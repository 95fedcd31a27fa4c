"""``ops/batching.py::row_chunks`` on the CPU: the decision per key and batch
size, the capture rule and the counters.

The probe runs on the card only; these tests let it run on CPU tensors by
patching ``batching._probes``, and stand in for a graph capture by patching
``batching._capturing``.
"""

import weakref

import numpy as np
import pytest
import torch

from dreamlab_tpu_torch.ops import batching
from dreamlab_tpu_torch.utils import tracing

BATCHED = "batching.calls_batched"
PER_ROW = "batching.calls_per_row"


@pytest.fixture(autouse=True)
def fresh():
    batching.reset()
    yield
    batching.reset()


@pytest.fixture
def probed(monkeypatch):
    """CPU tensors take the card's path, outside a capture."""
    monkeypatch.setattr(batching, "_probes", lambda x: True)
    _capturing(monkeypatch, False)


def _capturing(monkeypatch, flag: bool):
    monkeypatch.setattr(batching, "_capturing", lambda: flag)


class Calls:
    """``fn`` that records the batch size of every call it gets."""

    def __init__(self, fn):
        self.fn, self.sizes = fn, []

    def __call__(self, *xs):
        self.sizes.append(xs[0].shape[0])
        return self.fn(*xs)


def _x(b, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, 5, 3).astype(np.float32))


def _counts():
    c = tracing.counters()
    return c.get(BATCHED, 0), c.get(PER_ROW, 0)


def _last_row_off(x):
    y = x * 2.0
    if x.shape[0] > 1:
        y[-1] += 1e-3
    return y


# a batched result that differs from its rows (an epsilon that grows with
# the batch), and a row-wise one
ROWS_DIFFER = lambda x: x * 2.0 + 1e-3 * (x.shape[0] - 1)
ROW_WISE = lambda x: x * 2.0 + 1.0


@pytest.mark.parametrize("fn,rows", [
    (ROWS_DIFFER, 1),
    (ROW_WISE, 4),
    (_last_row_off, 1),  # one row off is enough
    # -0.0 equals 0.0 as a value, not as bytes
    (lambda x: torch.full_like(x, -0.0 if x.shape[0] > 1 else 0.0), 1),
], ids=["rows_differ", "row_wise", "last_row_off", "zero_sign"])
def test_the_probe_records_batched_only_where_every_row_equals_its_solo_call(probed, fn,
                                                                              rows,
                                                                              monkeypatch):
    released = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: released.append(1))
    x = _x(4)
    out = batching.row_chunks(("f",), fn, x)
    assert released == [1]  # the probe's freed blocks go back to the device
    assert batching.same_bytes(out, batching.per_row(fn, x))
    assert list(batching.decisions().values()) == [rows]
    (full,) = batching.decisions()
    assert full == batching.signature(("f",), [x])
    # decided: the next call runs as decided, without probing
    calls = Calls(fn)
    assert batching.same_bytes(batching.row_chunks(("f",), calls, x), out)
    assert calls.sizes == ([4] if rows == 4 else [1] * 4) and released == [1]


def test_each_batch_size_and_key_is_decided_on_its_own(probed):
    batching.row_chunks(("f",), ROWS_DIFFER, _x(4))
    batching.row_chunks(("f",), ROWS_DIFFER, _x(2))
    batching.row_chunks(("h",), ROW_WISE, _x(2))
    batching.row_chunks(("f",), ROW_WISE, torch.zeros(2, 5, 4))  # another shape
    assert sorted(batching.decisions().values()) == [1, 1, 2, 2]


def test_batch_one_calls_the_function_directly(probed, monkeypatch):
    """No probe, no lookup, no key built and no count, even while capturing."""
    for name in ("_probe", "signature", "_capturing"):
        monkeypatch.setattr(batching, name, lambda *a, name=name: pytest.fail(f"{name} called"))
    before = _counts()
    calls = Calls(ROWS_DIFFER)
    x = _x(1)
    assert torch.equal(batching.row_chunks(("f",), calls, x), ROWS_DIFFER(x))
    assert calls.sizes == [1] and batching.decisions() == {} and _counts() == before


def test_cpu_tensors_run_one_call_a_row():
    calls = Calls(ROW_WISE)
    x = _x(3)
    assert torch.equal(batching.row_chunks(("f",), calls, x), ROW_WISE(x))
    assert calls.sizes == [1, 1, 1] and batching.decisions() == {}


@pytest.mark.parametrize("fn,sizes,counted", [
    (ROW_WISE, [3], (1, 0)),          # decided batched: one call, counted batched
    (ROWS_DIFFER, [1, 1, 1], (0, 3)),  # decided per row: a call a row
    (None, [1, 1, 1], (0, 3)),         # never decided: per row, and not probed
], ids=["batched", "per_row", "undecided"])
def test_a_capture_looks_decisions_up_and_counts_each_library_call(probed, monkeypatch, fn,
                                                                   sizes, counted):
    x = _x(3)
    if fn is not None:
        batching.row_chunks(("f",), fn, x)  # the eager run decides
    decided = batching.decisions()
    before = _counts()
    _capturing(monkeypatch, True)
    monkeypatch.setattr(batching, "_probe", lambda *a: pytest.fail("probed while capturing"))
    calls = Calls(fn or ROW_WISE)
    out = batching.row_chunks(("f",), calls, x)
    assert calls.sizes == sizes and batching.decisions() == decided
    assert batching.same_bytes(out, batching.per_row(fn or ROW_WISE, x))
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == counted


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "capture"])
def test_a_batch_over_the_scratch_budget_runs_per_row_unprobed(probed, monkeypatch,
                                                                capturing):
    """A call whose rows would hold more than ``SCRATCH_BYTES`` of scratch
    together runs one call a row and is never probed; at the budget it is."""
    monkeypatch.setattr(batching, "SCRATCH_BYTES", 400)
    x = _x(4)
    batching.row_chunks(("f",), ROW_WISE, x, scratch=100)  # 4 x 100: probed, batched
    assert list(batching.decisions().values()) == [4]
    _capturing(monkeypatch, capturing)
    monkeypatch.setattr(batching, "_probe", lambda *a: pytest.fail("probed over the budget"))
    before = _counts()
    calls = Calls(ROW_WISE)
    out = batching.row_chunks(("f",), calls, x, scratch=101)
    assert calls.sizes == [1] * 4 and torch.equal(out, batching.per_row(ROW_WISE, x))
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == ((0, 4) if capturing else (0, 0))


def test_nothing_is_counted_outside_a_capture(probed):
    before = _counts()
    for _ in range(2):
        batching.row_chunks(("f",), ROW_WISE, _x(3))
        batching.row_chunks(("g",), ROWS_DIFFER, _x(3))
    assert _counts() == before


def test_the_probe_holds_the_batched_output_and_one_row(probed):
    """Each solo output is dropped before the next row's call."""
    alive = []

    def fn(x):
        y = x * 2.0
        if x.shape[0] == 1:
            alive[:] = [r for r in alive if r() is not None]
            assert not alive, "an earlier row's solo output is still held"
            alive.append(weakref.ref(y))
        return y

    batching.row_chunks(("f",), fn, _x(4))
    assert list(batching.decisions().values()) == [4]


def test_call_sites_pass_their_keys_and_keep_the_program_bytes(probed, monkeypatch):
    """The tiny SD1.5 program at batch 3 with every call site probed on the
    CPU (oneDNN's choice of algorithm depends on the batch too) gives the
    bytes of the same program one row at a time, and decides keys of every
    kind of call."""
    from dreamlab_tpu_torch.pipeline import LCMPipeline
    from dreamlab_tpu_torch.testing import random_bundle

    pipe = LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")
    kw = dict(height=32, width=32, num_inference_steps=2, seed=4, batch=3)
    probed_run = pipe.generate("a cat", **kw)
    kinds = {full[0][0] for full in batching.decisions()}
    assert kinds == {"conv2d", "linear", "group_norm", "attention", "clip_attention"}
    batching.reset()
    monkeypatch.setattr(batching, "_probes", lambda x: False)
    per_row = pipe.generate("a cat", **kw)
    assert np.array_equal(probed_run.images, per_row.images)
    assert np.array_equal(probed_run.latents, per_row.latents)


def test_the_survey_records_each_distinct_call_with_its_count(monkeypatch):
    """``scripts/ab_batching.py`` on the CPU (its device timing stubbed): the
    recorded program runs one row at a time and gives the per-row bytes;
    each distinct call is recorded once, with its strides and its count, and
    every chunk size of a row-wise call equals the solo calls."""
    from dreamlab_tpu_torch.pipeline import LCMPipeline
    from dreamlab_tpu_torch.scripts import ab_batching
    from dreamlab_tpu_torch.testing import random_bundle

    monkeypatch.setattr(ab_batching, "graph_ms", lambda fn, iters=10: 1.0)
    pipe = LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")
    kw = dict(height=32, width=32, num_inference_steps=2, seed=4, batch=4)
    want = pipe.generate("a cat", **kw).images
    sites = {}
    with ab_batching.record_sites(sites), torch.inference_mode():
        got = pipe.generate("a cat", **kw).images
    assert np.array_equal(got, want) and batching.decisions() == {}
    assert all(full == batching.signature(s.key, s.xs) for full, s in sites.items())
    assert sum(s.calls for s in sites.values()) > len(sites)
    rows = ab_batching.survey({k: sites[k] for k in list(sites)[:3]}, 4)
    assert [set(r["ms"]) for r in rows] == [{"1", "2", "4"}] * 3
    row_wise = ab_batching.Site(("f",), ROW_WISE, [_x(4)])
    (row,) = ab_batching.survey({"f": row_wise}, 4)
    assert row["equal"] == {"4": True, "2": True}
    assert ab_batching.totals([row], 4)["f"]["equal_sites"] == 1
