"""The port's attention probes (``dreamlab_tpu_torch/scripts``) against the
JAX scripts' Pallas kernels, on the CPU.

K4 (``scripts/ab_transpose_free.py::flash_attention_4d``) and K6
(``scripts/ab_head_packing.py::flash_attention_packed3``) are loaded from the
scripts and run in interpret mode. K5's script runs its benchmark at import,
so its ``pallas_call`` (``scripts/ab_attention_layout.py:61-86``) is rebuilt
here around the same ``_flash_kernel``. On CPU tensors the port's wrappers
compute their plain versions. Tolerance 2e-5, as for the one-head kernel
(tests/test_torch_port_kernels_plain.py): fp32 softmax and two fp32
contractions summed in another order.
"""

import functools
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dreamlab_tpu.ops.attention import _xla_attention
from dreamlab_tpu.ops.flash_attention import _flash_kernel, _pack_geometry
from dreamlab_tpu_torch.ops import flash_attention as tfa
from dreamlab_tpu_torch.ops import flash_group as tfg
from dreamlab_tpu_torch.scripts import ab_attention_layout as t_layout
from dreamlab_tpu_torch.scripts import ab_head_packing as t_packing
from dreamlab_tpu_torch.scripts import ab_transpose_free as t_4d
from dreamlab_tpu_torch.scripts import timing as t_timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_4d():
    return _load_script("ab_transpose_free")


@pytest.fixture(scope="module")
def jax_packing():
    return _load_script("ab_head_packing")


def _qkv(seed, b, n, m, h, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, h, d).astype(np.float32),
            rs.randn(b, m, h, d).astype(np.float32),
            rs.randn(b, m, h, d).astype(np.float32))


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------------------
# K4: the head group read in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,h,d,pack", [
    (1, 256, 6, 40, 3),
    (1, 256, 4, 64, 2),
    (2, 256, 8, 40, 2),
])
def test_flash_4d_matches_jax_interpret(jax_4d, b, n, h, d, pack):
    assert tfa.pack_geometry(h, d)[0] == pack
    q, k, v = _qkv(b + n + h + d, b, n, n, h, d)
    scale = d ** -0.5
    before = t_4d.LAUNCHES
    got = t_4d.flash_attention_4d(*_torch(q, k, v), scale=scale).numpy()
    assert t_4d.LAUNCHES == before  # CPU tensors: the plain version, no launch
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_4d.flash_attention_4d(
            *map(jnp.asarray, (q, k, v)), scale=scale, block_q=128, block_k=128))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_flash_4d_rejects_groups_the_kernel_has_not():
    q = torch.zeros((1, 128, 8, 16))  # pack_geometry(8, 16) = 8 heads per group
    with pytest.raises(ValueError, match="pack 8"):
        t_4d.flash_attention_4d(q, q, q, scale=0.25)


# ---------------------------------------------------------------------------
# K6: three heads per block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,h,d", [(1, 256, 6, 40), (2, 256, 3, 40)])
def test_packed3_matches_jax_interpret(jax_packing, b, n, h, d):
    q, k, v = _qkv(7 * b + h, b, n, n, h, d)
    scale = d ** -0.5
    got = t_packing.flash_attention_packed3(*_torch(q, k, v), scale=scale).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_packing.flash_attention_packed3(
            *map(jnp.asarray, (q, k, v)), scale=scale, block_q=128, block_k=128))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("h,d", [(4, 40), (6, 48)])
def test_packed3_rejects_what_the_script_asserts(h, d):
    q = torch.zeros((1, 128, h, d))
    with pytest.raises(ValueError, match="packed3"):
        t_packing.flash_attention_packed3(q, q, q, scale=0.1)


# ---------------------------------------------------------------------------
# K5: the one-head kernel on pre-folded [G, N, lane] inputs
# ---------------------------------------------------------------------------


def _jax_kernel_call(q, k, v, lane, scale, bq=128, bk=128):
    """scripts/ab_attention_layout.py:61-86 at test size: K1's Pallas body,
    pack = 1, on [G, N, lane]."""
    g, n, _ = q.shape
    kern = functools.partial(_flash_kernel, scale=scale, kv_len=None,
                             num_k_blocks=n // bk, block_k=bk, d=lane, pack=1)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((g, n, lane), q.dtype),
        grid=(g, n // bq, n // bk),
        in_specs=[
            pl.BlockSpec((1, bq, lane), lambda ib, iq, ik: (ib, iq, 0)),
            pl.BlockSpec((1, bk, lane), lambda ib, iq, ik: (ib, ik, 0)),
            pl.BlockSpec((1, bk, lane), lambda ib, iq, ik: (ib, ik, 0)),
        ],
        out_specs=pl.BlockSpec((1, bq, lane), lambda ib, iq, ik: (ib, iq, 0)),
        scratch_shapes=[pltpu.VMEM((1, bq, lane), jnp.float32)] * 3,
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("parallel", "parallel", "arbitrary")),
    )(q, k, v)


def _folded(lane, b=1, h=2, n=256, d=40):
    q, k, v = _qkv(11, b, n, n, h, d)
    return [t_layout.fold(x, lane).numpy() for x in _torch(q, k, v)], d ** -0.5


@pytest.mark.parametrize("lane", [40, 128])
def test_kernel_call_matches_jax_interpret(lane):
    (q, k, v), scale = _folded(lane)
    before = t_layout.LAUNCHES
    got = t_layout.kernel_call(*_torch(q, k, v), lane, scale=scale).numpy()
    assert t_layout.LAUNCHES == before
    assert got.shape == q.shape
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_kernel_call(*map(jnp.asarray, (q, k, v)), lane, scale))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the zero-padded lanes come out exactly zero in both
    assert not got[:, :, 40:].any() and not want[:, :, 40:].any()


def test_kernel_call_lanes_agree_and_keep_the_callers_scale():
    (q1, k1, v1), scale = _folded(128)
    (q2, k2, v2), _ = _folded(40)
    wide = t_layout.kernel_call(*_torch(q1, k1, v1), 128, scale=scale).numpy()
    narrow = t_layout.kernel_call(*_torch(q2, k2, v2), 40, scale=scale).numpy()
    np.testing.assert_allclose(wide[:, :, :40], narrow, rtol=0, atol=TOL)
    # the folded rows are the heads of [B, N, H, D] attention at D^-0.5
    q, k, v = _qkv(11, 1, 256, 256, 2, 40)
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), scale))
    np.testing.assert_allclose(narrow, want.transpose(0, 2, 1, 3).reshape(2, 256, 40),
                               rtol=0, atol=TOL)


def test_kernel_call_rejects_a_lane_width_it_was_not_given():
    x = torch.zeros((2, 128, 40))
    with pytest.raises(ValueError):
        t_layout.kernel_call(x, x, x, 128, scale=0.1)


# ---------------------------------------------------------------------------
# the group kernel's module, pack_geometry and the one-head kernel's tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,m,h,d,pack", [
    (1, 256, 77, 6, 40, 3),    # masked key edge, cross-attention length
    (2, 200, 300, 4, 64, 2),   # ragged query edge
    (1, 128, 128, 6, 16, 2),
])
def test_flash_group_plain_matches_jax(b, n, m, h, d, pack):
    q, k, v = _qkv(n + m, b, n, m, h, d)
    got = tfg.flash_group(*_torch(q, k, v), pack=pack).numpy()
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), d ** -0.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape,pack", [
    ((1, 128, 6, 40), 4),   # no such group compiled
    ((1, 128, 4, 40), 3),   # heads do not split
    ((1, 128, 6, 64), 3),   # too wide for pack 3
])
def test_flash_group_rejects_what_the_kernel_does_not_take(shape, pack):
    q = torch.zeros(shape)
    with pytest.raises(ValueError):
        tfg.flash_group(q, q, q, pack=pack)


def test_pack_geometry_matches_jax():
    for h in range(1, 21):
        for d in (8, 16, 40, 64, 80, 96, 128):
            assert tfa.pack_geometry(h, d) == _pack_geometry(h, d), (h, d)


@pytest.mark.parametrize("block_q,block_k", [(64, 16), (64, 64), (128, 32), (128, 64)])
def test_flash_tiles_give_the_default_output_on_cpu(block_q, block_k):
    q, k, v = _torch(*_qkv(3, 1, 256, 256, 2, 40))
    want = tfa.flash_attention(q, k, v)
    got = tfa.flash_attention(q, k, v, block_q=block_q, block_k=block_k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block_q,block_k", [(256, 0), (0, 128), (32, 32)])
def test_flash_rejects_tiles_outside_the_sweep(block_q, block_k):
    q = torch.zeros((1, 128, 2, 40))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, block_q=block_q, block_k=block_k)


# ---------------------------------------------------------------------------
# the probes' entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ab_transpose_free", "ab_attention_layout",
                                  "ab_head_packing"])
def test_probe_main_needs_a_gpu(monkeypatch, name):
    mod = importlib.import_module(f"dreamlab_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        mod.main()


# ---------------------------------------------------------------------------
# the probes' bf16 check limit at N = M = 4096
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _n4096():
    """bf16-valued q, k, v at N = M = 4096 (2 heads, d = 40) and the fp32
    plain output on them."""
    q, k, v = (x.bfloat16().float() for x in _torch(*_qkv(0, 1, 4096, 4096, 2, 40)))
    return q, k, v, tfa.attention_plain(q, k, v, 40 ** -0.5)


@pytest.mark.parametrize("d,scale_d", [(40, 40), (128, 40)])
def test_probe_limit_passes_one_bf16_rounding(d, scale_d):
    """The output rounded once to bf16 passes, at d = 40 and at d = 128 with
    the d = 40 scale, where the outputs reach about 1 and a raw-error limit
    of 3e-3 would fail."""
    q, k, v = (x.bfloat16().float() for x in _torch(*_qkv(1, 1, 4096, 4096, 2, d)))
    ref = tfa.attention_plain(q, k, v, scale_d ** -0.5)
    check = t_timing.bf16_check(ref.bfloat16(), ref)
    assert check["beyond_rounding"] <= 0
    assert t_timing.report_checks({"rounded": check}) == []


@pytest.mark.parametrize("fault", ["one_key_dropped", "key_tile_dropped", "scale_1pct_off"])
def test_probe_limit_catches_a_faulty_kernel_at_n4096(fault):
    q, k, v, ref = _n4096()
    scale = 40 ** -0.5
    keep = torch.ones(4096, dtype=torch.bool)
    if fault == "scale_1pct_off":
        scale *= 1.01
    else:
        keep[1000:1001 if fault == "one_key_dropped" else 1032] = False
    got = tfa.attention_plain(q, k[:, keep], v[:, keep], scale).bfloat16()
    check = t_timing.bf16_check(got, ref)
    assert check["beyond_rounding"] > 10 * t_timing.TOL_BF16
    assert t_timing.report_checks({fault: check}) == [fault]


# ---------------------------------------------------------------------------
# the shared timer: CUDA events around calls queued behind a spin kernel
# ---------------------------------------------------------------------------


class _FakeEvent:
    """torch.cuda.Event stand-in: ``stamps`` are the card's clock in ms."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.at - self.at


@pytest.mark.parametrize("host_s,want", [(0.0, 0.5), (0.001, 0.5), (0.006, None)])
def test_device_ms_times_queued_calls_between_events(monkeypatch, host_s, want):
    """Each fake call advances the card's clock by 0.5 ms; a host that takes
    longer to queue the 10 calls than the spin lasts is refused."""
    import time as _time

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(_FakeEvent, "clock", [0.0])
    calls = []

    def call():
        calls.append(1)
        _FakeEvent.clock[0] += 0.5
        _time.sleep(host_s)

    timed = functools.partial(t_timing.device_ms, call, iters=10, warmup_s=0.0)
    if want is None:
        with pytest.raises(RuntimeError, match="to queue 10 calls"):
            timed()
    else:
        assert timed() == pytest.approx(want)
        assert len(calls) == 11  # one warm-up call, then the 10 timed
