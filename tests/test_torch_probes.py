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
_FAULTS = ("one_key_dropped", "key_tile_dropped", "scale_1pct_off")


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
# the group kernel's module and pack_geometry
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


@pytest.mark.parametrize("name", ["profiler_race", "yume_loop"])
def test_hang_hunt_main_needs_a_gpu(monkeypatch, name):
    """The card-only hang hunts refuse a machine without one before any work."""
    mod = importlib.import_module(f"dreamlab_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        mod.main(["--seconds", "1"])


# ---------------------------------------------------------------------------
# the probes' bf16 check limits at N = M = 4096
# ---------------------------------------------------------------------------


def _tile_bf16_p(q, k, v, scale, block_k=64, log2=False):
    """A plain emulation of the tensor-core flash kernel's arithmetic on
    [B, N, H, D]: keys in tiles of ``block_k``, online softmax in fp32, the row
    sum over fp32 P, P rounded to bf16 before the PV product (the Pallas
    kernel's ``p.astype(v.dtype)``), fp32 accumulation, the output rounded
    to bf16 once. ``log2``: the wgmma kernel's form of the softmax, the row
    max of the raw scores times scale * log2(e) and p = 2^(s * scale *
    log2(e) - max)."""
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    b, h, n, d = qh.shape
    row_max = torch.full((b, h, n, 1), -1e30)
    row_sum = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, d))
    for j0 in range(0, kh.shape[2], block_k):
        raw = qh @ kh[:, :, j0:j0 + block_k].transpose(-1, -2)
        if log2:
            scale_log2 = scale * 1.4426950408889634
            new_max = torch.maximum(row_max, raw.amax(-1, keepdim=True) * scale_log2)
            alpha = torch.exp2(row_max - new_max)
            p = torch.exp2(raw * scale_log2 - new_max)
        else:
            s = raw * scale
            new_max = torch.maximum(row_max, s.amax(-1, keepdim=True))
            alpha = torch.exp(row_max - new_max)
            p = torch.exp(s - new_max)
        row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vh[:, :, j0:j0 + block_k]
        row_max = new_max
    return (acc / row_sum).transpose(1, 2).bfloat16()


def _faulty(q, k, v, scale, fault, arith):
    """The output of a kernel with ``fault`` (one key or a 32-key tile of
    4096 dropped, or the scale 1 % off) in the given arithmetic."""
    keep = torch.ones(k.shape[1], dtype=torch.bool)
    if fault == "scale_1pct_off":
        scale *= 1.01
    else:
        keep[1000:1001 if fault == "one_key_dropped" else 1032] = False
    if arith == "fp32":
        return tfa.attention_plain(q, k[:, keep], v[:, keep], scale).bfloat16()
    if arith == "wgmma":
        return _tile_bf16_p(q, k[:, keep], v[:, keep], scale, tfa.WGMMA_BLOCK_K, log2=True)
    return _tile_bf16_p(q, k[:, keep], v[:, keep], scale)


@functools.lru_cache(maxsize=None)
def _n4096():
    """bf16-valued q, k, v at N = M = 4096 (2 heads, d = 40) and the fp32
    plain output on them."""
    q, k, v = (x.bfloat16().float() for x in _torch(*_qkv(0, 1, 4096, 4096, 2, 40)))
    return q, k, v, tfa.attention_plain(q, k, v, 40 ** -0.5)


@pytest.mark.parametrize("d,scale_d,arith", [
    pytest.param(40, 40, "fp32", id="40-40"),
    pytest.param(128, 40, "fp32", id="128-40"),
    pytest.param(40, 40, "bf16_p", id="40-40-bf16_p"),
    pytest.param(80, 80, "bf16_p", id="80-80-bf16_p"),
    pytest.param(128, 40, "bf16_p", id="128-40-bf16_p"),
    # the wgmma kernel's tiles and softmax form, at the UNet's head widths
    pytest.param(40, 40, "wgmma", id="40-40-wgmma"),
    pytest.param(80, 80, "wgmma", id="80-80-wgmma"),
    pytest.param(64, 64, "wgmma", id="64-64-wgmma"),
])
def test_probe_limit_passes_one_bf16_rounding(d, scale_d, arith):
    """fp32: the output rounded once to bf16 passes TOL_BF16, at d = 40 and at
    d = 128 with the d = 40 scale, where the outputs reach about 1 and a
    raw-error limit of 3e-3 would fail. bf16_p: the tensor-core kernel's
    arithmetic (P rounded to bf16) leaves more than TOL_BF16 beyond the
    rounding and passes TOL_BF16_P, at d = 40, 80 and 128; so does the wgmma
    kernel's (its key tile, the log2-domain softmax) at d = 40, 80 and 64,
    by the same margin."""
    q, k, v = (x.bfloat16().float() for x in _torch(*_qkv(1, 1, 4096, 4096, 2, d)))
    ref = tfa.attention_plain(q, k, v, scale_d ** -0.5)
    if arith == "fp32":
        check = t_timing.bf16_check(ref.bfloat16(), ref)
        assert check["beyond_rounding"] <= 0
    else:
        tiles = (dict(block_k=tfa.WGMMA_BLOCK_K, log2=True) if arith == "wgmma" else {})
        check = t_timing.bf16_check(_tile_bf16_p(q, k, v, scale_d ** -0.5, **tiles), ref,
                                    t_timing.TOL_BF16_P)
        assert t_timing.TOL_BF16 < check["beyond_rounding"] <= t_timing.TOL_BF16_P / 3
    assert t_timing.report_checks({"rounded": check}) == []


@pytest.mark.parametrize("kernel,shape,pack", [
    pytest.param("k4", (1, 512, 6, 40), 3, id="k4-pack3"),
    pytest.param("k4", (1, 512, 4, 64), 2, id="k4-pack2"),
    pytest.param("k6", (1, 512, 6, 40), 3, id="k6"),
])
def test_group_limit_is_the_pallas_kernels_arithmetic(jax_4d, jax_packing, kernel, shape, pack):
    """The Pallas K4 and K6 on bf16 inputs (interpret mode) round P to bf16
    before the PV product, as the card's head-group kernel does: each leaves
    more than TOL_BF16 beyond one rounding of the plain fp32 output, and
    stays within TOL_BF16_P, the limit the group kernel is held to."""
    b, n, h, d = shape
    if kernel == "k4":
        fn = jax_4d.flash_attention_4d
        assert tfa.pack_geometry(h, d)[0] == pack
    else:
        fn = jax_packing.flash_attention_packed3
    q, k, v = _qkv(0, b, n, n, h, d)
    with pltpu.force_tpu_interpret_mode():
        got = fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale=d ** -0.5,
                 block_q=128, block_k=128)
    got = torch.from_numpy(np.array(got.astype(jnp.float32)))
    qb, kb, vb = (x.bfloat16().float() for x in _torch(q, k, v))
    check = t_timing.bf16_check(got, tfg.flash_group_plain(qb, kb, vb, d ** -0.5),
                                t_timing.TOL_BF16_P)
    assert t_timing.TOL_BF16 < check["beyond_rounding"] <= t_timing.TOL_BF16_P
    assert t_timing.report_checks({kernel: check}) == []


@pytest.mark.parametrize("fault,arith", [
    *(pytest.param(f, "fp32", id=f) for f in _FAULTS),
    *(pytest.param(f, "bf16_p", id=f"{f}-bf16_p") for f in _FAULTS),
    *(pytest.param(f, "wgmma", id=f"{f}-wgmma") for f in _FAULTS),
])
def test_probe_limit_catches_a_faulty_kernel_at_n4096(fault, arith):
    """Each fault fails its arithmetic's limit by a wide margin: ten times
    TOL_BF16 in fp32, twice TOL_BF16_P with P rounded to bf16 (the Pallas
    kernel's arithmetic and the wgmma kernel's, at its key tile)."""
    q, k, v, ref = _n4096()
    limit, margin = ((t_timing.TOL_BF16, 10) if arith == "fp32"
                     else (t_timing.TOL_BF16_P, 2))
    check = t_timing.bf16_check(_faulty(q, k, v, 40 ** -0.5, fault, arith), ref, limit)
    assert check["beyond_rounding"] > margin * limit
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
        assert len(calls) == 1 + 10 * t_timing.QUEUE_ATTEMPTS  # each window timed once
    else:
        assert timed() == pytest.approx(want)
        assert len(calls) == 11  # one warm-up call, then the 10 timed


def test_device_ms_measures_a_slow_window_again(monkeypatch):
    """A window the host was too slow to queue is thrown away and timed again:
    the first timed window is slow, the second is not."""
    import time as _time

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(_FakeEvent, "clock", [0.0])
    calls = []

    def call():
        calls.append(1)
        _FakeEvent.clock[0] += 0.5
        _time.sleep(0.006 if 1 < len(calls) <= 11 else 0.0)

    assert t_timing.device_ms(call, iters=10, warmup_s=0.0) == pytest.approx(0.5)
    assert len(calls) == 21  # the warm-up call, the slow window, the timed one
