"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
``dreamlab_tpu_torch/csrc``) and skip elsewhere. They import no JAX, so on a
machine without it run them as

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: in fp32 (TF32 off) the kernels differ from the plain versions only
in summation order, so 1e-4 (attention) and 1e-5 (GroupNorm). In bf16 the
kernel is compared with the plain version computed in fp32 on the same bf16
inputs, and what is held is the error left beyond one bf16 rounding of the
output (``scripts/timing.py::bf16_check``). The tensor-core flash kernels,
one head per block and head group, round P to bf16 before the PV product,
as the Pallas kernels do, so they are held to ``TOL_BF16_P`` (2e-3: a CPU
emulation of that arithmetic leaves 1.7e-4 to 6.1e-4, a dropped key 1.3e-2
or more). GroupNorm keeps fp32 statistics and rounds its output once, so
what is left is fp32 summation order, a few 1e-6 at outputs up to about 5:
``TOL_BF16`` (1e-4), the limit of every kernel that computes in fp32 and
rounds once.
"""

import numpy as np
import pytest
import torch

from dreamlab_tpu_torch.ops import _build
from dreamlab_tpu_torch.ops import attention
from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.ops import groupnorm as gn
from dreamlab_tpu_torch.scripts import ab_attention_layout as layout
from dreamlab_tpu_torch.scripts.timing import TOL_BF16, TOL_BF16_P, bf16_check

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: 1e-4}
GN_TOL = {torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _assert_close(got, want, tol_fp32, tol_bf16):
    """fp32: the raw error; bf16: the error beyond one bf16 rounding."""
    if got.dtype == torch.bfloat16:
        c = bf16_check(got, want, tol_bf16)
        assert c["beyond_rounding"] <= c["limit"], c
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol_fp32, err


def test_build_reports_registers(cuda):
    log = _build.build_log()
    print(log)
    assert "flash_fwd_kernel" in log and "flash_wgmma_kernel" in log
    assert "gn_cluster_kernel" in log and "gn_apply_kernel" in log
    assert "flash_group_fwd_kernel" in log and "flash_group_wgmma_kernel" in log


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 256, 256, 8, 40),
    (1, 256, 77, 8, 40),     # masked key edge, cross-attention length
    (1, 256, 1000, 8, 80),   # masked edge across several key tiles
    (2, 200, 300, 2, 64),    # ragged query edge
    (1, 128, 128, 2, 128),   # widest head dim
    (1, 1024, 1024, 2, 128),  # d = 128: dynamic shared memory above 48 KB
    (1, 1024, 1024, 8, 80),  # UNet level 2
    (1, 4032, 4032, 10, 64),  # SDXL at 1344x768: ragged query and key tiles
    (1, 1008, 1008, 20, 64),
    (1, 4096, 4096, 2, 40),  # UNet level 1: d = 40 zero-filled to 48 by TMA
    (1, 256, 300, 4, 20),    # 40-byte head rows: bf16 takes the plain path
    (2, 130, 77, 3, 7),      # odd head dim, ragged edges: bf16 takes the plain path
    (1, 4096, 4096, 10, 64),  # SDXL at 1024²: level 1
    (2, 1024, 1024, 20, 64),  # SDXL at 1024²: level 2, the cfg mode's doubled batch
    # the SDXL refiner at 1024²: levels 1 and 2, and its 4-layer mid block
    (1, 4096, 4096, 12, 64), (1, 1024, 1024, 24, 64), (1, 256, 256, 24, 64),
])
def test_flash_matches_plain(cuda, dtype, b, n, m, h, d):
    """Each launch counts once in all and once on its route: fp32 on the
    scalar kernel, bf16 at d % 8 == 0 on the wgmma kernel. bf16 no kernel
    takes raises in the kernel's wrapper, and the dispatch runs it on the
    plain path, launching nothing."""
    q = _randn((b, n, h, d), dtype, cuda, 0)
    k = _randn((b, m, h, d), dtype, cuda, 1)
    v = _randn((b, m, h, d), dtype, cuda, 2)
    route = "scalar" if dtype == torch.float32 else "wgmma" if d % 8 == 0 else None
    assert fa.route(q, k, v) == route
    before, routes = fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)
    if route is None:
        with pytest.raises(ValueError, match="no kernel"):
            fa.flash_attention(q, k, v)
        got = attention.dot_product_attention(q, k, v)
        assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES) == (before, routes)
    else:
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1
        assert fa.ROUTE_LAUNCHES == {**routes, route: routes[route] + 1}
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, TOL[torch.float32], TOL_BF16_P)


def test_flash_wgmma_is_bitwise_repeatable(cuda):
    """No split over keys and no atomics: two calls give the same bytes, and
    so does each tile rule (one, two or three consumer warpgroups)."""
    q, k, v = (_randn((2, 1000, 6, 64), torch.bfloat16, cuda, i) for i in range(3))
    assert fa.route(q, k, v) == "wgmma"
    first = fa.flash_attention(q, k, v)
    assert torch.equal(first.view(torch.int16), fa.flash_attention(q, k, v).view(torch.int16))
    rule = fa.wgmma_consumers
    try:
        for c in (1, 2, 3):
            fa.wgmma_consumers = lambda *a, c=c, **kw: c
            assert torch.equal(fa.launch(q, k, v, scale=64 ** -0.5), first)
    finally:
        fa.wgmma_consumers = rule


@pytest.mark.parametrize("b,n,h,d", [(2, 1024, 20, 64), (2, 4096, 8, 40)])
def test_flash_wgmma_batch_row_equals_its_solo_call(cuda, b, n, h, d):
    """SDXL's cfg batch at level 2 and SD1.5's level 1: each batch row of a
    call on the packed projection's views equals that row's solo call, byte
    for byte (the tile rule reads no batch)."""
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 4)
    q, k, v = (qkv[:, :, i].view(b, n, h, d) for i in range(3))
    assert fa.route(q, k, v) == "wgmma"
    got = fa.flash_attention(q, k, v)
    for i in range(b):
        solo = fa.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(got[i:i + 1], solo)


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 4032, 4032, 10, 64),  # SDXL at 1344x768: ragged query and key tiles
    (1, 1008, 1008, 20, 64),
    (1, 4032, 77, 10, 64),    # cross-attention length: one ragged key tile
    (2, 1008, 77, 20, 64),
    (1, 100, 77, 8, 40),      # fewer rows than one consumer's 64 + 64
    (1, 300, 1000, 8, 80),
])
def test_flash_wgmma_ragged_edges(cuda, b, n, m, h, d):
    q = _randn((b, n, h, d), torch.bfloat16, cuda, 5)
    k = _randn((b, m, h, d), torch.bfloat16, cuda, 6)
    v = _randn((b, m, h, d), torch.bfloat16, cuda, 7)
    assert fa.route(q, k, v) == "wgmma"
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, None, TOL_BF16_P)


def test_a_failed_wgmma_launch_raises_and_runs_nothing_else(cuda, monkeypatch):
    """The route is a dispatch, not a fallback: a launch the wgmma entry
    refuses (here: a tile rule it was not built for) raises, counts nothing
    and is not run again on another kernel."""
    q, k, v = (_randn((1, 256, 4, 64), torch.bfloat16, cuda, i) for i in range(3))
    fa.flash_attention(q, k, v)  # build and bind before the spy
    asked = []
    kernel = _build.kernel
    monkeypatch.setattr(_build, "kernel", lambda name, argtypes: asked.append(name) or
                        kernel(name, argtypes))
    monkeypatch.setattr(fa, "wgmma_consumers", lambda *a, **kw: 4)
    before, routes = fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)
    with pytest.raises(RuntimeError, match="dl_flash_wgmma"):
        fa.flash_attention(q, k, v)
    assert asked == ["dl_flash_wgmma"]
    assert fa.LAUNCHES == before and fa.ROUTE_LAUNCHES == routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,m,h,d,pack", [
    (1, 256, 256, 6, 40, 3),
    (2, 200, 77, 6, 40, 3),    # ragged query edge, masked keys
    (1, 256, 1000, 4, 64, 2),  # masked edge across several key tiles
    (1, 192, 333, 6, 40, 3),   # keys: five full 64-key tiles and 13 more
    (1, 100, 256, 4, 64, 2),   # queries: one 64-row tile and 36 more
    (1, 256, 300, 8, 40, 2),
    (2, 130, 50, 6, 16, 3),
    (1, 128, 33, 2, 16, 2),
    (1, 128, 100, 4, 24, 2),   # zero-filled to 64 by TMA (fp32: to 40)
    (1, 256, 300, 4, 20, 2),   # 40-byte head slices: no bf16 kernel
    (2, 130, 77, 3, 7, 3),     # odd head dim, ragged edges: no bf16 kernel
    (2, 4096, 4096, 10, 64, 2),  # the probes' K4 shape at pack 2
])
def test_flash_group_matches_plain(cuda, dtype, b, n, m, h, d, pack):
    """Where no kernel takes the inputs (bf16 at d % 8 != 0) the launch
    raises and counts nothing."""
    q = _randn((b, n, h, d), dtype, cuda, 0)
    k = _randn((b, m, h, d), dtype, cuda, 1)
    v = _randn((b, m, h, d), dtype, cuda, 2)
    before = fg.LAUNCHES
    if fg.route(q, k, v, pack) is None:
        assert dtype == torch.bfloat16 and d % 8
        with pytest.raises(ValueError, match="no kernel"):
            fg.flash_group(q, k, v, pack=pack)
        assert fg.LAUNCHES == before
        return
    got = fg.flash_group(q, k, v, pack=pack)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, TOL[torch.float32], TOL_BF16_P)


def test_flash_group_bf16_is_bitwise_repeatable(cuda):
    """No split over keys and no atomics: two calls give the same bytes."""
    q, k, v = (_randn((2, 1000, 6, 40), torch.bfloat16, cuda, i) for i in range(3))
    first = fg.flash_group(q, k, v, pack=3)
    assert torch.equal(first.view(torch.int16), fg.flash_group(q, k, v, pack=3).view(torch.int16))


def test_flash_group_reads_token_strided_views(cuda):
    """q/k/v as views into one packed projection output: the group's lanes
    stay contiguous, only the token stride grows."""
    b, n, h, d = 2, 256, 6, 40
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 3)
    q, k, v = (qkv[:, :, i].reshape(b, n, h, d) for i in range(3))
    got = fg.flash_group(q, k, v, pack=3)
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, None, TOL_BF16_P)
    with pytest.raises(ValueError):  # heads not lane-adjacent
        fg.flash_group(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pack=3)


@pytest.mark.parametrize("b,n,m,h,d,pack", [
    (8, 4096, 4096, 6, 40, 3),   # K4 and K6 at pack 3
    (2, 4096, 4096, 10, 64, 2),  # K4 at pack 2
    (1, 4032, 4032, 10, 64, 2),  # SDXL at 1344x768: ragged query and key tiles
    (1, 4032, 77, 10, 64, 2),    # cross-attention length: one ragged key tile
    (2, 4032, 77, 6, 40, 3),
    (1, 100, 77, 8, 40, 2),      # one 64-row tile and 36 more
    (2, 130, 50, 6, 16, 3),      # d <= 16: 32-byte rows
    (1, 128, 100, 4, 24, 2),     # d = 24 zero-filled to 64 by TMA
])
def test_flash_group_wgmma_matches_plain(cuda, b, n, m, h, d, pack):
    """bf16 that TMA can describe takes the wgmma group kernel; the launch
    counts once in all and once on that route."""
    q = _randn((b, n, h, d), torch.bfloat16, cuda, 0)
    k = _randn((b, m, h, d), torch.bfloat16, cuda, 1)
    v = _randn((b, m, h, d), torch.bfloat16, cuda, 2)
    assert fg.route(q, k, v, pack) == "wgmma"
    before, routes = fg.LAUNCHES, dict(fg.ROUTE_LAUNCHES)
    got = fg.flash_group(q, k, v, pack=pack)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    assert fg.ROUTE_LAUNCHES == {**routes, "wgmma": routes["wgmma"] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape and got.is_contiguous()
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, None, TOL_BF16_P)


@pytest.mark.parametrize("b,n,h,d,pack", [(2, 4096, 6, 40, 3), (1, 4096, 8, 40, 2),
                                          (2, 1024, 20, 64, 2)])
def test_flash_group_wgmma_reads_packed_projection_views(cuda, b, n, h, d, pack):
    """q, k, v as views of one [B, N, 3, H*D] projection output (token
    stride 3*H*D): the tensor maps read them in place, and each batch row
    equals its solo call byte for byte."""
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 4)
    q, k, v = (qkv[:, :, i].view(b, n, h, d) for i in range(3))
    assert fg.route(q, k, v, pack) == "wgmma"
    got = fg.flash_group(q, k, v, pack=pack)
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, None, TOL_BF16_P)
    for i in range(b):
        solo = fg.flash_group(q[i:i + 1], k[i:i + 1], v[i:i + 1], pack=pack)
        assert torch.equal(got[i:i + 1], solo)


@pytest.mark.parametrize("b,n,h,d,pack", [(4, 1000, 6, 40, 3), (3, 1000, 4, 64, 2)])
def test_flash_group_wgmma_batch_row_equals_its_solo_call(cuda, b, n, h, d, pack):
    """Contiguous inputs, ragged tiles: each batch row equals that row's
    solo call byte for byte, and two calls give the same bytes."""
    q, k, v = (_randn((b, n, h, d), torch.bfloat16, cuda, 10 + i) for i in range(3))
    got = fg.flash_group(q, k, v, pack=pack)
    assert torch.equal(got, fg.flash_group(q, k, v, pack=pack))
    for i in range(b):
        assert torch.equal(got[i:i + 1],
                           fg.flash_group(q[i:i + 1], k[i:i + 1], v[i:i + 1], pack=pack))


def test_flash_group_routes_count_their_launches(cuda):
    """fp32 takes the scalar group kernel, bf16 TMA can describe the wgmma
    one; each launch counts on its own route only. bf16 TMA cannot describe
    (d = 20) raises and counts nothing."""
    for dtype, d, route in [(torch.bfloat16, 20, None), (torch.float32, 40, "scalar"),
                            (torch.bfloat16, 40, "wgmma")]:
        q, k, v = (_randn((1, 256, 4, d), dtype, cuda, i) for i in range(3))
        assert fg.route(q, k, v, 2) == route
        before, routes = fg.LAUNCHES, dict(fg.ROUTE_LAUNCHES)
        if route is None:
            with pytest.raises(ValueError, match="no kernel"):
                fg.flash_group(q, k, v, pack=2)
            assert (fg.LAUNCHES, fg.ROUTE_LAUNCHES) == (before, routes)
            continue
        got = fg.flash_group(q, k, v, pack=2)
        assert fg.LAUNCHES == before + 1
        assert fg.ROUTE_LAUNCHES == {**routes, route: routes[route] + 1}
        want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
        _assert_close(got, want, TOL[torch.float32], TOL_BF16_P)


def test_a_refused_group_wgmma_launch_raises_and_runs_nothing_else(cuda, monkeypatch):
    """The route is a dispatch, not a fallback: a launch the wgmma entry
    refuses (here: d = 72, past the widest instance, let through the
    Python check) raises, counts nothing and is not run again on another
    kernel."""
    q, k, v = (_randn((1, 256, 6, 40), torch.bfloat16, cuda, i) for i in range(3))
    fg.flash_group(q, k, v, pack=3)  # build and bind before the spy
    q, k, v = (_randn((1, 256, 6, 72), torch.bfloat16, cuda, i) for i in range(3))
    monkeypatch.setattr(fg, "MAX_HEAD_DIM", {2: 64, 3: 72})
    assert fg.route(q, k, v, 3) == "wgmma"
    asked = []
    kernel = _build.kernel
    monkeypatch.setattr(_build, "kernel", lambda name, argtypes: asked.append(name) or
                        kernel(name, argtypes))
    before, routes = fg.LAUNCHES, dict(fg.ROUTE_LAUNCHES)
    with pytest.raises(RuntimeError, match="dl_flash_group_wgmma"):
        fg.flash_group(q, k, v, pack=3)
    assert asked == ["dl_flash_group_wgmma"]
    assert fg.LAUNCHES == before and fg.ROUTE_LAUNCHES == routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lane", [40, 128])
def test_kernel_call_matches_plain(cuda, dtype, lane):
    x = [_randn((2, 300, 4, 40), dtype, cuda, i) for i in range(3)]
    q, k, v = (layout.fold(t, lane) for t in x)
    before = layout.LAUNCHES
    got = layout.kernel_call(q, k, v, lane, scale=40 ** -0.5)
    torch.cuda.synchronize()
    assert layout.LAUNCHES == before + 1
    want = fa.attention_plain(*(t.float().unsqueeze(2) for t in (q, k, v)),
                              40 ** -0.5).squeeze(2)
    _assert_close(got, want, TOL[torch.float32], TOL_BF16_P)
    assert not got[:, :, 40:].any()


def test_flash_reads_strided_views(cuda):
    """q/k/v as views into one packed projection output: no copies needed."""
    b, n, h, d = 2, 256, 4, 40
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 3)
    q, k, v = (qkv[:, :, i].reshape(b, n, h, d) for i in range(3))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    _assert_close(got, want, None, TOL_BF16_P)


def test_a_packed_unet_hands_the_kernel_its_projection_views(cuda, monkeypatch):
    """A packed self-attention site gives K1 q, k and v as views of its one
    projection output (token stride 3 x C, no copy), and the packed UNet on
    the card equals its unpacked layout on the same weights (fp32)."""
    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.models import unet

    bundle = testing.random_bundle(tiny=True, seed=3, device="cuda")
    cfg, params = bundle.unet_cfg, bundle.unet_params
    seen, launch = [], fa.launch

    def spy(q, k, v, **kw):
        seen.append((q.stride(1), q.shape[2] * q.shape[3], k.data_ptr() - q.data_ptr(),
                     v.data_ptr() - k.data_ptr()))
        return launch(q, k, v, **kw)

    x = _randn((1, 32, 32, 4), torch.float32, cuda, 1)  # 1024 tokens at level 0
    t = torch.tensor([999], dtype=torch.int32, device=cuda)
    ctx = _randn((1, 77, cfg.cross_attention_dim), torch.float32, cuda, 2)
    w = torch.zeros((1, cfg.time_cond_proj_dim), device=cuda)
    want = unet.forward(params, cfg, x, t, ctx, timestep_cond=w)
    monkeypatch.setattr(fa, "launch", spy)
    packed = unet.pack_attention_params(params)
    got = unet.forward(packed, cfg, x, t, ctx, timestep_cond=w)
    assert seen and all(stride == 3 * c and dk == dv == c * 4 for stride, c, dk, dv in seen)
    _assert_close(got, want, TOL[torch.float32], None)
    # in bf16 the same views take the wgmma route (TMA reads them in place)
    routes = []
    monkeypatch.setattr(fa, "launch", lambda q, k, v, **kw: routes.append(fa.route(q, k, v))
                        or spy(q, k, v, **kw))
    seen.clear()
    bf = testing.cast_tree(packed, torch.bfloat16)
    unet.forward(bf, cfg, x.bfloat16(), t, ctx.bfloat16(), timestep_cond=w.bfloat16())
    assert seen and all(stride == 3 * c for stride, c, _, _ in seen)
    assert routes and set(routes) == {"wgmma"}


def test_flash_rejects_what_it_does_not_take(cuda):
    """No kernel takes d = 160, bf16 at d = 20 or an unaligned bf16 base:
    each raises, and the dispatch runs them on the plain path."""
    q = torch.zeros((1, 128, 2, 160), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    buf = _randn((256 * 2 * 64 + 8,), torch.bfloat16, cuda, 8)
    for x in (_randn((1, 256, 2, 20), torch.bfloat16, cuda, 9),
              buf[1:1 + 256 * 2 * 64].view(1, 256, 2, 64)):
        assert fa.route(x, x, x) is None
        with pytest.raises(ValueError, match="no kernel"):
            fa.flash_attention(x, x, x)
        before = fa.LAUNCHES
        torch.testing.assert_close(attention.dot_product_attention(x, x, x),
                                   fa.attention_plain(x, x, x, x.shape[-1] ** -0.5))
        assert fa.LAUNCHES == before
    q = torch.zeros((1, 128, 2, 40), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


def _gn_params(c, dtype, device):
    rs = np.random.RandomState(5)
    scale = torch.from_numpy(1 + 0.1 * rs.randn(c).astype(np.float32)).to(device, dtype)
    bias = torch.from_numpy(0.1 * rs.randn(c).astype(np.float32)).to(device, dtype)
    return scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((1, 64, 64, 320), 32),
    ((1, 16, 16, 2560), 32),
    ((2, 5, 7, 64), 8),        # rows not a multiple of the tile
    ((1, 512, 512, 128), 32),  # VAE's last level
])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "nosilu"])
def test_group_norm_matches_plain(cuda, dtype, shape, groups, silu):
    """One launch per fused call: LAUNCHES counts every GroupNorm kernel."""
    c = shape[-1]
    x = _randn(shape, dtype, cuda, 4)
    scale, bias = _gn_params(c, dtype, cuda)
    before = (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES)
    got = gn.fused_group_norm_silu(x, scale, bias, groups=groups, silu=silu)
    torch.cuda.synchronize()
    assert (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES) == tuple(
        n + 1 for n in before)
    want = gn.group_norm_plain(x.float(), scale.float(), bias.float(),
                               groups=groups, silu=silu)
    _assert_close(got, want, GN_TOL[torch.float32], TOL_BF16)


@pytest.mark.parametrize("shape", [
    # UNet (SD1.5 at 512x512): every channel width of its GroupNorm calls
    (1, 64, 64, 320), (1, 64, 64, 640), (1, 64, 64, 960), (1, 32, 32, 640),
    (1, 32, 32, 960), (1, 32, 32, 1280), (1, 16, 16, 1920), (1, 8, 8, 2560),
    # VAE decoder: 512 at 64^2..256^2, 256 at 256^2 and 512^2 (134 MB, above
    # the 50 MB L2), 128 at 512^2
    (1, 64, 64, 512), (1, 256, 256, 512), (1, 512, 512, 256), (1, 512, 512, 128),
    # batch 8 at a UNet width
    (8, 32, 32, 640),
    # SDXL at 1024x1024: the UNet's widths on 128^2 (4x SD1.5's rows) and the
    # narrower levels' widest, and the VAE's 1024^2 rows (268 M values at 256
    # channels: 0.5 GiB a batch row)
    (1, 128, 128, 320), (1, 128, 128, 640), (1, 128, 128, 960), (1, 64, 64, 1920),
    (1, 32, 32, 2560), (1, 1024, 1024, 256), (2, 1024, 1024, 256), (1, 1024, 1024, 128),
])
def test_group_norm_cluster_path_at_census_widths(cuda, shape):
    """bf16 at the widths one request gives the kernel, against the plain
    fp32 version; a batch row equals its solo run byte for byte."""
    c = shape[-1]
    x = _randn(shape, torch.bfloat16, cuda, 7)
    scale, bias = _gn_params(c, torch.bfloat16, cuda)
    got = gn.fused_group_norm_silu(x, scale, bias, groups=32)
    want = gn.group_norm_plain(x.float(), scale.float(), bias.float(), groups=32, silu=True)
    _assert_close(got, want, None, TOL_BF16)
    solo = gn.fused_group_norm_silu(x[-1:].contiguous(), scale, bias, groups=32)
    assert torch.equal(got[-1:], solo)


@pytest.mark.parametrize("shape", [
    # the VAE encoder at 512x512: 128 channels at 512^2, then each level's
    # first resnet on its input width (128 at 256^2, 256 at 128^2), then
    # 256 at 256^2, 512 at 128^2 and 64^2
    (1, 512, 512, 128), (1, 256, 256, 128), (1, 256, 256, 256), (1, 128, 128, 256),
    (1, 128, 128, 512), (1, 64, 64, 512),
    # at 1024x1024: twice the sizes
    (1, 1024, 1024, 128), (1, 512, 512, 128), (1, 512, 512, 256), (1, 256, 256, 256),
    (1, 256, 256, 512), (1, 128, 128, 512),
])
def test_group_norm_at_the_vae_encoder_widths(cuda, shape):
    """bf16 GroupNorm+SiLU at the encoder's (channels, size) pairs against the
    plain fp32 version."""
    x = _randn(shape, torch.bfloat16, cuda, 9)
    scale, bias = _gn_params(shape[-1], torch.bfloat16, cuda)
    got = gn.fused_group_norm_silu(x, scale, bias, groups=32)
    want = gn.group_norm_plain(x.float(), scale.float(), bias.float(), groups=32, silu=True)
    _assert_close(got, want, None, TOL_BF16)


@pytest.mark.parametrize("shape", [
    # the SDXL refiner's UNet at 1024x1024 (widths 384/768/1536 and the up
    # blocks' concatenations), every (size, channels) pair of one call
    (1, 128, 128, 384), (1, 128, 128, 768), (1, 128, 128, 1152), (1, 64, 64, 384),
    (1, 64, 64, 768), (1, 64, 64, 1152), (1, 64, 64, 1536), (1, 64, 64, 2304),
    (1, 32, 32, 768), (1, 32, 32, 1536), (1, 32, 32, 2304), (1, 32, 32, 3072),
    (1, 16, 16, 1536), (1, 16, 16, 3072),
])
def test_group_norm_at_the_refiner_widths(cuda, shape):
    """bf16 GroupNorm+SiLU at the refiner's (channels, size) pairs against
    the plain fp32 version."""
    x = _randn(shape, torch.bfloat16, cuda, 11)
    scale, bias = _gn_params(shape[-1], torch.bfloat16, cuda)
    got = gn.fused_group_norm_silu(x, scale, bias, groups=32)
    want = gn.group_norm_plain(x.float(), scale.float(), bias.float(), groups=32, silu=True)
    _assert_close(got, want, None, TOL_BF16)


def test_style_swap_in_place_under_a_captured_graph(cuda, tmp_path):
    """A style written into the live weights reaches the bucket's captured
    graph (the same PNG as the eager route with the style on), and
    un-styling gives back the unstyled bytes."""
    from dreamlab_tpu_torch import lora, testing
    from dreamlab_tpu_torch.engine.base import GenSpec
    from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
    from dreamlab_tpu_torch.pipeline import LCMPipeline
    from dreamlab_tpu_torch.utils.png import encode_png
    from dreamlab_tpu_torch.utils.safetensors import save_file

    pipe = LCMPipeline(testing.random_bundle(tiny=True, seed=3, device="cuda"))
    path = str(tmp_path / "style.safetensors")
    save_file(testing.random_lora(pipe.unet_params, rank=4, seed=5), path)
    worker = CudaPipelineWorker(pipe, styles={"s": lora.StyleDef(name="s", path=path)})
    spec = lambda style: GenSpec("a cat", size="64x64", num_inference_steps=2, seed=7,
                                 style=style, style_level=0 if style is None else 4)
    plain = worker.run_job_with_latents(spec(None))[0]  # captures the bucket
    styled = worker.run_job_with_latents(spec("s"))[0]
    assert len(pipe._compiled) == 1 and styled != plain
    assert worker.run_job_with_latents(spec(None))[0] == plain
    worker._apply_style("s", 4)
    try:
        eager = pipe._generate_eager("a cat", height=64, width=64, num_inference_steps=2,
                                     seed=7)
    finally:
        worker._apply_style(None, 0)
    assert encode_png(eager.images[0]) == styled


def test_progress_segments_and_controlnet_under_captured_graphs(cuda):
    """The progress bucket's per-step latents (external events, slots read
    on a side stream) equal the eager route's and leave the image as the
    plain bucket's; (0, 1) then (1, 2) equals the 2-step run byte for byte
    with the carry on the card; a ControlNet of the same config written into
    the live leaves reaches the captured ctrl graph."""
    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.pipeline import LCMPipeline

    pipe = LCMPipeline(testing.random_bundle(tiny=True, seed=3, device="cuda"))
    kw = dict(height=64, width=64, num_inference_steps=2, seed=7)
    steps, eager_steps = [], []
    plain = pipe.generate("a cat", **kw)
    got = pipe.generate("a cat", callback=lambda i, t, lat: steps.append((i, t, lat)), **kw)
    pipe._generate_eager("a cat", callback=lambda i, t, lat: eager_steps.append((i, t, lat)),
                         **kw)
    assert np.array_equal(got.images, plain.images)
    assert [s[:2] for s in steps] == [s[:2] for s in eager_steps] and len(steps) == 2
    for (_, _, a), (_, _, b) in zip(steps, eager_steps):
        assert np.array_equal(a, b)
    base = pipe.generate("a cat", segment=(0, 1), **kw)
    assert base.state_device.is_cuda
    rest = pipe.generate("a cat", segment=(1, 2), latents_state=base.state_device, **kw)
    assert np.array_equal(rest.images, plain.images)
    ucfg = pipe.bundle.unet_cfg
    pipe.set_controlnet(testing.random_controlnet(ucfg, vae_scale=2, seed=1, device="cuda"), ucfg)
    hint = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    first = pipe.generate("a cat", control_image=hint, **kw)
    pipe.set_controlnet(testing.random_controlnet(ucfg, vae_scale=2, seed=2, device="cuda"), ucfg)
    second = pipe.generate("a cat", control_image=hint, **kw)
    eager = pipe._generate_eager("a cat", control_image=hint, **kw)
    assert not np.array_equal(first.images, second.images)
    assert np.array_equal(second.images, eager.images)


def test_pipelined_generate_and_styles_on_the_card(cuda, tmp_path):
    """``generate(pipelined=True)`` gives ``generate``'s bytes with several
    requests of one bucket in flight (pinned staging, per-request pinned
    outputs); pipelined requests of two styles, dispatched back to back,
    each equal their serial runs (restores and merges queued behind the
    replays)."""
    from dreamlab_tpu_torch import lora, testing
    from dreamlab_tpu_torch.engine.base import GenSpec
    from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
    from dreamlab_tpu_torch.pipeline import LCMPipeline
    from dreamlab_tpu_torch.utils.safetensors import save_file

    pipe = LCMPipeline(testing.random_bundle(tiny=True, seed=3, device="cuda"))
    kw = dict(height=64, width=64, num_inference_steps=2)
    serial = [pipe.generate("a cat", seed=s, **kw) for s in (1, 2, 3)]
    flight = [pipe.generate("a cat", seed=s, pipelined=True, **kw) for s in (1, 2, 3)]
    for want, res in zip(serial, flight):
        res.wait()
        assert np.array_equal(res.images, want.images)
        assert np.array_equal(res.latents, want.latents)
    styles = {}
    for name, seed in (("A", 5), ("B", 6)):
        path = str(tmp_path / f"{name}.safetensors")
        save_file(testing.random_lora(pipe.unet_params, rank=4, seed=seed), path)
        styles[name] = lora.StyleDef(name=name, path=path, strengths=(4.0,))
    worker = CudaPipelineWorker(pipe, styles=styles)
    specs = [GenSpec("a cat", size="64x64", num_inference_steps=2, seed=7, style=st,
                     style_level=1) for st in ("A", "B", None)]
    want = [worker.run_job(s) for s in specs]
    assert len({png for png, _ in want}) == 3
    for _ in range(3):
        finals = [worker.run_job_pipelined(s) for s in specs]
        assert [f() for f in finals] == want


def test_batched_library_calls_give_every_row_its_solo_bytes(cuda):
    """The SD1.5 batch-8 bucket at 512² captured through the worker, its eager
    run probing every key (``ops/batching.py``): some calls were captured
    batched; each key decided batched, run on fresh seeded inputs of its
    recorded shapes and strides, gives every row the bytes of that row's solo
    call; and every row of the batch replay (PNG) equals its solo replay's."""
    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.engine.base import GenSpec
    from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
    from dreamlab_tpu_torch.ops import batching
    from dreamlab_tpu_torch.pipeline import LCMPipeline
    from dreamlab_tpu_torch.scripts.ab_batching import record_sites
    from dreamlab_tpu_torch.utils import tracing

    worker = CudaPipelineWorker(LCMPipeline(testing.random_bundle("sd15", seed=0,
                                                                  device="cuda")))
    specs = [GenSpec("a cat on a sofa", size="512x512", seed=100 + i) for i in range(8)]
    batching.reset()
    sites = {}
    before = tracing.counters().get("batching.calls_batched", 0)
    with record_sites(sites):
        coalesced = worker.run_jobs(specs)
    assert tracing.counters().get("batching.calls_batched", 0) > before
    batched = [full for full, rows in batching.decisions().items() if rows > 1]
    assert batched and all(rows in (1, 8) for rows in batching.decisions().values())
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        for full in batched:
            xs = [torch.empty_strided(shape, stride, dtype=dtype, device="cuda")
                  .normal_(generator=gen) for dtype, shape, stride in full[2:]]
            out = sites[full].fn(*xs)
            for i in range(8):
                solo = sites[full].fn(*(x[i:i + 1] for x in xs))
                assert batching.same_bytes(out[i:i + 1], solo), (full, i)
    assert coalesced == [worker.run_job(s) for s in specs]


def test_capture_on_one_thread_while_another_replays(cuda):
    """A bucket captured on one thread (device lock exclusive, the
    "thread_local" capture mode) while another thread replays another
    pipeline's bucket and runs eager convs on a stream of its own: every
    result equals its serial run."""
    import threading

    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.models import superres
    from dreamlab_tpu_torch.models.configs import SuperResConfig
    from dreamlab_tpu_torch.pipeline import LCMPipeline, device_lock

    a = LCMPipeline(testing.random_bundle(tiny=True, seed=3, device="cuda"))
    b = LCMPipeline(testing.random_bundle(tiny=True, seed=4, device="cuda"))
    kw = dict(num_inference_steps=2)
    want_a = [a.generate("a cat", height=64, width=64, seed=s, **kw).images for s in range(6)]
    cfg = SuperResConfig(tile=32)
    params = testing.random_espcn(cfg, seed=1, device="cuda")
    y = torch.rand(96, 80, device="cuda")
    want_sr = superres.upscale_luma(params, cfg, y).cpu()
    errors, got_a, got_sr = [], [], []
    go = threading.Event()

    def replays():
        go.wait(10)
        stream = torch.cuda.Stream()
        try:
            for s in range(6):
                got_a.append(a.generate("a cat", height=64, width=64, seed=s, **kw).images)
                with device_lock("cuda").shared(), torch.cuda.stream(stream):
                    out = superres.upscale_luma(params, cfg, y)
                stream.synchronize()
                got_sr.append(out.cpu())
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=replays)
    t.start()
    go.set()
    captured = [b.warmup(h, w, steps=2) for h, w in ((64, 64), (32, 64), (64, 32))]
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert all(np.array_equal(g, w) for g, w in zip(got_a, want_a)) and len(got_a) == 6
    assert all(torch.equal(g, want_sr) for g in got_sr)
    assert len(b._compiled) == 3 and all(c["capture_s"] > 0 for c in captured)
    for (h, w) in ((64, 64), (32, 64), (64, 32)):
        res = b.generate("a dog", height=h, width=w, seed=9, **kw)
        eager = b._generate_eager("a dog", height=h, width=w, seed=9, **kw)
        assert np.abs(res.images.astype(int) - eager.images.astype(int)).max() <= 1


def test_superres_on_the_card_matches_the_cpu(cuda):
    """The ESPCN forward on cuDNN (fp32, TF32 off) against the CPU's, and the
    colour ops and the bicubic resize byte-equal between card and CPU."""
    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.models import superres
    from dreamlab_tpu_torch.models.configs import SUPERRES
    from dreamlab_tpu_torch.pipeline import deterministic_backends
    from dreamlab_tpu_torch.utils import image_ops

    deterministic_backends()
    params = testing.random_espcn(SUPERRES, seed=2)
    y = torch.rand(300, 250)
    want = superres.upscale_luma(params, SUPERRES, y)
    got = superres.upscale_luma({k: {n: v.cuda() for n, v in d.items()}
                                 for k, d in params.items()}, SUPERRES, y.cuda()).cpu()
    assert (got - want).abs().max().item() < 1e-4
    assert (torch.round(got * 255) - torch.round(want * 255)).abs().max().item() <= 1
    rgb = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (123, 77, 3)).astype(np.uint8))
    for fn in (image_ops.rgb_to_ycbcr, image_ops.ycbcr_to_rgb,
               lambda x: image_ops.resize_bicubic(x, (231, 369)),
               lambda x: image_ops.resize_bicubic(x, (40, 50))):
        assert torch.equal(fn(rgb.cuda()).cpu(), fn(rgb))


def test_group_norm_at_2e31_values(cuda):
    """bf16 [8, 1024, 1024, 256]: 2^31 values, the VAE decode of a run_jobs of
    8 SDXL requests. Each batch row against the plain fp32 version of that
    row alone, and byte-equal to the kernel's batch-1 output of that row."""
    shape = (8, 1024, 1024, 256)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    for i in range(shape[0]):
        x[i] = torch.randn(shape[1:], generator=g, device=cuda).to(torch.bfloat16)
    scale, bias = _gn_params(256, torch.bfloat16, cuda)
    got = gn.fused_group_norm_silu(x, scale, bias, groups=32)
    for i in range(shape[0]):
        row = x[i:i + 1]
        want = gn.group_norm_plain(row.float(), scale.float(), bias.float(), groups=32,
                                   silu=True)
        _assert_close(got[i:i + 1], want, None, TOL_BF16)
        del want
        assert torch.equal(got[i:i + 1], gn.fused_group_norm_silu(row, scale, bias, groups=32))


def test_group_norm_coeffs_match_plain(cuda):
    x = _randn((2, 32, 32, 640), torch.float32, cuda, 6) + 3.0
    scale = torch.ones(640, device=cuda)
    bias = torch.zeros(640, device=cuda)
    before = (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES)
    a, b = gn.group_norm_coeffs(x, scale, bias, groups=32)
    assert (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    a0, b0 = gn.group_norm_coeffs_plain(x, scale, bias, groups=32)
    assert (a - a0).abs().max().item() <= 1e-5
    assert (b - b0).abs().max().item() <= 1e-5


def test_scale_shift_silu_launches_the_apply_kernel(cuda):
    x = _randn((2, 16, 16, 320), torch.bfloat16, cuda, 8)
    scale, bias = _gn_params(320, torch.bfloat16, cuda)
    a, b = gn.group_norm_coeffs_plain(x.float(), scale.float(), bias.float(), groups=32)
    before = (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES)
    got = gn.scale_shift_silu(x, a, b)
    assert (gn.LAUNCHES, gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES) == (
        before[0] + 1, before[1], before[2] + 1)
    _assert_close(got, gn.scale_shift_silu_plain(x.float(), a, b), None, TOL_BF16)
