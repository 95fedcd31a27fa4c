"""The flash kernels' dispatch in the port: K1's ``route``, the attention
dispatch that asks it, the wgmma kernel's tile rule, and the head-group
kernel's ``route`` (K4 and K6).

``ops/flash_attention.py::route`` names the kernel a call launches from the
inputs alone: "wgmma" (csrc/flash_wgmma.cu) for bf16 that TMA can describe,
"scalar" (csrc/flash_attention.cu) for fp32, None for anything else, which
``ops/attention.py::_flash_supported`` then sends to the plain path. These
tests hold the rule at every shape the pipelines give K1 (as the packed
projection's views and as contiguous tensors), at the inputs no kernel
takes, and the CPU path's result to the JAX package's attention on the
packed views. ``ops/flash_group.py::route`` makes the same choice for the
head-group kernels (csrc/flash_group_wgmma.cu, csrc/flash_group.cu) at the
probes' shapes and the census's head-group shapes. The tests named
``..._go_to_mma`` hold inputs that the mma.sync kernels, since removed,
used to take: no kernel takes them now.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamlab_tpu.ops.attention import _xla_attention
from dreamlab_tpu_torch.ops import attention as tattn
from dreamlab_tpu_torch.ops import flash_attention as tfa
from dreamlab_tpu_torch.ops import flash_group as tfg

# [B, N, H, D] of every K1 self-attention site: SD1.5 at 512² (txt2img,
# img2img, styles, ControlNet's trunk, the mesh's data axis; batch 8 on the
# run_jobs path), SDXL at 1024² (its cfg mode doubles the batch) and
# 1344x768, the refiner at 1024², SD1.5 on the mesh's model axis (4 heads a
# rank)
CENSUS = [
    (1, 4096, 8, 40), (1, 1024, 8, 80), (8, 4096, 8, 40), (8, 1024, 8, 80),
    (1, 4096, 10, 64), (1, 1024, 20, 64), (2, 4096, 10, 64), (2, 1024, 20, 64),
    (1, 4032, 10, 64), (1, 1008, 20, 64),
    (1, 4096, 12, 64), (1, 1024, 24, 64), (1, 256, 24, 64),
    (1, 4096, 4, 40), (1, 1024, 4, 80),
]


def _packed(b, n, h, d, dtype=torch.bfloat16):
    """q, k, v as views of one [B, N, 3, H*D] projection output (token stride 3*H*D)."""
    buf = torch.empty((b, n, 3, h * d), dtype=dtype)
    return tuple(buf[:, :, i].view(b, n, h, d) for i in range(3))


def _contiguous(b, n, h, d, dtype=torch.bfloat16):
    return tuple(torch.empty((b, n, h, d), dtype=dtype) for _ in range(3))


@pytest.mark.parametrize("layout", [_packed, _contiguous], ids=["packed", "contiguous"])
@pytest.mark.parametrize("b,n,h,d", CENSUS)
def test_every_census_shape_takes_the_wgmma_route(layout, b, n, h, d):
    q, k, v = layout(b, n, h, d)
    assert tfa.route(q, k, v) == "wgmma"


@pytest.mark.parametrize("d", [20, 7])
def test_head_dims_tma_cannot_take_go_to_mma(d):
    """bf16 at a head dim that is not a multiple of 8: no kernel, the plain path."""
    q, k, v = _contiguous(1, 256, 4, d)
    assert tfa.route(q, k, v) is None
    assert not tattn._flash_supported(q, k, v)


def _unaligned():
    """q an offset view whose base is 2 bytes past a 16-byte boundary, k
    one 16 bytes in (aligned)."""
    buf = torch.empty(1 * 256 * 4 * 64 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    return buf[1:1 + 256 * 4 * 64].view(1, 256, 4, 64), buf[8:8 + 256 * 4 * 64].view(1, 256, 4, 64)


def test_an_unaligned_base_goes_to_mma():
    """An unaligned base in any of q, k and v: no kernel, the plain path."""
    q, k = _unaligned()
    assert tfa.route(k, k, k) == "wgmma"
    assert tfa.route(q, k, k) is tfa.route(k, q, k) is tfa.route(k, k, q) is None
    assert not any(tattn._flash_supported(*qkv) for qkv in ((q, k, k), (k, q, k), (k, k, q)))


def _token_stride_260():
    buf = torch.empty((1, 256, 4 * 64 + 4), dtype=torch.bfloat16)
    return buf[:, :, :256].unflatten(2, (4, 64)), torch.empty((1, 256, 4, 64), dtype=torch.bfloat16)


def test_strides_that_are_not_multiples_of_8_go_to_mma():
    """A token stride of 260 elements: no kernel, the plain path."""
    q, k = _token_stride_260()
    assert q.stride(1) == 260
    assert tfa.route(q, k, k) is None
    assert not tattn._flash_supported(q, k, k)


def _cross_attention():
    q, _, _ = _contiguous(1, 4096, 8, 40)
    k, v, _ = _contiguous(1, 77, 8, 40)
    return q, k, v


@pytest.mark.parametrize("qkv,takes", [
    *(pytest.param(lambda layout=layout, s=s: layout(*s), True,
                   id=f"{layout.__name__[1:]}-{'-'.join(map(str, s))}")
      for s in CENSUS for layout in (_packed, _contiguous)),
    pytest.param(lambda: _contiguous(1, 256, 4, 20), False, id="d20"),
    pytest.param(lambda: _contiguous(1, 256, 4, 7), False, id="d7"),
    pytest.param(lambda: (lambda q, k: (q, k, k))(*_unaligned()), False, id="unaligned-base"),
    pytest.param(lambda: (lambda q, k: (q, k, k))(*_token_stride_260()), False,
                 id="token-stride-260"),
    pytest.param(lambda: _contiguous(1, 256, 8, 160), False, id="d160"),
    pytest.param(_cross_attention, False, id="77-keys"),
])
def test_the_dispatch_takes_the_kernel_exactly_where_route_gives_one(qkv, takes):
    """One rule for the kernel choice: ``_flash_supported`` (shapes, dtype,
    strides and alignment; the device is its caller's check) holds where
    ``route`` names a kernel and both sequences have at least 256 tokens,
    and nowhere else. Every census shape takes it, in both layouts; bf16
    that no kernel takes and d = 160 do not, nor do 77 keys, which a
    kernel would take."""
    q, k, v = qkv()
    assert tattn._flash_supported(q, k, v) is takes
    long = q.shape[1] >= 256 and k.shape[1] >= 256
    assert takes == (long and tfa.route(q, k, v) is not None)
    if takes:
        assert tfa.route(q, k, v) == "wgmma"


@pytest.mark.parametrize("b,n,h,d", [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 256, 4, 20)])
def test_fp32_goes_to_scalar(b, n, h, d):
    q, k, v = _contiguous(b, n, h, d, torch.float32)
    assert tfa.route(q, k, v) == "scalar"


def test_cpu_tensors_compute_the_plain_version_and_count_nothing():
    rs = np.random.RandomState(3)
    buf = torch.from_numpy(rs.randn(1, 256, 3, 4 * 40).astype(np.float32)).bfloat16()
    q, k, v = (buf[:, :, i].view(1, 256, 4, 40) for i in range(3))
    assert tfa.route(q, k, v) == "wgmma"
    before = (tfa.LAUNCHES, dict(tfa.ROUTE_LAUNCHES))
    got = tfa.flash_attention(q, k, v)
    via_dispatch = tattn.dot_product_attention(q, k, v, impl="flash")
    assert (tfa.LAUNCHES, tfa.ROUTE_LAUNCHES) == before
    want = tfa.attention_plain(q, k, v, 40 ** -0.5)
    assert torch.equal(got, want) and torch.equal(via_dispatch, want)


@pytest.mark.parametrize("b,n,m,h,d", [(1, 256, 256, 4, 40), (2, 256, 256, 2, 64),
                                       (1, 128, 128, 2, 80)])
def test_the_plain_version_on_packed_views_matches_jax(b, n, m, h, d):
    """The CPU path on the packed projection's views (what the wgmma route
    reads) against the JAX package's XLA attention and its Pallas kernel in
    interpret mode, on the same fp32 inputs."""
    rs = np.random.RandomState(n + h + d)
    buf = rs.randn(b, n, 3, h * d).astype(np.float32)
    q, k, v = (np.ascontiguousarray(buf[:, :, i].reshape(b, n, h, d)) for i in range(3))
    tbuf = torch.from_numpy(buf)
    tq, tk, tv = (tbuf[:, :, i].view(b, n, h, d) for i in range(3))
    got = tfa.flash_attention(tq, tk, tv).numpy()
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), d ** -0.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    with pltpu.force_tpu_interpret_mode():
        from dreamlab_tpu.ops.flash_attention import flash_attention

        pallas = np.asarray(flash_attention(*map(jnp.asarray, (q, k, v)), scale=d ** -0.5,
                                            block_q=128))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n,h,d,consumers", [
    (1024, 8, 80, 1),   # SD1.5 level 2: 128 blocks of 64 rows, not 64 of 128
    (4096, 8, 40, 2),   # SD1.5 level 1: two waves of 128 rows against two of 192
    (1024, 20, 64, 3),  # SDXL level 2: 120 blocks in one wave, not 160 in two
    (1008, 20, 64, 3),
    (4096, 10, 64, 3),  # SDXL level 1: a tie of rows per SM, K/V shared wider
    (4032, 10, 64, 3),
    (4096, 12, 64, 3), (1024, 24, 64, 2), (256, 24, 64, 1),
    (1024, 2, 128, 2),  # d > 80: two consumers always
    (4096, 4, 40, 2),   # the mesh's model axis: 128 blocks of 128 rows fill the card
    (1024, 4, 80, 1),
    (4096, 8, 80, 2),   # three consumers are built for d <= 64
])
def test_the_tile_rule_at_the_census_shapes(n, h, d, consumers):
    assert tfa.wgmma_consumers(n, h, d) == consumers


def test_the_tile_rule_fills_the_card_at_sd15_and_sdxl():
    """SD1.5's [1, 1024, 8, 80] fills more than the 64 blocks of 128 rows;
    SDXL's [1, 1024, 20, 64] leaves no short second wave on 132 SMs."""
    def blocks(n, h, d):
        c = tfa.wgmma_consumers(n, h, d)
        return -(-n // (tfa.WGMMA_ROWS * c)) * h, c

    sd15, c = blocks(1024, 8, 80)
    assert sd15 > 64 and c == 1  # one-consumer blocks run two to an SM
    sdxl, c = blocks(1024, 20, 64)
    assert c == 3 and sdxl <= tfa.H100_SMS


@pytest.mark.parametrize("n,h,d", sorted({(n, h, d) for _, n, h, d in CENSUS}))
def test_the_tile_rule_reads_no_batch(n, h, d):
    """The rule sees N, H and d (and the SM count) only: a batch row runs
    the blocks of its solo call. Any choice stays within the built
    instances (one consumer and three up to d = 80 and 64)."""
    c = tfa.wgmma_consumers(n, h, d)
    assert c in (1, 2, 3)
    assert c != 3 or d <= 64
    assert c != 1 or d <= 80
    assert tfa.wgmma_consumers(n, h, d, sms=tfa.H100_SMS) == c


# [B, N, H, D, pack] the head-group kernel is given: the probes' K4 shapes
# (pack from pack_geometry) and K6's, and the census shapes whose pack_geometry
# gives a group (chip_smoke.py's time_group): SD1.5 level 1, SDXL's levels,
# 1344x768, the refiner's level 1 and the mesh's model axis
GROUP_SHAPES = [
    (8, 4096, 6, 40, 3), (2, 4096, 10, 64, 2),
    (1, 4096, 8, 40, 2), (1, 4096, 10, 64, 2), (1, 1024, 20, 64, 2),
    (1, 4032, 10, 64, 2), (1, 1008, 20, 64, 2), (1, 4096, 12, 64, 2), (1, 4096, 4, 40, 2),
]


@pytest.mark.parametrize("layout", [_packed, _contiguous], ids=["packed", "contiguous"])
@pytest.mark.parametrize("b,n,h,d,pack", GROUP_SHAPES)
def test_every_group_shape_takes_the_wgmma_group_route(layout, b, n, h, d, pack):
    assert tfa.pack_geometry(h, d)[0] == pack
    q, k, v = layout(b, n, h, d)
    assert tfg.route(q, k, v, pack) == "wgmma"


def test_a_group_token_stride_tma_cannot_take_goes_to_mma():
    """Token stride 6 * 40 + 4 = 244 elements: 488 bytes, not a multiple of
    16. No kernel takes it."""
    buf = torch.empty((1, 256, 6 * 40 + 4), dtype=torch.bfloat16)
    q = buf[:, :, :240].unflatten(2, (6, 40))
    assert q.stride() == (256 * 244, 244, 40, 1)
    k = torch.empty((1, 256, 6, 40), dtype=torch.bfloat16)
    assert tfg.route(k, k, k, 3) == "wgmma"
    assert tfg.route(q, k, k, 3) is tfg.route(k, q, k, 3) is tfg.route(k, k, q, 3) is None


def test_an_unaligned_group_base_goes_to_mma():
    """No kernel takes an unaligned base."""
    q, k = _unaligned()
    assert tfg.route(k, k, k, 2) == "wgmma"
    assert tfg.route(q, k, k, 2) is None


@pytest.mark.parametrize("d,pack", [(20, 2), (7, 3), (36, 3)])
def test_group_head_dims_tma_cannot_take_go_to_mma(d, pack):
    """No kernel takes bf16 at a head dim that is not a multiple of 8."""
    q, k, v = _contiguous(1, 256, 6, d)
    assert tfg.route(q, k, v, pack) is None


@pytest.mark.parametrize("b,n,h,d,pack", [(8, 4096, 6, 40, 3), (1, 256, 4, 20, 2)])
def test_fp32_groups_go_to_scalar(b, n, h, d, pack):
    q, k, v = _contiguous(b, n, h, d, torch.float32)
    assert tfg.route(q, k, v, pack) == "scalar"


@pytest.mark.parametrize("h,d,pack", [
    (6, 40, 4),   # no kernel groups four heads
    (8, 40, 3),   # 8 heads do not split into threes
    (6, 48, 3),   # d over pack 3's 40
    (4, 80, 2),   # d over pack 2's 64
])
def test_the_group_route_refuses_a_group_the_kernels_do_not_take(h, d, pack):
    q, k, v = _contiguous(1, 128, h, d)
    with pytest.raises(ValueError):
        tfg.route(q, k, v, pack)
    with pytest.raises(ValueError):
        tfg.flash_group(q, k, v, pack=pack)


def test_cpu_groups_compute_the_plain_version_and_count_nothing():
    """On the CPU flash_group is flash_group_plain (the JAX probes' Pallas
    kernels hold it in tests/test_torch_probes.py), on the packed views the
    wgmma route would read on the card."""
    rs = np.random.RandomState(5)
    buf = torch.from_numpy(rs.randn(2, 256, 3, 6 * 40).astype(np.float32)).bfloat16()
    q, k, v = (buf[:, :, i].view(2, 256, 6, 40) for i in range(3))
    assert tfg.route(q, k, v, 3) == "wgmma"
    before = (tfg.LAUNCHES, dict(tfg.ROUTE_LAUNCHES))
    got = tfg.flash_group(q, k, v, pack=3)
    assert (tfg.LAUNCHES, tfg.ROUTE_LAUNCHES) == before
    assert torch.equal(got, tfg.flash_group_plain(q, k, v, 40 ** -0.5))


def test_the_group_launch_refuses_cpu_tensors():
    """``launch`` runs a kernel or raises: no plain version behind it."""
    q, k, v = _contiguous(1, 128, 6, 40)
    with pytest.raises(ValueError, match="CUDA"):
        tfg.launch(q, k, v, pack=3, scale=40 ** -0.5)
