"""The plain versions of the port's kernels against the JAX package, on the CPU.

The JAX side runs the way tests/test_attention.py runs it: its XLA reference
path, and its Pallas kernels in interpret mode. Tolerances: attention 2e-5
(fp32 softmax and two fp32 contractions in another order); GroupNorm 1e-5
(fp32 statistics; the Pallas kernel's E[x^2] - mean^2 agrees with the
two-pass variance to ~1e-6 at zero-mean inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamlab_tpu.models import layers as jl
from dreamlab_tpu.ops.attention import _xla_attention
from dreamlab_tpu_torch.ops import attention as tattn
from dreamlab_tpu_torch.ops import flash_attention as tfa
from dreamlab_tpu_torch.ops import groupnorm as tgn


def _qkv(seed, b, n, m, h, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, h, d).astype(np.float32),
            rs.randn(b, m, h, d).astype(np.float32),
            rs.randn(b, m, h, d).astype(np.float32))


def _plain(q, k, v):
    return tfa.attention_plain(*map(torch.from_numpy, (q, k, v)), q.shape[-1] ** -0.5).numpy()


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 256, 256, 2, 40),
    (1, 256, 200, 2, 64),
    (1, 256, 77, 2, 80),
    (2, 256, 256, 8, 40),   # head packing geometry of test_attention.py (pack 2)
    (2, 256, 256, 6, 40),   # pack 3
    (1, 128, 77, 6, 40),    # packed heads with masked keys
])
def test_attention_plain_matches_jax(b, n, m, h, d):
    q, k, v = _qkv(n + m + h + d, b, n, m, h, d)
    scale = d ** -0.5
    got = _plain(q, k, v)
    want_xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), scale))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=2e-5)
    with pltpu.force_tpu_interpret_mode():
        from dreamlab_tpu.ops.flash_attention import flash_attention

        want_flash = np.asarray(flash_attention(*map(jnp.asarray, (q, k, v)),
                                                scale=scale, block_q=128))
    np.testing.assert_allclose(got, want_flash, rtol=0, atol=2e-5)


def test_dispatch_on_cpu_takes_plain_path_and_launches_nothing():
    q, k, v = _qkv(0, 1, 256, 256, 2, 40)  # a flash-eligible shape
    before = tfa.LAUNCHES
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), _plain(q, k, v), rtol=0, atol=0)
    forced = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), impl="flash")
    np.testing.assert_allclose(forced.numpy(), _plain(q, k, v), rtol=0, atol=0)
    assert tfa.LAUNCHES == before

    x = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 4, 16).astype(np.float32))
    before = (tgn.LAUNCHES, tgn.STATS_LAUNCHES, tgn.APPLY_LAUNCHES)
    tgn.fused_group_norm_silu(x, torch.ones(16), torch.zeros(16), groups=4)
    a, b = tgn.group_norm_coeffs(x, torch.ones(16), torch.zeros(16), groups=4)
    tgn.scale_shift_silu(x, a, b)
    assert (tgn.LAUNCHES, tgn.STATS_LAUNCHES, tgn.APPLY_LAUNCHES) == before


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor on neither the CPU nor a CUDA device is refused."""
    q = torch.empty((1, 256, 2, 40), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    x = torch.empty((1, 4, 4, 16), device="meta")
    p = torch.empty((16,), device="meta")
    with pytest.raises(ValueError):
        tgn.fused_group_norm_silu(x, p, p, groups=4)
    with pytest.raises(ValueError):
        tgn.scale_shift_silu(x, torch.empty((1, 16), device="meta"),
                             torch.empty((1, 16), device="meta"))


def _gn_inputs(seed, shape, *, offset=0.0, unit_affine=False):
    rs = np.random.RandomState(seed)
    x = (offset + rs.randn(*shape)).astype(np.float32)
    c = shape[-1]
    if unit_affine:
        return x, np.ones(c, np.float32), np.zeros(c, np.float32)
    return x, rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)


@pytest.mark.parametrize("shape,groups,tile,silu,unit", [
    ((1, 5, 3, 16), 4, 8, False, True),   # 15 rows, tile 8: the padded-tile path
    ((1, 5, 3, 16), 4, 8, True, True),
    ((2, 8, 8, 32), 8, 32, True, False),
    ((1, 16, 12, 64), 16, 32, True, False),
    ((1, 16, 12, 64), 16, 32, False, False),
])
def test_group_norm_plain_matches_jax(shape, groups, tile, silu, unit):
    from dreamlab_tpu.ops.groupnorm import fused_group_norm_silu

    x, s, b = _gn_inputs(0, shape, unit_affine=unit)
    got = tgn.group_norm_plain(*map(torch.from_numpy, (x, s, b)), groups=groups,
                               silu=silu).numpy()
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(fused_group_norm_silu(
            *map(jnp.asarray, (x, s, b)), groups=groups, silu=silu, tile=tile))
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)
    params = {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}
    want = (jl.group_norm_silu(params, jnp.asarray(x), groups=groups) if silu
            else jl.group_norm(params, jnp.asarray(x), groups=groups))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)

    # the plain K2/K3 pair composes to the same function
    a, sh = tgn.group_norm_coeffs_plain(*map(torch.from_numpy, (x, s, b)), groups=groups)
    y = tgn.scale_shift_silu_plain(torch.from_numpy(x), a, sh, silu=silu).numpy()
    np.testing.assert_allclose(y, got, rtol=0, atol=1e-5)


def test_group_norm_plain_keeps_digits_at_large_mean():
    """x = 100 + N(0, 1): the two-pass variance of layers.group_norm (which
    the port matches) keeps the digits that E[x^2] - mean^2 loses.

    Tolerance 1e-4 against a float64 reference, not 1e-5: an fp32 value near
    100 is itself only good to ~4e-6, and the fp32 group mean of 256 such
    values carries a summation-order error of a few 1e-5, so two fp32
    implementations (the port's and layers.group_norm) land ~1e-4 apart.
    The Pallas kernel's E[x^2] - mean^2 misses by more than 1e-3.
    """
    from dreamlab_tpu.ops.groupnorm import fused_group_norm_silu

    shape, groups = (2, 8, 8, 32), 8
    x, s, b = _gn_inputs(3, shape, offset=100.0)
    xd = x.astype(np.float64).reshape(shape[0], -1, groups, shape[-1] // groups)
    mean = xd.mean(axis=(1, 3), keepdims=True)
    var = np.square(xd - mean).mean(axis=(1, 3), keepdims=True)
    y = ((xd - mean) / np.sqrt(var + 1e-5)).reshape(shape) * s + b
    exact = y / (1 + np.exp(-y))

    got = tgn.group_norm_plain(*map(torch.from_numpy, (x, s, b)), groups=groups,
                               silu=True).numpy()
    want = np.asarray(jl.group_norm_silu(
        {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x), groups=groups))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)
    np.testing.assert_allclose(want, exact, rtol=0, atol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(fused_group_norm_silu(*map(jnp.asarray, (x, s, b)),
                                                  groups=groups))
    assert np.abs(pallas - exact).max() > 1e-3


# ---------------------------------------------------------------------------
# the GroupNorm cluster kernel's geometry and the order of its sums
# ---------------------------------------------------------------------------

# (H*W, C) of every GroupNorm call of one SD1.5 512x512 request (UNet, VAE)
_CENSUS = [(4096, 320), (4096, 640), (4096, 960), (1024, 320), (1024, 640), (1024, 960),
           (1024, 1280), (256, 640), (256, 1280), (256, 1920), (64, 1280), (64, 2560),
           (4096, 512), (16384, 512), (65536, 512), (65536, 256), (262144, 256),
           (262144, 128)]


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("hw,c,groups", [(hw, c, 32) for hw, c in _CENSUS]
                         + [(35, 64, 8), (16, 16, 4), (12, 8, 8), (7, 4096, 1)])
def test_group_norm_geometry(hw, c, groups, elt):
    """Slabs of whole groups in whole 16-byte vectors, at least 64 bytes
    wide; clusters of up to 16 blocks, each with rows to read; a thread for
    every vector of a slab row. (The geometry takes no batch size, so a row
    is summed the same way alone or in a batch.)"""
    slab, cluster, rows, threads = tgn.geometry(hw, c, groups, elt)
    vec = 16 // elt
    assert c % slab == 0 and slab % (c // groups) == 0 and slab % vec == 0
    assert slab * elt >= tgn.MIN_SLAB_BYTES or slab == c
    assert cluster in (1, 2, 4, 8, 16)
    assert rows == -(-hw // cluster) and (cluster - 1) * rows < hw
    assert threads % 32 == 0 and slab // vec <= threads <= 1024
    if (hw, c) in _CENSUS[:7]:  # the UNet's inputs at 64^2 and 32^2
        assert cluster * (c // slab) >= 128  # about the card's 132 SMs at batch 1


def _cluster_stats(x, groups, elt):
    """numpy emulation of how gn_cluster_kernel splits one batch row [HW, C]:
    block rank r of a slab's cluster takes rows r, r + cluster, ...; its
    thread of row group ri the block's rows ri, ri + rg, ... Each thread's
    per-channel (mean, M2) is merged into the block's per-group (mean, M2),
    then the cluster's over its blocks, here as sum(n_i m_i) / n and
    sum(M2_i + n_i (m_i - mean)^2) (the kernel merges the same parts with
    Chan's update inside a block)."""
    hw, c = x.shape
    slab, cluster, rows, threads = tgn.geometry(hw, c, groups, elt)
    cg, vec = c // groups, 16 // elt
    rg = threads // (slab // vec)

    def combine(parts):
        n = sum(p[0] for p in parts)
        mean = sum(p[0] * p[1] for p in parts) / n
        return n, mean, sum(p[2] + p[0] * (p[1] - mean) ** 2 for p in parts)

    mean, var = np.zeros(groups), np.zeros(groups)
    for c0 in range(0, c, slab):
        blocks = []
        for rank in range(cluster):
            mine = x[rank::cluster, c0:c0 + slab]
            assert len(mine) <= rows
            parts = [[] for _ in range(slab // cg)]
            for ri in range(rg):
                col = mine[ri::rg]
                for ch in range(slab):
                    v = col[:, ch]
                    parts[ch // cg].append((len(v), v.mean() if len(v) else 0.0,
                                            ((v - v.mean()) ** 2).sum() if len(v) else 0.0))
            blocks.append([combine(p) if len(mine) else (0, 0.0, 0.0) for p in parts])
        for gi in range(slab // cg):
            n, m, m2 = combine([b[gi] for b in blocks])
            assert n == hw * cg  # every row counted once
            mean[c0 // cg + gi], var[c0 // cg + gi] = m, m2 / n
    return mean, var


@pytest.mark.parametrize("hw,c,groups", [(512, 320, 32), (4096, 128, 32), (35, 64, 8),
                                         (64, 2560, 32)])
def test_cluster_kernel_order_of_sums_matches_the_two_pass_statistics(hw, c, groups):
    """Every row is counted once, in the blocks' and row groups' split, and
    the merged mean and variance are the two-pass ones of the plain version."""
    x = (3.0 + np.random.RandomState(hw + c).randn(hw, c)).astype(np.float32)
    _, want_mean, want_var = tgn._group_stats(torch.from_numpy(x)[None], groups)
    for elt in (2, 4):
        mean, var = _cluster_stats(x.astype(np.float64), groups, elt)
        np.testing.assert_allclose(mean, want_mean.numpy().ravel(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(var, want_var.numpy().ravel(), rtol=1e-5, atol=0)
