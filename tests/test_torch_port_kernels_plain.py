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
    s0, a0 = tgn.STATS_LAUNCHES, tgn.APPLY_LAUNCHES
    tgn.fused_group_norm_silu(x, torch.ones(16), torch.zeros(16), groups=4)
    tgn.group_norm_coeffs(x, torch.ones(16), torch.zeros(16), groups=4)
    assert (tgn.STATS_LAUNCHES, tgn.APPLY_LAUNCHES) == (s0, a0)


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
