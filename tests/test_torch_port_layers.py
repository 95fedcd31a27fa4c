"""The port's configs and layers against the JAX package's, on the CPU.

Same numpy inputs through both, fp32. Tolerances: 1e-5 for norms and
elementwise layers (fp32 rounding and summation order only), 1e-4 for convs
(fp32 sums over up to kh*kw*Cin products in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import layers as jl
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import layers as tl


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", ["SD15_TEXT", "SD15_UNET", "SD15_VAE",
                                  "TINY_TEXT", "TINY_UNET", "TINY_VAE"])
def test_config_presets_field_equal(name):
    want, got = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1)])
def test_conv2d_matches_jax(stride, k):
    rs = np.random.RandomState(stride * 10 + k)
    x = rs.randn(2, 8, 10, 5).astype(np.float32)
    w = rs.randn(k, k, 5, 7).astype(np.float32)  # HWIO
    b = rs.randn(7).astype(np.float32)
    want = jl.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     stride=stride)
    got = tl.conv2d({"w": _t(w).permute(3, 2, 0, 1), "b": _t(b)}, _t(x), stride=stride)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_linear_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 6).astype(np.float32)
    w = rs.randn(6, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    want = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tl.linear({"w": _t(w).t(), "b": _t(b)}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def _norm_params(rs, c):
    return rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)


@pytest.mark.parametrize("fn", ["group_norm", "group_norm_silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norms_match_jax(fn, eps):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 5, 16).astype(np.float32)
    s, b = _norm_params(rs, 16)
    want = getattr(jl, fn)({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                           jnp.asarray(x), groups=4, eps=eps)
    got = getattr(tl, fn)({"scale": _t(s), "bias": _t(b)}, _t(x), groups=4, eps=eps)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_jax():
    rs = np.random.RandomState(2)
    x = (3 + rs.randn(2, 7, 24)).astype(np.float32)
    s, b = _norm_params(rs, 24)
    want = jl.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = tl.layer_norm({"scale": _t(s), "bias": _t(b)}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_geglu_and_quick_gelu_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 6).astype(np.float32)
    w = rs.randn(6, 8).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    want = jl.geglu({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tl.geglu({"w": _t(w).t(), "b": _t(b)}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.quick_gelu(_t(x)).numpy(),
                               _np(jl.quick_gelu(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0.0), (33, False, 1.0)])
def test_timestep_embedding_matches_jax(dim, flip, shift):
    t = np.asarray([999, 759, 1, 0], np.int32)
    want = jl.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip,
                                 downscale_freq_shift=shift)
    got = tl.timestep_embedding(torch.from_numpy(t), dim, flip_sin_to_cos=flip,
                                downscale_freq_shift=shift)
    # atol 1e-4, not 1e-5: angles reach ~1000 rad, where one fp32 ulp of a
    # frequency (XLA's exp vs torch's) moves the angle by ~6e-5
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
    # at small timesteps the angles are small and the two agree to 1e-5
    small = np.asarray([0, 1, 3], np.int32)
    np.testing.assert_allclose(
        tl.timestep_embedding(torch.from_numpy(small), dim, flip_sin_to_cos=flip,
                              downscale_freq_shift=shift).numpy(),
        _np(jl.timestep_embedding(jnp.asarray(small), dim, flip_sin_to_cos=flip,
                                  downscale_freq_shift=shift)),
        rtol=1e-5, atol=1e-5)


def test_nearest_upsample_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32)
    want = jl.nearest_upsample(jnp.asarray(x))
    got = tl.nearest_upsample(_t(x))
    np.testing.assert_array_equal(got.numpy(), _np(want))
