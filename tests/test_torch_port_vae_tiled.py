"""The port's tiled VAE decode against the JAX package's, on the CPU.

``_tile_starts`` and ``_feather`` are exact; ``decode_tiled`` is held to
JAX's at 16-latent tiles (atol 1e-4, the VAE bound of
tests/test_torch_port_models.py). The fault this repairs: the port decoded
the whole frame where the JAX pipeline decodes tiled (latent side above
``DREAMLAB_VAE_CHUNK``), so a tiny ``generate`` with the chunk set low on
both sides must match JAX (latents rtol 1e-4 / atol 1e-3; pixels within +-1,
under 1 % moved), and a full-frame decode of the same latents must not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import vae as jvae
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import convert
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import vae as tvae
from dreamlab_tpu_torch.pipeline import LCMPipeline
from tests.test_torch_port_img2img import port_bundle_of
from tests.test_torch_port_models import _np_tree


@pytest.mark.parametrize("extent,tile,stride", [(24, 16, 8), (25, 16, 8), (16, 16, 8),
                                                (168, 64, 48), (96, 64, 48), (200, 64, 56)])
def test_tile_starts_match_jax(extent, tile, stride):
    assert tvae._tile_starts(extent, tile, stride) == jvae._tile_starts(extent, tile, stride)


@pytest.mark.parametrize("n_px,ramp_px", [(128, 32), (512, 128), (16, 0)])
def test_feather_matches_jax(n_px, ramp_px):
    for lo in (False, True):
        for hi in (False, True):
            np.testing.assert_array_equal(tvae._feather(n_px, ramp_px, lo, hi).numpy(),
                                          jvae._feather(n_px, ramp_px, lo, hi))


@pytest.fixture(scope="module")
def tiny_vae():
    params = jvae.init_decoder_params(jcfg.TINY_VAE, np.random.RandomState(0))
    return params, convert.from_jax_numpy(_np_tree(params))


@pytest.mark.parametrize("shape,tile,overlap", [((2, 24, 24), 16, 8), ((1, 16, 40), 16, 4)])
def test_decode_tiled_matches_jax(tiny_vae, shape, tile, overlap):
    jparams, tparams = tiny_vae
    lat = np.random.RandomState(1).randn(*shape, 4).astype(np.float32)
    want = np.asarray(jvae.decode_tiled(jparams, jcfg.TINY_VAE, jnp.asarray(lat), tile=tile,
                                        overlap=overlap))
    got = tvae.decode_tiled(tparams, tcfg.TINY_VAE, torch.from_numpy(lat), tile=tile,
                            overlap=overlap)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_decode_tiled_passes_through_below_one_tile(tiny_vae):
    _, tparams = tiny_vae
    lat = torch.from_numpy(np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32))
    torch.testing.assert_close(tvae.decode_tiled(tparams, tcfg.TINY_VAE, lat, tile=16),
                               tvae.decode(tparams, tcfg.TINY_VAE, lat), rtol=0, atol=0)


def _pixels_close(got, want) -> bool:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_generate_above_the_chunk_decodes_tiled_as_jax_does(monkeypatch):
    monkeypatch.setenv("DREAMLAB_VAE_CHUNK", "12")
    monkeypatch.setenv("DREAMLAB_VAE_TILE", "8")
    jb = jax_random_bundle("sd15", tiny=True, seed=3)
    port = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
    assert (port._vae_chunk, port._vae_tile) == (12, 8)
    call = dict(height=32, width=48, num_inference_steps=2, seed=5)  # latents 16 x 24
    res = port.generate("a cat at sunset", **call)
    jres = JaxPipeline(jb, dtype=jnp.float32).generate("a cat at sunset", **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    assert _pixels_close(res.images, np.asarray(jres.images))
    # the fault: decoding the same latents whole gives another image
    full = tvae.decode(port.vae_params, port.bundle.vae_cfg,
                       torch.from_numpy(res.latents) / port.bundle.vae_cfg.scaling_factor)
    full_u8 = torch.round(torch.clamp(full * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8).numpy()
    assert not _pixels_close(full_u8, np.asarray(jres.images))
    monkeypatch.setenv("DREAMLAB_VAE_CHUNK", "off")
    assert LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")._vae_chunk is None
