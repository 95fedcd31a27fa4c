"""The port's models and scheduler against the JAX package's, on the CPU.

Tiny configs, batch 2, the same weights (JAX init, converted with
``convert.from_jax_numpy``) and the same numpy inputs, fp32. Tolerances:
text encoder 1e-5 (two layers of fp32 matmuls); UNet and VAE 1e-4 (dozens
of convs and norms whose fp32 sums run in another order); scheduler arrays
are the same float64 math cast to float32, so equal; one LCM step 1e-6
(fp32 elementwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.models import clip_text as jclip
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.models import vae as jvae
from dreamlab_tpu.scheduler import lcm as jlcm
from dreamlab_tpu_torch import convert
from dreamlab_tpu_torch.models import clip_text as tclip
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.models import vae as tvae
from dreamlab_tpu_torch.scheduler import lcm as tlcm


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def test_encode_text_matches_jax():
    cfg = tcfg.TINY_TEXT
    params = jclip.init_params(jcfg.TINY_TEXT, np.random.RandomState(0))
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size - 1, (2, 77)).astype(np.int32)
    ids[0, 5:] = cfg.vocab_size - 1  # EOS + EOS padding
    ids[1, 20:] = cfg.vocab_size - 1
    want_seq, want_pooled = jclip.encode_text(params, jnp.asarray(ids), jcfg.TINY_TEXT)
    got_seq, got_pooled = tclip.encode_text(convert.from_jax_numpy(_np_tree(params)),
                                            torch.from_numpy(ids).long(), cfg)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), rtol=0, atol=1e-5)


def test_unet_forward_matches_jax():
    params = junet.init_params(jcfg.TINY_UNET, np.random.RandomState(2))
    rs = np.random.RandomState(3)
    sample = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([999, 259], np.int32)
    ctx = rs.randn(2, 77, 32).astype(np.float32)
    cond = rs.randn(2, 8).astype(np.float32)
    want = junet.forward(params, jcfg.TINY_UNET, jnp.asarray(sample), jnp.asarray(t),
                         jnp.asarray(ctx), timestep_cond=jnp.asarray(cond))
    got = tunet.forward(convert.from_jax_numpy(_np_tree(params)), tcfg.TINY_UNET,
                        torch.from_numpy(sample), torch.from_numpy(t),
                        torch.from_numpy(ctx), timestep_cond=torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_vae_decode_matches_jax():
    params = jvae.init_decoder_params(jcfg.TINY_VAE, np.random.RandomState(4))
    lat = np.random.RandomState(5).randn(2, 6, 8, 4).astype(np.float32)
    want = jvae.decode(params, jcfg.TINY_VAE, jnp.asarray(lat))
    got = tvae.decode(convert.from_jax_numpy(_np_tree(params)), tcfg.TINY_VAE,
                      torch.from_numpy(lat))
    assert got.shape == (2, 12, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _shapes(tree, prefix=""):
    """{path: shape} of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}"))
    return out


def test_random_init_schema_matches_jax():
    """The port's random init builds the JAX package's trees, in torch layout."""
    gen = torch.Generator().manual_seed(0)
    for jtree, ttree in [
        (jclip.init_params(jcfg.TINY_TEXT), tclip.init_params(tcfg.TINY_TEXT, gen)),
        (junet.init_params(jcfg.TINY_UNET), tunet.init_params(tcfg.TINY_UNET, gen)),
        (jvae.init_decoder_params(jcfg.TINY_VAE), tvae.init_decoder_params(tcfg.TINY_VAE, gen)),
    ]:
        assert _shapes(ttree) == _shapes(convert.from_jax_numpy(_np_tree(jtree)))


@pytest.mark.parametrize("steps,orig", [(4, None), (2, None), (8, 25), (1, None)])
def test_schedule_matches_jax(steps, orig):
    cfg = tlcm.LCMConfig()
    np.testing.assert_array_equal(tlcm.lcm_timesteps(cfg, steps, orig),
                                  jlcm.lcm_timesteps(jlcm.LCMConfig(), steps, orig))
    got = tlcm.make_lcm_schedule(cfg, steps, orig)
    want = jlcm.make_lcm_schedule(jlcm.LCMConfig(), steps, orig)
    for field in ("timesteps", "sqrt_alpha_prod", "sqrt_beta_prod", "sqrt_alpha_prod_prev",
                  "sqrt_beta_prod_prev", "c_skip", "c_out", "add_noise"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.init_noise_sigma == want.init_noise_sigma


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_lcm_step_matches_jax(prediction_type):
    sched_t = tlcm.make_lcm_schedule(tlcm.LCMConfig(), 4)
    sched_j = jlcm.make_lcm_schedule(jlcm.LCMConfig(), 4)
    rs = np.random.RandomState(6)
    mo, sample, noise = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3))
    for i in range(4):  # the last step returns the clean prediction unrenoised
        want_prev, want_den = jlcm.lcm_step(sched_j, jnp.int32(i), jnp.asarray(mo),
                                            jnp.asarray(sample), jnp.asarray(noise),
                                            prediction_type=prediction_type)
        got_prev, got_den = tlcm.lcm_step(sched_t, i, torch.from_numpy(mo),
                                          torch.from_numpy(sample), torch.from_numpy(noise),
                                          prediction_type=prediction_type)
        np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_den.numpy(), np.asarray(want_den), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [256, 8, 9])
def test_guidance_scale_embedding_matches_jax(dim):
    w = np.asarray([0.0, 7.5, 1.25], np.float32)
    got = tlcm.guidance_scale_embedding(w, dim)
    want = np.asarray(jlcm.guidance_scale_embedding(w, dim))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
