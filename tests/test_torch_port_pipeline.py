"""The port's txt2img slice end to end against the JAX package, on the CPU.

The anchor: the tiny diffusers checkpoint of tests/test_loader.py, loaded by
the JAX package's loader and converted with ``convert.from_jax_numpy``, must
reproduce tests/golden/tiny_sd15_seed7_* within test_golden.py's bounds
(latents rtol 1e-4 / atol 1e-3; pixels within +-1 with under 1% moved) and
match the JAX pipeline's output for the same call.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.loader import load_pipeline
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu_torch import convert
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.pipeline import LCMPipeline, PipelineBundle
from dreamlab_tpu_torch.scheduler.lcm import LCMConfig
from dreamlab_tpu_torch.utils.tokenizer import CLIPTokenizer
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_models import _np_tree

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def port_bundle(jax_bundle, checkpoint_dir) -> PipelineBundle:
    """The port's bundle for a checkpoint the JAX package loaded."""
    same = lambda cfg, cls: cls(**dataclasses.asdict(cfg))
    return PipelineBundle(
        arch=jax_bundle.arch,
        tokenizer=CLIPTokenizer.from_pretrained(os.path.join(checkpoint_dir, "tokenizer")),
        text_cfg=same(jax_bundle.text_cfg, tcfg.CLIPTextConfig),
        text_params=convert.from_jax_numpy(_np_tree(jax_bundle.text_params)),
        unet_cfg=same(jax_bundle.unet_cfg, tcfg.UNetConfig),
        unet_params=convert.from_jax_numpy(_np_tree(jax_bundle.unet_params)),
        vae_cfg=same(jax_bundle.vae_cfg, tcfg.VAEConfig),
        vae_params=convert.from_jax_numpy(_np_tree(jax_bundle.vae_params)),
        scheduler_cfg=same(jax_bundle.scheduler_cfg, LCMConfig),
    )


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    ckpt = make_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "ckpt")
    return ckpt, load_pipeline(ckpt)


def _assert_pixels_close(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"pixel drift: max delta {diff.max()}"
    assert (diff > 0).mean() < 0.01, "more than 1% of pixels moved"


def test_port_reproduces_golden_and_jax(tiny_ckpt):
    ckpt, jax_bundle = tiny_ckpt
    pipe = LCMPipeline(port_bundle(jax_bundle, ckpt), dtype=torch.float32, device="cpu")
    call = dict(height=32, width=32, num_inference_steps=2, seed=7)
    res = pipe.generate("a cat at sunset", **call)
    assert res.images.dtype == np.uint8 and res.images.shape == (1, 32, 32, 3)

    want_lat = np.load(os.path.join(GOLDEN, "tiny_sd15_seed7_latents.npy"))
    np.testing.assert_allclose(res.latents, want_lat, rtol=1e-4, atol=1e-3)
    _assert_pixels_close(res.images, np.load(os.path.join(GOLDEN, "tiny_sd15_seed7_pixels.npy")))

    jres = JaxPipeline(jax_bundle, dtype=jnp.float32).generate("a cat at sunset", **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    _assert_pixels_close(res.images, np.asarray(jres.images))


def test_batched_rows_with_explicit_noise_match_jax(tiny_ckpt):
    """Per-row guidance and explicit noise (the worker's coalescing path)."""
    ckpt, jax_bundle = tiny_ckpt
    pipe = LCMPipeline(port_bundle(jax_bundle, ckpt), dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(11)
    lat = rs.randn(2, 8, 8, 4).astype(np.float32)  # tiny VAE: 2x downsample
    noises = rs.randn(2, 2, 8, 8, 4).astype(np.float32)
    call = dict(height=16, width=16, num_inference_steps=2, guidance_scale=[1.0, 8.0],
                latents=lat, step_noises=noises, seed=0)
    res = pipe.generate(["a dog", "a cat at sunset"], **call)
    jres = JaxPipeline(jax_bundle, dtype=jnp.float32).generate(
        ["a dog", "a cat at sunset"], **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    _assert_pixels_close(res.images, np.asarray(jres.images))


def test_entry_point_needs_cuda_unless_cpu_is_asked(tiny_ckpt, monkeypatch):
    ckpt, jax_bundle = tiny_ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LCMPipeline(port_bundle(jax_bundle, ckpt))


def test_generate_rejects_bad_sizes(tiny_ckpt):
    ckpt, jax_bundle = tiny_ckpt
    pipe = LCMPipeline(port_bundle(jax_bundle, ckpt), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="multiples"):
        pipe.generate("a cat", height=30, width=32)
    with pytest.raises(ValueError, match="guidance_scale"):
        pipe.generate(["a", "b"], height=16, width=16, guidance_scale=[1.0, 2.0, 3.0])
