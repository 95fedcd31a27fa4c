"""The port's SDXL slice and classic CFG against the JAX package, on the CPU.

Models: tiny configs, the same weights (JAX init, converted with
``convert.from_jax_numpy``) and the same numpy inputs, fp32, with the
tolerances of tests/test_torch_port_models.py (text tower 1e-5, UNet 1e-4).
Pipeline: one tiny SDXL checkpoint directory written by
``testing.write_diffusers_dir`` and loaded by both packages' loaders, and
``generate`` in the three guidance modes, held to the bounds of
tests/test_torch_port_pipeline.py (latents rtol 1e-4 / atol 1e-3; pixels
within +-1 with under 1 % moved). Worker: batched rows byte-identical to
their solo runs with oneDNN on (its conv algorithm depends on the batch).
"""

import dataclasses
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.loader import load_pipeline as jax_load_pipeline
from dreamlab_tpu.models import clip_text as jclip
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import layers as jlayers
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu_torch import convert, loader, testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.worker_factory import (
    WorkerCreationError,
    create_cuda_worker,
    detect_worker_type,
)
from dreamlab_tpu_torch.models import clip_text as tclip
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import layers as tlayers
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_models import _np_tree, _shapes

# ---------------------------------------------------------------------------
# configs and models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["SDXL_TEXT_L", "SDXL_TEXT_BIGG", "SDXL_UNET", "SDXL_VAE",
                                  "TINY_UNET_XL", "SD15_TEXT", "SD15_UNET", "SD15_VAE"])
def test_presets_are_field_equal_to_jax(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))


def test_gelu_is_exact_and_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(tlayers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)


TEXT_XL = {
    # bigG: exact gelu, penultimate raw state, projected pooled output
    "bigG": dict(hidden_act="gelu", penultimate=True, projection_dim=16),
    # SDXL's CLIP-L tower: quick_gelu, penultimate raw state
    "L": dict(penultimate=True),
    # SD2.x: the penultimate state through the final LayerNorm
    "penultimate_ln": dict(hidden_act="gelu", penultimate=True, penultimate_ln=True),
}


@pytest.mark.parametrize("variant", list(TEXT_XL))
def test_encode_text_sdxl_branches_match_jax(variant):
    jc = dataclasses.replace(jcfg.TINY_TEXT, num_layers=3, **TEXT_XL[variant])
    tc = dataclasses.replace(tcfg.TINY_TEXT, num_layers=3, **TEXT_XL[variant])
    params = jclip.init_params(jc, np.random.RandomState(0))
    rs = np.random.RandomState(1)
    ids = rs.randint(1, tc.vocab_size - 1, (2, 77)).astype(np.int32)
    ids[0, 5], ids[0, 6:] = tc.vocab_size - 1, 0  # EOS, then "!" padding (id 0)
    ids[1, 20:] = tc.vocab_size - 1
    want_seq, want_pooled = jclip.encode_text(params, jnp.asarray(ids), jc)
    tparams = convert.from_jax_numpy(_np_tree(params))
    got_seq, got_pooled = tclip.encode_text(tparams, torch.from_numpy(ids).long(), tc)
    assert got_pooled.shape == (2, tc.projection_dim or tc.hidden_size)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), rtol=0, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert _shapes(tclip.init_params(tc, gen)) == _shapes(tparams)


@pytest.mark.parametrize("lcm", [False, True], ids=["text_time", "text_time+wcond"])
def test_unet_forward_text_time_matches_jax(lcm):
    extra = dict(time_cond_proj_dim=8) if lcm else {}
    jc = dataclasses.replace(jcfg.TINY_UNET_XL, **extra)
    tc = dataclasses.replace(tcfg.TINY_UNET_XL, **extra)
    params = junet.init_params(jc, np.random.RandomState(2))
    rs = np.random.RandomState(3)
    sample = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([999, 259], np.int32)
    ctx = rs.randn(2, 77, 64).astype(np.float32)
    pooled = rs.randn(2, 32).astype(np.float32)
    time_ids = np.asarray([[1024, 1024, 0, 0, 1024, 1024], [768, 512, 16, 0, 768, 512]],
                          np.float32)
    cond = rs.randn(2, 8).astype(np.float32) if lcm else None
    want = junet.forward(params, jc, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                         timestep_cond=None if cond is None else jnp.asarray(cond),
                         added_text_embeds=jnp.asarray(pooled),
                         added_time_ids=jnp.asarray(time_ids))
    tparams = convert.from_jax_numpy(_np_tree(params))
    got = tunet.forward(tparams, tc, torch.from_numpy(sample), torch.from_numpy(t),
                        torch.from_numpy(ctx),
                        timestep_cond=None if cond is None else torch.from_numpy(cond),
                        added_text_embeds=torch.from_numpy(pooled),
                        added_time_ids=torch.from_numpy(time_ids))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert _shapes(tunet.init_params(tc, torch.Generator().manual_seed(0))) == _shapes(tparams)
    with pytest.raises(ValueError, match="added_text_embeds"):
        tunet.forward(tparams, tc, torch.from_numpy(sample), torch.from_numpy(t),
                      torch.from_numpy(ctx))


# ---------------------------------------------------------------------------
# pipeline: the tiny SDXL directory, loaded by both packages
# ---------------------------------------------------------------------------


def _assert_pixels_close(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"pixel drift: max delta {diff.max()}"
    assert (diff > 0).mean() < 0.01, "more than 1% of pixels moved"


def _write(tmp_path_factory, name, bundle):
    return testing.write_diffusers_dir(bundle, str(tmp_path_factory.mktemp(name) / "ckpt"))


@pytest.fixture(scope="module")
def sdxl_dir(tmp_path_factory):
    return _write(tmp_path_factory, "sdxl", testing.random_bundle("sdxl", tiny=True, seed=5))


@pytest.fixture(scope="module")
def sdxl_pipes(sdxl_dir):
    port = LCMPipeline(loader.load_pipeline(sdxl_dir, device="cpu"), dtype=torch.float32,
                       device="cpu")
    return port, JaxPipeline(jax_load_pipeline(sdxl_dir), dtype=jnp.float32)


CALLS = {
    "none": dict(prompt="a cat at sunset", guidance_scale=1.0),
    "cfg": dict(prompt="a mountain", guidance_scale=3.0, negative_prompt="a dog"),
    # per-row guidance and negatives (the worker's coalescing path)
    "cfg_rows": dict(prompt=["a cat", "a dog at sunset"], guidance_scale=[2.0, 6.5],
                     negative_prompt=["", "mountain"]),
}


@pytest.mark.parametrize("case", list(CALLS))
def test_sdxl_generate_matches_jax(sdxl_pipes, case):
    port, jax_pipe = sdxl_pipes
    kw = dict(CALLS[case])
    prompt = kw.pop("prompt")
    call = dict(height=16, width=24, num_inference_steps=2, seed=11, **kw)
    res = port.generate(prompt, **call)
    assert port.cfg_mode(kw["guidance_scale"]) == ("none" if case == "none" else "cfg")
    jres = jax_pipe.generate(prompt, **call)
    assert res.images.shape == np.asarray(jres.images).shape
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    _assert_pixels_close(res.images, np.asarray(jres.images))


def test_sdxl_lcm_wcond_generate_matches_jax(tmp_path_factory):
    """An SDXL UNet with time_cond_proj_dim (LCM-SDXL): guidance as the w-embedding."""
    bundle = testing.random_bundle("sdxl", tiny=True, seed=6)
    bundle.unet_cfg = dataclasses.replace(bundle.unet_cfg, time_cond_proj_dim=8)
    bundle.unet_params = tunet.init_params(bundle.unet_cfg, torch.Generator().manual_seed(6))
    ckpt = _write(tmp_path_factory, "sdxl_lcm", bundle)
    port = LCMPipeline(loader.load_pipeline(ckpt, device="cpu"), dtype=torch.float32,
                       device="cpu")
    assert port.cfg_mode([8.0]) == "wcond"
    call = dict(height=16, width=16, num_inference_steps=2, seed=3, guidance_scale=[1.0, 8.0])
    res = port.generate(["a cat", "a dog"], **call)
    jres = JaxPipeline(jax_load_pipeline(ckpt), dtype=jnp.float32).generate(
        ["a cat", "a dog"], **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    _assert_pixels_close(res.images, np.asarray(jres.images))


def test_micro_conditioning_ids_match_jax(sdxl_pipes):
    port, jax_pipe = sdxl_pipes
    assert port._micro_cond_ids() == jax_pipe._micro_cond_ids() == 6
    for mode in ("none", "cfg"):
        np.testing.assert_array_equal(
            port._time_ids(1024, 768, 3, cfg_mode=mode),
            np.asarray(jax_pipe._time_ids(1024, 768, 3, cfg_mode=mode)))


# ---------------------------------------------------------------------------
# worker and factory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdxl_worker(sdxl_dir):
    return create_cuda_worker(0, sdxl_dir, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("guidance", [(1.0, 1.0, 0.5), (2.0, 4.0, 7.5)], ids=["none", "cfg"])
def test_run_jobs_rows_equal_solo_runs(sdxl_worker, guidance):
    specs = [GenSpec(f"a cat {i}", size="16x16", num_inference_steps=2, seed=s,
                     guidance_scale=g, negative_prompt=n)
             for i, (s, g, n) in enumerate(zip((1, 2, 3), guidance, (None, "a dog", "sunset")))]
    assert all(sdxl_worker.batchable(specs[0], s) for s in specs[1:])
    batched = sdxl_worker.run_jobs(specs)
    assert [seed for _, seed in batched] == [1, 2, 3]
    for (png, _), spec in zip(batched, specs):
        assert png == sdxl_worker.run_job(spec)[0]


def test_worker_passes_negatives_and_splits_guidance_modes(sdxl_worker):
    a = GenSpec("a cat", size="16x16", num_inference_steps=2, seed=4, guidance_scale=3.0)
    assert not sdxl_worker.batchable(a, dataclasses.replace(a, guidance_scale=1.0))
    assert not sdxl_worker.batchable(a, dataclasses.replace(a, aesthetic_score=3.0))
    png = sdxl_worker.run_job(dataclasses.replace(a, negative_prompt="a dog"))[0]
    want = sdxl_worker.pipeline.generate("a cat", height=16, width=16, num_inference_steps=2,
                                         seed=4, guidance_scale=3.0, negative_prompt="a dog")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), want.images[0])
    assert png != sdxl_worker.run_job(a)[0]  # the negative prompt reaches the UNet


def test_create_cuda_worker_serves_the_in_memory_bundle(tmp_path):
    """The loaded worker's PNG equals that of a pipeline built in memory from
    the same (fp16) values: the chip smoke run's loader check, at tiny size."""
    bundle = testing.cast_params(
        loader.load_pipeline(make_tiny_checkpoint(tmp_path / "jax"), device="cpu"),
        torch.float16)
    ckpt = testing.write_diffusers_dir(bundle, str(tmp_path / "ckpt"))
    assert detect_worker_type(ckpt) == "sd15"
    worker = create_cuda_worker(3, ckpt, dtype=torch.float32, device="cpu")
    assert worker.worker_id == 3 and worker.pipeline.bundle.model_dir == ckpt
    memory = CudaPipelineWorker(LCMPipeline(bundle, dtype=torch.float32, device="cpu"))
    spec = GenSpec("a dog at sunset", size="32x16", num_inference_steps=2, seed=9)
    assert worker.run_job(spec)[0] == memory.run_job(spec)[0]


def test_create_cuda_worker_refuses_what_later_slices_bring(sdxl_dir, tmp_path, monkeypatch):
    """A LoRA or a ControlNet cannot serve alone (WorkerCreationError, as in
    the reference); a mode's ControlNet or refiner that cannot be read warns
    and the worker serves without it (the mode's scale falls back to 1.0);
    mode LoRAs and embeddings are served, and a file that cannot be read
    warns and is skipped, as in the reference."""
    path = str(tmp_path / "style.safetensors")
    save_file({"lora_unet_down_blocks_0_attn1_to_q.lora_down.weight": torch.zeros(4, 8)}, path)
    with pytest.raises(WorkerCreationError, match="LoRA"):
        create_cuda_worker(0, path, device="cpu")
    (tmp_path / "controlnet").mkdir()
    (tmp_path / "controlnet" / "config.json").write_text('{"_class_name": "ControlNetModel"}')
    with pytest.raises(WorkerCreationError, match="ControlNet"):
        create_cuda_worker(0, str(tmp_path / "controlnet"), device="cpu")
    worker = create_cuda_worker(
        0, sdxl_dir, dtype=torch.float32, device="cpu",
        controlnet=types.SimpleNamespace(file=str(tmp_path / "no_cn"), scale=0.5),
        refiner=types.SimpleNamespace(file=str(tmp_path / "no_refiner"), switch_at=0.7))
    assert worker.pipeline.controlnet_params is None and worker.controlnet_scale == 1.0
    assert worker.refiner is None and worker.supports_batching
    missing = types.SimpleNamespace(file=str(tmp_path / "x.safetensors"), strength=1.0)
    worker = create_cuda_worker(0, sdxl_dir, dtype=torch.float32, device="cpu",
                                loras=[missing], embeddings=[missing.file])
    assert worker.pipeline.vae_encoder_params is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_cuda_worker(0, sdxl_dir)
