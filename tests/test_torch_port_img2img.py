"""The port's img2img and inpainting against the JAX package's, on the CPU.

``encode_moments``: a tiny encoder, JAX's init converted with
``convert.from_jax_numpy``, the same images, fp32, atol 1e-5.
``img2img`` / ``inpaint``: tiny SD1.5 (tests/test_loader.py's checkpoint)
and tiny SDXL (the port's ``write_diffusers_dir``) directories, each loaded
with its VAE encoder by both packages' loaders, the same seed and strength,
held to the bounds of tests/test_torch_port_pipeline.py (latents rtol 1e-4 /
atol 1e-3; pixels within +-1, under 1 % moved). The schedule as device
inputs (one program per bucket for every strength) must equal the float
version exactly, and the worker's ``run_img2img`` must give the pipeline's
image, from a directory and from a single file.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.loader import load_pipeline as jax_load_pipeline
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import vae as jvae
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu_torch import convert, loader, testing
from dreamlab_tpu_torch import loader_single_file as lsf
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.models import clip_text as tclip
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.models import vae as tvae
from dreamlab_tpu_torch.pipeline import LCMPipeline, PipelineBundle
from dreamlab_tpu_torch.scheduler import lcm as tlcm
from dreamlab_tpu_torch.scheduler.lcm import LCMConfig
from dreamlab_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_loader import _leaves, assert_trees_equal
from tests.test_torch_port_models import _np_tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch calls, restored after it:
    the test workers share the CPU, and torch's OpenMP pool, oversubscribed,
    stalls at every op's barrier (the tiny pipelines run ~10x slower).
    Modules that import this fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_bundle_of(jb) -> PipelineBundle:
    """The port's bundle of a JAX ``testing.random_bundle`` (the same words'
    test tokenizer, the trees converted)."""
    same = lambda cfg, cls: None if cfg is None else cls(**dataclasses.asdict(cfg))
    tree = lambda t: None if t is None else convert.from_jax_numpy(_np_tree(t))
    tok = make_test_tokenizer(testing.WORDS)
    return PipelineBundle(
        arch=jb.arch, tokenizer=tok, text_cfg=same(jb.text_cfg, tcfg.CLIPTextConfig),
        text_params=tree(jb.text_params), unet_cfg=same(jb.unet_cfg, tcfg.UNetConfig),
        unet_params=tree(jb.unet_params), vae_cfg=same(jb.vae_cfg, tcfg.VAEConfig),
        vae_params=tree(jb.vae_params), scheduler_cfg=same(jb.scheduler_cfg, LCMConfig),
        tokenizer_2=None if jb.tokenizer_2 is None else tok,
        text_cfg_2=same(jb.text_cfg_2, tcfg.CLIPTextConfig),
        text_params_2=tree(jb.text_params_2),
        vae_encoder_params=tree(jb.vae_encoder_params))


def _pixels_close(got, want):
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1, f"pixel drift: max delta {diff.max()}"
    assert (diff > 0).mean() < 0.01, "more than 1% of pixels moved"


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _half_mask(h, w):
    m = np.zeros((h, w), np.uint8)
    m[:, w // 2:] = 255
    return m


def test_encode_moments_matches_jax():
    params = jvae.init_encoder_params(jcfg.TINY_VAE, np.random.RandomState(0))
    images = np.random.RandomState(1).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jvae.encode_moments(params, jcfg.TINY_VAE, jnp.asarray(images)))
    tparams = convert.from_jax_numpy(_np_tree(params))
    got = tvae.encode_moments(tparams, tcfg.TINY_VAE, torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 12, 8) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    init = tvae.init_encoder_params(tcfg.TINY_VAE, torch.Generator().manual_seed(0))
    shapes = lambda t: {k: tuple(v.shape) for k, v in _leaves(t).items()}
    assert shapes(init) == shapes(tparams)


# ---------------------------------------------------------------------------
# the pipeline against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_dir(tmp_path_factory):
    return make_tiny_checkpoint(tmp_path_factory.mktemp("sd15") / "ckpt")


@pytest.fixture(scope="module")
def sdxl_dir(tmp_path_factory):
    return testing.write_diffusers_dir(testing.random_bundle("sdxl", tiny=True, seed=7),
                                       str(tmp_path_factory.mktemp("sdxl") / "ckpt"))


def _pipes(ckpt):
    port = LCMPipeline(loader.load_pipeline(ckpt, device="cpu", load_vae_encoder=True),
                       dtype=torch.float32, device="cpu")
    jax_pipe = JaxPipeline(jax_load_pipeline(ckpt, load_vae_encoder=True), dtype=jnp.float32)
    return port, jax_pipe


CASES = {
    "sd15-img2img": ("sd15", dict(strength=0.5)),
    "sd15-inpaint": ("sd15", dict(strength=1.0, mask=True)),
    "sdxl-img2img": ("sdxl", dict(strength=0.75, guidance_scale=2.0, negative_prompt="a dog")),
    "sdxl-inpaint": ("sdxl", dict(strength=0.6, mask=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_img2img_and_inpaint_match_jax(case, sd15_dir, sdxl_dir):
    arch, kw = CASES[case]
    port, jax_pipe = _pipes(sd15_dir if arch == "sd15" else sdxl_dir)
    h, w = (16, 24) if arch == "sdxl" else (32, 16)
    kw = dict(kw, num_inference_steps=2, seed=13)
    if kw.pop("mask", False):
        kw["mask"] = _half_mask(h, w)
    res = port.img2img("a cat at sunset", _image(h, w), **kw)
    jres = jax_pipe.img2img("a cat at sunset", _image(h, w), **kw)
    assert res.images.shape == (1, h, w, 3)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    _pixels_close(res.images, jres.images)
    task = "inpaint" if "mask" in kw else "img2img"
    assert [k[-1] for k in port._compiled] == [task]


def test_validation_errors_match_jax(sd15_dir):
    port, jax_pipe = _pipes(sd15_dir)
    img = _image(32, 32)
    for kw, match in ((dict(strength=0.0), "strength"), (dict(strength=1.5), "strength"),
                      (dict(mask=np.zeros((16, 16))), "mask shape")):
        for pipe in (port, jax_pipe):
            with pytest.raises(ValueError, match=match):
                pipe.img2img("x", img, **kw)
    for pipe in (port, jax_pipe):
        with pytest.raises(ValueError, match="multiples"):
            pipe.img2img("x", _image(30, 32))
    no_encoder = LCMPipeline(loader.load_pipeline(sd15_dir, device="cpu"),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no VAE encoder"):
        no_encoder.img2img("x", img)


def test_inpaint_keeps_the_known_latents(sd15_dir):
    """Outside the mask the final latents are the encoded image's (the JAX
    package's test_inpaint_preserves_known_latents), inside they are not."""
    port, _ = _pipes(sd15_dir)
    img, mask = _image(32, 32, seed=1), _half_mask(32, 32)
    res = port.inpaint("whatever", img, mask, num_inference_steps=2, seed=3)
    c, s = port.latent_channels, port.vae_scale
    eps = np.random.RandomState(3).randn(1, c, 32 // s, 32 // s).astype(np.float32)
    image_f = (img[None].astype(np.float32) / 255.0) * 2 - 1
    with torch.inference_mode():
        x0 = port._encode_x0(torch.from_numpy(image_f),
                             torch.from_numpy(eps.transpose(0, 2, 3, 1).copy())).numpy()
    keep = (mask.reshape(32 // s, s, 32 // s, s).max(axis=(1, 3)) == 0)
    np.testing.assert_array_equal(res.latents[0][keep], x0[0][keep])
    assert not np.allclose(res.latents[0][~keep], x0[0][~keep])


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("strength", [1.0, 0.5, 0.3])
def test_device_schedule_step_equals_the_float_step(prediction_type, strength):
    """lcm_step on a schedule of fp32 tensors (the img2img programs' input)
    gives the float version's bits, at every step, the last included."""
    sched = tlcm.make_lcm_schedule(LCMConfig(), 4, None, strength)
    dev = tlcm.schedule_on({f: torch.from_numpy(getattr(sched, f))
                            for f in tlcm.SCHEDULE_FIELDS})
    rs = np.random.RandomState(4)
    sample, out, noise = (torch.from_numpy(rs.randn(2, 8, 8, 4).astype(np.float32))
                          for _ in range(3))
    for i in range(4):
        want = tlcm.lcm_step(sched, i, out, sample, noise, prediction_type=prediction_type)
        got = tlcm.lcm_step(dev, i, out, sample, noise, prediction_type=prediction_type)
        for g, wv in zip(got, want):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, wv, rtol=0, atol=0)


def test_one_bucket_serves_every_strength(sd15_dir):
    """Strength is no part of the key: the bucket made at 0.5 serves 0.75,
    with what a fresh pipeline gives at 0.75."""
    port, _ = _pipes(sd15_dir)
    img = _image(32, 32, seed=2)
    port.img2img("a dog", img, strength=0.5, num_inference_steps=2, seed=6)
    again = port.img2img("a dog", img, strength=0.75, num_inference_steps=2, seed=6)
    assert len(port._compiled) == 1
    fresh, _ = _pipes(sd15_dir)
    want = fresh.img2img("a dog", img, strength=0.75, num_inference_steps=2, seed=6)
    np.testing.assert_array_equal(again.images, want.images)
    np.testing.assert_array_equal(again.latents, want.latents)


# ---------------------------------------------------------------------------
# the worker: run_img2img from a directory and from a single file
# ---------------------------------------------------------------------------


def _png_pixels(png):
    img = Image.open(io.BytesIO(png))
    return np.asarray(img), img.text["parameters"]


def _check_worker(worker, h, w):
    spec = GenSpec("a cat at sunset", num_inference_steps=2, seed=8)
    img, mask = _image(h, w, seed=4), _half_mask(h, w)
    png, seed = worker.run_img2img(spec, img, strength=0.5)
    pixels, text = _png_pixels(png)
    assert seed == 8 and "Strength: 0.5" in text
    want = worker.pipeline.img2img("a cat at sunset", img, strength=0.5,
                                   num_inference_steps=2, seed=8)
    np.testing.assert_array_equal(pixels, want.images[0])
    inpainted, _ = worker.run_img2img(spec, img, strength=1.0, mask=mask)
    want = worker.pipeline.inpaint("a cat at sunset", img, mask, num_inference_steps=2,
                                   seed=8)
    np.testing.assert_array_equal(_png_pixels(inpainted)[0], want.images[0])


def test_run_img2img_from_a_directory(sd15_dir):
    worker = create_cuda_worker(0, sd15_dir, dtype=torch.float32, device="cpu")
    assert worker.pipeline.vae_encoder_params is not None
    _check_worker(worker, 16, 16)


TINY_SD_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                    transformer_layers_per_block=(1, 0), num_attention_heads=(2, 2),
                    norm_groups=8, time_cond_proj_dim=8, mid_block_transformer_layers=1)


def test_run_img2img_from_a_single_file(tmp_path, monkeypatch):
    """An SD1.5-class single file (cross-attention 768, the loader's SD1.5
    presets patched to a tiny topology) carries the encoder."""
    unet_cfg = tcfg.UNetConfig(**TINY_SD_UNET)
    monkeypatch.setattr(lsf, "SD15_UNET", unet_cfg)
    monkeypatch.setattr(lsf, "SD15_VAE", tcfg.TINY_VAE)
    bundle = testing.random_bundle(tiny=True, seed=10)
    gen = torch.Generator().manual_seed(10)
    bundle.unet_cfg, bundle.unet_params = unet_cfg, tunet.init_params(unet_cfg, gen)
    bundle.text_cfg = dataclasses.replace(tcfg.SD15_TEXT, vocab_size=bundle.text_cfg.vocab_size,
                                          num_layers=2, intermediate_size=64)
    bundle.text_params = tclip.init_params(bundle.text_cfg, gen)
    path = testing.write_single_file(bundle, str(tmp_path / "tiny.safetensors"))
    worker = create_cuda_worker(0, path, dtype=torch.float32, device="cpu")
    loaded = worker.pipeline.vae_encoder_params
    assert_trees_equal(loaded, bundle.vae_encoder_params)
    _check_worker(worker, 16, 16)
