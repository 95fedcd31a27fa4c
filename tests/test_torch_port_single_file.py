"""The port's single-file (LDM layout) loader against the JAX package's
``load_single_file``, on the CPU.

Files: the tiny SD1.5, SD2.1, SDXL-base and SDXL-refiner single files of
tests/test_single_file.py and tests/test_single_file_sdxl.py, written by their
exporters. SD1.5-class files load with the SD1.5 presets in both packages;
at tiny size both loaders' presets are patched to the tiny topology (the
tensors' shapes, the cross-attention width 768 or 1024 by which the files
are classified, kept). Exact: configs field for field, trees leaf by leaf
against ``convert.from_jax_numpy`` of the JAX trees (fp32 files, so no
cast). ``generate`` on each file is held to the bounds of
tests/test_torch_port_pipeline.py (latents rtol 1e-4 / atol 1e-3; pixels
within +-1 with under 1 % moved). ``testing.write_single_file`` (the
loader's inverse, which the chip run uses at full width) round-trips a
bundle with the LCM ``cond_proj``, and its worker's PNG equals that of the
same bundle written as a diffusers directory.
"""

import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu import loader_single_file as jlsf
from dreamlab_tpu.models import clip_text as jclip
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.models import vae as jvae
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.utils.tokenizer import make_test_tokenizer
from dreamlab_tpu_torch import loader, loader_single_file as lsf, testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.models import clip_text, unet
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.pipeline import LCMPipeline
from tests.test_loader import export_clip, export_vae_decoder
from tests.test_single_file import SD15_PAIRS, VAE_PAIRS, export_unet_ldm
from tests.test_single_file_sdxl import (
    diffusers_vae_to_ldm,
    export_openclip,
    make_tiny_refiner_single_file,
    make_tiny_sdxl_single_file,
)
from tests.test_torch_port_loader import assert_bundles_equal, assert_trees_equal


def _write_tokenizer(tmp_path, tok):
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(tok.encoder))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        " ".join(p) for p in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)) + "\n")


def _save(tensors, path):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()}, path)
    return path


# the tiny SD1.5-class topology the patched presets give both loaders
TINY_SD_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                    transformer_layers_per_block=(1, 0), num_attention_heads=(2, 2),
                    norm_groups=8, time_cond_proj_dim=8, mid_block_transformer_layers=1)


@pytest.fixture
def tiny_presets(monkeypatch):
    """Both loaders' SD1.5 presets at tiny size (cross-attention width 768)."""
    monkeypatch.setattr(jlsf, "SD15_UNET", jcfg.UNetConfig(**TINY_SD_UNET))
    monkeypatch.setattr(jlsf, "SD15_VAE", jcfg.TINY_VAE)
    monkeypatch.setattr(lsf, "SD15_UNET", tcfg.UNetConfig(**TINY_SD_UNET))
    monkeypatch.setattr(lsf, "SD15_VAE", tcfg.TINY_VAE)


def make_tiny_sd_single_file(tmp_path, *, cad=768, seed=2):
    """An SD1.5-class (cad 768, CLIP ViT-L naming) or SD2.1-class (cad 1024,
    OpenCLIP naming) single file, as tests/test_single_file_sdxl.py's
    test_sd21_single_file_openclip_tower writes it."""
    rs = np.random.RandomState(seed)
    unet_cfg = jcfg.UNetConfig(**{**TINY_SD_UNET, "cross_attention_dim": cad,
                                  "time_cond_proj_dim": None})
    tensors = export_unet_ldm(junet.init_params(unet_cfg, rs), unet_cfg)
    tok = make_test_tokenizer(["cat", "sunset"])
    if cad == 1024:
        tcfg_j = jcfg.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=1024,
                                     num_layers=2, num_heads=16, intermediate_size=64,
                                     hidden_act="gelu", penultimate=True, projection_dim=1024)
        tensors.update(export_openclip(jclip.init_params(tcfg_j, rs),
                                       prefix="cond_stage_model.model."))
    else:
        tcfg_j = jcfg.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=768,
                                     num_layers=2, num_heads=12, intermediate_size=64)
        for k, t in export_clip(jclip.init_params(tcfg_j, rs), tcfg_j).items():
            tensors["cond_stage_model.transformer." + k] = t
    diff_vae = export_vae_decoder(jvae.init_decoder_params(jcfg.TINY_VAE, rs), jcfg.TINY_VAE)
    tensors.update(diffusers_vae_to_ldm(diff_vae, len(jcfg.TINY_VAE.block_out_channels)))
    _write_tokenizer(tmp_path, tok)
    return _save(tensors, str(tmp_path / f"sd_{cad}.safetensors"))


def _assert_generate_matches_jax(bundle, jax_bundle, **extra):
    port = LCMPipeline(bundle, dtype=torch.float32, device="cpu")
    call = dict(height=16, width=16, num_inference_steps=2, seed=3, **extra)
    res = port.generate("a cat at sunset", **call)
    jres = JaxPipeline(jax_bundle, dtype=jnp.float32).generate("a cat at sunset", **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    diff = np.abs(res.images.astype(np.int16) - np.asarray(jres.images).astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, diff.max()


# ---------------------------------------------------------------------------
# key tables against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ldm,diff", SD15_PAIRS)
def test_unet_key_mapping_matches_jax(ldm, diff):
    assert lsf._map_unet_key(ldm, tcfg.SD15_UNET) == diff == jlsf._map_unet_key(
        ldm, jcfg.SD15_UNET)


@pytest.mark.parametrize("ldm,diff", VAE_PAIRS)
def test_vae_key_mapping_matches_jax(ldm, diff):
    assert list(lsf._translate_vae({ldm: torch.zeros(4, 4, 3, 3)}, 4)) == [diff]


@pytest.mark.parametrize("name", ["time_embed.0.cond_proj.weight", "time_embed.cond_proj.weight"])
def test_cond_proj_maps_to_the_time_embedding(name):
    """Both names of the LCM guidance projection reach ``cond_proj`` (the JAX
    package maps the first into ``linear_1`` and drops the second)."""
    assert lsf._map_unet_key(name, tcfg.SD15_UNET) == "time_embedding.cond_proj.weight"


def test_openclip_translation_matches_jax():
    rs = np.random.RandomState(0)
    pre = "conditioner.embedders.1.model."
    src = {pre + "transformer.resblocks.0.attn.in_proj_weight": rs.randn(24, 8),
           pre + "transformer.resblocks.0.attn.in_proj_bias": rs.randn(24),
           pre + "transformer.resblocks.1.mlp.c_fc.weight": rs.randn(16, 8),
           pre + "transformer.resblocks.1.ln_2.bias": rs.randn(8),
           pre + "text_projection": rs.randn(8, 4), pre + "logit_scale": np.float32(4.6),
           pre + "positional_embedding": rs.randn(77, 8)}
    src = {k: np.asarray(v, np.float32) for k, v in src.items()}
    got = lsf._translate_text_openclip({k: torch.from_numpy(v) for k, v in src.items()})
    want = jlsf._translate_text_openclip(src)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


# ---------------------------------------------------------------------------
# whole files against load_single_file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cad", [768, 1024], ids=["sd15", "sd21"])
def test_sd_single_file_matches_jax(tmp_path, tiny_presets, cad, caplog):
    path = make_tiny_sd_single_file(tmp_path, cad=cad)
    with caplog.at_level(logging.WARNING):
        bundle = loader.load_pipeline(path, device="cpu")
    jax_bundle = jlsf.load_single_file(path)
    assert_bundles_equal(bundle, jax_bundle)
    assert bundle.model_dir == path and bundle.arch == "sd15"
    assert bundle.unet_cfg.time_cond_proj_dim is None
    if cad == 1024:
        assert bundle.text_cfg.penultimate_ln and bundle.text_cfg.hidden_act == "gelu"
        assert bundle.tokenizer.pad_id == bundle.tokenizer.encoder["!"]
        assert bundle.unet_cfg.num_attention_heads == (1, 1)  # 64-dim heads
    _assert_generate_matches_jax(bundle, jax_bundle)


@pytest.mark.parametrize("make", [make_tiny_sdxl_single_file, make_tiny_refiner_single_file],
                         ids=["base", "refiner"])
def test_sdxl_single_file_matches_jax(tmp_path, make, caplog):
    path = make(tmp_path)[0]
    with caplog.at_level(logging.WARNING, logger="dreamlab_tpu_torch.loader"):
        bundle = loader.load_pipeline(path, device="cpu")
    jax_bundle = jlsf.load_single_file(path)
    assert_bundles_equal(bundle, jax_bundle)
    assert bundle.arch == "sdxl" and bundle.vae_cfg.scaling_factor == 0.13025
    if make is make_tiny_refiner_single_file:
        assert bundle.text_params_2 is None and bundle.tokenizer.pad_id == 0
    else:
        assert bundle.tokenizer_2.pad_id == 0 and bundle.vae_cfg.block_out_channels == (32, 64)
        # the VAE encoder is read, as the JAX package reads it (assert_bundles_equal
        # held it leaf by leaf), and no tensor is left unconverted
        assert bundle.vae_encoder_params is not None
        assert not any("encoder." in r.getMessage() for r in caplog.records)
    _assert_generate_matches_jax(bundle, jax_bundle, aesthetic_score=6.5)


def test_single_file_without_towers_fails_as_in_jax(tmp_path):
    path = make_tiny_sdxl_single_file(tmp_path)[0]
    from dreamlab_tpu_torch.utils.safetensors import load_file, save_file

    tensors = {k: v for k, v in load_file(path).items() if not k.startswith("conditioner.")}
    path = str(tmp_path / "no_towers.safetensors")
    save_file(tensors, path)
    with pytest.raises(ValueError, match="embedders.0") as got:
        loader.load_pipeline(path, device="cpu")
    with pytest.raises(ValueError) as want:
        jlsf.load_single_file(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", ["none", "sidecar", "sibling"])
def test_sidecar_scheduler_matches_jax(tmp_path, layout):
    ckpt = tmp_path / "m.safetensors"
    ckpt.write_bytes(b"")
    raw = {"prediction_type": "v_prediction", "beta_schedule": "scaled_linear", "unknown": 1}
    if layout == "sidecar":
        (tmp_path / "m.scheduler_config.json").write_text(json.dumps(raw))
    elif layout == "sibling":
        (tmp_path / "scheduler").mkdir()
        (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps(raw))
    got = lsf._load_sidecar_scheduler(str(ckpt))
    assert dataclasses.asdict(got) == dataclasses.asdict(jlsf._load_sidecar_scheduler(str(ckpt)))
    assert got.prediction_type == ("epsilon" if layout == "none" else "v_prediction")


def test_missing_tokenizer_raises_as_in_jax(tmp_path, tiny_presets):
    path = make_tiny_sd_single_file(tmp_path)
    (tmp_path / "tokenizer" / "vocab.json").unlink()
    (tmp_path / "tokenizer" / "merges.txt").unlink()
    (tmp_path / "tokenizer").rmdir()
    with pytest.raises(FileNotFoundError, match="carry no tokenizer") as got:
        loader.load_pipeline(path, device="cpu")
    with pytest.raises(FileNotFoundError) as want:
        jlsf.load_single_file(path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the writer the chip run uses, and a worker on a single file
# ---------------------------------------------------------------------------


def test_write_single_file_round_trips_with_cond_proj(tmp_path, tiny_presets):
    """The port's LDM writer is the loader's inverse: a tiny SD1.5 bundle with
    the LCM ``cond_proj`` comes back leaf for leaf (configs included), and
    its worker's PNG equals that of the same bundle as a diffusers directory."""
    bundle = testing.random_bundle(tiny=True, seed=8)
    bundle.unet_cfg = tcfg.UNetConfig(**{**TINY_SD_UNET, "cross_attention_dim": 768})
    bundle.text_cfg = dataclasses.replace(
        tcfg.SD15_TEXT, vocab_size=bundle.text_cfg.vocab_size, hidden_size=768, num_layers=2,
        num_heads=12, intermediate_size=64)
    gen = torch.Generator().manual_seed(8)
    bundle.unet_params = unet.init_params(bundle.unet_cfg, gen)
    bundle.text_params = clip_text.init_params(bundle.text_cfg, gen)
    path = testing.write_single_file(bundle, str(tmp_path / "one" / "sd15.safetensors"))
    back = loader.load_pipeline(path, device="cpu")
    assert back.unet_cfg == bundle.unet_cfg and back.vae_cfg == bundle.vae_cfg
    # SD1.5 files take the preset's vocabulary size (the JAX package's rule);
    # the ids never reach past the file's embedding rows
    assert back.text_cfg == dataclasses.replace(bundle.text_cfg, vocab_size=49408)
    assert back.scheduler_cfg == bundle.scheduler_cfg
    assert "cond_proj" in back.unet_params["time_embedding"]
    for name in ("text_params", "unet_params", "vae_params"):
        assert_trees_equal(getattr(back, name), getattr(bundle, name))
    directory = testing.write_diffusers_dir(bundle, str(tmp_path / "dir"))
    spec = GenSpec("a cat at sunset", size="16x16", num_inference_steps=4, seed=5,
                   guidance_scale=4.0)
    single = create_cuda_worker(0, path, dtype=torch.float32, device="cpu",
                                warmup_size=(16, 16))
    assert len(single.pipeline._compiled) == 1  # the warmed bucket
    png = single.run_job(spec)[0]
    assert len(single.pipeline._compiled) == 1
    assert png == create_cuda_worker(1, directory, dtype=torch.float32,
                                     device="cpu").run_job(spec)[0]
