"""The port's checkpoint loading against the JAX package's, on the CPU.

Everything here is exact: the tokenizer's ids, the safetensors reader's bits
(against the ``safetensors`` package, which the port does not use), the
config parsers' fields, and ``load_pipeline``'s trees leaf by leaf against
``convert.from_jax_numpy`` of the JAX loader's trees (the same file values,
only transposed there and back).
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from dreamlab_tpu import loader as jloader
from dreamlab_tpu.scheduler.lcm import load_scheduler_config as jax_load_scheduler_config
from dreamlab_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from dreamlab_tpu_torch import convert, loader, testing
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.scheduler.lcm import load_scheduler_config
from dreamlab_tpu_torch.utils import safetensors as st
from dreamlab_tpu_torch.utils.tokenizer import CLIPTokenizer, make_test_tokenizer
from tests.test_loader import SD15_UNET_JSON, SDXL_UNET_JSON, make_tiny_checkpoint
from tests.test_torch_port_models import _np_tree

# ---------------------------------------------------------------------------
# tokenizer: the checkpoint's declared pad token
# ---------------------------------------------------------------------------


def _tokenizer_dir(path, files):
    tok = make_test_tokenizer(["sun", "cat"])
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps(tok.encoder))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        " ".join(p) for p in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)) + "\n")
    for name, content in files.items():
        (path / name).write_text(json.dumps(content))
    return tok


@pytest.mark.parametrize("files,pad", [
    ({"tokenizer_config.json": {"model_max_length": 77, "pad_token": "!"}}, "!"),
    ({"tokenizer_config.json": {"model_max_length": 77,
                                "pad_token": {"content": "!", "lstrip": False}}}, "!"),
    ({"special_tokens_map.json": {"pad_token": "!"}}, "!"),
    ({"tokenizer_config.json": {"model_max_length": 77},
      "special_tokens_map.json": {"pad_token": {"content": "!"}}}, "!"),
    ({"special_tokens_map.json": {"pad_token": "<|endoftext|>"}}, "<|endoftext|>"),
    ({"tokenizer_config.json": {"pad_token": "<pad-not-in-vocab>"}}, "<|endoftext|>"),
    ({}, "<|endoftext|>"),
], ids=["config-str", "config-addedtoken", "map-str", "map-addedtoken", "map-eos",
        "not-in-vocab", "none"])
def test_from_pretrained_honours_the_declared_pad_token(tmp_path, files, pad):
    tok = _tokenizer_dir(tmp_path / "tokenizer", files)
    got = CLIPTokenizer.from_pretrained(str(tmp_path / "tokenizer"))
    want = JaxTokenizer.from_pretrained(str(tmp_path / "tokenizer"))
    assert got.pad_id == want.pad_id == tok.encoder[pad]
    prompts = ["a sun", "a cat at sunset", ""]
    np.testing.assert_array_equal(got(prompts), want(prompts))
    assert got("a sun")[0, -1] == tok.encoder[pad]


# ---------------------------------------------------------------------------
# safetensors reader and writer against the safetensors package
# ---------------------------------------------------------------------------


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    out = {"w": torch.randn(7, 3, 3, 5, generator=g), "b": torch.randn(7, generator=g),
           "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4),
           "odd": torch.randn(3, generator=g)}
    out = {k: v.to(dtype) for k, v in out.items()}
    out["ids"] = torch.arange(5, dtype=torch.int64)
    return out


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    path = str(tmp_path / "x.safetensors")
    torch_save_file(_tensors(dtype), path, metadata={"format": "pt"})
    got = st.load_file(path)
    want = torch_load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    if dtype != torch.bfloat16:  # numpy has no bf16
        for k, v in np_load_file(path).items():
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert "__metadata__" not in got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_safetensors_writer_is_read_by_the_package(tmp_path, dtype):
    path = str(tmp_path / "x.safetensors")
    tensors = _tensors(dtype)
    st.save_file(tensors, path, {"format": "pt"})
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0  # 8-byte aligned payload
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    back = torch_load_file(path)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(_bits(back[k]), _bits(v)), k


def test_safetensors_reader_copy_on_write_and_bad_offsets(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": torch.ones(4)}, path)
    t = st.load_file(path)["a"]
    t += 1  # the map is private: the file keeps its values
    assert torch.equal(st.load_file(path)["a"], torch.ones(4))
    raw = open(path, "rb").read()
    bad = raw.replace(b'"data_offsets":[0,16]', b'"data_offsets":[0,12]')
    assert bad != raw
    open(path, "wb").write(bad)
    with pytest.raises(ValueError, match="spans bytes"):
        st.load_file(path)


# ---------------------------------------------------------------------------
# config parsers
# ---------------------------------------------------------------------------

TEXT_JSONS = [
    {"architectures": ["CLIPTextModel"], "hidden_size": 768, "num_hidden_layers": 12},
    {"architectures": ["CLIPTextModelWithProjection"], "hidden_size": 1280,
     "num_hidden_layers": 32, "num_attention_heads": 20, "intermediate_size": 5120,
     "hidden_act": "gelu", "projection_dim": 1280},
    {"architectures": ["CLIPTextModel"], "projection_dim": 512},  # no projection head
    {},
]


@pytest.mark.parametrize("raw", [SD15_UNET_JSON, SDXL_UNET_JSON,
                                 testing.unet_config_json(tcfg.SD15_UNET),
                                 testing.unet_config_json(tcfg.SDXL_UNET),
                                 testing.unet_config_json(tcfg.TINY_UNET)],
                         ids=["sd15", "sdxl", "written-sd15", "written-sdxl", "written-tiny"])
def test_unet_config_from_json_matches_jax(raw):
    got = loader.unet_config_from_json(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(jloader.unet_config_from_json(raw))
    if got.cross_attention_dim != tcfg.TINY_UNET.cross_attention_dim:
        assert loader.classify_arch(got.cross_attention_dim) == jloader.classify_arch(
            got.cross_attention_dim)


@pytest.mark.parametrize("cfg", [tcfg.SD15_UNET, tcfg.SDXL_UNET, tcfg.TINY_UNET])
def test_written_unet_config_parses_back(cfg):
    assert loader.unet_config_from_json(json.loads(json.dumps(
        testing.unet_config_json(cfg)))) == cfg


@pytest.mark.parametrize("raw", TEXT_JSONS, ids=["L", "bigG", "no-head", "defaults"])
@pytest.mark.parametrize("penultimate", [False, True])
def test_text_config_from_json_matches_jax(raw, penultimate):
    got = loader.text_config_from_json(raw, penultimate=penultimate)
    want = jloader.text_config_from_json(raw, penultimate=penultimate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("raw", [{}, {"block_out_channels": [16, 32], "layers_per_block": 1,
                                      "norm_num_groups": 8, "scaling_factor": 0.13025}])
def test_vae_config_from_json_matches_jax(raw):
    assert dataclasses.asdict(loader.vae_config_from_json(raw)) == dataclasses.asdict(
        jloader.vae_config_from_json(raw))


def test_classify_arch_rejects_unknown():
    with pytest.raises(ValueError):
        loader.classify_arch(512)


# ---------------------------------------------------------------------------
# load_pipeline against the JAX loader
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def assert_trees_equal(got, want):
    """Same paths, dtypes, shapes and values."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


TREES = [("text_params", "text_params"), ("unet_params", "unet_params"),
         ("vae_params", "vae_params"), ("text_params_2", "text_params_2")]
CONFIGS = ["text_cfg", "unet_cfg", "vae_cfg", "scheduler_cfg", "text_cfg_2"]


def assert_bundles_equal(bundle, jax_bundle):
    assert bundle.arch == jax_bundle.arch
    for name in CONFIGS:
        a, b = getattr(bundle, name), getattr(jax_bundle, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    for name, jname in TREES + [("vae_encoder_params", "vae_encoder_params")]:
        a, b = getattr(bundle, name), getattr(jax_bundle, jname)
        assert (a is None) == (b is None), name
        if a is not None:
            assert_trees_equal(a, convert.from_jax_numpy(_np_tree(b)))
    prompts = ["a cat at sunset", "dog"]
    np.testing.assert_array_equal(bundle.tokenizer(prompts), jax_bundle.tokenizer(prompts))
    if jax_bundle.tokenizer_2 is not None:
        np.testing.assert_array_equal(bundle.tokenizer_2(prompts),
                                      jax_bundle.tokenizer_2(prompts))


def test_load_pipeline_sd15_matches_jax_loader(tmp_path, caplog):
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    with caplog.at_level(logging.WARNING, logger="dreamlab_tpu_torch.loader"):
        bundle = loader.load_pipeline(ckpt, device="cpu")
    assert bundle.model_dir == ckpt and bundle.tokenizer_2 is None
    assert_bundles_equal(bundle, jloader.load_pipeline(ckpt))
    # the VAE encoder's tensors are read on request only: reported, not dropped silently
    assert any("vae" in r.getMessage() and "encoder." in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dreamlab_tpu_torch.loader"):
        bundle = loader.load_pipeline(ckpt, device="cpu", load_vae_encoder=True)
    assert bundle.vae_encoder_params is not None
    assert_bundles_equal(bundle, jloader.load_pipeline(ckpt, load_vae_encoder=True))
    assert not any("encoder." in r.getMessage() for r in caplog.records)


@pytest.fixture(scope="module")
def tiny_sdxl(tmp_path_factory):
    bundle = testing.random_bundle("sdxl", tiny=True, seed=4)
    return bundle, testing.write_diffusers_dir(
        bundle, str(tmp_path_factory.mktemp("sdxl") / "ckpt"))


def test_load_pipeline_sdxl_matches_jax_loader_and_round_trips(tiny_sdxl):
    original, ckpt = tiny_sdxl
    bundle = loader.load_pipeline(ckpt, device="cpu")
    assert bundle.arch == "sdxl" and bundle.text_cfg_2.projection_dim == 32
    assert bundle.text_cfg.penultimate and bundle.text_cfg_2.penultimate
    assert_bundles_equal(bundle, jloader.load_pipeline(ckpt))
    for name in ("text_cfg", "text_cfg_2", "unet_cfg", "vae_cfg", "scheduler_cfg"):
        assert getattr(bundle, name) == getattr(original, name), name
    for name, _ in TREES:
        assert_trees_equal(getattr(bundle, name), getattr(original, name))
    # tokenizer_2 pads with "!" (id 0), tokenizer with EOS
    row, row_2 = bundle.tokenizer("a cat")[0], bundle.tokenizer_2("a cat")[0]
    assert bundle.tokenizer_2.pad_id == 0 and row_2[-1] == 0
    assert row[-1] == bundle.tokenizer.eos_id
    np.testing.assert_array_equal(row[:4], row_2[:4])


def test_load_pipeline_keeps_the_file_dtype(tmp_path):
    """The JAX package's tiny checkpoint, loaded, written back in fp16 by the
    port's writer, and loaded again: fp16 leaves equal to the first load's."""
    original = loader.load_pipeline(make_tiny_checkpoint(tmp_path / "ckpt"), device="cpu")
    half = testing.cast_params(original, torch.float16)
    bundle = loader.load_pipeline(testing.write_diffusers_dir(half, str(tmp_path / "fp16")),
                                  device="cpu")
    for name in ("text_params", "unet_params", "vae_params"):
        assert_trees_equal(getattr(bundle, name), getattr(half, name))


def test_load_pipeline_refiner_layout(tiny_sdxl, tmp_path):
    """Only text_encoder_2/tokenizer_2: that tower is the text tower."""
    import shutil

    _, ckpt = tiny_sdxl
    refiner = str(tmp_path / "refiner")
    shutil.copytree(ckpt, refiner)
    shutil.rmtree(os.path.join(refiner, "text_encoder"))
    shutil.rmtree(os.path.join(refiner, "tokenizer"))
    bundle = loader.load_pipeline(refiner, device="cpu")
    assert bundle.text_params_2 is None and bundle.tokenizer_2 is None
    assert bundle.text_cfg.projection_dim == 32 and bundle.tokenizer.pad_id == 0
    assert_bundles_equal(bundle, jloader.load_pipeline(refiner))


def test_conv_stored_projections_become_linears(tmp_path):
    """SD1.5 checkpoints store proj_in/proj_out as 1x1 convs."""
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    path = os.path.join(ckpt, "unet", "diffusion_pytorch_model.safetensors")
    tensors = torch_load_file(path)
    key = "down_blocks.0.attentions.0.proj_in.weight"
    w = tensors[key]
    tensors[key] = w[:, :, None, None].clone()
    torch_save_file(tensors, path)
    bundle = loader.load_pipeline(ckpt, device="cpu")
    assert torch.equal(bundle.unet_params["down"][0]["attentions"][0]["proj_in"]["w"], w)
    assert_bundles_equal(bundle, jloader.load_pipeline(ckpt))


def test_load_scheduler_config_matches_jax(tmp_path):
    os.makedirs(tmp_path / "scheduler")
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "LCMScheduler", "num_train_timesteps": 1000, "beta_start": 0.001,
        "beta_end": 0.02, "beta_schedule": "linear", "original_inference_steps": 25,
        "prediction_type": "v_prediction", "timestep_scaling": 10.0, "unknown": 1}))
    got = load_scheduler_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_load_scheduler_config(str(tmp_path)))
    assert got.original_inference_steps == 25 and got.prediction_type == "v_prediction"


def test_load_pipeline_refuses_a_single_file_and_needs_cuda_unless_cpu(tiny_sdxl, tmp_path,
                                                                      monkeypatch):
    """A single file goes to the single-file loader, which refuses what is
    not a safetensors file or not a diffusion checkpoint."""
    path = tmp_path / "model.safetensors"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="not a safetensors file"):
        loader.load_pipeline(str(path), device="cpu")
    st.save_file({"unrelated.weight": torch.zeros(2)}, str(path))
    with pytest.raises(ValueError, match="not a diffusion checkpoint"):
        loader.load_pipeline(str(path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_pipeline(tiny_sdxl[1])
