"""The port's CLIP image tower, its preprocessing and the loader's CLIP part
(``dreamlab_tpu_torch/models/clip_vision.py``, ``loader.py``) against the JAX
package's (``dreamlab_tpu/models/clip_vision.py``, ``dreamlab_tpu/loader.py``)
on the CPU.

Tolerances: features fp32 within atol 1e-5 (the two packages sum in other
orders); the bicubic resize's uint8 pixels equal to PIL's and the normalised
floats within 1e-6; converted leaves equal.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu import loader as jloader
from dreamlab_tpu.models import clip_text as jclip_text
from dreamlab_tpu.models import clip_vision as jclip_vision
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu_torch import loader, testing
from dreamlab_tpu_torch.convert import from_jax_numpy
from dreamlab_tpu_torch.models import clip_vision
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.pipeline import _flat
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _text_cfg(tok):
    return tcfg.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64, projection_dim=16)


@pytest.mark.parametrize("name", ["CLIP_VIT_B32_VISION", "CLIP_VIT_B32_TEXT", "TINY_VISION"])
def test_clip_presets_field_equal(name):
    want, got = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    if hasattr(want, "num_patches"):
        assert got.num_patches == want.num_patches


def test_from_jax_numpy_takes_the_vision_tree():
    """HWIO -> OIHW for the patch conv, [in, out] -> [out, in] for the
    projection; the class and position embeddings and the norms as they are."""
    jp = _np_tree(jclip_vision.init_params(jcfg.TINY_VISION, np.random.RandomState(1)))
    tp = from_jax_numpy(jp)
    np.testing.assert_array_equal(tp["patch_embedding"]["w"].numpy(),
                                  jp["patch_embedding"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["visual_projection"]["w"].numpy(),
                                  jp["visual_projection"]["w"].T)
    np.testing.assert_array_equal(tp["class_embedding"].numpy(), jp["class_embedding"])
    np.testing.assert_array_equal(tp["position_embedding"]["w"].numpy(),
                                  jp["position_embedding"]["w"])
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["q"]["w"].numpy(),
                                  jp["layers"][1]["attn"]["q"]["w"].T)
    np.testing.assert_array_equal(tp["pre_ln"]["scale"].numpy(), jp["pre_ln"]["scale"])
    assert "b" not in tp["visual_projection"] and "b" not in tp["patch_embedding"]


@pytest.mark.parametrize("batch", [1, 3])
def test_encode_image_matches_jax(batch):
    jp = jclip_vision.init_params(jcfg.TINY_VISION, np.random.RandomState(1))
    tp = from_jax_numpy(_np_tree(jp))
    pixels = np.random.RandomState(batch).randn(batch, 32, 32, 3).astype(np.float32)
    want = np.asarray(jclip_vision.encode_image(jp, jnp.asarray(pixels), jcfg.TINY_VISION))
    got = clip_vision.encode_image(tp, torch.from_numpy(pixels), tcfg.TINY_VISION)
    assert got.shape == (batch, tcfg.TINY_VISION.projection_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_a_batch_row_equals_its_solo_run():
    tp = from_jax_numpy(_np_tree(jclip_vision.init_params(jcfg.TINY_VISION,
                                                          np.random.RandomState(1))))
    pixels = torch.from_numpy(np.random.RandomState(5).randn(3, 32, 32, 3).astype(np.float32))
    batch = clip_vision.encode_image(tp, pixels, tcfg.TINY_VISION)
    solo = clip_vision.encode_image(tp, pixels[1:2], tcfg.TINY_VISION)
    assert torch.equal(batch[1:2], solo)


SIZES = [(40, 40), (64, 48), (17, 300), (300, 17), (32, 32)]


def _pil_resize_crop(arr, s):
    """What the JAX package's preprocess does before it normalises."""
    img = Image.fromarray(arr).convert("RGB")
    w, h = img.size
    scale = s / min(w, h)
    nw, nh = max(s, int(round(w * scale))), max(s, int(round(h * scale)))
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - s) // 2, (nh - s) // 2
    return np.asarray(img.crop((left, top, left + s, top + s)))


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_preprocess_matches_jax_pil(h, w):
    """The shortest edge resized as PIL's bicubic, the centre crop and the
    normalisation: uint8 pixels equal to PIL's, floats within 1e-6 of the
    JAX package's."""
    s = tcfg.TINY_VISION.image_size
    img = np.random.RandomState(h * 1000 + w).randint(0, 256, (h, w, 3), np.uint8)
    want = jclip_vision.preprocess_images([img], jcfg.TINY_VISION)
    got = clip_vision.preprocess_images([img], tcfg.TINY_VISION)
    assert got.dtype == torch.float32 and got.shape == (1, s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the uint8 image under the normalisation, against PIL's
    std = torch.tensor(clip_vision.IMAGE_STD)
    mean = torch.tensor(clip_vision.IMAGE_MEAN)
    pix = torch.round((got[0] * std + mean) * 255.0).to(torch.uint8).numpy()
    np.testing.assert_array_equal(pix, _pil_resize_crop(img, s))


def test_preprocess_takes_gray_and_rgba_as_pil_converts_them():
    rs = np.random.RandomState(9)
    gray = rs.randint(0, 256, (40, 56), np.uint8)
    rgba = rs.randint(0, 256, (48, 40, 4), np.uint8)
    want = jclip_vision.preprocess_images([gray, rgba], jcfg.TINY_VISION)
    got = clip_vision.preprocess_images([gray, torch.from_numpy(rgba)], tcfg.TINY_VISION)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _hf_vision_state(rs, cfg, pre_ln):
    """A tiny HF CLIPVisionModel state dict made with numpy."""
    c, ff, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    r = lambda *shape: rs.randn(*shape).astype(np.float32)
    pre = "vision_model."
    state = {pre + "embeddings.patch_embedding.weight": r(c, 3, p, p),
             pre + "embeddings.class_embedding": r(c),
             pre + "embeddings.position_embedding.weight": r(cfg.num_patches + 1, c),
             pre + pre_ln + ".weight": r(c), pre + pre_ln + ".bias": r(c),
             pre + "post_layernorm.weight": r(c), pre + "post_layernorm.bias": r(c),
             "visual_projection.weight": r(cfg.projection_dim, c)}
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            state[f"{b}.{n}.weight"], state[f"{b}.{n}.bias"] = r(c), r(c)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[f"{b}.self_attn.{n}.weight"], state[f"{b}.self_attn.{n}.bias"] = r(c, c), r(c)
        state[f"{b}.mlp.fc1.weight"], state[f"{b}.mlp.fc1.bias"] = r(ff, c), r(ff)
        state[f"{b}.mlp.fc2.weight"], state[f"{b}.mlp.fc2.bias"] = r(c, ff), r(c)
    return state


@pytest.mark.parametrize("pre_ln", ["pre_layrnorm", "pre_layernorm"])
def test_convert_clip_vision_matches_jax_leaf_by_leaf(pre_ln):
    state = _hf_vision_state(np.random.RandomState(3), tcfg.TINY_VISION, pre_ln)
    want = _flat(from_jax_numpy(_np_tree(jloader.convert_clip_vision(state, jcfg.TINY_VISION))))
    got = _flat(loader.convert_clip_vision({k: torch.from_numpy(v) for k, v in state.items()},
                                           tcfg.TINY_VISION))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def test_clip_vision_config_from_json_matches_jax():
    raw = {"image_size": 64, "patch_size": 16, "hidden_size": 48, "num_hidden_layers": 3,
           "num_attention_heads": 4, "intermediate_size": 96, "hidden_act": "gelu",
           "layer_norm_eps": 1e-6, "projection_dim": 24}
    for cfg in (raw, {}):
        assert dataclasses.asdict(loader.clip_vision_config_from_json(cfg)) == \
            dataclasses.asdict(jloader.clip_vision_config_from_json(cfg))


@pytest.fixture(scope="module")
def tiny_clip():
    tok = testing.clip_tokenizer()
    text_cfg = _text_cfg(tok)
    tp, vp = testing.random_clip(text_cfg, tcfg.TINY_VISION, seed=4)
    return tok, text_cfg, tp, vp


@pytest.mark.parametrize("tokenizer_subdir,pre_ln", [(False, "pre_layrnorm"),
                                                     (True, "pre_layernorm")])
def test_load_clip_model_matches_jax(tmp_path, tiny_clip, tokenizer_subdir, pre_ln):
    """A tiny CLIPModel directory written with the port's safetensors writer:
    both packages' loaders give the same text and image features (1e-5)."""
    tok, text_cfg, tp, vp = tiny_clip
    d = testing.write_clip_dir(str(tmp_path / "clip"), tp, text_cfg, vp, tcfg.TINY_VISION, tok,
                               tokenizer_subdir=tokenizer_subdir, pre_ln=pre_ln)
    with open(os.path.join(d, "config.json")) as f:
        assert set(json.load(f)) >= {"projection_dim", "text_config", "vision_config"}
    port = loader.load_clip_model(d, device="cpu")
    jax_model = jloader.load_clip_model(d)
    assert port.device.type == "cpu"
    assert dataclasses.asdict(port.vision_cfg) == dataclasses.asdict(jax_model.vision_cfg)
    rs = np.random.RandomState(3)
    images = [rs.randint(0, 256, (40, 40, 3), np.uint8), rs.randint(0, 256, (64, 48, 3), np.uint8)]
    np.testing.assert_allclose(port.embed_images(images), jax_model.embed_images(images),
                               rtol=0, atol=ATOL)
    for prompt in ("a cat", "a dog at sunset"):
        got, want = port.embed_text(prompt), jax_model.embed_text(prompt)
        assert got.shape == (16,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the weights as written, leaf for leaf
    for mine, written in ((port._vision_params, vp), (port._text_params, tp)):
        a, b = _flat(mine), _flat(written)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_load_clip_model_without_weights_raises(tmp_path, tiny_clip):
    tok, text_cfg, tp, vp = tiny_clip
    d = testing.write_clip_dir(str(tmp_path / "clip"), tp, text_cfg, vp, tcfg.TINY_VISION, tok)
    os.remove(os.path.join(d, "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="no safetensors weights"):
        loader.load_clip_model(d, device="cpu")
    with pytest.raises(FileNotFoundError, match="no safetensors weights"):
        jloader.load_clip_model(d)


def test_load_clip_model_needs_the_card_unless_cpu(tmp_path, tiny_clip, monkeypatch):
    tok, text_cfg, tp, vp = tiny_clip
    d = testing.write_clip_dir(str(tmp_path / "clip"), tp, text_cfg, vp, tcfg.TINY_VISION, tok)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_clip_model(d)


def test_text_features_of_a_clip_model_match_jax(tiny_clip):
    """The CLIPModel text tower's projected pooled output, as the JAX text
    tower gives it on the same weights."""
    tok, text_cfg, tp, _ = tiny_clip
    jtext = jclip_text.init_params(jcfg.CLIPTextConfig(**dataclasses.asdict(text_cfg)),
                                   np.random.RandomState(0))
    from dreamlab_tpu_torch.models import clip_text

    ids = tok("a cat")
    want = np.asarray(jclip_text.encode_text(jtext, jnp.asarray(ids), jcfg.CLIPTextConfig(
        **dataclasses.asdict(text_cfg)))[1])
    got = clip_text.encode_text(from_jax_numpy(_np_tree(jtext)), torch.from_numpy(ids).long(),
                                text_cfg)[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
