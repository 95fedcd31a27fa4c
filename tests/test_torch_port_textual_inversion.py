"""The port's textual inversion against the JAX package's, on the CPU.

File layouts, trigger words and token ids are exact; the tables the
embeddings extend are equal leaf by leaf; a tower's encoding of a prompt
carrying the trigger is held to the JAX tower with the same embeddings
(atol 1e-5, tests/test_torch_port_models.py's text bound). Bundles are the
port's tiny SDXL directory (towers 768 and 1280 wide) loaded by both
packages, with its refiner layout, and JAX's tiny SD1.5 bundle converted.
"""

import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu import textual_inversion as jti
from dreamlab_tpu.loader import load_pipeline as jax_load_pipeline
from dreamlab_tpu.models import clip_text as jclip
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu.utils.tokenizer import make_test_tokenizer as jax_test_tokenizer
from dreamlab_tpu_torch import convert, loader, testing
from dreamlab_tpu_torch import textual_inversion as tti
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.models import clip_text as tclip
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.utils.safetensors import save_file
from dreamlab_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_img2img import port_bundle_of
from tests.test_torch_port_models import _np_tree


def _write(path, tensors):
    save_file({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in tensors.items()},
              str(path))
    return str(path)


def test_file_layouts_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    v = rs.randn(2, 32)
    files = {"a1111": {"emb_params": v}, "diffusers": {"<tok>": v},
             "sdxl": {"clip_l": v, "clip_g": rs.randn(2, 64)}, "vector": {"emb_params": v[0]}}
    for name, tensors in files.items():
        path = _write(tmp_path / f"{name}.safetensors", tensors)
        got, want = tti.load_embedding_file(path), jti.load_embedding_file(path)
        assert list(got) == list(want), name
        for slot, w in want.items():
            assert got[slot].dtype == torch.float32
            np.testing.assert_array_equal(got[slot].numpy(), w)
    bad = _write(tmp_path / "bad.safetensors", {"x": v, "y": v})
    for mod in (tti, jti):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.load_embedding_file(bad)
    for path, override in (("/x/MyStyle.safetensors", None), ("/x/e.safetensors", "Custom")):
        assert tti.trigger_word(path, override) == jti.trigger_word(path, override)


@pytest.mark.parametrize("prompt", ["a cat mystyle", "mystyle", "a style2 cat",
                                    "my-style cat", "a cat, style2, photo", "a plain cat",
                                    "STYLE2!", "a  cat\\tmystyle."])
def test_trigger_ids_match_jax(prompt):
    tok, jtok = make_test_tokenizer(["cat"]), jax_test_tokenizer(["cat"])
    for t in (tok, jtok):
        t.add_trigger("mystyle", [900, 901])
        t.add_trigger("Style2", [910])
        t.add_trigger("my-style", [911])
    assert tok.tokenize(prompt) == jtok.tokenize(prompt)
    np.testing.assert_array_equal(tok(prompt), jtok(prompt))
    assert make_test_tokenizer(["cat"]).tokenize("a plain cat") == tok.tokenize("a plain cat")


@pytest.fixture(scope="module")
def sdxl_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sdxl")
    base = testing.write_diffusers_dir(testing.random_bundle("sdxl", tiny=True, seed=12),
                                       str(root / "base"))
    refiner = str(root / "refiner")
    shutil.copytree(base, refiner)
    for sub in ("text_encoder", "tokenizer"):
        shutil.rmtree(os.path.join(refiner, sub))
    return {"sdxl": base, "refiner": refiner}


def _tables(bundle, jbundle):
    for attr in ("text_params", "text_params_2"):
        t, j = getattr(bundle, attr), getattr(jbundle, attr)
        assert (t is None) == (j is None), attr
        if t is not None:
            np.testing.assert_array_equal(t["token_embedding"]["w"].numpy(),
                                          np.asarray(j["token_embedding"]["w"]), err_msg=attr)


@pytest.mark.parametrize("layout", ["sdxl", "refiner"])
def test_routing_by_width_matches_jax(sdxl_dirs, tmp_path, layout):
    """A dual file goes to both SDXL towers by width; on the refiner layout
    (one 1280-wide tower) the clip_g half applies and clip_l drops. A file
    no tower fits changes nothing (no orphan rows) and counts 0."""
    rs = np.random.RandomState(1)
    dual = _write(tmp_path / "XLStyle.safetensors",
                  {"clip_l": rs.randn(2, 768), "clip_g": rs.randn(3, 1280)})
    wrong = _write(tmp_path / "wrong.safetensors", {"emb_params": rs.randn(2, 999)})
    entries = [types.SimpleNamespace(file=dual, name=None), wrong,
               str(tmp_path / "missing.safetensors")]
    bundle = loader.load_pipeline(sdxl_dirs[layout], device="cpu")
    jbundle = jax_load_pipeline(sdxl_dirs[layout])
    vocab = bundle.text_params["token_embedding"]["w"].shape[0]
    assert tti.apply_embeddings(bundle, entries) == jti.apply_embeddings(jbundle, entries) == 1
    _tables(bundle, jbundle)
    if layout == "sdxl":
        assert bundle.tokenizer.triggers == {"xlstyle": [vocab, vocab + 1]}
        assert bundle.tokenizer_2.triggers == {"xlstyle": [vocab, vocab + 1, vocab + 2]}
    else:
        assert bundle.tokenizer.triggers == {"xlstyle": [vocab, vocab + 1, vocab + 2]}
    assert bundle.tokenizer.triggers == jbundle.tokenizer.triggers
    assert "wrong" not in bundle.tokenizer.triggers


def test_encoded_text_matches_jax_with_the_embeddings(tmp_path):
    jb = jax_random_bundle("sd15", tiny=True, seed=2)
    bundle = port_bundle_of(jb)
    rs = np.random.RandomState(3)
    path = _write(tmp_path / "vivid.safetensors", {"emb_params": rs.randn(2, 32)})
    assert tti.apply_embeddings(bundle, [path]) == jti.apply_embeddings(jb, [path]) == 1
    _tables(bundle, jb)
    ids = bundle.tokenizer(["a vivid cat", "a cat, vivid."])
    np.testing.assert_array_equal(ids, jb.tokenizer(["a vivid cat", "a cat, vivid."]))
    assert (ids >= bundle.text_cfg.vocab_size).any()  # the new rows are read
    want_seq, want_pooled = jclip.encode_text(jb.text_params, jnp.asarray(ids), jb.text_cfg)
    got_seq, got_pooled = tclip.encode_text(convert.from_jax_numpy(_np_tree(jb.text_params)),
                                            torch.from_numpy(ids).long(), bundle.text_cfg)
    got_seq2, _ = tclip.encode_text(bundle.text_params, torch.from_numpy(ids).long(),
                                    bundle.text_cfg)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), rtol=0, atol=1e-5)
    torch.testing.assert_close(got_seq2, got_seq, rtol=0, atol=0)


def test_create_cuda_worker_applies_mode_embeddings(tmp_path):
    """Embeddings reach the loaded worker's tokenizer and its placed table,
    and the trigger changes the image."""
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    ti = _write(tmp_path / "glow.safetensors", {"emb_params": np.random.RandomState(2)
                                                .randn(1, 768) * 0.5})
    worker = create_cuda_worker(0, ckpt, dtype=torch.float32, device="cpu",
                                embeddings=[types.SimpleNamespace(file=ti, name=None)])
    tok = worker.pipeline.bundle.tokenizer
    vocab = worker.pipeline.bundle.text_cfg.vocab_size
    assert tok.triggers == {"glow": [vocab]}
    assert worker.pipeline.text_params["token_embedding"]["w"].shape[0] == vocab + 1
    spec = lambda p: GenSpec(p, size="16x16", num_inference_steps=2, seed=4)
    plain = LCMPipeline(loader.load_pipeline(ckpt, device="cpu"), dtype=torch.float32,
                        device="cpu")
    with_ti = worker.run_job(spec("a glow cat"))[0]
    assert with_ti != worker.run_job(spec("a cat"))[0]
    from tests.test_torch_port_img2img import _png_pixels

    want = plain.generate("a glow cat", height=16, width=16, num_inference_steps=2, seed=4)
    assert not np.array_equal(_png_pixels(with_ti)[0], want.images[0])
