"""The port's LoRA parsing, in-place merge, styles and merged-weights cache
against the JAX package's, on the CPU.

Parsing is exact (the same tree paths, tensors and alphas). Merged leaves
are held to ``dreamlab_tpu.lora.merge_lora_into_tree`` on the same weights
(fp32, atol 1e-6; the JAX leaves transposed to the port's [out, in]). The
worker's styled request is held to the JAX worker's at the pipeline bounds
(latents rtol 1e-4 / atol 1e-3; pixels within +-1, under 1 % moved); the
port writes merges into the live leaves (a captured graph reads them there),
so an unstyled request must give the same bytes before and after a styled
one. The cache checks are tests/test_lora_worker.py's, on the port.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu import lora as jlora
from dreamlab_tpu.engine import worker_factory as jwf
from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
from dreamlab_tpu.loader import load_pipeline as jax_load_pipeline
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import convert, loader, lora, testing
from dreamlab_tpu_torch.engine import model_registry as mr
from dreamlab_tpu_torch.engine import worker_factory as twf
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_torch_port_img2img import port_bundle_of
from tests.test_torch_port_loader import _leaves
from tests.test_torch_port_models import _np_tree


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_parsed_equal(got, want):
    for part in ("unet", "text"):
        g, w = getattr(got, part), getattr(want, part)
        assert list(g) == list(w), part
        for path, (down, up, alpha) in w.items():
            np.testing.assert_array_equal(g[path][0].numpy(), down)
            np.testing.assert_array_equal(g[path][1].numpy(), up)
            assert g[path][2] == alpha


@pytest.fixture(scope="module")
def tiny_unet():
    params = junet.init_params(jcfg.TINY_UNET, np.random.RandomState(0))
    return params, convert.from_jax_numpy(_np_tree(params))


@pytest.mark.parametrize("dialect", ["kohya", "diffusers"])
def test_parse_matches_jax(tiny_unet, dialect):
    sd = testing.random_lora(tiny_unet[1], rank=4, dialect=dialect, seed=1)
    got = lora.parse_lora_state_dict(sd)
    _assert_parsed_equal(got, jlora.parse_lora_state_dict(_np(sd)))
    assert sorted(got.unet) == sorted(testing.lora_paths(tiny_unet[1]))
    assert got.num_modules == 48 and not got.text


@pytest.mark.parametrize("scale", [0.7, 1.6])
def test_merged_leaves_match_jax(tiny_unet, scale):
    jparams, tparams = tiny_unet
    sd = testing.random_lora(tparams, rank=4, dialect="kohya", seed=2)
    want = jlora.merge_lora_into_tree(jparams, jlora.parse_lora_state_dict(_np(sd)).unet, scale)
    params = convert.from_jax_numpy(_np_tree(jparams))  # a copy, merged in place
    written = lora.merge_lora_into_tree(params, lora.parse_lora_state_dict(sd).unet, scale)
    assert written == 48
    for (k, got), (_, w) in zip(_leaves(params).items(),
                                _leaves(convert.from_jax_numpy(_np_tree(want))).items()):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
    path = "down.0.attentions.0.blocks.0.attn1.q"
    assert not torch.equal(lora.leaf(params, path), lora.leaf(tparams, path))


def test_scale_zero_is_the_identity(tiny_unet):
    _, tparams = tiny_unet
    params = convert.from_jax_numpy(_np_tree(tiny_unet[0]))
    t = lora.parse_lora_state_dict(testing.random_lora(tparams, rank=2, dialect="diffusers"))
    assert lora.merge_lora_into_tree(params, t.unet, 0.0) == 0
    assert lora.merged_leaves(params, t.unet, 0.0) == {}
    for (k, got), (_, w) in zip(_leaves(params).items(), _leaves(tparams).items()):
        assert torch.equal(got, w), k


def test_text_encoder_keys_match_jax():
    jb = jax_random_bundle("sd15", tiny=True, seed=1)
    text = convert.from_jax_numpy(_np_tree(jb.text_params))
    g = torch.Generator().manual_seed(3)
    sd = {}
    for i, proj, dims in ((0, "self_attn_q_proj", (32, 32)), (1, "mlp_fc1", (64, 32)),
                          (1, "self_attn_out_proj", (32, 32))):
        key = f"lora_te_text_model_encoder_layers_{i}_{proj}"
        sd[f"{key}.lora_down.weight"] = torch.randn((2, dims[1]), generator=g)
        sd[f"{key}.lora_up.weight"] = torch.randn((dims[0], 2), generator=g)
    sd["text_encoder.text_model.encoder.layers.0.mlp.fc2.lora_A.weight"] = torch.randn(
        (2, 64), generator=g)
    sd["text_encoder.text_model.encoder.layers.0.mlp.fc2.lora_B.weight"] = torch.randn(
        (32, 2), generator=g)
    got, want = lora.parse_lora_state_dict(sd), jlora.parse_lora_state_dict(_np(sd))
    _assert_parsed_equal(got, want)
    # the MLP adapters keep "mlp." in their path, which the tower's tree
    # lacks (its fc1 / fc2 sit on the layer): both packages skip them with
    # a warning (ROADMAP Queue 3)
    assert sorted(got.text) == ["layers.0.attn.q", "layers.0.mlp.fc2", "layers.1.attn.out",
                                "layers.1.mlp.fc1"]
    assert lora.leaf(text, "layers.1.mlp.fc1") is None
    merged = jlora.merge_lora_into_tree(jb.text_params, want.text, 0.8)
    lora.merge_lora_into_tree(text, got.text, 0.8)
    for (k, g_), (_, w) in zip(_leaves(text).items(),
                               _leaves(convert.from_jax_numpy(_np_tree(merged))).items()):
        np.testing.assert_allclose(g_.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_ladder_and_style_requests_match_jax():
    s, js = lora.StyleDef(name="x", path="/x"), jlora.StyleDef(name="x", path="/x")
    for level in (-1, 0, 1, 3, 8, 99):
        assert s.strength_for_level(level) == js.strength_for_level(level)
    for req in ((None, 3), ("anime", 0), ("anime", 3), ("anime", "bad"), ("anime", 99),
                ("", 2), ("anime", "4")):
        assert lora.parse_style_request(*req) == jlora.parse_style_request(*req)


# ---------------------------------------------------------------------------
# mode LoRAs: an SDXL kohya file with lora_te2_* keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdxl_dir(tmp_path_factory):
    return testing.write_diffusers_dir(testing.random_bundle("sdxl", tiny=True, seed=11),
                                       str(tmp_path_factory.mktemp("sdxl") / "ckpt"))


def _mixed_te_file(path, towers):
    """UNet modules plus text modules in the kohya dialect for ``towers``
    ("te1": 768 wide, "te2": 1280 wide): both write layers.0's q projection,
    the reference's dict collision; te2 alone writes layers.1's k."""
    g = torch.Generator().manual_seed(5)
    sd = {}
    for key, n_in, n_out in (
            ("lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn1_to_q", 64, 64),
            ("lora_unet_down_blocks_1_attentions_0_transformer_blocks_1_attn2_to_k", 2048, 64)):
        sd[f"{key}.lora_down.weight"] = torch.randn((4, n_in), generator=g) / n_in ** 0.5
        sd[f"{key}.lora_up.weight"] = torch.randn((n_out, 4), generator=g) * 0.05
    for tower, width, layers in (("te1", 768, ((0, "q"),)), ("te2", 1280, ((0, "q"), (1, "k")))):
        if tower not in towers:
            continue
        for i, proj in layers:
            key = f"lora_{tower}_text_model_encoder_layers_{i}_self_attn_{proj}_proj"
            sd[f"{key}.lora_down.weight"] = torch.randn((4, width), generator=g) / width ** 0.5
            sd[f"{key}.lora_up.weight"] = torch.randn((width, 4), generator=g) * 0.05
            sd[f"{key}.alpha"] = torch.tensor(2.0)
    save_file(sd, path)
    return path


@pytest.mark.parametrize("towers", [("te1",), ("te1", "te2")], ids=["te1", "te1+te2"])
def test_mode_loras_give_the_reference_weights(sdxl_dir, tmp_path, towers):
    """The port's apply_mode_loras ends with the JAX package's weights. With
    te2 keys the reference merges them into the first tower (text_params),
    where the 1280-wide delta does not fit the 768-wide leaf: the text merge
    fails after the UNet merged, so the UNet is merged and both towers are
    not (ROADMAP Queue 3)."""
    path = _mixed_te_file(str(tmp_path / "mode.safetensors"), towers)
    entry = types.SimpleNamespace(file=path, strength=0.9)
    jb = jax_load_pipeline(sdxl_dir)
    ref = types.SimpleNamespace(unet_params=jb.unet_params, text_params=jb.text_params)
    jwf.apply_mode_loras(ref, [entry])
    port = LCMPipeline(loader.load_pipeline(sdxl_dir, device="cpu"), dtype=torch.float32,
                       device="cpu")
    before = {k: v.clone() for k, v in _leaves(port.text_params_2).items()}
    twf.apply_mode_loras(port, [entry])
    # the port merged into the placed UNet's packed slots: held to the
    # reference's merged UNet packed as its pipeline packs it
    ref.unet_params = junet.pack_attention_params(ref.unet_params)
    for name in ("unet_params", "text_params"):
        want = _leaves(convert.from_jax_numpy(_np_tree(getattr(ref, name))))
        got = _leaves(getattr(port, name))
        assert list(got) == list(want), name
        for (k, g), w in zip(got.items(), want.values()):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}{k}")
    for k, v in _leaves(port.text_params_2).items():
        assert torch.equal(v, before[k]), k
    fresh = loader.load_pipeline(sdxl_dir, device="cpu")
    q = "down.1.attentions.0.blocks.0.attn1.q"
    assert not torch.equal(lora.leaf(port.unet_params, q), lora.leaf(fresh.unet_params, q))
    assert torch.equal(lora.leaf(port.text_params, "layers.0.attn.q"),
                       lora.leaf(fresh.text_params, "layers.0.attn.q")) == ("te2" in towers)


# ---------------------------------------------------------------------------
# the worker: styles, the merged-weights cache, the registry
# ---------------------------------------------------------------------------


def _style_file(tmp_path, name, unet_params, dialect, seed):
    path = str(tmp_path / f"{name}.safetensors")
    save_file(testing.random_lora(unet_params, rank=4, dialect=dialect, seed=seed), path)
    return lora.StyleDef(name=name, path=path)


@pytest.fixture
def styled(tmp_path, monkeypatch):
    """A port worker on a tiny JAX-initialised bundle with two styles (kohya
    and diffusers dialect), the same bundle's JAX worker, and a counter of
    the port's merges."""
    def make(cache_max=None):
        if cache_max is not None:
            monkeypatch.setenv("DREAMLAB_LORA_CACHE", str(cache_max))
        mr.reset_model_registry()
        jb = jax_random_bundle("sd15", tiny=True, seed=4)
        pb = port_bundle_of(jb)
        styles = {"vivid": _style_file(tmp_path, "vivid", pb.unet_params, "kohya", 10),
                  "noir": _style_file(tmp_path, "noir", pb.unet_params, "diffusers", 20)}
        worker = CudaPipelineWorker(LCMPipeline(pb, dtype=torch.float32, device="cpu"), 0,
                                    styles=styles)
        merges = []
        orig = lora.merged_leaves
        monkeypatch.setattr(lora, "merged_leaves",
                            lambda *a, **k: (merges.append(1), orig(*a, **k))[1])
        return worker, jb, styles, merges

    yield make
    mr.reset_model_registry()


def _spec(style, level=3, seed=1):
    return GenSpec("a cat at sunset", size="16x16", num_inference_steps=2, seed=seed,
                   style=style, style_level=level)


def test_styled_request_matches_the_jax_worker(styled):
    worker, jb, styles, _ = styled()
    jstyles = {n: jlora.StyleDef(name=n, path=s.path) for n, s in styles.items()}
    jworker = TPUPipelineWorker(JaxPipeline(jb, dtype=jnp.float32), 0, styles=jstyles)
    plain = worker.run_job(_spec(None, 0))[0]
    for name in ("vivid", "noir"):
        got, want = worker._generate(_spec(name)), jworker._generate(_spec(name))
        np.testing.assert_allclose(got.latents, np.asarray(want.latents), rtol=1e-4,
                                   atol=1e-3)
        diff = np.abs(got.images.astype(np.int16) - np.asarray(want.images).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name
        assert worker.run_job(_spec(name))[0] != plain
        # the merge was undone in place: unstyled bytes as before
        assert worker.run_job(_spec(None, 0))[0] == plain
    assert worker._active_paths == ()


def test_merged_cache_hit_and_registry_bytes(styled):
    worker, _, _, merges = styled()
    a = worker.run_job(_spec("vivid", seed=42))[0]
    assert len(merges) == 1
    assert worker.run_job(_spec("vivid", seed=42))[0] == a and len(merges) == 1  # cache hit
    worker.run_job(_spec("vivid", level=5))  # another scale: merge #2
    worker.run_job(_spec("vivid", level=3))  # both levels resident (cap 2)
    assert len(merges) == 2
    reg = mr.get_model_registry()
    entries = {m.name: m.hbm_bytes for m in reg.list_models()}
    base = [n for n in entries if n.startswith("lora-base:0:")]
    cached = [n for n in entries if n.startswith("lora:0:")]
    assert len(base) == 1
    assert sorted(n.rsplit(":", 2)[1:] for n in cached) == [["vivid", "3"], ["vivid", "5"]]
    # each registered under the bytes it holds: the 48 touched fp32 leaves,
    # not the whole UNet the reference registers per entry
    leaf_bytes = sum(t.numel() for t in worker._base.values()) * 4
    unet_bytes = sum(t.numel() for t in _leaves(worker.pipeline.unet_params).values()) * 4
    assert len(worker._base) == 48 and leaf_bytes < unet_bytes
    assert entries[base[0]] == leaf_bytes and all(entries[n] == leaf_bytes for n in cached)


def test_merged_cache_eviction_and_close(styled):
    worker, _, _, merges = styled(cache_max=1)
    reg = mr.get_model_registry()
    cached = lambda: [m.name for m in reg.list_models() if m.name.startswith("lora:")]
    worker.run_job(_spec("vivid"))
    assert len(merges) == 1 and len(cached()) == 1 and cached()[0].endswith(":vivid:3")
    worker.run_job(_spec("noir"))  # evicts vivid (cap 1)
    assert len(merges) == 2 and len(cached()) == 1 and cached()[0].endswith(":noir:3")
    worker.run_job(_spec("vivid"))  # merged again after its eviction
    assert len(merges) == 3
    worker.close()
    assert reg.list_models() == []


def test_merged_cache_disabled_and_bounded_by_can_fit(styled, monkeypatch):
    worker, _, _, merges = styled(cache_max=0)
    plain = worker.run_job(_spec(None, 0))[0]
    a = worker.run_job(_spec("vivid"))[0]
    assert worker.run_job(_spec("vivid"))[0] == a and len(merges) == 2
    assert worker._merged_cache == {} and worker.run_job(_spec(None, 0))[0] == plain
    worker, _, _, merges = styled(cache_max=2)
    monkeypatch.setattr(mr.get_model_registry(), "can_fit", lambda n: False)
    worker.run_job(_spec("vivid"))
    worker.run_job(_spec("vivid"))
    assert len(merges) == 2 and worker._merged_cache == {}


def test_two_workers_do_not_collide_in_the_registry(styled):
    first, _, styles, _ = styled()
    second = CudaPipelineWorker(LCMPipeline(port_bundle_of(jax_random_bundle(
        "sd15", tiny=True, seed=4)), dtype=torch.float32, device="cpu"), 0, styles=styles)
    for w in (first, second):
        w.run_job(_spec("vivid"))
    reg = mr.get_model_registry()
    names = [m.name for m in reg.list_models() if m.name.startswith("lora:")]
    assert len(names) == 2 and len(set(names)) == 2
    first.close()
    assert len([m for m in reg.list_models() if m.name.startswith("lora:")]) == 1
    assert len(second._merged_cache) == 1


def test_unknown_style_and_cross_attention_guard(styled):
    worker, _, styles, _ = styled()
    with pytest.raises(ValueError, match="unknown style"):
        worker.run_job(_spec("nope"))
    worker.styles["wide"] = dataclasses.replace(styles["vivid"], required_cross_attention_dim=2048)
    with pytest.raises(ValueError, match="cross_attention_dim"):
        worker.run_job(_spec("wide"))
    assert worker._active_paths == ()


def test_workers_register_with_their_pipeline_devices_registry(styled):
    worker, _, _, _ = styled()
    assert mr.get_model_registry("cpu") is mr.get_model_registry(torch.device("cpu"))
    assert mr.get_model_registry("meta") is not mr.get_model_registry("cpu")
    worker.run_job(_spec("vivid"))
    names = lambda dev: [m.name for m in mr.get_model_registry(dev).list_models()]
    assert any(n.startswith("lora:") for n in names("cpu")) and names("meta") == []
    assert mr.get_model_registry("cpu").device == torch.device("cpu")


def test_registry_counts_registered_bytes_without_device_stats():
    reg = mr.ModelRegistry(total_hbm_bytes=1000, device="cpu")
    assert mr.ModelRegistry(device="cpu").can_fit(10 ** 15)  # no stats: never blocks
    reg.register_model("a", model_path="/a", worker_id=0, hbm_bytes=850)
    assert reg.get_used_hbm() == 850
    assert reg.can_fit(50) and not reg.can_fit(51)  # 90 % headroom of 1000
    stats = reg.get_hbm_stats()
    from dreamlab_tpu.engine.model_registry import ModelRegistry as JaxRegistry

    jstats = JaxRegistry(total_hbm_bytes=1000)
    jstats.register_model("a", model_path="/a", worker_id=0, hbm_bytes=850)
    assert sorted(stats) == sorted(jstats.get_hbm_stats())
    assert stats["models"][0]["vram_gb"] == 0.0 and stats["used_gb"] == 0.0
    assert reg.unregister_model("a") and not reg.unregister_model("a")


# ---------------------------------------------------------------------------
# the style registry and its YAML reader
# ---------------------------------------------------------------------------

STYLES_DOC = '''lora_root: /models/loras
styles:
  anime:
    file: anime-v2.safetensors
    strengths: [0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8]
    required_cross_attention_dim: 768
  crisp:
    file: add-detail-xl.safetensors
    required_cross_attention_dim: 2048
'''  # dreamlab_tpu/engine/styles.py's documented layout

STYLES_ENGINE_TEST = '''
lora_root: /loras
styles:
  anime:
    file: anime-v2.safetensors
    strengths: [0.5, 1.0]
    required_cross_attention_dim: 768
  crisp: detail.safetensors
'''  # tests/test_engine.py::test_style_registry_yaml's file

YAML_DOCS = {
    "styles_doc": STYLES_DOC,
    "engine_test": STYLES_ENGINE_TEST,
    "scalars": ("# a comment\nroot: '/a b'  # trailing\nn: ~\ne:\nq: \"x\\ty\"\n"
                "f: [1, -2.5, .5, 1_000, 1.5e3, 08, 'it''s', null, +3., -.inf]\n"
                "nested:\n    deep:\n        k: v-w\n"),
    "empty": "\n# nothing\n",
    "block_list": "a:\n  - x\n",
    "flow_map": "a: {b: 1}\n",
}


@pytest.mark.parametrize("name", list(YAML_DOCS))
def test_yaml_lite_reads_as_safe_load(name):
    import yaml

    from dreamlab_tpu_torch.utils import yaml_lite

    assert yaml_lite.loads(YAML_DOCS[name]) == yaml.safe_load(YAML_DOCS[name])


@pytest.mark.parametrize("doc", ["a: true", "a: off", "a:\n  - - x", "a: &x 1", "a: *x",
                                 "a: !!str 1", "a: 2020-01-01", "a: 0x1F", "a: 012",
                                 "a: 1:30", "---\na: 1", "a: [1, [2]]", "a: {b: {c: 1}}",
                                 "a: b: c", "a: |\n  text", "a: 'open", "a:\n\tb: 1",
                                 "a: [1,\n  2]", "just a scalar"])
def test_yaml_lite_raises_outside_its_subset(doc):
    from dreamlab_tpu_torch.utils import yaml_lite

    with pytest.raises(ValueError, match="yaml_lite"):
        yaml_lite.loads(doc)


@pytest.mark.parametrize("doc", [STYLES_DOC, STYLES_ENGINE_TEST], ids=["doc", "engine_test"])
def test_style_registry_matches_jax(tmp_path, monkeypatch, doc):
    from dreamlab_tpu.engine.styles import load_style_registry as jax_load
    from dreamlab_tpu_torch.engine import styles

    path = tmp_path / "styles.yaml"
    path.write_text(doc)
    want = {n: dataclasses.asdict(s) for n, s in jax_load(str(path)).items()}
    assert {n: dataclasses.asdict(s) for n, s in styles.load_style_registry(str(path)).items()} \
        == want
    monkeypatch.setenv("STYLES_CONFIG", str(path))
    styles.reset_style_registry()
    try:
        assert sorted(styles.get_style_registry()) == sorted(want)
        assert styles.get_style_registry() is styles.get_style_registry()
    finally:
        styles.reset_style_registry()
    assert styles.load_style_registry(str(tmp_path / "missing.yaml")) == {}
