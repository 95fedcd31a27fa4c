"""The port's packed attention projections against the JAX package's, on the CPU.

``models/unet.py::pack_attention_params`` against
``dreamlab_tpu/models/unet.py::pack_attention_params`` leaf by leaf through
``convert.from_jax_numpy`` (exact); the packed UNet and ControlNet trunk
against the unpacked ones (fp32, rtol 1e-5 / atol 1e-5) and against JAX's
packed forward (``test_unet_forward_matches_jax``'s rtol 1e-4 / atol 1e-4);
a LoRA merged into the packed slots against ``dreamlab_tpu.lora.
merge_lora_into_tree`` on JAX's packed tree (atol 1e-6); a style applied
and restored in place; a slot's tensor-parallel slice; what a placed
pipeline holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu import lora as jlora
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import controlnet as jcn
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.testing import random_controlnet as jax_random_controlnet
from dreamlab_tpu_torch import convert, lora, testing
from dreamlab_tpu_torch.engine import model_registry as mr
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import controlnet as tcn
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.parallel import sharding
from dreamlab_tpu_torch.pipeline import LCMPipeline, _flat
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_loader import _leaves
from tests.test_torch_port_models import _np_tree
from tests.test_torch_port_sharding import _model_mesh

CFGS = {"sd15": (jcfg.TINY_UNET, tcfg.TINY_UNET), "sdxl": (jcfg.TINY_UNET_XL, tcfg.TINY_UNET_XL)}
UNPACKED = ("attn1.q.", "attn1.k.", "attn1.v.", "attn2.k.", "attn2.v.")


def _port(tree):
    return convert.from_jax_numpy(_np_tree(tree))


def _assert_same_leaves(got, want, atol=0.0):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for k, g in got.items():
        assert g.shape == want[k].shape, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


def _inputs(jc, seed=3):
    """sample, timesteps, context and the config's conditioning, numpy, batch 2."""
    rs = np.random.RandomState(seed)
    sample = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([999, 259], np.int32)
    ctx = rs.randn(2, 77, jc.cross_attention_dim).astype(np.float32)
    kw = {}
    if jc.time_cond_proj_dim:
        kw["timestep_cond"] = rs.randn(2, jc.time_cond_proj_dim).astype(np.float32)
    if jc.addition_embed_type == "text_time":
        pooled = jc.projection_class_embeddings_input_dim - 6 * jc.addition_time_embed_dim
        kw["added_text_embeds"] = rs.randn(2, pooled).astype(np.float32)
        kw["added_time_ids"] = np.tile(np.asarray([32, 32, 0, 0, 32, 32], np.float32), (2, 1))
    return sample, t, ctx, kw


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_pack_matches_jax_leaf_by_leaf_and_is_idempotent(arch):
    params = junet.init_params(CFGS[arch][0], np.random.RandomState(0))
    got = tunet.pack_attention_params(_port(params))
    _assert_same_leaves(got, _port(junet.pack_attention_params(params)))
    again = tunet.pack_attention_params(got)
    assert all(a is b for a, b in zip(_leaves(again).values(), _leaves(got).values()))
    site = got["mid"]["attention"]["blocks"][0]
    assert set(site["attn1"]) == {"qkv", "out"} and set(site["attn2"]) == {"q", "kv", "out"}
    c = CFGS[arch][1].block_out_channels[-1]
    assert site["attn1"]["qkv"]["w"].shape == (3, c, c)
    assert site["attn2"]["kv"]["w"].shape == (2, c, CFGS[arch][1].cross_attention_dim)


def test_pack_goes_by_key_name_when_the_context_is_as_wide_as_the_site():
    """TINY_UNET's first level has C = cross_attention_dim = 32: attn2's
    projections are as wide as attn1's, and still pack as k/v beside q.
    Every leaf that is not packed is the input tree's own tensor."""
    params = testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2)  # the UNet's trunk too
    site = params["down"][0]["attentions"][0]["blocks"][0]
    assert site["attn1"]["q"]["w"].shape == site["attn2"]["k"]["w"].shape == (32, 32)
    packed = tunet.pack_attention_params(params)
    blk = packed["down"][0]["attentions"][0]["blocks"][0]
    assert set(blk["attn1"]) == {"qkv", "out"} and set(blk["attn2"]) == {"q", "kv", "out"}
    assert torch.equal(blk["attn2"]["kv"]["w"][0], site["attn2"]["k"]["w"])
    assert torch.equal(blk["attn1"]["qkv"]["w"][2], site["attn1"]["v"]["w"])
    assert blk["attn2"]["q"]["w"] is site["attn2"]["q"]["w"]
    assert blk["ln1"]["scale"] is site["ln1"]["scale"]
    assert packed["zero_down"][0]["w"] is params["zero_down"][0]["w"]


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_packed_unet_forward_equals_unpacked_and_jax(arch):
    jc, tc = CFGS[arch]
    params = junet.init_params(jc, np.random.RandomState(2))
    sample, t, ctx, kw = _inputs(jc)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    unpacked = _port(params)
    want = tunet.forward(unpacked, tc, *_torch(sample, t, ctx), **tkw)
    got = tunet.forward(tunet.pack_attention_params(unpacked), tc, *_torch(sample, t, ctx),
                        **tkw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jwant = junet.forward(junet.pack_attention_params(params), jc, jnp.asarray(sample),
                          jnp.asarray(t), jnp.asarray(ctx),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_packed_controlnet_trunk_equals_unpacked_and_jax(arch):
    jc, tc = CFGS[arch]
    params = jax_random_controlnet(jc, vae_scale=2, seed=7)
    sample, t, ctx, kw = _inputs(jc, seed=4)
    hint = np.random.RandomState(5).rand(2, 16, 16, 3).astype(np.float32)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    unpacked = _port(params)
    emb = tcn.embed_cond(unpacked["cond_embedding"], torch.from_numpy(hint))
    want = tcn.forward(unpacked, tc, *_torch(sample, t, ctx), emb, conditioning_scale=0.7,
                       **tkw)
    got = tcn.forward(tunet.pack_attention_params(unpacked), tc, *_torch(sample, t, ctx), emb,
                      conditioning_scale=0.7, **tkw)
    jpacked = junet.pack_attention_params(params)
    jemb = jcn.embed_cond(jpacked["cond_embedding"], jnp.asarray(hint))
    jwant = jcn.forward(jpacked, jc, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                        jemb, conditioning_scale=0.7,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    for g, w, j in zip([*got[0], got[1]], [*want[0], want[1]], [*jwant[0], jwant[1]]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale", [0.7, 1.6])
def test_lora_merged_into_slots_matches_jax_and_commutes_with_packing(scale):
    jparams = junet.init_params(jcfg.TINY_UNET, np.random.RandomState(0))
    sd = testing.random_lora(_port(jparams), rank=4, dialect="kohya", seed=2)
    jpacked = junet.pack_attention_params(jparams)
    want = jlora.merge_lora_into_tree(jpacked, jlora.parse_lora_state_dict(
        {k: v.numpy() for k, v in sd.items()}).unet, scale)
    modules = lora.parse_lora_state_dict(sd).unet
    packed = tunet.pack_attention_params(_port(jparams))
    ptrs = {k: v.data_ptr() for k, v in _flat(packed).items()}
    assert lora.merge_lora_into_tree(packed, modules, scale) == 48
    assert {k: v.data_ptr() for k, v in _flat(packed).items()} == ptrs  # in place
    _assert_same_leaves(packed, _port(want), atol=1e-6)
    merged_first = _port(jparams)
    lora.merge_lora_into_tree(merged_first, modules, scale)
    _assert_same_leaves(tunet.pack_attention_params(merged_first), packed)
    slot = lora.leaf(packed, "down.0.attentions.0.blocks.0.attn2.v")
    assert slot.data_ptr() == packed["down"][0]["attentions"][0]["blocks"][0]["attn2"][
        "kv"]["w"][1].data_ptr()


def test_a_style_applied_and_restored_gives_back_the_base_bytes(tmp_path):
    mr.reset_model_registry()
    pipe = LCMPipeline(testing.random_bundle(tiny=True, seed=4), dtype=torch.float32,
                       device="cpu")
    path = str(tmp_path / "vivid.safetensors")
    save_file(testing.random_lora(pipe.unet_params, rank=4, seed=10), path)
    worker = CudaPipelineWorker(pipe, 0, styles={"vivid": lora.StyleDef("vivid", path)})
    base = {k: (v.data_ptr(), v.clone()) for k, v in _flat(pipe.unet_params).items()}
    spec = lambda style, level: GenSpec("a cat", size="16x16", num_inference_steps=2, seed=1,
                                        style=style, style_level=level)
    plain = worker.run_job(spec(None, 0))[0]
    try:
        for _ in range(2):  # a first merge, then a cache hit
            worker._apply_style("vivid", 3)
            live = _flat(pipe.unet_params)
            assert not torch.equal(live["mid.attention.blocks.0.attn1.qkv.w"],
                                   base["mid.attention.blocks.0.attn1.qkv.w"][1])
            worker._apply_style(None, 0)
            for k, v in _flat(pipe.unet_params).items():
                assert v.data_ptr() == base[k][0] and torch.equal(v, base[k][1]), k
        assert worker.run_job(spec("vivid", 3))[0] != plain
        assert worker.run_job(spec(None, 0))[0] == plain
    finally:
        worker.close()
        mr.reset_model_registry()


@pytest.mark.parametrize("rank", [0, 1])
def test_a_slot_is_sliced_for_a_model_rank_as_its_packed_leaf_is(rank):
    """``unet_leaf_slice`` on a slot path gives the rank's rows of that slot:
    the slot of the rank's shard of the packed leaf (what a LoRA merge
    writes into a tensor-parallel rank)."""
    pipe = LCMPipeline(testing.random_bundle(tiny=True), dtype=torch.float32, device="cpu")
    placements = sharding.unet_tp_placements(pipe.unet_params, _model_mesh(2),
                                             pipe.bundle.unet_cfg)
    pipe._unet_split, pipe.mesh = _flat(placements), _model_mesh(2, rank)
    shard = _flat(sharding.shard_params(pipe.unet_params, placements, _model_mesh(2, rank)))
    site = "mid.attention.blocks.0"
    for path, (packed, slot) in {"attn1.q": ("attn1.qkv", 0), "attn1.v": ("attn1.qkv", 2),
                                 "attn2.k": ("attn2.kv", 0), "attn2.v": ("attn2.kv", 1)}.items():
        whole = lora.leaf(pipe.unet_params, f"{site}.{path}")
        got = pipe.unet_leaf_slice(f"{site}.{path}.w", whole)
        assert torch.equal(got, shard[f"{site}.{packed}.w"][slot]), path
        assert got.shape[0] * 2 == whole.shape[0]
    q = pipe.unet_params["mid"]["attention"]["blocks"][0]["attn2"]["q"]["w"]
    assert pipe.unet_leaf_slice(f"{site}.attn2.q.w", q).shape[0] * 2 == q.shape[0]
    assert pipe.unet_leaf_slice("conv_in.w", q) is q


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_a_placed_pipeline_holds_packed_projections_only(arch):
    """The UNet, and a ControlNet once attached, hold ``attn1.qkv`` and
    ``attn2.kv`` in [S, out, in] and no unpacked q/k/v leaf but attn2's q;
    re-attaching a net of the same config writes the packed live leaves."""
    bundle = testing.random_bundle(arch, tiny=True)
    pipe = LCMPipeline(bundle, dtype=torch.float32, device="cpu")
    net = testing.random_controlnet(bundle.unet_cfg, vae_scale=2)
    pipe.set_controlnet(net, bundle.unet_cfg)
    ptrs = {k: v.data_ptr() for k, v in _flat(pipe.controlnet_params).items()}
    pipe.set_controlnet(testing.random_controlnet(bundle.unet_cfg, vae_scale=2, seed=3),
                        bundle.unet_cfg)
    assert {k: v.data_ptr() for k, v in _flat(pipe.controlnet_params).items()} == ptrs
    for tree in (pipe.unet_params, pipe.controlnet_params):
        flat = _flat(tree)
        assert not [p for p in flat if any(f".{u}" in p for u in UNPACKED)]
        qkv = [v for p, v in flat.items() if p.endswith("attn1.qkv.w")]
        kv = [v for p, v in flat.items() if p.endswith("attn2.kv.w")]
        assert qkv and len(qkv) == len(kv)
        assert all(v.shape[0] == 3 and v.shape[1] == v.shape[2] for v in qkv)
        assert all(v.shape[0] == 2 and v.shape[2] == bundle.unet_cfg.cross_attention_dim
                   for v in kv)
