"""The port's mesh (``dreamlab_tpu_torch/parallel/sharding.py``) and its
meshed pipeline against the JAX package, on the CPU.

The rules: ``parse_mesh_spec`` against JAX's on a table with its errors;
every leaf of the tiny SD1.5 and SDXL UNets placed as the transpose of
JAX's ``_tp_spec_for_path`` spec (the port's linears are ``[out, in]``).
The meshes and the pipelines run in gloo ranks on the CPU
(``parallel.multihost.run_ranks``, the rank bodies in
``tests/torch_mesh_ranks.py``) against the JAX package on its 8 virtual
CPU devices: data-parallel output equals the port's single process byte for
byte and JAX's ``make_mesh(4)`` latents at rtol 1e-4 / atol 1e-3;
tensor-parallel output (model = 2) is within 1 level of the single process
and within that tolerance of JAX's ``LCMPipeline(mesh=make_mesh(4, model=2),
tensor_parallel=True)``, on the weights the loaders read from one
checkpoint directory.
"""

import ast
import json
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.loader import load_pipeline as jax_load_pipeline
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.parallel import sharding as jsharding
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import loader, lora, testing
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.parallel import sharding
from dreamlab_tpu_torch.parallel.multihost import run_ranks
from dreamlab_tpu_torch.pipeline import LCMPipeline, _flat
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401
from tests.torch_mesh_ranks import DP_CASES, SEGMENTED, SIZE

RANK_TIMEOUT_S = 120


def _ranks(target, n, **args):
    return run_ranks(f"tests.torch_mesh_ranks:{target}", ["cpu"] * n, backend="gloo",
                     timeout=RANK_TIMEOUT_S, args=args)


def _within_one_level(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"pixel drift: max delta {diff.max()}"
    assert (diff > 0).mean() < 0.01, "more than 1% of pixels moved"


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["data=8", "data=4,model=2", "model=2", " data = 2 , ",
                                  "", "rows=4", "data=0", "model=-1", "data=x"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jsharding.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            sharding.parse_mesh_spec(spec)
        return
    assert sharding.parse_mesh_spec(spec) == want


def _model_mesh(model: int, rank: int = 0):
    """A stand-in of a ("data", "model") mesh of ``model`` ranks along the
    model axis: what the placement rules read of a DeviceMesh."""
    return types.SimpleNamespace(shape=(1, model), get_local_rank=lambda axis: rank)


def _jax_to_port(spec, path: str = "") -> object:
    """JAX's spec on an ``[in, out]`` leaf -> the port's placement on ``[out, in]``;
    on a packed ``[in, S, out]`` weight or ``[S, out]`` bias -> the port's
    ``[S, out, in]`` / ``[S, out]``."""
    spec = tuple(spec)
    if spec in ((), (None,), (None, None)):
        return sharding.REPLICATE
    if re.search(r"attn1\.qkv\.|attn2\.kv\.", path):
        assert spec in ((None, None, "model"), (None, "model")), (path, spec)
        return sharding.SPLIT_SLOTS  # each slot's output features
    if spec in ((None, "model"), ("model",)):  # output features
        return sharding.SPLIT_OUT
    if spec == ("model", None):  # input features
        return sharding.SPLIT_IN
    raise AssertionError(f"no port rule for JAX spec {spec}")


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_every_unet_leaf_is_placed_as_jax_specs_it(arch, packed):
    # the port's tiny SDXL has a mid block two layers deep (testing.random_bundle),
    # so the port's tree holds every path of JAX's and more; packed: both
    # packages' pack_attention_params (the pipelines' layout)
    pack = tunet.pack_attention_params if packed else (lambda t: t)
    jpack = junet.pack_attention_params if packed else (lambda t: t)
    jax_paths = {p for p, _ in jsharding._leaf_paths(jpack(jax_random_bundle(arch, tiny=True)
                                                           .unet_params))}
    tb = testing.random_bundle(arch, tiny=True)
    params = pack(tb.unet_params)
    leaves = _flat(params)
    assert jax_paths <= set(leaves)
    got = _flat(sharding.unet_tp_placements(params, _model_mesh(2), tb.unet_cfg))
    assert got == {p: _jax_to_port(jsharding._tp_spec_for_path(p, leaf.ndim), p)
                   for p, leaf in leaves.items()}
    placed = {p: s for p, s in got.items() if s is not None}
    blocks = len([p for p in got if p.endswith("attn1.out.w")])
    # q, k, v of both attention sites (packed: qkv, attn2's q and kv), their
    # out-projections and ff_out
    assert blocks and len(placed) == (6 if packed else 9) * blocks


def test_sites_whose_heads_the_model_axis_does_not_divide_stay_whole():
    tb = testing.random_bundle("sd15", tiny=True)  # 2 heads per site
    by_cfg = _flat(sharding.unet_tp_placements(tb.unet_params, _model_mesh(4), tb.unet_cfg))
    by_path = _flat(sharding.unet_tp_placements(tb.unet_params, _model_mesh(4)))
    attn = [p for p in by_path if ".attn" in p and by_path[p] is not None]
    assert attn and all(by_cfg[p] is None for p in attn)
    ff = [p for p in by_path if p.endswith("ff_out.w")]
    assert ff and all(by_cfg[p] == by_path[p] == sharding.SPLIT_IN for p in ff)


def test_shard_params_keeps_each_ranks_slice():
    tb = testing.random_bundle("sd15", tiny=True)
    placements = sharding.unet_tp_placements(tb.unet_params, _model_mesh(2), tb.unet_cfg)
    flat, split = _flat(tb.unet_params), _flat(placements)
    parts = [_flat(sharding.shard_params(tb.unet_params, placements, _model_mesh(2, r)))
             for r in range(2)]
    for path, leaf in flat.items():
        if split[path] is None:
            assert all(p[path] is leaf for p in parts)
        else:
            assert torch.equal(torch.cat([p[path] for p in parts], dim=split[path]), leaf)
            assert parts[1][path].is_contiguous()


# ---------------------------------------------------------------------------
# meshes and pipelines in gloo ranks
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_names_and_rows(tmp_path):
    out = str(tmp_path / "meshes.json")
    _ranks("mesh_shapes", 4, out=out)
    ranks = json.load(open(out))
    for r, seen in enumerate(ranks):
        assert seen["3x1"].startswith("mesh 3x1 does not cover the 4 ranks")
        for name, (data, model) in {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}.items():
            m = seen[name]
            assert m["shape"] == [data, model] and m["names"] == ["data", "model"]
            # JAX's row-major reshape: device r at (r // model, r % model)
            assert m["coord"] == [r // model, r % model]
            per = 8 // data
            assert m["rows_of_8"] == [m["coord"][0] * per, (m["coord"][0] + 1) * per]
            assert m["rows_of_3"] == [0, 3]  # 3 rows the axis does not divide: all


@pytest.fixture(scope="module")
def sd15_dir(tmp_path_factory):
    return make_tiny_checkpoint(tmp_path_factory.mktemp("sd15") / "ckpt")


@pytest.fixture(scope="module")
def sdxl_dir(tmp_path_factory):
    return testing.write_diffusers_dir(testing.random_bundle("sdxl", tiny=True, seed=7),
                                       str(tmp_path_factory.mktemp("sdxl") / "ckpt"))


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_data_parallel_equals_one_process_and_jax(arch, sd15_dir, sdxl_dir, tmp_path):
    ckpt = sd15_dir if arch == "sd15" else sdxl_dir
    out = str(tmp_path / "dp.npz")
    _ranks("data_parallel", 2, ckpt=ckpt, out=out)
    got = np.load(out)
    # the keys hold the local batch: a batch-2 request on two data ranks
    # replays the batch-1 bucket of solo requests; batch 4 runs 2 rows a rank
    keys = [ast.literal_eval(k) for k in got["keys"]]
    assert {k[0] for k in keys if k[5] == "host"} == {1}, keys
    assert {k[0] for k in keys if k[5] == "device"} == ({2} if arch == "sd15" else set()), keys
    solo = LCMPipeline(loader.load_pipeline(ckpt, device="cpu", load_vae_encoder=True),
                       dtype=torch.float32, device="cpu")
    jax_dp = JaxPipeline(jax_load_pipeline(ckpt), dtype=jnp.float32,
                         mesh=jsharding.make_mesh(4))
    for name, kw in DP_CASES[arch].items():
        want = solo.generate("a cat", **SIZE, **kw)
        np.testing.assert_array_equal(got[f"{name}_images"], want.images, err_msg=name)
        np.testing.assert_array_equal(got[f"{name}_latents"], want.latents, err_msg=name)
        if kw.get("rng") != "device":  # JAX's device RNG is its own
            j = jax_dp.generate("a cat", **SIZE, **kw)
            np.testing.assert_allclose(got[f"{name}_latents"], np.asarray(j.latents),
                                       rtol=1e-4, atol=1e-3, err_msg=name)
    init = (np.random.RandomState(3).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    want = solo.img2img("a cat", init, strength=0.6, seed=21, num_inference_steps=2)
    np.testing.assert_array_equal(got["img2img_images"], want.images)
    np.testing.assert_array_equal(got["img2img_latents"], want.latents)
    want = solo.generate("a cat", **SIZE, **SEGMENTED)
    np.testing.assert_array_equal(got["segments_images"], want.images)
    np.testing.assert_array_equal(got["segments_latents"], want.latents)


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_tensor_parallel_is_within_a_level_of_one_process_and_jax(arch, sd15_dir, sdxl_dir,
                                                                 tmp_path):
    ckpt = sd15_dir if arch == "sd15" else sdxl_dir
    solo = LCMPipeline(loader.load_pipeline(ckpt, device="cpu"), dtype=torch.float32,
                       device="cpu")
    lora_path = str(tmp_path / "style.safetensors")
    save_file(testing.random_lora(solo.unet_params, rank=4), lora_path)
    out = str(tmp_path / "tp.npz")
    _ranks("tensor_parallel", 2, ckpt=ckpt, out=out, lora_path=lora_path)
    got = np.load(out)
    c = solo.bundle.unet_cfg.block_out_channels[-1]
    assert tuple(got["q_rows"]) == (c // 2, c)  # a rank holds half the heads' rows
    kw = dict(SIZE, seed=3, batch=2)
    if arch == "sdxl":
        kw.update(guidance_scale=7.5, negative_prompt="bad")
    want = solo.generate("a dog", **kw)
    mesh = jsharding.make_mesh(4, model=2)
    j = JaxPipeline(jax_load_pipeline(ckpt), dtype=jnp.float32, mesh=mesh,
                    tensor_parallel=True).generate("a dog", **kw)
    for name in ("images", "restored"):
        _within_one_level(got[f"{name}_images"], want.images)
        np.testing.assert_allclose(got[f"{name}_latents"], want.latents, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[f"{name}_latents"], np.asarray(j.latents), rtol=1e-4,
                                   atol=1e-3)
        _within_one_level(got[f"{name}_images"], np.asarray(j.images))
    # a LoRA merged into the ranks' slices (a style through the router, a
    # mode LoRA by merge_lora_into_tree) gives the whole-weights merge
    lora.merge_lora_into_tree(solo.unet_params, lora.load_lora(lora_path).unet, 1.0)
    styled = solo.generate("a dog", **kw)
    assert not np.array_equal(styled.images, want.images)
    for name in ("styled", "merged"):
        _within_one_level(got[f"{name}_images"], styled.images)
        np.testing.assert_allclose(got[f"{name}_latents"], styled.latents, rtol=1e-4,
                                   atol=1e-3)


def test_tensor_parallel_needs_a_mesh():
    with pytest.raises(ValueError, match="needs a mesh"):
        LCMPipeline(testing.random_bundle(tiny=True), dtype=torch.float32, device="cpu",
                    tensor_parallel=True)


def test_one_device_pipeline_has_no_slices():
    pipe = LCMPipeline(testing.random_bundle(tiny=True), dtype=torch.float32, device="cpu")
    w = torch.ones(3)
    assert pipe.unet_leaf_slice("down.0.attentions.0.blocks.0.attn1.q.w", w) is w
    assert pipe.mesh is None and pipe._tp is None and not pipe.graphs
