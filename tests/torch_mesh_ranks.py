"""Rank bodies of the port's mesh tests (tests/test_torch_port_sharding.py,
tests/test_torch_port_multihost.py): each runs in every rank of a
``dreamlab_tpu_torch.parallel.multihost.run_ranks`` run (gloo, CPU, one
torch thread) and rank 0 writes what the test compares to ``out``. No JAX
here: the ranks import the port only."""

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from dreamlab_tpu_torch import loader, lora
from dreamlab_tpu_torch.parallel.sharding import data_rows, make_mesh
from dreamlab_tpu_torch.pipeline import LCMPipeline

# arch -> {name: generate's arguments}: the data-parallel cases (SD1.5's
# LCM UNet guides by the w-embedding, the SDXL checkpoint's by classic CFG on
# the doubled batch, whose micro-conditioning rows the split must keep paired)
DP_CASES = {
    "sd15": {"batch1": dict(seed=3, batch=1), "batch2": dict(seed=3, batch=2),
             "batch4_device_rng": dict(seed=5, batch=4, rng="device")},
    "sdxl": {"batch1": dict(seed=3, batch=1),
             "batch2_cfg": dict(seed=6, batch=2, guidance_scale=[1.5, 3.0],
                                negative_prompt="bad")},
}
SEGMENTED = dict(seed=3, batch=2)
SIZE = dict(height=32, width=32, num_inference_steps=2)


def mesh_shapes(out: str) -> int:
    """Every rank's coordinates in the meshes a 4-rank world holds, and the
    refusal of one it does not."""
    rank = dist.get_rank()
    seen = {}
    for data, model in ((4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(model=model, device_type="cpu")
        seen[f"{data}x{model}"] = {
            "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
            "coord": [mesh.get_local_rank("data"), mesh.get_local_rank("model")],
            "rows_of_8": [data_rows(8, mesh).start, data_rows(8, mesh).stop],
            "rows_of_3": [data_rows(3, mesh).start, data_rows(3, mesh).stop]}
    try:
        make_mesh(data=3, model=1, device_type="cpu")
        seen["3x1"] = "built"
    except ValueError as e:
        seen["3x1"] = str(e)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, seen)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(gathered, f)
    return 0


def data_parallel(ckpt: str, out: str) -> int:
    """The DP cases on a data-only mesh of the world, and img2img at batch 2."""
    mesh = make_mesh(model=1, device_type="cpu")
    pipe = LCMPipeline(loader.load_pipeline(ckpt, device="cpu", load_vae_encoder=True),
                       dtype=torch.float32, device="cpu", mesh=mesh)
    res = {}
    for name, kw in DP_CASES[pipe.bundle.arch].items():
        r = pipe.generate("a cat", **SIZE, **kw)
        res[f"{name}_images"], res[f"{name}_latents"] = r.images, r.latents
    init = (np.random.RandomState(3).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    r = pipe.img2img("a cat", init, strength=0.6, seed=21, num_inference_steps=2)
    res["img2img_images"], res["img2img_latents"] = r.images, r.latents
    # segments of a split batch: each rank carries its own rows
    first = pipe.generate("a cat", segment=(0, 1), **SIZE, **SEGMENTED)
    r = pipe.generate("a cat", segment=(1, 2), latents_state=first.state_device, **SIZE,
                      **SEGMENTED)
    res["segments_images"], res["segments_latents"] = r.images, r.latents
    res["keys"] = np.asarray([str(k[:8]) for k in pipe._compiled])
    if dist.get_rank() == 0:
        np.savez(out, **res)
    return 0


def tensor_parallel(ckpt: str, out: str, lora_path: str) -> int:
    """generate on a model-only mesh of the world (the UNet split); through
    the router, a style merged into every rank's slices and restored; then
    the LoRA merged as a mode LoRA is (``merge_lora_into_tree``)."""
    from dreamlab_tpu_torch.parallel.multihost_router import MultihostRouter, RouterPipeline

    mesh = make_mesh(model=dist.get_world_size(), device_type="cpu")
    pipe = LCMPipeline(loader.load_pipeline(ckpt, device="cpu"), dtype=torch.float32,
                       device="cpu", mesh=mesh, tensor_parallel=True)
    rp = RouterPipeline(pipe, MultihostRouter(timeout=120))
    kw = dict(SIZE, seed=3, batch=2)
    if pipe.bundle.arch == "sdxl":  # classic CFG on the doubled batch
        kw.update(guidance_scale=7.5, negative_prompt="bad")
    # the q slot of the mid block's packed qkv leaf
    res = {"q_rows": np.asarray(lora.leaf(pipe.unet_params,
                                          "mid.attention.blocks.0.attn1.q").shape)}
    if dist.get_rank() == 0:
        for name, path in (("images", "-"), ("styled", lora_path), ("restored", None)):
            if path != "-":
                rp.apply_lora(path, 1.0)
            r = rp.generate("a dog", **kw)
            res[f"{name}_images"], res[f"{name}_latents"] = r.images, r.latents
        rp.shutdown()
    else:
        rp.serve_follower()
    lora.merge_lora_into_tree(pipe.unet_params, lora.load_lora(lora_path).unet, 1.0,
                              shard=pipe.unet_leaf_slice)
    r = pipe.generate("a dog", **kw)
    res["merged_images"], res["merged_latents"] = r.images, r.latents
    if dist.get_rank() == 0:
        np.savez(out, **res)
    return 0


def fail_on_rank_1() -> int:
    """Rank 1 fails at once; rank 0 stays blocked, as a rank waits in an NCCL
    collective whose peer died (a gloo one would fail by itself)."""
    if dist.get_rank() == 1:
        return 3
    time.sleep(3600)
    return 0


def sleep_forever() -> int:
    time.sleep(3600)
    return 0


def unknown_op() -> int:
    """Rank 0 sends an op the followers do not know: they must stop."""
    from dreamlab_tpu_torch.parallel.multihost_router import MultihostRouter

    router = MultihostRouter(timeout=60)
    if router.is_primary:
        router.broadcast_message({"op": "bogus"})
        return 0
    router.serve_follower()
    return 0
