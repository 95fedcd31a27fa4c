"""The port's server over ``DREAMLAB_MESH`` on the CPU (``serving/app.py``'s
``MeshServing``; the counterpart of ``tests/test_server_mesh.py``): with
``device="cpu"`` (``DREAMLAB_DEVICE=cpu``) the server is rank 0 of a gloo
run and starts the other rank itself. Over ``"data=2"`` it serves
deterministic PNGs equal to the meshless server's, a mode switch is
rebuilt on both ranks (a coalesced batch after it takes one row from each
rank, equal to the meshless solo runs), a tenant request is refused, an
evicted mode is dropped on both ranks, the follower stops with the server,
and a layout with more ranks than the visible GPUs is refused at startup,
naming the counts. Over ``"model=2"`` each rank serves its slices of the
UNet, a mode LoRA merged into them, within 1 level of the meshless server."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dreamlab_tpu_torch import lora, testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.worker_pool import CustomJob
from dreamlab_tpu_torch.parallel.multihost_router import RouterPipeline
from dreamlab_tpu_torch.serving import app as tapp
from dreamlab_tpu_torch.serving.http import ServerThread
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401
from tests.test_torch_port_server import GEN, TIMEOUT, as_json, fetch


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    ckpt = make_tiny_checkpoint(root / "ckpt")
    return testing.write_modes_yaml(str(root / "modes.yaml"), {
        name: {"model": ckpt, "defaults": {"size": "32x32", "steps": 2}}
        for name in ("m", "m2")}, default_mode="m")


def _serve(modes, mesh_spec=None):
    cfg = tapp.ServerConfig(modes_config=modes, default_size="32x32", default_steps=2,
                            mesh_spec=mesh_spec)
    app = tapp.create_app(cfg, device="cpu")
    return app, ServerThread(app).start()


def _drive(app, port):
    """What the test reads from one server: PNGs, a switch, a coalesced batch."""
    out = {}
    first = fetch(port, "POST", "/generate", *as_json(GEN))
    assert first.status == 200 and first.headers["x-seed"] == "7", first.body[:200]
    out["png"] = first.body
    out["repeat"] = fetch(port, "POST", "/generate", *as_json(GEN)).body
    out["other"] = fetch(port, "POST", "/generate", *as_json({**GEN, "seed": 8})).body
    r = fetch(port, "POST", "/api/modes/switch", *as_json({"mode": "m2", "wait_seconds": 60}))
    assert r.status == 200, r.body
    r = fetch(port, "POST", "/generate", *as_json(GEN))
    assert r.status == 200 and r.headers["x-mode"] == "m2"
    out["after_switch"] = r.body
    pool = app[tapp.STATE_KEY].pool
    specs = [GenSpec(prompt="a cat", size="32x32", num_inference_steps=2, seed=s)
             for s in (3, 4)]
    out["batch"] = pool.submit_job(CustomJob(lambda w: [png for png, _ in w.run_jobs(specs)])
                                   ).result(timeout=TIMEOUT)
    out["solo"] = [pool.submit_job(CustomJob(lambda w, s=s: w.run_job(s)[0])
                                   ).result(timeout=TIMEOUT) for s in specs]
    return out


def test_the_server_serves_over_a_data_mesh_on_the_cpu(modes, monkeypatch):
    monkeypatch.setenv("STORAGE_PROVIDER", "MEMORY")
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "2")
    app, server = _serve(modes, "data=2")
    try:
        state = app[tapp.STATE_KEY]
        router = state.mesh.router
        assert dist.get_world_size() == 2 and isinstance(state.pool.worker.pipeline,
                                                         RouterPipeline)
        meshed = _drive(app, server.port)
        # the switch built the second mode on every rank (a batch of two rows
        # took one from each) and kept the first warm (cache 2); a tenant
        # request for it is refused all the same: it would run on rank 0 only
        assert set(router.pipes) == {"w1", "w2"}
        r = fetch(server.port, "POST", "/generate", *as_json({**GEN, "mode": "m"}))
        assert r.status == 400 and "single-rank" in json.loads(r.body)["detail"]
        assert state.pool.evict_mode("m") and set(router.pipes) == {"w2"}
        assert fetch(server.port, "POST", "/generate", *as_json(GEN)).body == \
            meshed["after_switch"]
    finally:
        server.stop()
    assert not dist.is_initialized()
    assert all(p.returncode == 0 for p in state.mesh.ranks.procs.values())

    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "1")
    app, server = _serve(modes)
    try:
        assert app[tapp.STATE_KEY].mesh is None
        plain = _drive(app, server.port)
    finally:
        server.stop()
    assert meshed["png"] == meshed["repeat"] != meshed["other"]
    assert meshed["batch"] == meshed["solo"]
    assert meshed == plain


def test_a_layout_with_more_ranks_than_gpus_is_refused_at_startup(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = tapp.ServerConfig(mesh_spec="data=2,model=2")
    with pytest.raises(ValueError, match=r"needs 4 ranks, one per GPU, and this host shows "
                                         r"2 GPU\(s\)"):
        tapp.create_app(cfg, skip_startup=True)
    # two fit two GPUs; the CPU takes any count
    tapp.create_app(tapp.ServerConfig(mesh_spec="data=2"), skip_startup=True)
    tapp.create_app(cfg, skip_startup=True, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis 'rows'"):
        tapp.create_app(tapp.ServerConfig(mesh_spec="rows=2"), skip_startup=True)


def test_a_mesh_without_a_modes_file_is_refused(tmp_path):
    state = tapp.ServerState(config=tapp.ServerConfig(model_path=str(tmp_path),
                                                      mesh_spec="data=2"),
                             device="cpu", storage=object(), sr=object())
    with pytest.raises(ValueError, match="serves the mode system"):
        tapp.build_components(state)


def test_the_server_splits_the_unet_over_a_model_mesh_on_the_cpu(tmp_path, monkeypatch):
    """``"model=2"``: every rank builds the mode with its slices of the UNet,
    its mode LoRA merged into them; the PNGs are within 1 level of the
    meshless server's."""
    from dreamlab_tpu_torch import loader
    from dreamlab_tpu_torch.utils.png import decode_png
    from dreamlab_tpu_torch.utils.safetensors import save_file

    monkeypatch.setenv("STORAGE_PROVIDER", "MEMORY")
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    adapter = str(tmp_path / "mode_lora.safetensors")
    save_file(testing.random_lora(loader.load_pipeline(ckpt, device="cpu").unet_params, rank=4),
              adapter)
    modes = testing.write_modes_yaml(str(tmp_path / "modes.yaml"), {"m": {
        "model": ckpt, "loras": [{"file": adapter, "strength": 1.0}],
        "defaults": {"size": "32x32", "steps": 2}}}, default_mode="m")
    pngs = {}
    for spec in ("model=2", None):
        app, server = _serve(modes, spec)
        try:
            pipe = app[tapp.STATE_KEY].pool.worker.pipeline
            if spec:
                q = lora.leaf(pipe.unet_params, "mid.attention.blocks.0.attn1.q")  # a slot
                assert q.shape[0] * 2 == q.shape[1]  # rank 0 holds half the heads' rows
            pngs[spec] = [fetch(server.port, "POST", "/generate",
                                *as_json({**GEN, "seed": s})).body for s in (7, 8)]
        finally:
            server.stop()
    for split, whole in zip(pngs["model=2"], pngs[None]):
        diff = np.abs(decode_png(split).astype(np.int16) - decode_png(whole).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
