"""The port's HTTP server against the JAX server on the CPU, continued
(``tests/test_torch_port_server.py`` has the two servers and the
comparisons): ``tests/test_server_controlnet.py``'s REST cases on both
servers with the same ControlNets attached, the cache routes with
``DREAMLAB_MODE_CACHE=2``, SDXL over REST, the legacy service, and the
port's startup: its refusal, the entry point without a GPU, and the mode
system and the legacy service built from a checkpoint directory on the CPU,
with the dream worker bound to them."""

import base64
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu.testing import random_controlnet as jax_random_controlnet
from dreamlab_tpu_torch import testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.persistence import InMemoryStorageProvider
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.serving import app as tapp
from dreamlab_tpu_torch.serving.http import ServerThread
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_controlnet import _port
from tests.test_torch_port_img2img import one_torch_thread, port_bundle_of  # noqa: F401
from tests.test_torch_port_server import (GEN, ROOT, TIMEOUT, _png_bytes, as_form, as_json,
                                          assert_same, close_pair, fetch, make_pair, pixels,
                                          tiny)  # noqa: F401 (tiny: a fixture)


# ---------------------------------------------------------------------------
# ControlNet (tests/test_server_controlnet.py's REST cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cn(tiny, tmp_path_factory):
    """Both servers with one mode whose worker takes hints (scale 1.0), and
    the zero-tap and live ControlNets on both pipelines' weights."""
    _, jpipe, tpipe = tiny
    pair = make_pair(str(tmp_path_factory.mktemp("cn")), jpipe, tpipe, modes=("tiny",),
                     sr=False, storage=False, worker_kw={"controlnet_scale": 1.0},
                     config=dict(default_size="32x32", default_steps=2, request_timeout=60))
    nets = {}
    for name, zero in (("zero", True), ("live", False)):
        net = jax_random_controlnet(jcfg.TINY_UNET, zero_taps=zero, vae_scale=2)
        nets[name] = (net, _port(net))
    pair.pipes, pair.nets = (jpipe, tpipe), nets
    yield pair
    close_pair(pair)
    jpipe.set_controlnet(None, None)
    tpipe.set_controlnet(None, None)


def _attach(pair, name):
    jpipe, tpipe = pair.pipes
    jnet, tnet = pair.nets[name] if name else (None, None)
    jpipe.set_controlnet(jnet, jcfg.TINY_UNET if name else None)
    tpipe.set_controlnet(tnet, tcfg.TINY_UNET if name else None)


def _hint(seed=0, size=32) -> bytes:
    arr = (np.random.RandomState(seed).rand(size, size, 3) * 255).astype(np.uint8)
    return _png_bytes(arr)


def test_generate_with_hint_no_controlnet_is_400(cn):
    _attach(cn, None)
    j, p = cn.both("POST", "/generate", *as_json(
        {**GEN, "control_image": base64.b64encode(_hint()).decode()}))
    assert_same(j, p)
    assert p.status == 400 and "ControlNet" in p.json()["detail"]


def test_generate_bad_b64_is_400(cn):
    _attach(cn, "zero")
    try:
        j, p = cn.both("POST", "/generate", *as_json({**GEN, "control_image": "!!notb64!!"}))
        assert_same(j, p)
        assert p.status == 400 and "base64" in p.json()["detail"]
    finally:
        _attach(cn, None)


def test_generate_zero_taps_hint_bitexact_and_headers(cn):
    _attach(cn, None)
    base = cn.port("POST", "/generate", *as_json(GEN))
    assert "x-controlnet" not in base.headers
    _attach(cn, "zero")
    try:
        j, p = cn.both("POST", "/generate", *as_json(
            {**GEN, "control_image": base64.b64encode(_hint()).decode()}))
        assert_same(j, p)
        assert (p.headers["x-controlnet"], p.headers["x-controlnet-scale"]) == ("1", "1.0")
        assert p.body == base.body  # zero taps: the same image
    finally:
        _attach(cn, None)


def test_generate_live_hint_changes_image_scale_zero_restores(cn):
    _attach(cn, None)
    base = cn.port("POST", "/generate", *as_json(GEN))
    _attach(cn, "live")
    try:
        hint = base64.b64encode(_hint()).decode()
        j, p = cn.both("POST", "/generate", *as_json({**GEN, "control_image": hint}))
        assert_same(j, p)
        assert p.body != base.body
        j, p = cn.both("POST", "/generate", *as_json(
            {**GEN, "control_image": "data:image/png;base64," + hint, "controlnet_scale": 0.0}))
        assert_same(j, p)
        assert p.body == base.body and p.headers["x-controlnet-scale"] == "0.0"
        # a 16x16 hint is resized to the output size (Lanczos, PIL's arithmetic)
        small = base64.b64encode(_hint(3, 16)).decode()
        assert_same(*cn.both("POST", "/generate", *as_json({**GEN, "control_image": small})))
    finally:
        _attach(cn, None)


def test_v1_controlnet_multipart(cn):
    _attach(cn, None)
    base = cn.port("POST", "/generate", *as_json(GEN))
    _attach(cn, "live")
    try:
        form = as_form({"prompt": "a cat", "size": "32x32", "steps": "2", "seed": "7",
                        "scale": "0.5"}, {"file": ("hint.png", _hint(), "image/png")})
        j, p = cn.both("POST", "/v1/controlnet", *form)
        assert_same(j, p)
        assert (p.headers["x-controlnet"], p.headers["x-controlnet-scale"],
                p.headers["x-seed"]) == ("1", "0.5", "7")
        assert p.body != base.body
    finally:
        _attach(cn, None)


def test_v1_controlnet_requires_prompt_and_file(cn):
    for form in (as_form({"prompt": "x"}),
                 as_form(files={"file": ("h.png", b"123", "image/png")})):
        j, p = cn.both("POST", "/v1/controlnet", *form)
        assert_same(j, p)
        assert p.status == 400


# ---------------------------------------------------------------------------
# the cache routes, SDXL, the legacy service
# ---------------------------------------------------------------------------


def test_models_load_unload_with_cache(tiny, tmp_path, monkeypatch):
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "2")
    _, jpipe, tpipe = tiny
    pair = make_pair(str(tmp_path), jpipe, tpipe, sr=False)
    try:
        steps = [({"mode": "beta"}, "/api/models/load", 200),
                 ({"mode": "beta"}, "/api/models/load", 200),
                 ({"mode": "alpha"}, "/api/models/unload", 409),
                 ({"mode": "beta"}, "/api/models/unload", 200),
                 ({"mode": "beta"}, "/api/models/unload", 404),
                 ({"mode": "nope"}, "/api/models/load", 404),
                 ({}, "/api/models/load", 400),
                 ({}, "/api/models/unload", 400)]
        for body, path, status in steps:
            j, p = pair.both("POST", path, *as_json(body))
            assert_same(j, p)
            assert p.status == status, (path, body)
        assert pair.pools[1].get_status()["warm_modes"] == []
    finally:
        close_pair(pair)


def test_generate_sdxl_over_rest(tmp_path):
    """SDXL (two towers, the cfg mode's doubled batch) through both servers."""
    jb = jax_random_bundle("sdxl", tiny=True)
    jpipe = JaxPipeline(jb, dtype=jnp.float32)
    tpipe = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
    pair = make_pair(str(tmp_path), jpipe, tpipe, modes=("xl",), sr=False)
    try:
        body = {"prompt": "a castle", "negative_prompt": "blurry", "size": "32x32",
                "num_inference_steps": 2, "guidance_scale": 4.0, "seed": 11}
        j, p = pair.both("POST", "/generate", *as_json(body))
        assert_same(j, p)
        assert p.headers["x-seed"] == "11"
        assert pair.port("POST", "/generate", *as_json(body)).body == p.body
    finally:
        close_pair(pair)


def test_legacy_service_multi_worker_and_pipelined(tiny):
    from dreamlab_tpu_torch.serving.legacy_service import PipelineService

    _, _, tpipe = tiny
    made = []

    def factory(i):
        made.append(CudaPipelineWorker(tpipe, i))
        return made[-1]

    spec = lambda i: GenSpec(prompt=f"p{i}", size="32x32", num_inference_steps=2, seed=i)
    want = [CudaPipelineWorker(tpipe).run_job(spec(i)) for i in range(4)]
    svc = PipelineService(factory, num_workers=2, queue_max=8)
    try:
        assert len(made) == 2
        assert [f.result(timeout=TIMEOUT) for f in [svc.submit(spec(i)) for i in range(4)]] == want
        png, seed, lat = svc.submit(spec(5), with_latents=True).result(timeout=TIMEOUT)
        assert len(lat) == 512 and seed == 5
    finally:
        svc.shutdown()
    with pytest.raises(RuntimeError):
        svc.submit(spec(9))


# ---------------------------------------------------------------------------
# startup: the refusals, and the startup path on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting,item", [({"mesh_spec": "data=4"}, "item 18")])
def test_unported_settings_refuse_to_start(setting, item):
    with pytest.raises(tapp.NotPortedError, match=item):
        tapp.create_app(tapp.ServerConfig(**setting), skip_startup=True)


def test_without_a_gpu_the_startup_fails_and_says_why(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = tapp.ServerState(config=tapp.ServerConfig(), storage=InMemoryStorageProvider())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.build_components(state)
    assert state.pool is None and state.sr is None


def test_the_entry_point_without_a_gpu_exits_with_the_reason(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP", "DREAMLAB_DEVICE")}
    env.update(CUDA_VISIBLE_DEVICES="", PORT="0", MODES_CONFIG=str(tmp_path / "none.yaml"))
    out = subprocess.run([sys.executable, "-m", "dreamlab_tpu_torch.serving.run"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no usable CUDA device" in out.stderr and "FAIL: no CUDA device" in out.stdout
    env["YUME_ENABLED"] = "1"  # served now: still no start without the card
    out = subprocess.run([sys.executable, "-m", "dreamlab_tpu_torch.serving.run"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no usable CUDA device" in out.stderr


def test_startup_builds_the_mode_system_on_the_cpu(tmp_path, monkeypatch):
    """The startup path with nothing injected: storage from the environment,
    the SR service and a pool over a modes file whose mode is a checkpoint
    directory, on ``device="cpu"``; cleanup shuts them down."""
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    modes = testing.write_modes_yaml(str(tmp_path / "modes.yaml"), {"m": {
        "model": ckpt, "defaults": {"size": "32x32", "steps": 2}}}, default_mode="m")
    monkeypatch.setenv("STORAGE_PROVIDER", "MEMORY")
    cfg = tapp.ServerConfig(modes_config=modes, default_size="32x32", default_steps=2)
    app = tapp.create_app(cfg, device="cpu")
    server = ServerThread(app).start()
    try:
        state = app[tapp.STATE_KEY]
        assert state.pool.current_mode == "m" and state.registry.device.type == "cpu"
        assert fetch(server.port, "GET", "/health").json() == {"status": "ok", "backend": "mode"}
        reply = fetch(server.port, "POST", "/generate", *as_json({"prompt": "a cat", "seed": 2}))
        assert reply.status == 200 and reply.headers["x-mode"] == "m"
        assert pixels(reply.body).shape == (32, 32, 3)
    finally:
        server.stop()
    assert state.pool.get_status()["shutdown"]


@pytest.mark.parametrize("backend", ["mode", "legacy"])
def test_startup_binds_the_dream_worker_on_the_cpu(tmp_path, monkeypatch, backend):
    """``YUME_ENABLED=1``: the startup binds a dream worker to the pool's
    worker (or the legacy service's first), its native CLIP scorer loaded on
    the server's device from ``YUME_CLIP_MODEL``, Redis refused -> in
    memory; ``/dreams/*`` serve a session; cleanup stops it."""
    import socket

    from dreamlab_tpu_torch.yume import dream_worker, scoring

    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    tok = testing.clip_tokenizer()
    text_cfg = tcfg.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=32, num_layers=2,
                                   num_heads=2, intermediate_size=64, projection_dim=16)
    text_params, vision_params = testing.random_clip(text_cfg, tcfg.TINY_VISION)
    clip_dir = testing.write_clip_dir(str(tmp_path / "clip"), text_params, text_cfg,
                                      vision_params, tcfg.TINY_VISION, tok)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    monkeypatch.setenv("REDIS_PORT", str(sock.getsockname()[1]))
    sock.close()
    monkeypatch.setenv("YUME_CLIP_MODEL", clip_dir)
    monkeypatch.setenv("STORAGE_PROVIDER", "MEMORY")
    monkeypatch.setenv("YUME_FINALIZE_RENDERS", "1")
    if backend == "mode":
        modes = testing.write_modes_yaml(str(tmp_path / "modes.yaml"), {"m": {
            "model": ckpt, "defaults": {"size": "32x32", "steps": 2}}}, default_mode="m")
        cfg = tapp.ServerConfig(modes_config=modes, default_size="32x32", default_steps=2,
                                yume_enabled=True)
    else:
        cfg = tapp.ServerConfig(model_path=ckpt, default_size="32x32", default_steps=2,
                                yume_enabled=True, warmup=False)
    app = tapp.create_app(cfg, device="cpu")
    server = ServerThread(app).start()
    try:
        state = app[tapp.STATE_KEY]
        dream = state.dream_worker
        assert dream_worker.get_dream_worker() is dream
        bound = state.pool.worker if backend == "mode" else state.legacy.workers[0]
        assert dream.worker is bound and dream.redis is None
        assert type(dream.scorer.model) is scoring.NativeCLIP
        assert dream.scorer.model.device.type == "cpu"
        dream.candidate_size = dream.render_size = "32x32"
        dream.render_steps, dream.score_threshold = 2, 0.0  # keep every candidate
        reply = fetch(server.port, "POST", "/dreams/start", *as_json({"prompt": "a cat"}))
        assert reply.status == 200 and reply.json()["prompts"][0] == "a cat"
        t0 = time.monotonic()
        while dream.stats["scored"] < 4:
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.01)
        assert fetch(server.port, "GET", "/dreams/status").json()["running"]
    finally:
        server.stop()
        dream_worker.set_dream_worker(None)
    # the cleanup stopped the session and ran its finalize
    assert not dream.get_status()["running"] and dream.stats["rendered"] >= 1

