"""The port's HTTP server (``dreamlab_tpu_torch.serving``) against the JAX
server (``dreamlab_tpu.serving``) on the CPU.

Both servers serve the same tiny SD1.5 weights (``random_bundle("sd15",
tiny=True)``; the port's through ``convert.from_jax_numpy``) behind a pool of
two modes, a bicubic super-resolution service (tile 16) and in-memory
storage. Each listens on a real ``127.0.0.1`` socket (the JAX one through
aiohttp's ``TestServer``) and the same bytes go to both through
``http.client``. Compared: status codes, the contract headers (``X-*``,
``Access-Control-*``, ``Content-Type``, ``Allow``), JSON bodies without
volatile fields (storage keys, ``created``, the device's name, load times),
SSE event sequences, and pixels: within +-1 level with under 1 % of pixels
moved, the bounds ``tests/test_torch_port_pipeline.py`` holds the two
pipelines to. Then cases only the port's layer has: a chunked body, 413,
keep-alive, pipelined requests, a client that disconnects while its job is
queued (the job never runs).

With ``tests/test_torch_port_server_modes.py`` it covers
``tests/test_server.py`` (the dreams' ``/dreams/*`` too, with scripted
scores and seeded strategies so both sessions run the same iterations) and
the server part of ``tests/test_server_controlnet.py``.
"""

import asyncio
import base64
import dataclasses
import http.client
import io
import json
import os
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestServer
from PIL import Image

from dreamlab_tpu.engine.mode_config import ModeConfigManager as JaxModeConfig
from dreamlab_tpu.engine.model_registry import ModelRegistry as JaxRegistry
from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
from dreamlab_tpu.engine.worker_pool import CustomJob as JaxCustomJob
from dreamlab_tpu.engine.worker_pool import WorkerPool as JaxPool
from dreamlab_tpu.models.configs import SuperResConfig as JaxSRConfig
from dreamlab_tpu.persistence import InMemoryStorageProvider as JaxMemory
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.serving import app as japp
from dreamlab_tpu.serving import schemas as jschemas
from dreamlab_tpu.serving.superres_service import SuperResService as JaxSR
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.mode_config import ModeConfigManager
from dreamlab_tpu_torch.engine.model_registry import ModelRegistry
from dreamlab_tpu_torch.engine.worker_pool import CustomJob, WorkerPool
from dreamlab_tpu_torch.invokers.comfy_client import multipart_body
from dreamlab_tpu_torch.models.configs import SuperResConfig
from dreamlab_tpu_torch.persistence import InMemoryStorageProvider
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.serving import app as tapp
from dreamlab_tpu_torch.serving import schemas as tschemas
from dreamlab_tpu_torch.serving.http import ServerThread
from dreamlab_tpu_torch.serving.superres_service import SuperResService
from tests.test_engine import write_modes_yaml
from tests.test_torch_port_img2img import one_torch_thread, port_bundle_of  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UI_DIST = os.path.join(ROOT, "ui", "dist")
GEN = {"prompt": "a cat", "size": "32x32", "num_inference_steps": 2, "seed": 7}
TIMEOUT = 120


# ---------------------------------------------------------------------------
# a client for both servers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Reply:
    status: int
    headers: dict  # lower-case names
    body: bytes

    def json(self):
        return json.loads(self.body)


def fetch(port, method, path, body=b"", headers=None, *, conn=None) -> Reply:
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return Reply(r.status, {k.lower(): v for k, v in r.getheaders()}, r.read())
    finally:
        if conn is None:
            c.close()


def as_json(obj):
    return json.dumps(obj).encode(), {"Content-Type": "application/json"}


def as_form(fields=None, files=None):
    body, ctype = multipart_body(fields or {}, files or {})
    return body, {"Content-Type": ctype}


class Pair:
    """The JAX app on aiohttp's TestServer (its loop driven while a request
    is in flight) and the port's app on its own server thread."""

    def __init__(self, jax_app, port_app):
        self.loop = asyncio.new_event_loop()
        self.jsrv = TestServer(jax_app, loop=self.loop, host="127.0.0.1")
        self.loop.run_until_complete(self.jsrv.start_server())
        self.tsrv = ServerThread(port_app).start()

    def jax(self, method, path, body=b"", headers=None) -> Reply:
        call = lambda: fetch(self.jsrv.port, method, path, body, headers)
        return self.loop.run_until_complete(self.loop.run_in_executor(None, call))

    def port(self, method, path, body=b"", headers=None) -> Reply:
        return fetch(self.tsrv.port, method, path, body, headers)

    def both(self, method, path, body=b"", headers=None):
        return self.jax(method, path, body, headers), self.port(method, path, body, headers)

    def run_jax(self, fn):
        """Call ``fn`` on a thread while the JAX server's loop runs."""
        return self.loop.run_until_complete(self.loop.run_in_executor(None, fn))

    def close(self):
        self.tsrv.stop()
        self.loop.run_until_complete(self.jsrv.close())
        self.loop.close()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

VOLATILE_JSON = {"created", "loaded_at", "device", "url", "image_key", "dir"}


def _contract(headers):
    return {k: v for k, v in headers.items()
            if k.startswith(("x-", "access-control-")) or k in ("content-type", "allow")}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE_JSON}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_pixels_close(a: bytes, b: bytes):
    pa, pb = pixels(a), pixels(b)
    assert pa.shape == pb.shape
    diff = np.abs(pa.astype(np.int16) - pb.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def sse_events(body: bytes):
    events = []
    for block in body.decode().strip().split("\n\n"):
        event = data = None
        for line in block.splitlines():
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                data = json.loads(line[6:])
        events.append((event, data))
    return events


def assert_same(j: Reply, p: Reply, *, volatile_headers=(), volatile_json=()):
    assert j.status == p.status, (j.status, p.status, j.body[:300], p.body[:300])
    jh, ph = _contract(j.headers), _contract(p.headers)
    assert jh.keys() == ph.keys(), (sorted(jh), sorted(ph))
    for k in jh:
        if k == "x-lcm-image-key":
            assert jh[k].startswith("lcm:") and ph[k].startswith("lcm:")
        elif k not in volatile_headers:
            assert jh[k] == ph[k], (k, jh[k], ph[k])
    ctype = jh.get("content-type", "").split(";")[0]
    if ctype == "application/json":
        jj, pj = _strip(j.json()), _strip(p.json())
        for key in volatile_json:
            jj.pop(key, None)
            pj.pop(key, None)
        assert jj == pj
    elif ctype in ("image/png", "image/jpeg"):
        assert_pixels_close(j.body, p.body)
    elif ctype == "text/event-stream":
        je, pe = sse_events(j.body), sse_events(p.body)
        assert [e for e, _ in je] == [e for e, _ in pe]
        for (event, jd), (_, pd) in zip(je, pe):
            if event == "result":
                assert_pixels_close(base64.b64decode(jd.pop("image_b64")),
                                    base64.b64decode(pd.pop("image_b64")))
                assert jd.pop("image_key").startswith("lcm:")
                assert pd.pop("image_key").startswith("lcm:")
            assert jd == pd
    else:
        assert j.body == p.body


# ---------------------------------------------------------------------------
# the two servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jb = jax_random_bundle("sd15", tiny=True)
    return jb, JaxPipeline(jb, dtype=jnp.float32), LCMPipeline(
        port_bundle_of(jb), dtype=torch.float32, device="cpu")


class Logged:
    """A port worker that logs the seeds of the requests it runs."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run_job(self, spec):
        self.log.append(spec.seed)
        return self.inner.run_job(spec)

    def run_job_pipelined(self, spec):
        self.log.append(spec.seed)
        return self.inner.run_job_pipelined(spec)

    def run_jobs_pipelined(self, specs):
        self.log.extend(s.seed for s in specs)
        return self.inner.run_jobs_pipelined(specs)


def make_pair(tmp, jpipe, tpipe, *, modes=("alpha", "beta"), sr=True, storage=True,
              queue_max=8, worker_kw=None, config=None, log=None):
    """Both servers over pools of ``modes`` (tests/test_engine.py's modes
    file), with the JAX server test's settings."""
    path = write_modes_yaml(os.path.join(tmp, "modes.yaml"), modes=modes)
    worker_kw = worker_kw or {}
    jmc, tmc = JaxModeConfig(str(path)), ModeConfigManager(str(path))
    jreg = JaxRegistry(total_hbm_bytes=16 << 30)
    treg = ModelRegistry(total_hbm_bytes=16 << 30, device="cpu")
    jpool = JaxPool(queue_max=queue_max, mode_config=jmc, registry=jreg,
                    worker_factory=lambda i, p: TPUPipelineWorker(jpipe, i, **worker_kw))

    def tfactory(i, p):
        w = CudaPipelineWorker(tpipe, i, **worker_kw)
        return Logged(w, log) if log is not None else w

    tpool = WorkerPool(queue_max=queue_max, mode_config=tmc, registry=treg,
                       worker_factory=tfactory)
    jsr = JaxSR(cfg=JaxSRConfig(tile=16), num_workers=1) if sr else None
    tsr = SuperResService(cfg=SuperResConfig(tile=16), device="cpu") if sr else None
    cfg = config or dict(default_size="32x32", default_steps=2, request_timeout=60,
                         ui_dist=UI_DIST)
    japp_ = japp.create_app(japp.ServerConfig(**cfg), pool=jpool, sr=jsr,
                            storage=JaxMemory() if storage else None, mode_config=jmc,
                            registry=jreg, skip_startup=True)
    tapp_ = tapp.create_app(tapp.ServerConfig(**cfg), pool=tpool, sr=tsr,
                            storage=InMemoryStorageProvider() if storage else None,
                            mode_config=tmc, registry=treg, skip_startup=True, device="cpu")
    pair = Pair(japp_, tapp_)
    pair.pools, pair.srs = (jpool, tpool), (jsr, tsr)
    return pair


def close_pair(pair):
    pair.close()
    for pool in pair.pools:
        pool.shutdown(drain=False, timeout=1)
    for sr in pair.srs:
        if sr is not None:
            sr.shutdown()


@pytest.fixture(scope="module")
def srv(tiny, tmp_path_factory):
    _, jpipe, tpipe = tiny
    log = []
    pair = make_pair(str(tmp_path_factory.mktemp("srv")), jpipe, tpipe, log=log)
    pair.log = log
    yield pair
    close_pair(pair)


# ---------------------------------------------------------------------------
# tests/test_server.py's cases, both servers
# ---------------------------------------------------------------------------


def test_health(srv):
    assert_same(*srv.both("GET", "/health"))


def test_generate_returns_png_with_headers(srv):
    j, p = srv.both("POST", "/generate", *as_json(GEN))
    assert_same(j, p)
    assert p.body[:8] == b"\x89PNG\r\n\x1a\n"
    assert (p.headers["x-seed"], p.headers["x-mode"], p.headers["x-superres"]) == ("7", "alpha", "0")
    assert p.headers["access-control-allow-origin"] == "*"


def test_generate_then_fetch_from_storage(srv):
    j, p = srv.both("POST", "/generate", *as_json(GEN))
    j2, p2 = (srv.jax("GET", f"/storage/{j.headers['x-lcm-image-key']}"),
              srv.port("GET", f"/storage/{p.headers['x-lcm-image-key']}"))
    assert_same(j2, p2)
    assert (j2.body, p2.body) == (j.body, p.body)
    assert p2.headers["x-meta-seed"] == "7"


def test_generate_validation_error(srv):
    for body in ({"prompt": "x", "size": "bogus"}, {"prompt": "x", "num_inference_steps": 99}):
        j, p = srv.both("POST", "/generate", *as_json(body))
        assert_same(j, p)
        assert p.status == 422


def test_generate_stream_sse(srv):
    ref_j, ref_p = srv.both("POST", "/generate", *as_json(GEN))
    j, p = srv.both("POST", "/generate/stream", *as_json(GEN))
    assert_same(j, p)
    events = sse_events(p.body)
    assert [d["step"] for e, d in events if e == "progress"] == [0, 1]
    (result,) = [d for e, d in events if e == "result"]
    assert (result["seed"], result["mode"]) == (7, "alpha")
    assert base64.b64decode(result["image_b64"]) == ref_p.body
    (jresult,) = [d for e, d in sse_events(j.body) if e == "result"]
    assert base64.b64decode(jresult["image_b64"]) == ref_j.body


def test_generate_stream_error_in_stream(srv):
    j, p = srv.both("POST", "/generate/stream", *as_json({**GEN, "mode": "nope"}))
    assert_same(j, p)
    errs = [d for e, d in sse_events(p.body) if e == "error"]
    assert len(errs) == 1 and errs[0]["status"] == 404


def test_generate_unknown_mode_404(srv):
    j, p = srv.both("POST", "/generate", *as_json({**GEN, "mode": "nope"}))
    assert_same(j, p)
    assert p.status == 404


def test_generate_mode_switch(srv):
    try:
        j, p = srv.both("POST", "/generate", *as_json({**GEN, "mode": "beta"}))
        assert_same(j, p)
        assert p.headers["x-mode"] == "beta"
    finally:
        srv.both("POST", "/api/modes/switch", *as_json({"mode": "alpha", "wait_seconds": 30}))


def test_generate_with_superres(srv):
    j, p = srv.both("POST", "/generate", *as_json({**GEN, "superres": True,
                                                    "superres_magnitude": 1}))
    assert (j.status, p.status) == (200, 200)
    assert _contract(j.headers).keys() == _contract(p.headers).keys()
    for k in ("x-superres", "x-sr-passes", "x-sr-scale-per-pass", "x-sr-model", "x-seed",
              "content-type"):
        assert j.headers[k] == p.headers[k], k
    assert p.headers["x-superres"] == "1" and p.headers["x-sr-passes"] == "1"
    assert pixels(p.body).shape == pixels(j.body).shape == (96, 96, 3)
    # the upscale of each server's own image: the port's SR of its PNG, and
    # that PNG within the pixel bounds of the JAX server's
    png_j, png_p = srv.both("POST", "/generate", *as_json(GEN))
    assert_pixels_close(png_j.body, png_p.body)
    want, passes = srv.srs[1].submit(png_p.body, magnitude=1).result(timeout=TIMEOUT)
    assert passes == 1 and p.body == want


def test_superres_upload(srv):
    buf = io.BytesIO()
    Image.new("RGB", (20, 24), (128, 40, 200)).save(buf, format="PNG")
    form = as_form({"magnitude": "1", "out_format": "jpeg"},
                   {"file": ("in.png", buf.getvalue(), "image/png")})
    j, p = srv.both("POST", "/superres", *form)
    assert_same(j, p)
    out = Image.open(io.BytesIO(p.body))
    assert out.size == (60, 72) and out.format == "JPEG"
    assert j.body == p.body  # the bicubic mode is PIL's to the bit, and so is the JPEG
    assert_same(*srv.both("POST", "/v1/superres", *form))


def test_superres_bad_magnitude(srv):
    form = as_form({"magnitude": "9"}, {"file": ("in.png", b"xx", "image/png")})
    j, p = srv.both("POST", "/superres", *form)
    assert_same(j, p)
    assert p.status == 400
    assert_same(*srv.both("POST", "/superres", *as_form({"magnitude": "1"})))


def test_storage_health_and_put(srv):
    # the stored PNGs' sizes differ (each package's own PNG writer)
    assert_same(*srv.both("GET", "/storage/health"), volatile_json=("bytes",))
    j, p = srv.both("PUT", "/storage/custom:key", b"blob",
                    {"Content-Type": "application/octet-stream"})
    assert_same(j, p)
    j, p = srv.both("GET", "/storage/custom:key")
    assert_same(j, p)
    assert p.body == b"blob"


def test_storage_missing_404(srv):
    j, p = srv.both("GET", "/storage/nope")
    assert_same(j, p)
    assert p.status == 404


def test_api_models_status(srv):
    j, p = srv.both("GET", "/api/models/status")
    assert_same(j, p)
    assert p.json()["backend"] == "mode" and "memory" in p.json()


def test_api_modes_and_switch(srv):
    j, p = srv.both("GET", "/api/modes")
    assert_same(j, p)
    assert set(p.json()["modes"]) == {"alpha", "beta"}
    for body in ({"mode": "alpha", "wait_seconds": 10}, {"mode": "zz"}, {}):
        j, p = srv.both("POST", "/api/modes/switch", *as_json(body))
        assert_same(j, p)
    assert_same(*srv.both("POST", "/api/modes/reload"))


def test_api_vram_schema(srv):
    for path in ("/api/vram", "/api/hbm"):
        j, p = srv.both("GET", path)
        assert_same(j, p)
        assert {"total_gb", "used_gb", "available_gb", "models"} <= p.json().keys()


def test_api_reserved_501(srv):
    for path in ("/api/models/load", "/api/models/unload"):
        j, p = srv.both("POST", path, *as_json({}))
        assert_same(j, p)
        assert p.status == 501


def test_sdapi_models_options_samplers(srv):
    for path in ("/sdapi/v1/sd-models", "/sdapi/v1/options", "/sdapi/v1/samplers"):
        assert_same(*srv.both("GET", path))


@pytest.mark.parametrize("body", [
    {"prompt": "a cat", "width": 32, "height": 32, "steps": 2, "seed": 3},
    {"prompt": "a cat", "width": 32, "height": 32, "steps": 2, "seed": 2**31 - 2,
     "batch_size": 2},
])
def test_sdapi_txt2img(srv, body):
    j, p = srv.both("POST", "/sdapi/v1/txt2img", *as_json(body))
    assert_same(j, p, volatile_json=("images",))
    jd, pd = j.json(), p.json()
    assert len(pd["images"]) == len(jd["images"]) == body.get("batch_size", 1)
    for ji, pi in zip(jd["images"], pd["images"]):
        assert_pixels_close(base64.b64decode(ji), base64.b64decode(pi))
    # image i takes (seed + i) mod (2^31 - 1): the second wraps to seed 0
    for i, img in enumerate(pd["images"]):
        seed = (body["seed"] + i) % (2**31 - 1)
        solo = srv.port("POST", "/generate", *as_json({**GEN, "seed": seed}))
        assert base64.b64decode(img) == solo.body


def test_sdapi_txt2img_random_seed(srv):
    body = {"prompt": "a cat", "width": 32, "height": 32, "steps": 1, "seed": -1}
    j, p = srv.both("POST", "/sdapi/v1/txt2img", *as_json(body))
    assert_same(j, p, volatile_json=("images", "info"))
    assert json.loads(p.json()["info"])["seed"] >= 0


@pytest.mark.parametrize("n", [1, 2])
def test_openai_images(srv, n):
    j, p = srv.both("POST", "/v1/images/generations",
                    *as_json({"prompt": "a cat", "size": "32x32", "n": n}))
    assert_same(j, p, volatile_json=("data",))
    assert len(p.json()["data"]) == n
    assert j.json()["created"] > 0 and p.json()["created"] > 0
    for jd, pd in zip(j.json()["data"], p.json()["data"]):
        assert base64.b64decode(pd["b64_json"])[:8] == b"\x89PNG\r\n\x1a\n"
        # no seed: each server draws its own, so only the size is comparable
        assert pixels(base64.b64decode(pd["b64_json"])).shape == \
            pixels(base64.b64decode(jd["b64_json"])).shape
    bad = {"prompt": "a cat", "response_format": "url"}
    assert_same(*srv.both("POST", "/v1/images/generations", *as_json(bad)))


def test_mode_defaults_applied(srv):
    # the modes file's defaults (steps 4) fill what the request leaves unset
    j, p = srv.both("POST", "/generate", *as_json({"prompt": "x", "size": "32x32", "seed": 1}))
    assert_same(j, p)
    meta = Image.open(io.BytesIO(p.body)).text["parameters"]
    assert "Steps: 4" in meta


def test_mode_defaults_never_override_user_values():
    class FakeMode:
        def default_size(self):
            return "256x256"

        def default_steps(self):
            return 8

        def default_guidance(self):
            return 2.5

    for given, want in (
        (dict(size="32x32", num_inference_steps=2, guidance_scale=1.5), ("32x32", 2, 1.5)),
        ({}, ("256x256", 8, 2.5)),
        (dict(size="64x64"), ("64x64", 8, 2.5)),
    ):
        for schemas, app in ((jschemas, japp), (tschemas, tapp)):
            req = schemas.GenerateRequest(prompt="x", **given)
            app._apply_mode_defaults(req, FakeMode())
            assert (req.size, req.num_inference_steps, req.guidance_scale) == want


def test_server_config_from_env(monkeypatch):
    for k, v in (("MODEL_ROOT", "/models"), ("MODEL", "ckpt"), ("NUM_WORKERS", "3"),
                 ("QUEUE_MAX", "7"), ("DEFAULT_SIZE", "384x384"), ("DEFAULT_TIMEOUT", "60"),
                 ("SR_NUM_WORKERS", "2"), ("YUME_ENABLED", "1"), ("SR_MAX_PIXELS", "99"),
                 ("DREAMLAB_PRELOAD_MODES", "all"), ("WARMUP", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MODES_CONFIG", raising=False)
    want = dataclasses.asdict(japp.ServerConfig.from_env())
    got = dataclasses.asdict(tapp.ServerConfig.from_env())
    assert got == want
    assert got["model_path"] == "/models/ckpt" and got["yume_enabled"]


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_img2img_endpoint(srv):
    img = np.random.RandomState(0).randint(0, 255, (32, 32, 3), np.uint8)
    form = as_form({"prompt": "repaint as a cat", "strength": "0.6", "steps": "2",
                    "seed": "11"}, {"file": ("in.png", _png_bytes(img), "image/png")})
    j, p = srv.both("POST", "/v1/img2img", *form)
    assert_same(j, p)
    assert (p.headers["x-seed"], p.headers["x-strength"]) == ("11", "0.6")


def test_inpaint_endpoint_with_mask(srv):
    img = np.random.RandomState(1).randint(0, 255, (32, 32, 3), np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[8:16, 8:16] = 255
    form = as_form({"prompt": "fill with flowers", "steps": "2", "seed": "3"},
                   {"file": ("in.png", _png_bytes(img), "image/png"),
                    "mask": ("mask.png", _png_bytes(mask), "image/png")})
    j, p = srv.both("POST", "/v1/inpaint", *form)
    assert_same(j, p)
    # an RGB mask goes through PIL's RGB -> L on both sides
    rgb_mask = np.repeat(mask[..., None], 3, axis=2)
    rgb_mask[..., 1] //= 3
    form = as_form({"prompt": "fill with flowers", "steps": "2", "seed": "3"},
                   {"file": ("in.png", _png_bytes(img), "image/png"),
                    "mask": ("mask.png", _png_bytes(rgb_mask), "image/png")})
    assert_same(*srv.both("POST", "/v1/inpaint", *form))


def test_img2img_missing_fields(srv):
    for form in (as_form({"prompt": "no image"}),
                 as_form(files={"file": ("x.png", b"123", "image/png")})):
        j, p = srv.both("POST", "/v1/img2img", *form)
        assert_same(j, p)
        assert p.status == 400


def test_request_logger_config(monkeypatch):
    from dreamlab_tpu_torch.serving.request_logger import (RequestLoggerConfig,
                                                           _body_summary, _headers_summary)

    monkeypatch.setenv("LOG_REQUESTS", "1")
    monkeypatch.setenv("LOG_PATH_DENYLIST", "/health,/metrics")
    monkeypatch.setenv("LOG_PATH_PREFIXES", "")
    cfg = RequestLoggerConfig()
    assert cfg.should_log("/generate")
    assert not cfg.should_log("/health") and not cfg.should_log("/metrics/x")
    monkeypatch.setenv("LOG_PATH_PREFIXES", "/api")
    cfg = RequestLoggerConfig()
    assert cfg.should_log("/api/modes") and not cfg.should_log("/generate")
    monkeypatch.setenv("LOG_REQUESTS", "0")
    assert not RequestLoggerConfig().should_log("/api/modes")
    out = _headers_summary({"Authorization": "secret", "Content-Type": "application/json",
                            "X-Custom": "hidden"})
    assert "secret" not in out and "<redacted>" in out and "application/json" in out
    assert "X-Custom" not in out
    assert _body_summary(b'{"a": 1}', "application/json", 100) == '{"a":1}'
    assert _body_summary(json.dumps({"k": "v" * 100}).encode(), "application/json",
                         20).endswith("…")
    assert "multipart" in _body_summary(b"xx", "multipart/form-data", 100)
    assert _body_summary(b"\x00\x01", "application/octet-stream", 100) == "<2 bytes>"


def test_profiler_endpoints(srv, tmp_path):
    """POST /api/profiler/start and /stop: a torch.profiler trace written as
    a Chrome trace into the directory, with the program's spans as ranges
    (those of the pool's thread too); the JAX server's 409s."""
    p = srv.port("POST", "/api/profiler/start", *as_json({"dir": str(tmp_path / "trace")}))
    assert p.status == 200 and p.json()["status"] == "tracing"
    trace_dir = p.json()["dir"]
    assert srv.port("POST", "/generate", *as_json({**GEN, "num_inference_steps": 1})).status == 200
    assert srv.port("POST", "/api/profiler/start", *as_json({})).status == 409
    p = srv.port("POST", "/api/profiler/stop")
    assert p.status == 200 and p.json() == {"status": "stopped", "dir": trace_dir}
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert events
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pool.dispatch", "png.encode"} <= ranges
    assert srv.port("POST", "/api/profiler/stop").status == 409


def test_styles_endpoint(srv):
    j, p = srv.both("GET", "/api/styles")
    assert_same(j, p)
    assert isinstance(p.json()["styles"], list)


def test_index_static_and_unmatched_routes(srv):
    for method, path in (("GET", "/"), ("GET", "/app.js"), ("GET", "/style.css"),
                         ("GET", "/missing.js"), ("GET", "/generate"), ("POST", "/health"),
                         ("DELETE", "/storage/x"), ("GET", "/../../etc/passwd"),
                         ("GET", "/%2e%2e/%2e%2e/etc/passwd"), ("GET", "/ui/../../setup.py"),
                         ("GET", "/api/../health"), ("GET", "/app.js/../index.html"),
                         ("OPTIONS", "/generate"), ("OPTIONS", "/nowhere")):
        assert_same(*srv.both(method, path))
    assert srv.port("GET", "/").body == open(os.path.join(UI_DIST, "index.html"), "rb").read()
    assert srv.port("GET", "/../../etc/passwd").status == 404


# ---------------------------------------------------------------------------
# validation: the port's schemas against pydantic, status and (loc, type)
# ---------------------------------------------------------------------------

INVALID = [
    ("/generate", {}),
    ("/generate", {"prompt": 1}),
    ("/generate", {"prompt": None}),
    ("/generate", {"prompt": "x", "size": "bogus"}),
    ("/generate", {"prompt": "x", "size": 512}),
    ("/generate", {"prompt": "x", "num_inference_steps": 0}),
    ("/generate", {"prompt": "x", "num_inference_steps": 51}),
    ("/generate", {"prompt": "x", "num_inference_steps": 4.5}),
    ("/generate", {"prompt": "x", "num_inference_steps": "4.5"}),
    ("/generate", {"prompt": "x", "num_inference_steps": "four"}),
    ("/generate", {"prompt": "x", "guidance_scale": 20.5}),
    ("/generate", {"prompt": "x", "guidance_scale": "high"}),
    ("/generate", {"prompt": "x", "seed": -1}),
    ("/generate", {"prompt": "x", "seed": 2**31}),
    ("/generate", {"prompt": "x", "style_lora": {"style": "a", "level": 9}}),
    ("/generate", {"prompt": "x", "style_lora": "a"}),
    ("/generate", {"prompt": "x", "superres": "maybe"}),
    ("/generate", {"prompt": "x", "superres_format": "gif"}),
    ("/generate", {"prompt": "x", "superres_quality": 0, "superres_magnitude": 4}),
    ("/generate", {"prompt": "x", "aesthetic_score": 11, "controlnet_scale": -1}),
    ("/generate", [1, 2]),
    ("/generate/stream", {"prompt": "x", "num_inference_steps": 99}),
    ("/sdapi/v1/txt2img", {"batch_size": 9, "styles": "x", "steps": None}),
    ("/sdapi/v1/txt2img", {"width": "wide", "cfg_scale": 21}),
    ("/v1/images/generations", {"n": 9}),
    ("/v1/images/generations", {"prompt": "x", "size": "big"}),
]


@pytest.mark.parametrize("path,body", INVALID, ids=[f"{p}:{json.dumps(b)[:40]}" for p, b in INVALID])
def test_invalid_bodies_match_pydantic(srv, path, body):
    j, p = srv.both("POST", path, *as_json(body))
    assert_same(j, p)
    assert p.status == 422
    assert [(e["loc"], e["type"]) for e in p.json()["detail"]] == \
        [(e["loc"], e["type"]) for e in j.json()["detail"]]


def test_non_json_and_empty_bodies_are_400(srv):
    for body in (b"not json", b""):
        j, p = srv.both("POST", "/generate", body, {"Content-Type": "application/json"})
        assert_same(j, p)
        assert p.status == 400


# ---------------------------------------------------------------------------
# the pool under load: 429, and a client that goes away
# ---------------------------------------------------------------------------


def _park(pool, custom_job):
    gate, entered = threading.Event(), threading.Event()

    def blocker(_worker):
        entered.set()
        assert gate.wait(TIMEOUT)

    pool.submit_job(custom_job(blocker))
    assert entered.wait(TIMEOUT)
    return gate


def test_a_full_queue_answers_429(srv):
    jpool, tpool = srv.pools
    gates = [_park(jpool, JaxCustomJob), _park(tpool, CustomJob)]
    try:
        for pool, job in ((jpool, JaxCustomJob), (tpool, CustomJob)):
            for _ in range(pool.queue.maxsize):
                pool.submit_job(job(lambda w: None))
        j, p = srv.both("POST", "/generate", *as_json(GEN))
        assert_same(j, p)
        assert p.status == 429 and p.json()["detail"] == "queue full (8 jobs)"
    finally:
        for g in gates:
            g.set()
    for pool in srv.pools:
        deadline = time.time() + TIMEOUT
        while pool.queue.qsize() and time.time() < deadline:
            time.sleep(0.01)


def test_a_disconnected_clients_queued_job_never_runs(srv):
    _, tpool = srv.pools
    gate = _park(tpool, CustomJob)
    try:
        body, headers = as_json({**GEN, "seed": 424242})
        sock = socket.create_connection(("127.0.0.1", srv.tsrv.port))
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        deadline = time.time() + TIMEOUT
        while not tpool.queue.qsize() and time.time() < deadline:
            time.sleep(0.005)
        (job,) = list(tpool.queue.queue)
        sock.close()
        while not job.future.cancelled() and time.time() < deadline:
            time.sleep(0.005)
        assert job.future.cancelled()
    finally:
        gate.set()
    assert srv.port("POST", "/generate", *as_json({**GEN, "seed": 8})).status == 200
    assert 424242 not in srv.log and 8 in srv.log


# ---------------------------------------------------------------------------
# the HTTP layer
# ---------------------------------------------------------------------------


def test_chunked_request_body(srv):
    body = json.dumps(GEN).encode()
    chunks = [body[i:i + 7] for i in range(0, len(body), 7)]
    replies = []
    for port in (srv.jsrv.port, srv.tsrv.port):
        def call(port=port):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
            try:
                c.request("POST", "/generate", body=iter(chunks), encode_chunked=True,
                          headers={"Content-Type": "application/json",
                                   "Transfer-Encoding": "chunked"})
                r = c.getresponse()
                return Reply(r.status, {k.lower(): v for k, v in r.getheaders()}, r.read())
            finally:
                c.close()
        replies.append(srv.run_jax(call) if port == srv.jsrv.port else call())
    assert_same(*replies)
    assert replies[1].status == 200


def _oversized(port):
    """A body 1 byte over 64 MiB, sent from a thread while the reply is read."""
    n = (64 << 20) + 1
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n" % n)

    def send():
        chunk = b" " * (1 << 20)
        try:
            for i in range(0, n, len(chunk)):
                sock.sendall(chunk[:min(len(chunk), n - i)])
        except OSError:
            pass  # the server refused the rest

    t = threading.Thread(target=send, daemon=True)
    t.start()
    resp = http.client.HTTPResponse(sock)
    resp.begin()
    status = resp.status
    sock.close()
    t.join(timeout=TIMEOUT)
    return status


def test_a_body_over_64_mib_is_413(srv):
    assert srv.run_jax(lambda: _oversized(srv.jsrv.port)) == _oversized(srv.tsrv.port) == 413
    assert srv.port("GET", "/health").status == 200


def test_keep_alive_over_two_requests(srv):
    c = http.client.HTTPConnection("127.0.0.1", srv.tsrv.port, timeout=TIMEOUT)
    try:
        first = fetch(None, "GET", "/health", conn=c)
        sock = c.sock
        second = fetch(None, "POST", "/generate", *as_json(GEN), conn=c)
        assert c.sock is sock and sock is not None  # the same connection served both
        assert (first.status, second.status) == (200, 200)
        assert "connection" not in first.headers
        close = fetch(None, "GET", "/health", headers={"Connection": "close"}, conn=c)
        assert close.headers["connection"] == "close"
    finally:
        c.close()


def test_pipelined_requests_on_one_connection(srv):
    """Two requests written back to back before the first reply: both are
    answered in order (bytes that arrive while a handler runs are kept)."""
    sock = socket.create_connection(("127.0.0.1", srv.tsrv.port), timeout=TIMEOUT)
    body = json.dumps(GEN).encode()
    req = (b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
           b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    sock.sendall(req + b"GET /health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
    data = b""
    while chunk := sock.recv(1 << 16):  # the server closes after the second reply
        data += chunk
    sock.close()
    stream = io.BytesIO(data)
    stream.close = lambda: None  # HTTPResponse closes its file after a body

    class Replayed:
        def makefile(self, mode):
            return stream

    first = http.client.HTTPResponse(Replayed())
    first.begin()
    png = first.read()
    second = http.client.HTTPResponse(Replayed())
    second.begin()
    assert (first.status, second.status) == (200, 200)
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and json.loads(second.read())["status"] == "ok"


class _Request:
    method, path = "POST", "/generate"


@pytest.mark.parametrize("exc,status", [
    (asyncio.TimeoutError(), 504), (tapp.QueueFullError("queue full (8 jobs)"), 429),
    (ValueError("bad size"), 400), (RuntimeError("boom"), 500), (KeyError("k"), 500)])
def test_error_middleware_maps_errors_as_the_jax_servers(exc, status):
    """The JAX server's mapping (timeout 504, a full queue 429, ValueError
    400, anything else 500 with a fixed detail; validation's 422 is above);
    an HTTPException passes through."""
    from dreamlab_tpu.engine.worker_pool import QueueFullError as JaxQueueFull

    jexc = JaxQueueFull(*exc.args) if isinstance(exc, tapp.QueueFullError) else exc

    async def run(middleware, e):
        async def handler(_request):
            raise e
        return await middleware(_Request(), handler)

    loop = asyncio.new_event_loop()
    try:
        jr = loop.run_until_complete(run(japp.error_middleware, jexc))
        tr = loop.run_until_complete(run(tapp.error_middleware, exc))
        assert (tr.status, json.loads(tr.body)) == (jr.status, json.loads(jr.text))
        assert tr.status == status
        with pytest.raises(tapp.web.HTTPNotFound):
            loop.run_until_complete(run(tapp.error_middleware,
                                        tapp._json_error(tapp.web.HTTPNotFound, "gone")))
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# /dreams/* (tests/test_server.py's dream cases), both servers
# ---------------------------------------------------------------------------

DREAM_ROUTES = [("POST", "/dreams/start", {"prompt": "x"}), ("POST", "/dreams/stop", None),
                ("GET", "/dreams/status", None), ("GET", "/dreams/top", None),
                ("GET", "/dreams/recent", None), ("GET", "/dreams/stats", None),
                ("GET", "/dreams/image/0123456789abcdef", None)]
# the clock's and the session id's (int(time.time())) fields
DREAM_VOLATILE = {"created_at", "started_at", "dreams_per_sec", "session_id"}
# candidate scores, handed out in call order by ScriptedScorer
DREAM_SCORES = [0.31, 0.87, 0.12, 0.64, 0.93, 0.05, 0.58, 0.77]


def _dream_json(obj):
    if isinstance(obj, dict):
        return {k: _dream_json(v) for k, v in obj.items() if k not in DREAM_VOLATILE}
    if isinstance(obj, list):
        return [_dream_json(v) for v in obj]
    return obj


def assert_same_dream(j: Reply, p: Reply):
    assert (j.status, _contract(j.headers)) == (p.status, _contract(p.headers))
    if p.headers.get("content-type", "").startswith("application/json"):
        assert _dream_json(j.json()) == _dream_json(p.json())
    else:
        assert_pixels_close(j.body, p.body)


class ScriptedScorer:
    """Scores from DREAM_SCORES in call order; ends the session after
    ``batches`` batches (the loop checks its stop flag before each one), so
    both servers' sessions run the same iterations whatever the CPU's speed."""

    def __init__(self, batches):
        self.batches, self.calls, self.dream = batches, 0, None

    def score_batch(self, images, prompt):
        start = self.calls * len(images)
        self.calls += 1
        if self.calls >= self.batches:
            self.dream._stop.set()  # a flag the loop polls: no waiter to wake
        return [DREAM_SCORES[(start + i) % len(DREAM_SCORES)] for i in range(len(images))]


@pytest.fixture(scope="module")
def dreams(tiny, tmp_path_factory):
    _, jpipe, tpipe = tiny
    cfg = dict(default_size="32x32", default_steps=2, request_timeout=60, yume_enabled=True)
    pair = make_pair(str(tmp_path_factory.mktemp("dreams")), jpipe, tpipe, sr=False,
                     storage=False, config=cfg)
    yield pair
    close_pair(pair)


@pytest.mark.parametrize("method,path,body", DREAM_ROUTES, ids=[p for _, p, _ in DREAM_ROUTES])
def test_dreams_without_a_dream_worker_are_503(dreams, method, path, body):
    from dreamlab_tpu.yume import dream_worker as jdw
    from dreamlab_tpu_torch.yume import dream_worker as dw

    jdw.set_dream_worker(None)
    dw.set_dream_worker(None)
    j, p = dreams.both(method, path, *(as_json(body) if body else ()))
    assert_same(j, p)
    assert p.status == 503 and p.json() == {"detail": "yume not initialized"}


def test_dreams_lifecycle_as_the_jax_servers(dreams, tiny, monkeypatch):
    """Start (200), a second start (409), status while the first batch is
    held, then two scripted batches, a render, finalize, stop, top, recent,
    stats, every rendered image (pixels; the port's = run_job's bytes) and
    an image never rendered (404): the same codes and bodies, but the
    clock's fields."""
    import threading

    import numpy as np

    from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
    from dreamlab_tpu.yume import dream_worker as jdw
    from dreamlab_tpu.yume import strategies as jstrat
    from dreamlab_tpu_torch.engine.base import GenSpec
    from dreamlab_tpu_torch.yume import dream_worker as dw
    from dreamlab_tpu_torch.yume import strategies as tstrat

    _, jpipe, tpipe = tiny
    monkeypatch.setenv("YUME_FINALIZE_RENDERS", "2")
    gate = threading.Event()
    made = []
    for mod, strat, worker in ((jdw, jstrat, TPUPipelineWorker(jpipe, 0)),
                               (dw, tstrat, CudaPipelineWorker(tpipe, 0))):
        monkeypatch.setattr(mod, "get_strategy", lambda name, strat=strat: strat.get_strategy(
            name, rng=np.random.RandomState(0)))
        scorer = ScriptedScorer(batches=2)
        dream = mod.DreamWorker(worker, scorer=scorer, redis=None, render_interval=2,
                                score_threshold=0.0, candidate_batch=2, candidate_size="32x32",
                                candidate_steps=2, render_size="32x32", render_steps=2)
        scorer.dream = dream
        generate = dream._generate_candidates
        dream._generate_candidates = lambda seeds, prompt, g=generate: (
            gate.wait(TIMEOUT), g(seeds, prompt))[1]
        mod.set_dream_worker(dream)
        made.append(dream)
    jdream, tdream = made
    try:
        start = {"prompt": "tiny dream", "strategy": "random", "temperature": 1.0}
        j, p = dreams.both("POST", "/dreams/start", *as_json(start))
        assert_same_dream(j, p)
        assert p.status == 200 and p.json()["prompts"] == tdream.prompts
        assert p.json()["session_id"].startswith("dream:")
        j, p = dreams.both("POST", "/dreams/start", *as_json({"prompt": "x"}))
        assert_same(j, p)
        assert p.status == 409 and p.json() == {"detail": "a dream session is already running"}
        j, p = dreams.both("GET", "/dreams/status")
        assert_same_dream(j, p)
        assert p.json()["running"] and p.json()["stats"]["generated"] == 0
        gate.set()
        t0 = time.monotonic()
        while True:  # each request to the JAX server drives its loop
            j, p = dreams.both("GET", "/dreams/status")
            if not (j.json()["running"] or p.json()["running"]):
                break
            assert time.monotonic() - t0 < TIMEOUT, (j.json(), p.json())
            time.sleep(0.01)
        for method, path in (("POST", "/dreams/stop"), ("GET", "/dreams/status"),
                             ("GET", "/dreams/top?n=5"), ("GET", "/dreams/top"),
                             ("GET", "/dreams/recent?n=50"), ("GET", "/dreams/stats")):
            j, p = dreams.both(method, path)
            assert_same_dream(j, p)
        stats = p.json()
        assert (stats["generated"], stats["scored"], stats["kept"], stats["rendered"]) == (4, 4, 4, 3)
        rendered = [c for c in tdream.top if c.rendered_png is not None]
        assert len(rendered) == 3
        for cand in rendered:
            j, p = dreams.both("GET", f"/dreams/image/{cand.candidate_id}")
            assert_same_dream(j, p)
            assert p.headers["content-type"] == "image/png"
            assert p.body == CudaPipelineWorker(tpipe, 0).run_job(GenSpec(
                prompt=cand.prompt, size="32x32", num_inference_steps=2, seed=cand.seed))[0]
        j, p = dreams.both("GET", "/dreams/image/0123456789abcdef")
        assert_same(j, p)
        assert p.status == 404 and p.json() == {"detail": "no rendered image"}
    finally:
        gate.set()
        jdw.set_dream_worker(None)
        dw.set_dream_worker(None)


@pytest.mark.parametrize("body", [{}, {"prompt": ""}, {"strategy": "random"}])
def test_dreams_start_without_a_prompt_is_400(dreams, tiny, body):
    from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
    from dreamlab_tpu.yume import dream_worker as jdw
    from dreamlab_tpu_torch.yume import dream_worker as dw

    _, jpipe, tpipe = tiny
    jdw.set_dream_worker(jdw.DreamWorker(TPUPipelineWorker(jpipe, 0)))
    dw.set_dream_worker(dw.DreamWorker(CudaPipelineWorker(tpipe, 0)))
    try:
        j, p = dreams.both("POST", "/dreams/start", *as_json(body))
        assert_same(j, p)
        assert p.status == 400 and p.json() == {"detail": "field 'prompt' required"}
        assert not dw.get_dream_worker().get_status()["running"]
    finally:
        jdw.set_dream_worker(None)
        dw.set_dream_worker(None)


def test_dreams_routes_are_served_only_with_yume_enabled(srv):
    j, p = srv.both("GET", "/dreams/status")
    assert_same(j, p)
    assert p.status == 404
