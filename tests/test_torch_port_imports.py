"""Import hygiene: the port imports nothing of JAX and nothing of ``dreamlab_tpu``,
reads safetensors files without the ``safetensors`` package, YAML without
PyYAML, serves HTTP without aiohttp, pydantic, requests, multidict and yarl,
imports PIL and websocket-client only inside a call that needs them, and
transformers only where Yume's scorer ladder reaches its second rung."""

import os
import pkgutil
import re
import subprocess
import sys

import dreamlab_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PIL is imported only by a job that needs its codecs, websocket-client only
# by a ComfyUI run that opens its socket, transformers only by Yume's scorer
# ladder when no local CLIP directory loads
FORBIDDEN = ("jax", "jaxlib", "dreamlab_tpu", "safetensors", "yaml", "PIL", "aiohttp",
             "pydantic", "pydantic_core", "requests", "multidict", "yarl", "websocket",
             "transformers")


def test_importing_every_module_loads_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        dreamlab_tpu_torch.__path__, "dreamlab_tpu_torch."))
    assert "dreamlab_tpu_torch.engine.cuda_worker" in mods
    assert "dreamlab_tpu_torch.scripts.ab_attention_layout" in mods
    for new in ("loader", "engine.worker_factory", "utils.safetensors", "lora",
                "textual_inversion", "engine.styles", "engine.model_registry",
                "utils.yaml_lite", "models.controlnet", "engine.worker_pool",
                "engine.mode_config", "engine.file_watcher", "models.superres",
                "utils.onnx_weights", "utils.image_ops", "serving.superres_service",
                "serving.http", "serving.schemas", "serving.app", "serving.model_routes",
                "serving.compat_endpoints", "serving.legacy_service", "serving.request_logger",
                "serving.logging_config", "serving.run", "serving.comfy_routes",
                "serving.startup_hooks", "persistence", "persistence.storage_provider",
                "persistence.filesystem_provider", "persistence.redis_provider", "utils.resp",
                "utils.verify_cuda", "invokers.jobs", "invokers.profiles",
                "invokers.workflow_store", "invokers.comfy_client", "cli",
                "models.clip_vision", "yume", "yume.scoring", "yume.strategies",
                "yume.dream_worker", "yume.dream_init", "yume.dream_endpoints",
                "utils.assets", "utils.custom_detector_examples", "utils.model_detector"):
        assert f"dreamlab_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        # importing a probe runs no work: no kernel wrapper has launched
        "counts = {m: sys.modules[m].LAUNCHES for m in sys.modules"
        " if m.startswith('dreamlab_tpu_torch.') and hasattr(sys.modules[m], 'LAUNCHES')}\n"
        "assert len(counts) >= 5 and not any(counts.values()), counts\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_serving_a_request_loads_none_of_them():
    """``create_app`` and one ``/health`` request over a real socket, in a
    fresh process: none of the forbidden packages is loaded."""
    code = (
        "import http.client, sys\n"
        "from dreamlab_tpu_torch.serving.app import ServerConfig, create_app\n"
        "from dreamlab_tpu_torch.serving.http import ServerThread\n"
        "srv = ServerThread(create_app(ServerConfig(), skip_startup=True)).start()\n"
        "c = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=60)\n"
        "c.request('GET', '/health'); r = c.getresponse()\n"
        "assert r.status == 200 and b'ok' in r.read()\n"
        "srv.stop()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_serving_the_dreams_loads_none_of_them():
    """``create_app`` with ``YUME_ENABLED`` and a ``/dreams/status`` request
    without a dream worker (503), in a fresh process: the dream routes load
    none of the forbidden packages, transformers included."""
    code = (
        "import http.client, sys\n"
        "from dreamlab_tpu_torch.serving.app import ServerConfig, create_app\n"
        "from dreamlab_tpu_torch.serving.http import ServerThread\n"
        "app = create_app(ServerConfig(yume_enabled=True), skip_startup=True)\n"
        "srv = ServerThread(app).start()\n"
        "c = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=60)\n"
        "c.request('GET', '/dreams/status'); r = c.getresponse()\n"
        "assert r.status == 503 and b'yume not initialized' in r.read()\n"
        "srv.stop()\n"
        "assert 'dreamlab_tpu_torch.yume.dream_endpoints' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^(import|from)\s+(jax|dreamlab_tpu|safetensors|yaml|PIL|aiohttp|"
                         r"pydantic|requests|multidict|yarl|websocket|transformers)(\.|\s|$)"
                         r"|^\s*(import|from)\s+(jax|dreamlab_tpu|safetensors|yaml|aiohttp|"
                         r"pydantic|requests|multidict|yarl)(\.|\s|$)",
                         re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "dreamlab_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path
