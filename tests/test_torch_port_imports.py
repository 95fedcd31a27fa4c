"""Import hygiene: the port imports nothing of JAX and nothing of ``dreamlab_tpu``,
reads safetensors files without the ``safetensors`` package, YAML without
PyYAML, and imports PIL only inside a call that needs it."""

import os
import pkgutil
import re
import subprocess
import sys

import dreamlab_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_importing_every_module_loads_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        dreamlab_tpu_torch.__path__, "dreamlab_tpu_torch."))
    assert "dreamlab_tpu_torch.engine.cuda_worker" in mods
    assert "dreamlab_tpu_torch.scripts.ab_attention_layout" in mods
    for new in ("loader", "engine.worker_factory", "utils.safetensors", "lora",
                "textual_inversion", "engine.styles", "engine.model_registry",
                "utils.yaml_lite", "models.controlnet", "engine.worker_pool",
                "engine.mode_config", "engine.file_watcher", "models.superres",
                "utils.onnx_weights", "utils.image_ops", "serving.superres_service"):
        assert f"dreamlab_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        # importing a probe runs no work: no kernel wrapper has launched
        "counts = {m: sys.modules[m].LAUNCHES for m in sys.modules"
        " if m.startswith('dreamlab_tpu_torch.') and hasattr(sys.modules[m], 'LAUNCHES')}\n"
        "assert len(counts) >= 5 and not any(counts.values()), counts\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'dreamlab_tpu' or m.startswith('dreamlab_tpu.')"
        " or m == 'safetensors' or m.startswith('safetensors.')"
        " or m == 'yaml' or m.startswith('yaml.')"
        # PIL is imported only by a super-resolution job that needs its codecs
        " or m == 'PIL' or m.startswith('PIL.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^(import|from)\s+(jax|dreamlab_tpu|safetensors|yaml|PIL)(\.|\s|$)"
                         r"|^\s*(import|from)\s+(jax|dreamlab_tpu|safetensors|yaml)(\.|\s|$)",
                         re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "dreamlab_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path
