"""Import hygiene: the port imports nothing of JAX and nothing of ``dreamlab_tpu``."""

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
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        # importing a probe runs no work: no kernel wrapper has launched
        "counts = {m: sys.modules[m].LAUNCHES for m in sys.modules"
        " if m.startswith('dreamlab_tpu_torch.') and hasattr(sys.modules[m], 'LAUNCHES')}\n"
        "assert len(counts) >= 5 and not any(counts.values()), counts\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'dreamlab_tpu' or m.startswith('dreamlab_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|dreamlab_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "dreamlab_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path
