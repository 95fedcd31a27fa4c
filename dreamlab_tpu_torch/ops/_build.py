"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Every ``csrc/*.cu`` compiles to an object file in its own ``nvcc`` process
(all started together), and the objects link into one shared library with a
plain C interface. No PyTorch headers are involved, so a build takes seconds,
not the minutes of ``torch.utils.cpp_extension``. The library lands in
``dreamlab_tpu_torch/_build/`` (ignored by git) under a name keyed by a hash
of the sources and flags, so an edited source never loads a stale build.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# dtype codes of csrc/common.cuh::DlDtype
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels (once per source hash); return the .so path."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    so = BUILD_DIR / f"libdreamlab_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / f"{so.stem}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{so.stem}_{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def build_log() -> str:
    """nvcc's output (register and shared-memory use per kernel) of the build."""
    so = build()
    log = so.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel(name: str, argtypes) -> object:
    """The C entry point ``name`` with its argument types set; builds on first use."""
    global _lib
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            if _lib is None:
                _lib = ctypes.CDLL(str(build()))
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a non-zero return of a C entry point (a CUDA error code)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {t.dtype}")
    return code
