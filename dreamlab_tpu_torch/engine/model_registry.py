"""Thread-safe registry of what occupies the card's memory (port of
``dreamlab_tpu/engine/model_registry.py``).

The same API and ``/api/vram`` stats schema as the JAX package's, over CUDA
memory: the total and the bytes in use come from ``torch.cuda.mem_get_info``
on the registry's device (every process's allocations and the caching
allocator's reserve count as used, since none of it is free for a new
load). The process keeps one registry per device (``get_model_registry``),
so a worker asks about the card its pipeline is on. A registry whose device
is the CPU has no device stats and counts the registered bytes, as the
reference does on a backend without memory stats.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from ..utils.safetensors import read_header

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoadedModel:
    name: str
    model_path: str
    worker_id: int
    hbm_bytes: int
    loras: List[str] = dataclasses.field(default_factory=list)
    loaded_at: float = dataclasses.field(default_factory=time.time)


HEADROOM = 0.9  # share of the device's memory that loads may fill
_HALF_FLOATS = ("F16", "BF16")  # 2-byte dtypes: 2 bytes short of fp32 an element


def _fp32_bytes(path: str) -> int:
    """A checkpoint file's bytes, with its 2-byte float tensors counted at
    4 bytes an element where its safetensors header says so."""
    size = os.path.getsize(path)
    if not path.endswith(".safetensors"):
        return size
    try:
        header = read_header(path)
        return size + sum(2 * math.prod(int(d) for d in info["shape"])
                          for info in header.values() if info["dtype"] in _HALF_FLOATS)
    except (OSError, ValueError, KeyError, TypeError):
        return size


def _device_key(device=None) -> torch.device:
    """``device`` with its CUDA index filled in; None = the current CUDA
    device, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_memory_stats(device: torch.device) -> Dict[str, int]:
    """Total, used and peak-allocated bytes of ``device``; zeros on the CPU."""
    if device.type != "cuda":
        return {"total": 0, "allocated": 0, "peak": 0}
    free, total = torch.cuda.mem_get_info(device)
    return {"total": int(total), "allocated": int(total - free),
            "peak": int(torch.cuda.max_memory_allocated(device))}


class ModelRegistry:
    """Tracks which models (and merged LoRA weights) occupy the card, and
    whether a new one fits."""

    def __init__(self, total_hbm_bytes: Optional[int] = None, device=None):
        self._lock = threading.Lock()
        self._models: Dict[str, LoadedModel] = {}
        self._total_override = total_hbm_bytes
        self.device = _device_key(device)

    def register_model(self, name: str, model_path: str, worker_id: int, hbm_bytes: int,
                       loras: Optional[List[str]] = None) -> LoadedModel:
        with self._lock:
            if name in self._models:
                logger.warning("registry: overwriting entry %s", name)
            entry = LoadedModel(name=name, model_path=model_path, worker_id=worker_id,
                                hbm_bytes=hbm_bytes, loras=list(loras or []))
            self._models[name] = entry
            return entry

    def unregister_model(self, name: str) -> bool:
        with self._lock:
            return self._models.pop(name, None) is not None

    def clear(self):
        with self._lock:
            self._models.clear()

    def get_model(self, name: str) -> Optional[LoadedModel]:
        with self._lock:
            return self._models.get(name)

    def list_models(self) -> List[LoadedModel]:
        with self._lock:
            return list(self._models.values())

    def total_hbm(self) -> int:
        if self._total_override is not None:
            return self._total_override
        return device_memory_stats(self.device)["total"]

    def get_used_hbm(self) -> int:
        """The device's used bytes where it reports them; else the sum of
        the registered sizes."""
        used = device_memory_stats(self.device)["allocated"]
        if used:
            return used
        with self._lock:
            return sum(m.hbm_bytes for m in self._models.values())

    def can_fit(self, required_bytes: int) -> bool:
        total = self.total_hbm()
        if not total:
            return True  # no stats: don't block loading
        return self.get_used_hbm() + required_bytes <= total * HEADROOM

    @staticmethod
    def estimate_model_hbm(model_path: str, dtype_bytes: int = 2) -> int:
        """The checkpoint files' fp32 bytes x1.2 (activations and
        fragmentation) x ``dtype_bytes`` / 4, the JAX package's formula,
        which takes every file for fp32. A safetensors file whose header
        parses counts its fp16 and bf16 elements at 4 bytes (so its
        elements x ``dtype_bytes`` x 1.2, twice the reference's estimate
        for an fp16 file); an fp32 file, a ``.bin`` or ``.ckpt`` and an
        unreadable header count their bytes, as in the reference. It does
        not see a mode's graph pool (a captured bucket's activations),
        which the pool measures instead, as the device's used bytes before
        and after the build and its warm-up."""
        if os.path.isfile(model_path):  # single-file checkpoints
            paths = [model_path]
        else:
            paths = [os.path.join(root, f) for root, _, files in os.walk(model_path)
                     for f in files if f.endswith((".safetensors", ".bin", ".ckpt"))]
        return int(sum(map(_fp32_bytes, paths)) * 1.2 * (dtype_bytes / 4))

    def get_hbm_stats(self) -> Dict:
        """The ``/api/vram`` payload."""
        stats = device_memory_stats(self.device)
        total = self.total_hbm()
        used = self.get_used_hbm()
        with self._lock:
            models = [{"name": m.name, "path": m.model_path, "worker_id": m.worker_id,
                       "vram_gb": round(m.hbm_bytes / 1e9, 2), "loras": m.loras,
                       "loaded_at": m.loaded_at} for m in self._models.values()]
        return {
            "device": str(self.device),
            "total_gb": round(total / 1e9, 2),
            "allocated_gb": round(stats["allocated"] / 1e9, 2),
            "used_gb": round(used / 1e9, 2),
            "available_gb": round(max(total - used, 0) / 1e9, 2),
            "used_percent": round(100.0 * used / total, 1) if total else 0.0,
            "models": models,
        }


_registries: Dict[torch.device, ModelRegistry] = {}
_registry_lock = threading.Lock()


def get_model_registry(device=None) -> ModelRegistry:
    """The process's registry of ``device`` (None = the current CUDA device,
    else the CPU)."""
    key = _device_key(device)
    with _registry_lock:
        if key not in _registries:
            _registries[key] = ModelRegistry(device=key)
        return _registries[key]


def reset_model_registry():
    with _registry_lock:
        _registries.clear()
