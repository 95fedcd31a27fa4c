"""Worker factory: checkpoint path -> detected arch -> loaded CUDA worker
(port of ``dreamlab_tpu/engine/worker_factory.py::create_tpu_worker``).

A path is classified by the model detector (``utils/model_detector.py``:
tensor shapes and configs, never file names), loaded by
``loader.load_pipeline`` (a diffusers directory or a single LDM-layout
file) and served by a ``CudaPipelineWorker``. LoRAs and ControlNets cannot
serve on their own and raise ``WorkerCreationError``; what later slices
bring (mode LoRAs, textual-inversion embeddings, attached ControlNets, the
refiner ensemble) is refused with ``ValueError``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import torch

from ..loader import load_pipeline
from ..pipeline import LCMPipeline, resolve_device
from ..utils.model_detector import DetectionError, detect_model
from .cuda_worker import CudaPipelineWorker

logger = logging.getLogger(__name__)


class WorkerCreationError(Exception):
    pass


def detect_worker_type(model_path: str) -> str:
    """'sd15' | 'sdxl' of a checkpoint, from its tensor shapes; raises
    WorkerCreationError for what cannot serve as a model."""
    try:
        info = detect_model(model_path)
    except DetectionError as e:
        raise WorkerCreationError(str(e)) from e
    if info.is_lora:
        raise WorkerCreationError(f"{model_path} is a LoRA, not a checkpoint")
    if info.is_controlnet:
        raise WorkerCreationError(
            f"{model_path} is a ControlNet — attach it to a mode via the "
            "modes.yaml 'controlnet:' key, it cannot serve standalone")
    if info.arch is None:
        raise WorkerCreationError(
            f"unsupported model (cross_attention_dim={info.cross_attention_dim}): "
            f"{model_path}")
    return info.arch


def create_cuda_worker(worker_id: int, model_path: str, *, dtype=torch.bfloat16,
                       device=None, loras=None, embeddings=None, controlnet=None,
                       refiner=None,
                       warmup_size: Optional[Tuple[int, int]] = None) -> CudaPipelineWorker:
    """Load a checkpoint (diffusers directory or single file) and wrap it in a
    CudaPipelineWorker on ``device`` (None = the CUDA device; "cpu" runs the
    plain versions). warmup_size: (width, height) of a bucket to capture
    before the worker is returned."""
    for given, what, where in ((loras, "LoRAs", "the LoRA slice"),
                               (embeddings, "textual-inversion embeddings", "the LoRA slice"),
                               (controlnet, "ControlNets", "the ControlNet slice"),
                               (refiner, "refiner checkpoints", "the img2img/refiner slice")):
        if given:
            raise ValueError(f"{what} are not served yet: they come with {where} of the port")
    dev = resolve_device(device)
    arch = detect_worker_type(model_path)
    t0 = time.perf_counter()
    pipeline = LCMPipeline(load_pipeline(model_path, device=dev), dtype=dtype, device=dev)
    logger.info("worker %d: loaded %s (%s) in %.1fs", worker_id, model_path, arch,
                time.perf_counter() - t0)
    if warmup_size:
        return CudaPipelineWorker(pipeline, worker_id, default_size=warmup_size, warmup=True)
    return CudaPipelineWorker(pipeline, worker_id)
