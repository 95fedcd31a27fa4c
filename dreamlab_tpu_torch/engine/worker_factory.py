"""Worker factory: checkpoint path -> detected arch -> loaded CUDA worker
(port of ``dreamlab_tpu/engine/worker_factory.py::create_tpu_worker``).

A diffusers directory is classified as SD1.5 or SDXL by its UNet's
``cross_attention_dim`` (``unet/config.json``, as the JAX package's
``utils/model_detector.py::diffusers_dir_detector`` and
``detect_worker_type`` do), loaded by ``loader.load_pipeline`` and served by
a ``CudaPipelineWorker``. What later slices bring is refused with
``ValueError``: single files, LoRAs, textual-inversion embeddings,
ControlNets and the refiner ensemble.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

from ..loader import classify_arch, load_pipeline
from ..pipeline import LCMPipeline, resolve_device
from .cuda_worker import CudaPipelineWorker

logger = logging.getLogger(__name__)


def detect_worker_type(model_path: str) -> str:
    """'sd15' | 'sdxl' of a diffusers directory; ValueError for anything else."""
    if os.path.isfile(model_path):
        raise ValueError(f"{model_path} is a single file: single-file checkpoints (and "
                         "their LoRA/ControlNet detection) come with the next slice of "
                         "the port; pass a diffusers directory")
    unet_json = os.path.join(model_path, "unet", "config.json")
    if not os.path.exists(unet_json):
        if os.path.exists(os.path.join(model_path, "config.json")):
            raise ValueError(f"{model_path} has no unet/ (a ControlNet or another single "
                             "model?): ControlNets come with the ControlNet slice")
        raise ValueError(f"{model_path} is not a diffusers checkpoint directory "
                         "(no unet/config.json)")
    with open(unet_json) as f:
        cad = json.load(f).get("cross_attention_dim")
    return classify_arch(cad)


def create_cuda_worker(worker_id: int, model_path: str, *, dtype=torch.bfloat16,
                       device=None, loras=None, embeddings=None, controlnet=None,
                       refiner=None) -> CudaPipelineWorker:
    """Load a diffusers checkpoint directory and wrap it in a CudaPipelineWorker
    on ``device`` (None = the CUDA device; "cpu" runs the plain versions)."""
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
    return CudaPipelineWorker(pipeline, worker_id)
