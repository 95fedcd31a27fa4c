"""Worker factory: checkpoint path -> detected arch -> loaded CUDA worker
(port of ``dreamlab_tpu/engine/worker_factory.py::create_tpu_worker``).

A path is classified by the model detector (``utils/model_detector.py``:
tensor shapes and configs, never file names), loaded by
``loader.load_pipeline`` with its VAE encoder (a diffusers directory or a
single LDM-layout file), extended by the mode's textual-inversion
embeddings before the weights are placed, merged with the mode's LoRAs,
and served by a ``CudaPipelineWorker`` with the style registry. LoRAs and
ControlNets cannot serve on their own and raise ``WorkerCreationError``. A
mode's ControlNet (``attach_mode_controlnet``) and refiner checkpoint (the
SDXL base -> refiner ensemble) are loaded beside it; either one that fails
to load warns, and the worker serves without it, as in the reference.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import torch

from .. import lora
from ..loader import load_controlnet, load_pipeline
from ..pipeline import LCMPipeline, resolve_device
from ..textual_inversion import apply_embeddings
from ..utils.model_detector import DetectionError, detect_model
from .cuda_worker import CudaPipelineWorker
from .styles import get_style_registry

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


def apply_mode_loras(pipeline, loras) -> None:
    """Merge a mode's LoRAs (``.file``, ``.strength``) into the pipeline's
    UNet and first text tower, in place, before the worker keeps its style
    base. A LoRA that cannot be read or merged warns and is skipped: the
    mode serves the weights it has (a text merge that fails leaves the UNet
    merged, as in the reference)."""
    for entry in loras or []:
        t0 = time.perf_counter()
        try:
            tensors = lora.load_lora(entry.file)
            lora.merge_lora_into_tree(pipeline.unet_params, tensors.unet, entry.strength,
                                      shard=pipeline.unet_leaf_slice)
            if tensors.text:
                lora.merge_lora_into_tree(pipeline.text_params, tensors.text, entry.strength)
        except Exception as e:  # warn-don't-raise: never fail a mode over an adapter
            logger.warning("mode lora %s not applied (%s); serving base weights",
                           entry.file, e)
            continue
        logger.info("mode lora %s (strength %.2f, %d modules) merged in %.0f ms", entry.file,
                    entry.strength, tensors.num_modules, 1e3 * (time.perf_counter() - t0))


def attach_mode_controlnet(pipeline, controlnet) -> float:
    """Load a mode's ControlNet (``.file``: a diffusers-layout directory,
    ``.scale``) onto the pipeline's device and attach it; returns the mode's
    default conditioning scale. A ControlNet that cannot be read or does not
    fit the UNet warns, and the mode serves without conditioning (scale 1.0
    returned), as in the reference."""
    t0 = time.perf_counter()
    try:
        params, cfg = load_controlnet(controlnet.file, device=pipeline.device)
        pipeline.set_controlnet(params, cfg)
    except Exception as e:  # warn-don't-raise: never fail a mode over a ControlNet
        logger.warning("controlnet %s not attached (%s); serving without conditioning",
                       controlnet.file, e)
        return 1.0
    logger.info("controlnet %s attached (scale %.2f) in %.0f ms", controlnet.file,
                controlnet.scale, 1e3 * (time.perf_counter() - t0))
    return controlnet.scale


def _load_refiner(refiner, *, dtype, device, mesh=None,
                  tensor_parallel: bool = False) -> Optional[LCMPipeline]:
    """A mode's refiner checkpoint (``.file``) as a pipeline with its VAE
    encoder, or None with a warning where it cannot load (the worker then
    serves the base alone)."""
    t0 = time.perf_counter()
    try:
        pipe = LCMPipeline(load_pipeline(refiner.file, device=device, load_vae_encoder=True),
                           dtype=dtype, device=device, mesh=mesh,
                           tensor_parallel=tensor_parallel)
    except Exception as e:  # warn-don't-raise, as for LoRAs and ControlNets
        logger.warning("refiner %s not loaded (%s); serving base only", refiner.file, e)
        return None
    logger.info("refiner %s loaded (switch_at %.2f) in %.1fs", refiner.file, refiner.switch_at,
                time.perf_counter() - t0)
    return pipe


def create_cuda_worker(worker_id: int, model_path: str, *, dtype=torch.bfloat16,
                       device=None, styles: Optional[Dict[str, lora.StyleDef]] = None,
                       loras=None, embeddings=None, controlnet=None, refiner=None,
                       warmup_size: Optional[Tuple[int, int]] = None, mesh=None,
                       tensor_parallel: bool = False) -> CudaPipelineWorker:
    """Load a checkpoint (diffusers directory or single file) with its VAE
    encoder and wrap it in a CudaPipelineWorker on ``device`` (None = the
    CUDA device; "cpu" runs the plain versions).

    embeddings: textual-inversion entries (``.file``, optional ``.name``)
    applied to the bundle before the weights are placed. loras: mode LoRAs
    (``.file``, ``.strength``) merged into the placed weights. styles: the
    per-request styles (None = ``get_style_registry()``). controlnet: the
    mode's ControlNet (``.file``, ``.scale``), attached to the pipeline.
    refiner: the mode's refiner checkpoint (``.file``, ``.switch_at``),
    loaded beside it for the base -> refiner ensemble. warmup_size:
    (width, height) of a bucket to capture before the worker is returned.
    mesh, tensor_parallel: this rank's ("data", "model") mesh and whether
    the UNet splits over its model axis, for the pipeline and the refiner's
    (``LCMPipeline``).
    """
    dev = resolve_device(device)
    arch = detect_worker_type(model_path)
    t0 = time.perf_counter()
    bundle = load_pipeline(model_path, device=dev, load_vae_encoder=True)
    if embeddings:
        apply_embeddings(bundle, embeddings)
    pipeline = LCMPipeline(bundle, dtype=dtype, device=dev, mesh=mesh,
                           tensor_parallel=tensor_parallel)
    del bundle
    if loras:
        apply_mode_loras(pipeline, loras)
    ensemble = {}
    if controlnet is not None:
        ensemble["controlnet_scale"] = attach_mode_controlnet(pipeline, controlnet)
    if refiner is not None:
        ensemble["refiner"] = _load_refiner(refiner, dtype=dtype, device=dev, mesh=mesh,
                                            tensor_parallel=tensor_parallel)
        if ensemble["refiner"] is not None:
            ensemble["refiner_switch_at"] = refiner.switch_at
    logger.info("worker %d: loaded %s (%s) in %.1fs", worker_id, model_path, arch,
                time.perf_counter() - t0)
    if styles is None:
        styles = get_style_registry()
    if warmup_size:
        return CudaPipelineWorker(pipeline, worker_id, styles=styles,
                                  default_size=warmup_size, warmup=True, **ensemble)
    return CudaPipelineWorker(pipeline, worker_id, styles=styles, **ensemble)
