"""Examples of extending the model-detector stack (a copy of
``dreamlab_tpu/utils/custom_detector_examples.py`` on the port's
``ModelDetector``).

Each example is a plain function over ``ModelInfo`` appended with
``ModelDetector.add_detector``; they show the extension points the stack
guarantees (the config and shapes the built-in detectors leave in ``extra``,
fall-through on no match). LoRA tensors are read with the port's
safetensors reader.

    detector = ModelDetector()
    detector.add_detector(lcm_detector)
    info = detector.detect(path)
    info.extra.get("is_lcm")
"""

from __future__ import annotations

import os
from typing import Optional

from .model_detector import ModelDetector, ModelInfo


def lcm_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """Flag LCM-distilled checkpoints: the UNet carries a guidance
    conditioning projection (``time_cond_proj_dim`` in diffusers configs,
    ``cond_proj`` tensors in single files)."""
    cfg = info.extra.get("unet_config")
    if cfg is not None:
        info.extra["is_lcm"] = cfg.get("time_cond_proj_dim") is not None
    return info


def turbo_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """Heuristic for *-Turbo variants by directory naming + SDXL class
    (shape-identical to base SDXL, so names are the only signal)."""
    base = os.path.basename(info.path.rstrip("/")).lower()
    if info.variant == "SDXL" and "turbo" in base:
        info.extra["is_turbo"] = True
        info.recommended_sizes = ["512x512", "768x768"]
    return info


def refiner_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """SDXL refiner models have a single text tower (no text_encoder dir)."""
    if info.format == "diffusers_dir" and info.variant == "SDXL":
        has_te2 = os.path.isdir(os.path.join(info.path, "text_encoder_2"))
        has_te1 = os.path.isdir(os.path.join(info.path, "text_encoder"))
        if has_te2 and not has_te1:
            info.extra["is_refiner"] = True
    return info


def license_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """Surface a LICENSE/README presence flag for policy pipelines."""
    if os.path.isdir(info.path):
        for name in ("LICENSE", "LICENSE.md", "LICENSE.txt"):
            if os.path.exists(os.path.join(info.path, name)):
                info.extra["license_file"] = name
                break
    return info


def lora_strength_analyzer(info: ModelInfo) -> Optional[ModelInfo]:
    """Suggest strength levels from LoRA tensor magnitudes: sample
    up-projection tensors, take the mean absolute magnitude, and map it to a
    ladder -- small deltas want higher strengths, large deltas want gentler
    ones."""
    if not info.is_lora or not info.path.endswith(".safetensors"):
        return info
    try:
        import numpy as np
        import torch

        from .safetensors import load_file

        tensors = load_file(info.path)  # memory-mapped: only what is read is loaded
        # up-projections only: .alpha scalars (values 4-32) would swamp
        # the weight magnitudes and always pick the gentlest ladder
        lora_keys = [
            k for k in sorted(tensors)
            if ("lora_up" in k or "lora_B" in k) and not k.endswith(".alpha")
        ][:10]
        magnitudes = []
        for key in lora_keys:
            t = tensors[key]
            # numpy in the file's dtype, as the JAX package reads it (numpy has no bf16)
            t = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            if t.ndim >= 2:
                magnitudes.append(float(np.abs(t).mean()))
        if magnitudes:
            avg = float(np.mean(magnitudes))
            if avg < 0.01:
                ladder = [0.8, 1.0, 1.2, 1.5]
            elif avg < 0.05:
                ladder = [0.6, 0.8, 1.0, 1.2]
            else:
                ladder = [0.4, 0.6, 0.8, 1.0]
            info.extra["lora_avg_magnitude"] = avg
            info.extra["suggested_strength_levels"] = ladder
    except Exception as e:
        info.extra["lora_analysis_error"] = str(e)
    return info


def make_extended_detector() -> ModelDetector:
    det = ModelDetector()
    for extra in (
        lcm_detector,
        turbo_detector,
        refiner_detector,
        license_detector,
        lora_strength_analyzer,
    ):
        det.add_detector(extra)
    return det
