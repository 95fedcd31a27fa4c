"""What is this checkpoint, and how is it served? (port of
``dreamlab_tpu/utils/model_detector.py``).

A chain of small detectors each augments a ``ModelInfo``; classification keys
off tensor *shapes* (the ``attn2.to_k`` input width is the
cross-attention dim), never off file names:

  cross_attention_dim 768 -> SD15, 1024 -> SD21, 2048 / 1280 -> SDXL.

Safetensors shapes come from the file's header through the port's own reader
(``utils/safetensors.py::read_shapes``), without reading tensor data; torch
``.ckpt/.pt/.pth`` key names come from the pickle stream through
``pickletools.genops``, which never unpickles (no code runs, no tensor data
is read). SD1.5/SD2.1-class and SDXL-class checkpoints are served by the CUDA
worker, with the arch tag the loader and the pipeline read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from .safetensors import read_shapes

WORKER = "dreamlab_tpu_torch.engine.cuda_worker.CudaPipelineWorker"


class DetectionError(Exception):
    pass


@dataclasses.dataclass
class ModelInfo:
    path: str
    format: Optional[str] = None  # diffusers_dir | safetensors | checkpoint | lora | controlnet | unknown
    is_lora: bool = False
    is_controlnet: bool = False
    cross_attention_dim: Optional[int] = None
    variant: Optional[str] = None  # SD15 | SD21 | SDXL
    arch: Optional[str] = None  # sd15 | sdxl (serving class)
    native_size: Optional[int] = None
    downsample: int = 8
    recommended_sizes: List[str] = dataclasses.field(default_factory=list)
    worker: Optional[str] = None
    extra: Dict = dataclasses.field(default_factory=dict)


Detector = Callable[[ModelInfo], Optional[ModelInfo]]


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------


def controlnet_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """ControlNets: a diffusers directory with a root ``config.json`` of class
    ``ControlNetModel`` (and no ``unet/``), or a single file with
    ``controlnet_*`` tensors (``control_model.*`` in the LDM layout)."""
    if os.path.isdir(info.path):
        cfg_path = os.path.join(info.path, "config.json")
        if os.path.exists(cfg_path) and not os.path.exists(
                os.path.join(info.path, "unet", "config.json")):
            with open(cfg_path) as f:
                cfg = json.load(f)
            if cfg.get("_class_name") == "ControlNetModel":
                info.format = "controlnet"
                info.is_controlnet = True
                info.cross_attention_dim = cfg.get("cross_attention_dim")
                info.extra["controlnet_config"] = cfg
                return info
        return None
    if info.format == "safetensors":
        shapes = info.extra.get("safetensors_shapes") or {}
        if any(k.startswith("controlnet_cond_embedding")
               or k.startswith("controlnet_down_blocks")
               or "control_model." in k for k in shapes):
            info.format = "controlnet"
            info.is_controlnet = True
    return info


def diffusers_dir_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """A diffusers-layout directory, through ``unet/config.json``."""
    if not os.path.isdir(info.path):
        return None
    unet_cfg = os.path.join(info.path, "unet", "config.json")
    if not os.path.exists(unet_cfg):
        return None
    with open(unet_cfg) as f:
        cfg = json.load(f)
    info.format = "diffusers_dir"
    info.cross_attention_dim = cfg.get("cross_attention_dim")
    info.extra["unet_config"] = cfg
    idx = os.path.join(info.path, "model_index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            info.extra["pipeline_class"] = json.load(f).get("_class_name")
    return info


def safetensors_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """A single safetensors file: LoRA or checkpoint, and the cross-attention
    width from tensor shapes."""
    if not (os.path.isfile(info.path) and info.path.endswith(".safetensors")):
        return None
    shapes = read_shapes(info.path)
    info.format = "safetensors"
    info.extra["safetensors_shapes"] = shapes

    if any(".lora_down." in k or ".lora_A." in k or k.startswith("lora_") for k in shapes):
        info.is_lora = True
        info.format = "lora"
        # LoRA compat: the to_k adapters' input width is the cross-attn dim
        for k, s in shapes.items():
            if "attn2" in k and "to_k" in k and ("lora_down" in k or "lora_A" in k):
                info.cross_attention_dim = s[1]
                break
        return info

    # the original "ldm" layout or a diffusers-layout single file
    for k, s in shapes.items():
        if k.endswith("attn2.to_k.weight") and len(s) == 2:
            info.cross_attention_dim = s[1]
            break
    return info


def _pickle_strings(data) -> List[str]:
    """String opcode arguments of a pickle stream, collected WITHOUT executing
    it: enough to read a torch state dict's key names (BINUNICODE ops) with no
    deserialization. ``data`` is bytes or an open binary file (a multi-GB
    legacy .ckpt streams instead of being read into memory)."""
    import pickletools

    out: List[str] = []
    try:
        for op, arg, _pos in pickletools.genops(data):
            if op.name in ("BINUNICODE", "SHORT_BINUNICODE", "BINUNICODE8", "UNICODE",
                           "STRING", "SHORT_BINSTRING", "BINSTRING") and isinstance(arg, str):
                out.append(arg)
    except Exception:
        pass  # a truncated or corrupt stream: what was seen so far
    return out


def checkpoint_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """Torch ``.ckpt/.pt/.pth`` files: key names from the pickle stream
    (``_pickle_strings``), never ``torch.load``."""
    ext = os.path.splitext(info.path)[1].lower()
    if not (os.path.isfile(info.path) and ext in (".ckpt", ".pt", ".pth")):
        return None
    import zipfile

    info.format = "checkpoint"
    keys: List[str] = []
    try:
        if zipfile.is_zipfile(info.path):
            with zipfile.ZipFile(info.path) as zf:
                pkls = [n for n in zf.namelist() if n.endswith("data.pkl")]
                if pkls:
                    keys = _pickle_strings(zf.read(pkls[0]))
        else:  # a legacy raw-pickle .ckpt: stream it, the tensors ride inline
            with open(info.path, "rb") as f:
                keys = _pickle_strings(f)
    except Exception as e:
        info.extra["checkpoint_error"] = str(e)
        return info

    if any("lora" in k.lower() for k in keys):
        info.is_lora = True
        info.format = "lora"
        has_te2 = any("text_encoder_2" in k or "lora_te2" in k for k in keys)
        info.cross_attention_dim = 2048 if has_te2 else 768
        return info

    has_te2 = any("text_encoder_2" in k or "conditioner.embedders.1" in k for k in keys)
    info.extra["has_dual_text_encoders"] = has_te2
    if has_te2:
        info.cross_attention_dim = 2048
    elif keys:
        # shapes are not in the pickle stream: a single-tower UNet is taken
        # as SD1.x-class
        info.cross_attention_dim = 768
    return info


def variant_classifier(info: ModelInfo) -> Optional[ModelInfo]:
    cad = info.cross_attention_dim
    if cad is None:
        return info
    info.variant = {768: "SD15", 1024: "SD21", 2048: "SDXL", 1280: "SDXL"}.get(cad)
    return info


def _recommended_sizes(native_px: int) -> List[str]:
    """The SDXL bucket ladder from 1024 up, the conservative SD set below."""
    if native_px >= 1024:
        return ["1024x1024", "1152x896", "1216x832", "1344x768", "1536x640",
                "896x1152", "832x1216", "768x1344", "640x1536"]
    return ["512x512", "640x512", "768x512", "512x640", "512x768"]


def resolution_detector(info: ModelInfo) -> Optional[ModelInfo]:
    """Size policy: diffusers ``unet.config.sample_size`` where there is one,
    the variant's native size otherwise; a LoRA gets a policy note instead of
    a native size."""
    down = 8
    if info.is_lora:
        info.extra["size_policy"] = {
            "note": "LoRA has no native resolution; policy determined by base model.",
            "divisible_by_px": down,
            "downsample_factor": down,
            "source": "lora",
        }
        return info
    native = None
    source = "heuristic:variant"
    cfg = info.extra.get("unet_config")
    sample_size = cfg.get("sample_size") if isinstance(cfg, dict) else None
    if isinstance(sample_size, int) and sample_size > 0:
        native = sample_size * down
        source = "diffusers:unet.config"
    if native is None:
        native = {"SD15": 512, "SD21": 768, "SDXL": 1024}.get(info.variant or "")
    if native is None:
        return info
    info.native_size = native
    info.downsample = down
    info.recommended_sizes = _recommended_sizes(native)
    info.extra["size_policy"] = {
        "downsample_factor": down,
        "divisible_by_px": down,
        "latent_sample_size": native // down,
        "native_resolution_px": native,
        "recommended_sizes": info.recommended_sizes,
        "source": source,
    }
    return info


def compatibility_resolver(info: ModelInfo) -> Optional[ModelInfo]:
    """Variant -> serving class: every supported variant serves through the
    CUDA worker, with its arch tag."""
    if info.is_lora or info.is_controlnet:
        return info
    if info.variant in ("SD15", "SD21"):
        info.arch = "sd15"
        info.worker = WORKER
    elif info.variant == "SDXL":
        info.arch = "sdxl"
        info.worker = WORKER
    return info


DEFAULT_STACK: List[Detector] = [
    diffusers_dir_detector,
    safetensors_detector,
    checkpoint_detector,
    controlnet_detector,
    variant_classifier,
    resolution_detector,
    compatibility_resolver,
]


class ModelDetector:
    """Run an (extensible) detector stack over a path."""

    def __init__(self, stack: Optional[List[Detector]] = None):
        self.stack = list(stack or DEFAULT_STACK)

    def add_detector(self, det: Detector, *, index: Optional[int] = None):
        if index is None:
            self.stack.append(det)
        else:
            self.stack.insert(index, det)

    def detect(self, path: str) -> ModelInfo:
        if not os.path.exists(path):
            raise DetectionError(f"path does not exist: {path}")
        info = ModelInfo(path=path)
        for det in self.stack:
            out = det(info)
            if out is not None:
                info = out
        if info.format is None:
            info.format = "unknown"
        # scratch the detectors pass along, not a result
        info.extra.pop("safetensors_shapes", None)
        return info


def detect_model(path: str) -> ModelInfo:
    return ModelDetector().detect(path)


def scan_directory(root: str) -> list:
    """Classify every diffusers directory and safetensors file under ``root``."""
    results = []
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        try:
            if os.path.isdir(path) and os.path.exists(os.path.join(path, "unet", "config.json")):
                results.append(detect_model(path))
            elif path.endswith(".safetensors"):
                results.append(detect_model(path))
        except DetectionError:
            continue
    return results

