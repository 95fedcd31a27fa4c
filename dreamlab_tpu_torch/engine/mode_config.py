"""modes.yaml configuration: named model + LoRA "modes" with defaults (port
of ``dreamlab_tpu/engine/mode_config.py``).

The same schema, resolution and errors as the JAX package's:

```yaml
model_root: /models
lora_root: /models/loras
default_mode: dreamshaper
modes:
  dreamshaper:
    model: LCM-Dreamshaper-V7      # dir or file under model_root
    description: "fast LCM mode"
    loras:
      - file: detail.safetensors   # under lora_root
        strength: 0.8
    embeddings:
      - file: vivid.safetensors    # textual inversion; trigger = file stem
      - { file: style2.safetensors, name: mystyle }
    defaults:
      size: "512x512"
      steps: 4
      guidance: 1.0
      warmup_buckets: ["512x768"]
```

The file is read by the port's own YAML subset reader
(``utils/yaml_lite.py``), not PyYAML; a layout outside that subset raises.
Missing paths warn instead of raising; ``reload()`` re-reads the file in
place.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional

from ..textual_inversion import trigger_word as _trigger_word
from ..utils import yaml_lite

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoRAConfig:
    file: str
    strength: float = 1.0
    name: Optional[str] = None

    @property
    def display_name(self) -> str:
        return self.name or os.path.splitext(os.path.basename(self.file))[0]


@dataclasses.dataclass
class EmbeddingConfig:
    """Textual-inversion embedding (trigger word → learned vectors)."""

    file: str
    name: Optional[str] = None  # trigger override; default = file stem


@dataclasses.dataclass
class ControlNetConfig:
    """Per-mode ControlNet: a diffusers-layout directory (config.json +
    safetensors) attached to the mode's pipeline at load. ``scale`` is the
    default conditioning strength; requests override it per call."""

    file: str
    scale: float = 1.0


@dataclasses.dataclass
class RefinerConfig:
    """Per-mode SDXL refiner checkpoint for base→refiner ensemble serving
    (diffusers denoising_end/denoising_start): the base model runs the
    first ``switch_at`` fraction of the step ladder, the refiner finishes
    and decodes — latents hand off on device."""

    file: str
    switch_at: float = 0.8


@dataclasses.dataclass
class ModeConfig:
    name: str
    model: str  # absolute path after resolution
    description: str = ""
    loras: List[LoRAConfig] = dataclasses.field(default_factory=list)
    embeddings: List[EmbeddingConfig] = dataclasses.field(default_factory=list)
    controlnet: Optional[ControlNetConfig] = None
    refiner: Optional[RefinerConfig] = None
    defaults: Dict = dataclasses.field(default_factory=dict)

    def default_size(self) -> Optional[str]:
        return self.defaults.get("size")

    def default_steps(self) -> Optional[int]:
        return self.defaults.get("steps")

    def default_guidance(self) -> Optional[float]:
        return self.defaults.get("guidance")

    def warmup_buckets(self) -> List[tuple]:
        """Extra (width, height, steps) buckets to pre-warm at mode
        load — ``defaults.warmup_buckets: ["768x768:4", "512x512"]`` in
        modes.yaml (steps defaults to the mode's default steps, then 4).
        On the card each is a captured CUDA graph, so a latency-sensitive
        deployment moves all its serving shapes off the request path, not
        just the default bucket."""
        out = []
        for item in self.defaults.get("warmup_buckets") or []:
            size, _, steps = str(item).partition(":")
            w, _, h = size.lower().partition("x")
            try:
                out.append((
                    int(w), int(h),
                    int(steps or self.default_steps() or 4),
                ))
            except ValueError:
                logger.warning(
                    "mode %s: bad warmup_buckets entry %r (want 'WxH[:steps]')",
                    self.name, item,
                )
        return out


class ModeConfigError(Exception):
    pass


class ModeConfigManager:
    def __init__(self, config_path: str):
        self.config_path = config_path
        self._lock = threading.Lock()
        self.model_root = ""
        self.lora_root = ""
        self.default_mode: Optional[str] = None
        self.modes: Dict[str, ModeConfig] = {}
        self._load()

    # ------------------------------------------------------------------
    def _load(self):
        if not os.path.exists(self.config_path):
            raise ModeConfigError(f"modes config not found: {self.config_path}")
        raw = yaml_lite.load(self.config_path) or {}
        if not isinstance(raw.get("modes"), dict) or not raw["modes"]:
            raise ModeConfigError("modes config must define at least one mode")

        model_root = raw.get("model_root", "")
        lora_root = raw.get("lora_root", model_root)
        modes: Dict[str, ModeConfig] = {}
        for name, spec in raw["modes"].items():
            if not isinstance(spec, dict) or "model" not in spec:
                raise ModeConfigError(f"mode {name!r} missing 'model'")
            model_path = spec["model"]
            if not os.path.isabs(model_path):
                model_path = os.path.join(model_root, model_path)
            loras = []
            for entry in spec.get("loras") or []:
                if isinstance(entry, str):
                    entry = {"file": entry}
                file = entry["file"]
                if not os.path.isabs(file):
                    file = os.path.join(lora_root, file)
                loras.append(
                    LoRAConfig(
                        file=file,
                        strength=float(entry.get("strength", 1.0)),
                        name=entry.get("name"),
                    )
                )
            embeddings = []
            for entry in spec.get("embeddings") or []:
                if isinstance(entry, str):
                    entry = {"file": entry}
                file = entry["file"]
                if not os.path.isabs(file):
                    file = os.path.join(lora_root, file)
                embeddings.append(
                    EmbeddingConfig(file=file, name=entry.get("name"))
                )
            controlnet = None
            cn = spec.get("controlnet")
            if cn:
                if isinstance(cn, str):
                    cn = {"file": cn}
                cn_file = cn.get("file") or cn.get("path")
                if not cn_file:
                    raise ModeConfigError(
                        f"mode {name!r}: controlnet needs 'file' (or 'path')"
                    )
                if not os.path.isabs(cn_file):
                    cn_file = os.path.join(model_root, cn_file)
                controlnet = ControlNetConfig(
                    file=cn_file, scale=float(cn.get("scale", 1.0))
                )
            refiner = None
            rf = spec.get("refiner")
            if rf:
                if isinstance(rf, str):
                    rf = {"model": rf}
                rf_file = rf.get("model") or rf.get("file") or rf.get("path")
                if not rf_file:
                    raise ModeConfigError(
                        f"mode {name!r}: refiner needs 'model' (or 'file')"
                    )
                if not os.path.isabs(rf_file):
                    rf_file = os.path.join(model_root, rf_file)
                switch_at = float(rf.get("switch_at", 0.8))
                if not 0.0 < switch_at < 1.0:
                    raise ModeConfigError(
                        f"mode {name!r}: refiner switch_at must be in (0, 1)"
                    )
                refiner = RefinerConfig(file=rf_file, switch_at=switch_at)
            modes[name] = ModeConfig(
                name=name,
                model=model_path,
                description=spec.get("description", ""),
                loras=loras,
                embeddings=embeddings,
                controlnet=controlnet,
                refiner=refiner,
                defaults=dict(spec.get("defaults") or {}),
            )

        default_mode = raw.get("default_mode") or next(iter(modes))
        if default_mode not in modes:
            raise ModeConfigError(f"default_mode {default_mode!r} not in modes")

        self._validate_paths(modes)
        with self._lock:
            self.model_root = model_root
            self.lora_root = lora_root
            self.default_mode = default_mode
            self.modes = modes
        logger.info(
            "mode config loaded: %d modes, default=%s", len(modes), default_mode
        )

    @staticmethod
    def _validate_paths(modes: Dict[str, ModeConfig]):
        """Warn (not raise) on missing paths, as the JAX package does."""
        for mode in modes.values():
            if not os.path.exists(mode.model):
                logger.warning(
                    "mode %s: model path missing: %s", mode.name, mode.model
                )
            for lora in mode.loras:
                if not os.path.exists(lora.file):
                    logger.warning(
                        "mode %s: lora missing: %s", mode.name, lora.file
                    )
            if mode.controlnet and not os.path.exists(mode.controlnet.file):
                logger.warning(
                    "mode %s: controlnet missing: %s",
                    mode.name, mode.controlnet.file,
                )
            if mode.refiner and not os.path.exists(mode.refiner.file):
                logger.warning(
                    "mode %s: refiner missing: %s",
                    mode.name, mode.refiner.file,
                )

    # ------------------------------------------------------------------
    def reload(self):
        self._load()

    def get_mode(self, name: str) -> ModeConfig:
        with self._lock:
            if name not in self.modes:
                raise KeyError(f"unknown mode {name!r}")
            return self.modes[name]

    def has_mode(self, name: str) -> bool:
        with self._lock:
            return name in self.modes

    def mode_names(self) -> List[str]:
        with self._lock:
            return list(self.modes)

    def to_dict(self) -> Dict:
        with self._lock:
            return {
                "default_mode": self.default_mode,
                "model_root": self.model_root,
                "lora_root": self.lora_root,
                "modes": {
                    name: {
                        "model": m.model,
                        "description": m.description,
                        "loras": [
                            {
                                "file": l.file,
                                "name": l.display_name,
                                "strength": l.strength,
                            }
                            for l in m.loras
                        ],
                        "embeddings": [
                            {
                                "file": e.file,
                                "trigger": _trigger_word(e.file, e.name),
                            }
                            for e in m.embeddings
                        ],
                        "controlnet": (
                            {"file": m.controlnet.file,
                             "scale": m.controlnet.scale}
                            if m.controlnet else None
                        ),
                        "refiner": (
                            {"model": m.refiner.file,
                             "switch_at": m.refiner.switch_at}
                            if m.refiner else None
                        ),
                        "defaults": m.defaults,
                    }
                    for name, m in self.modes.items()
                },
            }


_manager: Optional[ModeConfigManager] = None
_manager_lock = threading.Lock()


def get_mode_config(config_path: Optional[str] = None) -> ModeConfigManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            path = config_path or os.environ.get("MODES_CONFIG", "modes.yaml")
            _manager = ModeConfigManager(path)
        return _manager


def reload_mode_config():
    with _manager_lock:
        if _manager is not None:
            _manager.reload()


def reset_mode_config():
    global _manager
    with _manager_lock:
        _manager = None
