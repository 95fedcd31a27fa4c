"""Style registry: named, exclusive LoRA styles with strength ladders (port
of ``dreamlab_tpu/engine/styles.py``).

Styles load from a YAML file (``STYLES_CONFIG``, default ``styles.yaml``),
read by the port's own reader (``utils/yaml_lite.py``):

```yaml
lora_root: /models/loras
styles:
  anime:
    file: anime-v2.safetensors
    strengths: [0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8]
    required_cross_attention_dim: 768
  crisp:
    file: add-detail-xl.safetensors
    required_cross_attention_dim: 2048
```
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from ..lora import StyleDef
from ..utils import yaml_lite

logger = logging.getLogger(__name__)


def load_style_registry(path: Optional[str] = None) -> Dict[str, StyleDef]:
    path = path or os.environ.get("STYLES_CONFIG", "styles.yaml")
    if not os.path.exists(path):
        return {}
    raw = yaml_lite.load(path) or {}
    root = raw.get("lora_root") or ""
    registry: Dict[str, StyleDef] = {}
    for name, spec in (raw.get("styles") or {}).items():
        if isinstance(spec, str):
            spec = {"file": spec}
        file = spec["file"]
        if not os.path.isabs(file):
            file = os.path.join(root, file)
        kwargs = {}
        if "strengths" in spec:
            kwargs["strengths"] = tuple(float(s) for s in spec["strengths"])
        registry[name] = StyleDef(name=name, path=file,
                                  required_cross_attention_dim=spec.get(
                                      "required_cross_attention_dim"), **kwargs)
        if not os.path.exists(file):
            logger.warning("style %s: lora file missing: %s", name, file)
    logger.info("style registry: %d styles", len(registry))
    return registry


_registry: Optional[Dict[str, StyleDef]] = None
_lock = threading.Lock()


def get_style_registry() -> Dict[str, StyleDef]:
    global _registry
    with _lock:
        if _registry is None:
            _registry = load_style_registry()
        return _registry


def reset_style_registry():
    global _registry
    with _lock:
        _registry = None
