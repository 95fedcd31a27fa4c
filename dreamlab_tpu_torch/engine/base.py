"""Worker protocol and job spec (copy of ``dreamlab_tpu/engine/base.py``).

A worker owns one loaded pipeline and turns a generation spec into PNG
bytes; ``run_job_with_latents`` also returns a [1, 4, 8, 8] float16 latent
fingerprint (512 bytes) used by the UI's latent-exploration features.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Protocol, Tuple

_SIZE_RE = re.compile(r"^(\d+)\s*[xX]\s*(\d+)$")


def parse_size(size: str) -> Tuple[int, int]:
    """'WxH' -> (width, height)."""
    m = _SIZE_RE.match(size.strip())
    if not m:
        raise ValueError(f"invalid size {size!r}; expected 'WxH'")
    return int(m.group(1)), int(m.group(2))


@dataclasses.dataclass
class GenSpec:
    """One generation request (servers map their request schemas onto this)."""

    prompt: str
    size: str = "512x512"
    num_inference_steps: int = 4
    guidance_scale: float = 1.0
    seed: Optional[int] = None
    negative_prompt: Optional[str] = None
    style: Optional[str] = None
    style_level: int = 0
    original_inference_steps: Optional[int] = None
    aesthetic_score: float = 6.0  # refiner micro-conditioning (n_ids == 5)
    # per-step progress hook: called (step, timestep); excluded from equality
    progress_cb: Optional[Callable[[int, int], None]] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    # ControlNet conditioning: hint image [H, W, 3] uint8 at the output size
    control_image: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    controlnet_scale: Optional[float] = None
    # multi-tenant target mode: None = the pool's active mode
    mode: Optional[str] = None

    def dims(self) -> Tuple[int, int]:
        return parse_size(self.size)


class PipelineWorker(Protocol):
    """Worker protocol."""

    worker_id: int

    def run_job(self, spec: GenSpec) -> Tuple[bytes, int]:
        """Generate; returns (png_bytes, seed_used)."""
        ...

    def run_job_with_latents(self, spec: GenSpec) -> Tuple[bytes, int, bytes]:
        """Generate; returns (png_bytes, seed_used, latents_f16_bytes) where
        latents are [1, 4, 8, 8] float16 (512 bytes)."""
        ...
