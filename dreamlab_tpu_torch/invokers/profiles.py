"""Named ComfyUI workflow profiles: reusable node-input patch sets.

Copy of ``dreamlab_tpu/invokers/profiles.py`` — a profile
bundles default parameters for a workflow so clients submit
``{"workflowId": ..., "profile": "subtle-refine"}`` instead of raw node
patches. Request params override profile values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class WorkflowProfile:
    name: str
    workflow_id: str
    params: Dict[str, Any]
    description: str = ""


PROFILES: Dict[str, WorkflowProfile] = {
    p.name: p
    for p in (
        WorkflowProfile(
            name="subtle-refine",
            workflow_id="img2img-refine",
            params={"steps": 8, "cfg": 1.5, "denoise": 0.35},
            description="light img2img pass preserving composition",
        ),
        WorkflowProfile(
            name="strong-restyle",
            workflow_id="img2img-refine",
            params={"steps": 12, "cfg": 2.0, "denoise": 0.65},
            description="heavier restyle of the uploaded image",
        ),
        WorkflowProfile(
            name="upscale-detail",
            workflow_id="upscale-detail",
            params={"steps": 10, "cfg": 1.2, "denoise": 0.25},
            description="tiled upscale with detail injection",
        ),
    )
}


def resolve_profile(
    profile_name: Optional[str], params: Dict[str, Any]
) -> Dict[str, Any]:
    """Merge profile defaults under explicit params (explicit wins)."""
    if not profile_name:
        return params
    profile = PROFILES.get(profile_name)
    if profile is None:
        raise KeyError(f"unknown profile {profile_name!r}")
    return {**profile.params, **params}
