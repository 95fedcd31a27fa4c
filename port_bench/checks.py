"""What decides ``correct``: the served images against the plain
reference, a coalesced row against its solo run, and every request
answered.

For each image of the check's sample (drawn from the seed among the
window's answered requests, solo and coalesced rows both where the window
had them) the PNG the server returned is decoded by the benchmark's own
decoder and compared, pixel by pixel in uint8 levels, with the reference's
image of the same prompt and seed:

- ``mean_abs_levels``: the largest, over the sample, of an image's mean
  absolute difference;
- ``p999_abs_levels``: the largest 99.9th percentile of the absolute
  difference (a fault that alters a patch shows here before it moves the
  mean);
- ``batch_row_levels_off_solo``: the largest difference between a
  coalesced row and the same request run solo after the window (batching
  never changes a request's image: an exact comparison);
- ``unanswered``: requests due in the window that got no image.

A number's limit comes from ``limits/<workload>.json``; PERF.md gives the
readings each limit was set from.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent


def limits(workload: str) -> Dict[str, float]:
    with open(HERE / "limits" / f"{workload}.json") as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def image_gaps(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    if got.shape != want.shape:
        return {"mean_abs_levels": float("inf"), "p999_abs_levels": float("inf"),
                "max_abs_levels": float("inf")}
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).astype(np.float64)
    return {"mean_abs_levels": float(d.mean()),
            "p999_abs_levels": float(np.percentile(d, 99.9)),
            "max_abs_levels": float(d.max())}


def clipped_share(img: np.ndarray) -> float:
    """Share of an image's values at 0 or 255."""
    return float(((img == 0) | (img == 255)).mean())


def verdict(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number that has a limit."""
    return {k: {"value": numbers[k], "limit": lim[k]} for k in lim if k in numbers}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
