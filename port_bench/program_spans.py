"""The program's own spans, as the readers of the metrics that read them take
them.

The port records spans and counters at the layer boundaries of its serving
path (``dreamlab_tpu_torch/utils/tracing.py``) on the monotonic clock,
which is the one the run's window and the traced slice's device intervals
are on (``trace.py``). The server runs in the run's own process, so the
recorder there holds the window's spans. A program without the recorder
gives none, and the readers return None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def recorded() -> List[dict]:
    """Every span the program's recorder holds (none without a recorder):
    dicts with ``name``, ``t0``, ``t1`` (monotonic seconds), ``id``,
    ``parent`` and ``attrs``."""
    try:
        from dreamlab_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def window(run, name: str, spans: Optional[List[dict]] = None) -> List[dict]:
    """The spans of ``name`` that start within the run's window."""
    spans = recorded() if spans is None else spans
    return [s for s in spans if s["name"] == name and run.t_open <= s["t0"] <= run.t_close]


def median_ms(run, name: str) -> Optional[float]:
    """Median milliseconds of the window's spans of ``name``."""
    out = [1e3 * (s["t1"] - s["t0"]) for s in window(run, name)]
    return float(np.median(out)) if out else None


def self_ms(run, name: str, child: str, path: Optional[str] = None) -> Optional[float]:
    """Median milliseconds of the window's ``name`` spans (those whose
    ``path`` attribute is ``path``, answered 200, where given) less their
    ``child`` span; spans without such a child are left out."""
    spans = recorded()
    inner = {s["parent"]: s for s in spans if s["name"] == child}
    out = [1e3 * ((s["t1"] - s["t0"]) - (c["t1"] - c["t0"]))
           for s in window(run, name, spans)
           if path is None or (s["attrs"].get("path") == path and s["attrs"].get("status") == 200)
           for c in [inner.get(s["id"])] if c is not None]
    return float(np.median(out)) if out else None


def share_with(run, name: str, attr: str) -> Optional[float]:
    """Share (%) of the window's ``name`` spans whose ``attr`` is true."""
    spans = window(run, name)
    if not spans:
        return None
    return 100.0 * sum(bool(s["attrs"].get(attr)) for s in spans) / len(spans)


def _union(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(gaps, intervals) -> float:
    """Seconds of the gaps (sorted, disjoint) that lie inside the intervals
    (sorted, disjoint)."""
    total, j = 0.0, 0
    for s, t in gaps:
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < t:
            total += min(t, intervals[k][1]) - max(s, intervals[k][0])
            k += 1
    return total


def _gaps(profile) -> List[tuple]:
    return sorted((s, t) for _, s, t in profile["gaps"])


def in_slice(run) -> List[dict]:
    """The recorded spans that overlap the traced slice (none without one)."""
    prof = run.profile
    if prof is None:
        return []
    return [s for s in recorded() if s["t1"] > prof["start"] and s["t0"] < prof["stop"]]


def idle_share_inside(run, name: str) -> Optional[float]:
    """Share (%) of the traced slice's device-idle time that lies inside
    spans of ``name``; None without a slice, idle time or such spans."""
    prof = run.profile
    if prof is None:
        return None
    gaps = _gaps(prof)
    idle = sum(t - s for s, t in gaps)
    spans = [(s["t0"], s["t1"]) for s in in_slice(run) if s["name"] == name]
    if idle <= 0 or not spans:
        return None
    return 100.0 * _overlap(gaps, _union(spans)) / idle


# what names an idle gap of the device, first match first: the pool thread's
# innermost phases, then what holds them, then the queue and the server
HOLDERS = ("png.encode", "device.wait", "graph.replay", "pipeline.stage", "worker.noise",
           "style.apply", "graph.capture", "pool.settle", "pool.dispatch", "pool.collect",
           "pool.queued", "http.await", "http.request")


def held(gaps, spans: List[dict]) -> Dict[str, float]:
    """Seconds of the gaps (sorted, disjoint (start, end) pairs) by the
    program span that held them: each instant goes to the first of
    ``HOLDERS`` with a span open then, and to ``"none"`` where none is."""
    left = list(gaps)
    out: Dict[str, float] = {}
    for name in HOLDERS:
        mine = _union((s["t0"], s["t1"]) for s in spans if s["name"] == name)
        out[name] = _overlap(left, mine)
        left = _subtract(left, mine)
    out["none"] = sum(t - s for s, t in left)
    return out


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """Seconds of the traced slice's device-idle time by the program span
    that held it (``held``). None without a slice or spans."""
    spans = in_slice(run)
    if not spans:
        return None
    return held(_gaps(run.profile), spans)


def _subtract(gaps, intervals) -> List[tuple]:
    """The parts of the gaps outside the intervals (both sorted, disjoint)."""
    out = []
    for s, t in gaps:
        for a, b in intervals:
            if b <= s or a >= t:
                continue
            if a > s:
                out.append((s, a))
            s = max(s, b)
            if s >= t:
                break
        if s < t:
            out.append((s, t))
    return out
