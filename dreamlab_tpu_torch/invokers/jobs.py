"""In-memory job store for delegated (ComfyUI) jobs.

Copy of ``dreamlab_tpu/invokers/jobs.py``: RLock-guarded
dict with deep-copy snapshots, dotted-path updates, dedup appends, and the
reaper predicate (no heartbeat for 60 s, or 15 min hard cap ⇒ error).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

STALE_AFTER_S = 60.0
HARD_TIMEOUT_S = 900.0

_JOBS: Dict[str, Dict[str, Any]] = {}
_LOCK = threading.RLock()


def jobs_put(job_id: str, job: Dict[str, Any]):
    with _LOCK:
        job.setdefault("created_at", time.time())
        job.setdefault("heartbeat_at", time.time())
        _JOBS[job_id] = copy.deepcopy(job)


def jobs_get(job_id: str) -> Optional[Dict[str, Any]]:
    with _LOCK:
        job = _JOBS.get(job_id)
        return copy.deepcopy(job) if job is not None else None


def jobs_update(job_id: str, **fields):
    with _LOCK:
        job = _JOBS.get(job_id)
        if job is None:
            return
        job.update(copy.deepcopy(fields))
        job["heartbeat_at"] = time.time()


def jobs_update_path(job_id: str, path: str, value: Any):
    """Set a dotted path (e.g. 'progress.node') inside a job."""
    with _LOCK:
        job = _JOBS.get(job_id)
        if job is None:
            return
        node = job
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = copy.deepcopy(value)
        job["heartbeat_at"] = time.time()


def jobs_append_unique(job_id: str, path: str, value: Any):
    with _LOCK:
        job = _JOBS.get(job_id)
        if job is None:
            return
        node = job
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        lst = node.setdefault(parts[-1], [])
        if value not in lst:
            lst.append(copy.deepcopy(value))
        job["heartbeat_at"] = time.time()


def jobs_items_snapshot() -> List[Tuple[str, Dict[str, Any]]]:
    with _LOCK:
        return [(k, copy.deepcopy(v)) for k, v in _JOBS.items()]


def jobs_mark_error_if_running(job_id: str, error: str) -> bool:
    with _LOCK:
        job = _JOBS.get(job_id)
        if job is None or job.get("status") not in ("running", "pending"):
            return False
        job["status"] = "error"
        job["error"] = error
        return True


def jobs_clear():
    with _LOCK:
        _JOBS.clear()


def reap_stale_jobs(now: Optional[float] = None) -> int:
    """Mark jobs stale/timed-out (no heartbeat for 60 s, or 15 min in all)."""
    now = now or time.time()
    reaped = 0
    for job_id, job in jobs_items_snapshot():
        if job.get("status") not in ("running", "pending"):
            continue
        hb = job.get("heartbeat_at", job.get("created_at", now))
        created = job.get("created_at", now)
        if now - created > HARD_TIMEOUT_S:
            if jobs_mark_error_if_running(job_id, "hard timeout (15 min)"):
                reaped += 1
        elif now - hb > STALE_AFTER_S:
            if jobs_mark_error_if_running(job_id, "stale (no heartbeat 60 s)"):
                reaped += 1
    return reaped
