"""Background maintenance: delegated-job reaper thread (port of
``dreamlab_tpu/serving/startup_hooks.py``) — marks comfy jobs
``error`` after 60 s without heartbeat or a 15 min hard cap.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..invokers.jobs import reap_stale_jobs

logger = logging.getLogger(__name__)

_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def start_jobs_reaper(interval: float = 10.0) -> threading.Thread:
    global _thread
    if _thread and _thread.is_alive():
        return _thread
    _stop.clear()

    def loop():
        while not _stop.wait(interval):
            try:
                n = reap_stale_jobs()
                if n:
                    logger.info("reaper: marked %d stale jobs", n)
            except Exception:
                logger.exception("reaper error")

    _thread = threading.Thread(target=loop, name="jobs-reaper", daemon=True)
    _thread.start()
    return _thread


def stop_jobs_reaper():
    _stop.set()
