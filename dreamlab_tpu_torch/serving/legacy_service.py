"""Legacy serving path: N worker threads, one pipeline each, single queue
(port of ``dreamlab_tpu/serving/legacy_service.py``).

Env-configured, no mode system: a shared bounded queue and worker threads,
each owning a whole pipeline. The app builds ``min(NUM_WORKERS, cards)``
workers, worker *i* on ``cuda:i``; each keeps one request in flight (its
copy to the host and PNG behind the next one's replay).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional

from ..engine.base import GenSpec

logger = logging.getLogger(__name__)


class PipelineService:
    """N identical workers consuming one FIFO queue."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(
        self,
        worker_factory: Callable[[int], object],
        num_workers: int = 1,
        queue_max: int = 64,
    ):
        """worker_factory(worker_id) -> PipelineWorker (device placement is
        the factory's concern)."""
        self.queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=queue_max)
        self._shutdown = threading.Event()
        self.workers: List[object] = []
        self._threads: List[threading.Thread] = []
        for i in range(max(1, num_workers)):
            worker = worker_factory(i)
            self.workers.append(worker)
            t = threading.Thread(
                target=self._worker_loop, args=(worker,),
                name=f"pipeline-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        logger.info("PipelineService: %d workers ready", len(self.workers))

    @classmethod
    def get_instance(cls, *args, **kwargs) -> "PipelineService":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls(*args, **kwargs)
            return cls._instance

    @classmethod
    def reset_instance(cls):
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance.shutdown()
                cls._instance = None

    # ------------------------------------------------------------------
    def _worker_loop(self, worker):
        # one dispatched-but-unfinalized job may be in flight per worker:
        # its image d2h + PNG encode overlap the next job's device compute
        # (same pattern as WorkerPool's cross-batch pipelining)
        runner = getattr(worker, "run_job_pipelined", None)
        inflight = None  # (fut, finalize)

        def settle():
            nonlocal inflight
            if inflight is None:
                return
            fut, finalize = inflight
            inflight = None
            try:
                fut.set_result(finalize())
            except Exception as e:
                logger.exception("legacy job failed")
                fut.set_exception(e)

        try:
            while not self._shutdown.is_set():
                try:
                    item = self.queue.get(
                        timeout=0.01 if inflight else 0.25
                    )
                except queue.Empty:
                    settle()
                    continue
                if item is None:
                    self.queue.task_done()
                    break
                spec, with_latents, fut = item
                if not fut.set_running_or_notify_cancel():
                    self.queue.task_done()  # client gone: skip
                    settle()
                    continue
                try:
                    if with_latents:
                        settle()  # fingerprints need the settled path
                        fut.set_result(worker.run_job_with_latents(spec))
                    elif runner is not None:
                        finalize = runner(spec)
                        settle()
                        inflight = (fut, finalize)
                        if self.queue.empty():  # lone request: no idle-tick wait
                            settle()
                    else:
                        settle()
                        fut.set_result(worker.run_job(spec))
                except Exception as e:
                    logger.exception("legacy job failed")
                    fut.set_exception(e)
                finally:
                    self.queue.task_done()
        finally:
            settle()

    def submit(self, spec: GenSpec, *, with_latents: bool = False) -> Future:
        if self._shutdown.is_set():
            raise RuntimeError("service is shut down")
        fut: Future = Future()
        self.queue.put_nowait((spec, with_latents, fut))  # Full → 429 upstream
        return fut

    def shutdown(self):
        self._shutdown.set()
        # fail queued futures explicitly
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item:
                item[2].set_exception(RuntimeError("service shutting down"))
            self.queue.task_done()
        for _ in self._threads:
            try:
                self.queue.put_nowait(None)
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout=2.0)
