"""Mode-system worker pool: a bounded FIFO job queue and a hot-swappable
worker (port of ``dreamlab_tpu/engine/worker_pool.py``).

The same job taxonomy (generation, mode switch, custom), the same
guarantees (in-flight jobs finish before a switch applies; futures settle
in FIFO order; a full queue raises ``QueueFullError``), the same settings
(``DREAMLAB_MAX_BATCH``, ``DREAMLAB_BATCH_WINDOW_MS``,
``DREAMLAB_MODE_CACHE``, ``WARMUP``, ``MODES_CONFIG``) and the same
collaborators injectable for tests. The default factory is the port's
``create_cuda_worker``, so a pool serves on the card unless its factory
builds workers elsewhere.

Where the card asks for more than the JAX package does:

- a mode's warm-up captures CUDA graphs (``LCMPipeline.warmup``), so a
  failed warm-up of the mode's default bucket fails the switch (the JAX
  package logs it and serves on);
- a build waits for an in-flight background bucket capture (a second or
  so) instead of skipping its memory delta, so a mode's registered bytes
  are always the device's used bytes after its build and default-bucket
  capture less those before (its weights and its graph pool);
- disposing of a worker waits for such a capture too, then drops its
  graphs, collects and empties the CUDA cache with the device lock held
  exclusively, so the next load's ``can_fit`` reads the freed bytes.

The JAX pool's refusal of per-request mode routing under a multi-host
router has no counterpart: the port has no router.
"""

from __future__ import annotations

import abc
import enum
import logging
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


class JobType(enum.Enum):
    GENERATION = "generation"
    MODE_SWITCH = "mode_switch"
    CUSTOM = "custom"


class Job(abc.ABC):
    """A unit of work; completion is reported through ``future``."""

    job_type: JobType

    def __init__(self):
        self.job_id = uuid.uuid4().hex[:12]
        self.future: Future = Future()
        self.submitted_at = time.time()

    @abc.abstractmethod
    def execute(self, worker) -> Any:
        ...


class GenerationJob(Job):
    job_type = JobType.GENERATION

    def __init__(self, spec, *, with_latents: bool = False):
        super().__init__()
        self.spec = spec
        self.with_latents = with_latents

    def execute(self, worker):
        if self.with_latents:
            return worker.run_job_with_latents(self.spec)
        return worker.run_job(self.spec)


class ModeSwitchJob(Job):
    job_type = JobType.MODE_SWITCH

    def __init__(self, target_mode: str, on_complete: Optional[Callable] = None):
        super().__init__()
        self.target_mode = target_mode
        self.on_complete = on_complete

    def execute(self, worker):
        if self.on_complete:
            self.on_complete(self.target_mode)
        return self.target_mode


class CustomJob(Job):
    job_type = JobType.CUSTOM

    def __init__(self, fn: Callable, *args, **kwargs):
        super().__init__()
        self.fn = fn
        self.args = args
        self.kwargs = kwargs

    def execute(self, worker):
        return self.fn(worker, *self.args, **self.kwargs)


class QueueFullError(Exception):
    """Maps to HTTP 429 at the serving layer."""


class WorkerPool:
    """Single hot-swappable worker consuming a bounded FIFO queue."""

    def __init__(
        self,
        queue_max: int = 64,
        *,
        worker_factory: Optional[Callable[[int, str], Any]] = None,
        mode_config=None,
        registry=None,
        load_default: bool = True,
        max_batch: Optional[int] = None,
    ):
        """worker_factory(worker_id, model_path) -> PipelineWorker.

        All three collaborators are injectable for tests.

        max_batch: coalesce up to N adjacent compatible generation jobs into
        one batched device call (worker must expose run_jobs/batchable).
        Strictly FIFO: scanning stops at the first non-batchable job.
        """
        import os

        from .mode_config import get_mode_config
        from .model_registry import get_model_registry

        self.max_batch = max_batch if max_batch is not None else int(
            os.environ.get("DREAMLAB_MAX_BATCH", "8")
        )
        # coalescing window used only while a previous batch is computing on
        # device (the wait is hidden behind that compute) — seconds
        self.batch_window = float(
            os.environ.get("DREAMLAB_BATCH_WINDOW_MS", "20")
        ) / 1e3
        self.queue: "queue.Queue[Optional[Job]]" = queue.Queue(maxsize=queue_max)
        self.mode_config = mode_config or get_mode_config()
        self.registry = registry or get_model_registry()
        self._factory = worker_factory or self._default_factory
        self.worker = None
        self.current_mode: Optional[str] = None
        # multi-tenant mode cache: total resident workers (active + warm).
        # 1 = unload on every switch.
        self.mode_cache_size = int(os.environ.get("DREAMLAB_MODE_CACHE", "1"))
        self._mode_cache: Dict[str, Any] = {}  # insertion order = LRU order
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        # serializes background bucket captures against worker builds and
        # disposals: a capture's allocations never land inside a build's
        # before/after memory delta (they would inflate that worker's
        # registered footprint), and a worker is never torn down mid-capture
        self._hbm_window_lock = threading.Lock()
        # mode signature -> the device bytes its last build measured; a cold
        # load is admitted on the larger of this and the registry's estimate
        self._measured_hbm: Dict[tuple, int] = {}

        if load_default:
            self._load_mode(self.mode_config.default_mode)
        self._start_worker_thread()

    # ------------------------------------------------------------------
    @staticmethod
    def _default_factory(worker_id: int, model_path: str, *, loras=None,
                         embeddings=None, controlnet=None, refiner=None):
        from .worker_factory import create_cuda_worker

        return create_cuda_worker(
            worker_id, model_path, loras=loras, embeddings=embeddings,
            controlnet=controlnet, refiner=refiner,
        )

    def _load_mode(self, mode_name: str):
        mode = self.mode_config.get_mode(mode_name)
        sig = self._mode_signature(mode)

        # multi-tenant cache: with DREAMLAB_MODE_CACHE > 1, up to N modes
        # stay resident on the card and a switch back to a warm mode is
        # instant; cache size 1 unloads on every switch. Cached workers are keyed by
        # (model path, lora files+strengths): a modes.yaml hot-reload that
        # repoints a mode invalidates its warm worker instead of serving
        # stale weights.
        cached = self._cache_take(mode_name, sig)
        if cached is not None:
            self._stash_current_worker()
            with self._state_lock:
                self.worker = cached
                self.current_mode = mode_name
            logger.info("mode %s activated from cache", mode_name)
            return

        self._stash_current_worker()
        self._evict_until_fits(mode)
        t0 = time.time()
        worker = self._build_worker(mode_name, mode)
        with self._state_lock:
            self.worker = worker
            self.current_mode = mode_name
        logger.info("mode %s loaded in %.1fs", mode_name, time.time() - t0)

    def _build_worker(self, mode_name: str, mode):
        """Create and warm a worker for a mode and register its footprint on
        the card (shared by activation loads and cache preloading)."""
        import inspect
        import os

        warm = os.environ.get("WARMUP", "1") not in ("0", "false", "False")
        with self._hbm_window_lock:
            # the baseline holds no cached block a capture's empty_cache
            # would give back inside the window (the delta would miss it)
            self._empty_cache()
            used_before = self.registry.get_used_hbm()

            # per-mode extras (LoRAs with strengths, textual inversions, the
            # mode's ControlNet and refiner) pass to factories that accept
            # them; injected test factories with the plain (worker_id,
            # model_path) signature still work
            def accepts(name) -> bool:
                try:
                    fsig = inspect.signature(self._factory)
                except (TypeError, ValueError):
                    return False
                return name in fsig.parameters or any(
                    p.kind is p.VAR_KEYWORD for p in fsig.parameters.values()
                )

            kwargs = {}
            if mode.loras and accepts("loras"):
                kwargs["loras"] = mode.loras
            if getattr(mode, "embeddings", None) and accepts("embeddings"):
                kwargs["embeddings"] = mode.embeddings
            if getattr(mode, "controlnet", None) and accepts("controlnet"):
                kwargs["controlnet"] = mode.controlnet
            if getattr(mode, "refiner", None) and accepts("refiner"):
                kwargs["refiner"] = mode.refiner
            worker = self._factory(0, mode.model, **kwargs) if kwargs \
                else self._factory(0, mode.model)
            # capture the mode's default bucket so the first request after a
            # switch replays instead of capturing; a failed capture fails
            # the switch (no fallback on the card)
            pipeline = getattr(worker, "pipeline", None)
            size = mode.default_size()
            if warm and pipeline is not None and size:
                from .base import parse_size

                w, h = parse_size(size)
                try:
                    pipeline.warmup(h, w, steps=mode.default_steps() or 4)
                except Exception:
                    logger.exception("mode %s warmup failed", mode_name)
                    self._release(worker)
                    raise
            hbm = max(self.registry.get_used_hbm() - used_before, 0)
            if hbm:
                self._measured_hbm[self._mode_signature(mode)] = hbm
            else:
                hbm = self.registry.estimate_model_hbm(mode.model)
            self.registry.register_model(
                name=mode_name,
                model_path=mode.model,
                worker_id=0,
                hbm_bytes=hbm,
                loras=[l.display_name for l in mode.loras],
            )
        # extra buckets (defaults.warmup_buckets) are captured in the
        # BACKGROUND, started only after the delta above is taken; each
        # bucket holds _hbm_window_lock, so its allocations land in no later
        # build's delta either. The switch completes and the default bucket
        # serves at once; the other shapes arrive warm moments later, the
        # pool thread's requests replaying meanwhile (the device lock keeps
        # their launches out of the capture).
        extra = mode.warmup_buckets() if hasattr(mode, "warmup_buckets") else []
        if warm and getattr(worker, "pipeline", None) is not None and extra:
            def _warm_extra(worker=worker, extra=extra):
                for (bw, bh, bs) in extra:
                    try:
                        with self._hbm_window_lock:
                            # re-read per bucket: close() (eviction) drops
                            # the pipeline; stop warming a disposed worker
                            live = getattr(worker, "pipeline", None)
                            if live is None:
                                break
                            live.warmup(bh, bw, steps=bs)
                    except Exception:
                        logger.exception(
                            "mode %s background warmup %dx%d failed",
                            mode_name, bw, bh,
                        )
            threading.Thread(
                target=_warm_extra, name=f"warmup-{mode_name}", daemon=True,
            ).start()
        return worker

    # ------------------------------------------------------------------
    # worker cache management (all _mode_cache mutations under _state_lock;
    # dispose — device frees, gc — happens outside it)
    # ------------------------------------------------------------------

    @staticmethod
    def _mode_signature(mode) -> tuple:
        cn = getattr(mode, "controlnet", None)
        rf = getattr(mode, "refiner", None)
        return (
            mode.model,
            tuple((l.file, l.strength) for l in (mode.loras or [])),
            tuple(
                (e.file, e.name)
                for e in (getattr(mode, "embeddings", None) or [])
            ),
            (cn.file, cn.scale) if cn else None,
            (rf.file, rf.switch_at) if rf else None,
        )

    def _cache_take(self, mode_name: str, sig: tuple):
        """Pop and return the warm worker for ``mode_name`` if its cached
        signature still matches; dispose stale entries (modes.yaml
        re-pointed the mode since it was cached). None on miss."""
        with self._state_lock:
            entry = self._mode_cache.pop(mode_name, None)
        if entry is None:
            return None
        if entry[0] == sig:
            return entry[1]
        logger.info(
            "mode %s config changed since caching; reloading", mode_name
        )
        self._dispose_worker(mode_name, entry[1])
        return None

    def _admission_bytes(self, mode) -> int:
        """What a cold load of ``mode`` is admitted on: the larger of the
        registry's estimate (checkpoint bytes only) and the delta the last
        build of the same mode signature measured (weights and the default
        bucket's graph pool). A mode never built is admitted on the estimate;
        the JAX pool admits on the estimate alone."""
        return max(self.registry.estimate_model_hbm(mode.model),
                   self._measured_hbm.get(self._mode_signature(mode), 0))

    def _evict_until_fits(self, mode):
        """Make room BEFORE a load allocates: evict LRU warm workers until
        the admission bytes fit (can_fit degrades to True without device
        stats, so a stats-less backend never churns the cache)."""
        need = self._admission_bytes(mode)
        while not self.registry.can_fit(need):
            victim = self._pop_lru_cached()
            if victim is None:
                break
            self._dispose_worker(*victim)

    def _trim_cache(self):
        """Bound warm entries to mode_cache_size - 1 (one slot is reserved
        for the active worker)."""
        victims = []
        with self._state_lock:
            keep = max(self.mode_cache_size - 1, 0)
            while len(self._mode_cache) > keep:
                victims.append(self._pop_lru_locked())
        for v in victims:
            self._dispose_worker(*v)

    def _pop_lru_locked(self):
        """Pop the least-recently-used cache entry. Lock must be held."""
        mode, (_sig, worker) = next(iter(self._mode_cache.items()))
        del self._mode_cache[mode]
        return mode, worker

    def _pop_lru_cached(self):
        with self._state_lock:
            if not self._mode_cache:
                return None
            return self._pop_lru_locked()

    def _stash_current_worker(self):
        """Park the active worker in the cache (cache size 1 disposes it
        immediately: unload on every switch)."""
        with self._state_lock:
            worker, mode = self.worker, self.current_mode
            self.worker = None
            self.current_mode = None
            if worker is not None and mode and self.mode_cache_size > 1:
                try:
                    sig = self._mode_signature(self.mode_config.get_mode(mode))
                except Exception:
                    sig = None
                if sig is not None:
                    self._mode_cache[mode] = (sig, worker)  # MRU at the end
                    worker = None  # kept warm
        if worker is not None:
            self._dispose_worker(mode, worker)
        self._trim_cache()  # reserve one slot for the incoming active worker

    def _dispose_worker(self, mode: Optional[str], worker):
        if mode:
            self.registry.unregister_model(mode)
        with self._hbm_window_lock:  # never mid-capture of a background bucket
            self._release(worker)
        logger.info("mode %s unloaded", mode)

    def _release(self, worker):
        """Close a worker and give its memory back to the card: its graphs
        and weights dropped, collected, and the CUDA cache emptied, so
        ``mem_get_info`` shows the bytes free."""
        close = getattr(worker, "close", None)
        if close:
            close()
        self._empty_cache()

    def _empty_cache(self):
        """Collect garbage and return the allocator's cached blocks to the
        card, with the device lock held exclusively (no capture of another
        thread runs meanwhile): the device's used bytes are then live ones."""
        import gc

        import torch

        from ..pipeline import device_lock

        device = self.registry.device
        with device_lock(device).exclusive():
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    def _unload_current_worker(self):
        """Unload the active worker AND everything cached (shutdown path)."""
        victims = []
        with self._state_lock:
            worker, mode = self.worker, self.current_mode
            self.worker = None
            self.current_mode = None
            while self._mode_cache:
                victims.append(self._pop_lru_locked())
        if worker is not None:
            self._dispose_worker(mode, worker)
        for v in victims:
            self._dispose_worker(*v)

    # ------------------------------------------------------------------
    # multi-tenant routing: jobs whose spec names a non-active mode serve
    # from that mode's warm resident worker (DREAMLAB_MODE_CACHE > 1)
    # without touching the active mode — concurrent mode traffic pays no
    # switch, ever. All resolution happens on the pool thread.
    # ------------------------------------------------------------------

    @property
    def multi_tenant(self) -> bool:
        return self.mode_cache_size > 1

    def _worker_for_job(self, job: Job, before_build=None):
        """Resolve the worker that executes ``job`` (pool thread only).

        ``before_build`` runs immediately before any COLD tenant load —
        the caller settles in-flight futures there so they aren't held
        hostage to a model load, while warm-cache hits keep pipelining.
        Checking inside the resolution (not before it) closes the race
        where a modes.yaml reload between a warm-check and the load turns
        a 'warm' hit into a silent rebuild."""
        spec_mode = getattr(getattr(job, "spec", None), "mode", None)
        if not spec_mode or spec_mode == self.current_mode:
            return self.worker
        return self._tenant_worker(spec_mode, before_build=before_build)

    def _tenant_worker(self, mode_name: str, before_build=None):
        """Warm resident worker for a non-active mode, loading on first use.

        The active worker is never evicted for a tenant; tenants compete
        for the cache's size-1 warm slots under the registry's memory
        accounting, same as switch-time stashes."""
        if not self.multi_tenant:
            raise ValueError(
                f"mode {mode_name!r} is not active and DREAMLAB_MODE_CACHE="
                f"{self.mode_cache_size} leaves no room for warm tenants — "
                "switch modes or raise the cache size"
            )
        mode = self.mode_config.get_mode(mode_name)
        sig = self._mode_signature(mode)
        # a cached worker whose config changed since caching is about to be
        # disposed by _cache_take — settle in-flight pipelined batches FIRST
        # (they may be running on that very worker; disposing mid-flight
        # would also leave the registry under-counting until the batch
        # settles). Cache mutations happen on the pool thread only, so this
        # peek-then-take has no writer to race.
        with self._state_lock:
            entry = self._mode_cache.get(mode_name)
        if entry is not None and entry[0] != sig and before_build is not None:
            before_build()
        cached = self._cache_take(mode_name, sig)
        if cached is not None:
            with self._state_lock:
                self._mode_cache[mode_name] = (sig, cached)  # touch: MRU
            return cached
        if before_build is not None:
            before_build()
        self._evict_until_fits(mode)
        t0 = time.time()
        worker = self._build_worker(mode_name, mode)
        with self._state_lock:
            self._mode_cache[mode_name] = (sig, worker)
        self._trim_cache()
        logger.info(
            "tenant mode %s loaded in %.1fs (active stays %s)",
            mode_name, time.time() - t0, self.current_mode,
        )
        return worker

    # ------------------------------------------------------------------
    def _start_worker_thread(self):
        self._thread = threading.Thread(
            target=self._worker_loop, name="worker-pool", daemon=True
        )
        self._thread.start()

    def _can_batch(self, job: Job, worker=None) -> bool:
        worker = worker if worker is not None else self.worker
        return (
            isinstance(job, GenerationJob)
            and not job.with_latents
            and self.max_batch > 1
            and hasattr(worker, "run_jobs")
            and hasattr(worker, "batchable")
            # ensemble (base→refiner) workers serve solo: coalescing drives
            # one pipeline with explicit noise and would bypass the handoff
            and getattr(worker, "supports_batching", True)
        )

    def _collect_batch(
        self, first: GenerationJob, pending: list, *, window: float = 0.0,
        worker=None,
    ) -> list:
        """Greedily coalesce adjacent compatible jobs; stop at the first
        incompatible one so FIFO semantics (incl. the mode-switch ordering
        guarantee) hold.

        window: seconds to wait for more joiners. Callers pass it only
        while a previous batch is still computing on device — the wait is
        hidden behind that compute, so slightly-staggered arrivals coalesce
        for free (batch-8 is ~4× as efficient per image as batch-1)."""
        worker = worker if worker is not None else self.worker
        batch = [first]
        deadline = time.time() + window if window > 0 else 0.0
        while len(batch) < self.max_batch:
            try:
                remaining = deadline - time.time()
                if remaining > 0:
                    nxt = self.queue.get(timeout=min(remaining, 0.005))
                else:
                    nxt = self.queue.get_nowait()
            except queue.Empty:
                if deadline - time.time() > 0:
                    continue
                break
            self.queue.task_done()
            if (
                nxt is not None
                and isinstance(nxt, GenerationJob)
                and not nxt.with_latents
                # multi-tenant: only jobs resolving to the same worker share
                # a device call (None = the active mode; no switch can
                # interleave between collect and run — single pool thread)
                and (getattr(nxt.spec, "mode", None) or self.current_mode)
                == (getattr(first.spec, "mode", None) or self.current_mode)
                and worker.batchable(first.spec, nxt.spec)
            ):
                if nxt.future.set_running_or_notify_cancel():
                    batch.append(nxt)
                # cancelled joiners are simply dropped
            else:
                pending.append(nxt)
                break
        return batch

    def _worker_loop(self):
        pending: list = []
        try:
            self._run_jobs(pending)
        except Exception:
            logger.exception("worker loop crashed")
        finally:
            # fail anything left behind so no caller blocks forever
            leftovers = list(pending)
            while True:
                try:
                    leftovers.append(self.queue.get_nowait())
                    self.queue.task_done()
                except queue.Empty:
                    break
            for job in leftovers:
                if job is not None and not job.future.done():
                    job.future.set_exception(RuntimeError("pool shut down"))

    def _run_jobs(self, pending: list):
        # One coalesced batch may be "in flight": dispatched to the device
        # but not yet materialized — its images' copy to the host and PNG
        # encoding overlap the next batch's replay (the worker's
        # run_jobs_pipelined contract).
        # Futures still complete in strict FIFO order: the previous batch
        # settles immediately after the next one dispatches, and everything
        # non-batchable settles it first.
        inflight = None  # (jobs, finalize)

        def settle_inflight():
            nonlocal inflight
            if inflight is None:
                return
            jobs, finalize = inflight
            inflight = None
            try:
                results = finalize()
                for j, r in zip(jobs, results):
                    j.future.set_result(r)
            except Exception as e:
                logger.exception("batched jobs failed")
                for j in jobs:
                    j.future.set_exception(e)

        try:
            while not self._shutdown.is_set():
                if pending:
                    job = pending.pop(0)
                else:
                    try:
                        # short tick while work is in flight: a settle must
                        # not wait out the full idle timeout
                        job = self.queue.get(
                            timeout=0.01 if inflight else 0.25
                        )
                    except queue.Empty:
                        settle_inflight()
                        continue
                    self.queue.task_done()
                if job is None:
                    break
                # client gone (disconnect/timeout cancelled the future):
                # skip the job instead of burning device time
                if not job.future.set_running_or_notify_cancel():
                    if not pending and self.queue.empty():
                        settle_inflight()
                    continue

                # multi-tenant: route to the spec's mode (active by default).
                # A COLD tenant load settles in-flight work first (futures
                # must not be held hostage to a model load); warm tenants
                # keep the copy/encode-behind-replay pipelining.
                try:
                    worker = self._worker_for_job(
                        job, before_build=settle_inflight
                    )
                except Exception as e:
                    logger.exception("job %s mode resolution failed",
                                     job.job_id)
                    settle_inflight()
                    job.future.set_exception(e)
                    continue

                if self._can_batch(job, worker):
                    batch = self._collect_batch(
                        job, pending,
                        window=self.batch_window if inflight else 0.0,
                        worker=worker,
                    )
                    if len(batch) > 1:
                        runner = getattr(
                            worker, "run_jobs_pipelined", None
                        )
                        if runner is not None:
                            # dispatch the new batch BEFORE settling the
                            # previous one — that's the overlap
                            try:
                                finalize = runner([j.spec for j in batch])
                            except Exception as e:
                                logger.exception("batched dispatch failed")
                                settle_inflight()  # FIFO first
                                for j in batch:
                                    j.future.set_exception(e)
                                continue
                            settle_inflight()
                            inflight = (batch, finalize)
                            if not pending and self.queue.empty():
                                settle_inflight()
                            continue
                        try:
                            results = worker.run_jobs(
                                [j.spec for j in batch]
                            )
                            for j, r in zip(batch, results):
                                j.future.set_result(r)
                        except Exception as e:
                            logger.exception("batched jobs failed")
                            for j in batch:
                                j.future.set_exception(e)
                        continue

                # solo generation jobs pipeline the same way (one request's
                # copy and encoding hide behind the next one's replay)
                if (
                    isinstance(job, GenerationJob)
                    and not job.with_latents
                    and hasattr(worker, "run_job_pipelined")
                ):
                    try:
                        fin = worker.run_job_pipelined(job.spec)
                    except Exception as e:
                        logger.exception("job %s failed", job.job_id)
                        settle_inflight()  # FIFO: earlier job resolves first
                        job.future.set_exception(e)
                        continue
                    settle_inflight()
                    inflight = ([job], lambda fin=fin: [fin()])
                    # a lone request must not wait for the idle tick: only
                    # keep it in flight if more work is already queued
                    if not pending and self.queue.empty():
                        settle_inflight()
                    continue

                # anything else (mode switch, custom, fingerprint job)
                # runs strictly after the in-flight work completes
                settle_inflight()
                try:
                    if job.job_type is JobType.MODE_SWITCH:
                        if job.target_mode == self.current_mode:
                            logger.info("already in mode %s", job.target_mode)
                            result = job.execute(self.worker)
                        else:
                            result = job.execute(self.worker)
                            self._load_mode(job.target_mode)
                    else:
                        # fingerprint jobs route to their tenant too
                        result = job.execute(worker)
                    job.future.set_result(result)
                except Exception as e:  # fail only this job
                    logger.exception("job %s failed", job.job_id)
                    job.future.set_exception(e)
        finally:
            settle_inflight()  # never strand a dispatched batch

    # ------------------------------------------------------------------
    def submit_job(self, job: Job) -> Future:
        if self._shutdown.is_set():
            raise RuntimeError("pool is shut down")
        try:
            self.queue.put_nowait(job)
        except queue.Full:
            raise QueueFullError(
                f"queue full ({self.queue.maxsize} jobs)"
            ) from None
        return job.future

    def switch_mode(
        self, mode_name: str, on_complete: Optional[Callable] = None
    ) -> Future:
        if not self.mode_config.has_mode(mode_name):
            raise KeyError(f"unknown mode {mode_name!r}")
        return self.submit_job(ModeSwitchJob(mode_name, on_complete))

    def get_status(self) -> Dict:
        return {
            "current_mode": self.current_mode,
            "queue_depth": self.queue.qsize(),
            "queue_max": self.queue.maxsize,
            "worker_loaded": self.worker is not None,
            "warm_modes": self._warm_modes(),
            "mode_cache_size": self.mode_cache_size,
            "shutdown": self._shutdown.is_set(),
        }

    def _warm_modes(self):
        with self._state_lock:
            return list(self._mode_cache)

    def evict_mode(self, mode_name: str) -> bool:
        """Drop a warm (non-active) mode from the cache. Queued on the pool
        thread (single-writer); returns True if something was evicted."""

        def _evict(_worker):
            if mode_name == self.current_mode:
                raise ValueError(
                    f"mode {mode_name!r} is active; switch away first"
                )
            with self._state_lock:
                entry = self._mode_cache.pop(mode_name, None)
            if entry is None:
                return False
            self._dispose_worker(mode_name, entry[1])
            return True

        return self.submit_job(CustomJob(_evict)).result()

    def preload_modes(self, mode_names) -> list:
        """Load modes into the warm cache without activating them: a
        deployment warms its whole rotation at startup so even the first
        switch to each mode is instant. Runs on the pool thread (queued as
        a custom job) to keep all cache mutation single-writer; returns the
        list of modes actually loaded."""

        def _preload_one(_worker, name):
            if name == self.current_mode:
                return None
            with self._state_lock:
                if name in self._mode_cache:
                    return None
                room = (
                    len(self._mode_cache)
                    < max(self.mode_cache_size - 1, 0)
                )
            if not room:
                logger.warning(
                    "preload: cache full (size %d); skipping %s",
                    self.mode_cache_size, name,
                )
                return None
            try:
                mode = self.mode_config.get_mode(name)
            except KeyError:
                logger.warning("preload: unknown mode %s", name)
                return None
            if not self.registry.can_fit(self._admission_bytes(mode)):
                logger.warning("preload: no room on the device for %s", name)
                return None
            worker = self._build_worker(name, mode)
            with self._state_lock:
                self._mode_cache[name] = (self._mode_signature(mode), worker)
            logger.info("preloaded mode %s into the warm cache", name)
            return name

        # one job PER mode: generation requests interleave between loads
        # instead of queueing behind the whole rotation
        futures = [
            self.submit_job(CustomJob(_preload_one, name))
            for name in mode_names
        ]
        return [name for name in (f.result() for f in futures) if name]

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0):
        """Graceful drain, then stop and unload every worker."""
        if drain:
            deadline = time.time() + timeout
            while not self.queue.empty() and time.time() < deadline:
                time.sleep(0.05)
        self._shutdown.set()
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            pass
        if self._thread:
            self._thread.join(timeout=5.0)
        self._unload_current_worker()


_pool: Optional[WorkerPool] = None
_pool_lock = threading.Lock()


def get_worker_pool(**kwargs) -> WorkerPool:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = WorkerPool(**kwargs)
        return _pool


def reset_worker_pool():
    global _pool
    with _pool_lock:
        if _pool is not None:
            try:
                _pool.shutdown(drain=False, timeout=0.5)
            except Exception:
                logger.exception("pool shutdown during reset failed")
            _pool = None
