"""The port's worker pool, mode config, file watcher and registry on the CPU.

Mirrors ``tests/test_engine.py``, ``tests/test_multitenant.py`` and
``tests/test_pool_interleaving.py`` against ``dreamlab_tpu_torch``: the
JAX tests' fake workers are re-declared here and drive the pool's FIFO,
backpressure, switch, failure, shutdown, coalescing, pipelining, cache,
tenant, preload and evict rules. ``ModeConfigManager(...).to_dict()`` must
equal the JAX manager's on the same files. A tiny real ``CudaPipelineWorker``
on the CPU behind the pool: pipelined solo and batched PNGs byte-equal to
``run_job``, two pipelined requests of different styles each equal to its
serial run, and the pixels within +-1 (under 1 % moved) of the JAX pool's
on the same weights, the bounds of ``tests/test_torch_port_pipeline.py``.
"""

import io
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dreamlab_tpu.engine.mode_config import ModeConfigError as JaxModeConfigError
from dreamlab_tpu.engine.mode_config import ModeConfigManager as JaxModeConfigManager
from dreamlab_tpu.engine.model_registry import ModelRegistry as JaxRegistry
from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
from dreamlab_tpu.engine.worker_pool import WorkerPool as JaxWorkerPool
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import lora, testing
from dreamlab_tpu_torch.engine import file_watcher, mode_config, worker_pool
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.mode_config import ModeConfigError, ModeConfigManager
from dreamlab_tpu_torch.engine.model_registry import ModelRegistry
from dreamlab_tpu_torch.engine.worker_pool import (CustomJob, GenerationJob, QueueFullError,
                                                   WorkerPool)
from dreamlab_tpu_torch.pipeline import DeviceLock, LCMPipeline, device_lock, quiesced
from dreamlab_tpu_torch.utils import yaml_lite
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_torch_port_img2img import one_torch_thread, port_bundle_of  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# fakes (the JAX tests' deterministic fake workers)
# ---------------------------------------------------------------------------


class FakeWorker:
    def __init__(self, worker_id, model_path):
        self.worker_id = worker_id
        self.model_path = model_path
        self.closed = False
        self.jobs = []

    def run_job(self, spec):
        self.jobs.append(spec)
        rs = np.random.RandomState(spec.seed or 0)
        return rs.bytes(64), spec.seed or 0

    def run_job_with_latents(self, spec):
        png, seed = self.run_job(spec)
        return png, seed, b"\x00" * 512

    def close(self):
        self.closed = True


class BatchingFakeWorker(FakeWorker):
    def __init__(self, *a):
        super().__init__(*a)
        self.batch_calls = []
        self.batches = []

    @staticmethod
    def batchable(a, b):
        return a.size == b.size and a.num_inference_steps == b.num_inference_steps

    def run_jobs(self, specs):
        self.batch_calls.append(len(specs))
        self.batches.append(list(specs))
        return [self.run_job(s) for s in specs]


class PipelinedFakeWorker:
    """Dispatch/finalize events in a shared log; ``hold`` keeps the first
    batch's finalize waiting (a batch still computing)."""

    def __init__(self, log, hold=None):
        self.log, self.hold, self.calls = log, hold, 0

    @staticmethod
    def batchable(a, b):
        return a.size == b.size

    def run_jobs(self, specs):
        return self.run_jobs_pipelined(specs)()

    def run_jobs_pipelined(self, specs):
        self.log.append(("dispatch", [s.prompt for s in specs]))
        self.calls += 1
        first = self.calls == 1

        def finalize():
            if first and self.hold is not None:
                self.hold.wait(5)
            self.log.append(("finalize", [s.prompt for s in specs]))
            return [(f"png:{s.prompt}".encode(), s.seed) for s in specs]

        return finalize

    def run_job(self, spec):
        self.log.append(("solo", spec.prompt))
        return f"png:{spec.prompt}".encode(), spec.seed

    def close(self):
        pass


def modes_file(path, modes=("alpha", "beta"), default=None):
    """``tests/test_engine.py::write_modes_yaml``'s file, by the port's writer."""
    return testing.write_modes_yaml(
        str(path), {name: {"model": f"{name}.safetensors", "defaults": {"steps": 4}}
                    for name in modes},
        default_mode=default or modes[0], model_root="/nonexistent")


def make_pool(tmp_path, *, modes=("alpha", "beta"), cache_size=None, max_batch=None,
              queue_max=4, factory=None, total=16 << 30):
    cfg = ModeConfigManager(modes_file(tmp_path / "modes.yaml", modes))
    created = []

    def default_factory(worker_id, model_path):
        w = FakeWorker(worker_id, model_path)
        created.append(w)
        return w

    pool = WorkerPool(queue_max=queue_max, worker_factory=factory or default_factory,
                      mode_config=cfg, registry=ModelRegistry(total_hbm_bytes=total,
                                                              device="cpu"),
                      max_batch=max_batch)
    if cache_size is not None:
        pool.mode_cache_size = cache_size
    pool._created = created
    return pool


@pytest.fixture
def pool(tmp_path):
    p = make_pool(tmp_path)
    yield p
    p.shutdown(drain=False, timeout=1.0)


def stall(pool):
    """Park the pool thread in a custom job until the returned event is set."""
    gate, entered = threading.Event(), threading.Event()

    def blocker(_worker):
        entered.set()
        assert gate.wait(10)
        return "unblocked"

    fut = pool.submit_job(CustomJob(blocker))
    assert entered.wait(10)
    return gate, fut


def spec(prompt="p", seed=0, size="32x32", steps=2, **kw):
    return GenSpec(prompt=prompt, size=size, num_inference_steps=steps, seed=seed, **kw)


# ---------------------------------------------------------------------------
# the pool with fakes (tests/test_engine.py)
# ---------------------------------------------------------------------------


def test_default_mode_loaded_and_roundtrip(pool):
    assert pool.current_mode == "alpha" and pool.worker is not None
    assert pool.registry.get_model("alpha") is not None
    png, seed = pool.submit_job(GenerationJob(GenSpec(prompt="hi", seed=3))).result(timeout=5)
    assert seed == 3 and isinstance(png, bytes)
    assert pool.get_status() == {"current_mode": "alpha", "queue_depth": 0, "queue_max": 4,
                                 "worker_loaded": True, "warm_modes": [],
                                 "mode_cache_size": pool.mode_cache_size, "shutdown": False}


def test_fifo_ordering(pool):
    order = []

    def slow(worker, tag):
        time.sleep(0.05)
        order.append(tag)
        return tag

    futs = [pool.submit_job(CustomJob(slow, t)) for t in ("a", "b", "c")]
    assert [f.result(timeout=5) for f in futs] == ["a", "b", "c"] and order == ["a", "b", "c"]


def test_mode_switch_recreates_worker_and_same_mode_is_a_noop(pool):
    first = pool.worker
    pool.switch_mode("alpha").result(timeout=5)
    assert pool.worker is first
    assert pool.switch_mode("beta").result(timeout=5) == "beta"
    assert pool.current_mode == "beta" and pool.worker is not first and first.closed
    assert pool.registry.get_model("alpha") is None
    assert pool.registry.get_model("beta") is not None
    with pytest.raises(KeyError):
        pool.switch_mode("nope")


def test_switch_waits_for_inflight_jobs(pool):
    seen = []

    def slow(worker, tag):
        time.sleep(0.1)
        seen.append((tag, worker.model_path))
        return tag

    pool.submit_job(CustomJob(slow, "before"))
    pool.switch_mode("beta")
    pool.submit_job(CustomJob(slow, "after")).result(timeout=5)
    assert seen[0][0] == "before" and seen[0][1].endswith("alpha.safetensors")
    assert seen[1][0] == "after" and seen[1][1].endswith("beta.safetensors")


def test_queue_full_backpressure(pool):
    gate, _ = stall(pool)
    for _ in range(4):
        pool.submit_job(CustomJob(lambda w: None))
    with pytest.raises(QueueFullError):
        pool.submit_job(CustomJob(lambda w: None))
    gate.set()


def test_job_failure_only_fails_that_future(pool):
    def boom(worker):
        raise RuntimeError("kaboom")

    bad = pool.submit_job(CustomJob(boom))
    good = pool.submit_job(CustomJob(lambda w: "ok"))
    with pytest.raises(RuntimeError):
        bad.result(timeout=5)
    assert good.result(timeout=5) == "ok"


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_fails_the_leftovers(tmp_path, drain):
    pool = make_pool(tmp_path, queue_max=8)
    gate, _ = stall(pool)
    results = []
    futs = [pool.submit_job(CustomJob(lambda w: results.append(1))) for _ in range(3)]
    gate.set()
    pool.shutdown(drain=drain, timeout=5 if drain else 0.2)
    for f in futs:
        assert f.done()
        if drain:
            assert f.exception() is None
        elif f.exception() is not None:  # or it completed before shutdown won the race
            assert "shut down" in str(f.exception())
    if drain:
        assert results == [1, 1, 1]
    with pytest.raises(RuntimeError):
        pool.submit_job(CustomJob(lambda w: None))
    assert pool._created[0].closed


def test_pool_coalesces_compatible_jobs(tmp_path):
    workers = []

    def factory(i, path):
        workers.append(BatchingFakeWorker(i, path))
        return workers[-1]

    pool = make_pool(tmp_path, queue_max=16, max_batch=4, factory=factory)
    try:
        gate, _ = stall(pool)
        futs = [pool.submit_job(GenerationJob(spec(f"p{i}", i))) for i in range(3)]
        # an incompatible job right after: it must not join the batch
        odd = pool.submit_job(GenerationJob(spec("odd", 9, size="64x64")))
        gate.set()
        for f in futs + [odd]:
            f.result(timeout=5)
        assert 3 in workers[0].batch_calls and workers[0].jobs[-1].prompt == "odd"
    finally:
        pool.shutdown(drain=False, timeout=1)


def test_pool_batching_disabled_for_plain_worker(pool):
    futs = [pool.submit_job(GenerationJob(spec(f"p{i}", i))) for i in range(3)]
    assert [f.result(timeout=5)[1] for f in futs] == [0, 1, 2]


def test_pool_pipelined_batches_overlap_and_stay_fifo(tmp_path):
    events = []
    pool = make_pool(tmp_path, queue_max=32, max_batch=2,
                     factory=lambda i, p: PipelinedFakeWorker(events))
    try:
        gate, _ = stall(pool)
        futs = [pool.submit_job(GenerationJob(spec(f"p{i}", i))) for i in range(4)]
        solo = pool.submit_job(GenerationJob(spec("solo", 9, size="64x64")))
        gate.set()
        assert [f.result(timeout=5)[0] for f in futs] == [b"png:p0", b"png:p1", b"png:p2",
                                                          b"png:p3"]
        solo.result(timeout=5)
        # batch 2 dispatches before batch 1 finalizes; the solo job settles batch 2 first
        assert events == [("dispatch", ["p0", "p1"]), ("dispatch", ["p2", "p3"]),
                          ("finalize", ["p0", "p1"]), ("finalize", ["p2", "p3"]),
                          ("solo", "solo")]
    finally:
        pool.shutdown(drain=False, timeout=1)


def test_pool_inflight_settles_on_shutdown(tmp_path):
    pool = make_pool(tmp_path, queue_max=8, max_batch=2,
                     factory=lambda i, p: PipelinedFakeWorker([]))
    futs = [pool.submit_job(GenerationJob(spec(f"x{i}", i))) for i in range(2)]
    pool.shutdown(timeout=5)
    assert [f.result(timeout=1)[1] for f in futs] == [0, 1]


def test_batch_window_fills_while_inflight(tmp_path, monkeypatch):
    monkeypatch.setenv("DREAMLAB_BATCH_WINDOW_MS", "400")
    events, release_first = [], threading.Event()
    pool = make_pool(tmp_path, queue_max=32, max_batch=4,
                     factory=lambda i, p: PipelinedFakeWorker(events, hold=release_first))
    try:
        gate, _ = stall(pool)
        f1 = [pool.submit_job(GenerationJob(spec(f"a{i}", i))) for i in range(2)]
        gate.set()
        time.sleep(0.15)  # batch 1 dispatched; the loop idles with it in flight
        f2a = pool.submit_job(GenerationJob(spec("b0", 10)))
        time.sleep(0.1)
        f2b = pool.submit_job(GenerationJob(spec("b1", 11)))
        release_first.set()
        for f in f1 + [f2a, f2b]:
            f.result(timeout=10)
        dispatches = [p for kind, p in events if kind == "dispatch"]
        assert ["a0", "a1"] in dispatches and ["b0", "b1"] in dispatches, dispatches
    finally:
        pool.shutdown(drain=False, timeout=1)


def test_cancelled_jobs_are_skipped(pool):
    gate, _ = stall(pool)
    doomed = pool.submit_job(GenerationJob(spec("doomed", 1)))
    alive = pool.submit_job(GenerationJob(spec("alive", 2)))
    assert doomed.cancel()
    gate.set()
    assert alive.result(timeout=10)[1] == 2 and doomed.cancelled()
    assert all(j.prompt != "doomed" for j in pool.worker.jobs)


# ---------------------------------------------------------------------------
# the mode cache, preload and evict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_size,builds,resident", [(2, 2, {"alpha", "beta"}),
                                                        (1, 3, {"alpha"})])
def test_mode_cache_keeps_warm_workers(tmp_path, monkeypatch, cache_size, builds, resident):
    """DREAMLAB_MODE_CACHE=2 reactivates a warm worker; 1 reloads on every switch."""
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", str(cache_size))
    pool = make_pool(tmp_path, queue_max=8)
    try:
        assert pool.mode_cache_size == cache_size
        first = pool.worker
        pool.switch_mode("beta").result(timeout=5)
        pool.switch_mode("alpha").result(timeout=5)
        assert (pool.worker is first) == (cache_size > 1)
        assert len(pool._created) == builds
        assert {m["name"] for m in pool.registry.get_hbm_stats()["models"]} == resident
    finally:
        pool.shutdown(drain=False, timeout=1)
    assert pool.registry.get_hbm_stats()["models"] == []
    assert all(w.closed for w in pool._created)


def test_mode_cache_evicts_before_load_when_memory_is_tight(tmp_path, monkeypatch):
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "3")
    for name in ("a", "b"):
        (tmp_path / f"{name}.safetensors").write_bytes(b"x" * 200)  # estimate 120 B
    cfg = ModeConfigManager(testing.write_modes_yaml(
        str(tmp_path / "m.yaml"), {n: {"model": f"{n}.safetensors"} for n in ("a", "b")},
        default_mode="a", model_root=str(tmp_path)))
    order = []

    class W:
        def __init__(self, mode):
            self.mode = mode

        def close(self):
            order.append(("closed", self.mode))

    reg = ModelRegistry(total_hbm_bytes=150, device="cpu")  # fits one, not two
    pool = WorkerPool(queue_max=8, worker_factory=lambda i, p: W(p), mode_config=cfg,
                      registry=reg)
    try:
        active_a = pool.worker
        pool.switch_mode("b").result(timeout=5)
        assert {m["name"] for m in reg.get_hbm_stats()["models"]} == {"b"}
        assert ("closed", active_a.mode) in order  # closed before b was built
        assert pool.get_status()["warm_modes"] == []
    finally:
        pool.shutdown(drain=False, timeout=1)


def test_a_reload_is_admitted_on_the_measured_footprint(tmp_path, monkeypatch):
    """The registry's estimate sees checkpoint bytes only; a build measures
    3x as much. A mode never built is admitted on the estimate (tenant c
    fits beside a and b on it, and overfills the card); once c has been
    built and evicted, its reload is admitted on the measured bytes and
    evicts the LRU tenant b first, which the estimate alone would not."""
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "3")
    names = ("a", "b", "c")
    for name in names:
        (tmp_path / f"{name}.safetensors").write_bytes(b"x" * 200)  # estimate 120 B
    cfg = ModeConfigManager(testing.write_modes_yaml(
        str(tmp_path / "m.yaml"), {n: {"model": f"{n}.safetensors"} for n in names},
        default_mode="a", model_root=str(tmp_path)))
    build = 3 * ModelRegistry.estimate_model_hbm(str(tmp_path / "a.safetensors"))
    order = []

    class Card(ModelRegistry):
        """A registry over a simulated card whose used bytes the workers move."""
        used = 0

        def get_used_hbm(self):
            return self.used

    reg = Card(total_hbm_bytes=1000, device="cpu")  # loads may fill 900 B

    class W:
        def __init__(self, path):
            self.mode = os.path.basename(path)[0]
            reg.used += build
            order.append(("built", self.mode))

        def run_job(self, spec):
            return self.mode.encode(), spec.seed

        def close(self):
            reg.used -= build
            order.append(("closed", self.mode))

    pool = WorkerPool(queue_max=8, worker_factory=lambda i, p: W(p), mode_config=cfg,
                      registry=reg)

    def tenant(name):
        return pool.submit_job(GenerationJob(spec(seed=1, mode=name))).result(timeout=5)

    try:
        assert tenant("b") == (b"b", 1) and tenant("c") == (b"c", 1)
        assert reg.used == 3 * build > 900  # c was admitted on its estimate
        assert [m.hbm_bytes for m in reg.list_models()] == [build] * 3
        assert pool.evict_mode("c") and reg.used == 2 * build
        assert reg.can_fit(reg.estimate_model_hbm(str(tmp_path / "c.safetensors")))
        order.clear()
        assert tenant("c") == (b"c", 1)
        assert order == [("closed", "b"), ("built", "c")]
        assert pool.current_mode == "a" and pool.get_status()["warm_modes"] == ["c"]
        assert reg.used == 2 * build
    finally:
        pool.shutdown(drain=False, timeout=1)


def test_mode_cache_invalidated_by_config_change(tmp_path, monkeypatch):
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", "4")
    path = str(tmp_path / "m.yaml")

    def write(model_a):
        testing.write_modes_yaml(path, {"a": {"model": model_a}, "b": {"model": "mb"}},
                                 default_mode="a", model_root=str(tmp_path))

    write("ma")
    cfg = ModeConfigManager(path)

    class W:
        def __init__(self, path):
            self.path = path

        def close(self):
            pass

    pool = WorkerPool(queue_max=8, worker_factory=lambda i, p: W(p), mode_config=cfg,
                      registry=ModelRegistry(total_hbm_bytes=1 << 30, device="cpu"))
    try:
        first = pool.worker
        pool.switch_mode("b").result(timeout=5)
        write("ma-v2")
        cfg.reload()
        pool.switch_mode("a").result(timeout=5)
        assert pool.worker is not first and pool.worker.path.endswith("ma-v2")
    finally:
        pool.shutdown(drain=False, timeout=1)


@pytest.mark.parametrize("cache_size,want", [(3, ["beta", "gamma"]), (2, ["beta"])])
def test_preload_modes_warms_the_cache_within_its_capacity(tmp_path, monkeypatch,
                                                             cache_size, want):
    monkeypatch.setenv("DREAMLAB_MODE_CACHE", str(cache_size))
    pool = make_pool(tmp_path, modes=("alpha", "beta", "gamma"), queue_max=8)
    try:
        assert pool.preload_modes(["beta", "gamma", "alpha", "nope"]) == want
        assert pool.current_mode == "alpha" and set(pool.get_status()["warm_modes"]) == set(want)
        warm_beta = dict(pool._mode_cache)["beta"][1]
        pool.switch_mode("beta").result(timeout=5)
        assert pool.worker is warm_beta
        assert pool.evict_mode("alpha") is True and not pool.evict_mode("alpha")
        assert pool.registry.get_model("alpha") is None
        with pytest.raises(ValueError, match="active"):
            pool.evict_mode("beta")
    finally:
        pool.shutdown(drain=False, timeout=1)


# ---------------------------------------------------------------------------
# tenants (tests/test_multitenant.py)
# ---------------------------------------------------------------------------


def _built(pool, mode):
    return [w for w in pool._created if mode in w.model_path]


def test_tenant_request_serves_without_switch_and_reuses_its_worker(tmp_path):
    pool = make_pool(tmp_path, modes=("alpha", "beta", "gamma"), cache_size=3, queue_max=16)
    try:
        for seed in range(3):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", seed=seed, mode="beta"))
                            ).result(timeout=10)
        assert pool.current_mode == "alpha" and "beta" in pool.get_status()["warm_modes"]
        assert len(_built(pool, "beta")) == 1 and len(_built(pool, "beta")[0].jobs) == 3
        assert _built(pool, "alpha")[0].jobs == []
    finally:
        pool.shutdown()


def test_tenant_requires_cache_headroom_and_bad_modes_fail_one_job(tmp_path):
    pool = make_pool(tmp_path, modes=("alpha", "beta"), cache_size=1, queue_max=16)
    try:
        with pytest.raises(ValueError, match="DREAMLAB_MODE_CACHE"):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="beta"))).result(timeout=10)
        pool.mode_cache_size = 3
        with pytest.raises(KeyError):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="nope"))).result(timeout=10)
        pool.submit_job(GenerationJob(GenSpec(prompt="x"))).result(timeout=10)
        assert pool.current_mode == "alpha"
    finally:
        pool.shutdown()


def test_tenant_lru_eviction_bounded(tmp_path):
    pool = make_pool(tmp_path, modes=("alpha", "beta", "gamma"), cache_size=2, queue_max=16)
    try:
        for mode in ("beta", "gamma"):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", mode=mode))).result(timeout=10)
        assert pool.get_status()["warm_modes"] == ["gamma"]
        assert _built(pool, "beta")[0].closed
        assert not _built(pool, "alpha")[0].closed and pool.current_mode == "alpha"
    finally:
        pool.shutdown()


def test_tenant_switch_interleaving_builds_once(tmp_path):
    pool = make_pool(tmp_path, modes=("alpha", "beta", "gamma"), cache_size=3, queue_max=16)
    try:
        gate, _ = stall(pool)
        f1 = pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="beta")))
        sw = pool.switch_mode("beta")
        f2 = pool.submit_job(GenerationJob(GenSpec(prompt="y", mode="beta")))
        gate.set()
        for f in (f1, sw, f2):
            f.result(timeout=10)
        assert len(_built(pool, "beta")) == 1 and len(_built(pool, "beta")[0].jobs) == 2
        assert pool.current_mode == "beta" and pool.worker is _built(pool, "beta")[0]
    finally:
        pool.shutdown()


def test_pinned_mode_survives_queued_switch(tmp_path):
    pool = make_pool(tmp_path, modes=("alpha", "beta"), cache_size=2, queue_max=16)
    try:
        gate, _ = stall(pool)
        sw = pool.switch_mode("beta")
        fut = pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="alpha")))
        gate.set()
        sw.result(timeout=10)
        fut.result(timeout=10)
        assert pool.current_mode == "beta"
        assert [s.mode for s in _built(pool, "alpha")[0].jobs] == ["alpha"]
        assert _built(pool, "beta")[0].jobs == []
    finally:
        pool.shutdown()


def test_mixed_mode_jobs_do_not_share_batches(tmp_path):
    created = []

    def factory(i, path):
        created.append(BatchingFakeWorker(i, path))
        return created[-1]

    pool = make_pool(tmp_path, cache_size=2, max_batch=8, queue_max=32, factory=factory)
    try:
        pool.submit_job(GenerationJob(GenSpec(prompt="w", mode="beta"))).result(timeout=10)
        gate, _ = stall(pool)
        futs = [pool.submit_job(GenerationJob(GenSpec(prompt="x", seed=i, mode=m)))
                for i, m in enumerate([None, None, "beta", "beta", None])]
        gate.set()
        for f in futs:
            f.result(timeout=10)
        alpha, beta = created[0], next(w for w in created if "beta" in w.model_path)
        assert all({s.mode for s in b} == {None} for b in alpha.batches)
        assert all({s.mode for s in b} == {"beta"} for b in beta.batches)
        assert len([s for s in alpha.jobs if s.mode is None]) == 3
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# builds on the card's terms: warm-up, failures, disposal
# ---------------------------------------------------------------------------


class WarmWorker(FakeWorker):
    """A fake whose pipeline records warm-ups (and fails them where asked)."""

    def __init__(self, worker_id, model_path, fail=False):
        super().__init__(worker_id, model_path)
        test = self

        class Pipe:
            warmed = []

            def warmup(self, h, w, steps=4):
                if fail:
                    raise RuntimeError("capture failed")
                time.sleep(0.05)
                self.warmed.append((w, h, steps))

            def release_graphs(self):
                test.released = True

        self.pipeline = Pipe()
        self.released = False

    def close(self):
        self.pipeline.release_graphs()
        self.pipeline = None
        super().close()


def test_mode_warmup_captures_the_default_and_the_background_buckets(tmp_path):
    cfg = ModeConfigManager(testing.write_modes_yaml(
        str(tmp_path / "m.yaml"), {"a": {"model": "x", "defaults": {
            "size": "64x32", "steps": 3, "warmup_buckets": ["32x32:2", "64x64"]}}}))
    created = []

    def factory(i, p):
        created.append(WarmWorker(i, p))
        return created[-1]

    pool = WorkerPool(queue_max=4, worker_factory=factory, mode_config=cfg,
                      registry=ModelRegistry(total_hbm_bytes=1 << 30, device="cpu"))
    try:
        warmed = created[0].pipeline.warmed
        assert warmed[0] == (64, 32, 3)  # the default bucket, before the switch returns
        deadline = time.time() + 10
        while len(warmed) < 3 and time.time() < deadline:
            time.sleep(0.02)
        assert warmed == [(64, 32, 3), (32, 32, 2), (64, 64, 3)]
    finally:
        pool.shutdown()
    assert created[0].released and created[0].closed


def test_a_failed_default_warmup_fails_the_switch(tmp_path):
    cfg = ModeConfigManager(testing.write_modes_yaml(
        str(tmp_path / "m.yaml"), {"a": {"model": "x"},
                                   "b": {"model": "y", "defaults": {"size": "32x32"}}}))
    created = []

    def factory(i, p):
        created.append(WarmWorker(i, p, fail=p.endswith("y")))
        return created[-1]

    reg = ModelRegistry(total_hbm_bytes=1 << 30, device="cpu")
    pool = WorkerPool(queue_max=4, worker_factory=factory, mode_config=cfg, registry=reg)
    try:
        with pytest.raises(RuntimeError, match="capture failed"):
            pool.switch_mode("b").result(timeout=10)
        assert created[1].closed and reg.get_model("b") is None and pool.worker is None
        pool.switch_mode("a").result(timeout=10)  # the pool thread serves on
        assert pool.current_mode == "a"
    finally:
        pool.shutdown()


def test_get_and_reset_worker_pool(tmp_path, monkeypatch):
    cfg = ModeConfigManager(modes_file(tmp_path / "m.yaml"))
    kw = dict(worker_factory=FakeWorker, mode_config=cfg,
              registry=ModelRegistry(total_hbm_bytes=1 << 30, device="cpu"))
    worker_pool.reset_worker_pool()
    try:
        p = worker_pool.get_worker_pool(**kw)
        assert worker_pool.get_worker_pool() is p
    finally:
        worker_pool.reset_worker_pool()
    assert p.get_status()["shutdown"]


# ---------------------------------------------------------------------------
# registry, mode config, file watcher
# ---------------------------------------------------------------------------


def test_registry_accounting_and_estimate(tmp_path):
    reg = ModelRegistry(total_hbm_bytes=10_000, device="cpu")
    reg.register_model("m1", "/p1", 0, 4_000)
    reg.register_model("m1", "/p1b", 0, 5_000)  # overwrite warns, keeps the latest
    assert reg.get_model("m1").model_path == "/p1b" and reg.get_used_hbm() == 5_000
    assert reg.can_fit(4_000) and not reg.can_fit(4_001)
    assert reg.unregister_model("m1") and not reg.unregister_model("m1")
    reg.register_model("m2", "/p2", 0, 1, loras=["detail"])
    assert reg.get_hbm_stats()["models"][0]["loras"] == ["detail"]
    reg.clear()
    assert reg.get_model("m2") is None and reg.list_models() == []
    (tmp_path / "model" / "unet").mkdir(parents=True)
    (tmp_path / "model" / "unet" / "w.safetensors").write_bytes(b"x" * 1000)
    (tmp_path / "model" / "notes.txt").write_bytes(b"x" * 77)
    (tmp_path / "single.safetensors").write_bytes(b"x" * 333)
    for path in (tmp_path / "model", tmp_path / "single.safetensors"):
        for dtype_bytes in (2, 4):
            assert ModelRegistry.estimate_model_hbm(str(path), dtype_bytes) == \
                JaxRegistry.estimate_model_hbm(str(path), dtype_bytes)
    assert ModelRegistry.estimate_model_hbm(str(tmp_path / "model")) == 600


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_half_float_safetensors_are_estimated_from_their_header(tmp_path, dtype_bytes):
    """A deliberate divergence (ROADMAP Queue 3): the reference takes every
    file for fp32, so it halves an fp16 directory. The port counts its
    elements from the safetensors header at 4 bytes, so an fp16 or bf16
    file gets elements x dtype_bytes x 1.2 (plus its header's bytes at the
    reference's rate), twice the reference's payload term; an fp32 file,
    a .bin and an unparsable header still get the reference's estimate."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn((64, 48), generator=g), "b": torch.randn((300,), generator=g)}
    elements = 64 * 48 + 300
    half = tmp_path / "fp16"
    (half / "unet").mkdir(parents=True)
    save_file({k: v.half() for k, v in tensors.items()}, str(half / "unet" / "w.safetensors"))
    save_file({"c": torch.zeros((10, 10), dtype=torch.bfloat16)},
              str(half / "te.safetensors"))
    elements += 100
    full = str(tmp_path / "fp32.safetensors")
    save_file(tensors, full)
    (tmp_path / "weights.bin").write_bytes(b"x" * 4096)
    est = lambda p: ModelRegistry.estimate_model_hbm(str(p), dtype_bytes)
    jax_est = lambda p: JaxRegistry.estimate_model_hbm(str(p), dtype_bytes)
    headers = sum(os.path.getsize(p) for p in (half / "unet" / "w.safetensors",
                                               half / "te.safetensors")) - 2 * elements
    rate = 1.2 * dtype_bytes / 4
    assert est(half) == int((4 * elements + headers) * rate)
    # the payload's term: the reference's x2 (its header term as it was)
    assert abs((est(half) - headers * rate) - elements * dtype_bytes * 1.2) <= 1
    assert abs((est(half) - headers * rate) - 2 * (jax_est(half) - headers * rate)) <= 3
    for path in (full, tmp_path / "weights.bin"):
        assert est(path) == jax_est(path)


def _mode_file_cases(tmp_path):
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "w.safetensors").write_bytes(b"x")
    return {
        "example": os.path.join(ROOT, "modes.yaml.example"),
        "engine_test": testing.write_modes_yaml(str(tmp_path / "engine.yaml"), {
            "x": {"model": "ckpt", "description": "d",
                  "loras": [{"file": "l.safetensors", "strength": 0.7}],
                  "defaults": {"size": "512x512", "steps": 4, "guidance": 1.0}},
            "y": {"model": "/abs/path"}}, default_mode="x", model_root=str(tmp_path),
            lora_root="/lr"),
        "every_key": str(tmp_path / "all.yaml"),
    }


ALL_KEYS = """\
model_root: {root}
default_mode: full
modes:
  full:
    model: ckpt
    description: 'every key'
    loras:
    - detail.safetensors
    - {{ file: /abs/style.safetensors, strength: 0.5, name: styled }}
    embeddings:
      - file: vivid.safetensors
      - {{ file: style2.safetensors, name: mystyle }}
    controlnet: {{ path: canny, scale: 0.9 }}
    refiner: sdxl-refiner
    defaults:
      size: "512x512"
      steps: 4
      warmup_buckets: ["768x768:4", "512x768", "bad"]
  cn_as_string:
    model: ckpt
    controlnet: canny
    refiner: {{ file: r, switch_at: 0.7 }}
"""


@pytest.mark.parametrize("case", ["example", "engine_test", "every_key"])
def test_mode_config_matches_jax(tmp_path, case):
    paths = _mode_file_cases(tmp_path)
    (tmp_path / "all.yaml").write_text(ALL_KEYS.format(root=tmp_path))
    path = paths[case]
    port, ref = ModeConfigManager(path), JaxModeConfigManager(path)
    assert port.to_dict() == ref.to_dict()
    assert port.mode_names() == ref.mode_names() and port.default_mode == ref.default_mode
    for name in ref.mode_names():
        p, r = port.get_mode(name), ref.get_mode(name)
        assert (p.default_size(), p.default_steps(), p.default_guidance(),
                p.warmup_buckets()) == (r.default_size(), r.default_steps(),
                                        r.default_guidance(), r.warmup_buckets())
        assert port.has_mode(name)
    assert not port.has_mode("nope")
    with pytest.raises(KeyError):
        port.get_mode("nope")


@pytest.mark.parametrize("text", [None, "modes: {}\n", "default_mode: zz\nmodes:\n  a:\n    model: m\n",
                                  "modes:\n  a:\n    description: no model\n",
                                  "modes:\n  a:\n    model: m\n    controlnet: {scale: 1}\n",
                                  "modes:\n  a:\n    model: m\n    refiner: {switch_at: 0.5}\n",
                                  "modes:\n  a:\n    model: m\n    refiner: {model: r, switch_at: 1.5}\n"],
                         ids=["missing", "no_modes", "bad_default", "no_model", "cn_no_file",
                              "refiner_no_model", "refiner_switch_range"])
def test_mode_config_errors_match_jax(tmp_path, text):
    path = tmp_path / "m.yaml"
    if text is not None:
        path.write_text(text)
    with pytest.raises(JaxModeConfigError) as ref:
        JaxModeConfigManager(str(path))
    with pytest.raises(ModeConfigError) as got:
        ModeConfigManager(str(path))
    assert str(got.value) == str(ref.value)


def test_mode_config_reload_and_module_accessors(tmp_path, monkeypatch):
    path = modes_file(tmp_path / "modes.yaml", modes=("a",))
    m = ModeConfigManager(path)
    modes_file(tmp_path / "modes.yaml", modes=("a", "b"))
    m.reload()
    assert m.has_mode("b")
    monkeypatch.setenv("MODES_CONFIG", path)
    mode_config.reset_mode_config()
    try:
        got = mode_config.get_mode_config()
        assert got is mode_config.get_mode_config() and got.mode_names() == ["a", "b"]
        modes_file(tmp_path / "modes.yaml", modes=("c",))
        mode_config.reload_mode_config()
        assert got.mode_names() == ["c"]
    finally:
        mode_config.reset_mode_config()


def test_yaml_lite_reads_the_modes_layouts_as_safe_load(tmp_path):
    text = ALL_KEYS.format(root=tmp_path) + open(os.path.join(ROOT, "modes.yaml.example")).read(
    ).replace("model_root:", "other_root:").replace("default_mode:", "other_default:").replace(
        "modes:", "more_modes:")
    assert yaml_lite.loads(text) == yaml.safe_load(text)


def test_file_watcher_detects_a_change_and_restarts(tmp_path):
    path = tmp_path / "modes.yaml"
    path.write_text("a: 1\n")
    fired = threading.Event()
    w = file_watcher.start_config_watcher(str(path), fired.set, poll_interval=0.05, debounce=0.0)
    try:
        time.sleep(0.1)
        os.utime(path, (time.time() + 5, time.time() + 5))
        assert fired.wait(2.0)
        w2 = file_watcher.start_config_watcher(str(path), fired.set, poll_interval=0.05)
        assert w2 is not w and w._thread is None  # the old watcher was stopped
    finally:
        file_watcher.stop_config_watcher()
    assert file_watcher._watcher is None


# ---------------------------------------------------------------------------
# the device lock
# ---------------------------------------------------------------------------


def test_device_lock_excludes_captures_from_launch_sections():
    """Shared holders run together, nest, and count as nothing inside the
    thread's own exclusive hold; an exclusive holder waits for every shared
    holder and is never inside one. Stress: 12 threads, a short switch
    interval."""
    lock = DeviceLock()
    state = {"shared": 0, "exclusive": 0, "bad": 0}
    guard = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def reader():
        for _ in range(200):
            with lock.shared(), lock.shared():
                with guard:
                    state["shared"] += 1
                    state["bad"] += state["exclusive"] > 0
                with guard:
                    state["shared"] -= 1

    def writer():
        for _ in range(50):
            with lock.exclusive():
                with guard:
                    state["exclusive"] += 1
                    state["bad"] += state["shared"] > 0 or state["exclusive"] > 1
                with lock.shared():  # inside its own exclusive hold: no wait
                    pass
                with guard:
                    state["exclusive"] -= 1

    try:
        threads = [threading.Thread(target=reader) for _ in range(9)] + [
            threading.Thread(target=writer) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state == {"shared": 0, "exclusive": 0, "bad": 0}
    with lock.shared(), pytest.raises(RuntimeError, match="exclusively"):
        with lock.exclusive():
            pass


def test_quiesced_waits_for_launch_sections_and_holds_off_new_ones():
    """``quiesced()`` (the profiler's start and stop) waits for every launch
    section in flight on any device lock taken so far, and a section that
    starts while it is held waits until it ends; it nests in nothing."""
    lock = device_lock("cpu")
    inside, release, order = threading.Event(), threading.Event(), []

    def section(name, started=None):
        with lock.shared():
            order.append(name)
            if started is not None:
                started.set()
                release.wait(10)

    def quiet():
        with quiesced():
            order.append("quiet")
            time.sleep(0.2)  # a second section meanwhile must wait
            order.append("quiet ends")

    first = threading.Thread(target=section, args=("first", inside))
    first.start()
    assert inside.wait(10)
    q = threading.Thread(target=quiet)
    q.start()
    q.join(0.2)
    assert q.is_alive() and order == ["first"]  # waiting for the section in flight
    release.set()
    first.join(10)
    while "quiet" not in order and q.is_alive():
        time.sleep(0.001)
    second = threading.Thread(target=section, args=("second",))
    second.start()
    for t in (q, second):
        t.join(10)
        assert not t.is_alive()
    assert order == ["first", "quiet", "quiet ends", "second"]
    with lock.shared(), pytest.raises(RuntimeError, match="exclusively"):
        with quiesced():
            pass


# ---------------------------------------------------------------------------
# a tiny real worker behind the pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny SD1.5 bundle and the port's pipeline on the
    same weights (fp32, CPU)."""
    jb = jax_random_bundle("sd15", tiny=True, seed=3)
    return jb, LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")


def real_pool(tmp_path, pipe, log, max_batch):
    cfg = ModeConfigManager(modes_file(tmp_path / "modes.yaml"))
    return WorkerPool(queue_max=16, mode_config=cfg,
                      worker_factory=lambda i, p: RecordingWorker(CudaPipelineWorker(pipe, i), log),
                      registry=ModelRegistry(total_hbm_bytes=1 << 30, device="cpu"),
                      max_batch=max_batch)


class RecordingWorker:
    """A real worker and a log of its dispatches (tests/test_pool_interleaving.py)."""

    def __init__(self, inner, log):
        self.inner, self.log, self.worker_id = inner, log, inner.worker_id

    def batchable(self, a, b):
        return self.inner.batchable(a, b)

    def run_job(self, spec):
        self.log.append(("solo", [spec.seed], time.monotonic()))
        return self.inner.run_job(spec)

    def run_jobs(self, specs):
        self.log.append(("batch", [s.seed for s in specs], time.monotonic()))
        return self.inner.run_jobs(specs)

    def run_job_pipelined(self, spec):
        self.log.append(("dispatch", [spec.seed], time.monotonic()))
        return self.inner.run_job_pipelined(spec)

    def run_jobs_pipelined(self, specs):
        self.log.append(("dispatch", [s.seed for s in specs], time.monotonic()))
        return self.inner.run_jobs_pipelined(specs)

    def close(self):
        pass  # the pipeline is the module's


def _pixels(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def test_pipelined_generate_on_the_cpu_is_ready_at_once(tiny):
    _, pipe = tiny
    kw = dict(height=16, width=16, num_inference_steps=2, seed=4)
    res = pipe.generate("a cat", pipelined=True, **kw)
    assert res.images is not None and res.wait() is res
    np.testing.assert_array_equal(res.images, pipe.generate("a cat", **kw).images)


def test_pool_pngs_equal_run_job_and_the_jax_pool(tmp_path, tiny):
    """Solo requests (pipelined) and a coalesced batch (pipelined run_jobs)
    give run_job's bytes; the pixels are the JAX pool's within +-1."""
    jb, pipe = tiny
    specs = [spec("a cat at sunset", s, size="16x16") for s in (1, 2, 3)]
    serial = [CudaPipelineWorker(pipe).run_job(s) for s in specs]
    log = []
    pool = real_pool(tmp_path, pipe, log, max_batch=4)
    try:
        solo = [pool.submit_job(GenerationJob(s)).result(timeout=60) for s in specs]
        gate, _ = stall(pool)
        futs = [pool.submit_job(GenerationJob(s)) for s in specs]
        gate.set()
        batched = [f.result(timeout=60) for f in futs]
    finally:
        pool.shutdown(drain=False, timeout=2)
    assert solo == serial and batched == serial
    assert ("dispatch", [1, 2, 3]) in [(k, s) for k, s, _ in log]
    jcfg = JaxModeConfigManager(modes_file(tmp_path / "jax.yaml"))
    jpipe = JaxPipeline(jb, dtype=jnp.float32)
    jpool = JaxWorkerPool(queue_max=8, worker_factory=lambda i, p: TPUPipelineWorker(jpipe, i),
                          mode_config=jcfg, registry=JaxRegistry(total_hbm_bytes=1 << 30))
    try:
        from dreamlab_tpu.engine.base import GenSpec as JaxSpec
        from dreamlab_tpu.engine.worker_pool import GenerationJob as JaxJob

        want = [jpool.submit_job(JaxJob(JaxSpec(prompt=s.prompt, size=s.size,
                                                num_inference_steps=2, seed=s.seed))
                                 ).result(timeout=120) for s in specs]
    finally:
        jpool.shutdown(drain=False, timeout=2)
    for (png, seed), (jpng, jseed) in zip(serial, want):
        assert seed == jseed
        diff = np.abs(_pixels(png).astype(np.int16) - _pixels(jpng).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_pipelined_overlap_settles_fifo(tmp_path, tiny):
    """Two back-to-back batches: the second dispatches before the first
    settles, yet futures resolve in FIFO order (the JAX pool's timing
    assertion, tests/test_pool_interleaving.py)."""
    _, pipe = tiny
    log, completion = [], []
    pool = real_pool(tmp_path, pipe, log, max_batch=2)
    try:
        gate, _ = stall(pool)
        futs = []
        for label, seed in (("e1", 31), ("e2", 32), ("f1", 33)):
            fut = pool.submit_job(GenerationJob(spec("a cat", seed, size="16x16")))
            fut.add_done_callback(lambda f, label=label: completion.append(
                (label, time.monotonic())))
            futs.append(fut)
        gate.set()
        for f in futs:
            f.result(timeout=60)
    finally:
        pool.shutdown(drain=False, timeout=2)
    assert [label for label, _ in completion] == ["e1", "e2", "f1"]
    assert [(k, s) for k, s, _ in log if k == "dispatch"] == [("dispatch", [31, 32]),
                                                             ("dispatch", [33])]
    t_f1_dispatch = next(t for k, s, t in log if k == "dispatch" and s == [33])
    assert t_f1_dispatch < next(t for label, t in completion if label == "e1")


def test_window_cancel_switch_interleaving(tmp_path, tiny):
    """A coalescable trio with its middle row cancelled, a switch behind it
    and a request behind the switch: FIFO, no lost futures, the cancelled
    row never runs, the survivors coalesce and equal their solo runs."""
    _, pipe = tiny
    refs = {s: CudaPipelineWorker(pipe).run_job(spec("a cat", s, size="16x16")) for s in (21, 23)}
    log, completion = [], []
    pool = real_pool(tmp_path, pipe, log, max_batch=4)

    def track(label, fut):
        fut.add_done_callback(lambda f: completion.append(label))
        return fut

    try:
        gate, fut_block = stall(pool)
        f1, f2, f3 = (pool.submit_job(GenerationJob(spec("a cat", s, size="16x16")))
                      for s in (21, 22, 23))
        track("b1", f1)
        track("b3", f3)
        assert f2.cancel()
        fut_switch = track("switch", pool.switch_mode("beta"))
        f4 = track("tail", pool.submit_job(GenerationJob(spec("a cat", 24, size="16x16"))))
        gate.set()
        assert (f1.result(timeout=60), f3.result(timeout=60)) == (refs[21], refs[23])
        assert fut_switch.result(timeout=60) == "beta" and f4.result(timeout=60)
        assert fut_block.result(timeout=1) == "unblocked"
    finally:
        pool.shutdown(drain=False, timeout=2)
    assert 22 not in [s for _, seeds, _ in log for s in seeds]
    assert ("dispatch", [21, 23]) in [(k, s) for k, s, _ in log]
    assert completion.index("b1") < completion.index("switch") < completion.index("tail")
    assert completion.index("b3") < completion.index("switch")
    assert pool.current_mode is None  # shut down: every worker unloaded


def test_pipelined_requests_of_different_styles_equal_their_serial_runs(tmp_path):
    """Style A's request is still in flight when style B's is dispatched:
    each PNG equals its serial run (the restore and the next merge queue
    behind the replay that reads the merged leaves)."""
    pipe = LCMPipeline(testing.random_bundle(tiny=True, seed=1), dtype=torch.float32,
                       device="cpu")
    styles = {}
    for name, seed in (("A", 11), ("B", 12)):
        path = str(tmp_path / f"{name}.safetensors")
        save_file(testing.random_lora(pipe.unet_params, rank=4, seed=seed), path)
        styles[name] = lora.StyleDef(name=name, path=path, strengths=(4.0,))
    worker = CudaPipelineWorker(pipe, styles=styles)
    specs = [spec("a cat", 5, size="16x16", style=s, style_level=1) for s in ("A", "B")]
    specs.append(spec("a cat", 5, size="16x16"))
    serial = [worker.run_job(s) for s in specs]
    assert len({png for png, _ in serial}) == 3  # each style changes the image
    finals = [worker.run_job_pipelined(s) for s in specs]
    assert [f() for f in finals] == serial
    batch = [spec("a dog", 7, size="16x16", style="B", style_level=1),
             spec("a cat", 8, size="16x16", style="B", style_level=1)]
    fin_batch = worker.run_jobs_pipelined(batch)
    fin_solo = worker.run_job_pipelined(specs[0])
    assert fin_batch() == [worker.run_job(s) for s in batch] and fin_solo() == serial[0]


def test_dispose_releases_the_graphs_and_unregisters(tmp_path, tiny):
    _, pipe = tiny
    pipe.warmup(16, 16, steps=2)
    cfg = ModeConfigManager(modes_file(tmp_path / "modes.yaml"))
    reg = ModelRegistry(total_hbm_bytes=1 << 30, device="cpu")
    pool = WorkerPool(queue_max=4, worker_factory=lambda i, p: CudaPipelineWorker(pipe, i),
                      mode_config=cfg, registry=reg)
    worker = pool.worker
    pool.switch_mode("beta").result(timeout=30)
    assert worker.pipeline is None and pipe._compiled == {} and reg.get_model("alpha") is None
    pool.shutdown(drain=False, timeout=2)


def test_the_default_factory_serves_on_the_card(tmp_path, monkeypatch):
    """Without a factory the pool builds ``create_cuda_worker`` workers,
    which refuse to run on the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModeConfigManager(modes_file(tmp_path / "modes.yaml"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorkerPool(mode_config=cfg, registry=ModelRegistry(device="cpu"))
