"""The port's span recorder (``dreamlab_tpu_torch/utils/tracing.py``) and the
spans the serving path records with it, on the CPU.

The recorder: spans nest with the right parent on each thread and in each
asyncio task, ``record`` works across threads, and the ring stays bounded. A
``WorkerPool`` over a tiny ``CudaPipelineWorker`` serving one coalesced
group and one solo job: one ``pool.queued`` a job, one ``pool.dispatch`` a
call with its rows and a ``pipeline.stage`` inside, a ``pool.settle`` that
holds one ``png.encode`` a row, ``overlapped`` only where a later dispatch
came first, and counters that agree with the spans; an encode's deflate
bands on its span and in the ``png.bands`` and ``png.banded`` counters. A ``/generate`` through
``create_app``: its ``http.request`` holds an ``http.await`` of the pool's
job, and ``GET /api/trace`` returns the counters and Chrome trace events.
The profiler's start, stop and export run on one thread off the event
loop, with or without Kineto's every-thread setting: the server answers
meanwhile.
"""

import asyncio
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dreamlab_tpu_torch import testing
from dreamlab_tpu_torch.engine import cuda_worker
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.mode_config import ModeConfigManager
from dreamlab_tpu_torch.engine.model_registry import ModelRegistry
from dreamlab_tpu_torch.engine.worker_pool import CustomJob, GenerationJob, WorkerPool
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.serving import app as tapp
from dreamlab_tpu_torch.serving import model_routes
from dreamlab_tpu_torch.serving.http import ServerThread
from dreamlab_tpu_torch.utils import png, tracing
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401

TIMEOUT = 120


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts from an empty recorder."""
    tracing.reset()
    yield
    tracing.annotate(False)


def named(spans, name):
    return [s for s in spans if s["name"] == name]


def children(spans, parent, name=None):
    return [s for s in spans if s["parent"] == parent["id"] and name in (None, s["name"])]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_spans_nest_with_their_parent_on_each_thread():
    barrier = threading.Barrier(2)

    def body(tag):
        with tracing.span(f"outer.{tag}") as outer:
            barrier.wait()  # both outer spans open at once
            with tracing.span(f"inner.{tag}", tag=tag) as inner:
                inner.attrs["rows"] = 3
                barrier.wait()
            assert tracing.current() is outer

    threads = [threading.Thread(target=body, args=(t,), name=f"t{t}") for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    spans = tracing.spans()
    assert len(spans) == 4
    for tag in "ab":
        (outer,) = named(spans, f"outer.{tag}")
        (inner,) = named(spans, f"inner.{tag}")
        assert outer["parent"] is None and inner["parent"] == outer["id"]
        assert inner["attrs"] == {"tag": tag, "rows": 3}
        assert inner["thread"] == outer["thread"] == f"t{tag}"
        assert outer["t0"] <= inner["t0"] <= inner["t1"] <= outer["t1"]
    assert tracing.current() is None  # outside any span


def test_spans_nest_per_asyncio_task_on_one_loop():
    async def request(tag, ready, go):
        with tracing.span("outer", tag=tag):
            ready.set()
            await go.wait()  # the other task opens and closes its spans meanwhile
            with tracing.span("inner", tag=tag):
                await asyncio.sleep(0)

    async def main():
        go = asyncio.Event()
        ready = [asyncio.Event(), asyncio.Event()]
        tasks = [asyncio.ensure_future(request(t, r, go)) for t, r in zip("ab", ready)]
        for r in ready:
            await r.wait()
        go.set()
        await asyncio.gather(*tasks)

    asyncio.run(main())
    spans = tracing.spans()
    for tag in "ab":
        (outer,) = [s for s in named(spans, "outer") if s["attrs"]["tag"] == tag]
        (inner,) = [s for s in named(spans, "inner") if s["attrs"]["tag"] == tag]
        assert inner["parent"] == outer["id"]


def test_record_spans_threads_and_start_backdates():
    t0 = tracing.now()
    done = threading.Event()

    def other():
        tracing.record("pool.queued", t0, tracing.now(), job="j1")
        done.set()

    threading.Thread(target=other, name="taker").start()
    assert done.wait(TIMEOUT)
    (q,) = named(tracing.spans(), "pool.queued")
    assert q["t0"] == t0 / 1e9 and q["t1"] >= q["t0"]
    assert q["thread"] == "taker" and q["parent"] is None and q["attrs"] == {"job": "j1"}
    early = tracing.now()
    time.sleep(0.01)
    with tracing.span("late", start=early) as s:
        pass
    assert s.t0 == early and s.ms() >= 10.0
    tracing.record("dropped", None, tracing.now())  # no start: nothing recorded
    assert [x["name"] for x in tracing.spans()] == ["pool.queued", "late"]


def test_the_ring_stays_bounded():
    for i in range(tracing.CAPACITY + 10):
        tracing.record("x", i, i + 1, i=i)
    spans = tracing.spans()
    assert len(spans) == tracing.CAPACITY
    assert spans[0]["attrs"]["i"] == 10 and spans[-1]["attrs"]["i"] == tracing.CAPACITY + 9
    assert [s["attrs"]["i"] for s in tracing.spans(3)] == [tracing.CAPACITY + i for i in (7, 8, 9)]
    assert tracing.spans(0) == []


def test_chrome_events():
    with tracing.span("pool.dispatch", jobs=["a", "b"], rows=2, bucket=(1, 4, 4, None)):
        with tracing.span("pipeline.stage"):
            pass
    events = tracing.chrome_events()
    assert [e["name"] for e in events] == ["pipeline.stage", "pool.dispatch"]
    stage, dispatch = events
    for e in events:
        assert e["ph"] == "X" and e["pid"] == os.getpid() and isinstance(e["tid"], int)
        assert e["dur"] >= 0 and e["ts"] > 0
    assert stage["args"]["parent"] == dispatch["args"]["id"]
    assert dispatch["args"]["bucket"] == [1, 4, 4, None]
    assert dispatch["args"]["jobs"] == ["a", "b"]
    json.dumps(events)
    assert stage["ts"] >= dispatch["ts"]
    assert stage["ts"] + stage["dur"] <= dispatch["ts"] + dispatch["dur"] + 1e-3


# ---------------------------------------------------------------------------
# the pool, the worker and the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipe():
    return LCMPipeline(testing.random_bundle(tiny=True), dtype=torch.float32, device="cpu")


def make_pool(pipe, tmp):
    path = testing.write_modes_yaml(os.path.join(tmp, "modes.yaml"), {"tiny": {"model": "a"}},
                                    default_mode="tiny", model_root=str(tmp))
    mc = ModeConfigManager(path)
    reg = ModelRegistry(total_hbm_bytes=16 << 30, device="cpu")
    pool = WorkerPool(queue_max=8, worker_factory=lambda i, p: CudaPipelineWorker(pipe, i),
                      mode_config=mc, registry=reg)
    return pool, mc, reg


def test_pool_spans_of_a_coalesced_group_and_a_solo_job(pipe, tmp_path):
    pool, _, _ = make_pool(pipe, tmp_path)
    try:
        tracing.reset()
        gate, entered = threading.Event(), threading.Event()
        park = CustomJob(lambda _w: (entered.set(), gate.wait(TIMEOUT)))
        pool.submit_job(park)
        assert entered.wait(TIMEOUT)
        group = [GenerationJob(GenSpec(prompt="a cat", size="32x32", num_inference_steps=1,
                                       seed=s)) for s in (1, 2, 3)]
        solo = GenerationJob(GenSpec(prompt="a dog", size="16x16", num_inference_steps=1,
                                     seed=4))
        for job in group + [solo]:
            pool.submit_job(job)
        gate.set()
        for job in group + [solo]:
            job.future.result(TIMEOUT)
    finally:
        pool.shutdown(drain=False, timeout=1)
    spans = tracing.spans()
    jobs = [park] + group + [solo]
    queued = named(spans, "pool.queued")
    assert sorted(s["attrs"]["job"] for s in queued) == sorted(j.job_id for j in jobs)

    dispatches = sorted(named(spans, "pool.dispatch"), key=lambda s: s["t0"])
    assert [d["attrs"]["jobs"] for d in dispatches] == [[j.job_id for j in group],
                                                        [solo.job_id]]
    assert [d["attrs"]["rows"] for d in dispatches] == [3, 1]
    for d in dispatches:
        (stage,) = children(spans, d, "pipeline.stage")
        assert stage["attrs"]["bucket"][0] == d["attrs"]["rows"]
        assert d["t0"] <= stage["t0"] <= stage["t1"] <= d["t1"]
    assert len(children(spans, dispatches[0], "worker.noise")) == 1

    settles = sorted(named(spans, "pool.settle"), key=lambda s: s["t0"])
    assert [s["attrs"]["jobs"] for s in settles] == [d["attrs"]["jobs"] for d in dispatches]
    for s in settles:
        encodes = children(spans, s, "png.encode")
        assert len(encodes) == s["attrs"]["rows"]
        assert all(e["attrs"]["bytes"] > 0 for e in encodes)
    # the group settled after the solo job's dispatch went out; the solo
    # job, with nothing after it, alone
    assert [s["attrs"]["overlapped"] for s in settles] == [True, False]
    assert settles[0]["t0"] >= dispatches[1]["t1"]
    assert len(named(spans, "pool.collect")) == 2

    counts = tracing.counters()
    assert counts["pool.jobs"] == len(queued) == 5
    assert counts["pool.dispatches"] == len(dispatches)
    assert counts["pool.rows"] == sum(d["attrs"]["rows"] for d in dispatches)
    assert "pool.rejected_full" not in counts and "pool.cancelled" not in counts


@pytest.mark.parametrize("side", [512, 16])
def test_png_encode_records_its_bands(side):
    image = np.random.RandomState(side).randint(0, 256, (side, side, 3), np.uint8)
    cuda_worker._png(image)  # counters from an earlier encode
    before = tracing.counters()
    data = cuda_worker._png(image, {"parameters": "x"})
    after = tracing.counters()
    (encode,) = tracing.spans(1)
    assert encode["name"] == "png.encode" and encode["attrs"]["bytes"] == len(data)
    n = encode["attrs"]["bands"]
    assert n == png.bands(image.shape)
    assert (n > 1) == (side == 512)
    assert after["png.bands"] == before["png.bands"] + n
    assert after.get("png.banded", 0) == before.get("png.banded", 0) + (side == 512)


def test_pool_counts_rejected_and_cancelled_jobs(pipe, tmp_path):
    pool, _, _ = make_pool(pipe, tmp_path)
    try:
        tracing.reset()
        gate, entered = threading.Event(), threading.Event()
        pool.submit_job(CustomJob(lambda _w: (entered.set(), gate.wait(TIMEOUT))))
        assert entered.wait(TIMEOUT)
        waiting = [GenerationJob(GenSpec(prompt="x", size="16x16", num_inference_steps=1,
                                         seed=s)) for s in range(8)]
        for job in waiting:
            pool.submit_job(job)
        with pytest.raises(Exception, match="queue full"):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", size="16x16", seed=9)))
        for job in waiting[:2]:
            assert job.future.cancel()
        gate.set()
        for job in waiting[2:]:
            job.future.result(TIMEOUT)
    finally:
        pool.shutdown(drain=False, timeout=1)
    counts = tracing.counters()
    assert counts["pool.rejected_full"] == 1 and counts["pool.cancelled"] == 2
    assert counts["pool.jobs"] == 9 == len(named(tracing.spans(), "pool.queued"))
    assert counts["pool.rows"] == 6


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(pipe, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing")
    pool, mc, reg = make_pool(pipe, tmp)
    app = tapp.create_app(tapp.ServerConfig(default_size="32x32", default_steps=1,
                                            request_timeout=60),
                          pool=pool, sr=None, storage=None, mode_config=mc, registry=reg,
                          skip_startup=True, device="cpu")
    srv = ServerThread(app).start()
    yield srv
    srv.stop()
    pool.shutdown(drain=False, timeout=1)


def call(conn, method, path, body=None):
    headers = {"Content-Type": "application/json"} if body is not None else {}
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers=headers)
    r = conn.getresponse()
    return r.status, r.read()


def test_generate_spans_and_the_trace_route(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    status, png = call(conn, "POST", "/generate", {"prompt": "a cat", "size": "32x32",
                                                  "num_inference_steps": 1, "seed": 5})
    assert status == 200 and png[:4] == b"\x89PNG"
    # the same connection: the request's span closed before the next is read
    status, body = call(conn, "GET", "/api/trace?n=100000")
    conn.close()
    assert status == 200
    out = json.loads(body)
    assert set(out) == {"counters", "spans"}
    assert out["counters"]["pool.jobs"] >= 1 and out["counters"]["pool.dispatches"] >= 1
    spans = tracing.spans()
    (req,) = [s for s in named(spans, "http.request") if s["attrs"]["path"] == "/generate"]
    assert req["attrs"]["status"] == 200 and req["thread"] == "http-server"
    (waited,) = children(spans, req, "http.await")
    job = waited["attrs"]["job"]
    assert req["attrs"]["job"] == job
    assert req["t0"] <= waited["t0"] <= waited["t1"] <= req["t1"]
    assert [q["attrs"]["job"] for q in named(spans, "pool.queued")] == [job]
    (dispatch,) = named(spans, "pool.dispatch")
    assert dispatch["attrs"]["jobs"] == [job]
    (settle,) = named(spans, "pool.settle")
    assert waited["t0"] <= dispatch["t0"] <= settle["t1"] <= waited["t1"]

    events = {e["args"]["id"]: e for e in out["spans"]}
    for s in spans:
        if s["name"] in ("http.await", "pool.dispatch", "png.encode"):
            e = events[s["id"]]
            assert e["name"] == s["name"] and e["ph"] == "X"
            assert e["ts"] == pytest.approx(s["t0"] * 1e6) and e["dur"] >= 0
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    status, body = call(conn, "GET", "/api/trace?n=2")
    assert status == 200 and len(json.loads(body)["spans"]) == 2
    assert call(conn, "GET", "/api/trace?n=-1")[0] == 400
    assert call(conn, "GET", "/api/trace?n=many")[0] == 400
    conn.close()


class _SlowStop:
    """A profiler whose stop waits for a gate."""

    def __init__(self, prof):
        self.prof = prof
        self.entered, self.gate = threading.Event(), threading.Event()

    def stop(self):
        self.entered.set()
        assert self.gate.wait(TIMEOUT)
        self.prof.stop()

    def export_chrome_trace(self, path):
        self.prof.export_chrome_trace(path)


def test_a_profiler_stop_leaves_the_server_answering(server, tmp_path):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    status, body = call(conn, "POST", "/api/profiler/start", {"dir": str(tmp_path / "t")})
    assert status == 200
    slow = _SlowStop(model_routes._PROFILE["prof"])
    model_routes._PROFILE["prof"] = slow
    result = {}
    stopper = threading.Thread(target=lambda: result.update(
        stop=call(http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT),
                  "POST", "/api/profiler/stop")))
    stopper.start()
    try:
        assert slow.entered.wait(TIMEOUT)
        # the stop is held: other requests are answered meanwhile
        assert call(conn, "GET", "/health")[0] == 200
        status, body = call(conn, "POST", "/api/profiler/stop")
        assert status == 409 and json.loads(body)["detail"] == "trace start or stop in progress"
        assert call(conn, "POST", "/api/profiler/start", {})[0] == 409
    finally:
        slow.gate.set()
        stopper.join(TIMEOUT)
    status, body = result["stop"]
    assert status == 200 and json.loads(body)["status"] == "stopped"
    assert os.path.exists(tmp_path / "t" / "trace.json")
    assert call(conn, "POST", "/api/profiler/stop")[0] == 409
    conn.close()


class _FakeProfile:
    """A profiler that notes the thread of each call and writes an empty trace."""

    made = []

    def __init__(self, activities, experimental_config=None):
        self.config, self.threads = experimental_config, {}
        _FakeProfile.made.append(self)

    def _note(self, what):
        self.threads[what] = threading.current_thread().name

    def start(self):
        self._note("start")

    def stop(self):
        self._note("stop")

    def export_chrome_trace(self, path):
        self._note("export")
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.mark.parametrize("every_thread", [True, False], ids=["all_threads", "without"])
def test_the_profiler_starts_and_stops_on_one_thread(server, tmp_path, monkeypatch,
                                                     every_thread):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    if not every_thread:
        monkeypatch.setattr(model_routes, "_all_threads", lambda: None)
    _FakeProfile.made.clear()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    assert call(conn, "POST", "/api/profiler/start", {"dir": str(tmp_path / "t")})[0] == 200
    assert call(conn, "POST", "/generate", {"prompt": "a cat", "size": "32x32",
                                            "num_inference_steps": 1, "seed": 6})[0] == 200
    status, body = call(conn, "POST", "/api/profiler/stop")
    conn.close()
    assert status == 200 and json.loads(body)["dir"] == str(tmp_path / "t")
    (prof,) = _FakeProfile.made
    assert (prof.config is None) == (not every_thread)
    assert set(prof.threads) == {"start", "stop", "export"}
    assert len(set(prof.threads.values())) == 1
    assert prof.threads["start"].startswith("profiler")
    timed = [s for s in tracing.spans() if s["name"].startswith("profiler.")]
    assert [s["name"] for s in timed] == ["profiler.start", "profiler.stop", "profiler.export"]
    assert {s["thread"] for s in timed} == {prof.threads["start"]}


def test_a_profiler_without_every_thread_still_stops(server, tmp_path, monkeypatch):
    """Without Kineto's every-thread setting the profiler records its own
    thread's operators; its stop, on the thread that started it, answers 200
    and writes a trace the first time."""
    monkeypatch.setattr(model_routes, "_all_threads", lambda: None)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    assert call(conn, "POST", "/api/profiler/start", {"dir": str(tmp_path / "t")})[0] == 200
    assert call(conn, "POST", "/generate", {"prompt": "a cat", "size": "32x32",
                                            "num_inference_steps": 1, "seed": 7})[0] == 200
    status, body = call(conn, "POST", "/api/profiler/stop")
    assert status == 200 and json.loads(body)["status"] == "stopped"
    with open(tmp_path / "t" / "trace.json") as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    assert call(conn, "POST", "/api/profiler/stop")[0] == 409
    conn.close()
