#!/usr/bin/env python3
"""The operator's profiler routes on a served cell: ``POST /api/profiler/start``,
``/generate`` traffic, ``POST /api/profiler/stop``, over and over, while
``/health`` is asked every 10 ms.

    python3 port_bench/profiler_route.py --workload sd15-512-serial --seed 4294967311

From the root of a checkout, on a card. It builds the cell's server as
``run.py`` does (``system.build``), keeps ``--callers`` closed-loop callers
of the cell's size and steps busy, and runs ``--rounds`` traces of
``--traced`` seconds each, and with ``--without`` one more as if this torch
lacked Kineto's every-thread setting (``model_routes._all_threads`` gives
None). For each round it prints one JSON object: the start's and the
stop's seconds and statuses, the route's own spans of the profiler's start,
stop and export, ``/health``'s latencies while the stop ran,
the images served meanwhile, and the trace's recorder ranges by name and
thread (the pool thread's own id beside them) and its kernel events. The
traces are written under a temporary directory and removed.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import program_spans, run as harness, system  # noqa: E402

SPAN_NAMES = ("http.request", "http.await", "pool.collect", "pool.dispatch", "pool.settle",
              "pipeline.stage", "graph.replay", "device.wait", "png.encode", "worker.noise")


def post(port: int, path: str, body: dict, timeout: float = 600.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


class Callers:
    """Closed-loop ``/generate`` callers; each answer's end time and status."""

    def __init__(self, port: int, mix: dict, n: int):
        self.port, self.mix = port, mix
        self.done = []  # (monotonic end, status)
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._loop, args=(i,), daemon=True)
                        for i in range(n)]
        for t in self.threads:
            t.start()

    def _loop(self, i: int) -> None:
        seed = 1000 * i
        while not self.stop.is_set():
            seed += 1
            try:
                status, _ = post(self.port, "/generate",
                                 {"prompt": "a lighthouse", "size": self.mix["size"],
                                  "num_inference_steps": self.mix["steps"], "seed": seed})
            except OSError:
                status = 0
            self.done.append((time.monotonic(), status))

    def close(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(600)


def health_during(port: int, stopped: threading.Event) -> list:
    """``/health``'s latencies (ms), one asked every 10 ms until ``stopped``."""
    out = []
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    while not stopped.is_set():
        t = time.perf_counter()
        conn.request("GET", "/health")
        conn.getresponse().read()
        out.append(1e3 * (time.perf_counter() - t))
        time.sleep(0.01)
    conn.close()
    return out


def ranges(path: str, pool_tid: int) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by = collections.defaultdict(collections.Counter)
    kernels = 0
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in SPAN_NAMES:
            by[e["name"]]["pool" if e.get("tid") == pool_tid else str(e.get("tid"))] += 1
        elif e.get("cat") == "kernel":
            kernels += 1
    return {"ranges": {k: dict(v) for k, v in sorted(by.items())}, "kernel_events": kernels,
            "trace_mb": os.path.getsize(path) / 2 ** 20}


def trace_rounds(port: int, callers: Callers, pool_tid: int, rounds: list, traced: float,
                 tmp: str):
    """One JSON-ready dict a round; ``rounds`` says, for each, whether it
    runs without Kineto's every-thread setting."""
    from dreamlab_tpu_torch.serving import model_routes

    every = model_routes._all_threads
    try:
        for i, without in enumerate(rounds):
            model_routes._all_threads = (lambda: None) if without else every
            out = {"round": i, "without_all_threads": without}
            trace_dir = os.path.join(tmp, str(i))
            t = out_t0 = time.monotonic()
            status, _ = post(port, "/api/profiler/start", {"dir": trace_dir})
            out.update(start_status=status, start_s=time.monotonic() - t)
            time.sleep(traced)
            stopped = threading.Event()
            health = []
            poller = threading.Thread(target=lambda: health.extend(health_during(port, stopped)))
            poller.start()
            t = time.monotonic()
            status, body = post(port, "/api/profiler/stop", {})
            t1 = time.monotonic()
            stopped.set()
            poller.join(60)
            health.sort()
            out.update(stop_status=status, stop_s=t1 - t, health_n=len(health),
                       health_p50_ms=health[len(health) // 2] if health else None,
                       health_max_ms=health[-1] if health else None,
                       images_during_stop=sum(1 for e, s in list(callers.done)
                                              if t < e < t1 and s == 200))
            for span in program_spans.recorded():
                if span["name"].startswith("profiler.") and span["t0"] >= out_t0:
                    out[span["name"][len("profiler."):] + "_span_s"] = span["t1"] - span["t0"]
            if status == 200:
                out.update(ranges(os.path.join(trace_dir, "trace.json"), pool_tid))
            else:
                out["stop_body"] = body[:500].decode(errors="replace")
            yield out
            time.sleep(1.0)
    finally:
        model_routes._all_threads = every


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--callers", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--traced", type=float, default=2.0)
    ap.add_argument("--without", action="store_true",
                    help="run one more round without Kineto's every-thread setting")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = harness.load_cell(root, args.workload)
    harness.set_caches(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    system.import_program()

    mix = cell["mix"]
    built = system.build(cell["config"], mix, args.seed, "cuda")
    harness.warm_request(built.port, mix)
    pool_tid = next(t.native_id for t in threading.enumerate() if t.name == "worker-pool")
    callers = Callers(built.port, mix, args.callers)
    rounds = [False] * args.rounds + ([True] if args.without else [])
    try:
        time.sleep(2.0)
        with tempfile.TemporaryDirectory(prefix="profiler_route_") as tmp:
            for out in trace_rounds(built.port, callers, pool_tid, rounds, args.traced, tmp):
                print(json.dumps(out), flush=True)
    finally:
        callers.close()
        built.close()
    failed = sum(1 for _, s in callers.done if s != 200)
    print(json.dumps({"images": len(callers.done) - failed, "failed": failed}), flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
