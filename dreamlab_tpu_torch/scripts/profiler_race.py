"""torch.profiler stopped beside a CUDA graph replay on another thread.

A worker thread replays a captured graph in a loop, each replay inside the
device lock's shared hold and its waits on the host outside it, as the
pipeline's launch sections are written. The main thread meanwhile starts a
torch.profiler trace (CPU and CUDA activities), lets it run for
``--window`` seconds and stops it, over and over for ``--seconds`` seconds:

- default: each start and stop under ``pipeline.quiesced()``, as the server's
  profiler routes and ``chip_smoke.py`` call them;
- ``--unlocked``: bare, as they called them before.

A trace cycle that takes longer than ``--hang-s`` is a hang: faulthandler,
which needs no GIL, writes every thread's stack to stderr and the process
exits 1. Otherwise the last line is a JSON object with the cycles run.
Needs one CUDA device:

    python -m dreamlab_tpu_torch.scripts.profiler_race [--unlocked] [--seconds 120]
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import sys
import threading
import time

import torch

from ..pipeline import device_lock, quiesced
from .timing import require_cuda


def _graph(device, width: int = 2048, layers: int = 8):
    """A captured chain of ``layers`` bf16 matmuls and its output."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((width, width), device=device, generator=g).to(torch.bfloat16)
    w = torch.randn((width, width), device=device, generator=g).to(torch.bfloat16) / width ** 0.5
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):  # warm-up outside the capture, as the pipeline does
        y = x
        for _ in range(layers):
            y = y @ w
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x
        for _ in range(layers):
            y = y @ w
    return graph, y


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unlocked", action="store_true",
                    help="start and stop the profiler without pipeline.quiesced()")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--window", type=float, default=0.05)
    ap.add_argument("--hang-s", type=float, default=60.0)
    args = ap.parse_args(argv)
    require_cuda("profiler_race")
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", torch.cuda.current_device())
    lock = device_lock(device)
    graph, out = _graph(device)
    stop = threading.Event()
    replays = [0]

    def replayer():
        done = torch.cuda.Event()
        while not stop.is_set():
            with lock.shared():
                graph.replay()  # blocks in the driver once its launch queue is full
                done.record()
            replays[0] += 1
            if replays[0] % 64 == 0:
                done.synchronize()  # a wait on the host, outside the lock

    guard = (contextlib.nullcontext if args.unlocked else quiesced)
    thread = threading.Thread(target=replayer, name="replayer", daemon=True)
    thread.start()
    cycles, t_start = 0, time.perf_counter()
    try:
        while time.perf_counter() - t_start < args.seconds:
            faulthandler.dump_traceback_later(args.hang_s, exit=True, file=sys.stderr)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with guard():
                prof.start()
            time.sleep(args.window)
            with guard():
                prof.stop()
            faulthandler.cancel_dump_traceback_later()
            cycles += 1
    finally:
        stop.set()
        thread.join()
    torch.cuda.synchronize()
    result = {"unlocked": args.unlocked, "cycles": cycles, "replays": replays[0],
              "seconds": time.perf_counter() - t_start, "hung": False,
              "finite": bool(torch.isfinite(out).all())}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
