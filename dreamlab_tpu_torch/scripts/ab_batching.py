"""A/B: a bucket's library calls one row at a time against batched, on the card.

Every call that goes through ``ops/batching.py::row_chunks`` (convs, linears,
the plain GroupNorm, the plain attention, CLIP's attention) is recorded in
one eager run of SD1.5's program at 512x512 and batch ``--batch`` (random
weights at the published widths, 4 LCM steps): its key, its inputs' shapes
and how often the program calls it. Then, per distinct call on its recorded
inputs:

- whether the call over chunks of 8, 4 and 2 rows gives every row the bytes
  of that row's solo call;
- its device time one row at a time (``per_row``: the solo calls and the
  concatenation) and over each chunk size, each in a CUDA graph of its own
  (``scripts/timing.py::device_ms``).

``--buckets 2 .. 8`` then captures each of those buckets twice, once with
every call one row at a time and once as ``row_chunks`` decides, and gives
each warm-up's seconds, each replay's device time and the ``batching.*``
counters of the second capture; then whether each row of the largest batch's
replay equals its solo replay's bytes (PNGs through the worker). Prints a
JSON line per call, per bucket and of the totals, and writes the calls' and
the totals' lines to ``--out`` too. Run on the card:
``python -m dreamlab_tpu_torch.scripts.ab_batching [--buckets 2 3 4 5 6 7 8]``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
from typing import Dict, List

import torch

from dreamlab_tpu_torch.ops import batching
from dreamlab_tpu_torch.scripts.timing import device_ms, require_cuda
from dreamlab_tpu_torch.utils import tracing

PROMPT = "a photo of a cat on a sofa"


@dataclasses.dataclass
class Site:
    """One distinct library call of a program: its key, its recorded
    function and inputs (the first call's), and how often the program made it."""

    key: tuple
    fn: object
    xs: List[torch.Tensor]
    calls: int = 0


def _copy(x: torch.Tensor) -> torch.Tensor:
    """A copy with ``x``'s strides (a packed projection's view keeps its own)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)


@contextlib.contextmanager
def record_sites(sites: Dict[tuple, Site]):
    """Record every ``row_chunks`` call at a batch above 1 into ``sites``
    (keyed like ``row_chunks``' decisions) and pass it on to ``row_chunks``."""
    real = batching.row_chunks

    def recorder(key, fn, *xs, **kw):
        if xs[0].shape[0] > 1:
            full = batching.signature(key, xs)
            site = sites.get(full)
            if site is None:
                site = sites[full] = Site(key, fn, [_copy(x) for x in xs])
            site.calls += 1
        return real(key, fn, *xs, **kw)

    users = [m for name, m in sys.modules.items()
             if name.startswith("dreamlab_tpu_torch.") and getattr(m, "row_chunks", None) is real]
    for m in users:
        m.row_chunks = recorder
    try:
        yield sites
    finally:
        for m in users:
            m.row_chunks = real


def chunked(fn, xs, rows: int):
    """``fn`` over chunks of ``rows`` rows, concatenated (``rows`` 1: ``per_row``)."""
    b = xs[0].shape[0]
    if rows == b:
        return fn(*xs)
    if rows == 1:
        return batching.per_row(fn, *xs)
    return torch.cat([fn(*(x[i:i + rows] for x in xs)) for i in range(0, b, rows)])


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of ``fn`` replayed from a CUDA graph of its own."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = device_ms(graph.replay, iters, warmup_s=0.05)
    del graph
    return ms


def survey(sites: Dict[tuple, Site], batch: int) -> List[dict]:
    """Per distinct call: equality of each chunk size's rows to the solo
    calls, and device ms one row at a time and at each chunk size."""
    sizes = [batch]
    while sizes[-1] > 2 and sizes[-1] % 2 == 0:
        sizes.append(sizes[-1] // 2)
    rows = []
    for full, site in sites.items():
        solo = batching.per_row(site.fn, *site.xs)
        row = {"kind": site.key[0], "key": repr(site.key),
               "inputs": [list(x.shape) for x in site.xs], "calls": site.calls,
               "ms": {"1": graph_ms(lambda: batching.per_row(site.fn, *site.xs))}, "equal": {}}
        for c in sizes:
            out = chunked(site.fn, site.xs, c)
            row["equal"][str(c)] = batching.same_bytes(out, solo)
            row["ms"][str(c)] = graph_ms(lambda c=c: chunked(site.fn, site.xs, c))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def totals(rows: List[dict], batch: int) -> dict:
    """Per call kind: the program's ms one row at a time, ms batched at the
    calls whose batch-``batch`` rows equal the solo calls, and the ms those
    calls would save; with chunks, at the largest equal chunk size."""
    out: Dict[str, dict] = {}
    for r in rows:
        t = out.setdefault(r["kind"], {"sites": 0, "calls": 0, "per_row_ms": 0.0,
                                       "equal_sites": 0, "save_full_ms": 0.0,
                                       "save_chunk_ms": 0.0})
        per_row = r["ms"]["1"] * r["calls"]
        t["sites"] += 1
        t["calls"] += r["calls"]
        t["per_row_ms"] += per_row
        if r["equal"][str(batch)]:
            t["equal_sites"] += 1
            t["save_full_ms"] += per_row - r["ms"][str(batch)] * r["calls"]
        best = min([r["ms"]["1"]] + [r["ms"][c] for c, ok in r["equal"].items() if ok])
        t["save_chunk_ms"] += per_row - best * r["calls"]
    return out


def events_ms(fn, iters: int = 5) -> float:
    """Median device ms of ``fn`` between two CUDA events, one call at a time
    (a replay of a whole bucket queues too slowly for ``device_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def probes_off():
    """Every ``row_chunks`` call one row at a time, as before the probes."""
    real = batching._probes
    batching._probes = lambda x: False
    try:
        yield
    finally:
        batching._probes = real


def capture(pipe, batch: int, probes: bool) -> dict:
    """The batch bucket captured anew, its decisions made anew (every call
    one row at a time unless ``probes``): the warm-up's seconds (eager run,
    probes, capture), the replay's device ms and the capture's counters."""
    pipe._compiled.clear()
    batching.reset()
    before = tracing.counters()
    with contextlib.ExitStack() as stack:
        if not probes:
            stack.enter_context(probes_off())
        warm = pipe.warmup(512, 512, steps=4, batch=batch)
    after = tracing.counters()
    out = {"warmup_s": warm["seconds"],
           "replay_ms": events_ms(pipe._compiled[warm["key"]].graph.replay)}
    if probes:
        out.update({k.split(".")[1]: after.get(k, 0) - before.get(k, 0)
                    for k in ("batching.calls_batched", "batching.calls_per_row")})
        out["keys_batched"] = sum(r > 1 for r in batching.decisions().values())
        out["keys"] = len(batching.decisions())
    return out


def rows_equal_solo(pipe, batch: int) -> list:
    """Whether each PNG of a coalesced batch (the worker's ``run_jobs``)
    has the bytes of that row's solo ``run_job``."""
    from dreamlab_tpu_torch.engine.base import GenSpec
    from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker

    worker = CudaPipelineWorker(pipe)
    specs = [GenSpec(PROMPT, size="512x512", seed=1000 + i) for i in range(batch)]
    coalesced = worker.run_jobs(specs)
    return [c == worker.run_job(s) for c, s in zip(coalesced, specs)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="the surveyed bucket's batch")
    ap.add_argument("--buckets", type=int, nargs="*", default=[],
                    help="batches to capture one row at a time and as decided")
    ap.add_argument("--out", default="ab_batching.json")
    args = ap.parse_args()
    require_cuda("ab_batching")
    from dreamlab_tpu_torch import testing
    from dreamlab_tpu_torch.pipeline import LCMPipeline

    pipe = LCMPipeline(testing.random_bundle("sd15", seed=0, device="cuda"))
    sites: Dict[tuple, Site] = {}
    with probes_off(), record_sites(sites), torch.inference_mode():
        pipe._generate_eager(PROMPT, height=512, width=512, num_inference_steps=4,
                             seed=0, batch=args.batch)
        rows = survey(sites, args.batch)
    del sites
    torch.cuda.empty_cache()
    result = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "sites": len(rows), "by_kind": totals(rows, args.batch), "buckets": {}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with torch.inference_mode():
        for b in args.buckets:
            result["buckets"][b] = {"per_row": capture(pipe, b, probes=False),
                                    "decided": capture(pipe, b, probes=True)}
            print(json.dumps({b: result["buckets"][b]}), flush=True)
    if args.buckets:
        result["rows_equal_solo"] = rows_equal_solo(pipe, max(args.buckets))
    line = json.dumps(result)
    print(line, flush=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
