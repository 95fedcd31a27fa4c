#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The run builds the port's server (``dreamlab_tpu_torch``) over its
pool and a worker of the cell's configuration with weights drawn from the
seed, captures every bucket the cell's traffic reaches, starts the load
generator (``client.py``, a process of its own) and opens the window:
``--seconds`` of the cell's traffic over loopback HTTP. With ``--trace 1``
a steady slice of the window is profiled and the per-layer metrics are
reported, else the end-to-end ones. After the window it checks what the
window served against the plain reference (``checks.py``), and prints, as
its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and last ``checks``, each number compared beside its limit, which
also end its standard error.

It exits non-zero without a result where there is no card (or fewer than
the cell asks for), where JAX or the JAX package is loaded once the window
has closed, and where the cell's files are missing.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402

from port_bench import checks, flops, pngdec, readers, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dreamlab_tpu")
PROFILE_AT = 0.3  # the traced slice starts this share into the window


def process_start() -> float:
    """The process's start on the monotonic clock (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_PROCESS = process_start()


def log(msg: str) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def set_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's own kernel library lands in ``dreamlab_tpu_torch/_build``."""
    cache = root / "port_bench" / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["DREAMLAB_RNG"] = "host"
    os.environ["WARMUP"] = "1"
    os.environ["DREAMLAB_MODE_CACHE"] = "1"


def load_cell(root: Path, workload: str) -> dict:
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    pick = lambda ms: [m for m in ms if workload in m.get("workloads", [workload])]
    return {"workload": wl, "config": config, "mix": traffic.load(wl["traffic"]),
            "end_to_end": pick(bench["end_to_end"]), "per_layer": pick(bench["per_layer"])}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class LoadGenerator:
    """``client.py`` in its own process, spoken to in JSON lines."""

    def __init__(self, mix: dict, seed: int, seconds: float, rate=None, vocab_seed=None):
        self.proc = subprocess.Popen([sys.executable, str(HERE / "client.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.say({"traffic": mix, "seed": seed, "seconds": seconds, "rate": rate,
                  "vocab_seed": seed if vocab_seed is None else vocab_seed})

    def say(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def hear(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator ended early")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def window(built, mix: dict, seed: int, seconds: float, trace_on: bool, rate=None,
           gen: LoadGenerator = None, vocab_seed=None) -> dict:
    """One window of the mix against a built system: the load generator's
    records, the window's opening, and the traced slice."""
    import torch

    from port_bench import trace as trace_mod

    gen = gen or LoadGenerator(mix, seed, seconds, rate, vocab_seed)
    gen.hear()  # the schedule is made
    t_open = time.monotonic() + 0.2
    gen.say({"port": built.port, "t0": t_open})
    sliced = None
    if trace_on and torch.cuda.is_available():
        # the profiler is started and stopped on this thread, which waits
        # out the window meanwhile
        sliced = built.slice
        span = mix["profile_s"]
        at = t_open + min(max(1.0, PROFILE_AT * seconds), max(seconds - span - 0.5, 0.0))
        time.sleep(max(at - time.monotonic(), 0.0))
        sliced.start()
        time.sleep(span)
        sliced.stop()
        log(f"profiler: start {sliced.start_s:.3f} s, stop {sliced.stop_s:.3f} s, both with "
            f"every launch section held")
    records = gen.hear()["records"]
    return {"gen": gen, "t_open": t_open, "records": records, "slice": sliced}


def make_run(built, w: dict, seconds: float, work, setup_s: float, memory: int) -> readers.Run:
    t_open = w["t_open"]
    requests = [r for r in w["records"] if r["due"] < t_open + seconds]
    seeds = {r["seed"] for r in requests}
    with built.spans.lock:
        calls = [dict(c) for c in built.spans.calls if c["t0"] >= t_open]
        jobs = [dict(j) for s, j in built.spans.jobs.items() if s in seeds]
    profile = w["slice"].read() if w["slice"] is not None else None
    return readers.Run(seconds=seconds, t_open=t_open, requests=requests, calls=calls, jobs=jobs,
                       work=work, setup_s=setup_s, memory_reserved_peak=memory, profile=profile)


def sample(run: readers.Run, n: int, seed: int) -> list:
    """The check's sample: answered requests of the window, half of them
    rows of coalesced calls where the window had such, the rest solo."""
    rows = {s: c["rows"] for c in run.calls for s in c["seeds"]}
    answered = [r for r in run.requests if r.get("status") == 200]
    rng = traffic.stream(seed, "check")
    batched = [r for r in answered if rows.get(r["seed"], 1) > 1]
    solo = [r for r in answered if rows.get(r["seed"], 1) == 1]
    take_b = min(len(batched), (n + 1) // 2)
    take_s = min(len(solo), n - take_b)
    take_b = min(len(batched), n - take_s)
    pick = lambda pool, k: [pool[i] for i in sorted(rng.choice(len(pool), k, replace=False))]
    return [(r, rows.get(r["seed"], 1)) for r in pick(batched, take_b) + pick(solo, take_s)]


def breakdown(run: readers.Run) -> dict:
    prof = run.profile
    ops = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]
    from port_bench.trace import host_label

    gaps = [[host_label((s + t) / 2, run.calls, run.jobs), g] for g, s, t in prof["gaps"][:10]]
    return {"device_ops": [[name[:120], secs] for name, secs in ops], "idle_gaps": gaps}


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device: str,
             limits: dict) -> dict:
    """Build, serve one window, check. Returns the result's fields (metrics
    still with None where a reader found nothing)."""
    import gc

    import torch

    from port_bench import reference, system, trace as trace_mod, weights

    config, mix = cell["config"], cell["mix"]
    system.import_program()
    width, height = map(int, mix["size"].split("x"))
    work = flops.image_work(config, height, width, mix["steps"])
    gen = LoadGenerator(mix, seed, seconds)
    try:
        built = system.build(config, mix, seed, device)
        peak_before = built.peak_before_reset
        log(f"set-up phases (s): {json.dumps(built.marks)}")
        cuda = torch.device(device).type == "cuda"
        warm_request(built.port, mix)
        if trace_on and cuda:
            from dreamlab_tpu_torch.pipeline import quiesced

            built.slice = trace_mod.Slice(quiesced)
            warm_s = built.slice.warm(lambda: [
                built.worker.pipeline.warmup(height, width, steps=mix["steps"], batch=b)
                for b in range(1, mix["max_batch"] + 1)])
            log(f"profiler warmed over every bucket in {warm_s:.2f} s")
        w = window(built, mix, seed, seconds, trace_on, gen=gen)
        setup_s = w["t_open"] - T_PROCESS
        found = forbidden_modules()
        if found:
            log(f"loaded after the window: {found}")
            raise SystemExit(3)
        memory = torch.cuda.max_memory_reserved() if cuda else 0
        run = make_run(built, w, seconds, work, setup_s, memory)
        if run.profile is not None:
            launches = run.profile["graph_launches"]
            flash = trace_mod.family(run.profile, ("flash_wgmma_kernel", "flash_mma_kernel"))[1]
            gn = trace_mod.family(run.profile, ("gn_cluster_kernel", "gn_apply_kernel"))[1]
            log(f"traced slice: {run.profile['seconds']:.3f} s, device busy "
                f"{run.profile['busy_s']:.3f} s, replays launched "
                f"{'not recorded' if launches is None else len(launches)}, flash launches "
                f"{flash}, GroupNorm launches {gn} (census a replay: "
                f"{len(flops.flash_calls(work)), len(work.gn_silu)})")
        failed = collections.Counter(str(r.get("status") or r.get("error", "no answer"))[:80]
                                     for r in run.requests if r.get("status") != 200)
        if failed:
            log(f"requests without an image: {dict(failed)}")
        late = sorted(r["sent"] - r["due"] for r in run.requests)
        if late:
            log(f"load generator: {len(late)} requests, send delay past due max "
                f"{1e3 * late[-1]:.3f} ms, median {1e3 * late[len(late) // 2]:.3f} ms")
        picked = sample(run, mix["check"], seed)
        w["gen"].say({"want": [r["index"] for r, _ in picked]})
        pngs = w["gen"].hear()["pngs"]
        gen.close()
        served = {r["index"]: pngdec.decode(base64.b64decode(pngs[str(r["index"])]))
                  for r, _ in picked}
        # batching never changes a request's image: each coalesced row again, solo
        words = built.words
        reqs = {q.index: q for q in traffic.schedule(mix, seed, seconds, words)}
        from dreamlab_tpu_torch.engine.base import GenSpec

        row_gap = 0.0
        for r, rows in picked:
            if rows > 1:
                q = reqs[r["index"]]
                png, _ = built.worker.run_job(GenSpec(q.prompt, size=mix["size"],
                                                      num_inference_steps=mix["steps"],
                                                      guidance_scale=mix.get("guidance", 1.0),
                                                      seed=q.seed))
                solo = pngdec.decode(png)
                row_gap = max(row_gap, float(np.abs(solo.astype(np.int16)
                                                    - served[r["index"]]).max()))
        built.close()
        del built
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # the reference: its own weights from the seed, one image at a time
        _, vocabulary, _ = system.run_vocabulary(seed)
        ref = reference.Pipeline(config, weights.state_dicts(config, seed, device), vocabulary,
                                 device=device)
        numbers = {"mean_abs_levels": 0.0, "p999_abs_levels": 0.0, "max_abs_levels": 0.0}
        for r, rows in picked:
            q = reqs[r["index"]]
            want = ref(q.prompt, q.seed, height, width, mix["steps"], mix.get("guidance", 1.0))
            gaps = checks.image_gaps(served[r["index"]], want)
            log(f"request {r['index']} ({'coalesced, ' + str(rows) + ' rows' if rows > 1 else 'solo'}):"
                f" {json.dumps(gaps)}; clipped share served {checks.clipped_share(served[r['index']]):.4f}"
                f" reference {checks.clipped_share(want):.4f}")
            for k, v in gaps.items():
                numbers[k] = max(numbers[k], v)
        del ref
        numbers["batch_row_levels_off_solo"] = row_gap
        numbers["unanswered"] = sum(1 for r in run.requests if r.get("status") != 200)
        if not picked:
            numbers["mean_abs_levels"] = math.inf  # nothing served to check
        rows_seen = sorted({rows for _, rows in picked})
        log(f"checked {len(picked)} images, rows of their calls: {rows_seen}")
        return {"run": run, "numbers": numbers, "checks": checks.verdict(numbers, limits),
                "peak_before_reset": peak_before}
    finally:
        gen.close()


# a request through the server before the window opens (its own process,
# as the load generator is)
WARM_REQUEST = """
import http.client, json, sys
port, size, steps = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
c.request("POST", "/generate", body=json.dumps({"prompt": "", "size": size,
          "num_inference_steps": steps, "seed": 0}), headers={"Content-Type": "application/json"})
r = c.getresponse(); r.read()
sys.exit(0 if r.status == 200 else 1)
"""


def warm_request(port: int, mix: dict) -> None:
    """One request over HTTP before the window: the server's own first call."""
    warm = subprocess.run([sys.executable, "-c", WARM_REQUEST, str(port), mix["size"],
                           str(mix["steps"])], capture_output=True, text=True, timeout=300)
    if warm.returncode != 0:
        raise RuntimeError(f"the warm-up request failed: {warm.stderr[-2000:]}")


def result_line(cell: dict, out: dict, trace_on: bool, device_name: str) -> dict:
    import torch

    run = out["run"]
    metrics = {}
    for m in cell["per_layer" if trace_on else "end_to_end"]:
        value = readers.load(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": device_name, "count": 1,
           "memory_peak_bytes": max(run.memory_reserved_peak, out.get("peak_before_reset", 0))}
    line = {"correct": checks.passed(out["checks"]), "attempted": len(run.requests),
            "failed": int(out["numbers"]["unanswered"]), "metrics": metrics, "device": dev}
    if trace_on:
        if run.profile is None:
            raise RuntimeError("the traced slice shows no device activity")
        dev.update(busy_s=run.profile["busy_s"], window_s=run.profile["seconds"])
        line["breakdown"] = breakdown(run)
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(root, args.workload)
    set_caches(root)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not available"
    log(f"card: {name}; {smi}")
    limits = checks.limits(args.workload)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", limits)
    line = result_line(cell, out, bool(args.trace), name)
    for k, c in line["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
