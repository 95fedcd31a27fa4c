"""chip_smoke.py's Yume phase (6d) over and over on one card: a hang hunt.

Once: the kernels' build, one full-width SD1.5 census and kernel timing, and
the loader phase's fp16 SD1.5 directory and mode LoRA. Then
``chip_smoke.yume_phase`` until ``--seconds`` is spent, each iteration with
faulthandler armed (it needs no GIL) to write every thread's stack to stderr
and exit 1 if the iteration outlasts ``--iteration-s``. One JSON line an
iteration, and a last one with the clean iterations. Needs one CUDA device,
from the repo root:

    python -m dreamlab_tpu_torch.scripts.yume_loop --seconds 900
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import json
import os
import sys
import tempfile
import time

import torch

from .timing import require_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=900.0)
    ap.add_argument("--iteration-s", type=float, default=240.0)
    args = ap.parse_args(argv)
    require_cuda("yume_loop")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(600, exit=True, file=sys.stderr)
    cs._build.build()
    errs = collections.defaultdict(float)
    pipe = cs.LCMPipeline(cs.random_bundle(seed=0, device="cuda"), dtype=torch.bfloat16)
    seen = cs.census(pipe)
    per_request = cs.per_request_of(seen)
    rows = cs.time_kernels(seen, torch.bfloat16, errs)
    del pipe
    torch.cuda.empty_cache()
    done, times = 0, []
    with tempfile.TemporaryDirectory(prefix="dreamlab_ckpt_") as root:
        cs.loader_phase(per_request, root)
        print(json.dumps({"setup_s": time.perf_counter() - t_start}), flush=True)
        while time.perf_counter() - t_start + 1.5 * max(times or [60.0]) < args.seconds:
            faulthandler.dump_traceback_later(args.iteration_s, exit=True, file=sys.stderr)
            print(f"yume_loop: iteration {done} starts at "
                  f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            line = cs.yume_phase(root, rows, errs)[0]["yume"]
            times.append(time.perf_counter() - t0)
            print(json.dumps({"iteration": done, "s": times[-1], "failures": cs.FAILURES,
                              "session": line.get("session"),
                              "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30}),
                  flush=True)
            if cs.FAILURES:
                break
            done += 1
    faulthandler.cancel_dump_traceback_later()
    result = {"clean_iterations": done, "failures": cs.FAILURES, "iteration_s": times,
              "total_s": time.perf_counter() - t_start}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
