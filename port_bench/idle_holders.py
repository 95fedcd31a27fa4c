#!/usr/bin/env python3
"""Where a cell's idle card waits: one traced run of the cell, as ``run.py``
makes it, and the traced slice's device-idle time put down to the program
span that held it (``program_spans.held``).

    python3 port_bench/idle_holders.py --workload sd15-512-serial --seed 4294967311 --seconds 50

From the root of a checkout, on a card. Prints the run's result line, then
one JSON object: the slice's idle seconds by holder and as shares of its
idle time (``none``: no span open), and its ten longest gaps, each with the
holder of most of it. ``--dump PATH`` writes the window's program spans and
the slice's gaps there as JSON as well.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import checks, program_spans, run as harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = harness.load_cell(root, args.workload)
    harness.set_caches(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, True, "cuda",
                           checks.limits(args.workload))
    print(json.dumps(harness.result_line(cell, out, True, torch.cuda.get_device_name(0))),
          flush=True)
    run = out["run"]
    prof = run.profile
    spans = program_spans.in_slice(run)
    idle = sum(t - s for _, s, t in prof["gaps"])
    by = program_spans.idle_by_span(run) or {}
    longest = [[max(held.items(), key=lambda kv: kv[1])[0], t - s]
               for _, s, t in prof["gaps"][:10]
               for held in [program_spans.held([(s, t)], spans)]]
    print(json.dumps({"idle_s": idle, "slice_s": prof["seconds"], "by_holder_s": by,
                      "by_holder_share": {k: v / idle for k, v in by.items()} if idle else {},
                      "longest_gaps": longest}), flush=True)
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump({"t_open": run.t_open, "seconds": run.seconds, "gaps": prof["gaps"],
                       "start": prof["start"], "stop": prof["stop"],
                       "spans": [s for s in program_spans.recorded()
                                 if run.t_open <= s["t0"] <= run.t_close]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
