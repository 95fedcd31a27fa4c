#!/usr/bin/env python3
"""The control of a cell's ``correct``: the plain reference put in the
program's place and computed in the precision below the configuration's
(bfloat16 -> float8 e4m3 products, ``reference.FP8``), compared with the
reference in float32 by the same numbers a run compares. It has to come out
as not correct; its smallest readings are the upper ends the limits are
set below.

    python3 port_bench/control.py --workload <name> --seeds 11,12,13

On the card, at the cell's own size: each seed's weights and vocabulary,
and as many requests of its schedule as a run checks (the reference's image
does not depend on load or batching, so no window is needed). Prints one
JSON line a seed with each number's largest value over its images.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import checks, reference, run as harness, system, traffic, weights  # noqa: E402


def readings(config: dict, mix: dict, seed: int, seconds: float, device: str) -> dict:
    """The largest of each image number over a run's worth of requests of
    ``seed``: the control's images against the float32 reference's."""
    words, vocabulary, _ = system.run_vocabulary(seed)
    reqs = traffic.schedule(mix, seed, seconds, words)
    rng = traffic.stream(seed, "check")
    picked = [reqs[i] for i in sorted(rng.choice(len(reqs), mix["check"], replace=False))]
    states = weights.state_dicts(config, seed, device)
    exact = reference.Pipeline(config, states, vocabulary, device=device)
    low = reference.Pipeline(config, states, vocabulary, precision=reference.CONTROL,
                              device=device)
    del states
    width, height = map(int, mix["size"].split("x"))
    out = {}
    for q in picked:
        args = (q.prompt, q.seed, height, width, mix["steps"], mix.get("guidance", 1.0))
        gaps = checks.image_gaps(low(*args), exact(*args))
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    root = Path.cwd()
    cell = harness.load_cell(root, args.workload)
    harness.set_caches(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("the control runs on a CUDA device")
        return 2
    limits = checks.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell["config"], cell["mix"], seed, args.seconds, "cuda")
        fails = {k: v for k, v in got.items() if k in limits and v > limits[k]}
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "not_correct": bool(fails)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
