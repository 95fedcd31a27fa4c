#!/usr/bin/env python3
"""Find a cell's knee on the card: the highest offered rate its open-loop
traffic sustains without a growing backlog.

    python3 port_bench/sweep.py --config <config> --traffic <open-loop mix> \\
        --seed <n> --seconds <window> --rates 8,12,16,...

Builds the configuration's system under the mix once (a configuration and
a traffic file, found by name; the mix's own rate is not read), then serves one window at each rate in
turn (after the previous window's requests have all come back). A rate is
sustained where every request of its window was answered and the latest
quarter of the window's requests waited no longer, at the median, than
1.5 x the second quarter did (a backlog that grows through the window
shows as a later quarter waiting longer). Prints one JSON line a rate, then the knee and
the rate at 0.8 of it, to write into the cell's traffic file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from port_bench import run as harness, traffic  # noqa: E402

GROWTH = 1.5


def judge(records, t_open: float, seconds: float, rate: float) -> dict:
    reqs = sorted((r for r in records if r["due"] < t_open + seconds), key=lambda r: r["due"])
    ok = [r for r in reqs if r.get("status") == 200]
    lat = np.array([1e3 * (r["done"] - r["due"]) for r in ok])
    q = len(reqs) // 4
    quarter = lambda i: [1e3 * (r["done"] - r["due"]) for r in reqs[i * q:(i + 1) * q]
                         if r.get("status") == 200]
    second, last = np.median(quarter(1)), np.median(quarter(3))
    done_in = sum(1 for r in ok if r["done"] <= t_open + seconds) / seconds
    out = {"rate": rate, "offered": len(reqs), "answered": len(ok),
           "images_per_s": done_in, "p50_ms": float(np.median(lat)),
           "p90_ms": float(np.percentile(lat, 90)), "q2_p50_ms": float(second),
           "q4_p50_ms": float(last)}
    out["sustained"] = bool(len(ok) == len(reqs) and last <= GROWTH * second)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    root = Path.cwd()
    with open(root / "port_bench" / "configs" / f"{args.config}.json") as f:
        config = json.load(f)
    mix = traffic.load(args.traffic)
    harness.set_caches(root)
    import torch

    from port_bench import system

    if not torch.cuda.is_available():
        harness.log("the sweep needs a CUDA device")
        return 2
    if mix["loop"] != "open":
        harness.log("a knee is found for open-loop traffic")
        return 2
    system.import_program()
    built = system.build(config, mix, args.seed, "cuda")
    harness.log(f"set-up phases (s): {json.dumps(built.marks)}")
    harness.warm_request(built.port, mix)
    knee, fails = None, 0
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            w = harness.window(built, mix, args.seed + 1 + i, args.seconds, False, rate=rate,
                               vocab_seed=args.seed)
            w["gen"].say({"want": []})
            w["gen"].hear()
            w["gen"].close()
            row = judge(w["records"], w["t_open"], args.seconds, rate)
            print(json.dumps(row), flush=True)
            if row["sustained"]:
                knee, fails = rate, 0
            else:
                fails += 1
                if fails == 2:
                    break
    finally:
        built.close()
    print(json.dumps({"config": args.config, "traffic": args.traffic, "knee_per_s": knee,
                      "rate_at_0.8": None if knee is None else round(0.8 * knee, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
