"""Median wall milliseconds of the worker's dispatch in the window
(``run_job(s)_pipelined``: host staging and the graph's launch)."""

import numpy as np


def read(run):
    out = [1e3 * (c["t1"] - c["t0"]) for c in run.calls if "t1" in c]
    return float(np.median(out)) if out else None
