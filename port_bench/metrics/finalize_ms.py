"""Median wall milliseconds of the ``finalize`` a dispatch returns, in the
window: waiting for the device, the copy back and the PNG encoding."""

import numpy as np


def read(run):
    out = [1e3 * (c["f1"] - c["f0"]) for c in run.calls if "f1" in c]
    return float(np.median(out)) if out else None
