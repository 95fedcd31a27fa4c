"""Median over the window's requests of what the server adds: the
request's time on the client from sending to its last byte, less the
pool's time from ``submit_job`` to the job's future resolving."""

import numpy as np

from port_bench.readers import by_seed


def read(run):
    jobs = by_seed(run)
    out = [1e3 * ((r["done"] - r["sent"]) - (j["resolved"] - j["submit"]))
           for r in run.requests if r.get("status") == 200
           for j in [jobs.get(r["seed"])] if j and "resolved" in j]
    return float(np.median(out)) if out else None
