"""90th percentile over the window's jobs of the wait in the pool: from
``submit_job`` to the worker call that took the job."""

from port_bench.readers import percentile


def read(run):
    waits = [1e3 * (j["taken"] - j["submit"]) for j in run.jobs if "taken" in j]
    return percentile(waits, 90)
