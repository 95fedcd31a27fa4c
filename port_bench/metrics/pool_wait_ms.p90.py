"""90th percentile over the window's pool jobs of their wait in the pool's
queue, from the program's ``pool.queued`` spans: ``submit_job`` to the pool
thread taking the job."""

from port_bench import program_spans
from port_bench.readers import percentile


def read(run):
    return percentile([1e3 * (s["t1"] - s["t0"]) for s in program_spans.window(run, "pool.queued")],
                      90)
