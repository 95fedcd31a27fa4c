"""90th percentile of the window's latencies, measured as for
``latency_p50_ms``."""

from port_bench.readers import percentile


def read(run):
    return percentile(run.latencies_ms(), 90)
