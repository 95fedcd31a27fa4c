"""Median latency over every request due in the window, from when it was
due (not sent) to its last response byte; a failed request counts as
missing."""

from port_bench.readers import percentile


def read(run):
    return percentile(run.latencies_ms(), 50)
