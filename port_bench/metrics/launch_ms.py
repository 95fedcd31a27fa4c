"""Median milliseconds the host takes to hand a replay to the card in the
window, from the program's ``graph.replay`` spans (under the device lock:
the input copies queued, the graph's replay, the output copies and their
event queued)."""

from port_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "graph.replay")
