"""Median milliseconds the host blocks on the card for a dispatch's images
in the window, from the program's ``device.wait`` spans (the result's
event synchronized: the replay and the copy back done)."""

from port_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "device.wait")
