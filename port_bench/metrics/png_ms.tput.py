"""Median milliseconds of one image's PNG encoding in the window, from the
program's ``png.encode`` spans (one a served image)."""

from port_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "png.encode")
