"""Median milliseconds of the host's staging of a request in the window,
from the program's ``pipeline.stage`` spans (``LCMPipeline._stage``:
tokenizing, the conditioning arrays, host noise, SDXL's time ids)."""

from port_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "pipeline.stage")
