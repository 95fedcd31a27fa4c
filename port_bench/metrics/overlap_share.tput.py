"""Share of the window's settles in which the copy back and the PNG
encoding hid behind the next replay, from the program's ``pool.settle``
spans: those whose ``overlapped`` is true (a later dispatch went to the
card before the settle began)."""

from port_bench.program_spans import share_with


def read(run):
    return share_with(run, "pool.settle", "overlapped")
