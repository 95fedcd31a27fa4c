"""Share of the traced slice's device-idle time (no kernel or copy on the
card) that lies inside the program's ``png.encode`` spans: how much of the
idle card waits on the host's PNG encoding."""

from port_bench.program_spans import idle_share_inside


def read(run):
    return idle_share_inside(run, "png.encode")
