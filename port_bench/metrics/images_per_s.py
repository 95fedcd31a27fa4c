"""Images returned within the window over the window's seconds."""

from port_bench.readers import images_per_s


def read(run):
    return images_per_s(run)
