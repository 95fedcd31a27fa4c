"""Share of the traced slice in which no kernel or copy ran on the card."""

from port_bench.readers import device_idle_share


def read(run):
    return device_idle_share(run)
