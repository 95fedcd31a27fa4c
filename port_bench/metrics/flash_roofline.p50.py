"""K1's share of its roofline in the traced slice: the bounds of the flash
attention calls the slice's replays made (operations 4·B·H·N·M·d at the
bf16 peak, or q, k, v and o moved once at the HBM rate, whichever is
larger, from the configuration's shapes) over the device time of the flash
kernels there. The kernels are matched by the names the profiler prints."""

from port_bench import flops
from port_bench.readers import kernel_roofline

KERNELS = ("flash_wgmma_kernel", "flash_mma_kernel")


def read(run):
    return kernel_roofline(run, KERNELS, flops.flash_calls)
