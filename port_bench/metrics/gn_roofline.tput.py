"""K2+K3's share of its roofline in the traced slice: the bounds of the
fused GroupNorm+SiLU calls the slice's replays made (x read once, y written
once, gamma and beta, at the HBM rate; from the configuration's shapes)
over the device time of the GroupNorm kernels there. The kernels are
matched by the names the profiler prints."""

from port_bench.readers import kernel_roofline

KERNELS = ("gn_cluster_kernel", "gn_apply_kernel")


def read(run):
    return kernel_roofline(run, KERNELS, lambda work: work.gn_silu)
