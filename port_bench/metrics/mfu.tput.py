"""The model step's share of the card's bf16 peak (989 TFLOP/s) at the
traced run's throughput: ``images_per_s`` x one image's model FLOPs."""

from port_bench.readers import images_per_s, model_flops_share


def read(run):
    return model_flops_share(run, images_per_s(run))
