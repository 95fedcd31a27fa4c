"""The model step's share of the card's bf16 peak (989 TFLOP/s) at the
traced run's median latency: one image's model FLOPs (text towers, every
UNet call, the VAE decode; 2 a multiply-add, from the configuration's
shapes) over ``latency_p50_ms``."""

from port_bench.readers import model_flops_share, percentile


def read(run):
    p50 = percentile(run.latencies_ms(), 50)
    return model_flops_share(run, 1e3 / p50) if p50 else None
