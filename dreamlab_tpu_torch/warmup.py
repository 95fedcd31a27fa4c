"""Capture a checkpoint's serving buckets ahead of traffic (port of
``dreamlab_tpu/warmup.py``):

    python -m dreamlab_tpu_torch.warmup -i /models/LCM-Dreamshaper-V7 \\
        --sizes 512x512 768x768 --steps 4 --batches 1 4 8

The card keeps no CUDA graph across processes, so there is no cache to fill
as the JAX package fills XLA's: the tool builds the kernel library (the one
artifact that persists, in ``dreamlab_tpu_torch/_build/``), then captures
each bucket and prints its seconds and the bytes it added to the pipeline's
graph pool. A worker does the same at start with ``warmup=True`` or
``create_cuda_worker(warmup_size=...)``. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="capture serving buckets as CUDA graphs")
    p.add_argument("-i", "--model-dir")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--sizes", nargs="+", default=["512x512"])
    p.add_argument("--steps", nargs="+", type=int, default=[4])
    p.add_argument("--batches", nargs="+", type=int, default=[1])
    p.add_argument("--rng", choices=["host", "device"], default="host")
    args = p.parse_args(argv)
    if not args.model_dir and not args.random_weights:
        p.error("either -i/--model-dir or --random-weights is required")

    import torch

    from .engine.base import parse_size
    from .ops import _build
    from .pipeline import LCMPipeline, resolve_device

    dev = resolve_device()  # raises without a GPU
    t0 = time.perf_counter()
    print(f"kernel library: {_build.build()} ({time.perf_counter() - t0:.1f}s)")
    if args.random_weights:
        from .testing import random_bundle

        bundle = random_bundle("sd15", device=dev)
    else:
        from .loader import load_pipeline

        bundle = load_pipeline(args.model_dir, device=dev)
    pipe = LCMPipeline(bundle, device=dev)
    del bundle
    torch.cuda.empty_cache()
    for size in args.sizes:
        w, h = parse_size(size)
        for steps in args.steps:
            for batch in args.batches:
                out = pipe.warmup(h, w, steps=steps, batch=batch, rng=args.rng)
                print(f"  {size} steps={steps} batch={batch}: {out['seconds']:.1f}s "
                      f"(capture {out['capture_s']:.2f}s), "
                      f"+{out['reserved_bytes']} bytes reserved")
    print(f"done: {len(pipe._compiled)} buckets, "
          f"{torch.cuda.memory_reserved(dev)} bytes reserved on {torch.cuda.get_device_name(dev)}")


if __name__ == "__main__":
    main()
