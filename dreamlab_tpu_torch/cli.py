"""Standalone txt2img CLI on the card (port of ``dreamlab_tpu/cli.py``).

Load a checkpoint (a diffusers directory or a single file), generate, and
save PNGs (the port's writer) whose names encode the generation parameters.

    python -m dreamlab_tpu_torch.cli -i /models/LCM-Dreamshaper-V7 \\
        --prompt "a cat in a space suit" --steps 4 --size 512x512 --seed 42 -o out/

``--random-weights`` runs SD1.5 at full width with seeded random weights
when no checkpoint is at hand. ``--device cpu`` runs the plain versions on
the CPU; by default the CLI runs on the CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import os
import re
import time


def get_image_path(outdir: str, prompt: str, steps: int, guidance: float,
                   seed: int) -> str:
    slug = re.sub(r"[^a-z0-9]+", "-", prompt.lower())[:48].strip("-") or "image"
    name = f"{slug}_{steps}_{guidance:g}_{seed}.png"
    return os.path.join(outdir, name)


def main(argv=None):
    p = argparse.ArgumentParser(description="LCM txt2img on the card")
    p.add_argument("-i", "--model-dir", help="diffusers-layout checkpoint dir or single file")
    p.add_argument("--random-weights", action="store_true",
                   help="full-size SD1.5 with seeded random weights (no checkpoint)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--size", default="512x512")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("-o", "--output", default=".", help="output dir or file")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    if not args.model_dir and not args.random_weights:
        p.error("either -i/--model-dir or --random-weights is required")

    import torch

    from .engine.base import parse_size
    from .pipeline import LCMPipeline, resolve_device
    from .utils.png import encode_png

    device = resolve_device(args.device)
    t0 = time.time()
    if args.random_weights:
        from .testing import random_bundle

        bundle = random_bundle("sd15", device=device)
    else:
        from .loader import load_pipeline

        bundle = load_pipeline(args.model_dir, device=device)
    print(f"model loaded in {time.time() - t0:.1f}s ({bundle.arch})")

    pipe = LCMPipeline(bundle, dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
                       device=device)
    width, height = parse_size(args.size)

    t0 = time.time()
    res = pipe.generate(
        args.prompt,
        height=height,
        width=width,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance,
        negative_prompt=args.negative_prompt,
        seed=args.seed,
        batch=args.batch,
    )
    print(f"generated {res.images.shape[0]} image(s) in {time.time() - t0:.2f}s "
          f"seed={res.seed}")

    out = args.output
    if out.endswith(".png") and res.images.shape[0] == 1:
        paths = [out]
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    else:
        os.makedirs(out, exist_ok=True)
        paths = [
            get_image_path(out, args.prompt, args.steps, args.guidance,
                           res.seed + i if args.batch > 1 else res.seed)
            for i in range(res.images.shape[0])
        ]
    for path, img in zip(paths, res.images):
        with open(path, "wb") as f:
            f.write(encode_png(img))
        print("wrote", path)
    return paths


if __name__ == "__main__":
    main()
