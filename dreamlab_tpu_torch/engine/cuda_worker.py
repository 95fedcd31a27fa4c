"""CUDA pipeline worker (port of ``dreamlab_tpu/engine/tpu_worker.py``).

One worker owns one loaded ``LCMPipeline`` and implements the
``PipelineWorker`` protocol: ``run_job(spec) -> (png, seed)`` and
``run_job_with_latents`` with the [1, 4, 8, 8] float16 fingerprint
(512 bytes), plus the pool's coalescing interface ``batchable`` /
``run_jobs``. Batching never changes a request's output: each row's noise
comes from its own seed, as in a solo run.

Styles (LoRA), the refiner, ControlNet, progress callbacks and img2img come
with later slices; a spec that asks for one is refused with ``ValueError``.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np

from ..pipeline import LCMPipeline
from ..utils.png import encode_png
from .base import GenSpec


def latents_to_fingerprint(latents_nhwc: np.ndarray) -> bytes:
    """Final denoised latents [1, h, w, 4] -> [1, 4, 8, 8] f16 bytes via
    block-mean downsampling."""
    x = latents_nhwc[0]  # [h, w, 4]
    h, w, _ = x.shape
    bh, bw = max(h // 8, 1), max(w // 8, 1)
    x = x[: 8 * bh, : 8 * bw]
    x = x.reshape(8, bh, 8, bw, 4).mean(axis=(1, 3))  # [8, 8, 4]
    return x.transpose(2, 0, 1)[None].astype(np.float16).tobytes()


def _parameters_text(spec: GenSpec, seed: int, steps: int) -> str:
    return (f"{spec.prompt}\nSteps: {steps}, CFG scale: {spec.guidance_scale}, "
            f"Seed: {seed}, Size: {spec.size}")


def _new_seed() -> int:
    return int(np.random.randint(0, 2**31 - 1))


class CudaPipelineWorker:
    """A single-checkpoint serving worker on one CUDA device."""

    def __init__(self, pipeline: LCMPipeline, worker_id: int = 0):
        self.pipeline = pipeline
        self.worker_id = worker_id
        self._lock = threading.Lock()

    @staticmethod
    def _check_supported(spec: GenSpec) -> None:
        if spec.style is not None:
            raise ValueError(f"unknown style {spec.style!r}")
        if spec.control_image is not None or spec.progress_cb is not None:
            raise ValueError("ControlNet hints and progress callbacks come with a "
                             "later slice of the port")

    def _generate(self, spec: GenSpec):
        self._check_supported(spec)
        width, height = spec.dims()
        seed = spec.seed if spec.seed is not None else _new_seed()
        with self._lock:
            return self.pipeline.generate(
                spec.prompt, height=height, width=width,
                num_inference_steps=spec.num_inference_steps,
                original_inference_steps=spec.original_inference_steps,
                guidance_scale=spec.guidance_scale, seed=seed,
            )

    def run_job(self, spec: GenSpec) -> Tuple[bytes, int]:
        res = self._generate(spec)
        meta = {"parameters": _parameters_text(spec, res.seed, spec.num_inference_steps)}
        return encode_png(res.images[0], meta), res.seed

    def run_job_with_latents(self, spec: GenSpec) -> Tuple[bytes, int, bytes]:
        res = self._generate(spec)
        return encode_png(res.images[0]), res.seed, latents_to_fingerprint(res.latents)

    def batchable(self, a: GenSpec, b: GenSpec) -> bool:
        """Specs that can share one batched call: same shape, schedule and
        style, and nothing that must run solo. Guidance and negative prompts
        differ per row freely (LCM guidance rides the per-row w-embedding)."""
        return (
            a.size == b.size
            and a.num_inference_steps == b.num_inference_steps
            and a.original_inference_steps == b.original_inference_steps
            and (a.style, a.style_level) == (b.style, b.style_level)
            and a.progress_cb is None and b.progress_cb is None
            and a.control_image is None and b.control_image is None
        )

    def run_jobs(self, specs) -> List[Tuple[bytes, int]]:
        """Coalesced execution: one batched call for compatible specs.
        Returns [(png, seed), ...] in input order."""
        if len(specs) == 1:
            return [self.run_job(specs[0])]
        first = specs[0]
        if not all(self.batchable(first, s) for s in specs[1:]):
            raise ValueError("run_jobs takes mutually batchable specs")
        for s in specs:
            self._check_supported(s)
        width, height = first.dims()
        seeds = [s.seed if s.seed is not None else _new_seed() for s in specs]
        pipe = self.pipeline
        h_lat, w_lat = height // pipe.vae_scale, width // pipe.vae_scale
        steps = first.num_inference_steps
        lats, noises = [], []
        for seed in seeds:
            lat, noise = pipe._sample_noise(seed, 1, h_lat, w_lat, steps, 1.0)
            lats.append(lat[0])
            noises.append(noise[:, 0])
        with self._lock:
            res = pipe.generate(
                [s.prompt for s in specs], height=height, width=width,
                num_inference_steps=steps,
                original_inference_steps=first.original_inference_steps,
                guidance_scale=[float(s.guidance_scale) for s in specs],
                seed=seeds[0],
                latents=np.stack(lats),  # raw noise; generate applies the init sigma
                step_noises=np.stack(noises, axis=1),
            )
        return [
            (encode_png(res.images[i], {"parameters": _parameters_text(s, seed, steps)}), seed)
            for i, (s, seed) in enumerate(zip(specs, seeds))
        ]
