"""CUDA pipeline worker (port of ``dreamlab_tpu/engine/tpu_worker.py``).

One worker owns one loaded ``LCMPipeline`` and implements the
``PipelineWorker`` protocol: ``run_job(spec) -> (png, seed)`` and
``run_job_with_latents`` with the [1, 4, 8, 8] float16 fingerprint
(512 bytes), plus the pool's coalescing interface ``batchable`` /
``run_jobs``, its dispatch-now, finalize-later twins ``run_job_pipelined`` /
``run_jobs_pipelined`` (each returns a ``finalize()`` that waits for the
images and encodes the PNGs, so the pool hides one request's copy and
encoding behind the next one's replay), and ``run_img2img`` (img2img and
inpainting). Batching never
changes a request's output: each row's noise comes from its own seed, as in
a solo run, its guidance and negative prompt are its own, and the library
calls run one row at a time (``ops/batching.py``), the doubled batch of
classic CFG included.

On the card each request replays its shape bucket's CUDA graph
(``pipeline.py``); the worker's lock serializes its requests, and every
launch holds the device lock shared (``pipeline.device_lock``).
``warmup=True`` captures the ``default_size`` bucket (batch 1, 4 steps)
when the worker is built.

Styles (``styles``: name -> ``lora.StyleDef``) apply exclusively per
request and are always restored to the base weights afterwards, as in the
reference. A graph reads the weights at the addresses it captured, so a
style is written into the UNet's live leaves (``lora.write_leaves``)
instead of swapping the tree by pointer as the reference does:

- the first time a style touches a leaf, the worker keeps a copy of its
  base value; every merge is computed from those base copies;
- a merged-weights LRU (``DREAMLAB_LORA_CACHE`` entries, default 2) keeps,
  per (LoRA file, scale), the merged values of the touched leaves only;
  applying a cached style copies them in, un-styling copies the base
  leaves back;
- the cache entries and the base copies are registered with the model
  registry under the bytes they hold ("lora:..." and "lora-base:..."),
  where the reference registers a whole UNet per entry.

A pipeline with its own ``apply_lora(path, scale)`` (the multi-rank
``parallel.multihost_router.RouterPipeline``, which replays every merge on
every rank) merges the style itself, as the JAX worker prefers it; the
worker then only tracks which style is on, and a failed merge across the
ranks, which restores the base weights everywhere, leaves it unstyled.

A replay reads the live leaves when the card runs it, not when it is
queued (the JAX package's in-flight call holds the buffers it was given),
so merges and restores are queued on the stream the replays run on: a
request's restore runs after its replay, and the next style's merge after
that, whether the request was waited for or is still in flight.

ControlNet hints (``spec.control_image``, scaled by
``spec.controlnet_scale`` or the mode's ``controlnet_scale``) go to the
pipeline's attached ControlNet; a progress hook (``spec.progress_cb``) is
called ``(step, timestep)`` from the pipeline's progress bucket, without
latents. With a ``refiner`` (the SDXL base -> refiner ensemble), a request
of S >= 2 steps runs steps [0, k) on the base, k = round(S *
``refiner_switch_at``) kept within [1, S - 1], hands the carry to the
refiner on the device, and the refiner runs [k, S) and decodes: the hint
and the style condition the base segment, progress rides the refiner's.
Ensemble requests run solo (``supports_batching``, ``batchable``).

Spans (``utils/tracing.py``): ``png.encode`` around each image's encoding
(its ``bytes`` and deflate ``bands``; counters ``png.bands``, the bands in
all, and ``png.banded``, the encodes of two bands or more), ``worker.noise``
around a coalesced batch's per-row noise, ``style.apply`` around a style's
merge or restore.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import lora
from ..pipeline import LCMPipeline, device_lock
from ..utils import tracing
from ..utils.png import bands, encode_png
from .base import GenSpec
from .model_registry import get_model_registry

logger = logging.getLogger(__name__)


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


def _png(image: np.ndarray, metadata=None) -> bytes:
    """``encode_png`` of one image, in a ``png.encode`` span."""
    n = bands(image.shape)
    with tracing.span("png.encode", bands=n) as s:
        data = encode_png(image, metadata)
        s.attrs["bytes"] = len(data)
    tracing.count("png.bands", n)
    if n > 1:
        tracing.count("png.banded")
    return data


class CudaPipelineWorker:
    """A single-checkpoint serving worker on one CUDA device."""

    def __init__(self, pipeline: LCMPipeline, worker_id: int = 0, *,
                 styles: Optional[Dict[str, lora.StyleDef]] = None,
                 default_size: Tuple[int, int] = (512, 512), warmup: bool = False,
                 controlnet_scale: float = 1.0, refiner: Optional[LCMPipeline] = None,
                 refiner_switch_at: float = 0.8):
        self.pipeline = pipeline
        self.worker_id = worker_id
        # the mode's ControlNet scale; a spec's controlnet_scale overrides it
        self.controlnet_scale = controlnet_scale
        self.refiner = refiner
        self.refiner_switch_at = refiner_switch_at
        # the coalescing path drives one pipeline and would bypass the handoff
        self.supports_batching = refiner is None
        self.styles = dict(styles or {})
        self._style_cache: Dict[str, lora.LoRATensors] = {}  # path -> adapter
        self._active_paths: Tuple[str, ...] = ()  # the leaves the active style wrote
        self._base: Dict[str, torch.Tensor] = {}  # leaf path -> its unstyled value
        # (lora path, scale) -> (registry name, {leaf path: merged value})
        self._merged_cache: "OrderedDict[Tuple[str, float], Tuple[str, Dict]]" = OrderedDict()
        self._merged_cache_max = int(os.environ.get("DREAMLAB_LORA_CACHE", "2"))
        # registry names, unique per worker instance: pools may build several
        # workers with one worker_id, and the registry overwrites equal names
        self._tag = f"{worker_id}:{id(self):x}"
        # (lora path, scale) a pipeline's own apply_lora has on; None: base
        self._fleet_style: Optional[Tuple[str, float]] = None
        # serializes the pipeline's graph captures and replays, and styles
        self._lock = threading.Lock()
        if warmup:
            w, h = default_size
            with self._lock:
                pipeline.warmup(h, w)

    # ------------------------------------------------------------------
    # styles
    # ------------------------------------------------------------------

    def _apply_style(self, style: Optional[str], level) -> None:
        """Exclusive style application; (None, 0) restores the base weights."""
        style, level = lora.parse_style_request(style, level)
        if style is not None:
            sdef = self.styles.get(style)
            if sdef is None:
                raise ValueError(f"unknown style {style!r}")
            cad = self.pipeline.bundle.unet_cfg.cross_attention_dim
            if sdef.required_cross_attention_dim not in (None, cad):
                raise ValueError(f"style {style!r} requires cross_attention_dim="
                                 f"{sdef.required_cross_attention_dim}, model has {cad}")
        apply_lora = getattr(self.pipeline, "apply_lora", None)
        if apply_lora is not None:
            key = None if style is None else (sdef.path, sdef.strength_for_level(level))
            if key != self._fleet_style:
                self._fleet_style = None  # what a failed merge leaves: the base weights
                with tracing.span("style.apply", style=style):
                    apply_lora(*(key or (None,)))
                self._fleet_style = key
            return
        if style is None and not self._active_paths:
            return  # unstyled already
        with device_lock(self.pipeline.device).shared(), \
                tracing.span("style.apply", style=style) as applying:
            params = self.pipeline.unet_params
            # back to base first: the next style may not touch every leaf this one wrote
            lora.write_leaves(params, {p: self._base[p] for p in self._active_paths})
            self._active_paths = ()
            if style is None:
                return
            scale = sdef.strength_for_level(level)
            key = (sdef.path, scale)
            cached = self._merged_cache.get(key)
            if cached is not None:
                self._merged_cache.move_to_end(key)
                values = cached[1]
            else:
                if sdef.path not in self._style_cache:
                    self._style_cache[sdef.path] = lora.load_lora(sdef.path)
                modules = self._style_cache[sdef.path].unet
                self._keep_base(params, modules)
                values = lora.merged_leaves(params, modules, scale, base=self._base,
                                            shard=self.pipeline.unet_leaf_slice)
            lora.write_leaves(params, values)
            self._active_paths = tuple(values)
            if cached is None:
                self._merged_put(key, style, level, values)
            applying.attrs["cached"] = cached is not None
        took = applying.ms()
        logger.info("style %s level %d (scale %.2f) %s%s", style, level, scale,
                    "applied from the cache" if cached is not None else "merged",
                    "" if took is None else f" in {took:.0f} ms")

    @contextlib.contextmanager
    def unstyled(self):
        """Hold the worker's lock and give its pipeline: until released, the
        pipeline's weights are the base ones (every request restores them,
        queued behind its replay, before it lets the lock go). Yume's
        candidate batches call the pipeline under it."""
        with self._lock:
            yield self.pipeline

    def _registry(self):
        """The model registry of the card this worker's pipeline is on."""
        return get_model_registry(self.pipeline.device)

    def _keep_base(self, params, modules) -> None:
        """Copy the base value of every leaf ``modules`` touch that has none
        kept yet (all leaves are at base here), and register the copies'
        bytes."""
        added = False
        for path in modules:
            w = lora.leaf(params, path)
            if w is not None and path not in self._base:
                self._base[path] = w.clone()
                added = True
        if added:
            self._registry().register_model(
                f"lora-base:{self._tag}", model_path="", worker_id=self.worker_id,
                hbm_bytes=_nbytes(self._base))

    def _merged_put(self, key, style: str, level: int, values) -> None:
        """Cache a style's merged leaves, evicting least-recently used entries
        to stay within both the entry cap (DREAMLAB_LORA_CACHE) and the
        device's headroom (registered, then bounded: the values are already
        allocated, so the question is whether the card can keep them; if
        it cannot even after the older entries went, this one goes too)."""
        if self._merged_cache_max <= 0:
            return
        registry = self._registry()
        name = f"lora:{self._tag}:{style}:{level}"
        registry.register_model(name, model_path=key[0], worker_id=self.worker_id,
                                hbm_bytes=_nbytes(values))
        self._merged_cache[key] = (name, values)
        while self._merged_cache and (len(self._merged_cache) > self._merged_cache_max
                                      or not registry.can_fit(0)):
            victim_key, (victim_name, _) = self._merged_cache.popitem(last=False)
            registry.unregister_model(victim_name)
            if victim_key == key:
                break  # dropped itself: nothing left this cache can free

    def _merged_clear(self) -> None:
        registry = self._registry()
        for name, _ in self._merged_cache.values():
            registry.unregister_model(name)
        self._merged_cache.clear()
        registry.unregister_model(f"lora-base:{self._tag}")

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------

    def _generate(self, spec: GenSpec, pipelined: bool = False):
        width, height = spec.dims()
        seed = spec.seed if spec.seed is not None else _new_seed()
        common = dict(height=height, width=width,
                      num_inference_steps=spec.num_inference_steps,
                      original_inference_steps=spec.original_inference_steps,
                      guidance_scale=spec.guidance_scale,
                      negative_prompt=spec.negative_prompt, seed=seed, pipelined=pipelined)
        hint_kw, progress_kw = {}, {}
        if spec.control_image is not None:
            hint_kw = dict(control_image=spec.control_image,
                           controlnet_scale=(spec.controlnet_scale
                                             if spec.controlnet_scale is not None
                                             else self.controlnet_scale))
        if spec.progress_cb is not None:
            cb = spec.progress_cb
            progress_kw = dict(callback=lambda i, t, lat: cb(i, t), callback_latents=False)
        steps = spec.num_inference_steps
        with self._lock:
            self._apply_style(spec.style, spec.style_level)
            try:
                if self.refiner is None or steps < 2:
                    return self.pipeline.generate(spec.prompt, aesthetic_score=spec.aesthetic_score,
                                                  **common, **hint_kw, **progress_kw)
                k = min(max(int(round(steps * self.refiner_switch_at)), 1), steps - 1)
                base = self.pipeline.generate(spec.prompt, segment=(0, k), **common, **hint_kw)
                return self.refiner.generate(
                    spec.prompt, segment=(k, steps), latents_state=base.state_device,
                    aesthetic_score=spec.aesthetic_score, **common, **progress_kw)
            finally:
                self._apply_style(None, 0)

    def run_job(self, spec: GenSpec) -> Tuple[bytes, int]:
        return self.run_job_pipelined(spec)()

    def run_job_pipelined(self, spec: GenSpec) -> Callable[[], Tuple[bytes, int]]:
        """Dispatch now, finalize later: the request is queued on the card
        (its style restored behind it) and the returned ``finalize()`` waits
        for its images and encodes the PNG, as ``run_job`` returns it."""
        res = self._generate(spec, pipelined=True)

        def finalize() -> Tuple[bytes, int]:
            res.wait()
            meta = {"parameters": _parameters_text(spec, res.seed, spec.num_inference_steps)}
            return _png(res.images[0], meta), res.seed

        return finalize

    def run_job_with_latents(self, spec: GenSpec) -> Tuple[bytes, int, bytes]:
        res = self._generate(spec)
        return _png(res.images[0]), res.seed, latents_to_fingerprint(res.latents)

    def run_img2img(self, spec: GenSpec, image: np.ndarray, *, strength: float = 0.5,
                    mask: Optional[np.ndarray] = None) -> Tuple[bytes, int]:
        """img2img, or inpainting with ``mask``; the image's dims set the
        output size (``spec.size`` is not read)."""
        seed = spec.seed if spec.seed is not None else _new_seed()
        with self._lock:
            self._apply_style(spec.style, spec.style_level)
            try:
                res = self.pipeline.img2img(
                    spec.prompt, image, mask=mask, strength=strength,
                    aesthetic_score=spec.aesthetic_score,
                    num_inference_steps=spec.num_inference_steps,
                    original_inference_steps=spec.original_inference_steps,
                    guidance_scale=spec.guidance_scale,
                    negative_prompt=spec.negative_prompt, seed=seed,
                )
            finally:
                self._apply_style(None, 0)
        meta = {"parameters": (f"{spec.prompt}\nSteps: {spec.num_inference_steps}, "
                               f"CFG scale: {spec.guidance_scale}, Seed: {res.seed}, "
                               f"Strength: {strength}")}
        return _png(res.images[0], meta), res.seed

    def batchable(self, a: GenSpec, b: GenSpec) -> bool:
        """Specs that can share one batched call: same shape, schedule,
        style and guidance *mode*, and nothing that must run solo. Guidance
        values and negative prompts differ per row freely (LCM guidance
        rides the per-row w-embedding, classic CFG mixes per row). The mode
        is the boundary: guidance 1 through the CFG mix is not bit-equal to
        the cond-only call, so a g <= 1 row never joins a g > 1 batch on a
        non-LCM UNet. A worker with a refiner batches nothing."""
        if not (
            self.supports_batching
            and a.size == b.size
            and a.num_inference_steps == b.num_inference_steps
            and a.original_inference_steps == b.original_inference_steps
            and (a.style, a.style_level) == (b.style, b.style_level)
            and a.aesthetic_score == b.aesthetic_score
            and a.progress_cb is None and b.progress_cb is None
            and a.control_image is None and b.control_image is None
        ):
            return False
        return self.pipeline.cfg_mode(a.guidance_scale) == self.pipeline.cfg_mode(
            b.guidance_scale)

    def run_jobs(self, specs) -> List[Tuple[bytes, int]]:
        """Coalesced execution: one batched call for compatible specs.
        Returns [(png, seed), ...] in input order."""
        return self.run_jobs_pipelined(specs)()

    def run_jobs_pipelined(self, specs) -> Callable[[], List[Tuple[bytes, int]]]:
        """Dispatch a coalesced batch now, finalize later: the returned
        ``finalize()`` waits for the images and gives [(png, seed), ...] in
        input order. Each row's initial latents and step noises come from
        its own seed, as in a solo run, so batching never changes a
        request's image."""
        if len(specs) == 1:
            return self.run_job_pipelined(specs[0])
        first = specs[0]
        if not all(self.batchable(first, s) for s in specs[1:]):
            raise ValueError("run_jobs takes mutually batchable specs")
        width, height = first.dims()
        seeds = [s.seed if s.seed is not None else _new_seed() for s in specs]
        pipe = self.pipeline
        h_lat, w_lat = height // pipe.vae_scale, width // pipe.vae_scale
        steps = first.num_inference_steps
        lats, noises = [], []
        with tracing.span("worker.noise", rows=len(seeds)):
            for seed in seeds:
                lat, noise = pipe._sample_noise(seed, 1, h_lat, w_lat, steps, 1.0)
                lats.append(lat[0])
                noises.append(noise[:, 0])
        with self._lock:
            self._apply_style(first.style, first.style_level)
            try:
                res = pipe.generate(
                    [s.prompt for s in specs], height=height, width=width,
                    num_inference_steps=steps,
                    original_inference_steps=first.original_inference_steps,
                    guidance_scale=[float(s.guidance_scale) for s in specs],
                    negative_prompt=[s.negative_prompt or "" for s in specs],
                    seed=seeds[0],
                    aesthetic_score=first.aesthetic_score,
                    latents=np.stack(lats),  # raw noise; generate applies the init sigma
                    step_noises=np.stack(noises, axis=1),
                    pipelined=True,
                )
            finally:
                self._apply_style(None, 0)

        def finalize() -> List[Tuple[bytes, int]]:
            res.wait()
            return [(_png(res.images[i], {"parameters": _parameters_text(s, seed, steps)}),
                     seed) for i, (s, seed) in enumerate(zip(specs, seeds))]

        return finalize

    def close(self) -> None:
        """Unregister the style cache and base copies, drop the pipelines'
        graphs (their pools go back to the card at the next
        ``torch.cuda.empty_cache``) and the pipelines."""
        self._merged_clear()
        self._base.clear()
        self._style_cache.clear()
        for pipe in (self.pipeline, self.refiner):
            if pipe is not None:
                pipe.release_graphs()
        self.pipeline = self.refiner = None


def _nbytes(tensors: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())
