"""Yume: background seed exploration ("dreaming") (port of
``dreamlab_tpu/yume/dream_worker.py``).

An asyncio task loops: it generates a batch of low-resolution candidates,
scores them (CLIP or the heuristic), keeps a top-K deque, renders every Nth
iteration's best unrendered candidate at full size, stores candidates in
Redis (a hash per candidate, a score zset per session, the rendered PNG),
tracks dreams/s, and at the end renders the top unrendered candidates.

Candidates of one iteration go through one batched ``generate`` where the
worker exposes its pipeline (a CUDA graph per bucket on the card), each
row's initial latents and step noises drawn from its own seed as a solo
run draws them, so a candidate's image is its solo run's. Where the JAX
package differs:

- the batched call holds the worker's lock (``CudaPipelineWorker.unstyled``):
  the port merges styles into the live weights under that lock, so a batch
  dispatched beside a styled request would otherwise be generated with the
  style. The reference swaps weight trees by pointer and calls its pipeline
  without the lock;
- every call that reaches the card, scoring included, runs in the
  executor: the event loop serves the HTTP server and must not wait on the
  device (a background capture holds every launch for about a second);
- the solo fallback decodes PNGs with the port's reader, not PIL.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from ..engine.base import GenSpec
from ..utils.png import decode_png
from .scoring import AestheticScorer
from .strategies import get_strategy

logger = logging.getLogger(__name__)

CANDIDATE_SIZE = "64x64"
CANDIDATE_STEPS = 1
RENDER_SIZE = "512x512"
RENDER_STEPS = 4

_PROMPT_MODIFIERS = [
    "at dawn", "at dusk", "in fog", "in rain", "in snow", "at night",
    "golden hour", "dramatic lighting", "soft focus", "vivid colors",
    "muted palette", "wide angle", "close up", "from above", "from below",
    "surreal", "dreamlike", "ethereal", "cinematic", "minimalist",
]


@dataclasses.dataclass
class DreamCandidate:
    seed: int
    prompt: str
    score: float
    image: Optional[np.ndarray] = None  # low-res candidate
    rendered_png: Optional[bytes] = None
    created_at: float = dataclasses.field(default_factory=time.time)

    @property
    def candidate_id(self) -> str:
        return hashlib.sha1(f"{self.prompt}|{self.seed}".encode()).hexdigest()[:16]

    def summary(self) -> Dict:
        return {
            "id": self.candidate_id,
            "seed": self.seed,
            "prompt": self.prompt,
            "score": round(self.score, 4),
            "rendered": self.rendered_png is not None,
            "created_at": self.created_at,
        }


class DreamWorker:
    """One dreaming session manager bound to a generation worker."""

    def __init__(
        self,
        worker,
        scorer=None,
        redis=None,
        *,
        top_k: int = 20,
        render_interval: int = 8,
        score_threshold: float = 0.2,
        candidate_batch: int = 4,
        candidate_size: str = CANDIDATE_SIZE,
        candidate_steps: int = CANDIDATE_STEPS,
        render_size: str = RENDER_SIZE,
        render_steps: int = RENDER_STEPS,
    ):
        self.worker = worker
        self.scorer = scorer or AestheticScorer()
        self.redis = redis
        self.top_k = top_k
        self.render_interval = render_interval
        self.score_threshold = score_threshold
        self.candidate_batch = max(1, candidate_batch)
        self.candidate_size = candidate_size
        self.candidate_steps = candidate_steps
        self.render_size = render_size
        self.render_steps = render_steps

        self.session_id: Optional[str] = None
        self.base_prompt = ""
        self.prompts: List[str] = []
        self.strategy = None
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()
        self.top: Deque[DreamCandidate] = deque(maxlen=top_k)
        self.recent: Deque[Dict] = deque(maxlen=50)
        self.stats = {
            "generated": 0, "scored": 0, "kept": 0, "rendered": 0,
            "started_at": None, "dreams_per_sec": 0.0,
        }

    # ------------------------------------------------------------------
    def _prompt_variations(self, base: str, temperature: float, n: int = 8) -> List[str]:
        """Higher temperature mixes in more modifiers (seeded by ``hash(base)``,
        which Python salts per process)."""
        rng = np.random.RandomState(abs(hash(base)) % (2**31))
        k = max(0, min(int(round(temperature * 3)), 3))
        out = [base]
        for _ in range(n - 1):
            mods = rng.choice(_PROMPT_MODIFIERS, size=k, replace=False) if k else []
            out.append(", ".join([base, *mods]) if len(mods) else base)
        return out

    # ------------------------------------------------------------------
    async def start_dreaming(
        self,
        prompt: str,
        *,
        duration_s: Optional[float] = None,
        strategy: str = "temperature",
        temperature: float = 0.7,
    ) -> Dict:
        if self._task and not self._task.done():
            raise RuntimeError("a dream session is already running")
        self.session_id = f"dream:{int(time.time())}"
        self.base_prompt = prompt
        self.prompts = self._prompt_variations(prompt, temperature)
        self.strategy = get_strategy(strategy)
        self.top.clear()
        self.recent.clear()
        self.stats = {
            "generated": 0, "scored": 0, "kept": 0, "rendered": 0,
            "started_at": time.time(), "dreams_per_sec": 0.0,
        }
        self._stop.clear()
        self._task = asyncio.create_task(self._dream_loop(duration_s))
        logger.info("dream session %s started (%s)", self.session_id, strategy)
        return {"session_id": self.session_id, "prompts": self.prompts}

    async def stop_dreaming(self) -> Dict:
        self._stop.set()
        if self._task:
            try:
                # shielded: a stop request whose client goes away does not
                # cancel the session's finalize
                await asyncio.wait_for(asyncio.shield(self._task), timeout=30.0)
            except asyncio.TimeoutError:
                self._task.cancel()
        return self.get_status()

    # ------------------------------------------------------------------
    def _generate_candidates(self, seeds: List[int], prompt: str) -> List[np.ndarray]:
        """A low-res candidate batch: one batched call when the worker exposes
        its pipeline (a ``CudaPipelineWorker``), else one ``run_job`` per
        seed (any worker)."""
        pipeline = getattr(self.worker, "pipeline", None)
        if pipeline is not None and len(seeds) > 1:
            # every row's initial latents and step noises come from its own
            # seed's stream, as a solo run with that seed draws them
            w, h = map(int, self.candidate_size.split("x"))
            h_lat = h // pipeline.vae_scale
            w_lat = w // pipeline.vae_scale
            lats, noises = [], []
            for seed in seeds:
                lat, noise = pipeline._sample_noise(
                    seed, 1, h_lat, w_lat, self.candidate_steps, 1.0
                )
                lats.append(lat[0])
                noises.append(noise[:, 0])
            with self.worker.unstyled():  # no style merged while the batch runs
                res = pipeline.generate(
                    [prompt] * len(seeds), height=h, width=w,
                    num_inference_steps=self.candidate_steps, seed=seeds[0],
                    latents=np.stack(lats),
                    step_noises=np.stack(noises, axis=1),
                )
            return [res.images[i] for i in range(len(seeds))]
        images = []
        for seed in seeds:
            png, _ = self.worker.run_job(GenSpec(
                prompt=prompt, size=self.candidate_size,
                num_inference_steps=self.candidate_steps, seed=seed,
            ))
            images.append(decode_png(png)[..., :3])
        return images

    def _render(self, cand: DreamCandidate):
        png, _ = self.worker.run_job(GenSpec(
            prompt=cand.prompt, size=self.render_size,
            num_inference_steps=self.render_steps, seed=cand.seed,
        ))
        cand.rendered_png = png
        self.stats["rendered"] += 1
        self._store(cand)

    def _store(self, cand: DreamCandidate):
        """Persist to Redis: per-candidate hash + session score zset, and the
        rendered PNG, each for 24 h."""
        if self.redis is None:
            return
        try:
            key = f"{self.session_id}:{cand.candidate_id}"
            self.redis.hset(key, {
                "seed": str(cand.seed),
                "prompt": cand.prompt,
                "score": repr(cand.score),
                "rendered": "1" if cand.rendered_png else "0",
            })
            if cand.rendered_png:
                self.redis.set(key + ":png", cand.rendered_png, ex=24 * 3600)
            self.redis.expire(key, 24 * 3600)
            self.redis.zadd(f"{self.session_id}:scores", {cand.candidate_id: cand.score})
            self.redis.expire(f"{self.session_id}:scores", 24 * 3600)
        except Exception:
            logger.exception("dream store failed")

    # ------------------------------------------------------------------
    async def _dream_loop(self, duration_s: Optional[float]):
        loop = asyncio.get_running_loop()
        deadline = time.time() + duration_s if duration_s else None
        i = 0
        try:
            while not self._stop.is_set():
                if deadline and time.time() >= deadline:
                    break
                prompt = self.prompts[i % len(self.prompts)]
                seeds = [self.strategy.next_seed() for _ in range(self.candidate_batch)]
                images = await loop.run_in_executor(
                    None, self._generate_candidates, seeds, prompt
                )
                self.stats["generated"] += len(images)
                scores = await loop.run_in_executor(
                    None, self.scorer.score_batch, images, prompt
                )
                self.stats["scored"] += len(scores)
                for seed, img, score in zip(seeds, images, scores):
                    self.strategy.record_score(seed, score)
                    cand = DreamCandidate(seed=seed, prompt=prompt,
                                          score=score, image=img)
                    self.recent.appendleft(cand.summary())
                    if score >= self.score_threshold:
                        self.stats["kept"] += 1
                        self.top.append(cand)
                        self._store(cand)
                if i % self.render_interval == self.render_interval - 1 and self.top:
                    best = max(
                        (c for c in self.top if c.rendered_png is None),
                        key=lambda c: c.score, default=None,
                    )
                    if best is not None:
                        await loop.run_in_executor(None, self._render, best)
                elapsed = time.time() - self.stats["started_at"]
                if elapsed > 0:
                    self.stats["dreams_per_sec"] = self.stats["generated"] / elapsed
                i += 1
                await asyncio.sleep(0)  # yield to the event loop
        except Exception:
            logger.exception("dream loop crashed")
        finally:
            await loop.run_in_executor(None, self._finalize)

    def _finalize(self, max_renders: Optional[int] = None):
        """Render the top unrendered candidates at session end, up to
        ``YUME_FINALIZE_RENDERS`` (default 50)."""
        if max_renders is None:
            max_renders = int(os.environ.get("YUME_FINALIZE_RENDERS", "50"))
        pending = sorted(
            (c for c in self.top if c.rendered_png is None),
            key=lambda c: -c.score,
        )[:max_renders]
        for cand in pending:
            try:
                self._render(cand)
            except Exception:
                logger.exception("finalize render failed")

    # ------------------------------------------------------------------
    def get_status(self) -> Dict:
        running = bool(self._task and not self._task.done())
        return {
            "running": running,
            "session_id": self.session_id,
            "base_prompt": self.base_prompt,
            "stats": dict(self.stats),
            "top_count": len(self.top),
        }

    def get_top_dreams(self, n: int = 10) -> List[Dict]:
        return [
            c.summary()
            for c in sorted(self.top, key=lambda c: -c.score)[:n]
        ]

    def get_recent(self, n: int = 20) -> List[Dict]:
        return list(self.recent)[:n]

    def get_rendered_png(self, candidate_id: str) -> Optional[bytes]:
        for c in self.top:
            if c.candidate_id == candidate_id and c.rendered_png:
                return c.rendered_png
        if self.redis is not None and self.session_id:
            try:
                return self.redis.get(f"{self.session_id}:{candidate_id}:png")
            except Exception:
                return None
        return None


_worker: Optional[DreamWorker] = None


def get_dream_worker() -> Optional[DreamWorker]:
    return _worker


def set_dream_worker(worker: Optional[DreamWorker]):
    global _worker
    _worker = worker
