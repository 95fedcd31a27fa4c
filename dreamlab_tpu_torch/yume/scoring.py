"""Candidate scorers (port of ``dreamlab_tpu/yume/scoring.py``).

- ``CLIPScorer``: prompt <-> image cosine similarity clamped to [0, 1], with a
  text-embedding cache and batch scoring, over any model with
  ``embed_text(str) -> vec`` and ``embed_images(arrays) -> vecs``;
- ``NativeCLIP``: that model as the port's CLIP text and ViT image towers on
  one device (``loader.load_clip_model`` builds it from an HF directory);
- ``HFCLIPAdapter``: a transformers ``CLIPModel`` and processor, imported by
  the caller (``dream_init.py``), never by this module;
- ``AestheticScorer``: 0.5 sharpness + 0.3 contrast + 0.2 colour variety;
- ``CompositeScorer``: a weighted blend.

The numpy scorers are copies of the JAX package's.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import clip_text, clip_vision
from ..pipeline import _place_params, deterministic_backends, device_lock, resolve_device

logger = logging.getLogger(__name__)


class CLIPScorer:
    def __init__(self, model):
        """model: embed_text(str) -> [D]; embed_images(list[np.ndarray HWC u8])
        -> [N, D]."""
        self.model = model
        self._text_cache: Dict[str, np.ndarray] = {}

    def _text_embedding(self, prompt: str) -> np.ndarray:
        if prompt not in self._text_cache:
            v = np.asarray(self.model.embed_text(prompt), np.float32)
            self._text_cache[prompt] = v / (np.linalg.norm(v) + 1e-8)
        return self._text_cache[prompt]

    def score(self, image: np.ndarray, prompt: str) -> float:
        return self.score_batch([image], prompt)[0]

    def score_batch(self, images: Sequence[np.ndarray], prompt: str) -> List[float]:
        t = self._text_embedding(prompt)
        vecs = np.asarray(self.model.embed_images(list(images)), np.float32)
        vecs = vecs / (np.linalg.norm(vecs, axis=-1, keepdims=True) + 1e-8)
        sims = vecs @ t
        # cosine in [-1, 1] -> clamped to [0, 1]
        return [float(np.clip(s, 0.0, 1.0)) for s in sims]


class NativeCLIP:
    """The CLIP text and image towers on ``device`` (None: the CUDA device;
    "cpu" runs them on the CPU), features returned as float32 numpy.

    On the card every forward runs under ``torch.inference_mode()`` on a
    stream of its own, holding the device's launch lock shared
    (``pipeline.device_lock``) and releasing it before it waits for the
    result: a bucket captured on another thread meanwhile cannot take these
    launches into its graph.
    """

    def __init__(self, *, text_params, text_cfg, vision_params, vision_cfg, tokenizer,
                 device=None, dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        deterministic_backends()
        self.text_cfg, self.vision_cfg, self.tokenizer = text_cfg, vision_cfg, tokenizer
        # dtype None keeps the weights' own (the file's)
        self._text_params = _place_params(
            text_params, dtype or text_params["token_embedding"]["w"].dtype, self.device)
        self._vision_params = _place_params(
            vision_params, dtype or vision_params["patch_embedding"]["w"].dtype, self.device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _run(self, forward) -> np.ndarray:
        """``forward()`` -> float32 [B, D] on the host."""
        if self.stream is None:
            with torch.inference_mode():
                return forward().float().numpy()
        with torch.inference_mode(), device_lock(self.device).shared(), \
                torch.cuda.stream(self.stream):
            feats = forward().float()
            out = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
            out.copy_(feats, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return out.numpy()

    def _text_features(self, prompt: str) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenizer(prompt)).long().to(self.device)
        return clip_text.encode_text(self._text_params, ids, self.text_cfg)[1]

    def _image_features(self, images) -> torch.Tensor:
        pixels = clip_vision.preprocess_images(images, self.vision_cfg, self.device)
        return clip_vision.encode_image(self._vision_params, pixels, self.vision_cfg)

    def embed_text(self, prompt: str) -> np.ndarray:
        return self._run(lambda: self._text_features(prompt))[0]

    def embed_images(self, images) -> np.ndarray:
        return self._run(lambda: self._image_features(images))


class HFCLIPAdapter:
    """A transformers ``CLIPModel`` and ``CLIPProcessor`` in the scorer's
    interface, the model on ``device`` (None: the CUDA device)."""

    def __init__(self, model, processor, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.processor = processor

    def _on_device(self, inputs):
        return {k: v.to(self.device) for k, v in inputs.items()}

    def embed_text(self, prompt: str):
        inputs = self.processor(text=[prompt], return_tensors="pt", padding=True)
        with torch.inference_mode():
            return self.model.get_text_features(**self._on_device(inputs))[0].float().cpu().numpy()

    def embed_images(self, images):
        from PIL import Image

        inputs = self.processor(images=[Image.fromarray(im) for im in images],
                                return_tensors="pt")
        with torch.inference_mode():
            return self.model.get_image_features(**self._on_device(inputs)).float().cpu().numpy()


def _to_gray(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114], np.float32)
    return img


def _laplacian_var(gray: np.ndarray) -> float:
    """Sharpness: variance of the 4-neighbour Laplacian."""
    lap = (
        -4.0 * gray[1:-1, 1:-1]
        + gray[:-2, 1:-1] + gray[2:, 1:-1]
        + gray[1:-1, :-2] + gray[1:-1, 2:]
    )
    return float(lap.var())


class AestheticScorer:
    """Heuristic fallback when no CLIP is available: 0.5 sharpness + 0.3
    contrast + 0.2 colour variety, each normalised to [0, 1]."""

    SHARPNESS_NORM = 1000.0
    CONTRAST_NORM = 80.0
    COLOR_NORM = 60.0

    def score(self, image: np.ndarray, prompt: str = "") -> float:
        img = np.asarray(image, np.float32)
        gray = _to_gray(img)
        sharp = min(_laplacian_var(gray) / self.SHARPNESS_NORM, 1.0)
        contrast = min(float(gray.std()) / self.CONTRAST_NORM, 1.0)
        if img.ndim == 3:
            color = min(float(img.std(axis=(0, 1)).mean()) / self.COLOR_NORM, 1.0)
        else:
            color = 0.0
        return float(0.5 * sharp + 0.3 * contrast + 0.2 * color)

    def score_batch(self, images, prompt: str = ""):
        return [self.score(im, prompt) for im in images]


class CompositeScorer:
    def __init__(self, scorers: Sequence, weights: Optional[Sequence[float]] = None):
        self.scorers = list(scorers)
        w = np.asarray(
            weights if weights is not None else [1.0] * len(self.scorers),
            np.float64,
        )
        self.weights = w / w.sum()

    def score(self, image: np.ndarray, prompt: str = "") -> float:
        return float(sum(
            w * s.score(image, prompt)
            for w, s in zip(self.weights, self.scorers)
        ))

    def score_batch(self, images, prompt: str = ""):
        parts = [s.score_batch(images, prompt) for s in self.scorers]
        return [
            float(sum(w * p[i] for w, p in zip(self.weights, parts)))
            for i in range(len(images))
        ]
