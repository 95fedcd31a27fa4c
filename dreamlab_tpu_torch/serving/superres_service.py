"""Super-resolution service: a bounded queue and worker threads upscaling
images with the ESPCN (port of ``dreamlab_tpu/serving/superres_service.py``).

As in the JAX package: the luma plane goes through the sub-pixel CNN in
224-squared tiles, 3x per pass, ``magnitude`` passes (1 to 3, stopped early
at ``max_pixels``); Cb and Cr are upscaled bicubically; with no weights the
service upscales the RGB image bicubically (the reference's contract, never
random convs); a full queue raises ``queue.Full``; a cancelled job is
skipped. Weights load from ``.onnx`` (``utils/onnx_weights.py``, no ONNX
runtime) or ``.safetensors`` (the port's own reader).

On the card every step runs there: the colour conversions and the bicubic
resize in PIL's fixed point (``utils/image_ops.py``), the convs on cuDNN in
fp32. Each worker thread launches on a CUDA stream of its own, holding the
device lock shared (``pipeline.device_lock``) while it queues a job's work,
and waits for the result outside it. There is no fallback: a failed
forward fails the job's future.

Codecs: PNG in through ``utils/png.decode_png`` and PNG out through
``encode_png``, so the default path needs no PIL. Everything else goes
through PIL, imported when a job needs it: JPEG output, and inputs the
port's decoder does not read (JPEG, WebP, 16-bit or interlaced PNG). Where
PIL is absent such a job fails with an error that names the package. PNG
bytes differ from the JAX service's (the port writes the Up filter at zlib
level 1); the pixels do not.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import superres
from ..models.configs import SuperResConfig
from ..pipeline import deterministic_backends, device_lock, resolve_device
from ..utils import image_ops
from ..utils.png import UnsupportedPNG, decode_png, encode_png

logger = logging.getLogger(__name__)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclasses.dataclass
class SRJob:
    data: bytes
    magnitude: int = 1
    out_format: str = "png"  # png | jpeg
    quality: int = 90
    future: Future = dataclasses.field(default_factory=Future)


def _pil_image():
    """PIL's Image module, for the codecs the port does not have."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("this image format needs PIL (the Pillow package), which is not "
                           "installed; PNG in and PNG out need no PIL") from e
    return Image


def decode_rgb(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H, W, 3], as PIL's ``Image.open(...).convert("RGB")``
    gives it: PNGs the port's decoder reads without PIL (gray replicated,
    alpha dropped, palettes expanded), anything else through PIL."""
    if data[:8] == _PNG_SIGNATURE:
        try:
            px = decode_png(data)
        except UnsupportedPNG:
            pass
        else:
            if px.shape[2] in (1, 2):
                return np.repeat(px[..., :1], 3, axis=2)
            return np.ascontiguousarray(px[..., :3])
    img = _pil_image().open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


def encode_image(rgb: np.ndarray, out_format: str, quality: int) -> bytes:
    """uint8 [H, W, 3] -> PNG (``encode_png``) or JPEG (PIL) bytes."""
    if out_format.lower() in ("jpeg", "jpg"):
        buf = io.BytesIO()
        _pil_image().fromarray(rgb).save(buf, format="JPEG", quality=int(quality))
        return buf.getvalue()
    return encode_png(rgb)


def load_sr_params(cfg: SuperResConfig, path: Optional[str] = None, device=None):
    """ESPCN weights on ``device`` (None: the CPU): ``.onnx`` (the reference
    artifact) or ``.safetensors`` (torch OIHW ``conv1..conv4``). None when no
    weights are available: the worker then upscales bicubically instead of
    serving random convs."""
    if path and os.path.exists(path):
        if path.endswith(".onnx"):
            from ..utils.onnx_weights import load_espcn_from_onnx

            return superres.from_hwio(load_espcn_from_onnx(path), device)
        if path.endswith(".safetensors"):
            from ..utils.safetensors import load_file

            raw = load_file(path)
            return {f"conv{i}": {"w": raw[f"conv{i}.weight"].float().contiguous().to(device),
                                 "b": raw[f"conv{i}.bias"].float().contiguous().to(device)}
                    for i in (1, 2, 3, 4)}
    if path:
        logger.warning("SR model %s not loadable; degrading to bicubic upscaling", path)
    return None


class SuperResWorker:
    """One SR model instance on ``device`` (None: the card); stateless
    between jobs. params None = bicubic mode (weights unavailable)."""

    def __init__(self, params, cfg: SuperResConfig, worker_id: int = 0, device=None):
        self.params = params
        self.cfg = cfg
        self.worker_id = worker_id
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def upscale_once(self, rgb: torch.Tensor) -> torch.Tensor:
        """uint8 [H, W, 3] -> uint8 [H r, W r, 3] on the tensor's device: the
        luma through the network, Cb and Cr bicubic (bicubic RGB without
        weights)."""
        r = self.cfg.upscale
        size = (rgb.shape[1] * r, rgb.shape[0] * r)
        if self.params is None:
            return image_ops.resize_bicubic(rgb, size)
        ycc = image_ops.rgb_to_ycbcr(rgb)
        out_y = superres.upscale_luma(self.params, self.cfg, ycc[..., 0].float() / 255.0)
        y8 = torch.round(out_y * 255.0).to(torch.uint8)
        cbcr = image_ops.resize_bicubic(ycc[..., 1:], size)
        return image_ops.ycbcr_to_rgb(torch.cat([y8[..., None], cbcr], dim=-1))

    def upscale_rgb(self, rgb: np.ndarray, magnitude: int,
                    max_pixels: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """uint8 [H, W, 3] -> (upscaled uint8 [H', W', 3], passes run)."""
        passes = max(1, min(int(magnitude), 3))
        h, w = rgb.shape[:2]
        r = self.cfg.upscale
        for p in range(passes):
            if max_pixels and h * w * r * r > max_pixels:
                logger.warning("SR: stopping at pass %d (max_pixels)", p)
                passes = p
                break
            h, w = h * r, w * r
        if self.stream is None:
            img = torch.from_numpy(rgb)
            for _ in range(passes):
                img = self.upscale_once(img)
            return img.numpy(), passes
        with device_lock(self.device).shared(), torch.cuda.stream(self.stream):
            host_in = torch.from_numpy(rgb)
            img = torch.empty_like(host_in, pin_memory=True).copy_(host_in).to(
                self.device, non_blocking=True)
            for _ in range(passes):
                img = self.upscale_once(img)
            out = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            out.copy_(img, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return out.numpy(), passes

    def upscale_bytes(self, data: bytes, magnitude: int, out_format: str, quality: int,
                      max_pixels: Optional[int] = None) -> Tuple[bytes, int]:
        out, passes = self.upscale_rgb(decode_rgb(data), magnitude, max_pixels)
        return encode_image(out, out_format, quality), passes


class SuperResService:
    """Bounded queue + N worker threads on ``device`` (None: the card)."""

    def __init__(self, model_path: Optional[str] = None, num_workers: int = 1,
                 queue_max: int = 32, cfg: Optional[SuperResConfig] = None,
                 max_pixels: Optional[int] = None, params=None, device=None):
        self.device = resolve_device(device)
        deterministic_backends()  # fp32 convs without TF32, as the JAX package computes them
        self.cfg = cfg or SuperResConfig()
        if params is not None:
            self.params = {name: {k: v.to(self.device) for k, v in leaf.items()}
                           for name, leaf in params.items()}
        else:
            self.params = load_sr_params(self.cfg, model_path, self.device)
        if self.params is not None:
            # the upscale factor of the loaded weights: conv4 emits r^2
            # channels for depth-to-space, so any ESPCN export just works
            r2 = self.params["conv4"]["w"].shape[0]
            r = int(round(r2 ** 0.5))
            if r * r == r2 and r != self.cfg.upscale:
                self.cfg = dataclasses.replace(self.cfg, upscale=r)
        self.model_desc = (
            os.path.basename(model_path)
            if self.params is not None and model_path
            else ("espcn-injected" if self.params is not None else "bicubic")
        )
        self.max_pixels = max_pixels
        self.queue: "queue.Queue[Optional[SRJob]]" = queue.Queue(maxsize=queue_max)
        self._shutdown = threading.Event()
        self._threads = []
        for i in range(max(1, num_workers)):
            t = threading.Thread(
                target=self._loop,
                args=(SuperResWorker(self.params, self.cfg, i, self.device),),
                name=f"sr-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _loop(self, worker: SuperResWorker):
        while not self._shutdown.is_set():
            try:
                job = self.queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if job is None:
                self.queue.task_done()
                break
            if not job.future.set_running_or_notify_cancel():
                self.queue.task_done()  # client gone: skip
                continue
            try:
                t0 = time.time()
                out, passes = worker.upscale_bytes(
                    job.data, job.magnitude, job.out_format, job.quality, self.max_pixels,
                )
                logger.info("SR job: %d passes in %.0f ms", passes, 1e3 * (time.time() - t0))
                job.future.set_result((out, passes))
            except Exception as e:
                logger.exception("SR job failed")
                job.future.set_exception(e)
            finally:
                self.queue.task_done()

    def submit(self, data: bytes, magnitude: int = 1, out_format: str = "png",
               quality: int = 90) -> Future:
        job = SRJob(data=data, magnitude=magnitude, out_format=out_format, quality=quality)
        self.queue.put_nowait(job)  # queue.Full propagates (HTTP 429)
        return job.future

    def shutdown(self):
        self._shutdown.set()
        for _ in self._threads:
            try:
                self.queue.put_nowait(None)
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout=2.0)
