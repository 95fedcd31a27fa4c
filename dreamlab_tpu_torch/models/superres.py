"""Sub-pixel CNN super-resolution (ESPCN), port of ``dreamlab_tpu/models/superres.py``.

The ONNX model zoo's "super-resolution-10": the luma plane in [0, 1], four
convs (ReLU after the first three) and a depth-to-space to r x the size.
As in the JAX package the image is cut into ``cfg.tile``-squared tiles,
edge-padded, and all tiles run as one batch (``upscale_luma``).

The convs go to cuDNN in fp32, as the JAX package computes them in fp32 on
XLA (TF32 stays off under ``pipeline.deterministic_backends``). No hand
kernel: the JAX package has no Pallas kernel here.

Params: ``{"conv1".."conv4": {"w": [O, I, kh, kw], "b": [O]}}`` fp32 (torch
layout; ``from_hwio`` places the JAX package's and the ONNX reader's HWIO
numpy trees).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .configs import SuperResConfig


def forward(params, cfg: SuperResConfig, y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] luma in [0, 1] -> [B, H r, W r, 1] fp32.

    ``F.pixel_shuffle`` on NCHW takes channel c r^2 + i r + j to offset
    (i, j) of output channel c: the JAX package's CRD depth-to-space."""
    x = y.to(params["conv1"]["w"].dtype).permute(0, 3, 1, 2)
    for i in (1, 2, 3, 4):
        w, b = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
        x = F.conv2d(x, w, b, padding=(w.shape[2] // 2, w.shape[3] // 2))
        if i < 4:
            x = F.relu(x)
    return F.pixel_shuffle(x, cfg.upscale).permute(0, 2, 3, 1).float()


def from_hwio(tree, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A numpy HWIO tree (``utils/onnx_weights.py``, the JAX package's
    ``init_params``) as fp32 torch OIHW on ``device`` (None: the CPU)."""
    return {name: {"w": torch.from_numpy(np.ascontiguousarray(
                       np.asarray(leaf["w"], np.float32).transpose(3, 2, 0, 1))).to(device),
                   "b": torch.from_numpy(np.asarray(leaf["b"], np.float32).copy()).to(device)}
            for name, leaf in tree.items()}


def init_params(cfg: SuperResConfig, rng: Optional[np.random.RandomState] = None,
                device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random params, drawn as the JAX package's ``init_params`` draws them
    (the same RandomState gives the same leaves)."""
    rng = rng or np.random.RandomState(0)
    c1, c2, c3 = cfg.channels
    k1, k2, k3, k4 = cfg.kernel_sizes
    tree = {}
    for name, (k, cin, cout) in zip(("conv1", "conv2", "conv3", "conv4"),
                                    ((k1, 1, c1), (k2, c1, c2), (k3, c2, c3),
                                     (k4, c3, cfg.upscale ** 2))):
        std = 1.0 / math.sqrt(k * k * cin)
        tree[name] = {"w": np.asarray(rng.uniform(-std, std, (k, k, cin, cout)), np.float32),
                      "b": np.asarray(rng.uniform(-std, std, (cout,)), np.float32)}
    return from_hwio(tree, device)


def tile_plan(h: int, w: int, tile: int) -> Tuple[int, int, int, int]:
    """Padded dims + tile counts for an H x W image cut into ``tile``-squared tiles."""
    th = (h + tile - 1) // tile
    tw = (w + tile - 1) // tile
    return th * tile, tw * tile, th, tw


def upscale_luma(params, cfg: SuperResConfig, y: torch.Tensor) -> torch.Tensor:
    """A full-size [H, W] float luma plane on the params' device -> [H r, W r]
    in [0, 1]: edge-padded to whole tiles, all tiles in one forward,
    reassembled, cropped and clipped."""
    h, w = y.shape
    t, r = cfg.tile, cfg.upscale
    ph, pw, th, tw = tile_plan(h, w, t)
    ypad = F.pad(y[None, None].float(), (0, pw - w, 0, ph - h), mode="replicate")[0, 0]
    # [th, t, tw, t] -> [th * tw, t, t, 1]
    tiles = ypad.reshape(th, t, tw, t).permute(0, 2, 1, 3).reshape(-1, t, t, 1)
    out = forward(params, cfg, tiles)
    out = out.reshape(th, tw, t * r, t * r).permute(0, 2, 1, 3).reshape(ph * r, pw * r)
    return out[: h * r, : w * r].clamp(0.0, 1.0)
