"""Colour conversions and bicubic resizing as PIL computes them, in torch.

The JAX package's super-resolution service converts and resizes with PIL on
the host (``dreamlab_tpu/serving/superres_service.py``). The port does the
same arithmetic with plain torch ops on the tensor's device (the card in
serving, the CPU in the tests), in PIL's fixed point, so the results are
PIL's to the bit:

- RGB <-> YCbCr: JFIF coefficients, as PIL's ``ConvertYCbCr.c`` tabulates
  them (each table entry ``int(c * 64 * i + 0.5)``, truncated towards zero;
  sums shifted right by 6 bits);
- bicubic and Lanczos resizes (``Image.resize(..., BICUBIC)`` and
  ``LANCZOS``): the Keys kernel with a = -0.5 (support 2) or the 3-lobed
  Lanczos window (support 3), the support scaled by the reduction factor,
  weights normalised per output pixel and rounded to 22 fractional bits, two
  separable passes (horizontal, then vertical), each rounded and clipped to
  uint8 as PIL's 8-bit resampler does;
- RGB -> L (``Image.convert("L")``): ITU-R 601-2 luma in 16-bit fixed point,
  ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``.

Images are uint8 tensors [H, W, C]. The tables and the resize weights are
computed on the host and copied to the device asynchronously from pinned
memory, so a call queues its work without waiting for the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_SCALE = 6  # ConvertYCbCr.c's table bits
_PRECISION = 22  # Resample.c's PRECISION_BITS for 8-bit images (32 - 8 - 2)

# PIL's coefficients (ConvertYCbCr.c), rows Y, Cb, Cr over R, G, B ...
_TO_YCC = ((0.299, 0.587, 0.114), (-0.16874, -0.33126, 0.5), (0.5, -0.41869, -0.08131))
# ... and R from Cr, G from Cb and Cr, B from Cb
_CR_R, _CB_G, _CR_G, _CB_B = 1.402, -0.34414, -0.71414, 1.772


def _on(device, arr: np.ndarray) -> torch.Tensor:
    """A host array on ``device``, without a host wait on the card."""
    t = torch.from_numpy(arr)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _table(coef: float, device, offset: int = 0) -> torch.Tensor:
    """A PIL conversion table: entry i is int(coef * 64 * (i - offset) + 0.5),
    truncated towards zero as C's cast does."""
    i = np.arange(256) - offset
    return _on(device, np.trunc(coef * (1 << _SCALE) * i + 0.5).astype(np.int32))


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] RGB -> uint8 [..., 3] YCbCr, as ``Image.convert("YCbCr")``."""
    idx = rgb.long()
    out = []
    for row, offset in zip(_TO_YCC, (0, 128, 128)):
        acc = sum(_table(c, rgb.device)[idx[..., k]] for k, c in enumerate(row))
        out.append((acc >> _SCALE) + offset)
    return torch.stack(out, -1).to(torch.uint8)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] YCbCr -> uint8 [..., 3] RGB, as ``Image.convert("RGB")``
    of a YCbCr image."""
    dev = ycc.device
    y, cb, cr = ycc[..., 0].int(), ycc[..., 1].long(), ycc[..., 2].long()
    r = y + (_table(_CR_R, dev, 128)[cr] >> _SCALE)
    g = y + ((_table(_CB_G, dev, 128)[cb] + _table(_CR_G, dev, 128)[cr]) >> _SCALE)
    b = y + (_table(_CB_B, dev, 128)[cb] >> _SCALE)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic with a = -0.5 (PIL's ``bicubic_filter``)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    px = np.pi * np.where(x == 0.0, 1.0, x)
    return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    """The sinc windowed by a 3-lobed sinc (PIL's ``lanczos_filter``)."""
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


# filter name -> (kernel, support), as PIL's Resample.c declares them
_FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def resize_coeffs(in_size: int, out_size: int,
                  kind: str = "bicubic") -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one axis:
    (first input index [out], fixed-point weights [out, taps] int32). Taps
    past an output's last input have weight 0."""
    kernel, radius = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = radius * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates towards zero
    first = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    last = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size)
    k = np.arange(taps)[None, :]
    w = kernel((k + first[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(k < (last - first)[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION)),
                     np.trunc(0.5 + w * (1 << _PRECISION)))
    return first, fixed.astype(np.int32)


def _resize_axis(img: torch.Tensor, out_size: int, axis: int, kind: str) -> torch.Tensor:
    """One 8-bit pass of PIL's resampler along ``axis`` of uint8 [H, W, C]."""
    in_size = img.shape[axis]
    first, weights = resize_coeffs(in_size, out_size, kind)
    dev = img.device
    first, weights = _on(dev, first), _on(dev, weights)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = torch.full([out_size if a == axis else n for a, n in enumerate(img.shape)],
                     1 << (_PRECISION - 1), dtype=torch.int32, device=dev)
    for k in range(weights.shape[1]):
        idx = (first + k).clamp(max=in_size - 1)
        acc += img.index_select(axis, idx).int() * weights[:, k].view(shape)
    return (acc >> _PRECISION).clamp(0, 255).to(torch.uint8)


def _resize(img: torch.Tensor, size: Tuple[int, int], kind: str) -> torch.Tensor:
    w, h = size
    if w != img.shape[1]:
        img = _resize_axis(img, w, 1, kind)
    if h != img.shape[0]:
        img = _resize_axis(img, h, 0, kind)
    return img


def resize_bicubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """uint8 [H, W, C] -> uint8 [h, w, C] at ``size`` = (w, h), as
    ``Image.resize(size, Image.BICUBIC)``: horizontal pass, then vertical."""
    return _resize(img, size, "bicubic")


def resize_lanczos(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """uint8 [H, W, C] -> uint8 [h, w, C] at ``size`` = (w, h), as
    ``Image.resize(size, Image.LANCZOS)``."""
    return _resize(img, size, "lanczos")


def rgb_to_l(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] RGB -> uint8 [...] luma, as ``Image.convert("L")``."""
    c = rgb.int()
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).to(torch.uint8)
