"""GroupNorm(+SiLU) over NHWC: the hand-written CUDA kernels and their plain versions.

The kernels (``csrc/groupnorm.cu``) replace the two Pallas TPU kernels of
``dreamlab_tpu/ops/groupnorm.py::fused_group_norm_silu``:

- ``group_norm_coeffs`` (K2, ``_stats_kernel``): per-(B, C) coefficients
  ``a = gamma * rsqrt(var + eps)`` and ``b = beta - mean * a`` with fp32
  group statistics. On the card it launches a per-tile statistics kernel and
  a tiny finalize kernel (the group combine the JAX package left to XLA).
- ``scale_shift_silu`` (K3, ``_apply_kernel``): ``y = x * a + b`` then
  optional SiLU, in x's dtype.

``fused_group_norm_silu`` composes the two. Each wrapper launches its kernel
for CUDA tensors and raises on anything the kernel does not take; for CPU
tensors it computes its plain version. ``group_norm_plain`` mirrors
``dreamlab_tpu/models/layers.py::group_norm`` (+SiLU): the tests hold it to
the JAX package, and the card holds the kernels to it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_CHANNELS = 4096  # the stats kernel's shared memory holds 2 x C floats per row group
_THREADS = 256  # csrc/groupnorm.cu::kThreads
_SMS = 132  # H100 SXM streaming multiprocessors: the stats grid aims at 2 blocks each

# kernel launches since the last reset (the main path's proof that it ran)
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0

_STATS_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
_FINALIZE_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_APPLY_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _group_stats(x, groups: int):
    """fp32 per-(B, G) mean and two-pass variance of [B, ..., C]."""
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    xg = x.float().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return xg, mean, var


def group_norm_plain(x, scale, bias, *, groups: int, eps: float = 1e-5,
                     silu: bool = False):
    """GroupNorm over the channel axis of [B, ..., C] with fp32 statistics,
    then optional SiLU; output in x's dtype."""
    xg, mean, var = _group_stats(x, groups)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float() + bias.float()
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def group_norm_coeffs_plain(x, scale, bias, *, groups: int, eps: float = 1e-5):
    """Plain K2: fp32 [B, C] coefficients a, b with GroupNorm(x) == x*a + b."""
    _, mean, var = _group_stats(x, groups)
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    inv = torch.rsqrt(var + eps).reshape(b, groups, 1).expand(b, groups, cg).reshape(b, c)
    mean_c = mean.reshape(b, groups, 1).expand(b, groups, cg).reshape(b, c)
    a = inv * scale.float()
    return a, bias.float() - mean_c * a


def scale_shift_silu_plain(x, a, b, *, silu: bool = True):
    """Plain K3: y = x*a + b per (batch, channel), optional SiLU, in x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x.float() * a.reshape(shape) + b.reshape(shape)
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_x(x, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA or CPU tensors, got {x.device}")
    _build.dtype_code(x)
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty [B, ..., C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"{name}: channels {c} must be a multiple of 8 and <= {MAX_CHANNELS}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous, 16-byte aligned x")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: batch {x.shape[0]} exceeds the kernel's grid (65535)")


def _check_param(p, x, name: str) -> None:
    if p.device != x.device or p.dtype != x.dtype or p.shape != (x.shape[-1],) \
            or not p.is_contiguous():
        raise ValueError(f"{name}: gamma/beta must be contiguous [{x.shape[-1]}] "
                         f"{x.dtype} tensors on {x.device}")


def group_norm_coeffs(x, scale, bias, *, groups: int, eps: float = 1e-5):
    """K2: fp32 [B, C] coefficients a, b with GroupNorm(x) == x*a + b."""
    global STATS_LAUNCHES
    if x.device.type == "cpu":
        return group_norm_coeffs_plain(x, scale, bias, groups=groups, eps=eps)
    _check_x(x, "group_norm_coeffs")
    _check_param(scale, x, "group_norm_coeffs")
    _check_param(bias, x, "group_norm_coeffs")
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    hw = x.numel() // (b * c)
    # enough blocks per batch row to fill the card twice over at batch 1. The
    # split depends on hw only, never on b: a row's statistics are then summed
    # in the same order alone or in a batch (batching never changes a row).
    tile_rows = -(-hw // min(hw, 2 * _SMS))
    ntiles = -(-hw // tile_rows)
    stats = torch.empty((b, ntiles, 2, c), dtype=torch.float32, device=x.device)
    a = torch.empty((b, c), dtype=torch.float32, device=x.device)
    shift = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dev, code, stream = x.device.index or 0, _build.dtype_code(x), _build.stream_of(x)
    rc = _build.kernel("dl_gn_stats", _STATS_ARGS)(
        dev, x.data_ptr(), stats.data_ptr(), code, b, hw, c, tile_rows, ntiles, stream)
    _build.check(rc, "dl_gn_stats")
    rc = _build.kernel("dl_gn_finalize", _FINALIZE_ARGS)(
        dev, stats.data_ptr(), scale.data_ptr(), bias.data_ptr(), a.data_ptr(),
        shift.data_ptr(), code, b, hw, c, groups, ntiles, tile_rows, float(eps), stream)
    _build.check(rc, "dl_gn_finalize")
    STATS_LAUNCHES += 1
    return a, shift


def scale_shift_silu(x, a, b, *, silu: bool = True):
    """K3: y = x*a + b per (batch, channel), optional SiLU, in x's dtype."""
    global APPLY_LAUNCHES
    if x.device.type == "cpu":
        return scale_shift_silu_plain(x, a, b, silu=silu)
    _check_x(x, "scale_shift_silu")
    bsz, c = x.shape[0], x.shape[-1]
    for t in (a, b):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (bsz, c) \
                or not t.is_contiguous():
            raise ValueError(f"scale_shift_silu: a, b must be contiguous float32 "
                             f"[{bsz}, {c}] on {x.device}")
    hw = x.numel() // (bsz * c)
    vec = 16 // x.element_size()
    nvec = hw * c // vec
    blocks = max(1, min(-(-nvec // _THREADS), (16 * _SMS) // bsz))
    y = torch.empty_like(x)
    rc = _build.kernel("dl_gn_apply", _APPLY_ARGS)(
        x.device.index or 0, x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        _build.dtype_code(x), bsz, hw, c, int(silu), blocks, _build.stream_of(x))
    _build.check(rc, "dl_gn_apply")
    APPLY_LAUNCHES += 1
    return y


def fused_group_norm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                          silu: bool = True):
    """GroupNorm over the channel axis of [B, ..., C] (+SiLU), fp32 statistics.

    CUDA tensors run K2 then K3; CPU tensors run ``group_norm_plain``.
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups=groups, eps=eps, silu=silu)
    a, b = group_norm_coeffs(x, scale, bias, groups=groups, eps=eps)
    return scale_shift_silu(x, a, b, silu=silu)
