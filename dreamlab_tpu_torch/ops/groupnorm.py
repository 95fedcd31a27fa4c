"""GroupNorm(+SiLU) over NHWC: the hand-written CUDA kernels and their plain versions.

The kernels (``csrc/groupnorm.cu``) replace the two Pallas TPU kernels of
``dreamlab_tpu/ops/groupnorm.py::fused_group_norm_silu``:

- ``fused_group_norm_silu`` (K2 + K3, the main path): one launch of the
  cluster kernel per call. A thread block cluster owns one (batch row,
  channel slab); its blocks share their group statistics through
  distributed shared memory, fold gamma/beta into a, b, and apply
  ``y = x * a + b`` (+SiLU) to their own rows.
- ``group_norm_coeffs`` (K2, ``_stats_kernel``): the same kernel with the
  apply phase off, writing the fp32 per-(B, C) coefficients
  ``a = gamma * rsqrt(var + eps)`` and ``b = beta - mean * a``.
- ``scale_shift_silu`` (K3, ``_apply_kernel``): ``y = x * a + b`` then
  optional SiLU for given coefficients, in x's dtype.

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it computes its plain version.
``group_norm_plain`` mirrors ``dreamlab_tpu/models/layers.py::group_norm``
(+SiLU): the tests hold it to the JAX package, and the card holds the
kernels to it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# the widest slab the cluster kernel takes: 4096 fp32 channels are 1024
# vectors, one per thread of its largest block (the UNet's widest input, the
# skip concat, has 2560)
MAX_CHANNELS = 4096
_APPLY_THREADS = 256  # csrc/groupnorm.cu::kApplyThreads
_SMS = 132  # H100 SXM streaming multiprocessors: the grid aims to cover them at batch 1
MAX_CLUSTER = 16  # above 8 clusters are "non-portable": Hopper allows 16
MIN_SLAB_BYTES = 64  # a slab's row is at least two 32-byte sectors
MIN_BLOCK_ROWS = 16  # a cluster grows only while each block keeps this many rows
# 16-byte vectors per block up to which it runs 128 threads (small blocks:
# more of them fit on an SM, so a cluster of 16 is placed at once), and from
# which it runs 1024 (the VAE's large rows); 256 between
SMALL_BLOCK_WORK = 4 * 1024
WIDE_BLOCK_WORK = 16 * 1024
WIDE_CLUSTERS = 4  # 16-block clusters of 1024 threads per batch row, at most

# kernel launches since the last reset (the main path's proof that it ran).
# LAUNCHES counts every kernel this module launches: one per call of any
# wrapper. STATS_LAUNCHES counts the launches that computed the statistics
# (K2's work: the cluster kernel), APPLY_LAUNCHES those that wrote
# y = x*a + b (K3's work: the cluster kernel with its apply phase, or the
# apply kernel). A fused call is one launch and counts once in each.
LAUNCHES = 0
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0

_CLUSTER_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


def geometry(hw: int, c: int, groups: int, elt: int):
    """(slab, cluster, rows, threads) of one cluster-kernel call.

    slab: the narrowest run of whole groups that is whole 16-byte vectors,
    at least ``MIN_SLAB_BYTES`` wide and dividing C (C itself if none is).
    cluster: blocks per (batch row, slab), doubled while the slabs' blocks
    cover fewer than the card's SMs and each block keeps ``MIN_BLOCK_ROWS``
    rows. rows: H·W rows per block. threads: 128, 256 or 1024 by the
    vectors a block streams, and never fewer than one per vector of a slab
    row.
    A function of (H·W, C, groups) and the element size only, never of the
    batch: a row's statistics are summed in the same order alone or in a
    batch (batching never changes a row).
    """
    cg = c // groups
    vec = 16 // elt
    unit = cg * vec // math.gcd(cg, vec)
    slab = next((s for s in range(unit, c + 1, unit)
                 if c % s == 0 and s * elt >= MIN_SLAB_BYTES), c)
    nslabs = c // slab
    cluster = 1
    while (cluster < MAX_CLUSTER and nslabs * cluster < _SMS
           and hw >= 2 * cluster * MIN_BLOCK_ROWS):
        cluster *= 2
    nvec = slab // vec
    work = -(-hw // cluster) * nvec
    threads = 128 if work <= SMALL_BLOCK_WORK else 256 if work < WIDE_BLOCK_WORK else 1024
    if threads == 1024 and cluster == MAX_CLUSTER and nslabs > WIDE_CLUSTERS:
        # a 1024-thread block fills an SM, so a 16-block cluster takes a whole
        # GPC: more than a few of them run in two waves
        cluster //= 2
    threads = max(threads, -(-nvec // 32) * 32)
    return slab, cluster, -(-hw // cluster), threads


def _launch_cluster(x, scale, bias, groups: int, eps: float, *, silu: bool, apply: bool,
                    name: str):
    """One launch of the cluster kernel: y (apply) or the coefficients a, b."""
    global LAUNCHES, STATS_LAUNCHES, APPLY_LAUNCHES
    _check_x(x, name)
    _check_param(scale, x, name)
    _check_param(bias, x, name)
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    hw = x.numel() // (b * c)
    slab, cluster, rows, threads = geometry(hw, c, groups, x.element_size())
    if apply:
        y, a, shift = torch.empty_like(x), None, None
    else:
        y = None
        a = torch.empty((b, c), dtype=torch.float32, device=x.device)
        shift = torch.empty((b, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.kernel("dl_gn_cluster", _CLUSTER_ARGS)(
        x.device.index or 0, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ptr(y),
        ptr(a), ptr(shift), _build.dtype_code(x), b, hw, c, groups, slab, cluster, rows,
        threads, float(eps), int(silu), int(apply), _build.stream_of(x))
    _build.check(rc, "dl_gn_cluster")
    LAUNCHES += 1
    STATS_LAUNCHES += 1
    APPLY_LAUNCHES += int(apply)
    return y if apply else (a, shift)


def group_norm_coeffs(x, scale, bias, *, groups: int, eps: float = 1e-5):
    """K2: fp32 [B, C] coefficients a, b with GroupNorm(x) == x*a + b."""
    if x.device.type == "cpu":
        return group_norm_coeffs_plain(x, scale, bias, groups=groups, eps=eps)
    return _launch_cluster(x, scale, bias, groups, eps, silu=False, apply=False,
                           name="group_norm_coeffs")


def scale_shift_silu(x, a, b, *, silu: bool = True):
    """K3: y = x*a + b per (batch, channel), optional SiLU, in x's dtype."""
    global LAUNCHES, APPLY_LAUNCHES
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
    blocks = max(1, min(-(-nvec // _APPLY_THREADS), (16 * _SMS) // bsz))
    y = torch.empty_like(x)
    rc = _build.kernel("dl_gn_apply", _APPLY_ARGS)(
        x.device.index or 0, x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        _build.dtype_code(x), bsz, hw, c, int(silu), blocks, _build.stream_of(x))
    _build.check(rc, "dl_gn_apply")
    LAUNCHES += 1
    APPLY_LAUNCHES += 1
    return y


def fused_group_norm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                          silu: bool = True):
    """GroupNorm over the channel axis of [B, ..., C] (+SiLU), fp32 statistics.

    CUDA tensors run one launch of the cluster kernel (statistics and apply);
    CPU tensors run ``group_norm_plain``.
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups=groups, eps=eps, silu=silu)
    return _launch_cluster(x, scale, bias, groups, eps, silu=silu, apply=True,
                           name="fused_group_norm_silu")
