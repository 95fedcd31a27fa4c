"""Head-group flash attention: the hand-written CUDA kernel and its plain version.

The kernel (``csrc/flash_group.cu``) replaces the Pallas TPU kernels of two
layout probes: ``scripts/ab_transpose_free.py::flash_attention_4d`` (K1's
kernel over the 4-D ``[B, N, G, L]`` view) and
``scripts/ab_head_packing.py::_packed3_kernel`` (3 heads per lane block). One
block owns ``pack`` lane-adjacent heads and reads the group's ``L = pack * d``
contiguous lanes of each token row in place; each K/V tile is loaded once and
feeds all ``pack`` heads. bf16 runs the one-head kernel's tensor-core loop
(64 query rows per head) and rounds P to bf16 before the PV product, as both
Pallas kernels do; fp32 keeps a scalar kernel (128 query rows per block).

``flash_group`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors it computes ``flash_group_plain``.
The probe wrappers in ``dreamlab_tpu_torch/scripts`` count their own launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash_attention import attention_plain

# the compiled groups: the widest head each pack takes (csrc/flash_group.cu)
MAX_HEAD_DIM = {2: 64, 3: 40}

# kernel launches since the last reset
LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_void_p]
)


def flash_group_plain(q, k, v, scale: float):
    """[B, N, H, D] x [B, M, H, D] -> [B, N, H, D]: grouping heads changes no
    value, so the plain version is the plain attention."""
    return attention_plain(q, k, v, scale)


def _check_shapes(q, k, v, pack: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_group takes [B, N, H, D] tensors")
    b, n, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if pack not in MAX_HEAD_DIM:
        raise ValueError(f"pack {pack}: the kernel groups {sorted(MAX_HEAD_DIM)} heads")
    if h % pack != 0:
        raise ValueError(f"{h} heads do not split into groups of {pack}")
    if not 1 <= d <= MAX_HEAD_DIM[pack]:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM[pack]} for pack {pack}")
    if n < 1 or k.shape[1] < 1:
        raise ValueError("flash_group needs at least one query and one key")


def _check_cuda(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_group takes q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _build.dtype_code(q)
    b, _, h, d = q.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel's grid (65535)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"{name} must hold its heads lane-adjacent (strides "
                             f"[..., {d}, 1]), got {tuple(x.stride())}")


def flash_group(q, k, v, *, pack: int, scale: Optional[float] = None):
    """Non-causal attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D], one
    block per group of ``pack`` lane-adjacent heads.

    CUDA tensors run the kernel (output in q's dtype, contiguous); CPU
    tensors run ``flash_group_plain``. Both check the group geometry.
    """
    global LAUNCHES
    _check_shapes(q, k, v, pack)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_group_plain(q, k, v, scale)
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("dl_flash_group", _ARGTYPES)
    rc = fn(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _build.dtype_code(q), pack, b, n, k.shape[1], h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _build.stream_of(q),
    )
    _build.check(rc, "dl_flash_group")
    LAUNCHES += 1
    return out
