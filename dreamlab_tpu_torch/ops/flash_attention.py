"""Flash attention: the hand-written CUDA kernel and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``dreamlab_tpu/ops/flash_attention.py::_flash_kernel``. It reads
``[B, N, H, D]`` tensors in place through their strides and masks the ragged
key edge itself, so the TPU wrapper's head packing, block table and fold
transposes have no counterpart here. bf16 runs both products on the tensor
cores (``mma.sync``, P rounded to bf16 before the PV product as the Pallas
kernel rounds it); fp32 runs a scalar kernel, since the tensor cores would
take fp32 as TF32.

``flash_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; for CPU tensors it computes
``attention_plain``, which mirrors ``dreamlab_tpu/ops/attention.py::
_xla_attention`` (fp32 logits and softmax, probabilities cast to v's dtype,
fp32 PV) and is what the tests hold against the JAX package.

``pack_geometry`` keeps the JAX package's head-packing rule for the probes
of ``dreamlab_tpu_torch/scripts``, which group lane-adjacent heads
(``ops/flash_group.py``); this kernel does not pack.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_HEAD_DIM = 128
LANES = 128  # the TPU's lane width, the budget of pack_geometry

# the main path's tiles (csrc/flash_attention.cu::kBlockQ, kBlockK): 128
# queries (8 warps of 16 rows) per block, keys in tiles of 64. The probes'
# tile sweep adds these, compiled for bf16 at d <= 48 (the d = 40 head's
# mma depth) only; each key tile is a multiple of the mma's 16 keys.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 64
SWEEP_BLOCK_Q = (64, 128)
SWEEP_BLOCK_K = (16, 32, 64)
SWEEP_MAX_HEAD_DIM = 48

# kernel launches since the last reset (the main path's proof that it ran)
LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
)


def pack_geometry(h: int, d: int):
    """(pack, lane width L) of the JAX package's ``_pack_geometry``: pack is
    the largest divisor of h within floor(128 / d), capped at 8, for d a
    multiple of 8 and at most 64; otherwise one head, (1, d) when d % 8 == 0
    and (1, 128) else."""
    if d % 8 == 0 and d <= LANES // 2 and h > 0:
        for cand in range(min(LANES // d, h, 8), 1, -1):
            if h % cand == 0:
                return cand, cand * d
    return 1, d if d % 8 == 0 else LANES


def _tiles(block_q: int, block_k: int):
    """The (block_q, block_k) a call asks for, 0 meaning the default tile."""
    if block_q not in (0, *SWEEP_BLOCK_Q) or block_k not in (0, *SWEEP_BLOCK_K):
        raise ValueError(f"tiles block_q={block_q}, block_k={block_k}: block_q must be "
                         f"0 or one of {SWEEP_BLOCK_Q}, block_k 0 or one of {SWEEP_BLOCK_K}")
    return block_q or DEFAULT_BLOCK_Q, block_k or DEFAULT_BLOCK_K


def attention_plain(q, k, v, scale: float):
    """[B, N, H, D] x [B, M, H, D] -> [B, N, H, D], the plain reference math."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention takes q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _build.dtype_code(q)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, N, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one query and one key")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel's grid (65535)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def launch(q, k, v, *, scale: float, block_q: int = 0, block_k: int = 0):
    """Run the kernel on CUDA tensors [B, N, H, D] x [B, M, H, D]; count nothing.

    ``flash_attention`` and the layout probe ``scripts/ab_attention_layout.py``
    call this and keep their own launch counts. Raises on anything the
    kernel does not take, tiles included.
    """
    _check_inputs(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    tiles = _tiles(block_q, block_k)
    if tiles == (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
        tiles = (0, 0)
    elif q.dtype != torch.bfloat16 or d > SWEEP_MAX_HEAD_DIM:
        raise ValueError(f"tiles {tiles} are compiled for bfloat16 at d <= "
                         f"{SWEEP_MAX_HEAD_DIM} only, got {q.dtype} at d = {d}")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("dl_flash_attention", _ARGTYPES)
    rc = fn(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _build.dtype_code(q), b, n, m, h, d, *tiles,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.stream_of(q),
    )
    _build.check(rc, "dl_flash_attention")
    return out


def flash_attention(q, k, v, *, scale: Optional[float] = None, block_q: int = 0,
                    block_k: int = 0):
    """Non-causal multi-head attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D].

    CUDA tensors run the kernel (output in q's dtype, contiguous); CPU
    tensors run ``attention_plain``. block_q / block_k = 0 take the default
    tiles; other values are the probes' tile sweep (see SWEEP_BLOCK_Q/K).
    """
    global LAUNCHES
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        _tiles(block_q, block_k)
        return attention_plain(q, k, v, scale)
    out = launch(q, k, v, scale=scale, block_q=block_q, block_k=block_k)
    LAUNCHES += 1
    return out
