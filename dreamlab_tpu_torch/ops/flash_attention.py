"""Flash attention: the hand-written CUDA kernels and their plain PyTorch version.

The kernels replace the Pallas TPU kernel
``dreamlab_tpu/ops/flash_attention.py::_flash_kernel``. They read
``[B, N, H, D]`` tensors in place through their strides and mask the ragged
edges themselves, so the TPU wrapper's head packing, block table and fold
transposes have no counterpart here. ``route(q, k, v)`` picks one before any
launch, from the inputs' dtype, alignment, strides and head dim:

- ``"wgmma"`` (``csrc/flash_wgmma.cu``, ``flash_wgmma_kernel``): bf16 that
  TMA can describe, i.e. 16-byte aligned bases, batch, token and head strides
  positive multiples of 8 elements, d % 8 == 0 and d <= 128. Hopper's wgmma
  and TMA with a producer warp; every shape the pipelines give the kernel
  takes this route, packed projection views included.
- ``"mma"`` (``csrc/flash_attention.cu``, ``flash_mma_kernel``): other bf16
  inputs (d = 20, odd head dims, unaligned views) and the probes' tile sweep
  (``block_q`` / ``block_k`` != 0). ``mma.sync`` on the tensor cores.
- ``"scalar"`` (``flash_fwd_kernel``): fp32, one query row per thread, since
  the tensor cores would take fp32 as TF32.

Both bf16 kernels round P to bf16 before the PV product as the Pallas
kernel does. The route is a dispatch, not a fallback: a refused or failed
launch raises and is never run again on another route.

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

# kernel launches since the last reset (the main path's proof that it ran),
# in all and by route
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "mma": 0, "scalar": 0}
ROUTES = tuple(ROUTE_LAUNCHES)

# the wgmma kernel's tiles (csrc/flash_wgmma.cu): 64 query rows per consumer
# warpgroup, one to three consumers a block (wgmma_consumers), keys in tiles of 64
WGMMA_ROWS = 64
WGMMA_BLOCK_K = 64
H100_SMS = 132
# C entry points' own return codes (csrc/flash_wgmma.cu)
_WGMMA_ERRORS = {-1: "inputs the kernel does not take", -2: "the driver refused a tensor map",
                 -3: "registers at entry differ from what setmaxnreg was sized for"}

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
)
# dl_flash_wgmma: device, q, k, v, o, b, n, m, h, d, consumers, 9 strides, scale, stream
_WGMMA_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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


def route(q, k, v, block_q: int = 0, block_k: int = 0) -> str:
    """The kernel that takes these inputs: "wgmma", "mma" or "scalar" (see
    the module docstring). A pure function of dtype, tiles, head dim, base
    alignment and strides; it launches nothing and reads no device."""
    if q.dtype == torch.float32:
        return "scalar"
    if block_q or block_k or q.shape[-1] % 8 or q.shape[-1] > MAX_HEAD_DIM:
        return "mma"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return "mma"
    return "wgmma"


def wgmma_consumers(n: int, h: int, d: int, sms: int = H100_SMS) -> int:
    """Consumer warpgroups per block of the wgmma kernel (64 query rows
    each, one block an SM with two or three, two blocks an SM with one),
    from N, H and d only, never from the batch: a batch row runs the tiles
    of its solo call, and a tile's arithmetic does not depend on the choice.

    Blocks that share K and V among more rows move fewer bytes, so two
    consumers are the rule. One where 128-row blocks would leave half the
    SMs idle or more at batch 1 (SD1.5's [1024, 8, 80]: 128 blocks instead
    of 64; not the mesh's [4096, 4, 40], whose 128 such blocks fill all
    but 4 SMs and ran twice as fast as 256 of one consumer); three
    (d <= 64) where 192-row blocks take no more rows per SM in all, at
    waves of ``sms`` blocks (SDXL's [1024, 20, 64]: 120 blocks in one wave
    instead of 160, whose last 28 make a second; its [4096, 10, 64]: two
    waves of 192 rows against three of 128, a tie that three win on the
    H100 by sharing K and V among more rows)."""
    def blocks(c):
        return -(-n // (WGMMA_ROWS * c)) * h

    if d > 80:
        return 2
    if blocks(2) <= sms // 2:
        return 1
    rows = {c: -(-blocks(c) // sms) * c for c in (2, 3)}
    return 3 if d <= 64 and rows[3] <= rows[2] else 2


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


def _launch_wgmma(q, k, v, scale: float):
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    fn = _build.kernel("dl_flash_wgmma", _WGMMA_ARGTYPES)
    rc = fn(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, k.shape[1], h, d, wgmma_consumers(n, h, d, sms),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.stream_of(q),
    )
    if rc in _WGMMA_ERRORS:
        raise RuntimeError(f"dl_flash_wgmma: {_WGMMA_ERRORS[rc]} (code {rc})")
    _build.check(rc, "dl_flash_wgmma")
    return out


_INSTANCE_FIELDS = ("head_dim_padded", "consumers", "threads", "blocks_per_sm", "entry_registers",
                    "consumer_registers", "block_k", "stages", "smem_bytes", "pipelined")


def wgmma_instances() -> list:
    """The built instances of the wgmma kernel and their launch shape (from
    the library: ``dl_flash_wgmma_instances``), one dict each."""
    fn = _build.kernel("dl_flash_wgmma_instances", [ctypes.c_void_p, ctypes.c_int])
    rows = (ctypes.c_int * (10 * 32))()
    n = fn(ctypes.cast(rows, ctypes.c_void_p), 32)
    return [dict(zip(_INSTANCE_FIELDS, rows[10 * i:10 * i + 10])) for i in range(n)]


def launch(q, k, v, *, scale: float, block_q: int = 0, block_k: int = 0,
           kernel: Optional[str] = None):
    """Run a kernel on CUDA tensors [B, N, H, D] x [B, M, H, D]; count nothing.

    ``kernel`` None runs the one ``route`` picks. A same-run A/B may name
    "mma" for any bf16 input (``chip_smoke.py`` times the mma.sync kernel
    beside the wgmma one); "wgmma" only where ``route`` gives it.
    ``flash_attention`` and the layout probe ``scripts/ab_attention_layout.py``
    call this and keep their own launch counts. Raises on anything the
    kernel does not take, tiles included.
    """
    _check_inputs(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    tiles = _tiles(block_q, block_k)
    picked = route(q, k, v, block_q, block_k)
    if kernel is not None and kernel != picked and not (
            kernel == "mma" and picked == "wgmma"):
        raise ValueError(f"kernel {kernel!r} does not take these inputs (route: {picked!r})")
    if (kernel or picked) == "wgmma":
        return _launch_wgmma(q, k, v, scale)
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

    CUDA tensors run the kernel ``route`` picks (output in q's dtype,
    contiguous); CPU tensors run ``attention_plain`` and count nothing.
    block_q / block_k = 0 take the default tiles; other values are the
    probes' tile sweep (see SWEEP_BLOCK_Q/K) on the mma.sync kernel.
    """
    global LAUNCHES
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        _tiles(block_q, block_k)
        return attention_plain(q, k, v, scale)
    out = launch(q, k, v, scale=scale, block_q=block_q, block_k=block_k)
    LAUNCHES += 1
    ROUTE_LAUNCHES[route(q, k, v, block_q, block_k)] += 1
    return out
