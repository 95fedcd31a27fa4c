"""Flash attention: the hand-written CUDA kernels and their plain PyTorch version.

The kernels replace the Pallas TPU kernel
``dreamlab_tpu/ops/flash_attention.py::_flash_kernel``. They read
``[B, N, H, D]`` tensors in place through their strides and mask the ragged
edges themselves, so the TPU wrapper's head packing, block table and fold
transposes have no counterpart here. ``route(q, k, v)`` names the kernel that
takes the inputs, from their dtype, head dim, alignment and strides, or None:

- ``"wgmma"`` (``csrc/flash_wgmma.cu``, ``flash_wgmma_kernel``): bf16 that
  TMA can describe, i.e. 16-byte aligned bases, batch, token and head strides
  positive multiples of 8 elements, d % 8 == 0 and d <= 128. Hopper's wgmma
  and TMA with a producer warp; it rounds P to bf16 before the PV product as
  the Pallas kernel does. Every shape the pipelines give the kernel takes
  this route, packed projection views included.
- ``"scalar"`` (``csrc/flash_attention.cu``, ``flash_fwd_kernel``): fp32,
  one query row per thread, since the tensor cores would take fp32 as TF32.
- None for anything else (bf16 at d = 20 or unaligned views, fp16, d > 128,
  a strided head dim): ``ops/attention.py`` sends such calls to the plain
  path, and a launch on them raises.

The route is a dispatch, not a fallback: a refused or failed launch raises
and is never run again on another kernel.

``flash_attention`` launches the routed kernel for CUDA tensors and raises
on anything ``route`` refuses; for CPU tensors it computes
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

# kernel launches since the last reset (the main path's proof that it ran),
# in all and by route
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "scalar": 0}
ROUTES = tuple(ROUTE_LAUNCHES)

# the wgmma kernel's tiles (csrc/flash_wgmma.cu): 64 query rows per consumer
# warpgroup, one to three consumers a block (wgmma_consumers), keys in tiles of 64
WGMMA_ROWS = 64
WGMMA_BLOCK_K = 64
H100_SMS = 132
# C entry points' own return codes (csrc/flash_wgmma.cu)
_WGMMA_ERRORS = {-1: "inputs the kernel does not take", -2: "the driver refused a tensor map",
                 -3: "registers at entry differ from what setmaxnreg was sized for"}

# dl_flash_attention: device, q, k, v, o, dtype, b, n, m, h, d, 9 strides, scale, stream;
# dl_flash_wgmma: device, q, k, v, o, b, n, m, h, d, consumers, 9 strides, scale, stream
_ARGTYPES = (
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


def route(q, k, v) -> Optional[str]:
    """The kernel that takes these inputs: "wgmma", "scalar" or None (see
    the module docstring). A pure function of dtype, head dim, base
    alignment and strides; it launches nothing and reads no device."""
    d = q.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM or any(t.stride(-1) != 1 for t in (q, k, v)):
        return None
    if q.dtype == torch.float32:
        return "scalar"
    if q.dtype != torch.bfloat16 or d % 8:
        return None
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return None
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
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one query and one key")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel's grid (65535)")


def _launch_wgmma(q, k, v, scale: float):
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    fn = _build.kernel("dl_flash_wgmma", _ARGTYPES)
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


def launch(q, k, v, *, scale: float):
    """Run the kernel ``route`` picks on CUDA tensors [B, N, H, D] x
    [B, M, H, D]; count nothing. ``flash_attention`` and the layout probe
    ``scripts/ab_attention_layout.py`` call this and keep their own launch
    counts. Raises on anything no kernel takes.
    """
    _check_inputs(q, k, v)
    picked = route(q, k, v)
    if picked is None:
        raise ValueError(
            f"no kernel takes {q.dtype} q, k, v of shapes {tuple(q.shape)}, {tuple(k.shape)} "
            f"and strides {q.stride()}, {k.stride()}, {v.stride()}: bf16 needs 16-byte "
            f"aligned bases, strides multiples of 8 and d % 8 == 0, any dtype "
            f"d <= {MAX_HEAD_DIM} and a contiguous head dim")
    if picked == "wgmma":
        return _launch_wgmma(q, k, v, scale)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("dl_flash_attention", _ARGTYPES)
    rc = fn(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _build.dtype_code(q), b, n, k.shape[1], h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.stream_of(q),
    )
    _build.check(rc, "dl_flash_attention")
    return out


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """Non-causal multi-head attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D].

    CUDA tensors run the kernel ``route`` picks (output in q's dtype,
    contiguous) and raise where it picks none; CPU tensors run
    ``attention_plain`` and count nothing.
    """
    global LAUNCHES
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    out = launch(q, k, v, scale=scale)
    LAUNCHES += 1
    ROUTE_LAUNCHES[route(q, k, v)] += 1
    return out
