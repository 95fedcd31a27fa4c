"""Head-group flash attention: the hand-written CUDA kernels and their plain version.

The kernels replace the Pallas TPU kernels of two layout probes:
``scripts/ab_transpose_free.py::flash_attention_4d`` (K1's kernel over the
4-D ``[B, N, G, L]`` view) and ``scripts/ab_head_packing.py::_packed3_kernel``
(3 heads per lane block). One block owns ``pack`` lane-adjacent heads and
reads the group's ``L = pack * d`` contiguous lanes of each token row in
place; each K/V tile is loaded once and feeds all ``pack`` heads.
``route(q, k, v, pack)`` names the kernel that takes the inputs, from their
dtype, alignment, strides and head dim, or None:

- ``"wgmma"`` (``csrc/flash_group_wgmma.cu``, ``flash_group_wgmma_kernel``):
  bf16 that TMA can describe, i.e. 16-byte aligned bases, batch, token and
  head strides positive multiples of 8 elements (16 bytes), d % 8 == 0 and
  d <= ``MAX_HEAD_DIM[pack]``. Hopper's wgmma and TMA with a producer warp:
  one TMA box brings a chunk of all ``pack`` heads' K or V tile, and
  consumer warpgroup c computes head c (64 query rows), in the consumer loop
  of K1's wgmma kernel (``csrc/flash_sm90.cuh``). It rounds P to bf16
  before the PV product, as both Pallas kernels do.
- ``"scalar"`` (``csrc/flash_group.cu``, ``flash_group_fwd_kernel``): fp32,
  one thread per (query row, head), since the tensor cores would take fp32
  as TF32.
- None for anything else (bf16 at d = 20 or unaligned views): a launch on
  them raises.

The route is a dispatch, not a fallback: a refused or failed launch raises
and is never run again on another kernel.

``flash_group`` launches the routed kernel for CUDA tensors and raises on
anything ``route`` refuses; for CPU tensors it computes
``flash_group_plain``. ``launch`` runs the kernel without counting. The
probe wrappers in ``dreamlab_tpu_torch/scripts`` count their own launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash_attention import attention_plain

# the compiled groups: the widest head each pack takes (the bf16 kernel and
# the fp32 one)
MAX_HEAD_DIM = {2: 64, 3: 40}

# kernel launches since the last reset, in all and by route
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "scalar": 0}
ROUTES = tuple(ROUTE_LAUNCHES)

# dl_flash_group: device, q, k, v, o, dtype, pack, b, n, m, h, d, 6 strides, scale, stream
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_void_p]
)
# dl_flash_group_wgmma: device, q, k, v, o, pack, b, n, m, h, d, 9 strides, scale, stream
_WGMMA_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
)
# C entry points' own return codes (csrc/flash_sm90.cuh)
_WGMMA_ERRORS = {-1: "inputs the kernel does not take", -2: "the driver refused a tensor map",
                 -3: "registers at entry differ from what setmaxnreg was sized for"}


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


def route(q, k, v, pack: int) -> Optional[str]:
    """The kernel that takes these inputs: "wgmma", "scalar" or None (see
    the module docstring). A pure function of dtype, group, head dim, base
    alignment and strides; it launches nothing and reads no device. Raises
    on a group the kernels do not take."""
    _check_shapes(q, k, v, pack)
    if q.dtype == torch.float32:
        return "scalar"
    if q.dtype != torch.bfloat16 or q.shape[-1] % 8:
        return None
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return None
    return "wgmma"


def _launch_wgmma(q, k, v, pack: int, scale: float):
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("dl_flash_group_wgmma", _WGMMA_ARGTYPES)
    rc = fn(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pack, b, n, k.shape[1], h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.stream_of(q),
    )
    if rc in _WGMMA_ERRORS:
        raise RuntimeError(f"dl_flash_group_wgmma: {_WGMMA_ERRORS[rc]} (code {rc})")
    _build.check(rc, "dl_flash_group_wgmma")
    return out


_INSTANCE_FIELDS = ("pack", "head_dim_padded", "threads", "entry_registers",
                    "consumer_registers", "block_k", "stages", "smem_bytes")


def wgmma_instances() -> list:
    """The built instances of the wgmma kernel and their launch shape (from
    the library: ``dl_flash_group_wgmma_instances``), one dict each."""
    fn = _build.kernel("dl_flash_group_wgmma_instances", [ctypes.c_void_p, ctypes.c_int])
    width = len(_INSTANCE_FIELDS)
    rows = (ctypes.c_int * (width * 16))()
    n = fn(ctypes.cast(rows, ctypes.c_void_p), 16)
    return [dict(zip(_INSTANCE_FIELDS, rows[width * i:width * (i + 1)])) for i in range(n)]


def launch(q, k, v, *, pack: int, scale: float):
    """Run the kernel ``route`` picks on CUDA tensors [B, N, H, D] x
    [B, M, H, D]; count nothing. Raises on anything no kernel takes."""
    _check_cuda(q, k, v)
    picked = route(q, k, v, pack)
    if picked is None:
        raise ValueError(
            f"no kernel takes {q.dtype} q, k, v of shape {tuple(q.shape)} and strides "
            f"{q.stride()}, {k.stride()}, {v.stride()}: bf16 needs 16-byte aligned bases, "
            f"strides multiples of 8 and d % 8 == 0")
    if picked == "wgmma":
        return _launch_wgmma(q, k, v, pack, scale)
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
    return out


def flash_group(q, k, v, *, pack: int, scale: Optional[float] = None):
    """Non-causal attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D], one
    block per group of ``pack`` lane-adjacent heads.

    CUDA tensors run the kernel ``route`` picks (output in q's dtype,
    contiguous) and raise where it picks none; CPU tensors run
    ``flash_group_plain`` and count nothing.
    Both check the group geometry.
    """
    global LAUNCHES
    _check_shapes(q, k, v, pack)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_group_plain(q, k, v, scale)
    out = launch(q, k, v, pack=pack, scale=scale)
    LAUNCHES += 1
    ROUTE_LAUNCHES[route(q, k, v, pack)] += 1
    return out
