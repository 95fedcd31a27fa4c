"""Attention dispatch: the flash kernel on CUDA for the long spatial sequences,
the plain path everywhere else (port of ``dreamlab_tpu/ops/attention.py``).

Interface: [B, N, H, D] tensors with a separate head axis; softmax in fp32.
"""

from __future__ import annotations

from typing import Optional

from .batching import row_chunks
from .flash_attention import attention_plain, flash_attention, route


def _flash_supported(q, k, v) -> bool:
    """Whether the call takes the flash kernel, from shapes, dtype, strides
    and alignment alone (the device is the caller's check): a kernel takes
    the inputs (``route``: bf16 that TMA can describe, fp32, d <= 128) and
    the sequences are long enough to pay for it, at least 256 queries and
    256 keys. SD1.5 at 512²: N = 4096 (d = 40) and N = 1024 (d = 80). SDXL
    at 1024²: N = 4096 with 10 heads and N = 1024 with 20 heads, both
    d = 64 (its first level has no attention); at 1344x768, N = 4032 and
    1008. Cross-attention (77 keys), SD1.5's d = 160 level, the VAE's
    single d = 512 head and bf16 no kernel takes run the plain path. The
    JAX package also asks for multiples of 128 (its Pallas kernel's tiles),
    which sends 1344x768 to XLA; the CUDA kernel masks ragged tiles, so the
    port does not (ROADMAP Queue 3)."""
    return q.shape[1] >= 256 and k.shape[1] >= 256 and route(q, k, v) is not None


def dot_product_attention(q, k, v, *, scale: Optional[float] = None,
                          impl: str = "auto"):
    """Multi-head attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D].

    impl: "auto" (flash on CUDA when the shapes qualify), "flash", or "xla"
    (the plain path; the name is the JAX package's config value). The flash
    kernel treats each row alone; the plain path's matmuls run batched where
    the card showed every row equal to its solo call, else one row at a time
    (ops/batching.py).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "flash" or (impl == "auto" and q.is_cuda and _flash_supported(q, k, v)):
        return flash_attention(q, k, v, scale=scale)
    # a row's call holds its [H, N, M] scores up to three times in fp32
    scratch = 12 * q.shape[2] * q.shape[1] * k.shape[1]
    return row_chunks(("attention", scale),
                      lambda qr, kr, vr: attention_plain(qr, kr, vr, scale), q, k, v,
                      scratch=scratch)
