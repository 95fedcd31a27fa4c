"""Attention dispatch: the flash kernel on CUDA for the long spatial sequences,
the plain path everywhere else (port of ``dreamlab_tpu/ops/attention.py``).

Interface: [B, N, H, D] tensors with a separate head axis; softmax in fp32.
"""

from __future__ import annotations

from typing import Optional

from .batching import per_row
from .flash_attention import attention_plain, flash_attention


def _flash_supported(q, k) -> bool:
    """The JAX package's shape rule, keyed on the tensor's device: the UNet's
    spatial self-attention at N = 4096 (d = 40) and N = 1024 (d = 80) takes the
    kernel; cross-attention (77 keys), the d = 160 level and the VAE's
    single d = 512 head take the plain path."""
    if not q.is_cuda:
        return False
    n, m, d = q.shape[1], k.shape[1], q.shape[3]
    return n >= 256 and n % 128 == 0 and m % 128 == 0 and d <= 128


def dot_product_attention(q, k, v, *, scale: Optional[float] = None,
                          impl: str = "auto"):
    """Multi-head attention, [B, N, H, D] x [B, M, H, D] -> [B, N, H, D].

    impl: "auto" (flash on CUDA when the shapes qualify), "flash", or "xla"
    (the plain path; the name is the JAX package's config value). The flash
    kernel treats each row alone; the plain path's batched matmuls run one
    row at a time (ops/batching.py).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "flash" or (impl == "auto" and _flash_supported(q, k)):
        return flash_attention(q, k, v, scale=scale)
    return per_row(lambda qr, kr, vr: attention_plain(qr, kr, vr, scale), q, k, v)
