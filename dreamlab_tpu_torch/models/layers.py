"""Shared building blocks of the port (params as dicts of tensors).

Models here are plain functions of ``(params, inputs)`` where ``params`` is a
nested dict of tensors with the same keys as the JAX package's parameter
trees, so ``convert.from_jax_numpy`` maps one onto the other leaf by leaf.

Layout, decided once here:

- activations are NHWC-contiguous, as in the JAX package, so the public
  functions take and return what their JAX counterparts do;
- conv weights are OIHW and linear weights ``[out, in]`` (torch layout).
  ``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor is already NCHW in
  ``channels_last`` memory format, so ``F.conv2d`` takes it without a copy
  and returns ``channels_last``, which ``permute(0, 2, 3, 1)`` turns back into
  NHWC-contiguous. The pipeline stores conv weights ``channels_last`` too.

Convs, matmuls and the plain GroupNorm's reductions go through
``ops/batching.py::row_chunks``, keyed by what the library's choice of
algorithm can depend on: batched where the card has shown every row equal to
its solo call, one row at a time elsewhere, so batching never changes a row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.batching import row_chunks
from ..ops.groupnorm import fused_group_norm_silu, group_norm_plain


def _weight_sig(w):
    return (tuple(w.shape), w.stride(), w.dtype)


def _bias_sig(b):
    return None if b is None else b.dtype


def conv2d(params, x, *, stride: int = 1, padding=None):
    """NHWC conv with torch-convention symmetric padding (kh//2, kw//2), or
    ``padding`` pixels on every side where given (0: the "VALID" conv after
    the VAE encoder's explicit (0, 1, 0, 1) pad).

    At stride 2 the default is what diffusers checkpoints were trained with
    (``dreamlab_tpu/models/layers.py::conv2d`` translates XLA's "SAME" to it).
    """
    w, b = params["w"], params.get("b")
    kh, kw = w.shape[2], w.shape[3]
    pad = (kh // 2, kw // 2) if padding is None else (padding, padding)

    def conv(xr):
        y = F.conv2d(xr.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1).contiguous()

    key = ("conv2d", _weight_sig(w), _bias_sig(b), stride, pad)
    return row_chunks(key, conv, x)


def linear(params, x):
    """params: {'w': [out, in], 'b': [out] (optional)}."""
    w, b = params["w"], params.get("b")
    return row_chunks(("linear", _weight_sig(w), _bias_sig(b)),
                      lambda xr: F.linear(xr, w, b), x)


def group_norm(params, x, *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel axis of NHWC (or [..., C]), fp32 statistics."""
    scale, bias = params["scale"], params["bias"]
    return row_chunks(("group_norm", groups, scale.dtype),
                      lambda xr: group_norm_plain(xr, scale, bias, groups=groups, eps=eps), x)


def group_norm_silu(params, x, *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm -> SiLU, the UNet/VAE resnet prologue: the CUDA kernels on
    the card, the plain version on the CPU."""
    return fused_group_norm_silu(x, params["scale"], params["bias"], groups=groups, eps=eps)


def layer_norm(params, x, *, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics, output in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def silu(x):
    return F.silu(x)


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x):
    """Exact (erf) GELU, the activation of OpenCLIP's bigG text tower."""
    return F.gelu(x, approximate="none")


def geglu(params, x):
    """Gated GELU (exact) of the UNet transformer FFN: project to 2*d, gate."""
    a, g = linear(params, x).chunk(2, dim=-1)
    return a * F.gelu(g)


def timestep_embedding(timesteps, dim: int, *, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0):
    """Sinusoidal diffusion timestep embedding, [B] -> [B, dim] (fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    angles = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def nearest_upsample(x, factor: int = 2):
    """Nearest-neighbour upsample on NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


# ---------------------------------------------------------------------------
# Initializers (random weights for tests and the chip smoke run): the JAX
# package's scheme — uniform +-1/sqrt(fan_in), norms 1/0, embeddings N(0, 0.02).
# ---------------------------------------------------------------------------


def _uniform(gen, shape, bound):
    return torch.empty(shape, device=gen.device).uniform_(-bound, bound, generator=gen)


def init_conv(gen, kh, kw, cin, cout, *, bias=True):
    bound = 1.0 / math.sqrt(kh * kw * cin)
    p = {"w": _uniform(gen, (cout, cin, kh, kw), bound)}
    if bias:
        p["b"] = _uniform(gen, (cout,), bound)
    return p


def init_linear(gen, cin, cout, *, bias=True):
    bound = 1.0 / math.sqrt(cin)
    p = {"w": _uniform(gen, (cout, cin), bound)}
    if bias:
        p["b"] = _uniform(gen, (cout,), bound)
    return p


def init_norm(gen, c):
    return {"scale": torch.ones(c, device=gen.device),
            "bias": torch.zeros(c, device=gen.device)}


def init_embedding(gen, n, d):
    return {"w": torch.empty((n, d), device=gen.device).normal_(0.0, 0.02, generator=gen)}
