"""VAE decoder (AutoencoderKL), NHWC (port of ``dreamlab_tpu/models/vae.py::decode``).

Resnets open with GroupNorm+SiLU (the CUDA kernels on the card); the mid
block's single-head attention (d = 512) takes the plain attention path, as
in the JAX package. ``decode_tiled`` and the encoder come with later slices.
"""

from __future__ import annotations

import torch

from ..ops.attention import dot_product_attention
from .configs import VAEConfig
from .layers import (
    conv2d,
    group_norm,
    group_norm_silu,
    init_conv,
    init_linear,
    init_norm,
    linear,
    nearest_upsample,
)


def _resnet(p, x, *, groups):
    h = conv2d(p["conv1"], group_norm_silu(p["norm1"], x, groups=groups))
    h = conv2d(p["conv2"], group_norm_silu(p["norm2"], h, groups=groups))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _mid_attention(p, x, *, groups, impl="auto"):
    b, h, w, c = x.shape
    res = x
    x = group_norm(p["norm"], x, groups=groups, eps=1e-6).reshape(b, h * w, c)
    q = linear(p["q"], x)[:, :, None, :]  # single head: [B, N, 1, C]
    k = linear(p["k"], x)[:, :, None, :]
    v = linear(p["v"], x)[:, :, None, :]
    out = dot_product_attention(q, k, v, impl="xla" if impl == "xla" else "auto")[:, :, 0, :]
    return linear(p["out"], out).reshape(b, h, w, c) + res


def _mid_block(p, x, cfg: VAEConfig):
    x = _resnet(p["resnet1"], x, groups=cfg.norm_groups)
    if "attention" in p:
        x = _mid_attention(p["attention"], x, groups=cfg.norm_groups, impl=cfg.attention_impl)
    return _resnet(p["resnet2"], x, groups=cfg.norm_groups)


def decode(params, cfg: VAEConfig, latents):
    """[B, h, w, 4] latents (already divided by scaling_factor) -> fp32
    [B, 8h, 8w, 3] images in [-1, 1]."""
    x = latents.to(params["conv_in"]["w"].dtype)
    if "post_quant_conv" in params:
        x = conv2d(params["post_quant_conv"], x)
    x = conv2d(params["conv_in"], x)
    x = _mid_block(params["mid"], x, cfg)
    for block in params["up"]:
        for res in block["resnets"]:
            x = _resnet(res, x, groups=cfg.norm_groups)
        if "upsample" in block:
            x = conv2d(block["upsample"], nearest_upsample(x))
    x = group_norm_silu(params["norm_out"], x, groups=cfg.norm_groups)
    return conv2d(params["conv_out"], x).float()


# ---------------------------------------------------------------------------
# init: the tree of dreamlab_tpu/models/vae.py::init_decoder_params
# ---------------------------------------------------------------------------


def _init_resnet(gen, cin, cout):
    p = {
        "norm1": init_norm(gen, cin),
        "conv1": init_conv(gen, 3, 3, cin, cout),
        "norm2": init_norm(gen, cout),
        "conv2": init_conv(gen, 3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = init_conv(gen, 1, 1, cin, cout)
    return p


def init_decoder_params(cfg: VAEConfig, gen: torch.Generator):
    rev = list(reversed(cfg.block_out_channels))
    c0 = rev[0]
    mid = {"resnet1": _init_resnet(gen, c0, c0), "resnet2": _init_resnet(gen, c0, c0)}
    if cfg.mid_attention:
        mid["attention"] = {"norm": init_norm(gen, c0),
                            **{name: init_linear(gen, c0, c0) for name in ("q", "k", "v", "out")}}
    params = {
        "post_quant_conv": init_conv(gen, 1, 1, cfg.latent_channels, cfg.latent_channels),
        "conv_in": init_conv(gen, 3, 3, cfg.latent_channels, c0),
        "mid": mid,
    }
    up, cur = [], c0
    for k, cout in enumerate(rev):
        block = {"resnets": [_init_resnet(gen, cur if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block + 1)]}
        cur = cout
        if k < len(rev) - 1:
            block["upsample"] = init_conv(gen, 3, 3, cout, cout)
        up.append(block)
    params["up"] = up
    params["norm_out"] = init_norm(gen, rev[-1])
    params["conv_out"] = init_conv(gen, 3, 3, rev[-1], cfg.out_channels)
    return params
