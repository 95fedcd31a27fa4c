"""Conditional diffusion UNet, SD1.5 branch, NHWC (port of ``dreamlab_tpu/models/unet.py``).

The same block structure and parameter tree as the JAX package: resnets
open with GroupNorm+SiLU (the CUDA kernels on the card), spatial
self-attention dispatches through ``ops.attention`` (the flash kernel at the
4096- and 1024-token levels), convs and matmuls go to cuDNN and cuBLAS.

q/k/v stay three projections: the JAX package packs them into one matmul
(``pack_attention_params``) to suit the TPU's placement; whether packing
pays on the card is not measured yet. SDXL's micro-conditioning and
ControlNet's residual taps come with their slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import dot_product_attention
from .configs import UNetConfig
from .layers import (
    conv2d,
    geglu,
    group_norm,
    group_norm_silu,
    init_conv,
    init_linear,
    init_norm,
    layer_norm,
    linear,
    nearest_upsample,
    silu,
    timestep_embedding,
)


def _resnet(p, x, emb, *, groups):
    """ResnetBlock2D: GN->SiLU->conv, +time, GN->SiLU->conv, +skip."""
    h = conv2d(p["conv1"], group_norm_silu(p["norm1"], x, groups=groups))
    t = linear(p["time_emb_proj"], silu(emb))
    h = h + t[:, None, None, :].to(h.dtype)
    h = conv2d(p["conv2"], group_norm_silu(p["norm2"], h, groups=groups))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _attention(p, x, context, *, heads, impl="auto"):
    """Multi-head attention over the token axis. x: [B, N, C]; context:
    [B, M, Cc] or None for self-attention."""
    b, n, c = x.shape
    d = c // heads
    ctx = x if context is None else context
    m = ctx.shape[1]
    q = linear(p["q"], x).reshape(b, n, heads, d)
    k = linear(p["k"], ctx).reshape(b, m, heads, d)
    v = linear(p["v"], ctx).reshape(b, m, heads, d)
    out = dot_product_attention(q, k, v, impl=impl)
    return linear(p["out"], out.reshape(b, n, c))


def _transformer_block(p, x, context, *, heads, impl="auto"):
    """BasicTransformerBlock: self-attn, cross-attn, GEGLU FF (pre-LN)."""
    x = x + _attention(p["attn1"], layer_norm(p["ln1"], x), None, heads=heads, impl=impl)
    x = x + _attention(p["attn2"], layer_norm(p["ln2"], x), context, heads=heads, impl=impl)
    h = layer_norm(p["ln3"], x)
    return x + linear(p["ff_out"], geglu(p["ff_geglu"], h))


def _spatial_transformer(p, x, context, *, heads, groups, impl="auto"):
    """Transformer2DModel: GN (eps 1e-6, no SiLU), project in, token-space
    blocks, project out, residual."""
    b, h_, w_, c = x.shape
    residual = x
    x = group_norm(p["norm"], x, groups=groups, eps=1e-6)
    x = linear(p["proj_in"], x.reshape(b, h_ * w_, c))
    for blk in p["blocks"]:
        x = _transformer_block(blk, x, context, heads=heads, impl=impl)
    x = linear(p["proj_out"], x)
    return x.reshape(b, h_, w_, c) + residual


def time_embed(params, cfg: UNetConfig, timesteps, timestep_cond: Optional[torch.Tensor],
               dtype):
    """Combined time / LCM-w embedding [B, temb]."""
    t_emb = timestep_embedding(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
    ).to(dtype)
    if cfg.time_cond_proj_dim is not None and timestep_cond is not None:
        t_emb = t_emb + linear(params["time_embedding"]["cond_proj"],
                               timestep_cond.to(dtype))
    emb = linear(params["time_embedding"]["linear_1"], t_emb)
    return linear(params["time_embedding"]["linear_2"], silu(emb))


def down_blocks(params, cfg: UNetConfig, x, emb, context):
    """The down stack on post-conv_in ``x``: returns (x, skips), one skip per
    connection the up stack consumes (the initial sample included)."""
    skips = [x]
    for i, block in enumerate(params["down"]):
        heads = cfg.num_attention_heads[i]
        for j, res in enumerate(block["resnets"]):
            x = _resnet(res, x, emb, groups=cfg.norm_groups)
            if block.get("attentions"):
                x = _spatial_transformer(
                    block["attentions"][j], x, context, heads=heads,
                    groups=cfg.norm_groups, impl=cfg.attention_impl)
            skips.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2)
            skips.append(x)
    return x, skips


def mid_block(params, cfg: UNetConfig, x, emb, context):
    mid = params["mid"]
    x = _resnet(mid["resnet1"], x, emb, groups=cfg.norm_groups)
    if "attention" in mid:
        x = _spatial_transformer(
            mid["attention"], x, context, heads=cfg.num_attention_heads[-1],
            groups=cfg.norm_groups, impl=cfg.attention_impl)
    return _resnet(mid["resnet2"], x, emb, groups=cfg.norm_groups)


def forward(params, cfg: UNetConfig, sample, timesteps, encoder_hidden_states,
            timestep_cond=None):
    """Predict noise for ``sample`` [B, H, W, 4] at ``timesteps`` [B].

    encoder_hidden_states: [B, 77, cross_attention_dim] text conditioning.
    timestep_cond: [B, time_cond_proj_dim] LCM guidance embedding (w).
    Returns fp32 [B, H, W, 4].
    """
    if cfg.addition_embed_type is not None:
        raise ValueError("SDXL micro-conditioning comes with the SDXL slice")
    dtype = params["conv_in"]["w"].dtype
    x = sample.to(dtype)
    context = encoder_hidden_states.to(dtype)
    emb = time_embed(params, cfg, timesteps, timestep_cond, dtype)

    x = conv2d(params["conv_in"], x)
    x, skips = down_blocks(params, cfg, x, emb, context)
    x = mid_block(params, cfg, x, emb, context)
    for k, block in enumerate(params["up"]):
        heads = cfg.num_attention_heads[cfg.num_blocks - 1 - k]
        for j, res in enumerate(block["resnets"]):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet(res, x, emb, groups=cfg.norm_groups)
            if block.get("attentions"):
                x = _spatial_transformer(
                    block["attentions"][j], x, context, heads=heads,
                    groups=cfg.norm_groups, impl=cfg.attention_impl)
        if "upsample" in block:
            x = conv2d(block["upsample"], nearest_upsample(x))

    x = group_norm_silu(params["norm_out"], x, groups=cfg.norm_groups)
    return conv2d(params["conv_out"], x).float()


# ---------------------------------------------------------------------------
# init (tests / chip smoke run): the tree of dreamlab_tpu/models/unet.py::init_params
# ---------------------------------------------------------------------------


def _init_resnet(gen, cin, cout, temb_dim):
    p = {
        "norm1": init_norm(gen, cin),
        "conv1": init_conv(gen, 3, 3, cin, cout),
        "time_emb_proj": init_linear(gen, temb_dim, cout),
        "norm2": init_norm(gen, cout),
        "conv2": init_conv(gen, 3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = init_conv(gen, 1, 1, cin, cout)
    return p


def _init_attn(gen, c, ctx_dim):
    return {
        "q": init_linear(gen, c, c, bias=False),
        "k": init_linear(gen, ctx_dim, c, bias=False),
        "v": init_linear(gen, ctx_dim, c, bias=False),
        "out": init_linear(gen, c, c),
    }


def _init_transformer(gen, c, ctx_dim, n_layers):
    def block():
        return {
            "ln1": init_norm(gen, c),
            "attn1": _init_attn(gen, c, c),
            "ln2": init_norm(gen, c),
            "attn2": _init_attn(gen, c, ctx_dim),
            "ln3": init_norm(gen, c),
            "ff_geglu": init_linear(gen, c, 8 * c),
            "ff_out": init_linear(gen, 4 * c, c),
        }

    return {
        "norm": init_norm(gen, c),
        "proj_in": init_linear(gen, c, c),
        "blocks": [block() for _ in range(n_layers)],
        "proj_out": init_linear(gen, c, c),
    }


def init_params(cfg: UNetConfig, gen: torch.Generator):
    temb = cfg.time_embed_dim
    chans = cfg.block_out_channels
    ctx = cfg.cross_attention_dim
    params = {
        "conv_in": init_conv(gen, 3, 3, cfg.in_channels, chans[0]),
        "time_embedding": {
            "linear_1": init_linear(gen, chans[0], temb),
            "linear_2": init_linear(gen, temb, temb),
        },
    }
    if cfg.time_cond_proj_dim is not None:
        params["time_embedding"]["cond_proj"] = init_linear(
            gen, cfg.time_cond_proj_dim, chans[0], bias=False)

    down, skip_chans, cur = [], [chans[0]], chans[0]
    for i, cout in enumerate(chans):
        tl = cfg.transformer_layers_per_block[i]
        block = {"resnets": []}
        if tl > 0:
            block["attentions"] = []
        for _ in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(gen, cur, cout, temb))
            cur = cout
            if tl > 0:
                block["attentions"].append(_init_transformer(gen, cout, ctx, tl))
            skip_chans.append(cout)
        if i < cfg.num_blocks - 1:
            block["downsample"] = init_conv(gen, 3, 3, cout, cout)
            skip_chans.append(cout)
        down.append(block)
    params["down"] = down

    mid_c = chans[-1]
    mid = {
        "resnet1": _init_resnet(gen, mid_c, mid_c, temb),
        "resnet2": _init_resnet(gen, mid_c, mid_c, temb),
    }
    if cfg.has_mid_attention:
        mid["attention"] = _init_transformer(gen, mid_c, ctx, cfg.mid_block_transformer_layers)
    params["mid"] = mid

    up, cur = [], mid_c
    for k, cout in enumerate(reversed(chans)):
        tl = cfg.transformer_layers_per_block[cfg.num_blocks - 1 - k]
        block = {"resnets": []}
        if tl > 0:
            block["attentions"] = []
        for _ in range(cfg.layers_per_block + 1):
            block["resnets"].append(_init_resnet(gen, cur + skip_chans.pop(), cout, temb))
            cur = cout
            if tl > 0:
                block["attentions"].append(_init_transformer(gen, cout, ctx, tl))
        if k < cfg.num_blocks - 1:
            block["upsample"] = init_conv(gen, 3, 3, cout, cout)
        up.append(block)
    params["up"] = up

    params["norm_out"] = init_norm(gen, chans[0])
    params["conv_out"] = init_conv(gen, 3, 3, chans[0], cfg.out_channels)
    return params
