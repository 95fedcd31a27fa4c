"""Conditional diffusion UNet, SD1.5 and SDXL, NHWC (port of ``dreamlab_tpu/models/unet.py``).

The same block structure and parameter tree as the JAX package: resnets
open with GroupNorm+SiLU (the CUDA kernels on the card), spatial
self-attention dispatches through ``ops.attention`` (the flash kernel at the
4096- and 1024-token levels), convs and matmuls go to cuDNN and cuBLAS.
SDXL adds its ``text_time`` micro-conditioning to the time embedding; its
10-deep transformer stacks and attention-free first level are the same
code with other config values.

Attention projections come in two layouts, as in the JAX package. The
loaders and ``init_params`` give each site separate ``q``, ``k``, ``v``
linears; ``pack_attention_params`` (applied by the pipeline when it places
the weights) stacks self-attention's into one ``qkv`` leaf and
cross-attention's ``k`` and ``v`` into one ``kv`` leaf, ``{"w": [S, out,
in], "b": [S, out]}``: torch's ``[out, in]`` behind JAX's separate stack
axis. A packed site makes one GEMM over ``w.flatten(0, 1)`` where the
unpacked one makes three (self) or two (cross); q, k and v are strided
views of its output, which the flash kernel reads in place.
``forward`` takes either layout, and a ControlNet's residual taps
(``models/controlnet.py``): one per skip connection and one for the mid
block's output.

Tensor parallelism (``forward(..., tp=)``, ``tp`` a
``parallel.sharding.ModelGroup``): a model rank's tree holds its slice of
the split leaves (``parallel.sharding.unet_tp_placements``), and the
forward reads the split from the leaves' shapes. A site whose q/k/v rows
(of each slot, where packed) are a slice runs its rank's heads only; the
attention and feed-forward out-projections of a split site give partial
products over the rank's input features, summed over the model group in
fp32 before the bias is added once. A site left whole runs as without ``tp``. With ``tp=None`` the
forward is the single-device one.
"""

from __future__ import annotations

from typing import Dict, Optional

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


def _row_parallel(p, x, tp):
    """A linear over a model rank's slice of the input features: the
    partial product in fp32 (bf16 operands upcast, so no partial is rounded
    to bf16), summed over the model group, then the bias (added once) and
    one rounding to ``x``'s dtype, as one device's GEMM rounds its product."""
    y = tp.all_reduce(linear({"w": p["w"].float()}, x.float()))
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def _packed_proj(p, x):
    """S stacked projections as one linear: w [S, out, in] -> [B, N, S, out]."""
    s, cout = p["w"].shape[:2]
    flat = {"w": p["w"].flatten(0, 1)}
    if "b" in p:
        flat["b"] = p["b"].flatten()
    y = linear(flat, x)
    return y.view(*y.shape[:-1], s, cout)


def _attention(p, x, context, *, heads, impl="auto", tp=None):
    """Multi-head attention over the token axis. x: [B, N, C]; context:
    [B, M, Cc] or None for self-attention. Takes the unpacked layout
    ({"q", "k", "v", "out"}) or the packed one ({"qkv", "out"} for
    self-attention, {"q", "kv", "out"} for cross-attention). On a model rank
    whose q/k/v rows are a slice, its heads only, and the out-projection
    summed over ``tp``."""
    b, n, c = x.shape
    d = c // heads
    ctx = x if context is None else context
    m = ctx.shape[1]
    if "qkv" in p:
        qkv = _packed_proj(p["qkv"], x)  # [B, N, 3, local]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = linear(p["q"], x)
        if "kv" in p:
            kv = _packed_proj(p["kv"], ctx)  # [B, M, 2, local]
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            k, v = linear(p["k"], ctx), linear(p["v"], ctx)
    local = q.shape[-1]  # c, or this rank's slice of it
    h = local // d
    # views: the packed slots keep their token stride of S x local
    q, k, v = q.view(b, n, h, d), k.view(b, m, h, d), v.view(b, m, h, d)
    out = dot_product_attention(q, k, v, impl=impl).reshape(b, n, local)
    return linear(p["out"], out) if local == c else _row_parallel(p["out"], out, tp)


def _feed_forward(p, x, tp=None):
    """GEGLU, then the out-projection (over this rank's slice of the hidden
    features where ``ff_out`` is split)."""
    h = geglu(p["ff_geglu"], x)
    k = p["ff_out"]["w"].shape[1]
    if k == h.shape[-1]:
        return linear(p["ff_out"], h)
    return _row_parallel(p["ff_out"], h[..., tp.rank * k:(tp.rank + 1) * k], tp)


def _transformer_block(p, x, context, *, heads, impl="auto", tp=None):
    """BasicTransformerBlock: self-attn, cross-attn, GEGLU FF (pre-LN)."""
    x = x + _attention(p["attn1"], layer_norm(p["ln1"], x), None, heads=heads, impl=impl,
                       tp=tp)
    x = x + _attention(p["attn2"], layer_norm(p["ln2"], x), context, heads=heads, impl=impl,
                       tp=tp)
    return x + _feed_forward(p, layer_norm(p["ln3"], x), tp)


def _spatial_transformer(p, x, context, *, heads, groups, impl="auto", tp=None):
    """Transformer2DModel: GN (eps 1e-6, no SiLU), project in, token-space
    blocks, project out, residual."""
    b, h_, w_, c = x.shape
    residual = x
    x = group_norm(p["norm"], x, groups=groups, eps=1e-6)
    x = linear(p["proj_in"], x.reshape(b, h_ * w_, c))
    for blk in p["blocks"]:
        x = _transformer_block(blk, x, context, heads=heads, impl=impl, tp=tp)
    x = linear(p["proj_out"], x)
    return x.reshape(b, h_, w_, c) + residual


def time_embed(params, cfg: UNetConfig, timesteps, timestep_cond: Optional[torch.Tensor],
               added_text_embeds: Optional[torch.Tensor],
               added_time_ids: Optional[torch.Tensor], dtype):
    """Combined time / LCM-w / SDXL micro-conditioning embedding [B, temb]."""
    t_emb = timestep_embedding(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
    ).to(dtype)
    if cfg.time_cond_proj_dim is not None and timestep_cond is not None:
        t_emb = t_emb + linear(params["time_embedding"]["cond_proj"],
                               timestep_cond.to(dtype))
    emb = linear(params["time_embedding"]["linear_1"], t_emb)
    emb = linear(params["time_embedding"]["linear_2"], silu(emb))
    if cfg.addition_embed_type == "text_time":
        # pooled text embedding beside the Fourier features of the six (five
        # for the refiner) size/crop ids, concatenated in fp32, then cast
        time_ids_emb = timestep_embedding(
            added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
        ).reshape(added_time_ids.shape[0], -1)
        add = torch.cat([added_text_embeds.float(), time_ids_emb], dim=-1).to(dtype)
        a = linear(params["add_embedding"]["linear_1"], add)
        emb = emb + linear(params["add_embedding"]["linear_2"], silu(a))
    return emb


def down_blocks(params, cfg: UNetConfig, x, emb, context, tp=None):
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
                    groups=cfg.norm_groups, impl=cfg.attention_impl, tp=tp)
            skips.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2)
            skips.append(x)
    return x, skips


def mid_block(params, cfg: UNetConfig, x, emb, context, tp=None):
    mid = params["mid"]
    x = _resnet(mid["resnet1"], x, emb, groups=cfg.norm_groups)
    if "attention" in mid:
        x = _spatial_transformer(
            mid["attention"], x, context, heads=cfg.num_attention_heads[-1],
            groups=cfg.norm_groups, impl=cfg.attention_impl, tp=tp)
    return _resnet(mid["resnet2"], x, emb, groups=cfg.norm_groups)


def forward(params, cfg: UNetConfig, sample, timesteps, encoder_hidden_states,
            timestep_cond=None, added_text_embeds=None, added_time_ids=None,
            down_residuals=None, mid_residual=None, tp=None):
    """Predict noise for ``sample`` [B, H, W, 4] at ``timesteps`` [B].

    encoder_hidden_states: [B, 77, cross_attention_dim] text conditioning.
    timestep_cond: [B, time_cond_proj_dim] LCM guidance embedding (w).
    added_text_embeds / added_time_ids: SDXL micro-conditioning
    ([B, pooled_dim], [B, 6] or [B, 5] for the refiner).
    down_residuals / mid_residual: ControlNet taps, one residual per skip
    connection plus one for the mid output, cast to their dtype and added to
    the skips the up stack reads and to the mid output (diffusers'
    contract). Left None, the function is the plain UNet.
    tp: the model group (``parallel.sharding.ModelGroup``) of a rank whose
    ``params`` hold its tensor-parallel slices; None on one device.
    Returns fp32 [B, H, W, 4].
    """
    if cfg.addition_embed_type not in (None, "text_time"):
        raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r} is not served")
    if cfg.addition_embed_type == "text_time" and (added_text_embeds is None
                                                   or added_time_ids is None):
        raise ValueError("a text_time UNet needs added_text_embeds and added_time_ids")
    dtype = params["conv_in"]["w"].dtype
    x = sample.to(dtype)
    context = encoder_hidden_states.to(dtype)
    emb = time_embed(params, cfg, timesteps, timestep_cond, added_text_embeds,
                     added_time_ids, dtype)

    x = conv2d(params["conv_in"], x)
    x, skips = down_blocks(params, cfg, x, emb, context, tp)
    if down_residuals is not None:
        if len(down_residuals) != len(skips):
            raise ValueError(f"ControlNet provides {len(down_residuals)} down residuals but "
                             f"this UNet has {len(skips)} skip connections: architecture "
                             "mismatch")
        skips = [s + r.to(s.dtype) for s, r in zip(skips, down_residuals)]
    x = mid_block(params, cfg, x, emb, context, tp)
    if mid_residual is not None:
        x = x + mid_residual.to(x.dtype)
    for k, block in enumerate(params["up"]):
        heads = cfg.num_attention_heads[cfg.num_blocks - 1 - k]
        for j, res in enumerate(block["resnets"]):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet(res, x, emb, groups=cfg.norm_groups)
            if block.get("attentions"):
                x = _spatial_transformer(
                    block["attentions"][j], x, context, heads=heads,
                    groups=cfg.norm_groups, impl=cfg.attention_impl, tp=tp)
        if "upsample" in block:
            x = conv2d(block["upsample"], nearest_upsample(x))

    x = group_norm_silu(params["norm_out"], x, groups=cfg.norm_groups)
    return conv2d(params["conv_out"], x).float()


# ---------------------------------------------------------------------------
# packing (applied once, when the pipeline places the weights)
# ---------------------------------------------------------------------------

# the packed leaves and the slot of each projection they stack (the JAX
# package's ``lora._PACK_SLOTS``): attn1's q/k/v -> qkv, attn2's k/v -> kv
PACK_SLOTS: Dict[str, Dict[str, int]] = {"qkv": {"q": 0, "k": 1, "v": 2},
                                         "kv": {"k": 0, "v": 1}}


def _stack_attn(p, packed: str):
    """The linears a packed leaf stacks -> {"w": [S, out, in], "b": [S, out]}
    (the bias only where every projection has one)."""
    names = list(PACK_SLOTS[packed])
    out = {"w": torch.stack([p[n]["w"] for n in names])}
    if all("b" in p[n] for n in names):
        out["b"] = torch.stack([p[n]["b"] for n in names])
    return out


def pack_attention_params(params):
    """A tree with every transformer attention's projections packed
    (``dreamlab_tpu/models/unet.py::pack_attention_params``): attn1 {q, k, v}
    -> {qkv}, attn2 {k, v} -> {kv} beside its q. Sites are found by key
    name, not by shape (a tiny config can have cross_attention_dim == C).
    Every other leaf is the input tree's own tensor; a packed site passes
    through as it is."""
    def pack(p, self_attn: bool):
        if "qkv" in p or "kv" in p or "q" not in p:
            return p
        if self_attn:
            return {"qkv": _stack_attn(p, "qkv"), "out": p["out"]}
        return {"q": p["q"], "kv": _stack_attn(p, "kv"), "out": p["out"]}

    def walk(tree):
        if isinstance(tree, dict):
            return {k: pack(v, self_attn=k == "attn1")
                    if k in ("attn1", "attn2") and isinstance(v, dict) else walk(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


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
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": init_linear(gen, cfg.projection_class_embeddings_input_dim, temb),
            "linear_2": init_linear(gen, temb, temb),
        }

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
