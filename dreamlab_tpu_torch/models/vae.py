"""VAE decoder and encoder (AutoencoderKL), NHWC (port of ``dreamlab_tpu/models/vae.py``).

Resnets open with GroupNorm+SiLU (the CUDA kernels on the card); the mid
block's single-head attention (d = 512) takes the plain attention path, as
in the JAX package, in the decoder and the encoder alike.

``decode_tiled`` decodes latents larger than a tile as overlapping
fixed-shape tiles, feather-blended, as the JAX package does above its chunk
threshold: peak decoder memory follows the tile, not the frame. The tiles
run as a plain Python loop: they share one shape, so the loop captures into
a bucket's CUDA graph like the rest of the program. The blend weights are
built on the latents' device with torch ops (no host copy, which a capture
forbids).

``encode_moments`` is the encoder of img2img and inpainting. Its
downsamplers pad (0, 1, 0, 1) and then run a stride-2 conv with no padding,
as diffusers does, not the symmetric padding of ``layers.conv2d``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _tile_starts(extent: int, tile: int, stride: int):
    """Tile origins covering [0, extent): ``stride`` apart, the last one
    clamped so that every tile has the same shape."""
    starts = list(range(0, max(extent - tile, 0) + 1, stride))
    if starts[-1] + tile < extent:
        starts.append(extent - tile)
    return starts


def _feather(n_px: int, ramp_px: int, lo_edge: bool, hi_edge: bool, device="cpu"):
    """1-D fp32 blend weights: linear ramps over the overlap at interior
    edges, flat 1 at the image's borders."""
    w = torch.ones(n_px, dtype=torch.float32, device=device)
    if ramp_px > 0:
        ramp = torch.arange(1, ramp_px + 1, dtype=torch.float32, device=device) / (ramp_px + 1)
        if not lo_edge:
            w[:ramp_px] = ramp
        if not hi_edge:
            w[-ramp_px:] = ramp.flip(0)
    return w


def decode_tiled(params, cfg: VAEConfig, latents, *, tile: int = 64, overlap: int = 16):
    """``decode`` over ``tile`` x ``tile`` latent tiles that share ``overlap``
    latents with their neighbours, each decoded whole and blended with
    linear ramps over the overlap; accumulated in fp32 and divided by the
    weight sum. Latents no larger than one tile decode whole."""
    b, h, w, _ = latents.shape
    if h <= tile and w <= tile:
        return decode(params, cfg, latents)
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} leaves no stride in a tile of {tile}")
    s = cfg.scale_factor
    ts, dev = tile * s, latents.device
    out = torch.zeros((b, h * s, w * s, cfg.out_channels), dtype=torch.float32, device=dev)
    wsum = torch.zeros((1, h * s, w * s, 1), dtype=torch.float32, device=dev)
    for y0 in _tile_starts(h, tile, stride):
        wy = _feather(ts, overlap * s, y0 == 0, y0 + tile == h, dev)
        for x0 in _tile_starts(w, tile, stride):
            wx = _feather(ts, overlap * s, x0 == 0, x0 + tile == w, dev)
            wmask = (wy[:, None] * wx[None, :])[:, :, None]
            z = latents[:, y0:y0 + tile, x0:x0 + tile].contiguous()
            out[:, y0 * s:y0 * s + ts, x0 * s:x0 * s + ts] += decode(params, cfg, z) * wmask
            wsum[:, y0 * s:y0 * s + ts, x0 * s:x0 * s + ts] += wmask
    return out / wsum


def encode_moments(params, cfg: VAEConfig, images):
    """[B, H, W, 3] images in [-1, 1] -> fp32 [B, H/8, W/8, 2 * latent_channels]
    (mean, then logvar), before the scaling factor."""
    x = images.to(params["conv_in"]["w"].dtype)
    x = conv2d(params["conv_in"], x)
    for block in params["down"]:
        for res in block["resnets"]:
            x = _resnet(res, x, groups=cfg.norm_groups)
        if "downsample" in block:
            # diffusers pads (0, 1, 0, 1) before the stride-2 conv
            x = conv2d(block["downsample"], F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding=0)
    x = _mid_block(params["mid"], x, cfg)
    x = group_norm_silu(params["norm_out"], x, groups=cfg.norm_groups)
    x = conv2d(params["conv_out"], x)
    if "quant_conv" in params:
        x = conv2d(params["quant_conv"], x)
    return x.float()


# ---------------------------------------------------------------------------
# init: the trees of dreamlab_tpu/models/vae.py::init_{decoder,encoder}_params
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


def _init_mid(gen, c, cfg: VAEConfig):
    mid = {"resnet1": _init_resnet(gen, c, c), "resnet2": _init_resnet(gen, c, c)}
    if cfg.mid_attention:
        mid["attention"] = {"norm": init_norm(gen, c),
                            **{name: init_linear(gen, c, c) for name in ("q", "k", "v", "out")}}
    return mid


def init_decoder_params(cfg: VAEConfig, gen: torch.Generator):
    rev = list(reversed(cfg.block_out_channels))
    c0 = rev[0]
    mid = _init_mid(gen, c0, cfg)  # drawn first, as it always was
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


def init_encoder_params(cfg: VAEConfig, gen: torch.Generator):
    chans = cfg.block_out_channels
    params = {"conv_in": init_conv(gen, 3, 3, cfg.out_channels, chans[0])}
    down, cur = [], chans[0]
    for i, cout in enumerate(chans):
        block = {"resnets": [_init_resnet(gen, cur if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block)]}
        cur = cout
        if i < len(chans) - 1:
            block["downsample"] = init_conv(gen, 3, 3, cout, cout)
        down.append(block)
    params["down"] = down
    params["mid"] = _init_mid(gen, chans[-1], cfg)
    params["norm_out"] = init_norm(gen, chans[-1])
    lat2 = 2 * cfg.latent_channels
    params["conv_out"] = init_conv(gen, 3, 3, chans[-1], lat2)
    params["quant_conv"] = init_conv(gen, 1, 1, lat2, lat2)
    return params
