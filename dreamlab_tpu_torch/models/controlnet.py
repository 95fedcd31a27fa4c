"""ControlNet spatial conditioning, NHWC (port of ``dreamlab_tpu/models/controlnet.py``).

The ControlNet trunk is the UNet's down and mid stack (``unet.time_embed``,
``unet.down_blocks``, ``unet.mid_block``) run on the ControlNet's own
weights, so its resnets and attention go through the same kernels as the
UNet's (GroupNorm+SiLU, flash attention). The hint embedding does not
depend on the latents: the pipeline computes it once per request, outside
the step loop, and only the trunk and its 1x1 zero-conv taps run per step.

The parameter tree is the UNet's without ``up``, ``norm_out`` and
``conv_out``, plus ``cond_embedding`` (the hint ladder), ``zero_down`` (one
tap per skip connection) and ``zero_mid``; the checkpoint layout is
diffusers' ``ControlNetModel`` (``loader.load_controlnet``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import unet
from .configs import UNetConfig
from .layers import conv2d, init_conv, silu


def embed_cond(params, hint: torch.Tensor) -> torch.Tensor:
    """Hint embedding: [B, H, W, 3] in [0, 1] -> [B, H/8, W/8, C0].

    diffusers' ControlNetConditioningEmbedding: SiLU after every conv but
    the last (``conv_out``); the odd-indexed block convs stride 2, which
    brings the hint to latent resolution.
    """
    dtype = params["conv_in"]["w"].dtype
    x = silu(conv2d(params["conv_in"], hint.to(dtype)))
    for i, blk in enumerate(params["blocks"]):
        x = silu(conv2d(blk, x, stride=2 if i % 2 else 1))
    return conv2d(params["conv_out"], x)


def forward(params, cfg: UNetConfig, sample, timesteps, encoder_hidden_states,
            cond_embedding, *, conditioning_scale=1.0, timestep_cond=None,
            added_text_embeds=None, added_time_ids=None) -> Tuple[list, torch.Tensor]:
    """Run the control trunk; return (down_residuals, mid_residual) for
    ``unet.forward(..., down_residuals=, mid_residual=)``.

    ``cond_embedding`` is ``embed_cond``'s output (at latent resolution).
    Each residual is a zero-conv tap times ``conditioning_scale`` (a float,
    or a 0-d tensor: the pipeline's staged input), in the weights' dtype.
    """
    dtype = params["conv_in"]["w"].dtype
    x = sample.to(dtype)
    context = encoder_hidden_states.to(dtype)
    emb = unet.time_embed(params, cfg, timesteps, timestep_cond, added_text_embeds,
                          added_time_ids, dtype)
    x = conv2d(params["conv_in"], x) + cond_embedding.to(dtype)
    x, skips = unet.down_blocks(params, cfg, x, emb, context)
    x = unet.mid_block(params, cfg, x, emb, context)
    scale = torch.as_tensor(conditioning_scale, device=x.device).to(dtype)
    down = [conv2d(tap, s) * scale for tap, s in zip(params["zero_down"], skips)]
    return down, conv2d(params["zero_mid"], x) * scale


def skip_count(cfg: UNetConfig) -> int:
    """Skip connections of a UNet trunk: the conv_in output, one per resnet,
    one per downsample."""
    return 1 + cfg.num_blocks * cfg.layers_per_block + (cfg.num_blocks - 1)


# ---------------------------------------------------------------------------
# init (tests, chip smoke run): the tree of dreamlab_tpu/models/controlnet.py::init_params
# ---------------------------------------------------------------------------


def init_params(cfg: UNetConfig, gen: torch.Generator, *,
                cond_channels: Tuple[int, ...] = (16, 32, 96, 256),
                zero_taps: bool = True):
    """A random ControlNet matching ``cfg``'s trunk. ``zero_taps`` zeroes the
    output convs (the hint ladder's last and every tap), ControlNet's state
    at the start of training: it then leaves the UNet's output unchanged."""
    params = unet.init_params(cfg, gen)
    del params["up"], params["norm_out"], params["conv_out"]

    def zeroed(p):
        return {k: torch.zeros_like(v) for k, v in p.items()} if zero_taps else p

    c0 = cfg.block_out_channels[0]
    blocks = []
    for cin, cout in zip(cond_channels[:-1], cond_channels[1:]):
        blocks.append(init_conv(gen, 3, 3, cin, cin))
        blocks.append(init_conv(gen, 3, 3, cin, cout))
    params["cond_embedding"] = {
        "conv_in": init_conv(gen, 3, 3, 3, cond_channels[0]),
        "blocks": blocks,
        "conv_out": zeroed(init_conv(gen, 3, 3, cond_channels[-1], c0)),
    }
    # the skip channels, walked as unet.down_blocks appends them
    skip_chans = [c0]
    for i, cout in enumerate(cfg.block_out_channels):
        skip_chans += [cout] * cfg.layers_per_block
        if i < cfg.num_blocks - 1:
            skip_chans.append(cout)
    params["zero_down"] = [zeroed(init_conv(gen, 1, 1, c, c)) for c in skip_chans]
    params["zero_mid"] = zeroed(init_conv(gen, 1, 1, cfg.block_out_channels[-1],
                                          cfg.block_out_channels[-1]))
    return params

