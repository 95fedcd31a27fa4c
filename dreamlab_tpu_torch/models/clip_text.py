"""CLIP text encoder, SD1.5 branch (port of ``dreamlab_tpu/models/clip_text.py``).

OpenAI CLIP ViT-L/14: quick_gelu, causal self-attention over 77 tokens,
final LayerNorm, pooled output at the EOS position. The SDXL branches
(penultimate state, text projection) come with the SDXL slice.
"""

from __future__ import annotations

import torch

from ..ops.batching import per_row
from .configs import CLIPTextConfig
from .layers import (
    init_embedding,
    init_linear,
    init_norm,
    layer_norm,
    linear,
    quick_gelu,
)


def _self_attention(p, x, mask, num_heads):
    b, n, c = x.shape
    d = c // num_heads
    q = linear(p["q"], x).reshape(b, n, num_heads, d)
    k = linear(p["k"], x).reshape(b, n, num_heads, d)
    v = linear(p["v"], x).reshape(b, n, num_heads, d)
    # 77-token causal attention: small, so plain torch ops (the JAX package
    # keeps it on XLA too); fp32 logits and softmax, one batch row at a time

    def attend(qr, kr, vr):
        logits = torch.einsum("bnhd,bmhd->bhnm", qr.float(), kr.float())
        probs = torch.softmax(logits * (d ** -0.5) + mask, dim=-1).to(vr.dtype)
        return torch.einsum("bhnm,bmhd->bnhd", probs.float(), vr.float())

    out = per_row(attend, q, k, v)
    return linear(p["out"], out.to(x.dtype).reshape(b, n, c))


def _encoder_layer(p, x, mask, cfg: CLIPTextConfig):
    h = layer_norm(p["ln1"], x, eps=cfg.layer_norm_eps)
    x = x + _self_attention(p["attn"], h, mask, cfg.num_heads)
    h = layer_norm(p["ln2"], x, eps=cfg.layer_norm_eps)
    h = linear(p["fc2"], quick_gelu(linear(p["fc1"], h)))
    return x + h


def encode_text(params, input_ids, cfg: CLIPTextConfig):
    """Run the text tower on int [B, 77] ids.

    Returns (hidden_states [B, 77, C], pooled [B, C]): the final layer-normed
    sequence and its embedding at the EOS position, found by equality with
    the vocabulary's last id (not argmax: textual-inversion ids sit beyond
    the base vocabulary).
    """
    if cfg.penultimate or cfg.projection_dim is not None or cfg.hidden_act != "quick_gelu":
        raise ValueError("this port runs the SD1.5 text tower only; the SDXL "
                         "branches come with the SDXL slice")
    b, n = input_ids.shape
    pos = torch.arange(n, device=input_ids.device)
    tok = params["token_embedding"]["w"]
    x = (tok[input_ids] + params["position_embedding"]["w"][pos]).to(tok.dtype)

    causal = torch.full((n, n), -1e9, dtype=torch.float32,
                        device=input_ids.device).triu(1)[None, None]
    for layer_p in params["layers"]:
        x = _encoder_layer(layer_p, x, causal, cfg)
    final = layer_norm(params["final_ln"], x, eps=cfg.layer_norm_eps)

    eos_idx = (input_ids == cfg.vocab_size - 1).int().argmax(dim=-1)
    pooled = final[torch.arange(b, device=input_ids.device), eos_idx]
    return final, pooled


def init_params(cfg: CLIPTextConfig, gen: torch.Generator):
    c, ff = cfg.hidden_size, cfg.intermediate_size

    def layer():
        return {
            "ln1": init_norm(gen, c),
            "attn": {name: init_linear(gen, c, c) for name in ("q", "k", "v", "out")},
            "ln2": init_norm(gen, c),
            "fc1": init_linear(gen, c, ff),
            "fc2": init_linear(gen, ff, c),
        }

    return {
        "token_embedding": init_embedding(gen, cfg.vocab_size, c),
        "position_embedding": init_embedding(gen, cfg.max_position_embeddings, c),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_ln": init_norm(gen, c),
    }
