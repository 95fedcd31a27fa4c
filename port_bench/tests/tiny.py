"""Tiny configurations for the benchmark's CPU tests: the two served
configurations' topology (blocks, attention levels, towers, the LCM
w-embedding, SDXL's text_time) at toy widths, and mixes at toy sizes."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    u = c["unet"]
    n = len(u["block_out_channels"])
    u["block_out_channels"] = [16 * (i + 1) for i in range(n)]
    u["layers_per_block"] = 1
    u["norm_num_groups"] = 8
    u["attention_head_dim"] = 2 if isinstance(u["attention_head_dim"], int) else [2] * n
    if isinstance(u["transformer_layers_per_block"], list):
        u["transformer_layers_per_block"] = [1, 1, 2][:n]
    if u.get("time_cond_proj_dim"):
        u["time_cond_proj_dim"] = 8
    towers = [k for k in ("text_encoder", "text_encoder_2") if k in c]
    for i, k in enumerate(towers):
        t = c[k]
        t.update(hidden_size=16 * (i + 1), intermediate_size=32 * (i + 1), num_hidden_layers=2,
                 num_attention_heads=2)
        if "projection_dim" in t:
            t["projection_dim"] = 16 * (i + 1)
    u["cross_attention_dim"] = sum(c[k]["hidden_size"] for k in towers)
    if u.get("addition_embed_type") == "text_time":
        u["addition_time_embed_dim"] = 4
        u["projection_class_embeddings_input_dim"] = c[towers[-1]]["projection_dim"] + 6 * 4
    v = c["vae"]
    v["block_out_channels"] = [8, 16]
    v["layers_per_block"] = 1
    v["norm_num_groups"] = 4
    return c


def mix(name: str, **over) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        m = json.load(f)
    m.update(size="32x32", **over)
    return m
