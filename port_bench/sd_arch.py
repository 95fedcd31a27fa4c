"""The Stable Diffusion architectures as the public diffusers and
transformers config files describe them: the blocks, their widths, and each
tensor of the published state dicts under its published key and shape.

Plain Python over a configuration file's JSON. The weight maker, the
reference and the operation counts all read the structure from here; none
of them reads the program's configs.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

# (key, shape, role): role "w" (fan-in scaled), "b" (bias of the weight
# before it), "norm_w", "norm_b", "embed"
Tensor = Tuple[str, Tuple[int, ...], str]


def _per_level(value, n: int) -> List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def unet_struct(u: dict) -> dict:
    """Down, mid and up blocks of a ``UNet2DConditionModel`` config: each
    resnet's (cin, cout), each transformer's (channels, layers, heads), the
    level (resolution divisor) of each, and the diffusers key prefixes."""
    chans = list(u["block_out_channels"])
    n = len(chans)
    # diffusers' quirk: without num_attention_heads, attention_head_dim is the head count
    heads = _per_level(u.get("num_attention_heads") or u["attention_head_dim"], n)
    layers = _per_level(u.get("transformer_layers_per_block", 1), n)
    down_types, up_types = u["down_block_types"], u["up_block_types"]
    lpb = u["layers_per_block"]
    skips = [chans[0]]
    cur = chans[0]
    down = []
    for i in range(n):
        cross = "CrossAttn" in down_types[i]
        block = {"prefix": f"down_blocks.{i}", "level": i, "resnets": [], "attentions": [],
                 "downsample": None}
        for j in range(lpb):
            block["resnets"].append((cur, chans[i]))
            cur = chans[i]
            if cross:
                block["attentions"].append((chans[i], layers[i], heads[i]))
            skips.append(cur)
        if i < n - 1:
            block["downsample"] = cur
            skips.append(cur)
        down.append(block)
    mid_cross = "CrossAttn" in (u.get("mid_block_type") or "")
    mid = {"prefix": "mid_block", "level": n - 1, "resnets": [(cur, cur), (cur, cur)],
           "attentions": [(cur, layers[-1], heads[-1])] if mid_cross else []}
    up = []
    rev, rev_layers, rev_heads = chans[::-1], layers[::-1], heads[::-1]
    for k in range(n):
        cross = "CrossAttn" in up_types[k]
        block = {"prefix": f"up_blocks.{k}", "level": n - 1 - k, "resnets": [],
                 "attentions": [], "upsample": None}
        for j in range(lpb + 1):
            block["resnets"].append((cur + skips.pop(), rev[k]))
            cur = rev[k]
            if cross:
                block["attentions"].append((cur, rev_layers[k], rev_heads[k]))
        if k < n - 1:
            block["upsample"] = cur
        up.append(block)
    return {"down": down, "mid": mid, "up": up, "chans": chans,
            "temb": chans[0] * 4, "linear_proj": bool(u.get("use_linear_projection"))}


def _linear(key: str, cout: int, cin: int, bias: bool = True) -> Iterator[Tensor]:
    yield key + ".weight", (cout, cin), "w"
    if bias:
        yield key + ".bias", (cout,), "b"


def _conv(key: str, cout: int, cin: int, k: int = 3) -> Iterator[Tensor]:
    yield key + ".weight", (cout, cin, k, k), "w"
    yield key + ".bias", (cout,), "b"


def _norm(key: str, c: int) -> Iterator[Tensor]:
    yield key + ".weight", (c,), "norm_w"
    yield key + ".bias", (c,), "norm_b"


def _resnet(key: str, cin: int, cout: int, temb: Optional[int]) -> Iterator[Tensor]:
    yield from _norm(key + ".norm1", cin)
    yield from _conv(key + ".conv1", cout, cin)
    if temb is not None:
        yield from _linear(key + ".time_emb_proj", cout, temb)
    yield from _norm(key + ".norm2", cout)
    yield from _conv(key + ".conv2", cout, cout)
    if cin != cout:
        yield from _conv(key + ".conv_shortcut", cout, cin, 1)


def _transformer(key: str, c: int, n_layers: int, ctx: int, linear_proj: bool) -> Iterator[Tensor]:
    yield from _norm(key + ".norm", c)
    proj = _linear if linear_proj else (lambda k, co, ci: _conv(k, co, ci, 1))
    yield from proj(key + ".proj_in", c, c)
    for t in range(n_layers):
        b = f"{key}.transformer_blocks.{t}"
        for a, kv in (("attn1", c), ("attn2", ctx)):
            yield from _norm(f"{b}.norm{a[-1]}", c)
            yield from _linear(f"{b}.{a}.to_q", c, c, bias=False)
            yield from _linear(f"{b}.{a}.to_k", c, kv, bias=False)
            yield from _linear(f"{b}.{a}.to_v", c, kv, bias=False)
            yield from _linear(f"{b}.{a}.to_out.0", c, c)
        yield from _norm(f"{b}.norm3", c)
        yield from _linear(f"{b}.ff.net.0.proj", 8 * c, c)
        yield from _linear(f"{b}.ff.net.2", c, 4 * c)
    yield from proj(key + ".proj_out", c, c)


def unet_tensors(u: dict) -> Iterator[Tensor]:
    """Every tensor of a ``UNet2DConditionModel`` state dict."""
    s = unet_struct(u)
    c0, temb, ctx = s["chans"][0], s["temb"], u["cross_attention_dim"]
    yield from _conv("conv_in", c0, u["in_channels"])
    yield from _linear("time_embedding.linear_1", temb, c0)
    yield from _linear("time_embedding.linear_2", temb, temb)
    if u.get("time_cond_proj_dim"):
        yield from _linear("time_embedding.cond_proj", c0, u["time_cond_proj_dim"], bias=False)
    if u.get("addition_embed_type") == "text_time":
        yield from _linear("add_embedding.linear_1", temb,
                           u["projection_class_embeddings_input_dim"])
        yield from _linear("add_embedding.linear_2", temb, temb)
    for block in s["down"] + [s["mid"]] + s["up"]:
        p = block["prefix"]
        for j, (cin, cout) in enumerate(block["resnets"]):
            yield from _resnet(f"{p}.resnets.{j}", cin, cout, temb)
            if j < len(block["attentions"]):
                c, n_layers, _ = block["attentions"][j]
                yield from _transformer(f"{p}.attentions.{j}", c, n_layers, ctx,
                                        s["linear_proj"])
        if block.get("downsample"):
            yield from _conv(f"{p}.downsamplers.0.conv", block["downsample"], block["downsample"])
        if block.get("upsample"):
            yield from _conv(f"{p}.upsamplers.0.conv", block["upsample"], block["upsample"])
    yield from _norm("conv_norm_out", c0)
    yield from _conv("conv_out", u["out_channels"], c0)


def vae_decoder_struct(v: dict) -> dict:
    chans = list(v["block_out_channels"])
    rev = chans[::-1]
    lpb = v["layers_per_block"]
    up, cur = [], rev[0]
    for k in range(len(chans)):
        res = []
        for j in range(lpb + 1):
            res.append((cur, rev[k]))
            cur = rev[k]
        up.append({"prefix": f"decoder.up_blocks.{k}", "resnets": res,
                   "upsample": cur if k < len(chans) - 1 else None})
    return {"mid": rev[0], "up": up, "out": chans[0]}


def vae_decoder_tensors(v: dict) -> Iterator[Tensor]:
    """The tensors of an ``AutoencoderKL`` state dict that decoding reads
    (``post_quant_conv`` and ``decoder.*``)."""
    s = vae_decoder_struct(v)
    lat, mid = v["latent_channels"], s["mid"]
    yield from _conv("post_quant_conv", lat, lat, 1)
    yield from _conv("decoder.conv_in", mid, lat)
    for j in (0, 1):
        yield from _resnet(f"decoder.mid_block.resnets.{j}", mid, mid, None)
    a = "decoder.mid_block.attentions.0"
    yield from _norm(a + ".group_norm", mid)
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        yield from _linear(f"{a}.{name}", mid, mid)
    for block in s["up"]:
        for j, (cin, cout) in enumerate(block["resnets"]):
            yield from _resnet(f"{block['prefix']}.resnets.{j}", cin, cout, None)
        if block["upsample"]:
            yield from _conv(f"{block['prefix']}.upsamplers.0.conv", block["upsample"],
                             block["upsample"])
    yield from _norm("decoder.conv_norm_out", s["out"])
    yield from _conv("decoder.conv_out", v["out_channels"], s["out"])


def clip_projection(t: dict) -> Optional[int]:
    """The text projection's width where the model has one
    (``CLIPTextModelWithProjection``)."""
    arch = (t.get("architectures") or [""])[0]
    return t.get("projection_dim") if "WithProjection" in arch else None


def clip_text_tensors(t: dict) -> Iterator[Tensor]:
    """Every tensor of a transformers ``CLIPTextModel[WithProjection]`` state dict."""
    c, ff = t["hidden_size"], t["intermediate_size"]
    yield "text_model.embeddings.token_embedding.weight", (t["vocab_size"], c), "embed"
    yield ("text_model.embeddings.position_embedding.weight",
           (t["max_position_embeddings"], c), "embed")
    for i in range(t["num_hidden_layers"]):
        b = f"text_model.encoder.layers.{i}"
        yield from _norm(b + ".layer_norm1", c)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield from _linear(f"{b}.self_attn.{name}", c, c)
        yield from _norm(b + ".layer_norm2", c)
        yield from _linear(b + ".mlp.fc1", ff, c)
        yield from _linear(b + ".mlp.fc2", c, ff)
    yield from _norm("text_model.final_layer_norm", c)
    proj = clip_projection(t)
    if proj:
        yield from _linear("text_projection", proj, c, bias=False)


def towers(config: dict) -> List[str]:
    """The text towers a configuration has, in the order they are concatenated."""
    return [k for k in ("text_encoder", "text_encoder_2") if k in config]


def components(config: dict) -> Dict[str, Iterator[Tensor]]:
    """Each model of a configuration and its tensors."""
    out = {k: clip_text_tensors(config[k]) for k in towers(config)}
    out["unet"] = unet_tensors(config["unet"])
    out["vae"] = vae_decoder_tensors(config["vae"])
    return out
