"""Operations and bytes of one image, counted from a configuration's shapes.

2 FLOPs a multiply-add, over every conv, every linear and attention's two
products (Q·Kᵀ and P·V): the text tower(s) at 77 tokens, ``steps`` UNet
calls and the VAE decode. The counts depend on the configuration and the
image size alone, never on which kernel computes the work.

Also the kernels' census and bounds, frozen here with the peaks they are
held to: the attention calls the flash kernel (K1) serves and the
GroupNorm+SiLU calls the fused kernel (K2+K3) serves, each call's least
time on one H100 from its operations and the bytes it must move (inputs
read once, outputs written once).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from . import sd_arch

# NVIDIA H100 SXM, dense: bf16 tensor cores, fp32 outside them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
CONTEXT = 77
BF16 = 2

# K1's route on the card (the program's ops/attention.py as benchmarked):
# spatial self-attention with at least 256 queries and keys and d <= 128
FLASH_MIN_TOKENS = 256
FLASH_MAX_HEAD_DIM = 128


@dataclasses.dataclass
class Attention:
    n: int  # queries
    m: int  # keys
    heads: int
    d: int
    self_attn: bool

    @property
    def flops(self) -> float:
        return 4.0 * self.n * self.m * self.heads * self.d

    @property
    def on_flash(self) -> bool:
        return (self.self_attn and self.n >= FLASH_MIN_TOKENS and self.m >= FLASH_MIN_TOKENS
                and self.d <= FLASH_MAX_HEAD_DIM)

    def bound_s(self, rows: int = 1) -> float:
        ops = rows * self.flops
        nbytes = rows * BF16 * (2 * self.n + 2 * self.m) * self.heads * self.d
        return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


@dataclasses.dataclass
class GroupNormSilu:
    numel: int  # elements of x, one row
    channels: int

    def bound_s(self, rows: int = 1) -> float:
        # x read once, y written once (bf16), gamma and beta once; about 10
        # fp32 operations an element (statistics, normalise, SiLU)
        nbytes = rows * 2 * BF16 * self.numel + 2 * BF16 * self.channels
        return max(rows * 10.0 * self.numel / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    attention: List[Attention] = dataclasses.field(default_factory=list)
    gn_silu: List[GroupNormSilu] = dataclasses.field(default_factory=list)
    parts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, part: str, flops: float) -> None:
        self.flops += flops
        self.parts[part] = self.parts.get(part, 0.0) + flops

    def attend(self, part: str, a: Attention) -> None:
        self.add(part, a.flops)
        self.attention.append(a)


def linear(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def conv(hw: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * hw * cin * cout * k * k


def text_work(w: Work, t: dict, part: str) -> None:
    c, ff, heads = t["hidden_size"], t["intermediate_size"], t["num_attention_heads"]
    for _ in range(t["num_hidden_layers"]):
        w.add(part, 4 * linear(CONTEXT, c, c) + linear(CONTEXT, c, ff) + linear(CONTEXT, ff, c))
        w.attend(part, Attention(CONTEXT, CONTEXT, heads, c // heads, True))
    proj = sd_arch.clip_projection(t)
    if proj:
        w.add(part, linear(1, c, proj))


def _resnet(w: Work, part: str, hw: int, cin: int, cout: int, temb) -> None:
    w.gn_silu.append(GroupNormSilu(hw * cin, cin))
    w.add(part, conv(hw, cin, cout) + conv(hw, cout, cout))
    w.gn_silu.append(GroupNormSilu(hw * cout, cout))
    if temb:
        w.add(part, linear(1, temb, cout))
    if cin != cout:
        w.add(part, conv(hw, cin, cout, 1))


def _transformer(w: Work, part: str, n: int, c: int, layers: int, heads: int, ctx: int) -> None:
    w.add(part, 2 * linear(n, c, c))  # proj_in, proj_out
    d = c // heads
    for _ in range(layers):
        w.add(part, 4 * linear(n, c, c))  # attn1 q, k, v, out
        w.attend(part, Attention(n, n, heads, d, True))
        w.add(part, 2 * linear(n, c, c) + 2 * linear(CONTEXT, ctx, c))  # attn2 q, out; k, v
        w.attend(part, Attention(n, CONTEXT, heads, d, False))
        w.add(part, linear(n, c, 8 * c) + linear(n, 4 * c, c))  # GEGLU


def unet_work(w: Work, u: dict, h: int, wd: int, part: str = "unet") -> None:
    s = sd_arch.unet_struct(u)
    c0, temb, ctx = s["chans"][0], s["temb"], u["cross_attention_dim"]
    hw = lambda level: (h >> level) * (wd >> level)
    if u.get("time_cond_proj_dim"):
        w.add(part, linear(1, u["time_cond_proj_dim"], c0))
    w.add(part, linear(1, c0, temb) + linear(1, temb, temb))
    if u.get("addition_embed_type") == "text_time":
        w.add(part, linear(1, u["projection_class_embeddings_input_dim"], temb)
              + linear(1, temb, temb))
    w.add(part, conv(hw(0), u["in_channels"], c0))
    for block in s["down"] + [s["mid"]] + s["up"]:
        lv = block["level"]
        for j, (cin, cout) in enumerate(block["resnets"]):
            _resnet(w, part, hw(lv), cin, cout, temb)
            if j < len(block["attentions"]):
                c, layers, heads = block["attentions"][j]
                _transformer(w, part, hw(lv), c, layers, heads, ctx)
        if block.get("downsample"):
            c = block["downsample"]
            w.add(part, conv(hw(lv + 1), c, c))
        if block.get("upsample"):
            c = block["upsample"]
            w.add(part, conv(hw(lv - 1), c, c))
    w.gn_silu.append(GroupNormSilu(hw(0) * c0, c0))
    w.add(part, conv(hw(0), c0, u["out_channels"]))


def vae_work(w: Work, v: dict, h: int, wd: int, part: str = "vae") -> None:
    s = sd_arch.vae_decoder_struct(v)
    lat, mid = v["latent_channels"], s["mid"]
    hw = h * wd
    w.add(part, conv(hw, lat, lat, 1) + conv(hw, lat, mid))
    _resnet(w, part, hw, mid, mid, None)
    w.add(part, 4 * linear(hw, mid, mid))
    w.attend(part, Attention(hw, hw, 1, mid, True))
    _resnet(w, part, hw, mid, mid, None)
    for k, block in enumerate(s["up"]):
        res = hw * 4 ** k
        for cin, cout in block["resnets"]:
            _resnet(w, part, res, cin, cout, None)
        if block["upsample"]:
            c = block["upsample"]
            w.add(part, conv(res * 4, c, c))
    out = hw * 4 ** (len(s["up"]) - 1)
    w.gn_silu.append(GroupNormSilu(out * s["out"], s["out"]))
    w.add(part, conv(out, s["out"], v["out_channels"]))


def image_work(config: dict, height: int, width: int, steps: int) -> Work:
    """Everything one image of ``height`` x ``width`` in ``steps`` steps computes."""
    scale = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    h, wd = height // scale, width // scale
    w = Work()
    for tower in sd_arch.towers(config):
        text_work(w, config[tower], tower)
    for _ in range(steps):
        unet_work(w, config["unet"], h, wd)
    vae_work(w, config["vae"], h, wd)
    return w


def flash_calls(work: Work) -> List[Attention]:
    return [a for a in work.attention if a.on_flash]


def census(config: dict, height: int, width: int, steps: int) -> Tuple[int, int]:
    """(K1 launches, K2+K3 launches) of one replay: one launch a call,
    whatever the batch."""
    w = image_work(config, height, width, steps)
    return len(flash_calls(w)), len(w.gn_silu)
