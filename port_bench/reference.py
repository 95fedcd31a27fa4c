"""The plain reference: Stable Diffusion txt2img with LCM, as diffusers
and transformers compute it, in plain PyTorch on the published state dicts.

Imports torch, numpy and the benchmark's own modules, nothing of the
program. NCHW float32 with TF32 off; one image at a time; no kernels, no
graphs, no batching. It follows the published models:

- CLIP text towers (quick_gelu or exact gelu, causal attention, final
  LayerNorm; SDXL reads the penultimate layer's state and the second
  tower's projected EOS embedding);
- the UNet (``UNet2DConditionModel``: resnets with GroupNorm eps 1e-5,
  transformers with GroupNorm eps 1e-6 and LayerNorms eps 1e-5, GEGLU,
  the LCM w-embedding through ``time_embedding.cond_proj``, SDXL's
  ``text_time`` micro-conditioning);
- the VAE decoder (``AutoencoderKL``: GroupNorm eps 1e-6, a single-head
  mid attention);
- the LCM scheduler (diffusers' ``LCMScheduler``: the ladder, the
  boundary scalings, the renoising) and the serving recipe's host noise:
  ``np.random.RandomState(seed & 0x7FFFFFFF)``, the initial latents
  [1, 4, h, w] then the per-step noise [steps, 1, 4, h, w], NCHW;
- ``(x / 2 + 0.5).clamp(0, 1) * 255`` rounded to uint8.

``Precision`` says how the matrix products are computed. ``EXACT`` is the
reference. ``FP8`` is the control: the same model with every weight and
every input of a product rounded to float8 e4m3 (a scale a tensor), the
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import sd_arch, vocab


class Precision:
    """Exact float32 products."""

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        return t


class FP8(Precision):
    """Products of float8 e4m3 operands (one scale a tensor, amax to 448)."""

    @staticmethod
    def _round(t: torch.Tensor) -> torch.Tensor:
        scale = t.abs().amax().float().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    def w(self, t):
        return self._round(t)

    def a(self, t):
        return self._round(t)


EXACT, CONTROL = Precision(), FP8()


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Model:
    """One model's weights as float32 (in the precision's rounding)."""

    def __init__(self, state: Dict[str, torch.Tensor], p: Precision, groups: int = 32):
        self.p = p
        self.groups = groups  # GroupNorm's groups (norm_num_groups)
        self.t = {k: (p.w(v.float()) if v.ndim >= 2 and "embedding" not in k else v.float())
                  for k, v in state.items()}

    def has(self, key: str) -> bool:
        return key + ".weight" in self.t

    def linear(self, key: str, x: torch.Tensor) -> torch.Tensor:
        w = self.t[key + ".weight"]
        if w.ndim == 4:  # a 1x1 conv
            w = w[:, :, 0, 0]
        return F.linear(self.p.a(x), w, self.t.get(key + ".bias"))

    def conv(self, key: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        w = self.t[key + ".weight"]
        return F.conv2d(self.p.a(x), w, self.t.get(key + ".bias"), stride=stride,
                        padding=w.shape[-1] // 2)

    def group_norm(self, key: str, x, eps: float):
        return F.group_norm(x, self.groups, self.t[key + ".weight"], self.t[key + ".bias"], eps)

    def layer_norm(self, key: str, x, eps: float = 1e-5):
        return F.layer_norm(x, (x.shape[-1],), self.t[key + ".weight"], self.t[key + ".bias"], eps)

    def attend(self, q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
        """[B, N, C] x [B, M, C] -> [B, N, C], softmax in fp32."""
        b, n, c = q.shape
        d = c // heads
        q = q.reshape(b, n, heads, d).transpose(1, 2)
        k = k.reshape(b, -1, heads, d).transpose(1, 2)
        v = v.reshape(b, -1, heads, d).transpose(1, 2)
        s = torch.matmul(self.p.a(q), self.p.a(k).transpose(-1, -2)) * d ** -0.5
        if mask is not None:
            s = s + mask
        out = torch.matmul(self.p.a(torch.softmax(s, dim=-1)), self.p.a(v))
        return out.transpose(1, 2).reshape(b, n, c)


# ---------------------------------------------------------------------------
# CLIP text
# ---------------------------------------------------------------------------


def clip_text(m: Model, cfg: dict, ids: torch.Tensor):
    """(last state after the final LayerNorm, penultimate layer's state,
    pooled EOS embedding, projected where the tower has a projection)."""
    act = (lambda x: x * torch.sigmoid(1.702 * x)) if cfg["hidden_act"] == "quick_gelu" \
        else (lambda x: F.gelu(x))
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    n = ids.shape[1]
    x = (m.t["text_model.embeddings.token_embedding.weight"][ids]
         + m.t["text_model.embeddings.position_embedding.weight"][:n])
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    penultimate = x
    for i in range(cfg["num_hidden_layers"]):
        b = f"text_model.encoder.layers.{i}"
        penultimate = x
        h = m.layer_norm(b + ".layer_norm1", x, eps)
        h = m.attend(m.linear(b + ".self_attn.q_proj", h), m.linear(b + ".self_attn.k_proj", h),
                     m.linear(b + ".self_attn.v_proj", h), heads, mask)
        x = x + m.linear(b + ".self_attn.out_proj", h)
        h = m.layer_norm(b + ".layer_norm2", x, eps)
        x = x + m.linear(b + ".mlp.fc2", act(m.linear(b + ".mlp.fc1", h)))
    last = m.layer_norm("text_model.final_layer_norm", x, eps)
    eos = (ids == vocab.VOCAB_SIZE - 1).int().argmax(dim=-1)
    pooled = last[torch.arange(ids.shape[0], device=ids.device), eos]
    if sd_arch.clip_projection(cfg):
        pooled = m.linear("text_projection", pooled)
    return last, penultimate, pooled


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool, shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1) if flip else emb


def _resnet(m: Model, key: str, x, emb, eps: float):
    h = m.conv(key + ".conv1", F.silu(m.group_norm(key + ".norm1", x, eps)))
    if emb is not None:
        h = h + m.linear(key + ".time_emb_proj", F.silu(emb))[:, :, None, None]
    h = m.conv(key + ".conv2", F.silu(m.group_norm(key + ".norm2", h, eps)))
    if m.has(key + ".conv_shortcut"):
        x = m.conv(key + ".conv_shortcut", x)
    return x + h


def _transformer(m: Model, key: str, x, ctx, layers: int, heads: int):
    b, c, hh, ww = x.shape
    res = x
    h = m.group_norm(key + ".norm", x, 1e-6)
    if m.t[key + ".proj_in.weight"].ndim == 4:  # 1x1 conv, then tokens
        h = m.conv(key + ".proj_in", h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    else:
        h = m.linear(key + ".proj_in", h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
    for t in range(layers):
        k = f"{key}.transformer_blocks.{t}"
        n1 = m.layer_norm(k + ".norm1", h)
        a = m.attend(m.linear(k + ".attn1.to_q", n1), m.linear(k + ".attn1.to_k", n1),
                     m.linear(k + ".attn1.to_v", n1), heads)
        h = h + m.linear(k + ".attn1.to_out.0", a)
        n2 = m.layer_norm(k + ".norm2", h)
        a = m.attend(m.linear(k + ".attn2.to_q", n2), m.linear(k + ".attn2.to_k", ctx),
                     m.linear(k + ".attn2.to_v", ctx), heads)
        h = h + m.linear(k + ".attn2.to_out.0", a)
        g, gate = m.linear(k + ".ff.net.0.proj", m.layer_norm(k + ".norm3", h)).chunk(2, dim=-1)
        h = h + m.linear(k + ".ff.net.2", g * F.gelu(gate))
    if m.t[key + ".proj_out.weight"].ndim == 4:
        h = m.conv(key + ".proj_out", h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
    else:
        h = m.linear(key + ".proj_out", h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return h + res


def unet(m: Model, u: dict, x, t, ctx, w_emb=None, text_embeds=None, time_ids=None):
    """Noise prediction [B, 4, h, w] of a ``UNet2DConditionModel``."""
    s = sd_arch.unet_struct(u)
    eps = u.get("norm_eps", 1e-5)
    flip, shift = u["flip_sin_to_cos"], u["freq_shift"]
    t_emb = timestep_embedding(t, s["chans"][0], flip, shift)
    if w_emb is not None and m.has("time_embedding.cond_proj"):
        t_emb = t_emb + m.linear("time_embedding.cond_proj", w_emb)
    emb = m.linear("time_embedding.linear_2", F.silu(m.linear("time_embedding.linear_1", t_emb)))
    if u.get("addition_embed_type") == "text_time":
        ids = timestep_embedding(time_ids.flatten(), u["addition_time_embed_dim"], flip, shift)
        add = torch.cat([text_embeds, ids.reshape(time_ids.shape[0], -1)], dim=-1)
        emb = emb + m.linear("add_embedding.linear_2",
                             F.silu(m.linear("add_embedding.linear_1", add)))
    x = m.conv("conv_in", x)
    skips = [x]
    for block in s["down"]:
        p = block["prefix"]
        for j in range(len(block["resnets"])):
            x = _resnet(m, f"{p}.resnets.{j}", x, emb, eps)
            if j < len(block["attentions"]):
                _, layers, heads = block["attentions"][j]
                x = _transformer(m, f"{p}.attentions.{j}", x, ctx, layers, heads)
            skips.append(x)
        if block["downsample"]:
            x = m.conv(f"{p}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    mid = s["mid"]
    x = _resnet(m, "mid_block.resnets.0", x, emb, eps)
    if mid["attentions"]:
        _, layers, heads = mid["attentions"][0]
        x = _transformer(m, "mid_block.attentions.0", x, ctx, layers, heads)
    x = _resnet(m, "mid_block.resnets.1", x, emb, eps)
    for block in s["up"]:
        p = block["prefix"]
        for j in range(len(block["resnets"])):
            x = _resnet(m, f"{p}.resnets.{j}", torch.cat([x, skips.pop()], dim=1), emb, eps)
            if j < len(block["attentions"]):
                _, layers, heads = block["attentions"][j]
                x = _transformer(m, f"{p}.attentions.{j}", x, ctx, layers, heads)
        if block["upsample"]:
            x = m.conv(f"{p}.upsamplers.0.conv", F.interpolate(x, scale_factor=2.0,
                                                                 mode="nearest"))
    x = F.silu(m.group_norm("conv_norm_out", x, eps))
    return m.conv("conv_out", x)


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def vae_decode(m: Model, v: dict, z):
    """[B, 4, h, w] latents (already divided by the scaling factor) ->
    [B, 3, 8h, 8w] in [-1, 1]."""
    s = sd_arch.vae_decoder_struct(v)
    eps = 1e-6
    x = m.conv("decoder.conv_in", m.conv("post_quant_conv", z))
    x = _resnet(m, "decoder.mid_block.resnets.0", x, None, eps)
    a = "decoder.mid_block.attentions.0"
    b, c, hh, ww = x.shape
    h = m.group_norm(a + ".group_norm", x, eps).reshape(b, c, hh * ww).transpose(1, 2)
    h = m.attend(m.linear(a + ".to_q", h), m.linear(a + ".to_k", h), m.linear(a + ".to_v", h), 1)
    x = x + m.linear(a + ".to_out.0", h).transpose(1, 2).reshape(b, c, hh, ww)
    x = _resnet(m, "decoder.mid_block.resnets.1", x, None, eps)
    for block in s["up"]:
        for j in range(len(block["resnets"])):
            x = _resnet(m, f"{block['prefix']}.resnets.{j}", x, None, eps)
        if block["upsample"]:
            x = m.conv(f"{block['prefix']}.upsamplers.0.conv",
                       F.interpolate(x, scale_factor=2.0, mode="nearest"))
    x = F.silu(m.group_norm("decoder.conv_norm_out", x, eps))
    return m.conv("decoder.conv_out", x)


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------


def lcm_schedule(sched: dict, steps: int) -> dict:
    """diffusers' ``LCMScheduler``: the ladder and each step's scalars
    (float64, then float32 as the served schedule holds them)."""
    n_train = sched.get("num_train_timesteps", 1000)
    orig = sched.get("original_inference_steps", 50)
    if sched.get("beta_schedule", "scaled_linear") != "scaled_linear":
        raise ValueError("the reference takes the scaled_linear beta schedule")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n_train,
                        dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    k = n_train // orig
    origin = (np.arange(1, orig + 1) * k - 1)[::-1]
    idx = np.floor(np.linspace(0, len(origin), num=steps, endpoint=False)).astype(np.int64)
    ts = origin[idx]
    final = 1.0 if sched.get("set_alpha_to_one", True) else acp[0]
    prev = np.concatenate([ts[1:], ts[-1:]])
    a_t, a_prev = acp[ts], np.where(prev >= 0, acp[np.clip(prev, 0, None)], final)
    st = ts.astype(np.float64) * sched.get("timestep_scaling", 10.0)
    sd2 = 0.25  # sigma_data 0.5
    f32 = lambda v: [float(np.float32(x)) for x in v]
    return {"timesteps": [int(t) for t in ts], "sa": f32(np.sqrt(a_t)),
            "sb": f32(np.sqrt(1 - a_t)), "sa_prev": f32(np.sqrt(a_prev)),
            "sb_prev": f32(np.sqrt(1 - a_prev)), "c_skip": f32(sd2 / (st ** 2 + sd2)),
            "c_out": f32(st / np.sqrt(st ** 2 + sd2))}


def guidance_embedding(w: float, dim: int) -> np.ndarray:
    """diffusers' ``get_guidance_scale_embedding`` of (guidance - 1), in float64."""
    half = dim // 2
    freqs = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000.0) / (half - 1)))
    ang = (w * 1000.0) * freqs
    return np.concatenate([np.sin(ang), np.cos(ang)])[None].astype(np.float32)


def host_noise(seed: int, h: int, w: int, steps: int):
    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    lat = rs.randn(1, 4, h, w).astype(np.float32)
    noises = rs.randn(steps, 1, 4, h, w).astype(np.float32)
    return lat, noises


class Pipeline:
    """The reference txt2img of one configuration, over its seeded weights."""

    def __init__(self, config: dict, states: Dict[str, Dict[str, torch.Tensor]],
                 vocabulary: Dict[str, int], precision: Precision = EXACT, device="cpu"):
        self.config = config
        self.vocab = vocabulary
        self.device = torch.device(device)
        groups = {"unet": config["unet"]["norm_num_groups"],
                  "vae": config["vae"]["norm_num_groups"]}
        self.models = {name: Model(sd, precision, groups.get(name, 32))
                       for name, sd in states.items()}

    def _ids(self, prompt: str, tower: str) -> torch.Tensor:
        # SDXL's second tokenizer pads with "!" (id 0); CLIP's with EOS
        pad = 0 if tower == "text_encoder_2" else vocab.VOCAB_SIZE - 1
        return torch.from_numpy(vocab.ids(self.vocab, prompt, pad))[None].to(self.device)

    def encode(self, prompt: str):
        """(context [1, 77, C], pooled or None)."""
        if self.config["arch"] == "sd15":
            last, _, _ = clip_text(self.models["text_encoder"], self.config["text_encoder"],
                                   self._ids(prompt, "text_encoder"))
            return last, None
        seqs, pooled = [], None
        for tower in sd_arch.towers(self.config):
            _, pen, pooled = clip_text(self.models[tower], self.config[tower],
                                       self._ids(prompt, tower))
            seqs.append(pen)
        return torch.cat(seqs, dim=-1), pooled

    @torch.no_grad()
    def __call__(self, prompt: str, seed: int, height: int, width: int, steps: int,
                 guidance: float = 1.0) -> np.ndarray:
        """uint8 [H, W, 3]."""
        with no_tf32():
            return self._generate(prompt, seed, height, width, steps, guidance)

    def _generate(self, prompt, seed, height, width, steps, guidance):
        cfg, dev = self.config, self.device
        u, v = cfg["unet"], cfg["vae"]
        scale = 2 ** (len(v["block_out_channels"]) - 1)
        h, w = height // scale, width // scale
        ctx, pooled = self.encode(prompt)
        kw = {}
        if u.get("time_cond_proj_dim"):
            kw["w_emb"] = torch.from_numpy(
                guidance_embedding(guidance - 1.0, u["time_cond_proj_dim"])).to(dev)
        elif guidance > 1.0:
            raise ValueError("the reference serves classifier-free guidance only as the w-embedding")
        if u.get("addition_embed_type") == "text_time":
            kw["text_embeds"] = pooled
            kw["time_ids"] = torch.tensor([[height, width, 0, 0, height, width]],
                                          dtype=torch.float32, device=dev)
        sch = lcm_schedule(cfg["scheduler"], steps)
        lat, noises = host_noise(seed, h, w, steps)
        lat = torch.from_numpy(lat).to(dev)
        noises = torch.from_numpy(noises).to(dev)
        unet_m = self.models["unet"]
        for i in range(steps):
            t = torch.full((1,), sch["timesteps"][i], dtype=torch.int64, device=dev)
            eps = unet(unet_m, u, lat, t, ctx, **kw)
            x0 = (lat - sch["sb"][i] * eps) / sch["sa"][i]
            denoised = sch["c_out"][i] * x0 + sch["c_skip"][i] * lat
            lat = (sch["sa_prev"][i] * denoised + sch["sb_prev"][i] * noises[i]
                   if i < steps - 1 else denoised)
        img = vae_decode(self.models["vae"], v, denoised / v["scaling_factor"])
        img = ((img / 2 + 0.5).clamp(0, 1) * 255.0).round().to(torch.uint8)
        return img[0].permute(1, 2, 0).cpu().numpy()
