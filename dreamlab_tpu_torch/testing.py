"""Randomly initialised SD1.5 and SDXL bundles, full width or tiny, and a writer
that saves a bundle as a diffusers-layout checkpoint directory (port of
``dreamlab_tpu/testing.py::random_bundle`` and of the exporters of
``tests/test_loader.py``), random LoRA state dicts over every UNet
projection the LoRA key map reaches (``random_lora``), random ControlNets
and their diffusers directories (``random_controlnet``,
``write_controlnet_dir``), random SDXL refiner bundles
(``random_refiner_bundle``), seeded ESPCN weights and their ``.onnx`` file
(``random_espcn``, ``write_espcn_onnx``: a protobuf encoder of the port's
own, so the chip run needs no ONNX package), ``modes.yaml`` files
(``write_modes_yaml``, without PyYAML), and random CLIP models written as HF
``CLIPModel`` directories (``random_clip``, ``write_clip_dir``: Yume's
native scorer).

Speed does not depend on weight values, so the chip smoke run drives the real
architectures with seeded random weights when no checkpoint is at hand. The
init scheme is the JAX package's (uniform +-1/sqrt(fan_in), norms 1/0,
embeddings N(0, 0.02)): activations stay finite in bf16 through 4 steps.
``write_diffusers_dir`` is the loader's inverse: ``loader.load_pipeline`` of
what it writes gives the bundle back, leaf for leaf. ``write_single_file``
does the same for an SD1.5 bundle in the LDM single-file layout, the inverse
of ``loader_single_file.py``'s key tables.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Dict, Optional

import numpy as np
import torch

from . import lora
from .models import clip_text, clip_vision, configs, controlnet, superres, unet, vae
from .pipeline import PipelineBundle
from .scheduler.lcm import LCMConfig
from .utils.safetensors import save_file
from .utils.tokenizer import CLIPTokenizer, make_test_tokenizer

WORDS = ["cat", "dog", "sunset", "mountain"]


def random_bundle(arch: str = "sd15", *, tiny: bool = False, seed: int = 0,
                  device="cpu") -> PipelineBundle:
    """A bundle with random fp32 weights, the VAE encoder included, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``.

    The tiny SDXL bundle keeps the published text widths (768 + 1280 = the
    2048-wide context by which the loader tells SDXL) at two layers each,
    and TINY_UNET_XL's topology with that context and a mid block as deep
    as its last level, as diffusers' config can express.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = make_test_tokenizer(WORDS)
    vocab = len(tok.encoder)
    if arch == "sd15":
        unet_cfg = configs.TINY_UNET if tiny else configs.SD15_UNET
        vae_cfg = configs.TINY_VAE if tiny else configs.SD15_VAE
        if tiny:
            # text width tied to the cross-attention dim, as in real checkpoints
            text_cfg = configs.CLIPTextConfig(
                vocab_size=vocab, hidden_size=unet_cfg.cross_attention_dim,
                num_layers=2, num_heads=2, intermediate_size=64)
        else:
            text_cfg = dataclasses.replace(configs.SD15_TEXT, vocab_size=vocab)
        text_cfg_2 = tok_2 = None
    elif arch == "sdxl":
        if tiny:
            unet_cfg = dataclasses.replace(configs.TINY_UNET_XL, cross_attention_dim=2048,
                                           mid_block_transformer_layers=2)
            vae_cfg = configs.TINY_VAE
            small = dict(vocab_size=vocab, num_layers=2, num_heads=2, intermediate_size=64)
            text_cfg = dataclasses.replace(configs.SDXL_TEXT_L, **small)
            text_cfg_2 = dataclasses.replace(configs.SDXL_TEXT_BIGG, projection_dim=32, **small)
        else:
            unet_cfg, vae_cfg = configs.SDXL_UNET, configs.SDXL_VAE
            text_cfg = dataclasses.replace(configs.SDXL_TEXT_L, vocab_size=vocab)
            text_cfg_2 = dataclasses.replace(configs.SDXL_TEXT_BIGG, vocab_size=vocab)
        tok_2 = make_test_tokenizer(WORDS, pad_token="!")  # SDXL's tokenizer_2 pads with "!"
    else:
        raise ValueError(f"unknown arch {arch!r}")
    with torch.no_grad():
        return PipelineBundle(
            arch=arch,
            tokenizer=tok,
            text_cfg=text_cfg,
            text_params=clip_text.init_params(text_cfg, gen),
            unet_cfg=unet_cfg,
            unet_params=unet.init_params(unet_cfg, gen),
            vae_cfg=vae_cfg,
            vae_params=vae.init_decoder_params(vae_cfg, gen),
            scheduler_cfg=LCMConfig(),
            tokenizer_2=tok_2,
            text_cfg_2=text_cfg_2,
            text_params_2=None if text_cfg_2 is None else clip_text.init_params(text_cfg_2, gen),
            # drawn last: the other trees keep the values they had without it
            vae_encoder_params=vae.init_encoder_params(vae_cfg, gen),
        )


# the SDXL refiner's UNet: unet/config.json of stabilityai/stable-diffusion-xl-refiner-1.0
SDXL_REFINER_UNET = configs.UNetConfig(
    block_out_channels=(384, 768, 1536, 1536),
    layers_per_block=2,
    transformer_layers_per_block=(0, 4, 4, 0),
    num_attention_heads=(6, 12, 24, 24),
    cross_attention_dim=1280,
    time_cond_proj_dim=None,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2560,  # pooled 1280 + 5 x 256
    mid_block_transformer_layers=4,
)

# tests/test_refiner.py's tiny refiner: one bigG-like tower, 5 time ids
TINY_REFINER_UNET = dataclasses.replace(configs.TINY_UNET_XL,
                                        projection_class_embeddings_input_dim=32 + 5 * 8)

# diffusers' ControlNetModel of lllyasviel/sd-controlnet-canny: the SD1.5
# trunk without the LCM cond_proj, and its hint ladder's widths
SD15_CONTROLNET = dataclasses.replace(configs.SD15_UNET, time_cond_proj_dim=None)
CONTROLNET_COND_CHANNELS = (16, 32, 96, 256)


def random_refiner_bundle(*, tiny: bool = False, seed: int = 0, device="cpu") -> PipelineBundle:
    """An SDXL refiner bundle with random fp32 weights (the VAE encoder
    included): one OpenCLIP bigG tower (SDXL_TEXT_BIGG; tiny: 64 wide, two
    layers, projection 32) and the refiner's UNet (SDXL_REFINER_UNET, or
    tests/test_refiner.py's TINY_REFINER_UNET) over the SDXL VAE (TINY_VAE)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = make_test_tokenizer(WORDS)
    if tiny:
        text_cfg = configs.CLIPTextConfig(
            vocab_size=len(tok.encoder), hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=64, hidden_act="gelu", penultimate=True, projection_dim=32)
        unet_cfg, vae_cfg = TINY_REFINER_UNET, configs.TINY_VAE
    else:
        text_cfg = dataclasses.replace(configs.SDXL_TEXT_BIGG, vocab_size=len(tok.encoder))
        unet_cfg, vae_cfg = SDXL_REFINER_UNET, configs.SDXL_VAE
    with torch.no_grad():
        return PipelineBundle(
            arch="sdxl", tokenizer=tok, text_cfg=text_cfg,
            text_params=clip_text.init_params(text_cfg, gen),
            unet_cfg=unet_cfg, unet_params=unet.init_params(unet_cfg, gen),
            vae_cfg=vae_cfg, vae_params=vae.init_decoder_params(vae_cfg, gen),
            scheduler_cfg=LCMConfig(),
            vae_encoder_params=vae.init_encoder_params(vae_cfg, gen))


def random_controlnet(unet_cfg: configs.UNetConfig, *, seed: int = 7, zero_taps: bool = False,
                      vae_scale: int = 8, cond_channels=None, device="cpu"):
    """A random fp32 ControlNet for ``unet_cfg``'s trunk, drawn on ``device``.
    The hint ladder's widths are ``cond_channels`` where given, else 16·2^i
    over log2(vae_scale) + 1 levels (the JAX package's ``random_controlnet``),
    so its embedding lands at latent resolution."""
    if cond_channels is None:
        cond_channels = tuple(16 * 2 ** i for i in range(vae_scale.bit_length()))
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return controlnet.init_params(unet_cfg, gen, cond_channels=tuple(cond_channels),
                                      zero_taps=zero_taps)


_DIFFUSERS_LEAF = {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out.0",
                   "ff_geglu": "ff.net.0.proj", "ff_out": "ff.net.2"}


def lora_paths(unet_params):
    """Every UNet projection path a LoRA key map reaches: each spatial
    transformer's proj_in / proj_out and its blocks' q, k, v, out, GEGLU and
    FF-out linears (``lora._module_to_tree_path``'s targets)."""
    def transformers():
        for side in ("down", "up"):
            for i, block in enumerate(unet_params[side]):
                for j, _ in enumerate(block.get("attentions") or []):
                    yield f"{side}.{i}.attentions.{j}", block["attentions"][j]
        if "attention" in unet_params["mid"]:
            yield "mid.attention", unet_params["mid"]["attention"]

    for prefix, tr in transformers():
        yield f"{prefix}.proj_in"
        for k, blk in enumerate(tr["blocks"]):
            for attn in ("attn1", "attn2"):
                for leaf in ("q", "k", "v", "out"):
                    yield f"{prefix}.blocks.{k}.{attn}.{leaf}"
            yield f"{prefix}.blocks.{k}.ff_geglu"
            yield f"{prefix}.blocks.{k}.ff_out"
        yield f"{prefix}.proj_out"


def _diffusers_module(path: str) -> str:
    """A UNet tree path -> its diffusers module name (the key map's inverse)."""
    m = path.replace("mid.attention", "mid_block.attentions.0")
    m = re.sub(r"^(down|up)\.(\d+)", r"\1_blocks.\2", m)
    m = re.sub(r"\.blocks\.(\d+)", r".transformer_blocks.\1", m)
    stem, _, leaf = m.rpartition(".")
    return f"{stem}.{_DIFFUSERS_LEAF.get(leaf, leaf)}"


def random_lora(unet_params, *, rank: int = 8, dialect: str = "kohya", seed: int = 0,
                alpha: float = 4.0, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A LoRA state dict over every path of ``lora_paths`` (shapes from the
    tree), in the kohya dialect (``lora_unet_..._to_q.lora_down.weight``,
    with ``.alpha``) or the diffusers / PEFT one (``unet....to_q.lora_A.weight``,
    alpha = rank): down ~ N(0, 1/in), up ~ N(0, 0.01/rank), on the tree's device."""
    out: Dict[str, torch.Tensor] = {}
    for path in lora_paths(unet_params):
        w = lora.leaf(unet_params, path)
        gen = torch.Generator(device=w.device).manual_seed(seed)
        seed += 1
        n_out, n_in = w.shape
        down = torch.randn((rank, n_in), generator=gen, device=w.device) / n_in ** 0.5
        up = torch.randn((n_out, rank), generator=gen, device=w.device) * (0.1 / rank ** 0.5)
        module = _diffusers_module(path)
        if dialect == "kohya":
            key = "lora_unet_" + module.replace(".", "_")
            out.update({f"{key}.lora_down.weight": down.to(dtype),
                        f"{key}.lora_up.weight": up.to(dtype),
                        f"{key}.alpha": torch.tensor(alpha, dtype=dtype)})
        elif dialect == "diffusers":
            out.update({f"unet.{module}.lora_A.weight": down.to(dtype),
                        f"unet.{module}.lora_B.weight": up.to(dtype)})
        else:
            raise ValueError(f"unknown LoRA dialect {dialect!r}")
    return out


def cast_tree(tree, dtype: torch.dtype):
    """A parameter tree with every leaf cast to ``dtype`` (None stays None)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return None if tree is None else tree.to(dtype)


def cast_params(bundle: PipelineBundle, dtype: torch.dtype) -> PipelineBundle:
    """``bundle`` with every leaf of its parameter trees cast to ``dtype``
    (the dtype ``write_diffusers_dir`` then stores)."""
    return dataclasses.replace(bundle, **{
        name: cast_tree(getattr(bundle, name), dtype)
        for name in ("text_params", "text_params_2", "unet_params", "vae_params",
                     "vae_encoder_params")})


# ---------------------------------------------------------------------------
# the loader's inverse: parameter trees -> diffusers state dicts and configs
# ---------------------------------------------------------------------------


class _Out(dict):
    """A flat state dict under construction, in torch naming."""

    def conv(self, key, p):
        self[key + ".weight"] = p["w"]
        if "b" in p:
            self[key + ".bias"] = p["b"]

    linear = conv  # the port's linears are [out, in], as torch stores them

    def norm(self, key, p):
        self[key + ".weight"] = p["scale"]
        self[key + ".bias"] = p["bias"]

    def resnet(self, key, p):
        self.norm(key + ".norm1", p["norm1"])
        self.conv(key + ".conv1", p["conv1"])
        if "time_emb_proj" in p:
            self.linear(key + ".time_emb_proj", p["time_emb_proj"])
        self.norm(key + ".norm2", p["norm2"])
        self.conv(key + ".conv2", p["conv2"])
        if "shortcut" in p:
            self.conv(key + ".conv_shortcut", p["shortcut"])

    def attention(self, key, p, out="to_out.0"):
        for name, sub in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", out)):
            self.linear(f"{key}.{sub}", p[name])

    def vae_mid(self, key, p):
        self.resnet(key + ".resnets.0", p["resnet1"])
        self.resnet(key + ".resnets.1", p["resnet2"])
        self.norm(key + ".attentions.0.group_norm", p["attention"]["norm"])
        self.attention(key + ".attentions.0", p["attention"])

    def transformer(self, key, p):
        self.norm(key + ".norm", p["norm"])
        self.linear(key + ".proj_in", p["proj_in"])
        for k, blk in enumerate(p["blocks"]):
            b = f"{key}.transformer_blocks.{k}"
            self.norm(b + ".norm1", blk["ln1"])
            self.attention(b + ".attn1", blk["attn1"])
            self.norm(b + ".norm2", blk["ln2"])
            self.attention(b + ".attn2", blk["attn2"])
            self.norm(b + ".norm3", blk["ln3"])
            self.linear(b + ".ff.net.0.proj", blk["ff_geglu"])
            self.linear(b + ".ff.net.2", blk["ff_out"])
        self.linear(key + ".proj_out", p["proj_out"])


def _export_trunk(out: _Out, params) -> None:
    """A UNet's conv_in, embeddings, down and mid stack (a ControlNet's trunk)."""
    out.conv("conv_in", params["conv_in"])
    for name, p in params["time_embedding"].items():
        out.linear(f"time_embedding.{name}", p)
    for name, p in params.get("add_embedding", {}).items():
        out.linear(f"add_embedding.{name}", p)
    for i, block in enumerate(params["down"]):
        for j, res in enumerate(block["resnets"]):
            out.resnet(f"down_blocks.{i}.resnets.{j}", res)
            if block.get("attentions"):
                out.transformer(f"down_blocks.{i}.attentions.{j}", block["attentions"][j])
        if "downsample" in block:
            out.conv(f"down_blocks.{i}.downsamplers.0.conv", block["downsample"])
    out.resnet("mid_block.resnets.0", params["mid"]["resnet1"])
    out.resnet("mid_block.resnets.1", params["mid"]["resnet2"])
    if "attention" in params["mid"]:
        out.transformer("mid_block.attentions.0", params["mid"]["attention"])


def export_unet(params) -> Dict[str, torch.Tensor]:
    out = _Out()
    _export_trunk(out, params)
    for k, block in enumerate(params["up"]):
        for j, res in enumerate(block["resnets"]):
            out.resnet(f"up_blocks.{k}.resnets.{j}", res)
            if block.get("attentions"):
                out.transformer(f"up_blocks.{k}.attentions.{j}", block["attentions"][j])
        if "upsample" in block:
            out.conv(f"up_blocks.{k}.upsamplers.0.conv", block["upsample"])
    out.norm("conv_norm_out", params["norm_out"])
    out.conv("conv_out", params["conv_out"])
    return out


def export_controlnet(params) -> Dict[str, torch.Tensor]:
    """A diffusers ``ControlNetModel`` state dict (``loader.convert_controlnet``'s inverse)."""
    out = _Out()
    _export_trunk(out, params)
    emb = params["cond_embedding"]
    out.conv("controlnet_cond_embedding.conv_in", emb["conv_in"])
    for i, blk in enumerate(emb["blocks"]):
        out.conv(f"controlnet_cond_embedding.blocks.{i}", blk)
    out.conv("controlnet_cond_embedding.conv_out", emb["conv_out"])
    for i, tap in enumerate(params["zero_down"]):
        out.conv(f"controlnet_down_blocks.{i}", tap)
    out.conv("controlnet_mid_block", params["zero_mid"])
    return out


def write_controlnet_dir(params, cfg: configs.UNetConfig, path: str) -> str:
    """Save a ControlNet as diffusers lays one out: ``config.json`` of class
    ``ControlNetModel`` (read by both packages' ``load_controlnet`` and by the
    model detector) and its safetensors file, each tensor in its own dtype;
    returns ``path``."""
    raw = unet_config_json(cfg)
    raw.pop("up_block_types")
    raw.update(_class_name="ControlNetModel", conditioning_embedding_out_channels=[
        blk["w"].shape[0] for blk in [params["cond_embedding"]["conv_in"]]
        + params["cond_embedding"]["blocks"][1::2]])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f, indent=1)
    save_file(export_controlnet(params), os.path.join(path, "diffusion_pytorch_model.safetensors"),
              {"format": "pt"})
    return path


def export_vae(params, encoder=None) -> Dict[str, torch.Tensor]:
    """An ``AutoencoderKL`` state dict: the decoder's tree, and the encoder's
    where given."""
    out = _Out()
    if "post_quant_conv" in params:
        out.conv("post_quant_conv", params["post_quant_conv"])
    out.conv("decoder.conv_in", params["conv_in"])
    out.vae_mid("decoder.mid_block", params["mid"])
    for k, block in enumerate(params["up"]):
        for j, res in enumerate(block["resnets"]):
            out.resnet(f"decoder.up_blocks.{k}.resnets.{j}", res)
        if "upsample" in block:
            out.conv(f"decoder.up_blocks.{k}.upsamplers.0.conv", block["upsample"])
    out.norm("decoder.conv_norm_out", params["norm_out"])
    out.conv("decoder.conv_out", params["conv_out"])
    if encoder is None:
        return out
    out.conv("encoder.conv_in", encoder["conv_in"])
    for i, block in enumerate(encoder["down"]):
        for j, res in enumerate(block["resnets"]):
            out.resnet(f"encoder.down_blocks.{i}.resnets.{j}", res)
        if "downsample" in block:
            out.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", block["downsample"])
    out.vae_mid("encoder.mid_block", encoder["mid"])
    out.norm("encoder.conv_norm_out", encoder["norm_out"])
    out.conv("encoder.conv_out", encoder["conv_out"])
    if "quant_conv" in encoder:
        out.conv("quant_conv", encoder["quant_conv"])
    return out


def export_clip_text(params) -> Dict[str, torch.Tensor]:
    out = _Out()
    pre = "text_model."
    out[pre + "embeddings.token_embedding.weight"] = params["token_embedding"]["w"]
    out[pre + "embeddings.position_embedding.weight"] = params["position_embedding"]["w"]
    for i, layer in enumerate(params["layers"]):
        b = f"{pre}encoder.layers.{i}"
        out.norm(b + ".layer_norm1", layer["ln1"])
        for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                           ("out", "out_proj")):
            out.linear(f"{b}.self_attn.{proj}", layer["attn"][name])
        out.norm(b + ".layer_norm2", layer["ln2"])
        out.linear(b + ".mlp.fc1", layer["fc1"])
        out.linear(b + ".mlp.fc2", layer["fc2"])
    out.norm(pre + "final_layer_norm", params["final_ln"])
    if "text_projection" in params:
        out.linear("text_projection", params["text_projection"])
    return out


def unet_config_json(cfg: configs.UNetConfig) -> Dict:
    """diffusers' ``unet/config.json`` for ``cfg``: the head counts under
    ``attention_head_dim`` as SD1.5 and SDXL checkpoints store them, and the
    mid block as deep as the last level's ``transformer_layers_per_block``
    entry (the only depth diffusers' config can give it)."""
    tl = list(cfg.transformer_layers_per_block)
    mid = cfg.mid_block_transformer_layers
    if mid and tl[-1] not in (0, mid):
        raise ValueError(f"mid block depth {mid} differs from the last level's {tl[-1]}: "
                         "diffusers' config cannot express it")
    down = ["CrossAttnDownBlock2D" if n else "DownBlock2D" for n in tl]
    raw = {
        "_class_name": "UNet2DConditionModel",
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": down,
        "up_block_types": [t.replace("Down", "Up") for t in reversed(down)],
        "mid_block_type": "UNetMidBlock2DCrossAttn" if mid else None,
        # a level without attention reads no depth: 1 there, the mid's at the last
        "transformer_layers_per_block": [n or 1 for n in tl[:-1]] + [tl[-1] or mid or 1],
        "attention_head_dim": list(cfg.num_attention_heads),
        "cross_attention_dim": cfg.cross_attention_dim,
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": cfg.norm_groups,
        "flip_sin_to_cos": cfg.flip_sin_to_cos, "freq_shift": cfg.freq_shift,
        "time_cond_proj_dim": cfg.time_cond_proj_dim,
    }
    if cfg.addition_embed_type is not None:
        raw.update(addition_embed_type=cfg.addition_embed_type,
                   addition_time_embed_dim=cfg.addition_time_embed_dim,
                   projection_class_embeddings_input_dim=(
                       cfg.projection_class_embeddings_input_dim))
    return raw


def text_config_json(cfg: configs.CLIPTextConfig) -> Dict:
    arch = "CLIPTextModelWithProjection" if cfg.projection_dim else "CLIPTextModel"
    raw = {"architectures": [arch], "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "max_position_embeddings": cfg.max_position_embeddings,
           "intermediate_size": cfg.intermediate_size, "hidden_act": cfg.hidden_act,
           "layer_norm_eps": cfg.layer_norm_eps}
    if cfg.projection_dim:
        raw["projection_dim"] = cfg.projection_dim
    return raw


def _write_tokenizer(tok: CLIPTokenizer, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(tok.encoder, f, ensure_ascii=False)
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(" ".join(m) + "\n" for m in merges))
    cfg = {"model_max_length": tok.max_length}
    if tok.pad_id != tok.eos_id:
        cfg["pad_token"] = next(t for t, i in tok.encoder.items() if i == tok.pad_id)
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, ensure_ascii=False)


def write_diffusers_dir(bundle: PipelineBundle, model_dir: str) -> str:
    """Save ``bundle`` as a diffusers-layout checkpoint directory, each tensor
    in its own dtype; returns ``model_dir``."""

    def component(name, cfg_json, tensors, weights="diffusion_pytorch_model.safetensors"):
        os.makedirs(os.path.join(model_dir, name), exist_ok=True)
        with open(os.path.join(model_dir, name, "config.json"), "w") as f:
            json.dump(cfg_json, f, indent=1)
        save_file(tensors, os.path.join(model_dir, name, weights), {"format": "pt"})

    xl = bundle.arch == "sdxl"
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionXLPipeline" if xl
                   else "StableDiffusionPipeline"}, f)
    component("unet", unet_config_json(bundle.unet_cfg), export_unet(bundle.unet_params))
    vcfg = bundle.vae_cfg
    component("vae", {"_class_name": "AutoencoderKL", "latent_channels": vcfg.latent_channels,
                      "out_channels": vcfg.out_channels,
                      "block_out_channels": list(vcfg.block_out_channels),
                      "layers_per_block": vcfg.layers_per_block,
                      "norm_num_groups": vcfg.norm_groups,
                      "scaling_factor": vcfg.scaling_factor},
              export_vae(bundle.vae_params, bundle.vae_encoder_params))
    towers = [("", bundle.tokenizer, bundle.text_cfg, bundle.text_params)]
    if bundle.text_params_2 is not None:
        towers.append(("_2", bundle.tokenizer_2, bundle.text_cfg_2, bundle.text_params_2))
    for suffix, tok, cfg, params in towers:
        component("text_encoder" + suffix, text_config_json(cfg), export_clip_text(params),
                  weights="model.safetensors")
        _write_tokenizer(tok, os.path.join(model_dir, "tokenizer" + suffix))
    os.makedirs(os.path.join(model_dir, "scheduler"), exist_ok=True)
    with open(os.path.join(model_dir, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "LCMScheduler",
                   **dataclasses.asdict(bundle.scheduler_cfg)}, f, indent=1)
    return model_dir


# ---------------------------------------------------------------------------
# the single-file loader's inverse: SD1.5 in the LDM layout
# ---------------------------------------------------------------------------

_LDM_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
            "norm2": "out_layers.0", "conv2": "out_layers.3",
            "conv_shortcut": "skip_connection"}


def _ldm_unet_key(key: str, cfg: configs.UNetConfig) -> str:
    """A diffusers UNet name -> its ``model.diffusion_model.*`` name."""
    n = cfg.layers_per_block + 1  # LDM slots per level: the resnets, then the sampler

    def res(rest):
        stem, _, leaf = rest.partition(".")
        return f"{_LDM_RES[stem]}.{leaf}"

    fixed = (("time_embedding.cond_proj.", "time_embed.cond_proj."),
             ("time_embedding.linear_1.", "time_embed.0."),
             ("time_embedding.linear_2.", "time_embed.2."),
             ("add_embedding.linear_1.", "label_emb.0.0."),
             ("add_embedding.linear_2.", "label_emb.0.2."),
             ("conv_in.", "input_blocks.0.0."), ("conv_norm_out.", "out.0."),
             ("conv_out.", "out.2."))
    for diff, ldm in fixed:
        if key.startswith(diff):
            return ldm + key[len(diff):]
    m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)"
                 r"\.(\d+)\.(.+)", key)
    if m:
        side, block, kind, j, rest = m.group(1), int(m.group(2)), m.group(3), \
            int(m.group(4)), m.group(5)
        base = 1 + block * n if side == "down" else block * n
        if kind == "resnets":
            return f"{'input' if side == 'down' else 'output'}_blocks.{base + j}.0.{res(rest)}"
        if kind == "attentions":
            return f"{'input' if side == 'down' else 'output'}_blocks.{base + j}.1.{rest}"
        if kind == "downsamplers":  # "conv.*" -> "op.*"
            return f"input_blocks.{base + n - 1}.0.op.{rest[len('conv.'):]}"
        sub = 2 if cfg.transformer_layers_per_block[cfg.num_blocks - 1 - block] else 1
        return f"output_blocks.{base + n - 1}.{sub}.{rest}"
    m = re.match(r"mid_block\.(resnets|attentions)\.(\d+)\.(.+)", key)
    if m:
        kind, j, rest = m.group(1), int(m.group(2)), m.group(3)
        if kind == "attentions":
            return f"middle_block.1.{rest}"
        slot = 0 if j == 0 else 2 if cfg.has_mid_attention else 1
        return f"middle_block.{slot}.{res(rest)}"
    raise ValueError(f"no LDM name for UNet tensor {key!r}")


def _ldm_vae_key(key: str, n_blocks: int) -> str:
    """A diffusers AutoencoderKL name -> its LDM name (without the
    ``first_stage_model.`` prefix)."""
    m = re.match(r"decoder\.up_blocks\.(\d+)\.(.*)", key)
    if m:  # the up blocks run in reverse order between the layouts
        key = f"decoder.up.{n_blocks - 1 - int(m.group(1))}.{m.group(2)}"
    key = re.sub(r"^encoder\.down_blocks\.", "encoder.down.", key)
    key = re.sub(r"\.resnets\.", ".block.", key)
    for diff, ldm in (("upsamplers.0.conv", "upsample.conv"),
                      ("downsamplers.0.conv", "downsample.conv"),
                      ("conv_shortcut", "nin_shortcut"),
                      ("mid_block.block.0", "mid.block_1"), ("mid_block.block.1", "mid.block_2"),
                      ("mid_block.attentions.0", "mid.attn_1"),
                      ("attn_1.group_norm", "attn_1.norm"), ("attn_1.to_out.0", "attn_1.proj_out"),
                      ("attn_1.to_q", "attn_1.q"), ("attn_1.to_k", "attn_1.k"),
                      ("attn_1.to_v", "attn_1.v"), ("conv_norm_out", "norm_out")):
        key = key.replace(diff, ldm)
    return key


def write_single_file(bundle: PipelineBundle, path: str) -> str:
    """Save an SD1.5 ``bundle`` as one LDM-layout safetensors file, each
    tensor in its own dtype, with its tokenizer in ``<path stem>.tokenizer/``
    and its scheduler config in ``<path stem>.scheduler_config.json``;
    returns ``path``."""
    if bundle.arch != "sd15":
        raise ValueError(f"write_single_file writes SD1.5 bundles, got {bundle.arch!r}")
    out = {"model.diffusion_model." + _ldm_unet_key(k, bundle.unet_cfg): t
           for k, t in export_unet(bundle.unet_params).items()}
    n = len(bundle.vae_cfg.block_out_channels)
    out.update({"first_stage_model." + _ldm_vae_key(k, n): t
                for k, t in export_vae(bundle.vae_params, bundle.vae_encoder_params).items()})
    out.update({"cond_stage_model.transformer." + k: t
                for k, t in export_clip_text(bundle.text_params).items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(out, path, {"format": "pt"})
    stem = os.path.splitext(path)[0]
    _write_tokenizer(bundle.tokenizer, stem + ".tokenizer")
    with open(stem + ".scheduler_config.json", "w") as f:
        json.dump(dataclasses.asdict(bundle.scheduler_cfg), f, indent=1)
    return path


# ---------------------------------------------------------------------------
# super-resolution weights as an ONNX file
# ---------------------------------------------------------------------------


def random_espcn(cfg: configs.SuperResConfig = configs.SUPERRES, seed: int = 0, device=None):
    """Seeded ESPCN params (the JAX package's draw, ``superres.init_params``)."""
    return superres.init_params(cfg, np.random.RandomState(seed), device=device)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def _len_field(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _tensor_proto(name: str, arr: np.ndarray, float_data: bool) -> bytes:
    out = bytearray()
    for d in arr.shape:
        out += _varint(1 << 3) + _varint(d)  # dims, unpacked
    out += _varint(2 << 3) + _varint(1)  # data_type FLOAT
    flat = np.ascontiguousarray(arr, np.float32)
    if float_data:
        out += _len_field(4, struct.pack(f"<{flat.size}f", *flat.ravel()))
    else:
        out += _len_field(9, flat.tobytes())  # raw_data
    out += _len_field(8, name.encode())
    return bytes(out)


def _node_proto(op_type: str, inputs) -> bytes:
    return b"".join(_len_field(1, i.encode()) for i in inputs) + _len_field(4, op_type.encode())


def write_espcn_onnx(path: str, params, *, numeric_names: bool = False,
                     float_data: bool = False) -> str:
    """Save ESPCN params (``superres`` layout, OIHW) as an ONNX ModelProto:
    Conv, Relu x 3, Conv, DepthToSpace, the weights as OIHW initializers
    (``raw_data``, or ``float_data`` where asked; named ``conv{i}.weight``,
    or numbered as older torch exporters name them)."""
    graph, prev = bytearray(), "input"
    for i in (1, 2, 3, 4):
        wname = str(2 * i) if numeric_names else f"conv{i}.weight"
        bname = str(2 * i + 1) if numeric_names else f"conv{i}.bias"
        graph += _len_field(1, _node_proto("Conv", [prev, wname, bname]))
        prev = f"act{i}"
        if i < 4:
            graph += _len_field(1, _node_proto("Relu", [prev]))
        for name, leaf in ((wname, params[f"conv{i}"]["w"]), (bname, params[f"conv{i}"]["b"])):
            graph += _len_field(5, _tensor_proto(name, leaf.detach().cpu().numpy(), float_data))
    graph += _len_field(1, _node_proto("DepthToSpace", [prev]))
    with open(path, "wb") as f:
        f.write(_len_field(7, bytes(graph)))
    return str(path)


# ---------------------------------------------------------------------------
# modes.yaml
# ---------------------------------------------------------------------------


def _yaml_key(k) -> str:
    k = str(k)
    return k if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_-]*", k) else json.dumps(k)


def _yaml_lines(value, indent: int):
    pad = " " * indent
    if isinstance(value, dict) and value:
        for k, v in value.items():
            if isinstance(v, (dict, list)) and v:
                yield f"{pad}{_yaml_key(k)}:"
                yield from _yaml_lines(v, indent + 2)
            else:
                yield f"{pad}{_yaml_key(k)}: {_yaml_scalar(v)}"
    else:
        for v in value:
            if isinstance(v, (dict, list)) and v:
                inner = list(_yaml_lines(v, indent + 2))
                yield f"{pad}- {inner[0].lstrip()}"
                yield from inner[1:]
            else:
                yield f"{pad}- {_yaml_scalar(v)}"


def _yaml_scalar(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    if isinstance(v, bool):
        raise ValueError("modes.yaml takes no booleans")  # yaml_lite reads none
    return "null" if v is None else json.dumps(v)


def write_modes_yaml(path: str, modes: Dict[str, dict], *, default_mode: Optional[str] = None,
                     model_root: Optional[str] = None, lora_root: Optional[str] = None) -> str:
    """Write a ``modes.yaml`` (block mappings and sequences, JSON-quoted
    scalars: what both PyYAML and ``utils/yaml_lite.py`` read alike)."""
    top = {k: v for k, v in (("model_root", model_root), ("lora_root", lora_root),
                              ("default_mode", default_mode)) if v is not None}
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(_yaml_lines({**top, "modes": modes}, 0)) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# CLIP models (Yume's scorer) as HF CLIPModel directories
# ---------------------------------------------------------------------------


def clip_tokenizer(vocab_size: Optional[int] = None) -> CLIPTokenizer:
    """The test tokenizer over ``WORDS``; with ``vocab_size``, its vocabulary
    filled with unused tokens up to that size, BOS and EOS last, so that EOS
    is the vocabulary's last id as in CLIP's (the text tower pools there)."""
    tok = make_test_tokenizer(WORDS)
    if vocab_size is None:
        return tok
    specials = ("<|startoftext|>", "<|endoftext|>")
    vocab = {t: i for t, i in tok.encoder.items() if t not in specials}
    if vocab_size < len(vocab) + 2:
        raise ValueError(f"vocab_size {vocab_size} < the test vocabulary's {len(vocab) + 2}")
    for i in range(vocab_size - 2 - len(vocab)):
        vocab[f"<|unused{i}|>"] = len(vocab)
    for t in specials:
        vocab[t] = len(vocab)
    merges = [" ".join(m) for m in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)]
    return CLIPTokenizer(vocab, merges)


def random_clip(text_cfg: configs.CLIPTextConfig, vision_cfg: configs.CLIPVisionConfig, *,
                seed: int = 0, device="cpu"):
    """(text params, vision params) of a CLIP model, random fp32 weights drawn
    on ``device`` from a generator seeded with ``seed``: the text tower first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return clip_text.init_params(text_cfg, gen), clip_vision.init_params(vision_cfg, gen)


def export_clip_vision(params, pre_ln: str = "pre_layrnorm") -> Dict[str, torch.Tensor]:
    """The vision tower's HF state dict; ``pre_ln`` spells the pre-LayerNorm's
    key (HF's own ``pre_layrnorm``, or ``pre_layernorm``)."""
    out = _Out()
    pre = "vision_model."
    out[pre + "embeddings.patch_embedding.weight"] = params["patch_embedding"]["w"].contiguous()
    out[pre + "embeddings.class_embedding"] = params["class_embedding"]
    out[pre + "embeddings.position_embedding.weight"] = params["position_embedding"]["w"]
    out.norm(pre + pre_ln, params["pre_ln"])
    for i, layer in enumerate(params["layers"]):
        b = f"{pre}encoder.layers.{i}"
        out.norm(b + ".layer_norm1", layer["ln1"])
        for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                           ("out", "out_proj")):
            out.linear(f"{b}.self_attn.{proj}", layer["attn"][name])
        out.norm(b + ".layer_norm2", layer["ln2"])
        out.linear(b + ".mlp.fc1", layer["fc1"])
        out.linear(b + ".mlp.fc2", layer["fc2"])
    out.norm(pre + "post_layernorm", params["post_ln"])
    out.linear("visual_projection", params["visual_projection"])
    return out


def write_clip_dir(path: str, text_params, text_cfg: configs.CLIPTextConfig, vision_params,
                   vision_cfg: configs.CLIPVisionConfig, tokenizer: CLIPTokenizer, *,
                   tokenizer_subdir: bool = False, pre_ln: str = "pre_layrnorm") -> str:
    """Save a CLIP model as an HF ``CLIPModel`` directory: ``config.json``
    (``text_config``, ``vision_config``, ``projection_dim``), both towers and
    ``logit_scale`` in ``model.safetensors`` in the leaves' dtypes, and the
    tokenizer's files beside them or in ``tokenizer/``; returns ``path``."""
    if text_cfg.projection_dim != vision_cfg.projection_dim:
        raise ValueError("the towers' projection widths differ")
    os.makedirs(path, exist_ok=True)
    text_json = text_config_json(text_cfg)
    text_json.pop("architectures")
    vision_json = {"image_size": vision_cfg.image_size, "patch_size": vision_cfg.patch_size,
                   "hidden_size": vision_cfg.hidden_size,
                   "num_hidden_layers": vision_cfg.num_layers,
                   "num_attention_heads": vision_cfg.num_heads,
                   "intermediate_size": vision_cfg.intermediate_size,
                   "hidden_act": vision_cfg.hidden_act,
                   "layer_norm_eps": vision_cfg.layer_norm_eps}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "projection_dim": vision_cfg.projection_dim,
                   "text_config": text_json, "vision_config": vision_json}, f, indent=1)
    tensors = {**export_clip_text(text_params), **export_clip_vision(vision_params, pre_ln),
               "logit_scale": torch.tensor(2.6592, dtype=torch.float32)}
    save_file({k: v.detach().cpu().contiguous() for k, v in tensors.items()},
              os.path.join(path, "model.safetensors"), {"format": "pt"})
    _write_tokenizer(tokenizer, os.path.join(path, "tokenizer") if tokenizer_subdir else path)
    return path

