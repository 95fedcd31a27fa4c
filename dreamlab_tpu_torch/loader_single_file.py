"""Single-file checkpoints (the original "LDM" safetensors layout) -> a
PipelineBundle (port of ``dreamlab_tpu/loader_single_file.py``).

The LDM state dict's namespaces (``model.diffusion_model.*``,
``first_stage_model.*``, ``cond_stage_model.*`` / ``conditioner.*``) are
translated into the diffusers names the directory loader's converters read
(``loader.convert_unet``, ``convert_vae``, ``convert_clip_text``).
SD1.5-class files take the SD1.5 presets (with or without the LCM
``cond_proj``; SD2.x's OpenCLIP ViT-H tower and 64-dim heads where the
cross-attention width is 1024); SDXL base and refiner files have their
topology read from the tensors' shapes, as diffusers' ``from_single_file``
infers it.

Tensors come from the port's memory-mapped reader (``utils/safetensors.py``)
in the file's dtype and move to ``device``. The VAE encoder is read where
the file has one (img2img, inpainting), as the JAX package reads it.
Single files carry no tokenizer: it loads from
``<ckpt>.tokenizer/`` or a sibling ``tokenizer/`` directory (and
``tokenizer_2`` likewise), and a sidecar ``<ckpt>.scheduler_config.json`` or
sibling ``scheduler/`` gives the scheduler config.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Dict, Optional

import torch

from .loader import classify_arch, convert_clip_text, convert_unet, convert_vae
from .models.configs import (
    SD15_TEXT,
    SD15_UNET,
    SD15_VAE,
    SDXL_VAE,
    CLIPTextConfig,
    UNetConfig,
    VAEConfig,
)
from .pipeline import PipelineBundle, resolve_device
from .scheduler.lcm import LCMConfig, load_scheduler_config
from .utils.safetensors import load_file
from .utils.tokenizer import CLIPTokenizer

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."

# ---------------------------------------------------------------------------
# LDM -> diffusers UNet names
# ---------------------------------------------------------------------------

_RES_MAP = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}

# the LCM guidance projection: the name the JAX package's detection reads and
# the one diffusers' single-file converter reads
_COND_PROJ = ("time_embed.0.cond_proj.", "time_embed.cond_proj.")


def _map_unet_key(key: str, cfg: UNetConfig) -> Optional[str]:
    """One ``model.diffusion_model.*`` name (prefix stripped) -> its diffusers
    ``UNet2DConditionModel`` name, or None."""
    k = key
    layers = cfg.layers_per_block

    def map_res(rest: str) -> Optional[str]:
        for ldm, diff in _RES_MAP.items():
            if rest.startswith(ldm):
                return diff + rest[len(ldm):]
        return None

    for ldm in _COND_PROJ:
        if k.startswith(ldm):
            return "time_embedding.cond_proj." + k[len(ldm):]
    if k.startswith("time_embed.0."):
        return "time_embedding.linear_1." + k.split(".", 2)[2]
    if k.startswith("time_embed.2."):
        return "time_embedding.linear_2." + k.split(".", 2)[2]
    if k.startswith("label_emb.0.0."):
        return "add_embedding.linear_1." + k.split(".", 3)[3]
    if k.startswith("label_emb.0.2."):
        return "add_embedding.linear_2." + k.split(".", 3)[3]
    if k.startswith("input_blocks.0.0."):
        return "conv_in." + k.split(".", 3)[3]
    if k.startswith("out.0."):
        return "conv_norm_out." + k.split(".", 2)[2]
    if k.startswith("out.2."):
        return "conv_out." + k.split(".", 2)[2]

    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.+)", k)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        block, layer = (idx - 1) // (layers + 1), (idx - 1) % (layers + 1)
        if layer == layers:  # the downsampler's slot
            if rest.startswith("op."):
                return f"down_blocks.{block}.downsamplers.0.conv." + rest[len("op."):]
            return None
        if sub == 0:
            mapped = map_res(rest)
            return f"down_blocks.{block}.resnets.{layer}.{mapped}" if mapped else None
        return f"down_blocks.{block}.attentions.{layer}.{rest}"

    m = re.match(r"middle_block\.(\d+)\.(.+)", k)
    if m:
        sub, rest = int(m.group(1)), m.group(2)
        if sub == 0:
            mapped = map_res(rest)
            return f"mid_block.resnets.0.{mapped}" if mapped else None
        if sub == 1 and cfg.has_mid_attention:
            return f"mid_block.attentions.0.{rest}"
        mapped = map_res(rest)
        return f"mid_block.resnets.1.{mapped}" if mapped else None

    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.+)", k)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        block, layer = idx // (layers + 1), idx % (layers + 1)
        if sub == 0:
            mapped = map_res(rest)
            return f"up_blocks.{block}.resnets.{layer}.{mapped}" if mapped else None
        if rest.startswith("conv."):  # the upsampler
            return f"up_blocks.{block}.upsamplers.0.{rest}"
        return f"up_blocks.{block}.attentions.{layer}.{rest}"
    return None


def _translate_unet(tensors: Tensors, cfg: UNetConfig) -> Tensors:
    out: Tensors = {}
    unmapped = 0
    for key, t in tensors.items():
        if not key.startswith(UNET_PREFIX):
            continue
        mapped = _map_unet_key(key[len(UNET_PREFIX):], cfg)
        if mapped is None:
            unmapped += 1
            continue
        out[mapped] = t
    if unmapped:
        logger.warning("single-file unet: %d unmapped tensors", unmapped)
    return out


# ---------------------------------------------------------------------------
# VAE and text towers
# ---------------------------------------------------------------------------

# order matters: the attn_1 member renames run before the mid.attn_1
# container rename, so both fire on e.g. "mid.attn_1.q.weight"; the block ->
# resnets rename below is anchored to the up/down containers
_VAE_SEGMENTS = (
    ("nin_shortcut", "conv_shortcut"),
    ("attn_1.norm", "attn_1.group_norm"),
    ("attn_1.proj_out", "attn_1.to_out.0"),
    ("attn_1.q", "attn_1.to_q"),
    ("attn_1.k", "attn_1.to_k"),
    ("attn_1.v", "attn_1.to_v"),
    ("mid.block_1", "mid_block.resnets.0"),
    ("mid.attn_1", "mid_block.attentions.0"),
    ("mid.block_2", "mid_block.resnets.1"),
    ("norm_out", "conv_norm_out"),
)


def _translate_vae(tensors: Tensors, n_blocks: int) -> Tensors:
    """``first_stage_model.*`` -> diffusers ``AutoencoderKL`` names."""
    out: Tensors = {}
    for key, t in tensors.items():
        if not key.startswith(VAE_PREFIX):
            continue
        k = key[len(VAE_PREFIX):]
        m = re.match(r"decoder\.up\.(\d+)\.(.*)", k)
        if m:  # the up blocks run in reverse order between the layouts
            k = f"decoder.up_blocks.{n_blocks - 1 - int(m.group(1))}.{m.group(2)}"
        k = re.sub(r"encoder\.down\.(\d+)\.", r"encoder.down_blocks.\1.", k)
        k = k.replace("downsample.conv", "downsamplers.0.conv")
        k = k.replace("upsample.conv", "upsamplers.0.conv")
        for old, new in _VAE_SEGMENTS:
            k = k.replace(old, new)
        k = re.sub(r"(up_blocks|down_blocks)\.(\d+)\.block\.", r"\1.\2.resnets.", k)
        # the mid attention's projections are 1x1 convs in old VAEs
        if re.search(r"attentions\.0\.to_(q|k|v|out\.0)\.weight$", k) and t.ndim == 4:
            t = t[:, :, 0, 0].contiguous()
        out[k] = t
    return out


def _translate_text(tensors: Tensors) -> Tensors:
    """``cond_stage_model.transformer.*`` (SD1.x) or the SDXL ViT-L tower at
    ``conditioner.embedders.0.transformer.*`` -> transformers CLIPText names."""
    out: Tensors = {}
    for key, t in tensors.items():
        for prefix in ("cond_stage_model.transformer.", "conditioner.embedders.0.transformer."):
            if key.startswith(prefix):
                out[key[len(prefix):]] = t
                break
    return out


_OPENCLIP_RENAMES = {
    "ln_1": "layer_norm1",
    "ln_2": "layer_norm2",
    "attn.out_proj": "self_attn.out_proj",
    "mlp.c_fc": "mlp.fc1",
    "mlp.c_proj": "mlp.fc2",
}


def _translate_text_openclip(tensors: Tensors,
                             prefix: str = "conditioner.embedders.1.model.") -> Tensors:
    """An OpenCLIP tower (SDXL's bigG, SD2.x's ViT-H) -> transformers CLIPText
    names. OpenCLIP packs q/k/v into one ``attn.in_proj_weight`` [3C, C] (and
    ``in_proj_bias`` [3C]) per block, split here; ``text_projection`` is a raw
    [C, proj] matrix applied as ``pooled @ proj``, transposed here into a
    linear's [proj, C]."""
    out: Tensors = {}
    for key, t in tensors.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = t
        elif k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = t
        elif k in ("ln_final.weight", "ln_final.bias"):
            out["text_model.final_layer_norm." + k.split(".")[1]] = t
        elif k == "text_projection":
            out["text_projection.weight"] = t.t().contiguous()
        elif k == "text_projection.weight":  # some exports keep the linear form
            out["text_projection.weight"] = t
        else:
            m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", k)
            if not m:
                continue  # logit_scale and the like
            base, rest = f"text_model.encoder.layers.{m.group(1)}.", m.group(2)
            if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
                leaf = "weight" if rest.endswith("weight") else "bias"
                for name, part in zip(("q_proj", "k_proj", "v_proj"), t.chunk(3, dim=0)):
                    out[base + f"self_attn.{name}.{leaf}"] = part
            else:
                stem, _, leaf = rest.rpartition(".")
                if stem in _OPENCLIP_RENAMES:
                    out[base + _OPENCLIP_RENAMES[stem] + "." + leaf] = t
    return out


# ---------------------------------------------------------------------------
# configs from shapes (SDXL) and the text towers
# ---------------------------------------------------------------------------


def _derive_unet_cfg_sdxl(t: Tensors, cad: int, pooled_dim: Optional[int]) -> UNetConfig:
    """The UNet's topology from its LDM tensors: block widths, resnet and
    transformer counts, micro-conditioning dims. Head counts are not stored:
    SDXL's 64-dim heads. Nor is the micro-conditioning id count: 6 for base
    models, 5 for refiners, told apart by the divisibility of
    (projection input - pooled_dim)."""
    pre = UNET_PREFIX
    chan0 = t[pre + "input_blocks.0.0.weight"].shape[0]
    temb = t[pre + "time_embed.0.weight"].shape[0]

    block_out, tls = [], []
    layers_per_block = 1
    stage_channels, stage_layers, stage_tl = chan0, 0, 0
    idx = 1
    while True:
        res_key = f"{pre}input_blocks.{idx}.0.in_layers.2.weight"
        if res_key in t:
            stage_channels = t[res_key].shape[0]
            stage_layers += 1
            n_tf = 0
            while (f"{pre}input_blocks.{idx}.1.transformer_blocks.{n_tf}.attn1.to_q.weight"
                   in t):
                n_tf += 1
            stage_tl = max(stage_tl, n_tf)
            idx += 1
        elif f"{pre}input_blocks.{idx}.0.op.weight" in t:
            block_out.append(stage_channels)
            tls.append(stage_tl)
            layers_per_block = stage_layers
            stage_layers, stage_tl = 0, 0
            idx += 1
        else:
            break
    if stage_layers:
        block_out.append(stage_channels)
        tls.append(stage_tl)
        layers_per_block = stage_layers

    mid_tf = 0
    while f"{pre}middle_block.1.transformer_blocks.{mid_tf}.attn1.to_q.weight" in t:
        mid_tf += 1

    time_cond = next((t[pre + name + "weight"].shape[1] for name in _COND_PROJ
                      if pre + name + "weight" in t), None)
    label_key = pre + "label_emb.0.0.weight"
    pcei = add_dim = addition = None
    if label_key in t:
        addition = "text_time"
        pcei = t[label_key].shape[1]
        if pooled_dim:
            for n_ids in (6, 5):
                if (pcei - pooled_dim) % n_ids == 0:
                    add_dim = (pcei - pooled_dim) // n_ids
                    break

    return UNetConfig(
        in_channels=t[pre + "input_blocks.0.0.weight"].shape[1],
        out_channels=t[pre + "out.2.weight"].shape[0],
        block_out_channels=tuple(block_out),
        layers_per_block=layers_per_block,
        transformer_layers_per_block=tuple(tls),
        num_attention_heads=tuple(max(1, c // 64) for c in block_out),
        cross_attention_dim=cad,
        norm_groups=32,
        time_embed_dim_mult=temb // chan0,
        time_cond_proj_dim=time_cond,
        addition_embed_type=addition,
        addition_time_embed_dim=add_dim,
        projection_class_embeddings_input_dim=pcei,
        mid_block_transformer_layers=mid_tf,
    )


def _text_layers(text_t: Tensors) -> int:
    return 1 + max(int(m.group(1)) for k in text_t
                   if (m := re.match(r"text_model\.encoder\.layers\.(\d+)\.", k)))


def _derive_text_cfg(text_t: Tensors, *, act: str, penultimate: bool,
                     head_dim: int = 64) -> CLIPTextConfig:
    emb = text_t["text_model.embeddings.token_embedding.weight"]
    hidden = emb.shape[1]
    proj = text_t["text_projection.weight"].shape[0] if "text_projection.weight" in text_t \
        else None
    return CLIPTextConfig(
        vocab_size=emb.shape[0],
        hidden_size=hidden,
        num_layers=_text_layers(text_t),
        num_heads=max(1, hidden // head_dim),
        intermediate_size=text_t["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        hidden_act=act,
        penultimate=penultimate,
        projection_dim=proj,
    )


def _vae_sdxl(tensors: Tensors, device) -> tuple:
    """The VAE's topology from its tensor names, SDXL's scaling factor, and
    its decoder and encoder trees."""
    dec = VAE_PREFIX + "decoder.up."
    n_up = 1 + max(int(m.group(1)) for k in tensors
                   if (m := re.match(re.escape(dec) + r"(\d+)\.", k)))
    n_res = 1 + max(int(m.group(1)) for k in tensors
                    if (m := re.match(re.escape(dec) + r"0\.block\.(\d+)\.", k)))
    # LDM decoder.up.{i} is diffusers up_blocks.{n-1-i}, whose width is the
    # reversed list: read in LDM order, the widths come out ascending
    widths = tuple(tensors[f"{dec}{i}.block.0.conv2.weight"].shape[0] for i in range(n_up))
    vae_cfg = VAEConfig(
        latent_channels=tensors[VAE_PREFIX + "decoder.conv_in.weight"].shape[1],
        block_out_channels=widths,
        layers_per_block=n_res - 1,
        norm_groups=32,
        scaling_factor=SDXL_VAE.scaling_factor,
    )
    return (vae_cfg, *convert_vae(_translate_vae(tensors, n_up), vae_cfg, device=device))


# ---------------------------------------------------------------------------
# sidecars: tokenizer and scheduler
# ---------------------------------------------------------------------------


def _load_sidecar_scheduler(ckpt_path: str) -> LCMConfig:
    """``<ckpt>.scheduler_config.json``, else a sibling
    ``scheduler/scheduler_config.json``, else the defaults (epsilon). This is
    how a v-prediction SD2.1-768 file declares itself."""
    sidecar = os.path.splitext(ckpt_path)[0] + ".scheduler_config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(LCMConfig)}
        logger.info("single-file scheduler config from %s", sidecar)
        return LCMConfig(**{k: v for k, v in raw.items() if k in known})
    folder = os.path.dirname(ckpt_path)
    if os.path.exists(os.path.join(folder, "scheduler", "scheduler_config.json")):
        logger.info("single-file scheduler config from %s/scheduler", folder)
        return load_scheduler_config(folder)
    return LCMConfig()


def _find_tokenizer_dir(ckpt_path: str, which: str = "tokenizer") -> Optional[str]:
    base = os.path.splitext(ckpt_path)[0]
    for cand in (f"{base}.{which}", os.path.join(os.path.dirname(ckpt_path), which)):
        if os.path.isdir(cand):
            return cand
    if which == "tokenizer":
        raise FileNotFoundError(
            f"single-file checkpoints carry no tokenizer; place vocab.json/merges.txt in "
            f"{base}.tokenizer/ or a sibling tokenizer/ directory")
    return None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _load_single_file_sdxl_refiner(path: str, tensors: Tensors, cad: int,
                                   device) -> PipelineBundle:
    """SDXL refiner: ONE OpenCLIP bigG tower at ``conditioner.embedders.0.model``
    (no ViT-L), which gives both the context and the pooled embedding, and 5
    micro-conditioning ids (the aesthetic score)."""
    big_t = _translate_text_openclip(tensors, prefix="conditioner.embedders.0.model.")
    if not big_t:
        raise ValueError(f"{path}: no text tower (conditioner.embedders.0) found")
    text_cfg = _derive_text_cfg(big_t, act="gelu", penultimate=True)
    pooled_dim = text_cfg.projection_dim or text_cfg.hidden_size
    unet_cfg = _derive_unet_cfg_sdxl(tensors, cad, pooled_dim)
    unet_params = convert_unet(_translate_unet(tensors, unet_cfg), unet_cfg, device=device)
    vae_cfg, vae_params, vae_encoder_params = _vae_sdxl(tensors, device)
    # the bigG tower's tokenizer pads with "!" (id 0), not EOS
    tok_dir = _find_tokenizer_dir(path, "tokenizer_2") or _find_tokenizer_dir(path)
    return PipelineBundle(
        arch="sdxl",
        tokenizer=CLIPTokenizer.from_pretrained(tok_dir, pad_token="!"),
        text_cfg=text_cfg,
        text_params=convert_clip_text(big_t, text_cfg, device=device),
        unet_cfg=unet_cfg,
        unet_params=unet_params,
        vae_cfg=vae_cfg,
        vae_params=vae_params,
        scheduler_cfg=_load_sidecar_scheduler(path),
        model_dir=path,
        vae_encoder_params=vae_encoder_params,
    )


def _load_single_file_sdxl(path: str, tensors: Tensors, cad: int, device) -> PipelineBundle:
    """SDXL base: two text towers (ViT-L, and OpenCLIP bigG with packed q/k/v),
    the micro-conditioning UNet, the 0.13025-scaled VAE."""
    text1_t = _translate_text(tensors)
    if not text1_t:
        # refiner checkpoints keep their one bigG tower at embedders.0
        return _load_single_file_sdxl_refiner(path, tensors, cad, device)
    text2_t = _translate_text_openclip(tensors)
    if not text2_t:
        raise ValueError(f"{path}: no second text tower (conditioner.embedders.1.model)")
    text_cfg = _derive_text_cfg(text1_t, act="quick_gelu", penultimate=True)
    text_cfg_2 = _derive_text_cfg(text2_t, act="gelu", penultimate=True)
    unet_cfg = _derive_unet_cfg_sdxl(tensors, cad, text_cfg_2.hidden_size)
    unet_params = convert_unet(_translate_unet(tensors, unet_cfg), unet_cfg, device=device)
    vae_cfg, vae_params, vae_encoder_params = _vae_sdxl(tensors, device)
    tok_dir = _find_tokenizer_dir(path)
    tok2_dir = _find_tokenizer_dir(path, "tokenizer_2")
    # the same BPE vocabulary; OpenCLIP pads with "!" (id 0), not EOS
    tokenizer_2 = (CLIPTokenizer.from_pretrained(tok2_dir) if tok2_dir is not None
                   else CLIPTokenizer.from_pretrained(tok_dir, pad_token="!"))
    return PipelineBundle(
        arch="sdxl",
        tokenizer=CLIPTokenizer.from_pretrained(tok_dir),
        text_cfg=text_cfg,
        text_params=convert_clip_text(text1_t, text_cfg, device=device),
        unet_cfg=unet_cfg,
        unet_params=unet_params,
        vae_cfg=vae_cfg,
        vae_params=vae_params,
        scheduler_cfg=_load_sidecar_scheduler(path),
        tokenizer_2=tokenizer_2,
        text_cfg_2=text_cfg_2,
        text_params_2=convert_clip_text(text2_t, text_cfg_2, device=device),
        model_dir=path,
        vae_encoder_params=vae_encoder_params,
    )


def load_single_file(path: str, *, device=None) -> PipelineBundle:
    """Load an LDM-layout ``.safetensors`` checkpoint into a PipelineBundle
    whose tensors lie on ``device`` (None = the CUDA device) in the file's
    dtype. SD1.5 (with or without the LCM ``cond_proj``), SD2.x, SDXL base
    and SDXL refiner files."""
    dev = resolve_device(device)
    tensors = load_file(path)
    cad = next((t.shape[1] for k, t in tensors.items()
                if k.endswith("attn2.to_k.weight") and t.ndim == 2), None)
    if cad is None:
        raise ValueError(f"not a diffusion checkpoint (no attn2.to_k): {path}")
    arch = classify_arch(cad)
    if arch == "sdxl":
        return _load_single_file_sdxl(path, tensors, cad, dev)

    has_cond_proj = any(UNET_PREFIX + name in k for k in tensors for name in _COND_PROJ)
    unet_cfg = SD15_UNET if has_cond_proj else dataclasses.replace(
        SD15_UNET, time_cond_proj_dim=None)
    if cad == 1024:  # SD2.x: 64-dim attention heads, not SD1.5's 8 per block
        unet_cfg = dataclasses.replace(
            unet_cfg, cross_attention_dim=1024,
            num_attention_heads=tuple(max(1, c // 64) for c in unet_cfg.block_out_channels))
    unet_params = convert_unet(_translate_unet(tensors, unet_cfg), unet_cfg, device=dev)
    vae_cfg = SD15_VAE
    vae_params, vae_encoder_params = convert_vae(
        _translate_vae(tensors, len(vae_cfg.block_out_channels)), vae_cfg, device=dev)

    text_t = _translate_text(tensors)
    penultimate, penultimate_ln, act, openclip = False, False, "quick_gelu", False
    if not text_t and any(k.startswith("cond_stage_model.model.") for k in tensors):
        # SD2.x: an OpenCLIP ViT-H tower (fused in_proj, gelu), conditioning
        # on the final-layer-normed penultimate state (diffusers serves a
        # truncated 23-layer tower ending in final_layer_norm)
        text_t = _translate_text_openclip(tensors, prefix="cond_stage_model.model.")
        penultimate, penultimate_ln, act, openclip = True, True, "gelu", True
    if not text_t:
        raise ValueError(f"{path}: no text tower (cond_stage_model) found")
    hidden = text_t["text_model.embeddings.token_embedding.weight"].shape[1]
    text_cfg = dataclasses.replace(
        SD15_TEXT, hidden_size=hidden, num_layers=_text_layers(text_t),
        num_heads=hidden // 64,
        intermediate_size=text_t["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        hidden_act=act, penultimate=penultimate, penultimate_ln=penultimate_ln)
    tok_kwargs = {"pad_token": "!"} if openclip else {}
    return PipelineBundle(
        arch=arch,
        tokenizer=CLIPTokenizer.from_pretrained(_find_tokenizer_dir(path), **tok_kwargs),
        text_cfg=text_cfg,
        text_params=convert_clip_text(text_t, text_cfg, device=dev),
        unet_cfg=unet_cfg,
        unet_params=unet_params,
        vae_cfg=vae_cfg,
        vae_params=vae_params,
        scheduler_cfg=_load_sidecar_scheduler(path),
        model_dir=path,
        vae_encoder_params=vae_encoder_params,
    )
