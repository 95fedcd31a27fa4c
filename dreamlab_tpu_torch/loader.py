"""Checkpoint loading: diffusers-layout directories -> the port's parameter trees
(port of ``dreamlab_tpu/loader.py``).

A diffusers directory holds ``unet/``, ``vae/`` (or ``vae_decoder/``),
``text_encoder/`` + ``tokenizer/``, for SDXL also ``text_encoder_2/`` +
``tokenizer_2/`` (a refiner has only those two), and
``scheduler/scheduler_config.json``, each with a ``config.json`` and a
safetensors file read by ``utils/safetensors.py``. The checkpoint is
classified as SD1.5 or SDXL by the UNet's ``cross_attention_dim``.

The port keeps torch's own layouts (conv OIHW, linear ``[out, in]``), so the
weights load as stored: norms become ``{"scale", "bias"}``, and the 1x1-conv
``proj_in``/``proj_out`` of SD1.5 checkpoints become linears. Tensors keep
the file's dtype (the pipeline casts them) and are moved to ``device``.
A single file (LDM layout) goes to ``loader_single_file.py``.

``load_clip_model`` reads an HF ``CLIPModel`` directory (both towers in one
file, the tokenizer beside it or in ``tokenizer/``) into Yume's native CLIP
scorer.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from .models import controlnet
from .models.configs import CLIPTextConfig, CLIPVisionConfig, UNetConfig, VAEConfig
from .pipeline import PipelineBundle, resolve_device
from .scheduler.lcm import LCMConfig, load_scheduler_config
from .utils.safetensors import load_file
from .utils.tokenizer import CLIPTokenizer

logger = logging.getLogger(__name__)


def find_weights_file(component_dir: str) -> Optional[str]:
    for name in (
        "diffusion_pytorch_model.safetensors",
        "model.safetensors",
        "diffusion_pytorch_model.fp16.safetensors",
        "model.fp16.safetensors",
    ):
        p = os.path.join(component_dir, name)
        if os.path.exists(p):
            return p
    return None


def _load_weights(component_dir: str) -> Dict[str, torch.Tensor]:
    path = find_weights_file(component_dir)
    if path is None:
        raise FileNotFoundError(f"no safetensors weights in {component_dir}")
    return load_file(path)


class _W:
    """Key-mapped view over a flat torch state dict that records the tensors
    it hands out, so the unconverted ones can be reported."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device: torch.device):
        self.t = tensors
        self.device = device
        self.used: set = set()

    def has(self, key: str) -> bool:
        return key in self.t

    def raw(self, key: str) -> torch.Tensor:
        self.used.add(key)
        return self.t[key].to(self.device)

    def _weight_bias(self, key: str, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"w": w}
        if self.has(key + ".bias"):
            out["b"] = self.raw(key + ".bias")
        return out

    def conv(self, key: str) -> Dict[str, torch.Tensor]:
        return self._weight_bias(key, self.raw(key + ".weight"))

    def linear(self, key: str) -> Dict[str, torch.Tensor]:
        w = self.raw(key + ".weight")
        if w.ndim == 4:  # a 1x1 conv stored where a linear is meant
            w = w[:, :, 0, 0].contiguous()
        return self._weight_bias(key, w)

    def norm(self, key: str) -> Dict[str, torch.Tensor]:
        return {"scale": self.raw(key + ".weight"), "bias": self.raw(key + ".bias")}

    def embedding(self, key: str) -> Dict[str, torch.Tensor]:
        return {"w": self.raw(key + ".weight")}

    def warn_unused(self, what: str) -> None:
        unused = set(self.t) - self.used
        if unused:
            logger.warning("%s: %d unconverted tensors (e.g. %s)",
                           what, len(unused), sorted(unused)[:3])


# ---------------------------------------------------------------------------
# configs from json
# ---------------------------------------------------------------------------


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def unet_config_from_json(raw: Dict[str, Any]) -> UNetConfig:
    chans = tuple(raw["block_out_channels"])
    n = len(chans)
    down_types = raw.get("down_block_types", ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"])
    tl_raw = raw.get("transformer_layers_per_block", 1)
    tl_list = [tl_raw] * n if isinstance(tl_raw, int) else list(tl_raw)
    tl = tuple(tl_list[i] if "CrossAttn" in down_types[i] else 0 for i in range(n))
    # diffusers quirk: SD1.x stores the head *count* under attention_head_dim
    heads_raw = raw.get("num_attention_heads") or raw.get("attention_head_dim", 8)
    heads = tuple([heads_raw] * n if isinstance(heads_raw, int) else heads_raw)
    mid_type = raw.get("mid_block_type", "UNetMidBlock2DCrossAttn")
    mid_tl = tl_list[-1] if "CrossAttn" in (mid_type or "") else 0
    return UNetConfig(
        in_channels=raw.get("in_channels", 4),
        out_channels=raw.get("out_channels", 4),
        block_out_channels=chans,
        layers_per_block=raw.get("layers_per_block", 2),
        transformer_layers_per_block=tl,
        num_attention_heads=heads,
        cross_attention_dim=raw.get("cross_attention_dim", 768),
        norm_groups=raw.get("norm_num_groups", 32),
        time_cond_proj_dim=raw.get("time_cond_proj_dim"),
        addition_embed_type=raw.get("addition_embed_type"),
        addition_time_embed_dim=raw.get("addition_time_embed_dim"),
        projection_class_embeddings_input_dim=raw.get("projection_class_embeddings_input_dim"),
        mid_block_transformer_layers=mid_tl,
        flip_sin_to_cos=raw.get("flip_sin_to_cos", True),
        freq_shift=raw.get("freq_shift", 0),
    )


def vae_config_from_json(raw: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        latent_channels=raw.get("latent_channels", 4),
        out_channels=raw.get("out_channels", 3),
        block_out_channels=tuple(raw.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=raw.get("layers_per_block", 2),
        norm_groups=raw.get("norm_num_groups", 32),
        scaling_factor=raw.get("scaling_factor", 0.18215),
        mid_attention=True,
    )


def text_config_from_json(raw: Dict[str, Any], *, penultimate: bool = False) -> CLIPTextConfig:
    arch = (raw.get("architectures") or [""])[0]
    return CLIPTextConfig(
        vocab_size=raw.get("vocab_size", 49408),
        hidden_size=raw.get("hidden_size", 768),
        num_layers=raw.get("num_hidden_layers", 12),
        num_heads=raw.get("num_attention_heads", 12),
        max_position_embeddings=raw.get("max_position_embeddings", 77),
        intermediate_size=raw.get("intermediate_size", 3072),
        hidden_act=raw.get("hidden_act", "quick_gelu"),
        layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
        penultimate=penultimate,
        projection_dim=(raw.get("projection_dim")
                        if ("WithProjection" in arch or arch == "CLIPModel") else None),
    )


# ---------------------------------------------------------------------------
# component converters
# ---------------------------------------------------------------------------


def _unet_attn(w: _W, key: str) -> Dict:
    return {"q": w.linear(key + ".to_q"), "k": w.linear(key + ".to_k"),
            "v": w.linear(key + ".to_v"), "out": w.linear(key + ".to_out.0")}


def _unet_transformer(w: _W, key: str, n_layers: int) -> Dict:
    blocks = []
    for k in range(n_layers):
        b = f"{key}.transformer_blocks.{k}"
        blocks.append({
            "ln1": w.norm(b + ".norm1"),
            "attn1": _unet_attn(w, b + ".attn1"),
            "ln2": w.norm(b + ".norm2"),
            "attn2": _unet_attn(w, b + ".attn2"),
            "ln3": w.norm(b + ".norm3"),
            "ff_geglu": w.linear(b + ".ff.net.0.proj"),
            "ff_out": w.linear(b + ".ff.net.2"),
        })
    return {"norm": w.norm(key + ".norm"), "proj_in": w.linear(key + ".proj_in"),
            "blocks": blocks, "proj_out": w.linear(key + ".proj_out")}


def _resnet(w: _W, key: str, *, temb: bool) -> Dict:
    p = {"norm1": w.norm(key + ".norm1"), "conv1": w.conv(key + ".conv1")}
    if temb:
        p["time_emb_proj"] = w.linear(key + ".time_emb_proj")
    p.update(norm2=w.norm(key + ".norm2"), conv2=w.conv(key + ".conv2"))
    if w.has(key + ".conv_shortcut.weight"):
        p["shortcut"] = w.conv(key + ".conv_shortcut")
    return p


def _convert_unet_trunk(w: _W, cfg: UNetConfig) -> Dict:
    """The UNet's conv_in, embeddings, down and mid stack: the whole of a
    ControlNet's trunk, and the first part of a UNet."""
    params: Dict[str, Any] = {
        "conv_in": w.conv("conv_in"),
        "time_embedding": {"linear_1": w.linear("time_embedding.linear_1"),
                           "linear_2": w.linear("time_embedding.linear_2")},
    }
    if cfg.time_cond_proj_dim is not None and w.has("time_embedding.cond_proj.weight"):
        params["time_embedding"]["cond_proj"] = w.linear("time_embedding.cond_proj")
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {"linear_1": w.linear("add_embedding.linear_1"),
                                   "linear_2": w.linear("add_embedding.linear_2")}

    down: List[Dict] = []
    for i in range(cfg.num_blocks):
        tl = cfg.transformer_layers_per_block[i]
        block: Dict[str, Any] = {"resnets": []}
        if tl > 0:
            block["attentions"] = []
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_resnet(w, f"down_blocks.{i}.resnets.{j}", temb=True))
            if tl > 0:
                block["attentions"].append(
                    _unet_transformer(w, f"down_blocks.{i}.attentions.{j}", tl))
        if i < cfg.num_blocks - 1:
            block["downsample"] = w.conv(f"down_blocks.{i}.downsamplers.0.conv")
        down.append(block)
    params["down"] = down

    mid: Dict[str, Any] = {"resnet1": _resnet(w, "mid_block.resnets.0", temb=True),
                           "resnet2": _resnet(w, "mid_block.resnets.1", temb=True)}
    if cfg.has_mid_attention:
        mid["attention"] = _unet_transformer(w, "mid_block.attentions.0",
                                             cfg.mid_block_transformer_layers)
    params["mid"] = mid
    return params


def convert_unet(tensors: Dict[str, torch.Tensor], cfg: UNetConfig, *,
                 device="cpu") -> Dict:
    """A diffusers ``UNet2DConditionModel`` state dict -> ``models/unet.py``'s tree."""
    w = _W(tensors, torch.device(device))
    params = _convert_unet_trunk(w, cfg)
    up: List[Dict] = []
    for k in range(cfg.num_blocks):
        tl = cfg.transformer_layers_per_block[cfg.num_blocks - 1 - k]
        block = {"resnets": []}
        if tl > 0:
            block["attentions"] = []
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_resnet(w, f"up_blocks.{k}.resnets.{j}", temb=True))
            if tl > 0:
                block["attentions"].append(
                    _unet_transformer(w, f"up_blocks.{k}.attentions.{j}", tl))
        if k < cfg.num_blocks - 1:
            block["upsample"] = w.conv(f"up_blocks.{k}.upsamplers.0.conv")
        up.append(block)
    params["up"] = up

    params["norm_out"] = w.norm("conv_norm_out")
    params["conv_out"] = w.conv("conv_out")
    w.warn_unused("unet")
    return params


def convert_controlnet(tensors: Dict[str, torch.Tensor], cfg: UNetConfig, *,
                       device="cpu") -> Dict:
    """A diffusers ``ControlNetModel`` state dict -> ``models/controlnet.py``'s
    tree: the UNet trunk, the hint ladder (``controlnet_cond_embedding.*``)
    and the zero-conv taps (``controlnet_down_blocks.{i}``,
    ``controlnet_mid_block``)."""
    w = _W(tensors, torch.device(device))
    params = _convert_unet_trunk(w, cfg)

    def numbered(prefix):
        out, i = [], 0
        while w.has(f"{prefix}.{i}.weight"):
            out.append(w.conv(f"{prefix}.{i}"))
            i += 1
        return out

    params["cond_embedding"] = {
        "conv_in": w.conv("controlnet_cond_embedding.conv_in"),
        "blocks": numbered("controlnet_cond_embedding.blocks"),
        "conv_out": w.conv("controlnet_cond_embedding.conv_out"),
    }
    params["zero_down"] = numbered("controlnet_down_blocks")
    params["zero_mid"] = w.conv("controlnet_mid_block")
    w.warn_unused("controlnet")
    return params


def load_controlnet(model_dir: str, *, device=None) -> Tuple[Dict, UNetConfig]:
    """A diffusers-layout ControlNet directory (``config.json`` and its
    safetensors file) -> (params, cfg) for ``LCMPipeline.set_controlnet``,
    tensors on ``device`` (None = the CUDA device) in the file's dtype.
    Raises if the taps do not match the trunk's skip connections."""
    dev = resolve_device(device)
    cfg = unet_config_from_json(_read_json(os.path.join(model_dir, "config.json")))
    params = convert_controlnet(_load_weights(model_dir), cfg, device=dev)
    n_skips = controlnet.skip_count(cfg)
    if len(params["zero_down"]) != n_skips:
        raise ValueError(f"controlnet has {len(params['zero_down'])} down taps; the UNet "
                         f"trunk produces {n_skips} skips: incompatible architecture")
    return params, cfg


def _vae_mid(w: _W, prefix: str) -> Dict:
    """A VAE mid block (decoder or encoder) at ``prefix``."""
    a = prefix + ".attentions.0"
    # new diffusers naming (to_q, ...) or the legacy one (query, ...)
    names = ({"q": ".to_q", "k": ".to_k", "v": ".to_v", "out": ".to_out.0"}
             if w.has(a + ".to_q.weight")
             else {"q": ".query", "k": ".key", "v": ".value", "out": ".proj_attn"})
    gn = ".group_norm" if w.has(a + ".group_norm.weight") else ".norm"
    return {"resnet1": _resnet(w, prefix + ".resnets.0", temb=False),
            "resnet2": _resnet(w, prefix + ".resnets.1", temb=False),
            "attention": {"norm": w.norm(a + gn),
                          **{k: w.linear(a + v) for k, v in names.items()}}}


def _vae_decoder(w: _W, cfg: VAEConfig) -> Dict:
    params: Dict[str, Any] = {"conv_in": w.conv("decoder.conv_in"),
                              "mid": _vae_mid(w, "decoder.mid_block")}
    if w.has("post_quant_conv.weight"):
        params["post_quant_conv"] = w.conv("post_quant_conv")
    n = len(cfg.block_out_channels)
    up = []
    for k in range(n):
        block = {"resnets": [_resnet(w, f"decoder.up_blocks.{k}.resnets.{j}", temb=False)
                             for j in range(cfg.layers_per_block + 1)]}
        if k < n - 1:
            block["upsample"] = w.conv(f"decoder.up_blocks.{k}.upsamplers.0.conv")
        up.append(block)
    params["up"] = up
    params["norm_out"] = w.norm("decoder.conv_norm_out")
    params["conv_out"] = w.conv("decoder.conv_out")
    return params


def _vae_encoder(w: _W, cfg: VAEConfig) -> Dict:
    params: Dict[str, Any] = {"conv_in": w.conv("encoder.conv_in")}
    n = len(cfg.block_out_channels)
    down = []
    for i in range(n):
        block = {"resnets": [_resnet(w, f"encoder.down_blocks.{i}.resnets.{j}", temb=False)
                             for j in range(cfg.layers_per_block)]}
        if i < n - 1:
            block["downsample"] = w.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv")
        down.append(block)
    params["down"] = down
    params["mid"] = _vae_mid(w, "encoder.mid_block")
    params["norm_out"] = w.norm("encoder.conv_norm_out")
    params["conv_out"] = w.conv("encoder.conv_out")
    if w.has("quant_conv.weight"):
        params["quant_conv"] = w.conv("quant_conv")
    return params


def convert_vae(tensors: Dict[str, torch.Tensor], cfg: VAEConfig, *, device="cpu",
                encoder: bool = True) -> Tuple[Dict, Optional[Dict]]:
    """An ``AutoencoderKL`` state dict -> (``models/vae.py``'s decoder tree,
    its encoder tree). The encoder is None when ``encoder`` is False or the
    file has no ``encoder.*`` tensors; unread tensors are reported."""
    w = _W(tensors, torch.device(device))
    dec = _vae_decoder(w, cfg)
    enc = (_vae_encoder(w, cfg) if encoder and any(k.startswith("encoder.") for k in tensors)
           else None)
    w.warn_unused("vae" if encoder else "vae (the encoder is read with load_vae_encoder=True)")
    return dec, enc


def convert_clip_text(tensors: Dict[str, torch.Tensor], cfg: CLIPTextConfig, *,
                      device="cpu") -> Dict:
    """A transformers ``CLIPTextModel[WithProjection]`` state dict ->
    ``models/clip_text.py``'s tree."""
    w = _W(tensors, torch.device(device))
    pre = "text_model."
    layers = []
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}"
        layers.append({
            "ln1": w.norm(b + ".layer_norm1"),
            "attn": {"q": w.linear(b + ".self_attn.q_proj"),
                     "k": w.linear(b + ".self_attn.k_proj"),
                     "v": w.linear(b + ".self_attn.v_proj"),
                     "out": w.linear(b + ".self_attn.out_proj")},
            "ln2": w.norm(b + ".layer_norm2"),
            "fc1": w.linear(b + ".mlp.fc1"),
            "fc2": w.linear(b + ".mlp.fc2"),
        })
    params = {
        "token_embedding": w.embedding(pre + "embeddings.token_embedding"),
        "position_embedding": w.embedding(pre + "embeddings.position_embedding"),
        "layers": layers,
        "final_ln": w.norm(pre + "final_layer_norm"),
    }
    if cfg.projection_dim is not None and w.has("text_projection.weight"):
        params["text_projection"] = w.linear("text_projection")
    w.warn_unused("text encoder")
    return params


def convert_clip_vision(tensors: Dict[str, torch.Tensor], cfg: CLIPVisionConfig, *,
                        device="cpu") -> Dict:
    """A transformers ``CLIPVisionModel[WithProjection]`` (or ``CLIPModel``)
    state dict -> ``models/clip_vision.py``'s tree. Takes both the
    ``pre_layrnorm`` (HF's historical spelling) and ``pre_layernorm`` keys."""
    w = _W(tensors, torch.device(device))
    pre = "vision_model."
    layers = []
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}"
        layers.append({
            "ln1": w.norm(b + ".layer_norm1"),
            "attn": {"q": w.linear(b + ".self_attn.q_proj"),
                     "k": w.linear(b + ".self_attn.k_proj"),
                     "v": w.linear(b + ".self_attn.v_proj"),
                     "out": w.linear(b + ".self_attn.out_proj")},
            "ln2": w.norm(b + ".layer_norm2"),
            "fc1": w.linear(b + ".mlp.fc1"),
            "fc2": w.linear(b + ".mlp.fc2"),
        })
    pre_ln = pre + ("pre_layrnorm" if w.has(pre + "pre_layrnorm.weight") else "pre_layernorm")
    params = {
        "patch_embedding": {"w": w.raw(pre + "embeddings.patch_embedding.weight")},
        "class_embedding": w.raw(pre + "embeddings.class_embedding"),
        "position_embedding": w.embedding(pre + "embeddings.position_embedding"),
        "pre_ln": w.norm(pre_ln),
        "layers": layers,
        "post_ln": w.norm(pre + "post_layernorm"),
        "visual_projection": w.linear("visual_projection"),
    }
    w.warn_unused("vision tower")
    return params


def clip_vision_config_from_json(raw: Dict[str, Any]) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        image_size=raw.get("image_size", 224),
        patch_size=raw.get("patch_size", 32),
        hidden_size=raw.get("hidden_size", 768),
        num_layers=raw.get("num_hidden_layers", 12),
        num_heads=raw.get("num_attention_heads", 12),
        intermediate_size=raw.get("intermediate_size", 3072),
        hidden_act=raw.get("hidden_act", "quick_gelu"),
        layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
        projection_dim=raw.get("projection_dim", 512),
    )


def load_clip_model(model_dir: str, *, device=None):
    """An HF ``CLIPModel`` directory (``config.json`` with ``text_config`` and
    ``vision_config``, a safetensors file, the tokenizer's ``vocab.json`` and
    ``merges.txt`` in the directory or its ``tokenizer/``) -> a
    ``yume.scoring.NativeCLIP`` whose weights lie on ``device`` (None: the
    CUDA device) in the file's dtype."""
    from .yume.scoring import NativeCLIP

    raw = _read_json(os.path.join(model_dir, "config.json"))
    tjson, vjson = raw["text_config"], raw["vision_config"]
    proj = raw.get("projection_dim", 512)
    text_cfg = CLIPTextConfig(
        vocab_size=tjson.get("vocab_size", 49408),
        hidden_size=tjson.get("hidden_size", 512),
        num_layers=tjson.get("num_hidden_layers", 12),
        num_heads=tjson.get("num_attention_heads", 8),
        max_position_embeddings=tjson.get("max_position_embeddings", 77),
        intermediate_size=tjson.get("intermediate_size", 2048),
        hidden_act=tjson.get("hidden_act", "quick_gelu"),
        layer_norm_eps=tjson.get("layer_norm_eps", 1e-5),
        projection_dim=proj,
    )
    vision_cfg = clip_vision_config_from_json({**vjson, "projection_dim": proj})
    tensors = _load_weights(model_dir)
    dev = resolve_device(device)
    # one file holds both towers (and logit_scale): each converter gets its own keys
    text = {k: v for k, v in tensors.items() if k.startswith(("text_model.", "text_projection."))}
    vision = {k: v for k, v in tensors.items()
              if k.startswith(("vision_model.", "visual_projection."))}
    tok_dir = os.path.join(model_dir, "tokenizer")
    return NativeCLIP(
        text_params=convert_clip_text(text, text_cfg, device=dev),
        text_cfg=text_cfg,
        vision_params=convert_clip_vision(vision, vision_cfg, device=dev),
        vision_cfg=vision_cfg,
        tokenizer=CLIPTokenizer.from_pretrained(tok_dir if os.path.isdir(tok_dir) else model_dir),
        device=dev,
    )


# ---------------------------------------------------------------------------
# pipeline bundle
# ---------------------------------------------------------------------------


def classify_arch(cross_attention_dim: int) -> str:
    """2048/1280 -> SDXL-class, 768/1024 -> SD1.5-class (the reference's
    worker_factory detection rule)."""
    if cross_attention_dim in (2048, 1280):
        return "sdxl"
    if cross_attention_dim in (768, 1024):
        return "sd15"
    raise ValueError(f"unsupported cross_attention_dim: {cross_attention_dim}")


def load_pipeline(model_dir: str, *, device=None, load_vae_encoder: bool = False) -> PipelineBundle:
    """Load a diffusers-layout checkpoint directory, or a single LDM-layout
    file (``loader_single_file.load_single_file``), into a PipelineBundle
    whose tensors lie on ``device`` (None = the CUDA device) in the file's
    dtype. ``load_vae_encoder``: read the VAE encoder (img2img, inpainting)
    where the directory's VAE has one; a single file's is always read, as in
    the JAX package."""
    if os.path.isfile(model_dir):
        from .loader_single_file import load_single_file

        return load_single_file(model_dir, device=device)
    dev = resolve_device(device)

    def sub(name):
        return os.path.join(model_dir, name)

    unet_cfg = unet_config_from_json(_read_json(os.path.join(sub("unet"), "config.json")))
    arch = classify_arch(unet_cfg.cross_attention_dim)
    unet_params = convert_unet(_load_weights(sub("unet")), unet_cfg, device=dev)

    vae_dir = sub("vae") if os.path.isdir(sub("vae")) else sub("vae_decoder")
    vae_cfg = vae_config_from_json(_read_json(os.path.join(vae_dir, "config.json")))
    vae_params, vae_encoder_params = convert_vae(_load_weights(vae_dir), vae_cfg, device=dev,
                                                 encoder=load_vae_encoder)

    # SDXL-refiner checkpoints carry only the second (OpenCLIP bigG) tower,
    # which then serves as the text tower (context 1280 = cross_attention_dim,
    # its projected pooled output feeds the micro-conditioning)
    is_refiner = (arch == "sdxl" and not os.path.isdir(sub("text_encoder"))
                  and os.path.isdir(sub("text_encoder_2")))
    te_dir = sub("text_encoder_2") if is_refiner else sub("text_encoder")
    tok_dir = sub("tokenizer_2") if is_refiner else sub("tokenizer")
    text_cfg = text_config_from_json(_read_json(os.path.join(te_dir, "config.json")),
                                     penultimate=(arch == "sdxl"))
    text_params = convert_clip_text(_load_weights(te_dir), text_cfg, device=dev)

    has_scheduler = os.path.exists(os.path.join(sub("scheduler"), "scheduler_config.json"))
    bundle = PipelineBundle(
        arch=arch,
        tokenizer=CLIPTokenizer.from_pretrained(tok_dir),
        text_cfg=text_cfg,
        text_params=text_params,
        unet_cfg=unet_cfg,
        unet_params=unet_params,
        vae_cfg=vae_cfg,
        vae_params=vae_params,
        scheduler_cfg=load_scheduler_config(model_dir) if has_scheduler else LCMConfig(),
        model_dir=model_dir,
        vae_encoder_params=vae_encoder_params,
    )
    if arch == "sdxl" and not is_refiner and os.path.isdir(sub("text_encoder_2")):
        bundle.text_cfg_2 = text_config_from_json(
            _read_json(os.path.join(sub("text_encoder_2"), "config.json")), penultimate=True)
        bundle.text_params_2 = convert_clip_text(_load_weights(sub("text_encoder_2")),
                                                 bundle.text_cfg_2, device=dev)
        bundle.tokenizer_2 = CLIPTokenizer.from_pretrained(sub("tokenizer_2"))
    return bundle
