"""CLIP ViT image encoder (port of ``dreamlab_tpu/models/clip_vision.py``).

HF CLIPVisionTransformer semantics: patch conv (stride = patch, no bias, on
cuDNN) -> prepend the class embedding -> + position embeddings -> pre-
LayerNorm -> the encoder layers (``clip_text._encoder_layer`` with a zero,
non-causal mask) -> post-LayerNorm on the CLS token -> visual projection (no
bias). Yume's native CLIP scorer runs it beside the text tower.

``preprocess_images`` is CLIPProcessor's resize of the shortest edge,
centre crop and normalisation, run on the tensors' device with the port's
8-bit bicubic resampler (``utils/image_ops.py``, equal to PIL's), where the
JAX package resizes with PIL on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils import image_ops
from .clip_text import _encoder_layer
from .configs import CLIPTextConfig, CLIPVisionConfig
from .layers import conv2d, init_conv, init_embedding, init_linear, init_norm, layer_norm, linear

# CLIPProcessor's normalisation constants (OpenAI CLIP)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _layer_cfg(cfg: CLIPVisionConfig) -> CLIPTextConfig:
    """The encoder layer's hyperparameters, as ``clip_text._encoder_layer`` reads them."""
    return CLIPTextConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                          intermediate_size=cfg.intermediate_size, hidden_act=cfg.hidden_act,
                          layer_norm_eps=cfg.layer_norm_eps)


def encode_image(params, pixel_values: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """[B, H, W, 3] CLIP-normalised pixels -> [B, projection_dim] image features
    (``preprocess_images`` normalises)."""
    b = pixel_values.shape[0]
    dtype = params["patch_embedding"]["w"].dtype
    x = conv2d(params["patch_embedding"], pixel_values.to(dtype), stride=cfg.patch_size,
               padding=0)  # [B, h', w', C]
    x = x.reshape(b, -1, cfg.hidden_size)
    cls = params["class_embedding"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"]["w"][: x.shape[1]].to(dtype)
    x = layer_norm(params["pre_ln"], x, eps=cfg.layer_norm_eps)

    lcfg = _layer_cfg(cfg)
    mask = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=x.device)  # non-causal
    for layer_p in params["layers"]:
        x = _encoder_layer(layer_p, x, mask, lcfg)

    pooled = layer_norm(params["post_ln"], x[:, 0], eps=cfg.layer_norm_eps)
    return linear(params["visual_projection"], pooled)


def _rgb(image) -> torch.Tensor:
    """uint8 [H, W] (gray) or [H, W, 3 or 4] -> uint8 [H, W, 3], as PIL's
    ``convert("RGB")`` of ``Image.fromarray``: gray replicated, alpha dropped."""
    img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
    if img.ndim == 2:
        return img[..., None].expand(*img.shape, 3)
    return img[..., :3]


def preprocess_images(images: Sequence, cfg: CLIPVisionConfig, device="cpu") -> torch.Tensor:
    """uint8 images (numpy or tensors, any size) -> [N, S, S, 3] float32 on
    ``device``, CLIP-normalised: the shortest edge resized (bicubic) to
    ``image_size``, the centre cropped, scaled by 1/255, mean and std."""
    s = cfg.image_size
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=device)
    out = []
    for image in images:
        img = _rgb(image).to(device)
        h, w = img.shape[:2]
        scale = s / min(w, h)
        nw, nh = max(s, int(round(w * scale))), max(s, int(round(h * scale)))
        img = image_ops.resize_bicubic(img.contiguous(), (nw, nh))
        left, top = (nw - s) // 2, (nh - s) // 2
        out.append(img[top:top + s, left:left + s].float() / 255.0)
    return (torch.stack(out) - mean) / std


def init_params(cfg: CLIPVisionConfig, gen: torch.Generator):
    """Random weights in the JAX package's tree, drawn from ``gen`` as the
    port's other ``init_params`` draw them."""
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
        "patch_embedding": init_conv(gen, cfg.patch_size, cfg.patch_size, 3, c, bias=False),
        "class_embedding": init_embedding(gen, 1, c)["w"][0],
        "position_embedding": init_embedding(gen, cfg.num_patches + 1, c),
        "pre_ln": init_norm(gen, c),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "post_ln": init_norm(gen, c),
        "visual_projection": init_linear(gen, c, cfg.projection_dim, bias=False),
    }
