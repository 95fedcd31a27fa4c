"""Randomly initialised SD1.5 bundles, full width or tiny (port of
``dreamlab_tpu/testing.py::random_bundle``).

Speed does not depend on weight values, so the chip smoke run drives the real
architecture with seeded random weights when no checkpoint is at hand. The
init scheme is the JAX package's (uniform +-1/sqrt(fan_in), norms 1/0,
embeddings N(0, 0.02)): activations stay finite in bf16 through 4 steps.
"""

from __future__ import annotations

import dataclasses

import torch

from .models import clip_text, configs, unet, vae
from .pipeline import PipelineBundle
from .scheduler.lcm import LCMConfig
from .utils.tokenizer import make_test_tokenizer


def random_bundle(*, tiny: bool = False, seed: int = 0, device="cpu") -> PipelineBundle:
    """An SD1.5 bundle with random fp32 weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    unet_cfg = configs.TINY_UNET if tiny else configs.SD15_UNET
    vae_cfg = configs.TINY_VAE if tiny else configs.SD15_VAE
    tok = make_test_tokenizer(["cat", "dog", "sunset", "mountain"])
    if tiny:
        # text width tied to the cross-attention dim, as in real checkpoints
        text_cfg = configs.CLIPTextConfig(
            vocab_size=len(tok.encoder), hidden_size=unet_cfg.cross_attention_dim,
            num_layers=2, num_heads=2, intermediate_size=64)
    else:
        text_cfg = dataclasses.replace(configs.SD15_TEXT, vocab_size=len(tok.encoder))
    with torch.no_grad():
        return PipelineBundle(
            arch="sd15",
            tokenizer=tok,
            text_cfg=text_cfg,
            text_params=clip_text.init_params(text_cfg, gen),
            unet_cfg=unet_cfg,
            unet_params=unet.init_params(unet_cfg, gen),
            vae_cfg=vae_cfg,
            vae_params=vae.init_decoder_params(vae_cfg, gen),
            scheduler_cfg=LCMConfig(),
        )
