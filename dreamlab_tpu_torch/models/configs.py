"""Model architecture configs: the SD1.5, SDXL and super-resolution presets and
their tiny test variants.

A copy of the dataclasses of ``dreamlab_tpu/models/configs.py`` (importing
that module pulls in JAX through ``dreamlab_tpu/models/__init__.py``). The
tests hold each preset field-equal to the JAX package's. Tiny variants keep
the exact topology at toy widths so every code path runs in CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"  # OpenAI CLIP; OpenCLIP bigG uses "gelu"
    layer_norm_eps: float = 1e-5
    # SDXL reads the penultimate hidden state ("clip skip"); 0 = final.
    penultimate: bool = False
    # SD2.x applies the final LayerNorm to the penultimate state.
    penultimate_ln: bool = False
    # OpenCLIP text encoders project the pooled EOS embedding.
    projection_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # per down-block: 0 transformer layers = plain DownBlock2D
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 0)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_groups: int = 32
    time_embed_dim_mult: int = 4  # time_embed_dim = block_out[0] * mult
    time_cond_proj_dim: Optional[int] = 256  # LCM guidance embedding (w)
    # SDXL micro-conditioning: pooled text emb dim + fourier dim for time_ids
    addition_embed_type: Optional[str] = None  # None | "text_time"
    addition_time_embed_dim: Optional[int] = None  # 256 for SDXL
    projection_class_embeddings_input_dim: Optional[int] = None  # 2816 for SDXL
    mid_block_transformer_layers: int = 1
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # attention dispatch: 'auto' | 'flash' | 'xla' (ops/attention.py)
    attention_impl: str = "auto"

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    @property
    def has_mid_attention(self) -> bool:
        return self.mid_block_transformer_layers > 0


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2  # decoder uses layers_per_block + 1 resnets
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    mid_attention: bool = True
    attention_impl: str = "auto"  # 'auto' | 'flash' | 'xla'

    @property
    def scale_factor(self) -> int:
        """Spatial downsample factor between pixels and latents (8 for SD)."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class SuperResConfig:
    """Sub-pixel CNN (ESPCN, the ONNX model zoo's "super-resolution-10"):
    the luma plane in, 3x per pass through depth-to-space, over tiles of
    ``tile`` squared (224 -> 672)."""

    upscale: int = 3
    channels: Tuple[int, ...] = (64, 64, 32)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3)
    tile: int = 224


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

SD15_TEXT = CLIPTextConfig()

SD15_UNET = UNetConfig()

SD15_VAE = VAEConfig()

SUPERRES = SuperResConfig()

SDXL_TEXT_L = CLIPTextConfig(penultimate=True)  # CLIP ViT-L, hidden 768

SDXL_TEXT_BIGG = CLIPTextConfig(
    vocab_size=49408,
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    intermediate_size=5120,
    hidden_act="gelu",
    penultimate=True,
    projection_dim=1280,
)

SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    transformer_layers_per_block=(0, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    time_cond_proj_dim=None,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
    mid_block_transformer_layers=10,
)

SDXL_VAE = VAEConfig(scaling_factor=0.13025)

# Tiny presets: same topology, toy widths — used by the CPU test suite.
TINY_TEXT = CLIPTextConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
    max_position_embeddings=77, intermediate_size=64,
)

TINY_UNET = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    transformer_layers_per_block=(1, 0),
    num_attention_heads=(2, 2),
    cross_attention_dim=32,
    norm_groups=8,
    time_cond_proj_dim=8,
    mid_block_transformer_layers=1,
)

TINY_UNET_XL = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    transformer_layers_per_block=(0, 2),
    num_attention_heads=(2, 2),
    cross_attention_dim=64,
    norm_groups=8,
    time_cond_proj_dim=None,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8,  # pooled 32 + 6 time_ids
    mid_block_transformer_layers=1,
)

TINY_VAE = VAEConfig(
    latent_channels=4, block_out_channels=(16, 32), layers_per_block=1,
    norm_groups=8,
)
