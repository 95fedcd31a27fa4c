"""txt2img pipeline on PyTorch (port of ``dreamlab_tpu/pipeline.py::LCMPipeline``).

The main path of the JAX package's program (``pipeline.py`` ``_build``:
``encode`` -> ``lax.scan`` of UNet + LCM step -> VAE decode -> uint8) as
eager PyTorch: CLIP encode, a Python loop of ``unet.forward`` +
``lcm_step``, ``vae.decode(denoised / scaling_factor)``, clip, round, uint8.

This slice serves LCM checkpoints (guidance as the w-embedding,
``cfg_mode="wcond"``) with host-side noise (``rng_mode="host"``): latents
and per-step noise come from ``np.random.RandomState(seed)`` in NCHW and are
transposed, exactly as in the JAX package, so a seed gives the same noise in
both. Classic CFG, SDXL, device RNG, segments and callbacks come later.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .models import clip_text, unet, vae
from .models.configs import CLIPTextConfig, UNetConfig, VAEConfig
from .scheduler.lcm import (
    LCMConfig,
    LCMSchedule,
    guidance_scale_embedding,
    lcm_step,
    make_lcm_schedule,
)
from .utils.tokenizer import CLIPTokenizer


@dataclasses.dataclass
class PipelineBundle:
    """Everything a worker needs to serve one SD1.5 checkpoint: configs and
    parameter trees (dicts of tensors, ``convert`` / ``testing`` layout)."""

    arch: str  # "sd15"
    tokenizer: CLIPTokenizer
    text_cfg: CLIPTextConfig
    text_params: Dict
    unet_cfg: UNetConfig
    unet_params: Dict
    vae_cfg: VAEConfig
    vae_params: Dict
    scheduler_cfg: LCMConfig


@dataclasses.dataclass
class GenerationResult:
    images: np.ndarray  # [B, H, W, 3] uint8
    seed: int
    latents: np.ndarray  # [B, h, w, 4] fp32 final denoised latents


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller names another; never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def _place_params(tree, dtype: torch.dtype, device: torch.device):
    """Cast floating leaves to ``dtype`` on ``device``; conv weights (4-D)
    go channels_last, the layout of the NHWC activations (models/layers.py)."""
    if isinstance(tree, dict):
        return {k: _place_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_params(v, dtype, device) for v in tree]
    t = tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)
    if t.ndim == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


class LCMPipeline:
    """Serving pipeline for one loaded checkpoint.

    Args:
        bundle: configs + parameter trees.
        dtype: compute/param dtype (bf16, as in the JAX package).
        device: None = the CUDA device (raises if there is none); "cpu" runs
            every kernel's plain version.
    """

    def __init__(self, bundle: PipelineBundle, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        if bundle.arch != "sd15" or bundle.unet_cfg.time_cond_proj_dim is None:
            raise ValueError("this port serves SD1.5 LCM checkpoints; classic CFG "
                             "and SDXL come with later slices")
        self.bundle = bundle
        self.dtype = dtype
        self.device = resolve_device(device)
        self.text_params = _place_params(bundle.text_params, dtype, self.device)
        self.unet_params = _place_params(bundle.unet_params, dtype, self.device)
        self.vae_params = _place_params(bundle.vae_params, dtype, self.device)
        self.vae_scale = bundle.vae_cfg.scale_factor
        self.latent_channels = bundle.vae_cfg.latent_channels
        self._schedules: Dict[Tuple, LCMSchedule] = {}

    def _schedule(self, steps: int, original_steps: Optional[int]) -> LCMSchedule:
        key = (steps, original_steps)
        if key not in self._schedules:
            self._schedules[key] = make_lcm_schedule(
                self.bundle.scheduler_cfg, steps, original_steps)
        return self._schedules[key]

    def _sample_noise(self, seed: int, batch: int, h_lat: int, w_lat: int, steps: int,
                      init_noise_sigma: float) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side NCHW sampling, bit-compatible with the JAX package's seeds."""
        rs = np.random.RandomState(seed & 0x7FFFFFFF)
        c = self.latent_channels
        lat = rs.randn(batch, c, h_lat, w_lat).astype(np.float32)
        lat = lat.transpose(0, 2, 3, 1) * init_noise_sigma
        noises = rs.randn(steps, batch, c, h_lat, w_lat).astype(np.float32)
        noises = noises.transpose(0, 1, 3, 4, 2)
        return np.ascontiguousarray(lat), np.ascontiguousarray(noises)

    def generate(self, prompt, *, height: int = 512, width: int = 512,
                 num_inference_steps: int = 4,
                 original_inference_steps: Optional[int] = None,
                 guidance_scale: Any = 1.0, seed: Optional[int] = None,
                 batch: Optional[int] = None, latents: Optional[np.ndarray] = None,
                 step_noises: Optional[np.ndarray] = None) -> GenerationResult:
        """Generate images: uint8 [B, H, W, 3] plus the final latents.

        guidance_scale: a scalar or one value per row; it conditions the UNet
        through the LCM w-embedding. latents / step_noises: explicit raw
        initial noise [B, h, w, 4] and per-step noise [S, B, h, w, 4] (the
        worker's coalesced batches give each row its own seed's noise).
        """
        b = self.bundle
        divisor = self.vae_scale * 2 ** (b.unet_cfg.num_blocks - 1)
        if height % divisor or width % divisor:
            raise ValueError(f"height/width must be multiples of {divisor} "
                             f"(got {width}x{height})")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if batch is not None and len(prompts) == 1:
            prompts = prompts * batch
        bsz = len(prompts)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))

        gs = np.asarray(guidance_scale, np.float32).reshape(-1)
        if gs.size == 1:
            gs = np.full((bsz,), float(gs[0]), np.float32)
        elif gs.size != bsz:
            raise ValueError(f"guidance_scale has {gs.size} entries for batch {bsz}")

        schedule = self._schedule(num_inference_steps, original_inference_steps)
        h_lat, w_lat = height // self.vae_scale, width // self.vae_scale
        lat0, noises = self._sample_noise(seed, bsz, h_lat, w_lat, num_inference_steps,
                                          schedule.init_noise_sigma)
        if latents is not None:
            # provided latents are raw noise, scaled by init sigma
            lat0 = np.asarray(latents, np.float32) * schedule.init_noise_sigma
            if lat0.shape != (bsz, h_lat, w_lat, self.latent_channels):
                raise ValueError(f"unexpected latents shape {lat0.shape}")
        if step_noises is not None:
            noises = np.asarray(step_noises, np.float32)
            want = (num_inference_steps, bsz, h_lat, w_lat, self.latent_channels)
            if noises.shape != want:
                raise ValueError(f"unexpected step_noises shape {noises.shape}; want {want}")
        ids = b.tokenizer(prompts)
        w_emb = guidance_scale_embedding(gs - 1.0, b.unet_cfg.time_cond_proj_dim)

        dev = self.device
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(dev, torch.int64)
            lat = torch.from_numpy(lat0).to(dev)
            noises_t = torch.from_numpy(noises).to(dev)
            w_emb_t = torch.from_numpy(w_emb).to(dev)
            ctx, _ = clip_text.encode_text(self.text_params, ids_t, b.text_cfg)
            for i in range(schedule.num_steps):
                t = torch.full((bsz,), int(schedule.timesteps[i]), dtype=torch.int32,
                               device=dev)
                noise_pred = unet.forward(self.unet_params, b.unet_cfg, lat, t, ctx,
                                          timestep_cond=w_emb_t)
                lat, denoised = lcm_step(schedule, i, noise_pred, lat, noises_t[i],
                                         prediction_type=b.scheduler_cfg.prediction_type)
            img = vae.decode(self.vae_params, b.vae_cfg, denoised / b.vae_cfg.scaling_factor)
            img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
            images = torch.round(img * 255.0).to(torch.uint8).cpu().numpy()
            latents_np = denoised.cpu().numpy()
        return GenerationResult(images=images, seed=seed, latents=latents_np)
