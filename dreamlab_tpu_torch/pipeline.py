"""txt2img pipeline on PyTorch (port of ``dreamlab_tpu/pipeline.py::LCMPipeline``).

The JAX package's program (``pipeline.py`` ``_build``: ``encode`` ->
``lax.scan`` of UNet + LCM step -> VAE decode -> uint8) as eager PyTorch:
CLIP encode, a Python loop of ``unet.forward`` + ``lcm_step``,
``vae.decode(denoised / scaling_factor)``, clip, round, uint8.

SD1.5 and SDXL checkpoints. SDXL encodes with two text towers (the
sequences concatenated, the pooled embedding from the second) and
conditions the UNet on micro-conditioning ids as well; a refiner-layout
checkpoint has the second tower only. Guidance takes one of three modes,
chosen per call as in the JAX package:

- ``wcond``: the UNet has ``time_cond_proj_dim`` (LCM checkpoints, SD1.5
  or SDXL); guidance conditions it through the w-embedding, no CFG.
- ``cfg``: classic classifier-free guidance when a row's guidance exceeds
  1: one UNet call on the doubled batch (negatives, then prompts) per step,
  mixed per row as ``uncond + g * (cond - uncond)``.
- ``none``: guidance <= 1 on a non-LCM UNet (SDXL with an LCM-LoRA merged).

Noise comes from the host (``rng_mode="host"``): latents and per-step noise
from ``np.random.RandomState(seed)`` in NCHW, transposed, exactly as in the
JAX package, so a seed gives the same noise in both. Device RNG, segments
(the refiner ensemble), img2img and callbacks come later.
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

# the refiner's uncond-branch aesthetic score (diffusers' default)
NEGATIVE_AESTHETIC_SCORE = 2.5


@dataclasses.dataclass
class PipelineBundle:
    """Everything a worker needs to serve one checkpoint: configs, tokenizers
    and parameter trees (dicts of tensors, ``loader`` / ``testing`` layout)."""

    arch: str  # "sd15" | "sdxl"
    tokenizer: CLIPTokenizer
    text_cfg: CLIPTextConfig
    text_params: Dict
    unet_cfg: UNetConfig
    unet_params: Dict
    vae_cfg: VAEConfig
    vae_params: Dict
    scheduler_cfg: LCMConfig
    # SDXL's second (OpenCLIP bigG) tower; None for SD1.5 and the refiner
    tokenizer_2: Optional[CLIPTokenizer] = None
    text_cfg_2: Optional[CLIPTextConfig] = None
    text_params_2: Optional[Dict] = None
    model_dir: Optional[str] = None  # where the loader read it; None in memory


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
    """Cast floating leaves to ``dtype`` on ``device`` (None, an absent tree,
    stays None); conv weights (4-D) go channels_last, the layout of the NHWC
    activations (models/layers.py)."""
    if isinstance(tree, dict):
        return {k: _place_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_params(v, dtype, device) for v in tree]
    if tree is None:
        return None
    t = tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)
    if t.ndim == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


class LCMPipeline:
    """Serving pipeline for one loaded checkpoint.

    Args:
        bundle: configs, tokenizers + parameter trees. The pipeline keeps
            the configs and tokenizers (``self.bundle``, parameter trees
            dropped) and its own copies of the trees, cast and placed, so
            the caller's copies can be freed.
        dtype: compute/param dtype (bf16, as in the JAX package).
        device: None = the CUDA device (raises if there is none); "cpu" runs
            every kernel's plain version.
    """

    def __init__(self, bundle: PipelineBundle, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        if bundle.arch not in ("sd15", "sdxl"):
            raise ValueError(f"unknown arch {bundle.arch!r}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.text_params = _place_params(bundle.text_params, dtype, self.device)
        self.text_params_2 = _place_params(bundle.text_params_2, dtype, self.device)
        self.unet_params = _place_params(bundle.unet_params, dtype, self.device)
        self.vae_params = _place_params(bundle.vae_params, dtype, self.device)
        self.bundle = dataclasses.replace(bundle, text_params=None, text_params_2=None,
                                          unet_params=None, vae_params=None)
        self.vae_scale = bundle.vae_cfg.scale_factor
        self.latent_channels = bundle.vae_cfg.latent_channels
        self._schedules: Dict[Tuple, LCMSchedule] = {}

    def cfg_mode(self, guidance_scale) -> str:
        """'wcond' for an LCM UNet (guidance as the w-embedding), else 'cfg'
        when any row's guidance exceeds 1, else 'none'."""
        if self.bundle.unet_cfg.time_cond_proj_dim is not None:
            return "wcond"
        return "cfg" if float(np.max(guidance_scale)) > 1.0 else "none"

    def _micro_cond_ids(self) -> int:
        """SDXL micro-conditioning id count, from the UNet config (its add
        embedding takes pooled_dim + n_ids x addition_time_embed_dim): 6 for
        base models (original size, crop, target size), 5 for the refiner
        (original size, crop, aesthetic score)."""
        b = self.bundle
        cfg = b.unet_cfg
        pooled_dim = (b.text_cfg_2.projection_dim if b.text_cfg_2 is not None
                      else b.text_cfg.projection_dim) or 0
        if cfg.projection_class_embeddings_input_dim and cfg.addition_time_embed_dim:
            return ((cfg.projection_class_embeddings_input_dim - pooled_dim)
                    // cfg.addition_time_embed_dim)
        return 6

    def _time_ids(self, height: int, width: int, bsz: int, aesthetic_score: float = 6.0,
                  cfg_mode: str = "none") -> np.ndarray:
        """SDXL micro-conditioning ids: [B, n], or [2, B, n] in cfg mode with
        row 0 the uncond branch (the negative aesthetic score for refiners,
        diffusers' requires_aesthetics_score convention)."""
        if self._micro_cond_ids() == 5:
            cond = [height, width, 0, 0, aesthetic_score]
            uncond = [height, width, 0, 0, NEGATIVE_AESTHETIC_SCORE]
        else:
            cond = [height, width, 0, 0, height, width]
            uncond = cond
        if cfg_mode == "cfg":
            return np.asarray([[uncond] * bsz, [cond] * bsz], np.float32)
        return np.asarray([cond] * bsz, np.float32)

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

    def _encode(self, texts):
        """Text conditioning of ``texts``: (context [B, 77, C], pooled [B, P]
        or None)."""
        b = self.bundle
        dev = self.device
        ids = torch.from_numpy(b.tokenizer(texts)).to(dev, torch.int64)
        if b.arch != "sdxl":
            return clip_text.encode_text(self.text_params, ids, b.text_cfg)[0], None
        if self.text_params_2 is None:
            # refiner layout: the one bigG tower gives the context and the
            # projected pooled embedding of the micro-conditioning
            return clip_text.encode_text(self.text_params, ids, b.text_cfg)
        ids_2 = torch.from_numpy(b.tokenizer_2(texts)).to(dev, torch.int64)
        seq1, _ = clip_text.encode_text(self.text_params, ids, b.text_cfg)
        seq2, pooled = clip_text.encode_text(self.text_params_2, ids_2, b.text_cfg_2)
        return torch.cat([seq1, seq2], dim=-1), pooled

    def generate(self, prompt, *, height: int = 512, width: int = 512,
                 num_inference_steps: int = 4,
                 original_inference_steps: Optional[int] = None,
                 guidance_scale: Any = 1.0, negative_prompt: Any = None,
                 seed: Optional[int] = None, batch: Optional[int] = None,
                 latents: Optional[np.ndarray] = None,
                 step_noises: Optional[np.ndarray] = None,
                 aesthetic_score: float = 6.0) -> GenerationResult:
        """Generate images: uint8 [B, H, W, 3] plus the final latents.

        guidance_scale: a scalar or one value per row; it picks the guidance
        mode (``cfg_mode``) and weighs each row. negative_prompt: None (""),
        one string, or one per row; read in cfg mode only. latents /
        step_noises: explicit raw initial noise [B, h, w, 4] and per-step
        noise [S, B, h, w, 4] (the worker's coalesced batches give each row
        its own seed's noise). aesthetic_score: the refiner's
        micro-conditioning.
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
        mode = self.cfg_mode(gs)
        neg = negative_prompt
        negs = [""] * bsz if neg is None else [neg] * bsz if isinstance(neg, str) else list(neg)
        if len(negs) != bsz:
            raise ValueError(f"negative_prompt has {len(negs)} entries for batch {bsz}")

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
        dev = self.device
        with torch.inference_mode():
            lat = torch.from_numpy(lat0).to(dev)
            noises_t = torch.from_numpy(noises).to(dev)
            ctx, pooled = self._encode(prompts)
            kw = {}
            if mode == "wcond":
                kw["timestep_cond"] = torch.from_numpy(
                    guidance_scale_embedding(gs - 1.0, b.unet_cfg.time_cond_proj_dim)).to(dev)
            if mode == "cfg":
                ctx_neg, pooled_neg = self._encode(negs)
                ctx = torch.cat([ctx_neg, ctx])
                g = torch.from_numpy(gs).to(dev).reshape(-1, 1, 1, 1)
            if b.arch == "sdxl":
                time_ids = torch.from_numpy(self._time_ids(
                    height, width, bsz, aesthetic_score, cfg_mode=mode)).to(dev)
                if mode == "cfg":  # [2, B, n]: the uncond rows, then the cond rows
                    pooled = torch.cat([pooled_neg, pooled])
                    time_ids = torch.cat([time_ids[0], time_ids[1]])
                kw.update(added_text_embeds=pooled, added_time_ids=time_ids)
            rows = 2 * bsz if mode == "cfg" else bsz
            for i in range(schedule.num_steps):
                t = torch.full((rows,), int(schedule.timesteps[i]), dtype=torch.int32,
                               device=dev)
                x = torch.cat([lat, lat]) if mode == "cfg" else lat
                noise_pred = unet.forward(self.unet_params, b.unet_cfg, x, t, ctx, **kw)
                if mode == "cfg":
                    uncond, cond = noise_pred.chunk(2)
                    noise_pred = uncond + g * (cond - uncond)
                lat, denoised = lcm_step(schedule, i, noise_pred, lat, noises_t[i],
                                         prediction_type=b.scheduler_cfg.prediction_type)
            img = vae.decode(self.vae_params, b.vae_cfg, denoised / b.vae_cfg.scaling_factor)
            img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
            images = torch.round(img * 255.0).to(torch.uint8).cpu().numpy()
            latents_np = denoised.cpu().numpy()
        return GenerationResult(images=images, seed=seed, latents=latents_np)
