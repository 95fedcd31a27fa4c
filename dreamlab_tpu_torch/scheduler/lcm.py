"""Latent Consistency Model scheduler (port of ``dreamlab_tpu/scheduler/lcm.py``).

``LCMConfig``, ``load_scheduler_config``, ``lcm_timesteps``,
``make_lcm_schedule`` and ``guidance_scale_embedding`` are host-side copies
of the JAX package's (its module imports JAX), in float64 numpy. ``lcm_step`` is the per-step update in
fp32 torch. Semantics follow diffusers' ``LCMScheduler``.

A schedule's entries reach ``lcm_step`` in one of two forms: host arrays,
read as Python floats (the txt2img program bakes them into its CUDA graph),
or fp32 device tensors (``schedule_on``: the img2img and inpaint programs
take the strength-truncated schedule as an input, so one graph serves every
strength). Both compute in fp32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LCMConfig:
    """Static scheduler configuration (diffusers ``scheduler_config.json``)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    set_alpha_to_one: bool = True
    init_noise_sigma: float = 1.0
    sigma_data: float = 0.5  # fixed by the consistency-model parameterisation
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0

    def betas(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, n, dtype=np.float64)
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, n,
                               dtype=np.float64) ** 2
        if self.beta_schedule == "squaredcos_cap_v2":
            def alpha_bar(t):
                return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

            return np.array(
                [min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999)
                 for i in range(n)],
                dtype=np.float64,
            )
        raise ValueError(f"unknown beta_schedule: {self.beta_schedule}")

    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas())


def load_scheduler_config(model_dir: str) -> LCMConfig:
    """Read a diffusers-layout ``scheduler/scheduler_config.json``; keys that
    are not ``LCMConfig`` fields (``_class_name``, ...) are ignored."""
    with open(os.path.join(model_dir, "scheduler", "scheduler_config.json")) as f:
        raw = json.load(f)
    known = {f.name for f in dataclasses.fields(LCMConfig)}
    return LCMConfig(**{k: v for k, v in raw.items() if k in known})


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    """Per-request precomputed schedule: host arrays indexed by step."""

    timesteps: np.ndarray  # int32 [S] — training-timestep index fed to the UNet
    sqrt_alpha_prod: np.ndarray  # f32 [S]
    sqrt_beta_prod: np.ndarray  # f32 [S]
    sqrt_alpha_prod_prev: np.ndarray  # f32 [S]
    sqrt_beta_prod_prev: np.ndarray  # f32 [S]
    c_skip: np.ndarray  # f32 [S] — consistency boundary scaling
    c_out: np.ndarray  # f32 [S]
    add_noise: np.ndarray  # f32 [S] — 1.0 except at the final step
    init_noise_sigma: float = 1.0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def lcm_timesteps(config: LCMConfig, num_inference_steps: int,
                  original_inference_steps: Optional[int] = None,
                  strength: float = 1.0) -> np.ndarray:
    """The LCM timestep ladder (descending int32): e.g. 4 steps of the
    default 50-step / 1000-timestep schedule give [999, 759, 499, 259]."""
    orig = original_inference_steps or config.original_inference_steps
    if orig > config.num_train_timesteps:
        raise ValueError(f"original_inference_steps {orig} > num_train_timesteps "
                         f"{config.num_train_timesteps}")
    k = config.num_train_timesteps // orig
    origin = (np.arange(1, int(orig * strength) + 1, dtype=np.int64) * k) - 1
    if num_inference_steps > len(origin):
        raise ValueError(f"num_inference_steps {num_inference_steps} exceeds the "
                         f"trained ladder length {len(origin)}")
    origin = origin[::-1]
    idx = np.floor(np.linspace(0, len(origin), num=num_inference_steps,
                               endpoint=False)).astype(np.int64)
    return origin[idx].astype(np.int32)


def make_lcm_schedule(config: LCMConfig, num_inference_steps: int,
                      original_inference_steps: Optional[int] = None,
                      strength: float = 1.0) -> LCMSchedule:
    """Host-side precomputation of all per-step scalars (exact float64,
    stored as float32 like the JAX package's device arrays)."""
    timesteps = lcm_timesteps(config, num_inference_steps, original_inference_steps,
                              strength)
    acp = config.alphas_cumprod()
    final_alpha = 1.0 if config.set_alpha_to_one else float(acp[0])
    # the previous timestep is the next ladder entry; the last step emits
    # `denoised` directly (add_noise masks the renoising there)
    prev = np.empty_like(timesteps)
    prev[:-1] = timesteps[1:]
    prev[-1] = timesteps[-1]

    def at(t_arr):
        return np.where(t_arr >= 0, acp[np.clip(t_arr, 0, None)], final_alpha)

    alpha_prod = at(timesteps)
    alpha_prod_prev = at(prev)
    scaled_t = timesteps.astype(np.float64) * config.timestep_scaling
    sd2 = config.sigma_data ** 2
    c_skip = sd2 / (scaled_t ** 2 + sd2)
    c_out = scaled_t / np.sqrt(scaled_t ** 2 + sd2)
    add_noise = np.ones(len(timesteps))
    add_noise[-1] = 0.0

    def f32(x):
        return np.asarray(x, dtype=np.float64).astype(np.float32)

    return LCMSchedule(
        timesteps=timesteps.astype(np.int32),
        sqrt_alpha_prod=f32(np.sqrt(alpha_prod)),
        sqrt_beta_prod=f32(np.sqrt(1.0 - alpha_prod)),
        sqrt_alpha_prod_prev=f32(np.sqrt(alpha_prod_prev)),
        sqrt_beta_prod_prev=f32(np.sqrt(1.0 - alpha_prod_prev)),
        c_skip=f32(c_skip),
        c_out=f32(c_out),
        add_noise=f32(add_noise),
        init_noise_sigma=float(config.init_noise_sigma),
    )


SCHEDULE_FIELDS = ("timesteps", "sqrt_alpha_prod", "sqrt_beta_prod", "sqrt_alpha_prod_prev",
                   "sqrt_beta_prod_prev", "c_skip", "c_out", "add_noise")


def schedule_on(arrays, init_noise_sigma: float = 1.0) -> LCMSchedule:
    """A schedule whose entries are the given tensors (``arrays[name]`` for
    each of ``SCHEDULE_FIELDS``: int32 timesteps, fp32 coefficients)."""
    return LCMSchedule(**{name: arrays[name] for name in SCHEDULE_FIELDS},
                       init_noise_sigma=init_noise_sigma)


def slice_schedule(schedule: LCMSchedule, start: int, stop: int) -> LCMSchedule:
    """Steps [start, stop) of a schedule: diffusers' ``denoising_end`` /
    ``denoising_start`` ensemble contract (SDXL base -> refiner) on the LCM
    ladder. Slicing the full schedule keeps the handoff exact: the base
    segment's last step still renoises toward ``timesteps[stop]`` (its
    ``add_noise`` stays 1, its ``*_prev`` entries point into the next
    segment), so the carry after [0, k) is the state a full run carries into
    step k; only the full ladder's last step emits ``denoised`` as it is."""
    return dataclasses.replace(schedule, **{name: getattr(schedule, name)[start:stop]
                                            for name in SCHEDULE_FIELDS})


def _at(arr, i: int):
    """Entry ``i`` of a schedule array: a 0-d tensor of a device schedule,
    else the fp32 host value as a Python float."""
    return arr[i] if isinstance(arr, torch.Tensor) else float(arr[i])


def _predict_x0(schedule: LCMSchedule, i: int, model_output, sample,
                prediction_type: str):
    # fp32 scalars, exactly the JAX package's schedule entries
    sa = _at(schedule.sqrt_alpha_prod, i)
    sb = _at(schedule.sqrt_beta_prod, i)
    if prediction_type == "epsilon":
        return (sample - sb * model_output) / sa
    if prediction_type == "v_prediction":
        return sa * sample - sb * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"unknown prediction_type: {prediction_type}")


def lcm_step(schedule: LCMSchedule, i: int, model_output, sample, noise,
             prediction_type: str = "epsilon") -> Tuple[torch.Tensor, torch.Tensor]:
    """One LCM update in fp32.

    Returns ``(prev_sample, denoised)``: the renoised next latent state (the
    clean prediction itself at the final step) and the consistency-model
    clean prediction.
    """
    sample = sample.float()
    x0 = _predict_x0(schedule, i, model_output.float(), sample, prediction_type)
    denoised = _at(schedule.c_out, i) * x0 + _at(schedule.c_skip, i) * sample
    renoise = lambda: (_at(schedule.sqrt_alpha_prod_prev, i) * denoised
                       + _at(schedule.sqrt_beta_prod_prev, i) * noise.float())
    if isinstance(schedule.add_noise, torch.Tensor):
        # no host branch on a device value: a captured graph cannot sync
        return torch.where(schedule.add_noise[i] > 0, renoise(), denoised), denoised
    if schedule.add_noise[i] > 0:
        return renoise(), denoised
    return denoised, denoised


def guidance_scale_embedding(w, embedding_dim: int, dtype=np.float32) -> np.ndarray:
    """Sinusoidal embedding of (guidance_scale - 1), the LCM-w conditioning.

    Host-side float64 on purpose: the angles reach w*1000 radians, where fp32
    sin/cos loses ~1e-2.

    Args:
        w: [B] guidance weights, already offset by -1.
        embedding_dim: UNet ``time_cond_proj_dim`` (256 for LCM SD1.5).
    """
    w = np.asarray(w, dtype=np.float64) * 1000.0
    half = embedding_dim // 2
    freqs = np.exp(np.arange(half, dtype=np.float64) * (-math.log(10000.0) / (half - 1)))
    angles = w[:, None] * freqs[None, :]
    emb = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    if embedding_dim % 2 == 1:
        emb = np.pad(emb, [(0, 0), (0, 1)])
    return emb.astype(dtype)
