"""Seeded weights under the published checkpoints' key names and shapes.

Each model of a configuration (the text towers, the UNet, the VAE's
decoder) is drawn from the run's seed on the device in one ``torch.randn``
call of the served dtype into a flat buffer, then each tensor is scaled in
place and copied out into a tensor of its own, so that dropping the state
dict frees everything the program did not keep:

- conv and linear weights and their biases: standard deviation
  ``1/sqrt(3 fan_in)``, the variance of the uniform ``+-1/sqrt(fan_in)``
  that the port's ``init_params`` draw (a decoded image then spreads like
  a real one instead of saturating);
- norm weights ``1 + 0.1 n``, norm biases ``0.1 n``;
- embeddings ``0.02 n`` (token) and ``0.01 n`` (position).

The same seed on the same device gives the same tensors: the program and
the reference are handed the same values.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import sd_arch

_EMBED_STD = {"token_embedding": 0.02, "position_embedding": 0.01}


def _seed_of(seed: int, name: str) -> int:
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, *map(ord, "weights:" + name)])
    return int(ss.generate_state(1, np.uint64)[0] & (2**63 - 1))


def model_state(tensors: List[sd_arch.Tensor], seed: int, name: str, device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One model's state dict, drawn from ``seed`` (see the module's text)."""
    total = sum(math.prod(shape) for _, shape, _ in tensors)
    gen = torch.Generator(device=device).manual_seed(_seed_of(seed, name))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    off, fan_in = 0, 1
    for key, shape, role in tensors:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if role == "w":
            fan_in = math.prod(shape[1:])
            t.mul_(1.0 / math.sqrt(3.0 * fan_in))
        elif role == "b":
            t.mul_(1.0 / math.sqrt(3.0 * fan_in))
        elif role == "norm_w":
            t.mul_(0.1).add_(1.0)
        elif role == "norm_b":
            t.mul_(0.1)
        elif role == "embed":
            t.mul_(next(v for k, v in _EMBED_STD.items() if k in key))
        out[key] = t.clone()
    del flat
    return out


def state_dicts(config: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Dict]:
    """{model: state dict} of a configuration: its text towers, "unet", "vae"."""
    return {name: model_state(list(tensors), seed, name, device, dtype)
            for name, tensors in sd_arch.components(config).items()}
