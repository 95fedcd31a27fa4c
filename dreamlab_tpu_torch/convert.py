"""Parameter trees of the JAX package -> the port's (torch layout).

``from_jax_numpy`` takes trees in the schema of the JAX package's
``clip_text.init_params`` / ``clip_vision.init_params`` / ``unet.init_params``
/ ``vae.init_decoder_params`` / ``vae.init_encoder_params`` /
``controlnet.init_params`` (as loaded by its ``load_pipeline``,
``load_controlnet`` and ``load_clip_model``; a ControlNet's hint ladder and
zero-conv taps are lists of convs, converted as every conv is; the CLIP
image tower's patch conv and projection are a conv and a linear, its class
embedding a bare vector under no ``w``, kept as it is), with numpy
leaves (``np.asarray`` of each JAX array), and returns the same trees as
torch tensors in the port's
layout: conv kernels HWIO -> OIHW, linear kernels ``[in, out]`` ->
``[out, in]``, embeddings unchanged. The JAX pipeline's packed attention
projections (``attn1.qkv``, ``attn2.kv``: ``w [in, S, out]``, ``b [S, out]``)
become the port's ``w [S, out, in]``, their biases as they are. With it
both packages compute the same function on the same weights, which is what
the tests compare.
"""

from __future__ import annotations

import numpy as np
import torch

_EMBEDDINGS = ("token_embedding", "position_embedding")
_PACKED = ("qkv", "kv")


def _leaf(arr, *, key: str, parent: str):
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    if key == "w" and parent not in _EMBEDDINGS:
        if t.ndim == 4:  # HWIO -> OIHW
            return t.permute(3, 2, 0, 1).contiguous()
        if t.ndim == 2:  # [in, out] -> [out, in]
            return t.t().contiguous()
        if t.ndim == 3 and parent in _PACKED:  # [in, S, out] -> [S, out, in]
            return t.permute(1, 2, 0).contiguous()
    return t


def _convert(tree, parent: str = ""):
    if isinstance(tree, dict):
        return {k: (_convert(v, k) if isinstance(v, (dict, list))
                    else _leaf(v, key=k, parent=parent)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, parent) for v in tree]
    raise TypeError(f"unexpected node {type(tree)} under {parent!r}")


def from_jax_numpy(tree):
    """Convert one parameter tree (text, CLIP image tower, UNet, VAE decoder
    or encoder, ControlNet) to the port's layout."""
    return _convert(tree)
