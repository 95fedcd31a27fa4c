"""LoRA adapters: safetensors -> weights merged in place (port of ``dreamlab_tpu/lora.py``).

A merged weight is ``W' = W + scale * (alpha / rank) * up @ down``, computed
in fp32 and cast back to the leaf's dtype, the JAX package's arithmetic.
The port keeps torch's ``[out, in]`` layout for linears (``layers.linear``
is ``F.linear``), so the delta is ``up @ down`` with no transpose. Adapter
paths name the unpacked projections (``...attn1.q``); in a packed tree
(``models/unet.py::pack_attention_params``, the pipeline's layout) ``leaf``
resolves such a path to its slot of the packed leaf, ``w[slot]``, a view
of the packed weight, so a merge reads and writes the slot in place, as the
JAX package's ``_merged_w_slot`` writes ``w[:, slot]``.

A bucket's CUDA graph reads the weights at the addresses it captured, so a
merge is written into the live leaves (``write_leaves``, ``copy_``), never
swapped in as a new tree; ``merged_leaves`` computes the values from given
base values, so a style is always merged from the unstyled weights.

Key dialects:

- diffusers / PEFT: ``unet.down_blocks.0....attn1.to_q.lora_A.weight``
- kohya: ``lora_unet_down_blocks_0_..._attn1_to_q.lora_down.weight``

Text-encoder adapters (``lora_te*_`` / ``text_encoder.``) go to
``LoRATensors.text``, which mode LoRAs merge into the first text tower.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Callable, Dict, Optional, Tuple

import torch

from .models.unet import PACK_SLOTS
from .utils.safetensors import load_file

logger = logging.getLogger(__name__)

Module = Tuple[torch.Tensor, torch.Tensor, float]  # (down [r, in], up [out, r], alpha)


@dataclasses.dataclass
class LoRATensors:
    """One adapter: tree path -> (down [r, in], up [out, r], alpha)."""

    unet: Dict[str, Module]
    text: Dict[str, Module]

    @property
    def num_modules(self) -> int:
        return len(self.unet) + len(self.text)


# ---------------------------------------------------------------------------
# key translation
# ---------------------------------------------------------------------------

_LEAF_MAP = {
    "to_q": "q",
    "to_k": "k",
    "to_v": "v",
    "to_out.0": "out",
    "ff.net.0.proj": "ff_geglu",
    "ff.net.2": "ff_out",
    "proj_in": "proj_in",
    "proj_out": "proj_out",
    "q_proj": "q",
    "k_proj": "k",
    "v_proj": "v",
    "out_proj": "out",
    "fc1": "fc1",
    "fc2": "fc2",
}


def _module_to_tree_path(module: str) -> Optional[str]:
    """A diffusers module path -> the parameter tree's path (dot-form)."""
    m = module
    m = m.replace("mid_block.attentions.0", "mid.attention")
    m = re.sub(r"down_blocks\.(\d+)", r"down.\1", m)
    m = re.sub(r"up_blocks\.(\d+)", r"up.\1", m)
    m = re.sub(r"transformer_blocks\.(\d+)", r"blocks.\1", m)
    m = re.sub(r"text_model\.encoder\.layers\.(\d+)", r"layers.\1", m)
    m = m.replace("self_attn.", "attn.")
    for suffix, leaf in _LEAF_MAP.items():
        if m.endswith("." + suffix):
            return m[: -len(suffix)] + leaf
    return None


def _normalize_kohya(key: str) -> str:
    """kohya underscores -> diffusers dots: container separators become
    dots; module-name underscores (down_blocks, to_q, ...) stay."""
    for pat, rep in (
        (r"^lora_unet_", ""),
        (r"^lora_te\d?_text_model_encoder_layers_(\d+)_", r"text_model.encoder.layers.\1."),
        (r"(down|up)_blocks_(\d+)_", r"\1_blocks.\2."),
        (r"mid_block_", "mid_block."),
        (r"attentions_(\d+)_", r"attentions.\1."),
        (r"resnets_(\d+)_", r"resnets.\1."),
        (r"transformer_blocks_(\d+)_", r"transformer_blocks.\1."),
        (r"attn(\d)_", r"attn\1."),
        (r"to_out_0$", "to_out.0"),
        (r"ff_net_0_proj$", "ff.net.0.proj"),
        (r"ff_net_2$", "ff.net.2"),
        (r"self_attn_(q|k|v|out)_proj$", r"self_attn.\1_proj"),
        (r"mlp_fc(\d)$", r"mlp.fc\1"),
    ):
        key = re.sub(pat, rep, key)
    return key


def load_lora(path: str) -> LoRATensors:
    """Parse a LoRA safetensors file; its tensors are read in key order, the
    order in which the ``safetensors`` package hands them to the JAX
    package (where two keys reach one path, the later one wins there too)."""
    return parse_lora_state_dict(dict(sorted(load_file(path).items())))


def parse_lora_state_dict(raw: Dict[str, torch.Tensor]) -> LoRATensors:
    mods: Dict[str, Dict[str, torch.Tensor]] = {}
    alphas: Dict[str, float] = {}
    for key, tensor in raw.items():
        if key.endswith(".alpha"):
            alphas[key[: -len(".alpha")]] = float(tensor)
            continue
        for tag, slot in ((".lora_A.weight", "down"), (".lora_down.weight", "down"),
                          (".lora_B.weight", "up"), (".lora_up.weight", "up")):
            if key.endswith(tag):
                mods.setdefault(key[: -len(tag)], {})[slot] = tensor
                break

    unet: Dict[str, Module] = {}
    text: Dict[str, Module] = {}
    skipped = 0
    for module, parts in mods.items():
        if "down" not in parts or "up" not in parts:
            skipped += 1
            continue
        is_text = module.startswith(("lora_te", "text_encoder"))
        norm = _normalize_kohya(module) if module.startswith("lora_") else module
        norm = norm.replace("unet.", "", 1).replace("text_encoder.", "", 1)
        tree_path = _module_to_tree_path(norm)
        if tree_path is None:
            skipped += 1
            continue
        down, up = parts["down"], parts["up"]
        if down.ndim == 4:  # 1x1 conv adapters
            down, up = down[:, :, 0, 0], up[:, :, 0, 0]
        if down.ndim != 2:
            skipped += 1
            continue
        rank = down.shape[0]
        (text if is_text else unet)[tree_path] = (down, up, alphas.get(module, float(rank)))
    if skipped:
        logger.warning("lora: skipped %d unsupported modules", skipped)
    return LoRATensors(unet=unet, text=text)


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------


def _tree_get(tree, path: str):
    node = tree
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def leaf(params, path: str) -> Optional[torch.Tensor]:
    """The weight tensor at ``path`` of a parameter tree, or None. A q/k/v
    path whose site is packed gives its slot of the packed weight (a view:
    writing it writes the packed leaf)."""
    try:
        return _tree_get(params, path)["w"]
    except (KeyError, IndexError, TypeError, ValueError):
        pass
    site, _, name = path.rpartition(".")
    try:
        node = _tree_get(params, site)
    except (KeyError, IndexError, TypeError, ValueError):
        return None
    for packed, slots in PACK_SLOTS.items():
        if isinstance(node, dict) and packed in node and name in slots:
            return node[packed]["w"][slots[name]]
    return None


def merged_leaves(params, modules: Dict[str, Module], scale: float,
                  base: Optional[Dict[str, torch.Tensor]] = None,
                  shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                  ) -> Dict[str, torch.Tensor]:
    """{path: merged weight} for each adapter module whose leaf ``params``
    has, merged from ``base[path]`` where given, else from the live leaf;
    new tensors in each leaf's dtype, on its device. ``shard(leaf path,
    delta)`` gives the part of the whole delta a tensor-parallel rank's
    leaf holds (``LCMPipeline.unet_leaf_slice``). A path the tree lacks
    warns and is skipped; a shape that does not fit raises, before any
    leaf is written. Scale 0 merges nothing."""
    out: Dict[str, torch.Tensor] = {}
    if not modules or scale == 0.0:
        return out
    for path, (down, up, alpha) in modules.items():
        w = leaf(params, path)
        if w is None:
            logger.warning("lora: path %s not found in params", path)
            continue
        src = w if base is None else base[path]
        eff = scale * (alpha / down.shape[0])
        delta = torch.matmul(up.to(w.device, torch.float32), down.to(w.device, torch.float32))
        if shard is not None:
            delta = shard(f"{path}.w", delta)
        if delta.shape != w.shape:
            raise ValueError(f"lora: {path} delta {tuple(delta.shape)} does not fit the "
                             f"weight {tuple(w.shape)}")
        out[path] = (src.float() + eff * delta).to(w.dtype)
    return out


def write_leaves(params, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into the live leaves (or packed slots) of ``params``
    (same addresses)."""
    with torch.no_grad():
        for path, v in values.items():
            leaf(params, path).copy_(v)


def merge_lora_into_tree(params, modules: Dict[str, Module], scale: float,
                         shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                         ) -> int:
    """Merge an adapter's modules into ``params`` in place (every value is
    computed before any leaf is written; ``shard`` as for
    ``merged_leaves``). Returns the leaves written."""
    values = merged_leaves(params, modules, scale, shard=shard)
    write_leaves(params, values)
    return len(values)


# ---------------------------------------------------------------------------
# styles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StyleDef:
    """A named, exclusive style backed by one LoRA file with a strength ladder."""

    name: str
    path: str
    strengths: Tuple[float, ...] = (0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8)
    required_cross_attention_dim: Optional[int] = None

    def strength_for_level(self, level: int) -> float:
        """1-indexed ladder; level 0 = off."""
        if level <= 0:
            return 0.0
        return self.strengths[min(level, len(self.strengths)) - 1]


def parse_style_request(style: Optional[str], level) -> Tuple[Optional[str], int]:
    """Validate a style request: (style name or None, level), the level
    clamped to [0, 8]; no style or level 0 is (None, 0)."""
    try:
        lvl = int(level)
    except (TypeError, ValueError):
        lvl = 0
    lvl = max(0, min(8, lvl))
    if not style or lvl == 0:
        return None, 0
    return str(style), lvl
