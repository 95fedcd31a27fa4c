"""Textual-inversion embeddings: trigger words backed by learned vectors
(port of ``dreamlab_tpu/textual_inversion.py``).

A ``.safetensors`` embedding file adds one trigger word to the tokenizer,
mapping to k learned vectors that are appended as new rows of a text
tower's token-embedding table. It is applied to a ``PipelineBundle`` before
``LCMPipeline`` places the weights, so the enlarged table is what the card
holds. The text tower finds EOS by equality with ``vocab_size - 1``, so the
appended ids never move the pooled position.

File layouts (safetensors only, read by the port's own reader):

- A1111: ``{"emb_params": [k, C]}``
- diffusers: ``{"<token>": [k, C]}`` (one key, any name)
- SDXL dual: ``{"clip_l": [k, C1], "clip_g": [k, C2]}``

The trigger word defaults to the file's stem, lowercased.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

from .utils.safetensors import load_file

logger = logging.getLogger(__name__)


def load_embedding_file(path: str) -> Dict[str, torch.Tensor]:
    """{slot: [k, C] fp32}: slot 'clip_l' / 'clip_g' for SDXL dual files, the
    single key or 'emb_params' as 'clip_l'."""
    raw = load_file(path)
    as_rows = lambda t: torch.atleast_2d(t.float())
    if "clip_l" in raw or "clip_g" in raw:
        return {k: as_rows(raw[k]) for k in ("clip_l", "clip_g") if k in raw}
    if "emb_params" in raw:
        return {"clip_l": as_rows(raw["emb_params"])}
    if len(raw) == 1:
        return {"clip_l": as_rows(next(iter(raw.values())))}
    raise ValueError(f"{path}: unrecognized textual-inversion layout (keys: {sorted(raw)})")


def trigger_word(path: str, override: Optional[str] = None) -> str:
    return (override or os.path.splitext(os.path.basename(path))[0]).lower()


def _extend_tower(params, vectors: torch.Tensor) -> Tuple[dict, List[int]]:
    """A copy of a text tower's tree with k rows appended to its token
    embedding table, and the new rows' token ids."""
    table = params["token_embedding"]["w"]
    k, c = vectors.shape
    if c != table.shape[1]:
        raise ValueError(f"embedding width {c} != tower width {table.shape[1]}")
    new_ids = list(range(table.shape[0], table.shape[0] + k))
    merged = torch.cat([table, vectors.to(table.dtype).to(table.device)])
    return {**params, "token_embedding": {**params["token_embedding"], "w": merged}}, new_ids


def apply_embeddings(bundle, entries) -> int:
    """Merge textual-inversion files into a ``PipelineBundle`` in place.

    entries: objects with ``.file`` (a path) and an optional ``.name``
    (the trigger), or plain paths. Each slot goes to the tower whose width
    matches: a refiner bundle has one (bigG-width) tower, so a dual file's
    ``clip_g`` half applies there and its ``clip_l`` half is dropped. A
    file's updates are staged and committed together, only if at least one
    slot lands and none fails: no orphan rows. A missing or incompatible
    file warns and is skipped. Returns the number applied.
    """
    applied = 0
    for entry in entries or []:
        path = getattr(entry, "file", entry)
        name = getattr(entry, "name", None)
        try:
            slots = load_embedding_file(path)
            word = trigger_word(path, name)
            towers = [("text_params", bundle.tokenizer)]
            if bundle.text_params_2 is not None:
                towers.append(("text_params_2", bundle.tokenizer_2))
            widths = {attr: getattr(bundle, attr)["token_embedding"]["w"].shape[1]
                      for attr, _ in towers}
            staged, unmatched = [], []  # staged: (attr, new params, ids, tokenizer)
            for slot, vectors in slots.items():
                target = next(((attr, tok) for attr, tok in towers
                               if widths[attr] == vectors.shape[1]
                               and all(a != attr for a, _, _, _ in staged)), None)
                if target is None:
                    unmatched.append(slot)
                    continue
                attr, tok = target
                new_params, ids = _extend_tower(getattr(bundle, attr), vectors)
                staged.append((attr, new_params, ids, tok))
            if not staged:
                raise ValueError(f"no tower matches embedding widths "
                                 f"{[v.shape[1] for v in slots.values()]} "
                                 f"(towers: {sorted(widths.values())})")
            for attr, new_params, ids, tok in staged:
                setattr(bundle, attr, new_params)
                if tok is not None:
                    tok.add_trigger(word, ids)
            if unmatched:
                logger.info("textual inversion %r: slots %s have no matching tower in this "
                            "bundle; skipped", word, unmatched)
            logger.info("textual inversion %r: %d vector(s) from %s", word,
                        max(len(ids) for _, _, ids, _ in staged), path)
            applied += 1
        except Exception as e:  # warn and skip, as for mode LoRAs
            logger.warning("textual inversion %s not applied (%s)", path, e)
    return applied
