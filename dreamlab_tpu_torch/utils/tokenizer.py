"""Self-contained CLIP BPE tokenizer (port of ``dreamlab_tpu/utils/tokenizer.py``).

The JAX package's copy matches words with the third-party ``regex`` module
(``\\p{L}`` / ``\\p{N}``). This one uses the standard library's ``re``, which
has no ``\\p{..}``; ``[^\\W\\d_]`` is not ``\\p{L}`` either (``'½'`` is ``\\w``
but not a letter). So the letter (L*) and number (N*) classes are built once
from ``unicodedata.category``, as explicit code-point ranges.

CLIP specifics: byte-level BPE over GPT-2's printable byte alphabet,
lowercasing and whitespace collapse, word-final ``</w>``, specials
``<|startoftext|>`` / ``<|endoftext|>``, pad-to-77 with the checkpoint's
declared pad token (EOS where it declares none), and truncation at 77
tokens with a warning.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _class_ranges(major: str) -> str:
    """Character-class body matching every code point of Unicode category major*."""
    parts, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            elif cp != prev + 1:
                parts.append((start, prev))
                start = cp
            prev = cp
    parts.append((start, prev))
    esc = lambda cp: f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in parts)


@lru_cache()
def _word_pattern() -> "re.Pattern":
    letters, numbers = _class_ranges("L"), _class_ranges("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE,
    )


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class CLIPTokenizer:
    """BPE tokenizer for CLIP text towers.

    Args:
        vocab: token string -> id.
        merges: ordered list of merge pairs ("a b" per line).
        max_length: model context (77).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[str], max_length: int = 77,
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 pad_token: Optional[str] = None):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos_id = self.encoder[bos_token]
        self.eos_id = self.encoder[eos_token]
        # CLIP pads with EOS
        self.pad_id = self.encoder[pad_token] if pad_token else self.eos_id
        self._cache: Dict[str, List[str]] = {}
        # textual-inversion triggers: lowercased word -> learned token ids
        self.triggers: Dict[str, List[int]] = {}

    def add_trigger(self, word: str, ids: List[int]) -> None:
        """Map a whole word to explicit token ids (textual inversion): the
        word bypasses BPE and expands to its learned vectors' ids."""
        self.triggers[word.lower()] = list(ids)

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str, **kwargs) -> "CLIPTokenizer":
        """Load a diffusers-layout ``tokenizer/`` directory (vocab.json, merges.txt).

        The pad token is the checkpoint's declared one (``tokenizer_config.json``
        ``pad_token``, else ``special_tokens_map.json``; a plain string or an
        ``AddedToken`` dict): SDXL's ``tokenizer_2`` pads with "!" (id 0).
        Without a declared pad token in the vocabulary, CLIP pads with EOS.
        """
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [line for line in lines if line and not line.startswith("#")]

        def special(v):
            return v.get("content") if isinstance(v, dict) else v

        pad = None
        cfg_path = os.path.join(tokenizer_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            kwargs.setdefault("max_length", cfg.get("model_max_length", 77) or 77)
            pad = special(cfg.get("pad_token"))
        if pad is None:
            map_path = os.path.join(tokenizer_dir, "special_tokens_map.json")
            if os.path.exists(map_path):
                with open(map_path, encoding="utf-8") as f:
                    pad = special(json.load(f).get("pad_token"))
        if pad is not None and pad in vocab:
            kwargs.setdefault("pad_token", pad)
        return cls(vocab, merges, **kwargs)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids, no specials. Trigger words match whole whitespace
        words (trailing ",.;:!?" tolerated) before the BPE word pattern,
        which would split names such as "style2" or "my-style"."""
        text = " ".join(text.split()).strip().lower()
        if not self.triggers:
            return self._bpe_ids(text)
        ids: List[int] = []
        for chunk in text.split(" "):
            stripped = chunk.rstrip(",.;:!?")
            if stripped in self.triggers:
                ids.extend(self.triggers[stripped])
                chunk = chunk[len(stripped):]  # tokenize the punctuation
                if not chunk:
                    continue
            ids.extend(self._bpe_ids(chunk))
        return ids

    def _bpe_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _word_pattern().findall(text):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(btok):
                pid = self.encoder.get(piece)
                if pid is None:
                    # unknown pieces degrade to per-character lookups
                    ids.extend(self.encoder.get(ch, self.eos_id) for ch in piece)
                else:
                    ids.append(pid)
        return ids

    def __call__(self, text, *, max_length: Optional[int] = None) -> np.ndarray:
        """Encode prompt(s) -> int32 [B, max_length] with BOS/EOS/pad; over-long
        prompts truncate (keeping the final EOS) with a warning."""
        if isinstance(text, str):
            text = [text]
        n = max_length or self.max_length
        batch = np.full((len(text), n), self.pad_id, dtype=np.int32)
        for row, prompt in enumerate(text):
            ids = self.tokenize(prompt)
            if len(ids) > n - 2:
                logger.warning("Prompt truncated to %d tokens (%d removed): %r",
                               n, len(ids) - (n - 2), prompt[:80])
                ids = ids[: n - 2]
            seq = [self.bos_id] + ids + [self.eos_id]
            batch[row, : len(seq)] = seq
        return batch


def make_test_tokenizer(words: Optional[List[str]] = None,
                        pad_token: Optional[str] = None) -> CLIPTokenizer:
    """Tiny synthetic tokenizer for the hardware-free tests: full byte
    alphabet + ``</w>`` variants + merges for a few known words; pads with
    ``pad_token`` (SDXL's second tokenizer: "!", id 0) or EOS."""
    alphabet = sorted(set(_bytes_to_unicode().values()))
    vocab: Dict[str, int] = {}
    for ch in alphabet:
        vocab[ch] = len(vocab)
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    merges: List[str] = []
    for w in words or []:
        # build each word left-to-right: (ab, c), (abc, d)...
        chars = list(w[:-1]) + [w[-1] + "</w>"]
        prefix = chars[0]
        for nxt in chars[1:]:
            merges.append(f"{prefix} {nxt}")
            prefix += nxt
            if prefix not in vocab:
                vocab[prefix] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, merges, pad_token=pad_token)
