"""A CLIP-sized BPE vocabulary made from the seed, and the plain tokenizer
that the reference reads it with.

The real BPE merges of CLIP are not in the repository, so the benchmark
makes a vocabulary of the published size (49408: the byte alphabet and its
word-final forms, the words' merge chains, filler, then BOS 49406 and EOS
49407, as in CLIP's) with merges that build each word of a seeded word list
left to right. A word starts with a letter of ``FIRST`` and goes on with
letters of ``REST``, so the only merge BPE can apply to a word is the one
that extends its leftmost piece: every word ends as one token, the token
``word</w>``. Prompts made of these words are what the traffic sends, and
the reference tokenizes them by looking each word up, which the program's
BPE has to agree with.

Imports only the standard library and numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

VOCAB_SIZE = 49408
BOS, EOS = "<|startoftext|>", "<|endoftext|>"
CONTEXT = 77
FIRST = "abcdefghijklm"
REST = "nopqrstuvwxyz"
WORDS = 4096
WORD_LEN = (3, 9)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable byte alphabet (CLIP's)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def make(rng: np.random.Generator) -> Tuple[List[str], Dict[str, int], List[str]]:
    """(words, vocab token -> id, merges) of one run."""
    words: List[str] = []
    seen = set()
    while len(words) < WORDS:
        n = int(rng.integers(WORD_LEN[0], WORD_LEN[1] + 1))
        w = FIRST[int(rng.integers(len(FIRST)))] + "".join(
            REST[i] for i in rng.integers(0, len(REST), size=n - 1))
        if w not in seen:
            seen.add(w)
            words.append(w)
    alphabet = sorted(set(_bytes_to_unicode().values()))
    vocab: Dict[str, int] = {}
    for ch in alphabet:
        vocab[ch] = len(vocab)
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    merges: List[str] = []
    made = set()
    for w in words:
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        prefix = pieces[0]
        for nxt in pieces[1:]:
            if (prefix, nxt) not in made:
                made.add((prefix, nxt))
                merges.append(f"{prefix} {nxt}")
            prefix += nxt
            vocab.setdefault(prefix, len(vocab))
    if len(vocab) > VOCAB_SIZE - 2:
        raise ValueError(f"{len(vocab)} tokens leave no room for BOS and EOS")
    for i in range(VOCAB_SIZE - 2 - len(vocab)):
        vocab[f"<|fill_{i}|>"] = len(vocab)
    vocab[BOS] = VOCAB_SIZE - 2
    vocab[EOS] = VOCAB_SIZE - 1
    return words, vocab, merges


def ids(vocab: Dict[str, int], prompt: str, pad_id: int) -> np.ndarray:
    """int64 [77]: BOS, one token a word, EOS, padding (the reference's
    tokenizer; prompts are words of the list joined by single spaces)."""
    toks = [vocab[BOS]] + [vocab[w + "</w>"] for w in prompt.split(" ")] + [vocab[EOS]]
    if len(toks) > CONTEXT:
        raise ValueError(f"prompt of {len(toks)} tokens exceeds {CONTEXT}")
    out = np.full(CONTEXT, pad_id, np.int64)
    out[:len(toks)] = toks
    return out
