"""The port's tokenizer (stdlib ``re``) against the JAX package's (``regex``).

Ids must be equal: the port builds the \\p{L} / \\p{N} classes from
``unicodedata``, so letters, numbers and everything else split the same way.
"""

import json

import numpy as np
import pytest

from dreamlab_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from dreamlab_tpu.utils.tokenizer import make_test_tokenizer as jax_make
from dreamlab_tpu_torch.utils.tokenizer import CLIPTokenizer, make_test_tokenizer

WORDS = ["cat", "dog", "sunset", "mountain", "it's"]

PROMPTS = [
    "a cat at sunset",
    "A Mountain, at DAWN; with dogs!",
    "the dog's toy isn't here, we'll see what they've done, I'm sure you're right, he'd go",
    "3 cats and 42 dogs, 4.5 stars -- 100%",
    "   lots   of\twhite\nspace   ",
    "café naïve résumé ½ 東京 ١٢٣ Ⅻ x² ﬁne ß İstanbul ǅ",
    "emoji 🐱🐶 — “curly quotes” ‘single’ …",
    "",
    " ".join(["mountain"] * 90),  # truncated at 77 tokens
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_match_jax(prompt):
    got = make_test_tokenizer(WORDS)(prompt)
    want = jax_make(WORDS)(prompt)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batch_and_from_pretrained_match_jax(tmp_path):
    jtok = jax_make(WORDS)
    (tmp_path / "vocab.json").write_text(json.dumps(jtok.encoder))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        " ".join(p) for p in sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get)) + "\n")
    got = CLIPTokenizer.from_pretrained(str(tmp_path))(PROMPTS)
    want = JaxTokenizer.from_pretrained(str(tmp_path))(PROMPTS)
    np.testing.assert_array_equal(got, want)
