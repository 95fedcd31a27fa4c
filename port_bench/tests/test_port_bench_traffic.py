"""The arrival schedule and the prompts come from the seed alone; the seed
changes the order of the work, not the work."""

import numpy as np
import pytest

from port_bench import traffic, vocab
from port_bench.tests import tiny

BIG = 2**33 + 12345  # seeds past 32 bits


def _words(seed):
    return vocab.make(traffic.stream(seed, "vocab"))[0]


@pytest.mark.parametrize("name", ["serial-512", "serial-1024", "poisson-sd15-512",
                                  "poisson-sdxl-1024", "burst8x2-512"])
def test_schedule_is_deterministic_from_the_seed(name):
    mix = traffic.load(name)
    a = traffic.schedule(mix, BIG, 30, _words(BIG))
    b = traffic.schedule(mix, BIG, 30, _words(BIG))
    c = traffic.schedule(mix, BIG + 1, 30, _words(BIG + 1))
    assert [(r.due_s, r.prompt, r.seed) for r in a] == [(r.due_s, r.prompt, r.seed) for r in b]
    assert [r.seed for r in a] != [r.seed for r in c]
    if mix["loop"] == "open":  # the same work for every seed
        gaps = lambda reqs: np.sort(np.diff([0.0] + [r.due_s for r in reqs]))
        np.testing.assert_allclose(gaps(a), gaps(c), atol=1e-9)
    assert len({r.seed for r in a}) == len(a)
    assert all(0 <= r.seed <= 2**31 - 1 for r in a)


def test_open_loop_seeds_share_the_work():
    mix = traffic.load("poisson-sd15-512")
    gaps = [np.diff([0.0] + [r.due_s for r in traffic.schedule(mix, s, 30, _words(s))])
            for s in (1, BIG)]
    assert len(gaps[0]) == len(gaps[1]) == round(mix["rate_per_s"] * 30)
    np.testing.assert_allclose(np.sort(gaps[0]), np.sort(gaps[1]))
    assert not np.allclose(gaps[0], gaps[1])
    assert gaps[0].sum() < 30


def test_bursts_share_a_prompt_and_take_consecutive_seeds():
    mix = traffic.load("burst8x2-512")
    reqs = traffic.schedule(mix, BIG, 5, _words(BIG))
    for i in range(0, 32, mix["burst"]):
        burst = reqs[i:i + mix["burst"]]
        assert len({r.prompt for r in burst}) == 1 and len({(r.client, r.burst) for r in burst}) == 1
        assert [r.seed for r in burst] == list(range(burst[0].seed, burst[0].seed + mix["burst"]))


def test_the_programs_bpe_gives_the_references_ids():
    from dreamlab_tpu_torch.utils.tokenizer import CLIPTokenizer

    words, voc, merges = vocab.make(traffic.stream(BIG, "vocab"))
    assert len(voc) == vocab.VOCAB_SIZE and voc[vocab.EOS] == vocab.VOCAB_SIZE - 1
    mix = tiny.mix("poisson-sd15-512")
    prompts = [r.prompt for r in traffic.schedule(mix, BIG, 10, words)][:40]
    for pad_token, pad_id in ((None, vocab.VOCAB_SIZE - 1), ("!", 0)):
        tok = CLIPTokenizer(voc, merges, pad_token=pad_token)
        got = tok(prompts)
        want = np.stack([vocab.ids(voc, p, pad_id) for p in prompts])
        np.testing.assert_array_equal(got, want)
