"""Yume on the port (``dreamlab_tpu_torch/yume``) against the JAX package's
(``dreamlab_tpu/yume``) on the CPU: the cases of ``tests/test_yume.py`` and
``tests/test_clip_vision.py``'s scorer, held to the reference.

- strategies: each one's seed sequence equal to the JAX package's from the
  same ``RandomState`` and the same scores;
- scorers: equal on the same images; ``CLIPScorer`` over both packages'
  ``NativeCLIP`` on the same weights within 1e-5;
- candidates: a batched candidate equal to its solo ``run_job`` (decoded),
  within ``tests/test_golden.py``'s pixel bound (+-1, under 1 % of pixels) of
  the JAX package's; also while a styled request holds the worker;
- a session end to end (finalize renders), scoring off the event loop;
- the Redis records on ``tests/test_persistence.py::FakeRedis`` equal to what
  the JAX worker writes;
- the scorer ladder: native CLIP, transformers, heuristic.

``_prompt_variations`` seeds from ``hash(base)``, which Python salts per
process: the two packages are compared within this process only. Sessions
are waited on by a count of candidates, never by a sleep.
"""

import asyncio
import dataclasses
import os
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
from dreamlab_tpu.models import clip_text as jclip_text
from dreamlab_tpu.models import clip_vision as jclip_vision
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu.utils.resp import RespClient as JaxResp
from dreamlab_tpu.utils.tokenizer import make_test_tokenizer as jax_test_tokenizer
from dreamlab_tpu.yume import dream_init as jinit
from dreamlab_tpu.yume import dream_worker as jdw
from dreamlab_tpu.yume import scoring as jscoring
from dreamlab_tpu.yume import strategies as jstrat
from dreamlab_tpu_torch import lora, testing
from dreamlab_tpu_torch.convert import from_jax_numpy
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.utils.png import decode_png
from dreamlab_tpu_torch.utils.resp import RespClient
from dreamlab_tpu_torch.utils.safetensors import save_file
from dreamlab_tpu_torch.utils.tokenizer import make_test_tokenizer
from dreamlab_tpu_torch.yume import dream_init, scoring, strategies
from dreamlab_tpu_torch.yume import dream_worker as dw
from tests.test_persistence import FakeRedis
from tests.test_torch_port_img2img import one_torch_thread, port_bundle_of  # noqa: F401
from tests.test_yume import FakeCLIP

TIMEOUT = 120
SMALL = dict(candidate_size="32x32", candidate_steps=1, render_size="32x32", render_steps=2)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def assert_pixels_close(a, b):
    """tests/test_golden.py's bound: +-1 level, under 1 % of pixels moved."""
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


@pytest.fixture(scope="module")
def tiny():
    jb = jax_random_bundle("sd15", tiny=True)
    jpipe = JaxPipeline(jb, dtype=jnp.float32)
    tpipe = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
    return jb, TPUPipelineWorker(jpipe, 0), CudaPipelineWorker(tpipe, 0)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

STRATEGIES = [
    ("random", {}), ("linear", {}), ("linear", {"stride": 7}), ("grid", {}),
    ("grid", {"rows": 3, "cols": 5}), ("evolutionary", {}),
    ("evolutionary", {"population_size": 8, "mutation_range": 10}), ("temperature", {}),
    ("temperature", {"initial_temp": 0.2, "decay": 0.5, "min_temp": 0.01}), ("cluster", {}),
    ("cluster", {"num_clusters": 2, "radius": 100, "explore_prob": 0.1}),
]


@pytest.mark.parametrize("name,kwargs", STRATEGIES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}"
                              for n, k in STRATEGIES])
def test_strategy_seed_sequence_equals_jax(name, kwargs):
    seqs = []
    for mod in (strategies, jstrat):
        s = mod.get_strategy(name, rng=np.random.RandomState(0), **kwargs)
        scores = np.random.RandomState(1).rand(80)
        seq = []
        for score in scores:
            seed = s.next_seed()
            assert 0 <= seed < strategies.MAX_SEED
            s.record_score(seed, float(score))
            seq.append(seed)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert len(set(seqs[0])) > 5  # explores


def test_get_strategy_unknown_raises_as_jax():
    with pytest.raises(ValueError) as got:
        strategies.get_strategy("bogus")
    with pytest.raises(ValueError) as want:
        jstrat.get_strategy("bogus")
    assert str(got.value) == str(want.value)


def test_evolutionary_crossover_biases_toward_elites():
    s = strategies.EvolutionaryStrategy(rng=np.random.RandomState(0), population_size=8,
                                        mutation_range=10)
    for seed in range(8):
        s.record_score(seed * 1000 + 100_000_000, seed / 8.0)
    assert all(90_000_000 < s.next_seed() < 110_008_000 for _ in range(20))


def test_temperature_converges_to_best():
    s = strategies.TemperatureScheduleStrategy(rng=np.random.RandomState(0), initial_temp=0.2,
                                               decay=0.5, min_temp=0.01)
    s.record_score(500_000_000, 0.99)
    near = sum(1 for _ in range(50)
               if abs(s.next_seed() - 500_000_000) < strategies.MAX_SEED * 0.011)
    assert near > 40


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------


def _images():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (32, 32, 3), np.uint8), np.full((32, 32, 3), 128, np.uint8),
            rs.randint(0, 256, (40, 56, 3), np.uint8), rs.randint(0, 256, (24, 24), np.uint8)]


def test_aesthetic_scores_equal_jax():
    got, want = scoring.AestheticScorer(), jscoring.AestheticScorer()
    imgs = _images()
    assert got.score_batch(imgs) == want.score_batch(imgs)
    assert got.score(imgs[0]) > got.score(imgs[1])  # sharper scores higher


def test_composite_scores_equal_jax():
    class Const:
        def __init__(self, v):
            self.v = v

        def score(self, image, prompt=""):
            return self.v

        def score_batch(self, images, prompt=""):
            return [self.v] * len(images)

    imgs = _images()
    for weights in ([3, 1], None):
        got = scoring.CompositeScorer([Const(1.0), scoring.AestheticScorer()], weights)
        want = jscoring.CompositeScorer([Const(1.0), jscoring.AestheticScorer()], weights)
        assert got.score_batch(imgs, "x") == want.score_batch(imgs, "x")
        assert got.score(imgs[0]) == want.score(imgs[0])
    assert scoring.CompositeScorer([Const(1.0), Const(0.0)], [3, 1]).score(None) == \
        pytest.approx(0.75)


def test_clip_scorer_over_a_fake_model_equals_jax():
    model = FakeCLIP()
    got, want = scoring.CLIPScorer(model), jscoring.CLIPScorer(model)
    imgs = _images()[:3]
    assert got.score_batch(imgs, "a cat") == want.score_batch(imgs, "a cat")
    assert got.score(imgs[0], "a cat") == want.score(imgs[0], "a cat")
    assert "a cat" in got._text_cache and all(0 <= s <= 1 for s in got.score_batch(imgs, "x"))


@pytest.fixture(scope="module")
def native_pair():
    """Both packages' NativeCLIP over the same tiny towers (the port's on the
    CPU, its trees converted from the JAX ones)."""
    words = ["cat", "dream"]
    jtok, ttok = jax_test_tokenizer(words), make_test_tokenizer(words)
    text_cfg = tcfg.CLIPTextConfig(vocab_size=len(ttok.encoder), hidden_size=32, num_layers=2,
                                   num_heads=2, intermediate_size=64, projection_dim=16)
    jtext_cfg = jcfg.CLIPTextConfig(**dataclasses.asdict(text_cfg))
    jtp = jclip_text.init_params(jtext_cfg, np.random.RandomState(0))
    jvp = jclip_vision.init_params(jcfg.TINY_VISION, np.random.RandomState(1))
    jmodel = jscoring.NativeCLIP(text_params=jtp, text_cfg=jtext_cfg, vision_params=jvp,
                                 vision_cfg=jcfg.TINY_VISION, tokenizer=jtok)
    tmodel = scoring.NativeCLIP(text_params=from_jax_numpy(_np_tree(jtp)), text_cfg=text_cfg,
                                vision_params=from_jax_numpy(_np_tree(jvp)),
                                vision_cfg=tcfg.TINY_VISION, tokenizer=ttok, device="cpu")
    return jmodel, tmodel


def test_clip_scorer_over_both_native_clips(native_pair):
    jmodel, tmodel = native_pair
    imgs = _images()
    np.testing.assert_allclose(tmodel.embed_images(imgs), jmodel.embed_images(imgs),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmodel.embed_text("a cat"), jmodel.embed_text("a cat"),
                               rtol=0, atol=1e-5)
    got, want = scoring.CLIPScorer(tmodel), jscoring.CLIPScorer(jmodel)
    for prompt in ("a cat", "a dream"):
        g, w = got.score_batch(imgs, prompt), want.score_batch(imgs, prompt)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        assert all(0.0 <= s <= 1.0 for s in g)
    assert got.score(imgs[0], "a cat") == got.score_batch(imgs, "a cat")[0]
    assert set(got._text_cache) == {"a cat", "a dream"}


def test_native_clip_needs_the_card_unless_cpu(native_pair, monkeypatch):
    _, tmodel = native_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scoring.NativeCLIP(text_params=tmodel._text_params, text_cfg=tmodel.text_cfg,
                           vision_params=tmodel._vision_params, vision_cfg=tmodel.vision_cfg,
                           tokenizer=tmodel.tokenizer)


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def test_prompt_variations_and_candidates_equal_jax(tiny):
    _, jworker, tworker = tiny
    got, want = dw.DreamWorker(tworker), jdw.DreamWorker(jworker)
    for base, temp in (("a forest", 0.0), ("a forest", 1.0), ("a cat", 0.7), ("x", 0.34)):
        assert got._prompt_variations(base, temp) == want._prompt_variations(base, temp)
    assert all(p == "a forest" for p in got._prompt_variations("a forest", 0.0))
    assert any("," in p for p in got._prompt_variations("a forest", 1.0))
    c = dw.DreamCandidate(seed=42, prompt="a cat, at dawn", score=0.123456, created_at=1.5)
    j = jdw.DreamCandidate(seed=42, prompt="a cat, at dawn", score=0.123456, created_at=1.5)
    assert c.candidate_id == j.candidate_id and c.summary() == j.summary()
    assert (dw.CANDIDATE_SIZE, dw.CANDIDATE_STEPS, dw.RENDER_SIZE, dw.RENDER_STEPS) == (
        jdw.CANDIDATE_SIZE, jdw.CANDIDATE_STEPS, jdw.RENDER_SIZE, jdw.RENDER_STEPS)


@pytest.mark.parametrize("steps", [1, 2])
def test_batched_candidates_equal_solo_runs_and_jax(tiny, steps):
    """A batched candidate equals what a solo run_job with its seed gives,
    and the JAX package's batched candidate within the golden pixel bound."""
    _, jworker, tworker = tiny
    seeds = [101, 202, 303]
    got = dw.DreamWorker(tworker, candidate_size="32x32",
                         candidate_steps=steps)._generate_candidates(seeds, "a cat")
    want = jdw.DreamWorker(jworker, candidate_size="32x32",
                           candidate_steps=steps)._generate_candidates(seeds, "a cat")
    assert len(got) == 3
    for seed, img, jimg in zip(seeds, got, want):
        png, _ = tworker.run_job(GenSpec(prompt="a cat", size="32x32",
                                         num_inference_steps=steps, seed=seed))
        np.testing.assert_array_equal(img, decode_png(png))
        assert_pixels_close(img, np.asarray(jimg))


def test_without_a_pipeline_candidates_are_solo_runs(tiny):
    """Any worker: one run_job per seed, its PNG decoded by the port's reader."""
    _, _, tworker = tiny

    class RunJobOnly:
        def run_job(self, spec):
            return tworker.run_job(spec)

    seeds = [7, 8]
    solo = dw.DreamWorker(RunJobOnly(), candidate_size="32x32")._generate_candidates(seeds, "x")
    batched = dw.DreamWorker(tworker, candidate_size="32x32")._generate_candidates(seeds, "x")
    for a, b in zip(solo, batched):
        assert a.dtype == np.uint8 and a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    # one seed takes the solo path on a worker with a pipeline too
    one = dw.DreamWorker(tworker, candidate_size="32x32")._generate_candidates([7], "x")
    np.testing.assert_array_equal(one[0], batched[0])


def test_a_candidate_batch_beside_a_styled_request_is_unstyled(tiny, tmp_path):
    """A styled request merges its LoRA into the live weights under the
    worker's lock; a candidate batch asked for meanwhile waits for the
    restore and comes out as the unstyled solo runs."""
    jb = tiny[0]
    pipe = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
    path = str(tmp_path / "style.safetensors")
    save_file(testing.random_lora(pipe.unet_params, rank=4, seed=3), path)
    worker = CudaPipelineWorker(pipe, 0, styles={
        "s": lora.StyleDef(name="s", path=path, strengths=(4.0,))})
    seeds = [11, 12]
    spec = lambda seed, **kw: GenSpec(prompt="a cat", size="32x32", num_inference_steps=1,
                                      seed=seed, **kw)
    plain = [decode_png(worker.run_job(spec(s))[0]) for s in seeds]
    styled_solo = decode_png(worker.run_job(spec(11, style="s", style_level=1))[0])
    assert not np.array_equal(styled_solo, plain[0])  # the style changes the image

    entered, gate = threading.Event(), threading.Event()
    generate = pipe.generate

    def held(*args, **kwargs):
        if threading.current_thread().name == "styled":
            entered.set()  # the style is merged; hold it there
            assert gate.wait(TIMEOUT)
        return generate(*args, **kwargs)

    pipe.generate = held
    styled = {}
    t = threading.Thread(name="styled", target=lambda: styled.setdefault(
        "png", worker.run_job(spec(11, style="s", style_level=1))[0]))
    t.start()
    try:
        assert entered.wait(TIMEOUT)
        out = {}
        c = threading.Thread(target=lambda: out.setdefault("images", dw.DreamWorker(
            worker, candidate_size="32x32")._generate_candidates(seeds, "a cat")))
        c.start()
        c.join(0.3)
        assert c.is_alive()  # waits on the worker's lock while the style is in
        gate.set()
        c.join(TIMEOUT)
        t.join(TIMEOUT)
        assert not c.is_alive() and not t.is_alive()
    finally:
        gate.set()
        pipe.generate = generate
    for img, want in zip(out["images"], plain):
        np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(decode_png(styled["png"]), styled_solo)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


async def _wait_generated(dream, n):
    t0 = time.monotonic()
    while dream.stats["generated"] < n:
        assert time.monotonic() - t0 < TIMEOUT, dream.get_status()
        await asyncio.sleep(0.01)


def test_dream_session_end_to_end(tiny, monkeypatch):
    """Start, a second start refused, candidates scored, stop: finalize
    renders the top unrendered candidates at the render size, each PNG equal
    to run_job's on its prompt and seed."""
    monkeypatch.setenv("YUME_FINALIZE_RENDERS", "3")
    _, _, tworker = tiny
    dream = dw.DreamWorker(tworker, scorer=scoring.AestheticScorer(), redis=None,
                           render_interval=2, score_threshold=0.0, candidate_batch=2, **SMALL)

    async def run():
        info = await dream.start_dreaming("tiny dream", strategy="random")
        assert info["session_id"].startswith("dream:") and info["prompts"][0] == "tiny dream"
        assert dream.get_status()["running"]
        with pytest.raises(RuntimeError, match="already running"):
            await dream.start_dreaming("again")
        await _wait_generated(dream, 6)
        return await dream.stop_dreaming()

    st = asyncio.run(run())
    assert not st["running"]
    assert st["stats"]["generated"] >= 6 and st["stats"]["scored"] == st["stats"]["generated"]
    assert st["stats"]["kept"] == st["stats"]["generated"]
    assert st["top_count"] == min(20, st["stats"]["generated"])
    top = dream.get_top_dreams(5)
    assert top and all(0 <= t["score"] <= 1 for t in top)
    assert [t["score"] for t in top] == sorted((t["score"] for t in top), reverse=True)
    assert len(dream.get_recent(5)) == 5 and dream.get_recent(100)[0]["seed"] == \
        dream.top[-1].seed
    # every iteration's render (interval 2) plus finalize's 3
    rendered = [c for c in dream.top if c.rendered_png is not None]
    assert st["stats"]["rendered"] >= len(rendered) >= 3
    for cand in rendered[:2]:
        png = dream.get_rendered_png(cand.candidate_id)
        assert png == tworker.run_job(GenSpec(prompt=cand.prompt, size="32x32",
                                              num_inference_steps=2, seed=cand.seed))[0]
    assert dream.get_rendered_png("0" * 16) is None


def test_scoring_runs_off_the_event_loop(tiny, native_pair):
    """A session scores through CLIPScorer over the native towers, and every
    scoring call runs on an executor thread, never on the loop's."""
    _, tmodel = native_pair
    _, _, tworker = tiny
    threads = []

    class Recording(scoring.CLIPScorer):
        def score_batch(self, images, prompt):
            threads.append(threading.get_ident())
            return super().score_batch(images, prompt)

    scorer = Recording(tmodel)
    dream = dw.DreamWorker(tworker, scorer=scorer, redis=None, render_interval=100,
                           score_threshold=0.0, candidate_batch=2, **SMALL)

    async def run():
        await dream.start_dreaming("a tiny dream", strategy="temperature")
        await _wait_generated(dream, 4)
        await dream.stop_dreaming()
        return threading.get_ident()

    os.environ["YUME_FINALIZE_RENDERS"] = "0"
    try:
        loop_thread = asyncio.run(run())
    finally:
        del os.environ["YUME_FINALIZE_RENDERS"]
    assert len(threads) >= 2 and loop_thread not in threads
    assert dream.stats["scored"] == dream.stats["generated"]
    assert scorer._text_cache and all(0 <= t["score"] <= 1 for t in dream.get_top_dreams(3))


# ---------------------------------------------------------------------------
# Redis records
# ---------------------------------------------------------------------------


def test_redis_records_equal_jax(tiny):
    """A kept candidate, then rendered: the hash, the score zset, the PNG key
    and the expiries the JAX worker writes, and the PNG read back through
    Redis once the candidate left the top deque."""
    _, jworker, tworker = tiny
    servers = [FakeRedis(), FakeRedis()]
    for s in servers:
        s.start()
    try:
        workers = []
        for (mod, worker, client), srv in zip(((dw, tworker, RespClient), (jdw, jworker, JaxResp)),
                                              servers):
            dream = mod.DreamWorker(worker, redis=client("127.0.0.1", srv.port))
            dream.session_id = "dream:1700000000"
            cand = mod.DreamCandidate(seed=5, prompt="a cat, at dusk", score=0.4321, created_at=2.0)
            dream._store(cand)
            cand.rendered_png = b"\x89PNG fake"
            dream._store(cand)
            workers.append((dream, cand.candidate_id))
        (got, gid), (want, wid) = workers
        assert gid == wid
        a, b = servers
        assert a.kv == b.kv and a.hashes == b.hashes and a.zsets == b.zsets
        assert a.expiry.keys() == b.expiry.keys() and len(a.expiry) == 3
        key = f"dream:1700000000:{gid}".encode()
        assert a.hashes[key] == {b"seed": b"5", b"prompt": b"a cat, at dusk",
                                 b"score": b"0.4321", b"rendered": b"1"}
        assert got.get_rendered_png(gid) == want.get_rendered_png(wid) == b"\x89PNG fake"
    finally:
        for s in servers:
            s.stop()


def test_a_failing_redis_is_logged_not_raised(tiny):
    _, _, tworker = tiny

    class Down:
        def __getattr__(self, name):
            raise ConnectionError("down")

    dream = dw.DreamWorker(tworker, redis=Down())
    dream.session_id = "dream:1"
    dream._store(dw.DreamCandidate(seed=1, prompt="p", score=0.5))
    assert dream.get_rendered_png("x") is None


# ---------------------------------------------------------------------------
# the scorer ladder
# ---------------------------------------------------------------------------


def _fake_transformers(log):
    mod = types.ModuleType("transformers")

    class Model:
        @classmethod
        def from_pretrained(cls, name):
            log.append(("model", name))
            return cls()

        def to(self, device):
            log.append(("to", str(device)))
            return self

    class Processor:
        @classmethod
        def from_pretrained(cls, name):
            log.append(("processor", name))
            return cls()

    mod.CLIPModel, mod.CLIPProcessor = Model, Processor
    return mod


@pytest.fixture
def clip_dir(tmp_path):
    tok = testing.clip_tokenizer()
    text_cfg = tcfg.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=32, num_layers=2,
                                   num_heads=2, intermediate_size=64, projection_dim=16)
    tp, vp = testing.random_clip(text_cfg, tcfg.TINY_VISION, seed=2)
    return testing.write_clip_dir(str(tmp_path / "clip"), tp, text_cfg, vp, tcfg.TINY_VISION,
                                  tok)


def test_ladder_native_rung_from_a_local_directory(clip_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # transformers absent
    monkeypatch.setenv("YUME_CLIP_MODEL", clip_dir)
    got, want = dream_init._try_clip_scorer("cpu"), jinit._try_clip_scorer()
    assert type(got) is scoring.CLIPScorer and type(got.model) is scoring.NativeCLIP
    assert type(want) is jscoring.CLIPScorer and type(want.model) is jscoring.NativeCLIP
    assert got.model.device.type == "cpu"
    imgs = _images()[:2]
    np.testing.assert_allclose(got.score_batch(imgs, "a cat"), want.score_batch(imgs, "a cat"),
                               rtol=0, atol=1e-5)


def test_ladder_a_directory_that_does_not_load_falls_to_the_heuristic(clip_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    os.remove(os.path.join(clip_dir, "model.safetensors"))
    monkeypatch.setenv("YUME_CLIP_MODEL", clip_dir)
    assert type(dream_init._try_clip_scorer("cpu")) is scoring.AestheticScorer
    assert type(jinit._try_clip_scorer()) is jscoring.AestheticScorer


def test_ladder_transformers_rung_and_without_it_the_heuristic(monkeypatch):
    monkeypatch.setenv("YUME_CLIP_MODEL", "openai/clip-vit-base-patch32")
    log = []
    monkeypatch.setitem(sys.modules, "transformers", _fake_transformers(log))
    got, want = dream_init._try_clip_scorer("cpu"), jinit._try_clip_scorer()
    assert type(got.model) is scoring.HFCLIPAdapter and type(want.model) is jscoring.HFCLIPAdapter
    assert got.model.device.type == "cpu"
    assert ("to", "cpu") in log and ("model", "openai/clip-vit-base-patch32") in log
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert type(dream_init._try_clip_scorer("cpu")) is scoring.AestheticScorer
    assert type(jinit._try_clip_scorer()) is jscoring.AestheticScorer


def test_initialize_dream_system_with_no_redis_stays_in_memory(tiny, clip_dir, monkeypatch):
    """The wiring on the CPU: the native scorer from the directory, Redis
    refused (a closed port) -> None, the worker made the process's."""
    _, _, tworker = tiny
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    monkeypatch.setenv("REDIS_PORT", str(port))
    monkeypatch.setenv("YUME_CLIP_MODEL", clip_dir)
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert dream_init._try_redis() is None and jinit._try_redis() is None
    try:
        dream = asyncio.run(dream_init.initialize_dream_system(tworker, device="cpu"))
        assert dw.get_dream_worker() is dream and dream.redis is None
        assert type(dream.scorer.model) is scoring.NativeCLIP and dream.worker is tworker
        injected = scoring.AestheticScorer()
        dream = asyncio.run(dream_init.initialize_dream_system(tworker, scorer=injected,
                                                               redis="r"))
        assert dream.scorer is injected and dream.redis == "r"
    finally:
        dw.set_dream_worker(None)


def test_the_reference_styles_a_candidate_batch_beside_a_styled_request(tiny, tmp_path):
    """The JAX package's fault, pinned (ROADMAP Queue 3): its candidate batch
    calls the pipeline without the worker's lock, so one dispatched while a
    styled request has swapped in the merged UNet comes out styled. The port
    holds the lock (the test above); this one records the reference."""
    import io

    from PIL import Image

    from dreamlab_tpu.engine.base import GenSpec as JaxGenSpec
    from dreamlab_tpu.lora import StyleDef as JaxStyleDef

    jb = tiny[0]
    pipe = JaxPipeline(jb, dtype=jnp.float32)
    path = str(tmp_path / "style.safetensors")
    save_file(testing.random_lora(port_bundle_of(jb).unet_params, rank=4, seed=3), path)
    worker = TPUPipelineWorker(pipe, 0, styles={
        "s": JaxStyleDef(name="s", path=path, strengths=(4.0,))})
    spec = lambda seed, **kw: JaxGenSpec(prompt="a cat", size="32x32", num_inference_steps=1,
                                         seed=seed, **kw)
    seeds = [11, 12]
    plain = [np.asarray(Image.open(io.BytesIO(worker.run_job(spec(s))[0])).convert("RGB"))
             for s in seeds]
    entered, gate = threading.Event(), threading.Event()
    generate = pipe.generate

    def held(*args, **kwargs):
        if threading.current_thread().name == "styled":
            entered.set()
            assert gate.wait(TIMEOUT)
        return generate(*args, **kwargs)

    pipe.generate = held
    t = threading.Thread(name="styled",
                         target=lambda: worker.run_job(spec(11, style="s", style_level=1)))
    t.start()
    try:
        assert entered.wait(TIMEOUT)
        images = jdw.DreamWorker(worker, candidate_size="32x32")._generate_candidates(
            seeds, "a cat")
    finally:
        gate.set()
        t.join(TIMEOUT)
    diffs = [int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
             for a, b in zip(images, plain)]
    assert min(diffs) > 1, diffs  # styled, where the solo runs are not
