"""The port's per-step progress callbacks, on the CPU: the cases of
tests/test_callback.py run against ``dreamlab_tpu_torch``, and the steps,
timesteps and per-step latents against the JAX package's callback on the
same weights and seed (latents rtol 1e-4 / atol 1e-3, the bounds of
tests/test_torch_port_pipeline.py)."""

import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.pipeline import LCMPipeline
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_img2img import port_bundle_of

KW = dict(height=32, width=32, num_inference_steps=4)


@pytest.fixture(scope="module")
def jb():
    return jax_random_bundle("sd15", tiny=True)


@pytest.fixture(scope="module")
def pipe(jb):
    return LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")


def test_callback_fires_every_step_as_jax_does(jb, pipe):
    calls, jcalls = [], []
    res = pipe.generate("cb", seed=7, callback=lambda i, t, lat: calls.append((i, t, lat)), **KW)
    JaxPipeline(jb, dtype=jnp.float32).generate(
        "cb", seed=7, callback=lambda i, t, lat: jcalls.append((i, t, lat)), **KW)
    assert [c[0] for c in calls] == [c[0] for c in jcalls] == [0, 1, 2, 3]
    sched = pipe._schedule(4, None)
    assert [c[1] for c in calls] == [c[1] for c in jcalls] == [int(t) for t in sched.timesteps]
    for (_, _, lat), (_, _, jlat) in zip(calls, jcalls):
        assert lat.shape == (1, pipe.latent_channels, 16, 16)  # NCHW, as the reference's
        np.testing.assert_allclose(lat, np.asarray(jlat), rtol=1e-4, atol=1e-3)
    assert res.images.shape == (1, 32, 32, 3)
    key = next(k for k in pipe._compiled if dict(k[8:]).get("progress"))
    assert key[:8] == (1, 16, 16, 4, "wcond", "host", None, "txt2img")
    assert dict(key[8:]) == {"progress": "latents"}


def test_callback_steps_filters(pipe):
    calls = []
    pipe.generate("cb", seed=7, callback=lambda i, t, lat: calls.append(i), callback_steps=2,
                  **KW)
    assert calls == [0, 2]


def test_callback_does_not_change_output(pipe):
    base = pipe.generate("determinism", seed=11, **KW)
    withcb = pipe.generate("determinism", seed=11, callback=lambda i, t, lat: None, **KW)
    np.testing.assert_array_equal(base.images, withcb.images)
    np.testing.assert_array_equal(base.latents, withcb.latents)
    # the callback-free bucket is the plain one
    assert (1, 16, 16, 4, "wcond", "host", None, "txt2img") in pipe._compiled


def test_callback_without_latents(pipe):
    calls = []
    pipe.generate("cheap", seed=3, callback=lambda i, t, lat: calls.append((i, lat)),
                  callback_latents=False, **KW)
    assert [i for i, _ in calls] == [0, 1, 2, 3]
    assert all(lat is None for _, lat in calls)
    assert any(dict(k[8:]).get("progress") == "steps" for k in pipe._compiled)


def test_broken_callback_does_not_break_generation(pipe):
    def boom(i, t, lat):
        raise RuntimeError("user callback bug")

    res = pipe.generate("robust", seed=5, callback=boom, **KW)
    assert res.images.shape == (1, 32, 32, 3)


def test_registry_cleaned_up(pipe):
    pipe.generate("cleanup", seed=1, callback=lambda i, t, lat: None, **KW)
    assert pipe._progress_registry == {}


def _register(pipe, calls, every):
    token = next(pipe._progress_tokens)
    with pipe._progress_lock:
        pipe._progress_registry[token] = (lambda i, t, lat: calls.append(i), every, {"last": -1})
    return token


def test_progress_monotonic_drops_late_steps(pipe):
    calls = []
    token = _register(pipe, calls, 1)
    try:
        for step in [0, 2, 1, 3, 3, 2, 4]:
            pipe._progress_emit(token, step, 999)
    finally:
        with pipe._progress_lock:
            pipe._progress_registry.pop(token, None)
    assert calls == [0, 2, 3, 4]


def test_progress_monotonic_respects_callback_steps(pipe):
    calls = []
    token = _register(pipe, calls, 2)
    try:
        for step in [1, 0, 2, 3, 4]:
            pipe._progress_emit(token, step, 999)
    finally:
        with pipe._progress_lock:
            pipe._progress_registry.pop(token, None)
    assert calls == [0, 2, 4]


def test_progress_monotonic_under_concurrency(pipe):
    calls = []
    token = _register(pipe, calls, 1)
    steps = list(range(200)) * 2
    random.Random(0).shuffle(steps)
    threads = [threading.Thread(target=lambda ss=ss: [pipe._progress_emit(token, s, 1)
                                                      for s in ss])
               for ss in (steps[i::4] for i in range(4))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        with pipe._progress_lock:
            pipe._progress_registry.pop(token, None)
    assert calls == sorted(calls), "a client saw a step go backwards"
    assert len(calls) == len(set(calls)), "duplicate step delivered"


def test_worker_progress_cb(pipe):
    """The worker calls ``progress_cb(step, timestep)`` from the steps bucket;
    the PNG equals the callback-free request's, and a progress spec runs solo."""
    worker = CudaPipelineWorker(pipe)
    seen = []
    spec = GenSpec("a cat", size="32x32", num_inference_steps=4, seed=2)
    png = worker.run_job(GenSpec("a cat", size="32x32", num_inference_steps=4, seed=2,
                                 progress_cb=lambda i, t: seen.append((i, t))))[0]
    assert seen == [(i, int(t)) for i, t in enumerate(pipe._schedule(4, None).timesteps)]
    assert png == worker.run_job(spec)[0]
    assert not worker.batchable(spec, GenSpec("a cat", size="32x32", num_inference_steps=4,
                                              progress_cb=print))
