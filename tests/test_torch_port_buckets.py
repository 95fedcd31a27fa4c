"""The port's program per shape bucket, ``warmup`` and device RNG against the
JAX package's, on the CPU.

On the CPU a bucket's program is the eager function, cached in
``_compiled`` under the JAX package's key (plus ``original_inference_steps``,
whose schedule the port bakes into the txt2img program, and the task, as the
JAX key has it); on the card it is a
captured CUDA graph (chip_smoke.py). These are the JAX package's
tests/test_pipeline.py checks of the cache (test_compile_cache_reuse) and of
device RNG (test_device_rng_deterministic), on the port, with the JAX
pipeline beside it where a number can be compared (latents rtol 1e-4 /
atol 1e-3; pixels within +-1 with under 1 % moved, as
tests/test_torch_port_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.pipeline import LCMPipeline, deterministic_backends
from dreamlab_tpu_torch.testing import random_bundle
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_pipeline import port_bundle, tiny_ckpt  # noqa: F401 (fixture)

CALL = dict(height=32, width=32, num_inference_steps=2)


@pytest.fixture(scope="module")
def pipe():
    return LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")


def test_compile_cache_reuse(pipe):
    pipe._compiled.clear()
    pipe.generate("x", seed=0, **CALL)
    n = len(pipe._compiled)
    pipe.generate("y", seed=1, **CALL)
    assert len(pipe._compiled) == n  # same bucket, the same program
    pipe.generate("y", seed=1, **{**CALL, "width": 48})
    assert len(pipe._compiled) == n + 1
    pipe.generate("y", seed=1, **{**CALL, "width": 48}, original_inference_steps=25)
    assert len(pipe._compiled) == n + 2  # the schedule is baked into the program
    assert (1, 16, 16, 2, "wcond", "host", None, "txt2img") in pipe._compiled
    assert (1, 16, 24, 2, "wcond", "host", 25, "txt2img") in pipe._compiled


@pytest.mark.parametrize("batch", [1, 3])
def test_warmup_creates_the_bucket_generate_uses(batch):
    pipe = LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")
    out = pipe.warmup(32, 32, steps=2, batch=batch)
    assert list(pipe._compiled) == [out["key"]] == [(batch, 16, 16, 2, "wcond", "host", None,
                                                            "txt2img")]
    program = pipe._compiled[out["key"]]
    res = pipe.generate(["a cat"] * batch, seed=4, **CALL)
    assert list(pipe._compiled) == [out["key"]] and pipe._compiled[out["key"]] is program
    assert res.images.shape == (batch, 32, 32, 3)


def test_device_rng_deterministic(pipe):
    a = pipe.generate("a cat", seed=11, rng="device", **CALL)
    b = pipe.generate("a cat", seed=11, rng="device", **CALL)
    np.testing.assert_array_equal(a.images, b.images)
    c = pipe.generate("a cat", seed=12, rng="device", **CALL)
    assert not np.array_equal(a.images, c.images)
    # host and device modes differ (documented), both valid, in separate buckets
    h = pipe.generate("a cat", seed=11, rng="host", **CALL)
    assert h.images.shape == a.images.shape and not np.array_equal(h.images, a.images)
    modes = {key[5] for key in pipe._compiled if key[:4] == (1, 16, 16, 2)}
    assert modes == {"host", "device"}
    # the seed is read modulo 2**31, as the host path reads it
    d = pipe.generate("a cat", seed=11 + 2**31, rng="device", **CALL)
    np.testing.assert_array_equal(a.images, d.images)


def test_device_rng_from_the_environment_and_explicit_noise_forces_host(pipe, monkeypatch):
    monkeypatch.setenv("DREAMLAB_RNG", "device")
    env = pipe.generate("a cat", seed=21, **CALL)
    np.testing.assert_array_equal(env.images, pipe.generate("a cat", seed=21, rng="device",
                                                            **CALL).images)
    lat, noise = pipe._sample_noise(21, 1, 16, 16, 2, 1.0)
    forced = pipe.generate("a cat", seed=21, latents=lat, step_noises=noise, **CALL)
    monkeypatch.setenv("DREAMLAB_RNG", "host")
    host = pipe.generate("a cat", seed=21, **CALL)
    np.testing.assert_array_equal(forced.images, host.images)
    with pytest.raises(ValueError, match="rng mode"):
        pipe.generate("a cat", seed=21, rng="tpu", **CALL)


def test_host_rng_bucket_matches_jax_with_row_guidance(tiny_ckpt):  # noqa: F811
    """The staged program equals the JAX program on the same batched call
    with per-row guidance (the tiny checkpoint's UNet has cond_proj: the
    wcond mode)."""
    ckpt, jax_bundle = tiny_ckpt
    port = LCMPipeline(port_bundle(jax_bundle, ckpt), dtype=torch.float32, device="cpu")
    jax_pipe = JaxPipeline(jax_bundle, dtype=jnp.float32)
    call = dict(CALL, seed=5, guidance_scale=[1.0, 6.0])
    res = port.generate(["a cat", "a dog at sunset"], **call)
    jres = jax_pipe.generate(["a cat", "a dog at sunset"], **call)
    np.testing.assert_allclose(res.latents, np.asarray(jres.latents), rtol=1e-4, atol=1e-3)
    diff = np.abs(res.images.astype(np.int16) - np.asarray(jres.images).astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert list(port._compiled) == [(2, 16, 16, 2, "wcond", "host", None, "txt2img")]


def test_eager_route_equals_the_bucket_program(pipe):
    call = dict(CALL, seed=9, guidance_scale=3.0)
    np.testing.assert_array_equal(pipe._generate_eager("a cat", **call).images,
                                  pipe.generate("a cat", **call).images)


def test_constructing_a_pipeline_sets_the_deterministic_backends(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    deterministic_backends()  # idempotent
    assert torch.backends.cudnn.deterministic


def test_worker_warmup_and_default_size():
    pipe = LCMPipeline(random_bundle(tiny=True, seed=2), dtype=torch.float32, device="cpu")
    worker = CudaPipelineWorker(pipe, 4, default_size=(48, 32), warmup=True)
    assert list(pipe._compiled) == [(1, 16, 24, 4, "wcond", "host", None, "txt2img")]
    worker.run_job(GenSpec("a cat", size="48x32", num_inference_steps=4, seed=1))
    assert len(pipe._compiled) == 1
    cold = CudaPipelineWorker(LCMPipeline(random_bundle(tiny=True, seed=2),
                                          dtype=torch.float32, device="cpu"))
    assert not cold.pipeline._compiled


def test_create_cuda_worker_warmup_size(tmp_path):
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    worker = create_cuda_worker(0, ckpt, dtype=torch.float32, device="cpu",
                                warmup_size=(32, 16))
    assert list(worker.pipeline._compiled) == [(1, 8, 16, 4, "wcond", "host", None, "txt2img")]
    assert not create_cuda_worker(1, ckpt, dtype=torch.float32,
                                  device="cpu").pipeline._compiled
