"""The port's worker (CudaPipelineWorker) on the CPU: PNG bytes, fingerprints,
determinism and batch invariance, against the pipeline and the JAX package's
worker helpers."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.engine.tpu_worker import latents_to_fingerprint as jax_fingerprint
from dreamlab_tpu.engine.tpu_worker import png_encode as jax_png_encode
from dreamlab_tpu_torch.engine.base import GenSpec, parse_size
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker, latents_to_fingerprint
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.testing import random_bundle
from dreamlab_tpu_torch.utils.png import encode_png


@pytest.fixture(scope="module")
def worker():
    pipe = LCMPipeline(random_bundle(tiny=True, seed=1), dtype=torch.float32, device="cpu")
    return CudaPipelineWorker(pipe)


def _decode(png: bytes):
    img = Image.open(io.BytesIO(png))
    img.load()
    return np.asarray(img), img.text


def test_parse_size():
    assert parse_size("512x768") == (512, 768)
    assert parse_size(" 64 X 32 ") == (64, 32)
    with pytest.raises(ValueError):
        parse_size("512")


def test_run_job_png_carries_pipeline_pixels_and_parameters(worker):
    spec = GenSpec("a cat at sunset", size="32x16", num_inference_steps=2, seed=5)
    png, seed = worker.run_job(spec)
    assert seed == 5 and png[:8] == b"\x89PNG\r\n\x1a\n"
    pixels, text = _decode(png)
    want = worker.pipeline.generate("a cat at sunset", height=16, width=32,
                                    num_inference_steps=2, seed=5).images[0]
    np.testing.assert_array_equal(pixels, want)
    assert text["parameters"] == (
        "a cat at sunset\nSteps: 2, CFG scale: 1.0, Seed: 5, Size: 32x16")
    assert worker.run_job(spec)[0] == png  # same seed -> byte-identical PNG


def test_run_job_with_latents_fingerprint_matches_jax(worker):
    spec = GenSpec("a dog", size="32x32", num_inference_steps=2, seed=9)
    png, seed, fp = worker.run_job_with_latents(spec)
    res = worker.pipeline.generate("a dog", height=32, width=32, num_inference_steps=2,
                                   seed=9)
    assert len(fp) == 512 and fp == jax_fingerprint(res.latents)
    np.testing.assert_array_equal(_decode(png)[0], res.images[0])
    rs = np.random.RandomState(0)
    for shape in [(1, 64, 64, 4), (1, 12, 20, 4), (1, 8, 8, 4)]:
        lat = rs.randn(*shape).astype(np.float32)
        assert latents_to_fingerprint(lat) == jax_fingerprint(lat)


def test_png_encoder_round_trips_and_matches_jax_pixels():
    rs = np.random.RandomState(1)
    for arr in [rs.randint(0, 256, (17, 23, 3), np.uint8),
                rs.randint(0, 256, (8, 5), np.uint8),
                rs.randint(0, 256, (4, 6, 4), np.uint8)]:
        got = _decode(encode_png(arr, {"parameters": "x"}))
        np.testing.assert_array_equal(got[0], arr)
        assert got[1]["parameters"] == "x"
    arr = rs.randint(0, 256, (16, 16, 3), np.uint8)
    np.testing.assert_array_equal(_decode(encode_png(arr))[0],
                                  _decode(jax_png_encode(arr))[0])


def test_run_jobs_rows_equal_solo_runs(worker):
    """Byte-identical with oneDNN's convs on, whose algorithm choice depends on
    the batch size: the library calls run one row at a time (ops/batching.py)."""
    specs = [GenSpec("a cat", size="16x16", num_inference_steps=2, seed=s,
                     guidance_scale=g) for s, g in [(1, 1.0), (2, 4.0), (3, 8.0)]]
    assert all(worker.batchable(specs[0], s) for s in specs[1:])
    batched = worker.run_jobs(specs)
    assert [seed for _, seed in batched] == [1, 2, 3]
    for (png, _), spec in zip(batched, specs):
        assert png == worker.run_job(spec)[0]


def test_batchable_and_unsupported_features(worker):
    a = GenSpec("a", size="16x16")
    assert not worker.batchable(a, GenSpec("b", size="32x32"))
    assert not worker.batchable(a, GenSpec("b", size="16x16", num_inference_steps=2))
    assert not worker.batchable(a, GenSpec("b", size="16x16", progress_cb=print))
    with pytest.raises(ValueError, match="unknown style"):
        worker.run_job(GenSpec("a", size="16x16", style="anime"))
    with pytest.raises(ValueError):
        worker.run_jobs([a, GenSpec("b", size="32x32")])
