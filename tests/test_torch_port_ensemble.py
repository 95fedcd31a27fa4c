"""The port's segments and SDXL base -> refiner ensemble against the JAX
package's, on the CPU.

Segments on one pipeline: (0, k) then (k, S) equal the S-step run bit for
bit (the sliced schedule and the full run's noise stream are the whole
contract), the carry stays a tensor on the pipeline's device, and the range
errors are the reference's. The refiner (tests/test_refiner.py's tiny
bundle, carried across with ``convert.from_jax_numpy``): its 5 time ids,
and ``generate`` against JAX's at the bounds of
tests/test_torch_port_pipeline.py (latents rtol 1e-4 / atol 1e-3; pixels
within +-1, under 1 % moved). The worker's ensemble against
``TPUPipelineWorker``'s on the same two tiny models: the same pixels within
those bounds, the same progress steps and timesteps, and no batching.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.engine.base import GenSpec as JaxSpec
from dreamlab_tpu.engine.tpu_worker import TPUPipelineWorker
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.scheduler import lcm as jlcm
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.models import controlnet as tcn
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.scheduler import lcm as tlcm
from dreamlab_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.test_refiner import _tiny_refiner_bundle
from tests.test_torch_port_img2img import _pixels_close, port_bundle_of
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(height=32, width=32, num_inference_steps=4, seed=11)


@pytest.fixture(scope="module")
def sd15():
    return LCMPipeline(port_bundle_of(jax_random_bundle("sd15", tiny=True)),
                       dtype=torch.float32, device="cpu")


def test_segments_bitmatch_the_full_run(sd15):
    full = sd15.generate("a cat", **KW)
    base = sd15.generate("a cat", segment=(0, 3), **KW)
    assert base.images is None and base.latents is None
    assert isinstance(base.state_device, torch.Tensor) and base.state_device.device == sd15.device
    assert base.state_device.dtype == torch.float32
    rest = sd15.generate("a cat", segment=(3, 4), latents_state=base.state_device, **KW)
    np.testing.assert_array_equal(rest.images, full.images)
    np.testing.assert_array_equal(rest.latents, full.latents)
    keys = {k[7]: dict(k[8:]) for k in sd15._compiled if dict(k[8:]).get("segment")}
    assert keys == {"latent": {"segment": (0, 3)}, "txt2img": {"segment": (3, 4)}}
    # (0, S) is the full run's bucket
    n = len(sd15._compiled)
    np.testing.assert_array_equal(sd15.generate("a cat", segment=(0, 4), **KW).images,
                                  full.images)
    assert len(sd15._compiled) == n


def test_segment_validation_matches_jax(sd15):
    jax_pipe = JaxPipeline(jax_random_bundle("sd15", tiny=True), dtype=jnp.float32)
    state = sd15.generate("a cat", segment=(0, 2), **KW).state_device
    jstate = jax_pipe.generate("a cat", segment=(0, 2), **KW).state_device
    cases = [("out of range", dict(segment=(0, 5))), ("out of range", dict(segment=(2, 2))),
             ("latents_state", dict(segment=(1, 4))),
             ("latents_state", dict(segment=(0, 2), latents_state="state")),
             ("incompatible", dict(segment=(2, 4), latents_state="state",
                                   latents=np.zeros((1, 16, 16, 4), np.float32)))]
    for match, kw in cases:
        for pipe, st in ((sd15, state), (jax_pipe, jstate)):
            kw2 = {k: st if isinstance(v, str) else v for k, v in kw.items()}
            with pytest.raises(ValueError, match=match):
                pipe.generate("a cat", **kw2, **KW)
    with pytest.raises(ValueError, match="latents_state shape"):
        sd15.generate("a cat", segment=(2, 4), latents_state=state[:, :8], **KW)


def test_slice_schedule_matches_jax():
    cfg = tlcm.LCMConfig()
    full = tlcm.make_lcm_schedule(cfg, 6)
    jfull = jlcm.make_lcm_schedule(jlcm.LCMConfig(), 6)
    for start, stop in ((0, 4), (4, 6), (2, 3)):
        got, want = tlcm.slice_schedule(full, start, stop), jlcm.slice_schedule(jfull, start, stop)
        for name in tlcm.SCHEDULE_FIELDS:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
        assert got.num_steps == stop - start


# ---------------------------------------------------------------------------
# the refiner and the ensemble
# ---------------------------------------------------------------------------


def _port_refiner(jb):
    """The port's bundle of tests/test_refiner.py's refiner (its own tokenizer)."""
    return dataclasses.replace(port_bundle_of(jb), tokenizer=make_test_tokenizer(["castle"]))


@pytest.fixture(scope="module")
def parts():
    jbase, jref = jax_random_bundle("sdxl", tiny=True), _tiny_refiner_bundle()
    port = (LCMPipeline(port_bundle_of(jbase), dtype=torch.float32, device="cpu"),
            LCMPipeline(_port_refiner(jref), dtype=torch.float32, device="cpu"))
    jax = (JaxPipeline(jbase, dtype=jnp.float32), JaxPipeline(jref, dtype=jnp.float32))
    return port, jax


def test_refiner_time_ids_and_generate_match_jax(parts):
    (_, refiner), (_, jrefiner) = parts
    ids = refiner._time_ids(512, 512, 2, aesthetic_score=6.5)
    assert refiner._micro_cond_ids() == 5 and ids.shape == (2, 5)
    assert list(ids[0]) == [512, 512, 0, 0, 6.5]
    np.testing.assert_array_equal(ids, np.asarray(jrefiner._time_ids(512, 512, 2,
                                                                     aesthetic_score=6.5)))
    kw = dict(height=16, width=16, num_inference_steps=2, seed=5, guidance_scale=3.0,
              aesthetic_score=7.0)
    got, want = refiner.generate("a castle", **kw), jrefiner.generate("a castle", **kw)
    np.testing.assert_allclose(got.latents, np.asarray(want.latents), rtol=1e-4, atol=1e-3)
    _pixels_close(got.images, want.images)
    assert testing.random_refiner_bundle(tiny=True).unet_cfg == refiner.bundle.unet_cfg


def _pixels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)))


def test_worker_ensemble_matches_the_tpu_worker(parts):
    """switch 0.5 at 4 steps: base [0, 2), refiner [2, 4); the same pixels
    as the JAX worker's, the progress of the refiner's segment, a solo
    worker's image differs, steps=1 serves the base alone."""
    (base, refiner), (jbase, jrefiner) = parts
    ens = CudaPipelineWorker(base, refiner=refiner, refiner_switch_at=0.5)
    jens = TPUPipelineWorker(jbase, 0, refiner=jrefiner, refiner_switch_at=0.5)
    solo = CudaPipelineWorker(base)
    assert not ens.supports_batching and solo.supports_batching
    steps, jsteps = [], []
    spec = dict(prompt="a castle", size="32x32", num_inference_steps=4, seed=9)
    png, seed = ens.run_job(GenSpec(**spec, progress_cb=lambda i, t: steps.append((i, t))))
    jpng, _ = jens.run_job(JaxSpec(**spec, progress_cb=lambda i, t: jsteps.append((i, t))))
    assert seed == 9
    _pixels_close(_pixels(png), _pixels(jpng))
    assert steps == jsteps == [(0, 499), (1, 259)]
    assert ens.run_job(GenSpec(**spec))[0] == png
    assert png != solo.run_job(GenSpec(**spec))[0]
    assert not ens.batchable(GenSpec(**spec), GenSpec(**spec))
    one = GenSpec(**dict(spec, num_inference_steps=1))
    assert ens.run_job(one) == solo.run_job(one)
    _, _, fp = ens.run_job_with_latents(GenSpec(**spec))
    assert len(fp) == 512


def test_ensemble_hint_conditions_the_base_segment(parts):
    """A hint conditions the base segment only (the refiner has no
    ControlNet): the ensemble equals the base's hinted (0, k) handed to the
    refiner's (k, S)."""
    (base, refiner), _ = parts
    base.set_controlnet(testing.random_controlnet(base.bundle.unet_cfg, vae_scale=2),
                        base.bundle.unet_cfg)
    try:
        hint = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
        ens = CudaPipelineWorker(base, refiner=refiner, refiner_switch_at=0.8,
                                 controlnet_scale=0.5)
        png = ens.run_job_with_latents(GenSpec("a castle", size="32x32", num_inference_steps=4,
                                               seed=3, control_image=hint))[0]
        kw = dict(height=32, width=32, num_inference_steps=4, seed=3)
        carry = base.generate("a castle", segment=(0, 3), control_image=hint,
                              controlnet_scale=0.5, **kw).state_device
        want = refiner.generate("a castle", segment=(3, 4), latents_state=carry, **kw)
        np.testing.assert_array_equal(_pixels(png), want.images[0])
        assert tcn.skip_count(base.bundle.unet_cfg) == len(base.controlnet_params["zero_down"])
    finally:
        base.set_controlnet(None, None)
