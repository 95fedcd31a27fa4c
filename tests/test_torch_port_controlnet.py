"""The port's ControlNet against the JAX package's, on the CPU.

``embed_cond`` and ``forward`` (and the UNet fed the taps): JAX's
``random_controlnet`` carried across with ``convert.from_jax_numpy``, the
same numpy inputs, fp32, atol 1e-5 (tiny SD1.5 with the w-embedding; tiny
SDXL with the micro-conditioning). The pipeline: ``generate(control_image=)``
against JAX's on the same host noise, held to the bounds of
tests/test_torch_port_pipeline.py (latents rtol 1e-4 / atol 1e-3; pixels
within +-1, under 1 % moved); the invariants of tests/test_controlnet.py
(zero taps and scale 0 are the identity, bit for bit; a hint broadcast over
the batch; integer hint dtypes; the errors); a net of the same config
written into the live leaves, another config dropping the ctrl buckets; a
directory the port writes loaded by both packages' loaders, leaf for leaf;
the worker and ``create_cuda_worker(controlnet=)``.
"""

import dataclasses
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.loader import load_controlnet as jax_load_controlnet
from dreamlab_tpu.models import configs as jcfg
from dreamlab_tpu.models import controlnet as jcn
from dreamlab_tpu.models import unet as junet
from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu.testing import random_controlnet as jax_random_controlnet
from dreamlab_tpu_torch import convert, loader, testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.models import configs as tcfg
from dreamlab_tpu_torch.models import controlnet as tcn
from dreamlab_tpu_torch.models import unet as tunet
from dreamlab_tpu_torch.pipeline import LCMPipeline, _flat
from dreamlab_tpu_torch.utils.model_detector import detect_model
from tests.test_loader import make_tiny_checkpoint
from tests.test_torch_port_img2img import _pixels_close, port_bundle_of
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_loader import assert_trees_equal
from tests.test_torch_port_models import _np_tree

CALL = dict(height=32, width=32, num_inference_steps=2, seed=1)


def _hint(h=32, w=32, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _jax_cn(cfg, *, zero_taps=False, seed=7):
    return jax_random_controlnet(cfg, zero_taps=zero_taps, vae_scale=2, seed=seed)


def _port(tree):
    return convert.from_jax_numpy(_np_tree(tree))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_embed_cond_forward_and_taps_match_jax(arch):
    """The hint ladder, the trunk's taps at scale 0.7 and the UNet fed them,
    against JAX on the same weights and inputs (fp32, atol 1e-5)."""
    jcfg_ = jcfg.TINY_UNET if arch == "sd15" else jcfg.TINY_UNET_XL
    tcfg_ = tcfg.TINY_UNET if arch == "sd15" else tcfg.TINY_UNET_XL
    params = _jax_cn(jcfg_)
    uparams = junet.init_params(jcfg_, np.random.RandomState(3))
    rs = np.random.RandomState(0)
    sample = rs.randn(2, 16, 16, 4).astype(np.float32)
    hint = rs.rand(2, 32, 32, 3).astype(np.float32)
    ctx = rs.randn(2, 77, jcfg_.cross_attention_dim).astype(np.float32)
    t = np.asarray([999, 259], np.int32)
    kw = {}
    if arch == "sd15":
        kw["timestep_cond"] = rs.randn(2, jcfg_.time_cond_proj_dim).astype(np.float32)
    else:
        kw["added_text_embeds"] = rs.randn(2, 32).astype(np.float32)
        kw["added_time_ids"] = np.tile(np.asarray([32, 32, 0, 0, 32, 32], np.float32), (2, 1))

    j = {k: jnp.asarray(v) for k, v in kw.items()}
    jemb = jcn.embed_cond(params["cond_embedding"], jnp.asarray(hint))
    jdown, jmid = jcn.forward(params, jcfg_, jnp.asarray(sample), jnp.asarray(t),
                              jnp.asarray(ctx), jemb, conditioning_scale=0.7, **j)
    jout = junet.forward(uparams, jcfg_, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                         down_residuals=jdown, mid_residual=jmid, **j)

    tparams = _port(params)
    tk = {k: torch.from_numpy(v) for k, v in kw.items()}
    temb = tcn.embed_cond(tparams["cond_embedding"], torch.from_numpy(hint))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=0, atol=1e-5)
    tdown, tmid = tcn.forward(tparams, tcfg_, torch.from_numpy(sample), torch.from_numpy(t),
                              torch.from_numpy(ctx), temb, conditioning_scale=0.7, **tk)
    assert len(tdown) == len(jdown) == tcn.skip_count(tcfg_)
    for a, b in zip(tdown, jdown):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmid.numpy(), np.asarray(jmid), rtol=0, atol=1e-5)
    tout = tunet.forward(_port(uparams), tcfg_, torch.from_numpy(sample), torch.from_numpy(t),
                         torch.from_numpy(ctx), down_residuals=tdown, mid_residual=tmid, **tk)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="architecture mismatch"):
        tunet.forward(_port(uparams), tcfg_, torch.from_numpy(sample), torch.from_numpy(t),
                      torch.from_numpy(ctx), down_residuals=tdown[:-1], mid_residual=tmid, **tk)


def test_init_params_tree_matches_jax():
    """The port's init gives JAX's tree, shape for shape, zero taps zero."""
    want = _port(_jax_cn(jcfg.TINY_UNET, zero_taps=True))
    got = testing.random_controlnet(tcfg.TINY_UNET, zero_taps=True, vae_scale=2)
    shapes = lambda t: {k: tuple(v.shape) for k, v in _flat(t).items()}
    assert shapes(got) == shapes(want)
    assert not any(v.any() for v in got["zero_down"][0].values())
    assert not got["cond_embedding"]["conv_out"]["w"].any()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jb():
    return jax_random_bundle("sd15", tiny=True)


@pytest.fixture(scope="module")
def pipe(jb):
    return LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")


@pytest.fixture
def attached(pipe):
    """The pipeline with a ControlNet of non-zero taps; detached afterwards."""
    pipe.set_controlnet(_port(_jax_cn(jcfg.TINY_UNET)), tcfg.TINY_UNET)
    yield pipe
    pipe.set_controlnet(None, None)


def test_generate_with_a_hint_matches_jax(jb, attached):
    """wcond, scale 0.7: the same hint and seed through both pipelines."""
    jpipe = JaxPipeline(jb, dtype=jnp.float32)
    jpipe.set_controlnet(_jax_cn(jcfg.TINY_UNET), jcfg.TINY_UNET)
    kw = dict(CALL, control_image=_hint(), controlnet_scale=0.7)
    want = jpipe.generate("a cat", **kw)
    got = attached.generate("a cat", **kw)
    np.testing.assert_allclose(got.latents, np.asarray(want.latents), rtol=1e-4, atol=1e-3)
    _pixels_close(got.images, want.images)
    key = next(k for k in attached._compiled if "ctrl" in dict(k[8:]))
    assert key[:8] == (1, 16, 16, 2, "wcond", "host", None, "txt2img")
    assert dict(key[8:]) == {"ctrl": tcfg.TINY_UNET}


def test_zero_taps_scale_zero_and_hints(pipe):
    """Zero taps and scale 0 give the plain images bit for bit; a non-zero
    scale and another hint change them; an int64 hint equals its uint8."""
    base = pipe.generate("a cat", **CALL)
    pipe.set_controlnet(_port(_jax_cn(jcfg.TINY_UNET, zero_taps=True)), tcfg.TINY_UNET)
    try:
        zero = pipe.generate("a cat", control_image=_hint(), **CALL)
        pipe.set_controlnet(_port(_jax_cn(jcfg.TINY_UNET)), tcfg.TINY_UNET)
        r0 = pipe.generate("a cat", control_image=_hint(), controlnet_scale=0.0, **CALL)
        r1 = pipe.generate("a cat", control_image=_hint(), **CALL)
        r9 = pipe.generate("a cat", control_image=_hint(seed=9), **CALL)
        r64 = pipe.generate("a cat", control_image=_hint().astype(np.int64), **CALL)
        dists = [float(np.linalg.norm(pipe.generate(
            "a cat", control_image=_hint(), controlnet_scale=s, **CALL).latents - base.latents))
            for s in (0.1, 0.5)]
    finally:
        pipe.set_controlnet(None, None)
    np.testing.assert_array_equal(zero.images, base.images)
    np.testing.assert_array_equal(r0.images, base.images)
    assert not np.array_equal(r1.images, base.images)
    assert not np.array_equal(r1.images, r9.images)
    np.testing.assert_array_equal(r64.images, r1.images)
    assert dists[0] < dists[1] < float(np.linalg.norm(r1.latents - base.latents))


def test_batched_hint_broadcast(attached):
    """One hint broadcasts over the batch; per-row hints are each row's own
    (the noise pinned equal per row, so the hint is the only difference)."""
    rs = np.random.RandomState(7)
    lat = np.repeat(rs.randn(1, 16, 16, 4).astype(np.float32), 2, axis=0)
    noises = np.repeat(rs.randn(2, 1, 16, 16, 4).astype(np.float32), 2, axis=1)
    kw = dict(CALL, batch=2, latents=lat, step_noises=noises)
    r = attached.generate("a cat", control_image=_hint(), **kw)
    np.testing.assert_array_equal(r.images[0], r.images[1])
    r2 = attached.generate("a cat", control_image=np.stack([_hint(), _hint(seed=9)]), **kw)
    assert not np.array_equal(r2.images[0], r2.images[1])
    np.testing.assert_array_equal(r.images[0], r2.images[0])


def test_validation_errors(pipe):
    with pytest.raises(ValueError, match="no ControlNet"):
        pipe.generate("a cat", control_image=_hint(), **CALL)
    bad_cfg = dataclasses.replace(tcfg.TINY_UNET, layers_per_block=2)
    bad = testing.random_controlnet(bad_cfg, vae_scale=2)
    with pytest.raises(ValueError, match="mismatch"):
        pipe.set_controlnet(bad, bad_cfg)
    assert pipe.controlnet_params is None
    pipe.set_controlnet(testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2), tcfg.TINY_UNET)
    try:
        with pytest.raises(ValueError, match="resize"):
            pipe.generate("a cat", control_image=_hint(16, 16), **CALL)
    finally:
        pipe.set_controlnet(None, None)


def test_same_config_writes_the_live_leaves_another_drops_the_buckets(jb, pipe):
    """A net of the attached net's config goes into the leaves the ctrl
    bucket reads (same tensors, same program) and gives what a fresh
    pipeline with that net gives; another config, and a detach, drop the
    ctrl buckets."""
    pipe.set_controlnet(testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2, seed=1),
                        tcfg.TINY_UNET)
    try:
        first = pipe.generate("a cat", control_image=_hint(), **CALL)
        leaves = {k: v.data_ptr() for k, v in _flat(pipe.controlnet_params).items()}
        ctrl = {k: p for k, p in pipe._compiled.items() if "ctrl" in dict(k[8:])}
        other = testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2, seed=2)
        pipe.set_controlnet(other, tcfg.TINY_UNET)
        assert {k: v.data_ptr() for k, v in _flat(pipe.controlnet_params).items()} == leaves
        assert {k: p for k, p in pipe._compiled.items() if "ctrl" in dict(k[8:])} == ctrl
        second = pipe.generate("a cat", control_image=_hint(), **CALL)
        fresh = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
        fresh.set_controlnet(other, tcfg.TINY_UNET)
        np.testing.assert_array_equal(second.images,
                                      fresh.generate("a cat", control_image=_hint(),
                                                     **CALL).images)
        assert not np.array_equal(second.images, first.images)
        # another hint ladder: another config of the net
        wide = testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2, cond_channels=(8, 32))
        pipe.set_controlnet(wide, tcfg.TINY_UNET)
        assert not any("ctrl" in dict(k[8:]) for k in pipe._compiled)
        pipe.generate("a cat", control_image=_hint(), **CALL)
        assert any("ctrl" in dict(k[8:]) for k in pipe._compiled)
    finally:
        pipe.set_controlnet(None, None)
    assert not any("ctrl" in dict(k[8:]) for k in pipe._compiled)
    assert pipe.controlnet_params is None and pipe.controlnet_cfg is None


def test_sdxl_cfg_path_matches_jax():
    """Classic CFG (the doubled batch, the doubled hint embedding) on tiny
    SDXL: zero taps are the identity, and a non-zero net matches JAX."""
    jbx = jax_random_bundle("sdxl", tiny=True)
    port = LCMPipeline(port_bundle_of(jbx), dtype=torch.float32, device="cpu")
    kw = dict(CALL, seed=3, guidance_scale=4.0)
    base = port.generate("a cat", **kw)
    port.set_controlnet(_port(_jax_cn(jcfg.TINY_UNET_XL, zero_taps=True)), tcfg.TINY_UNET_XL)
    np.testing.assert_array_equal(port.generate("a cat", control_image=_hint(), **kw).images,
                                  base.images)
    port.set_controlnet(_port(_jax_cn(jcfg.TINY_UNET_XL)), tcfg.TINY_UNET_XL)
    got = port.generate("a cat", control_image=_hint(), **kw)
    jpipe = JaxPipeline(jbx, dtype=jnp.float32)
    jpipe.set_controlnet(_jax_cn(jcfg.TINY_UNET_XL), jcfg.TINY_UNET_XL)
    want = jpipe.generate("a cat", control_image=_hint(), **kw)
    assert not np.array_equal(got.images, base.images)
    np.testing.assert_allclose(got.latents, np.asarray(want.latents), rtol=1e-4, atol=1e-3)
    _pixels_close(got.images, want.images)


# ---------------------------------------------------------------------------
# loader, worker, factory
# ---------------------------------------------------------------------------


def test_controlnet_dir_loads_in_both_packages(tmp_path):
    """A directory the port writes is a ControlNet to the detector, and both
    loaders read it to the same tree."""
    params = testing.random_controlnet(tcfg.TINY_UNET, vae_scale=2)
    path = testing.write_controlnet_dir(params, tcfg.TINY_UNET, str(tmp_path / "cn"))
    assert detect_model(path).is_controlnet
    got, cfg = loader.load_controlnet(path, device="cpu")
    assert cfg == tcfg.TINY_UNET
    assert_trees_equal(got, params)
    jparams, jcfg_ = jax_load_controlnet(path)
    assert dataclasses.asdict(jcfg_) == dataclasses.asdict(cfg)
    assert_trees_equal(_port(jparams), params)


def test_worker_hint_scale_and_the_factory(jb, tmp_path):
    """The worker passes the hint and the mode's scale (a spec's own scale
    overrides it); ``create_cuda_worker(controlnet=)`` attaches the mode's
    net with its scale, and one it cannot read warns and serves without."""
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    ucfg = loader.load_pipeline(ckpt, device="cpu").unet_cfg
    cn = testing.random_controlnet(ucfg, vae_scale=2)
    cn_dir = testing.write_controlnet_dir(cn, ucfg, str(tmp_path / "cn"))
    worker = create_cuda_worker(0, ckpt, dtype=torch.float32, device="cpu",
                                controlnet=types.SimpleNamespace(file=cn_dir, scale=0.6))
    assert worker.controlnet_scale == 0.6 and worker.pipeline.controlnet_cfg == ucfg
    pipe = worker.pipeline
    spec = GenSpec("a cat", size="32x32", num_inference_steps=2, seed=4, control_image=_hint())
    png = lambda s: np.asarray(Image.open(io.BytesIO(worker.run_job(s)[0])))
    want = lambda scale: pipe.generate("a cat", height=32, width=32, num_inference_steps=2,
                                       seed=4, control_image=_hint(),
                                       controlnet_scale=scale).images[0]
    np.testing.assert_array_equal(png(spec), want(0.6))
    np.testing.assert_array_equal(png(dataclasses.replace(spec, controlnet_scale=0.2)),
                                  want(0.2))
    assert not worker.batchable(spec, dataclasses.replace(spec, control_image=None))
    plain = create_cuda_worker(0, ckpt, dtype=torch.float32, device="cpu",
                               controlnet=types.SimpleNamespace(file=str(tmp_path / "none"),
                                                                scale=0.6))
    assert plain.controlnet_scale == 1.0 and plain.pipeline.controlnet_params is None
    assert isinstance(worker, CudaPipelineWorker)
