"""The port's per-stage profiler (``LCMPipeline.profile_stages``, ``cli --profile``)
against the JAX package's, on the CPU.

The keys are JAX's ``profile_stages`` keys, in its order, on a tiny SD1.5
bundle; every stage takes time, and ``denoise_loop_ms`` is ``unet_step_ms``
x ``steps``. The CLI prints them before it generates (on the tiny bundle:
``testing.random_bundle`` patched, so no full-width model is built here).
The times are CPU times of the plain versions: they say nothing of the card.
"""

import re

import jax.numpy as jnp
import pytest
import torch

from dreamlab_tpu.pipeline import LCMPipeline as JaxPipeline
from dreamlab_tpu.testing import random_bundle as jax_random_bundle
from dreamlab_tpu_torch import cli, testing
from dreamlab_tpu_torch.pipeline import LCMPipeline
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_img2img import port_bundle_of


@pytest.fixture(scope="module")
def jax_keys():
    """JAX's keys, from its profile_stages on the tiny SD1.5 bundle."""
    stats = JaxPipeline(jax_random_bundle("sd15", tiny=True), dtype=jnp.float32).profile_stages(
        height=32, width=32, steps=2, iters=1)
    return list(stats)


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_profile_stages_gives_jax_keys(jax_keys, arch):
    jb = jax_random_bundle(arch, tiny=True)
    pipe = LCMPipeline(port_bundle_of(jb), dtype=torch.float32, device="cpu")
    stats = pipe.profile_stages(height=32, width=32, steps=3, batch=2, iters=2)
    assert list(stats) == jax_keys
    assert all(v > 0 for v in stats.values())
    assert stats["denoise_loop_ms"] == stats["unet_step_ms"] * 3


def test_cli_profile_prints_the_stages(jax_keys, monkeypatch, tmp_path, capsys):
    tiny = testing.random_bundle
    monkeypatch.setattr(testing, "random_bundle",
                        lambda arch="sd15", **kw: tiny(arch, tiny=True, device=kw["device"]))
    out = str(tmp_path / "cat.png")
    paths = cli.main(["--random-weights", "--profile", "--device", "cpu", "--dtype", "f32",
                      "--prompt", "a cat", "--size", "32x32", "--steps", "2", "--seed", "1",
                      "-o", out])
    printed = capsys.readouterr().out
    stages = re.findall(r"^  (\w+): (\d+\.\d\d)$", printed, re.M)
    assert [k for k, _ in stages] == jax_keys
    assert all(float(v) >= 0 for _, v in stages)
    assert printed.index("denoise_loop_ms") < printed.index("generated 1 image")
    assert paths == [out]
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
