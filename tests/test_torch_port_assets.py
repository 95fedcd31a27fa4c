"""The port's asset manifests, detector examples and detector CLI
(``dreamlab_tpu_torch/utils/{assets,custom_detector_examples,model_detector}.py``)
against the JAX package's on the CPU: ``tests/test_assets.py``'s cases on the
repo's ``model/Assets/*.json``, the examples' cases of ``tests/test_yume.py``
and ``tests/test_detector_checkpoint.py``, and the CLI's JSON on
``tests/test_loader.py::make_tiny_checkpoint``.

The two detectors name their serving worker (``ModelInfo.worker``) in their
own package; every other field must be equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dreamlab_tpu.utils import assets as jassets
from dreamlab_tpu.utils import custom_detector_examples as jexamples
from dreamlab_tpu.utils import model_detector as jdet
from dreamlab_tpu_torch.utils import assets, custom_detector_examples as examples
from dreamlab_tpu_torch.utils import model_detector as det
from dreamlab_tpu_torch.utils import safetensors as st
from tests.test_loader import make_tiny_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS_DIR = os.path.join(ROOT, "model", "Assets")
JAX_WORKER = "dreamlab_tpu.engine.tpu_worker.TPUPipelineWorker"
NAMES = sorted(jassets.load_manifests(ASSETS_DIR))


def _same_info(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert (a.pop("worker") is None) == (b.pop("worker") is None)
    assert a == b


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_manifests_parse_as_jax(name):
    got, want = assets.load_manifests(ASSETS_DIR), jassets.load_manifests(ASSETS_DIR)
    assert list(got) == list(want)
    assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])


def test_shipped_manifests():
    ms = assets.load_manifests(ASSETS_DIR)
    assert {"LCM-Dreamshaper-V7", "SDXL-Base-1.0"} <= set(ms)
    lcm = ms["LCM-Dreamshaper-V7"]
    assert (lcm.pipeline, lcm.layout) == ("lcm-sd15", "diffusers")
    assert any(f.path.startswith("unet/") for f in lcm.files)


@pytest.mark.parametrize("name", NAMES)
def test_plan_equals_jax(name):
    got = assets.plan(assets.load_manifests(ASSETS_DIR)[name])
    assert got == jassets.plan(jassets.load_manifests(ASSETS_DIR)[name])
    assert got[0].startswith(f"# {name}") and all(f"{name}/" in ln for ln in got[1:])


def test_plan_resolves_urls_against_the_repository():
    lines = assets.plan(assets.load_manifests(ASSETS_DIR)["LCM-Dreamshaper-V7"])
    assert any("resolve/main/unet/diffusion_pytorch_model.safetensors" in ln for ln in lines)


def test_verify_missing_delivered_and_empty_as_jax(tmp_path):
    path = os.path.join(ASSETS_DIR, "LCM-Dreamshaper-V7.json")
    m, jm = assets.parse_manifest(path), jassets.parse_manifest(path)
    both = lambda **kw: (assets.verify(m, str(tmp_path), **kw),
                         jassets.verify(jm, str(tmp_path), **kw))
    got, want = both(run_detector=False)
    assert got == want and got and all("missing file" in p for p in got)
    root = tmp_path / m.name
    for f in m.files:
        p = root / f.path
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    assert both(run_detector=False) == ([], [])
    (root / m.files[0].path).write_bytes(b"")
    got, want = both(run_detector=False)
    assert got == want == [f"empty file: {root / m.files[0].path}"]


def test_verify_hashes_and_the_detector_check_as_jax(tmp_path):
    """sha256 checked on request; a delivered tiny SD1.5 checkpoint passes
    the detector check, and a manifest promising SDXL fails it in both."""
    ckpt = make_tiny_checkpoint(tmp_path / "tiny")
    files = sorted(os.path.relpath(os.path.join(d, f), ckpt)
                   for d, _, fs in os.walk(ckpt) for f in fs)
    for pipeline in ("lcm-sd15", "sdxl"):
        manifest = tmp_path / f"{pipeline}.json"
        manifest.write_text(json.dumps({
            "name": "tiny", "repository": "https://example.invalid/tiny",
            "pipeline": pipeline, "layout": "diffusers",
            "files": [{"path": files[0], "sha256": "0" * 64}] + files[1:]}))
        m, jm = assets.parse_manifest(str(manifest)), jassets.parse_manifest(str(manifest))
        for kw in ({}, {"check_hashes": True}):
            got = assets.verify(m, str(tmp_path), **kw)
            assert got == jassets.verify(jm, str(tmp_path), **kw)
            if kw:
                assert got == [f"sha256 mismatch: {os.path.join(ckpt, files[0])}"]
            elif pipeline == "sdxl":
                assert len(got) == 1 and "arch='sd15'" in got[0]
            else:
                assert got == []


def test_manifest_validation_errors(tmp_path):
    bad = tmp_path / "bad.json"
    cases = [({"name": "x", "layout": "diffusers"}, "missing keys"),
             ({"name": "x", "repository": "r", "pipeline": "p", "layout": "tarball",
               "files": ["a"]}, "unknown layout"),
             ({"name": "x", "repository": "r", "pipeline": "p", "layout": "diffusers",
               "files": []}, "no files")]
    for raw, match in cases:
        bad.write_text(json.dumps(raw))
        with pytest.raises(ValueError, match=match) as got:
            assets.parse_manifest(str(bad))
        with pytest.raises(ValueError) as want:
            jassets.parse_manifest(str(bad))
        assert str(got.value) == str(want.value)


def test_cli_list_plan_and_verify_print_as_jax(tmp_path, capsys):
    for argv, rc in ((["--list"], 0), ([], 0), (["--plan", "SDXL-Base-1.0"], 0),
                     (["--root", str(tmp_path), "--verify", "LCM-Dreamshaper-V7"], 1)):
        argv = ["--assets", ASSETS_DIR] + argv
        assert assets.main(argv) == rc
        got = capsys.readouterr().out
        assert jassets.main(argv) == rc
        assert got == capsys.readouterr().out
    assert "missing file" in got


def test_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "dreamlab_tpu_torch.utils.assets", "--assets",
                          ASSETS_DIR, "--list"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "LCM-Dreamshaper-V7" in out.stdout and "sdxl" in out.stdout


# ---------------------------------------------------------------------------
# the detector's examples and CLI
# ---------------------------------------------------------------------------


def test_extended_detector_on_a_tiny_checkpoint_equals_jax(tmp_path):
    d = make_tiny_checkpoint(tmp_path / "ckpt")
    (tmp_path / "ckpt" / "LICENSE").write_text("MIT")
    info = examples.make_extended_detector().detect(d)
    assert info.extra["is_lcm"] is True and info.extra["license_file"] == "LICENSE"
    _same_info(info, jexamples.make_extended_detector().detect(d))


def test_refiner_and_turbo_examples_equal_jax(tmp_path):
    unet = {"cross_attention_dim": 2048, "sample_size": 128}
    for name, dirs in (("sdxl-turbo", ("text_encoder", "text_encoder_2")),
                       ("refiner", ("text_encoder_2",))):
        d = tmp_path / name
        (d / "unet").mkdir(parents=True)
        (d / "unet" / "config.json").write_text(json.dumps(unet))
        for sub in dirs:
            (d / sub).mkdir()
        info = examples.make_extended_detector().detect(str(d))
        _same_info(info, jexamples.make_extended_detector().detect(str(d)))
        assert info.extra.get("is_turbo", False) == (name == "sdxl-turbo")
        assert info.extra.get("is_refiner", False) == (name == "refiner")


@pytest.mark.parametrize("scale,ladder", [(0.003, [0.8, 1.0, 1.2, 1.5]),
                                          (0.03, [0.6, 0.8, 1.0, 1.2]),
                                          (0.3, [0.4, 0.6, 0.8, 1.0])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_lora_strength_analyzer_equals_jax(tmp_path, scale, ladder, dtype):
    rs = np.random.RandomState(0)
    base = "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k"
    tensors = {f"{base}.lora_A.weight": rs.randn(2, 768) * scale,
               f"{base}.lora_B.weight": rs.randn(32, 2) * scale}
    path = str(tmp_path / "lora.safetensors")
    st.save_file({k: torch.from_numpy(v).to(dtype) for k, v in tensors.items()}, path)
    info = examples.make_extended_detector().detect(path)
    assert info.is_lora and info.extra["suggested_strength_levels"] == ladder
    _same_info(info, jexamples.make_extended_detector().detect(path))


def test_detector_cli_prints_the_jax_detectors_json(tmp_path, capsys):
    d = make_tiny_checkpoint(tmp_path / "ckpt")
    lora = str(tmp_path / "style.safetensors")
    st.save_file({"lora_unet_down_blocks_0_attn1_to_q.lora_down.weight": torch.zeros(2, 4)}, lora)
    assert det.main([d, lora, "--scan", str(tmp_path)]) == 0
    got = capsys.readouterr().out
    jdet.main([d, lora, "--scan", str(tmp_path)])
    want = capsys.readouterr().out
    assert got.replace(det.WORKER, JAX_WORKER) == want
    assert got.count('"path"') == 4  # two paths, then the scan's directory and file


def test_detector_cli_runs_as_a_module(tmp_path):
    d = make_tiny_checkpoint(tmp_path / "ckpt")
    out = subprocess.run([sys.executable, "-m", "dreamlab_tpu_torch.utils.model_detector", d],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    info = json.loads(out.stdout)
    assert (info["arch"], info["variant"], info["worker"]) == ("sd15", "SD15", det.WORKER)
