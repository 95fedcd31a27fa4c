"""The port's model detector and worker-type detection against the JAX
package's, on the CPU.

Every input of tests/test_detector_checkpoint.py (torch .ckpt archives, a
legacy raw pickle, a malicious pickle, a diffusers directory's size policy)
and the single files of tests/test_single_file_sdxl.py, plus LoRA and
ControlNet files and directories: the port's ``ModelInfo`` must equal the
JAX detector's field for field (the serving worker's class path aside: the
port names its CUDA worker). ``detect_worker_type`` must raise
``WorkerCreationError`` with the reference's words where the reference does.
"""

import dataclasses
import io
import json
import os
import pickle

import pytest
import torch

from dreamlab_tpu.engine import worker_factory as jfactory
from dreamlab_tpu.utils import model_detector as jdet
from dreamlab_tpu_torch.engine.worker_factory import WorkerCreationError, detect_worker_type
from dreamlab_tpu_torch.utils import model_detector as det
from dreamlab_tpu_torch.utils import safetensors as st
from tests.test_single_file_sdxl import make_tiny_refiner_single_file, make_tiny_sdxl_single_file


def _ckpt(path, state):
    torch.save(state, str(path))  # a zip-format torch archive
    return str(path)


def _raw_pickle(path, obj):
    path.write_bytes(pickle.dumps(obj))
    return str(path)


def _safetensors(path, shapes):
    st.save_file({k: torch.zeros(s) for k, s in shapes.items()}, str(path))
    return str(path)


def _diffusers_dir(path, unet_cfg, index=None):
    (path / "unet").mkdir(parents=True)
    (path / "unet" / "config.json").write_text(json.dumps(unet_cfg))
    if index:
        (path / "model_index.json").write_text(json.dumps({"_class_name": index}))
    return str(path)


def _controlnet_dir(path, cad=768):
    path.mkdir()
    (path / "config.json").write_text(json.dumps({"_class_name": "ControlNetModel",
                                                  "cross_attention_dim": cad}))
    return str(path)


ATTN2_K = "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"

CASES = {
    "ckpt-sd15": lambda d: _ckpt(d / "model.ckpt", {"state_dict": {
        ATTN2_K: torch.zeros(4, 4),
        "first_stage_model.decoder.conv_in.weight": torch.zeros(1),
        "cond_stage_model.transformer.text_model.embeddings.token_embedding.weight":
            torch.zeros(1)}}),
    "ckpt-sdxl": lambda d: _ckpt(d / "sdxl.ckpt", {"state_dict": {
        "conditioner.embedders.1.model.transformer.resblocks.0.attn.in_proj_weight":
            torch.zeros(1),
        "model.diffusion_model.middle_block.1.transformer_blocks.0.attn2.to_k.weight":
            torch.zeros(1)}}),
    "ckpt-lora": lambda d: _ckpt(d / "style.ckpt", {
        "lora_unet_down_blocks_0_attn1_to_q.lora_down.weight": torch.zeros(2, 4)}),
    "ckpt-legacy": lambda d: _raw_pickle(d / "old.ckpt", {
        "state_dict": {"cond_stage_model.x": 1, "model.diffusion_model.y": 2}}),
    "ckpt-empty": lambda d: _raw_pickle(d / "empty.pt", {}),
    "st-sd15": lambda d: _safetensors(d / "sd15.safetensors", {ATTN2_K: (8, 768)}),
    "st-sd21": lambda d: _safetensors(d / "sd21.safetensors", {ATTN2_K: (8, 1024)}),
    "st-unknown-width": lambda d: _safetensors(d / "odd.safetensors", {ATTN2_K: (8, 512)}),
    "st-lora": lambda d: _safetensors(d / "lora.safetensors", {
        "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn2_to_k.lora_down.weight":
            (4, 2048),
        "unet.down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.lora_A.weight":
            (4, 2048)}),
    "st-controlnet": lambda d: _safetensors(d / "cn.safetensors", {
        "controlnet_cond_embedding.conv_in.weight": (16, 3, 3, 3), ATTN2_K: (8, 768)}),
    "st-ldm-controlnet": lambda d: _safetensors(d / "cn_ldm.safetensors", {
        "control_model.input_blocks.0.0.weight": (4, 4)}),
    "dir-sample-size": lambda d: _diffusers_dir(d / "ckpt", {
        "cross_attention_dim": 768, "sample_size": 96,
        "block_out_channels": [320, 640, 1280, 1280]}, "StableDiffusionPipeline"),
    "dir-sdxl": lambda d: _diffusers_dir(d / "xl", {"cross_attention_dim": 2048}),
    "dir-controlnet": lambda d: _controlnet_dir(d / "controlnet"),
    "dir-empty": lambda d: (d / "nothing").mkdir() or str(d / "nothing"),
    "sdxl-single-file": lambda d: make_tiny_sdxl_single_file(d)[0],
    "refiner-single-file": lambda d: make_tiny_refiner_single_file(d)[0],
}


def _fields(info):
    out = dataclasses.asdict(info)
    out.pop("worker")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_model_info_equals_jax(tmp_path, case):
    path = CASES[case](tmp_path)
    got, want = det.detect_model(path), jdet.detect_model(path)
    assert _fields(got) == _fields(want)
    assert (got.worker is None) == (want.worker is None)
    if got.arch is not None:
        assert got.worker == det.WORKER


def test_the_reference_expectations_hold(tmp_path):
    """tests/test_detector_checkpoint.py's own assertions, on the port."""
    info = det.detect_model(CASES["ckpt-sd15"](tmp_path))
    assert (info.format, info.cross_attention_dim, info.variant, info.arch) == (
        "checkpoint", 768, "SD15", "sd15")
    assert info.extra["has_dual_text_encoders"] is False
    info = det.detect_model(CASES["ckpt-sdxl"](tmp_path))
    assert (info.cross_attention_dim, info.arch, info.native_size) == (2048, "sdxl", 1024)
    assert "1216x832" in info.recommended_sizes
    info = det.detect_model(CASES["ckpt-lora"](tmp_path))
    assert info.is_lora and info.format == "lora"
    assert info.extra["size_policy"]["source"] == "lora"
    info = det.detect_model(CASES["dir-sample-size"](tmp_path))
    assert info.native_size == 768 and info.extra["size_policy"]["latent_sample_size"] == 96
    assert info.extra["size_policy"]["source"] == "diffusers:unet.config"


def test_malicious_pickle_is_never_executed(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {tmp_path / 'pwned'}",))

    buf = io.BytesIO()
    pickle.dump({"state_dict_key_with_text_encoder_2": Evil()}, buf)
    path = tmp_path / "evil.ckpt"
    path.write_bytes(buf.getvalue())
    info = det.detect_model(str(path))
    assert not os.path.exists(tmp_path / "pwned"), "the pickle was executed"
    assert info.format == "checkpoint" and info.cross_attention_dim == 2048
    assert _fields(info) == _fields(jdet.detect_model(str(path)))


def test_safetensors_shapes_come_from_the_header_alone(tmp_path):
    """read_shapes reads no tensor data: a file cut after its header still
    gives every shape (the payload is never touched)."""
    path = _safetensors(tmp_path / "big.safetensors", {"a": (64, 32), "b": (3,)})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    with open(path, "r+b") as f:
        f.truncate(8 + n)
    assert st.read_shapes(path) == {"a": [64, 32], "b": [3]}
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\0\0\0")
    with pytest.raises(ValueError, match="not a safetensors file"):
        st.read_shapes(str(short))


def test_scan_directory_equals_jax(tmp_path):
    for case in ("st-sd15", "st-lora", "dir-sample-size", "dir-controlnet", "ckpt-sd15"):
        CASES[case](tmp_path)
    got = [_fields(i) for i in det.scan_directory(str(tmp_path))]
    want = [_fields(i) for i in jdet.scan_directory(str(tmp_path))]
    assert got == want and len(got) == 3


def test_missing_path_raises_detection_error(tmp_path):
    with pytest.raises(det.DetectionError, match="does not exist"):
        det.detect_model(str(tmp_path / "nope"))
    with pytest.raises(WorkerCreationError, match="does not exist"):
        detect_worker_type(str(tmp_path / "nope"))


def test_extra_detectors_run_in_the_chain(tmp_path):
    seen = []
    d = det.ModelDetector()
    d.add_detector(lambda info: seen.append(info.variant) or None)
    d.add_detector(lambda info: dataclasses.replace(info, extra={**info.extra, "x": 1}),
                   index=0)
    info = d.detect(CASES["st-sd15"](tmp_path))
    assert seen == ["SD15"] and info.extra["x"] == 1 and info.arch == "sd15"


@pytest.mark.parametrize("case,match", [
    ("st-lora", "is a LoRA"), ("ckpt-lora", "is a LoRA"),
    ("dir-controlnet", "is a ControlNet"), ("st-controlnet", "is a ControlNet"),
    ("st-unknown-width", "unsupported model"), ("dir-empty", "unsupported model"),
])
def test_detect_worker_type_raises_where_the_reference_does(tmp_path, case, match):
    path = CASES[case](tmp_path)
    with pytest.raises(WorkerCreationError, match=match) as got:
        detect_worker_type(path)
    with pytest.raises(jfactory.WorkerCreationError) as want:
        jfactory.detect_worker_type(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case,arch", [("ckpt-sd15", "sd15"), ("st-sd21", "sd15"),
                                       ("dir-sdxl", "sdxl"), ("sdxl-single-file", "sdxl"),
                                       ("refiner-single-file", "sdxl")])
def test_detect_worker_type_serving_arch(tmp_path, case, arch):
    path = CASES[case](tmp_path)
    assert detect_worker_type(path) == jfactory.detect_worker_type(path) == arch
