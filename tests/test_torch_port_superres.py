"""The port's super-resolution against the JAX package and PIL, on the CPU.

- ONNX: the same synthesized files (the port's ``testing.write_espcn_onnx``)
  parsed by both packages' readers give equal leaves.
- ``forward`` / ``upscale_luma``: against ``dreamlab_tpu/models/superres.py``
  on the same params at tile 16, fp32, atol 1e-5, at ragged sizes.
- ``decode_png``: equal to PIL on every colour type it reads and on every
  row filter; the colour conversions and the bicubic resize (``utils/
  image_ops.py``) equal to PIL's, every pixel (PIL's fixed point is
  reproduced: 0 of 2^24 colours differ either way).
- ``upscale_bytes``: against the JAX ``SuperResWorker`` on one PNG, decoded
  RGB within 3 levels everywhere and a mean difference <= 0.5 (the
  network's fp32 luma may round the other way), in the network and the
  bicubic modes; JPEG through PIL within a mean of 1 level.
- The service: a full queue raises, a cancelled job is skipped, the factor
  comes from conv4, PIL's absence is named.
"""

import builtins
import io
import queue
import struct
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamlab_tpu.models import superres as jsr
from dreamlab_tpu.models.configs import SuperResConfig as JaxSRConfig
from dreamlab_tpu.serving.superres_service import SuperResWorker as JaxSRWorker
from dreamlab_tpu.serving.superres_service import load_sr_params as jax_load_sr_params
from dreamlab_tpu.utils.onnx_weights import load_espcn_from_onnx as jax_load_onnx
from dreamlab_tpu.utils.onnx_weights import parse_onnx_graph as jax_parse_onnx
from dreamlab_tpu_torch import testing
from dreamlab_tpu_torch.models import superres
from dreamlab_tpu_torch.models.configs import SUPERRES, SuperResConfig
from dreamlab_tpu_torch.serving import superres_service as srs
from dreamlab_tpu_torch.serving.superres_service import (SuperResService, SuperResWorker,
                                                         decode_rgb, load_sr_params)
from dreamlab_tpu_torch.utils import image_ops
from dreamlab_tpu_torch.utils.onnx_weights import load_espcn_from_onnx, parse_onnx_graph
from dreamlab_tpu_torch.utils.png import UnsupportedPNG, decode_png, encode_png
from dreamlab_tpu_torch.utils.safetensors import save_file
from tests.test_torch_port_img2img import one_torch_thread  # noqa: F401

TILE = SuperResConfig(tile=16)


def _hwio(params):
    """The port's params as the JAX package's numpy HWIO tree."""
    return {k: {"w": v["w"].numpy().transpose(2, 3, 1, 0), "b": v["b"].numpy()}
            for k, v in params.items()}


def _png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def _picture(h, w, seed=0):
    """Smooth colour gradients under a little noise (uint8 RGB)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin(x / 5.0 + y / 7.0)], -1) * 230.0
    img += np.random.RandomState(seed).uniform(0, 25, img.shape)
    return img.clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# ONNX weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numeric_names,float_data", [(False, False), (True, True)])
def test_onnx_files_read_alike_by_both_packages(tmp_path, numeric_names, float_data):
    params = testing.random_espcn(SUPERRES, seed=1)
    path = testing.write_espcn_onnx(str(tmp_path / "sr.onnx"), params,
                                    numeric_names=numeric_names, float_data=float_data)
    got, want = load_espcn_from_onnx(path), jax_load_onnx(path)
    for name in ("conv1", "conv2", "conv3", "conv4"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[name][leaf], want[name][leaf])
        np.testing.assert_array_equal(got[name]["w"], _hwio(params)[name]["w"])
    tensors, nodes = parse_onnx_graph(path)
    jt, jn = jax_parse_onnx(path)
    assert nodes == jn and sorted(tensors) == sorted(jt) and len(tensors) == 8
    assert [n["op_type"] for n in nodes] == ["Conv", "Relu"] * 3 + ["Conv", "DepthToSpace"]
    placed = load_sr_params(SUPERRES, path)
    assert all(torch.equal(placed[k]["w"], params[k]["w"]) for k in params)


def test_onnx_rejects_a_graph_that_is_not_espcn(tmp_path):
    path = str(tmp_path / "bad.onnx")
    with open(path, "wb") as f:
        f.write(testing._len_field(7, testing._len_field(1, testing._node_proto(
            "MatMul", ["a", "b"]))))
    for load in (load_espcn_from_onnx, jax_load_onnx):
        with pytest.raises(ValueError, match="expected 4 Conv"):
            load(path)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_init_params_draw_as_jax_does():
    want = jsr.init_params(JaxSRConfig(), np.random.RandomState(5))
    got = _hwio(superres.init_params(SUPERRES, np.random.RandomState(5)))
    for name in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[name][leaf], want[name][leaf])


@pytest.mark.parametrize("shape", [(16, 16), (20, 37), (33, 17), (5, 9)])
def test_upscale_luma_matches_jax(shape):
    params = testing.random_espcn(TILE, seed=2)
    y = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = jsr.upscale_luma(_hwio(params), JaxSRConfig(tile=16), y)
    got = superres.upscale_luma(params, TILE, torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (3 * shape[0], 3 * shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    x = np.random.RandomState(3).rand(2, 16, 16, 1).astype(np.float32)
    np.testing.assert_allclose(superres.forward(params, TILE, torch.from_numpy(x)).numpy(),
                               np.asarray(jsr.forward(_hwio(params), JaxSRConfig(tile=16),
                                                      jnp.asarray(x))), rtol=0, atol=1e-5)


def test_depth_to_space_order_is_the_jax_packages():
    """conv4 emitting the constant k on channel k: output pixel (3h + i,
    3w + j) must read channel 3 i + j, as the JAX CRD depth-to-space does."""
    params = testing.random_espcn(TILE, seed=0)
    params["conv4"]["w"].zero_()
    params["conv4"]["b"].copy_(torch.arange(9, dtype=torch.float32))
    out = superres.forward(params, TILE, torch.rand(1, 4, 5, 1))[0, ..., 0]
    i, j = np.mgrid[0:12, 0:15]
    np.testing.assert_array_equal(out.numpy(), (3 * (i % 3) + j % 3).astype(np.float32))
    want = jsr.forward(_hwio(params), JaxSRConfig(tile=16), jnp.zeros((1, 4, 5, 1)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want)[0, ..., 0])


# ---------------------------------------------------------------------------
# the PNG decoder
# ---------------------------------------------------------------------------


def _filtered_png(arr: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG whose row y uses filter ``filters[y % len(filters)]``
    (a test-side encoder of all five filters)."""
    h, w, c = arr.shape
    rows, prior, out = arr.reshape(h, w * c).astype(np.int32), np.zeros(w * c, np.int32), b""
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,ctype", [("L", 0), ("LA", 4), ("RGB", 2), ("RGBA", 6)])
def test_decode_png_equals_pil_on_every_colour_type_and_filter(mode, ctype):
    rs = np.random.RandomState(ctype)
    c = len(mode)
    arr = np.concatenate([_picture(23, 31), rs.randint(0, 256, (23, 31, 1), np.uint8)], -1)[..., :c]
    pil_png = _png(arr[..., 0] if c == 1 else arr, mode)
    ours = _filtered_png(arr, ctype, [0, 1, 2, 3, 4])
    for data in (pil_png, ours):
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(decode_png(data), want.reshape(arr.shape))
    np.testing.assert_array_equal(decode_png(ours), arr)
    if c in (1, 3, 4):
        np.testing.assert_array_equal(decode_png(encode_png(arr, {"parameters": "x"})), arr)
    np.testing.assert_array_equal(decode_rgb(pil_png),
                                  np.asarray(Image.open(io.BytesIO(pil_png)).convert("RGB")))


def test_decode_png_reads_palettes_and_refuses_what_it_does_not_read():
    img = Image.fromarray(_picture(19, 26)).quantize(64)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), want)
    np.testing.assert_array_equal(decode_rgb(data), want)
    wide = io.BytesIO()
    Image.fromarray((np.arange(60, dtype=np.uint16) * 1000).reshape(6, 10)).save(wide, "PNG")
    with pytest.raises(UnsupportedPNG, match="bit depth 16"):
        decode_png(wide.getvalue())
    # decode_rgb sends what decode_png does not read to PIL
    np.testing.assert_array_equal(decode_rgb(wide.getvalue()), np.asarray(
        Image.open(io.BytesIO(wide.getvalue())).convert("RGB")))
    bad = bytearray(encode_png(_picture(4, 4)))
    bad[-20] ^= 1  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a")


# ---------------------------------------------------------------------------
# colour conversions and bicubic resizing against PIL
# ---------------------------------------------------------------------------


def test_colour_conversions_equal_pil_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    cube = cube.reshape(4096, 4096, 3)
    got = image_ops.rgb_to_ycbcr(torch.from_numpy(cube)).numpy()
    assert (got != np.asarray(Image.fromarray(cube).convert("YCbCr"))).sum() == 0
    got = image_ops.ycbcr_to_rgb(torch.from_numpy(cube)).numpy()
    assert (got != np.asarray(Image.fromarray(cube, "YCbCr").convert("RGB"))).sum() == 0


@pytest.mark.parametrize("shape,size", [((16, 16, 3), (48, 48)), ((20, 37, 1), (111, 60)),
                                        ((64, 48, 3), (30, 70)), ((100, 80, 1), (25, 33)),
                                        ((1, 3, 1), (9, 3))])
def test_bicubic_resize_equals_pil(shape, size):
    arr = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(np.uint8)
    img = Image.fromarray(arr if shape[2] == 3 else arr[..., 0])
    want = np.asarray(img.resize(size, Image.BICUBIC)).reshape(size[1], size[0], shape[2])
    np.testing.assert_array_equal(image_ops.resize_bicubic(torch.from_numpy(arr), size).numpy(),
                                  want)


@pytest.mark.parametrize("shape,size", [((32, 32, 3), (48, 40)), ((40, 56, 3), (16, 24)),
                                        ((17, 23, 3), (9, 64)), ((64, 64, 3), (30, 64)),
                                        ((512, 512, 3), (64, 64)), ((16, 16, 3), (512, 512))])
def test_lanczos_resize_equals_pil(shape, size):
    """The ControlNet hint's resize (``Image.resize(..., LANCZOS)``) at up-
    and down-scales, byte for byte."""
    arr = np.random.RandomState(shape[1]).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(arr).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(image_ops.resize_lanczos(torch.from_numpy(arr), size).numpy(),
                                  want)


def test_rgb_to_l_equals_pil_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    cube = cube.reshape(4096, 4096, 3)
    got = image_ops.rgb_to_l(torch.from_numpy(cube)).numpy()
    assert (got != np.asarray(Image.fromarray(cube).convert("L"))).sum() == 0


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16"])
def test_decode_l_equals_pil(mode):
    """The inpainting mask's decode (``convert("L")``): PNGs of every kind
    the port reads, and a 16-bit one that goes to PIL."""
    rgb = _picture(21, 34)
    if mode == "P":
        img = Image.fromarray(rgb).quantize(32)
    elif mode == "I;16":
        img = Image.fromarray((rgb[..., 0].astype(np.uint16) * 257))
    else:
        img = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(srs.decode_l(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("L")))


# ---------------------------------------------------------------------------
# the worker against the JAX package's
# ---------------------------------------------------------------------------


def _rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("weights", [True, False], ids=["espcn", "bicubic"])
def test_upscale_bytes_matches_jax(weights):
    params = testing.random_espcn(TILE, seed=4) if weights else None
    ours = SuperResWorker(params, TILE, device="cpu")
    ref = JaxSRWorker(_hwio(params) if weights else None, JaxSRConfig(tile=16))
    data = _png(_picture(20, 27))
    for magnitude, max_pixels in ((1, None), (2, None), (3, 60 * 81 * 9)):
        got, passes = ours.upscale_bytes(data, magnitude, "png", 90, max_pixels)
        want, jpasses = ref.upscale_bytes(data, magnitude, "png", 90, max_pixels)
        assert passes == jpasses == min(magnitude, 2)
        diff = np.abs(_rgb(got) - _rgb(want))
        assert diff.max() <= 3 and diff.mean() <= 0.5, (diff.max(), diff.mean())
        if not weights:  # PIL's integer arithmetic, reproduced: the same pixels
            assert diff.max() == 0
    got, _ = ours.upscale_bytes(data, 1, "jpeg", 85)
    want, _ = ref.upscale_bytes(data, 1, "jpeg", 85)
    assert got[:2] == b"\xff\xd8"
    assert np.abs(_rgb(got) - _rgb(want)).mean() <= 1.0


def test_trained_weights_beat_bicubic_psnr(tmp_path):
    """``tests/test_superres_weights.py``'s analytic Catmull-Rom ESPCN,
    written by the port's ONNX writer and run through the port."""
    r = 3
    params = testing.random_espcn(TILE, seed=5)
    for leaf in params.values():
        leaf["w"].zero_()
        leaf["b"].zero_()
    lift = 2.0
    params["conv1"]["w"][0, 0, 2, 2] = 1.0  # identity tap of the 5x5 kernel
    params["conv1"]["b"][0] = lift
    for i in (2, 3):
        params[f"conv{i}"]["w"][0, 0, 1, 1] = 1.0

    def catmull_rom(t):
        return np.array([-0.5 * t ** 3 + t ** 2 - 0.5 * t, 1.5 * t ** 3 - 2.5 * t ** 2 + 1.0,
                         -1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t, 0.5 * t ** 3 - 0.5 * t ** 2])

    for dy in range(r):
        wy = catmull_rom(dy / r)
        for dx in range(r):
            wx = catmull_rom(dx / r)
            ty = np.array([wy[0], wy[1], wy[2] + wy[3]])
            tx = np.array([wx[0], wx[1], wx[2] + wx[3]])
            k = np.outer(ty, tx)
            params["conv4"]["w"][dy * r + dx, 0] = torch.from_numpy(k).float()
            params["conv4"]["b"][dy * r + dx] = float(-lift * k.sum())
    loaded = load_sr_params(TILE, testing.write_espcn_onnx(str(tmp_path / "t.onnx"), params))
    yy, xx = np.mgrid[0:48, 0:48].astype(np.float32)
    hi = 0.5 + 0.25 * np.sin(xx / 7.0) + 0.25 * np.cos(yy / 9.0)
    lo = hi[::r, ::r]
    up_net = superres.upscale_luma(loaded, TILE, torch.from_numpy(lo)).numpy()
    lo8 = torch.from_numpy((lo * 255).round().astype(np.uint8)[..., None])
    up_bic = image_ops.resize_bicubic(lo8, (48, 48)).numpy()[..., 0] / 255.0

    def psnr(a, b):
        a, b = a[9:-9, 9:-9], b[9:-9, 9:-9]
        return -10.0 * np.log10(float(np.mean((a - b) ** 2)) + 1e-12)

    assert psnr(up_net, hi) > psnr(up_bic, hi)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


def test_service_factor_weights_and_descriptions(tmp_path):
    cfg2 = SuperResConfig(upscale=2, tile=16)
    params = testing.random_espcn(cfg2, seed=6)
    st = str(tmp_path / "sr.safetensors")
    save_file({f"{k}.{'weight' if leaf == 'w' else 'bias'}": v
               for k, d in params.items() for leaf, v in d.items()}, st)
    svc = SuperResService(model_path=st, cfg=TILE, device="cpu")
    try:
        assert svc.cfg.upscale == 2 and svc.model_desc == "sr.safetensors"
        assert all(torch.equal(svc.params[k]["w"], params[k]["w"]) for k in params)
        png, passes = svc.submit(_png(_picture(10, 12)), magnitude=1).result(timeout=60)
        assert passes == 1 and decode_png(png).shape == (20, 24, 3)
    finally:
        svc.shutdown()
    for path in (None, str(tmp_path / "missing.onnx")):
        assert load_sr_params(TILE, path) is None
        assert jax_load_sr_params(JaxSRConfig(tile=16), path) is None
    svc = SuperResService(cfg=TILE, device="cpu")
    assert svc.params is None and svc.model_desc == "bicubic"
    svc.shutdown()
    svc = SuperResService(params=params, cfg=TILE, device="cpu")
    assert svc.model_desc == "espcn-injected" and svc.cfg.upscale == 2
    svc.shutdown()


def test_service_queue_backpressure_and_cancelled_jobs(monkeypatch):
    gate, started = threading.Event(), threading.Event()
    seen = []
    real = SuperResWorker.upscale_bytes

    def slow(self, data, *a):
        seen.append(data)
        started.set()
        gate.wait(10)
        return real(self, data, *a)

    monkeypatch.setattr(SuperResWorker, "upscale_bytes", slow)
    svc = SuperResService(cfg=TILE, queue_max=2, device="cpu")
    try:
        data = _png(_picture(8, 8))
        first = svc.submit(data)
        assert started.wait(10)
        doomed = svc.submit(b"doomed" + data)
        kept = svc.submit(data)
        with pytest.raises(queue.Full):
            svc.submit(data)
        assert doomed.cancel()
        gate.set()
        assert first.result(timeout=30)[1] == 1 and kept.result(timeout=30)[1] == 1
        assert len(seen) == 2 and all(s == data for s in seen)
    finally:
        gate.set()
        svc.shutdown()


def test_a_job_that_needs_pil_without_it_names_the_package(monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *a, **kw)

    worker = SuperResWorker(None, TILE, device="cpu")
    data = _png(_picture(8, 8))
    jpeg = io.BytesIO()
    Image.fromarray(_picture(8, 8)).save(jpeg, format="JPEG")
    monkeypatch.setattr(builtins, "__import__", no_pil)
    png, passes = worker.upscale_bytes(data, 1, "png", 90)  # PNG in and out: no PIL
    assert decode_png(png).shape == (24, 24, 3)
    for call in (lambda: worker.upscale_bytes(data, 1, "jpeg", 90),
                 lambda: worker.upscale_bytes(jpeg.getvalue(), 1, "png", 90)):
        with pytest.raises(RuntimeError, match="Pillow"):
            call()
    assert srs.encode_image(_picture(2, 2), "PNG", 0)[:4] == b"\x89PNG"


def test_service_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuperResService(cfg=TILE)
