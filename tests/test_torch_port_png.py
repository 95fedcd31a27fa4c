"""The port's PNG encoder (``dreamlab_tpu_torch/utils/png.py``), whose IDAT
stream is deflated in bands of rows on a thread pool.

Gray, RGB and RGBA images of one band, exactly two bands, a ragged last band,
512² and 1024² decode to their pixels through the port's decoder and the
benchmark's own; the IDAT payload inflates to the single-stream filtered
bytes; an image under two bands gives the bytes of one ``zlib.compress``
call; the bytes do not depend on the pool's threads or on encodes running
at once; a forked child encodes on a pool of its own; the banded stream is
within 0.5 % of the single stream's size; the tEXt chunks follow IHDR.
"""

import multiprocessing
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dreamlab_tpu_torch.utils import png
from port_bench import pngdec

TIMEOUT = 120
CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}


def band_rows(width, channels):
    return png._band_rows(width * channels + 1)


SIZES = {  # name -> (height, width) for a number of channels
    "one_band": lambda c: (band_rows(40, c), 40),
    "two_bands": lambda c: (2 * band_rows(256, c), 256),
    "ragged": lambda c: (2 * band_rows(200, c) + 7, 200),
    "512": lambda c: (512, 512),
    "1024": lambda c: (1024, 1024),
}
BANDS = {"one_band": 1, "two_bands": 2, "ragged": 3}


def image(height, width, channels, seed=0):
    """Noise, as the cells' images from random weights nearly are."""
    shape = (height, width) if channels == 1 else (height, width, channels)
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def smooth_plus_noise(n, seed=0):
    y, x = np.mgrid[:n, :n]
    smooth = np.stack([x * 255 // n, y * 255 // n, (x + y) * 127 // n], -1)
    return (smooth + np.random.RandomState(seed).randint(0, 24, smooth.shape)).astype(np.uint8)


def chunks(data):
    """[(kind, payload)] of a PNG, CRCs checked."""
    assert data[:8] == png._SIGNATURE
    out, pos = [], 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(kind + payload)
        out.append((kind, payload))
        pos += 12 + length
    return out


def filtered(arr):
    """The Up-filtered stream, filter byte first in each row, a row at a time."""
    rows = arr.reshape(arr.shape[0], -1).astype(np.int16)
    out = bytearray()
    for y in range(len(rows)):
        prior = rows[y - 1] if y else np.zeros_like(rows[0])
        out += b"\x02" + ((rows[y] - prior) % 256).astype(np.uint8).tobytes()
    return bytes(out)


def single_stream_png(arr, metadata=None):
    """What the encoder wrote before bands: one ``zlib.compress`` at level 1."""
    h, w = arr.shape[:2]
    c = arr.shape[2] if arr.ndim == 3 else 1
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    text = b"".join(png.text_chunk(k, v) for k, v in (metadata or {}).items())
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr) + text
            + png._chunk(b"IDAT", zlib.compress(filtered(arr), 1)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("color", CHANNELS)
def test_round_trip(color, size):
    c = CHANNELS[color]
    h, w = SIZES[size](c)
    arr = image(h, w, c)
    if size in BANDS:
        assert png.bands(arr.shape) == BANDS[size]
    data = png.encode_png(arr, {"parameters": "x"})
    want = arr.reshape(h, w, c)
    np.testing.assert_array_equal(png.decode_png(data), want)
    np.testing.assert_array_equal(pngdec.decode(data).reshape(h, w, c), want)


@pytest.mark.parametrize("size", ["two_bands", "ragged", "512", "1024"])
def test_idat_inflates_to_the_single_stream_filtered_bytes(size):
    h, w = SIZES[size](3)
    arr = image(h, w, 3, seed=1)
    assert png.bands(arr.shape) >= 2
    idat = [p for kind, p in chunks(png.encode_png(arr)) if kind == b"IDAT"]
    assert len(idat) == 1
    assert idat[0][:2] == zlib.compress(b"", 1)[:2]
    assert zlib.decompress(idat[0]) == filtered(arr)  # the Adler-32 checked too


@pytest.mark.parametrize("shape", [(16, 16, 3), (1, 1), (64, 64, 4), (64, 64), (8, 5, 3),
                                   (band_rows(40, 3), 40, 3), (band_rows(40, 1), 40)])
def test_under_two_bands_gives_one_zlib_call_s_bytes(shape):
    arr = np.random.RandomState(2).randint(0, 256, shape, np.uint8)
    assert png.bands(shape) == 1
    meta = {"parameters": "a cat\nSteps: 4", "seed": "7"}
    assert png.encode_png(arr, meta) == single_stream_png(arr, meta)
    assert png.encode_png(arr) == single_stream_png(arr)


@pytest.mark.parametrize("threads", [1, 8])
def test_bytes_do_not_depend_on_the_pool_s_threads(threads, monkeypatch):
    arrs = [image(1024, 1024, 3, seed=3), image(*SIZES["ragged"](4), 4, seed=4)]
    default = [png.encode_png(a, {"parameters": "x"}) for a in arrs]
    with ThreadPoolExecutor(threads) as pool:
        monkeypatch.setattr(png, "_executor", pool)
        assert [png.encode_png(a, {"parameters": "x"}) for a in arrs] == default
    for a, data in zip(arrs, default):
        assert zlib.decompress(chunks(data)[2][1]) == filtered(a)


def test_encodes_at_once_equal_serial_encodes():
    arrs = [image(512, 512, 3, seed=s) for s in range(4)] + [image(300, 777, 4, seed=9)]
    serial = [png.encode_png(a) for a in arrs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(4) as callers:
            futures = [callers.submit(png.encode_png, a) for a in arrs * 3]
            got = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert got == serial * 3


def _encode_in_child(arr, conn):
    conn.send(png.encode_png(arr))
    conn.close()


def test_a_forked_child_makes_its_own_pool():
    arr = image(512, 512, 3, seed=5)
    want = png.encode_png(arr)  # the parent's pool exists before the fork
    ctx = multiprocessing.get_context("fork")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_encode_in_child, args=(arr, child))
    proc.start()
    child.close()
    try:
        assert parent.poll(TIMEOUT), "the child's encode did not finish"
        assert parent.recv() == want
    finally:
        proc.join(TIMEOUT)
        if proc.is_alive():
            proc.kill()
    assert not proc.is_alive() and proc.exitcode == 0


@pytest.mark.parametrize("kind", ["noise-512", "noise-1024", "smooth+noise-512",
                                  "smooth+noise-1024"])
def test_banded_size_is_within_half_a_percent_of_one_stream(kind):
    n = int(kind.split("-")[1])
    arr = image(n, n, 3, seed=6) if kind.startswith("noise") else smooth_plus_noise(n)
    banded, single = len(png.encode_png(arr)), len(single_stream_png(arr))
    assert abs(banded - single) <= 0.005 * single


@pytest.mark.parametrize("size", ["one_band", "1024"])
def test_text_chunks_follow_ihdr(size):
    arr = image(*SIZES[size](3), 3, seed=7)
    kinds = [kind for kind, _ in chunks(png.encode_png(arr, {"parameters": "p", "seed": "1"}))]
    assert kinds == [b"IHDR", b"tEXt", b"tEXt", b"IDAT", b"IEND"]


@pytest.mark.parametrize("cut", [0, 1, 65520, 65521, 65522, 100_000, 299_999])
def test_adler32_combine_matches_one_pass(cut):
    data = np.random.RandomState(8).randint(0, 256, 300_000, np.uint8).tobytes()
    a, b = data[:cut], data[cut:]
    assert png._adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b)) == zlib.adler32(data)


def test_band_count_follows_the_row_width_alone():
    rows = band_rows(512, 3)
    assert rows == round(png.BAND_BYTES / (512 * 3 + 1))
    assert [png.bands((h, 512, 3)) for h in (1, rows, rows + 1, 2 * rows, 2 * rows + 1)] == [1, 1, 2, 2, 3]
    assert png.bands((512, 512)) == png.bands((512, 512, 1))
    assert png.bands((4, 100_000, 4)) == 4  # a row wider than a band: a band a row
