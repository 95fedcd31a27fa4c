"""PNG encoding and decoding from numpy and the standard library's zlib.

The encoder is the port's counterpart of
``dreamlab_tpu/engine/tpu_worker.py::png_encode`` and its native encoder
(``dreamlab_tpu/native/pngenc.c``): the same choices (the "Up" row filter,
zlib level 1) and the same ``tEXt`` metadata chunks right after IHDR, which
the UI reads to resume a generation's parameters.

The IDAT stream is deflated in bands of whole rows, one band a task on a
process-wide thread pool (zlib lets go of the GIL while it deflates), as
pigz does across a file: each band is a raw deflate primed with the 32 KiB
of filtered stream before it and ended by a sync flush (the last by the
stream's end), and the bands are joined behind one zlib header and the
Adler-32 of the whole stream. So it is one standard zlib stream in one IDAT
chunk. A band's rows follow from the row's width alone (``bands``), so an
image gives the same bytes on any host, with any number of threads; an
image of fewer than two bands is one ``zlib.compress`` call.

The decoder reads what the super-resolution service takes in without PIL:
8-bit, non-interlaced gray, gray + alpha, RGB, RGBA and palette images,
every row filter, every chunk's CRC checked. No PIL and no C build.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray, RGB, RGBA)
# color type -> channels of the filtered rows (gray, RGB, palette, gray + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Filtered bytes a deflate band aims at (the whole rows nearest it): of 64 and
# 128 KiB, 128 encoded 512² and 1024² images faster on an H100's 8-core host
# (PERF.md).
BAND_BYTES = 128 << 10
_WINDOW = 32 << 10  # deflate's window: the dictionary a band is primed with
_ADLER_BASE = 65521

_executor: Optional[ThreadPoolExecutor] = None
_executor_lock = threading.Lock()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    data = kind + payload
    return (struct.pack(">I", len(payload)) + data
            + struct.pack(">I", zlib.crc32(data) & 0xFFFFFFFF))


def text_chunk(keyword: str, value: str) -> bytes:
    """A PNG tEXt chunk (latin-1 payload per the spec)."""
    return _chunk(b"tEXt", keyword.encode("latin-1") + b"\x00"
                  + value.encode("latin-1", errors="replace"))


def _pool() -> ThreadPoolExecutor:
    """The process's band pool, made on first use: a thread for each CPU the
    process may run on."""
    global _executor
    with _executor_lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                           thread_name_prefix="png-band")
        return _executor


def _forget_pool() -> None:
    # a forked child has none of its parent's threads: it makes its own pool
    global _executor, _executor_lock
    _executor, _executor_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def _band_rows(row_bytes: int) -> int:
    """Rows of a band whose filtered rows are ``row_bytes`` each (filter byte
    included): the whole number nearest ``BAND_BYTES``, at least one."""
    return max(1, round(BAND_BYTES / row_bytes))


def bands(shape: Sequence[int]) -> int:
    """The number of deflate bands ``encode_png`` cuts an image of this shape
    ([H, W] or [H, W, C]) into; under 2 it makes one ``zlib.compress`` call."""
    h, w = shape[0], shape[1]
    c = shape[2] if len(shape) > 2 else 1
    return -(-h // _band_rows(w * c + 1))


def _adler32_combine(a: int, b: int, n: int) -> int:
    """The Adler-32 of two byte strings joined, from each one's Adler-32 and
    the second's length ``n`` (zlib's ``adler32_combine``)."""
    s1 = ((a & 0xFFFF) + (b & 0xFFFF) - 1) % _ADLER_BASE
    s2 = ((a >> 16) + (b >> 16) + n * ((a & 0xFFFF) - 1)) % _ADLER_BASE
    return s1 | s2 << 16


def _deflate_band(raw: memoryview, start: int, end: int, level: int):
    """Band ``raw[start:end]`` as raw deflate blocks primed with the window
    before it, ended by a sync flush (by the stream's end for the last band),
    and its Adler-32."""
    primed = {"zdict": raw[max(0, start - _WINDOW):start]} if start else {}
    z = zlib.compressobj(level, zlib.DEFLATED, -15, **primed)
    band = raw[start:end]
    body = z.compress(band) + z.flush(zlib.Z_FINISH if end == len(raw) else zlib.Z_SYNC_FLUSH)
    return body, zlib.adler32(band), end - start


def _deflate_banded(raw: memoryview, band_bytes: int, level: int) -> bytes:
    """One zlib stream of ``raw``, its bands of ``band_bytes`` deflated on the
    pool."""
    pool = _pool()
    futures = [pool.submit(_deflate_band, raw, start, min(start + band_bytes, len(raw)), level)
               for start in range(0, len(raw), band_bytes)]
    parts = [f.result() for f in futures]
    check = parts[0][1]
    for _, adler, n in parts[1:]:
        check = _adler32_combine(check, adler, n)
    return b"".join([zlib.compress(b"", level)[:2], *(body for body, _, _ in parts),
                     struct.pack(">I", check)])


def encode_png(arr: np.ndarray, metadata: Optional[Dict[str, str]] = None,
               *, level: int = 1) -> bytes:
    """[H, W] or [H, W, {1, 3, 4}] uint8 -> PNG bytes, with optional tEXt chunks."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, got {c}")
    rows = arr.reshape(h, w * c)
    # filter type 2 ("Up"): each row minus the row above, mod 256
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = memoryview(np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1).reshape(-1))
    if bands(arr.shape) < 2:
        idat = zlib.compress(raw, level)
    else:
        idat = _deflate_banded(raw, _band_rows(w * c + 1) * (w * c + 1), level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    text = b"".join(text_chunk(k, v) for k, v in (metadata or {}).items())
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + text
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


class UnsupportedPNG(ValueError):
    """A well-formed PNG of a kind ``decode_png`` does not read (a bit depth
    other than 8, interlacing)."""


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The image rows [H, stride] of the filtered, decompressed IDAT stream:
    None, Up and Sub rows vectorised, Average and Paeth byte by byte."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prior
        elif kind in (3, 4):
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) >> 1 if kind == 3 else _paeth(a, up[i], c)
                cur[i] = (cur[i] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]: C = 1 (gray), 2 (gray + alpha), 3 (RGB,
    and palette images, expanded through PLTE; a tRNS chunk is not read) or
    4 (RGBA). Raises ValueError on a bad signature or CRC or an unknown
    critical chunk, and UnsupportedPNG on anything but 8-bit
    non-interlaced images."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos, header, palette, idat = 8, None, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG: truncated before IEND")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC or length in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        elif kind[:1].isupper():
            raise ValueError(f"PNG: unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError("PNG: no IHDR")
    width, height, depth, ctype, compression, filtering, interlace = header
    if depth != 8 or ctype not in _CHANNELS or compression or filtering or interlace:
        raise UnsupportedPNG(f"PNG: only 8-bit non-interlaced gray, gray+alpha, RGB, RGBA and "
                         f"palette images are read (bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    channels = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    pixels = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError("PNG: palette index out of range")
        return palette[pixels[..., 0]]
    return pixels
