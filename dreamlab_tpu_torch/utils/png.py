"""PNG encoding and decoding from numpy and the standard library's zlib.

The encoder is the port's counterpart of
``dreamlab_tpu/engine/tpu_worker.py::png_encode`` and its native encoder
(``dreamlab_tpu/native/pngenc.c``): the same choices (the "Up" row filter,
zlib level 1) and the same ``tEXt`` metadata chunks right after IHDR, which
the UI reads to resume a generation's parameters. The decoder reads what
the super-resolution service takes in without PIL: 8-bit, non-interlaced
gray, gray + alpha, RGB, RGBA and palette images, every row filter, every
chunk's CRC checked. No PIL and no C build.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray, RGB, RGBA)
# color type -> channels of the filtered rows (gray, RGB, palette, gray + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, payload: bytes) -> bytes:
    data = kind + payload
    return (struct.pack(">I", len(payload)) + data
            + struct.pack(">I", zlib.crc32(data) & 0xFFFFFFFF))


def text_chunk(keyword: str, value: str) -> bytes:
    """A PNG tEXt chunk (latin-1 payload per the spec)."""
    return _chunk(b"tEXt", keyword.encode("latin-1") + b"\x00"
                  + value.encode("latin-1", errors="replace"))


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
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    text = b"".join(text_chunk(k, v) for k, v in (metadata or {}).items())
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + text
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


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
