"""The benchmark's own PNG decoder: 8-bit greyscale, RGB or RGBA, not
interlaced, every filter type, chunk CRCs checked. It reads what the server
returned; it shares no code with the program's encoder or decoder."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int16)
    up = prior.astype(np.int16)
    for i in range(len(out)):
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(up[i])
        c = int(up[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int16)
    for i in range(len(out)):
        a = int(out[i - bpp]) if i >= bpp else 0
        out[i] = (out[i] + ((a + int(prior[i])) >> 1)) & 0xFF
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    ch = _CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("IDAT holds the wrong number of bytes")
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: a running sum along the row, per channel
            row = np.cumsum(line.reshape(width, ch).astype(np.uint32), axis=0).astype(
                np.uint8).reshape(stride)
        elif kind == 2:
            row = line + prior
        elif kind == 3:
            row = _average_row(line, prior, ch)
        elif kind == 4:
            row = _paeth_row(line, prior, ch)
        else:
            raise ValueError(f"unknown filter type {kind}")
        out[y] = row
        prior = row
    return out.reshape(height, width, ch)
