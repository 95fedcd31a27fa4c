"""PNG encoding from numpy and the standard library's zlib.

The port's counterpart of ``dreamlab_tpu/engine/tpu_worker.py::png_encode``
and its native encoder (``dreamlab_tpu/native/pngenc.c``): the same choices
(the "Up" row filter, zlib level 1) and the same ``tEXt`` metadata chunks
right after IHDR, which the UI reads to resume a generation's parameters.
No PIL and no C build.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray, RGB, RGBA)


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
