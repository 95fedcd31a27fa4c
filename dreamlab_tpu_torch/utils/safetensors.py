"""A safetensors reader and writer on the standard library and torch.

The format: an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?}``
(offsets relative to the first byte after the header), then the raw
little-endian payload. The port does not depend on the ``safetensors``
package (the card's machine does not promise it).

``load_file`` maps the file copy-on-write (``mmap.ACCESS_COPY``) and returns
tensors that view the mapping: a 5 GB UNet file is read from the page cache
as the tensors are used (moved to the card, cast), never copied whole into
the process first, and a write to a tensor never reaches the file.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
_CODES = {v: k for k, v in DTYPES.items()}


def _read_header(f, path: str):
    """(header dict, header length) of an open safetensors file."""
    raw = f.read(8)
    if len(raw) < 8:
        raise ValueError(f"{path} is not a safetensors file (shorter than 8 bytes)")
    (n,) = struct.unpack("<Q", raw)
    if n > os.fstat(f.fileno()).st_size - 8:
        raise ValueError(f"{path} is not a safetensors file (header of {n} bytes runs "
                         "past the end)")
    try:
        header = json.loads(f.read(n))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path} is not a safetensors file (bad header: {e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path} is not a safetensors file (header is not an object)")
    return header, n


def read_header(path: str) -> Dict[str, dict]:
    """{name: {"dtype", "shape", "data_offsets"}} of every tensor of the
    file, from its header alone (no tensor data is read)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f, path)
    return {name: info for name, info in header.items() if name != "__metadata__"}


def read_shapes(path: str) -> Dict[str, list]:
    """{name: shape} of every tensor of the file, from its header alone."""
    return {name: [int(s) for s in info["shape"]] for name, info in read_header(path).items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU tensors viewing a copy-on-write map."""
    with open(path, "rb") as f:
        header, n = _read_header(f, path)
        size = f.seek(0, 2)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        shape = [int(s) for s in info["shape"]]
        count = math.prod(shape)
        begin, end = info["data_offsets"]
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if end - begin != nbytes or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {info['dtype']} "
                             f"spans bytes [{begin}, {end}) of a {size - start}-byte payload")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=start + begin).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; written as they are, in their dtype)."""
    header, offset = {}, 0
    for name, t in tensors.items():
        code = _CODES.get(t.dtype)
        if code is None:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors code")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # 8-byte aligned payload, as the reference writer pads
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
