"""Minimal ONNX weight extraction, with no onnx or onnxruntime (copy of
``dreamlab_tpu/utils/onnx_weights.py``).

The super-resolution model ships as ``super-resolution-10.onnx``. The port
runs the network itself (``models/superres.py``) and needs only the
*initializer tensors* of the file, so this module walks the protobuf wire
format directly:

  ModelProto.graph (field 7) → GraphProto.node (1) / .initializer (5)
  NodeProto.input (1), .op_type (4)
  TensorProto.dims (1), .data_type (2), .float_data (4), .name (8),
  .raw_data (9)

Conv weights are matched to layers by *node order*, not by initializer name
(older torch exporters emit numeric names), so any 4-conv ESPCN export
loads. The result is numpy, HWIO as the JAX package's; ``models/superres.py``
turns it into the port's torch layout.
"""

from __future__ import annotations

import logging
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# ONNX TensorProto.DataType values we care about
_DT_FLOAT = 1
_DT_FLOAT16 = 10
_DT_DOUBLE = 11
_DT_INT64 = 7
_DT_INT32 = 6

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's bytes.

    value is: int for varint/fixed, bytes for length-delimited.
    """
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, i = _read_varint(buf, i)
        elif wire == _WIRE_I64:
            val = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wire == _WIRE_LEN:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == _WIRE_I32:
            val = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = _DT_FLOAT
    name = ""
    raw: Optional[bytes] = None
    floats: List[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims: packed or repeated varint
            if wire == _WIRE_LEN:
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    dims.append(d)
            else:
                dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 4:  # float_data (packed)
            floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    np_dtype = {
        _DT_FLOAT: np.float32,
        _DT_FLOAT16: np.float16,
        _DT_DOUBLE: np.float64,
        _DT_INT64: np.int64,
        _DT_INT32: np.int32,
    }.get(dtype)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    else:
        arr = np.asarray(floats, dtype=np_dtype)
    return name, arr.reshape(dims or (-1,))


def _parse_node(buf: bytes) -> Dict[str, object]:
    inputs: List[str] = []
    op_type = ""
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            inputs.append(val.decode("utf-8"))
        elif field == 4:
            op_type = val.decode("utf-8")
    return {"op_type": op_type, "inputs": inputs}


def parse_onnx_graph(path: str) -> Tuple[Dict[str, np.ndarray], List[Dict]]:
    """Return ({initializer name: array}, [node dicts in graph order])."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == _WIRE_LEN:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph in ModelProto (not an ONNX file?)")
    tensors: Dict[str, np.ndarray] = {}
    nodes: List[Dict] = []
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == _WIRE_LEN:
            name, arr = _parse_tensor(val)
            tensors[name] = arr
        elif field == 1 and wire == _WIRE_LEN:
            nodes.append(_parse_node(val))
    return tensors, nodes


def load_espcn_from_onnx(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Extract a 4-conv sub-pixel CNN's weights as the superres param tree.

    Matches Conv nodes in graph order (input names → initializers), converts
    torch OIHW kernels to HWIO, and returns float32 numpy
    ``{conv1..conv4: {w, b}}`` (``models/superres.from_hwio`` places them).
    """
    tensors, nodes = parse_onnx_graph(path)
    convs = [n for n in nodes if n["op_type"] == "Conv"]
    if len(convs) != 4:
        raise ValueError(
            f"{path}: expected 4 Conv nodes (ESPCN), found {len(convs)}"
        )
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for i, node in enumerate(convs, start=1):
        inits = [name for name in node["inputs"] if name in tensors]
        weights = [n for n in inits if tensors[n].ndim == 4]
        if not weights:
            raise ValueError(f"{path}: Conv #{i} has no 4-D weight initializer")
        w = tensors[weights[0]].astype(np.float32)  # OIHW
        biases = [n for n in inits if tensors[n].ndim == 1]
        b = (
            tensors[biases[0]].astype(np.float32)
            if biases
            else np.zeros((w.shape[0],), np.float32)
        )
        params[f"conv{i}"] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),  # → HWIO
            "b": np.ascontiguousarray(b),
        }
    # sanity: channel chain must connect (conv_i out == conv_{i+1} in)
    for i in (1, 2, 3):
        cout = params[f"conv{i}"]["w"].shape[3]
        cin_next = params[f"conv{i + 1}"]["w"].shape[2]
        if cout != cin_next:
            raise ValueError(
                f"{path}: conv{i} out={cout} does not feed conv{i + 1} "
                f"in={cin_next} — not a plain ESPCN graph"
            )
    return params
