"""Batch invariance: batching must never change a request's output.

cuBLAS and cuDNN choose their algorithm by shape, and the batch size is part
of the shape: on the H100 some convolutions and small-M matmuls over a batch
of 8 round a row differently from the same row alone, and four LCM steps
carry that to whole pixel levels (a 512x512 batch row was 3 levels off its
solo run; chip_smoke.py checks it). Our own kernels and row-wise ops
(LayerNorm, softmax, elementwise) compute each row the same way at any batch
size. Other calls of a library go through ``row_chunks`` with a key, and run
batched only where the card has shown that every row of the batched call
equals that row's solo call, byte for byte (on an H100, 72 of the 89 distinct
calls of SD1.5's 512x512 batch-8 program; not most 3x3 convs at 16x16 to
64x64, two small-M linears and the VAE's one-head attention,
``scripts/ab_batching.py``):

- a batch of one calls the function directly: no probe, no lookup;
- CPU tensors run one call a row (``per_row``): the CPU is the test host;
- on the card, outside a graph capture, the first call of a key at a batch
  size is a probe: the batched call, then each row's solo call compared with
  its row. The answer is kept for the process, per key and batch size: a key
  whose rows all matched runs batched from then on, any other one call a
  row. The eager run before each bucket's capture (``pipeline.py``,
  ``_GraphProgram``) probes every key of the bucket on its own activations;
- while a graph is being captured a key is only looked up, never probed, and
  a key not yet decided runs one call a row, which is always safe.

A call whose rows each hold more than their output (attention's scores) says
how much (``scratch``): a batch whose calls would hold more than
``SCRATCH_BYTES`` together runs one call a row, unprobed. The VAE's one-head
attention holds 3.2 GB a row at 1024x1024, so that batching it, or probing
it, would multiply the card's peak.

The key is what the library's choice can depend on: the call site names the
op and its fixed arguments (weight shape, strides and dtype, stride, padding,
bias), and ``row_chunks`` adds the inputs' dtypes, shapes, strides and
device. Counters ``batching.calls_batched`` and ``batching.calls_per_row``
count the library calls that captured graphs issue, one per call: a batched
call counts one, a per-row site its batch size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils import tracing

# (site key, inputs' signature) -> rows per library call: the batch size or 1
_rows: Dict[Tuple, int] = {}

# the most that one batched call may hold besides its output: 1 GiB, 1.3 % of
# an H100's memory; SD1.5's and SDXL's batched attentions hold at most 0.3 GiB
# at batch 8
SCRATCH_BYTES = 1 << 30

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _probes(x: torch.Tensor) -> bool:
    """Whether a tensor's calls are probed and batched: on the card only."""
    return x.is_cuda


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def per_row(fn, *xs):
    """``fn(*xs)`` computed one batch row at a time (dim 0) and concatenated."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])])


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte equality (-0.0 is not 0.0; a NaN equals its own bits)."""
    as_int = _INT_OF_SIZE[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def _probe(fn, xs) -> Tuple[torch.Tensor, int]:
    """The batched call and whether each row equals its solo call: (the
    result, rows per call). Each solo output is freed before the next row's,
    so the probe holds the batched output and one row; then the blocks the
    probe freed go back to the device. Cached, they split the allocator's
    large blocks: SD1.5's 512x512 batch-8 eager run on an H100 reserved 4.16
    GiB beyond its start so, 3.25 with the release and 3.78 one row at a time."""
    try:
        out = fn(*xs)
        for i in range(out.shape[0]):
            if not same_bytes(out[i:i + 1], fn(*(x[i:i + 1] for x in xs))):
                del out
                return per_row(fn, *xs), 1
        return out, out.shape[0]
    finally:
        torch.cuda.empty_cache()


def signature(key: Tuple, xs) -> Tuple:
    """``key`` with the device and each input's dtype, shape and strides."""
    return (key, xs[0].device, *((x.dtype, tuple(x.shape), x.stride()) for x in xs))


def row_chunks(key: Tuple, fn, *xs, scratch: int = 0):
    """``fn(*xs)``, each batch row (dim 0 of every ``xs``) the bytes of its
    solo call: batched where the card showed that for ``key`` at this batch
    size, else one call a row (see the module's text). ``scratch``: the
    bytes a row's call holds besides its output."""
    b = xs[0].shape[0]
    if b == 1:
        return fn(*xs)
    if not _probes(xs[0]):
        return per_row(fn, *xs)
    full = signature(key, xs)
    rows = 1 if b * scratch > SCRATCH_BYTES else _rows.get(full)
    if _capturing():
        batched = rows == b
        tracing.count("batching.calls_batched" if batched else "batching.calls_per_row",
                      1 if batched else b)
        return fn(*xs) if batched else per_row(fn, *xs)
    if rows is None:
        out, _rows[full] = _probe(fn, xs)
        return out
    return fn(*xs) if rows == b else per_row(fn, *xs)


def decisions() -> Dict[Tuple, int]:
    """Every decided key: (site key, device, inputs' signature) -> rows per call."""
    return dict(_rows)


def reset() -> None:
    """Forget every decision (the next call of each key probes again)."""
    _rows.clear()
