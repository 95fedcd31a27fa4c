"""Batch invariance: batching must never change a request's output.

cuBLAS and cuDNN choose their algorithm by shape, and the batch size is part
of the shape: on the H100 a convolution or a small-M matmul over a batch of 8
rounds some rows differently from the same row alone, and four LCM steps
carry that to whole pixel levels (a 512x512 batch row was 3 levels off its
solo run; chip_smoke.py checks it). Our own
kernels and row-wise ops (LayerNorm, softmax, elementwise) compute each row
the same way at any batch size. For the library calls, ``per_row`` issues one
call per batch row, so a row in a batch runs exactly the calls of its solo run.
The cost is more launches in batched calls; the bits are the solo run's.
"""

from __future__ import annotations

import torch


def per_row(fn, *xs):
    """``fn(*xs)`` computed one batch row at a time (dim 0) and concatenated."""
    b = xs[0].shape[0]
    if b == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(b)])
