"""A/B: flash attention over a head group read in place, against the one-head kernel.

Port of ``scripts/ab_transpose_free.py``. The TPU probe asked whether q/k/v
could stay in their token-major ``[B, N, G, L]`` layout (a pure reshape of
``[B, N, H, D]``, ``G = H / pack``, ``L = pack * d``) instead of being folded
by a transpose; Mosaic's tiling refused the 4-D block. On the H100 a layout
is a stride: ``flash_attention_4d`` runs the head-group kernel
(``csrc/flash_group.cu``) on the reshaped tensors in place, with ``pack``
from the JAX package's packing rule, beside the port's one-head kernel at the
same shapes, with the plain version and PyTorch's SDPA timed as yardsticks.

Run on the card: ``python -m dreamlab_tpu_torch.scripts.ab_transpose_free``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch.nn.functional as F

from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.scripts.timing import (bf16_check, compare, randn, report_checks,
                                               require_cuda)

# (B, N, H, D, tag): pack 3 at L = 120, and pack 2 at L = 128
SHAPES = [(8, 4096, 6, 40, "sd15ish-H6"), (2, 4096, 10, 64, "sdxl-4k")]

# launches of the group kernel through this wrapper since the last reset
LAUNCHES = 0


def flash_attention_4d(q, k, v, *, scale: float):
    """[B, N, H, D] attention through the head-group kernel, ``pack`` from
    ``pack_geometry(H, D)``: the group is read in place, no transpose."""
    global LAUNCHES
    pack, _ = fa.pack_geometry(q.shape[2], q.shape[3])
    out = fg.flash_group(q, k, v, pack=pack, scale=scale)
    if q.is_cuda:
        LAUNCHES += 1
    return out


def main(iters: int = 10) -> dict:
    """At each shape: both kernels' errors against the plain fp32 version,
    then the device times of the one-head kernel, the group kernel, the plain
    version and SDPA (a yardstick). Times nothing if a check fails
    (``failed`` lists it)."""
    require_cuda("ab_transpose_free")
    rs = np.random.RandomState(0)
    errs, shapes = {}, {}
    for b, n, h, d, tag in SHAPES:
        q, k, v = (randn(rs, (b, n, h, d)) for _ in range(3))
        s = d ** -0.5
        pack, lanes = fa.pack_geometry(h, d)
        ref = fa.attention_plain(q.float(), k.float(), v.float(), s)
        checks = {f"{tag}/group": bf16_check(flash_attention_4d(q, k, v, scale=s), ref),
                  f"{tag}/one_head": bf16_check(fa.flash_attention(q, k, v, scale=s), ref)}
        del ref
        print(f"{tag}: pack {pack}, L={lanes}; against the plain fp32 version:", flush=True)
        errs.update(checks)
        failed = report_checks(checks)
        if failed:
            return {"checks": errs, "failed": failed}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, rounds = compare({
            "one_head": lambda: fa.flash_attention(q, k, v, scale=s),
            "group": lambda: flash_attention_4d(q, k, v, scale=s),
            "plain": lambda: fa.attention_plain(q, k, v, s),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=s)}, iters)
        print(f"{tag}: one head per block {ms['one_head']:.3f} ms | head group in place "
              f"{ms['group']:.3f} ms | plain {ms['plain']:.3f} ms | sdpa {ms['sdpa']:.3f} ms "
              f"(yardstick) (median of rounds {rounds})", flush=True)
        shapes[tag] = {"shape": [b, n, h, d], "pack": pack, "lanes": lanes,
                       **{f"{name}_ms": t for name, t in ms.items()}, "rounds_ms": rounds}
        del q, k, v, qt, kt, vt
    return {"checks": errs, "failed": [], "shapes": shapes}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
