"""A/B: what several heads per block and lane width cost on the card.

Port of ``scripts/ab_head_packing.py``, in three parts:

1. ``matmul_floors`` — bf16 ``torch.matmul`` at the attention's products:
   ``[4096, K] @ [K, 4096]`` for K in {40, 64, 128} and
   ``[4096, 4096] @ [4096, Nout]`` for Nout in {40, 128}. Equal times would
   mean a narrow head costs a matrix unit as much as a padded one.
2. ``flash_attention_packed3`` — three heads per block through the
   head-group kernel at pack 3 (on the route ``ops/flash_group.py::route``
   picks: ``"wgmma"``, ``csrc/flash_group_wgmma.cu``, for these bf16
   inputs), checked against the plain fp32 version at ``(8, 4096, 6, 40)``
   and timed beside the port's one-head kernel (H = 6 so that both run the
   same problem).
3. The one-head kernel at a true d = 128, which says what padding 40 lanes
   to 128 would cost here. Each variant is checked against the plain fp32
   version on its own inputs before any is timed.

The TPU probe also sweeps its Pallas kernel's block sizes. The port has no
such sweep: its one bf16 kernel takes its tiles from
``ops/flash_attention.py::wgmma_consumers``, which every tile choice leaves
byte for byte equal.

Times are device time from CUDA events (``scripts/timing.py``), the way
``chip_smoke.py`` times. Run on the card:
``python -m dreamlab_tpu_torch.scripts.ab_head_packing``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.scripts.timing import (TOL_BF16_P, bf16_check, compare, randn,
                                               report_checks, require_cuda)

SHAPE = (8, 4096, 6, 40)  # (B, N, H, D); H % 3 == 0 for the packed kernel

# launches of the group kernel through flash_attention_packed3 since the last reset
LAUNCHES = 0


def matmul_floors(iters: int = 10) -> dict:
    """bf16 matmul device times (ms) at the QK^T and PV shapes."""
    rs = np.random.RandomState(0)
    m, n = 4096, 4096
    fns, labels = {}, {}
    for k in (40, 64, 128):
        a, b = randn(rs, (m, k)), randn(rs, (k, n))
        fns[f"qk_K{k}"] = lambda a=a, b=b: torch.matmul(a, b)
        labels[f"qk_K{k}"] = f"QK^T-shape [{m},{k}]@[{k},{n}]"
    for nout in (40, 128):
        a, b = randn(rs, (m, 4096)), randn(rs, (4096, nout))
        fns[f"pv_N{nout}"] = lambda a=a, b=b: torch.matmul(a, b)
        labels[f"pv_N{nout}"] = f"PV-shape   [{m},4096]@[4096,{nout}]"
    out, rounds = compare(fns, iters)
    print("== matmul floors (bf16, device ms) ==", flush=True)
    for name, ms in out.items():
        print(f"  {labels[name]}: {ms:7.4f} ms  rounds {[round(t, 4) for t in rounds[name]]}",
              flush=True)
    return out


def flash_attention_packed3(q, k, v, *, scale: float):
    """[B, N, H, D] with H % 3 == 0 and 3 * D <= 128: three heads per block."""
    global LAUNCHES
    h, d = q.shape[2], q.shape[3]
    if h % 3 != 0 or 3 * d > fa.LANES:
        raise ValueError(f"packed3 needs H % 3 == 0 and 3 * D <= {fa.LANES}, got H={h}, D={d}")
    out = fg.flash_group(q, k, v, pack=3, scale=scale)
    if q.is_cuda:
        LAUNCHES += 1
    return out


def main(iters: int = 10) -> dict:
    """The matmul floors; then every attention kernel variant (the one-head
    kernel, packed3 on its route, the one-head kernel at d = 128) against
    the plain fp32 version on its inputs, and their device times beside the
    plain version and SDPA (a yardstick). Times no attention if a check fails
    (``failed`` lists it)."""
    require_cuda("ab_head_packing")
    rs = np.random.RandomState(0)
    b, n, h, d = SHAPE
    scale = d ** -0.5

    floors = matmul_floors(iters)

    q, k, v = (randn(rs, SHAPE) for _ in range(3))
    # the same kernel at true d = 128 lanes, the same problem otherwise
    q8, k8, v8 = (randn(rs, (b, n, h, 128)) for _ in range(3))
    kernels = {"one_head": lambda: fa.flash_attention(q, k, v, scale=scale),
               "packed3": lambda: flash_attention_packed3(q, k, v, scale=scale),
               "one_head_d128": lambda: fa.flash_attention(q8, k8, v8, scale=scale)}
    ref = fa.attention_plain(q.float(), k.float(), v.float(), scale)
    ref8 = fa.attention_plain(q8.float(), k8.float(), v8.float(), scale)
    # every variant runs on the tensor cores and rounds P, as the Pallas kernels do
    errs = {name: bf16_check(fn(), ref8 if name == "one_head_d128" else ref, TOL_BF16_P)
            for name, fn in kernels.items()}
    del ref, ref8
    print("against the plain fp32 version (bf16 inputs):", flush=True)
    failed = report_checks(errs)
    if failed:
        return {"shape": list(SHAPE), "matmul_floors_ms": floors, "checks": errs,
                "failed": failed}

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {**kernels,
           "plain": lambda: fa.attention_plain(q, k, v, scale),
           "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)}
    ms, rounds = compare(fns, iters)
    print(f"== attention variants at B{b} N{n} H{h} d{d} (device ms, median of rounds) ==",
          flush=True)
    for name, t in ms.items():
        print(f"  {name:14s} {t:8.3f}  rounds {[round(r, 3) for r in rounds[name]]}",
              flush=True)
    print(f"  true d=128 / d=40: x{ms['one_head_d128'] / ms['one_head']:.2f} "
          "(what padding 40 lanes to 128 would cost)", flush=True)
    return {"shape": list(SHAPE), "matmul_floors_ms": floors, "checks": errs,
            "failed": [], "one_head_ms": ms["one_head"], "packed3_ms": ms["packed3"],
            "packed3_route": fg.route(q, k, v, 3), "plain_ms": ms["plain"], "sdpa_ms": ms["sdpa"],
            "one_head_d128_ms": ms["one_head_d128"], "rounds_ms": rounds}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
