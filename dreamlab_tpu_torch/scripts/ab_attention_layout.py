"""A/B the flash-attention data path at the serving hot shape.

Port of ``scripts/ab_attention_layout.py``, at ``B=8, H=8, N=4096, D=40``:

  site    — the port's ``flash_attention`` on ``[B, N, H, D]`` (strided reads)
  folded  — ``kernel_call`` on pre-folded contiguous ``[B*H, N, 128]``, the
            lanes beyond D zero-padded
  nopad   — ``kernel_call`` on pre-folded ``[B*H, N, D]``
  xla     — the port's plain attention (materialized softmax)

The TPU probe's kernel was K1's Pallas body at ``pack=1`` on pre-folded
inputs. On the H100 a layout is a stride argument, so ``kernel_call`` is the
port's hand-written one-head kernel (``csrc/flash_attention.cu``) launched on
the ``[G, N, 1, lane]`` view at head width ``lane``; the scale stays the
caller's (D^-0.5), not lane^-0.5. PyTorch's SDPA is timed beside them as a
yardstick only, and the plain version and SDPA again on the folded lane-128
inputs (the work ``folded`` does).

Run on the card: ``python -m dreamlab_tpu_torch.scripts.ab_attention_layout``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch.nn.functional as F

from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.scripts.timing import (bf16_check, compare, randn, report_checks,
                                               require_cuda)

B, H, N, D = 8, 8, 4096, 40
LANES = 128
SITES = 5  # N = 4096 self-attention sites per UNet call at 512x512

# launches of the one-head kernel through kernel_call since the last reset
LAUNCHES = 0


def kernel_call(q, k, v, lane: int, *, scale: float):
    """Pre-folded ``[G, N, lane]`` x3 -> ``[G, N, lane]``: one head of width
    ``lane`` per row of G. Lanes that are zero in q and v come out zero."""
    global LAUNCHES
    if q.ndim != 3 or q.shape[-1] != lane or k.shape != v.shape or k.shape[-1] != lane:
        raise ValueError(f"kernel_call takes [G, N, {lane}] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    q4, k4, v4 = (x.unsqueeze(2) for x in (q, k, v))
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return fa.attention_plain(q4, k4, v4, scale).squeeze(2)
    out = fa.launch(q4, k4, v4, scale=scale)
    LAUNCHES += 1
    return out.squeeze(2)


def fold(x, lane: int):
    """[B, N, H, D] -> contiguous [B*H, N, lane], the lanes beyond D zero."""
    b, n, h, d = x.shape
    x = x.transpose(1, 2).reshape(b * h, n, d)
    return F.pad(x, (0, lane - d)).contiguous()


def main(iters: int = 10) -> dict:
    """The three kernel variants' errors against the plain fp32 version (the
    pad lanes of ``folded`` must be exactly 0), then every variant's device
    time. Times nothing if a check fails (``failed`` lists it)."""
    require_cuda("ab_attention_layout")
    rs = np.random.RandomState(0)
    q4, k4, v4 = (randn(rs, (B, N, H, D)) for _ in range(3))
    scale = D ** -0.5
    qf, kf, vf = (fold(x, LANES) for x in (q4, k4, v4))
    qn, kn, vn = (fold(x, D) for x in (q4, k4, v4))

    # one reference: attention is per head, and zero lanes of q, k and v
    # leave the logits unchanged and give zero output lanes
    ref = fa.attention_plain(q4.float(), k4.float(), v4.float(), scale)
    padded = kernel_call(qf, kf, vf, LANES, scale=scale)
    errs = {"site": bf16_check(fa.flash_attention(q4, k4, v4, scale=scale), ref),
            "folded": bf16_check(padded, fold(ref, LANES)),
            "nopad": bf16_check(kernel_call(qn, kn, vn, D, scale=scale), fold(ref, D))}
    pad_max = padded[:, :, D:].abs().max().item()
    del ref, padded
    print(f"# against the plain fp32 version (folded pad lanes max |x| {pad_max}):", flush=True)
    failed = report_checks(errs) + (["folded pad lanes"] if pad_max != 0 else [])
    if failed:
        return {"checks": errs, "pad_lanes_max": pad_max, "failed": failed}

    qt, kt, vt = (x.transpose(1, 2) for x in (q4, k4, v4))
    qf4, kf4, vf4 = (x.unsqueeze(2) for x in (qf, kf, vf))  # [G, N, 1, 128]
    qft, kft, vft = (x.unsqueeze(1) for x in (qf, kf, vf))  # SDPA's [G, 1, N, 128]
    times, rounds = compare({
        "site": lambda: fa.flash_attention(q4, k4, v4, scale=scale),
        "folded": lambda: kernel_call(qf, kf, vf, LANES, scale=scale),
        "nopad": lambda: kernel_call(qn, kn, vn, D, scale=scale),
        "xla": lambda: fa.attention_plain(q4, k4, v4, scale),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
        "xla_lane128": lambda: fa.attention_plain(qf4, kf4, vf4, scale),
        "sdpa_lane128": lambda: F.scaled_dot_product_attention(qft, kft, vft, scale=scale),
    }, iters)
    for name, ms in times.items():
        print(f"{name:12s} {ms:8.3f} ms  rounds {[round(t, 3) for t in rounds[name]]}"
              + ("  (yardstick, not the port's)" if name.startswith("sdpa") else ""),
              flush=True)
    best = min(times["folded"], times["nopad"])
    print(f"# per-step serving impact x{SITES} sites: site {SITES * times['site']:.1f} ms, "
          f"best-kernel {SITES * best:.1f} ms, xla {SITES * times['xla']:.1f} ms", flush=True)
    return {"shape": [B, N, H, D], "checks": errs, "pad_lanes_max": pad_max,
            "failed": [], **{f"{k}_ms": v for k, v in times.items()}, "rounds_ms": rounds}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
