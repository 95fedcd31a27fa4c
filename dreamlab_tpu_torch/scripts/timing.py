"""Device timing and the check limit shared by the probes and ``chip_smoke.py``.

A time here is the card's time for a call: CUDA events around ``iters``
calls queued behind a spin kernel of about 50 ms. The host queues every call
while the card spins, so the calls then run back to back: host launch gaps
are excluded, and a tiny kernel is charged its device time (and the card's
own gaps between kernels), not the launch rate of the host. Each measurement
first keeps the card busy with the same call for ``WARMUP_S`` seconds, so
that its clocks have left their idle state; ``compare`` times several
variants in alternating rounds and keeps each one's median, so that a drift
of the clocks falls on all of them alike. (Summed kernel times under
torch.profiler were the first yardstick; on the H100 its windows now and then
lost some or all of their kernels, which read as a shorter time.)

Each probe holds every kernel variant it times against the plain fp32
version on the same inputs first (``bf16_check``), and times nothing if one
is off by more than a bf16 rounding of the output and ``TOL_BF16``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

WARMUP_S = 0.2
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's SM clock, longer if slower
MAX_QUEUE_S = 0.04  # host time to queue the timed calls, within the spin

# A kernel that computes in fp32 and rounds its output to bf16 once differs
# from the fp32 plain version on the same inputs by at most 2^-8 |x| at each
# output x (half an ulp), plus the fp32 summation order (about 1e-6 here).
# ``bf16_check`` measures what is left beyond that rounding and TOL_BF16
# bounds it. A kernel that dropped one key of 4096, or whose scale was 1 %
# off, leaves 5e-3 or more (tests/test_torch_probes.py shows both). A limit
# on the raw error fits no single size: at d = 128 with the d = 40 scale the
# outputs reach about 2, where one rounding alone moves them by up to 7.8e-3.
BF16_ROUNDING = 2.0 ** -8
TOL_BF16 = 1e-4


def max_err(got, want) -> float:
    """Largest absolute difference, in fp32."""
    return (got.float() - want.float()).abs().max().item()


def bf16_check(got, want) -> dict:
    """``got``'s largest error against ``want``, ``want``'s largest magnitude,
    and the largest error beyond one bf16 rounding of ``want`` (what
    TOL_BF16 bounds)."""
    want = want.float()
    diff = (got.float() - want).abs()
    return {"max_abs_err": diff.max().item(), "max_abs_want": want.abs().max().item(),
            "beyond_rounding": (diff - BF16_ROUNDING * want.abs()).max().item()}


def report_checks(checks: dict, tol: float = TOL_BF16) -> list:
    """Print each ``{name: bf16_check}``; return the names beyond ``tol``."""
    bad = []
    for name, c in checks.items():
        ok = c["beyond_rounding"] <= tol
        bad += [] if ok else [name]
        print(f"{'check' if ok else 'FAIL:'} {name}: max abs err {c['max_abs_err']:.3g} "
              f"(max |want| {c['max_abs_want']:.3g}), beyond one bf16 rounding "
              f"{c['beyond_rounding']:.3g} (limit {tol:g})", flush=True)
    return bad


def require_cuda(what: str) -> None:
    """Raise unless a CUDA device is present: a probe times the card or nothing."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs an NVIDIA GPU (no CUDA device found)")


def device_ms(fn, iters: int = 10, warmup_s: float = WARMUP_S) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel, after warm-up calls that last at least
    ``warmup_s``. Raises if the host took so long to queue the calls that
    the card may have waited for them."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    if queued_s > MAX_QUEUE_S:
        raise RuntimeError(f"the host took {queued_s:.3f} s to queue {iters} calls, longer "
                           f"than the card's {MAX_QUEUE_S} s of spinning: the time would "
                           "include host gaps")
    return start.elapsed_time(end) / iters


def compare(fns: dict, iters: int = 10, rounds: int = 3) -> tuple:
    """Each variant of an A/B timed in ``rounds`` rounds whose order
    alternates (A B C, C B A, A B C, ...): ({name: median device ms per
    call}, {name: [ms of each round]})."""
    names = list(fns)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name].append(device_ms(fns[name], iters))
    return {name: statistics.median(ts) for name, ts in samples.items()}, samples


def randn(rs: np.random.RandomState, shape, dtype=torch.bfloat16, device="cuda"):
    """Standard normal values from a numpy seed, as the JAX scripts make them."""
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device=device, dtype=dtype)
