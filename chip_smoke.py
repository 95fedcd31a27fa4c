#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``dreamlab_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and nvcc, imports nothing of JAX, and exits non-zero if any phase fails:

1. prints the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
2. builds the CUDA kernels from ``dreamlab_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card, and a
   tiny fp32 pipeline on the card (kernels) against the same on the CPU
   (plain versions, which the CPU tests hold to the JAX package);
4. times each kernel (device time, ``scripts/timing.py::device_ms``) at the
   shapes one 512x512 request gives it (found by a census run), beside its
   plain version, a library call and its bound;
5. drives the main path at SD1.5's full width with seeded random bf16
   weights: 20 timed CudaPipelineWorker.run_job requests (512x512, 4 LCM
   steps), one of them a repeat that must be byte-identical, and run_jobs
   batches of 8 whose row must match that spec's solo run; launch counts must
   show every kernel ran;
6. probes phase: holds the probes' kernels (K4 ``flash_attention_4d``, K5
   ``kernel_call`` at lanes 40 and 128, K6 ``flash_attention_packed3``) in
   fp32 against their plain versions at the probes' full shapes, then runs
   the three probe entry points of ``dreamlab_tpu_torch/scripts`` with their
   launch counts reset. Each probe first holds every bf16 kernel variant it
   times against the plain fp32 version on its own inputs (beyond one bf16
   rounding of the output: ``scripts/timing.py::TOL_BF16``), then times them beside the plain
   version and SDPA; the phase reads their errors and times, adds each
   kernel's bound, and prints one ``{"probes": {...}}`` line;
7. prints the ``{"kernels": [...]}`` line, the main path's numbers, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import platform
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.models import layers
from dreamlab_tpu_torch.ops import _build, attention
from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.ops import groupnorm as gn
from dreamlab_tpu_torch.pipeline import LCMPipeline
from dreamlab_tpu_torch.scripts import ab_attention_layout, ab_head_packing, ab_transpose_free
from dreamlab_tpu_torch.scripts.timing import TOL_BF16, device_ms, max_err
from dreamlab_tpu_torch.testing import random_bundle

# H100 SXM peaks (NVIDIA data sheet, dense): the bound is the larger of
# operations over the peak for the inputs' type and bytes over HBM bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

TOL_FLASH = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_GN = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
TOL_GN_COEFFS = 1e-4  # fp32 statistics over up to 1M values, summed in another order

STEPS = 4
SIZE = 512
LATENCY_SAMPLES = 20  # batch-1 requests timed on the main path (p50 over them)
BATCH8_SAMPLES = 3  # run_jobs calls of 8 timed (img/s from their median)
FAILURES = []


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def expect(ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(what)
        log(f"FAIL: {what}")


def end_phase(name: str) -> None:
    if FAILURES:
        log(f"phase {name} failed: {FAILURES}")
        sys.exit(1)


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(errs) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for b, n, m, h, d in [(1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80),
                              (8, 4096, 4096, 8, 40), (1, 256, 77, 8, 40),
                              (1, 256, 1000, 8, 80)]:
            q, k, v = (randn(s, dtype, i) for i, s in enumerate(
                [(b, n, h, d), (b, m, h, d), (b, m, h, d)]))
            got = fa.flash_attention(q, k, v)
            want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
            err = (got.float() - want).abs().max().item()
            log({"check": "flash", "dtype": str(dtype), "shape": [b, n, m, h, d], "max_abs_err": err})
            expect(err <= TOL_FLASH[dtype], f"flash {dtype} {[b, n, m, h, d]} err {err}")
            if dtype == torch.bfloat16:
                errs["flash"] = max(errs["flash"], err)
            del q, k, v, got, want
        torch.cuda.empty_cache()

        for shape in [(1, 64, 64, 320), (1, 16, 16, 2560), (1, 512, 512, 128), (2, 5, 7, 64)]:
            c = shape[-1]
            x = randn(shape, dtype, 10)
            gamma = (1 + 0.1 * randn((c,), torch.float32, 11)).to(dtype)
            beta = (0.1 * randn((c,), torch.float32, 12)).to(dtype)
            groups = 32 if c >= 128 else 8
            a, sh = gn.group_norm_coeffs(x, gamma, beta, groups=groups)
            a0, sh0 = gn.group_norm_coeffs_plain(x.float(), gamma.float(), beta.float(),
                                                 groups=groups)
            err2 = max((a - a0).abs().max().item(), (sh - sh0).abs().max().item())
            expect(err2 <= TOL_GN_COEFFS, f"gn coeffs {dtype} {shape} err {err2}")
            for silu in (True, False):
                y = gn.scale_shift_silu(x, a0, sh0, silu=silu)
                y0 = gn.scale_shift_silu_plain(x.float(), a0, sh0, silu=silu)
                err3 = (y.float() - y0).abs().max().item()
                full = gn.fused_group_norm_silu(x, gamma, beta, groups=groups, silu=silu)
                want = gn.group_norm_plain(x.float(), gamma.float(), beta.float(),
                                           groups=groups, silu=silu)
                err = (full.float() - want).abs().max().item()
                log({"check": "group_norm_silu", "dtype": str(dtype), "shape": list(shape),
                     "silu": silu, "coeffs_err": err2, "apply_err": err3, "max_abs_err": err})
                expect(err3 <= TOL_GN[dtype], f"gn apply {dtype} {shape} {silu} err {err3}")
                expect(err <= TOL_GN[dtype], f"gn {dtype} {shape} {silu} err {err}")
                if dtype == torch.bfloat16:
                    errs["gn_apply"] = max(errs["gn_apply"], err3)
            if dtype == torch.bfloat16:
                errs["gn_stats"] = max(errs["gn_stats"], err2)


def check_small_pipeline() -> None:
    """A tiny fp32 pipeline through the kernels (flash at 1024 tokens, d = 16)
    against the plain versions on the CPU: same weights, same seed."""
    bundle = random_bundle(tiny=True, seed=3)
    call = dict(height=64, width=64, num_inference_steps=2, seed=7, batch=2)
    f0, g0 = fa.LAUNCHES, gn.APPLY_LAUNCHES
    gpu = LCMPipeline(bundle, dtype=torch.float32).generate("a cat at sunset", **call)
    expect(fa.LAUNCHES > f0 and gn.APPLY_LAUNCHES > g0, "tiny pipeline launched no kernel")
    cpu = LCMPipeline(bundle, dtype=torch.float32, device="cpu").generate(
        "a cat at sunset", **call)
    lat_err = float(np.abs(gpu.latents - cpu.latents).max())
    px = np.abs(gpu.images.astype(np.int16) - cpu.images.astype(np.int16))
    log({"check": "tiny_pipeline_cuda_vs_cpu", "latents_max_abs_err": lat_err,
         "pixels_max_delta": int(px.max()), "pixels_moved": float((px > 0).mean())})
    # the golden test's bounds (tests/test_golden.py)
    expect(np.allclose(gpu.latents, cpu.latents, rtol=1e-4, atol=1e-3), "tiny latents")
    expect(px.max() <= 1 and (px > 0).mean() < 0.01, "tiny pixels")


# ---------------------------------------------------------------------------
# phase 4: census of the kernels' shapes on one request, and timing
# ---------------------------------------------------------------------------


def census(pipe) -> collections.Counter:
    """Shapes each kernel wrapper sees in one batch-1 512x512 request."""
    seen = collections.Counter()
    flash, gnorm = attention.flash_attention, layers.fused_group_norm_silu

    def rec_flash(q, k, v, **kw):
        seen[("flash", tuple(q.shape), k.shape[1])] += 1
        return flash(q, k, v, **kw)

    def rec_gn(x, scale, bias, **kw):
        seen[("gn", tuple(x.shape), kw["groups"])] += 1
        return gnorm(x, scale, bias, **kw)

    attention.flash_attention, layers.fused_group_norm_silu = rec_flash, rec_gn
    try:
        pipe.generate("census", height=SIZE, width=SIZE, num_inference_steps=STEPS, seed=0)
    finally:
        attention.flash_attention, layers.fused_group_norm_silu = flash, gnorm
    return seen


def time_kernels(seen, dtype) -> dict:
    rows = {k: collections.defaultdict(float) for k in ("flash", "gn_stats", "gn_apply", "gn")}
    for (kind, shape, extra), count in sorted(seen.items()):
        if kind == "flash":
            b, n, h, d = shape
            m = extra
            q, k, v = randn((b, n, h, d), dtype, 1), randn((b, m, h, d), dtype, 2), \
                randn((b, m, h, d), dtype, 3)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            t = {"ms": device_ms(lambda: fa.flash_attention(q, k, v)),
                 "plain_ms": device_ms(lambda: fa.attention_plain(q, k, v, d ** -0.5), 3),
                 "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))}
            elt = q.element_size()
            bms, by = bound_ms(4.0 * b * h * n * m * d, elt * (2 * b * n * h * d + 2 * b * m * h * d),
                               dtype)
            log({"time": "flash", "shape": [b, n, m, h, d], "count": count, **t,
                 "bound_ms": bms, "bound_by": by})
            _accumulate(rows["flash"], t, bms, by, count)
            continue
        groups = extra
        x = randn(shape, dtype, 4)
        c = shape[-1]
        gamma, beta = torch.ones(c, device="cuda", dtype=dtype), torch.zeros(
            c, device="cuda", dtype=dtype)
        a, sh = gn.group_norm_coeffs(x, gamma, beta, groups=groups)
        xn = x.permute(0, 3, 1, 2)
        nbytes, numel = x.numel() * x.element_size(), x.numel()
        coeff_bytes = 2 * 4 * shape[0] * c
        t2 = {"ms": device_ms(lambda: gn.group_norm_coeffs(x, gamma, beta, groups=groups)),
              "plain_ms": device_ms(lambda: gn.group_norm_coeffs_plain(x, gamma, beta,
                                                                     groups=groups)),
              "library_ms": None}
        b2 = bound_ms(4.0 * numel, nbytes + coeff_bytes, torch.float32)
        t3 = {"ms": device_ms(lambda: gn.scale_shift_silu(x, a, sh)),
              "plain_ms": device_ms(lambda: gn.scale_shift_silu_plain(x, a, sh)),
              "library_ms": None}
        b3 = bound_ms(6.0 * numel, 2 * nbytes + coeff_bytes, torch.float32)
        tc = {"ms": device_ms(lambda: gn.fused_group_norm_silu(x, gamma, beta, groups=groups)),
              "plain_ms": device_ms(lambda: gn.group_norm_plain(x, gamma, beta, groups=groups,
                                                              silu=True)),
              "library_ms": device_ms(lambda: F.silu(F.group_norm(xn, groups, gamma, beta)))}
        bc = bound_ms(10.0 * numel, 2 * nbytes, torch.float32)
        log({"time": "gn", "shape": list(shape), "count": count, "stats": {**t2, "bound_ms": b2[0]},
             "apply": {**t3, "bound_ms": b3[0]}, "fused": {**tc, "bound_ms": bc[0]}})
        _accumulate(rows["gn_stats"], t2, *b2, count)
        _accumulate(rows["gn_apply"], t3, *b3, count)
        _accumulate(rows["gn"], tc, *bc, count)
    return rows


def _accumulate(row, t, bms, by, count) -> None:
    """Per-request totals: each shape's time times its launches per request."""
    for key in ("ms", "plain_ms", "library_ms"):
        row[key] = None if t[key] is None or row.get(key, 0.0) is None else \
            row.get(key, 0.0) + count * t[key]
    row["bound_ms"] += count * bms
    row[f"bound_{by}_ms"] += count * bms
    row["launches_per_request"] += count


# ---------------------------------------------------------------------------
# phase 5: main path
# ---------------------------------------------------------------------------


def png_pixels(png: bytes) -> np.ndarray:
    """Decode the port's own PNGs (8-bit RGB, "Up" row filter, one IDAT)."""
    w, h = struct.unpack(">II", png[16:24])
    pos, idat = 8, b""
    while pos < len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            idat += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if not (rows[:, 0] == 2).all():
        raise ValueError("not a PNG of the port's writer (row filter other than Up)")
    return np.cumsum(rows[:, 1:], axis=0, dtype=np.uint8).reshape(h, w, 3)


def check_png(png: bytes) -> None:
    expect(png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
           and struct.unpack(">II", png[16:24]) == (SIZE, SIZE), "PNG header / IHDR 512x512")


def host_cpu() -> str:
    """The host CPU: the main path is host-bound (PERF.md), so its times
    depend on the machine a call lands on."""
    model = platform.processor() or platform.machine()
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{model}, {os.cpu_count()} CPUs"


def reset_counts() -> None:
    fa.LAUNCHES = 0
    gn.STATS_LAUNCHES = 0
    gn.APPLY_LAUNCHES = 0


def counts() -> dict:
    return {"flash": fa.LAUNCHES, "gn_stats": gn.STATS_LAUNCHES, "gn_apply": gn.APPLY_LAUNCHES}


def main_path(worker, per_request) -> dict:
    spec = lambda seed: GenSpec(f"a mountain at sunset, seed {seed}", size=f"{SIZE}x{SIZE}",
                                num_inference_steps=STEPS, seed=seed)
    reset_counts()
    latency, pngs = [], {}
    for seed in (1, 2, 3):
        t0 = time.perf_counter()
        if seed == 3:
            png, _, fp = worker.run_job_with_latents(spec(seed))
            expect(bool(np.isfinite(np.frombuffer(fp, np.float16)).all()), "latents finite")
        else:
            png, _ = worker.run_job(spec(seed))
        latency.append(time.perf_counter() - t0)
        check_png(png)
        pngs[seed] = png
        if seed == 1:
            expect(counts() == per_request, f"one request launched {counts()}, "
                                            f"expected {per_request}")
    t0 = time.perf_counter()
    expect(worker.run_job(spec(1))[0] == pngs[1], "same seed gives identical PNG bytes")
    latency.append(time.perf_counter() - t0)
    for seed in range(100, 100 + LATENCY_SAMPLES - len(latency)):
        t0 = time.perf_counter()
        worker.run_job(spec(seed))
        latency.append(time.perf_counter() - t0)

    batch = [spec(seed) for seed in range(10, 18)]
    batch_s = []
    for _ in range(BATCH8_SAMPLES):
        t0 = time.perf_counter()
        out = worker.run_jobs(batch)
        batch_s.append(time.perf_counter() - t0)
        for png, _ in out:
            check_png(png)
    solo, _ = worker.run_job(batch[3])
    row = png_pixels(out[3][0]).astype(np.int16)
    delta = int(np.abs(row - png_pixels(solo).astype(np.int16)).max())
    log({"batch_row_vs_solo": {"identical_bytes": out[3][0] == solo, "max_pixel_delta": delta}})
    expect(delta <= 1, f"batch-8 row differs from its solo run by {delta}")

    # batch-1 and batch-8 runs each launch once per site; +1 for the solo check
    n_requests = LATENCY_SAMPLES + BATCH8_SAMPLES + 1
    got = counts()
    expect(got == {k: n_requests * v for k, v in per_request.items()},
           f"main path launched {got}, expected {n_requests} x {per_request}")
    lat_ms = [1e3 * t for t in latency]
    return {"launches": got, "p50_ms_batch1": statistics.median(lat_ms),
            "batch1_samples": len(lat_ms), "min_ms_batch1": min(lat_ms),
            "max_ms_batch1": max(lat_ms), "latency_ms_batch1": lat_ms,
            "img_per_s_batch8": 8 / statistics.median(batch_s),
            "batch8_s": batch_s, "batch_row_max_pixel_delta": delta}


def kernel_times(prof) -> list:
    """(device ms, launches, name) of every kernel one torch.profiler run saw:
    device-side entries only (host entries such as the profiler's own
    "Activity Buffer Request" can carry a device time too)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == DeviceType.CUDA:
            out.append((us / 1e3, e.count, e.key))
    return sorted(out, reverse=True)


def profile(run) -> dict:
    """Device time by kernel over one call of ``run`` (torch.profiler), and the
    device's busy share of the wall time (the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = kernel_times(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(n for _, n, _ in kernels),
            "top": [[name[:90], ms, n] for ms, n, name in kernels[:12]]}


# ---------------------------------------------------------------------------
# phase 6: the probes (K4, K5, K6) of dreamlab_tpu_torch/scripts
# ---------------------------------------------------------------------------

K5_LANES = (ab_attention_layout.LANES, ab_attention_layout.D)


def attention_bound(b, n, m, h, d, dtype) -> tuple:
    """Operations 4*B*H*N*M*D; bytes: q and o once, k and v once."""
    elt = torch.finfo(dtype).bits // 8
    return bound_ms(4.0 * b * h * n * m * d, elt * (2 * b * n * h * d + 2 * b * m * h * d), dtype)


def self_attention_bound(shape, dtype) -> tuple:
    b, n, h, d = shape
    return attention_bound(b, n, n, h, d, dtype)


def k5_inputs(dtype, lane):
    """K5's pre-folded [B*H, N, lane] q, k, v at the layout probe's shape."""
    lay = ab_attention_layout
    return [lay.fold(randn((lay.B, lay.N, lay.H, lay.D), dtype, 20 + i), lane)
            for i in range(3)]


def check_probes_fp32() -> None:
    """K4, K5 (both lanes) and K6 in fp32 against their plain versions on the
    card at the probes' full shapes (the probes check bf16 themselves, every
    variant they time; these launches are not counted)."""
    dtype = torch.float32
    cases = [("flash_4d", ab_transpose_free.flash_attention_4d, (b, n, h, d))
             for b, n, h, d, _ in ab_transpose_free.SHAPES]
    cases.append(("flash_packed3", ab_head_packing.flash_attention_packed3, ab_head_packing.SHAPE))
    for name, fn, shape in cases:
        q, k, v = (randn(shape, dtype, 30 + i) for i in range(3))
        got = fn(q, k, v, scale=shape[-1] ** -0.5)
        err = max_err(got, fg.flash_group_plain(q, k, v, shape[-1] ** -0.5))
        log({"check": name, "dtype": str(dtype), "shape": list(shape), "max_abs_err": err})
        expect(err <= TOL_FLASH[dtype], f"{name} {dtype} {list(shape)} err {err}")
        del q, k, v, got
    lane_d = ab_attention_layout.D
    for lane in K5_LANES:
        q, k, v = k5_inputs(dtype, lane)
        scale = lane_d ** -0.5
        got = ab_attention_layout.kernel_call(q, k, v, lane, scale=scale)
        want = fa.attention_plain(*(x.unsqueeze(2) for x in (q, k, v)), scale).squeeze(2)
        err = max_err(got, want)
        pad = got[:, :, lane_d:].abs().max().item() if lane > lane_d else 0.0
        log({"check": "flash_folded", "dtype": str(dtype), "lane": lane,
             "shape": list(q.shape), "max_abs_err": err, "pad_lanes_max": pad})
        expect(err <= TOL_FLASH[dtype], f"flash_folded {dtype} lane {lane} err {err}")
        expect(pad == 0, f"flash_folded lane {lane}: pad lanes {pad}, expected 0")
        del q, k, v, got, want
    torch.cuda.empty_cache()


def reset_probe_counts() -> None:
    fa.LAUNCHES = 0
    fg.LAUNCHES = 0
    ab_transpose_free.LAUNCHES = 0
    ab_attention_layout.LAUNCHES = 0
    ab_head_packing.LAUNCHES = 0


def probe_counts() -> dict:
    return {"flash_4d": ab_transpose_free.LAUNCHES,
            "flash_folded": ab_attention_layout.LAUNCHES,
            "flash_packed3": ab_head_packing.LAUNCHES,
            "flash_group (K4 + K6)": fg.LAUNCHES, "flash (K1 beside them)": fa.LAUNCHES}


def probes(errs) -> tuple:
    """Phase 6. Returns (kernel entries for the kernels line, probes line)."""
    t0 = time.perf_counter()
    check_probes_fp32()
    end_phase("probe checks")
    reset_probe_counts()
    runs = {"ab_transpose_free": ab_transpose_free.main(),
            "ab_attention_layout": ab_attention_layout.main(),
            "ab_head_packing": ab_head_packing.main()}
    launches = probe_counts()
    for probe, run in runs.items():
        # bf16, every kernel variant the probe times, on the probe's own inputs
        for case, c in run["checks"].items():
            log({"check": f"{probe}/{case}", "dtype": "torch.bfloat16", **c,
                 "beyond_rounding_limit": TOL_BF16})
        expect(not run["failed"], f"{probe}: checks failed {run['failed']}")
    for name in ("flash_4d", "flash_folded", "flash_packed3"):
        expect(launches[name] > 0, f"the probes launched {name} no time")
    end_phase("probes")

    t4 = runs["ab_transpose_free"]
    lay = runs["ab_attention_layout"]
    hp = runs["ab_head_packing"]
    errs["flash_4d"] = max(c["max_abs_err"] for case, c in t4["checks"].items()
                           if case.endswith("/group"))
    errs["flash_folded"] = max(lay["checks"][lane]["max_abs_err"] for lane in ("folded", "nopad"))
    errs["flash_packed3"] = hp["checks"]["packed3"]["max_abs_err"]
    bf16 = torch.bfloat16
    # per probe run: one call at each shape the probe gives the kernel;
    # K5 at lane 128 (the folded variant; lane 40 is in the probes line)
    al = ab_attention_layout
    k5_bound = lambda lane: attention_bound(al.B * al.H, al.N, al.N, 1, lane, bf16)
    k4_bounds = [self_attention_bound(t["shape"], bf16) for t in t4["shapes"].values()]
    rows = {
        "flash_4d": (sum(t["group_ms"] for t in t4["shapes"].values()),
                     sum(t["plain_ms"] for t in t4["shapes"].values()),
                     sum(t["sdpa_ms"] for t in t4["shapes"].values()),
                     (sum(b for b, _ in k4_bounds), k4_bounds[0][1])),
        "flash_folded": (lay["folded_ms"], lay["xla_lane128_ms"], lay["sdpa_lane128_ms"],
                         k5_bound(al.LANES)),
        "flash_packed3": (hp["packed3_ms"], hp["plain_ms"], hp["sdpa_ms"],
                          self_attention_bound(hp["shape"], bf16)),
    }
    sources = {
        "flash_4d": ("dreamlab_tpu_torch/csrc/flash_group.cu", "scripts/ab_transpose_free.py:46"),
        "flash_folded": ("dreamlab_tpu_torch/csrc/flash_attention.cu",
                         "scripts/ab_attention_layout.py:61"),
        "flash_packed3": ("dreamlab_tpu_torch/csrc/flash_group.cu",
                          "scripts/ab_head_packing.py:134"),
    }
    entries = []
    for name, (ms, plain_ms, library_ms, (bms, by)) in rows.items():
        entries.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            # K5 at lane 128 computes 3.2x the work of d = 40: both bounds
            **({"bound_ms_d40": k5_bound(al.D)[0]}
               if name == "flash_folded" else {})})
    line = {"probes": {**runs, "launches": launches, "probes_s": time.perf_counter() - t0}}
    return entries, line


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # batch invariance and run-to-run identity: no per-shape autotuning
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    t0 = time.perf_counter()
    _build.build()
    log({"build_s": time.perf_counter() - t0})
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    errs = collections.defaultdict(float)
    t0 = time.perf_counter()
    check_kernels(errs)
    check_small_pipeline()
    end_phase("checks")
    log({"checks_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bundle = random_bundle(seed=0, device="cuda")
    pipe = LCMPipeline(bundle, dtype=torch.bfloat16)
    del bundle
    torch.cuda.empty_cache()
    worker = CudaPipelineWorker(pipe)
    seen = census(pipe)
    pipe.generate("warmup", height=SIZE, width=SIZE, num_inference_steps=STEPS, batch=8, seed=0)
    per_request = {"flash": sum(c for k, c in seen.items() if k[0] == "flash"),
                   "gn_stats": sum(c for k, c in seen.items() if k[0] == "gn")}
    per_request["gn_apply"] = per_request["gn_stats"]
    log({"setup_s": time.perf_counter() - t0, "launches_per_request": per_request})
    expect(per_request == {"flash": 40, "gn_stats": 209, "gn_apply": 209},
           f"census {per_request}, expected 40 flash and 209 GroupNorm launches")

    t0 = time.perf_counter()
    rows = time_kernels(seen, torch.bfloat16)
    log({"timing_s": time.perf_counter() - t0, "per_request_ms": rows})

    t0 = time.perf_counter()
    result = main_path(worker, per_request)
    end_phase("main path")
    log({"main_path_s": time.perf_counter() - t0, "card": smi, "host_cpu": host_cpu(),
         **result})

    spec = GenSpec("a mountain at sunset", size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                   seed=5)
    log({"profile_batch1": profile(lambda: worker.run_job(spec))})
    log({"profile_batch8": profile(lambda: worker.run_jobs([spec] * 8))})
    del worker, pipe
    torch.cuda.empty_cache()

    probe_entries, probe_line = probes(errs)
    log(probe_line)

    sources = {
        "flash": ("dreamlab_tpu_torch/csrc/flash_attention.cu",
                  "dreamlab_tpu/ops/flash_attention.py:52"),
        "gn_stats": ("dreamlab_tpu_torch/csrc/groupnorm.cu",
                     "dreamlab_tpu/ops/groupnorm.py:30"),
        "gn_apply": ("dreamlab_tpu_torch/csrc/groupnorm.cu",
                     "dreamlab_tpu/ops/groupnorm.py:36"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": result["launches"][name], "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["bound_operations_ms"] > r["bound_bytes_ms"]
            else "bytes",
            "library_ms": r["library_ms"],
        })
    log({"kernels": kernels + probe_entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
