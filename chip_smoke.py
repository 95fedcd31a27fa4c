#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``dreamlab_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and nvcc, imports nothing of JAX, and exits non-zero if any phase fails:

1. prints the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
2. builds the CUDA kernels from ``dreamlab_tpu_torch/csrc`` (nvcc, sm_90a),
   prints each kernel's registers and spills (ptxas) and its tensor-core
   (HMMA) instructions (cuobjdump), and fails if an instance of a bf16 flash
   kernel (one head, ``flash_mma_kernel``; head group,
   ``flash_group_mma_kernel``) has none or spills;
3. holds each kernel against its plain PyTorch version on the card (bf16:
   the error beyond one bf16 rounding of the output,
   ``scripts/timing.py::bf16_check``), and a tiny fp32 pipeline on the card
   (kernels) against the same on the CPU (plain versions, which the CPU tests
   hold to the JAX package);
4. holds each kernel against its plain version again, and times it (device
   time, ``scripts/timing.py::device_ms``), at the shapes one 512x512
   request gives it (found by a census run on the pipeline's eager route),
   beside its plain version, a library call and its bound; at each flash
   shape also K1's tile sweep and the head-group kernel at the JAX package's
   pack (main-path candidates);
5. drives the main path at SD1.5's full width with seeded random bf16
   weights: captures the batch-1 and batch-8 buckets (``warmup``: one eager
   run, then the capture, each launching every kernel once per call: the
   launch counts must be 4x the census; seconds and reserved bytes per
   bucket), then 20 timed CudaPipelineWorker.run_job requests (512x512, 4 LCM
   steps) that replay the batch-1 graph, one of them a repeat that must be
   byte-identical, and run_jobs batches of 8 whose row must equal that spec's
   solo run byte for byte; replays add no count, the profiler counts the
   kernels a replay ran (40 flash, 209 GroupNorm, as the census);
   then the before: the same requests on the private eager route (timed,
   profiled, PNG against the graph's), and device RNG (same seed, same bytes;
   another seed, other bytes);
6. loader phase: writes SD1.5 at full width (``random_bundle(seed=0)``, fp16)
   as a diffusers directory and as an LDM single file in a temporary
   directory, builds a worker from each with ``create_cuda_worker`` (load
   seconds printed; the single file with ``warmup_size=(512, 512)``), and
   checks that one ``run_job``'s PNG is byte-identical to that of a pipeline
   built in memory from the same fp16 values, for both; then a worker from
   the directory with a mode LoRA and a two-vector textual inversion (the
   trigger word and the mode LoRA each change the PNG);
6b. pool and super-resolution (counts reset before the pool path, read
   after it: 2 x the census per captured bucket): two modes of that
   directory in a ``modes.yaml`` (``a`` plain with a 512x768 background
   bucket, ``b`` with the mode LoRA at 0.8), ``DREAMLAB_MODE_CACHE=2``,
   ``DREAMLAB_MAX_BATCH=8``, ``WorkerPool`` with its default factory: 6
   requests while ``a``'s 512x768 bucket is captured in the background and
   an SR job runs, 16 solo requests (pipelined) in turns with 16 serial
   ``run_job`` (img/s, a profiled run: busy share), one profiled pool
   request (40 flash, 209 GroupNorm+SiLU), 8 requests coalesced into one
   pipelined ``run_jobs`` beside serial ``run_jobs``, a tenant request for
   ``b``, switches from the cache and cold, ``evict_mode``; every pool PNG
   byte-equal to ``run_job``'s on the same worker; per mode the registered
   bytes beside ``estimate_model_hbm`` and the measured delta. Then an ESPCN
   ``.onnx`` at ``super-resolution-10``'s shape (seeded weights) through
   ``SuperResService`` on one pool PNG at magnitude 1 (9 tiles) and 2 (49
   tiles): the card's luma within 1 level of the CPU's fp32 forward, the
   colour path byte-equal to the CPU's, ms per pass, host PNG decode and
   encode ms, peak memory; the bicubic mode equal to the CPU's;
6c. server (counts reset before it, read after it: every kernel launched):
   ``serving.app.create_app(device="cuda")`` started in the process on a
   127.0.0.1 port over three modes of that directory (``a`` plain, ``b``
   with the mode LoRA, ``c`` with a full-width ControlNet), the pool
   phase's ESPCN, ``DREAMLAB_MODE_CACHE=3``, solo dispatch; over real
   sockets at 512², 4 steps: ``/generate`` = ``run_job``, the storage round
   trip, ``/generate/stream`` (4 progress events in order, the result =
   ``/generate``'s), ``/generate`` with ``superres`` = the SR service on that
   PNG, ``/sdapi/v1/txt2img`` at batch 2 and ``/v1/images/generations`` at
   n 2 = their solo ``/generate``, ``/v1/img2img`` and ``/v1/inpaint`` =
   ``run_img2img``, a disconnected client's queued job never runs;
   p50 over 20 serial ``/generate`` beside 20 ``run_job``, 16 concurrent
   HTTP clients beside the pool's own img/s on the same specs (in turns),
   the busy share over them, a profiled request (40 flash, 209
   GroupNorm+SiLU kernels); ``/api/modes/switch`` to ``c`` with
   ``wait_seconds`` then ``X-Mode``, ``/v1/controlnet`` = the worker's
   ``run_job`` with the hint, a tenant request for ``b``; stage times;
6d. Yume (counts reset before it, read after it): a full-width CLIP
   ViT-B/32 directory (``openai/clip-vit-base-patch32``'s config, seeded
   random fp32 weights, the test tokenizer's vocabulary filled to 49408) and
   ``create_app(device="cuda")`` with ``YUME_ENABLED`` over mode ``a`` of
   the loader phase's directory, a style over the mode LoRA's file: the
   dream worker bound to the pool's worker with the native CLIP scorer on
   the card; features and the scores of a candidate batch held to the same
   directory on the CPU (scores within 1e-4, features 1e-4 of their
   largest magnitude); a candidate batch (64², batch 4, 1 step) = each
   seed's solo ``run_job`` PNG decoded, a render = ``run_job``'s PNG, also
   while styled pool requests are in flight; medians of the candidate
   batch's generation, of scoring it with the text cached and of a render;
   the candidate bucket's capture seconds and bytes; one session of 16
   batches over ``/dreams/start`` (dreams/s), a second start 409,
   ``stop``, ``top``, ``recent``, ``status``, ``/dreams/image/{id}`` =
   ``run_job`` at the render size, 404; 16 pool requests with a session
   running and without, in turns (img/s, every PNG = ``run_job``'s), the
   busy share beside a session; then the census of a candidate batch (0
   flash, 74 GroupNorm+SiLU), its shapes checked and timed, a profiled
   candidate batch and render;
7. SD1.5 extras: a new full-width worker with two styles (rank-8 LoRAs over
   every projection the key map reaches, kohya and diffusers dialect).
   Styles path (counts reset before it): unstyled, A at level 3 (its first
   merge timed alone), A again (a cache hit), B, unstyled; the two unstyled
   PNGs and A's two are byte-identical, the styled graph PNG equals the
   eager route's, the merged leaves are within one bf16 ulp of a CPU fp32
   merge; merge, cache-hit and restore ms, touched and registered bytes, a
   profiled styled replay (the census). img2img path (counts reset): the
   encoder's GroupNorm shapes checked and timed, img2img at 0.5 and
   inpainting at 1.0 with a half-frame mask through ``run_img2img`` (graph =
   eager, the same seed twice, the 0.5 bucket replayed at 0.75 = eager at
   0.75, inpainting keeps the encoded latents outside the mask), p50 over
   10 requests, a profiled replay (txt2img's flash census, its GroupNorm
   census plus the encoder's);
7b. ControlNet and progress (SD1.5, 512², ``wcond``): SD1.5 in fp16 as a
   diffusers directory and a full-width ControlNet (the SD1.5 trunk without
   cond_proj, hint ladder 16/32/96/256, non-zero taps, seeded random
   weights) as a ControlNet directory, served by
   ``create_cuda_worker(controlnet=)``. A census on the eager route (56
   flash, 289 GroupNorm), every shape checked and timed; counts reset, the
   ctrl and plain buckets captured; the same seed twice, scale 0 = the plain
   request, graph = eager, p50 over 10 ControlNet requests beside 10 plain
   ones, a profiled replay; a net of the same config written into the live
   leaves (same graph) = a fresh pipeline with that net. Then progress on
   the same worker (counts reset): steps 0-3 with the schedule's
   timesteps, the PNG = the callback-free one's, per-step latents = the
   eager route's, when each step arrived, p50 beside callback-free;
8. SDXL phase: SDXL at full width (two text towers, ``text_time``
   micro-conditioning), seeded random bf16 weights drawn on the card, 1024x1024,
   4 steps. A census of one request on the eager route (280 flash, 169
   GroupNorm launches), each kernel held against its plain version and timed
   at every census shape, the largest VAE GroupNorm also at batch 2 and at
   batch 8 (2^31 values: each row against its plain version and byte-equal to
   the kernel's batch-1 output of that row), and the VAE's plain mid-block
   attention (one 512-wide head over 16384 tokens) timed with its peak memory;
   then 5 timed requests at guidance 1.0 (``none`` mode; one a repeat that
   must be byte-identical), one at guidance 2.0 with a negative prompt (the
   batch-doubled ``cfg`` mode), ``run_jobs`` of 2 in each mode whose rows must
   equal their solo runs byte for byte, each bucket captured on its first
   request; one profiled replay; the eager route on the same requests (timed,
   profiled, PNGs against the graph's); the peak memory; one SDXL img2img
   request at 1024² (the encoder's shapes checked and timed, a replay, the
   peak memory); SDXL at 1344x768, whose latents (96 x 168) decode as 8
   tiles (census 280 flash at N = 4032 and 1008, 140 + 8 x 29 GroupNorm; the
   new shapes checked, K1's timed; three replays and the eager route
   byte-identical; the tiled decode's ms and peak memory beside the
   full-frame decode's); one ``{"sdxl": {...}}`` line;
8b. ensemble phase: SDXL base and the full-width SDXL refiner (seeded
   random bf16 weights drawn on the card) in one worker, 1024², 4 steps,
   switch 0.8 (base [0, 3), refiner [3, 4)). A census on the eager route
   (254 flash, 179 GroupNorm), each kernel checked and timed at the refiner
   segment's shapes; counts reset, both segment buckets captured on the
   first request, 3 timed requests (a repeat: the same bytes), graph =
   eager, the carry an fp32 card tensor, a profiled replay, the peak memory
   with both pipelines resident, capture seconds and bytes per bucket; the
   base's (0, 3) then (3, 4) = its 4-step run, byte for byte;
9. probes phase: holds the probes' kernels (K4 ``flash_attention_4d``, K5
   ``kernel_call`` at lanes 40 and 128, K6 ``flash_attention_packed3``) in
   fp32 against their plain versions at the probes' full shapes, then runs
   the three probe entry points of ``dreamlab_tpu_torch/scripts`` with their
   launch counts reset. Each probe first holds every bf16 kernel variant it
   times against the plain fp32 version on its own inputs (beyond one bf16
   rounding of the output), then times them beside the plain
   version and SDPA; the phase reads their errors and times, adds each
   kernel's bound, and prints one ``{"probes": {...}}`` line;
10. prints the run's seconds (``{"total_s": ...}``), the ``{"kernels": [...]}``
   line (each kernel on the SD1.5 main path, K1 and K2+K3 on the pool
   path (``_pool``: its launches, the SD1.5 census's times), on the
   server path (``_server``, likewise) and on the Yume path (``_yume`` at
   the render's shapes, ``_yume_candidates`` at a candidate batch's), then on the
   SDXL path with a ``_sdxl`` name, K2+K3 at the encoder's shapes (``_encoder``,
   ``_encoder_sdxl``), K1 at 1344x768, K1 and K2+K3 on the ControlNet path
   (``_controlnet``) and at the refiner segment's shapes (``_refiner``),
   then the probes' kernels), and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import http.client
import json
import math
import os
import platform
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from dreamlab_tpu_torch import lora, testing
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.mode_config import ModeConfigManager
from dreamlab_tpu_torch.engine.model_registry import get_model_registry, reset_model_registry
from dreamlab_tpu_torch.engine.worker_factory import create_cuda_worker
from dreamlab_tpu_torch.engine.worker_pool import CustomJob, GenerationJob, WorkerPool
from dreamlab_tpu_torch.invokers.comfy_client import multipart_body
from dreamlab_tpu_torch.models import layers, superres, vae
from dreamlab_tpu_torch.models.configs import SUPERRES
from dreamlab_tpu_torch.ops import _build, attention
from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.ops import groupnorm as gn
from dreamlab_tpu_torch.pipeline import LCMPipeline, _flat
from dreamlab_tpu_torch.scripts import ab_attention_layout, ab_head_packing, ab_transpose_free
from dreamlab_tpu_torch.serving import app as server_app
from dreamlab_tpu_torch.serving.http import ServerThread
from dreamlab_tpu_torch.serving.superres_service import (SuperResService, SuperResWorker,
                                                         decode_rgb, load_sr_params)
from dreamlab_tpu_torch.scripts.timing import (TOL_BF16, TOL_BF16_P, bf16_check, device_ms,
                                               max_err)
from dreamlab_tpu_torch.testing import (CONTROLNET_COND_CHANNELS, SD15_CONTROLNET,
                                        cast_params, cast_tree, random_bundle,
                                        random_controlnet,
                                        random_lora, random_refiner_bundle,
                                        write_controlnet_dir, write_diffusers_dir,
                                        write_single_file)
from dreamlab_tpu_torch.utils import image_ops
from dreamlab_tpu_torch.utils.png import decode_png, encode_png
from dreamlab_tpu_torch.utils.safetensors import save_file
from dreamlab_tpu_torch.yume import dream_worker as dw

# H100 SXM peaks (NVIDIA data sheet, dense): the bound is the larger of
# operations over the peak for the inputs' type and bytes over HBM bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# fp32: the kernels differ from the plain versions in summation order only.
# bf16: the error beyond one bf16 rounding of the output (bf16_check), at most
# TOL_BF16_P for the tensor-core flash kernels, one head and head group (they
# round P to bf16, as the Pallas kernels do) and TOL_BF16 for GroupNorm (fp32
# statistics, one rounding of the output).
TOL_FP32_FLASH = 1e-4
TOL_FP32_GN = 1e-5
TOL_GN_COEFFS = 1e-4  # fp32 statistics over up to 1M values, summed in another order

STEPS = 4
SIZE = 512
LATENCY_SAMPLES = 20  # batch-1 requests timed on the main path (p50 over them)
BATCH8_SAMPLES = 3  # run_jobs calls of 8 timed (img/s from their median)
EAGER_SAMPLES = 10  # the same requests on the eager route (the before)
XL_SIZE = 1024
XL_LATENCY_SAMPLES = 5  # SDXL batch-1 requests timed (p50, min, max over them)
XL_EAGER_SAMPLES = 3
STYLE_RANK = 8  # the styles' and the mode LoRA's rank
STYLE_TIMING_REPS = 5  # cache-hit applies and restores timed (median)
IMG2IMG_SAMPLES = 10  # SD1.5 img2img and inpainting requests timed, each (p50 over them)
# a bucket's capture follows one eager run: each launches every kernel once
# per call, so capturing a bucket counts twice its census
CAPTURE_RUNS = 2
# one SDXL request: 10 self-attention sites at 4096 tokens and 60 at 1024 per
# UNet call; 35 GroupNorm+SiLU calls per UNet call (17 resnets x 2 + norm_out)
# and 29 in the VAE decode; 4 steps; the cfg mode's doubled batch launches the same
XL_PER_REQUEST = {"flash": 4 * 70, "gn": 4 * 35 + 29}
# a ControlNet request (SD1.5, 512², wcond): each UNet call adds the trunk's
# 4 flash sites (2 at 4096 tokens, 2 at 1024) and 20 GroupNorm+SiLU calls
# (10 resnets); the hint ladder has none
CN_PER_REQUEST = {"flash": 40 + 4 * 4, "gn": 209 + 4 * 20}
CN_SAMPLES = 10  # ControlNet requests timed, and as many plain ones beside them
PROGRESS_SAMPLES = 10  # progress requests timed, and as many callback-free ones
# an ensemble request (SDXL 1024², 4 steps, switch 0.8): 3 base steps, one
# refiner step (20 flash sites at 4096 tokens, 20 at 1024, 4 at 256; 22
# resnets and norm_out) and the refiner's VAE decode
SWITCH_AT = 0.8
ENSEMBLE_PER_REQUEST = {"flash": 3 * 70 + 44, "gn": 3 * 35 + 45 + 29}
ENSEMBLE_SAMPLES = 3
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
# phase 2: what the build produced
# ---------------------------------------------------------------------------


def _demangle(names) -> dict:
    """{mangled: short demangled name} (c++filt where the machine has it)."""
    names = list(names)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        out = names
    short = [re.sub(r"\(.*$", "", n.replace("(anonymous namespace)::", "").replace("void ", ""))
             for n in out]
    return dict(zip(names, short))


def ptxas_summary(build_log: str) -> list:
    """Registers and spill bytes of each compiled kernel (nvcc -Xptxas=-v)."""
    rows = []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m[1]), int(m[2])
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m[1])
    names = _demangle(r["kernel"] for r in rows)
    return [{**r, "kernel": names[r["kernel"]]} for r in rows]


def sass_hmma(so) -> dict:
    """{kernel: HMMA (tensor-core) instructions} in the built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    names = _demangle(counts)
    return {names[k]: n for k, n in sorted(counts.items())}


MMA_KERNELS = ("flash_mma_kernel", "flash_group_mma_kernel")  # the bf16 flash kernels


def check_build(so) -> None:
    ptxas = ptxas_summary(_build.build_log())
    for row in ptxas:
        log({"ptxas": row})
    hmma = sass_hmma(so)
    log({"sass_hmma": hmma})
    for kern in MMA_KERNELS:
        mma = {k: n for k, n in hmma.items() if kern in k}
        expect(len(mma) > 0 and all(n > 0 for n in mma.values()),
               f"an instance of {kern} contains no HMMA: {mma}")
        spills = [r for r in ptxas if kern in r["kernel"]
                  and r.get("spill_stores", 0) + r.get("spill_loads", 0) > 0]
        expect(not spills, f"instances of {kern} spill: {spills}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(q, k, v, errs, what) -> dict:
    """One flash call against the plain fp32 version on the same inputs."""
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q.float(), k.float(), v.float(), q.shape[-1] ** -0.5)
    if q.dtype == torch.bfloat16:
        c = bf16_check(got, want, TOL_BF16_P)
        expect(c["beyond_rounding"] <= c["limit"], f"flash {what}: {c}")
        errs["flash"] = max(errs["flash"], c["max_abs_err"])
        errs["flash_beyond"] = max(errs["flash_beyond"], c["beyond_rounding"])
        return c
    err = max_err(got, want)
    expect(err <= TOL_FP32_FLASH, f"flash fp32 {what}: err {err}")
    return {"max_abs_err": err, "limit": TOL_FP32_FLASH}


def check_gn(x, gamma, beta, groups, silu, errs, what) -> dict:
    """fused_group_norm_silu against the plain fp32 version on the same inputs."""
    got = gn.fused_group_norm_silu(x, gamma, beta, groups=groups, silu=silu)
    want = gn.group_norm_plain(x.float(), gamma.float(), beta.float(), groups=groups,
                               silu=silu)
    if x.dtype == torch.bfloat16:
        c = bf16_check(got, want, TOL_BF16)
        expect(c["beyond_rounding"] <= c["limit"], f"gn {what}: {c}")
        errs["gn"] = max(errs["gn"], c["max_abs_err"])
        errs["gn_beyond"] = max(errs["gn_beyond"], c["beyond_rounding"])
        return c
    err = max_err(got, want)
    expect(err <= TOL_FP32_GN, f"gn fp32 {what}: err {err}")
    return {"max_abs_err": err, "limit": TOL_FP32_GN}


def check_kernels(errs) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        # the main path's shapes, masked key edges, d = 20 (40-byte head rows:
        # element-wise staging) and d = 128 (dynamic shared memory)
        for b, n, m, h, d in [(1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80),
                              (8, 4096, 4096, 8, 40), (1, 256, 77, 8, 40),
                              (1, 256, 1000, 8, 80), (1, 256, 300, 4, 20),
                              (1, 1024, 1024, 2, 128)]:
            q, k, v = (randn(s, dtype, i) for i, s in enumerate(
                [(b, n, h, d), (b, m, h, d), (b, m, h, d)]))
            c = check_flash(q, k, v, errs, f"{dtype} {[b, n, m, h, d]}")
            log({"check": "flash", "dtype": str(dtype), "shape": [b, n, m, h, d], **c})
            del q, k, v
        torch.cuda.empty_cache()

        for shape in [(1, 64, 64, 320), (1, 16, 16, 2560), (1, 512, 512, 128), (2, 5, 7, 64)]:
            c = shape[-1]
            x = randn(shape, dtype, 10)
            gamma = (1 + 0.1 * randn((c,), torch.float32, 11)).to(dtype)
            beta = (0.1 * randn((c,), torch.float32, 12)).to(dtype)
            groups = 32 if c >= 128 else 8
            err2 = check_coeffs(x, gamma, beta, groups)
            for silu in (True, False):
                y = gn.scale_shift_silu(x, *gn.group_norm_coeffs_plain(
                    x.float(), gamma.float(), beta.float(), groups=groups), silu=silu)
                y0 = gn.group_norm_plain(x.float(), gamma.float(), beta.float(),
                                         groups=groups, silu=silu)
                if dtype == torch.bfloat16:
                    c3 = bf16_check(y, y0, TOL_BF16)
                    ok3, err3 = c3["beyond_rounding"] <= c3["limit"], c3["beyond_rounding"]
                    errs["gn_apply"] = max(errs["gn_apply"], c3["max_abs_err"])
                else:
                    err3 = max_err(y, y0)
                    ok3 = err3 <= TOL_FP32_GN
                expect(ok3, f"gn apply {dtype} {shape} {silu} err {err3}")
                c = check_gn(x, gamma, beta, groups, silu, errs, f"{dtype} {shape} {silu}")
                log({"check": "group_norm_silu", "dtype": str(dtype), "shape": list(shape),
                     "silu": silu, "coeffs_err": err2, "apply_err": err3, **c})
            if dtype == torch.bfloat16:
                errs["gn_stats"] = max(errs["gn_stats"], err2)


def check_coeffs(x, gamma, beta, groups) -> float:
    """group_norm_coeffs (the cluster kernel, apply phase off) against the plain
    fp32 coefficients."""
    a, sh = gn.group_norm_coeffs(x, gamma, beta, groups=groups)
    a0, sh0 = gn.group_norm_coeffs_plain(x.float(), gamma.float(), beta.float(), groups=groups)
    err = max(max_err(a, a0), max_err(sh, sh0))
    expect(err <= TOL_GN_COEFFS, f"gn coeffs {x.dtype} {list(x.shape)} err {err}")
    return err


def check_small_pipeline() -> None:
    """A tiny fp32 pipeline through the kernels (flash at 1024 tokens, d = 16)
    against the plain versions on the CPU: same weights, same seed."""
    bundle = random_bundle(tiny=True, seed=3)
    call = dict(height=64, width=64, num_inference_steps=2, seed=7, batch=2)
    f0, g0 = fa.LAUNCHES, gn.APPLY_LAUNCHES
    pipe = LCMPipeline(bundle, dtype=torch.float32)
    # what a deployed worker gets: the pipeline sets them, this script does not
    flags = {"cudnn.deterministic": torch.backends.cudnn.deterministic,
             "cudnn.benchmark": torch.backends.cudnn.benchmark,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    log({"backend_flags": flags})
    expect(flags == {"cudnn.deterministic": True, "cudnn.benchmark": False,
                     "cudnn.allow_tf32": False, "matmul.allow_tf32": False},
           f"LCMPipeline left the backend flags {flags}")
    gpu = pipe.generate("a cat at sunset", **call)
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


def census(pipe, size: int = SIZE, run=None) -> collections.Counter:
    """Shapes each kernel wrapper sees in one batch-1 request at ``size``²,
    or in ``run()`` where given (the eager route: a capture would run the
    wrappers twice)."""
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
        if run is None:
            pipe._generate_eager("census", height=size, width=size,
                                 num_inference_steps=STEPS, seed=0)
        else:
            run()
    finally:
        attention.flash_attention, layers.fused_group_norm_silu = flash, gnorm
    return seen


def per_request_of(seen) -> dict:
    """Launches per request of a census: one per flash and per GroupNorm call
    (the fused launch counts once in gn, gn_stats and gn_apply)."""
    gn_calls = sum(c for k, c in seen.items() if k[0] == "gn")
    return {"flash": sum(c for k, c in seen.items() if k[0] == "flash"), "gn": gn_calls,
            "gn_stats": gn_calls, "gn_apply": gn_calls}


def time_kernels(seen, dtype, errs, parts: bool = True) -> dict:
    """Each census shape: the kernel against its plain version, then timed
    (per-request totals: each shape's time times its count in ``seen``);
    without ``parts`` GroupNorm's two phases are not timed apart (K2 and K3
    alone), only the fused call the paths run."""
    rows = {k: collections.defaultdict(float) for k in ("flash", "gn_stats", "gn_apply", "gn")}
    for (kind, shape, extra), count in sorted(seen.items()):
        if kind == "flash":
            b, n, h, d = shape
            m = extra
            q, k, v = randn((b, n, h, d), dtype, 1), randn((b, m, h, d), dtype, 2), \
                randn((b, m, h, d), dtype, 3)
            c = check_flash(q, k, v, errs, f"census {[b, n, m, h, d]}")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            t = {"ms": device_ms(lambda: fa.flash_attention(q, k, v)),
                 "plain_ms": device_ms(lambda: fa.attention_plain(q, k, v, d ** -0.5), 3),
                 "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))}
            # the sweep's tiles where they are compiled: what the default was chosen from
            tiles = {f"bq{bq}_bk{bk}": device_ms(lambda bq=bq, bk=bk: fa.launch(
                q, k, v, scale=d ** -0.5, block_q=bq, block_k=bk))
                for bq in fa.SWEEP_BLOCK_Q for bk in fa.SWEEP_BLOCK_K} \
                if d <= fa.SWEEP_MAX_HEAD_DIM else {}
            elt = q.element_size()
            bms, by = bound_ms(4.0 * b * h * n * m * d, elt * (2 * b * n * h * d + 2 * b * m * h * d),
                               dtype)
            log({"time": "flash", "shape": [b, n, m, h, d], "count": count, **t,
                 "bound_ms": bms, "bound_by": by, "tiles_ms": tiles,
                 "head_group": time_group(q, k, v), "check": c})
            _accumulate(rows["flash"], t, bms, by, count)
            continue
        groups = extra
        x = randn(shape, dtype, 4)
        c = shape[-1]
        gamma, beta = torch.ones(c, device="cuda", dtype=dtype), torch.zeros(
            c, device="cuda", dtype=dtype)
        check = {"coeffs_err": check_coeffs(x, gamma, beta, groups),
                 **check_gn(x, gamma, beta, groups, True, errs, f"census {list(shape)}")}
        xn = x.permute(0, 3, 1, 2)
        nbytes, numel = x.numel() * x.element_size(), x.numel()
        coeff_bytes = 2 * 4 * shape[0] * c
        if parts:
            a, sh = gn.group_norm_coeffs(x, gamma, beta, groups=groups)
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
        log({"time": "gn", "shape": list(shape), "count": count,
             **({"stats": {**t2, "bound_ms": b2[0]}, "apply": {**t3, "bound_ms": b3[0]}}
                if parts else {}),
             "fused": {**tc, "bound_ms": bc[0]}, "check": check})
        if parts:
            _accumulate(rows["gn_stats"], t2, *b2, count)
            _accumulate(rows["gn_apply"], t3, *b3, count)
        _accumulate(rows["gn"], tc, *bc, count)
    return rows


def time_group(q, k, v) -> dict:
    """The head-group kernel at the JAX package's pack for this shape (a
    candidate for the main path, which runs one head per block), checked
    against the plain fp32 version, then timed; {} where pack_geometry
    gives one head or a group the kernel does not take."""
    b, n, h, d = q.shape
    pack = fa.pack_geometry(h, d)[0]
    if d > fg.MAX_HEAD_DIM.get(pack, 0):
        return {}
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    c = bf16_check(fg.flash_group(q, k, v, pack=pack), want, TOL_BF16_P)
    expect(c["beyond_rounding"] <= c["limit"], f"flash_group census {[b, n, h, d]}: {c}")
    return {"pack": pack, "ms": device_ms(lambda: fg.flash_group(q, k, v, pack=pack)),
            "check": c}


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


def check_png(png: bytes, size: int = SIZE) -> None:
    expect(png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
           and struct.unpack(">II", png[16:24]) == (size, size), f"PNG header / IHDR {size}²")


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
    gn.LAUNCHES = 0
    gn.STATS_LAUNCHES = 0
    gn.APPLY_LAUNCHES = 0


def counts() -> dict:
    """Launches per kernel wrapper; "gn" counts every GroupNorm kernel launch,
    so gn == gn_stats == gn_apply means one launch per fused call."""
    return {"flash": fa.LAUNCHES, "gn": gn.LAUNCHES, "gn_stats": gn.STATS_LAUNCHES,
            "gn_apply": gn.APPLY_LAUNCHES}


def bucket_stats(pipe) -> list:
    """Each captured bucket of ``pipe``: its key, capture seconds and the bytes
    it added to the pipeline's graph pool."""
    return [{"key": list(key[:8]) + [f"{name}={'config' if name == 'ctrl' else value}"
                                     for name, value in key[8:]],
             "capture_s": p.capture_s, "reserved_bytes": p.reserved_bytes}
            for key, p in pipe._compiled.items()]


def main_path(worker, per_request) -> dict:
    spec = lambda seed: GenSpec(f"a mountain at sunset, seed {seed}", size=f"{SIZE}x{SIZE}",
                                num_inference_steps=STEPS, seed=seed)
    pipe = worker.pipeline
    reset_counts()
    warm = {f"batch{b}": pipe.warmup(SIZE, SIZE, steps=STEPS, batch=b) for b in (1, 8)}
    captured = counts()
    expect(captured == {k: 2 * CAPTURE_RUNS * v for k, v in per_request.items()},
           f"capturing the batch-1 and batch-8 buckets launched {captured}, expected "
           f"{2 * CAPTURE_RUNS} x {per_request} (an eager run and a capture each)")
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
            expect(counts() == captured, f"a replayed request went through the wrappers: "
                                         f"{counts()} after {captured}")
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
    expect(out[3][0] == solo, f"batch-8 row differs from its solo run (max delta {delta})")

    # the replays went through no wrapper: the counts are the captures'
    got = counts()
    expect(got == captured, f"main path launched {got}, expected the captures' {captured}")
    expect(len(pipe._compiled) == 2, f"the main path made {len(pipe._compiled)} buckets, "
                                     "expected batch 1 and batch 8")
    lat_ms = [1e3 * t for t in latency]
    return {"launches": got, "p50_ms_batch1": statistics.median(lat_ms),
            "batch1_samples": len(lat_ms), "min_ms_batch1": min(lat_ms),
            "max_ms_batch1": max(lat_ms), "latency_ms_batch1": lat_ms,
            "img_per_s_batch8": 8 / statistics.median(batch_s),
            "batch8_s": batch_s, "batch_row_max_pixel_delta": delta,
            "warmup": {k: {"seconds": w["seconds"], "capture_s": w["capture_s"],
                           "reserved_bytes": w["reserved_bytes"]} for k, w in warm.items()},
            "graph_pool_bytes": sum(w["reserved_bytes"] for w in warm.values())}


def eager_png(pipe, spec) -> bytes:
    """``run_job_with_latents``'s PNG on the pipeline's private eager route:
    the before of the graph path."""
    w, h = spec.dims()
    res = pipe._generate_eager(spec.prompt, height=h, width=w,
                               num_inference_steps=spec.num_inference_steps,
                               guidance_scale=spec.guidance_scale,
                               negative_prompt=spec.negative_prompt, seed=spec.seed,
                               aesthetic_score=spec.aesthetic_score)
    return encode_png(res.images[0])


def graph_vs_eager(worker, specs, n_eager: int, kernels: dict) -> dict:
    """The before (eager route) beside the after (replayed graph): the PNG of
    each spec both ways (at most one pixel level apart), the eager route's
    times over ``n_eager`` requests, and one profiled request each way
    (the replay must run ``kernels``, the census)."""
    pipe = worker.pipeline
    pngs = {}
    for name, spec in specs.items():
        graph, eager = worker.run_job_with_latents(spec)[0], eager_png(pipe, spec)
        delta = int(np.abs(png_pixels(graph).astype(np.int16)
                           - png_pixels(eager).astype(np.int16)).max())
        pngs[name] = {"identical_bytes": graph == eager, "max_pixel_delta": delta}
        expect(delta <= 1, f"{name}: the graph's PNG is {delta} levels off the eager route's")
    first = next(iter(specs.values()))
    eager_ms = []
    for i in range(n_eager):
        t0 = time.perf_counter()
        eager_png(pipe, dataclasses.replace(first, seed=300 + i))
        eager_ms.append(1e3 * (time.perf_counter() - t0))
    prof_graph = profile(lambda: worker.run_job(first))
    prof_eager = profile(lambda: eager_png(pipe, first))
    for name, prof in (("replay", prof_graph), ("eager", prof_eager)):
        ran = {k: prof["port_kernels"].get(k, 0) for k in kernels}
        expect(ran == kernels, f"a profiled {name} request ran {prof['port_kernels']}, "
                               f"expected {kernels}")
    return {"graph_vs_eager": pngs, "eager_p50_ms": statistics.median(eager_ms),
            "eager_min_ms": min(eager_ms), "eager_max_ms": max(eager_ms),
            "eager_ms": eager_ms, "host_ms": host_breakdown(pipe, first),
            "profile_graph": prof_graph, "profile_eager": prof_eager}


def host_breakdown(pipe, spec, samples: int = 5) -> dict:
    """Medians (ms) of a replayed request's parts: host staging alone
    (``_stage``), ``generate`` (staging, input copies, replay, the
    device-to-host copy), and the PNG encoding of its image."""
    w, h = spec.dims()
    call = dict(height=h, width=w, num_inference_steps=spec.num_inference_steps,
                guidance_scale=spec.guidance_scale, negative_prompt=spec.negative_prompt,
                seed=spec.seed)
    parts = collections.defaultdict(list)
    for _ in range(samples):
        t0 = time.perf_counter()
        pipe._stage(spec.prompt, **call)
        t1 = time.perf_counter()
        res = pipe.generate(spec.prompt, **call)
        t2 = time.perf_counter()
        encode_png(res.images[0])
        t3 = time.perf_counter()
        for name, dt in (("stage", t1 - t0), ("generate", t2 - t1), ("png", t3 - t2)):
            parts[name].append(1e3 * dt)
    return {name: statistics.median(v) for name, v in parts.items()}


def check_device_rng(pipe) -> dict:
    """rng="device" on the graph path: one seed twice gives the same bytes,
    another seed other bytes."""
    call = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS, rng="device")
    a, b, c = (pipe.generate("a mountain at sunset", seed=s, **call).images for s in (5, 5, 6))
    out = {"same_seed_identical": bool(np.array_equal(a, b)),
           "other_seed_differs": not np.array_equal(a, c)}
    expect(all(out.values()), f"device RNG: {out}")
    return out


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


PORT_KERNELS = ("flash_mma_kernel", "flash_fwd_kernel", "gn_cluster_kernel", "gn_apply_kernel")


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
    port = collections.Counter()
    for _, n, name in kernels:
        for kern in PORT_KERNELS:
            if kern in name:
                port[kern] += n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(n for _, n, _ in kernels),
            "port_kernels": dict(port),
            "top": [[name[:90], ms, n] for ms, n, name in kernels[:12]]}


# ---------------------------------------------------------------------------
# phase 6: a checkpoint directory through the loader
# ---------------------------------------------------------------------------


def loader_phase(per_request, root: str) -> dict:
    """SD1.5 at full width written as an fp16 diffusers directory and as an
    fp16 LDM single file under ``root``, each served by ``create_cuda_worker``
    (the single file with its bucket captured at load): each PNG must equal,
    byte for byte, that of a pipeline built in memory from the same fp16
    values. The directory and the mode LoRA stay for phase 6b."""
    bundle = cast_params(random_bundle(seed=0, device="cuda"), torch.float16)
    spec = GenSpec("a mountain at sunset", size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                   seed=21)
    out = {}
    paths = {"directory": os.path.join(root, "sd15"),
             "single_file": os.path.join(root, "sd15.safetensors")}
    mode_lora = os.path.join(root, "mode_lora.safetensors")
    save_file(random_lora(bundle.unet_params, rank=STYLE_RANK, seed=300,
                          dtype=torch.float16), mode_lora)
    embedding = os.path.join(root, "lumen.safetensors")
    width = bundle.text_params["token_embedding"]["w"].shape[1]
    save_file({"emb_params": 0.02 * randn((2, width), torch.float16, 301)}, embedding)
    t0 = time.perf_counter()
    write_diffusers_dir(bundle, paths["directory"])
    write_s = {"directory": time.perf_counter() - t0}
    t0 = time.perf_counter()
    write_single_file(bundle, paths["single_file"])
    write_s["single_file"] = time.perf_counter() - t0
    nbytes = {"directory": sum(os.path.getsize(os.path.join(d, f)) for d, _, files
                               in os.walk(paths["directory"]) for f in files),
              "single_file": os.path.getsize(paths["single_file"])}
    memory = CudaPipelineWorker(LCMPipeline(bundle))
    del bundle
    png_memory = memory.run_job(spec)[0]
    del memory
    torch.cuda.empty_cache()
    for name, path in paths.items():
        warmup = (SIZE, SIZE) if name == "single_file" else None
        reset_counts()
        t0 = time.perf_counter()
        worker = create_cuda_worker(0, path, warmup_size=warmup)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        png = worker.run_job(spec)[0]
        launched = counts()
        del worker
        torch.cuda.empty_cache()
        check_png(png)
        expect(png == png_memory, f"the {name} checkpoint's PNG differs from the "
                                  "in-memory pipeline's on the same fp16 values")
        # the bucket's capture (at load or on the first request) is the
        # only place the wrappers run
        expect(launched == {k: CAPTURE_RUNS * v for k, v in per_request.items()},
               f"the {name} worker launched {launched}, expected "
               f"{CAPTURE_RUNS} x {per_request}")
        out[name] = {"checkpoint_bytes": nbytes[name], "write_s": write_s[name],
                     "load_s": load_s, "warmup_size": warmup,
                     "png_identical": png == png_memory, "launches": launched}
    out["mode_lora_and_embedding"] = mode_extras(paths["directory"], mode_lora, embedding,
                                                 spec, png_memory)
    return out


def mode_extras(ckpt, mode_lora, embedding, spec, png_plain) -> dict:
    """``create_cuda_worker`` with a mode LoRA and a two-vector textual
    inversion: the trigger word changes the image, and the mode LoRA changes
    it from the plain checkpoint's."""
    t0 = time.perf_counter()
    worker = create_cuda_worker(
        0, ckpt, loras=[types.SimpleNamespace(file=mode_lora, strength=0.8)],
        embeddings=[types.SimpleNamespace(file=embedding, name=None)])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bundle = worker.pipeline.bundle
    vocab = bundle.text_cfg.vocab_size
    triggers = bundle.tokenizer.triggers
    expect(triggers == {"lumen": [vocab, vocab + 1]}, f"embedding triggers {triggers}")
    plain = worker.run_job(spec)[0]
    lumen = worker.run_job(dataclasses.replace(spec, prompt="a lumen mountain at sunset"))[0]
    check_png(plain)
    check_png(lumen)
    expect(lumen != plain, "the trigger word changed nothing")
    expect(plain != png_plain, "the mode LoRA changed nothing")
    del worker
    torch.cuda.empty_cache()
    return {"load_s": load_s, "triggers": triggers, "trigger_changes_png": lumen != plain,
            "mode_lora_changes_png": plain != png_plain}


# ---------------------------------------------------------------------------
# phase 6b: the worker pool and the super-resolution service
# ---------------------------------------------------------------------------

POOL_SOLO = 16  # back-to-back solo requests through the pool (and as many serial run_job)
POOL_BATCH = 8  # requests the pool coalesces into one pipelined run_jobs
POOL_TIMEOUT_S = 120  # the longest the phase waits for one future


def pool_spec(seed: int, mode=None) -> GenSpec:
    return GenSpec(f"a lighthouse in the fog, seed {seed}", size=f"{SIZE}x{SIZE}",
                   num_inference_steps=STEPS, seed=seed, mode=mode)


def used_bytes() -> int:
    """The card's used bytes (every process and cache), as the registry reads them."""
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    return total - free


def pool_stall(pool):
    """Park the pool thread in a custom job; the returned event releases it."""
    gate, entered = threading.Event(), threading.Event()

    def blocker(_worker):
        entered.set()
        gate.wait(POOL_TIMEOUT_S)

    pool.submit_job(CustomJob(blocker))
    expect(entered.wait(POOL_TIMEOUT_S), "the pool thread never took the stalling job")
    return gate


def pool_run(pool, specs, t_ref=None) -> tuple:
    """Submit every spec at once: (seconds from submit to the last result,
    [(png, seed)], each future's settle time after ``t_ref``, default the
    submit)."""
    settled = []
    t0 = time.perf_counter()
    t_ref = t0 if t_ref is None else t_ref
    futs = [pool.submit_job(GenerationJob(s)) for s in specs]
    for f in futs:
        f.add_done_callback(lambda _f: settled.append(time.perf_counter() - t_ref))
    out = [f.result(timeout=POOL_TIMEOUT_S) for f in futs]
    return time.perf_counter() - t0, out, sorted(settled)


def wait_for(cond, what: str) -> float:
    """Poll ``cond`` until it holds; the seconds it took (fails the run after
    POOL_TIMEOUT_S)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > POOL_TIMEOUT_S:
            expect(False, f"{what}: not done in {POOL_TIMEOUT_S} s")
            break
        time.sleep(0.002)
    return time.perf_counter() - t0


def serial_run(worker, specs) -> tuple:
    t0 = time.perf_counter()
    out = [worker.run_job(s) for s in specs]
    return time.perf_counter() - t0, out


def check_same(got, want, what: str) -> bool:
    same = [g == w for g, w in zip(got, want)]
    expect(len(got) == len(want) and all(same),
           f"{what}: {same.count(False)} of {len(want)} pool PNGs differ from run_job's")
    return all(same)


def pool_path(root: str, ckpt: str, mode_lora: str, onnx: str, per_request) -> tuple:
    """The pool over two modes of one SD1.5 directory (``a`` plain with a
    512x768 background bucket, ``b`` with the mode LoRA), cache 2, batch 8:
    requests while ``a``'s background bucket is captured and an SR job runs,
    16 solo requests and 8 coalesced ones against serial run_job, a tenant
    request, switches from the cache and cold, evict; every PNG byte-equal to
    run_job's on the same worker."""
    modes = testing.write_modes_yaml(os.path.join(root, "modes.yaml"), {
        "a": {"model": ckpt, "defaults": {"size": f"{SIZE}x{SIZE}", "steps": STEPS,
                                          "warmup_buckets": [f"{SIZE}x{SIZE * 3 // 2}"]}},
        "b": {"model": ckpt, "loras": [{"file": mode_lora, "strength": 0.8}],
              "defaults": {"size": f"{SIZE}x{SIZE}", "steps": STEPS}}}, default_mode="a")
    os.environ["DREAMLAB_MODE_CACHE"] = "2"
    os.environ["DREAMLAB_MAX_BATCH"] = str(POOL_BATCH)
    reset_model_registry()
    registry = get_model_registry("cuda")
    estimate = registry.estimate_model_hbm(ckpt)
    sr = SuperResService(model_path=onnx)
    out = {"estimate_model_hbm": estimate}
    pool = None
    try:
        used0 = used_bytes()
        t0 = time.perf_counter()
        pool = WorkerPool(mode_config=ModeConfigManager(modes), registry=registry, queue_max=64)
        t_built = time.perf_counter()
        out["cold_load_a_s"] = t_built - t0
        wa = pool.worker
        pipe_a = wa.pipeline
        s = pipe_a.vae_scale
        background_key = (1, SIZE * 3 // 2 // s, SIZE // s, STEPS)  # (batch, h_lat, w_lat, steps)

        # (1) requests and an SR job while a's 512x768 bucket is captured behind them
        def background_done():
            return any(k[:4] == background_key for k in list(pipe_a._compiled))

        pool.max_batch = 1  # solo requests (pipelined) until the coalesced batch below
        sr_fut = sr.submit(encode_png(test_image(SIZE, SIZE, 5)), magnitude=1)
        specs = [pool_spec(500 + i) for i in range(6)]
        _, during, settled = pool_run(pool, specs, t_built)
        wait_for(background_done, "a's background bucket")
        ready_s = time.perf_counter() - t_built
        sr_png, _ = sr_fut.result(timeout=POOL_TIMEOUT_S)
        check_png(sr_png, 3 * SIZE)
        background = next(p for k, p in pipe_a._compiled.items() if k[:4] == background_key)
        # times after the pool's constructor returned, which started the capture
        out["background"] = {"capture_s": background.capture_s,
                             "reserved_bytes": background.reserved_bytes,
                             "bucket_ready_after_s": ready_s, "requests_settled_after_s": settled}
        out["used_after_a_bytes"] = used_bytes() - used0
        check_same(during, [wa.run_job(s) for s in specs],
                   "requests during the background capture and an SR job")

        # (2) 16 back-to-back solo requests (pipelined) against serial run_job
        specs = [pool_spec(600 + i) for i in range(POOL_SOLO)]
        rounds = []
        for order in ("serial", "pool", "pool", "serial"):
            if order == "serial":
                secs, pngs = serial_run(wa, specs)
                want = pngs
            else:
                secs, pngs, _ = pool_run(pool, specs)
                check_same(pngs, want, "16 solo requests")
            rounds.append({order: POOL_SOLO / secs})
        prof = profile(lambda: pool_run(pool, specs))
        out["solo"] = {"img_per_s": rounds, "profile_16": {
            k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share", "kernel_launches")}}
        census = profile(lambda: pool.submit_job(GenerationJob(specs[0])).result(
            timeout=POOL_TIMEOUT_S))
        ran = {k: census["port_kernels"].get(k, 0) for k in ("flash_mma_kernel",
                                                             "gn_cluster_kernel")}
        expect(ran == {"flash_mma_kernel": per_request["flash"],
                       "gn_cluster_kernel": per_request["gn"]},
               f"a pool-dispatched request ran {census['port_kernels']}")
        out["census_profile"] = {"port_kernels": census["port_kernels"],
                                 "device_busy_ms": census["device_busy_ms"],
                                 "wall_ms": census["wall_ms"]}

        # (3) 8 requests coalesced into one pipelined run_jobs batch
        pool.max_batch = POOL_BATCH
        batch = [pool_spec(700 + i) for i in range(POOL_BATCH)]
        solo = [wa.run_job(s) for s in batch]  # a batch row equals its solo run
        wa.run_jobs(batch)  # captures the batch bucket
        t0 = time.perf_counter()
        serial_batch = wa.run_jobs(batch)
        serial_s = time.perf_counter() - t0
        check_same(serial_batch, solo, "serial run_jobs rows against run_job")
        calls = []
        dispatch = wa.run_jobs_pipelined
        wa.run_jobs_pipelined = lambda s: calls.append(len(s)) or dispatch(s)
        gate = pool_stall(pool)
        futs = [pool.submit_job(GenerationJob(s)) for s in batch]
        t0 = time.perf_counter()
        gate.set()
        coalesced = [f.result(timeout=POOL_TIMEOUT_S) for f in futs]
        pool_s = time.perf_counter() - t0
        del wa.run_jobs_pipelined
        expect(calls == [POOL_BATCH], f"the pool dispatched {calls}, expected one batch of 8")
        check_same(coalesced, solo, "the coalesced batch")
        out["coalesced"] = {"dispatches": calls, "img_per_s_pool": POOL_BATCH / pool_s,
                            "img_per_s_serial_run_jobs": POOL_BATCH / serial_s}

        # (4) a tenant request for b while a is active (b built cold as a tenant)
        t_spec = pool_spec(800, mode="b")
        used1 = used_bytes()
        t0 = time.perf_counter()
        tenant_png = pool.submit_job(GenerationJob(t_spec)).result(timeout=POOL_TIMEOUT_S)
        out["tenant_first_request_s"] = time.perf_counter() - t0
        out["tenant_build_used_bytes"] = used_bytes() - used1
        expect(pool.current_mode == "a" and pool.get_status()["warm_modes"] == ["b"],
               f"after a tenant request: {pool.get_status()}")
        wb = pool._mode_cache["b"][1]
        check_same([tenant_png], [wb.run_job(t_spec)], "the tenant request")
        expect(tenant_png != wa.run_job(pool_spec(800))[0], "mode b's LoRA changed nothing")

        # (5) a -> b -> a from the cache; evict b; a -> b cold; b -> a from the cache
        switch_ms = {}

        def switch(name, label):
            t0 = time.perf_counter()
            pool.switch_mode(name).result(timeout=POOL_TIMEOUT_S)
            switch_ms.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))

        switch("b", "from_cache")
        expect(pool.worker is wb, "the switch to b rebuilt the warm worker")
        check_same([pool.submit_job(GenerationJob(pool_spec(800))).result(
            timeout=POOL_TIMEOUT_S)], [tenant_png], "b after the switch")
        switch("a", "from_cache")
        expect(pool.worker is wa, "the switch back to a rebuilt the warm worker")
        buckets = len(wb.pipeline._compiled)
        before = used_bytes()
        expect(pool.evict_mode("b"), "evict_mode(b) evicted nothing")
        out["evict_freed_bytes"] = before - used_bytes()
        expect(registry.get_model("b") is None and wb.pipeline is None,
               "the evicted worker is still registered or holds its pipeline")
        used2 = used_bytes()
        switch("b", "cold")
        out["cold_switch_used_bytes"] = used_bytes() - used2
        wb2 = pool.worker
        check_same([pool.submit_job(GenerationJob(pool_spec(800))).result(
            timeout=POOL_TIMEOUT_S)], [tenant_png], "b rebuilt cold")
        switch("a", "from_cache")
        out["switch_ms"] = switch_ms
        out["modes"] = {name: {"registered_bytes": registry.get_model(name).hbm_bytes,
                               "estimate_model_hbm": estimate}
                        for name in ("a", "b")}
        out["buckets_captured"] = buckets + len(pipe_a._compiled) + len(wb2.pipeline._compiled)
        out["status"] = pool.get_status()
    finally:
        if pool is not None:
            pool.shutdown(drain=False, timeout=10)
        sr.shutdown()
    return out, during[0][0]


def sr_path(onnx: str, png: bytes) -> dict:
    """One pool PNG through the service at magnitude 1 (9 tiles) and 2 (49
    tiles), the card's luma against the CPU's fp32 forward (within 1 level),
    the colour path against the CPU's (byte-equal), times and peak memory;
    the bicubic mode against the CPU's."""
    cpu_params = load_sr_params(SUPERRES, onnx)
    svc = SuperResService(model_path=onnx)
    out = {"model_desc": svc.model_desc, "upscale": svc.cfg.upscale}
    try:
        worker = SuperResWorker(svc.params, svc.cfg)
        t0 = time.perf_counter()
        rgb = decode_rgb(png)
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0)
        luma, colour, passes_ms, encode_ms = {}, {}, {}, {}
        img = torch.from_numpy(rgb).cuda()
        for magnitude in (1, 2):
            # the luma of this pass, on the card and on the CPU
            ycc = image_ops.rgb_to_ycbcr(img)
            y_card = superres.upscale_luma(svc.params, svc.cfg, ycc[..., 0].float() / 255.0)
            y_cpu = superres.upscale_luma(cpu_params, svc.cfg, ycc[..., 0].cpu().float() / 255.0)
            err = (y_card.cpu() - y_cpu).abs().max().item()
            levels = (torch.round(y_card.cpu() * 255) - torch.round(y_cpu * 255)).abs().max().item()
            expect(levels <= 1, f"SR pass {magnitude}: the card's luma is {levels} levels off "
                                "the CPU's")
            luma[magnitude] = {"max_abs_err": err, "max_levels": levels}
            size = (img.shape[1] * 3, img.shape[0] * 3)
            same = {"rgb_to_ycbcr": torch.equal(ycc.cpu(), image_ops.rgb_to_ycbcr(img.cpu())),
                    "resize_bicubic": torch.equal(
                        image_ops.resize_bicubic(ycc[..., 1:], size).cpu(),
                        image_ops.resize_bicubic(ycc[..., 1:].cpu(), size))}
            nxt = worker.upscale_once(img)
            same["ycbcr_to_rgb"] = torch.equal(
                image_ops.ycbcr_to_rgb(image_ops.rgb_to_ycbcr(nxt)).cpu(),
                image_ops.ycbcr_to_rgb(image_ops.rgb_to_ycbcr(nxt).cpu()))
            expect(all(same.values()), f"SR pass {magnitude}: colour path {same}")
            colour[magnitude] = same
            passes_ms[magnitude] = {"upscale_once_ms": device_ms(lambda: worker.upscale_once(img), 3),
                                    "forward_ms": device_ms(lambda: superres.upscale_luma(
                                        svc.params, svc.cfg, ycc[..., 0].float() / 255.0), 3),
                                    "tiles": math.ceil(img.shape[0] / svc.cfg.tile)
                                    * math.ceil(img.shape[1] / svc.cfg.tile),
                                    "input": list(img.shape)}
            img = nxt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        results = {}
        for magnitude in (1, 2):
            t0 = time.perf_counter()
            data, passes = svc.submit(png, magnitude=magnitude).result(timeout=POOL_TIMEOUT_S)
            results[magnitude] = {"service_ms": 1e3 * (time.perf_counter() - t0),
                                  "passes": passes, "bytes": len(data)}
            check_png(data, SIZE * 3 ** magnitude)
            t0 = time.perf_counter()
            up = decode_png(data)
            results[magnitude]["decode_out_ms"] = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            encode_png(up)
            encode_ms[magnitude] = 1e3 * (time.perf_counter() - t0)
            if magnitude == 2:
                expect(np.array_equal(up, img.cpu().numpy()),
                       "the service's magnitude-2 PNG differs from the worker's two passes")
        out["peak_bytes_above_baseline"] = torch.cuda.max_memory_allocated() - base
        out.update(luma=luma, colour_path_equal=colour, pass_ms=passes_ms, service=results,
                   encode_ms=encode_ms)
        cpu_bicubic = SuperResWorker(None, SUPERRES, device="cpu").upscale_rgb(rgb, 1)[0]
        bicubic = SuperResService()
        try:
            data, _ = bicubic.submit(png, magnitude=1).result(timeout=POOL_TIMEOUT_S)
        finally:
            bicubic.shutdown()
        out["bicubic_equal_cpu"] = np.array_equal(decode_png(data), cpu_bicubic)
        expect(out["bicubic_equal_cpu"], "the card's bicubic mode differs from the CPU's")
    finally:
        svc.shutdown()
    return out


def pool_sr_phase(root: str, per_request) -> tuple:
    """Phase 6b on the loader phase's directory and mode LoRA: the pool path
    with its launch counts reset before it and read after it (each captured
    bucket: an eager run and a capture), then the SR path on one of its
    PNGs. Returns the phase's line and the pool path's launches."""
    onnx = testing.write_espcn_onnx(os.path.join(root, "super-resolution-10.onnx"),
                                    testing.random_espcn(SUPERRES, seed=10))
    t0 = time.perf_counter()
    reset_counts()
    pool_out, png = pool_path(root, os.path.join(root, "sd15"),
                              os.path.join(root, "mode_lora.safetensors"), onnx, per_request)
    launched = counts()
    n = pool_out["buckets_captured"]
    expect(n > 0 and launched == {k: CAPTURE_RUNS * n * v for k, v in per_request.items()},
           f"the pool path launched {launched}, expected {CAPTURE_RUNS} x {n} buckets x "
           f"{per_request}")
    pool_out.update(launches=launched, path_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sr_out = sr_path(onnx, png)
    sr_out["path_s"] = time.perf_counter() - t0
    return {"pool": pool_out, "superres": sr_out}, launched


# ---------------------------------------------------------------------------
# phase 6c: the HTTP server over the pool, on real sockets
# ---------------------------------------------------------------------------

SERVER_SERIAL = 20  # serial /generate requests timed (and as many run_job beside them)
SERVER_CLIENTS = 16  # concurrent HTTP clients, one request each


def http_call(port: int, method: str, path: str, body=None, headers=None, conn=None) -> tuple:
    """(status, lower-case headers, body) of one request (a fresh connection
    unless ``conn`` is given)."""
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=POOL_TIMEOUT_S)
    try:
        if isinstance(body, dict):
            body, headers = json.dumps(body).encode(), {"Content-Type": "application/json"}
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        if conn is None:
            c.close()


def png_seed(png: bytes) -> int:
    """The seed in a port PNG's ``parameters`` text."""
    text = png[png.index(b"tEXtparameters\x00") + 15:]
    return int(re.search(rb"Seed: (\d+)", text).group(1))


def server_path(root: str, ckpt: str, mode_lora: str, onnx: str, per_request) -> dict:
    """``create_app(device="cuda")`` served on 127.0.0.1 over three modes of
    the loader phase's SD1.5 directory (``a`` plain, ``b`` with the mode
    LoRA, ``c`` with a full-width ControlNet) and the pool phase's ESPCN;
    every route's bytes held against the in-process call they stand for;
    a disconnected client's job never runs; HTTP p50 beside run_job's, 16
    concurrent clients beside the pool's own img/s, the busy share."""
    t_write = time.perf_counter()
    net = cast_tree(random_controlnet(SD15_CONTROLNET, seed=13,
                                      cond_channels=CONTROLNET_COND_CHANNELS, device="cuda"),
                    torch.float16)
    cn_dir = write_controlnet_dir(net, SD15_CONTROLNET, os.path.join(root, "cn_server"))
    del net
    defaults = {"size": f"{SIZE}x{SIZE}", "steps": STEPS}
    modes = testing.write_modes_yaml(os.path.join(root, "modes_server.yaml"), {
        "a": {"model": ckpt, "defaults": defaults},
        "b": {"model": ckpt, "loras": [{"file": mode_lora, "strength": 0.8}],
              "defaults": defaults},
        "c": {"model": ckpt, "controlnet": {"file": cn_dir, "scale": 1.0},
              "defaults": defaults}}, default_mode="a")
    os.environ["DREAMLAB_MODE_CACHE"] = "3"
    os.environ["DREAMLAB_MAX_BATCH"] = "1"  # solo requests, pipelined, as in the pool phase
    reset_model_registry()
    cfg = server_app.ServerConfig(modes_config=modes, default_size=f"{SIZE}x{SIZE}",
                                  default_steps=STEPS, sr_model_path=onnx)
    t_start = time.perf_counter()
    marks = {"controlnet_written": t_start - t_write}
    app = server_app.create_app(cfg, device="cuda")
    srv = ServerThread(app).start()
    out = {"startup_s": time.perf_counter() - t_start, "marks_s": marks}
    mark = lambda name: marks.__setitem__(name, time.perf_counter() - t_start)
    state = app[server_app.STATE_KEY]
    pool, port = state.pool, srv.port
    prompt = "a harbour at night"
    gen = lambda seed, **kw: {"prompt": prompt, "seed": seed, **kw}
    spec = lambda seed, **kw: GenSpec(prompt, size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                                      seed=seed, **kw)
    try:
        wa = pool.worker
        checks = {}
        # /generate = run_job; the storage round trip
        status, hdr, png = http_call(port, "POST", "/generate", gen(900))
        check_png(png)
        checks["generate_eq_run_job"] = status == 200 and png == wa.run_job(spec(900))[0]
        status, _, stored = http_call(port, "GET", f"/storage/{hdr['x-lcm-image-key']}")
        checks["storage_round_trip"] = status == 200 and stored == png
        checks["headers"] = (hdr["x-seed"], hdr["x-mode"], hdr["x-superres"]) == ("900", "a", "0")
        # /generate/stream: 4 progress events in order, the result = /generate's
        status, hdr, body = http_call(port, "POST", "/generate/stream", gen(900))
        events = [(b.split("\n")[0][7:], json.loads(b.split("\n")[1][6:]))
                  for b in body.decode().strip().split("\n\n")]
        steps = [d["step"] for e, d in events if e == "progress"]
        result = [d for e, d in events if e == "result"]
        checks["stream_progress_in_order"] = steps == list(range(STEPS))
        checks["stream_result_eq_generate"] = (
            len(result) == 1 and base64.b64decode(result[0]["image_b64"]) == png)
        # /generate with superres = the SR service on that PNG
        status, hdr, up = http_call(port, "POST", "/generate",
                                    gen(900, superres=True, superres_magnitude=1))
        want, _ = state.sr.submit(png, magnitude=1).result(timeout=POOL_TIMEOUT_S)
        checks["superres_eq_service"] = status == 200 and up == want and hdr["x-sr-passes"] == "1"
        # compat: batch 2 and n 2 = their solo /generate
        solo = lambda seed: http_call(port, "POST", "/generate", gen(seed))[2]
        status, _, body = http_call(port, "POST", "/sdapi/v1/txt2img", {
            "prompt": prompt, "width": SIZE, "height": SIZE, "steps": STEPS, "seed": 910,
            "batch_size": 2})
        images = [base64.b64decode(i) for i in json.loads(body)["images"]]
        checks["txt2img_batch2_eq_solo"] = status == 200 and images == [solo(910), solo(911)]
        status, _, body = http_call(port, "POST", "/v1/images/generations",
                                    {"prompt": prompt, "size": f"{SIZE}x{SIZE}", "n": 2})
        images = [base64.b64decode(d["b64_json"]) for d in json.loads(body)["data"]]
        checks["openai_n2_eq_solo"] = status == 200 and len(images) == 2 and all(
            img == solo(png_seed(img)) for img in images)
        # img2img and inpaint = run_img2img
        image, mask = test_image(SIZE, SIZE, 90), half_mask(SIZE, SIZE)
        for route, files, strength in (
                ("/v1/img2img", {"file": ("in.png", encode_png(image), "image/png")}, 0.5),
                ("/v1/inpaint", {"file": ("in.png", encode_png(image), "image/png"),
                                 "mask": ("mask.png", encode_png(mask), "image/png")}, 1.0)):
            form, ctype = multipart_body({"prompt": prompt, "strength": str(strength),
                                          "steps": str(STEPS), "seed": "920"}, files)
            status, hdr, body = http_call(port, "POST", route, form, {"Content-Type": ctype})
            want = wa.run_img2img(spec(920), image, strength=strength,
                                  mask=mask if "mask" in files else None)[0]
            checks[f"{route[4:]}_eq_run_img2img"] = status == 200 and body == want
        mark("routes")
        # a client that goes away while its job is queued: the job never runs
        ran = []
        dispatch = wa.run_job_pipelined
        wa.run_job_pipelined = lambda s: ran.append(s.seed) or dispatch(s)
        gate = pool_stall(pool)
        body = json.dumps(gen(4242)).encode()
        sock = socket.create_connection(("127.0.0.1", port))
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        wait_for(lambda: pool.queue.qsize() == 1, "the disconnecting client's job queued")
        (job,) = list(pool.queue.queue)
        sock.close()
        wait_for(job.future.cancelled, "the disconnected client's job cancelled")
        gate.set()
        http_call(port, "POST", "/generate", gen(901))
        del wa.run_job_pipelined
        checks["disconnected_job_never_ran"] = job.future.cancelled() and ran == [901]

        mark("disconnect")
        # timings: serial /generate against run_job on the same specs
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=POOL_TIMEOUT_S)
        seeds = list(range(1000, 1000 + SERVER_SERIAL))
        lat = {"run_job": [], "http": []}
        for order in ("http", "run_job"):
            for seed in seeds:
                t0 = time.perf_counter()
                if order == "http":
                    status, _, body = http_call(port, "POST", "/generate", gen(seed), conn=conn)
                    expect(status == 200, f"/generate answered {status}")
                else:
                    wa.run_job(spec(seed))
                lat[order].append(1e3 * (time.perf_counter() - t0))
        conn.close()
        out["serial"] = {"p50_ms_http": statistics.median(lat["http"]),
                         "p50_ms_run_job": statistics.median(lat["run_job"]),
                         "min_ms_http": min(lat["http"]), "max_ms_http": max(lat["http"]),
                         "samples_each": len(lat["http"])}
        mark("serial")
        # 16 concurrent clients against the pool's own img/s on the same specs
        seeds = list(range(1100, 1100 + SERVER_CLIENTS))

        def clients():
            got = [None] * len(seeds)

            def one(i):
                got[i] = http_call(port, "POST", "/generate", gen(seeds[i]))

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(seeds))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0, got

        rounds = []
        for order in ("pool", "http", "http", "pool"):
            if order == "pool":
                secs, pngs, _ = pool_run(pool, [spec(s) for s in seeds])
                want = [p for p, _ in pngs]
            else:
                secs, got = clients()
                check_same([b for _, _, b in got], want, "16 concurrent HTTP clients")
            rounds.append({order: len(seeds) / secs})
        prof = profile(clients)
        out["concurrent"] = {"img_per_s": rounds, "profile_16": {
            k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share", "kernel_launches")}}
        mark("concurrent")
        census_req = profile(lambda: http_call(port, "POST", "/generate", gen(1200)))
        ran_k = {k: census_req["port_kernels"].get(k, 0) for k in ("flash_mma_kernel",
                                                                   "gn_cluster_kernel")}
        checks["http_request_ran_the_census"] = ran_k == {
            "flash_mma_kernel": per_request["flash"], "gn_cluster_kernel": per_request["gn"]}
        out["census_profile"] = {"port_kernels": census_req["port_kernels"],
                                 "device_busy_ms": census_req["device_busy_ms"],
                                 "wall_ms": census_req["wall_ms"]}

        mark("census")
        # /api/modes/switch with wait_seconds, then X-Mode; /v1/controlnet = generate
        t0 = time.perf_counter()
        status, _, body = http_call(port, "POST", "/api/modes/switch",
                                    {"mode": "c", "wait_seconds": 120})
        out["switch_to_c_ms"] = 1e3 * (time.perf_counter() - t0)
        status, hdr, _ = http_call(port, "POST", "/generate", gen(930))
        checks["switch_then_x_mode"] = json.loads(body)["status"] == "switched" \
            and hdr["x-mode"] == "c"
        wc = pool.worker
        hint = test_image(SIZE, SIZE, 91)
        form, ctype = multipart_body({"prompt": prompt, "steps": str(STEPS), "seed": "931",
                                      "scale": "0.7"},
                                     {"file": ("hint.png", encode_png(hint), "image/png")})
        status, hdr, body = http_call(port, "POST", "/v1/controlnet", form,
                                      {"Content-Type": ctype})
        want = wc.run_job(spec(931, control_image=hint, controlnet_scale=0.7))[0]
        checks["controlnet_eq_generate"] = status == 200 and body == want and \
            (hdr["x-controlnet"], hdr["x-controlnet-scale"]) == ("1", "0.7")
        mark("controlnet")
        status, hdr, _ = http_call(port, "POST", "/generate", gen(932, mode="b"))
        checks["tenant_b_x_mode"] = status == 200 and hdr["x-mode"] == "b"
        status, _, body = http_call(port, "GET", "/api/models/status")
        out["status"] = json.loads(body)["queue"]
        out["memory"] = json.loads(body)["memory"]
        out["buckets"] = sum(len(w.pipeline._compiled) for w in
                             [pool.worker] + [e[1] for e in pool._mode_cache.values()])
        mark("tenant")
        for name, ok in checks.items():
            expect(bool(ok), f"server: {name}")
        out["checks"] = checks
    finally:
        srv.stop()  # the cleanup hooks shut the pool and the SR service down
    out["shut_down"] = pool.get_status()["shutdown"]
    return out


def server_phase(root: str, onnx: str, per_request) -> tuple:
    """Phase 6c on the loader phase's directory and mode LoRA and the pool
    phase's ESPCN, its launch counts reset before it and read after it.
    Returns the phase's line and its launches."""
    t0 = time.perf_counter()
    reset_counts()
    out = server_path(root, os.path.join(root, "sd15"),
                      os.path.join(root, "mode_lora.safetensors"), onnx, per_request)
    launched = counts()
    expect(all(launched[k] > 0 for k in ("flash", "gn")),
           f"the server path launched {launched}")
    out.update(launches=launched, path_s=time.perf_counter() - t0)
    return {"server": out}, launched


# ---------------------------------------------------------------------------
# phase 6d: Yume dreaming on the server's pool (CLIP ViT-B/32 scorer)
# ---------------------------------------------------------------------------

YUME_PROMPT = "a lighthouse on a cliff"
YUME_SEEDS = [1301, 1302, 1303, 1304]  # one candidate batch (the worker's batch of 4)
YUME_TIMED = 10  # candidate batches and scorings timed (median)
YUME_RENDERS = 5  # renders timed (median)
YUME_ITERATIONS = 16  # the dreams/s session's candidate batches
YUME_POOL = 16  # pool requests a round, with a dream session running and without
# a candidate batch (64², batch 4, 1 step): the UNet's 45 GroupNorm+SiLU calls
# and the VAE decode's 29; its attention runs over at most 64 tokens, under
# the flash rule's 256 (ops/attention.py), so no K1
YUME_CANDIDATE_PER_BATCH = {"flash": 0, "gn": 45 + 29, "gn_stats": 74, "gn_apply": 74}
TOL_CLIP_SCORE = 1e-4  # card against CPU, fp32 on both: a score's absolute error
TOL_CLIP_FEATURES = 1e-4  # a feature's error over the largest feature magnitude


class StopAfter:
    """A scorer that ends its dream session after ``batches`` candidate
    batches (the loop reads its stop flag before each batch): a session of a
    fixed iteration count."""

    def __init__(self, scorer, dream, batches: int):
        self.scorer, self.dream, self.batches, self.calls = scorer, dream, batches, 0

    def score_batch(self, images, prompt):
        self.calls += 1
        if self.calls >= self.batches:
            self.dream._stop.set()  # a flag the loop polls: no waiter to wake
        return self.scorer.score_batch(images, prompt)


def clip_against_cpu(card_model, clip_dir: str, images) -> dict:
    """The card's CLIP features and CLIPScorer scores against the same
    directory loaded on the CPU (fp32 both)."""
    from dreamlab_tpu_torch.loader import load_clip_model
    from dreamlab_tpu_torch.yume.scoring import CLIPScorer

    cpu_model = load_clip_model(clip_dir, device="cpu")
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
    text = rel(card_model.embed_text(YUME_PROMPT), cpu_model.embed_text(YUME_PROMPT))
    feats = rel(card_model.embed_images(images), cpu_model.embed_images(images))
    card_scores = CLIPScorer(card_model).score_batch(images, YUME_PROMPT)
    cpu_scores = CLIPScorer(cpu_model).score_batch(images, YUME_PROMPT)
    score_err = max(abs(a - b) for a, b in zip(card_scores, cpu_scores))
    expect(text <= TOL_CLIP_FEATURES and feats <= TOL_CLIP_FEATURES,
           f"CLIP features card vs CPU: text {text}, image {feats} over {TOL_CLIP_FEATURES}")
    expect(score_err <= TOL_CLIP_SCORE, f"CLIP scores card vs CPU: {score_err}")
    return {"text_rel_err": text, "image_rel_err": feats, "score_max_abs_err": score_err,
            "limit_score": TOL_CLIP_SCORE, "limit_features_rel": TOL_CLIP_FEATURES,
            "scores_card": card_scores, "scores_cpu": cpu_scores}


def yume_path(root: str, ckpt: str, style_lora: str) -> tuple:
    """``create_app(device="cuda")`` with ``YUME_ENABLED`` over mode ``a`` of
    the loader phase's SD1.5 directory (a style ``s`` over the mode LoRA's
    file), ``YUME_CLIP_MODEL`` a full-width CLIP ViT-B/32 directory of seeded
    random fp32 weights: the native rung on the card, held to the CPU;
    candidates = their solo runs, renders = run_job, also beside styled pool
    requests; medians of candidate generation, scoring and renders;
    dreams/s over one session of YUME_ITERATIONS batches; the pool's img/s
    with a session running and without; /dreams/* over HTTP. Returns the
    phase's line, the server (still up, for the census) and its state."""
    from dreamlab_tpu_torch.engine.styles import reset_style_registry
    from dreamlab_tpu_torch.models.configs import CLIP_VIT_B32_TEXT, CLIP_VIT_B32_VISION

    t_start = time.perf_counter()
    text_cfg, vision_cfg = CLIP_VIT_B32_TEXT, CLIP_VIT_B32_VISION
    tok = testing.clip_tokenizer(text_cfg.vocab_size)  # EOS last, as CLIP's own vocabulary
    text_params, vision_params = testing.random_clip(text_cfg, vision_cfg, seed=21,
                                                     device="cuda")
    clip_dir = testing.write_clip_dir(os.path.join(root, "clip-vit-base-patch32"), text_params,
                                      text_cfg, vision_params, vision_cfg, tok)
    del text_params, vision_params
    styles = os.path.join(root, "styles.yaml")
    with open(styles, "w") as f:
        f.write(f"styles:\n  s:\n    file: {style_lora}\n    strengths: [1.0]\n")
    defaults = {"size": f"{SIZE}x{SIZE}", "steps": STEPS}
    modes = testing.write_modes_yaml(os.path.join(root, "modes_yume.yaml"),
                                     {"a": {"model": ckpt, "defaults": defaults}},
                                     default_mode="a")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    os.environ.update(YUME_CLIP_MODEL=clip_dir, STYLES_CONFIG=styles, YUME_FINALIZE_RENDERS="4",
                      DREAMLAB_MODE_CACHE="1", DREAMLAB_MAX_BATCH="1",
                      REDIS_PORT=str(sock.getsockname()[1]))  # nothing listens: in memory
    sock.close()
    reset_style_registry()
    reset_model_registry()
    out = {"write_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    app = server_app.create_app(server_app.ServerConfig(
        modes_config=modes, default_size=f"{SIZE}x{SIZE}", default_steps=STEPS,
        yume_enabled=True), device="cuda")
    srv = ServerThread(app).start()
    out["startup_s"] = time.perf_counter() - t0
    state = app[server_app.STATE_KEY]
    pool, port, dream = state.pool, srv.port, state.dream_worker
    worker, pipe = pool.worker, pool.worker.pipeline
    checks = {"dream_bound_to_pool_worker": dream is not None and dream.worker is worker,
              "native_clip_on_the_card": type(dream.scorer.model).__name__ == "NativeCLIP"
              and dream.scorer.model.device.type == "cuda"}
    spec = lambda seed, size=SIZE, steps=STEPS, **kw: GenSpec(
        YUME_PROMPT, size=f"{size}x{size}", num_inference_steps=steps, seed=seed, **kw)
    cand_size = int(dream.candidate_size.split("x")[0])
    solo = lambda seed: decode_png(worker.run_job(spec(seed, cand_size,
                                                       dream.candidate_steps))[0])
    # candidates: one batch (its bucket captured on the first) = the solo runs
    t0 = time.perf_counter()
    images = dream._generate_candidates(YUME_SEEDS, YUME_PROMPT)
    out["first_candidate_batch_s"] = time.perf_counter() - t0
    out["candidate_bucket"] = [b for b in bucket_stats(pipe)
                               if b["key"][:4] == [len(YUME_SEEDS), cand_size // pipe.vae_scale,
                                                   cand_size // pipe.vae_scale,
                                                   dream.candidate_steps]]
    want = [solo(s) for s in YUME_SEEDS]
    checks["candidates_eq_solo"] = all(np.array_equal(a, b) for a, b in zip(images, want))
    # the CLIP scorer on the card against the CPU
    out["clip"] = clip_against_cpu(dream.scorer.model, clip_dir, images)
    # medians: candidate generation, scoring with the text cached, renders
    gen_ms, score_ms = [], []
    for _ in range(YUME_TIMED):
        t0 = time.perf_counter()
        batch = dream._generate_candidates(YUME_SEEDS, YUME_PROMPT)
        gen_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        dream.scorer.score_batch(batch, YUME_PROMPT)
        score_ms.append(1e3 * (time.perf_counter() - t0))
    checks["candidates_repeat"] = all(np.array_equal(a, b) for a, b in zip(batch, images))
    render_ms = []
    for i in range(YUME_RENDERS):
        cand = dw.DreamCandidate(seed=YUME_SEEDS[i % len(YUME_SEEDS)], prompt=YUME_PROMPT,
                                 score=0.5)
        t0 = time.perf_counter()
        dream._render(cand)
        render_ms.append(1e3 * (time.perf_counter() - t0))
    checks["render_eq_run_job"] = cand.rendered_png == worker.run_job(spec(cand.seed))[0]
    out["timing_ms"] = {"candidate_batch": statistics.median(gen_ms),
                        "score_batch_text_cached": statistics.median(score_ms),
                        "render": statistics.median(render_ms),
                        "samples": {"candidate_batch": YUME_TIMED, "score": YUME_TIMED,
                                    "render": YUME_RENDERS}}
    # candidate batches while styled pool requests are in flight: unstyled
    styled_specs = [spec(1400 + i, style="s", style_level=1) for i in range(6)]
    futs = [pool.submit_job(GenerationJob(s)) for s in styled_specs]
    beside = []
    while not all(f.done() for f in futs) or not beside:
        beside.append(dream._generate_candidates(YUME_SEEDS, YUME_PROMPT))
    styled = [f.result(timeout=POOL_TIMEOUT_S)[0] for f in futs]
    checks["candidates_beside_styled_requests_unstyled"] = all(
        np.array_equal(a, b) for batch in beside for a, b in zip(batch, want))
    checks["styled_pool_pngs_eq_run_job"] = styled == [worker.run_job(s)[0] for s in styled_specs]
    checks["style_changes_png"] = styled[0] != worker.run_job(spec(1400))[0]
    out["candidate_batches_beside_styled"] = len(beside)
    # one session of YUME_ITERATIONS batches over HTTP: dreams/s, /dreams/*
    base_scorer = dream.scorer
    dream.score_threshold = 0.0  # random weights score near 0: keep every candidate
    dream.scorer = StopAfter(base_scorer, dream, YUME_ITERATIONS)
    status, _, body = http_call(port, "POST", "/dreams/start",
                                {"prompt": YUME_PROMPT, "strategy": "random"})
    checks["start_200"] = status == 200
    checks["second_start_409"] = http_call(port, "POST", "/dreams/start",
                                           {"prompt": "x"})[0] == 409
    wait_for(lambda: not dream.get_status()["running"], "the dream session's end")
    status, _, body = http_call(port, "GET", "/dreams/stats")
    stats = json.loads(body)
    out["session"] = {k: stats[k] for k in ("generated", "scored", "kept", "rendered",
                                            "dreams_per_sec")}
    checks["session_counts"] = (stats["generated"], stats["scored"]) == (
        4 * YUME_ITERATIONS, 4 * YUME_ITERATIONS)
    status, _, body = http_call(port, "POST", "/dreams/stop")
    checks["stop_200"] = status == 200 and not json.loads(body)["running"]
    status, _, body = http_call(port, "GET", "/dreams/top?n=5")
    top = json.loads(body)["top"]
    checks["top"] = status == 200 and len(top) == 5 and top == dream.get_top_dreams(5)
    checks["recent"] = http_call(port, "GET", "/dreams/recent")[0] == 200
    checks["status"] = http_call(port, "GET", "/dreams/status")[0] == 200
    rendered = [c for c in dream.top if c.rendered_png is not None]
    served = []
    for cand in rendered[:3]:
        status, hdr, png = http_call(port, "GET", f"/dreams/image/{cand.candidate_id}")
        want_png = worker.run_job(GenSpec(cand.prompt, size=dream.render_size,
                                          num_inference_steps=dream.render_steps,
                                          seed=cand.seed))[0]
        served.append(status == 200 and hdr["content-type"] == "image/png" and png == want_png)
    checks["image_eq_run_job"] = len(served) > 0 and all(served)
    checks["image_404"] = http_call(port, "GET", "/dreams/image/0123456789abcdef")[0] == 404
    dream.scorer = base_scorer
    # the pool beside a session and without one, in turns
    seeds = list(range(1500, 1500 + YUME_POOL))
    pool_want = [worker.run_job(spec(s))[0] for s in seeds]

    def pool_round(with_dreams: bool):
        if with_dreams:
            expect(http_call(port, "POST", "/dreams/start", {"prompt": YUME_PROMPT})[0] == 200,
                   "yume: a session beside the pool did not start")
            wait_for(lambda: dream.stats["generated"] > 0, "the first candidates")
        secs, pngs, _ = pool_run(pool, [spec(s) for s in seeds])
        generated = dream.stats["generated"]
        if with_dreams:
            http_call(port, "POST", "/dreams/stop")
        check_same([p for p, _ in pngs], pool_want, "pool PNGs beside a dream session"
                   if with_dreams else "pool PNGs")
        return {"with_dreams" if with_dreams else "without": YUME_POOL / secs,
                "candidates_meanwhile": generated if with_dreams else 0}

    rounds = [pool_round(w) for w in (True, False, False, True)]
    http_call(port, "POST", "/dreams/start", {"prompt": YUME_PROMPT})
    wait_for(lambda: dream.stats["generated"] > 0, "the first candidates")
    prof = profile(lambda: pool_run(pool, [spec(s) for s in seeds]))
    http_call(port, "POST", "/dreams/stop")
    out["beside_pool"] = {"img_per_s": rounds, "profile_16_with_dreams": {
        k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share", "kernel_launches",
                             "port_kernels")}}
    for name, ok in checks.items():
        expect(bool(ok), f"yume: {name}")
    out["checks"] = checks
    out["path_s"] = time.perf_counter() - t_start
    return out, srv, state


def yume_phase(root: str, rows, errs) -> tuple:
    """Phase 6d: counts reset before the Yume path and read after it (the
    default 512² bucket captured at startup, the candidate buckets on their
    first batch); then, outside the count, the census of a candidate batch on
    the eager route, its GroupNorm shapes checked and timed, and a profiled
    candidate batch and render. Returns the phase's line and the kernels
    line's ``_yume`` entries."""
    t0 = time.perf_counter()
    reset_counts()
    out, srv, state = yume_path(root, os.path.join(root, "sd15"),
                                os.path.join(root, "mode_lora.safetensors"))
    launched = counts()
    try:
        dream, pipe = state.dream_worker, state.pool.worker.pipeline
        expect(all(launched[k] > 0 for k in ("flash", "gn")), f"the Yume path launched {launched}")
        size = int(dream.candidate_size.split("x")[0])
        h_lat = size // pipe.vae_scale
        lats, noises = zip(*(pipe._sample_noise(s, 1, h_lat, h_lat, dream.candidate_steps, 1.0)
                             for s in YUME_SEEDS))
        seen = census(pipe, run=lambda: pipe._generate_eager(
            [YUME_PROMPT] * len(YUME_SEEDS), height=size, width=size,
            num_inference_steps=dream.candidate_steps, seed=YUME_SEEDS[0],
            latents=np.stack([lat[0] for lat in lats]),
            step_noises=np.stack([n[:, 0] for n in noises], axis=1)))
        per_batch = per_request_of(seen)
        expect(per_batch == YUME_CANDIDATE_PER_BATCH,
               f"candidate batch census {per_batch}, expected {YUME_CANDIDATE_PER_BATCH}")
        cand_errs = collections.defaultdict(float)
        cand_rows = time_kernels(seen, torch.bfloat16, cand_errs, parts=False)
        prof_cand = profile(lambda: dream._generate_candidates(YUME_SEEDS, YUME_PROMPT))
        prof_render = profile(lambda: state.pool.worker.run_job(GenSpec(
            YUME_PROMPT, size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS, seed=7)))
        ran = lambda prof: {k: prof["port_kernels"].get(k, 0)
                            for k in ("flash_mma_kernel", "gn_cluster_kernel")}
        expect(ran(prof_cand) == {"flash_mma_kernel": 0,
                                  "gn_cluster_kernel": YUME_CANDIDATE_PER_BATCH["gn"]},
               f"a profiled candidate batch ran {prof_cand['port_kernels']}")
        expect(ran(prof_render) == {"flash_mma_kernel": 40, "gn_cluster_kernel": 209},
               f"a profiled render ran {prof_render['port_kernels']}")
        out["census_candidate_batch"] = per_batch
        out["profile_candidate_batch"] = {k: prof_cand[k] for k in (
            "wall_ms", "device_busy_ms", "busy_share", "kernel_launches", "port_kernels")}
        out["profile_render"] = {k: prof_render[k] for k in (
            "wall_ms", "device_busy_ms", "busy_share", "kernel_launches", "port_kernels")}
        out["per_candidate_batch_ms"] = {k: dict(v) for k, v in cand_rows.items()
                                         if k == "gn"}
    finally:
        srv.stop()  # the cleanup hooks stop the dream session, the pool and the SR service
        for name in ("YUME_CLIP_MODEL", "STYLES_CONFIG", "YUME_FINALIZE_RENDERS", "REDIS_PORT"):
            os.environ.pop(name, None)
        from dreamlab_tpu_torch.engine.styles import reset_style_registry

        reset_style_registry()
        dw.set_dream_worker(None)
    out.update(launches=launched, phase_s=time.perf_counter() - t0)
    entries = (kernel_entries(rows, launched, errs, "_yume", ("flash", "gn"))
               + kernel_entries(cand_rows, launched, cand_errs, "_yume_candidates", ("gn",)))
    return {"yume": out}, entries


# ---------------------------------------------------------------------------
# phase 7: styles, img2img and inpainting at SD1.5's 512x512
# ---------------------------------------------------------------------------


def timed_ms(fn) -> float:
    """Host ms of ``fn`` between two device syncs (work that ends on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def test_image(height: int, width: int, seed: int) -> np.ndarray:
    """A seeded uint8 picture: smooth colour gradients under a little noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([x / width, y / height, 0.5 + 0.5 * np.sin(x / 37.0 + y / 53.0)], -1)
    return np.clip(255 * img + rs.randn(height, width, 3) * 8, 0, 255).astype(np.uint8)


def half_mask(height: int, width: int) -> np.ndarray:
    mask = np.zeros((height, width), np.uint8)
    mask[:, width // 2:] = 255  # regenerate the right half
    return mask


def check_merged_leaves(worker, sdef, level) -> dict:
    """The merged leaves on the card (the cache's values) against a CPU fp32
    merge of the same base and adapter tensors, rounded to bf16: at most one
    bf16 ulp apart."""
    scale = sdef.strength_for_level(level)
    values = worker._merged_cache[(sdef.path, scale)][1]
    modules = worker._style_cache[sdef.path].unet
    worst, n_ulp1 = 0.0, 0
    for path, got in values.items():
        down, up, alpha = modules[path]
        want = (worker._base[path].float().cpu() + scale * (alpha / down.shape[0])
                * (up.float().cpu() @ down.float().cpu())).to(torch.bfloat16)
        _, exp = torch.frexp(want.float())
        ulps = (got.float().cpu() - want.float()).abs() / torch.pow(2.0, (exp - 8).float())
        worst = max(worst, ulps.max().item())
        n_ulp1 += int((ulps > 0).sum())
    expect(worst <= 1.0, f"merged leaves {worst} bf16 ulps off the CPU fp32 merge")
    return {"leaves": len(values), "max_ulps": worst, "values_one_ulp_off": n_ulp1}


def styles_path(worker, styles, per_request) -> dict:
    """Unstyled, style A at level 3 (its first merge, timed alone), A again
    (a cache hit), B, unstyled again, all replays of one captured bucket."""
    pipe = worker.pipeline
    spec = lambda style=None, level=0: GenSpec(
        "a lighthouse in a storm", size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS, seed=31,
        style=style, style_level=level)
    png = lambda sp: worker.run_job_with_latents(sp)[0]  # no metadata: comparable bytes
    t0 = time.perf_counter()
    reset_counts()
    plain = png(spec())  # captures the bucket
    read_ms = timed_ms(lambda: lora.load_lora(styles["A"].path))
    with worker._lock:
        first_ms = timed_ms(lambda: worker._apply_style("A", 3))  # reads the file, merges
        first_restore_ms = timed_ms(lambda: worker._apply_style(None, 0))
    a1 = png(spec("A", 3))
    hit_ms, restore_ms = [], []
    with worker._lock:
        for _ in range(STYLE_TIMING_REPS):
            hit_ms.append(timed_ms(lambda: worker._apply_style("A", 3)))
            restore_ms.append(timed_ms(lambda: worker._apply_style(None, 0)))
    a2 = png(spec("A", 3))
    b = png(spec("B", 3))
    plain2 = png(spec())
    launched = counts()
    expect(launched == {k: CAPTURE_RUNS * v for k, v in per_request.items()},
           f"the styles path launched {launched}, expected one bucket's capture "
           f"{CAPTURE_RUNS} x {per_request} (styled replays go through no wrapper)")
    expect(plain2 == plain, "unstyled PNG bytes changed after a styled request")
    expect(a1 != plain and b != plain and b != a1, "a style changed nothing")
    expect(a2 == a1, "style A twice gave other bytes")
    with worker._lock:
        worker._apply_style("A", 3)
        try:
            eager = eager_png(pipe, spec("A", 3))
        finally:
            worker._apply_style(None, 0)
    expect(eager == a1, "the styled graph PNG differs from the eager route's")
    merged = check_merged_leaves(worker, styles["A"], 3)
    prof = profile(lambda: png(spec("A", 3)))
    census_kernels = {"flash_mma_kernel": per_request["flash"],
                      "gn_cluster_kernel": per_request["gn"]}
    expect({k: prof["port_kernels"].get(k, 0) for k in census_kernels} == census_kernels,
           f"a styled replay ran {prof['port_kernels']}, expected {census_kernels}")
    registry = get_model_registry()
    entries = {m.name: m.hbm_bytes for m in registry.list_models()}
    touched = sum(t.numel() * t.element_size() for t in worker._base.values())
    unet = sum(t.numel() * t.element_size() for t in _flat(pipe.unet_params).values())
    expect(entries.get(next((n for n in entries if n.startswith("lora-base:")), ""))
           == touched, f"registry entries {entries} miss the base copies' {touched} bytes")
    return {"launches": launched, "first_merge_ms": first_ms, "lora_file_read_ms": read_ms,
            "first_restore_ms": first_restore_ms,
            "cache_hit_ms": statistics.median(hit_ms), "cache_hit_ms_all": hit_ms,
            "restore_ms": statistics.median(restore_ms), "restore_ms_all": restore_ms,
            "touched_leaves": len(worker._base), "touched_leaf_bytes": touched,
            "unet_bytes": unet, "registry_bytes": entries,
            "registry_lora_bytes": sum(v for n, v in entries.items() if n.startswith("lora")),
            "merged_vs_cpu_fp32": merged, "styled_equals_eager": eager == a1,
            "replay_port_kernels": prof["port_kernels"],
            "replay_kernel_ms": prof["device_busy_ms"], "path_s": time.perf_counter() - t0}


def encoder_gn_calls(cfg) -> int:
    """GroupNorm+SiLU calls of one VAE encode: two per resnet (layers_per_block
    per level, two in the mid block) and norm_out."""
    return 2 * (len(cfg.block_out_channels) * cfg.layers_per_block + 2) + 1


def img2img_path(worker, per_request, txt_seen, errs) -> tuple:
    """img2img at strength 0.5 and inpainting at 1.0 with a half-frame mask
    through ``run_img2img``, each bucket captured on its first request; the
    graph against the eager route, the same seed twice, the 0.5 graph
    replayed at 0.75 against eager at 0.75, the known latents outside the
    mask; p50 over IMG2IMG_SAMPLES requests of each task and a profiled
    img2img replay. Returns
    (the encoder's per-request kernel rows, launches, the line)."""
    pipe = worker.pipeline
    image, mask = test_image(SIZE, SIZE, 40), half_mask(SIZE, SIZE)
    spec = GenSpec("a lighthouse at dawn", size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                   seed=41)
    call = dict(num_inference_steps=STEPS, seed=41)
    seen = census(pipe, run=lambda: pipe._img2img_eager(spec.prompt, image, strength=0.5,
                                                        **call))
    encoder = seen - txt_seen  # the encoder's calls (the rest is txt2img's census)
    n_enc = encoder_gn_calls(pipe.bundle.vae_cfg)
    i2i_request = {"flash": per_request["flash"], "gn": per_request["gn"] + n_enc,
                   "gn_stats": per_request["gn"] + n_enc, "gn_apply": per_request["gn"] + n_enc}
    expect(sum(c for k, c in encoder.items() if k[0] == "gn") == n_enc
           and not any(k[0] == "flash" for k in encoder),
           f"img2img census adds {dict(encoder)}, expected {n_enc} GroupNorm calls")
    log({"img2img_census_encoder": [[list(k[1]), k[2], n] for k, n in sorted(encoder.items())]})
    t0 = time.perf_counter()
    rows = time_kernels(encoder, torch.bfloat16, errs)
    timing_s = time.perf_counter() - t0
    end_phase("img2img census")

    t0 = time.perf_counter()
    reset_counts()
    i2i = worker.run_img2img(spec, image, strength=0.5)[0]
    inp = worker.run_img2img(spec, image, strength=1.0, mask=mask)[0]
    launched = counts()
    expect(launched == {k: 2 * CAPTURE_RUNS * v for k, v in i2i_request.items()},
           f"the img2img path launched {launched}, expected two buckets' captures "
           f"{2 * CAPTURE_RUNS} x {i2i_request}")
    check_png(i2i)
    check_png(inp)
    expect(worker.run_img2img(spec, image, strength=0.5)[0] == i2i,
           "img2img: the same seed gave other bytes")
    buckets = len(pipe._compiled)
    at75 = worker.run_img2img(spec, image, strength=0.75)[0]
    expect(len(pipe._compiled) == buckets and at75 != i2i,
           "strength 0.75 made a bucket of its own or changed nothing")
    res = pipe.inpaint(spec.prompt, image, mask, **call)
    def latencies(**kw) -> list:
        out = []
        for i in range(IMG2IMG_SAMPLES):
            t1 = time.perf_counter()
            worker.run_img2img(dataclasses.replace(spec, seed=500 + i), image, **kw)
            out.append(1e3 * (time.perf_counter() - t1))
        return out

    latency = latencies(strength=0.5)
    inpaint_latency = latencies(strength=1.0, mask=mask)
    prof = profile(lambda: worker.run_img2img(spec, image, strength=0.5))
    want_kernels = {"flash_mma_kernel": i2i_request["flash"],
                    "gn_cluster_kernel": i2i_request["gn"]}
    expect({k: prof["port_kernels"].get(k, 0) for k in want_kernels} == want_kernels,
           f"a profiled img2img replay ran {prof['port_kernels']}, expected {want_kernels}")
    expect(counts() == launched, f"img2img replays went through the wrappers: {counts()}")
    # the eager route (the before), which goes through the wrappers
    eager = pipe._img2img_eager(spec.prompt, image, strength=0.5, **call)
    expect(np.array_equal(png_pixels(i2i), eager.images[0]), "img2img graph != eager")
    eager_inp = pipe._img2img_eager(spec.prompt, image, mask=mask, strength=1.0, **call)
    expect(np.array_equal(png_pixels(inp), eager_inp.images[0]), "inpaint graph != eager")
    eager75 = pipe._img2img_eager(spec.prompt, image, strength=0.75, **call)
    expect(np.array_equal(png_pixels(at75), eager75.images[0]),
           "img2img: the 0.5 bucket replayed at 0.75 differs from eager at 0.75")
    # inpainting keeps the encoded image outside the mask
    staged = pipe._stage_img2img(spec.prompt, image, mask=mask, strength=1.0, **call)
    with torch.inference_mode():
        x0 = pipe._encode_x0(torch.from_numpy(staged.inputs["image"]).cuda(),
                             torch.from_numpy(staged.inputs["eps_post"]).cuda()).cpu().numpy()
    keep = staged.inputs["mask_lat"][0, :, :, 0] == 0
    known_err = float(np.abs(res.latents[0][keep] - x0[0][keep]).max())
    expect(known_err == 0.0, f"inpaint moved the known latents by {known_err}")
    expect(float(np.abs(res.latents[0][~keep] - x0[0][~keep]).max()) > 0,
           "inpaint left the masked latents as encoded")
    line = {"launches": launched, "per_request": i2i_request, "encoder_gn_calls": n_enc,
            "p50_ms": statistics.median(latency), "min_ms": min(latency),
            "max_ms": max(latency), "latency_ms": latency,
            "inpaint_p50_ms": statistics.median(inpaint_latency),
            "inpaint_latency_ms": inpaint_latency,
            "buckets": [b for b in bucket_stats(pipe) if b["key"][-1] != "txt2img"],
            "profile_replay": prof, "known_latents_max_err": known_err,
            "encoder_per_request_ms": rows["gn"], "timing_s": timing_s,
            "path_s": time.perf_counter() - t0}
    return rows, launched, line


def sd15_extras_phase(per_request, txt_seen) -> tuple:
    """Phase 7. A new SD1.5 worker (full width, seeded random bf16 weights,
    its VAE encoder included) with two styles (rank-8 LoRAs over every
    projection the key map reaches, kohya and diffusers dialect, fp16
    files), then the styles path and the img2img path, each with its counts
    reset before it. Returns (encoder rows, img2img launches, errs, line)."""
    t0 = time.perf_counter()
    reset_model_registry()
    pipe = LCMPipeline(random_bundle(seed=0, device="cuda"), dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    errs = collections.defaultdict(float)
    with tempfile.TemporaryDirectory(prefix="dreamlab_styles_") as root:
        styles = {}
        for name, dialect, seed in (("A", "kohya", 100), ("B", "diffusers", 200)):
            path = os.path.join(root, f"style_{name}.safetensors")
            save_file(random_lora(pipe.unet_params, rank=STYLE_RANK, dialect=dialect, seed=seed,
                                  dtype=torch.float16), path)
            styles[name] = lora.StyleDef(name=name, path=path)
        worker = CudaPipelineWorker(pipe, styles=styles)
        setup_s = time.perf_counter() - t0
        styled = styles_path(worker, styles, per_request)
        log({"styles": styled})
        end_phase("styles")
        rows, launched, i2i = img2img_path(worker, per_request, txt_seen, errs)
        log({"img2img": i2i})
        end_phase("img2img")
    worker.close()
    del pipe
    freed = delete_pipeline(worker)
    reset_model_registry()
    line = {"sd15_extras": {"card": smi_line(), "setup_s": setup_s, "freed_bytes": freed,
                            "phase_s": time.perf_counter() - t0}}
    return rows, launched, errs, line


# ---------------------------------------------------------------------------
# phase 7b: ControlNet and progress callbacks at SD1.5's 512x512
# ---------------------------------------------------------------------------


def times_of(fns: dict, samples: int) -> dict:
    """{name: [ms, ...]} over ``samples`` rounds, the functions taking turns."""
    out = {name: [] for name in fns}
    for _ in range(samples):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            out[name].append(1e3 * (time.perf_counter() - t0))
    return out


def ctrl_keys(pipe) -> list:
    return [k for k in pipe._compiled if "ctrl" in dict(k[8:])]


def controlnet_path(worker, bundle, net_b, hint, per_request) -> tuple:
    """The ControlNet path on the worker ``create_cuda_worker`` built with
    the mode's net: a census on the eager route (56 flash, 289 GroupNorm),
    each kernel checked and timed at its shapes; then, counts reset, the
    ctrl bucket and the plain bucket captured on their first requests, the
    same seed twice, scale 0 against the plain request, graph against
    eager, p50 over CN_SAMPLES requests beside as many plain ones, a
    profiled replay, and a net of the same config written into the live
    leaves (the same graph) against a fresh pipeline with that net.
    Returns (rows, launches, errs, the line)."""
    pipe = worker.pipeline
    errs = collections.defaultdict(float)
    prompt, seed = "a lighthouse on a cliff", 81
    call = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS)
    spec = lambda **kw: GenSpec(prompt, size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                                seed=kw.pop("seed", seed), **{"control_image": hint, **kw})
    seen = census(pipe, run=lambda: pipe._generate_eager(prompt, control_image=hint, seed=seed,
                                                         **call))
    cn_request = per_request_of(seen)
    log({"controlnet_census": [[list(k[1]), k[2], n] for k, n in sorted(seen.items())],
         "launches_per_request": cn_request})
    expect(cn_request["flash"] == CN_PER_REQUEST["flash"]
           and cn_request["gn"] == CN_PER_REQUEST["gn"],
           f"ControlNet census {cn_request}, expected {CN_PER_REQUEST}")
    t0 = time.perf_counter()
    rows = time_kernels(seen, torch.bfloat16, errs)
    timing_s = time.perf_counter() - t0
    end_phase("controlnet census")

    png = lambda sp: worker.run_job_with_latents(sp)[0]  # no metadata: comparable bytes
    t0 = time.perf_counter()
    reset_counts()
    first = png(spec())  # captures the ctrl bucket
    first_s = time.perf_counter() - t0
    again = png(spec())
    plain = png(spec(control_image=None))  # captures the plain bucket
    zero = png(spec(controlnet_scale=0.0))
    launched = counts()
    want = {k: CAPTURE_RUNS * (cn_request[k] + per_request[k]) for k in cn_request}
    expect(launched == want, f"the ControlNet path launched {launched}, expected the ctrl and "
                             f"plain buckets' captures {want}")
    check_png(first)
    expect(again == first, "ControlNet: the same seed gave other bytes")
    expect(first != plain, "ControlNet: the hint changed nothing")
    expect(zero == plain, "ControlNet: scale 0 differs from the plain request")
    eager = encode_png(pipe._generate_eager(prompt, control_image=hint, seed=seed,
                                            **call).images[0])
    expect(eager == first, "ControlNet: the graph's PNG differs from the eager route's")
    lat = times_of({"controlnet": lambda: png(spec(seed=seed + 1)),
                    "plain": lambda: png(spec(seed=seed + 1, control_image=None))}, CN_SAMPLES)
    prof = profile(lambda: png(spec()))
    want_kernels = {"flash_mma_kernel": cn_request["flash"],
                    "gn_cluster_kernel": cn_request["gn"]}
    expect({k: prof["port_kernels"].get(k, 0) for k in want_kernels} == want_kernels,
           f"a profiled ControlNet replay ran {prof['port_kernels']}, expected {want_kernels}")
    # replays go through no wrapper; the eager route above did, once
    expect(counts() == {k: launched[k] + cn_request[k] for k in launched},
           f"ControlNet replays went through the wrappers: {counts()} after {launched}")

    # another net of the same config: written into the leaves the graph reads
    keys, programs = ctrl_keys(pipe), dict(pipe._compiled)
    pipe.set_controlnet(net_b, SD15_CONTROLNET)
    same_graph = ctrl_keys(pipe) == keys and all(pipe._compiled[k] is programs[k] for k in keys)
    expect(same_graph, "re-attaching a net of the same config replaced the ctrl bucket")
    second = png(spec())
    fresh = LCMPipeline(bundle)
    fresh.set_controlnet(net_b, SD15_CONTROLNET)
    fresh_png = encode_png(fresh.generate(prompt, control_image=hint, seed=seed,
                                          **call).images[0])
    del fresh
    torch.cuda.empty_cache()
    expect(second != first, "the second net changed nothing")
    expect(second == fresh_png, "the re-attached net's PNG differs from a fresh pipeline's")
    line = {"card": smi_line(), "launches": launched, "per_request": cn_request,
            "first_request_s": first_s, "p50_ms": statistics.median(lat["controlnet"]),
            "min_ms": min(lat["controlnet"]), "max_ms": max(lat["controlnet"]),
            "latency_ms": lat["controlnet"], "plain_p50_ms": statistics.median(lat["plain"]),
            "plain_latency_ms": lat["plain"], "profile_replay": prof,
            "kernel_ms_per_request": prof["device_busy_ms"],
            "scale0_equals_plain": zero == plain, "graph_equals_eager": eager == first,
            "reattach_same_graph": same_graph, "reattach_equals_fresh": second == fresh_png,
            "buckets": [b for b in bucket_stats(pipe) if "ctrl" in str(b["key"])],
            "flash_per_request_ms": rows["flash"], "gn_per_request_ms": rows["gn"],
            "timing_s": timing_s}
    return rows, launched, errs, line


def progress_path(worker, per_request) -> dict:
    """Progress on the ControlNet phase's worker (counts reset): a request
    with ``progress_cb`` (steps 0-3 in order with the schedule's timesteps,
    the PNG equal to the callback-free request's), ``generate`` with
    ``callback_latents=True`` (each step's latents equal the eager route's,
    the image the plain one's), the host ms at which each step arrived, and
    p50 over PROGRESS_SAMPLES requests beside as many callback-free ones."""
    pipe = worker.pipeline
    prompt, seed = "a harbour at night", 91
    call = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS, seed=seed)
    spec = GenSpec(prompt, size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS, seed=seed)
    timesteps = [int(t) for t in pipe._schedule(STEPS, None).timesteps]
    reset_counts()
    steps = []
    t0 = time.perf_counter()
    png_cb = worker.run_job_with_latents(dataclasses.replace(
        spec, progress_cb=lambda i, t: steps.append((i, t))))[0]  # captures the steps bucket
    first_s = time.perf_counter() - t0
    png_plain = worker.run_job_with_latents(spec)[0]  # the plain bucket: a replay
    expect(steps == list(enumerate(timesteps)), f"progress steps {steps}, expected "
                                                f"{list(enumerate(timesteps))}")
    expect(png_cb == png_plain, "a progress request's PNG differs from the callback-free one's")
    lat_steps, arrival = [], []
    t0 = time.perf_counter()

    def on_step(i, t, lat):
        arrival.append(1e3 * (time.perf_counter() - t0))
        lat_steps.append((i, t, lat))

    res = pipe.generate(prompt, callback=on_step, **call)  # captures the latents bucket
    replay_steps, replay_arrival = [], []
    t0 = time.perf_counter()
    res2 = pipe.generate(prompt, callback=lambda i, t, lat: (
        replay_arrival.append(1e3 * (time.perf_counter() - t0)), replay_steps.append(lat)),
        **call)
    replay_ms = 1e3 * (time.perf_counter() - t0)
    launched = counts()
    want = {k: 2 * CAPTURE_RUNS * v for k, v in per_request.items()}
    expect(launched == want, f"the progress path launched {launched}, expected two buckets' "
                             f"captures {want}")
    eager_steps = []
    pipe._generate_eager(prompt, callback=lambda i, t, lat: eager_steps.append((i, t, lat)),
                         **call)
    lat_delta = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(lat_steps, eager_steps))
    expect([s[:2] for s in lat_steps] == [s[:2] for s in eager_steps] == list(enumerate(
        timesteps)), "per-step latents: steps or timesteps differ from the eager route's")
    expect(lat_delta == 0.0, f"per-step latents differ from the eager route's by {lat_delta}")
    expect(all(np.array_equal(a, b[2]) for a, b in zip(replay_steps, lat_steps)),
           "a replay's per-step latents differ from the capture's request")
    expect(encode_png(res.images[0]) == png_plain and np.array_equal(res2.images, res.images),
           "the latents bucket's image differs from the plain one")
    cb_spec = dataclasses.replace(spec, progress_cb=lambda i, t: None)
    lat = times_of({"progress": lambda: worker.run_job_with_latents(cb_spec),
                    "plain": lambda: worker.run_job_with_latents(spec)}, PROGRESS_SAMPLES)
    return {"launches": launched, "steps": steps, "first_request_s": first_s,
            "latents_vs_eager_max_abs": lat_delta,
            "step_arrival_ms_first_request": arrival, "step_arrival_ms_replay": replay_arrival,
            "latents_replay_ms": replay_ms,
            "p50_ms": statistics.median(lat["progress"]), "latency_ms": lat["progress"],
            "plain_p50_ms": statistics.median(lat["plain"]), "plain_latency_ms": lat["plain"],
            "buckets": [b for b in bucket_stats(pipe) if "progress" in str(b["key"])]}


def controlnet_phase(per_request) -> tuple:
    """Phase 7b. SD1.5 at full width in fp16 as a diffusers directory and a
    full-width ControlNet (``SD15_CONTROLNET``: the SD1.5 trunk without
    cond_proj, hint ladder 16/32/96/256, non-zero taps, seeded random
    weights drawn on the card, fp16) as a ControlNet directory, served by
    ``create_cuda_worker(controlnet=)``; the ControlNet path, then the
    progress path on the same worker, each with its counts reset. Returns
    (rows, launches, errs, the line)."""
    t0 = time.perf_counter()
    bundle = cast_params(random_bundle(seed=0, device="cuda"), torch.float16)
    nets = [cast_tree(random_controlnet(SD15_CONTROLNET, seed=s,
                                               cond_channels=CONTROLNET_COND_CHANNELS,
                                               device="cuda"), torch.float16)
            for s in (11, 12)]
    hint = test_image(SIZE, SIZE, 80)
    with tempfile.TemporaryDirectory(prefix="dreamlab_cn_") as root:
        ckpt = write_diffusers_dir(bundle, os.path.join(root, "sd15"))
        cn_dir = write_controlnet_dir(nets[0], SD15_CONTROLNET, os.path.join(root, "cn"))
        t1 = time.perf_counter()
        worker = create_cuda_worker(0, ckpt, controlnet=types.SimpleNamespace(file=cn_dir,
                                                                               scale=1.0))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
    expect(worker.pipeline.controlnet_cfg == SD15_CONTROLNET and worker.controlnet_scale == 1.0,
           "create_cuda_worker(controlnet=) did not attach the mode's ControlNet")
    end_phase("controlnet load")
    setup_s = time.perf_counter() - t0
    rows, launched, errs, line = controlnet_path(worker, bundle, nets[1], hint, per_request)
    log({"controlnet": line})
    end_phase("controlnet")
    progress = progress_path(worker, per_request)
    log({"progress": progress})
    end_phase("progress")
    del bundle, nets
    freed = delete_pipeline(worker)
    return rows, launched, errs, {"controlnet_phase": {
        "card": smi_line(), "setup_s": setup_s, "load_s": load_s, "freed_bytes": freed,
        "phase_s": time.perf_counter() - t0}}


# ---------------------------------------------------------------------------
# phase 8: SDXL at 1024x1024, img2img there, and 1344x768 (tiled decode)
# ---------------------------------------------------------------------------


def check_gn_2e31(gamma, beta, errs) -> dict:
    """fused_group_norm_silu on bf16 [8, 1024, 1024, 256] (2^31 values, the
    VAE decode of a run_jobs of 8 SDXL requests): each batch row against the
    plain version of that row alone (beyond one bf16 rounding, TOL_BF16) and
    byte-equal to the kernel's batch-1 output of that row."""
    shape = (8, XL_SIZE, XL_SIZE, 256)
    x = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
    for i in range(shape[0]):
        x[i] = randn(shape[1:], torch.bfloat16, 50 + i)
    y = gn.fused_group_norm_silu(x, gamma, beta, groups=32)
    rows = []
    for i in range(shape[0]):
        xi = x[i:i + 1]
        want = gn.group_norm_plain(xi.float(), gamma.float(), beta.float(), groups=32, silu=True)
        c = bf16_check(y[i:i + 1], want, TOL_BF16)
        del want
        solo = torch.equal(y[i:i + 1], gn.fused_group_norm_silu(xi, gamma, beta, groups=32))
        expect(c["beyond_rounding"] <= c["limit"], f"gn [8,1024,1024,256] row {i}: {c}")
        expect(solo, f"gn [8,1024,1024,256] row {i} differs from its batch-1 output")
        errs["gn"] = max(errs["gn"], c["max_abs_err"])
        errs["gn_beyond"] = max(errs["gn_beyond"], c["beyond_rounding"])
        rows.append({"max_abs_err": c["max_abs_err"], "beyond_rounding": c["beyond_rounding"],
                     "equals_batch1": solo})
        torch.cuda.empty_cache()
    del x, y
    torch.cuda.empty_cache()
    return {"shape": list(shape), "values": math.prod(shape), "limit": TOL_BF16, "rows": rows}


def check_sdxl_extremes(errs) -> dict:
    """The largest VAE GroupNorm at batch 2 and at batch 8 (the census has
    batch 1), and the VAE's plain mid-block attention (one 512-wide head over 16384 tokens):
    its device time and the memory it adds at its peak."""
    x = randn((2, XL_SIZE, XL_SIZE, 256), torch.bfloat16, 40)
    gamma = (1 + 0.1 * randn((256,), torch.float32, 41)).to(torch.bfloat16)
    beta = (0.1 * randn((256,), torch.float32, 42)).to(torch.bfloat16)
    gn_b2 = check_gn(x, gamma, beta, 32, True, errs, "sdxl vae [2,1024,1024,256]")
    row = gn.fused_group_norm_silu(x[1:].contiguous(), gamma, beta, groups=32)
    expect(torch.equal(gn.fused_group_norm_silu(x, gamma, beta, groups=32)[1:], row),
           "GroupNorm batch-2 row differs from its solo run")
    del x, row
    torch.cuda.empty_cache()
    gn_b8 = check_gn_2e31(gamma, beta, errs)
    n = (XL_SIZE // 8) ** 2
    q, k, v = (randn((1, n, 1, 512), torch.bfloat16, 43 + i) for i in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    attention.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    ms = device_ms(lambda: attention.dot_product_attention(q, k, v), 3)
    return {"gn_batch2_check": gn_b2, "gn_batch8_check": gn_b8,
            "vae_mid_attention": {"shape": [1, n, 1, 512], "plain_ms": ms,
                                  "peak_extra_bytes": extra}}


def sdxl_style(worker, spec) -> dict:
    """One styled SDXL request at 1024² (a rank-8 LoRA over every projection
    the key map reaches, kohya dialect) replaying the ``none`` bucket: other
    bytes than unstyled, and the unstyled bytes unchanged after it."""
    pipe = worker.pipeline
    with tempfile.TemporaryDirectory(prefix="dreamlab_xl_style_") as root:
        path = os.path.join(root, "xl_style.safetensors")
        save_file(random_lora(pipe.unet_params, rank=STYLE_RANK, seed=400,
                              dtype=torch.float16), path)
        worker.styles["xl"] = lora.StyleDef(name="xl", path=path)
        png = lambda sp: worker.run_job_with_latents(sp)[0]
        plain = png(spec)
        reset_counts()
        with worker._lock:
            first_ms = timed_ms(lambda: worker._apply_style("xl", 3))
            restore_ms = timed_ms(lambda: worker._apply_style(None, 0))
        styled = png(dataclasses.replace(spec, style="xl", style_level=3))
        launched = counts()
        after = png(spec)
    expect(styled != plain and after == plain,
           "SDXL style: changed nothing, or the unstyled bytes moved after it")
    expect(not any(launched.values()), f"a styled SDXL replay went through the wrappers: "
                                        f"{launched}")
    out = {"first_merge_ms": first_ms, "restore_ms": restore_ms,
           "touched_leaves": len(worker._base),
           "touched_leaf_bytes": sum(t.numel() * t.element_size()
                                     for t in worker._base.values()),
           "styled_differs": styled != plain, "unstyled_unchanged": after == plain}
    worker._merged_clear()  # free the base copies and the cache before the next paths
    worker._base.clear()
    return out


def sdxl_img2img(worker, txt_seen) -> tuple:
    """One SDXL img2img request at 1024², ``none`` mode, strength 0.5: the
    encoder's GroupNorm calls checked and timed at their shapes, the bucket
    captured on the first request, a replay of the same seed (identical
    bytes), and the peak memory. Returns (the encoder's rows, launches, errs,
    the line)."""
    pipe = worker.pipeline
    errs = collections.defaultdict(float)
    image = test_image(XL_SIZE, XL_SIZE, 60)
    spec = GenSpec("a castle on a hill at dawn", size=f"{XL_SIZE}x{XL_SIZE}",
                   num_inference_steps=STEPS, seed=61)
    seen = census(pipe, run=lambda: pipe._img2img_eager(spec.prompt, image, strength=0.5,
                                                        num_inference_steps=STEPS, seed=61))
    encoder = seen - txt_seen
    n_enc = encoder_gn_calls(pipe.bundle.vae_cfg)
    expect(sum(c for k, c in encoder.items() if k[0] == "gn") == n_enc
           and not any(k[0] == "flash" for k in encoder),
           f"SDXL img2img census adds {dict(encoder)}, expected {n_enc} GroupNorm calls")
    rows = time_kernels(encoder, torch.bfloat16, errs)
    end_phase("sdxl img2img census")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first = worker.run_img2img(spec, image, strength=0.5)[0]
    first_s = time.perf_counter() - t0
    launched = counts()
    per_request = {"flash": XL_PER_REQUEST["flash"], "gn": XL_PER_REQUEST["gn"] + n_enc}
    want = {"flash": CAPTURE_RUNS * per_request["flash"],
            "gn": CAPTURE_RUNS * per_request["gn"],
            "gn_stats": CAPTURE_RUNS * per_request["gn"],
            "gn_apply": CAPTURE_RUNS * per_request["gn"]}
    expect(launched == want, f"the SDXL img2img path launched {launched}, expected {want}")
    t0 = time.perf_counter()
    again = worker.run_img2img(spec, image, strength=0.5)[0]
    replay_ms = 1e3 * (time.perf_counter() - t0)
    check_png(first, XL_SIZE)
    expect(again == first, "SDXL img2img: the same seed gave other bytes")
    line = {"launches": launched, "per_request": per_request, "first_request_s": first_s,
            "replay_ms": replay_ms, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "encoder_per_request_ms": rows["gn"],
            "bucket": [b for b in bucket_stats(pipe) if b["key"][-1] == "img2img"]}
    return rows, launched, errs, line


def sdxl_tiles(worker, txt_seen) -> tuple:
    """SDXL at 1344x768 (latents 96 x 168, above the 160 chunk): a census (K1
    at N = 4032 and 1008; 8 decoder tiles of 29 GroupNorm calls), every
    shape new to the card checked against its plain version and K1's timed,
    three requests after the capture (graph = eager, byte for byte), and the
    tiled decode's time and peak memory beside the full-frame decode of the
    same latents. Returns (K1's rows, launches, errs, the line)."""
    pipe = worker.pipeline
    errs = collections.defaultdict(float)
    width, height = 1344, 768
    h_lat, w_lat = height // pipe.vae_scale, width // pipe.vae_scale
    tile = pipe._vae_tile
    n_tiles = (len(vae._tile_starts(h_lat, tile, tile - tile // 4))
               * len(vae._tile_starts(w_lat, tile, tile - tile // 4)))
    spec = GenSpec("a harbour at dusk", size=f"{width}x{height}", num_inference_steps=STEPS,
                   seed=71)
    seen = census(pipe, run=lambda: pipe._generate_eager(
        spec.prompt, height=height, width=width, num_inference_steps=STEPS, seed=71))
    per_request = {"flash": sum(c for k, c in seen.items() if k[0] == "flash"),
                   "gn": sum(c for k, c in seen.items() if k[0] == "gn")}
    want = {"flash": XL_PER_REQUEST["flash"], "gn": 4 * 35 + n_tiles * 29}
    expect(max(h_lat, w_lat) > pipe._vae_chunk and n_tiles == 8 and per_request == want,
           f"1344x768 census {per_request} over {n_tiles} tiles, expected {want} over 8")
    new = collections.Counter({k: c for k, c in seen.items() if k not in txt_seen})
    log({"tiles_census": [[list(k[1]), k[2], n] for k, n in sorted(seen.items())],
         "new_shapes": len(new)})
    flash_new = collections.Counter({k: c for k, c in new.items() if k[0] == "flash"})
    rows = time_kernels(flash_new, torch.bfloat16, errs)
    for (kind, shape, groups), _ in sorted(new.items()):
        if kind == "gn":
            x = randn(shape, torch.bfloat16, 72)
            gamma = (1 + 0.1 * randn((shape[-1],), torch.float32, 73)).to(torch.bfloat16)
            beta = (0.1 * randn((shape[-1],), torch.float32, 74)).to(torch.bfloat16)
            check_gn(x, gamma, beta, groups, True, errs, f"1344x768 {list(shape)}")
    end_phase("1344x768 census")

    reset_counts()
    t0 = time.perf_counter()
    res = pipe.generate(spec.prompt, height=height, width=width, num_inference_steps=STEPS,
                        seed=71)
    first_s = time.perf_counter() - t0
    launched = counts()
    expect(launched["flash"] == CAPTURE_RUNS * want["flash"]
           and launched["gn"] == CAPTURE_RUNS * want["gn"],
           f"the 1344x768 path launched {launched}, expected {CAPTURE_RUNS} x {want}")
    pngs, latency = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        pngs.append(worker.run_job_with_latents(spec)[0])
        latency.append(1e3 * (time.perf_counter() - t1))
    eager = eager_png(pipe, spec)
    expect(all(p == pngs[0] for p in pngs) and eager == pngs[0],
           "1344x768: the replays or the eager route gave other bytes")
    expect(png_pixels(pngs[0]).shape == (height, width, 3), "1344x768 PNG shape")
    prof = profile(lambda: worker.run_job_with_latents(spec))
    want_kernels = {"flash_mma_kernel": want["flash"], "gn_cluster_kernel": want["gn"]}
    expect({k: prof["port_kernels"].get(k, 0) for k in want_kernels} == want_kernels,
           f"a profiled 1344x768 replay ran {prof['port_kernels']}, expected {want_kernels}")
    z = torch.from_numpy(res.latents).cuda() / pipe.bundle.vae_cfg.scaling_factor
    decodes = {}
    for name, fn in (("tiled", lambda: pipe._decode(z)),
                     ("full_frame", lambda: vae.decode(pipe.vae_params, pipe.bundle.vae_cfg, z))):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = timed_ms(fn)
            decodes[name] = {"ms": ms, "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
            img = torch.round(torch.clamp(fn() * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
            decodes[name]["image"] = img.cpu().numpy()
    delta = np.abs(decodes["tiled"].pop("image").astype(np.int16)
                   - decodes["full_frame"].pop("image").astype(np.int16))
    expect(np.array_equal(png_pixels(pngs[0]), res.images[0]), "1344x768 generate != run_job")
    line = {"launches": launched, "per_request": want, "tiles": n_tiles,
            "first_request_s": first_s, "p50_ms": statistics.median(latency),
            "latency_ms": latency, "profile_replay": prof, "decode": decodes,
            "tiled_vs_full_frame": {"max_pixel_delta": int(delta.max()),
                                    "pixels_moved": float((delta > 0).mean())},
            "bucket": [b for b in bucket_stats(pipe) if b["key"][1:3] == [h_lat, w_lat]],
            "flash_per_request_ms": rows["flash"]}
    return rows, launched, errs, line


def sdxl_phase(errs) -> tuple:
    """Phase 8. Returns (per-request kernel rows, launches, the sdxl line,
    and the img2img and 1344x768 paths' (rows, launches, errs))."""
    t0 = time.perf_counter()
    pipe = LCMPipeline(random_bundle("sdxl", seed=0, device="cuda"), dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    worker = CudaPipelineWorker(pipe)
    setup_s = time.perf_counter() - t0
    seen = census(pipe, XL_SIZE)
    per_request = per_request_of(seen)
    log({"sdxl_setup_s": setup_s, "launches_per_request": per_request,
         "census": [[list(k[1]), k[2], n] for k, n in sorted(seen.items())]})
    want = {"flash": XL_PER_REQUEST["flash"], "gn": XL_PER_REQUEST["gn"],
            "gn_stats": XL_PER_REQUEST["gn"], "gn_apply": XL_PER_REQUEST["gn"]}
    expect(per_request == want, f"SDXL census {per_request}, expected {want}")
    end_phase("sdxl census")

    t0 = time.perf_counter()
    rows = time_kernels(seen, torch.bfloat16, errs)
    extremes = check_sdxl_extremes(errs)
    log({"sdxl_timing_s": time.perf_counter() - t0, "per_request_ms": rows, **extremes})
    end_phase("sdxl kernel checks")

    spec = lambda seed, **kw: GenSpec(f"a castle on a hill, seed {seed}",
                                      size=f"{XL_SIZE}x{XL_SIZE}", num_inference_steps=STEPS,
                                      seed=seed, **kw)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured = {k: CAPTURE_RUNS * v for k, v in per_request.items()}
    reset_counts()
    warm = pipe.warmup(XL_SIZE, XL_SIZE, steps=STEPS)  # the none bucket
    latency, pngs = [], {}
    for seed in range(1, XL_LATENCY_SAMPLES):
        t1 = time.perf_counter()
        pngs[seed] = worker.run_job(spec(seed))[0]
        latency.append(time.perf_counter() - t1)
        check_png(pngs[seed], XL_SIZE)
    t1 = time.perf_counter()
    expect(worker.run_job(spec(1))[0] == pngs[1], "SDXL: same seed gives identical PNG bytes")
    latency.append(time.perf_counter() - t1)
    launches = counts()  # the kernels line's SDXL launches: the bucket's capture
    expect(launches == captured, f"SDXL requests launched {launches}, expected the "
                                 f"capture's {captured} (replays go through no wrapper)")

    # each new bucket is captured on its first request, then replayed
    cfg_spec = spec(7, guidance_scale=2.0, negative_prompt="blurry, low quality")
    expect(pipe.cfg_mode(cfg_spec.guidance_scale) == "cfg", "guidance 2.0 is not the cfg mode")
    reset_counts()
    cfg_png = worker.run_job(cfg_spec)[0]
    expect(counts() == captured, f"SDXL cfg bucket's capture launched {counts()}, "
                                 f"expected {captured}")
    t1 = time.perf_counter()
    expect(worker.run_job(cfg_spec)[0] == cfg_png, "SDXL cfg: same seed gives identical bytes")
    cfg_s = time.perf_counter() - t1
    check_png(cfg_png, XL_SIZE)
    expect(cfg_png != worker.run_job(spec(7, guidance_scale=2.0))[0],
           "SDXL cfg: the negative prompt changed nothing")

    batches = {}
    for mode, (g, negs) in {"none": ((1.0, 0.5), (None, None)),
                            "cfg": ((2.0, 5.0), ("blurry", None))}.items():
        specs = [spec(30 + i, guidance_scale=gi, negative_prompt=ni)
                 for i, (gi, ni) in enumerate(zip(g, negs))]
        expect(worker.batchable(*specs), f"SDXL {mode} specs not batchable")
        reset_counts()
        out = worker.run_jobs(specs)
        expect(counts() == captured, f"SDXL run_jobs {mode} bucket's capture launched "
                                     f"{counts()}, expected {captured}")
        t1 = time.perf_counter()
        again = worker.run_jobs(specs)
        batch_s = time.perf_counter() - t1
        expect(again == out, f"SDXL run_jobs {mode}: a replay gave other bytes")
        same = [png == worker.run_job(s)[0] for (png, _), s in zip(out, specs)]
        expect(all(same), f"SDXL {mode}: batch rows vs solo runs identical: {same}")
        batches[mode] = {"batch2_s": batch_s, "rows_identical_to_solo": same}
    peak = torch.cuda.max_memory_allocated()
    requests_s = time.perf_counter() - t0
    end_phase("sdxl requests")

    before = graph_vs_eager(worker, {"none": spec(1), "cfg": cfg_spec}, XL_EAGER_SAMPLES,
                            {"flash_mma_kernel": XL_PER_REQUEST["flash"],
                             "gn_cluster_kernel": XL_PER_REQUEST["gn"]})
    prof, prof_eager = before["profile_graph"], before["profile_eager"]
    log({"profile_sdxl_batch1": prof, "profile_sdxl_eager": prof_eager})
    buckets = bucket_stats(pipe)
    lat_ms = [1e3 * t for t in latency]
    line = {"sdxl": {
        "card": smi_line(), "host_cpu": host_cpu(), "size": XL_SIZE, "steps": STEPS,
        "p50_ms_batch1": statistics.median(lat_ms), "min_ms_batch1": min(lat_ms),
        "max_ms_batch1": max(lat_ms), "latency_ms_batch1": lat_ms,
        "cfg_request_ms": 1e3 * cfg_s, "run_jobs_2": batches,
        "kernel_ms_per_request": prof["device_busy_ms"],
        "kernel_launches_per_request": prof["kernel_launches"],
        "busy_share": prof["busy_share"], "port_kernels": prof["port_kernels"],
        "port_launches_per_request": per_request,
        "eager": {"p50_ms_batch1": before["eager_p50_ms"], "min_ms_batch1": before["eager_min_ms"],
                  "max_ms_batch1": before["eager_max_ms"], "latency_ms_batch1": before["eager_ms"],
                  "kernel_ms_per_request": prof_eager["device_busy_ms"],
                  "kernel_launches_per_request": prof_eager["kernel_launches"],
                  "busy_share": prof_eager["busy_share"]},
        "graph_vs_eager": before["graph_vs_eager"], "host_ms": before["host_ms"],
        "warmup_none_batch1": {"seconds": warm["seconds"], "capture_s": warm["capture_s"],
                               "reserved_bytes": warm["reserved_bytes"]},
        "buckets": buckets, "graph_pool_bytes": sum(b["reserved_bytes"] for b in buckets),
        "flash_ms_per_request": rows["flash"]["ms"], "gn_ms_per_request": rows["gn"]["ms"],
        "peak_memory_bytes": peak, "requests_s": requests_s,
        "vae_mid_attention": extremes["vae_mid_attention"]}}
    line["sdxl"]["style"] = sdxl_style(worker, spec(1))
    end_phase("sdxl style")
    t0 = time.perf_counter()
    i2i_rows, i2i_launches, i2i_errs, i2i_line = sdxl_img2img(worker, seen)
    line["sdxl"]["img2img"] = {**i2i_line, "path_s": time.perf_counter() - t0}
    end_phase("sdxl img2img")
    t0 = time.perf_counter()
    t_rows, t_launches, t_errs, t_line = sdxl_tiles(worker, seen)
    line["sdxl"]["tiles_1344x768"] = {**t_line, "path_s": time.perf_counter() - t0}
    end_phase("sdxl 1344x768")
    del pipe
    line["sdxl"]["freed_bytes_on_delete"] = delete_pipeline(worker)
    return (rows, launches, line, (i2i_rows, i2i_launches, i2i_errs),
            (t_rows, t_launches, t_errs))


# ---------------------------------------------------------------------------
# phase 8b: the SDXL base -> refiner ensemble at 1024x1024
# ---------------------------------------------------------------------------


def ensemble_phase() -> tuple:
    """Phase 8b. SDXL base and the SDXL refiner (``SDXL_REFINER_UNET``, one
    bigG tower, the SDXL VAE), both at full width with seeded random bf16
    weights drawn on the card, in a CudaPipelineWorker with the refiner at
    switch 0.8: 4 steps run as base [0, 3) and refiner [3, 4). A census of
    one request on the eager route (254 flash, 179 GroupNorm); each kernel
    checked and timed at the refiner segment's shapes; then, counts reset,
    the two segment buckets captured on the first request, ENSEMBLE_SAMPLES
    requests (one a repeat: the same bytes), the graph against the eager
    route, the carry a card tensor, a profiled replay, the peak memory with
    both pipelines resident; and on the base alone (0, 3) then (3, 4)
    against its 4-step run, byte for byte. Returns (rows, launches, errs,
    the line)."""
    t0 = time.perf_counter()
    errs = collections.defaultdict(float)
    base = LCMPipeline(random_bundle("sdxl", seed=0, device="cuda"))
    refiner = LCMPipeline(random_refiner_bundle(seed=1, device="cuda"))
    torch.cuda.empty_cache()
    worker = CudaPipelineWorker(base, refiner=refiner, refiner_switch_at=SWITCH_AT)
    setup_s = time.perf_counter() - t0
    k = min(max(int(round(STEPS * SWITCH_AT)), 1), STEPS - 1)
    prompt, seed = "a castle on a hill at dawn", 101
    call = dict(height=XL_SIZE, width=XL_SIZE, num_inference_steps=STEPS)
    spec = lambda s: GenSpec(prompt, size=f"{XL_SIZE}x{XL_SIZE}", num_inference_steps=STEPS,
                             seed=s)

    def eager(s=seed):
        carry = base._generate_eager(prompt, segment=(0, k), seed=s, **call).state_device
        return refiner._generate_eager(prompt, segment=(k, STEPS), latents_state=carry,
                                       seed=s, **call)

    seen = census(base, run=eager)
    ens_request = per_request_of(seen)
    carry = base._generate_eager(prompt, segment=(0, k), seed=seed, **call).state_device
    ref_seen = census(refiner, run=lambda: refiner._generate_eager(
        prompt, segment=(k, STEPS), latents_state=carry, seed=seed, **call))
    log({"ensemble_census": [[list(c[1]), c[2], n] for c, n in sorted(seen.items())],
         "refiner_census": [[list(c[1]), c[2], n] for c, n in sorted(ref_seen.items())],
         "launches_per_request": ens_request})
    expect(ens_request["flash"] == ENSEMBLE_PER_REQUEST["flash"]
           and ens_request["gn"] == ENSEMBLE_PER_REQUEST["gn"],
           f"ensemble census {ens_request}, expected {ENSEMBLE_PER_REQUEST}")
    t1 = time.perf_counter()
    rows = time_kernels(ref_seen, torch.bfloat16, errs)
    timing_s = time.perf_counter() - t1
    end_phase("ensemble census")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    first = worker.run_job_with_latents(spec(seed))[0]  # captures both segment buckets
    first_s = time.perf_counter() - t1
    launched = counts()
    want = {c: CAPTURE_RUNS * v for c, v in ens_request.items()}
    expect(launched == want, f"the ensemble path launched {launched}, expected the two "
                             f"segment buckets' captures {want}")
    check_png(first, XL_SIZE)
    latency = []
    for s in [seed] + [seed + 1 + i for i in range(ENSEMBLE_SAMPLES - 1)]:
        t1 = time.perf_counter()
        out = worker.run_job_with_latents(spec(s))[0]
        latency.append(1e3 * (time.perf_counter() - t1))
        if s == seed:
            expect(out == first, "ensemble: the same seed gave other bytes")
    peak = torch.cuda.max_memory_allocated()
    expect(counts() == launched, f"ensemble replays went through the wrappers: {counts()}")
    eager_png = encode_png(eager().images[0])
    expect(eager_png == first, "ensemble: the graph's PNG differs from the eager route's")
    handoff = base.generate(prompt, segment=(0, k), seed=seed, **call)
    on_card = (handoff.images is None and handoff.latents is None
               and isinstance(handoff.state_device, torch.Tensor)
               and handoff.state_device.is_cuda
               and handoff.state_device.dtype == torch.float32)
    expect(on_card, "the base segment's carry is not an fp32 card tensor")
    prof = profile(lambda: worker.run_job_with_latents(spec(seed)))
    want_kernels = {"flash_mma_kernel": ens_request["flash"],
                    "gn_cluster_kernel": ens_request["gn"]}
    expect({c: prof["port_kernels"].get(c, 0) for c in want_kernels} == want_kernels,
           f"a profiled ensemble replay ran {prof['port_kernels']}, expected {want_kernels}")
    buckets = {"base": bucket_stats(base), "refiner": bucket_stats(refiner)}

    # the base alone: its segments against its 4-step run
    full = base.generate(prompt, seed=seed, **call)
    head = base.generate(prompt, segment=(0, k), seed=seed, **call)
    tail = base.generate(prompt, segment=(k, STEPS), latents_state=head.state_device,
                         seed=seed, **call)
    bitmatch = (np.array_equal(tail.images, full.images)
                and np.array_equal(tail.latents, full.latents))
    expect(bitmatch, "the base's (0, 3) then (3, 4) differ from its 4-step run")
    line = {"ensemble": {
        "card": smi_line(), "host_cpu": host_cpu(), "size": XL_SIZE, "steps": STEPS,
        "switch_at": SWITCH_AT, "segments": [[0, k], [k, STEPS]], "setup_s": setup_s,
        "launches": launched, "per_request": ens_request, "first_request_s": first_s,
        "p50_ms": statistics.median(latency), "latency_ms": latency,
        "kernel_ms_per_request": prof["device_busy_ms"],
        "kernel_launches_per_request": prof["kernel_launches"],
        "busy_share": prof["busy_share"], "port_kernels": prof["port_kernels"],
        "graph_equals_eager": eager_png == first, "carry_on_card": on_card,
        "base_segments_equal_full_run": bitmatch, "buckets": buckets,
        "peak_memory_bytes_both_resident": peak,
        "refiner_flash_per_request_ms": rows["flash"], "refiner_gn_per_request_ms": rows["gn"],
        "timing_s": timing_s}}
    del base, refiner, eager
    worker.refiner = None
    line["ensemble"]["freed_bytes_on_delete"] = delete_pipeline(worker)
    line["ensemble"]["phase_s"] = time.perf_counter() - t0
    return rows, launched, errs, line


def delete_pipeline(worker) -> int:
    """Drop the worker's pipeline, its graphs and their pool; the bytes the
    card's allocator gave back."""
    reserved = torch.cuda.memory_reserved()
    worker.pipeline = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return reserved - torch.cuda.memory_reserved()


# ---------------------------------------------------------------------------
# phase 9: the probes (K4, K5, K6) of dreamlab_tpu_torch/scripts
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
        expect(err <= TOL_FP32_FLASH, f"{name} {dtype} {list(shape)} err {err}")
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
        expect(err <= TOL_FP32_FLASH, f"flash_folded {dtype} lane {lane} err {err}")
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
    """Phase 9. Returns (kernel entries for the kernels line, probes line)."""
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
            log({"check": f"{probe}/{case}", "dtype": "torch.bfloat16", **c})
        expect(not run["failed"], f"{probe}: checks failed {run['failed']}")
    for name in ("flash_4d", "flash_folded", "flash_packed3"):
        expect(launches[name] > 0, f"the probes launched {name} no time")
    end_phase("probes")

    t4 = runs["ab_transpose_free"]
    lay = runs["ab_attention_layout"]
    hp = runs["ab_head_packing"]
    checks_of = {"flash_4d": [c for case, c in t4["checks"].items() if case.endswith("/group")],
                 "flash_folded": [lay["checks"][lane] for lane in ("folded", "nopad")],
                 "flash_packed3": [hp["checks"]["packed3"]]}
    for name, checks in checks_of.items():
        errs[name] = max(c["max_abs_err"] for c in checks)
        errs[f"{name}_beyond"] = max(c["beyond_rounding"] for c in checks)
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
            "beyond_rounding_limit": TOL_BF16_P, "max_beyond_rounding": errs[f"{name}_beyond"],
            # K5 at lane 128 computes 3.2x the work of d = 40: both bounds
            **({"bound_ms_d40": k5_bound(al.D)[0]}
               if name == "flash_folded" else {})})
    line = {"probes": {**runs, "launches": launches, "probes_s": time.perf_counter() - t0}}
    return entries, line


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def kernel_entries(rows, launches, errs, suffix="",
                   keys=("flash", "gn_stats", "gn_apply", "gn")) -> list:
    """The kernels line's entries of one path: K1, and K2, K3 and K2+K3 (the
    fused call the paths run; K2 and K3 alone are checked at fixed shapes).
    ``launches`` counts every launch of the path's run (its warm runs and
    captures, of all its buckets); ``launches_per_request`` counts those of
    one request at the shapes the entry's times add up."""
    sources = {
        "flash": ("dreamlab_tpu_torch/csrc/flash_attention.cu",
                  "dreamlab_tpu/ops/flash_attention.py:52"),
        "gn_stats": ("dreamlab_tpu_torch/csrc/groupnorm.cu",
                     "dreamlab_tpu/ops/groupnorm.py:30"),
        "gn_apply": ("dreamlab_tpu_torch/csrc/groupnorm.cu",
                     "dreamlab_tpu/ops/groupnorm.py:36"),
        # K2 + K3 as the main path runs them: one cluster-kernel launch per call
        "gn": ("dreamlab_tpu_torch/csrc/groupnorm.cu", "dreamlab_tpu/ops/groupnorm.py:47"),
    }
    names = {"gn": "group_norm_silu"}
    limits = {"flash": (TOL_BF16_P, errs["flash_beyond"]), "gn": (TOL_BF16, errs["gn_beyond"])}
    kernels = []
    for name in keys:
        src, replaces = sources[name]
        r = rows[name]
        kernels.append({
            "name": names.get(name, name) + suffix, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "launches_per_request": int(r["launches_per_request"]),
            "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["bound_operations_ms"] > r["bound_bytes_ms"]
            else "bytes",
            "library_ms": r["library_ms"],
            **({"beyond_rounding_limit": limits[name][0],
                "max_beyond_rounding": limits[name][1]} if name in limits else {}),
        })
    return kernels


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        return 1
    smi = smi_line()
    log(smi)

    t0 = time.perf_counter()
    so = _build.build()
    log({"build_s": time.perf_counter() - t0})
    check_build(so)
    end_phase("build")

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
    per_request = per_request_of(seen)
    log({"setup_s": time.perf_counter() - t0, "launches_per_request": per_request})
    expect(per_request == {"flash": 40, "gn": 209, "gn_stats": 209, "gn_apply": 209},
           f"census {per_request}, expected 40 flash and 209 GroupNorm launches")

    t0 = time.perf_counter()
    rows = time_kernels(seen, torch.bfloat16, errs)
    log({"timing_s": time.perf_counter() - t0, "per_request_ms": rows})

    t0 = time.perf_counter()
    result = main_path(worker, per_request)
    end_phase("main path")
    log({"main_path_s": time.perf_counter() - t0, "card": smi, "host_cpu": host_cpu(),
         **result})

    spec = GenSpec("a mountain at sunset", size=f"{SIZE}x{SIZE}", num_inference_steps=STEPS,
                   seed=5)
    t0 = time.perf_counter()
    census_kernels = {"flash_mma_kernel": per_request["flash"],
                      "gn_cluster_kernel": per_request["gn"]}
    before = graph_vs_eager(worker, {"batch1": spec}, EAGER_SAMPLES, census_kernels)
    prof1, prof_eager = before.pop("profile_graph"), before.pop("profile_eager")
    log({"profile_batch1": prof1, "profile_eager_batch1": prof_eager})
    # the card's own record: the fused kernel ran, the separate apply kernel did not
    expect("gn_apply_kernel" not in prof1["port_kernels"],
           f"profiled request ran {prof1['port_kernels']}")
    prof8 = profile(lambda: worker.run_jobs([spec] * 8))
    log({"profile_batch8": prof8})
    # the kernels take the batch: one launch per call at batch 8 as at batch 1
    expect({k: prof8["port_kernels"].get(k, 0) for k in census_kernels} == census_kernels,
           f"a profiled batch-8 replay ran {prof8['port_kernels']}")
    device_rng = check_device_rng(pipe)
    del pipe
    freed = delete_pipeline(worker)
    del worker
    end_phase("graph against eager")
    log({"graph_vs_eager_s": time.perf_counter() - t0, "card": smi, **before,
         "device_rng": device_rng, "freed_bytes_on_delete": freed,
         "before_after_batch1": {
             "eager": {"p50_ms": before["eager_p50_ms"], "min_ms": before["eager_min_ms"],
                       "max_ms": before["eager_max_ms"],
                       "busy_share": prof_eager["busy_share"],
                       "kernel_ms": prof_eager["device_busy_ms"],
                       "kernel_launches": prof_eager["kernel_launches"]},
             "graph": {"p50_ms": result["p50_ms_batch1"], "min_ms": result["min_ms_batch1"],
                       "max_ms": result["max_ms_batch1"], "busy_share": prof1["busy_share"],
                       "kernel_ms": prof1["device_busy_ms"],
                       "kernel_launches": prof1["kernel_launches"]}}})

    with tempfile.TemporaryDirectory(prefix="dreamlab_ckpt_") as root:
        t0 = time.perf_counter()
        loaded = loader_phase(per_request, root)
        end_phase("loader")
        log({"loader": {**loaded, "phase_s": time.perf_counter() - t0, "card": smi}})
        t0 = time.perf_counter()
        pool_line, pool_launches = pool_sr_phase(root, per_request)
        end_phase("pool and super-resolution")
        log({"pool_sr": {**pool_line, "phase_s": time.perf_counter() - t0, "card": smi}})
        t0 = time.perf_counter()
        server_line, server_launches = server_phase(
            root, os.path.join(root, "super-resolution-10.onnx"), per_request)
        end_phase("server")
        log({**server_line, "phase_s": time.perf_counter() - t0, "card": smi})
        yume_line, yume_entries = yume_phase(root, rows, errs)
        end_phase("yume")
        log({**yume_line, "card": smi})

    enc_rows, enc_launches, enc_errs, extras_line = sd15_extras_phase(per_request, seen)
    log(extras_line)

    cn_rows, cn_launches, cn_errs, cn_line = controlnet_phase(per_request)
    log(cn_line)

    t0 = time.perf_counter()
    xl_errs = collections.defaultdict(float)
    xl_rows, xl_launches, xl_line, xl_i2i, xl_tiles = sdxl_phase(xl_errs)
    end_phase("sdxl")
    xl_line["sdxl"]["phase_s"] = time.perf_counter() - t0
    log(xl_line)

    ens_rows, ens_launches, ens_errs, ens_line = ensemble_phase()
    end_phase("ensemble")
    log(ens_line)

    probe_entries, probe_line = probes(errs)
    log(probe_line)
    log({"total_s": time.perf_counter() - start})

    kernels = (kernel_entries(rows, result["launches"], errs)
               + kernel_entries(rows, pool_launches, errs, "_pool", ("flash", "gn"))
               + kernel_entries(rows, server_launches, errs, "_server", ("flash", "gn"))
               + yume_entries
               + kernel_entries(xl_rows, xl_launches, xl_errs, "_sdxl", ("flash", "gn"))
               + kernel_entries(enc_rows, enc_launches, enc_errs, "_encoder", ("gn",))
               + kernel_entries(*xl_i2i, "_encoder_sdxl", ("gn",))
               + kernel_entries(*xl_tiles, "_sdxl_1344x768", ("flash",))
               + kernel_entries(cn_rows, cn_launches, cn_errs, "_controlnet", ("flash", "gn"))
               + kernel_entries(ens_rows, ens_launches, ens_errs, "_refiner", ("flash", "gn")))
    log({"kernels": kernels + probe_entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
