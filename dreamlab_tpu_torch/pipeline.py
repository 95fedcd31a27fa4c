"""txt2img, img2img and inpainting on PyTorch (port of ``dreamlab_tpu/pipeline.py::LCMPipeline``).

A request runs in two parts, as in the JAX package:

- **staging** on the host: tokenize, draw host noise, build the LCM
  w-embedding, the micro-conditioning ids and the per-row guidance;
- **the bucket's program**: CLIP encode, the 4-step loop of
  ``unet.forward`` + ``lcm_step``, ``vae.decode(denoised / scaling_factor)``,
  clip, round, uint8. The JAX package traces and jits it once per shape
  bucket (``_build``, ``_get_compiled``); here it is captured once per
  bucket as a CUDA graph and replayed (``_GraphProgram``). The bucket key is
  (batch, h_lat, w_lat, steps, cfg_mode, rng_mode, original_inference_steps,
  task), followed by ("segment", (start, stop)), ("progress", mode) and
  ("ctrl", ControlNet config) where a request has them (a plain request's
  key has none): txt2img bakes the schedule's entries into the program as
  Python floats, so the original step count that shapes the schedule, and
  a segment's bounds, belong to the key. On the CPU a bucket's program is
  the same function run eagerly (``_EagerProgram``), cached under the same
  key.

img2img and inpainting (``img2img``, ``inpaint``; task "img2img" /
"inpaint") VAE-encode the init image, renoise it to the first timestep of
the strength-truncated ladder, denoise and decode; inpainting blends the
known region back at each step, renoised to the next timestep. Strength is
a user's float, so these programs take the schedule as device inputs (as
the JAX program takes it as an argument): one graph per bucket serves every
strength. Decoding switches to ``vae.decode_tiled`` when the latent's longer
side exceeds ``DREAMLAB_VAE_CHUNK`` (default "auto" = 160; "off" disables),
with ``DREAMLAB_VAE_TILE``-latent tiles (default 64), both read once at
init as the JAX package reads them; the choice follows (h, w), so the key
needs no entry for it.

SD1.5 and SDXL checkpoints. SDXL encodes with two text towers (the
sequences concatenated, the pooled embedding from the second) and
conditions the UNet on micro-conditioning ids as well; a refiner-layout
checkpoint has the second tower only. Guidance takes one of three modes,
chosen per call as in the JAX package:

- ``wcond``: the UNet has ``time_cond_proj_dim`` (LCM checkpoints, SD1.5
  or SDXL); guidance conditions it through the w-embedding, no CFG.
- ``cfg``: classic classifier-free guidance when a row's guidance exceeds
  1: one UNet call on the doubled batch (negatives, then prompts) per step,
  mixed per row as ``uncond + g * (cond - uncond)``.
- ``none``: guidance <= 1 on a non-LCM UNet (SDXL with an LCM-LoRA merged).

Noise: ``rng_mode="host"`` (the default, or ``DREAMLAB_RNG``) draws latents
and per-step noise from ``np.random.RandomState(seed)`` in NCHW, transposed,
exactly as the JAX package does, so a seed gives the same noise in both.
``rng_mode="device"`` draws them on the device from a ``torch.Generator``
seeded with the seed, straight into the program's inputs: deterministic per
seed on one device, and not equal to host noise (as the JAX package's
device mode is not). Explicit ``latents`` / ``step_noises`` force host
noise.

Segments (``generate(segment=(start, stop), latents_state=)``, the SDXL base
-> refiner ensemble): steps [start, stop) of the ladder, with the schedule
sliced (``slice_schedule``) and baked into the bucket's program as the full
run's is, and the noise of the same host stream a full run draws; a segment
that ends early decodes nothing and returns its fp32 carry on the device
(``state_device``), which the next segment's graph copies into its static
input on the device. So (0, k) then (k, S) equals the S-step run bit for
bit. A device schedule would not: CUDA divides by a host scalar as a
product with its reciprocal, by a device scalar exactly.

ControlNet (``set_controlnet``, ``generate(control_image=,
controlnet_scale=)``): the hint and the scale are staged inputs; the hint
embedding runs once per request, the trunk once per UNet call. A ctrl
bucket's graph reads the ControlNet's leaves where it captured them, so a
net of the same config is written into the live leaves and one of another
config (or a detach) drops the ctrl buckets.

Progress (``generate(callback=, callback_steps=, callback_latents=)``):
``callback(step, timestep, latents)`` as the JAX package calls it, from a
bucket of its own ("steps" or "latents"). A graph cannot call the host, so
its program records an external CUDA event after each step (and, for
"latents", copies the step's latents into a static slot); the calling
thread waits on event i while the replay runs on, reads slot i on a side
stream and hands it to ``_progress_emit``, which filters, orders and guards
the calls as the JAX package's trampoline does.

Pipelined dispatch (``generate(pipelined=True)``, the worker pool's
overlap): the call returns once the replay and the copies of its images and
latents into pinned host buffers of the request's own are queued, and
``result.wait()`` blocks until they are on the host. The inputs are staged
through pinned buffers on the replay's stream, so stream order alone keeps
request i+1's inputs from landing before replay i has read them and its
outputs from being overwritten before they are copied out. A request with a
progress callback runs synchronously, as in the JAX package.

Threads: the launches of one device go through ``device_lock(device)``, a
reader-writer lock. A graph capture holds it exclusively; every other
launch section (a replay's dispatch, an eager run, a style merge, a
super-resolution forward) holds it shared and releases it before waiting on
the host. So a bucket can be captured on one thread while others replay,
merge and upscale, and none of their launches lands inside the capture.
One pipeline's captures and dispatches are serialized by its own lock.

Spans (``utils/tracing.py``): ``pipeline.stage`` around host staging,
``graph.replay`` around a replay's launch section and ``graph.capture``
around a capture (counted in ``pipeline.captures``), each naming its
bucket, and ``device.wait`` around a pipelined result's wait.

A mesh (``LCMPipeline(mesh=, tensor_parallel=)``, one rank per device,
``parallel/sharding.py``): every rank stages the whole request batch from
the same seeds (so the same host noise, and under device RNG the same
draws, taken before the rows are split) and keeps its data rank's rows; the
bucket key holds the local batch, so a batch-2 request on two data ranks
replays the batch-1 graph of solo requests. After the program the images
and latents are gathered over the data group in rank order, so every rank
returns the whole batch. With ``tensor_parallel`` the UNet's transformer
blocks are split over the model axis (text towers, VAE and ControlNet stay
whole on every rank); its buckets hold collectives, captured where the
model group runs them on the device (NCCL) and run eagerly over a host
(gloo) group, which a graph cannot capture: the choice is the group's
backend, made when the pipeline is built.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .models import clip_text, controlnet, unet, vae
from .models.configs import CLIPTextConfig, UNetConfig, VAEConfig
from .parallel.sharding import (ModelGroup, data_rows, gather_rows, shard_leaf, shard_params,
                                unet_tp_placements)
from .scheduler.lcm import (
    LCMConfig,
    LCMSchedule,
    guidance_scale_embedding,
    lcm_step,
    make_lcm_schedule,
    SCHEDULE_FIELDS,
    schedule_on,
    slice_schedule,
)
from .utils import tracing
from .utils.tokenizer import CLIPTokenizer

logger = logging.getLogger(__name__)

# the refiner's uncond-branch aesthetic score (diffusers' default)
NEGATIVE_AESTHETIC_SCORE = 2.5

# (batch, h_lat, w_lat, steps, cfg_mode, rng_mode, original_steps, task) and,
# where a request has them, ("segment", (start, stop)), ("progress", mode),
# ("ctrl", ControlNet config)
BucketKey = Tuple

# staged inputs without a batch axis
_UNBATCHED = frozenset(("ctrl_scale", *SCHEDULE_FIELDS))


@dataclasses.dataclass
class PipelineBundle:
    """Everything a worker needs to serve one checkpoint: configs, tokenizers
    and parameter trees (dicts of tensors, ``loader`` / ``testing`` layout)."""

    arch: str  # "sd15" | "sdxl"
    tokenizer: CLIPTokenizer
    text_cfg: CLIPTextConfig
    text_params: Dict
    unet_cfg: UNetConfig
    unet_params: Dict
    vae_cfg: VAEConfig
    vae_params: Dict
    scheduler_cfg: LCMConfig
    # SDXL's second (OpenCLIP bigG) tower; None for SD1.5 and the refiner
    tokenizer_2: Optional[CLIPTokenizer] = None
    text_cfg_2: Optional[CLIPTextConfig] = None
    text_params_2: Optional[Dict] = None
    model_dir: Optional[str] = None  # where the loader read it; None in memory
    vae_encoder_params: Optional[Dict] = None  # img2img / inpaint; None if not loaded


@dataclasses.dataclass
class GenerationResult:
    """``images`` and ``latents`` are host arrays once the result is ready:
    at once, or after ``wait()`` for a pipelined one (None until then)."""

    images: Optional[np.ndarray]  # [B, H, W, 3] uint8; None for a segment that ends early
    seed: int
    latents: Optional[np.ndarray]  # [B, h, w, 4] fp32 final denoised latents; None as images
    # a segment that ends early: its fp32 carry [B, h, w, 4] on the device
    state_device: Optional[torch.Tensor] = None
    # a pipelined result: (event after the copies, pinned images, pinned latents)
    _pending: Optional[Tuple[Any, torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    def wait(self) -> "GenerationResult":
        """Block until the images and latents are on the host (at once unless
        the result is pipelined)."""
        if self._pending is not None:
            ready, images, latents = self._pending
            with tracing.span("device.wait"):
                ready.synchronize()
            self.images, self.latents = images.numpy(), latents.numpy()
            self._pending = None
        return self


class DeviceLock:
    """A reader-writer lock over one device's launches: ``exclusive()`` for a
    graph capture, ``shared()`` for every other launch section. Shared holds
    nest within a thread, and count as nothing inside the thread's own
    exclusive hold; a waiting capture admits no new shared holder, so a
    steady stream of launches cannot starve it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: Optional[int] = None  # the exclusive holder's thread id
        self._writers_waiting = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._local, "depth", 0)
        mine = self._writer == threading.get_ident()
        if depth == 0 and not mine:
            with self._cond:
                while self._writer is not None or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if depth == 0 and not mine:
                with self._cond:
                    self._readers -= 1
                    if not self._readers:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._writer == me:
            yield
            return
        if getattr(self._local, "depth", 0):
            raise RuntimeError("a thread that holds the device lock shared cannot take it "
                               "exclusively")
        with self._cond:
            self._writers_waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()


_device_locks: Dict[torch.device, DeviceLock] = {}
_device_locks_guard = threading.Lock()


def device_lock(device) -> DeviceLock:
    """The process's launch lock of ``device`` (a CUDA device without an
    index is the current one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _device_locks_guard:
        return _device_locks.setdefault(device, DeviceLock())


@contextlib.contextmanager
def quiesced():
    """Every device lock of the process (each CUDA device's and any other
    taken so far) held exclusively, in one fixed order: while it is held no
    thread is inside a launch section. torch.profiler starts and stops under
    it: stopping it while another thread replays a CUDA graph can deadlock
    with the GIL held, so that the whole process stops for good
    (``scripts/profiler_race.py``)."""
    devices = {torch.device("cuda", i) for i in range(torch.cuda.device_count())}
    with _device_locks_guard:
        devices.update(_device_locks)
    with contextlib.ExitStack() as held:
        for device in sorted(devices, key=str):
            held.enter_context(device_lock(device).exclusive())
        yield


@dataclasses.dataclass
class _Staged:
    """One request after host staging: its bucket and its program's inputs
    (host arrays, and a segment's carry as a device tensor; in device-RNG
    mode without the two noise arrays), and its progress callback's
    registry token (0: none). On a data rank of a mesh that splits the
    batch: ``rows``, the rank's rows of the request's ``batch``."""

    key: BucketKey
    inputs: Dict[str, Any]
    seed: int
    init_noise_sigma: float
    progress_token: int = 0
    rows: Optional[slice] = None
    batch: int = 0


def _staging(stage: Callable[..., _Staged]) -> Callable[..., _Staged]:
    """A staging method, in a ``pipeline.stage`` span that names the bucket."""

    @functools.wraps(stage)
    def staged(self, *args, **kwargs) -> _Staged:
        with tracing.span("pipeline.stage") as s:
            out = stage(self, *args, **kwargs)
            s.attrs["bucket"] = out.key
        return out

    return staged


def _extras(key: BucketKey) -> Dict[str, Any]:
    """The optional entries of a bucket key: segment, progress, ctrl."""
    return dict(key[8:])


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller names another; never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def deterministic_backends() -> None:
    """The backend settings both serving invariants rest on (the same seed
    gives the same bytes; a batch row equals its solo run), and that graph
    capture needs (no autotuning while a graph is being captured): cuDNN
    deterministic without benchmark autotuning, TF32 off for matmuls and
    cuDNN. The flags are process-wide; every pipeline sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def _place_params(tree, dtype: torch.dtype, device: torch.device):
    """The leaves on ``device``, floating ones cast to ``dtype`` (None, an
    absent tree, stays None); conv weights (4-D) go channels_last, the layout
    of the NHWC activations (models/layers.py). A leaf that is already so
    placed is taken as it is, so a checkpoint the loader put on the card is
    not held twice there. LoRA merges write these leaves in place, which
    inference mode forbids for tensors made outside it and vice versa: an
    inference tensor is copied, and the copies are made outside inference
    mode."""
    if isinstance(tree, dict):
        return {k: _place_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_params(v, dtype, device) for v in tree]
    if tree is None:
        return None
    with torch.inference_mode(False):
        t = tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)
        if t.ndim == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.clone() if t.is_inference() else t


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: leaf} of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _draw_device_noise(staged: _Staged, lat0: torch.Tensor, noises: torch.Tensor) -> None:
    """Device RNG: fill the program's noise inputs in place from a generator
    on their device seeded with the seed (latents first, scaled by the init
    sigma, then the per-step noise). A data rank draws the whole batch's
    noise and keeps its rows, so each row is the one a single device draws."""
    gen = torch.Generator(device=lat0.device).manual_seed(staged.seed & 0x7FFFFFFF)
    if staged.rows is None:
        lat0.normal_(generator=gen).mul_(staged.init_noise_sigma)
        noises.normal_(generator=gen)
        return
    full = lambda t, axis: t.new_empty(t.shape[:axis] + (staged.batch,) + t.shape[axis + 1:])
    lat0.copy_(full(lat0, 0).normal_(generator=gen).mul_(staged.init_noise_sigma)[staged.rows])
    noises.copy_(full(noises, 1).normal_(generator=gen)[:, staged.rows])


def _tensor(v) -> torch.Tensor:
    """A staged input as a tensor: a host array viewed, a device tensor (a
    segment's carry) as it is."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(v)


def _device_inputs(pipe: "LCMPipeline", staged: _Staged) -> Dict[str, torch.Tensor]:
    """A request's program inputs on the pipeline's device, each its own
    copy: the staged host arrays and carry, and in device-RNG mode the noise
    drawn there."""
    x = {k: _tensor(v).to(pipe.device, copy=True) for k, v in staged.inputs.items()}
    if staged.key[5] == "device":
        x.update(pipe._noise_buffers(staged.key))
        _draw_device_noise(staged, x["lat0"], x["noises"])
    return x


def _pinned(v) -> torch.Tensor:
    """A staged input ready for an asynchronous copy to the device: a host
    array copied into pinned memory, a device tensor (a segment's carry) as
    it is. The caching host allocator keeps a pinned block from reuse until
    the copies queued from it have run."""
    if isinstance(v, torch.Tensor):
        return v
    src = torch.from_numpy(v)
    return torch.empty_like(src, pin_memory=True).copy_(src)


def _result(staged: _Staged, outputs) -> GenerationResult:
    """A program's outputs as a result. A segment that ends early keeps its
    carry on the device (a copy of it, where a graph's output would be
    overwritten by the bucket's next replay). On the card the images and
    latents are queued for copying into pinned host buffers of the
    request's own, on the current stream, and are read at ``wait()``; on the
    CPU they are the host arrays."""
    if staged.key[7] == "latent":
        return GenerationResult(None, staged.seed, None, state_device=outputs[0].clone())
    images, latents = outputs
    if images.device.type != "cuda":
        return GenerationResult(images.numpy(), staged.seed, latents.numpy())
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in (images, latents)]
    ready = torch.cuda.Event()
    ready.record()
    return GenerationResult(None, staged.seed, None, _pending=(ready, *host))


class _EagerProgram:
    """A bucket's program run as called: the CPU's program, and on the card
    the private eager route (``LCMPipeline._generate_eager``), which holds
    the device lock shared for the whole run, host waits included."""

    def __init__(self, key: BucketKey):
        self.key = key

    def __call__(self, pipe: "LCMPipeline", staged: _Staged) -> GenerationResult:
        progress = _extras(self.key).get("progress")
        sink = None
        if progress is not None:
            timesteps = pipe._key_schedule(self.key).timesteps

            def sink(i, lat):
                pipe._progress_emit(staged.progress_token, i, timesteps[i],
                                    lat.cpu().numpy() if progress == "latents" else None)

        with torch.inference_mode(), device_lock(pipe.device).shared():
            return _result(staged, pipe._program(self.key, _device_inputs(pipe, staged),
                                                 progress=sink))


class _GraphProgram:
    """A bucket's program as one captured CUDA graph.

    Static inputs live at fixed addresses: each call copies the staged host
    arrays into them from pinned buffers, asynchronously on the current
    stream (a segment's carry: device to device; device RNG draws straight
    into the noise inputs), replays the graph, and queues the copies of
    images and latents to the request's own pinned host buffers (a
    segment's carry: to a tensor of its own), all before the next replay
    can overwrite them. Capture follows one eager run on a side stream,
    which builds the kernel library, sets the kernels' attributes and lets
    cuBLAS and cuDNN settle, none of which may happen while capturing; it
    holds the device lock exclusively and captures in the "thread_local"
    error mode, so other threads' host waits stay legal meanwhile. The
    graphs of one pipeline share its memory pool; the pipeline's lock
    serializes its captures and dispatches. The program keeps no reference
    to the pipeline: deleting the pipeline frees its graphs and their pool.

    A progress bucket records one external event per step (and copies each
    step's latents into its slot of a static buffer); after launching the
    replay, the call waits on each event in turn and reads the slot on a
    side stream while the graph runs on.
    """

    def __init__(self, pipe: "LCMPipeline", staged: _Staged):
        dev = pipe.device
        key = staged.key
        progress = _extras(key).get("progress")
        self.events = self.slots = None
        with tracing.span("graph.capture", bucket=key), torch.inference_mode(), \
                device_lock(dev).exclusive():
            self.inputs = _device_inputs(pipe, staged)
            if progress is not None:
                self.timesteps = pipe._key_schedule(key).timesteps
                steps = len(self.timesteps)
                self.events = [torch.cuda.Event(external=True) for _ in range(steps)]
                if progress == "latents":
                    self.slots = torch.empty((steps, *self.inputs["lat0"].shape), device=dev)
                self.reader = torch.cuda.Stream(dev)
            sink = None if progress is None else self._record
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                pipe._program(key, self.inputs, progress=sink)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pipe._graph_pool,
                                  capture_error_mode="thread_local"):
                self.outputs = pipe._program(key, self.inputs, progress=sink)
            torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        tracing.count("pipeline.captures")
        # what this capture added to the shared pool (later buckets reuse
        # the blocks earlier ones freed, so they add less)
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _record(self, i: int, lat: torch.Tensor) -> None:
        """Step ``i``'s progress nodes: its latents into slot i, then event i."""
        if self.slots is not None:
            self.slots[i].copy_(lat)
        self.events[i].record()

    def __call__(self, pipe: "LCMPipeline", staged: _Staged) -> GenerationResult:
        lock = device_lock(pipe.device)
        with torch.inference_mode():
            with lock.shared(), tracing.span("graph.replay", bucket=staged.key):
                for name, v in staged.inputs.items():
                    self.inputs[name].copy_(_pinned(v), non_blocking=True)
                if staged.key[5] == "device":
                    _draw_device_noise(staged, self.inputs["lat0"], self.inputs["noises"])
                self.graph.replay()
                res = _result(staged, self.outputs)
            for i, event in enumerate(self.events or ()):
                event.synchronize()  # step i is done; the replay runs on
                lat = None
                if self.slots is not None:
                    # on a side stream: not behind the replay
                    with lock.shared(), torch.cuda.stream(self.reader):
                        lat = self.slots[i].cpu().numpy()
                pipe._progress_emit(staged.progress_token, i, self.timesteps[i], lat)
        return res


class LCMPipeline:
    """Serving pipeline for one loaded checkpoint.

    Args:
        bundle: configs, tokenizers + parameter trees. The pipeline keeps
            the configs and tokenizers (``self.bundle``, parameter trees
            dropped) and its own copies of the trees, cast and placed, so
            the caller's copies can be freed.
        dtype: compute/param dtype (bf16, as in the JAX package).
        device: None = the CUDA device (raises if there is none); "cpu" runs
            every kernel's plain version.
        mesh: this rank's ("data", "model") ``DeviceMesh``
            (``parallel.sharding.make_mesh``); every rank of it builds the
            pipeline from the same weights and runs the same calls.
        tensor_parallel: split the UNet's transformer blocks over the mesh's
            model axis.
    """

    def __init__(self, bundle: PipelineBundle, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None, tensor_parallel: bool = False):
        if bundle.arch not in ("sd15", "sdxl"):
            raise ValueError(f"unknown arch {bundle.arch!r}")
        if tensor_parallel and mesh is None:
            raise ValueError("tensor_parallel needs a mesh")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        deterministic_backends()
        self.text_params = _place_params(bundle.text_params, dtype, self.device)
        self.text_params_2 = _place_params(bundle.text_params_2, dtype, self.device)
        # q/k/v packed once placed (unet.pack_attention_params, as the JAX
        # package packs at placement): before any bucket is captured, since
        # a graph reads the weights at their addresses
        self.unet_params = unet.pack_attention_params(
            _place_params(bundle.unet_params, dtype, self.device))
        # this rank's UNet slices ({leaf path: the dim it splits, or None}) and
        # its model group; a whole UNet and None on one device
        self._unet_split: Dict[str, Optional[int]] = {}
        self._tp = None
        if tensor_parallel:
            placements = unet_tp_placements(self.unet_params, mesh, bundle.unet_cfg)
            self.unet_params = shard_params(self.unet_params, placements, mesh)
            self._unet_split = _flat(placements)
            self._tp = ModelGroup.of(mesh)
        # a bucket's program on the card is a captured graph, unless it holds
        # collectives that a graph cannot capture (a gloo model group)
        self.graphs = self.device.type == "cuda" and (self._tp is None or self._tp.on_device)
        self.vae_params = _place_params(bundle.vae_params, dtype, self.device)
        self.vae_encoder_params = _place_params(bundle.vae_encoder_params, dtype, self.device)
        self.bundle = dataclasses.replace(bundle, text_params=None, text_params_2=None,
                                          unet_params=None, vae_params=None,
                                          vae_encoder_params=None)
        self.vae_scale = bundle.vae_cfg.scale_factor
        self.latent_channels = bundle.vae_cfg.latent_channels
        # the JAX package's tiled-decode settings, read the same way
        chunk = os.environ.get("DREAMLAB_VAE_CHUNK", "auto")
        self._vae_chunk: Optional[int] = (
            None if chunk.lower() in ("0", "off", "false", "no")
            else 160 if chunk == "auto" else int(chunk))
        self._vae_tile = int(os.environ.get("DREAMLAB_VAE_TILE", "64"))
        self._schedules: Dict[Tuple, LCMSchedule] = {}
        # bucket key -> program (a captured graph on the card, eager on the CPU)
        self._compiled: Dict[BucketKey, Any] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if self.graphs else None
        # an attached ControlNet (set_controlnet); requests opt in per call
        self.controlnet_params: Optional[Dict] = None
        self.controlnet_cfg: Optional[UNetConfig] = None
        # progress callbacks: a request's token -> (callback, every, state)
        self._progress_registry: Dict[int, Tuple[Callable, int, dict]] = {}
        self._progress_tokens = itertools.count(1)
        self._progress_lock = threading.Lock()
        # serializes this pipeline's captures and dispatches (a pool's
        # background warm-up captures beside its worker's requests)
        self._lock = threading.Lock()

    def unet_leaf_slice(self, path: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole ``value`` of the UNet leaf at ``path``
        (the value itself on one device and where the leaf is whole): what a
        LoRA merge writes into a tensor-parallel rank's leaf. ``path`` may
        name a projection packed into a slot (``...attn1.q.w``): a slot of
        ``[S, out, in]`` is ``[out, in]``, split one dim lower."""
        split = self._unet_split.get(path)
        parts = path.rsplit(".", 2)
        if split is None and len(parts) == 3:
            site, name, field = parts
            for packed, slots in unet.PACK_SLOTS.items():
                whole = self._unet_split.get(f"{site}.{packed}.{field}")
                if name in slots and whole is not None:
                    split = whole - 1
        return value if split is None else shard_leaf(value, split, self.mesh)

    def _data_rows(self, bsz: int) -> Optional[slice]:
        """This data rank's rows of a ``bsz``-row batch; None where it runs
        them all (no mesh, or a batch the data axis does not divide)."""
        if self.mesh is None:
            return None
        rows = data_rows(bsz, self.mesh)
        return None if rows == slice(0, bsz) else rows

    def _shard_rows(self, staged: _Staged) -> _Staged:
        """A staged batch cut to this data rank's rows. A segment's carry
        already holds the rank's rows."""
        bsz = staged.key[0]
        rows = self._data_rows(bsz)
        if rows is None:
            return staged
        cfg = staged.key[4] == "cfg"
        x = {}
        for name, v in staged.inputs.items():
            if isinstance(v, torch.Tensor) or name in _UNBATCHED:
                x[name] = v
            elif name in ("noises", "noises_known"):  # [S, B, ...]
                x[name] = np.ascontiguousarray(v[:, rows])
            elif name == "time_ids" and cfg:  # the uncond rows, then the cond rows
                x[name] = np.ascontiguousarray(v.reshape(2, bsz, -1)[:, rows].reshape(
                    -1, v.shape[-1]))
            else:
                x[name] = np.ascontiguousarray(v[rows])
        return dataclasses.replace(staged, key=(rows.stop - rows.start, *staged.key[1:]),
                                   inputs=x, rows=rows, batch=bsz)

    def _gathered(self, staged: _Staged, res: GenerationResult) -> GenerationResult:
        """A data rank's result as the whole batch's: its images and latents
        gathered over the data group in rank order (waited for first)."""
        if staged.rows is None:
            return res
        res.wait()
        if res.images is not None:
            res.images = gather_rows(res.images, self.mesh)
            res.latents = gather_rows(res.latents, self.mesh)
        return res

    def release_graphs(self) -> None:
        """Drop every bucket's program: the graphs, and with the last of them
        the pipeline's graph pool (returned to the card at the next
        ``torch.cuda.empty_cache``)."""
        with self._lock:
            self._compiled.clear()

    def set_controlnet(self, params, cfg: Optional[UNetConfig]) -> None:
        """Attach a ControlNet (``models/controlnet.py``'s tree and its
        UNetConfig), or detach it with ``params=None``. Its attention
        projections are packed as the UNet's are
        (``unet.pack_attention_params``), and it is checked against the
        pipeline's UNet (tap count, tap width, cross attention width). A
        ctrl bucket's graph reads the leaves it
        captured: a net of the attached net's config and shapes is written
        into those leaves (``copy_``), so the graphs serve it as they are;
        another net, or a detach, drops the ctrl buckets and their graphs."""
        if params is None:
            self._drop_ctrl_buckets()
            self.controlnet_params = self.controlnet_cfg = None
            return
        params = unet.pack_attention_params(params)
        ucfg = self.bundle.unet_cfg
        n_skips = controlnet.skip_count(ucfg)
        taps = params.get("zero_down", ())
        if len(taps) != n_skips:
            raise ValueError(f"ControlNet has {len(taps)} down taps but this UNet has "
                             f"{n_skips} skip connections: architecture mismatch")
        c0 = taps[0]["w"].shape[0]
        if c0 != ucfg.block_out_channels[0]:
            raise ValueError(f"ControlNet tap channels ({c0}) != UNet block_out_channels[0] "
                             f"({ucfg.block_out_channels[0]})")
        if cfg.cross_attention_dim != ucfg.cross_attention_dim:
            raise ValueError(f"ControlNet cross_attention_dim {cfg.cross_attention_dim} != "
                             f"UNet {ucfg.cross_attention_dim}")
        if self.controlnet_params is not None and cfg == self.controlnet_cfg:
            live, new = _flat(self.controlnet_params), _flat(params)
            if {k: v.shape for k, v in live.items()} == {k: v.shape for k, v in new.items()}:
                with torch.no_grad():
                    for path, leaf in live.items():
                        leaf.copy_(new[path])
                return
        self._drop_ctrl_buckets()
        self.controlnet_params = _place_params(params, self.dtype, self.device)
        self.controlnet_cfg = cfg

    def _drop_ctrl_buckets(self) -> None:
        with self._lock:
            for key in [k for k in self._compiled if "ctrl" in _extras(k)]:
                del self._compiled[key]

    def _progress_emit(self, token: int, step: int, timestep, latents=None) -> None:
        """Deliver one step to the callback registered under ``token`` (the
        JAX package's trampoline): steps filtered by ``step % every == 0``,
        strictly increasing (a late or repeated step is dropped), the
        callback called under the lock, latents NHWC in and NCHW out, and a
        callback that raises logged, never raised into the request."""
        step = int(step)
        with self._progress_lock:
            entry = self._progress_registry.get(int(token))
            if entry is None:
                return
            cb, every, state = entry
            if step % every != 0 or step <= state["last"]:
                return
            state["last"] = step
            try:
                lat = None if latents is None else np.asarray(latents).transpose(0, 3, 1, 2)
                cb(step, int(timestep), lat)
            except Exception:
                logger.exception("progress callback failed at step %d", step)

    def cfg_mode(self, guidance_scale) -> str:
        """'wcond' for an LCM UNet (guidance as the w-embedding), else 'cfg'
        when any row's guidance exceeds 1, else 'none'."""
        if self.bundle.unet_cfg.time_cond_proj_dim is not None:
            return "wcond"
        return "cfg" if float(np.max(guidance_scale)) > 1.0 else "none"

    def _micro_cond_ids(self) -> int:
        """SDXL micro-conditioning id count, from the UNet config (its add
        embedding takes pooled_dim + n_ids x addition_time_embed_dim): 6 for
        base models (original size, crop, target size), 5 for the refiner
        (original size, crop, aesthetic score)."""
        b = self.bundle
        cfg = b.unet_cfg
        pooled_dim = (b.text_cfg_2.projection_dim if b.text_cfg_2 is not None
                      else b.text_cfg.projection_dim) or 0
        if cfg.projection_class_embeddings_input_dim and cfg.addition_time_embed_dim:
            return ((cfg.projection_class_embeddings_input_dim - pooled_dim)
                    // cfg.addition_time_embed_dim)
        return 6

    def _time_ids(self, height: int, width: int, bsz: int, aesthetic_score: float = 6.0,
                  cfg_mode: str = "none") -> np.ndarray:
        """SDXL micro-conditioning ids: [B, n], or [2, B, n] in cfg mode with
        row 0 the uncond branch (the negative aesthetic score for refiners,
        diffusers' requires_aesthetics_score convention)."""
        if self._micro_cond_ids() == 5:
            cond = [height, width, 0, 0, aesthetic_score]
            uncond = [height, width, 0, 0, NEGATIVE_AESTHETIC_SCORE]
        else:
            cond = [height, width, 0, 0, height, width]
            uncond = cond
        if cfg_mode == "cfg":
            return np.asarray([[uncond] * bsz, [cond] * bsz], np.float32)
        return np.asarray([cond] * bsz, np.float32)

    def _schedule(self, steps: int, original_steps: Optional[int]) -> LCMSchedule:
        key = (steps, original_steps)
        if key not in self._schedules:
            self._schedules[key] = make_lcm_schedule(
                self.bundle.scheduler_cfg, steps, original_steps)
        return self._schedules[key]

    def _sample_noise(self, seed: int, batch: int, h_lat: int, w_lat: int, steps: int,
                      init_noise_sigma: float) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side NCHW sampling, bit-compatible with the JAX package's seeds."""
        rs = np.random.RandomState(seed & 0x7FFFFFFF)
        c = self.latent_channels
        lat = rs.randn(batch, c, h_lat, w_lat).astype(np.float32)
        lat = lat.transpose(0, 2, 3, 1) * init_noise_sigma
        noises = rs.randn(steps, batch, c, h_lat, w_lat).astype(np.float32)
        noises = noises.transpose(0, 1, 3, 4, 2)
        return np.ascontiguousarray(lat), np.ascontiguousarray(noises)

    def _key_schedule(self, key: BucketKey) -> LCMSchedule:
        """The host schedule a txt2img or segment bucket bakes in: the full
        ladder's, sliced to the key's segment."""
        schedule = self._schedule(key[3], key[6])
        segment = _extras(key).get("segment")
        return schedule if segment is None else slice_schedule(schedule, *segment)

    def _noise_buffers(self, key: BucketKey) -> Dict[str, torch.Tensor]:
        """Uninitialised lat0 [B, h, w, C] and noises [S, B, h, w, C] for a
        bucket whose noise is drawn on the device."""
        batch, h_lat, w_lat, steps = key[:4]
        c = self.latent_channels
        return {"lat0": torch.empty((batch, h_lat, w_lat, c), device=self.device),
                "noises": torch.empty((steps, batch, h_lat, w_lat, c), device=self.device)}

    # ------------------------------------------------------------------
    # the bucket's program: device tensors in, images and latents out
    # ------------------------------------------------------------------

    def _encode(self, ids, ids_2=None):
        """Text conditioning of token ids: (context [B, 77, C], pooled [B, P]
        or None)."""
        b = self.bundle
        if b.arch != "sdxl":
            return clip_text.encode_text(self.text_params, ids, b.text_cfg)[0], None
        if self.text_params_2 is None:
            # refiner layout: the one bigG tower gives the context and the
            # projected pooled embedding of the micro-conditioning
            return clip_text.encode_text(self.text_params, ids, b.text_cfg)
        seq1, _ = clip_text.encode_text(self.text_params, ids, b.text_cfg)
        seq2, pooled = clip_text.encode_text(self.text_params_2, ids_2, b.text_cfg_2)
        return torch.cat([seq1, seq2], dim=-1), pooled

    def _encode_x0(self, image, eps_post):
        """The init image's latent: a sample of the encoder's posterior,
        times the scaling factor (the JAX package's ``encode_x0``)."""
        cfg, c = self.bundle.vae_cfg, self.latent_channels
        moments = vae.encode_moments(self.vae_encoder_params, cfg, image)
        mean, logvar = moments[..., :c], moments[..., c:].clamp(-30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * eps_post) * cfg.scaling_factor

    def _decode(self, latents):
        """VAE decode, tiled when the latent's longer side exceeds the chunk."""
        b = self.bundle
        if self._vae_chunk is not None and max(latents.shape[1:3]) > self._vae_chunk:
            return vae.decode_tiled(self.vae_params, b.vae_cfg, latents, tile=self._vae_tile,
                                    overlap=max(self._vae_tile // 4, 1))
        return vae.decode(self.vae_params, b.vae_cfg, latents)

    def _program(self, key: BucketKey, x: Dict[str, torch.Tensor],
                 progress: Optional[Callable] = None):
        """Encode, denoise and decode one bucket's batch from its inputs
        ``x`` (see ``_stage``, ``_stage_img2img``); returns (uint8 images
        [B, H, W, 3], fp32 denoised latents [B, h, w, C]) on the device, or
        for a segment that ends early (task "latent") its fp32 carry and
        denoised latents, undecoded. ``progress(i, latents)`` is called
        after each step of a progress bucket. Reads its inputs and never
        writes them, so a captured graph can replay it."""
        _, _, _, _, mode, _, _, task = key[:8]
        cn_cfg = _extras(key).get("ctrl")
        b = self.bundle
        dev = self.device
        if task in ("txt2img", "latent"):
            schedule = self._key_schedule(key)
            timestep = lambda i: torch.full((rows,), int(schedule.timesteps[i]),
                                            dtype=torch.int32, device=dev)
        else:  # the strength-truncated schedule is an input
            schedule = schedule_on(x)
            timestep = lambda i: schedule.timesteps[i].expand(rows)
        ctx, pooled = self._encode(x["ids"], x.get("ids_2"))
        kw = {}
        if mode == "wcond":
            kw["timestep_cond"] = x["w_emb"]
        if mode == "cfg":
            ctx_neg, pooled_neg = self._encode(x["ids_neg"], x.get("ids_2_neg"))
            ctx = torch.cat([ctx_neg, ctx])
            g = x["guidance"].reshape(-1, 1, 1, 1)
        if b.arch == "sdxl":
            if mode == "cfg":  # the uncond rows, then the cond rows
                pooled = torch.cat([pooled_neg, pooled])
            kw.update(added_text_embeds=pooled, added_time_ids=x["time_ids"])
        rows = ctx.shape[0]
        if cn_cfg is not None:
            # the hint's embedding does not depend on the latents: once per request
            cn = self.controlnet_params
            cond_emb = controlnet.embed_cond(cn["cond_embedding"], x["hint"])
            if mode == "cfg":
                cond_emb = torch.cat([cond_emb, cond_emb])
            # a ControlNet reads the w-embedding and the micro-conditioning
            # only where its own config has them (SD1.5 nets have no cond_proj)
            cn_kw = {}
            if cn_cfg.time_cond_proj_dim is not None and "timestep_cond" in kw:
                cn_kw["timestep_cond"] = kw["timestep_cond"]
            if cn_cfg.addition_embed_type == "text_time":
                cn_kw.update(added_text_embeds=kw["added_text_embeds"],
                             added_time_ids=kw["added_time_ids"])
        noises = x["noises"]
        if task in ("txt2img", "latent"):
            lat = x["lat0"]
        else:  # renoise the init image to the ladder's first timestep
            x0 = self._encode_x0(x["image"], x["eps_post"])
            lat = schedule.sqrt_alpha_prod[0] * x0 + schedule.sqrt_beta_prod[0] * x["noise0"]
        for i in range(schedule.num_steps):
            xin = torch.cat([lat, lat]) if mode == "cfg" else lat
            t = timestep(i)
            taps = {}
            if cn_cfg is not None:
                down, mid = controlnet.forward(cn, cn_cfg, xin, t, ctx, cond_emb,
                                               conditioning_scale=x["ctrl_scale"], **cn_kw)
                taps = {"down_residuals": down, "mid_residual": mid}
            noise_pred = unet.forward(self.unet_params, b.unet_cfg, xin, t, ctx, **kw, **taps,
                                      tp=self._tp)
            if mode == "cfg":
                uncond, cond = noise_pred.chunk(2)
                noise_pred = uncond + g * (cond - uncond)
            lat, denoised = lcm_step(schedule, i, noise_pred, lat, noises[i],
                                     prediction_type=b.scheduler_cfg.prediction_type)
            if task == "inpaint":  # the known region, renoised to the next timestep
                known = (schedule.sqrt_alpha_prod_prev[i] * x0
                         + schedule.sqrt_beta_prod_prev[i] * x["noises_known"][i])
                lat = x["mask_lat"] * lat + (1.0 - x["mask_lat"]) * known
            if progress is not None:
                progress(i, lat)
        if task == "latent":  # the carry goes to the next segment, undecoded
            return lat, denoised
        if task == "inpaint":
            denoised = x["mask_lat"] * denoised + (1.0 - x["mask_lat"]) * x0
        img = self._decode(denoised / b.vae_cfg.scaling_factor)
        img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8), denoised

    def _get_compiled(self, staged: _Staged):
        """The program of ``staged``'s bucket: captured on its first request
        on the card (no eager fallback: a failed capture raises), the eager
        function on the CPU and where ``graphs`` is off (collectives over a
        host group)."""
        program = self._compiled.get(staged.key)
        if program is None:
            if self.graphs:
                program = _GraphProgram(self, staged)
                logger.info("captured bucket %s in %.2fs (+%d bytes reserved)", staged.key,
                            program.capture_s, program.reserved_bytes)
            else:
                program = _EagerProgram(staged.key)
            self._compiled[staged.key] = program
        return program

    # ------------------------------------------------------------------
    # staging and the public API
    # ------------------------------------------------------------------

    def _conditioning(self, prompts, guidance_scale, negative_prompt, height: int, width: int,
                      aesthetic_score: float) -> Tuple[str, Dict[str, np.ndarray]]:
        """(guidance mode, the program's text and guidance inputs) of a batch
        of prompts: token ids (the negatives' in cfg mode), per-row guidance
        or its w-embedding, SDXL's micro-conditioning ids."""
        b = self.bundle
        bsz = len(prompts)
        gs = np.asarray(guidance_scale, np.float32).reshape(-1)
        if gs.size == 1:
            gs = np.full((bsz,), float(gs[0]), np.float32)
        elif gs.size != bsz:
            raise ValueError(f"guidance_scale has {gs.size} entries for batch {bsz}")
        mode = self.cfg_mode(gs)
        neg = negative_prompt
        negs = [""] * bsz if neg is None else [neg] * bsz if isinstance(neg, str) else list(neg)
        if len(negs) != bsz:
            raise ValueError(f"negative_prompt has {len(negs)} entries for batch {bsz}")

        def tokens(tok, texts):
            return np.asarray(tok(texts), np.int64)

        inputs = {"ids": tokens(b.tokenizer, prompts)}
        if mode == "cfg":
            inputs["ids_neg"] = tokens(b.tokenizer, negs)
            inputs["guidance"] = gs
        if b.arch == "sdxl" and self.text_params_2 is not None:
            inputs["ids_2"] = tokens(b.tokenizer_2, prompts)
            if mode == "cfg":
                inputs["ids_2_neg"] = tokens(b.tokenizer_2, negs)
        if mode == "wcond":
            inputs["w_emb"] = guidance_scale_embedding(gs - 1.0, b.unet_cfg.time_cond_proj_dim)
        if b.arch == "sdxl":
            time_ids = self._time_ids(height, width, bsz, aesthetic_score, cfg_mode=mode)
            if mode == "cfg":  # [2, B, n] -> the uncond rows, then the cond rows
                time_ids = np.concatenate([time_ids[0], time_ids[1]])
            inputs["time_ids"] = time_ids
        return mode, inputs

    @_staging
    def _stage(self, prompt, *, height: int = 512, width: int = 512,
               num_inference_steps: int = 4,
               original_inference_steps: Optional[int] = None,
               guidance_scale: Any = 1.0, negative_prompt: Any = None,
               seed: Optional[int] = None, batch: Optional[int] = None,
               latents: Optional[np.ndarray] = None,
               step_noises: Optional[np.ndarray] = None,
               rng: Optional[str] = None, aesthetic_score: float = 6.0,
               control_image: Optional[np.ndarray] = None, controlnet_scale: float = 1.0,
               segment: Optional[Tuple[int, int]] = None,
               latents_state: Optional[torch.Tensor] = None,
               progress: str = "none") -> _Staged:
        """Host staging of one txt2img request (``generate``'s arguments;
        ``progress``: "none", "steps" or "latents")."""
        divisor = self.vae_scale * 2 ** (self.bundle.unet_cfg.num_blocks - 1)
        if height % divisor or width % divisor:
            raise ValueError(f"height/width must be multiples of {divisor} "
                             f"(got {width}x{height})")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if batch is not None and len(prompts) == 1:
            prompts = prompts * batch
        bsz = len(prompts)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        mode, cond = self._conditioning(prompts, guidance_scale, negative_prompt, height, width,
                                        aesthetic_score)

        start, stop = segment or (0, num_inference_steps)
        if segment is not None and not 0 <= start < stop <= num_inference_steps:
            raise ValueError(f"segment {segment} out of range for {num_inference_steps} steps")
        if (segment is not None or latents_state is not None) and (
                (start > 0) != (latents_state is not None)):
            raise ValueError("segments starting after 0 require latents_state (and only they "
                             "may pass one)")
        if segment is not None and (latents is not None or step_noises is not None):
            raise ValueError("segment is incompatible with explicit latents/step_noises")
        rng_mode = rng or os.environ.get("DREAMLAB_RNG", "host")
        if rng_mode not in ("host", "device"):
            raise ValueError(f"unknown rng mode {rng_mode!r} (host | device)")
        if latents is not None or step_noises is not None or segment is not None:
            rng_mode = "host"  # explicit noise and segments force the host path
        schedule = self._schedule(num_inference_steps, original_inference_steps)
        h_lat, w_lat = height // self.vae_scale, width // self.vae_scale
        c = self.latent_channels
        inputs: Dict[str, Any] = {}
        if rng_mode == "host":
            lat0, noises = self._sample_noise(seed, bsz, h_lat, w_lat, num_inference_steps,
                                              schedule.init_noise_sigma)
            noises = noises[start:stop]  # a segment's noise: the full run's stream
            if latents_state is not None:
                # the previous segment's fp32 carry, on the device (a data
                # rank's: its rows)
                lat0 = latents_state
                rows = self._data_rows(bsz) or slice(0, bsz)
                if tuple(lat0.shape) != (rows.stop - rows.start, h_lat, w_lat, c):
                    raise ValueError(f"unexpected latents_state shape {tuple(lat0.shape)}")
            if latents is not None:
                # provided latents are raw noise, scaled by init sigma
                lat0 = np.asarray(latents, np.float32) * schedule.init_noise_sigma
                if lat0.shape != (bsz, h_lat, w_lat, c):
                    raise ValueError(f"unexpected latents shape {lat0.shape}")
            if step_noises is not None:
                noises = np.asarray(step_noises, np.float32)
                want = (num_inference_steps, bsz, h_lat, w_lat, c)
                if noises.shape != want:
                    raise ValueError(f"unexpected step_noises shape {noises.shape}; "
                                     f"want {want}")
            inputs.update(lat0=lat0 if latents_state is not None
                          else np.ascontiguousarray(lat0, np.float32),
                          noises=np.ascontiguousarray(noises, np.float32))
        inputs.update(cond)
        if control_image is not None:
            inputs.update(hint=self._hint(control_image, bsz, height, width),
                          ctrl_scale=np.asarray(controlnet_scale, np.float32))
        extras = []
        if (start, stop) != (0, num_inference_steps):
            extras.append(("segment", (start, stop)))
        if progress != "none":
            extras.append(("progress", progress))
        if control_image is not None:
            extras.append(("ctrl", self.controlnet_cfg))
        task = "latent" if stop < num_inference_steps else "txt2img"
        key = (bsz, h_lat, w_lat, num_inference_steps, mode, rng_mode,
               original_inference_steps, task, *extras)
        return self._shard_rows(_Staged(key=key, inputs=inputs, seed=seed,
                                        init_noise_sigma=float(schedule.init_noise_sigma)))

    def _hint(self, control_image, bsz: int, height: int, width: int) -> np.ndarray:
        """A ControlNet hint as the program takes it: [B, H, W, 3] fp32 in
        [0, 1] at the output size (integer pixels / 255, one hint broadcast
        over the batch), as the JAX package prepares it."""
        if self.controlnet_params is None:
            raise ValueError("control_image given but no ControlNet is attached "
                             "(set_controlnet)")
        hint = np.asarray(control_image)
        if hint.ndim == 3:
            hint = hint[None]
        if np.issubdtype(hint.dtype, np.integer):
            hint = hint.astype(np.float32) / 255.0
        if hint.shape[1:3] != (height, width):
            raise ValueError(f"control_image dims {hint.shape[1:3]} != output "
                             f"{(height, width)}: resize the hint to the output size")
        if hint.shape[0] == 1 and bsz > 1:
            hint = np.broadcast_to(hint, (bsz,) + hint.shape[1:])
        if hint.shape[0] != bsz:
            raise ValueError(f"control_image has {hint.shape[0]} rows for batch {bsz}")
        return np.ascontiguousarray(hint, np.float32)

    @_staging
    def _stage_img2img(self, prompt, init_image, *, mask: Optional[np.ndarray] = None,
                       strength: float = 0.5, aesthetic_score: float = 6.0,
                       num_inference_steps: int = 4,
                       original_inference_steps: Optional[int] = None,
                       guidance_scale: Any = 1.0, negative_prompt: Any = None,
                       seed: Optional[int] = None) -> _Staged:
        """Host staging of one img2img or inpaint request (``img2img``'s
        arguments), draw for draw the JAX package's: one RandomState of the
        seed gives the posterior sample, the renoising noise, the step noises
        and, for inpainting, the known region's step noises, in NCHW."""
        if self.vae_encoder_params is None:
            raise ValueError("checkpoint has no VAE encoder weights")
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        img = np.asarray(init_image)
        if img.ndim == 3:
            img = img[None]
        bsz, height, width, _ = img.shape
        divisor = self.vae_scale * 2 ** (self.bundle.unet_cfg.num_blocks - 1)
        if height % divisor or width % divisor:
            raise ValueError(f"image dims must be multiples of {divisor}")
        prompts = [prompt] * bsz if isinstance(prompt, str) else list(prompt)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        mode, cond = self._conditioning(prompts, guidance_scale, negative_prompt, height, width,
                                        aesthetic_score)
        # built per request: the programs take it as device inputs, and the
        # strength is the user's float
        schedule = make_lcm_schedule(self.bundle.scheduler_cfg, num_inference_steps,
                                     original_inference_steps, strength)
        h_lat, w_lat = height // self.vae_scale, width // self.vae_scale
        rs = np.random.RandomState(seed & 0x7FFFFFFF)
        shape = (bsz, self.latent_channels, h_lat, w_lat)
        steps_shape = (num_inference_steps, *shape)
        nhwc = lambda a: np.ascontiguousarray(a.astype(np.float32).transpose(0, 2, 3, 1))
        nshwc = lambda a: np.ascontiguousarray(a.astype(np.float32).transpose(0, 1, 3, 4, 2))
        inputs = {"eps_post": nhwc(rs.randn(*shape)), "noise0": nhwc(rs.randn(*shape)),
                  "noises": nshwc(rs.randn(*steps_shape)),
                  "image": np.ascontiguousarray((img.astype(np.float32) / 255.0) * 2.0 - 1.0)}
        task = "img2img"
        if mask is not None:
            task = "inpaint"
            m = np.asarray(mask, np.float32)
            if m.ndim == 3:
                m = m[..., 0]
            if m.shape != (height, width):
                raise ValueError(f"mask shape {m.shape} != image dims {(height, width)}")
            # any repainted pixel in a latent cell marks the cell for regeneration
            s = self.vae_scale
            m_lat = (m > 0).astype(np.float32).reshape(h_lat, s, w_lat, s).max(axis=(1, 3))
            inputs["mask_lat"] = np.repeat(m_lat[None, :, :, None], bsz, axis=0)
            inputs["noises_known"] = nshwc(rs.randn(*steps_shape))
        inputs.update(cond)
        inputs.update({name: np.ascontiguousarray(getattr(schedule, name))
                       for name in SCHEDULE_FIELDS})
        key = (bsz, h_lat, w_lat, num_inference_steps, mode, "host",
               original_inference_steps, task)
        return self._shard_rows(_Staged(key=key, inputs=inputs, seed=seed,
                                        init_noise_sigma=float(schedule.init_noise_sigma)))

    def warmup(self, height: int, width: int, steps: int = 4, batch: int = 1,
               rng: Optional[str] = None) -> Dict[str, Any]:
        """Capture a bucket ahead of its first request (on the CPU: create
        its eager program). Returns the bucket key, the seconds the call
        took and, on the card, the capture's seconds and reserved bytes."""
        t0 = time.perf_counter()
        staged = self._stage("warmup", height=height, width=width,
                             num_inference_steps=steps, seed=0, batch=batch, rng=rng)
        with self._lock:
            program = self._get_compiled(staged)
            program(self, staged).wait()
        out = {"key": staged.key, "seconds": time.perf_counter() - t0,
               "capture_s": getattr(program, "capture_s", None),
               "reserved_bytes": getattr(program, "reserved_bytes", None)}
        logger.info("warmup %dx%dx%d steps=%d in %.1fs", batch, height, width, steps,
                    out["seconds"])
        return out

    def _profile_inputs(self, height: int, width: int, batch: int):
        """``profile_stages``' inputs on the device, seeded as the JAX
        package's: token ids [B, 77], fp32 latents [B, h, w, C], timesteps
        999, a random context [B, 77, Cc] and zero conditioning (the
        w-embedding, or SDXL's pooled embedding and ids) for the UNet."""
        b, dev = self.bundle, self.device
        rs = np.random.RandomState(0)
        h_lat, w_lat = height // self.vae_scale, width // self.vae_scale
        ids = torch.from_numpy(np.asarray(b.tokenizer(["profile"] * batch), np.int64)).to(dev)
        lat = torch.from_numpy(rs.randn(batch, h_lat, w_lat, self.latent_channels)
                               .astype(np.float32)).to(dev)
        ctx = torch.from_numpy(rs.randn(batch, 77, b.unet_cfg.cross_attention_dim)
                               .astype(np.float32)).to(dev)
        t = torch.full((batch,), 999, dtype=torch.int32, device=dev)
        kw = {}
        if b.unet_cfg.time_cond_proj_dim:
            kw["timestep_cond"] = torch.zeros((batch, b.unet_cfg.time_cond_proj_dim),
                                              device=dev)
        if b.unet_cfg.addition_embed_type:
            n_ids = self._micro_cond_ids()
            pooled_dim = (b.unet_cfg.projection_class_embeddings_input_dim
                          - n_ids * b.unet_cfg.addition_time_embed_dim)
            kw["added_text_embeds"] = torch.zeros((batch, pooled_dim), device=dev)
            kw["added_time_ids"] = torch.zeros((batch, n_ids), device=dev)
        return ids, lat, t, ctx, kw

    def profile_stages(self, *, height: int = 512, width: int = 512, steps: int = 4,
                       batch: int = 1, iters: int = 5) -> Dict[str, float]:
        """Per-stage wall-clock breakdown in ms (the JAX package's
        ``profile_stages``, the reference's built-in profiler contract): the
        first tower's text encode, one UNet call and the VAE decode, each
        run eagerly on seeded inputs, once to warm up, then ``iters`` times
        between two device synchronizations; ``denoise_loop_ms`` is
        ``unet_step_ms`` x ``steps``. A request runs the three inside one
        captured graph: this is for diagnosis, not serving."""
        b, dev = self.bundle, self.device
        ids, lat, t, ctx, kw = self._profile_inputs(height, width, batch)
        stages = {
            "text_encode": lambda: clip_text.encode_text(self.text_params, ids, b.text_cfg)[0],
            "unet_step": lambda: unet.forward(self.unet_params, b.unet_cfg, lat, t, ctx, **kw,
                                              tp=self._tp),
            "vae_decode": lambda: vae.decode(self.vae_params, b.vae_cfg, lat),
        }
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        out: Dict[str, float] = {}
        with self._lock, torch.inference_mode(), device_lock(dev).shared():
            for name, fn in stages.items():
                fn()
                sync()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                sync()
                out[name + "_ms"] = 1e3 * (time.perf_counter() - t0) / iters
        out["denoise_loop_ms"] = out["unet_step_ms"] * steps
        return out

    def generate(self, prompt, *, height: int = 512, width: int = 512,
                 num_inference_steps: int = 4,
                 original_inference_steps: Optional[int] = None,
                 guidance_scale: Any = 1.0, negative_prompt: Any = None,
                 seed: Optional[int] = None, batch: Optional[int] = None,
                 latents: Optional[np.ndarray] = None,
                 step_noises: Optional[np.ndarray] = None,
                 rng: Optional[str] = None,
                 aesthetic_score: float = 6.0,
                 callback: Optional[Callable] = None, callback_steps: int = 1,
                 callback_latents: bool = True,
                 control_image: Optional[np.ndarray] = None, controlnet_scale: float = 1.0,
                 segment: Optional[Tuple[int, int]] = None,
                 latents_state: Optional[torch.Tensor] = None,
                 pipelined: bool = False) -> GenerationResult:
        """Generate images: uint8 [B, H, W, 3] plus the final latents.

        guidance_scale: a scalar or one value per row; it picks the guidance
        mode (``cfg_mode``) and weighs each row. negative_prompt: None (""),
        one string, or one per row; read in cfg mode only. latents /
        step_noises: explicit raw initial noise [B, h, w, 4] and per-step
        noise [S, B, h, w, 4] (the worker's coalesced batches give each row
        its own seed's noise); either forces host noise. rng: "host" or
        "device" (None reads ``DREAMLAB_RNG``, default "host").
        aesthetic_score: the refiner's micro-conditioning.

        callback: ``callback(step, timestep, latents)`` after every
        ``callback_steps``-th step (steps strictly increasing; latents NCHW
        numpy, or None with ``callback_latents=False``); a callback that
        raises is logged and generation goes on. control_image: a hint
        [H, W, 3] (or [B, H, W, 3]) at the output size, uint8 or float in
        [0, 1], for the attached ControlNet (``set_controlnet``), its taps
        times ``controlnet_scale``. segment: run steps [start, stop) of the
        ``num_inference_steps`` ladder; one that ends early returns its
        carry in ``result.state_device`` (a device tensor; no decode, no
        host copy, ``images`` and ``latents`` None), one that starts after
        0 takes the previous segment's as ``latents_state``. Segments draw
        the full run's host noise stream.

        pipelined: return once the work is queued; ``result.wait()`` blocks
        until the images and latents are on the host (ignored, as in the
        JAX package, where a callback makes the call synchronous, and where
        data ranks gather their rows).

        On the card the request replays its bucket's CUDA graph, captured on
        the bucket's first request (or by ``warmup``); a failed capture or
        replay raises.
        """
        return self._generate(
            prompt, False, callback, callback_steps, callback_latents, pipelined, height=height,
            width=width, num_inference_steps=num_inference_steps,
            original_inference_steps=original_inference_steps,
            guidance_scale=guidance_scale, negative_prompt=negative_prompt, seed=seed,
            batch=batch, latents=latents, step_noises=step_noises, rng=rng,
            aesthetic_score=aesthetic_score, control_image=control_image,
            controlnet_scale=controlnet_scale, segment=segment, latents_state=latents_state)

    def _generate(self, prompt, eager: bool, callback: Optional[Callable] = None,
                  callback_steps: int = 1, callback_latents: bool = True,
                  pipelined: bool = False, **kwargs) -> GenerationResult:
        """``generate`` through the bucket's program, or with ``eager`` its
        function run eagerly; a callback is registered for the call only."""
        progress = "none" if callback is None else "latents" if callback_latents else "steps"
        staged = self._stage(prompt, progress=progress, **kwargs)
        if callback is not None:
            pipelined = False  # a callback makes the call synchronous
            staged.progress_token = next(self._progress_tokens)
            with self._progress_lock:
                self._progress_registry[staged.progress_token] = (
                    callback, max(1, callback_steps), {"last": -1})
        try:
            with self._lock:
                program = _EagerProgram(staged.key) if eager else self._get_compiled(staged)
                res = program(self, staged)
        finally:
            if callback is not None:
                with self._progress_lock:
                    self._progress_registry.pop(staged.progress_token, None)
        return self._gathered(staged, res if pipelined else res.wait())

    def img2img(self, prompt, init_image: np.ndarray, *, mask: Optional[np.ndarray] = None,
                strength: float = 0.5, aesthetic_score: float = 6.0,
                num_inference_steps: int = 4, original_inference_steps: Optional[int] = None,
                guidance_scale: Any = 1.0, negative_prompt: Any = None,
                seed: Optional[int] = None) -> GenerationResult:
        """Image to image: VAE-encode, renoise to the strength-truncated LCM
        ladder, denoise, decode; one program per bucket, as ``generate``.

        init_image: [H, W, 3] uint8 (or [B, H, W, 3]); H and W set the output
        size and follow ``generate``'s divisibility rule. strength in (0, 1]:
        the share of the trained ladder to traverse (diffusers' img2img
        semantics); 1.0 is about txt2img's noise. mask: [H, W] or [H, W, 1],
        nonzero = regenerate there (legacy inpainting, ``inpaint``).
        """
        staged = self._stage_img2img(
            prompt, init_image, mask=mask, strength=strength, aesthetic_score=aesthetic_score,
            num_inference_steps=num_inference_steps,
            original_inference_steps=original_inference_steps, guidance_scale=guidance_scale,
            negative_prompt=negative_prompt, seed=seed)
        with self._lock:
            res = self._get_compiled(staged)(self, staged)
        return self._gathered(staged, res.wait())

    def inpaint(self, prompt, init_image: np.ndarray, mask: np.ndarray, *,
                strength: float = 1.0, **kwargs) -> GenerationResult:
        """Legacy inpainting: ``img2img`` with the unmasked region blended
        back at each step, renoised to the next timestep. mask: [H, W] or
        [H, W, 1]; nonzero = regenerate that region."""
        return self.img2img(prompt, init_image, mask=mask, strength=strength, **kwargs)

    def _generate_eager(self, prompt, *, callback: Optional[Callable] = None,
                        callback_steps: int = 1, callback_latents: bool = True,
                        **kwargs) -> GenerationResult:
        """``generate`` without the bucket's graph: the same program run
        eagerly (the before/after comparison of ``chip_smoke.py``)."""
        return self._generate(prompt, True, callback, callback_steps, callback_latents,
                              **kwargs)

    def _img2img_eager(self, prompt, init_image, **kwargs) -> GenerationResult:
        """``img2img`` without the bucket's graph (``_generate_eager``'s twin)."""
        staged = self._stage_img2img(prompt, init_image, **kwargs)
        return self._gathered(staged, _EagerProgram(staged.key)(self, staged).wait())
