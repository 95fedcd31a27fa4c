"""Multi-rank serving router: HTTP on rank 0, the same calls on every rank
(port of ``dreamlab_tpu/parallel/multihost_router.py``).

The JAX package runs one controller process per TPU host; the port runs one
process (rank) per GPU. Either way the REST server runs on rank 0 only and
every accepted pipeline call is broadcast to all ranks, so each executes
the same call on its own device over the ("data", "model") mesh: a data
rank on its rows, a model rank on its slices of the UNet, with the
collectives the pipeline makes (``pipeline.py``, ``parallel/sharding.py``).
A meshed pipeline gathers the data ranks' rows itself, so every rank's
result holds the whole batch and rank 0 answers the request from its own.

Wire protocol (``torch.distributed`` collectives on a gloo control group,
so request bytes never touch a device, whatever the compute runs on):

1. ``[length]`` int64 broadcast of a CPU tensor; 0 is the shutdown sentinel;
2. ``[length]``-byte uint8 broadcast carrying a typed JSON message (numpy
   arrays: explicit latents, step noises, ControlNet hints, img2img inputs,
   ride base64-encoded, recursively):
   - ``{"op": "call", "pipe": id, "method": m, "kw": {...}}``: generate /
     img2img / inpaint / warmup on the pipe registered under ``id``;
   - ``{"op": "lora", "pipe": id, "path": p, "scale": s}``: every rank
     merges the same LoRA file into its own weights (``path=None``
     restores them);
   - ``{"op": "build", "pipe": id, "spec": {...}}`` and ``{"op": "drop",
     "pipe": id}``: every rank builds the same worker (the router's
     ``builder``, which the server sets) or drops its pipes, so a mode
     switch on rank 0 happens on every rank;
3. the call itself, with its collectives;
4. a vote (an all-gather of one flag per rank) after a merge or a build:
   a failure on any rank undoes it on every rank and raises on rank 0.

Every rank builds from the same checkpoint, draws host noise from the
request's seed (rank 0 fixes a missing seed before the broadcast) and
merges the same LoRA file, so no weight bytes cross between ranks.

Beyond plain txt2img, as in the JAX router: ControlNet hints (arrays in the
message), segments (each rank keeps its own carry, ``router.last_carry``;
rank 0 checks by identity that the caller hands back the carry it just
produced), progress with ``callback_latents=False`` (followers register a
no-op with the same ``callback_steps``, so the ("progress", "steps") bucket
is the same on every rank), img2img and inpainting. A raw ``unet_params``
write would change rank 0's weights only, so ``RouterPipeline`` refuses it
and offers ``apply_lora``, which the worker prefers when present. Rank 0
serializes broadcasts and their calls (one lock), so the pool's thread and
a background warm-up never interleave their collectives.
"""

from __future__ import annotations

import base64
import datetime
import json
import logging
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import lora
from ..pipeline import device_lock

logger = logging.getLogger(__name__)


def _encode_value(v):
    if isinstance(v, np.ndarray):
        return {
            "__nd__": True,
            "dtype": str(v.dtype),
            "shape": list(v.shape),
            "b64": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode(),
        }
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    return v


def _decode_value(v):
    if isinstance(v, dict) and v.get("__nd__"):
        return np.frombuffer(
            base64.b64decode(v["b64"]), dtype=np.dtype(v["dtype"])
        ).reshape(v["shape"]).copy()
    if isinstance(v, dict):
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


class MultihostRouter:
    """Length-prefixed JSON broadcast from rank 0 over a gloo control group
    of the whole world. Every rank constructs one, in the same order as its
    other groups (a group's creation is a collective)."""

    def __init__(self, timeout: float = 600.0):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.is_primary = self.rank == 0
        self._control = dist.new_group(backend="gloo",
                                       timeout=datetime.timedelta(seconds=timeout))
        # pipe_id -> RouterPipeline (every rank registers the same set)
        self.pipes: Dict[str, "RouterPipeline"] = {}
        # this rank's carry from the last segment that ended early
        self.last_carry: Any = None
        # (router, pipe_id, spec) -> what a "build" message builds (the server's modes)
        self.builder: Optional[Callable[["MultihostRouter", str, dict], Any]] = None
        # rank 0: one broadcast and its call at a time
        self._lock = threading.RLock()

    # -- byte channel ------------------------------------------------------
    def _bcast_bytes(self, data: Optional[bytes]) -> bytes:
        n = torch.zeros((1,), dtype=torch.int64)
        if self.is_primary and data is not None:
            n[0] = len(data)
        dist.broadcast(n, src=0, group=self._control)
        length = int(n[0])
        if length == 0:
            return b""
        if self.is_primary:
            buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        else:
            buf = torch.empty((length,), dtype=torch.uint8)
        dist.broadcast(buf, src=0, group=self._control)
        return buf.numpy().tobytes()

    # -- message channel ---------------------------------------------------
    def broadcast_message(self, msg: Optional[Dict[str, Any]]) -> None:
        """Rank 0: publish a typed message (None = shutdown sentinel)."""
        if not self.is_primary:
            raise RuntimeError("only rank 0 broadcasts")
        data = None
        if msg is not None:
            data = json.dumps(_encode_value(msg)).encode()
        self._bcast_bytes(data)

    def recv_message(self) -> Optional[Dict[str, Any]]:
        """Followers: block until the next message; None on shutdown."""
        if self.is_primary:
            raise RuntimeError("rank 0 does not receive")
        data = self._bcast_bytes(None)
        if not data:
            return None
        return _decode_value(json.loads(data))

    def vote(self, ok: bool) -> int:
        """All-gather one flag per rank; returns how many ranks failed."""
        flags = [torch.zeros((1,), dtype=torch.int32) for _ in range(self.world)]
        dist.all_gather(flags, torch.tensor([int(ok)], dtype=torch.int32), group=self._control)
        return sum(1 for f in flags if not int(f[0]))

    # -- builds ------------------------------------------------------------
    def build(self, pipe_id: str, spec: dict):
        """Rank 0: build ``spec`` with ``builder`` on every rank (its
        pipelines registered under ``pipe_id``); a build that fails on any
        rank is dropped on all of them and raises here."""
        with self._lock:
            self.broadcast_message({"op": "build", "pipe": pipe_id, "spec": spec})
            return self._build(pipe_id, spec)

    def _build(self, pipe_id: str, spec: dict):
        built, error = None, None
        try:
            built = self.builder(self, pipe_id, spec)
        except Exception as e:
            logger.exception("building %s failed on rank %d", pipe_id, self.rank)
            error = e
        failed = self.vote(error is None)
        if failed:
            for pid in [p for p in self.pipes if p == pipe_id or p.startswith(pipe_id + "/")]:
                self.pipes.pop(pid)._pipe.release_graphs()
            close = getattr(built, "close", None)
            if close is not None:
                close()
            raise RuntimeError(f"building {pipe_id!r} failed on {failed}/{self.world} "
                               "rank(s); dropped on every rank") from error
        return built

    # -- follower loop -----------------------------------------------------
    def serve_follower(self) -> int:
        """The loop of ranks 1..N-1: replay broadcast messages until the
        shutdown sentinel; returns the number of messages served.

        Error policy, per op:

        - ``call``: caught and logged. A request that fails argument
          validation (bad strength, missing ControlNet, ...) raises the same
          exception on every rank before any collective; rank 0 answers 4xx
          and keeps serving, so followers keep serving too. (A failure
          inside a collective is not survivable either way: that is a
          runtime fault, not a request fault.)
        - ``lora`` and ``build``: they vote across the ranks; a partial
          failure undoes the merge or the build on every rank, and the error
          is caught here like a call error.
        - ``drop``: the pipe's graphs go, on every rank.
        - unknown ops are fatal: rank 0 executed something this rank does
          not understand (version skew), so continuing would silently
          desynchronize state."""
        served = 0
        while True:
            msg = self.recv_message()
            if msg is None:
                return served
            op = msg.get("op")
            if op not in ("call", "lora", "build", "drop"):
                raise ValueError(f"unknown router op {op!r}: rank version skew?")
            try:
                if op == "build":
                    self._build(msg["pipe"], msg["spec"])
                else:
                    pipe = self.pipes[msg.get("pipe", "base")]
                    if op == "call":
                        pipe._execute(msg["method"], msg["kw"], progress=msg.get("progress"),
                                      carry=bool(msg.get("carry")))
                    elif op == "lora":
                        pipe._apply_lora_sync(msg["path"], msg["scale"])
                    else:
                        pipe._drop()
            except Exception:
                logger.exception("follower: message %s failed (rank 0 fails the same "
                                 "request; weights stay consistent; continuing)", op)
            served += 1


class RouterPipeline:
    """LCMPipeline facade for multi-rank serving.

    Rank 0 wraps each pipeline in one of these and hands it to the ordinary
    serving stack (``CudaPipelineWorker`` / ``WorkerPool`` / ``create_app``).
    ``generate()`` / ``img2img()`` / ``inpaint()`` / ``warmup()`` broadcast
    the call before executing it, so followers running ``serve_follower``
    stay in lockstep. An ensemble constructs one facade per model (the
    refiner under ``pipe_id + "/refiner"``) over the same router.
    """

    def __init__(self, pipe, router: MultihostRouter, pipe_id: str = "base"):
        if pipe_id in router.pipes:
            raise ValueError(f"duplicate router pipe id {pipe_id!r}")
        object.__setattr__(self, "_pipe", pipe)
        object.__setattr__(self, "_router", router)
        object.__setattr__(self, "_pipe_id", pipe_id)
        object.__setattr__(self, "_lora_cache", {})  # path -> LoRATensors
        object.__setattr__(self, "_base", {})  # leaf path -> its unstyled value
        object.__setattr__(self, "_active_paths", ())  # the leaves the merge wrote
        object.__setattr__(self, "_active_lora", None)  # (path, scale) merged
        router.pipes[pipe_id] = self

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    # a style written into rank 0's weights only would leave the followers
    # running other weights, silently corrupting every row or slice they
    # own: refuse the raw write; apply_lora() replays the merge on every rank
    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif name == "unet_params":
            raise ValueError(
                "multi-rank serving cannot hot-swap raw weights: the write "
                "would apply on rank 0 only and diverge from the other "
                "ranks; use apply_lora(path, scale) instead")
        else:
            setattr(self._pipe, name, value)

    # -- LoRA styles -------------------------------------------------------
    def apply_lora(self, path: Optional[str], scale: float = 1.0) -> None:
        """Merge LoRA ``path`` at ``scale`` into the UNet weights on every
        rank (None restores the base). Each rank computes the same merge
        from the same file; a tensor-parallel rank writes its slice."""
        with self._router._lock:
            if self._router.is_primary:
                self._router.broadcast_message({"op": "lora", "pipe": self._pipe_id,
                                                "path": path, "scale": float(scale)})
            self._apply_lora_sync(path, float(scale))

    def _apply_lora_sync(self, path: Optional[str], scale: float) -> None:
        """Apply locally, then vote: a merge that fails on any rank (a file
        missing on one host's disk, a corrupt download) must not leave the
        ranks with different weights, so on any failure every rank restores
        its base weights before the error surfaces."""
        ok = True
        try:
            self._apply_lora_local(path, scale)
        except Exception:
            logger.exception("LoRA merge of %r failed on rank %d", path, self._router.rank)
            ok = False
        failed = self._router.vote(ok)
        if failed:
            self._apply_lora_local(None, 0.0)
            raise RuntimeError(f"LoRA merge of {path!r} failed on {failed}/"
                               f"{self._router.world} rank(s); base weights restored on "
                               "every rank")

    def _apply_lora_local(self, path: Optional[str], scale: float) -> None:
        """The port's in-place merge: the live leaves are written (a graph
        reads them at their addresses), from base copies kept the first
        time a merge touches a leaf."""
        if path is not None and self._active_lora == (path, scale):
            return
        pipe = self._pipe
        with device_lock(pipe.device).shared():
            params = pipe.unet_params
            lora.write_leaves(params, {p: self._base[p] for p in self._active_paths})
            self._active_paths, self._active_lora = (), None
            if path is None:
                return
            tensors = self._lora_cache.get(path)
            if tensors is None:
                tensors = self._lora_cache[path] = lora.load_lora(path)
            for p in tensors.unet:
                w = lora.leaf(params, p)
                if w is not None and p not in self._base:
                    self._base[p] = w.clone()
            values = lora.merged_leaves(params, tensors.unet, scale, base=self._base,
                                        shard=pipe.unet_leaf_slice)
            lora.write_leaves(params, values)
            self._active_paths, self._active_lora = tuple(values), (path, scale)

    # -- pipeline calls ----------------------------------------------------
    def generate(self, prompt, **kw):
        callback = kw.pop("callback", None)
        progress = None
        if callback is not None:
            if kw.pop("callback_latents", True):
                raise ValueError(
                    "multi-rank serving supports progress callbacks only with "
                    "callback_latents=False (per-step latents of every rank's rows "
                    "would need a collective per step)")
            progress = [int(kw.pop("callback_steps", 1))]
        state = kw.pop("latents_state", None)
        return self._dispatch("generate", {"prompt": prompt, **kw}, callback=callback,
                              progress=progress, carry=state is not None, carry_obj=state)

    def img2img(self, prompt, init_image, **kw):
        if kw.get("mask") is not None:
            return self._dispatch("inpaint", {
                "prompt": prompt, "init_image": np.asarray(init_image),
                "mask": np.asarray(kw.pop("mask")), **kw})
        kw.pop("mask", None)
        return self._dispatch("img2img", {
            "prompt": prompt, "init_image": np.asarray(init_image), **kw})

    def inpaint(self, prompt, init_image, mask, **kw):
        return self._dispatch("inpaint", {
            "prompt": prompt, "init_image": np.asarray(init_image),
            "mask": np.asarray(mask), **kw})

    def warmup(self, height: int, width: int, steps: int = 4, batch: int = 1,
               rng: Optional[str] = None):
        """Capture (or create) a bucket on every rank."""
        return self._dispatch("warmup", {"height": height, "width": width, "steps": steps,
                                         "batch": batch, "rng": rng})

    def release_graphs(self) -> None:
        """The worker's close: every rank drops this pipe and its graphs."""
        if self._router.pipes.get(self._pipe_id) is not self:
            return
        with self._router._lock:
            if self._router.is_primary:
                self._router.broadcast_message({"op": "drop", "pipe": self._pipe_id})
            self._drop()

    def _drop(self) -> None:
        self._router.pipes.pop(self._pipe_id, None)
        self._pipe.release_graphs()

    def _dispatch(self, method, kw, *, callback=None, progress=None, carry=False,
                  carry_obj=None):
        kw = dict(kw)
        kw.pop("pipelined", None)  # every rank waits: the data ranks gather
        if method != "warmup" and kw.get("seed") is None:
            kw["seed"] = int(np.random.randint(0, 2**31 - 1))  # one seed for every rank
        if carry and (carry_obj is None or carry_obj is not self._router.last_carry):
            raise ValueError(
                "multi-rank segments must hand back the latents_state returned by the "
                "immediately preceding segment call through this router (each rank "
                "holds its own rows of the carry; a foreign tensor would diverge)")
        with self._router._lock:
            self._router.broadcast_message({
                "op": "call", "pipe": self._pipe_id, "method": method,
                "kw": kw, "progress": progress, "carry": carry})
            return self._execute(method, kw, callback=callback, progress=progress,
                                 carry=carry)

    def _execute(self, method, kw, *, callback=None, progress=None, carry=False):
        """Run the call on this rank. The collective sequence must be the
        same on every rank: it follows from the arguments alone."""
        kw = dict(kw)
        if isinstance(kw.get("segment"), list):
            kw["segment"] = tuple(kw["segment"])
        if carry:
            if self._router.last_carry is None:
                raise RuntimeError("segment handoff arrived with no carry on this rank "
                                   "(calls replayed out of order?)")
            kw["latents_state"] = self._router.last_carry
            self._router.last_carry = None
        if progress is not None:
            kw.update(callback=callback or (lambda step, t, lat: None),
                      callback_steps=progress[0], callback_latents=False)
        if method == "warmup":
            return self._pipe.warmup(**kw)
        if method == "generate":
            res = self._pipe.generate(**kw)
        elif method in ("img2img", "inpaint"):
            res = getattr(self._pipe, method)(**kw)
        else:
            raise ValueError(f"unknown router method {method!r}")
        if res.state_device is not None:
            self._router.last_carry = res.state_device
        return res

    # -- follower loop -----------------------------------------------------
    def serve_follower(self) -> int:
        """``MultihostRouter.serve_follower`` of this pipe's router."""
        return self._router.serve_follower()

    def shutdown(self) -> None:
        """Rank 0: release the followers."""
        if self._router.is_primary:
            self._router.broadcast_message(None)
