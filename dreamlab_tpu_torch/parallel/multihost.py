"""Ranks of one mesh as processes on this machine, and their dryruns (port of
``dreamlab_tpu/parallel/multihost.py``).

The JAX package wires N controller processes into one global device set
with ``jax.distributed``; the port runs one ``torch.distributed`` rank per
device (``init_process``). ``run_ranks`` (the JAX module's
``_spawn_controllers``) starts the ranks of one run as
``python -m dreamlab_tpu_torch.parallel.multihost`` children: the parent
holds the rendezvous (a ``TCPStore`` master on port 0, so no free-port
race), every rank joins it as a client, runs ``target(**args)`` and exits.
On a timeout or a rank's nonzero exit the parent kills every rank: a dead
rank must never leave another blocked in a collective.

The dryruns run the tiny SD1.5 model on the CPU over gloo:

- ``dryrun_multihost(n)``: one data-parallel generation over n ranks, each
  rank's rows checksummed, the checksums all-gathered, a second run the
  same;
- ``dryrun_router(n)``: rank 0 serves the port's HTTP stack
  (``serving/http.py``, ``create_app``, the pool) over a ``RouterPipeline``
  and drives it over ``urllib``; the other ranks replay the broadcast calls
  (``parallel/multihost_router.py``). The same checks as the JAX dryrun:
  repeat bytes, ``X-Seed`` and the fingerprint, batched rows equal to solo
  rows, SSE, progress, img2img, ControlNet, segments, LoRA apply and
  restore, the failed-merge vote, the raw-write refusal, the follower
  surviving a rejected request.
"""

from __future__ import annotations

import datetime
import faulthandler
import importlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOOPBACK = ("127.0.0.1", "localhost", "::1")


def init_process(coordinator: str, num_processes: int, process_id: int, *, backend: str,
                 device: str, timeout: float = 600.0, store=None) -> torch.device:
    """Join this process to a run of ``num_processes`` ranks as rank
    ``process_id`` on ``device``, over ``backend`` ("gloo" on the CPU and
    for ranks that share a card; "cpu:gloo,cuda:nccl" for one rank per
    GPU). The rendezvous is the ``TCPStore`` at ``coordinator``
    ("host:port"), or ``store`` where this process holds it. Every
    collective of the run times out after ``timeout`` seconds.

    A rendezvous on the loopback address means every rank is on this
    machine: gloo and NCCL then connect their ranks over the loopback
    interface too (unless ``GLOO_SOCKET_IFNAME`` / ``NCCL_SOCKET_IFNAME``
    say otherwise), not over the address the host name resolves to, which
    a machine without a network may not route."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    td = datetime.timedelta(seconds=timeout)
    host, port = coordinator.rsplit(":", 1)
    if host.strip("[]") in LOOPBACK:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if store is None:
        store = dist.TCPStore(host, int(port), num_processes, is_master=False, timeout=td)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=td)
    return dev


def rendezvous(num_processes: int, timeout: float = 600.0) -> dist.TCPStore:
    """A ``TCPStore`` master on a port the system picks (``store.port``)."""
    return dist.TCPStore("127.0.0.1", 0, num_processes, is_master=True,
                         wait_for_workers=False, timeout=datetime.timedelta(seconds=timeout))


class Ranks:
    """Rank processes started by this one, each logging to a file of its own.

    ``wait`` returns once every rank has exited 0, and kills every rank and
    raises on the first nonzero exit or at its deadline. A ``watch`` thread
    does the same for ranks that serve until they are told to stop."""

    def __init__(self, procs: Dict[int, subprocess.Popen], logs: Dict[int, str]):
        self.procs, self.logs = procs, logs
        self._closing = False

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()

    def log_tail(self, rank: int, n: int = 8000) -> str:
        with open(self.logs[rank], errors="replace") as f:
            return f.read()[-n:]

    def wait(self, timeout: float) -> Dict[int, str]:
        """Each rank's log once all exited 0; on a nonzero exit or at the
        deadline, kill them all and raise with each rank's exit code and log."""
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in self.procs.values()]
            if all(c == 0 for c in codes):
                return {r: self.log_tail(r, 1 << 20) for r in self.procs}
            failed = any(c not in (None, 0) for c in codes)
            if failed or time.monotonic() > deadline:
                self.kill()
                codes = {r: p.returncode for r, p in self.procs.items()}
                tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{self.log_tail(r)}"
                                  for r, c in codes.items())
                why = "failed" if failed else f"timed out after {timeout:.0f} s"
                raise RuntimeError(f"ranks {why}: exit codes {codes}\n{tails}")
            time.sleep(0.05)

    def watch(self) -> None:
        """A daemon thread that kills every rank once one exits while they
        are meant to run (before ``close``): the starting process's own next
        collective with them then fails instead of blocking."""

        def run():
            while not self._closing:
                if any(p.poll() is not None for p in self.procs.values()):
                    if not self._closing:
                        logger.error("a rank exited while serving (%s): stopping every rank",
                                     {r: p.poll() for r, p in self.procs.items()})
                        self.kill()
                    return
                time.sleep(0.2)

        threading.Thread(target=run, name="rank-watch", daemon=True).start()

    def close(self, timeout: float) -> None:
        """Wait for ranks told to stop, killing what is left at the deadline."""
        self._closing = True
        try:
            self.wait(timeout)
        except RuntimeError:
            logger.exception("ranks did not stop cleanly")


def start_ranks(target: str, ranks: Sequence[int], world: int, port: int, *, backend: str,
                devices: Sequence[str], timeout: float, args: Optional[dict] = None,
                log_dir: Optional[str] = None,
                dump_stacks_after: Optional[float] = None) -> Ranks:
    """Start ``ranks`` (of a ``world``-rank run whose store listens on
    ``port``) as children running ``target`` ("module:function") with
    ``args``; ``devices[r]`` is rank r's device. A rank still running
    ``dump_stacks_after`` seconds after its start writes every thread's
    stack to its log."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="dreamlab_ranks_")
    procs, logs = {}, {}
    for r in ranks:
        spec = {"coordinator": f"127.0.0.1:{port}", "world": world, "rank": r,
                "backend": backend, "device": devices[r], "timeout": timeout,
                "target": target, "args": args or {}, "dump_stacks_after": dump_stacks_after}
        logs[r] = os.path.join(log_dir, f"rank{r}.log")
        with open(logs[r], "wb") as out:
            procs[r] = subprocess.Popen(
                [sys.executable, "-m", "dreamlab_tpu_torch.parallel.multihost",
                 json.dumps(spec)], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    return Ranks(procs, logs)


def run_ranks(target: str, devices: Sequence[str], *, backend: str, timeout: float,
              args: Optional[dict] = None) -> Dict[int, str]:
    """Run ``target(**args)`` in one rank per entry of ``devices`` (this
    process holds the rendezvous and is no rank); each rank's output once
    every one exited 0. Any failure or the deadline kills them all and
    raises with each rank's output."""
    world = len(devices)
    store = rendezvous(world, timeout)
    with tempfile.TemporaryDirectory(prefix="dreamlab_ranks_") as logs:
        ranks = start_ranks(target, range(world), world, store.port, backend=backend,
                            devices=devices, timeout=timeout, args=args, log_dir=logs,
                            dump_stacks_after=max(1.0, timeout - 10.0))
        try:
            return ranks.wait(timeout)
        finally:
            ranks.kill()


def _child_main(argv) -> int:
    """One rank: join the run, run its target on one intra-op thread (the
    ranks share the host's cores), leave the run."""
    spec = json.loads(argv[0])
    torch.set_num_threads(1)
    if spec.get("dump_stacks_after"):
        # every thread's stack into this rank's log shortly before the
        # parent's deadline kills it: where a rank hangs shows in its error
        faulthandler.dump_traceback_later(spec["dump_stacks_after"], exit=False)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s rank%(process)d %(message)s")
    init_process(spec["coordinator"], spec["world"], spec["rank"], backend=spec["backend"],
                 device=spec["device"], timeout=spec["timeout"])
    module, _, name = spec["target"].partition(":")
    try:
        rc = getattr(importlib.import_module(module), name)(**spec["args"])
    finally:
        dist.destroy_process_group()
    return int(rc or 0)


# ---------------------------------------------------------------------------
# the dryruns (tiny SD1.5 on the CPU)
# ---------------------------------------------------------------------------

SIZE = dict(height=32, width=32, num_inference_steps=2)


def _tiny_pipeline(mesh):
    from ..pipeline import LCMPipeline
    from ..testing import random_bundle

    # every rank builds the same weights from the same seed: the deployment's
    # every rank loading the same checkpoint
    bundle = random_bundle("sd15", tiny=True, seed=0)
    return bundle, LCMPipeline(bundle, dtype=torch.float32, device="cpu", mesh=mesh)


def _checksum_child() -> int:
    """One rank of ``dryrun_multihost``: a batch of one row per rank over the
    data axis; each rank's rows checksummed and all-gathered; a repeat the
    same, and the gathered images the same on every rank."""
    from .sharding import data_rows, make_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(model=1, device_type="cpu")
    _, pipe = _tiny_pipeline(mesh)

    def run():
        res = pipe.generate("multihost dryrun", seed=0, batch=world, **SIZE)
        assert res.images.shape == (world, 32, 32, 3), res.images.shape
        own = res.images[data_rows(world, mesh)].astype(np.float64).sum()
        sums = [torch.zeros(1, dtype=torch.float64) for _ in range(world)]
        dist.all_gather(sums, torch.tensor([own], dtype=torch.float64))
        whole = [torch.zeros(1, dtype=torch.float64) for _ in range(world)]
        dist.all_gather(whole, torch.tensor([res.images.astype(np.float64).sum()]))
        return [float(s) for s in sums], {float(w) for w in whole}

    sums, whole = run()
    assert len(whole) == 1, f"ranks gathered different batches: {whole}"
    assert abs(sum(sums) - whole.pop()) < 1e-6, "row blocks do not add up to the batch"
    assert run()[0] == sums, "multihost run not deterministic"
    if rank == 0:
        print(f"dryrun_multihost ok: processes={world} mesh=({world}x1) "
              f"images=({world}, 32, 32, 3) checksums={sums}", flush=True)
    return 0


def _post(port: int, path: str, body: bytes):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:  # surface the server's reason
        raise AssertionError(f"HTTP {e.code}: {e.read(2000)!r}") from e


def _router_child(lora_path: str) -> int:
    """One rank of ``dryrun_router``: rank 0 runs the port's serving stack
    over a ``RouterPipeline`` and drives it over HTTP and in process; the
    others replay the broadcast calls."""
    from .. import lora, testing
    from ..engine.base import GenSpec
    from ..engine.cuda_worker import CudaPipelineWorker
    from .multihost_router import MultihostRouter, RouterPipeline
    from .sharding import make_mesh

    world = dist.get_world_size()
    mesh = make_mesh(model=1, device_type="cpu")
    bundle, pipe = _tiny_pipeline(mesh)
    # every rank attaches the same ControlNet (same seed): every host loading
    # the same mode config
    pipe.set_controlnet(testing.random_controlnet(bundle.unet_cfg, vae_scale=pipe.vae_scale),
                        bundle.unet_cfg)
    router = MultihostRouter()
    rp = RouterPipeline(pipe, router)
    if dist.get_rank() != 0:
        served = rp.serve_follower()
        assert served >= 25, f"follower replayed only {served} messages"
        return 0

    from ..engine.mode_config import ModeConfigManager
    from ..engine.model_registry import ModelRegistry
    from ..engine.worker_pool import WorkerPool
    from ..serving.app import ServerConfig, create_app
    from ..serving.http import ServerThread

    modes = testing.write_modes_yaml(os.path.join(os.path.dirname(lora_path), "modes.yaml"),
                                     {"router": {"model": "a"}}, default_mode="router",
                                     model_root=os.path.dirname(lora_path))
    pool = WorkerPool(queue_max=8, worker_factory=lambda i, p: CudaPipelineWorker(rp, i),
                      mode_config=ModeConfigManager(modes),
                      registry=ModelRegistry(total_hbm_bytes=16 << 30, device="cpu"))
    app = create_app(ServerConfig(default_size="32x32", default_steps=2), pool=pool,
                     skip_startup=True, device="cpu")
    server = ServerThread(app).start()
    try:
        body = (b'{"prompt": "router dryrun", "size": "32x32", '
                b'"num_inference_steps": 2, "seed": 5}')
        st1, hdr1, png1 = _post(server.port, "/generate", body)
        assert st1 == 200 and png1[:8] == b"\x89PNG\r\n\x1a\n", (st1, png1[:8])
        assert hdr1.get("X-Seed") == "5", hdr1
        # determinism through the router: same seed, same bytes
        assert _post(server.port, "/generate", body)[2] == png1, "router not deterministic"
        assert _post(server.port, "/generate", body.replace(b'"seed": 5', b'"seed": 6'))[2] \
            != png1

        # the fingerprint path: latents gathered over the data ranks
        w = CudaPipelineWorker(rp, 9)
        spec = lambda s: GenSpec(prompt="router dryrun", size="32x32", num_inference_steps=2,
                                 seed=s)
        png_fp, seed_fp, fp = w.run_job_with_latents(spec(5))
        assert seed_fp == 5 and len(fp) == 512, (seed_fp, len(fp))

        # a coalesced batch of one row per data rank: each rank's rows from
        # their own seeds, gathered; every row equals its solo run
        seeds = [41 + i for i in range(world)]
        solo = [w.run_job(spec(s))[0] for s in seeds]
        assert [b[0] for b in w.run_jobs([spec(s) for s in seeds])] == solo, \
            "batched rows != solo runs through the router"

        # SSE through the whole stack: the worker registers a
        # callback_latents=False hook; followers replay it with a no-op
        st, _, sse = _post(server.port, "/generate/stream", body)
        sse = sse.decode()
        assert sse.count("event: progress") == 2, sse[:400]
        assert "event: result" in sse and "image_b64" in sse

        fired = []
        rp1 = rp.generate("router dryrun", callback=lambda i, t, lat: fired.append(i),
                          callback_steps=1, callback_latents=False, seed=5, **SIZE)
        assert fired == [0, 1], fired
        rp2 = rp.generate("router dryrun", callback=lambda i, t, lat: None, callback_steps=1,
                          callback_latents=False, seed=5, **SIZE)
        assert np.array_equal(rp1.images, rp2.images), "progress run not deterministic"
        try:
            rp.generate("x", callback=lambda i, t, lat: None, seed=5, **SIZE)
            raise AssertionError("callback_latents=True must be refused")
        except ValueError:
            pass

        init = (np.random.RandomState(3).rand(32, 32, 3) * 255).astype(np.uint8)
        i1 = rp.img2img("router dryrun", init, strength=0.6, seed=21, num_inference_steps=2)
        i2 = rp.img2img("router dryrun", init, strength=0.6, seed=21, num_inference_steps=2)
        assert i1.images.shape == (1, 32, 32, 3)
        assert np.array_equal(i1.images, i2.images), "img2img not deterministic"

        hint = (np.random.RandomState(4).rand(32, 32, 3) * 255).astype(np.uint8)
        g_plain = rp.generate("router dryrun", seed=9, **SIZE)
        g_hint = rp.generate("router dryrun", seed=9, control_image=hint,
                             controlnet_scale=1.0, **SIZE)
        g_hint2 = rp.generate("router dryrun", seed=9, control_image=hint,
                              controlnet_scale=1.0, **SIZE)
        assert not np.array_equal(g_plain.images, g_hint.images), "the hint had no effect"
        assert np.array_equal(g_hint.images, g_hint2.images)

        # segments: each rank keeps its own carry
        full = rp.generate("router dryrun", seed=11, **SIZE)
        s1 = rp.generate("router dryrun", segment=(0, 1), seed=11, **SIZE)
        assert s1.images is None and s1.state_device is not None
        s2 = rp.generate("router dryrun", segment=(1, 2), latents_state=s1.state_device,
                         seed=11, **SIZE)
        assert np.array_equal(s2.images, full.images), "segments != the full run"
        try:
            rp.generate("x", segment=(1, 2), latents_state=torch.zeros(1, 16, 16, 4),
                        seed=11, **SIZE)
            raise AssertionError("a foreign carry must be refused")
        except ValueError:
            pass

        # LoRA styles: the merge replays on every rank
        base_img = rp.generate("router dryrun", seed=13, **SIZE)
        base_batch = rp.generate("router dryrun", seed=13, batch=world, **SIZE)
        rp.apply_lora(lora_path, 1.0)
        styled = rp.generate("router dryrun", seed=13, **SIZE)
        assert not np.array_equal(base_img.images, styled.images), "the LoRA had no effect"
        rp.apply_lora(None)
        assert np.array_equal(rp.generate("router dryrun", seed=13, **SIZE).images,
                              base_img.images), "restoring did not give the base weights"
        # a merge that fails on one rank votes, restores the base everywhere
        # and fails loudly: a row of the batch from each rank shows it
        rp.apply_lora(lora_path, 1.0)
        try:
            rp.apply_lora("/nonexistent/adapter.safetensors", 1.0)
            raise AssertionError("a missing adapter must fail the request")
        except RuntimeError:
            pass
        assert np.array_equal(rp.generate("router dryrun", seed=13, batch=world,
                                          **SIZE).images, base_batch.images), \
            "a failed merge left styled weights"
        try:
            rp.unet_params = None
            raise AssertionError("a raw weight write must be refused")
        except ValueError:
            pass

        # a request every rank rejects before any collective leaves the
        # followers serving
        try:
            rp.img2img("x", init, strength=0.0, seed=1, num_inference_steps=2)
            raise AssertionError("strength 0 must raise")
        except ValueError:
            pass
        assert np.array_equal(rp.generate("router dryrun", seed=13, **SIZE).images,
                              base_img.images), "the router desynced after a rejected request"
        assert lora.load_lora(lora_path).num_modules > 0
    finally:
        server.stop()
        rp.shutdown()
    print(f"dryrun_router ok: processes={world} mesh=({world}x1) fingerprint=512B "
          "features=batch,sse,progress,img2img,controlnet,segments,lora,lora-vote,"
          "raw-write-refusal,reject-resilience deterministic=True", flush=True)
    return 0


def _dryrun(target: str, n_proc: int, timeout: float, ok_marker: str, args=None) -> str:
    out = run_ranks(target, ["cpu"] * n_proc, backend="gloo", timeout=timeout, args=args)[0]
    line = [ln for ln in out.splitlines() if ok_marker in ln]
    if not line:
        raise RuntimeError(f"no {ok_marker!r} line from rank 0:\n{out[-4000:]}")
    print(line[-1])
    return line[-1]


def dryrun_multihost(n_proc: int = 2, *, timeout: float = 300.0) -> str:
    """``n_proc`` CPU ranks run one data-parallel generation and agree."""
    return _dryrun(f"{__name__}:_checksum_child", n_proc, timeout, "dryrun_multihost ok")


def dryrun_router(n_proc: int = 2, *, timeout: float = 300.0) -> str:
    """``n_proc`` CPU ranks serve real HTTP requests through the router
    (HTTP on rank 0, the same calls everywhere)."""
    from ..testing import random_bundle, random_lora
    from ..utils.safetensors import save_file

    with tempfile.TemporaryDirectory(prefix="dreamlab_router_") as root:
        path = os.path.join(root, "style.safetensors")
        save_file(random_lora(random_bundle("sd15", tiny=True, seed=0).unet_params, rank=4),
                  path)
        return _dryrun(f"{__name__}:_router_child", n_proc, timeout, "dryrun_router ok",
                       {"lora_path": path})


if __name__ == "__main__":  # a rank's entry
    sys.exit(_child_main(sys.argv[1:]))
