"""The system under test: the port's server over its pool over a worker of
one seeded configuration, built the way a deployment builds it.

The seeded state dicts go through the port's own converters
(``loader.convert_clip_text``, ``convert_unet``, ``convert_vae``) into a
``PipelineBundle``; the pipeline places them; ``serving/app.py::
create_app`` serves a ``WorkerPool`` whose factory hands out the worker
(behind ``Instrumented``, which times the calls into it) on a loopback
port. The benchmark's spans are taken here, around the calls into the
layers: the pool's ``submit_job`` and the worker's dispatch and finalize.
Nothing inside the program is changed.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

from . import traffic, vocab, weights

# the one mode the pool serves: the configuration, at the mix's defaults
MODES_YAML = """default_mode: "bench"
modes:
  bench:
    model: {model}
    defaults:
      size: {size}
      steps: {steps}
      guidance: {guidance}
"""

# the program's modules, imported once the run's environment is set
loader = pipeline = cuda_worker = worker_pool = None


def import_program() -> None:
    global loader, pipeline, cuda_worker, worker_pool
    from dreamlab_tpu_torch import loader as _loader, pipeline as _pipeline
    from dreamlab_tpu_torch.engine import cuda_worker as _cw, worker_pool as _wp

    loader, pipeline, cuda_worker, worker_pool = _loader, _pipeline, _cw, _wp


def run_vocabulary(seed: int):
    """(words, vocab, merges) of a run."""
    return vocab.make(traffic.stream(seed, "vocab"))


def make_bundle(config: dict, states: Dict[str, Dict], vocabulary, merges):
    """The port's bundle of a configuration, through its own converters."""
    from dreamlab_tpu_torch.scheduler.lcm import LCMConfig
    from dreamlab_tpu_torch.utils.tokenizer import CLIPTokenizer

    sdxl = config["arch"] == "sdxl"
    unet_cfg = loader.unet_config_from_json(config["unet"])
    vae_cfg = loader.vae_config_from_json(config["vae"])
    text_cfg = loader.text_config_from_json(config["text_encoder"], penultimate=sdxl)
    dev = next(iter(states["unet"].values())).device
    known = {f.name for f in dataclasses.fields(LCMConfig)}
    bundle = pipeline.PipelineBundle(
        arch=config["arch"],
        tokenizer=CLIPTokenizer(vocabulary, merges),
        text_cfg=text_cfg,
        text_params=loader.convert_clip_text(states["text_encoder"], text_cfg, device=dev),
        unet_cfg=unet_cfg,
        unet_params=loader.convert_unet(states["unet"], unet_cfg, device=dev),
        vae_cfg=vae_cfg,
        vae_params=loader.convert_vae(states["vae"], vae_cfg, device=dev, encoder=False)[0],
        scheduler_cfg=LCMConfig(**{k: v for k, v in config["scheduler"].items() if k in known}),
    )
    if "text_encoder_2" in config:
        bundle.text_cfg_2 = loader.text_config_from_json(config["text_encoder_2"],
                                                         penultimate=True)
        bundle.text_params_2 = loader.convert_clip_text(states["text_encoder_2"],
                                                        bundle.text_cfg_2, device=dev)
        bundle.tokenizer_2 = CLIPTokenizer(vocabulary, merges, pad_token="!")
    return bundle


class Spans:
    """The run's records, taken around the calls into the program's layers
    (monotonic seconds): ``jobs`` by request seed (submitted, taken by a
    worker call, resolved), ``calls`` in dispatch order (dispatch start and
    end, rows, seeds; finalize start and end)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.jobs: Dict[int, dict] = {}
        self.calls: List[dict] = []
        self._by_spec: Dict[int, dict] = {}

    def submitted(self, job) -> None:
        rec = {"seed": job.spec.seed, "submit": time.monotonic()}
        with self.lock:
            self.jobs[job.spec.seed] = rec
            self._by_spec[id(job.spec)] = rec
        job.future.add_done_callback(lambda _: rec.__setitem__("resolved", time.monotonic()))

    def dispatch(self, specs) -> dict:
        rec = {"t0": time.monotonic(), "rows": len(specs), "seeds": [s.seed for s in specs]}
        with self.lock:
            for s in specs:
                job = self._by_spec.pop(id(s), None)
                if job is not None:
                    job["taken"] = rec["t0"]
            self.calls.append(rec)
        return rec


class Instrumented:
    """A worker seen through the benchmark's spans: its dispatch
    (``run_job(s)_pipelined``) and the ``finalize`` it returns are timed;
    everything else is the worker's own."""

    def __init__(self, worker, spans: Spans):
        self._worker = worker
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._worker, name)

    def _timed(self, specs, dispatch):
        rec = self._spans.dispatch(specs)
        finalize = dispatch()
        rec["t1"] = time.monotonic()

        def timed_finalize():
            rec["f0"] = time.monotonic()
            try:
                return finalize()
            finally:
                rec["f1"] = time.monotonic()

        return timed_finalize

    def run_job_pipelined(self, spec):
        return self._timed([spec], lambda: self._worker.run_job_pipelined(spec))

    def run_jobs_pipelined(self, specs):
        return self._timed(list(specs), lambda: self._worker.run_jobs_pipelined(specs))


@dataclasses.dataclass
class Built:
    server: object
    port: int
    pool: object
    worker: object  # the program's worker (not the instrumented view)
    spans: Spans
    words: List[str]
    marks: Dict[str, float]  # set-up phase -> seconds
    peak_before_reset: int  # bytes reserved at most before the serving peak was reset
    tmp: tempfile.TemporaryDirectory
    slice: Optional[object] = None  # a traced run's trace.Slice

    def close(self) -> None:
        """Stop the server and the pool, free the worker's graphs and weights."""
        try:
            self.server.stop()
        finally:
            self.pool.shutdown(drain=False, timeout=5.0)  # closes the worker it serves
            if self.worker.pipeline is not None:
                self.worker.close()
            self.tmp.cleanup()
            self.pool = self.worker = self.server = None
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


def build(config: dict, mix: dict, seed: int, device: str) -> Built:
    """Make the seeded weights, build the port's pipeline, worker, pool and
    server, and capture every bucket the mix reaches (batch 1 by the pool's
    own mode warm-up, 2 .. ``max_batch`` after it)."""
    from dreamlab_tpu_torch.engine.mode_config import ModeConfigManager
    from dreamlab_tpu_torch.engine.model_registry import ModelRegistry
    from dreamlab_tpu_torch.persistence.storage_provider import InMemoryStorageProvider
    from dreamlab_tpu_torch.serving import app as server_app
    from dreamlab_tpu_torch.serving.http import ServerThread

    marks: Dict[str, float] = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        now = time.perf_counter()
        marks[name] = now - t
        t = now

    cuda = torch.device(device).type == "cuda"
    words, vocabulary, merges = run_vocabulary(seed)
    states = weights.state_dicts(config, seed, device)
    if cuda:
        torch.cuda.synchronize()
    mark("weights_made")
    bundle = make_bundle(config, states, vocabulary, merges)
    del states
    pipe = pipeline.LCMPipeline(bundle, dtype=getattr(torch, config["dtype"]), device=device)
    del bundle
    worker = cuda_worker.CudaPipelineWorker(pipe)
    gc.collect()
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        # the serving peak: from the pipeline holding its weights, the
        # benchmark's own copies gone, before any bucket is captured
        peak = torch.cuda.max_memory_reserved()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mark("pipeline_placed")

    spans = Spans()
    tmp = tempfile.TemporaryDirectory(prefix="port_bench_")
    modes = os.path.join(tmp.name, "modes.yaml")
    with open(modes, "w") as f:
        f.write(MODES_YAML.format(model=json.dumps(f"seeded:{config['name']}"),
                                  size=json.dumps(mix["size"]), steps=mix["steps"],
                                  guidance=float(mix.get("guidance", 1.0))))
    os.environ["DREAMLAB_BATCH_WINDOW_MS"] = str(mix["batch_window_ms"])
    mode_config = ModeConfigManager(modes)
    registry = ModelRegistry(device=device)
    view = Instrumented(worker, spans)
    pool = worker_pool.WorkerPool(queue_max=mix.get("queue_max", 64),
                                  worker_factory=lambda worker_id, model_path: view,
                                  mode_config=mode_config, registry=registry,
                                  max_batch=mix["max_batch"])
    submit = pool.submit_job

    def submit_job(job):
        if isinstance(job, worker_pool.GenerationJob):
            spans.submitted(job)
        return submit(job)

    pool.submit_job = submit_job
    mark("pool_built_batch1_captured")
    width, height = map(int, mix["size"].split("x"))
    for batch in range(2, mix["max_batch"] + 1):
        pipe.warmup(height, width, steps=mix["steps"], batch=batch)
    mark("buckets_captured")
    cfg = server_app.ServerConfig(default_size=mix["size"], default_steps=mix["steps"],
                                  default_guidance=mix.get("guidance", 1.0),
                                  queue_max=mix.get("queue_max", 64), warmup=False)
    app = server_app.create_app(cfg, pool=pool, storage=InMemoryStorageProvider(),
                                mode_config=mode_config, registry=registry, skip_startup=True)
    server = ServerThread(app).start()
    mark("server_listening")
    return Built(server, server.port, pool, worker, spans, words, marks, peak, tmp)
