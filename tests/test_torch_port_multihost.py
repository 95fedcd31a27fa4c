"""The port's rank processes and router (``dreamlab_tpu_torch/parallel/
multihost.py``, ``multihost_router.py``) on the CPU, in gloo ranks: the
checksum and router dryruns (``tests/test_multihost.py``'s two, on the
port's HTTP stack), a failing or hung rank taking every rank down with it
(a hung rank's stack in the error), ranks on one machine on loopback, the
router's typed JSON against the JAX router's, the follower's fatal
unknown op, and the serving stack's side of the router: the worker styling
through ``apply_lora`` and the pool refusing per-request mode routing."""

import json
import time
import types

import numpy as np
import pytest

from dreamlab_tpu.parallel import multihost_router as jrouter
from dreamlab_tpu_torch import lora
from dreamlab_tpu_torch.engine.base import GenSpec
from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker
from dreamlab_tpu_torch.engine.worker_pool import GenerationJob
from dreamlab_tpu_torch.parallel import multihost_router as trouter
from dreamlab_tpu_torch.parallel.multihost import dryrun_multihost, dryrun_router, run_ranks
from tests.test_torch_port_pool import FakeWorker, make_pool

RANK_TIMEOUT_S = 120


def test_dryrun_multihost_two_processes():
    assert "processes=2" in dryrun_multihost(2, timeout=RANK_TIMEOUT_S)


def test_router_serves_generate_across_processes():
    """Rank 0 runs the port's HTTP stack over a RouterPipeline and every
    check of the JAX router dryrun holds across 2 gloo ranks."""
    assert "deterministic=True" in dryrun_router(2, timeout=RANK_TIMEOUT_S)


def test_a_failing_rank_stops_every_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks failed: exit codes \{0: -9, 1: 3\}"):
        run_ranks("tests.torch_mesh_ranks:fail_on_rank_1", ["cpu", "cpu"], backend="gloo",
                  timeout=RANK_TIMEOUT_S)
    assert time.monotonic() - t0 < 60  # rank 0 was killed, not waited out


def test_the_deadline_kills_every_rank():
    with pytest.raises(RuntimeError, match="ranks timed out after 4 s"):
        run_ranks("tests.torch_mesh_ranks:sleep_forever", ["cpu", "cpu"], backend="gloo",
                  timeout=4)


def test_a_hung_rank_shows_its_stack_in_the_deadline_error():
    """Each rank writes every thread's stack to its log before the deadline
    (10 s before it, at least 1 s after the rank starts): the error says
    where a rank hung."""
    with pytest.raises(RuntimeError) as err:
        run_ranks("tests.torch_mesh_ranks:sleep_forever", ["cpu", "cpu"], backend="gloo",
                  timeout=10)
    msg = str(err.value)
    assert "ranks timed out after 10 s" in msg
    assert msg.count("most recent call first") >= 2
    assert "in sleep_forever" in msg


def test_ranks_on_this_machine_connect_over_loopback(monkeypatch):
    """A rendezvous on 127.0.0.1 puts gloo's and NCCL's pairs on the loopback
    interface, unless the caller chose one."""
    import torch.distributed as dist

    from dreamlab_tpu_torch.parallel import multihost

    env = {k: v for k, v in multihost.os.environ.items() if k != "GLOO_SOCKET_IFNAME"}
    env["NCCL_SOCKET_IFNAME"] = "eth9"
    monkeypatch.setattr(multihost.os, "environ", env)  # this process's own is left alone
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: None)
    multihost.init_process("127.0.0.1:1", 1, 0, backend="gloo", device="cpu", store=object())
    assert (env["GLOO_SOCKET_IFNAME"], env["NCCL_SOCKET_IFNAME"]) == ("lo", "eth9")


def test_an_unknown_op_is_fatal_on_the_followers():
    with pytest.raises(RuntimeError, match="unknown router op 'bogus'"):
        run_ranks("tests.torch_mesh_ranks:unknown_op", ["cpu", "cpu"], backend="gloo",
                  timeout=RANK_TIMEOUT_S)


def test_typed_json_matches_the_jax_router():
    msg = {"op": "call", "kw": {
        "latents": np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4),
        "mask": np.ones((4, 4), np.uint8), "seed": np.int64(7), "scale": np.float32(0.5),
        "segment": (0, 3), "prompt": ["a", "b"], "guidance_scale": [1.0, 2.5]}}
    wire = json.dumps(trouter._encode_value(msg))
    assert wire == json.dumps(jrouter._encode_value(msg))
    back = trouter._decode_value(json.loads(wire))
    want = jrouter._decode_value(json.loads(wire))
    for k, v in want["kw"].items():
        np.testing.assert_array_equal(back["kw"][k], v)
        assert type(back["kw"][k]) is type(v)


def _fleet_pipeline(calls, fail=()):
    """What the worker reads of a RouterPipeline when it styles: its UNet's
    cross-attention width and ``apply_lora``, which fails for ``fail``."""
    def apply_lora(path, scale=1.0):
        calls.append((path, scale))
        if path in fail:
            raise RuntimeError(f"LoRA merge of {path!r} failed on 1/2 rank(s)")

    return types.SimpleNamespace(
        bundle=types.SimpleNamespace(unet_cfg=types.SimpleNamespace(cross_attention_dim=32)),
        apply_lora=apply_lora)


def test_the_worker_styles_through_the_pipelines_apply_lora():
    calls = []
    styles = {"a": lora.StyleDef("a", "/s/a.safetensors"),
              "bad": lora.StyleDef("bad", "/s/bad.safetensors")}
    w = CudaPipelineWorker(_fleet_pipeline(calls, fail={"/s/bad.safetensors"}), styles=styles)
    w._apply_style("a", 3)
    w._apply_style("a", 3)  # on already: no second merge on the ranks
    w._apply_style(None, 0)
    w._apply_style(None, 0)
    assert calls == [("/s/a.safetensors", 0.8), (None, 1.0)]
    with pytest.raises(RuntimeError, match="failed on 1/2"):
        w._apply_style("bad", 1)
    # the failed fleet merge restored the base weights on every rank: the
    # worker is unstyled, so the next request's restore is no merge either
    w._apply_style(None, 0)
    w._apply_style("a", 3)
    assert calls[2:] == [("/s/bad.safetensors", 0.4), ("/s/a.safetensors", 0.8)]


def _routed_factory(created):
    def factory(worker_id, model_path):
        w = FakeWorker(worker_id, model_path)
        w.pipeline = types.SimpleNamespace(_router=object())
        created.append(w)
        return w
    return factory


def test_tenant_routing_is_refused_under_the_router(tmp_path):
    created = []
    pool = make_pool(tmp_path, modes=("alpha", "beta"), cache_size=2, queue_max=16,
                     factory=_routed_factory(created))
    try:
        with pytest.raises(ValueError, match="per-request mode routing is single-rank"):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="beta"))).result(timeout=10)
        assert [w.model_path.split("/")[-1] for w in created] == ["alpha.safetensors"]
        pool.submit_job(GenerationJob(GenSpec(prompt="x", seed=1))).result(timeout=10)
    finally:
        pool.shutdown()


def test_a_routed_tenant_built_without_an_active_worker_is_refused(tmp_path):
    created = []
    pool = make_pool(tmp_path, modes=("alpha", "beta"), cache_size=2, queue_max=16,
                     factory=_routed_factory(created))
    try:
        pool.switch_mode("alpha").result(timeout=10)
        pool._stash_current_worker()  # no active worker: only the build shows the router
        with pytest.raises(ValueError, match="per-request mode routing is single-rank"):
            pool.submit_job(GenerationJob(GenSpec(prompt="x", mode="beta"))).result(timeout=10)
        beta = [w for w in created if "beta" in w.model_path]
        assert len(beta) == 1 and beta[0].closed and "beta" not in pool._mode_cache
    finally:
        pool.shutdown()
