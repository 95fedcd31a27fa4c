"""A run's whole control flow on the CPU at a tiny configuration (the
harness's look for a card skipped): the server, the pool and the worker
serve a window from the load generator's process, the spans and readers
fill, the check compares with the reference. Then the same run with the
timed path broken underneath, once for each fault a serving cell can
have, comes out not correct; and the measuring path refuses to run or
report without a card.

The exchange between chips is not among the faults: every cell runs on one
card and no served path crosses chips."""

import contextlib
from pathlib import Path

import numpy as np
import pytest

from port_bench import checks, run as harness
from port_bench.tests import tiny

ROOT = Path(__file__).resolve().parent.parent.parent
LIMITS = checks.limits("sd15-512-serial")


def rehearse(mix_name="poisson-sd15-512", **over):
    harness.set_caches(ROOT)
    mix = tiny.mix(mix_name, **{"rate_per_s": 8.0, "max_batch": 4, "check": 6, **over})
    cell = {"workload": {"name": "rehearsal", "chips": 1}, "config": tiny.config("sd15-lcm-512"),
            "mix": mix, "end_to_end": [], "per_layer": []}
    return harness.run_cell(cell, 2**33 + 7, 3.0, False, "cpu", LIMITS)


def test_a_whole_run_on_the_cpu():
    out = rehearse()
    run = out["run"]
    assert run.requests and all(r["status"] == 200 for r in run.requests)
    assert checks.passed(out["checks"]), out["checks"]
    assert out["numbers"]["unanswered"] == 0 and out["numbers"]["batch_row_levels_off_solo"] == 0
    for name in ("latency_p50_ms", "latency_p90_ms", "server_ms", "queue_wait_ms.p90",
                 "dispatch_ms", "finalize_ms", "rows_per_call", "mfu.p50"):
        value = harness.readers.load(name)(run)
        assert value is not None and value > 0, name
    # no card, no device trace: the kernel readers find nothing to read
    for name in ("flash_roofline.p50", "gn_roofline.tput", "device_idle_share.p50"):
        assert harness.readers.load(name)(run) is None
    with pytest.raises(RuntimeError):
        harness.result_line({"per_layer": []}, out, True, "cpu")


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def step_unchanged(schedule, i, model_output, sample, noise, prediction_type="epsilon"):
    return sample.float(), sample.float()


def test_a_step_that_returns_its_state_unchanged_is_not_correct():
    from dreamlab_tpu_torch import pipeline

    with patched(pipeline, "lcm_step", step_unchanged):
        out = rehearse()
    assert not checks.passed(out["checks"]), out["checks"]


def test_rows_of_a_batch_left_out_are_not_correct():
    """Each coalesced call computes its first row only and hands its image
    to every row."""
    from dreamlab_tpu_torch.engine.cuda_worker import CudaPipelineWorker

    real = CudaPipelineWorker.run_jobs_pipelined

    def first_row_only(self, specs):
        if len(specs) == 1:
            return real(self, specs)
        finalize = self.run_job_pipelined(specs[0])

        def done():
            png, _ = finalize()
            return [(png, s.seed) for s in specs]

        return done

    with patched(CudaPipelineWorker, "run_jobs_pipelined", first_row_only):
        out = rehearse("burst8x2-512")
    assert not checks.passed(out["checks"]), out["checks"]


def test_an_image_altered_where_it_is_produced_is_not_correct():
    from dreamlab_tpu_torch.engine import cuda_worker

    encode = cuda_worker.encode_png

    def altered(img, meta=None):
        img = np.array(img)
        img[: img.shape[0] // 8] = 0
        return encode(img, meta)

    with patched(cuda_worker, "encode_png", altered):
        out = rehearse()
    assert not checks.passed(out["checks"]), out["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc = harness.main(["--workload", "sd15-512-serial", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
