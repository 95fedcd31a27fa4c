"""What the metric files share: loading a reader by its metric's name, and
the arithmetic several readers do.

A reader is ``metrics/<metric name>.py`` with ``read(run) -> float | None``:
None where the run holds nothing for it to read (then the metric is left
out of the result line). ``run`` is a ``Run``: the window's requests as the
load generator saw them, the harness's spans around the calls into the
pool and the worker, the traced slice, one image's work from the
configuration's shapes, and the set-up and memory readings.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import flops, trace

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Run:
    seconds: float  # the window's length
    t_open: float  # the window's opening (monotonic)
    requests: List[dict]  # due in the window, as the load generator recorded them
    calls: List[dict]  # worker calls dispatched from the window's opening on
    jobs: List[dict]  # pool jobs of the window's requests
    work: flops.Work  # one image's work
    setup_s: float
    memory_reserved_peak: int
    profile: Optional[dict] = None  # trace.Slice.read() of a traced run

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds

    def latencies_ms(self) -> np.ndarray:
        """Each request's latency from when it was due to its last byte; a
        request that failed or never came counts as infinitely late."""
        return np.array([1e3 * (r["done"] - r["due"]) if r.get("status") == 200 else math.inf
                         for r in self.requests])


def load(name: str) -> Callable:
    """The ``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> Optional[float]:
    values = np.sort(np.asarray(values, dtype=np.float64))
    if values.size == 0:
        return None
    if not np.isfinite(values).all():
        # the ranks at and above the first infinite value are infinite
        pos = q / 100.0 * (values.size - 1)
        if math.ceil(pos) >= np.argmax(~np.isfinite(values)):
            return math.inf
    return float(np.percentile(values, q))


def images_per_s(run: Run) -> Optional[float]:
    done = sum(1 for r in run.requests
               if r.get("status") == 200 and r["done"] <= run.t_close)
    return done / run.seconds if done else None


# the profiler loses a launch's record now and then (1 of 676, 6 of 418 in
# traced slices on the H100); a census off by more is another program
CENSUS_SLACK = 0.02


def kernel_roofline(run: Run, kernels, calls_of_image: Callable[[flops.Work], list]) -> Optional[float]:
    """Share (%) of the least time the traced slice's calls of a kernel
    family could take on the card (their bounds from their shapes) in the
    device time the family's kernels took there. The slice holds whole
    replays; each replay launched in it is matched to the worker call whose
    dispatch launched it, for its rows. The bounds are taken for the
    launches the slice recorded (the census's bound a launch, times those).
    None where the slice shows no replay, one that no call launched, or a
    number of the family's launches off the replays' census by more than
    ``CENSUS_SLACK``."""
    prof = run.profile
    if prof is None:
        return None
    if prof["graph_launches"] is None:
        # no runtime calls recorded: the calls whose dispatch ended in the slice
        calls = [c for c in run.calls if prof["start"] < c.get("t1", 0.0) < prof["stop"]]
    else:
        calls = [next((c for c in run.calls if c["t0"] <= t <= c.get("t1", c["t0"])), None)
                 for t in prof["graph_launches"]]
    per_image = calls_of_image(run.work)
    secs, launches = trace.family(prof, kernels)
    expected = len(per_image) * len(calls)
    if (not calls or None in calls or not per_image or not launches
            or abs(launches - expected) > CENSUS_SLACK * expected):
        return None
    bound = sum(c.bound_s(call["rows"]) for call in calls for c in per_image)
    return 100.0 * bound * (launches / expected) / secs


def device_idle_share(run: Run) -> Optional[float]:
    prof = run.profile
    if prof is None or prof["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["seconds"])


def model_flops_share(run: Run, images_per_second: Optional[float]) -> Optional[float]:
    """Share (%) of the card's bf16 peak that one image's model FLOPs at
    ``images_per_second`` make."""
    if not images_per_second:
        return None
    return 100.0 * images_per_second * run.work.flops / flops.PEAK_BF16_FLOPS


def by_seed(run: Run) -> Dict[int, dict]:
    return {j["seed"]: j for j in run.jobs}
