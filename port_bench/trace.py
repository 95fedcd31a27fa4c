"""The device trace of a traced run: torch.profiler over a steady slice of
the window, started and stopped with every launch section of the process
quiesced (``pipeline.quiesced()``: a profiler stop beside a CUDA graph
replay can deadlock) and the device idle, so that the slice holds whole
replays: every replay the slice shows was launched inside it, and every
replay launched inside it ran to its end inside it.

``read`` turns the profiler's events into what the readers take: the
device's activity (kernels, copies) as intervals on the host's monotonic
clock, time by kernel name, the replays launched (``cudaGraphLaunch``) with
their launch times, and the idle gaps.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional

import torch


class Slice:
    def __init__(self, quiesced):
        self.quiesced = quiesced
        self._marker = torch.zeros(1, device="cuda")
        self.result = None
        self.t_start = self.t_stop = None

    @staticmethod
    def _config():
        """The profiler's configuration: the device's activity and the CUDA
        runtime's calls only (recording every host operator of the serving
        threads would slow the host that sets the pace). Driven through
        torch.autograd.profiler's own enable and disable, so that a stop
        only collects the records, and turning them into events waits until
        the serving threads run again."""
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                        _ExperimentalConfig)

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        return config, {ProfilerActivity.CUDA}

    def start(self) -> None:
        from torch.autograd import profiler

        config, activities = self._config()
        profiler._prepare_profiler(config, activities)
        with self.quiesced():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            profiler._enable_profiler(config, activities)
            self.start_s = time.perf_counter() - t0
            # a clock mark: the one launch made while every launch section
            # of the process is held, between two readings of the host clock
            before = time.monotonic_ns()
            self._marker.fill_(1.0)
            self._mono_mark = (before + time.monotonic_ns()) // 2
            torch.cuda.synchronize()
            self.t_start = time.monotonic()

    def stop(self) -> None:
        from torch.autograd import profiler

        with self.quiesced():
            torch.cuda.synchronize()
            self.t_stop = time.monotonic()
            self.result = profiler._disable_profiler()
        self.stop_s = time.monotonic() - self.t_stop

    def warm(self, replay) -> float:
        """Set-up of a traced run: one profiler cycle around ``replay()``
        (a replay of every bucket the cell reaches), so that the profiler's
        own first start, and its first look at each graph, fall before the
        window. Returns its seconds."""
        t0 = time.perf_counter()
        self.start()
        replay()
        self.stop()
        self.result = None
        return time.perf_counter() - t0

    def read(self) -> Optional[dict]:
        """The slice's device activity, or None where the profiler saw no
        device activity at all."""
        from torch.autograd import DeviceType

        events = sorted(self.result.events(), key=lambda e: e.start_ns())
        runtime = any(e.device_type() != DeviceType.CUDA for e in events)
        # the mark's launch; without the runtime's events, its kernel (the
        # device was idle: it starts microseconds after the launch)
        mark = next((e for e in events if ("LaunchKernel" in e.name() if runtime else
                                           e.device_type() == DeviceType.CUDA)), None)
        if mark is None:
            return None
        offset = mark.start_ns() - self._mono_mark
        to_mono = lambda ns: (ns - offset) / 1e9
        lo, hi = self.t_start, self.t_stop
        device, launches = [], []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                s, d = to_mono(e.start_ns()), e.duration_ns() / 1e9
                if s + d > lo and s < hi:
                    device.append((max(s, lo), min(s + d, hi), name))
            elif "GraphLaunch" in name:
                s = to_mono(e.start_ns())
                if lo <= s <= hi:
                    launches.append(s)
        if not device:
            return None
        device.sort()
        busy, segments = 0.0, []
        for s, t, _ in device:
            if segments and s <= segments[-1][1]:
                segments[-1][1] = max(segments[-1][1], t)
            else:
                segments.append([s, t])
        busy = sum(t - s for s, t in segments)
        gaps = [(lo, segments[0][0])] + [(a[1], b[0]) for a, b in zip(segments, segments[1:])] \
            + [(segments[-1][1], hi)]
        by_name: Dict[str, float] = Counter()
        count: Dict[str, int] = Counter()
        for s, t, name in device:
            by_name[name] += t - s
            count[name] += 1
        return {"start": lo, "stop": hi, "seconds": hi - lo, "busy_s": busy,
                "by_name": dict(by_name), "count": dict(count),
                # None where the profiler recorded no runtime calls
                "graph_launches": sorted(launches) if runtime else None,
                "gaps": sorted(((t - s, s, t) for s, t in gaps if t > s), reverse=True)}


def family(profile: dict, names) -> tuple:
    """(seconds, launches) of the kernels whose name holds one of ``names``."""
    secs = sum(v for k, v in profile["by_name"].items() if any(n in k for n in names))
    launches = sum(v for k, v in profile["count"].items() if any(n in k for n in names))
    return secs, launches


def host_label(t: float, calls: List[dict], jobs: List[dict]) -> str:
    """What the host was doing at monotonic time ``t``, by the harness's
    spans: inside a dispatch, inside a finalize, with a job waiting in the
    pool's queue, or with none of these (the server, or nothing to do)."""
    for c in calls:
        if c["t0"] <= t <= c.get("t1", c["t0"]):
            return "dispatch"
        if "f0" in c and c["f0"] <= t <= c.get("f1", c["f0"]):
            return "finalize"
    if any(j["submit"] <= t < j.get("taken", float("inf")) for j in jobs):
        return "queue"
    return "server_or_idle"
