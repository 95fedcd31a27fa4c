"""The readers of the metrics that read the program's own spans
(``program_spans.py``), on a synthetic run with planted spans and a planted
traced slice: only the window's spans count, a request's self time is its
span less its child's, idle time inside a span is counted by overlap (a gap
half inside a ``png.encode`` counts half), and without spans every reader
returns None."""

import sys

import pytest

from port_bench import program_spans, readers

NEW = ("http_self_ms", "pool_wait_ms.p90", "stage_ms", "launch_ms", "device_wait_ms",
       "png_ms.p50", "png_ms.tput", "overlap_share.tput", "idle_png_share.p50",
       "idle_png_share.tput")
_ids = iter(range(1, 10**6))


def span(name, t0, t1, parent=None, **attrs):
    return {"name": name, "t0": t0, "t1": t1, "id": next(_ids), "parent": parent,
            "thread": "t", "tid": 1, "attrs": attrs}


def gaps(*pairs):
    return sorted(((t - s, s, t) for s, t in pairs), reverse=True)


def make_run(profile=None):
    return readers.Run(seconds=10.0, t_open=100.0, requests=[], calls=[], jobs=[], work=None,
                       setup_s=0.0, memory_reserved_peak=0, profile=profile)


@pytest.fixture
def planted(monkeypatch):
    spans = []
    monkeypatch.setattr(program_spans, "recorded", lambda: list(spans))
    return spans


def test_only_the_windows_spans_count(planted):
    for t0, ms in ((99.0, 10), (101.0, 20), (105.0, 30), (110.0, 50), (110.5, 40)):
        planted.append(span("png.encode", t0, t0 + ms / 1e3))
        planted.append(span("graph.replay", t0, t0 + ms / 2e3))
    run = make_run()
    assert readers.load("png_ms.p50")(run) == pytest.approx(30.0)
    assert readers.load("png_ms.tput")(run) == pytest.approx(30.0)
    assert readers.load("launch_ms")(run) == pytest.approx(15.0)
    assert readers.load("stage_ms")(run) is None  # none planted


def test_self_time_is_the_span_less_its_child(planted):
    a = span("http.request", 101.0, 101.100, path="/generate", status=200)
    b = span("http.request", 102.0, 102.050, path="/generate", status=200)
    failed = span("http.request", 103.0, 103.5, path="/generate", status=429)
    other = span("http.request", 104.0, 104.2, path="/health", status=200)
    lone = span("http.request", 105.0, 105.3, path="/generate", status=200)  # no child
    planted += [a, b, failed, other, lone,
                span("http.await", 101.01, 101.09, parent=a["id"]),
                span("http.await", 102.002, 102.047, parent=b["id"]),
                span("http.await", 103.0, 103.001, parent=failed["id"]),
                span("http.await", 104.0, 104.001, parent=other["id"])]
    # (100 - 80) and (50 - 45) ms
    assert readers.load("http_self_ms")(make_run()) == pytest.approx(12.5)


def test_waits_and_overlap_share(planted):
    for i in range(10):
        planted.append(span("pool.queued", 101.0 + i, 101.0 + i + (i + 1) / 1e3))
        planted.append(span("pool.settle", 101.0 + i, 101.1 + i, overlapped=i < 3))
    planted.append(span("pool.queued", 50.0, 60.0))  # before the window
    run = make_run()
    assert readers.load("pool_wait_ms.p90")(run) == pytest.approx(9.1)
    assert readers.load("overlap_share.tput")(run) == pytest.approx(30.0)


def test_idle_time_inside_png_spans_by_overlap(planted):
    # the slice 100.0-101.0; idle 0.2 s + 0.1 s + 0.1 s
    prof = {"start": 100.0, "stop": 101.0, "seconds": 1.0, "busy_s": 0.6,
            "gaps": gaps((100.0, 100.2), (100.5, 100.6), (100.9, 101.0))}
    # half of the first gap, the whole second, none of the third; a span
    # outside the slice and one of another name do not count
    planted += [span("png.encode", 100.1, 100.3), span("png.encode", 100.45, 100.65),
                span("png.encode", 101.5, 102.0), span("device.wait", 100.9, 101.0)]
    run = make_run(prof)
    assert readers.load("idle_png_share.p50")(run) == pytest.approx(100 * 0.2 / 0.4)
    assert readers.load("idle_png_share.tput")(run) == pytest.approx(100 * 0.2 / 0.4)
    # two png spans that overlap over one gap: the gap whole, counted once
    planted.append(span("png.encode", 100.0, 100.15))
    assert readers.load("idle_png_share.p50")(run) == pytest.approx(100 * 0.3 / 0.4)
    assert readers.load("idle_png_share.p50")(make_run()) is None  # no slice


def test_idle_time_by_the_span_that_held_it(planted):
    prof = {"start": 100.0, "stop": 101.0, "seconds": 1.0, "busy_s": 0.6,
            "gaps": gaps((100.0, 100.2), (100.5, 100.6), (100.9, 101.0))}
    planted += [span("pool.settle", 100.0, 100.6), span("png.encode", 100.1, 100.2),
                span("device.wait", 100.0, 100.05), span("http.request", 100.85, 100.95)]
    held = program_spans.idle_by_span(make_run(prof))
    assert held["png.encode"] == pytest.approx(0.1)
    assert held["device.wait"] == pytest.approx(0.05)
    assert held["pool.settle"] == pytest.approx(0.15)
    assert held["http.request"] == pytest.approx(0.05)
    assert held["none"] == pytest.approx(0.05)
    assert sum(held.values()) == pytest.approx(0.4)


def test_every_reader_returns_none_without_spans(planted):
    prof = {"start": 100.0, "stop": 101.0, "seconds": 1.0, "busy_s": 0.6,
            "gaps": gaps((100.0, 100.2))}
    for name in NEW:
        assert readers.load(name)(make_run(prof)) is None, name
    assert program_spans.idle_by_span(make_run(prof)) is None


def test_the_programs_recorder_is_read_and_its_absence_gives_none(monkeypatch):
    from dreamlab_tpu_torch import utils
    from dreamlab_tpu_torch.utils import tracing

    tracing.reset()
    try:
        for i in range(3):
            t0 = int((101.0 + i) * 1e9)
            tracing.record("pipeline.stage", t0, t0 + (i + 1) * 1_000_000)
        assert readers.load("stage_ms")(make_run()) == pytest.approx(2.0)
        # a program without the recorder (the parent of the change that added it)
        monkeypatch.delattr(utils, "tracing")
        monkeypatch.setitem(sys.modules, "dreamlab_tpu_torch.utils.tracing", None)
        assert program_spans.recorded() == []
        assert readers.load("stage_ms")(make_run()) is None
    finally:
        tracing.reset()


def test_a_whole_run_on_the_cpu_fills_the_readers_of_the_programs_spans():
    """The rehearsal's tiny run (``test_port_bench_rehearsal.py``): the
    program's spans of the window agree with the harness's spans around the
    calls into it. No card: no graph replay, no device wait, no slice."""
    from port_bench.tests.test_port_bench_rehearsal import rehearse

    run = rehearse()["run"]
    value = {name: readers.load(name)(run) for name in NEW + ("server_ms", "dispatch_ms",
                                                             "finalize_ms")}
    for name in ("http_self_ms", "pool_wait_ms.p90", "stage_ms", "png_ms.p50",
                 "png_ms.tput", "overlap_share.tput"):
        assert value[name] is not None and value[name] >= 0, name
    for name in ("launch_ms", "device_wait_ms", "idle_png_share.p50", "idle_png_share.tput"):
        assert value[name] is None, name
    assert value["http_self_ms"] <= value["server_ms"]
    assert value["stage_ms"] <= value["dispatch_ms"]
    assert value["png_ms.p50"] <= value["finalize_ms"]
