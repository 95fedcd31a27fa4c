"""Every cell of BENCHMARK.json finds its files by name, and the file keeps
to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from port_bench import checks, readers, traffic

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    entry = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"] == []
    mix = traffic.load(wl["traffic"])
    assert mix["loop"] in ("open", "closed")
    assert set(checks.limits(cell)) >= {"mean_abs_levels", "unanswered"}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            if cell in m.get("workloads", [cell]):
                assert callable(readers.load(m["name"]))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == keys, m
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        for cell in m.get("workloads", []):
            assert cell in CELLS
        if kind == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        else:
            # the metric it moves is reported by every cell that reports it
            moved = e2e[m["moves"]]
            assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        layers = [m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
