"""On the card (``requires_cuda``; skipped without one): the control of
every cell, at the cell's own size, comes out as not correct on three
seeds. Run on the chip with ``python3 -m pytest port_bench/tests -m requires_cuda``."""

import json
from pathlib import Path

import pytest

from port_bench import checks, control, run as harness

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(card, workload):
    cell = harness.load_cell(ROOT, workload)
    limits = checks.limits(workload)
    for seed in (101, 2**32 + 3, 7919):
        got = control.readings(cell["config"], cell["mix"], seed, 30.0, "cuda")
        assert not checks.passed(checks.verdict(got, limits)), (seed, got)
