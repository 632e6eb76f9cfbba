"""On the card (marker ``cuda``; skipped without one, decided in the
``card`` fixture): a short run of each cell through the command line's
path comes out correct, with its metrics."""

import time

import pytest

from benchmark import common
from benchmark.run import run_cell

CELLS = [w["name"] for w in common.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = run_cell(cell, 2**31 + 101, 5.0, trace,
                   t_process=time.perf_counter())
    assert out["correct"], out["compared"]
    assert out["device"]["kind"] == card
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in common.cell_metrics(
        common.load_manifest(), cell, kind)}
    assert set(out["metrics"]) <= want and out["metrics"]
    if trace:
        assert out["device"]["busy_s"] > 0
