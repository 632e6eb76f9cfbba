"""A run of each cell, on the CPU at a test's size, with the timed path
broken underneath, must come out not correct; unbroken, correct; with the
control (the reference, priorities coarsened) in the program's place, not
correct. The look for a card is skipped: ``run_cell`` is what the command
line calls after it."""

import time

import pytest

from benchmark import common, control
from benchmark.run import run_cell

CELL = next(w["name"] for w in common.load_manifest()["workloads"]
            if w["traffic"] == "churn")
SMALL_PLANNER = {"servers": 64, "max_requesters": 16, "nshards": 2}


def planner_run(seed=2**31 + 3, traffic_patch=None, **hooks):
    return run_cell(CELL, seed, 1.0, False, device="cpu",
                    t_process=time.perf_counter(), conf_patch=SMALL_PLANNER,
                    traffic_patch=traffic_patch, **hooks)


class Broken:
    """The port's planner with one fault where its plan is produced."""

    def __init__(self, conf, fault):
        from benchmark.planner_cell import build_solver

        self.inner = build_solver(conf, "cpu")
        self.fault = fault
        self.first = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def plan(self):
        pairs = self.inner.plan()
        if self.fault == "unchanged":  # the step hands back its old state
            if self.first is None:
                self.first = (pairs, self.inner.last_assigned)
            pairs, self.inner.last_assigned = self.first
        elif self.fault == "half":  # half of the plan left out
            pairs = pairs[::2]
        elif self.fault == "altered" and pairs:  # one answer altered
            h, s, rh, fr, rq = pairs[0]
            pairs = [(h, s, rh, fr, rq + 1)] + pairs[1:]
        return pairs


def test_planner_sound_run_is_correct():
    out = planner_run()
    assert out["correct"], out["compared"]
    assert out["compared"]["rounds_checked"]["value"] >= 8


def test_planner_checks_span_the_window():
    """The rounds checked are drawn from the whole window, and the window's
    last round is among them."""
    out = planner_run(traffic_patch={"check_most": 8})
    run = out["run"]
    n, got = len(run["rounds"]), run["checked_rounds"]
    assert n > 64, n
    assert got[-1] == n - 1
    assert len(got) in (8, 9) and max(got[:-1]) >= 8
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_planner_fault_is_not_correct(fault):
    out = planner_run(make_solver=lambda c: Broken(c, fault))
    assert not out["correct"]
    assert out["compared"]["rounds_wrong"]["value"] > 0


def test_planner_control_is_not_correct():
    out = planner_run(**control.control_hook("planner", 4))
    assert not out["correct"]
    assert out["compared"]["rounds_wrong"]["value"] > 0
