"""The readers of the planner's own spans: each averages over the window's
rounds, counts a round that skipped its phase as 0, and reads nothing
(None) from a run that kept no spans."""

import pytest

from benchmark import common

PHASES = {"diff": "ingest", "pack": "ingest", "upload": "ingest",
          "reqrows": "ingest", "enqueue": "plan", "readback": "plan",
          "extract": "plan"}
SPAN_METRICS = [f"planner.{p}_ms.plan" for p in PHASES] + [
    "planner.diff_useful_pct.plan", "planner.scanned_rows.plan"]


def four_rounds():
    """Four rounds in the window, of which two ran every phase (2 ms and
    4 ms each), walked 100 servers and changed 3 and 5, and scanned 700
    and 900 rows."""
    spans = []
    for k, (ms, changed, scanned) in enumerate([(2, 3, 700), (4, 5, 900)]):
        t = 10.0 * k
        for phase, parent in PHASES.items():
            args = {"round": k}
            if phase == "diff":
                args.update(walked=100, servers_changed=changed)
            if phase == "readback":
                args.update(scanned=scanned)
            spans.append((f"planner:{parent}.{phase}", t, t + ms * 1e-3,
                          args))
    return {"kind": "planner", "rounds": [None] * 4, "program_spans": spans}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_ms_is_a_mean_over_the_rounds(phase):
    read = common.metric_reader(f"planner.{phase}_ms.plan")
    assert read(four_rounds()) == pytest.approx((2 + 4) / 4)


def test_diff_useful_share_and_scanned_rows():
    run = four_rounds()
    assert common.metric_reader("planner.diff_useful_pct.plan")(run) == (
        pytest.approx(100 * 8 / 200))
    assert common.metric_reader("planner.scanned_rows.plan")(run) == (
        pytest.approx((700 + 900) / 4))


@pytest.mark.parametrize("name", SPAN_METRICS + ["auction_roofline"])
def test_no_spans_read_nothing(name):
    read = common.metric_reader(name)
    assert read({"kind": "planner", "rounds": [None] * 4,
                 "program_spans": None, "trace": None}) is None
    assert read({"kind": "planner", "rounds": [None] * 4,
                 "program_spans": [], "trace": None}) is None


def test_auction_roofline_counts_the_prologue():
    """Two launches of 1 us each: each round's bytes from its commits, the
    prologue's from the rows scanned and staged, over the bytes rate."""
    import numpy as np

    from benchmark import bounds

    conf = {"max_requesters": 100, "types": [1, 2, 3, 4], "cand_width": 32}
    C, D = 512, 545
    commits = [np.array([30, 2, 0, 7]), np.array([1, 1, 1, 1])]
    run = {"kind": "planner", "conf": conf, "C": C, "D": D,
           "trace": {"kernels": {"auction_kernel_true": (2e-6, 2)}},
           "rounds": [[0, 0, 0, 0, 0, 0, x] for x in commits],
           "program_spans": [
               ("planner:ingest.reqrows", 0, 1, {"rows": 300}),
               ("planner:plan.readback", 0, 1, {"scanned": 3812}),
               ("planner:plan.readback", 0, 1, {"scanned": 2100})]}
    rounds = sum(bounds.k5_bytes(x.tolist(), [C] * 4, 32, D, C)
                 for x in commits)
    prologue = (bounds.k5_window_bytes(3812, 100, 4, C)
                + bounds.k5_window_bytes(2100, 100, 4, C)
                + bounds.k5_pack_bytes(300, 100, 4))
    want = bounds.roofline_pct(rounds + prologue, 2e-6)
    got = common.metric_reader("auction_roofline")(run)
    assert got == pytest.approx(want)
    assert got > bounds.roofline_pct(rounds, 2e-6)


def test_union_seconds_merges_overlaps():
    ivs = [(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (4.0, 4.5), (6.0, 6.0)]
    assert common.union_seconds(ivs) == pytest.approx(2.0 + 1.5)
    assert common.union_seconds([]) == 0.0


def test_plan_device_us_is_the_busy_time_over_the_rounds():
    from benchmark import planner_cell

    run = {"rounds": [[0, 3e-3]] * 8, "device_busy": {"busy_s": 4e-4,
                                                      "ops": 40}}
    assert planner_cell.end_to_end(run)["plan_device_us"] == \
        pytest.approx(50.0)
    # an untraced run off the card has no device trace: nothing to read
    assert planner_cell.end_to_end({**run, "device_busy": None}) == {
        "plan_device_us": None}


def test_round_ms_is_the_host_mean():
    read = common.metric_reader("planner.round_ms.plan")
    assert read({"kind": "planner", "rounds": [[0, 2e-3], [1, 4e-3]]}) == \
        pytest.approx(3.0)
    assert read({"kind": "planner", "rounds": []}) is None
