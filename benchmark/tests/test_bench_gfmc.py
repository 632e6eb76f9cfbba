"""The GFMC cell (``planner131k.gfmc``): its generator lands one round of
the economy's untargeted work on 17 servers in turn, re-parks each
requester on its own vector, and freezes a copy that plans as the whole
snapshots do; the cell finds its files and readers, runs correct on the
CPU at a test's size and comes out not correct under the control; the
readers of the auction's counts average over the plans and read nothing
from a program that does not report them."""

import time
from collections import Counter

import pytest

from benchmark import common, control, reference
from benchmark.gfmc import Gfmc
from benchmark.run import run_cell

M = common.load_manifest()
CELL = "planner131k.gfmc"
TRAFFIC = common.traffic_file("gfmc")
TYPES = [1, 2, 3, 4, 5]


def generator(seed=2**31 + 11, nservers=40, K=16, R=8):
    return Gfmc(TRAFFIC, nservers, K, R, TYPES, seed)


def test_each_round_lands_the_economys_work_on_17_servers_in_turn():
    gen = generator(nservers=40)
    first = TRAFFIC["first_rank"]
    for rnd in range(6):
        before = {s: list(v["tasks"]) for s, v in gen.snaps.items()}
        gen.bursts()
        landed = {s: [t for t in v["tasks"] if t not in before[s]]
                  for s, v in gen.snaps.items()}
        got = {s: ts for s, ts in landed.items() if ts}
        want = {first + (rnd * 17 + d) % 40 for d in range(17)}
        assert set(got) == want
        assert all(len(ts) == 8 for ts in got.values())
        types = Counter(t[1] for ts in got.values() for t in ts)
        assert types == {1: 8, 2: 32, 3: 96}
        assert all(t[2] == {1: 1, 2: 2, 3: 3}[t[1]]
                   for ts in got.values() for t in ts)
        gen.consume([(h, t[0], first, 1 + rnd, 2) for h, ts in got.items()
                     for t in ts])  # no such requester: nothing re-parks
        assert not gen.holding


def _plan(snaps, nservers, K, R, m=4, rounds=4):
    return reference.plan_from_snapshots(snaps, TYPES, K, R, nservers,
                                         rounds, m)


def test_requesters_keep_their_vectors_and_frozen_plans_as_the_whole():
    """20 rounds planned by the reference: every requester re-parks on its
    own vector (rank 0 on [D]), each server keeps R of them, and each round
    the frozen copy (C = 64 of 320 rows) plans the same pairs and
    assignment as the whole snapshots."""
    nservers, K, R = 40, 16, 8
    gen = generator(nservers=nservers, K=K, R=R)
    C = reference.slot_sizes(4, 4, nservers * R)[0]
    assert C == 64
    planned = 0
    for _ in range(20):
        gen.bursts()
        frozen = gen.frozen(C)
        # the requester lists stop at the window's servers
        assert sum(bool(v["reqs"]) for v in frozen.values()) == 9
        pairs, asg = _plan(gen.snaps, nservers, K, R)
        f_pairs, f_asg = _plan(frozen, nservers, K, R)
        assert pairs == f_pairs and (asg == f_asg).all()
        gen.consume(pairs)
        planned += len(pairs)
        for s, v in gen.snaps.items():
            assert len(v["reqs"]) == R
            for rank, _, vec in v["reqs"]:
                assert vec == ([5] if rank == 0 else [1, 2, 3, 4])
                assert rank // R == s - TRAFFIC["first_rank"]
    assert planned > 0


def test_cell_finds_its_files_and_readers():
    w, entry = common.find_cell(M, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("gfmc-131k", "gfmc",
                                                       1)
    conf = common.config_file(entry)
    assert conf["kind"] == TRAFFIC["kind"] == "planner"
    assert conf["types"] == TYPES and entry["reduced"] == []
    from benchmark.planner_cell import generator as find

    assert find(TRAFFIC) is Gfmc
    names = {m["name"] for m in common.cell_metrics(M, CELL, "per_layer")}
    assert {"planner.auction_rounds.plan", "planner.type_conflicts.plan",
            "planner.scanned_rows.plan", "auction_roofline"} <= names
    for name in names:
        assert callable(common.metric_reader(name))
    e2e = {m["name"] for m in common.cell_metrics(M, CELL, "end_to_end")}
    assert e2e == {"plan_device_us", "setup_s"}


SMALL = {"servers": 64, "max_requesters": 16, "nshards": 2}


def gfmc_run(**hooks):
    return run_cell(CELL, 2**31 + 5, 1.0, False, device="cpu",
                    t_process=time.perf_counter(), conf_patch=SMALL, **hooks)


def test_sound_run_is_correct_and_control_is_not():
    out = gfmc_run()
    assert out["correct"], out["compared"]
    assert out["compared"]["rounds_checked"]["value"] >= 8
    # every round plans the whole round's work
    assert all(r[5] == 136 for r in out["run"]["rounds"])
    out = gfmc_run(**control.control_hook("planner", 4))
    assert not out["correct"]
    assert out["compared"]["rounds_wrong"]["value"] > 0


def readback_run(args):
    return {"kind": "planner", "rounds": [None] * len(args),
            "program_spans": [("planner:plan.readback", 1.0, 1.001, a)
                              for a in args]}


def test_auction_readers_average_over_the_plans():
    run = readback_run([{"scanned": 513, "rounds": 6, "lost": 128},
                        {"scanned": 513, "rounds": 5, "lost": 120}])
    assert common.metric_reader("planner.auction_rounds.plan")(run) == 5.5
    assert common.metric_reader("planner.type_conflicts.plan")(run) == 124


@pytest.mark.parametrize("name", ["planner.auction_rounds.plan",
                                  "planner.type_conflicts.plan"])
def test_auction_readers_read_nothing_without_the_counts(name):
    read = common.metric_reader(name)
    assert read(readback_run([{"scanned": 2050}])) is None
    assert read({"kind": "planner", "rounds": [], "program_spans": None,
                 "trace": None}) is None
