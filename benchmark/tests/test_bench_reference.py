"""The frozen reference agrees with the port on small seeded instances
(the port's plain versions on the CPU): every planning round's pairs and
assignment."""

import numpy as np
import pytest

from benchmark import reference
from benchmark.churn import Churn

TYPES = (1, 2, 3, 4)


def planner(S, K, R, nshards, rounds=4, m=3):
    from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver

    return DistributedAssignmentSolver(
        TYPES, K, R, nshards=nshards, rounds=rounds,
        servers_per_shard=-(-S // nshards), cand_width=m, auction="device",
        device="cpu")


def random_snaps(rng, S, K, R, first=10):
    """Tasks of every type at many priorities, requesters that accept one,
    several or any type: cross-type conflicts, ties and truncation."""
    snaps = {}
    seq = 0
    for s in range(S):
        tasks = []
        for _ in range(int(rng.integers(0, K + 4))):
            tasks.append((seq, int(rng.choice(TYPES + (9,))),
                          int(rng.integers(-3, 4)), 8))
            seq += 1
        reqs = []
        for i in range(int(rng.integers(0, R + 3))):
            kind = rng.integers(0, 4)
            types = None if kind == 0 else sorted(
                {int(x) for x in rng.choice(TYPES, size=int(kind))})
            reqs.append((1000 + s * 50 + i, i + 1, types))
        snaps[first + 3 * s] = {"tasks": tasks, "reqs": reqs}
    return snaps


@pytest.mark.parametrize("nshards", [1, 2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_planner_rounds_equal_on_random_tables(nshards, seed):
    rng = np.random.default_rng(seed)
    S, K, R = 12, 6, 5
    solver = planner(S, K, R, nshards)
    for _ in range(4):  # the same solver over changing tables
        snaps = random_snaps(rng, S, K, R)
        solver.ingest(snaps)
        pairs = solver.plan()
        ref_pairs, ref_asg = reference.plan_from_snapshots(
            snaps, TYPES, K, R, solver.S, 4, 3)
        assert pairs == ref_pairs
        if ref_asg is not None:
            assert np.array_equal(solver.last_assigned, ref_asg)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
@pytest.mark.parametrize("S,R,rounds,m", [(40, 6, 6, 4), (60, 20, 2, 2)])
def test_planner_rounds_equal_under_churn(seed, S, R, rounds, m):
    """Plans under churn; in the second shape every type has more
    requesters than C, so the check's copy stops short of the last
    servers' requesters."""
    params = {"first_rank": 100, "delta_servers": 4, "burst": 8,
              "prio_range": [-5, 5]}
    K = 8
    solver = planner(S, K, R, 4, rounds=rounds, m=m)
    gen = Churn(params, S, K, R, TYPES, seed)
    solver.ingest(gen.snaps)
    solver.plan()
    for _ in range(12):
        gen.bursts()
        whole = {s: dict(v) for s, v in gen.snaps.items()}
        frozen = gen.frozen(reference.slot_sizes(m, rounds, solver.S * R)[0])
        solver.ingest(gen.snaps)
        pairs = solver.plan()
        ref_pairs, ref_asg = reference.plan_from_snapshots(
            frozen, TYPES, K, R, solver.S, rounds, m)
        assert pairs and pairs == ref_pairs
        assert np.array_equal(solver.last_assigned, ref_asg)
        # the copy holds what the plan can read: the whole snapshots give
        # the same plan
        assert (ref_pairs, ref_asg.tolist()) == tuple(
            x if i == 0 else x.tolist() for i, x in enumerate(
                reference.plan_from_snapshots(whole, TYPES, K, R, solver.S,
                                              rounds, m)))
        gen.consume(pairs)


def test_control_differs_from_reference():
    rng = np.random.default_rng(5)
    snaps = random_snaps(rng, 12, 6, 5)
    a = reference.plan_from_snapshots(snaps, TYPES, 6, 5, 12, 4, 3)[0]
    b = reference.plan_from_snapshots(snaps, TYPES, 6, 5, 12, 4, 3, 4)[0]
    assert a != b


def test_frozen_copy_stops_at_the_window():
    params = {"first_rank": 100, "delta_servers": 4, "burst": 8,
              "prio_range": [-5, 5]}
    gen = Churn(params, 60, 8, 20, TYPES, 1)
    gen.round = 12  # this round's bursts land on servers 48 to 51
    gen.bursts()
    frozen = gen.frozen(64)
    assert len(frozen) < 60
    assert any(not v["reqs"] for v in frozen.values())  # a holder past it
