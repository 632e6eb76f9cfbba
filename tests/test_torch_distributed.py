"""The sharded planner of the port against the JAX package.

The JAX package's sharded solver cannot be built under the installed jax
(its ``shard_map`` calls pass ``check_rep``), so its callable parts are the
oracle: ``_shard_candidates`` called directly (no ``shard_map``), the numpy
twins ``_merge_shard_major``, ``_reqwin`` and ``_host_auction``, and the
single-device ``AssignmentSolver``. ``nshards`` (1, 2, 8) takes the place
of the mesh size. Tolerance: exact equality throughout (integer ids and
priorities).

* candidate generation is bit-equal to ``_shard_candidates``, per shard;
* the host tier (``build_distributed_solver``) equals the reference
  pipeline composed from the parts above;
* the device tier's pair lists equal the host tier's, also across
  mutating rounds, a vanished server and multi-job with a reweight;
* matched requester set and score equal the JAX ``AssignmentSolver``'s;
* churn patches rows without a re-sweep, non-multiple server rows pad,
  deep single-type bursts and shard-mates beyond the sweep window plan,
  a vanished server's rows clear at capacity;
* the view path (array ledger) plans as the tuple path (py ledger) does;
* at the 10,000-server shape, churn reallocates no resident tensor.
"""

import copy
import time

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import jax
import jax.numpy as jnp

from adlb_tpu.balancer import distributed as ref
from adlb_tpu.balancer.solve import AssignmentSolver as RefSolver
from adlb_tpu_torch.balancer import distributed as port
from adlb_tpu_torch.balancer import plan_bench
from adlb_tpu_torch.balancer.distributed import (
    DistributedAssignmentSolver,
    build_distributed_solver,
)
from adlb_tpu_torch.balancer.engine import PlanEngine

TYPES = (1, 2, 3, 4)
NEG = -(2**31) + 1
CLIP = 10**9
MAX_JOBS = 3
JOB_WEIGHTS = {1: 4.0, 2: 0.2}

_ref_cands = jax.jit(ref._shard_candidates, static_argnums=(3, 4))


def _dist(nshards, auction="device", **kw):
    kw.setdefault("types", TYPES)
    return DistributedAssignmentSolver(nshards=nshards, auction=auction,
                                       device="cpu", **kw)


def _rand_job(rng, J):
    if J <= 1 or rng.random() < 0.4:
        return 0
    if rng.random() < 0.08:
        return J  # overflow id: planner-invisible
    return int(rng.integers(1, J))


def _random_snapshots(rng, nservers, ntasks, nreqs, ntypes, J=1):
    types = TYPES[:ntypes]
    snapshots = {}
    seq = 0
    for s in range(100, 100 + nservers):
        tasks = []
        for _ in range(rng.integers(0, ntasks + 1)):
            seq += 1
            tk = (seq, int(rng.choice(types)), int(rng.integers(-9, 10)), 8)
            jb = _rand_job(rng, J)
            tasks.append(tk + (jb,) if jb else tk)
        tasks.sort(key=lambda t: -t[2])
        reqs = []
        for r in range(rng.integers(0, nreqs + 1)):
            rq = ((s - 100) * 50 + r, int(rng.integers(1, 1000)),
                  None if rng.random() < 0.25
                  else sorted({int(rng.choice(types))
                               for _ in range(rng.integers(1, 3))}))
            jb = _rand_job(rng, J)
            reqs.append(rq + (0, jb) if jb else rq)
        snapshots[s] = {"tasks": tasks, "reqs": reqs}
    return snapshots


def _score(pairs, snapshots):
    prio = {(s, t[0]): t[2] for s, snap in snapshots.items()
            for t in snap["tasks"]}
    return sum(prio[(p[0], p[1])] for p in pairs)


def _check_parity(p_dist, p_single, snapshots):
    """Matched requester set and score equal the single-device greedy's;
    no task twice; every pair type-safe."""
    def by_req(pairs):
        return {(p[2], p[3], p[4]) for p in pairs}

    assert by_req(p_dist) == by_req(p_single)
    assert _score(p_dist, snapshots) == _score(p_single, snapshots)
    assert len({(p[0], p[1]) for p in p_dist}) == len(p_dist)
    type_of = {(s, t[0]): t[1] for s, sn in snapshots.items()
               for t in sn["tasks"]}
    masks = {(s, r[0], r[1]): r[2] for s, sn in snapshots.items()
             for r in sn["reqs"]}
    for holder, seqno, req_home, for_rank, rqseqno in p_dist:
        mask = masks[(req_home, for_rank, rqseqno)]
        assert mask is None or type_of[(holder, seqno)] in mask


# ---- candidates and the host tier against the JAX package's parts ----


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_candidates_bit_equal_to_jax_shard_candidates(nshards):
    """Per shard, the port's batched candidates equal the JAX function's:
    prios past the clip (a job bias pushes them there), dead entries,
    entries with no type, and free rows (rank 0)."""
    rng = np.random.default_rng(300 + nshards)
    Sl, K, T = 5, 7, 4
    S = nshards * Sl
    for trial in range(4):
        C, D = ref._slot_sizes(int(rng.integers(1, 20)), 8, 16, 10**6)
        tp = rng.integers(-9, 10, (S, K)).astype(np.int32)
        tp[rng.random((S, K)) < 0.1] = CLIP + 7000  # biased past the clip
        tp[rng.random((S, K)) < 0.1] = -CLIP - 3
        tp[rng.random((S, K)) < 0.2] = NEG  # dead
        tt = rng.integers(-1, T, (S, K)).astype(np.int32)
        rk = rng.permutation(S).astype(np.int32) + 3
        free = rng.random(S) < 0.3
        tp[free] = NEG
        tt[free] = -1
        rk[free] = 0
        cp, cg = port._shard_candidates(
            torch.from_numpy(tp).view(nshards, Sl, K),
            torch.from_numpy(tt).view(nshards, Sl, K),
            torch.from_numpy(rk).view(nshards, Sl), T, D)
        assert cp.dtype == cg.dtype == torch.int32
        assert cp.shape == (nshards, T, D)
        for d in range(nshards):
            blk = slice(d * Sl, (d + 1) * Sl)
            wp, wg = _ref_cands(jnp.asarray(tp[blk]), jnp.asarray(tt[blk]),
                                jnp.asarray(rk[blk]), T, D)
            assert np.array_equal(cp[d].numpy(), np.asarray(wp)), (trial, d)
            assert np.array_equal(cg[d].numpy(), np.asarray(wg)), (trial, d)
        # the device tier's one-sort merge orders as the two-sort twin
        gp, gg = port._merge_candidates(cp, cg)
        wp, wg = ref._merge_shard_major(cp.numpy(), cg.numpy())
        assert np.array_equal(gp.numpy(), wp)
        assert np.array_equal(gg.numpy(), wg)


def _reference_pipeline(nshards, rounds, m, tp, tt, rm, rv):
    """build_distributed_solver as composed from the JAX package's parts."""
    S, K = tp.shape
    NR, T = rm.shape
    pad = (-S) % nshards
    tp = np.concatenate([tp, np.full((pad, K), NEG, np.int32)])
    tt = np.concatenate([tt, np.full((pad, K), -1, np.int32)])
    Sl = tp.shape[0] // nshards
    C, D = ref._slot_sizes(None, m, rounds, NR)
    rk = np.arange(tp.shape[0], dtype=np.int32)
    parts = [_ref_cands(jnp.asarray(tp[d * Sl:(d + 1) * Sl]),
                        jnp.asarray(tt[d * Sl:(d + 1) * Sl]),
                        jnp.asarray(rk[d * Sl:(d + 1) * Sl]), T, D)
             for d in range(nshards)]
    gp, gg = ref._merge_shard_major(np.stack([np.asarray(p) for p, _ in parts]),
                                    np.stack([np.asarray(g) for _, g in parts]))
    rw, lens = ref._reqwin(rm, rv, T, C)
    assigned = ref._host_auction(gp, gg, rw, lens, rv.copy(), rounds, m)
    assign = np.full((NR,), -1, np.int32)
    t_idx, c_idx = np.nonzero(assigned >= 0)
    assign[rw[t_idx, c_idx]] = assigned[t_idx, c_idx]
    return assign


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_host_tier_equals_reference_pipeline(nshards):
    rng = np.random.default_rng(400 + nshards)
    S, K, NR, T = 13, 6, 40, 3  # 13 rows pad to a multiple of 2 and 8
    solve = build_distributed_solver(nshards, rounds=4, cand_width=4,
                                     device="cpu")
    for trial in range(3):
        tp = rng.integers(-9, 10, (S, K)).astype(np.int32)
        tt = rng.integers(0, T, (S, K)).astype(np.int32)
        tp[rng.random((S, K)) < 0.2] = NEG
        rm = rng.random((NR, T)) < 0.5
        rv = rng.random(NR) < 0.8
        got = solve(tp, tt, rm, rv)
        want = _reference_pipeline(nshards, 4, 4, tp, tt, rm, rv)
        assert np.array_equal(got, want), trial
        assert (got >= 0).sum() > 5


def test_auto_pads_non_multiple_server_rows():
    """5 server rows on 8 shards pad instead of raising; padded rows never
    appear in the plan."""
    solve = build_distributed_solver(8, rounds=16, device="cpu")
    S, K, T = 5, 4, 2
    task_prio = np.full((S, K), NEG, np.int32)
    task_type = np.full((S, K), -1, np.int32)
    task_prio[0, :2] = (5, 3)
    task_type[0, :2] = (0, 1)
    task_prio[4, 0] = 9
    task_type[4, 0] = 0
    req_mask = np.zeros((4, T), bool)
    req_valid = np.zeros((4,), bool)
    req_mask[0, 0] = req_valid[0] = True
    req_mask[2] = req_valid[2] = True
    assign = solve(task_prio, task_type, req_mask, req_valid)
    assert assign.tolist() == [4 * K, -1, 0, -1]


# ---- device tier == host tier (the contracts of test_device_auction) ----


def _twins(nshards, ntypes, nservers, rounds=64, **kw):
    sps = max(1, -(-nservers // nshards))
    return tuple(_dist(nshards, tier, types=TYPES[:ntypes],
                       max_tasks_per_server=10, max_requesters=5,
                       rounds=rounds, servers_per_shard=sps, **kw)
                 for tier in ("device", "host"))


@pytest.mark.parametrize("J", [1, MAX_JOBS])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_device_pairs_equal_host_pairs_exactly(nshards, J):
    rng = np.random.default_rng(7000 + nshards + 10 * J)
    kw = dict(max_jobs=J, job_weights=JOB_WEIGHTS) if J > 1 else {}
    planned = 0
    for trial in range(5):
        ntypes = int(rng.integers(1, len(TYPES) + 1))
        nservers = max(nshards, int(rng.integers(1, 4)) * nshards)
        dev, host = _twins(nshards, ntypes, nservers, **kw)
        snaps = _random_snapshots(rng, nservers, 8, 4, ntypes, J=J)
        pairs = dev.solve(snaps, None)
        assert pairs == host.solve(snaps, None)
        planned += len(pairs)
    assert planned > 0


@pytest.mark.parametrize("J", [1, MAX_JOBS])
@pytest.mark.parametrize("nshards", [2, 8])
def test_device_tier_tracks_host_across_mutating_rounds(nshards, J):
    """Task bursts, requester churn, a vanished server at round 3 and (in
    the multi-job arm) a live reweight of both tiers at round 4: the pair
    lists stay identical; a world with no requesters plans nothing."""
    rng = np.random.default_rng(8100 + nshards + 10 * J)
    nservers = 2 * nshards
    kw = dict(max_jobs=J, job_weights=JOB_WEIGHTS) if J > 1 else {}
    dev, host = _twins(nshards, len(TYPES), nservers, **kw)
    snaps = _random_snapshots(rng, nservers, 6, 3, len(TYPES), J=J)
    seq = [10**6]
    for rnd in range(6):
        assert dev.solve(snaps, None) == host.solve(snaps, None), rnd
        ranks = sorted(snaps)
        burst_at = snaps[ranks[rnd % len(ranks)]]
        for _ in range(3):
            seq[0] += 1
            tk = (seq[0], int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
            jb = _rand_job(rng, J)
            burst_at["tasks"].append(tk + (jb,) if jb else tk)
        burst_at["tasks"].sort(key=lambda t: -t[2])
        snaps[ranks[(rnd + 1) % len(ranks)]]["reqs"] = []
        if rnd == 3 and len(snaps) > 1:
            del snaps[ranks[-1]]
        if rnd == 4 and J > 1:
            for sol in (dev, host):
                assert sol.set_job_bias({1: 0.5, 2: 6.0})
    for snap in snaps.values():
        snap["reqs"] = []
    assert dev.solve(snaps, None) == []
    assert host.solve(snaps, None) == []


def test_deep_instance_device_tier_equals_host_tier_with_truncation():
    """More requesters and tasks than C slots per type and few rounds:
    both tiers plan a truncated window, and their pairs agree."""
    rng = np.random.default_rng(77)
    dev, host = (_dist(8, tier, max_tasks_per_server=16, max_requesters=8,
                       rounds=3, cand_width=4, slots_per_type=16,
                       servers_per_shard=4) for tier in ("device", "host"))
    snaps = _random_snapshots(rng, 32, 16, 8, 4)
    pairs = dev.solve(snaps, None)
    assert pairs == host.solve(snaps, None)
    untruncated = _dist(8, max_tasks_per_server=16, max_requesters=8,
                        rounds=64, servers_per_shard=4).solve(snaps, None)
    assert 0 < len(pairs) < len(untruncated)


# ---- parity with the JAX single-device solver (test_sharded_parity) ----


@pytest.mark.parametrize("auction", ["device", "host"])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_parity_fuzz(nshards, auction):
    rng = np.random.default_rng(1000 + nshards)
    for trial in range(6):
        ntypes = int(rng.integers(1, len(TYPES) + 1))
        nservers = max(nshards, int(rng.integers(1, 3)) * nshards)
        dist = _dist(nshards, auction, types=TYPES[:ntypes],
                     max_tasks_per_server=12, max_requesters=6, rounds=64,
                     servers_per_shard=max(1, nservers // nshards))
        single = RefSolver(types=TYPES[:ntypes], max_tasks=12,
                           max_requesters=6)
        snaps = _random_snapshots(rng, nservers, 10, 5, ntypes)
        _check_parity(dist.solve(snaps, None), single.solve(snaps, None),
                      snaps)


@pytest.mark.parametrize("auction", ["device", "host"])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_parity_across_incremental_rounds(nshards, auction):
    """Rounds that consume the plan, add work and re-park keep the
    stateful delta-ingest path equal to a stateless single-device solve."""
    rng = np.random.default_rng(7)
    dist = _dist(nshards, auction, max_tasks_per_server=12,
                 max_requesters=6, rounds=64, servers_per_shard=2)
    single = RefSolver(types=TYPES, max_tasks=12, max_requesters=6)
    snaps = _random_snapshots(rng, 2 * nshards, 8, 4, 4)
    stamp = [1.0]
    for s in snaps:
        snaps[s]["stamp"] = snaps[s]["task_stamp"] = stamp[0]
    seq = [10**6]
    for rnd in range(6):
        p_dist = dist.solve(snaps, None)
        _check_parity(p_dist, single.solve(snaps, None), snaps)
        for holder, seqno, req_home, for_rank, rqseqno in p_dist:
            hs = snaps[holder]
            hs["tasks"] = [t for t in hs["tasks"] if t[0] != seqno]
            stamp[0] += 1
            hs["task_stamp"] = stamp[0]
            rs = snaps[req_home]
            rs["reqs"] = [r for r in rs["reqs"]
                          if not (r[0] == for_rank and r[1] == rqseqno)]
            rs["stamp"] = stamp[0]
        for s in list(snaps)[:2]:
            seq[0] += 1
            snaps[s]["tasks"].append((seq[0], int(rng.choice(TYPES)),
                                      int(rng.integers(-9, 10)), 8))
            snaps[s]["tasks"].sort(key=lambda t: -t[2])
            snaps[s]["reqs"].append(((s - 100) * 50 + 40 + rnd,
                                     int(rng.integers(1, 1000)),
                                     [int(rng.choice(TYPES))]))
            stamp[0] += 1
            snaps[s]["stamp"] = snaps[s]["task_stamp"] = stamp[0]


@pytest.mark.parametrize("auction", ["device", "host"])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_churn_during_planning_no_resweep(nshards, auction):
    """A drain and a join between rounds patch rows (no re-sweep of the
    host tier's candidate lists) and keep single-solver parity."""
    rng = np.random.default_rng(21)
    dist = _dist(nshards, auction, max_tasks_per_server=10,
                 max_requesters=5, rounds=64, servers_per_shard=4)
    single = RefSolver(types=TYPES, max_tasks=10, max_requesters=5)
    nservers = 2 * nshards
    snaps = _random_snapshots(rng, nservers, 6, 3, 4)
    stamp = [1.0]
    for s in snaps:
        snaps[s]["stamp"] = snaps[s]["task_stamp"] = stamp[0]
    next_rank = [100 + nservers]
    seq = [10**6]
    dist.solve(snaps, None)
    sweeps0 = dist.sweep_count
    for rnd in range(5):
        del snaps[sorted(snaps)[rnd % len(snaps)]]
        rank = next_rank[0]
        next_rank[0] += 1
        stamp[0] += 1
        tasks = []
        for _ in range(int(rng.integers(1, 6))):
            seq[0] += 1
            tasks.append((seq[0], int(rng.choice(TYPES)),
                          int(rng.integers(-9, 10)), 8))
        tasks.sort(key=lambda t: -t[2])
        snaps[rank] = {"tasks": tasks,
                       "reqs": [(rank * 50, 1, [int(rng.choice(TYPES))])],
                       "stamp": stamp[0], "task_stamp": stamp[0]}
        _check_parity(dist.solve(snaps, None), single.solve(snaps, None),
                      snaps)
    assert dist.sweep_count == sweeps0
    assert dist.sweep_reasons["delta"] == 0


def test_patch_survives_deep_single_type_burst():
    """A delta whose entries of one type exceed the merged list's capacity
    truncates at the tail, flags a re-sweep and still plans the top of the
    burst (2 shards, K=256, one type)."""
    rng = np.random.default_rng(5)
    K = 256
    dist = _dist(2, "host", types=(1,), max_tasks_per_server=K,
                 max_requesters=4, rounds=16, servers_per_shard=8)
    stamp = [1.0]
    snaps = {100 + s: {"tasks": [], "reqs": [], "stamp": 1.0,
                       "task_stamp": 1.0} for s in range(16)}
    snaps[100]["reqs"] = [(0, 1, [1]), (1, 2, [1])]
    assert dist.solve(snaps, None) == []
    for s in range(10):
        stamp[0] += 1
        snaps[100 + s]["tasks"] = sorted(
            ((s * 1000 + i, 1, int(rng.integers(-50, 50)), 8)
             for i in range(K)), key=lambda t: -t[2])
        snaps[100 + s]["task_stamp"] = stamp[0]
    pairs = dist.solve(snaps, None)
    assert len(pairs) == 2
    prio = {(100 + s, t[0]): t[2] for s in range(10)
            for t in snaps[100 + s]["tasks"]}
    assert sorted(prio[(p[0], p[1])] for p in pairs) == \
        sorted(prio.values())[-2:]


def test_patch_resurfaces_shard_mate_tasks_beyond_sweep_window():
    """A shard-mate's tasks beyond the sweep window resurface in the same
    round the delta drains the shard's top entries."""
    K = 48
    dist = _dist(2, "host", types=(1,), max_tasks_per_server=K,
                 max_requesters=2, rounds=16, servers_per_shard=2)
    snaps = {
        100: {"tasks": [(i + 1, 1, 1000 - i, 8) for i in range(K)],
              "reqs": [], "stamp": 1.0, "task_stamp": 1.0},
        101: {"tasks": [(900, 1, -5, 8), (901, 1, -6, 8)],
              "reqs": [], "stamp": 1.0, "task_stamp": 1.0},
        102: {"tasks": [], "reqs": [(7, 1, [1]), (8, 2, [1])],
              "stamp": 1.0, "task_stamp": 1.0},
        103: {"tasks": [], "reqs": [], "stamp": 1.0, "task_stamp": 1.0},
    }
    p1 = dist.solve(snaps, None)
    assert {(p[0], p[1]) for p in p1} == {(100, 1), (100, 2)}
    snaps[100]["tasks"] = []
    snaps[100]["task_stamp"] = snaps[100]["stamp"] = 2.0
    snaps[102]["reqs"] = [(7, 3, [1]), (8, 4, [1])]
    snaps[102]["stamp"] = 2.0
    p2 = dist.solve(snaps, None)
    p_ref = RefSolver(types=(1,), max_tasks=K, max_requesters=2).solve(
        snaps, None)
    assert {(p[0], p[1]) for p in p2} == {(101, 900), (101, 901)}
    assert {(p[2], p[3], p[4]) for p in p2} == {
        (p[2], p[3], p[4]) for p in p_ref}


@pytest.mark.parametrize("auction", ["device", "host"])
def test_vanished_server_rows_cleared_even_at_capacity(auction):
    dist = _dist(2, auction, types=(1,), max_tasks_per_server=4,
                 max_requesters=2, rounds=16, servers_per_shard=1)
    snaps = {
        100: {"tasks": [(1, 1, 9, 8)], "reqs": [],
              "stamp": 1.0, "task_stamp": 1.0},
        101: {"tasks": [], "reqs": [(5, 1, [1])],
              "stamp": 1.0, "task_stamp": 1.0},
        102: {"tasks": [], "reqs": [], "stamp": 1.0,
              "task_stamp": 1.0},  # beyond capacity: untracked
    }
    assert {(p[0], p[1]) for p in dist.solve(snaps, None)} == {(100, 1)}
    del snaps[100]  # 102 keeps the snapshot count level
    snaps[101]["reqs"] = [(5, 6, [1])]
    snaps[101]["stamp"] = 2.0
    assert dist.solve(snaps, None) == []


@pytest.mark.parametrize("auction", ["device", "host"])
def test_more_servers_than_shards_and_padding(auction):
    """16 servers on 8 shards (two per shard) and 5 servers on 8 shards
    (padded rows): the matched set and score of the single-device greedy."""
    rng = np.random.default_rng(11)
    for nservers, sps in ((16, 2), (5, 1)):
        dist = _dist(8, auction, max_tasks_per_server=8, max_requesters=4,
                     rounds=64, servers_per_shard=sps)
        single = RefSolver(types=TYPES, max_tasks=8, max_requesters=4)
        for trial in range(2):
            snaps = _random_snapshots(rng, nservers, 6, 3, 4)
            _check_parity(dist.solve(snaps, None),
                          single.solve(snaps, None), snaps)


def test_simple_plans_and_constructor_checks():
    dist = _dist(8, types=(1,), max_tasks_per_server=8, max_requesters=4)
    snaps = {100: {"tasks": [(1, 1, 5, 8)], "reqs": []},
             101: {"tasks": [], "reqs": [(0, 1, [1])]}}
    assert dist.solve(snaps, None) == [(100, 1, 101, 0, 1)]
    snaps2 = {100: {"tasks": [], "reqs": [(3, 7, None)]},
              101: {"tasks": [(9, 1, 2, 8)], "reqs": []}}
    assert dist.solve(snaps2, None) == [(101, 9, 100, 3, 7)]
    with pytest.raises(ValueError, match="auction"):
        _dist(2, "bogus", max_tasks_per_server=4, max_requesters=2)
    with pytest.raises(ValueError, match="nshards"):
        _dist(0, max_tasks_per_server=4, max_requesters=2)
    with pytest.raises(ValueError, match="overflows the int32 gid"):
        _dist(1, types=(1,), max_tasks_per_server=4, max_requesters=1) \
            .solve({2**30: {"tasks": [], "reqs": []}}, None)


# ---- view path vs tuple path (test_ledger_parity's sharded arms) ----


def _mk_engine(host_ledger, solver, max_jobs=1, job_weights=None):
    eng = PlanEngine(types=TYPES, max_tasks=12, max_requesters=6,
                     host_ledger=host_ledger, max_jobs=max_jobs,
                     job_weights=job_weights, device="cpu")
    eng.solver = solver
    eng.PUMP_INTERVAL = 0.0
    eng.INFLOW_MIN_AGE = 0.0
    eng.INFLOW_TTL = 1e9
    eng.SUPPRESS_TTL = 1e9
    eng.PARK_RECENT = 1e9
    eng.LOOK_GROW_WINDOW = 1e9
    return eng


def _job_task(rng, seqno, J):
    tk = (seqno, int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
    jb = _rand_job(rng, J)
    return tk + (jb,) if jb else tk


def _rand_snaps(rng, nservers, seq, stamp, J):
    snaps = {}
    for s in range(100, 100 + nservers):
        tasks = []
        for _ in range(int(rng.integers(0, 10))):
            seq[0] += 1
            tasks.append(_job_task(rng, seq[0], J))
        tasks.sort(key=lambda t: -t[2])
        reqs = []
        for r in range(int(rng.integers(0, 5))):
            rq = ((s - 100) * 50 + r, int(rng.integers(1, 1000)),
                  None if rng.random() < 0.2
                  else sorted({int(rng.choice(TYPES))
                               for _ in range(int(rng.integers(1, 3)))}))
            jb = _rand_job(rng, J)
            reqs.append(rq + (0, jb) if jb else rq)
        snaps[s] = {"tasks": tasks, "reqs": reqs,
                    "consumers": int(rng.integers(0, 3)),
                    "stamp": stamp, "task_stamp": stamp}
    return snaps


def _mutate(rng, pair, seq, rnd, matches, J):
    """Consume the plan, then in-place task deltas, dead-rank requester
    patches, a server death and fresh restamps (rejoins included), the
    same on both snapshot dicts."""
    t = time.monotonic()
    for snaps in pair:
        for holder, s_, rh, fr, rq in matches:
            if holder in snaps:
                snaps[holder]["tasks"] = [
                    x for x in snaps[holder]["tasks"] if x[0] != s_]
                snaps[holder]["task_stamp"] = t
            if rh in snaps:
                snaps[rh]["reqs"] = [r for r in snaps[rh]["reqs"]
                                     if not (r[0] == fr and r[1] == rq)]
                snaps[rh]["stamp"] = t
    ranks = sorted(pair[0])
    if rng.random() < 0.7:
        tgt = int(rng.choice(ranks))
        seq[0] += 1
        unit = _job_task(rng, seq[0], J)
        for snaps in pair:
            snaps[tgt]["tasks"].append(unit)
            snaps[tgt]["delta_seq"] = snaps[tgt].get("delta_seq", 0) + 1
    if rng.random() < 0.4:
        tgt = int(rng.choice(ranks))
        dead = int(rng.integers(0, 400))
        for snaps in pair:
            kept = [r for r in snaps[tgt]["reqs"] if r[0] != dead]
            if len(kept) != len(snaps[tgt]["reqs"]):
                snaps[tgt]["reqs"] = kept
                snaps[tgt]["req_seq"] = snaps[tgt].get("req_seq", 0) + 1
    if rng.random() < 0.15 and len(ranks) > 2:
        tgt = int(rng.choice(ranks))
        for snaps in pair:
            snaps.pop(tgt, None)
    t2 = time.monotonic()
    for _ in range(int(rng.integers(1, 3))):
        tgt = 100 + int(rng.integers(0, 8))
        tasks = []
        for _ in range(int(rng.integers(0, 10))):
            seq[0] += 1
            tasks.append(_job_task(rng, seq[0], J))
        tasks.sort(key=lambda x: -x[2])
        rq = ((tgt - 100) * 50 + 20 + rnd, int(rng.integers(1, 1000)),
              [int(rng.choice(TYPES))])
        jb = _rand_job(rng, J)
        reqs = [rq + (0, jb) if jb else rq]
        cons = int(rng.integers(0, 3))
        for snaps in pair:
            snaps[tgt] = {"tasks": list(tasks), "reqs": list(reqs),
                          "consumers": cons, "stamp": t2, "task_stamp": t2}


@pytest.mark.parametrize("J", [1, MAX_JOBS])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_view_path_equals_tuple_path(nshards, J):
    """The array ledger hands the solver a LedgerView (view path), the py
    ledger a filtered snapshot dict (tuple path): the same matches and
    migrations every round, a live reweight at round 7 included."""
    nservers = 2 * nshards if nshards > 4 else 8
    kw = dict(max_jobs=J, job_weights=JOB_WEIGHTS) if J > 1 else {}

    def dist():
        return _dist(nshards, max_tasks_per_server=12, max_requesters=6,
                     rounds=64, servers_per_shard=-(-nservers // nshards),
                     **kw)

    a = _mk_engine("array", dist(), **kw)
    p = _mk_engine("py", dist(), **kw)
    rng = np.random.default_rng(1000 + nshards + 10 * J)
    seq = [0]
    snapsA = _rand_snaps(rng, nservers, seq, time.monotonic(), J)
    snapsP = copy.deepcopy(snapsA)
    planned = 0
    for rnd in range(12):
        if rnd == 7 and J > 1:
            for e in (a, p):
                assert e.set_job_weights({1: 1.0, 2: 5.0})
        mA = a.round(snapsA, None)
        mP = p.round(snapsP, None)
        assert mA == mP, (rnd, mA, mP)
        planned += len(mA[0])
        _mutate(rng, (snapsA, snapsP), seq, rnd, mA[0], J)
    assert planned > 0


# ---- fixed resident state at the 10,000-server shape ----


@pytest.mark.parametrize("J", [1, 2])
def test_no_realloc_at_10k_shape(J):
    """At 10,000 server rows (K=4, R=2, 8 shards) deltas, churn and
    namespace-hopping bursts never reallocate the resident tensors or the
    staging buffers: the port's counterpart of "no retrace"."""
    rng = np.random.default_rng(99 + J)
    kw = dict(max_jobs=J, job_weights={1: 3.0}) if J > 1 else {}
    sol = _dist(8, max_tasks_per_server=4, max_requesters=2, rounds=16,
                servers_per_shard=1250, **kw)
    assert sol.S == 10000
    snaps = {}
    seq = 0
    for s in range(100, 100 + 256):
        seq += 4
        jb = _rand_job(rng, J)
        tk = (seq, int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
        rq = (s * 50, 1, [int(rng.choice(TYPES))])
        snaps[s] = {"tasks": [tk + (jb,) if jb else tk],
                    "reqs": [rq + (0, jb) if jb else rq] if s % 2 else []}
    assert sol.solve(snaps, None)
    ptrs = {n: getattr(sol, n).data_ptr()
            for n in ("_dev_tab",)}
    ptrs.update(rows=sol._rows.dev.data_ptr(),
                req=sol._reqs.table.data_ptr(),
                req_rows=sol._reqs.rows.dev.data_ptr(),
                req_order=sol._reqs.order.dev.data_ptr())
    planned = 0
    for rnd in range(3):
        del snaps[sorted(snaps)[rnd]]
        fresh = 20000 + rnd
        snaps[fresh] = {
            "tasks": [(10**7 + rnd, int(rng.choice(TYPES)), 5, 8)
                      + ((1,) if J > 1 else ())],
            "reqs": [(fresh * 50, 1, None) + ((0, 1) if J > 1 else ())]}
        seq += 1
        first = snaps[sorted(snaps)[0]]
        first["tasks"] = (first["tasks"] + [
            (seq, int(rng.choice(TYPES)), int(rng.integers(-9, 10)), 8)
        ])[: sol.K]
        planned += len(sol.solve(snaps, None))
    now = {"_dev_tab": sol._dev_tab.data_ptr(),
           "rows": sol._rows.dev.data_ptr(),
           "req": sol._reqs.table.data_ptr(),
           "req_rows": sol._reqs.rows.dev.data_ptr(),
           "req_order": sol._reqs.order.dev.data_ptr()}
    assert now == ptrs
    assert planned > 0


def test_plan_bench_device_tier_equals_host_tier_every_round():
    """plan_bench's first row at a few reps, on the CPU: every round's
    device-tier pair list equals the host tier's from the same snapshots."""
    out = plan_bench.run_sweep(scales=[(64, 16, 16)], reps=3, nshards=8,
                               device="cpu", check_host=True)
    row = out["rows"][0]
    assert row["rounds_equal_to_host_tier"] == 3
    assert row["pairs_total"] > 0 and row["plans"] == 4
