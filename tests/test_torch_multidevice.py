"""The sharded planner with its task table split across devices, on the CPU.

``DistributedAssignmentSolver(devices=["cpu"] * n)`` keeps one piece of the
table per device and runs every step of the code that serves cards: each
changed row uploads to its owner's piece, each piece makes its own shard's
candidates, the device tier merges every piece's [2, T, D] lists where they
lie with the merge alone (``merge_runs`` over the list of runs; route
``in_place``, no gather copy), or copies them to the planning device first
on the ``gather`` route, the host tier reads every piece back and merges on
the host. n = 2, 3 and 8 stand for the number of cards. An engine that
shards across devices builds its pieces when it is built.

Oracles, on the same numpy state: the JAX package's pipeline built from its
own functions (``_shard_candidates`` per shard, called without
``shard_map`` since the installed jax cannot build the mesh tier,
``_merge_shard_major``, ``_reqwin``, ``_host_auction``), the port's solver
on as many logical shards, and the JAX single-device ``AssignmentSolver``.
Tolerance: exact equality throughout (the planner's contract is exact:
integer ids and priorities).

The tests named after JAX package tests are their twins here, where the
mesh they need cannot be built: ``test_distributed_solver.py::
test_matches_single_device_solver``, ``::test_more_servers_than_devices``,
``::test_plan_engine_uses_mesh_when_available``, ``test_device_auction.py::
test_multi_job_tiers_track_across_churn_and_reweight`` and
``test_ledger_parity.py::test_parity_sharded_solver_multi_job``.
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
from adlb_tpu_torch import graft_entry
from adlb_tpu_torch.balancer import candidates, plan_bench
from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver
from adlb_tpu_torch.balancer.engine import PlanEngine, shard_placement
from window_churn import assert_windows, live_types
from tests.test_torch_distributed import (
    _check_parity, _mk_engine, _mutate, _rand_job, _rand_snaps,
    _random_snapshots)

TYPES = (1, 2, 3, 4)
NEG = -(2**31) + 1
I32MAX = 2**31 - 1
MAX_JOBS = 3
JOB_WEIGHTS = {1: 4.0, 2: 0.2}

_ref_cands = jax.jit(ref._shard_candidates, static_argnums=(3, 4))


def _multi(n, auction="device", **kw):
    kw.setdefault("types", TYPES)
    return DistributedAssignmentSolver(devices=["cpu"] * n, auction=auction,
                                       device="cpu", **kw)


def _jax_plan(sol):
    """The JAX package's pipeline on the solver's host mirror: per-shard
    candidates, the shard-major merge, the rank-ordered requester windows
    and the host auction. Returns (assigned [T, C], pairs, the windows
    [T, C], their lengths [T]) with the pairs extracted as ``plan()``
    extracts them."""
    Sl, T, D = sol._Sl, sol.T, sol.D
    rk = np.maximum(sol._row_rank, 0).astype(np.int32)
    parts = [_ref_cands(jnp.asarray(sol._tp[d * Sl:(d + 1) * Sl]),
                        jnp.asarray(sol._tt[d * Sl:(d + 1) * Sl]),
                        jnp.asarray(rk[d * Sl:(d + 1) * Sl]), T, D)
             for d in range(sol.nshards)]
    gp, gg = ref._merge_shard_major(
        np.stack([np.asarray(p) for p, _ in parts]),
        np.stack([np.asarray(g) for _, g in parts]))
    rw, lens = ref._reqwin(sol._req_mask, sol._req_valid, T, sol.C,
                           sol._row_perm)
    assigned = ref._host_auction(gp, gg, rw, lens, sol._req_valid.copy(),
                                 sol.rounds, sol.m)
    pairs = []
    t_idx, c_idx = np.nonzero(assigned >= 0)
    for g, rid in zip(assigned[t_idx, c_idx].tolist(),
                      rw[t_idx, c_idx].tolist()):
        rank, ki = divmod(int(g), sol.K)
        si = sol._si.get(rank)
        tref = sol._task_ref[si][ki] if si is not None else None
        rref = sol._req_ref[rid]
        if tref is not None and rref is not None:
            pairs.append((tref[0], tref[1], rref[0], rref[1], rref[2]))
    return assigned, pairs, rw, lens


def _pieces_hold_the_mirror(sol):
    """Every piece's resident rows equal the host mirror's, on the piece's
    own device: prios and types, and the rank of every row with a live slot
    (a freed row whose slots were all dead keeps its old rank: dead slots
    never become candidates, so it is not re-shipped)."""
    K = sol.K
    for p, d in zip(sol._pieces, sol.devices):
        assert p.tab.device == d
        tab = p.tab.numpy()
        rows = slice(p.lo, p.lo + p.rows)
        assert np.array_equal(tab[:, :K], sol._tp[rows])
        assert np.array_equal(tab[:, K:2 * K], sol._tt[rows])
        live = (sol._tp[rows] > NEG).any(axis=1)
        assert np.array_equal(tab[live, 2 * K], sol._row_rank[rows][live])


def _task(rng, seq, J, types=TYPES):
    tk = (seq, int(rng.choice(types)), int(rng.integers(-9, 10)), 8)
    jb = _rand_job(rng, J)
    return tk + (jb,) if jb else tk


def _req(rng, rank, rqseq, J):
    rq = (rank, rqseq, None if rng.random() < 0.2
          else sorted({int(rng.choice(TYPES))
                       for _ in range(int(rng.integers(1, 3)))}))
    jb = _rand_job(rng, J)
    return rq + (0, jb) if jb else rq


# ---- every round against the JAX pipeline and the logical shards ----


@pytest.mark.parametrize("J", [1, 2])
@pytest.mark.parametrize("auction", ["device", "host"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_rounds_equal_the_jax_pipeline_and_logical_shards(n, auction, J):
    """64 mutating rounds over 2n + 1 servers (padded rows: not a multiple
    of n): plans consumed, task bursts in random job namespaces, requesters
    re-parking, a server dying and a new rank rejoining into its freed slot
    every eighth round, a deep single-type burst past D every sixteenth
    and, with two jobs, a reweight at round 20. Each round the assignment
    array and the pair list equal the JAX pipeline's and the logical-shard
    solver's, every piece holds the host mirror's rows and, on the device
    tier, the windows the auction built on the planning device equal the
    JAX pipeline's."""
    rng = np.random.default_rng(9000 + 100 * n + 10 * J + (auction == "host"))
    nservers = 2 * n + 1
    kw = dict(max_tasks_per_server=24, max_requesters=4, rounds=8,
              cand_width=4, slots_per_type=8,
              servers_per_shard=-(-nservers // n))
    if J > 1:
        kw.update(max_jobs=J, job_weights=JOB_WEIGHTS)
    multi = _multi(n, auction, **kw)
    logical = DistributedAssignmentSolver(TYPES, nshards=n, auction=auction,
                                          device="cpu", **kw)
    assert multi.S > nservers and multi.D == 8 + 4 + 1
    seq, rq = [0], [0]
    stamp = [1.0]

    def fresh(rank):
        stamp[0] += 1
        tasks = []
        for _ in range(int(rng.integers(0, 6))):
            seq[0] += 1
            tasks.append(_task(rng, seq[0], J))
        tasks.sort(key=lambda t: -t[2])
        reqs = []
        for i in range(int(rng.integers(0, 4))):
            rq[0] += 1
            reqs.append(_req(rng, rank * 10 + i, rq[0], J))
        return {"tasks": tasks, "reqs": reqs, "stamp": stamp[0],
                "task_stamp": stamp[0]}

    snaps = {100 + s: fresh(100 + s) for s in range(nservers)}
    next_rank = 100 + nservers
    planned = rejoined = 0
    for rnd in range(64):
        if rnd == 20 and J > 1:
            for sol in (multi, logical):
                assert sol.set_job_bias({1: 0.5, 2: 6.0})
        pairs = multi.solve(snaps, None)
        assert pairs == logical.solve(snaps, None), rnd
        assert np.array_equal(multi.last_assigned, logical.last_assigned)
        want_assigned, want_pairs, rw, lens = _jax_plan(multi)
        assert np.array_equal(multi.last_assigned, want_assigned), rnd
        assert pairs == want_pairs, rnd
        if auction == "device" and multi._req_valid.any():
            assert_windows(multi._plan_rows, rw, lens, live_types(multi))
            assert np.array_equal(multi._plan_rows, logical._plan_rows)
            assert multi.last_scanned == logical.last_scanned
        _pieces_hold_the_mirror(multi)
        planned += len(pairs)
        # the data plane consumes the plan
        stamp[0] += 1
        for holder, seqno, req_home, for_rank, rqseqno in pairs:
            hs, rs = snaps[holder], snaps[req_home]
            hs["tasks"] = [t for t in hs["tasks"] if t[0] != seqno]
            hs["task_stamp"] = stamp[0]
            rs["reqs"] = [r for r in rs["reqs"]
                          if not (r[0] == for_rank and r[1] == rqseqno)]
            rs["stamp"] = stamp[0]
        ranks = sorted(snaps)
        for s in rng.choice(ranks, size=2, replace=False).tolist():
            snap = snaps[s]
            for _ in range(int(rng.integers(1, 4))):
                seq[0] += 1
                snap["tasks"].append(_task(rng, seq[0], J))
            snap["tasks"] = sorted(snap["tasks"], key=lambda t: -t[2])[:24]
            rq[0] += 1
            snap["reqs"] = snap["reqs"][-3:] + [_req(rng, s * 10 + 5, rq[0],
                                                     J)]
            snap["stamp"] = snap["task_stamp"] = stamp[0]
        if rnd % 8 == 7:
            # a death, and a new rank taking the freed slot
            del snaps[ranks[int(rng.integers(0, len(ranks)))]]
            snaps[next_rank] = fresh(next_rank)
            next_rank += 1
            rejoined += 1
        if rnd % 16 == 3:
            # deep single-type burst: more live tasks of one type in one
            # shard than the candidate depth D
            s = ranks[int(rng.integers(0, len(ranks)))]
            if s in snaps:
                seq[0] += 24
                snaps[s]["tasks"] = [(seq[0] - i, 2, int(rng.integers(-50, 50)),
                                      8) for i in range(24)]
                snaps[s]["tasks"].sort(key=lambda t: -t[2])
                snaps[s]["task_stamp"] = stamp[0]
    assert planned > 64 and rejoined == 8
    # the first rejoin took a fresh slot (it registers before the death is
    # seen), every later one the slot its round's death freed
    assert multi._next_si == nservers + 1


# ---- twins of the JAX package's mesh tests ----


@pytest.mark.parametrize("auction", ["device", "host"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_matches_single_device_solver(n, auction):
    """The reference contract against the exact single-device greedy:
    identical matched requester set, equal score, type safety, no task
    twice (two types, 8 servers, 64 rounds of the auction)."""
    rng = np.random.default_rng(42 + n)
    multi = _multi(n, auction, types=(1, 2), max_tasks_per_server=16,
                   max_requesters=8, rounds=64,
                   servers_per_shard=-(-8 // n))
    single = RefSolver(types=(1, 2), max_tasks=16, max_requesters=8)
    for trial in range(5):
        snaps = _random_snapshots(rng, 8, 12, 6, 2)
        _check_parity(multi.solve(snaps, None), single.solve(snaps, None),
                      snaps)


@pytest.mark.parametrize("auction", ["device", "host"])
def test_more_servers_than_devices(auction):
    """16 servers on 8 pieces, two a piece, and 13 on 3 (padded rows): the
    single-device greedy's matched set and score."""
    rng = np.random.default_rng(7)
    for nservers, n in ((16, 8), (13, 3)):
        multi = _multi(n, auction, types=(1, 2), max_tasks_per_server=8,
                       max_requesters=4, rounds=64,
                       servers_per_shard=-(-nservers // n))
        single = RefSolver(types=(1, 2), max_tasks=8, max_requesters=4)
        for trial in range(3):
            snaps = _random_snapshots(rng, nservers, 6, 3, 2)
            _check_parity(multi.solve(snaps, None),
                          single.solve(snaps, None), snaps)


def test_plan_engine_uses_mesh_when_available():
    """PlanEngine(use_mesh=True) over a placement puts one shard on each
    entry and plans cross-server matches (here four CPU pieces; on a card
    host the placement is every visible card, see shard_placement)."""
    engine = PlanEngine(types=(1, 2), max_tasks=8, max_requesters=4,
                        use_mesh=True, nservers=4, device="cpu",
                        devices=["cpu"] * 4)
    sol = engine.solver
    assert isinstance(sol, DistributedAssignmentSolver)
    assert sol.nshards == 4 and sol.devices == [torch.device("cpu")] * 4
    snaps = {
        100: {"tasks": [(1, 1, 5, 8), (2, 2, 3, 8)], "reqs": [],
              "nbytes": 16, "consumers": 1},
        101: {"tasks": [], "reqs": [(7, 1, [1]), (8, 2, [2])],
              "nbytes": 0, "consumers": 2},
    }
    matches, migrations = engine.round(snaps, None)
    assert len(matches) == 2
    for holder, seqno, req_home, for_rank, rqseqno in matches:
        assert holder == 100 and req_home == 101
    assert len(sol._pieces) == 4


@pytest.mark.parametrize("n", [2, 3, 8])
def test_multi_job_tiers_track_across_churn_and_reweight(n):
    """Task bursts in random namespaces, a server vanishing at round 3, a
    reweight of both tiers at round 4: the device tier's pair lists and
    assignments equal the host tier's every round."""
    rng = np.random.default_rng(9400 + n)
    nservers = 2 * n
    dev, host = (_multi(n, tier, max_tasks_per_server=10, max_requesters=5,
                        rounds=64, servers_per_shard=2, max_jobs=MAX_JOBS,
                        job_weights=JOB_WEIGHTS)
                 for tier in ("device", "host"))
    snaps = _random_snapshots(rng, nservers, 6, 3, len(TYPES), J=MAX_JOBS)
    seq = [10**6]
    for rnd in range(6):
        assert dev.solve(snaps, None) == host.solve(snaps, None), rnd
        assert np.array_equal(dev.last_assigned, host.last_assigned)
        ranks = sorted(snaps)
        burst_at = snaps[ranks[rnd % len(ranks)]]
        for _ in range(3):
            seq[0] += 1
            burst_at["tasks"].append(_task(rng, seq[0], MAX_JOBS))
        burst_at["tasks"].sort(key=lambda t: -t[2])
        snaps[ranks[(rnd + 1) % len(ranks)]]["reqs"] = []
        if rnd == 3:
            del snaps[ranks[-1]]
        if rnd == 4:
            for sol in (dev, host):
                assert sol.set_job_bias({1: 0.5, 2: 6.0})


@pytest.mark.parametrize("n", [2, 3, 8])
def test_parity_sharded_solver_multi_job(n):
    """The array ledger's view path and the py ledger's tuple path plan the
    same matches and migrations over a solver split across n pieces, with
    death and rejoin churn and a reweight at round 7."""
    nservers = 2 * n if n > 4 else 8
    kw = dict(max_jobs=MAX_JOBS, job_weights=JOB_WEIGHTS)

    def solver():
        return _multi(n, max_tasks_per_server=12, max_requesters=6,
                      rounds=64, servers_per_shard=-(-nservers // n), **kw)

    a = _mk_engine("array", solver(), **kw)
    p = _mk_engine("py", solver(), **kw)
    rng = np.random.default_rng(2000 + n)
    seq = [0]
    snapsA = _rand_snaps(rng, nservers, seq, time.monotonic(), MAX_JOBS)
    snapsP = copy.deepcopy(snapsA)
    planned = 0
    for rnd in range(14):
        if rnd == 7:
            for e in (a, p):
                assert e.set_job_weights({1: 1.0, 2: 5.0})
        mA = a.round(snapsA, None)
        mP = p.round(snapsP, None)
        assert mA == mP, (rnd, mA, mP)
        planned += len(mA[0])
        _mutate(rng, (snapsA, snapsP), seq, rnd, mA[0], MAX_JOBS)
    assert planned > 0


# ---- the pieces, the gather and the merge alone ----


def _sorted_runs(rng, n, T, D, share=None):
    """n runs [n, T, D] as kernel A leaves them: each sorted (prio desc,
    gid asc) and padded, a random live length (at most ``share`` of D when
    given), many ties in prio broken by gid, run 0's first pair held by
    every other run too."""
    cp = np.full((n, T, D), NEG, np.int32)
    cg = np.full((n, T, D), I32MAX, np.int32)
    for q in range(n):
        for t in range(T):
            top = D if share is None else int(share * D)
            live = int(rng.integers(0, top + 1))
            p = rng.integers(-3, 3, live)
            g = rng.integers(0, 4 * D, live)
            if q and live and cp[0, t, 0] > NEG:
                p[0], g[0] = cp[0, t, 0], cg[0, t, 0]  # run 0 holds it
            o = np.lexsort((g, -p))
            cp[q, t, :live], cg[q, t, :live] = p[o], g[o]
    return cp, cg


def _separate_runs(cp, cg):
    """Each run in its own [2, T, D] tensor (separately allocated, as the
    pieces' candidate lists are)."""
    return [torch.from_numpy(np.stack([cp[q], cg[q]])) for q in
            range(cp.shape[0])]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_merge_alone_equals_merge_shard_major_cut_to_d(n):
    """The merge alone's plain version against the JAX package's
    ``_merge_shard_major`` cut to D: runs sorted (prio desc, gid asc),
    short runs padded, many ties in prio broken by gid, equal pairs in
    different runs; dispatched on CPU tensors by ``merge_runs``."""
    rng = np.random.default_rng(50 + n)
    for T, D in ((1, 1), (3, 7), (8, 545)):
        cp, cg = _sorted_runs(rng, n, T, D)
        want_p, want_g = ref._merge_shard_major(cp, cg)
        gp, gg = candidates.merge_runs(_separate_runs(cp, cg), D)
        assert gp.shape == (T, D) and gp.dtype == torch.int32
        assert np.array_equal(gp.numpy(), want_p[:, :D])
        assert np.array_equal(gg.numpy(), want_g[:, :D])


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("T,D", [(1, 1), (3, 7), (8, 545)])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_merge_over_separate_runs_equals_stacked_and_shard_major(n, T, D,
                                                                 share):
    """``merge_runs`` and ``merge_runs_torch`` over a list of separately
    allocated runs (each [2, T, D], one a strided view of a larger buffer)
    equal the stacked form (one [n, T, D] merge, ``_merge_candidates``, cut
    to D) and the JAX package's ``_merge_shard_major`` cut to D; the live
    share of each run at most ``share``."""
    rng = np.random.default_rng(7000 + 100 * n + 10 * T + int(10 * share))
    cp, cg = _sorted_runs(rng, n, T, D, share)
    runs = _separate_runs(cp, cg)
    if n > 1:  # run 1 as a view into a bigger allocation, like a piece's
        big = torch.full((2, 3, T, D), 5, dtype=torch.int32)
        big[:, 1] = runs[1]
        runs[1] = big[:, 1]
    want = [x[:, :D] for x in ref._merge_shard_major(cp, cg)]
    sp, sg = candidates._merge_candidates(torch.from_numpy(cp),
                                          torch.from_numpy(cg))
    stacked = (sp[:, :D], sg[:, :D])
    for got in (candidates.merge_runs(runs, D),
                candidates.merge_runs_torch(runs, D)):
        for g, s_, w in zip(got, stacked, want):
            assert g.shape == (T, D) and g.dtype == torch.int32
            assert torch.equal(g, s_)
            assert np.array_equal(g.numpy(), w)


def test_merge_alone_refuses_what_the_kernel_does_not_take():
    run = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        candidates.merge_runs([run.long(), run.long()], 5)
    with pytest.raises(ValueError, match=r"\[2, T=3, D=4\]"):
        candidates.merge_runs([run, run], 4)
    with pytest.raises(ValueError, match=r"\[2, T=3, D=5\]"):
        candidates.merge_runs([run, torch.zeros((2, 4, 5),
                                                dtype=torch.int32)], 5)
    with pytest.raises(ValueError, match="contiguous"):
        candidates.merge_runs([run, run.transpose(1, 2).contiguous()
                               .transpose(1, 2)], 5)
    with pytest.raises(ValueError, match="at least one run"):
        candidates.merge_runs_torch([], 5)


@pytest.mark.parametrize("auction", ["device", "host"])
def test_a_changed_row_uploads_to_its_owner_piece_only(auction):
    """One task change on one server ships one row to the piece that owns
    its slot; no other piece is touched."""
    sol = _multi(3, auction, types=(1,), max_tasks_per_server=4,
                 max_requesters=2, servers_per_shard=2)
    snaps = {100 + s: {"tasks": [(s + 1, 1, s, 8)], "reqs": [],
                       "stamp": 1.0, "task_stamp": 1.0} for s in range(6)}
    snaps[100]["reqs"] = [(0, 1, [1])]
    sol.solve(snaps, None)
    before = [p.uploads for p in sol._pieces]
    owner = sol._si[104] // 2
    snaps[104]["tasks"] = [(50, 1, 40, 8)]
    snaps[104]["task_stamp"] = 2.0
    assert sol.solve(snaps, None) == [(104, 50, 100, 0, 1)]
    after = [p.uploads for p in sol._pieces]
    assert [a - b for a, b in zip(after, before)] == [
        int(i == owner) for i in range(3)]
    _pieces_hold_the_mirror(sol)


def test_a_device_plan_is_one_candidates_call_per_piece_and_one_merge(
        monkeypatch):
    """A device-tier round across n pieces: n per-shard candidate calls
    (kernel A on each card), one call of the merge alone and one auction
    (which builds the requester windows), all on their pieces' devices; the
    host tier's sweep reads every piece."""
    from adlb_tpu_torch.balancer import distributed as dist

    calls = {"shard": [], "merge": 0, "auction": 0}
    shard, merge, auct = (candidates.shard_candidates, candidates.merge_runs,
                          dist._auction.auction_windows)

    def count_shard(tp, *a, **k):
        calls["shard"].append(tp.shape[0])
        return shard(tp, *a, **k)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(candidates, "shard_candidates", count_shard)
    monkeypatch.setattr(candidates, "merge_runs", count("merge", merge))
    monkeypatch.setattr(dist._auction, "auction_windows",
                        count("auction", auct))
    sol = _multi(3, types=(1, 2), max_tasks_per_server=4, max_requesters=2,
                 servers_per_shard=2)
    snaps = {100 + s: {"tasks": [(s + 1, 1 + s % 2, s, 8)],
                       "reqs": [(s, 1, None)] if s % 3 == 0 else []}
             for s in range(6)}
    copies = candidates.gather_copies
    assert sol.solve(snaps, None)
    assert calls == {"shard": [1, 1, 1], "merge": 1, "auction": 1}
    assert sol.merge_route == "in_place" and sol._gathered is None
    assert sol.gather_copies == 0 and candidates.gather_copies == copies
    counts = sol.planner_counts()
    assert (counts["merge_route"], counts["gather_copies"],
            counts["device_plans"], counts["device_windows"]) == (
                "in_place", 0, 1, 1)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_gather_route_plans_what_the_in_place_route_plans(n):
    """A solver forced to the ``gather`` route (the route of a placement
    without peer access) over n CPU pieces: every round of plan_bench's
    first row equal to the host tier and the logical shards, the runs
    copied once a device plan into its [n, 2, T, D] buffer, reported as
    such; the default route copies nothing."""
    kept = []
    copies = candidates.gather_copies
    plan_bench.run_sweep(scales=[(64, 16, 16)], reps=4, devices=["cpu"] * n,
                         device="cpu", check_host=True, check_logical=True,
                         merge_route="gather",
                         on_row=lambda s, r: kept.append(s))
    sol = kept[0]
    assert sol.merge_route == "gather"
    assert sol._gathered.shape == (n, 2, sol.T, sol.D)
    assert sol.gather_copies == n * sol.solve_count > 0
    assert candidates.gather_copies - copies == sol.gather_copies
    assert sol.planner_counts()["merge_route"] == "gather"
    with pytest.raises(ValueError, match="merge_route"):
        _multi(n, max_tasks_per_server=4, max_requesters=2,
               merge_route="peer")


def test_plan_engine_across_pieces_builds_them_at_construction():
    """``PlanEngine(use_mesh=True)`` with a placement builds the sharded
    solver's pieces, its merge and its requester tables when the engine is
    built, as the JAX engine builds its mesh: no planning round pays for
    them. A bare solver stays unbuilt until :meth:`warm` or its first
    ingest."""
    eng = PlanEngine(types=(1, 2), max_tasks=8, max_requesters=4,
                     use_mesh=True, nservers=6, device="cpu",
                     devices=["cpu"] * 3)
    sol = eng.solver
    assert isinstance(sol, DistributedAssignmentSolver)
    assert [p.tab.device.type for p in sol._pieces] == ["cpu"] * 3
    assert sol._reqs is not None and sol.merge_route == "in_place"
    bare = _multi(3, types=(1, 2), max_tasks_per_server=8, max_requesters=4)
    assert bare._pieces is None and bare.merge_route is None
    bare.warm()
    pieces = bare._pieces
    bare.warm()
    assert bare._pieces is pieces and len(pieces) == 3


def test_mixed_or_mismatched_placements_raise():
    with pytest.raises(ValueError, match="one device type"):
        _multi_with(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="one shard per device"):
        DistributedAssignmentSolver(TYPES, 4, 2, nshards=3,
                                    devices=["cpu"] * 2, device="cpu")
    with pytest.raises(ValueError, match="planning device"):
        DistributedAssignmentSolver(TYPES, 4, 2, devices=["cpu"] * 2,
                                    device="cuda")


def _multi_with(devices):
    return DistributedAssignmentSolver(TYPES, 4, 2, devices=devices,
                                       device="cpu")


def test_engine_placement_helper():
    """One shard per visible card: none on one card or on the CPU (the
    single-device solver plans), four shards of 2,500 servers on four
    cards at the 10k row."""
    assert shard_placement("cuda", 1, 10_000) == (None, 1)
    assert shard_placement("cpu", 4, 10_000) == (None, 1)
    devices, sps = shard_placement("cuda", 4, 10_000)
    assert devices == [torch.device("cuda", i) for i in range(4)]
    assert sps == 2_500
    assert shard_placement("cuda", 8, 5) == (
        [torch.device("cuda", i) for i in range(8)], 1)
    assert shard_placement("cuda", 3, 10_000)[1] == 3_334  # padded rows


def test_plan_engine_on_the_cpu_keeps_the_single_device_solver():
    from adlb_tpu_torch.balancer.solve import AssignmentSolver

    engine = PlanEngine(types=(1, 2), max_tasks=8, max_requesters=4,
                        use_mesh=True, nservers=4, device="cpu")
    assert isinstance(engine.solver, AssignmentSolver)


def test_dryrun_multichip_on_the_cpu_keeps_logical_shards():
    got = graft_entry.dryrun_multichip(8, device="cpu")
    assert got["placement"] is None
    assert got["pairs"] and got["matches"] and got["migrations"]


def test_plan_bench_across_pieces_equals_host_tier_and_logical_shards():
    """plan_bench's first row over three CPU pieces: every round's plan
    equals the host tier's (across the same pieces) and the logical-shard
    solver's, pair lists and assignment arrays."""
    out = plan_bench.run_sweep(scales=[(64, 16, 16)], reps=4,
                               devices=["cpu"] * 3, device="cpu",
                               check_host=True, check_logical=True)
    row = out["rows"][0]
    assert out["nshards"] == 3 and out["devices"] == ["cpu"] * 3
    assert row["rounds_equal_to_host_tier"] == 4
    assert row["rounds_equal_to_logical"] == 4
    assert row["pairs_total"] > 0 and "ingest_p99_ms" in row
