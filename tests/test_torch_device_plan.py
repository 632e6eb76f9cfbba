"""The sharded planner's device plan, as two kernels' plain versions, against
the JAX package (all on the CPU).

A device plan is one launch of ``csrc/candidates.cu`` (every shard's top-D
candidates of each type and their cross-shard merge, cut to [T, D]) and one
launch of ``csrc/auction.cu`` over those [T, D] lists. On the CPU both run
their plain versions, which this file holds against the JAX package's
``_shard_candidates`` (jitted on the CPU, one shard at a time: its
``shard_map`` tier cannot be built under the installed jax), its numpy merge
``_merge_shard_major`` and its numpy auction ``_host_auction`` over the full
[T, nshards * D] merge. Instances come from a numpy seed and are
parametrised over nshards in {1, 2, 8}, jobs J in {1, 2} (T = 4 J types,
prios biased past the clip as a job weight biases them) and with and
without truncation (more than D live slots of a type in a shard). Exact
equality throughout: priorities and ids are integers.

The requester windows the auction builds in its prologue from the
resident requester table (``auction_windows``; on the CPU ``windows_torch``)
are held to the JAX package's ``_reqwin`` on the solver's host mirror, and
the plans over them to the host tier's, over churn rounds
(``window_churn.py``: joins and leaves, any-type requesters, multi-job
composite types, a type too rare to fill its window, an empty requester
table) at 1, 2 and 8 shards, and on random tables with several mask words a
row.

The tie rule the kernel relies on is pinned too: equal keys are equal
(prio, gid) pairs, so the candidates do not depend on which of two slots
with the same pair comes first, and the solver's live gids are unique
anyway (ranks are unique, gid = rank * K + ki).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import jax
import jax.numpy as jnp

from adlb_tpu.balancer import distributed as ref
from adlb_tpu_torch.balancer import auction, candidates
from adlb_tpu_torch.balancer import distributed as port
from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver
from adlb_tpu_torch.runtime.trace import Tracer
from window_churn import (CASES as CHURN_CASES, WindowChurn, assert_windows,
                          check_windows, host_reach, live_types,
                          random_windows, solver_kwargs)

NEG = -(2**31) + 1
CLIP = 10**9

_ref_cands = jax.jit(ref._shard_candidates, static_argnums=(3, 4))


def _instance(seed, nshards, J, trunc, Sl=10, K=8):
    """A task table cut into shards, laid out as the solver keeps it (one
    [S, 2K + 1] table: prios, types, rank; the shards are strided views),
    plus requester tables. Truncated instances have D = C + m + 1 below the
    live slots of a type in a shard."""
    rng = np.random.default_rng(seed)
    T = 4 * J
    S = nshards * Sl
    tp = rng.integers(-9, 10, (S, K)).astype(np.int32)
    if J > 1:
        tp[rng.random((S, K)) < 0.15] = CLIP + 7000  # a job bias past the clip
        tp[rng.random((S, K)) < 0.1] = -CLIP - 3
    tt = rng.integers(-1, T, (S, K)).astype(np.int32)
    tp[rng.random((S, K)) < 0.15] = NEG
    rk = rng.permutation(S).astype(np.int32) + 3
    free = rng.random(S) < 0.2
    tp[free], tt[free], rk[free] = NEG, -1, 0
    m, rounds = (1, 4) if trunc else (4, 8)
    NR = S * 3
    C, D = port._slot_sizes(1 if trunc else None, m, rounds, NR)
    tab = torch.empty((S, 2 * K + 1), dtype=torch.int32)
    tab[:, :K], tab[:, K:2 * K] = torch.from_numpy(tp), torch.from_numpy(tt)
    tab[:, 2 * K] = torch.from_numpy(rk)
    views = (tab[:, :K].reshape(nshards, Sl, K),
             tab[:, K:2 * K].reshape(nshards, Sl, K),
             tab[:, 2 * K].reshape(nshards, Sl))
    rv = rng.random(NR) < 0.85
    rm = rng.random((NR, T)) < 0.4
    return dict(tp=tp, tt=tt, rk=rk, views=views, T=T, C=C, D=D, m=m,
                rounds=rounds, rm=rm, rv=rv, Sl=Sl, nshards=nshards)


def _jax_candidates(inst):
    """The JAX package's candidates, one shard at a time: [nshards, T, D]."""
    Sl, T, D = inst["Sl"], inst["T"], inst["D"]
    parts = []
    for d in range(inst["nshards"]):
        blk = slice(d * Sl, (d + 1) * Sl)
        parts.append(_ref_cands(jnp.asarray(inst["tp"][blk]),
                                jnp.asarray(inst["tt"][blk]),
                                jnp.asarray(inst["rk"][blk]), T, D))
    return (np.stack([np.asarray(p) for p, _ in parts]),
            np.stack([np.asarray(g) for _, g in parts]))


CASES = [(ns, J, trunc) for ns in (1, 2, 8) for J in (1, 2)
         for trunc in (False, True)]


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_plain_candidates_equal_jax_shard_candidates(nshards, J, trunc):
    inst = _instance(10 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, D = inst["T"], inst["D"]
    cp, cg = candidates.shard_candidates(*inst["views"], T, D)
    wp, wg = _jax_candidates(inst)
    assert cp.shape == (nshards, T, D) and cp.dtype == torch.int32
    assert np.array_equal(cp.numpy(), wp) and np.array_equal(cg.numpy(), wg)
    live = (inst["tp"] > NEG) & (inst["tt"] >= 0)
    per = [int((live[d * inst["Sl"]:(d + 1) * inst["Sl"]]
                & (inst["tt"][d * inst["Sl"]:(d + 1) * inst["Sl"]] == t))
               .sum()) for d in range(nshards) for t in range(T)]
    assert (max(per) > D) == trunc


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_plain_merge_equals_first_d_columns_of_jax_merge(nshards, J, trunc):
    inst = _instance(20 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, D = inst["T"], inst["D"]
    gp, gg = candidates.merged_candidates(*inst["views"], T, D)
    wp, wg = ref._merge_shard_major(*_jax_candidates(inst))
    assert gp.shape == (T, D) and gp.is_contiguous()
    assert np.array_equal(gp.numpy(), wp[:, :D])
    assert np.array_equal(gg.numpy(), wg[:, :D])
    if trunc and nshards > 1:
        # the cut drops live entries: [T, D] is not the whole merge
        assert ((wp > NEG).sum(axis=1) > D).any()


@pytest.mark.parametrize("nshards,J,trunc", CASES)
def test_auction_over_t_by_d_equals_jax_host_auction(nshards, J, trunc):
    inst = _instance(30 * nshards + J + 100 * trunc, nshards, J, trunc)
    T, C, D, m, rounds = (inst[k] for k in ("T", "C", "D", "m", "rounds"))
    gp, gg = candidates.merged_candidates(*inst["views"], T, D)
    rw, lens = ref._reqwin(inst["rm"], inst["rv"], T, C)
    rwc, open0 = port._compact_reqwin(rw)
    got = auction.auction_torch(gp, gg, torch.from_numpy(rwc),
                                torch.from_numpy(lens),
                                torch.from_numpy(open0), rounds, m)
    wp, wg = ref._merge_shard_major(*_jax_candidates(inst))
    want = ref._host_auction(wp, wg, rw, lens, inst["rv"].copy(), rounds, m)
    assert np.array_equal(got.numpy()[:, :C], want)
    assert (got.numpy()[:, C] == -1).all() and (want >= 0).sum() > 0


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_equal_pairs_make_the_candidates_independent_of_slot_order(nshards):
    """Slots that repeat a (prio, gid) pair (ranks repeated) give the same
    candidates whatever order the shard's rows are in, and the same as the
    JAX package's stable sort: which of two equal keys survives a cut does
    not show in the output."""
    rng = np.random.default_rng(40 + nshards)
    Sl, K, T, D = 8, 6, 3, 5
    S = nshards * Sl
    tp = rng.integers(0, 2, (S, K)).astype(np.int32)
    tt = rng.integers(0, T, (S, K)).astype(np.int32)
    rk = rng.integers(0, 3, S).astype(np.int32)  # many equal gids
    got = candidates.shard_candidates(
        torch.from_numpy(tp).view(nshards, Sl, K),
        torch.from_numpy(tt).view(nshards, Sl, K),
        torch.from_numpy(rk).view(nshards, Sl), T, D)
    perm = np.concatenate([d * Sl + rng.permutation(Sl)
                           for d in range(nshards)])
    shuffled = candidates.shard_candidates(
        torch.from_numpy(tp[perm]).view(nshards, Sl, K),
        torch.from_numpy(tt[perm]).view(nshards, Sl, K),
        torch.from_numpy(rk[perm]).view(nshards, Sl), T, D)
    inst = dict(tp=tp, tt=tt, rk=rk, Sl=Sl, T=T, D=D, nshards=nshards)
    want = _jax_candidates(inst)
    for g, s, w in zip(got, shuffled, want):
        assert torch.equal(g, s) and np.array_equal(g.numpy(), w)
    # the cut is binding and repeats a pair at its edge in some shard/type
    assert (got[0] > NEG).sum() == nshards * T * D


def test_solver_live_gids_are_unique_across_slot_reuse():
    """The solver's resident table never holds two live slots with one gid:
    ranks are unique per row, rows are free-listed (a freed row is dead
    before its next tenant arrives), and gid = rank * K + ki."""
    rng = np.random.default_rng(5)
    sol = DistributedAssignmentSolver((1, 2, 3), 4, 2, nshards=4,
                                      servers_per_shard=3, device="cpu")
    snaps = {}
    for rnd in range(12):
        for s in list(snaps):
            if rng.random() < 0.3:
                del snaps[s]  # a server leaves: its row is freed
        while len(snaps) < sol.S:
            s = int(rng.integers(100, 200))
            snaps[s] = {"tasks": [(int(rng.integers(1e6)), int(t), 1, 8)
                                  for t in rng.integers(1, 4, 4)],
                        "reqs": [(s * 10, rnd, None)]}
        sol.solve(snaps, None)
        tab = sol._dev_tab.numpy()
        K = sol.K
        live = (tab[:, :K] > NEG) & (tab[:, K:2 * K] >= 0)
        gids = (tab[:, 2 * K:2 * K + 1].astype(np.int64) * K
                + np.arange(K))[live]
        assert gids.size and np.unique(gids).size == gids.size, rnd


def test_device_plan_is_candidates_then_auction_on_the_cpu():
    """``_device_plan`` hands the auction the [T, D] merged candidates, and
    its commits equal the host tier's full-merge auction on the same
    state."""
    rng = np.random.default_rng(9)
    kw = dict(types=(1, 2, 3, 4), max_tasks_per_server=6, max_requesters=3,
              nshards=8, servers_per_shard=2, rounds=6, cand_width=3,
              slots_per_type=4, device="cpu")
    dev = DistributedAssignmentSolver(auction="device", **kw)
    host = DistributedAssignmentSolver(auction="host", **kw)
    snaps = {100 + s: {"tasks": [(s * 10 + i, int(rng.integers(1, 5)),
                                  int(rng.integers(-5, 5)), 8)
                                 for i in range(6)],
                       "reqs": [(s, 1, [int(rng.integers(1, 5))])]}
             for s in range(16)}
    assert dev.D == 4 + 3 + 1
    for sol in (dev, host):
        sol.ingest(snaps)
    a_dev = dev._device_plan()
    host._sweep()
    a_host = ref._host_auction(host._gp, host._gg, host._rw, host._lens,
                               host._req_valid.copy(), host.rounds, host.m)
    assert np.array_equal(a_dev, a_host) and (a_dev >= 0).sum() > 0
    check_windows(dev)
    # the merged candidates the auction took: [T, D]
    gp, _ = candidates.merged_candidates(*dev._dev_blocks, dev.T, dev.D)
    assert gp.shape == (dev.T, dev.D)
    assert ((host._gp > NEG).sum(axis=1) > dev.D).any()  # the cut binds


def test_candidates_check_their_inputs():
    tab = torch.zeros((8, 2 * 4 + 1), dtype=torch.int32)
    tp, tt = tab[:, :4].reshape(2, 4, 4), tab[:, 4:8].reshape(2, 4, 4)
    rk = tab[:, 8].reshape(2, 4)
    assert candidates.shard_candidates(tp, tt, rk, 2, 3)[0].shape == (2, 2, 3)
    with pytest.raises(ValueError, match="int32"):
        candidates.shard_candidates(tp.long(), tt, rk, 2, 3)
    with pytest.raises(ValueError, match="must be"):
        candidates.merged_candidates(tp, tt, rk[:, :3], 2, 3)
    with pytest.raises(ValueError, match="strided"):
        candidates.shard_candidates(tp.transpose(1, 2), tt, rk, 2, 3)
    with pytest.raises(ValueError, match="no candidates for device"):
        candidates.shard_candidates(tp.to("meta"), tt.to("meta"),
                                    rk.to("meta"), 2, 3)


# ---- the requester windows built by the auction's prologue ----


@pytest.mark.parametrize("case", CHURN_CASES)
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_device_windows_equal_reqwin_over_churn(nshards, case):
    """30 churn rounds: each device plan's windows, lengths and ``scanned``
    equal the JAX package's ``_reqwin`` on the solver's host mirror for the
    types with a candidate (the others a prefix of it), and its pairs and
    ``last_assigned`` the host tier's. The rank order is re-sent
    exactly in the rounds whose membership changed; each ingest ships the
    rows of the servers whose requesters changed, and nothing else."""
    kw = solver_kwargs(case, nshards)
    tr = Tracer(0, pid=1)
    dev = DistributedAssignmentSolver(auction="device", device="cpu",
                                      tracer=tr, **kw)
    host = DistributedAssignmentSolver(auction="host", device="cpu", **kw)
    gen = WindowChurn(1000 * nshards + CHURN_CASES.index(case), case)
    snaps, members = gen.snaps, None
    seen = 0
    short = full = empty = 0
    for rnd in range(30):
        pairs = dev.solve(snaps, None)
        assert pairs == host.solve(snaps, None), rnd
        events = tr.events[seen:]
        seen += len(events)
        rows = [e["args"] for e in events
                if e["name"] == "planner:ingest.reqrows"]
        changed = set(snaps) != members
        members = set(snaps)
        assert [r["order_uploaded"] for r in rows] in (
            [[True]] if changed else [[False], []]), rnd
        # the mirror's mask is clear on every row that is not valid: what
        # lets the device tier ship the mask alone
        assert not (dev._req_mask & ~dev._req_valid[:, None]).any()
        if not dev._req_valid.any():
            empty += 1
            continue
        check_windows(dev)
        rw, lens = ref._reqwin(dev._req_mask, dev._req_valid, dev.T, dev.C,
                               dev._row_perm)
        live = live_types(dev)
        assert_windows(dev._plan_rows, rw, lens, live)
        assert np.array_equal(dev.last_assigned, host.last_assigned), rnd
        in_use = len(dev._si) * dev.R
        if (lens[live] < dev.C).any():
            short += 1
            assert dev.last_scanned == in_use
        else:
            full += 1
            assert dev.C * live.any() <= dev.last_scanned <= in_use
        snaps = gen.step(pairs)
    counts = dev.planner_counts()
    assert counts["device_windows"] == counts["device_plans"] == 30 - empty
    if case == "rare":
        assert short == 30 and (dev._plan_rows[3, dev.C] < dev.C)
    elif case == "drain":
        assert empty >= 3 and full > 0
    else:
        assert full > 0


@pytest.mark.parametrize("case", ["mixed", "multi_job"])
def test_device_windows_equal_reqwin_on_the_view_path(case):
    """The engine's path: 20 churn rounds through the array ledger's view
    (``_ingest_view``). Each device plan's windows equal ``_reqwin`` on the
    mirror, its pairs the host tier's from the same view, and the mirror's
    mask is clear on every row that is not valid."""
    import time

    from adlb_tpu_torch.balancer.engine import PlanEngine

    kw = solver_kwargs(case, 2)
    J = kw.get("max_jobs", 1)
    eng = PlanEngine(kw["types"], kw["max_tasks_per_server"],
                     kw["max_requesters"], use_mesh=True, nshards=2,
                     nservers=24, max_jobs=J, job_weights=kw.get(
                         "job_weights"), device="cpu")
    led = eng._ledger
    dev = DistributedAssignmentSolver(auction="device", device="cpu", **kw)
    host = DistributedAssignmentSolver(auction="host", device="cpu", **kw)
    gen = WindowChurn(4000 + J, case)
    snaps = gen.snaps
    windows = 0
    for rnd in range(20):
        now = time.monotonic()
        led.sync(snaps, now)
        led.filter_reqs(snaps, {}, now)
        view = led.view()
        dev._ingest_view(view)
        host._ingest_view(view)
        pairs = dev.plan()
        assert pairs == host.plan(), rnd
        assert not (dev._req_mask & ~dev._req_valid[:, None]).any()
        if dev._req_valid.any():
            check_windows(dev)
            assert np.array_equal(dev.last_assigned, host.last_assigned)
            windows += 1
        snaps = gen.step(pairs)
    assert windows == 20 == dev.planner_counts()["device_windows"]


def test_device_windows_of_an_empty_requester_table():
    """No requester parked: ``plan`` returns nothing and launches nothing;
    a device plan over the empty table builds empty windows (every row in
    use read, nothing committed). The rows staged for a plan that never
    launched are applied by the next launch."""
    kw = solver_kwargs("mixed", 2)
    sol = DistributedAssignmentSolver(auction="device", device="cpu", **kw)
    gen = WindowChurn(77, "mixed")
    snaps = gen.snaps
    parked = {s: snaps[s]["reqs"] for s in snaps}
    for s in snaps:
        snaps[s]["reqs"] = []
    assert sol.solve(snaps, None) == []
    assert sol.planner_counts()["device_windows"] == 0
    # the cold ingest staged every server's (empty) rows; no launch took them
    assert sol._reqs.pending.size == len(snaps)
    assigned = sol._device_plan()
    assert sol._reqs.pending.size == 0
    assert (assigned == -1).all() and (sol._plan_rows[:, :sol.C] == -1).all()
    assert (sol._plan_rows[:, sol.C] == 0).all()
    assert sol.last_scanned == len(snaps) * sol.R == host_reach(sol)
    # park, plan, then drain: the drained rows stay pending (plan returns
    # before any launch) until the requesters come back
    for s in snaps:
        snaps[s]["reqs"] = parked[s]
        snaps[s]["stamp"] += 100
    assert sol.solve(snaps, None)
    check_windows(sol)
    for s in snaps:
        snaps[s]["reqs"] = []
        snaps[s]["stamp"] += 100
    assert sol.solve(snaps, None) == []
    assert sol._reqs.pending.size == len(snaps)
    s0 = sorted(snaps)[0]
    snaps[s0]["reqs"] = parked[s0]
    snaps[s0]["stamp"] += 100
    sol.solve(snaps, None)
    assert sol._reqs.pending.size == 0
    check_windows(sol)
    assert (sol._plan_rows[:, sol.C] <= len(parked[s0])).all()


@pytest.mark.parametrize("T,C,R,density,n_delta", [
    (4, 8, 6, 0.4, 0), (4, 512, 100, 0.25, 10), (8, 5, 3, 0.05, 4),
    (40, 16, 4, 0.3, 7), (1, 3, 1, 0.0, 2)])
def test_windows_plain_version_equals_reqwin_and_compaction(T, C, R, density,
                                                           n_delta):
    """``auction_windows`` on the CPU against the host's pipeline on random
    tables (40 types: two mask words a row; density 0: empty windows):
    the staged rows applied, the windows and lengths of ``_reqwin`` in rank
    order, ``scanned``, and the commits of ``auction_torch`` over the host's
    sorted compacted ids, though the windows' ids follow the scan."""
    inst = random_windows(np.random.default_rng(T * 1000 + C), T, C, R,
                          density, n_delta)
    gp, gg, table, order, delta = (torch.from_numpy(inst[k]) for k in (
        "gp", "gg", "table", "order", "delta"))
    mask, valid, perm, nused, m, rounds = (inst[k] for k in (
        "mask", "valid", "perm", "nused", "m", "rounds"))
    rw, lens = ref._reqwin(mask, valid, T, C, perm)
    out = auction.auction_windows(gp, gg, table, order, delta, n_delta,
                                  rounds, m, C)
    n = T * (C + 1)
    assert out.shape == (2 * n + 3,) and out.dtype == torch.int32
    assert np.array_equal(table.numpy(), inst["want_table"])
    rows = out[n:2 * n].view(T, C + 1).numpy()
    assert_windows(rows, rw, lens, inst["gp"][:, 0] > NEG)
    assert int(out[2 * n + 1]) == inst["reach"]
    rwc, open0 = port._compact_reqwin(rw)
    want, rounds_run, lost = auction._rounds_torch(
        gp, gg, torch.from_numpy(rwc), torch.from_numpy(lens),
        torch.from_numpy(open0), rounds, m)
    assert torch.equal(out[:n].view(T, C + 1), want)
    assert (int(out[2 * n]), int(out[2 * n + 2])) == (rounds_run, lost)
    if density:
        assert (want >= 0).sum() > 0

