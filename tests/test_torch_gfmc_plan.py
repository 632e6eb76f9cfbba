"""The sharded planner on GFMC's request shape (``gfmc_shape.py``: every
worker parked on [A, B, C, C_ANSWER], the master on [D], tasks of A, B and
C at priorities 1, 2 and 3), on the CPU.

Over 20 mutating rounds at 40 servers x 12 requesters, at 1, 2 and 8
shards and three seeds: the device tier's plain versions, the host tier and
the benchmark's plain reference (``benchmark/reference.py``, which imports
nothing of the program) plan the same pairs and the same assignment; the
device tier's windows of the live types (those with a candidate) equal the
JAX package's ``_reqwin`` on the solver's mirror and the others are empty;
``scanned`` is the rows up to the one that fills the last live window (the
master's row and C shared rows), and a live D task makes the scan read
every row in use; the auction rounds run and the entries that lost their
requester to another type equal a plain replay of ``reference.auction``.
At the benchmark cell's own state (T = 5, C = 512, m = 32) the plain
version scans 513 rows and runs 6 rounds with 128 losses; with no live type
it scans nothing.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.balancer import distributed as ref
from adlb_tpu_torch.balancer import auction
from adlb_tpu_torch.balancer.distributed import DistributedAssignmentSolver
from adlb_tpu_torch.runtime.trace import Tracer
from benchmark import reference
from gfmc_shape import (CELL, SMALL, TYPES, GfmcWorld, gfmc_windows,
                        solver_kwargs)
from window_churn import (assert_windows, check_windows, host_reach,
                          live_types)

NEG = -(2**31) + 1
ROUNDS = 20


def replay(snaps, kw, nservers):
    """``reference.auction`` replayed on the reference's own packing of
    ``snaps``, with its rounds and its losers counted: (assigned, the rounds
    run, the entries whose requester went to another entry's key). Its
    assignment is held to ``reference.auction``'s, so the counts are of the
    reference's own rounds."""
    K, R, m, rounds = (kw["max_tasks_per_server"], kw["max_requesters"],
                       kw["cand_width"], kw["rounds"])
    C, D = reference.slot_sizes(m, rounds, nservers * R)
    cands, reqwin, lens, _, _ = reference.pack_snapshots(snaps, TYPES, K, R,
                                                         C)
    T = len(TYPES)
    gp = np.full((T, D), reference.NEG, dtype=np.int64)
    gg = np.full((T, D), reference.I32MAX, dtype=np.int64)
    for t, lst in enumerate(cands):
        n = min(len(lst), D)
        if n:
            arr = np.asarray(lst[:n], dtype=np.int64)
            gp[t, :n], gg[t, :n] = arr[:, 0], arr[:, 1]
    nrows = int(reqwin.max()) + 1 if (reqwin >= 0).any() else 0
    req_open = np.ones((max(nrows, 1),), dtype=bool)
    head = np.zeros((T,), dtype=np.int64)
    nlive = (gp > reference.NEG).sum(axis=1)
    slot_valid = np.arange(C)[None, :] < lens[:, None]
    assigned = np.full((T, C), -1, dtype=np.int64)
    run = lost = 0
    for _ in range(rounds):
        run += 1
        entries, trunc = [], {}
        for t in range(T):
            open_slots = np.flatnonzero(
                slot_valid[t] & req_open[np.clip(reqwin[t], 0, None)])
            if open_slots.size == 0:
                continue
            h = int(head[t])
            if h + m < nlive[t]:
                trunc[t] = (int(gp[t, h + m]), -int(gg[t, h + m]))
            for j in range(min(m, open_slots.size, int(nlive[t]) - h)):
                c = int(open_slots[j])
                entries.append((t, j, int(gp[t, h + j]), int(gg[t, h + j]),
                                c, int(reqwin[t, c])))
        best: dict = {}
        for e in entries:
            key = (e[2], -e[3])
            if e[5] not in best or key > best[e[5]][0]:
                best[e[5]] = (key, e)
        winners = {(e[0], e[1]) for _, e in best.values()}
        lost += len(entries) - len(winners)
        threshold = (reference.NEG, -reference.I32MAX)
        for e in entries:
            if (e[0], e[1]) not in winners:
                threshold = max(threshold, (e[2], -e[3]))
        for key in trunc.values():
            threshold = max(threshold, key)
        commits = 0
        for t in range(T):
            for e in (x for x in entries if x[0] == t):
                if (e[0], e[1]) not in winners:
                    break
                if (e[2], -e[3]) <= threshold:
                    continue
                assigned[t, e[4]] = e[3]
                req_open[e[5]] = False
                head[t] += 1
                commits += 1
        if commits == 0:
            break
    np.testing.assert_array_equal(
        assigned, reference.auction(cands, reqwin, lens, rounds, m, D))
    return assigned, run, lost


def _solvers(nshards, tracer=None):
    kw = solver_kwargs(nshards)
    dev = DistributedAssignmentSolver(auction="device", device="cpu",
                                      tracer=tracer, **kw)
    host = DistributedAssignmentSolver(auction="host", device="cpu", **kw)
    return kw, dev, host


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_gfmc_device_tier_equals_host_tier_and_reference(nshards, seed):
    """20 rounds: pairs and ``assigned`` equal across the device tier's
    plain versions, the host tier and the reference; the live windows equal
    ``_reqwin``'s and the scan stops at the last of them; rounds and losses
    equal the reference's replay and the readback span's arguments."""
    tr = Tracer(0, pid=1)
    kw, dev, host = _solvers(nshards, tr)
    world = GfmcWorld(100 * nshards + seed)
    snaps, seen = world.snaps, 0
    conflicts = 0
    for rnd in range(ROUNDS):
        pairs = dev.solve(snaps, None)
        assert pairs == host.solve(snaps, None), rnd
        want_pairs, want_asg = reference.plan_from_snapshots(
            snaps, TYPES, kw["max_tasks_per_server"], kw["max_requesters"],
            world.S, kw["rounds"], kw["cand_width"])
        assert pairs == want_pairs, rnd
        np.testing.assert_array_equal(dev.last_assigned, want_asg)
        np.testing.assert_array_equal(host.last_assigned, want_asg)
        # only A, B and C have work: C_ANSWER's and D's windows are empty
        live = live_types(dev)
        assert live.tolist() == [True, True, True, False, False], rnd
        check_windows(dev)
        rw, lens = ref._reqwin(dev._req_mask, dev._req_valid, dev.T, dev.C,
                               dev._row_perm)
        assert_windows(dev._plan_rows, rw, lens, live)
        assert (dev._plan_rows[3:, dev.C] == 0).all() and lens[4] == 1
        # the master's row, then C rows that every live window shares
        assert dev.last_scanned == host_reach(dev) == dev.C + 1
        _, rounds_run, lost = replay(snaps, kw, world.S)
        assert (dev.last_rounds, dev.last_lost) == (rounds_run, lost), rnd
        conflicts += lost > 0
        events = tr.events[seen:]
        seen += len(events)
        rb = [e["args"] for e in events
              if e["name"] == "planner:plan.readback"]
        assert [(a["scanned"], a["rounds"], a["lost"]) for a in rb] == [
            (dev.last_scanned, rounds_run, lost)]
        snaps = world.step(pairs)
    assert conflicts == ROUNDS


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_gfmc_live_d_task_scans_every_row(nshards):
    """A D task queued each round: D is live, its window holds the master's
    row alone, so the scan reads every row in use; the plans still equal
    the host tier's and the reference's, and the master takes the D task."""
    kw, dev, host = _solvers(nshards)
    world = GfmcWorld(7 + nshards, d_task=True)
    snaps = world.snaps
    for rnd in range(ROUNDS):
        pairs = dev.solve(snaps, None)
        assert pairs == host.solve(snaps, None), rnd
        want_pairs, want_asg = reference.plan_from_snapshots(
            snaps, TYPES, kw["max_tasks_per_server"], kw["max_requesters"],
            world.S, kw["rounds"], kw["cand_width"])
        assert pairs == want_pairs, rnd
        np.testing.assert_array_equal(dev.last_assigned, want_asg)
        assert live_types(dev)[4]
        check_windows(dev)
        assert dev._plan_rows[4, dev.C] == 1
        assert dev.last_scanned == len(dev._si) * dev.R == world.S * world.R
        assert any(p[3] == 0 for p in pairs), rnd
        _, rounds_run, lost = replay(snaps, kw, world.S)
        assert (dev.last_rounds, dev.last_lost) == (rounds_run, lost), rnd
        snaps = world.step(pairs)


def _plain(inst, n_delta=None):
    names = ("gp", "gg", "table", "order", "delta")
    gp, gg, table, order, delta = (torch.from_numpy(inst[k].copy())
                                   for k in names)
    n = inst["n_delta"] if n_delta is None else n_delta
    out = auction.auction_windows(gp, gg, table, order, delta, n,
                                  inst["rounds"], inst["m"], inst["C"])
    return out, table


@pytest.mark.parametrize("shape", ["cell", "small"])
def test_gfmc_windows_plain_version(shape):
    """``auction_windows`` on the CPU over GFMC's shape: the staged rows
    applied, the live windows equal ``_reqwin``'s, C_ANSWER's and D's
    empty, ``scanned`` the master's row plus C, the commits, rounds and
    losses those of ``_rounds_torch`` over the host's windows; at the
    cell's state 136 commits in 6 rounds with 128 losses."""
    S, nused, R, C, m, rounds, tasks = CELL if shape == "cell" else SMALL
    inst = gfmc_windows(np.random.default_rng(C), S, nused, R, C, m, rounds,
                        tasks, n_delta=3)
    out, table = _plain(inst)
    T, n = len(TYPES), len(TYPES) * (C + 1)
    np.testing.assert_array_equal(table.numpy(), inst["want_table"])
    rw, lens = ref._reqwin(inst["mask"], inst["valid"], T, C, inst["perm"])
    live = inst["gp"][:, 0] > NEG
    rows = out[n:2 * n].view(T, C + 1).numpy()
    assert_windows(rows, rw, lens, live)
    assert (rows[3:, C] == 0).all() and lens.tolist() == [C] * 4 + [1]
    assert int(out[2 * n + 1]) == C + 1
    from adlb_tpu_torch.balancer import distributed as port

    rwc, open0 = port._compact_reqwin(rw)
    want, rounds_run, lost = auction._rounds_torch(
        *(torch.from_numpy(inst[k]) for k in ("gp", "gg")),
        torch.from_numpy(rwc), torch.from_numpy(lens),
        torch.from_numpy(open0), rounds, m)
    assert torch.equal(out[:n].view(T, C + 1), want)
    assert (int(out[2 * n]), int(out[2 * n + 2])) == (rounds_run, lost)
    if shape == "cell":
        assert (int((want >= 0).sum()), rounds_run, lost) == (136, 6, 128)


def test_gfmc_windows_with_no_live_type_scan_nothing():
    """No task of any type: every window empty, nothing scanned, one round
    that commits nothing and no loss."""
    S, nused, R, C, m, rounds, _ = SMALL
    inst = gfmc_windows(np.random.default_rng(5), S, nused, R, C, m, rounds,
                        {})
    out, _ = _plain(inst)
    T, n = len(TYPES), len(TYPES) * (C + 1)
    assert (out[:n] == -1).all()
    rows = out[n:2 * n].view(T, C + 1)
    assert (rows[:, :C] == -1).all() and (rows[:, C] == 0).all()
    assert out[2 * n:].tolist() == [1, 0, 0]
