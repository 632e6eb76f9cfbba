"""Card-only tests of the port's CUDA kernels (a kernel has no CPU mode).

The greedy sweep: every route at the main path's shape, the route the
kernel reports against ``requester_classes``, one launch per device solve,
and requester counts whose working set does not fit in shared memory (the
kernel's scratch buffer in device memory).

The auction (the requester windows built in the kernel's prologue from the
resident requester table, then the rounds): on fuzzed instances whose
requester table is staged whole (a multi-job type axis whose lists stay in
device memory, two past shared memory), over the full merge and over the
[T, D] lists the device plan hands over, bit-equal to its plain version,
its windows to ``_reqwin`` and its commits to ``auction_torch`` over the
host's compacted tables and to the numpy twin ``_host_auction``; the
sharded solver's device tier equal to its host tier over churn rounds,
and a failed build or launch raises. Bit-equal to its plain version on
random tables (the benchmark cell's shape, the 10k row's, two mask words
a row, past shared memory, empty windows), and over churn rounds
(``window_churn.py``: joins and leaves, any-type requesters, multi-job
types, a rare type, an empty table) at 1, 2 and 8 shards and across 2 and
4 cards where present: windows equal to ``_reqwin`` on the host mirror
(the live types'; the others a prefix), plans equal to the CPU device
tier's and the host tier's. On GFMC's request shape (``gfmc_shape.py``)
at the benchmark cell's sizes and a small one, with D live and with no
live type: bit-equal to its plain version, so the live windows, ``scanned``,
the rounds and the losses to another type too.

The candidates (with the cross-shard merge): per shard and merged, bit-equal
to the plain version and to a numpy twin on fuzzed instances (truncated
types, empty types, repeated ranks, one row per shard, 16 shards, keys past
shared memory), laid out as the solver's strided table; a device plan is
one candidates launch and one auction launch; a refused launch raises.
The merge alone, in place over separately allocated runs (its cluster
variant, and past eight runs its staged and device-memory variants; over
peer pointers on two or more cards), bit-equal to its plain version and
numpy twin; peer access enabled twice; a refused peer enable or launch
raises; back-to-back device plans without readback while the tables change
(the merged event that holds each card's next kernel A); the sharded
planner split across the cards (one shard per card, or 8 on cuda:0 when
one is visible) at the 10k row equal to the one-card logical shards and the
host tier, merged in place with no gather copy, a planner whose planning
card is cuda:1 (two cards), and ``PlanEngine(use_mesh=True)`` with one
shard per card, built when the engine is. The graft entry
(``graft_entry``) runs on the card, its dry run over the card placement.

Process worlds and the native plane: ``spawn_world(start_method="fork")``
with a master that plans on the card raises before any process starts; a
spawned master plans on the card, one launch per device solve, reported
back to the parent; the sidecar's solves on the card equal ``_host_greedy``.

They skip without a CUDA device. This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
import multiprocessing
import shutil

import numpy as np
import pytest
import torch

from adlb_tpu_torch import graft_entry
from adlb_tpu_torch.balancer import auction, candidates, cuda_build
from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer import distributed as dist
from adlb_tpu_torch.balancer import plan_bench
from adlb_tpu_torch.balancer.solve import _NEG, AssignmentSolver, _host_greedy
from gfmc_shape import CELL as GFMC_CELL, SMALL as GFMC_SMALL, gfmc_windows
from window_churn import (CASES as CHURN_CASES, WindowChurn, assert_windows,
                          check_windows, random_windows, solver_kwargs,
                          staged_rows)


def _random_instance(rng, nt, nr, t, pad=0.25):
    task_prio = rng.integers(-1000, 1000, size=nt).astype(np.int32)
    task_type = rng.integers(0, t, size=nt).astype(np.int32)
    p = rng.random(nt) < pad
    task_prio[p] = int(_NEG)
    task_type[p] = -1
    return (task_prio, task_type, rng.random((nr, t)) < 0.5,
            rng.random(nr) < 0.8)


def _bench_instance(rng, nt, nr, t=4):
    tp = rng.integers(-50, 50, size=(nt,)).astype(np.int32)
    tt = rng.integers(0, t, size=(nt,)).astype(np.int32)
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    return tp, tt, rm, np.ones((nr,), dtype=bool)


#: one 65536 x 8192 instance per route: bench.py's generator, random masks
#: at T=4, random masks at T=64
ROUTE_CASES = {"partition": lambda rng: _bench_instance(rng, 65536, 8192),
               "classes": lambda rng: _random_instance(rng, 65536, 8192, 4),
               "sweep": lambda rng: _random_instance(rng, 65536, 8192, 64)}


def _route(arrs):
    return greedy_sweep.requester_classes(
        torch.from_numpy(arrs[2]), torch.from_numpy(arrs[3])).route


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nr,t", [
    (16, 8, 2), (200, 130, 6), (1024, 9, 2), (5000, 1000, 3),
    (4096, 700, 64), (9000, 33, 4), (30000, 9000, 7), (5000, 2000, 70)])
def test_kernel_matches_plain_and_host(card, nt, nr, t):
    rng = np.random.default_rng(nt + nr + t)
    for _ in range(3):
        arrs = _random_instance(rng, nt, nr, t)
        ins = [torch.from_numpy(a).to(card) for a in arrs]
        got, code = greedy_sweep.solve_cuda(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got, greedy_sweep.greedy_assign_torch(*ins))
        np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
        assert greedy_sweep.ROUTES[int(code) - 1] == _route(arrs)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_each_route_at_main_path_shape(card, route):
    arrs = ROUTE_CASES[route](np.random.default_rng(17))
    assert _route(arrs) == route
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    got, code = greedy_sweep.solve_cuda(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.ROUTES[int(code) - 1] == route
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
    assert torch.equal(got, greedy_sweep.greedy_assign_torch(*ins))


@pytest.mark.cuda
def test_solver_device_solve_is_one_launch(card):
    """The main path's hand-off: one launch per device solve, counted under
    the route it took, the buffers kept while the shape holds."""
    solver = AssignmentSolver(types=(1, 2, 3, 4), max_tasks=4096,
                              max_requesters=512, host_threshold_reqs=0)
    rng = np.random.default_rng(19)
    for route in ("partition", "classes", "partition"):
        arrs = ROUTE_CASES[route](rng)
        before, routes = greedy_sweep.launches, greedy_sweep.route_launches()
        got = solver._device_solve(*arrs)
        assert greedy_sweep.launches == before + 1
        assert greedy_sweep.route_launches()[route] == routes[route] + 1
        np.testing.assert_array_equal(got, _host_greedy(*arrs))
    handoff = solver.handoff
    solver._device_solve(*ROUTE_CASES["partition"](rng))
    assert solver.handoff is handoff


#: (tasks, requesters, types, masks) past what shared memory holds: 32
#: servers x 2048 requesters, and 16 x 2048 with 4 types x 16 jobs (T=64)
LARGE = {"classes_nr65536": (16384, 65536, 4, "random"),
         "partition_nr65536": (16384, 65536, 4, "one_type"),
         "sweep_t64_nr32768": (16384, 32768, 64, "random"),
         "sweep_t11_nr65536": (16384, 65536, 11, "random")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LARGE))
def test_kernel_past_shared_memory(card, case):
    nt, nr, t, masks = LARGE[case]
    rng = np.random.default_rng(nr + t)
    arrs = (_random_instance(rng, nt, nr, t) if masks == "random"
            else _bench_instance(rng, nt, nr, t))
    route = _route(arrs)
    assert route == case.split("_")[0]
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    got, code = greedy_sweep.solve_cuda(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.ROUTES[int(code) - 1] == route
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))
    assert greedy_sweep.Workspace(nt, nr, t, card).scratch is not None


@pytest.mark.cuda
def test_solver_at_32_servers_x_2048_requesters(card):
    """The hand-off at NR = 65,536 (scratch in device memory) against the
    numpy twin, one launch per solve."""
    solver = AssignmentSolver(types=(1, 2, 3, 4), max_tasks=512,
                              max_requesters=2048, host_threshold_reqs=0)
    rng = np.random.default_rng(23)
    for make in (_random_instance, _bench_instance):
        arrs = make(rng, 32 * 512, 32 * 2048, 4)
        before = greedy_sweep.launches
        got = solver._device_solve(*arrs)
        assert greedy_sweep.launches == before + 1
        np.testing.assert_array_equal(got, _host_greedy(*arrs))
    assert solver.handoff.work.scratch is not None


@pytest.mark.cuda
def test_kernel_main_path_shape_counts_one_launch(card):
    rng = np.random.default_rng(0)
    arrs = _bench_instance(rng, 65536, 8192)
    ins = [torch.from_numpy(a).to(card) for a in arrs]
    before = greedy_sweep.launches
    got = greedy_sweep.greedy_assign(*ins)
    torch.cuda.synchronize()
    assert greedy_sweep.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), _host_greedy(*arrs))


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(card):
    ins = [torch.from_numpy(a).to(card) for a in
           _random_instance(np.random.default_rng(2), 50, 20, 3)]
    with pytest.raises(ValueError, match="int32"):
        greedy_sweep.greedy_assign(ins[0].to(torch.int64), *ins[1:])
    with pytest.raises(ValueError, match="task_prio on"):
        greedy_sweep.greedy_assign(ins[0], ins[1].cpu(), *ins[2:])


def _auction_instance(rng, T, m, nshards, rounds, Sl=4, K=8, R=4,
                      slots=None):
    """Random task table -> per-shard candidates -> merged lists, random
    requester masks -> slot tables: (numpy twin inputs, card tensors gp,
    gg, rwc, lens, open0, and the resident requester table's card tensors:
    an empty table, the rank order 0 .. S - 1 and every slot's rows
    staged, R a slot)."""
    S = nshards * Sl
    tp = rng.integers(-50, 50, (S, K)).astype(np.int32)
    tt = rng.integers(0, T, (S, K)).astype(np.int32)
    tp[rng.random((S, K)) < 0.2] = int(_NEG)
    rk = rng.permutation(S).astype(np.int32)
    NR = S * R
    C, D = dist._slot_sizes(slots, m, rounds, NR)
    cp, cg = dist._shard_candidates(
        torch.from_numpy(tp).view(nshards, Sl, K),
        torch.from_numpy(tt).view(nshards, Sl, K),
        torch.from_numpy(rk).view(nshards, Sl), T, D)
    gp, gg = dist._merge_shard_major(cp.numpy(), cg.numpy())
    rv = rng.random(NR) < 0.9
    rm = rng.random((NR, T)) < 0.4
    rw, lens = dist._reqwin(rm, rv, T, C)
    rwc, open0 = dist._compact_reqwin(rw)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
           for a in (gp, gg, rwc, lens, open0)]
    win = [torch.from_numpy(a).cuda() for a in (
        np.zeros((NR, (T + 31) // 32), np.int32),
        np.concatenate([[S], np.arange(S)]).astype(np.int32),
        staged_rows(np.arange(S), rm, rv))]
    return (gp, gg, rw, lens, rv), ins, win


#: (T, m, nshards, rounds, servers per shard, slots per type): m = 1 and
#: m past a warp, T = 24 as 3 jobs x 8 types at C=512 (the working set fits
#: in shared memory, the staged lists beside it do not), and two shapes
#: whose working set does not fit in shared memory (T=24, C=1024; T=32,
#: C=1024)
AUCTION_CASES = [(1, 1, 1, 16, 4, None), (4, 8, 2, 16, 4, None),
                 (8, 32, 8, 16, 32, None), (8, 40, 8, 16, 32, None),
                 (24, 32, 8, 16, 32, 512), (24, 32, 8, 32, 64, 1024),
                 (32, 8, 8, 4, 64, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,m,nshards,rounds,sl,slots", AUCTION_CASES)
def test_auction_kernel_matches_plain_and_host(card, T, m, nshards, rounds,
                                               sl, slots):
    """One launch over the full merge with the whole requester table
    staged, then one over the [T, D] lists the device plan hands over with
    nothing staged: each bit-equal to the plain version, its windows equal
    to ``_reqwin``, its commits to ``auction_torch`` over the host's sorted
    compacted ids and to the numpy twin over the full merge."""
    rng = np.random.default_rng(T * 100 + m)
    (gp, gg, rw, lens, rv), ins, win = _auction_instance(
        rng, T, m, nshards, rounds, Sl=sl, slots=slots)
    C = rw.shape[1]
    S, n, D = win[1].shape[0] - 1, T * (C + 1), C + m + 1
    work = auction.Workspace(T, C, m, card)
    want = dist._host_auction(gp, gg, rw, lens, rv.copy(), rounds, m)
    tables = [x.cpu() for x in ins[2:]]
    cpu_win = [x.cpu() for x in win]
    cut = [x[:, :D].contiguous() for x in ins[:2]]
    for lists, n_delta in ((ins[:2], S), (cut, 0)):
        before = auction.launches
        got = auction.auction_windows(*lists, *win, n_delta, rounds, m, C,
                                      work=work).cpu()
        assert auction.launches == before + 1
        cpu_lists = [x.cpu() for x in lists]
        assert torch.equal(got, auction.auction_windows(
            *cpu_lists, *cpu_win, n_delta, rounds, m, C))
        assert torch.equal(got[:n].view(T, C + 1), auction.auction_torch(
            *cpu_lists, *tables, rounds, m))
        np.testing.assert_array_equal(got[:n].view(T, C + 1)[:, :C], want)
        rows = got[n:2 * n].view(T, C + 1).numpy()
        assert_windows(rows, rw, lens, gp[:, 0] > _NEG)
    assert (want >= 0).sum() > 0
    assert (work.scratch is not None) == (slots == 1024)
    assert work.lists_staged == (slots is None)
    with pytest.raises(ValueError, match="workspace"):
        auction.auction_windows(*ins[:2], *win, 0, rounds, m + 1, C,
                                work=work)


@pytest.mark.cuda
def test_auction_launch_failure_raises(card):
    (_, _, rw, _, _), ins, win = _auction_instance(
        np.random.default_rng(3), 4, 8, 2, 4)
    work = auction.Workspace(4, rw.shape[1], 8, card)
    with pytest.raises(RuntimeError, match="auction launch failed"):
        # the kernel refuses a negative round count
        work.launch_windows(*ins[:2], *win, 0, -1)
    with pytest.raises(ValueError, match="workspace"):
        auction.Workspace(5, rw.shape[1], 8, card).launch_windows(
            *ins[:2], *win, 0, 4)


@pytest.mark.cuda
def test_kernel_build_failure_raises(card, tmp_path):
    broken = tmp_path / "broken.cu"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build_all([broken])


@pytest.mark.cuda
def test_sharded_device_tier_equals_host_tier_over_churn(card):
    """plan_bench's first two rows on the card: every round's device-tier
    pairs equal the host tier's; one auction launch per device plan."""
    before = auction.launches
    plans = []
    out = plan_bench.run_sweep(scales=plan_bench.SCALES[:2], reps=8,
                               nshards=8, device="cuda", check_host=True,
                               on_row=lambda s, r: plans.append(s.solve_count))
    assert [r["rounds_equal_to_host_tier"] for r in out["rows"]] == [8, 8]
    assert all(r["pairs_total"] > 0 for r in out["rows"])
    assert auction.launches - before == sum(plans)


#: (T, C, R, density, staged slots, slots, slots in use): the benchmark
#: cell's shape (1,304 slots x 100 rows, C = 512; about 2,300 rows fill the
#: four windows), the 10k row's (10,000 x 2 at T = 8), two mask words a row,
#: a working set past shared memory (T = 32, C = 1024: the kernel's
#: scratch), no accepting row at all, one slot a type
WINDOW_CASES = [(4, 512, 100, 0.25, 10, 1304, 1297),
                (8, 512, 2, 0.4, 40, 10000, 9000),
                (40, 64, 8, 0.3, 7, 64, 60), (32, 1024, 16, 0.2, 5, 512, 500),
                (4, 16, 4, 0.0, 3, 30, 25), (1, 1, 1, 0.5, 2, 30, 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,R,density,n_delta,S,nused", WINDOW_CASES)
def test_auction_windows_kernel_matches_plain(card, T, C, R, density, n_delta,
                                              S, nused):
    """One launch of the auction against its plain version on the
    same inputs: the whole output (commits, each slot's requester row,
    lengths, rounds run, ``scanned``, and so the dense ids in scan order)
    and the table the staged rows were applied to."""
    inst = random_windows(np.random.default_rng(T * 7 + C), T, C, R, density,
                          n_delta, S=S, nused=nused, m=32 if T <= 8 else 8,
                          rounds=16)
    names = ("gp", "gg", "table", "order", "delta")
    cpu = [torch.from_numpy(inst[k]) for k in names]
    dev = [x.to(card) for x in cpu]
    m, rounds = inst["m"], inst["rounds"]
    work = auction.Workspace(T, C, m, card)
    before = auction.launches
    got = auction.auction_windows(*dev[:2], *dev[2:], n_delta, rounds, m, C,
                                  work=work).clone()
    torch.cuda.synchronize()
    assert auction.launches == before + 1
    want = auction.auction_windows(*cpu[:2], *cpu[2:], n_delta, rounds, m, C)
    assert torch.equal(got.cpu(), want)
    assert int(work.rounds_run) == int(want[2 * T * (C + 1)])
    assert int(got[2 * T * (C + 1) + 1]) == inst["reach"]
    np.testing.assert_array_equal(dev[2].cpu().numpy(), inst["want_table"])
    assert (work.scratch is not None) == (C == 1024)
    # a second launch with nothing staged builds the same windows
    again = auction.auction_windows(*dev[:2], *dev[2:], 0, rounds, m, C,
                                    work=work)
    assert torch.equal(again.cpu(), want)
    with pytest.raises(ValueError, match="delta holds"):
        auction.auction_windows(*dev[:2], *dev[2:], S + 1, rounds, m, C,
                                work=work)


#: GFMC's shape: the benchmark cell's state, a small one, the small one
#: with a D task (D live, its window short: every row scanned) and with no
#: task at all (nothing scanned)
GFMC_CASES = {"cell": GFMC_CELL, "small": GFMC_SMALL,
              "small_d": GFMC_SMALL[:6] + ({**GFMC_SMALL[6], 5: 1},),
              "none": GFMC_SMALL[:6] + ({},)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GFMC_CASES))
def test_gfmc_windows_kernel_matches_plain(card, case):
    """One launch on GFMC's shape, some slots staged, against
    ``windows_torch`` + ``auction_torch`` on the same inputs: the whole
    output (assigned, the windows' rows, rounds, ``scanned``, losses), the
    live windows equal to ``_reqwin``, the others empty; at the cell's state
    513 rows scanned, 136 commits in 6 rounds, 128 losses."""
    S, nused, R, C, m, rounds, tasks = GFMC_CASES[case]
    inst = gfmc_windows(np.random.default_rng(C + len(tasks)), S, nused, R,
                        C, m, rounds, tasks, n_delta=5)
    names = ("gp", "gg", "table", "order", "delta")
    cpu = [torch.from_numpy(inst[k]) for k in names]
    dev = [x.to(card) for x in cpu]
    work = auction.Workspace(5, C, m, card)
    got = auction.auction_windows(*dev[:2], *dev[2:], 5, rounds, m, C,
                                  work=work).cpu()
    want = auction.auction_windows(*cpu[:2], *cpu[2:], 5, rounds, m, C)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(dev[2].cpu().numpy(), inst["want_table"])
    n = 5 * (C + 1)
    rw, lens = dist._reqwin(inst["mask"], inst["valid"], 5, C, inst["perm"])
    live = inst["gp"][:, 0] > _NEG
    assert_windows(got[n:2 * n].view(5, C + 1).numpy(), rw, lens, live)
    rounds_run, scanned, lost = got[2 * n:].tolist()
    assert int(work.rounds_run) == rounds_run
    if case == "cell":
        assert (int((got[:n] >= 0).sum()), rounds_run, scanned, lost) == (
            136, 6, C + 1, 128)
    elif case == "small":
        assert scanned == C + 1 and lost > 0
    elif case == "small_d":
        assert scanned == nused * R
    else:
        assert (rounds_run, scanned, lost) == (1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHURN_CASES)
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_card_windows_equal_reqwin_over_churn(card, nshards, case):
    """30 churn rounds on the card: each device plan's windows, lengths and
    ``scanned`` equal ``_reqwin`` on the host mirror and the CPU device
    tier's, its pairs and ``last_assigned`` the host tier's; one auction
    launch a device plan."""
    kw = solver_kwargs(case, nshards)
    sol = dist.DistributedAssignmentSolver(device="cuda", **kw)
    cpu = dist.DistributedAssignmentSolver(device="cpu", **kw)
    host = dist.DistributedAssignmentSolver(auction="host", device="cpu",
                                            **kw)
    gen = WindowChurn(2000 * nshards + CHURN_CASES.index(case), case)
    snaps = gen.snaps
    before = auction.launches
    for rnd in range(30):
        pairs = sol.solve(snaps, None)
        assert pairs == cpu.solve(snaps, None) == host.solve(snaps, None)
        if sol._req_valid.any():
            check_windows(sol)
            np.testing.assert_array_equal(sol._plan_rows, cpu._plan_rows)
            assert sol.last_scanned == cpu.last_scanned
            np.testing.assert_array_equal(sol.last_assigned,
                                          host.last_assigned)
        snaps = gen.step(pairs)
    assert auction.launches - before == sol.planner_counts()[
        "device_windows"] == sol.solve_count


@pytest.mark.cuda
@pytest.mark.parametrize("ncards", [2, 4])
def test_card_windows_across_cards_equal_reqwin_over_churn(card, ncards):
    """One shard per card, the requester table, the windows and the auction
    on cuda:0: the windows equal ``_reqwin`` on the host mirror and the
    plans those of CPU pieces and of the host tier."""
    if torch.cuda.device_count() < ncards:
        pytest.skip(f"needs {ncards} cards")
    kw = solver_kwargs("mixed", 1)
    kw.pop("nshards")
    kw["servers_per_shard"] = -(-24 // ncards)
    sol = dist.DistributedAssignmentSolver(
        devices=[f"cuda:{i}" for i in range(ncards)], **kw)
    cpu = dist.DistributedAssignmentSolver(devices=["cpu"] * ncards,
                                           device="cpu", **kw)
    host = dist.DistributedAssignmentSolver(
        devices=["cpu"] * ncards, device="cpu", auction="host", **kw)
    gen = WindowChurn(3000 + ncards, "mixed")
    snaps = gen.snaps
    for rnd in range(30):
        pairs = sol.solve(snaps, None)
        assert pairs == cpu.solve(snaps, None) == host.solve(snaps, None)
        check_windows(sol)
        np.testing.assert_array_equal(sol._plan_rows, cpu._plan_rows)
        np.testing.assert_array_equal(sol.last_assigned, host.last_assigned)
        snaps = gen.step(pairs)
    assert sol._reqs.table.device == torch.device("cuda", 0)
    assert sol.merge_route == "in_place"


def _cand_instance(rng, ns, Sl, K, T, one_type=False, dup_ranks=False):
    """A task table laid out as the solver keeps it ([S, 2K + 1]), dead
    slots, slots with no type and free rows included: numpy (tp, tt, rk)
    shaped [ns, Sl, ...] and the card views the kernel reads."""
    S = ns * Sl
    tp = rng.integers(-50, 50, (S, K)).astype(np.int32)
    tp[rng.random((S, K)) < 0.1] = 10**9 + 5  # past the clip
    tt = rng.integers(-1, T, (S, K)).astype(np.int32)
    if one_type:
        tt[tt >= 0] = 0
    tp[rng.random((S, K)) < 0.2] = int(_NEG)
    rk = (rng.integers(3, 3 + max(S // 4, 1), S) if dup_ranks
          else rng.permutation(S) + 3).astype(np.int32)
    free = rng.random(S) < 0.1
    tp[free], tt[free], rk[free] = int(_NEG), -1, 0
    tab = torch.empty((S, 2 * K + 1), dtype=torch.int32)
    tab[:, :K], tab[:, K:2 * K] = torch.from_numpy(tp), torch.from_numpy(tt)
    tab[:, 2 * K] = torch.from_numpy(rk)
    tab = tab.cuda()
    views = (tab[:, :K].reshape(ns, Sl, K), tab[:, K:2 * K].reshape(ns, Sl, K),
             tab[:, 2 * K].reshape(ns, Sl))
    return (tp.reshape(ns, Sl, K), tt.reshape(ns, Sl, K),
            rk.reshape(ns, Sl)), views


def _cand_numpy(tp, tt, rk, T, D):
    """Numpy twin: per shard and type, the D live slots with the best (prio
    desc, gid asc), prio clamped, gid = rank * K + ki; padded."""
    ns, Sl, K = tp.shape
    gid = (rk.astype(np.int64)[:, :, None] * K + np.arange(K)).astype(np.int32)
    prio = np.clip(tp, -10**9, 10**9)
    cp = np.full((ns, T, D), int(_NEG), np.int32)
    cg = np.full((ns, T, D), 2**31 - 1, np.int32)
    for s in range(ns):
        for t in range(T):
            sel = (tp[s] > int(_NEG)) & (tt[s] == t)
            p, g = prio[s][sel], gid[s][sel]
            o = np.lexsort((g, -p.astype(np.int64)))[:D]
            cp[s, t, :o.size], cg[s, t, :o.size] = p[o], g[o]
    return cp, cg


#: (nshards, servers per shard, K, T, D, one type, repeated ranks): 1, 2, 8
#: and 16 shards, truncated and not, the 10k row's shape dense and with one
#: type, one row per shard, and one shard whose keys go to device scratch
CAND_CASES = [(1, 6, 8, 4, 70, False, False), (2, 6, 8, 4, 5, False, False),
              (8, 6, 8, 8, 5, False, True), (16, 64, 16, 24, 300, False, False),
              (8, 1250, 16, 8, 545, False, False),
              (8, 1250, 16, 8, 545, True, True), (8, 1, 8, 2, 9, False, False),
              (1, 2048, 16, 8, 545, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,Sl,K,T,D,one,dup", CAND_CASES)
def test_candidates_kernel_matches_plain_and_numpy(card, ns, Sl, K, T, D, one,
                                                   dup):
    rng = np.random.default_rng(ns * 1000 + Sl + D)
    shaped, views = _cand_instance(rng, ns, Sl, K, T, one, dup)
    cp, cg = _cand_numpy(*shaped, T, D)
    want = {False: (cp, cg),
            True: tuple(x[:, :D] for x in dist._merge_shard_major(cp, cg))}
    work = candidates.Workspace(ns, Sl, K, T, D, card)
    for merge in (False, True):
        plain = candidates.candidates_torch(*views, T, D, merge)
        for _ in range(2):  # the merge's tickets come back to 0
            before = candidates.launches
            run = (candidates.merged_candidates if merge
                   else candidates.shard_candidates)
            got = [x.clone() for x in run(*views, T, D, work=work)]
            torch.cuda.synchronize()
            assert candidates.launches == before + 1
            for g, p, w in zip(got, plain, want[merge]):
                assert torch.equal(g, p)
                np.testing.assert_array_equal(g.cpu().numpy(), w)
    # a shard's keys (8 bytes each) past shared memory go to device scratch
    assert (work.scratch is not None) == (Sl * K > 1250 * 16)


@pytest.mark.cuda
def test_candidates_refuse_what_the_kernel_does_not_take(card):
    _, views = _cand_instance(np.random.default_rng(1), 2, 4, 8, 3)
    with pytest.raises(ValueError, match="past the kernel"):
        candidates.Workspace(2, 4, 8, 3, 5000, card)
    work = candidates.Workspace(2, 4, 8, 3, 7, card)
    with pytest.raises(ValueError, match="workspace"):
        candidates.shard_candidates(*views, 3, 8, work=work)
    with pytest.raises(ValueError, match="int32"):
        work.launch(views[0].long(), *views[1:], True)


@pytest.mark.cuda
def test_device_plan_is_two_launches_equal_to_the_host_tier(card):
    """One device plan on plan_bench's first row: one candidates launch,
    one auction launch, and the same commits as the host tier."""
    kept = []
    plan_bench.run_sweep(scales=plan_bench.SCALES[:1], reps=2, nshards=8,
                         device="cuda", on_row=lambda s, r: kept.append(s))
    sol = kept[0]
    before = candidates.launches, auction.launches
    got = sol._device_plan()
    assert (candidates.launches - before[0],
            auction.launches - before[1]) == (1, 1)
    sol._sweep()
    rw, lens = sol.host_windows()
    want = dist._host_auction(sol._gp, sol._gg, rw, lens,
                              sol._req_valid.copy(), sol.rounds, sol.m)
    np.testing.assert_array_equal(got, want)
    check_windows(sol)


@pytest.mark.cuda
def test_graft_entry_runs_on_the_card(card):
    fn, args = graft_entry.entry()
    assert all(a.is_cuda for a in args)
    out = fn(*args)
    np.testing.assert_array_equal(
        out.cpu().numpy(), fn(*(a.cpu() for a in args)).numpy())
    before = (candidates.launches, candidates.merge_launches,
              auction.launches)
    got = graft_entry.dryrun_multichip(8)
    n = min(8, torch.cuda.device_count())
    assert got["placement"] == [f"cuda:{i % n}" for i in range(8)]
    plans = got["device_plans"]
    assert (candidates.launches - before[0],
            candidates.merge_launches - before[1],
            auction.launches - before[2]) == (8 * plans, plans, plans)


def _sorted_runs(rng, n, T, D, live):
    """n runs [n, T, D] as kernel A leaves them: sorted by (prio desc, gid
    asc), a random share live, the rest padded; many prio ties."""
    p = rng.integers(-4, 4, (n, T, D)).astype(np.int64)
    g = rng.integers(0, 4 * n * D, (n, T, D)).astype(np.int64)
    nlive = (rng.random((n, T)) * live * (D + 1)).astype(np.int64)
    dead = np.arange(D)[None, None, :] >= nlive[:, :, None]
    p[dead], g[dead] = int(_NEG), 2**31 - 1
    o = np.argsort(((-p) << 32) + g, axis=2, kind="stable")
    return (np.take_along_axis(p, o, 2).astype(np.int32),
            np.take_along_axis(g, o, 2).astype(np.int32))


def _runs_on(cp, cg, devices):
    """Run q as its own [2, T, D] tensor on ``devices[q % len(devices)]``."""
    return [torch.from_numpy(np.stack([cp[q], cg[q]])).to(
        devices[q % len(devices)]) for q in range(cp.shape[0])]


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,D,live", [
    (1, 8, 545, 0.6), (2, 8, 545, 0.3), (3, 24, 13, 0.5), (8, 8, 545, 0.5),
    (3, 8, 4096, 0.7), (8, 8, 4096, 0.8), (12, 8, 545, 0.5),
    (9, 8, 4096, 0.8)])
def test_merge_alone_matches_plain_and_numpy(card, n, T, D, live):
    """The merge alone in place over n separately allocated runs on one
    card: bit-equal to its plain version and to ``_merge_shard_major`` cut
    to D, twice; one cluster of n blocks a type up to 8 runs, past that one
    block a type with the keys in shared memory, or in device memory past
    it (9 runs of 4096)."""
    cp, cg = _sorted_runs(np.random.default_rng(n * 100 + D), n, T, D, live)
    runs = _runs_on(cp, cg, [card])
    want = [x[:, :D] for x in dist._merge_shard_major(cp, cg)]
    plain = candidates.merge_runs_torch(runs, D)
    work = candidates.MergeWorkspace(runs, D, card)
    assert work.variant == ("cluster" if n <= 8 else "staged"
                            if 8 * (n + 1) * D <= 227 * 1024
                            else "device_memory")
    for _ in range(2):
        before = candidates.merge_launches
        got = candidates.merge_runs(runs, D, work=work)
        torch.cuda.synchronize()
        assert candidates.merge_launches == before + 1
        for g, p_, w in zip(got, plain, want):
            assert torch.equal(g, p_)
            np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,D", [(2, 545), (4, 545), (8, 545), (4, 4096),
                                 (12, 545)])
def test_merge_in_place_over_peer_pointers(card, n, D):
    """Two or more cards: the runs spread over every card, merged on cuda:0
    through peer pointers, bit-equal to the plain version on a gathered
    copy and to the numpy twin."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards")
    devices = [torch.device("cuda", i) for i in range(cards)]
    cp, cg = _sorted_runs(np.random.default_rng(40 + n + D), n, 8, D, 0.6)
    runs = _runs_on(cp, cg, devices)
    work = candidates.MergeWorkspace(runs, D, devices[0])
    got = [x.cpu() for x in candidates.merge_runs(runs, D, work=work)]
    plain = candidates.merge_runs_torch([r.to(devices[0]) for r in runs], D)
    want = [x[:, :D] for x in dist._merge_shard_major(cp, cg)]
    for g, p_, w in zip(got, plain, want):
        assert torch.equal(g, p_.cpu())
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.cuda
def test_peer_access_enabled_twice_is_harmless_and_a_refusal_raises(card):
    """Enabling peer access that is already on (by an earlier call, or by
    PyTorch's own peer copy) succeeds; asking the CUDA runtime for what it
    refuses (a card's access to itself) raises."""
    with pytest.raises(RuntimeError, match="peer access"):
        candidates.enable_peer("cuda:0", "cuda:0")
    if torch.cuda.device_count() < 2:
        return
    torch.ones(4, device="cuda:1").to("cuda:0")  # PyTorch's peer copy
    for _ in range(2):
        candidates.enable_peer("cuda:0", "cuda:1")
        candidates.enable_peer("cuda:1", "cuda:0")


@pytest.mark.cuda
def test_a_refused_merge_launch_raises(card):
    runs = _runs_on(*_sorted_runs(np.random.default_rng(5), 2, 4, 8, 0.5),
                    [card])
    work = candidates.MergeWorkspace(runs, 8, card)
    work.shape = (2, 4, 0)  # a D the kernel refuses
    with pytest.raises(RuntimeError, match="merge launch failed"):
        work.launch()


@pytest.mark.cuda
def test_back_to_back_device_plans_without_readback(card):
    """Across the cards (8 pieces on cuda:0 with one card): device plans
    enqueued back to back with no readback while the pieces' tables change
    between them, each result copied on the planning stream; every one
    equal to the plan of the same state over CPU pieces. With several
    cards this holds each card's next kernel A behind the merge that reads
    its runs."""
    placement = _card_placement()
    n = len(placement)
    kw = dict(types=(1, 2, 3), max_tasks_per_server=16, max_requesters=8,
              servers_per_shard=4)
    sol = dist.DistributedAssignmentSolver(devices=placement, **kw)
    ref = dist.DistributedAssignmentSolver(devices=["cpu"] * n,
                                           device="cpu", **kw)
    assert sol.merge_route == "in_place" or sol.merge_route is None
    rng = np.random.default_rng(11)
    snaps = {100 + s: {"tasks": [], "reqs": [(s * 10 + i, 1, [1 + i % 3])
                                             for i in range(4)]}
             for s in range(4 * n)}
    got, want = [], []
    for it in range(12):
        for s in rng.choice(sorted(snaps), size=n, replace=False).tolist():
            snaps[s]["tasks"] = sorted(
                ((it * 1000 + s * 16 + i, int(rng.integers(1, 4)),
                  int(rng.integers(-50, 50)), 8) for i in range(16)),
                key=lambda t: -t[2])
        sol.ingest(snaps)
        got.append(sol._enqueue_device_plan().clone())
        ref.solve(snaps, None)
        want.append((ref.last_assigned.copy(), ref._plan_rows.copy()))
    assert sol.merge_route == "in_place" and sol.gather_copies == 0
    for d in set(placement):
        torch.cuda.synchronize(d)
    T, C = sol.T, sol.C
    n = T * (C + 1)
    for g, (w, rows) in zip(got, want):
        out = g.cpu().numpy()
        np.testing.assert_array_equal(out[:n].reshape(T, C + 1)[:, :C], w)
        np.testing.assert_array_equal(out[n:2 * n].reshape(T, C + 1), rows)


def _card_placement():
    cards = torch.cuda.device_count()
    return graft_entry.card_placement(min(8, cards) if cards > 1 else 8)


@pytest.mark.cuda
def test_sharded_planner_across_cards_at_the_10k_row(card):
    """The 10k row over one shard per card (8 on cuda:0 with one card):
    every round's assignment and pairs equal the one-card solver's on as
    many logical shards and the host tier's across the same cards; each
    piece lives on its card; a device plan is one kernel-A launch a shard,
    one merge and one auction."""
    placement = _card_placement()
    kept = []
    out = plan_bench.run_sweep(scales=plan_bench.SCALES[3:], reps=4,
                               devices=placement, device="cuda",
                               check_host=True, check_logical=True,
                               on_row=lambda s, r: kept.append(s))
    row = out["rows"][0]
    assert row["rounds_equal_to_host_tier"] == 4
    assert row["rounds_equal_to_logical"] == 4 and row["pairs_total"] > 0
    sol = kept[0]
    assert [p.tab.device for p in sol._pieces] == placement
    assert all(p.rows == 10_000 // len(placement) for p in sol._pieces)
    before = (candidates.launches, candidates.merge_launches,
              auction.launches, candidates.gather_copies)
    sol._device_plan()
    assert (candidates.launches - before[0],
            candidates.merge_launches - before[1],
            auction.launches - before[2],
            candidates.gather_copies - before[3]) == (len(placement), 1, 1, 0)
    assert sol.merge_route == "in_place" and sol.gather_copies == 0
    assert sol.planner_counts()["merge_route"] == "in_place"


@pytest.mark.cuda
def test_a_planner_on_a_second_card_launches_there(card):
    """Two cards: a solver whose planning card is cuda:1, its shards on
    cuda:1 and cuda:0, plans what the CPU pieces plan; every launch ran
    (on cuda:1 while cuda:0 stayed current)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    rng = np.random.default_rng(3)
    snaps = {}
    for s in range(100, 112):
        tasks = sorted(((s * 10 + i, int(rng.integers(1, 3)),
                         int(rng.integers(-9, 9)), 8) for i in range(4)),
                       key=lambda t: -t[2])
        snaps[s] = {"tasks": tasks,
                    "reqs": [(s, 1, [int(rng.integers(1, 3))])]}
    kw = dict(types=(1, 2), max_tasks_per_server=8, max_requesters=2,
              servers_per_shard=6)
    want = dist.DistributedAssignmentSolver(
        devices=["cpu", "cpu"], device="cpu", **kw).solve(snaps, None)
    sol = dist.DistributedAssignmentSolver(devices=["cuda:1", "cuda:0"],
                                           device="cuda:1", **kw)
    assert torch.cuda.current_device() == 0
    before = candidates.launches, auction.launches
    assert sol.solve(snaps, None) == want and want
    assert sol._work.out.device == torch.device("cuda", 1)
    assert sol._pieces[0].tab.device == torch.device("cuda", 1)
    assert (candidates.launches - before[0],
            auction.launches - before[1]) == (2, 1)


@pytest.mark.cuda
def test_plan_engine_shards_over_every_card(card):
    """PlanEngine(use_mesh=True): one shard per visible card, planned on
    cuda:0; on one card the single-device solver."""
    from adlb_tpu_torch.balancer.engine import PlanEngine

    eng = PlanEngine(types=(1, 2), max_tasks=8, max_requesters=4,
                     use_mesh=True, nservers=10_000)
    cards = torch.cuda.device_count()
    if cards == 1:
        assert isinstance(eng.solver, AssignmentSolver)
        return
    sol = eng.solver
    assert sol.devices == [torch.device("cuda", i) for i in range(cards)]
    assert sol.device == torch.device("cuda", 0)
    assert sol._Sl == -(-10_000 // cards)
    # built with the engine: every piece on its card, the merge in place
    assert [p.tab.device for p in sol._pieces] == sol.devices
    assert sol.merge_route == "in_place" and sol._merge_work is not None


def _planned_cfg(**kw):
    from adlb_tpu_torch.runtime.world import Config

    return Config(balancer="tpu", device="cuda", solver_host_threshold=0,
                  exhaust_check_interval=0.2, **kw)


@pytest.mark.cuda
def test_spawn_world_refuses_fork_with_a_card_planner(card):
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world
    from adlb_tpu_torch.workloads import nq

    before = multiprocessing.active_children()
    with pytest.raises(ValueError, match="fork"):
        spawn_world(3, 2, [nq.WORK],
                    functools.partial(nq.app_main, n=6, max_depth_for_puts=2),
                    cfg=_planned_cfg(), start_method="fork", timeout=60.0)
    assert multiprocessing.active_children() == before


@pytest.mark.cuda
def test_spawned_master_plans_on_the_card(card, monkeypatch):
    """The default start of a card-planning world is "spawn"; the master
    child plans on the card, one kernel launch per device solve, each
    equal to the numpy twin's."""
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world
    from adlb_tpu_torch.workloads import nq

    monkeypatch.setenv("ADLB_CHECK_SOLVES", "1")
    res = spawn_world(6, 2, [nq.WORK],
                      functools.partial(nq.app_main, n=8, max_depth_for_puts=3),
                      cfg=_planned_cfg(put_routing="home"), timeout=300.0)
    assert sum(s for s, _, _ in res.app_results.values()) \
        == nq.KNOWN_SOLUTIONS[8]
    counts = res.planner[6]
    assert counts["device_solves"] > 0 and counts["host_solves"] == 0
    assert counts["greedy_sweep_launches"] == counts["device_solves"] \
        == counts["solves_checked"]
    assert counts["solves_wrong"] == 0


@pytest.mark.cuda
def test_sidecar_solves_on_the_card_equal_host_greedy(card, monkeypatch):
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ toolchain")
    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.workloads import hotspot_native

    monkeypatch.setattr(solve, "check_every", 1)
    greedy_sweep.reset_counts()
    solve.reset_counts()
    res = hotspot_native.run(n_tasks=600, work_us=1000, num_app_ranks=12,
                             nservers=4, cfg=_planned_cfg(), timeout=300.0)
    assert res.tasks == 600
    counts = solve.planner_counts()
    assert counts["device_solves"] > 0 and counts["host_solves"] == 0
    assert counts["greedy_sweep_launches"] == counts["device_solves"] \
        == counts["solves_checked"]
    assert counts["solves_wrong"] == 0


def _failover_economy(ctx, planned, put):
    """Rank 0 puts a unit at its home server every 2 ms until ``planned``
    is set (by the promoted deputy's first device solve), at most 20,000,
    and records how many in ``put``; every rank consumes until the world
    ends. A rank homed away from rank 0's server is fed only by a plan,
    so the backlog lasts until the deputy has planned on the card, however
    long its planner takes to start there."""
    import struct
    import time

    from adlb_tpu_torch.types import ADLB_SUCCESS

    if ctx.rank == 0:
        n = 0
        while not planned.is_set() and n < 20_000:
            if ctx.put(struct.pack("<q", n), 1) != ADLB_SUCCESS:
                break
            n += 1
            time.sleep(0.002)
        put.append(n)
    got = []
    while True:
        rc, w = ctx.get_work([1])
        if rc != ADLB_SUCCESS:
            return got
        got.append(struct.unpack("<q", w.payload)[0])
        time.sleep(0.002)


@pytest.mark.cuda
def test_promoted_deputy_plans_on_the_card(card, monkeypatch):
    """An in-process world loses its master (server index 0 disconnects at
    its 40th outbound frame): the deputy builds its PlanEngine on the card
    mid-world and plans there, one kernel launch per device solve, every
    solve of both planners equal to the numpy twin's. Units enter rank 0's
    home server until the deputy's first device solve has returned."""
    import threading

    from adlb_tpu_torch.api import run_world
    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.types import InfoKey

    planned, put = threading.Event(), []
    dsolve = solve.AssignmentSolver._device_solve

    def dsolve_(self, *arrays):
        out = dsolve(self, *arrays)
        s = getattr(threading.current_thread(), "server", None)
        if s is not None and s.rank == 5:  # the deputy
            planned.set()
        return out

    monkeypatch.setattr(solve.AssignmentSolver, "_device_solve", dsolve_)
    monkeypatch.setattr(solve, "check_every", 1)
    greedy_sweep.reset_counts()
    solve.reset_counts()
    res = run_world(4, 3, [1], functools.partial(
        _failover_economy, planned=planned, put=put), cfg=_planned_cfg(
        on_server_failure="failover", failover_client_wait=30.0,
        put_routing="home",
        fault_spec={"seed": 5, "disconnect_server_at": {0: 40}}),
        timeout=300.0)
    counts = solve.planner_counts()
    assert res.server_casualties == [4] and not res.aborted
    done = {x for v in res.app_results.values() for x in v}
    lost = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
               + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
               for s in res.server_stats.values())
    assert len(set(range(put[0])) - done) <= lost
    deputy = res.planner[5]
    assert deputy["device_solves"] > 0 and deputy["host_solves"] == 0
    assert deputy["greedy_sweep_launches"] == deputy["device_solves"]
    assert counts["greedy_sweep_launches"] == counts["device_solves"] \
        == counts["solves_checked"]
    assert counts["solves_wrong"] == 0


@pytest.mark.cuda
def test_bench_device_rows_on_the_card(card, monkeypatch):
    """The port's benchmark (``bench_torch.py``) on the card at reduced
    size: its device trickle (row 2, 100 units, every solve on the card)
    launches the kernel once per device solve and every kept solve equals
    ``_host_greedy``; ``solve_onchip`` (row 4, 8 x 512 x 64) times its
    windows and its first and last timed outputs equal ``_host_greedy``,
    one launch per call."""
    import os
    import sys

    from adlb_tpu_torch.balancer import solve

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_torch

    monkeypatch.setattr(solve, "check_every", 1)
    greedy_sweep.reset_counts()
    solve.reset_counts()
    row = bench_torch.device_trickle("cuda", n_tasks=100)
    counts = solve.planner_counts()
    assert row["trickle_dispatch_p50_ms_tpu_device_solve"] > 0
    assert counts["device_solves"] > 0 and counts["host_solves"] == 0
    assert counts["greedy_sweep_launches"] == counts["device_solves"] \
        == counts["solves_checked"]
    assert counts["solves_wrong"] == 0
    greedy_sweep.reset_counts()
    null = bench_torch.null_rtt(device="cuda")
    r = bench_torch.solve_onchip(8, 512, 64, null, reps=3, device="cuda")
    assert null > 0 and r["window_ms"] > 0 and r["ms"] >= 0
    assert r["checked"] == 2 and r["wrong"] == 0
    assert greedy_sweep.launches == r["calls"] == 4
