"""Card-only tests of the port's CUDA kernels (a kernel has no CPU mode).

The greedy sweep: every route at the main path's shape, the route the
kernel reports against ``requester_classes``, one launch per device solve,
and requester counts whose working set does not fit in shared memory (the
kernel's scratch buffer in device memory).

The auction: bit-equal to ``auction_torch`` and to the numpy twin
``_host_auction`` on fuzzed instances (a multi-job type axis whose lists
stay in device memory, two past shared memory), over the full merge and
over the [T, D] lists the device plan hands over, the sharded solver's
device tier equal to its host tier over churn rounds, and a failed build
or launch raises.

The candidates (with the cross-shard merge): per shard and merged, bit-equal
to the plain version and to a numpy twin on fuzzed instances (truncated
types, empty types, repeated ranks, one row per shard, 16 shards, keys past
shared memory), laid out as the solver's strided table; a device plan is
one candidates launch and one auction launch; a refused launch raises.
The graft entry (``graft_entry``) runs on the card.

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
    requester masks -> slot tables: (numpy twin inputs, card tensors)."""
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
    rw, lens = dist._reqwin(rng.random((NR, T)) < 0.4, rv, T, C)
    rwc, open0 = dist._compact_reqwin(rw)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
           for a in (gp, gg, rwc, lens, open0)]
    return (gp, gg, rw, lens, rv), ins


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
    rng = np.random.default_rng(T * 100 + m)
    (gp, gg, rw, lens, rv), ins = _auction_instance(
        rng, T, m, nshards, rounds, Sl=sl, slots=slots)
    C = rw.shape[1]
    work = auction.Workspace(T, C, m, card)
    before = auction.launches
    got = auction.auction(*ins, rounds, m, work=work)
    torch.cuda.synchronize()
    assert auction.launches == before + 1
    assert torch.equal(got, auction.auction_torch(*ins, rounds, m))
    want = dist._host_auction(gp, gg, rw, lens, rv.copy(), rounds, m)
    np.testing.assert_array_equal(got.cpu().numpy()[:, :C], want)
    assert (want >= 0).sum() > 0
    assert (work.scratch is not None) == (slots == 1024)
    assert work.lists_staged == (slots is None)
    # the [T, D] lists the device plan hands over give the same commits
    D = C + m + 1
    cut = [x[:, :D].contiguous() for x in ins[:2]] + ins[2:]
    got_cut = auction.auction(*cut, rounds, m, work=work)
    assert torch.equal(got_cut, auction.auction_torch(*cut, rounds, m))
    np.testing.assert_array_equal(got_cut.cpu().numpy()[:, :C], want)
    with pytest.raises(ValueError, match="workspace"):
        auction.auction(*ins, rounds, m + 1, work=work)


@pytest.mark.cuda
def test_auction_launch_failure_raises(card):
    (_, _, rw, _, _), ins = _auction_instance(np.random.default_rng(3), 4,
                                              8, 2, 4)
    work = auction.Workspace(4, rw.shape[1], 8, card)
    with pytest.raises(RuntimeError, match="auction launch failed"):
        work.launch(*ins, -1)  # the kernel refuses a negative round count
    with pytest.raises(ValueError, match="workspace"):
        auction.Workspace(4, rw.shape[1] + 1, 8, card).launch(*ins, 4)


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
    want = dist._host_auction(sol._gp, sol._gg, sol._rw, sol._lens,
                              sol._req_valid.copy(), sol.rounds, sol.m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_graft_entry_runs_on_the_card(card):
    fn, args = graft_entry.entry()
    assert all(a.is_cuda for a in args)
    out = fn(*args)
    np.testing.assert_array_equal(
        out.cpu().numpy(), fn(*(a.cpu() for a in args)).numpy())
    before = candidates.launches, auction.launches
    got = graft_entry.dryrun_multichip(8)
    assert (candidates.launches - before[0],
            auction.launches - before[1]) == (got["device_plans"],) * 2


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
