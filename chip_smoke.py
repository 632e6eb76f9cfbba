"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc`` (it exits non-zero without them, printing
no result). Phases:

1. build the three kernels, the greedy sweep
   (``adlb_tpu_torch/csrc/greedy_sweep.cu``) and the sharded planner's
   candidates with their cross-shard merge
   (``adlb_tpu_torch/csrc/candidates.cu``) and auction
   (``adlb_tpu_torch/csrc/auction.cu``), from the sources in this
   checkout, one ``nvcc`` per source, started together;
2. hold the kernel against its plain PyTorch versions and against the numpy
   twin ``_host_greedy`` on edge cases (among them requester counts whose
   working set overflows shared memory into the kernel's scratch buffer) and
   at the main path's shapes, with one instance per kernel route at each
   shape plus the ``classes`` instance widened to T=11, which the ``sweep``
   route takes (exact equality: the outputs are integer assignments; the
   route the kernel reports must be the one ``requester_classes`` names),
   and time it: the wrapper, the sort alone, the kernel alone, the plain
   version; then, checked only, the other shapes the main path solves at:
   phase 8's 32768 x 4096 (8 servers) per route, instances shaped like the
   worlds of phases 3 and 8 (T=5: workers want the four work types, the
   master the answer type) and phase 9's 512 x 128 with one type;
3. drive the port's main path: a ``run_world`` with the planned balancer on
   the card, 16 servers x (4096 tasks, 512 requesters), so every device
   solve is a 65536 x 8192 instance; every unit must be consumed exactly
   once, every device solve must be exactly one kernel launch, and every
   eighth solve must equal ``_host_greedy``. Prints the launches per
   route and the median in-world solve split on the host clock into
   hand-off, sort + launch enqueue and wait for the result;
4. hold the candidates kernel, per shard and merged, against its plain
   version and a numpy twin on fuzzed task tables laid out as the solver
   keeps them (1 to 16 shards, one and two jobs, with and without
   truncation, the 10k row's shape sparse, dense, with one type, one
   priority and repeated ranks, empty types, one row per shard, keys past
   shared memory), each launched twice; and the auction kernel against its
   plain version ``auction_torch`` and the numpy twin ``_host_auction`` on
   fuzzed instances (T 1 to 64, m 1 to 40, 1 to 8 shards, C from
   ``_slot_sizes``; three shapes whose working set goes to the kernel's
   device scratch, one whose lists stay in device memory), over the full
   merge and over its first D columns;
   exact equality;
5. drive the sharded planner: ``plan_bench``'s 1k and 10k rows (10,000
   servers x 100 parked requesters = 1M, 160,000 task slots, 8 shards, 16
   rounds) on the card, every round's device-tier pair list equal to the
   host tier's from the same snapshots, one candidates launch and one
   auction launch per device plan (and one candidates launch per host-tier
   sweep); a few ``PlanEngine(use_mesh=True, nshards=8)`` rounds through
   the ledger's view path, both tiers equal; ``dryrun_multichip(8)``
   (``adlb_tpu_torch/graft_entry.py``); then, on the 10k row's final
   state, both kernels against their plain versions and numpy twins, a
   ``_device_plan`` counted at two launches, and the device plan timed:
   each launch alone (medians of CUDA-event windows, and the device time
   per launch in a CUDA graph) beside its bytes bound, the auction's chain bound (rounds run x barriers per round x one
   barrier measured here), and the plain versions;
6. run the known-answer workloads (nq, sudoku, gfmc, tsp, hotspot, model,
   add2, batcher, c1, c3, coinop, grid, partest, pmcmc, skel, trickle) in
   planned-balancer worlds on the card; each must return its answer, and
   every device solve must be one greedy-sweep launch;
7. drive the all-native plane planned on the card: ``hotspot_native`` with
   16 C++ server daemons and 112 C clients (128 ranks), 20,000 tasks of
   2 ms entering one server, the planning sidecar at the phase-3 caps so
   every sidecar solve is a 65536 x 8192 instance; every task done once,
   every device solve one kernel launch, no host solve, every eighth solve
   equal to ``_host_greedy``; units/s, rounds and the solve split printed
   beside phase 3's. Then the seven native workloads (nq, sudoku, gfmc,
   tsp, hotspot, coinop, trickle) at their default sizes on the card;
8. a ``spawn_world`` process world, 32 apps x 8 Python servers at the same
   per-server caps, phase 3's app with 5,000 units; the master is a child
   started without fork that plans on the card and reports its solves,
   kernel launches and checked solves back;
9. two launchers (``python -m adlb_tpu_torch.runtime.launch``) on this
   host split one world with native servers and the sidecar on the card
   in the master's launcher, ``nq_c`` as the app: nq's known answer, and
   the master launcher's kernel launches equal its device solves, every
   one of them checked;
10. phase 3's world loses its master (``on_server_failure="failover"``, a
    fault-injected disconnect of server index 0 at the outbound frame it
    reaches once it has made 50 device solves, before half the units are
    consumed): every unit completed, re-executed or counted lost, the
    deputy builds its planner on the card and plans the rest, one launch
    per device solve for each planner; MTTR and the time from promotion to
    the deputy's first device solve are printed;
11. phase 3's world with a write-ahead log and a spill tier, checkpointed by
    rank 0 mid-run, 2 s after its last put was acknowledged (the planner
    must have solved on the card by then), then a second planned world
    that restores the checkpoint and drains it: consumed and drained cover
    every unit; the first world's wall and its solves before the
    checkpoint are printed;
12. phase 3's world with two weighted jobs, the ops endpoint, an SLO
    objective, the controller (dry run), tail hedging and periodic
    statistics; a ``POST /jobs/1`` mid-run changes a weight, which must
    reach the engine and the solver's job bias;
13. phase 8's process world whose master is SIGKILLed: the promoted
    deputy, a child that never used CUDA before, plans on the card and
    reports its counts back;
14. the port's chaos soak (``scripts/chaos_soak_torch.py``) on the card,
    over a fixed list of seeds whose draws are the master killed
    ``mid_plan`` (twice), a server killed under ``failover`` and a worker
    killed under ``reclaim`` (twice), every world planned on the card with
    the host threshold 0 on the spawn plane: each iteration must pass, and
    its planners together make device solves, one kernel launch each;
15. the JAX package's suites whose worlds plan (``tests/torch_reference.py``,
    ``CARD_FILES``) run unchanged against the port with the device
    ``"cuda"`` and the host threshold 0, three files at a time: every test
    passes (a failed test passes when run once more alone, or the phase
    fails), and each file's pytest process launches the kernel once per
    device solve.

Each phase's wall time is printed.

Every process that plans keeps every eighth device solve (phase 9: every
one) and holds it against ``_host_greedy`` after the world
(``solve.check_every``, ``ADLB_CHECK_SOLVES`` in the children's
environment); a phase fails on any solve that differs.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# torch is imported inside the functions that use it: phase 8's ranks are
# spawned interpreters that import this module for its app, and only the
# planning rank needs torch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NEG = -(2**31) + 1
#: every CHECK_EVERY-th device solve of a planning process is held
#: against ``_host_greedy`` (see ``solve.check_every``)
CHECK_EVERY = 8


def card_label() -> str:
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median per-call device time with CUDA events, each call on an idle
    card, after warm-up (the method of the port's first chip_smoke.py)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 50, reps: int = 7) -> float:
    """Device time per call with no host work in the way: ``calls`` calls
    of ``fn`` captured in one CUDA graph, the median CUDA-event window of
    its replays over ``calls``. ``fn`` must only enqueue work on the
    current stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def back_to_back_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time per call with CUDA events around ``reps`` calls in a
    row, after warm-up: the host enqueues the next call while the card runs
    this one, so it reads lower than :func:`time_ms` by the launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nt: int, nr: int, t: int) -> float:
    """Least time for the solve's bytes: every input read once (prio and
    type int32, mask and valid bool) and assign int32 plus the route word
    written once, over the card's memory rate. Its operations are a few per
    task and a few per mask byte: far under the bytes' time."""
    nbytes = 4 * nt * 2 + nr * t + nr + 4 * (nr + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3


def bench_instance(rng, nt, nr, t=4):
    """The JAX package's solve-scale generator (bench.py, solve_onchip):
    prios in [-50, 50), uniform types, one type per requester, all valid."""
    tp = rng.integers(-50, 50, size=(nt,)).astype(np.int32)
    tt = rng.integers(0, t, size=(nt,)).astype(np.int32)
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    rv = np.ones((nr,), dtype=bool)
    return tp, tt, rm, rv


def random_instance(rng, nt, nr, t, pad=0.25, prio_hi=1000):
    tp = rng.integers(-prio_hi, prio_hi, size=nt).astype(np.int32)
    tt = rng.integers(0, t, size=nt).astype(np.int32)
    p = rng.random(nt) < pad
    tp[p] = NEG
    tt[p] = -1
    rm = rng.random((nr, t)) < 0.5
    rv = rng.random(nr) < 0.8
    return tp, tt, rm, rv


def widen(arrs, t):
    """The same instance over t types: the added types have no task and no
    requester, so the greedy's result is the same, but past T=10 the kernel
    takes route ``sweep``."""
    tp, tt, rm, rv = arrs
    wide = np.zeros((rm.shape[0], t), dtype=bool)
    wide[:, :rm.shape[1]] = rm
    return tp, tt, wide, rv


def world_instance(rng, nt, nr):
    """Shaped like the solves of phases 3 and 8: four work types and the
    answer type (T=5); a 32nd of the requesters (the masters) want only the
    answer type, the others the four work types; a quarter of the task
    slots padding, a fifth of the requester slots empty."""
    tp, tt, _, rv = random_instance(rng, nt, nr, 5, prio_hi=97)
    rm = np.zeros((nr, 5), dtype=bool)
    master = rng.random(nr) < 1 / 32
    rm[master, 4] = True
    rm[~master, :4] = True
    return tp, tt, rm, rv


def one_type_instance(rng, nt, nr, t):
    tp, tt, _, rv = random_instance(rng, nt, nr, t)
    rm = np.zeros((nr, t), dtype=bool)
    rm[np.arange(nr), rng.integers(0, t, nr)] = True
    return tp, tt, rm, rv


def edge_cases(rng):
    cases = []
    for nt, nr, t in ((16, 8, 2), (64, 32, 4), (200, 130, 6), (300, 60, 4),
                      (1024, 9, 2), (5000, 1000, 3)):
        cases.append((f"random {nt}x{nr}x{t}", random_instance(rng, nt, nr, t)))
    tp, tt, rm, rv = random_instance(rng, 2000, 300, 4, pad=0.0)
    tp[:] = 7
    cases.append(("ties 2000x300", (tp, tt, rm, rv)))
    cases.append(("all padding", (np.full(64, NEG, np.int32),
                                  np.full(64, -1, np.int32),
                                  np.ones((40, 3), bool), np.ones(40, bool))))
    tp, tt, rm, _ = random_instance(rng, 100, 50, 3)
    cases.append(("no valid requesters", (tp, tt, rm, np.zeros(50, bool))))
    cases.append(("zero requesters", (tp, tt, np.zeros((0, 3), bool),
                                      np.zeros(0, bool))))
    tp, tt, rm, rv = random_instance(rng, 500, 77, 4)
    rm[::3] = False
    cases.append(("empty masks 500x77", (tp, tt, rm, rv)))
    cases.append(("NR=33", random_instance(rng, 400, 33, 2)))
    cases.append(("multi-job T=64", random_instance(rng, 4096, 700, 64)))
    tp, tt, _, rv = random_instance(rng, 30000, 9000, 7)
    rm = np.arange(7)[None, :] < rng.integers(1, 8, 9000)[:, None]
    cases.append(("nested masks 30000x9000x7", (tp, tt, rm, rv)))
    cases.append(("one type T=64 20000x7000",
                  one_type_instance(rng, 20000, 7000, 64)))
    cases.append(("one type T=70 5000x2000",
                  one_type_instance(rng, 5000, 2000, 70)))
    cases.append(("random T=11 5000x2000", random_instance(rng, 5000, 2000, 11)))
    # past shared memory: 32 servers x 2048 requesters, and 16 x 2048 with
    # 4 types x 16 jobs (T=64); the working set goes to device memory
    big = np.random.default_rng(2)
    cases.append(("random 16384x65536x4",
                  random_instance(big, 16384, 65536, 4)))
    cases.append(("bench 16384x65536", bench_instance(big, 16384, 65536)))
    cases.append(("random T=64 16384x32768",
                  random_instance(big, 16384, 32768, 64)))
    return cases


#: one instance per kernel route at the main path's shapes: bench.py's
#: generator (one type per requester), random masks at T=4 (pad 0.25, valid
#: 0.8), random masks at T=64; the ``classes`` instance is also timed on
#: route ``sweep``, widened to T=11
ROUTE_CASES = (("partition", lambda rng, nt, nr: bench_instance(rng, nt, nr)),
               ("classes", lambda rng, nt, nr: random_instance(rng, nt, nr, 4)),
               ("sweep", lambda rng, nt, nr: random_instance(rng, nt, nr, 64)))


def check_kernel(gs, host_greedy, report):
    """Phase 2: exact agreement, routes and times. Returns the kernel's
    numbers at 65536x8192 per case (the main path's is ``partition``)."""
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    err = 0

    def diff(a, b) -> int:
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def run(name, arrs, want_route=None):
        """Kernel, route and every plain version on one instance; returns
        the card tensors and the kernel's result."""
        nonlocal err
        ins = [torch.from_numpy(a).to(dev) for a in arrs]
        got, code = gs.solve_cuda(*ins)
        torch.cuda.synchronize()
        route = gs.ROUTES[int(code) - 1]
        classes = gs.requester_classes(ins[2], ins[3])
        if route != classes.route or want_route not in (None, route):
            raise AssertionError(
                f"{name}: kernel took route {route!r}, requester_classes "
                f"names {classes.route!r}, expected {want_route!r}")
        want = host_greedy(*arrs)
        plain = gs.greedy_assign_torch(*ins)
        err = max(err, diff(got, plain))
        ok = torch.equal(got, plain) and np.array_equal(got.cpu().numpy(), want)
        plains = ["plain"]
        if route == "partition":
            ok = ok and torch.equal(got, gs.greedy_assign_partition_torch(*ins))
            plains.append("plain partition")
        if route != "sweep":
            ok = ok and torch.equal(got, gs.greedy_assign_classes_torch(*ins))
            plains.append("plain classes")
        if not ok:
            raise AssertionError(f"kernel disagrees on case {name!r}")
        report(f"phase 2: {name}: route {route}; kernel == "
               f"{' == '.join(plains)} == host_greedy")
        return ins, got, route

    for name, arrs in edge_cases(rng):
        run(name, arrs)

    def timed_case(name, route, arrs, nt, nr):
        t = arrs[2].shape[1]
        ins, got, _ = run(f"{name} {nt}x{nr} T={t}", arrs, route)
        t0 = time.perf_counter()
        gs.greedy_assign_torch(*ins)
        torch.cuda.synchronize()
        plain_once = time.perf_counter() - t0
        ms = time_ms(lambda: gs.greedy_assign_cuda(*ins), reps=50)
        ms_b2b = back_to_back_ms(lambda: gs.greedy_assign_cuda(*ins), reps=50)
        sort_ms = time_ms(lambda: gs.sort_tasks(ins[0]), reps=50)
        # the kernel alone: launches on the sorted tasks from ready pointers
        work = gs.Workspace(nt, nr, t, dev)
        ptrs = [x.data_ptr() for x in ins[1:]]
        stream = torch.cuda.current_stream().cuda_stream
        work.run(ins[0], *ptrs, stream)
        if not torch.equal(work.out[:nr], got):
            raise AssertionError(f"{name}: kernel differs between launches")
        kernel_ms = time_ms(lambda: work.launch(*ptrs, stream), reps=50)
        kernel_b2b = back_to_back_ms(lambda: work.launch(*ptrs, stream),
                                     reps=200)
        plain_ms = time_ms(lambda: gs.greedy_assign_torch(*ins),
                           reps=3 if plain_once < 1 else 1, warmup=0)
        bnd = bound_ms(nt, nr, t)
        report(f"phase 2: {name} {nt}x{nr} T={t}: wrapper {ms:.4f} ms "
               f"(back to back {ms_b2b:.4f}), sort alone {sort_ms:.4f} ms, "
               f"kernel alone {kernel_ms:.4f} ms (back to back "
               f"{kernel_b2b:.4f}), plain {plain_ms:.1f} ms, bound "
               f"{bnd:.6f} ms (bytes), matched {int((got >= 0).sum())}")
        if nt == 65536:
            by_case[name.replace(" ", "_")] = {
                "route": route, "ms": ms, "ms_back_to_back": ms_b2b,
                "sort_ms": sort_ms, "kernel_ms": kernel_ms,
                "kernel_ms_back_to_back": kernel_b2b, "plain_ms": plain_ms,
                "bound_ms": bnd}

    by_case = {}
    for nt, nr in ((4096, 512), (16384, 2048), (65536, 8192)):
        for route, make in ROUTE_CASES:
            arrs = make(rng, nt, nr)
            timed_case(route, route, arrs, nt, nr)
            if route == "classes":
                timed_case("classes as sweep", "sweep", widen(arrs, 11),
                           nt, nr)
    # checked only: the other shapes the main path solves at
    rng = np.random.default_rng(3)
    for route, make in ROUTE_CASES:
        run(f"{route} 32768x4096 (phase 8's shape)", make(rng, 32768, 4096),
            route)
    for nt, nr in ((65536, 8192), (32768, 4096)):
        run(f"world-shaped {nt}x{nr} T=5", world_instance(rng, nt, nr),
            "partition")
    for route, make in ROUTE_CASES:
        run(f"{route} 61440x7680 (phase 10's deputy: 15 servers)",
            make(rng, 61440, 7680), route)
    run("one type 512x128 T=1 (phase 9's shape)",
        random_instance(rng, 512, 128, 1))
    run("all open 512x128 T=1", bench_instance(rng, 512, 128, t=1))
    return by_case, err


MAIN_TYPES = (1, 2, 3, 4)
MAIN_ANSWER = 9


def main_value(i: int) -> int:
    return (i * 7919) % 1000003


def main_path_app(ctx, nunits: int):
    """Phase 3's app (also phase 8's, so it lives at module level and
    pickles): rank 0 puts ``nunits`` typed, prioritised units and sums the
    answers; every other rank reserves, gets and answers until the end."""
    from adlb_tpu_torch import ADLB_SUCCESS

    if ctx.rank == 0:
        for i in range(nunits):
            ctx.put(i.to_bytes(4, "little"), MAIN_TYPES[i % 4],
                    work_prio=(i * 31) % 97)
        total = 0
        for _ in range(nunits):
            rc, r = ctx.reserve([MAIN_ANSWER])
            if rc != ADLB_SUCCESS:
                raise RuntimeError(f"answer reserve failed: rc={rc}")
            rc, buf = ctx.get_reserved(r.handle)
            total += int.from_bytes(buf, "little")
        ctx.set_problem_done()
        return total
    seen = []
    while True:
        rc, r = ctx.reserve(list(MAIN_TYPES))
        if rc != ADLB_SUCCESS:
            return seen
        rc, buf = ctx.get_reserved(r.handle)
        if rc != ADLB_SUCCESS:
            return seen
        i = int.from_bytes(buf, "little")
        seen.append(i)
        ctx.put(main_value(i).to_bytes(8, "little"), MAIN_ANSWER,
                target_rank=0)


def main_path_config(device, max_tasks, max_requesters):
    """Puts stay at rank 0's home server, so the other servers' workers are
    fed by the planner's matches and migrations; every solve on the card."""
    from adlb_tpu_torch.runtime.world import Config

    return Config(balancer="tpu", device=device, solver_host_threshold=0,
                  put_routing="home", balancer_max_tasks=max_tasks,
                  balancer_max_requesters=max_requesters)


def check_main_path(res, napps: int, nunits: int) -> None:
    if res.aborted:
        raise AssertionError("world aborted")
    consumed = sorted(i for r in range(1, napps)
                      for i in res.app_results[r])
    if consumed != list(range(nunits)):
        raise AssertionError(
            f"units not consumed exactly once: {len(consumed)} consumed, "
            f"{len(set(consumed))} distinct of {nunits}")
    if res.app_results[0] != sum(main_value(i) for i in range(nunits)):
        raise AssertionError("answer total differs")


def run_main_path(device="cuda", nunits=10_000, napps=64, nservers=16,
                  max_tasks=4096, max_requesters=512):
    """Phase 3: a planned-balancer world on the card (the arguments only
    shrink it for a rehearsal on the CPU). Returns its wall time."""
    from adlb_tpu_torch import run_world

    t0 = time.perf_counter()
    res = run_world(num_app_ranks=napps, nservers=nservers,
                    types=MAIN_TYPES + (MAIN_ANSWER,),
                    app_fn=functools.partial(main_path_app, nunits=nunits),
                    cfg=main_path_config(device, max_tasks, max_requesters),
                    timeout=600)
    wall = time.perf_counter() - t0
    check_main_path(res, napps, nunits)
    return wall


class PlannerTimer:
    """Host-clock time of every planning round (``PlanEngine.round``, in
    the in-server planner and in the sidecar alike) and of every device
    solve (numpy in, numpy out) with its split: hand-off (numpy copies into
    the pinned buffer and the H2D enqueue), sort + launch + D2H enqueue,
    wait for the result."""

    def __init__(self):
        from adlb_tpu_torch.balancer import engine, solve

        self.engine, self.solve = engine, solve
        self.round_s, self.solve_s, self.splits = [], [], []

    def __enter__(self):
        timer = self
        plan_round = self.untimed_round = self.engine.PlanEngine.round
        device_solve = self.untimed_solve = \
            self.solve.AssignmentSolver._device_solve

        def timed_round(engine, *args, **kw):
            t = time.perf_counter()
            out = plan_round(engine, *args, **kw)
            timer.round_s.append(time.perf_counter() - t)
            return out

        def timed_solve(solver, *arrays):
            t = time.perf_counter()
            out = device_solve(solver, *arrays)
            timer.solve_s.append(time.perf_counter() - t)
            if solver.handoff is not None:  # the card route's hand-off
                timer.splits.append(solver.handoff.split)
            return out

        self.engine.PlanEngine.round = timed_round
        self.solve.AssignmentSolver._device_solve = timed_solve
        return self

    def __exit__(self, *exc):
        self.engine.PlanEngine.round = self.untimed_round
        self.solve.AssignmentSolver._device_solve = self.untimed_solve

    def text(self, wall: float) -> str:
        out = (f"{len(self.round_s)} planning rounds, median "
               f"{1e3 * statistics.median(self.round_s or [0]):.3f} ms, "
               f"{sum(self.round_s):.3f} s in all")
        if self.solve_s:
            out += (f"; device solves {sum(self.solve_s):.3f} s in all "
                    f"({100 * sum(self.solve_s) / wall:.1f}% of wall), "
                    f"median {1e3 * statistics.median(self.solve_s):.3f} "
                    f"ms, max {1e3 * max(self.solve_s):.3f} ms each; median "
                    f"split: {split_text(self.splits)}")
        return out


def keep_solves(every: int = CHECK_EVERY) -> None:
    """Hold every ``every``-th device solve of this process, and of the
    planning processes it starts, against ``_host_greedy``."""
    from adlb_tpu_torch.balancer import solve

    solve.check_every = every
    os.environ["ADLB_CHECK_SOLVES"] = str(every)


def stacks_on_timeout(run):
    """``run()``, and when its world times out, every thread's stack on
    stderr first: which rank or planner a hung world waits in."""
    import faulthandler

    try:
        return run()
    except TimeoutError:
        faulthandler.dump_traceback(all_threads=True)
        raise


def check_planned(what: str, counts: dict, device: str = "cuda",
                  need_solves: bool = True) -> None:
    """A planning process's counts (``solve.planner_counts``, or what a
    child sent back): device solves ran (when ``need_solves``), none on
    the host, one kernel launch each on the card, at least every
    CHECK_EVERY-th solve checked, and every checked one equal to
    ``_host_greedy``."""
    solves = counts["device_solves"]
    if (need_solves and solves == 0) or counts["host_solves"] \
            or counts["greedy_sweep_launches"] != (device == "cuda") * solves \
            or counts["solves_checked"] < solves // CHECK_EVERY \
            or counts["solves_wrong"]:
        raise AssertionError(f"{what}: planner counts {counts}")


def split_text(rows) -> str:
    if not rows:
        return "no card hand-off"
    med = [1e3 * statistics.median(col) for col in zip(*rows)]
    return (f"hand-off {med[0]:.3f} ms, sort + launch enqueue "
            f"{med[1]:.3f} ms, wait for the result {med[2]:.3f} ms")


def auction_instance(rng, T, m, nshards, rounds, sl=4, K=8, R=4, slots=None,
                     one_type=False, device="cuda"):
    """A fuzzed auction instance: a random task table cut into shards,
    its per-shard candidates merged (the port's ``_shard_candidates`` and
    ``_merge_shard_major``), random requester masks (or one random type per
    requester, as plan_bench parks them) and their slot tables. Returns
    (numpy twin inputs, tensors on ``device``, D): the tensors hold the full
    [T, nshards * D] merge; the device plan hands the auction its first D
    columns."""
    import torch

    from adlb_tpu_torch.balancer import distributed as dist

    S = nshards * sl
    tp = rng.integers(-50, 50, (S, K)).astype(np.int32)
    tt = rng.integers(0, T, (S, K)).astype(np.int32)
    tp[rng.random((S, K)) < 0.2] = NEG
    rk = rng.permutation(S).astype(np.int32)
    NR = S * R
    C, D = dist._slot_sizes(slots, m, rounds, NR)
    cp, cg = dist._shard_candidates(
        torch.from_numpy(tp).view(nshards, sl, K),
        torch.from_numpy(tt).view(nshards, sl, K),
        torch.from_numpy(rk).view(nshards, sl), T, D)
    gp, gg = dist._merge_shard_major(cp.numpy(), cg.numpy())
    rv = rng.random(NR) < 0.9
    rm = rng.random((NR, T)) < 0.4
    if one_type:
        rm = np.arange(T)[None, :] == rng.integers(0, T, NR)[:, None]
    rw, lens = dist._reqwin(rm, rv, T, C)
    rwc, open0 = dist._compact_reqwin(rw)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in (gp, gg, rwc, lens, open0)]
    return (gp, gg, rw, lens, rv), ins, D


def auction_cases():
    """(name, T, m, nshards, rounds, servers per shard, slots per type, one
    type per requester): every T of {1, 4, 8, 24} with every m of {1, 8,
    32, 40} over 1, 2 and 8 shards, random masks and one type per
    requester; the 10k row's (T, m, C) = (8, 32, 512) at 8 shards;
    multi-job T' = 3 jobs x 8 types at C = 512; and three shapes past
    shared memory."""
    cases = []
    for i, (T, m) in enumerate((T, m) for T in (1, 4, 8, 24)
                               for m in (1, 8, 32, 40)):
        ns = (1, 2, 8)[i % 3]
        for one in (False, True):
            cases.append((f"T={T} m={m} nshards={ns}"
                          f"{' one type' if one else ''}", T, m, ns, 16, 4,
                          None, one))
    cases += [("10k-row shape T=8 m=32 C=512", 8, 32, 8, 16, 32, None, False),
              ("10k-row shape one type", 8, 32, 8, 16, 32, None, True),
              ("multi-job T'=24 C=512", 24, 32, 8, 16, 32, 512, True),
              ("past shared memory T=24 C=1024", 24, 32, 8, 32, 64, 1024,
               True),
              ("past shared memory T=32 C=1024", 32, 8, 8, 4, 64, 1024,
               False),
              ("past shared memory T=64 C=512 m=40", 64, 40, 2, 8, 256, 512,
               True)]
    return cases


def tier(work) -> str:
    """Where an auction workspace's launches keep their working set."""
    if work.scratch is not None:
        return "device scratch"
    if work.lists_staged:
        return "shared memory, lists staged"
    return "shared memory, lists in device memory"


def check_auction(auction, report):
    """Phase 4: the auction kernel against its plain version and the numpy
    twin on every case, over the full [T, nshards * D] merge and over its
    first D columns (what the device plan hands over), both equal to the
    numpy twin over the full merge. Returns the largest absolute difference
    seen."""
    import torch

    from adlb_tpu_torch.balancer import distributed as dist

    err = 0
    for name, T, m, ns, rounds, sl, slots, one in auction_cases():
        rng = np.random.default_rng(T * 1000 + m * 10 + ns)
        (gp, gg, rw, lens, rv), ins, D = auction_instance(
            rng, T, m, ns, rounds, sl=sl, slots=slots, one_type=one)
        C = rw.shape[1]
        want = dist._host_auction(gp, gg, rw, lens, rv.copy(), rounds, m)
        work = auction.Workspace(T, C, m, ins[0].device)
        cut = [x[:, :D].contiguous() for x in ins[:2]] + ins[2:]
        for lists in (ins, cut):
            got = work.launch(*lists, rounds).clone()
            torch.cuda.synchronize()
            plain = auction.auction_torch(*lists, rounds, m)
            err = max(err, int((got.long() - plain.long()).abs().max()))
            if not (torch.equal(got, plain)
                    and np.array_equal(got.cpu().numpy()[:, :C], want)):
                raise AssertionError(f"auction kernel disagrees on case "
                                     f"{name}, L={lists[0].shape[1]}")
        report(f"phase 4: auction {name} C={C} L={gp.shape[1]} and L=D={D} "
               f"rounds={rounds}: kernel == plain == host_auction, "
               f"{int((want >= 0).sum())} commits in "
               f"{int(work.rounds_run)} rounds, {work.threads} threads, "
               f"working set in {tier(work)}")
    return err


def candidates_numpy(tp, tt, rk, T, D):
    """The numpy twin of the candidates: per shard and type, the D live
    slots of the type with the best (prio desc, gid asc), prio clamped,
    gid = rank * K + ki wrapped to int32, padded; [nshards, T, D] each."""
    ns, Sl, K = tp.shape
    gid = (rk.astype(np.int64)[:, :, None] * K + np.arange(K)) % 2**32
    gid = np.where(gid >= 2**31, gid - 2**32, gid).astype(np.int32)
    prio = np.clip(tp, -10**9, 10**9)
    cp = np.full((ns, T, D), NEG, np.int32)
    cg = np.full((ns, T, D), 2**31 - 1, np.int32)
    for s in range(ns):
        for t in range(T):
            sel = (tp[s] > NEG) & (tt[s] == t)
            p, g = prio[s][sel], gid[s][sel]
            o = np.lexsort((g, -p.astype(np.int64)))[:D]
            cp[s, t, :o.size] = p[o]
            cg[s, t, :o.size] = g[o]
    return cp, cg


def candidates_instance(rng, ns, Sl, K, T, D, live=0.8, prio_hi=50,
                        past_clip=False, one_type=False, empty_types=False,
                        dup_ranks=False, device="cuda"):
    """A fuzzed task table laid out as the solver keeps it ([S, 2K + 1]:
    prios, types, rank; the kernel reads strided views of it). Dead slots,
    slots with no type and free rows (rank 0, dead) throughout; optionally
    prios biased past the clip (multi-job), every live slot of type 0, the
    odd types empty, or ranks repeated (equal (prio, gid) pairs). Returns
    numpy (tp, tt, rk) and the views on ``device``."""
    import torch

    S = ns * Sl
    tp = rng.integers(-prio_hi, prio_hi, (S, K)).astype(np.int32)
    if past_clip:
        tp[rng.random((S, K)) < 0.1] = 10**9 + 7000
        tp[rng.random((S, K)) < 0.1] = -10**9 - 3
    tt = rng.integers(-1, T, (S, K)).astype(np.int32)
    if one_type:
        tt[tt >= 0] = 0
    if empty_types:
        tt[tt % 2 == 1] -= 1
    tp[rng.random((S, K)) >= live] = NEG
    rk = rng.permutation(S).astype(np.int32) + 3
    if dup_ranks:
        rk = rng.integers(3, 3 + max(S // 4, 1), S).astype(np.int32)
    free = rng.random(S) < 0.1
    tp[free], tt[free], rk[free] = NEG, -1, 0
    tab = torch.empty((S, 2 * K + 1), dtype=torch.int32)
    tab[:, :K] = torch.from_numpy(tp)
    tab[:, K:2 * K] = torch.from_numpy(tt)
    tab[:, 2 * K] = torch.from_numpy(rk)
    tab = tab.to(device)
    views = (tab[:, :K].reshape(ns, Sl, K), tab[:, K:2 * K].reshape(ns, Sl, K),
             tab[:, 2 * K].reshape(ns, Sl))
    shaped = (tp.reshape(ns, Sl, K), tt.reshape(ns, Sl, K), rk.reshape(ns, Sl))
    return shaped, views


def candidates_cases():
    """(name, nshards, Sl, K, T, D, instance options): nshards 1, 2, 8 and
    16 with one and two jobs (T = 4 and 8, prios past the clip), each with
    and without truncation (more than D live of a type in a shard); the
    10k row's shape (8 x 1250 x 16, T=8, D=545) sparse as plan_bench fills
    it and dense, one type only, equal prios, repeated ranks; empty types;
    one server row per shard; 16 shards at T=24; and a shard whose keys go
    to the kernel's device scratch."""
    cases = []
    for ns in (1, 2, 8, 16):
        for J in (1, 2):
            for trunc in (False, True):
                D = 5 if trunc else 70
                cases.append((f"nshards={ns} J={J} "
                              f"{'truncated' if trunc else 'untruncated'}",
                              ns, 6, 8, 4 * J, D, dict(past_clip=J > 1)))
    cases += [
        ("10k-row shape, plan_bench-sparse", 8, 1250, 16, 8, 545,
         dict(live=0.02)),
        ("10k-row shape, dense", 8, 1250, 16, 8, 545, {}),
        ("10k-row shape, one type", 8, 1250, 16, 8, 545,
         dict(one_type=True)),
        ("10k-row shape, one prio", 8, 1250, 16, 8, 545,
         dict(prio_hi=1, one_type=True)),
        ("10k-row shape, repeated ranks", 8, 1250, 16, 8, 545,
         dict(dup_ranks=True, prio_hi=2)),
        ("empty types", 8, 40, 16, 8, 33, dict(empty_types=True)),
        ("one server row per shard", 8, 1, 8, 2, 9, {}),
        ("16 shards, T=24", 16, 64, 16, 24, 300, dict(past_clip=True)),
        ("past shared memory: 1 shard x 2048 x 16", 1, 2048, 16, 8, 545,
         dict(one_type=True)),
    ]
    return cases


def check_candidates(candidates, report):
    """Phase 4: the candidates kernel, per-shard and merged, against its
    plain version and the numpy twin on every case, launched twice (the
    merge's per-type tickets must come back to 0). Exact equality: integer
    priorities and ids. Returns the largest absolute difference seen."""
    import torch

    from adlb_tpu_torch.balancer import distributed as dist

    err = 0
    for i, (name, ns, Sl, K, T, D, opts) in enumerate(candidates_cases()):
        rng = np.random.default_rng(600 + i)
        shaped, views = candidates_instance(rng, ns, Sl, K, T, D, **opts)
        cp_np, cg_np = candidates_numpy(*shaped, T, D)
        gp_np, gg_np = (x[:, :D] for x in dist._merge_shard_major(cp_np,
                                                                 cg_np))
        work = candidates.Workspace(ns, Sl, K, T, D, views[0].device)
        for merge, want in ((False, (cp_np, cg_np)), (True, (gp_np, gg_np))):
            plain = candidates.candidates_torch(*views, T, D, merge)
            for _ in range(2):
                got = [x.clone() for x in work.launch(*views, merge)]
                torch.cuda.synchronize()
                for g, p, w in zip(got, plain, want):
                    err = max(err, int((g.long() - p.long()).abs().max()))
                    if not (torch.equal(g, p)
                            and np.array_equal(g.cpu().numpy(), w)):
                        raise AssertionError(
                            f"candidates kernel disagrees on case {name} "
                            f"({'merged' if merge else 'per shard'})")
        live = (shaped[0] > NEG) & (shaped[1] >= 0)
        most = max(int((live[s] & (shaped[1][s] == t)).sum())
                   for s in range(ns) for t in range(T))
        report(f"phase 4: candidates {name} [{ns}, {Sl}, {K}] T={T} D={D}: "
               f"per shard and merged, kernel == plain == numpy twin, twice; "
               f"most live of a type in a shard {most}"
               f"{' (truncated)' if most > D else ''}, keys in "
               f"{'device scratch' if work.scratch is not None else 'shared memory'}")
    return err


def auction_bound_ms(auction, gp, gg, rwc, lens, open0, rounds_run, m):
    """Least time for the bytes this run's auction needs, over the card's
    memory rate. Heads and closed slots only grow, so the rounds read each
    type's list up to its last round's head slice (m + 1 entries past the
    head, cut at the first padding entry) and scan its slot table up to
    that round's m-th open slot. The plain version run for one round fewer
    gives that round's heads and open requesters. Counted: each prio read
    and each live gid read, each scanned slot's requester id and open flag,
    the lengths, and assigned [T, C + 1] and the round count written once.
    Its operations (a few dozen per (type, rank) entry per round) take far
    less."""
    import torch

    T, L = gp.shape
    C = rwc.shape[1]
    before = auction.auction_torch(gp, gg, rwc, lens, open0,
                                   max(rounds_run - 1, 0), m)[:, :C]
    head = (before >= 0).sum(dim=1)
    nlive = (gp > NEG).sum(dim=1)
    reach = head + m + 1
    n_prio = torch.minimum(reach, torch.clamp(nlive + 1, max=L))
    n_gid = torch.minimum(reach, nlive)
    open_last = open0.clone()
    open_last[rwc[before >= 0].long()] = False
    cols = torch.arange(C, device=rwc.device)
    slot_open = (cols[None, :] < lens[:, None]) & open_last[rwc.long()]
    mth = slot_open & (torch.cumsum(slot_open, dim=1) == m)
    scanned = torch.where(mth.any(dim=1), mth.int().argmax(dim=1) + 1, lens)
    nbytes = (4 * int(n_prio.sum() + n_gid.sum()) + 5 * int(scanned.sum())
              + 4 * T + 4 * (T * (C + 1) + 1))
    return nbytes / HBM_BYTES_PER_S * 1e3


def timing_script():
    """``scripts/time_auction.py``, loaded from this checkout: its
    ``barrier_ms`` times one block barrier (``scripts/barrier_probe.cu``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "time_auction.py")
    spec = importlib.util.spec_from_file_location("time_auction", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_plan_split(solver, reps: int = 50) -> dict:
    """A device-tier solver's device plan on its resident state, as it
    runs: ``candidates_ms`` (one launch: every shard's candidates and their
    merge into [T, D]), ``auction_ms`` (one launch) and ``device_plan_ms``
    (both), medians of per-call CUDA-event windows, each with its device
    time per call in a CUDA graph beside it (``*_graph_ms``, no host launch
    work in the window); no readback. Its launches count as any other:
    call it after the counts were read."""
    blocks = solver._dev_blocks
    rwc, lens, open0 = solver._dev_req
    cw, aw = solver._cand_work, solver._work

    def cands():
        cw.launch(*blocks, True)

    def auct():
        aw.launch(cw.gp, cw.gg, rwc, lens, open0, solver.rounds)

    def both():
        cands()
        auct()

    cands()
    out = {}
    for name, fn in (("candidates", cands), ("auction", auct),
                     ("device_plan", both)):
        out[f"{name}_ms"] = time_ms(fn, reps)
        out[f"{name}_graph_ms"] = graph_ms(fn)
    return out


def time_device_plan(solver, auction, candidates, report):
    """On a device-tier solver's resident state: the device plan's two
    launches (candidates with the merge, then the auction) held against
    their plain versions and the numpy twins, counted in one
    ``_device_plan`` and timed: each launch alone, both, the plain versions
    (the torch ops the candidates launch replaced: K4's batched sorts, K3
    alone, the merge's sort; ``auction_torch``), each launch's bytes bound
    and the auction's chain bound, and one ``_device_plan`` with its D2H on
    the host clock."""
    import torch

    from adlb_tpu_torch.balancer import distributed as dist
    from adlb_tpu_torch.balancer import solve

    T, C, D, m = solver.T, solver.C, solver.D, solver.m
    blocks = solver._dev_blocks
    rwc, lens, open0 = solver._dev_req
    cw, aw = solver._cand_work, solver._work
    cpu_blocks = [b.cpu().numpy() for b in blocks]
    cp_np, cg_np = candidates_numpy(*cpu_blocks, T, D)
    full_p, full_g = dist._merge_shard_major(cp_np, cg_np)
    got_cp = [x.clone() for x in cw.launch(*blocks, False)]
    gp, gg = (x.clone() for x in cw.launch(*blocks, True))
    plain_cp = candidates.candidates_torch(*blocks, T, D, False)
    plain_gp = candidates.candidates_torch(*blocks, T, D, True)
    if not (all(torch.equal(a, b) for a, b in zip(got_cp, plain_cp))
            and all(torch.equal(a, b) for a, b in zip((gp, gg), plain_gp))
            and np.array_equal(got_cp[0].cpu().numpy(), cp_np)
            and np.array_equal(got_cp[1].cpu().numpy(), cg_np)
            and np.array_equal(gp.cpu().numpy(), full_p[:, :D])
            and np.array_equal(gg.cpu().numpy(), full_g[:, :D])):
        raise AssertionError("candidates kernel disagrees at the 10k row")
    got = aw.launch(gp, gg, rwc, lens, open0, solver.rounds).clone()
    rounds_run = int(aw.rounds_run)
    plain = auction.auction_torch(gp, gg, rwc, lens, open0, solver.rounds, m)
    want = dist._host_auction(full_p, full_g, solver._rw, solver._lens,
                              solver._req_valid.copy(), solver.rounds, m)
    if not (torch.equal(got, plain)
            and np.array_equal(got.cpu().numpy()[:, :C], want)):
        raise AssertionError("auction kernel disagrees at the 10k row")
    c0, a0 = candidates.launches, auction.launches
    solver._device_plan()
    per_plan = (candidates.launches - c0, auction.launches - a0)
    if per_plan != (1, 1):
        raise AssertionError(f"a device plan launched {per_plan} "
                             f"(candidates, auction), not (1, 1)")

    # K3 as the plain candidates call it: the three int32 sort keys of
    # every shard's task slots ([nshards, Sl*K]) to one int64 order
    tp, tt, rk = blocks
    ns, Sl, K = tp.shape
    live = (tp > NEG) & (tt >= 0)
    k3_keys = (torch.where(live, tt, T).reshape(ns, -1),
               -torch.clamp(tp, -10**9, 10**9).reshape(ns, -1),
               (rk.reshape(ns, Sl, 1) * K + torch.arange(
                   K, dtype=torch.int32, device=tp.device)).reshape(ns, -1))
    cp_t, cg_t = candidates.candidates_torch(*blocks, T, D, False)
    split = device_plan_split(solver)
    bar = timing_script().barrier_ms(time_ms, aw.threads)

    def plan_on_card():
        cw.launch(*blocks, True)
        aw.launch(cw.gp, cw.gg, rwc, lens, open0, solver.rounds)

    # the candidates launch reads the task blocks once and writes gp, gg
    cand_bytes = (sum(b.numel() * 4 for b in blocks) + 2 * T * D * 4)
    out = {
        **split,
        "candidates_ms_back_to_back": back_to_back_ms(
            lambda: cw.launch(*blocks, True), reps=200),
        "ms_back_to_back": back_to_back_ms(
            lambda: aw.launch(gp, gg, rwc, lens, open0, solver.rounds),
            reps=200),
        "device_plan_ms_back_to_back": back_to_back_ms(plan_on_card, reps=100),
        "candidates_plain_ms": time_ms(
            lambda: candidates.candidates_torch(*blocks, T, D, True), reps=50),
        "k4_plain_ms": time_ms(
            lambda: candidates.candidates_torch(*blocks, T, D, False),
            reps=50),
        "merge_plain_ms": time_ms(
            lambda: candidates._merge_candidates(cp_t, cg_t), reps=50),
        "k3_ms": time_ms(lambda: solve._stable_argsort3(*k3_keys), reps=50),
        "k3_bound_ms": (sum(k.numel() * 4 for k in k3_keys)
                        + k3_keys[0].numel() * 8) / HBM_BYTES_PER_S * 1e3,
        "candidates_bound_ms": cand_bytes / HBM_BYTES_PER_S * 1e3,
        "plain_ms": time_ms(lambda: auction.auction_torch(
            gp, gg, rwc, lens, open0, solver.rounds, m), reps=3, warmup=1),
        "bound_ms": auction_bound_ms(auction, gp, gg, rwc, lens, open0,
                                     rounds_run, m),
        "barrier_ms": bar,
        "barriers_per_round": auction.BARRIERS_PER_ROUND,
        "chain_bound_ms": rounds_run * auction.BARRIERS_PER_ROUND * bar,
        "auction_threads": aw.threads,
        "auction_lists_staged": aw.lists_staged,
        "launches_per_device_plan": sum(per_plan),
        "rounds_run": rounds_run,
        "commits": int((want >= 0).sum()),
        "shape": {"T": T, "D": D, "C": C, "m": m, "nshards": solver.nshards,
                  "S": solver.S, "K": solver.K},
    }
    host_plan = []
    for _ in range(11):
        t0 = time.perf_counter()
        solver._device_plan()
        host_plan.append(time.perf_counter() - t0)
    out["device_plan_host_clock_ms"] = 1e3 * statistics.median(host_plan[1:])
    report(f"phase 5: 10k row, T={T} D={D} C={C} m={m}: device plan "
           f"{out['device_plan_ms']:.4f} ms per call (back to back "
           f"{out['device_plan_ms_back_to_back']:.4f}, in a CUDA graph "
           f"{out['device_plan_graph_ms']:.4f}), "
           f"{out['launches_per_device_plan']} launches: candidates + merge "
           f"{out['candidates_ms']:.4f} ms (back to back "
           f"{out['candidates_ms_back_to_back']:.4f}, in a CUDA graph "
           f"{out['candidates_graph_ms']:.4f}; bound "
           f"{out['candidates_bound_ms']:.6f} ms, bytes), auction "
           f"{out['auction_ms']:.4f} ms (back to back "
           f"{out['ms_back_to_back']:.4f}, in a CUDA graph "
           f"{out['auction_graph_ms']:.4f}; bound {out['bound_ms']:.6f} ms, "
           f"bytes; chain bound {out['chain_bound_ms']:.6f} ms = "
           f"{rounds_run} rounds x {auction.BARRIERS_PER_ROUND} barriers x "
           f"{bar * 1e3:.4f} us at {aw.threads} threads), "
           f"{out['commits']} "
           f"commits; plain versions: candidates + merge "
           f"{out['candidates_plain_ms']:.4f} ms (per shard "
           f"{out['k4_plain_ms']:.4f}, merge {out['merge_plain_ms']:.4f}, "
           f"K3 alone on [{ns}, {Sl * K}] {out['k3_ms']:.4f} ms, bound "
           f"{out['k3_bound_ms']:.6f} ms), auction {out['plain_ms']:.3f} ms; "
           f"_device_plan with its D2H "
           f"{out['device_plan_host_clock_ms']:.3f} ms on the host clock; "
           f"kernels == plain versions == numpy twins")
    return out


def run_sharded_planner(auction, report, reps=40, device="cuda",
                        scales=None):
    """Phase 5: plan_bench's 1k and 10k rows on the card at plan_bench's own
    40 rounds, both tiers from the same snapshots every round, then
    PlanEngine rounds through the view path (``device``, ``reps`` and
    ``scales`` only shrink it for a rehearsal on the CPU, where nothing
    launches), and ``dryrun_multichip(8)`` (``adlb_tpu_torch/graft_entry.py``).
    Every device plan is one candidates launch and one auction launch; every
    host-tier sweep one candidates launch. Returns ({kernel: launches},
    device plans, the last row's solver, plan_bench's result)."""
    from adlb_tpu_torch import graft_entry
    from adlb_tpu_torch.balancer import candidates, plan_bench
    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver)
    from adlb_tpu_torch.balancer.engine import PlanEngine

    kept = {}
    plans = []

    sweeps = []

    def on_row(solver, row):
        plans.append(solver.solve_count)
        sweeps.append(solver.sweep_count + row["host_tier_sweeps"])
        kept[row["servers"]] = solver
        report(f"phase 5: plan_bench {row['servers']} servers x {row['R']} "
               f"parked ({row['parked_reqs']} requesters, "
               f"{row['servers'] * row['K']} task slots), 8 shards: plan "
               f"round p50 {row['plan_round_p50_ms']:.3f} ms, p90 "
               f"{row['plan_round_p90_ms']:.3f} ms, p99 "
               f"{row['plan_round_p99_ms']:.3f} ms, max "
               f"{row['plan_round_max_ms']:.3f} ms (median split: ingest "
               f"{row['ingest_p50_ms']:.3f} ms, solve {row['solve_p50_ms']:.3f}"
               f" ms, extract {row['extract_p50_ms']:.3f} ms); pairs per round "
               f"{row['pairs_per_round_p50']} (p50), {row['pairs_total']} in "
               f"all; cold ingest {row['cold_ingest_ms']:.1f} ms, first plan "
               f"{row['first_plan_ms']:.1f} ms, warm sweep "
               f"{row['device_sweep_ms']:.2f} ms; host tier p50 "
               f"{row['host_tier_p50_ms']:.3f} ms, p99 "
               f"{row['host_tier_p99_ms']:.3f} ms; device tier == host tier "
               f"on all {row['rounds_equal_to_host_tier']} rounds")

    auction.launches = candidates.launches = 0
    scales = scales or [plan_bench.SCALES[2], plan_bench.SCALES[3]]
    out = plan_bench.run_sweep(scales=scales, reps=reps, nshards=8,
                               device=device, check_host=True, on_row=on_row)
    launches, cand_launches = auction.launches, candidates.launches
    # a few engine rounds: the array ledger hands the solver its view
    engines = [PlanEngine(types=plan_bench.TYPES, max_tasks=16,
                          max_requesters=16, use_mesh=True, nshards=8,
                          nservers=256, auction=tier, device=device)
               for tier in ("device", "host")]
    for eng in engines:
        if not isinstance(eng.solver, DistributedAssignmentSolver):
            raise AssertionError("PlanEngine(use_mesh=True, nshards=8) did "
                                 "not build the sharded solver")
        # the engine's timed rules (pump cadence, inflow and suppression
        # lifetimes) off, so the two engines see the same rounds however
        # long each tier's plan takes
        eng.PUMP_INTERVAL = eng.INFLOW_MIN_AGE = 0.0
        eng.INFLOW_TTL = eng.SUPPRESS_TTL = eng.PARK_RECENT = 1e9
        eng.LOOK_GROW_WINDOW = 1e9
    rng = np.random.default_rng(5)
    seq = [0]
    matched = 0
    for rnd in range(6):
        snaps = {}
        for s in range(100, 356):
            tasks = []
            for _ in range(int(rng.integers(0, 6))):
                seq[0] += 1
                tasks.append((seq[0], int(rng.integers(1, 9)),
                              int(rng.integers(-50, 50)), 64))
            tasks.sort(key=lambda t: -t[2])
            reqs = [(s * 200 + i, rnd * 100 + i + 1,
                     [int(rng.integers(1, 9))])
                    for i in range(int(rng.integers(0, 4)))]
            snaps[s] = {"tasks": tasks, "reqs": reqs, "consumers": 1,
                        "nbytes": 64 * len(tasks), "stamp": float(rnd),
                        "task_stamp": float(rnd)}
        got = [eng.round(snaps, None) for eng in engines]
        if got[0] != got[1]:
            raise AssertionError(f"engine round {rnd}: the device tier's "
                                 f"plan differs from the host tier's")
        matched += len(got[0][0])
    launches_engine = auction.launches - launches
    cand_engine = candidates.launches - cand_launches
    on_card = device == "cuda"
    dev_solver, host_solver = (e.solver for e in engines)
    if dev_solver._seen_member_gen is None or matched == 0 \
            or launches_engine != on_card * dev_solver.solve_count \
            or cand_engine != on_card * (dev_solver.solve_count
                                         + host_solver.sweep_count):
        raise AssertionError("the engine rounds did not plan through the "
                             "view path and the kernels")
    report(f"phase 5: PlanEngine(use_mesh=True, nshards=8) x 6 rounds "
           f"through the ledger view: {matched} matches, device tier == "
           f"host tier, {cand_engine} candidates and {launches_engine} "
           f"auction launches")
    if launches != on_card * sum(plans) or not all(plans) \
            or cand_launches != on_card * (sum(plans) + sum(sweeps)):
        raise AssertionError(f"plan_bench did not run one launch of each "
                             f"kernel per device plan: auction {launches}, "
                             f"candidates {cand_launches}, plans {plans}, "
                             f"sweeps {sweeps}")
    before = candidates.launches, auction.launches
    dry = graft_entry.dryrun_multichip(8, device=device)
    dry_launches = (candidates.launches - before[0],
                    auction.launches - before[1])
    if dry_launches != (on_card * dry["device_plans"],) * 2:
        raise AssertionError(f"dryrun_multichip(8): {dry_launches} "
                             f"(candidates, auction) launches for "
                             f"{dry['device_plans']} device plans")
    report(f"phase 5: dryrun_multichip(8) on {device}: {dry['pairs']} plan "
           f"entries, types respected; engine round {dry['matches']} "
           f"matches, {dry['migrations']} migrations; "
           f"{dry['device_plans']} device plans = {dry_launches[0]} "
           f"candidates + {dry_launches[1]} auction launches")
    counts = {"auction": auction.launches,
              "shard_candidates": candidates.launches}
    return counts, sum(plans), kept[scales[-1][0]], out


def run_workloads(gs, report, device="cuda"):
    """Phase 6: the known-answer workloads in planned-balancer worlds on the
    card (``device="cpu"`` for a rehearsal, where nothing launches).
    Returns the greedy-sweep launches and device solves of all runs."""
    import dataclasses

    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.runtime.world import Config
    from adlb_tpu_torch.workloads import (
        add2,
        batcher,
        c1,
        c3,
        coinop,
        gfmc,
        grid,
        hotspot,
        model,
        nq,
        pmcmc,
        skel,
        sudoku,
        trickle,
        tsp,
    )

    keep_solves()
    cfg = Config(balancer="tpu", device=device, solver_host_threshold=0,
                 balancer_max_tasks=64, balancer_max_requesters=16,
                 exhaust_check_interval=0.15)
    dists = tsp.dist_matrix(tsp.make_cities(9, seed=3))
    pairs = [(i, 2 * i + 1) for i in range(100)]
    durations = [0.02, 0.01, 0.01, 0.005] * 3
    runs = (
        ("nq n=8", lambda: nq.run(n=8, num_app_ranks=4, nservers=2, cfg=cfg),
         lambda r: r.solutions == nq.KNOWN_SOLUTIONS[8],
         lambda r: f"{r.solutions} solutions"),
        ("sudoku", lambda: sudoku.run(num_app_ranks=4, nservers=2, cfg=cfg),
         lambda r: r.valid, lambda r: "valid solution"),
        ("gfmc 6x3x2", lambda: gfmc.run(num_a=6, bs_per_a=3, cs_per_b=2,
                                        num_app_ranks=5, nservers=2, cfg=cfg),
         lambda r: r.ok, lambda r: f"counts {r.counts}"),
        ("tsp 9 cities", lambda: tsp.run(n_cities=9, num_app_ranks=4,
                                         nservers=2, seed=3, cfg=cfg),
         lambda r: r.best == tsp.brute_force_optimum(dists),
         lambda r: f"tour length {r.best}"),
        ("hotspot 400 tokens", lambda: hotspot.run(
            n_tasks=400, work_time=0.002, num_app_ranks=9, nservers=4,
            cfg=cfg), lambda r: r.tasks == 400,
         lambda r: f"{r.tasks} tokens, {r.tasks_per_sec:.1f} tasks/s"),
        ("model mesh=auto", lambda: model.run(
            numprobs=40, work_secs=0.002, num_app_ranks=4, nservers=2,
            cfg=dataclasses.replace(cfg, balancer_mesh="auto")),
         lambda r: r.ok, lambda r: f"{r.num_done} of {r.numprobs} done"),
        ("add2 100 pairs", lambda: add2.run(pairs, nservers=2, cfg=cfg),
         lambda r: r.ok, lambda r: f"sum {r.total}"),
        ("batcher 12 jobs", lambda: batcher.run(durations, nservers=2,
                                                     cfg=cfg),
         lambda r: sum(r.jobs_run.values()) == len(durations),
         lambda r: f"{sum(r.jobs_run.values())} jobs run"),
        ("c1", lambda: c1.run(nservers=2, cfg=cfg), lambda r: r.ok,
         lambda r: f"B answer sum {r.total}"),
        ("c3", lambda: c3.run(nservers=2, cfg=cfg), lambda r: r.ok,
         lambda r: f"{r.a_answers} A and {r.c_answers} C answers"),
        ("coinop", lambda: coinop.run(cfg=cfg), lambda r: r.pops == 500,
         lambda r: f"{r.pops} pops, p50 {r.latency_p50_ms:.3f} ms"),
        ("grid 8x8x4", lambda: grid.run(nservers=2, cfg=cfg),
         lambda r: (r.grid == grid.run_sequential(8, 8, 4)).all(),
         lambda r: f"grid == sequential, average {r.average:.6f}"),
        ("partest", lambda: partest_world(cfg), lambda r: r,
         lambda r: "every calibrated unit replayed once"),
        ("pmcmc", lambda: pmcmc.run(nservers=2, cfg=cfg), lambda r: r.ok,
         lambda r: f"{len(r.solutions)} chains equal to pmcmc.chain"),
        ("skel", lambda: skel.run(cfg=cfg), lambda r: r.ok,
         lambda r: f"{sum(r.consumed.values())} tasks of 8 types"),
        ("trickle", lambda: trickle.run(cfg=cfg), lambda r: r.tasks == 200,
         lambda r: f"{r.tasks} tokens, dispatch p50 "
                   f"{r.dispatch_p50_ms:.3f} ms"),
    )
    total_launches = total_solves = 0
    for name, run, ok, what in runs:
        gs.reset_counts()
        solve.reset_counts()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        c = solve.planner_counts()
        if not ok(res):
            raise AssertionError(f"workload {name} returned a wrong answer: "
                                 f"{res}")
        check_planned(f"workload {name}", c, device, need_solves=False)
        total_launches += c["greedy_sweep_launches"]
        total_solves += c["device_solves"]
        report(f"phase 6: {name}: {what(res)} (known answer) in {wall:.3f} s, "
               f"{c['device_solves']} device solves = "
               f"{c['greedy_sweep_launches']} kernel launches, "
               f"{c['solves_checked']} == _host_greedy")
    if total_solves == 0:
        raise AssertionError("no workload ran a device solve")
    return total_launches, total_solves


def partest_world(cfg, nunits=24) -> bool:
    """partest has no world of its own: its calibrated units (define_work)
    go through a planned world, each replayed (do_work) by the rank that
    gets it. True when every unit was replayed once."""
    import pickle

    from adlb_tpu_torch import ADLB_SUCCESS, run_world
    from adlb_tpu_torch.workloads import partest

    units = [partest.define_work(0.002 * (1 + i % 3), nugget_reps=50)
             for i in range(nunits)]

    def app(ctx):
        if ctx.rank == 0:
            for i, u in enumerate(units):
                ctx.put(pickle.dumps((i, u)), 1)
        done = []
        while True:
            rc, w = ctx.get_work([1])
            if rc != ADLB_SUCCESS:
                return done
            i, u = pickle.loads(w.payload)
            partest.do_work(u, nugget_reps=50)
            done.append(i)

    res = run_world(num_app_ranks=4, nservers=2, types=[1], app_fn=app,
                    cfg=cfg, timeout=300)
    return sorted(i for v in res.app_results.values() for i in v) \
        == list(range(nunits))


#: the C client of each native workload (built in phase 1)
NATIVE_EXAMPLES = ("hotspot_c.c", "nq_c.c", "sudoku_c.c", "gfmc_c.c",
                   "tsp_c.c", "coinop_c.c", "trickle_c.c")


def build_native():
    """The native plane from this checkout's sources: the server daemon,
    the C client library and each workload's C client (g++ / gcc into
    ``adlb_tpu_torch/_build/native/``). Returns the built paths."""
    from adlb_tpu_torch.native import build, capi

    root = os.path.dirname(os.path.abspath(__file__))
    return [build.ensure_serverd()] + [
        capi.build_example(os.path.join(root, "examples", ex))
        for ex in NATIVE_EXAMPLES]


def run_native_plane(gs, report, device="cuda", n_tasks=20_000,
                     clients=112, nservers=16, max_tasks=4096,
                     max_requesters=512):
    """Phase 7: the hotspot world on the all-native plane, planned by the
    sidecar on the card (the arguments only shrink it for a rehearsal on
    the CPU). The sidecar is this process's only planner, so the
    process-wide counts are its own. Returns (result, wall, timer, planner
    counts)."""
    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.runtime.world import Config
    from adlb_tpu_torch.workloads import hotspot_native

    cfg = Config(server_impl="native", balancer="tpu", device=device,
                 solver_host_threshold=0, balancer_max_tasks=max_tasks,
                 balancer_max_requesters=max_requesters)
    keep_solves()
    gs.reset_counts()
    solve.reset_counts()
    with PlannerTimer() as timer:
        t0 = time.perf_counter()
        res = hotspot_native.run(n_tasks=n_tasks, work_us=2000,
                                 num_app_ranks=clients, nservers=nservers,
                                 cfg=cfg, timeout=600)
        wall = time.perf_counter() - t0
    counts = solve.planner_counts()
    if res.tasks != n_tasks:
        raise AssertionError(f"hotspot_native: {res.tasks} of {n_tasks} "
                             f"tasks done")
    check_planned("native plane", counts, device)
    report(f"phase 7: native plane, {nservers} C++ daemons x {clients} C "
           f"clients, {n_tasks} tasks of 2 ms done once in {wall:.3f} s "
           f"wall ({n_tasks / wall:.1f} units/s on the wall clock; the "
           f"probe's makespan {res.elapsed:.3f} s, {res.tasks_per_sec:.1f} "
           f"tasks/s, idle {res.idle_pct:.1f}%, wait {res.wait_pct:.1f}%); "
           f"device solves {counts['device_solves']} ({max_tasks * nservers}"
           f"x{max_requesters * nservers}), host solves "
           f"{counts['host_solves']}, kernel launches "
           f"{counts['greedy_sweep_launches']}, by route "
           f"{gs.route_launches()}")
    report(f"phase 7: sidecar {timer.text(wall)}; {counts['solves_checked']} "
           f"kept solves == _host_greedy")
    return res, wall, timer, counts


def run_native_workloads(gs, report, device="cuda"):
    """Phase 7, second part: the seven native workloads (five known
    answers, the coinop and trickle probes) at their default sizes with
    the sidecar on the card. Returns the kernel launches
    and device solves of all runs."""
    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.runtime.world import Config
    from adlb_tpu_torch.workloads import (
        coinop_native,
        gfmc_native,
        hotspot_native,
        nq_native,
        sudoku_native,
        trickle_native,
        tsp_native,
    )

    keep_solves()
    cfg = Config(balancer="tpu", device=device, solver_host_threshold=0,
                 exhaust_check_interval=0.15)
    runs = (
        ("nq_native", lambda: nq_native.run(cfg=cfg),
         lambda r: r.solutions == r.expected,
         lambda r: f"{r.solutions} solutions"),
        ("sudoku_native", lambda: sudoku_native.run(cfg=cfg),
         lambda r: r.valid, lambda r: f"{r.solved} solved, valid"),
        ("gfmc_native", lambda: gfmc_native.run(cfg=cfg), lambda r: r.ok,
         lambda r: f"counts {r.counts}"),
        ("tsp_native", lambda: tsp_native.run(cfg=cfg),
         lambda r: r.optimum is not None and r.best == r.optimum,
         lambda r: f"tour length {r.best}"),
        ("hotspot_native", lambda: hotspot_native.run(cfg=cfg),
         lambda r: r.tasks == 2000,
         lambda r: f"{r.tasks} tokens, {r.tasks_per_sec:.1f} tasks/s"),
        ("coinop_native", lambda: coinop_native.run(cfg=cfg),
         lambda r: r.pops == 400,
         lambda r: f"{r.pops} pops, p50 {r.latency_p50_ms:.3f} ms"),
        ("trickle_native", lambda: trickle_native.run(cfg=cfg),
         lambda r: r.tasks == 240,
         lambda r: f"{r.tasks} tokens, dispatch p50 "
                   f"{r.dispatch_p50_ms:.3f} ms"),
    )
    total_launches = total_solves = 0
    for name, run, ok, what in runs:
        gs.reset_counts()
        solve.reset_counts()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        c = solve.planner_counts()
        if not ok(res):
            raise AssertionError(f"{name} returned a wrong answer: {res}")
        check_planned(name, c, device, need_solves=False)
        total_launches += c["greedy_sweep_launches"]
        total_solves += c["device_solves"]
        report(f"phase 7: {name}: {what(res)} (known answer) in {wall:.3f} "
               f"s, {c['device_solves']} device solves = "
               f"{c['greedy_sweep_launches']} kernel launches, "
               f"{c['solves_checked']} == _host_greedy")
    if total_solves == 0:
        raise AssertionError("no native workload ran a device solve")
    return total_launches, total_solves


def run_process_world(report, device="cuda", nunits=5_000, napps=32,
                      nservers=8, max_tasks=4096, max_requesters=512):
    """Phase 8: phase 3's app in a ``spawn_world`` process world of Python
    servers; the master is a child that plans on the card (started without
    fork) and holds every CHECK_EVERY-th solve against ``_host_greedy``
    (``ADLB_CHECK_SOLVES`` in its environment) after the world, before it
    reports. Returns (wall, the master's planner counts)."""
    from adlb_tpu_torch.runtime.transport_shm import resolve_fabric
    from adlb_tpu_torch.runtime.transport_tcp import (
        resolve_start_method,
        spawn_world,
    )

    cfg = main_path_config(device, max_tasks, max_requesters)
    keep_solves()
    t0 = time.perf_counter()
    res = spawn_world(napps, nservers, MAIN_TYPES + (MAIN_ANSWER,),
                      functools.partial(main_path_app, nunits=nunits),
                      cfg=cfg, timeout=600)
    wall = time.perf_counter() - t0
    check_main_path(res, napps, nunits)
    if list(res.planner) != [napps]:  # the master: the first server rank
        raise AssertionError(f"process world: planners {res.planner}")
    counts = res.planner[napps]
    check_planned("process world's master", counts, device)
    report(f"phase 8: spawn_world {napps} apps x {nservers} Python servers "
           f"({resolve_fabric(cfg)} fabric, ranks started with "
           f"{resolve_start_method(cfg, None)!r}), {nunits} units consumed "
           f"once in {wall:.3f} s ({nunits / wall:.1f} units/s); the master "
           f"child's planning rounds {counts['rounds']}, "
           f"{counts['round_s']:.3f} s in all (mean "
           f"{1e3 * counts['round_s'] / max(counts['rounds'], 1):.3f} ms); "
           f"device solves {counts['device_solves']} "
           f"({max_tasks * nservers}x{max_requesters * nservers}), host "
           f"solves {counts['host_solves']}, kernel launches "
           f"{counts['greedy_sweep_launches']}; {counts['solves_checked']} "
           f"of the master's solves == _host_greedy")
    return wall, counts


def run_launchers(report, device="cuda", n=10, cutoff=3, apps_per_host=4):
    """Phase 9: two launchers on this host split one world of native
    servers, the sidecar on the card in the master's launcher, ``nq_c`` as
    the app; the sidecar holds every solve against ``_host_greedy``.
    Returns the master launcher's planner counts."""
    from adlb_tpu_torch.native.capi import build_example
    from adlb_tpu_torch.workloads.nq import KNOWN_SOLUTIONS

    root = os.path.dirname(os.path.abspath(__file__))
    exe = build_example(os.path.join(root, "examples", "nq_c.c"))
    napps = 2 * apps_per_host
    env = dict(os.environ, ADLB_NQ_N=str(n), ADLB_NQ_CUTOFF=str(cutoff),
               ADLB_PUT_ROUTING="home", ADLB_CHECK_SOLVES="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    hosts = [f"0-{apps_per_host - 1},{napps}",
             f"{apps_per_host}-{napps - 1},{napps + 1}"]
    with tempfile.TemporaryDirectory() as rdv:
        common = [sys.executable, "-m", "adlb_tpu_torch.runtime.launch",
                  "--rendezvous", rdv, "--nranks", str(napps + 2),
                  "--nservers", "2", "--types", "1", "--server-impl",
                  "native", "--balancer", "tpu", "--device", device,
                  "--solver-host-threshold", "0", "--timeout", "300"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(common + ["--ranks", ranks, exe], env=env,
                                  cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for ranks in hosts]
        try:
            outs = [p.communicate(timeout=400) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"launcher exited {p.returncode}:\n{out}\n"
                                 f"{err[-4000:]}")
    solutions = sum(int(v) for out, _ in outs
                    for v in re.findall(r"solutions=(\d+)", out))
    found = re.findall(r"\[adlb_launch\] planner (\{.*\})", outs[0][1])
    counts = json.loads(found[-1]) if found else None
    if solutions != KNOWN_SOLUTIONS[n]:
        raise AssertionError(f"nq({n}) over two launchers: {solutions} "
                             f"solutions, want {KNOWN_SOLUTIONS[n]}")
    if counts is None:
        raise AssertionError("launchers: the master launcher printed no "
                             "planner counts")
    check_planned("master launcher's sidecar", counts, device)
    if counts["solves_checked"] != counts["device_solves"]:
        raise AssertionError(f"launchers: not every solve checked: {counts}")
    report(f"phase 9: two launchers, {napps} nq_c clients + 2 C++ daemons, "
           f"the sidecar in the master's launcher: nq({n}) = {solutions} "
           f"(known answer) in {wall:.3f} s; device solves "
           f"{counts['device_solves']}, host solves {counts['host_solves']}, "
           f"kernel launches {counts['greedy_sweep_launches']}, "
           f"{counts['solves_checked']} == _host_greedy")
    return counts


def failover_app(ctx, nunits: int, work_s: float, progress=None):
    """Phases 10 and 13: phase 3's app made to outlive a server: every rank
    takes fused reserves (``get_work``) and rank 0 collects answers until
    the world's exhaustion instead of counting them, since a unit that
    failover counts as lost never answers, and a worker spends ``work_s``
    seconds on each unit. Returns rank 0's answered units, every other
    rank's consumed units. ``progress`` (in-process only) gets one entry
    per unit consumed."""
    from adlb_tpu_torch import ADLB_SUCCESS

    if ctx.rank == 0:
        for i in range(nunits):
            ctx.put(i.to_bytes(4, "little"), MAIN_TYPES[i % 4],
                    work_prio=(i * 31) % 97)
        answered = []
        while True:
            rc, w = ctx.get_work([MAIN_ANSWER])
            if rc != ADLB_SUCCESS:
                return answered
            answered.append(int.from_bytes(w.payload, "little"))
    seen = []
    while True:
        rc, w = ctx.get_work(list(MAIN_TYPES))
        if rc != ADLB_SUCCESS:
            return seen
        i = int.from_bytes(w.payload, "little")
        seen.append(i)
        if progress is not None:
            progress.append(i)
        time.sleep(work_s)
        ctx.put(i.to_bytes(4, "little"), MAIN_ANSWER, target_rank=0)


def check_failover(what: str, res, nunits: int, master: int) -> dict:
    """Every unit completed, re-executed or counted in FAILOVER_LOST or
    FAILOVER_RELAYS_UNRESOLVED, the master the one casualty, a takeover
    reported and the world not aborted. Returns the world's unit
    accounting."""
    from adlb_tpu_torch.types import InfoKey

    consumed = [i for r, v in res.app_results.items() if r != 0
                for i in v]
    lost = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
               + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
               for s in res.server_stats.values())
    failovers = sum(s.get(int(InfoKey.NUM_FAILOVERS), 0.0)
                    for s in res.server_stats.values())
    missing = set(range(nunits)) - set(consumed)
    if (len(missing) > lost or res.server_casualties != [master]
            or failovers < 1 or res.aborted
            or not set(res.app_results[0]) <= set(consumed)):
        raise AssertionError(
            f"{what}: {len(missing)} units missing with {lost} counted "
            f"lost, casualties {res.server_casualties}, failovers "
            f"{failovers}, aborted {res.aborted}")
    return {"consumed": len(consumed), "distinct": len(set(consumed)),
            "re_executed": len(consumed) - len(set(consumed)),
            "lost": int(lost), "failovers": int(failovers),
            "answered": len(res.app_results[0])}


class FailoverProbe:
    """Phase 10's instruments: the servers, the master's fault plan (its
    endpoint's ``disconnect_at`` is set mid-run to the next outbound
    frame, see :meth:`arm`), the
    deputy's promotion time and MTTR gauge, and the host-clock end of
    each solver's first device solve."""

    def __init__(self, master: int, min_solves: int):
        from adlb_tpu_torch.balancer import solve
        from adlb_tpu_torch.runtime import faults, server

        self.faults, self.server, self.solve = faults, server, solve
        self.master, self.min_solves = master, min_solves
        self.plans, self.first_solve = {}, {}
        self.servers = {}
        self.promoted = None  # (host-clock time, deputy Server, mttr ms)
        self.death = None  # (frame N, master's device solves, consumed)

    def __enter__(self):
        probe = self
        wrap = self.untimed_wrap = self.faults.maybe_wrap
        promote = self.untimed_promote = self.server.Server._promote_master
        run = self.untimed_run = self.server.Server.run
        dsolve = self.untimed_solve = \
            self.solve.AssignmentSolver._device_solve

        def maybe_wrap(ep, cfg, world=None):
            out = wrap(ep, cfg, world)
            if hasattr(out, "plan"):
                probe.plans[out.rank] = out.plan
            return out

        def run_server(srv):
            probe.servers[srv.rank] = srv
            return run(srv)

        def promote_master(srv, *args):
            promote(srv, *args)
            probe.promoted = (time.perf_counter(), srv, srv.metrics.gauge(
                "master_failover_mttr_ms").v)

        def device_solve(solver, *arrays):
            out = dsolve(solver, *arrays)
            probe.first_solve.setdefault(id(solver), time.perf_counter())
            return out

        self.faults.maybe_wrap = maybe_wrap
        self.server.Server._promote_master = promote_master
        self.server.Server.run = run_server
        self.solve.AssignmentSolver._device_solve = device_solve
        return self

    def __exit__(self, *exc):
        self.faults.maybe_wrap = self.untimed_wrap
        self.server.Server._promote_master = self.untimed_promote
        self.server.Server.run = self.untimed_run
        self.solve.AssignmentSolver._device_solve = self.untimed_solve

    def arm(self, progress: list, half: int, stop: threading.Event) -> None:
        """Run beside the world: once the master has made ``min_solves``
        device solves, and before ``half`` units are consumed, its next
        outbound frame disconnects it."""
        while not stop.is_set():
            plan = self.plans.get(self.master)
            srv = self.servers.get(self.master)
            if plan is not None and srv is not None and \
                    self.solve.solve_counts["device"] >= self.min_solves:
                done = len(progress)
                if done >= half:
                    return  # too late: the phase fails on self.death
                with plan._lock:
                    plan.disconnect_at = plan.frame + 1
                self.death = (plan.disconnect_at,
                              self.solve.solve_counts["device"], done,
                              srv.wq.untargeted_avail)
                return
            time.sleep(0.0005)


def run_master_failover(gs, report, device="cuda", nunits=10_000, napps=64,
                        nservers=16, max_tasks=4096, max_requesters=512,
                        min_solves=50, work_s=0.01):
    """Phase 10: phase 3's world loses its master. ``fault_spec`` arms a
    disconnect of server index 0, whose frame number N is set mid-run:
    the master's next outbound frame once it has made ``min_solves``
    device solves, while fewer than half the units are consumed. Each
    unit takes its worker ``work_s`` seconds, so the deputy's own workers
    fall behind rank 0's puts and the deputy has a backlog to plan. The
    deputy builds its PlanEngine on the card and plans the rest. Returns
    (wall, the planners' counts by rank, the probe's numbers)."""
    import dataclasses

    from adlb_tpu_torch import run_world
    from adlb_tpu_torch.balancer import solve

    master, deputy = napps, napps + 1
    cfg = dataclasses.replace(
        main_path_config(device, max_tasks, max_requesters),
        on_server_failure="failover", failover_client_wait=60.0,
        fault_spec={"seed": 10, "disconnect_server_at": {0: 2**62}})
    keep_solves()
    gs.reset_counts()
    solve.reset_counts()
    progress, stop = [], threading.Event()
    with FailoverProbe(master, min_solves) as probe:
        arm = threading.Thread(target=probe.arm,
                               args=(progress, nunits // 2, stop),
                               daemon=True)
        arm.start()
        t0 = time.perf_counter()
        res = stacks_on_timeout(lambda: run_world(
            num_app_ranks=napps, nservers=nservers,
            types=MAIN_TYPES + (MAIN_ANSWER,),
            app_fn=functools.partial(failover_app, nunits=nunits,
                                     work_s=work_s, progress=progress),
            cfg=cfg, timeout=240))
        wall = time.perf_counter() - t0
        stop.set()
        arm.join()
    if probe.death is None:
        raise AssertionError(f"master failover: the master made under "
                             f"{min_solves} device solves before half the "
                             f"units were consumed")
    acct = check_failover("master failover", res, nunits, master)
    counts = solve.planner_counts()
    planners = res.planner
    if set(planners) != {master, deputy} or probe.promoted is None \
            or probe.promoted[1].rank != deputy:
        raise AssertionError(f"master failover: planners {sorted(planners)}"
                             f", promoted {probe.promoted}")
    dep_solver = probe.promoted[1]._solver
    # a solve packs the servers whose snapshots the planner holds: at most
    # the 15 still alive after the death (fewer in the first rounds after
    # the promotion, while the survivors' snapshots arrive)
    shape = (max_tasks * (nservers - 1), max_requesters * (nservers - 1))
    dep_shapes = [tuple(s) for s in planners[deputy]["device_shapes"]]
    for rank, c in planners.items():
        if c["host_solves"] or c["solves_kept"] < -(-c["device_solves"]
                                                     // CHECK_EVERY) \
                or c["greedy_sweep_launches"] != \
                (device == "cuda") * c["device_solves"]:
            raise AssertionError(f"master failover: rank {rank}'s planner "
                                 f"counts {c}")
    if planners[deputy]["device_solves"] == 0 or not dep_shapes \
            or max(dep_shapes) != shape:
        raise AssertionError(
            f"master failover: the deputy's device solves "
            f"{planners[deputy]['device_solves']} at shapes {dep_shapes}, "
            f"want up to {shape}")
    if counts["solves_wrong"] or counts["solves_checked"] != sum(
            c["solves_kept"] for c in planners.values()):
        raise AssertionError(f"master failover: checks {counts}")
    to_first = probe.first_solve[id(dep_solver)] - probe.promoted[0]
    n, at_solves, at_consumed, at_backlog = probe.death
    report(f"phase 10: world {napps} apps x {nservers} servers, master "
           f"(rank {master}) disconnected at its outbound frame N={n}, "
           f"after {at_solves} of its device solves and {at_consumed} of "
           f"{nunits} units consumed, holding {at_backlog} untargeted "
           f"units; the world ended in {wall:.3f} s "
           f"({nunits / wall:.1f} units/s): {acct['consumed']} consumed "
           f"({acct['distinct']} distinct, {acct['re_executed']} "
           f"re-executed), {acct['lost']} counted lost, "
           f"{acct['failovers']} failover(s), {acct['answered']} answers")
    report(f"phase 10: master_failover_mttr_ms {probe.promoted[2]:.3f}; "
           f"promotion to the deputy's first device solve (its PlanEngine "
           f"built on the card) {1e3 * to_first:.3f} ms; device solves by "
           f"planning rank " + ", ".join(
               f"{r}: {c['device_solves']} ({c['greedy_sweep_launches']} "
               f"kernel launches, {c['solves_kept']} kept)"
               for r, c in sorted(planners.items()))
           + f"; the deputy's solves at "
           + ", ".join(f"{a}x{b}" for a, b in dep_shapes) + "; "
           f"{counts['solves_checked']} kept solves == _host_greedy")
    return wall, planners, {"death_frame": n, "master_solves_at_death":
                            at_solves, "consumed_at_death": at_consumed,
                            "backlog_at_death": at_backlog,
                            "mttr_ms": probe.promoted[2],
                            "promotion_to_first_solve_ms": 1e3 * to_first,
                            **acct}


def checkpoint_app(ctx, nunits: int, prefix: str, pad: int, hold_s: float):
    """Phase 11's first world: rank 0 puts ``nunits`` padded units, lets
    the planner match and migrate them for ``hold_s`` seconds, checkpoints
    the pool (``ctx.checkpoint``) and ends the world; every other rank
    consumes until the end. Returns ("ckpt", units captured, timings) at
    rank 0, where timings holds the host-clock seconds of its ``iput``
    loop (``put_s``) and of the ``flush_puts`` that waits for the last
    acks (``flush_s``), and the process's device solves when it
    checkpoints (``solves_at_ckpt``); the consumed units elsewhere. The
    puts are pipelined (``iput``): a write-ahead log holds each put's ack
    until the group commit that covers it, so synchronous puts would pay
    one commit window each."""
    from adlb_tpu_torch import ADLB_SUCCESS
    from adlb_tpu_torch.balancer import solve

    if ctx.rank == 0:
        t0 = time.perf_counter()
        for i in range(nunits):
            ctx.iput(i.to_bytes(4, "little") + bytes(pad), MAIN_TYPES[i % 4],
                     work_prio=(i * 31) % 97)
        t1 = time.perf_counter()
        if ctx.flush_puts() != ADLB_SUCCESS:
            raise RuntimeError("a put was not accepted")
        t2 = time.perf_counter()
        time.sleep(hold_s)
        timings = {"put_s": t1 - t0, "flush_s": t2 - t1,
                   "solves_at_ckpt": solve.solve_counts["device"]}
        rc, n = ctx.checkpoint(prefix)
        if rc != ADLB_SUCCESS:
            raise RuntimeError(f"checkpoint failed: rc={rc}")
        ctx.set_problem_done()
        return ("ckpt", n, timings)
    return drain_app(ctx)


def durable_config(device, tmp: str, nunits: int, max_tasks=4096,
                   max_requesters=512, pad=60, wal_fsync_ms=20.0):
    """Phase 11's first world's Config: phase 3's, with a 64 MiB memory
    cap per server, a write-ahead log under ``tmp`` whose group commit is
    ``wal_fsync_ms`` wide, and a spill tier under ``tmp`` whose watermark
    is 80% of the pool's payload bytes (``nunits`` units of 4 + ``pad``
    bytes)."""
    import dataclasses

    cap = 64 << 20
    return dataclasses.replace(
        main_path_config(device, max_tasks, max_requesters),
        max_malloc_per_server=cap, wal_dir=os.path.join(tmp, "wal"),
        wal_fsync_ms=wal_fsync_ms, spill_dir=os.path.join(tmp, "spill"),
        spill_watermark_frac=0.8 * nunits * (4 + pad) / cap)


def drain_app(ctx):
    """Consume until the world ends; the consumed unit ids."""
    from adlb_tpu_torch import ADLB_SUCCESS

    seen = []
    while True:
        rc, w = ctx.get_work(list(MAIN_TYPES))
        if rc != ADLB_SUCCESS:
            return seen
        seen.append(int.from_bytes(w.payload[:4], "little"))


def run_durable_world(gs, report, device="cuda", nunits=10_000, napps=64,
                      nservers=16, max_tasks=4096, max_requesters=512,
                      pad=60, hold_s=2.0, wal_fsync_ms=20.0):
    """Phase 11: phase 3's world with a write-ahead log (``wal_dir``) and
    a spill tier (``spill_dir``) (:func:`durable_config`), checkpointed
    mid-run by rank 0 while the planner migrates; then a second planned
    world restores the checkpoint (``restore_path``) and drains it. The
    WAL's group commit is ``wal_fsync_ms`` wide: a put handler commits
    once the window is due, so where an fsync takes longer than the 5 ms
    default window, every put would sync. About a fifth of the payloads
    spill (each put over the watermark pops its victims from the queue's
    resident index). The planner must have made device solves before the
    checkpoint (how many follows the world's wall, about one a second:
    the engine's migrations feed most consumers without a solve); consumed
    and drained must cover every unit; both worlds' K1 launches equal
    their device solves, and their kept solves equal ``_host_greedy``. Returns the two walls, the spilled
    share and both worlds' planner counts."""
    import dataclasses

    from adlb_tpu_torch import run_world
    from adlb_tpu_torch.balancer import solve
    from adlb_tpu_torch.runtime import spill, wal

    spilled, syncs = [], []
    put, sync = spill.SpillStore.put, wal.WriteAheadLog._sync

    def counted_put(store, seqno, blob):
        spilled.append(seqno)
        return put(store, seqno, blob)

    def timed_sync(log):
        t = time.perf_counter()
        out = sync(log)
        syncs.append(time.perf_counter() - t)
        return out

    walls, counts = [], []
    threads_at_start = threading.active_count()
    keep_solves()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "pool")
        cfg1 = durable_config(device, tmp, nunits, max_tasks, max_requesters,
                              pad, wal_fsync_ms)
        spill.SpillStore.put = counted_put
        wal.WriteAheadLog._sync = timed_sync
        try:
            for cfg, app in (
                    (cfg1, functools.partial(checkpoint_app, nunits=nunits,
                                             prefix=prefix, pad=pad,
                                             hold_s=hold_s)),
                    (dataclasses.replace(cfg1, wal_dir=None,
                                         restore_path=prefix,
                                         spill_dir=os.path.join(tmp, "s2")),
                     drain_app)):
                gs.reset_counts()
                solve.reset_counts()
                t0 = time.perf_counter()
                res = stacks_on_timeout(lambda: run_world(
                    num_app_ranks=napps, nservers=nservers,
                    types=MAIN_TYPES + (MAIN_ANSWER,), app_fn=app, cfg=cfg,
                    timeout=600))
                walls.append(time.perf_counter() - t0)
                if res.aborted:
                    raise AssertionError("durable world aborted")
                counts.append(solve.planner_counts())
                check_planned(f"durable world {len(walls)}", counts[-1],
                              device)
                if len(walls) == 1:
                    _, ckpt, timings = res.app_results[0]
                    consumed = {i for r, v in res.app_results.items()
                                if r != 0 for i in v}
                    nspilled = len(spilled)
                    wal_bytes = sum(
                        os.path.getsize(wal.log_path(cfg.wal_dir, r))
                        for r in range(napps, napps + nservers)
                        if os.path.exists(wal.log_path(cfg.wal_dir, r)))
                else:
                    drained = [i for v in res.app_results.values()
                               for i in v]
        finally:
            spill.SpillStore.put = put
            wal.WriteAheadLog._sync = sync
    if consumed | set(drained) != set(range(nunits)) \
            or len(drained) != ckpt:
        raise AssertionError(
            f"durable world: {len(consumed)} consumed before the checkpoint "
            f"and {len(drained)} drained after ({ckpt} captured) miss "
            f"{len(set(range(nunits)) - consumed - set(drained))} units")
    if timings["solves_at_ckpt"] < 1:
        raise AssertionError("durable world: the planner made no device "
                             "solve before rank 0's checkpoint")
    share = nspilled / nunits
    if share < 0.1:
        raise AssertionError(f"durable world: only {share:.1%} of the "
                             f"payloads spilled")
    report(f"phase 11: durable world {napps} apps x {nservers} servers, "
           f"{nunits} units of {4 + pad} bytes, {threads_at_start} threads "
           f"alive before it: rank 0's iput loop {timings['put_s']:.3f} s "
           f"({nunits / timings['put_s']:.1f} puts/s), its flush_puts "
           f"{timings['flush_s']:.3f} s; {len(consumed)} consumed "
           f"in {walls[0]:.3f} s before the world ended at rank 0's "
           f"checkpoint ({ckpt} units captured, "
           f"{timings['solves_at_ckpt']} device solves before it); "
           f"{nspilled} payloads "
           f"spilled ({100 * share:.1f}%), {wal_bytes} WAL bytes in "
           f"{len(syncs)} group commits ({wal_fsync_ms} ms window; fsync "
           f"median {1e3 * statistics.median(syncs or [0]):.3f} ms, max "
           f"{1e3 * max(syncs or [0]):.3f} ms, {sum(syncs):.3f} s in all); "
           f"the "
           f"restoring world drained {len(drained)} in {walls[1]:.3f} s; "
           f"consumed + drained == all {nunits}; device solves "
           f"{counts[0]['device_solves']} + {counts[1]['device_solves']} "
           f"= kernel launches {counts[0]['greedy_sweep_launches']} + "
           f"{counts[1]['greedy_sweep_launches']}; "
           f"{counts[0]['solves_checked'] + counts[1]['solves_checked']} "
           f"kept solves == _host_greedy")
    return walls, share, counts


def jobs_app(ctx, nunits: int, announce: str, weight: float, answers: dict,
             ready: threading.Event):
    """Phase 12: rank 0 submits two jobs, puts half of job 1's units (the
    even unit ids), POSTs job 1's new weight to the ops endpoint (found in
    the ``announce`` directory), reads /metrics, /alerts and /control,
    puts the rest of job 1's units and job 2's (the odd ids), and drains
    both jobs; the other ranks attach to one job each (odd ranks job 1,
    once rank 0 has submitted both) and consume until their job is done.
    Rank 0's home server holds no job-1 worker, so every job-1 unit
    reaches its worker through the planner, also after the POST."""
    import urllib.request

    from adlb_tpu_torch import ADLB_SUCCESS

    if ctx.rank == 0:
        jobs = [ctx.submit_job(name)[1] for name in ("a", "b")]
        if jobs != [1, 2]:
            raise RuntimeError(f"job ids {jobs}")
        ready.set()

        def put(units):
            for i in units:
                ctx.put(i.to_bytes(4, "little"), MAIN_TYPES[i % 4],
                        work_prio=(i * 31) % 97)

        ctx.attach(1)
        put(range(0, nunits // 2, 2))
        path = os.path.join(announce, "ops_endpoint.json")
        deadline = time.monotonic() + 30
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.01)
        with open(path) as f:
            base = f"http://127.0.0.1:{json.load(f)['port']}"
        req = urllib.request.Request(
            f"{base}/jobs/1", data=json.dumps({"weight": weight}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            answers["post"] = json.load(r)
        answers["posted_at"] = time.perf_counter()
        for route in ("metrics", "alerts", "control"):
            with urllib.request.urlopen(f"{base}/{route}", timeout=30) as r:
                answers[route] = (r.status, r.read().decode())
        put(range(nunits // 2, nunits, 2))
        ctx.attach(2)
        put(range(1, nunits, 2))
        for jid in jobs:
            ctx.drain_job(jid)
        return None
    if not ready.wait(60):
        raise RuntimeError("the jobs were not submitted")
    jid = 2 - ctx.rank % 2
    ctx.attach(jid)
    seen = []
    while True:
        rc, w = ctx.get_work(list(MAIN_TYPES))
        if rc != ADLB_SUCCESS:
            return (jid, seen)
        seen.append(int.from_bytes(w.payload, "little"))


def run_fleet_control(gs, report, device="cuda", nunits=10_000, napps=64,
                      nservers=16, max_tasks=4096, max_requesters=512):
    """Phase 12: phase 3's world with two weighted jobs (jobs 1 and 2;
    ``balancer_max_jobs=3``, since the planner plans job ids below it and
    leaves the others to the servers' pull), the ops endpoint,
    one SLO objective, the controller (dry run), tail hedging and periodic
    statistics. Mid-run a POST changes job 1's weight; it must reach
    ``PlanEngine.set_job_weights`` and the solver's ``set_job_bias``, and
    the solves after it are held against ``_host_greedy`` on the biased
    inputs. Returns (wall, planner counts, solves after the change)."""
    import dataclasses

    from adlb_tpu_torch import run_world
    from adlb_tpu_torch.balancer import engine, solve
    from adlb_tpu_torch.runtime import stats

    changes = []
    set_weights = engine.PlanEngine.set_job_weights

    def traced_set_weights(eng, weights):
        before = list(eng.solver.job_bias)
        changed = set_weights(eng, weights)
        changes.append((dict(weights or {}), changed, before,
                        list(eng.solver.job_bias),
                        eng.solver.device_solve_count,
                        eng.solver.solves_kept, eng.solver))
        return changed

    lines, answers = [], {}
    keep_solves()
    gs.reset_counts()
    solve.reset_counts()
    with tempfile.TemporaryDirectory() as announce:
        cfg = dataclasses.replace(
            main_path_config(device, max_tasks, max_requesters),
            balancer_max_jobs=3, job_weights={2: 2.0}, ops_port=0,
            ops_announce_dir=announce, obs_sync_interval=0.25,
            slo=[{"name": "unit-p99", "p99_ms": 60_000.0, "window_s": 60}],
            control=True, control_dry_run=True, hedge_budget_frac=0.05,
            lease_timeout_s=60.0, periodic_log_interval=1.0)
        engine.PlanEngine.set_job_weights = traced_set_weights
        stats.set_sink(lines.append)
        try:
            t0 = time.perf_counter()
            res = stacks_on_timeout(lambda: run_world(
                num_app_ranks=napps, nservers=nservers,
                types=MAIN_TYPES + (MAIN_ANSWER,),
                app_fn=functools.partial(
                    jobs_app, nunits=nunits, announce=announce, weight=4.0,
                    answers=answers, ready=threading.Event()),
                cfg=cfg, timeout=240))
            wall = time.perf_counter() - t0
        finally:
            engine.PlanEngine.set_job_weights = set_weights
            stats.set_sink(None)
    counts = solve.planner_counts()
    check_planned("fleet control", counts, device)
    got = {j: sorted(i for r, v in res.app_results.items()
                     if r != 0 and v[0] == j for i in v[1]) for j in (1, 2)}
    if res.aborted or got != {j: list(range(j - 1, nunits, 2))
                              for j in (1, 2)}:
        raise AssertionError("fleet control: units not consumed exactly "
                             "once per job")
    applied = [c for c in changes if c[0] == {1: 4.0, 2: 2.0} and c[1]]
    if not applied or answers["post"].get("weight") != 4.0:
        raise AssertionError(f"fleet control: the POSTed weight never "
                             f"reached the engine: {changes[:3]}, "
                             f"{answers.get('post')}")
    _, _, bias_before, bias, solves_then, kept_then, solver = applied[0]
    after = solver.device_solve_count - solves_then
    kept_after = solver.solves_kept - kept_then
    if after == 0 or kept_after == 0 or bias == bias_before:
        raise AssertionError(f"fleet control: {after} device solves and "
                             f"{kept_after} kept after the change, bias "
                             f"{bias}")
    for route in ("metrics", "alerts", "control"):
        if answers[route][0] != 200:
            raise AssertionError(f"fleet control: GET /{route} answered "
                                 f"{answers[route][0]}")
    alerts = json.loads(answers["alerts"][1])
    if [o["name"] for o in alerts["objectives"]] != ["unit-p99"] \
            or not json.loads(answers["control"][1])["enabled"] \
            or "adlb_" not in answers["metrics"][1]:
        raise AssertionError("fleet control: /alerts, /control or /metrics "
                             "answered something else")
    records = stats.parse_stat_lines(lines)
    if not records or records[-1]["nservers"] != nservers:
        raise AssertionError("fleet control: no periodic statistics record "
                             "of every server")
    report(f"phase 12: world {napps} apps x {nservers} servers, two jobs "
           f"(weights {{2: 2.0}}, then POST /jobs/1 weight 4.0), ops "
           f"endpoint, one SLO objective, controller (dry run), hedging "
           f"(budget 0.05), periodic statistics every 1 s: {nunits} units "
           f"consumed once per job in {wall:.3f} s ({nunits / wall:.1f} "
           f"units/s); the weight reached set_job_weights and the solver's "
           f"job bias {bias_before} -> {bias}; device solves "
           f"{counts['device_solves']} ({after} after the change, "
           f"{kept_after} of them kept) = kernel launches "
           f"{counts['greedy_sweep_launches']}; {counts['solves_checked']} "
           f"kept solves == _host_greedy on the biased inputs; /metrics "
           f"{len(answers['metrics'][1])} bytes, /alerts and /control "
           f"answered; {len(records)} STAT_APS records of {nservers} "
           f"servers")
    return wall, counts, after


def run_process_failover(report, device="cuda", nunits=5_000, napps=32,
                         nservers=8, max_tasks=4096, max_requesters=512,
                         work_s=0.01):
    """Phase 13: phase 8's process world whose master is SIGKILLed at its
    60th outbound frame (``kill_server_at_frame``). The deputy is a child
    that has not used CUDA; it loads the kernel the parent built at
    promotion, plans on the card and sends its counts back in
    ``WorldResult.planner``. Returns (wall, the deputy's counts)."""
    import dataclasses

    from adlb_tpu_torch.runtime.transport_tcp import (
        resolve_start_method,
        spawn_world,
    )

    master, deputy = napps, napps + 1
    cfg = dataclasses.replace(
        main_path_config(device, max_tasks, max_requesters),
        on_server_failure="failover", failover_client_wait=60.0,
        fault_spec={"seed": 13, "kill_server_at_frame": {0: 60}})
    keep_solves()
    t0 = time.perf_counter()
    res = spawn_world(napps, nservers, MAIN_TYPES + (MAIN_ANSWER,),
                      functools.partial(failover_app, nunits=nunits,
                                        work_s=work_s),
                      cfg=cfg, timeout=240)
    wall = time.perf_counter() - t0
    acct = check_failover("process-world failover", res, nunits, master)
    if list(res.planner) != [deputy]:  # a SIGKILLed master never reports
        raise AssertionError(f"process-world failover: planners "
                             f"{res.planner}")
    counts = res.planner[deputy]
    check_planned("process world's promoted deputy", counts, device)
    # the deputy packs the servers whose snapshots it holds: at most the 7
    # still alive (fewer in its first rounds)
    shape = [max_tasks * (nservers - 1), max_requesters * (nservers - 1)]
    shapes = counts["device_shapes"]
    if not shapes or max(shapes) != shape:
        raise AssertionError(f"process-world failover: the deputy solved "
                             f"at {shapes}, want up to {shape}")
    report(f"phase 13: spawn_world {napps} apps x {nservers} Python servers "
           f"(ranks started with {resolve_start_method(cfg, None)!r}), "
           f"master SIGKILLed at its 60th outbound frame, {nunits} units: "
           f"the world ended in {wall:.3f} s ({nunits / wall:.1f} units/s),"
           f" {acct['consumed']} consumed ({acct['re_executed']} "
           f"re-executed), {acct['lost']} counted lost; the deputy (rank "
           f"{deputy}) reported device solves {counts['device_solves']} "
           f"at " + ", ".join(f"{a}x{b}" for a, b in shapes) + ", "
           f"host solves {counts['host_solves']}, kernel launches "
           f"{counts['greedy_sweep_launches']}, {counts['rounds']} rounds; "
           f"{counts['solves_checked']} == _host_greedy")
    return wall, counts


#: phase 14's seeds of the port's chaos soak, and what each draws
SOAK_SEEDS = {
    1422: "master killed mid_plan (4 apps x 3 servers, reclaim)",
    1652: "master killed mid_plan (5 apps x 4 servers, abort)",
    1309: "server killed under failover (6 apps x 3 servers)",
    1383: "worker killed under reclaim (3 apps x 3 servers)",
    1327: "worker killed under reclaim (4 apps x 4 servers)",
}


def run_chaos_soak(report, device="cuda", seeds=None) -> dict:
    """Phase 14: ``one_iter`` of the port's chaos soak for each of
    ``seeds`` (``SOAK_SEEDS``) on ``device``. Every world plans
    (``balancer="tpu"``) with the soak's host threshold 0; its ranks are
    spawned, so each planner reports its counts in ``WorldResult.planner``
    (``chaos_soak_torch.PLANNERS``), a SIGKILLed master excepted. Each
    iteration's planners must make device solves, none on the host, one
    kernel launch each on the card. A failed iteration is the soak's
    ``CHAOS FAIL`` and fails the phase. Returns the totals."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "scripts"))
    import chaos_soak_torch as soak

    os.environ.setdefault("ADLB_FLIGHT_DIR",
                          tempfile.mkdtemp(prefix="chaos-flight-"))
    keep_solves()
    totals = {"device_solves": 0, "greedy_sweep_launches": 0,
              "solves_checked": 0, "worlds": 0}
    for seed, what in (seeds or SOAK_SEEDS).items():
        soak.PLANNERS.clear()
        t0 = time.perf_counter()
        try:
            desc = soak.one_iter(seed, device=device)
        except BaseException as e:
            report(f"phase 14: CHAOS FAIL seed={seed} device={device}: "
                   f"{e!r} (flight records in {os.environ['ADLB_FLIGHT_DIR']}"
                   f", python scripts/obs_report_torch.py DIR)")
            raise
        wall = time.perf_counter() - t0
        planners = {r: c for p in soak.PLANNERS for r, c in p.items()}
        for r, c in planners.items():
            check_planned(f"soak seed {seed} planner rank {r}", c, device,
                          need_solves=False)
        solves = sum(c["device_solves"] for c in planners.values())
        launches = sum(c["greedy_sweep_launches"]
                       for c in planners.values())
        if desc.get("mode") != "tpu" or solves == 0:
            raise AssertionError(f"soak seed {seed}: {desc}: planners "
                                 f"{planners}, want device solves > 0")
        totals["device_solves"] += solves
        totals["greedy_sweep_launches"] += launches
        totals["solves_checked"] += sum(c["solves_checked"]
                                        for c in planners.values())
        totals["worlds"] += len(soak.PLANNERS)
        report(f"phase 14: seed {seed}, {what}: {desc} in {wall:.3f} s; "
               f"planners by rank: " + ", ".join(
                   f"{r}: {c['device_solves']} device solves, "
                   f"{c['greedy_sweep_launches']} kernel launches, "
                   f"{c['solves_checked']} checked"
                   for r, c in sorted(planners.items())))
    report(f"phase 14: {len(seeds or SOAK_SEEDS)} soak iterations on "
           f"{device}, no failure; {totals['device_solves']} device solves, "
           f"{totals['greedy_sweep_launches']} kernel launches, "
           f"{totals['solves_checked']} kept solves == _host_greedy")
    return totals


def run_reference_suites(report, device="cuda", parallel=3) -> dict:
    """Phase 15: the runner's card mode. Each of ``CARD_FILES`` runs
    unchanged against the port on ``device`` with the host threshold 0, in
    its own pytest process, ``parallel`` files at a time; every test must
    pass (a failed test passes when run once more alone, or the phase
    fails), and on the card each file's pytest process launches the
    kernel once per device solve, none on the host, and every
    CHECK_EVERY-th device solve of each solver equals ``_host_greedy``
    (``check_planned``). Returns the totals."""
    from concurrent.futures import ThreadPoolExecutor

    # the runner by its path: a ``tests`` package installed on the host
    # would shadow this checkout's ``tests`` directory
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_reference import CARD_FILES, run_reference_file

    tmp = tempfile.mkdtemp(prefix="reference-suites-")

    def one(name):
        return name, run_reference_file(
            name, device, os.path.join(tmp, name),
            lambda line: report(f"phase 15: {line}"), host_threshold=0)

    keep_solves()  # the pytest processes inherit ADLB_CHECK_SOLVES
    totals = {"passed": 0, "reruns": 0, "device_solves": 0,
              "greedy_sweep_launches": 0, "solves_checked": 0}
    with ThreadPoolExecutor(parallel) as ex:
        for name, c in ex.map(one, CARD_FILES):
            k = c["kernels"]
            check_planned(f"phase 15: {name}", k, device, need_solves=False)
            totals["passed"] += c["passed"]
            totals["reruns"] += len(c["reruns"])
            for key in ("device_solves", "greedy_sweep_launches",
                        "solves_checked"):
                totals[key] += k[key]
    if totals["device_solves"] == 0:
        raise AssertionError("phase 15: no device solve in any file")
    report(f"phase 15: {len(CARD_FILES)} reference files on {device}: "
           f"{totals['passed']} tests passed, {totals['reruns']} rerun; "
           f"{totals['device_solves']} device solves and "
           f"{totals['greedy_sweep_launches']} kernel launches in the "
           f"pytest processes, {totals['solves_checked']} kept solves == "
           f"_host_greedy")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from adlb_tpu_torch.balancer import greedy_sweep as gs
    from adlb_tpu_torch.balancer import solve

    label = card_label()
    print(f"card: {label}")

    def report(line: str) -> None:
        print(f"[{label}] {line}", flush=True)

    laps = [time.perf_counter()]
    phase_walls = {}

    def lap(phase: str) -> None:
        """Print the wall time of the phase that just ended."""
        laps.append(time.perf_counter())
        phase_walls[phase] = laps[-1] - laps[-2]
        report(f"phase {phase}: wall {phase_walls[phase]:.1f} s")

    from adlb_tpu_torch.balancer import auction, candidates, cuda_build

    # the native plane (g++ / gcc) builds beside the kernels (nvcc)
    t0 = time.perf_counter()
    native = {}
    native_thread = threading.Thread(
        target=lambda: native.update(paths=build_native()), daemon=True)
    native_thread.start()
    # one nvcc each, all together (and the barrier probe that times the
    # auction's chain bound)
    cuda_build.build_all([gs.SOURCE, candidates.SOURCE, auction.SOURCE,
                          timing_script().PROBE_SOURCE])
    built = [gs.build(), candidates.build(), auction.build()]
    report(f"phase 1: built {', '.join(so.name for so in built)} in "
           f"{time.perf_counter() - t0:.2f} s")
    native_thread.join()
    if "paths" not in native:
        raise AssertionError("the native plane did not build")
    report(f"phase 1: built the native plane "
           f"({', '.join(os.path.basename(p) for p in native['paths'])}) in "
           f"{time.perf_counter() - t0:.2f} s")
    for log in (gs.build_log, candidates.build_log, auction.build_log):
        for ln in log.splitlines():
            if "ptxas" in ln:
                report(f"phase 1: {ln.strip()}")
    lap("1")

    by_case, max_err = check_kernel(gs, solve._host_greedy, report)
    lap("2")

    keep_solves()
    gs.reset_counts()
    auction.launches = candidates.launches = 0
    solve.reset_counts()
    nunits = 10_000
    with PlannerTimer() as main_timer:
        wall = run_main_path(nunits=nunits)
    route_launches = gs.route_launches()
    counts = solve.planner_counts()
    launches = counts["greedy_sweep_launches"]
    report(f"phase 3: world 64 apps x 16 servers, {nunits} units consumed "
           f"once in {wall:.3f} s ({nunits / wall:.1f} units/s); device "
           f"solves {counts['device_solves']}, host solves "
           f"{counts['host_solves']}, kernel launches {launches}, by route "
           f"{route_launches}")
    report(f"phase 3: {main_timer.text(wall)}")
    report(f"phase 3: {counts['solves_checked']} of the world's device "
           f"solves held against _host_greedy: {counts['solves_wrong']} "
           f"differ")
    check_planned("main path", counts)
    if sum(route_launches.values()) != launches:
        raise AssertionError(f"main path: launches by route {route_launches}"
                             f" for {launches} launches")
    # the same solve (numpy in, numpy out) with no world running: the
    # yardstick for what the world's solves spend waiting on the host
    alone = solve.AssignmentSolver(types=(1, 2, 3, 4), max_tasks=4096,
                                   max_requesters=512, host_threshold_reqs=0)
    arrs = bench_instance(np.random.default_rng(1), 65536, 8192)
    want = solve._host_greedy(*arrs)
    alone_s, alone_splits = [], []
    for _ in range(21):
        t = time.perf_counter()
        got = alone._device_solve(*arrs)
        alone_s.append(time.perf_counter() - t)
        alone_splits.append(alone.handoff.split)
        if not np.array_equal(got, want):
            raise AssertionError("a device solve with no world running "
                                 "differs from _host_greedy")
    report(f"phase 3: the same 65536x8192 device solve with no world "
           f"running: median {1e3 * statistics.median(alone_s[1:]):.3f} ms "
           f"on the host clock; median split: {split_text(alone_splits[1:])}")
    lap("3")

    cand_err = check_candidates(candidates, report)
    auction_err = check_auction(auction, report)
    lap("4")
    t0 = time.perf_counter()
    planner_launches, device_plans, solver10k, _ = run_sharded_planner(
        auction, report)
    report(f"phase 5: plan_bench rows and the dryrun in "
           f"{time.perf_counter() - t0:.1f} s, "
           f"{planner_launches['shard_candidates']} candidates launches and "
           f"{planner_launches['auction']} auction launches for "
           f"{device_plans} plan_bench device plans")
    timed10k = time_device_plan(solver10k, auction, candidates, report)
    del solver10k
    lap("5")
    work_launches, work_solves = run_workloads(gs, report)
    report(f"phase 6: {work_solves} device solves, {work_launches} "
           f"greedy-sweep launches over the sixteen workloads")
    lap("6")

    res7, wall7, timer7, counts7 = run_native_plane(gs, report)
    report(f"phase 7 beside phase 3 (same run): units/s on the wall clock "
           f"{20_000 / wall7:.1f} (native plane, sidecar) against "
           f"{nunits / wall:.1f} (in-process world); planning rounds "
           f"{len(timer7.round_s)} against {len(main_timer.round_s)}, median "
           f"{1e3 * statistics.median(timer7.round_s):.3f} against "
           f"{1e3 * statistics.median(main_timer.round_s):.3f} ms; median "
           f"device solve {1e3 * statistics.median(timer7.solve_s):.3f} "
           f"against {1e3 * statistics.median(main_timer.solve_s):.3f} ms "
           f"(sidecar: {split_text(timer7.splits)}; in-process: "
           f"{split_text(main_timer.splits)})")
    native_launches, native_solves = run_native_workloads(gs, report)
    lap("7")
    _, counts8 = run_process_world(report)
    lap("8")
    counts9 = run_launchers(report)
    lap("9")
    wall10, planners10, info10 = run_master_failover(gs, report)
    report(f"phase 10 beside phase 3 (same run): {nunits / wall10:.1f} "
           f"against {nunits / wall:.1f} units/s")
    lap("10")
    _, _, counts11 = run_durable_world(gs, report)
    lap("11")
    _, counts12, _ = run_fleet_control(gs, report)
    lap("12")
    _, counts13 = run_process_failover(report)
    lap("13")
    counts14 = run_chaos_soak(report)
    lap("14")
    counts15 = run_reference_suites(report)
    lap("15")
    report(f"all phases: {laps[-1] - laps[0]:.1f} s")

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "adlb_tpu" or m.startswith("adlb_tpu.")]
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")

    # the main path's route (the world's masks partition the types) at the
    # main path's shape; every case's numbers ride along. "ms" is the median
    # of per-call CUDA-event windows, as in the port's first chip_smoke.py
    main = by_case["partition"]
    print(json.dumps({"kernels": [{
        "name": "greedy_sweep",
        "route": "cuda",
        "source": "adlb_tpu_torch/csrc/greedy_sweep.cu",
        "replaces": "adlb_tpu/balancer/pallas_solve.py:63",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "ms_back_to_back": main["ms_back_to_back"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launches_by_route": route_launches,
        "launches_by_phase": {
            "3_in_process_world": launches,
            "6_workloads": work_launches,
            "7_native_plane_sidecar": counts7["greedy_sweep_launches"],
            "7_native_workloads": native_launches,
            "8_spawned_master": counts8["greedy_sweep_launches"],
            "9_launcher_sidecar": counts9["greedy_sweep_launches"],
            "10_failover_planners": {
                str(r): c["greedy_sweep_launches"]
                for r, c in sorted(planners10.items())},
            "11_durable_worlds": [c["greedy_sweep_launches"]
                                  for c in counts11],
            "12_fleet_control": counts12["greedy_sweep_launches"],
            "13_spawned_deputy": counts13["greedy_sweep_launches"],
            "14_chaos_soak": counts14["greedy_sweep_launches"],
            "15_reference_suites": counts15["greedy_sweep_launches"]},
        "solves_checked_by_phase": {
            "3_in_process_world": counts["solves_checked"],
            "7_native_plane_sidecar": counts7["solves_checked"],
            "8_spawned_master": counts8["solves_checked"],
            "9_launcher_sidecar": counts9["solves_checked"],
            "10_failover_planners": sum(c["solves_kept"]
                                        for c in planners10.values()),
            "11_durable_worlds": [c["solves_checked"] for c in counts11],
            "12_fleet_control": counts12["solves_checked"],
            "13_spawned_deputy": counts13["solves_checked"],
            "14_chaos_soak": counts14["solves_checked"],
            "15_reference_suites": counts15["solves_checked"]},
        "device_solves_by_phase": {
            "14_chaos_soak": counts14["device_solves"],
            "15_reference_suites": counts15["device_solves"]},
        "failover_10": info10,
        "phase_walls_s": phase_walls,
        "by_case_65536x8192": by_case,
    }, {
        "name": "shard_candidates",
        "route": "cuda",
        "source": "adlb_tpu_torch/csrc/candidates.cu",
        "replaces": "adlb_tpu/balancer/distributed.py:88",
        "launches": planner_launches["shard_candidates"],
        "max_abs_err": cand_err,
        "ms": timed10k["candidates_ms"],
        "ms_back_to_back": timed10k["candidates_ms_back_to_back"],
        "ms_graph": timed10k["candidates_graph_ms"],
        "plain_ms": timed10k["candidates_plain_ms"],
        "bound_ms": timed10k["candidates_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "also_replaces": ["adlb_tpu/balancer/distributed.py:170",
                          "adlb_tpu/balancer/solve.py:53"],
    }, {
        "name": "auction",
        "route": "cuda",
        "source": "adlb_tpu_torch/csrc/auction.cu",
        "replaces": "adlb_tpu/balancer/distributed.py:136",
        "launches": planner_launches["auction"],
        "max_abs_err": auction_err,
        "ms": timed10k["auction_ms"],
        "ms_back_to_back": timed10k["ms_back_to_back"],
        "ms_graph": timed10k["auction_graph_ms"],
        "plain_ms": timed10k["plain_ms"],
        "bound_ms": timed10k["bound_ms"],
        "bound_by": "bytes",
        "chain_bound_ms": timed10k["chain_bound_ms"],
        "library_ms": None,
        "device_plan_ms": timed10k["device_plan_ms"],
        "at_10k_row": timed10k,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
