"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc`` (it exits non-zero without them, printing
no result). Phases:

1. build the greedy-sweep kernel (``adlb_tpu_torch/csrc/greedy_sweep.cu``)
   from the sources in this checkout;
2. hold the kernel against its plain PyTorch versions and against the numpy
   twin ``_host_greedy`` on edge cases (among them requester counts whose
   working set overflows shared memory into the kernel's scratch buffer) and
   at the main path's shapes, with one instance per kernel route at each
   shape plus the ``classes`` instance widened to T=11, which the ``sweep``
   route takes (exact equality: the outputs are integer assignments; the
   route the kernel reports must be the one ``requester_classes`` names),
   and time it: the wrapper, the sort alone, the kernel alone, the plain
   version;
3. drive the port's main path: a ``run_world`` with the planned balancer on
   the card, 16 servers x (4096 tasks, 512 requesters), so every device
   solve is a 65536 x 8192 instance; every unit must be consumed exactly
   once, every device solve must be exactly one kernel launch, and every
   eighth solve is held against ``_host_greedy``. Prints the launches per
   route and the median in-world solve split on the host clock into
   hand-off, sort + launch enqueue and wait for the result.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NEG = -(2**31) + 1


def card_label() -> str:
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


def back_to_back_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time per call with CUDA events around ``reps`` calls in a
    row, after warm-up: the host enqueues the next call while the card runs
    this one, so it reads lower than :func:`time_ms` by the launch gaps."""
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
    return by_case, err


def run_main_path(device="cuda", nunits=10_000, napps=64, nservers=16,
                  max_tasks=4096, max_requesters=512):
    """Phase 3: a planned-balancer world on the card (the arguments only
    shrink it for a rehearsal on the CPU). Returns its wall time."""
    from adlb_tpu_torch import ADLB_SUCCESS, run_world
    from adlb_tpu_torch.runtime.world import Config

    types = (1, 2, 3, 4)
    answer = 9

    def value(i: int) -> int:
        return (i * 7919) % 1000003

    def app(ctx):
        if ctx.rank == 0:
            for i in range(nunits):
                ctx.put(i.to_bytes(4, "little"), types[i % 4],
                        work_prio=(i * 31) % 97)
            total = 0
            for _ in range(nunits):
                rc, r = ctx.reserve([answer])
                if rc != ADLB_SUCCESS:
                    raise RuntimeError(f"answer reserve failed: rc={rc}")
                rc, buf = ctx.get_reserved(r.handle)
                total += int.from_bytes(buf, "little")
            ctx.set_problem_done()
            return total
        seen = []
        while True:
            rc, r = ctx.reserve(list(types))
            if rc != ADLB_SUCCESS:
                return seen
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                return seen
            i = int.from_bytes(buf, "little")
            seen.append(i)
            ctx.put(value(i).to_bytes(8, "little"), answer, target_rank=0)

    # puts stay at rank 0's home server, so the other servers' workers
    # are fed by the planner's matches and migrations
    cfg = Config(balancer="tpu", device=device, solver_host_threshold=0,
                 put_routing="home",
                 balancer_max_tasks=max_tasks,
                 balancer_max_requesters=max_requesters)
    t0 = time.perf_counter()
    res = run_world(num_app_ranks=napps, nservers=nservers,
                    types=types + (answer,), app_fn=app, cfg=cfg,
                    timeout=600)
    wall = time.perf_counter() - t0
    if res.aborted:
        raise AssertionError("world aborted")
    consumed = sorted(i for r in range(1, napps)
                      for i in res.app_results[r])
    if consumed != list(range(nunits)):
        raise AssertionError(
            f"units not consumed exactly once: {len(consumed)} consumed, "
            f"{len(set(consumed))} distinct of {nunits}")
    if res.app_results[0] != sum(value(i) for i in range(nunits)):
        raise AssertionError("answer total differs")
    return wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from adlb_tpu_torch.balancer import greedy_sweep as gs
    from adlb_tpu_torch.balancer import solve

    label = card_label()
    print(f"card: {label}")

    def report(line: str) -> None:
        print(f"[{label}] {line}", flush=True)

    t0 = time.perf_counter()
    so = gs.build()
    report(f"phase 1: built {so.name} in {time.perf_counter() - t0:.2f} s")
    for ln in gs.build_log.splitlines():
        if "ptxas" in ln:
            report(f"phase 1: {ln.strip()}")

    by_case, max_err = check_kernel(gs, solve._host_greedy, report)

    # host-clock time of each device solve in the world (numpy in, numpy
    # out) and its split: hand-off (numpy copies into the pinned buffer and
    # the H2D enqueue), sort + launch + D2H enqueue, wait for the result;
    # every eighth solve's inputs and result are kept for a check afterwards
    solve_s, splits, sampled = [], [], []
    untimed = solve.AssignmentSolver._device_solve

    def timed(self, *arrays):
        t = time.perf_counter()
        out = untimed(self, *arrays)
        solve_s.append(time.perf_counter() - t)
        splits.append(self.handoff.split)
        if len(solve_s) % 8 == 1:
            sampled.append(([np.array(a) for a in arrays], out.copy()))
        return out

    def split_text(rows) -> str:
        med = [1e3 * statistics.median(col) for col in zip(*rows)]
        return (f"hand-off {med[0]:.3f} ms, sort + launch enqueue "
                f"{med[1]:.3f} ms, wait for the result {med[2]:.3f} ms")

    solve.AssignmentSolver._device_solve = timed
    gs.reset_counts()
    solve.solve_counts.update(device=0, host=0)
    nunits = 10_000
    try:
        wall = run_main_path(nunits=nunits)
    finally:
        solve.AssignmentSolver._device_solve = untimed
    launches = gs.launches
    route_launches = gs.route_launches()
    counts = dict(solve.solve_counts)
    report(f"phase 3: world 64 apps x 16 servers, {nunits} units consumed "
           f"once in {wall:.3f} s ({nunits / wall:.1f} units/s); device "
           f"solves {counts['device']}, host solves {counts['host']}, "
           f"kernel launches {launches}, by route {route_launches}")
    if solve_s:
        report(f"phase 3: device solves 65536x8192 took "
               f"{sum(solve_s):.3f} s in all ({100 * sum(solve_s) / wall:.1f}% "
               f"of the world's wall time), median "
               f"{1e3 * statistics.median(solve_s):.3f} ms, max "
               f"{1e3 * max(solve_s):.3f} ms each; median split: "
               f"{split_text(splits)}")
    wrong = sum(not np.array_equal(out, solve._host_greedy(*arrays))
                for arrays, out in sampled)
    report(f"phase 3: {len(sampled)} of the world's device solves held "
           f"against _host_greedy: {wrong} differ")
    if wrong:
        raise AssertionError(f"{wrong} world solves differ from _host_greedy")
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
    if launches == 0 or counts["host"] != 0 \
            or launches != counts["device"] \
            or sum(route_launches.values()) != launches:
        raise AssertionError(f"main path did not run one kernel launch per "
                             f"device solve: launches={launches} "
                             f"routes={route_launches} counts={counts}")

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
        "by_case_65536x8192": by_case,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
