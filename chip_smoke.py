"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc`` (it exits non-zero without them, printing
no result). Phases:

1. build the greedy-sweep kernel (``adlb_tpu_torch/csrc/greedy_sweep.cu``)
   from the sources in this checkout;
2. hold the kernel against its plain PyTorch version and against the numpy
   twin ``_host_greedy`` on edge cases and at the main path's shapes
   (exact equality: the outputs are integer assignments), and time it;
3. drive the port's main path: a ``run_world`` with the planned balancer on
   the card, 16 servers x (4096 tasks, 512 requesters), so every device
   solve is a 65536 x 8192 instance; every unit must be consumed exactly
   once, and every solve must have launched the kernel.

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
    """Median per-call device time with CUDA events, after warm-up."""
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


def bound_ms(nt: int, nr: int, t: int) -> float:
    """Least time for the sweep's bytes: every input read once (prio and
    type int32, mask and valid bool) and assign int32 written once, over
    the card's memory rate. Its operations are a few per task and a few per
    mask word: far under the bytes' time."""
    nbytes = 4 * nt * 2 + nr * t + nr + 4 * nr
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
    return cases


def check_kernel(gs, host_greedy, report):
    """Phase 2: exact agreement and times. Returns the kernel's entry."""
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    err = 0

    def diff(a, b) -> int:
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    for name, arrs in edge_cases(rng):
        ins = [torch.from_numpy(a).to(dev) for a in arrs]
        got = gs.greedy_assign_cuda(*ins)
        torch.cuda.synchronize()
        plain = gs.greedy_assign_torch(*ins)
        want = host_greedy(*arrs)
        err = max(err, diff(got, plain))
        if not (torch.equal(got, plain)
                and np.array_equal(got.cpu().numpy(), want)):
            raise AssertionError(f"kernel disagrees on case {name!r}")
        report(f"phase 2: {name}: kernel == plain == host_greedy")
    main = None
    for nt, nr in ((4096, 512), (16384, 2048), (65536, 8192)):
        arrs = bench_instance(rng, nt, nr)
        ins = [torch.from_numpy(a).to(dev) for a in arrs]
        got = gs.greedy_assign_cuda(*ins)
        torch.cuda.synchronize()
        want = host_greedy(*arrs)
        t0 = time.perf_counter()
        plain = gs.greedy_assign_torch(*ins)
        torch.cuda.synchronize()
        plain_once = time.perf_counter() - t0
        err = max(err, diff(got, plain))
        if not (np.array_equal(got.cpu().numpy(), want)
                and torch.equal(got, plain)):
            raise AssertionError(f"kernel disagrees at {nt}x{nr}")
        ms = time_ms(lambda: gs.greedy_assign_cuda(*ins), reps=50)
        plain_ms = time_ms(lambda: gs.greedy_assign_torch(*ins),
                           reps=3 if plain_once < 5 else 1, warmup=0)
        prep = gs.prepare_sweep(*ins)
        prep_ms = time_ms(lambda: gs.prepare_sweep(*ins), reps=50)
        sweep_ms = time_ms(lambda: gs.launch_sweep(*prep, nr), reps=50)
        bnd = bound_ms(nt, nr, 4)
        report(f"phase 2: {nt}x{nr} T=4: kernel == plain == host_greedy; "
               f"kernel {ms:.4f} ms (torch pre-pass {prep_ms:.4f} ms, "
               f"sweep launch alone {sweep_ms:.4f} ms), plain "
               f"{plain_ms:.1f} ms, bound {bnd:.6f} ms (bytes), matched "
               f"{int((got >= 0).sum())}")
        main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd}
    main["max_abs_err"] = err
    return main


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

    k1 = check_kernel(gs, solve._host_greedy, report)

    # host-clock time of each device solve in the world (numpy in, numpy
    # out: hand-off, pre-pass, kernel and the copy back)
    solve_s = []
    untimed = solve.AssignmentSolver._device_solve

    def timed(self, *arrays):
        t = time.perf_counter()
        out = untimed(self, *arrays)
        solve_s.append(time.perf_counter() - t)
        return out

    solve.AssignmentSolver._device_solve = timed
    gs.launches = 0
    solve.solve_counts.update(device=0, host=0)
    nunits = 10_000
    try:
        wall = run_main_path(nunits=nunits)
    finally:
        solve.AssignmentSolver._device_solve = untimed
    launches = gs.launches
    counts = dict(solve.solve_counts)
    report(f"phase 3: world 64 apps x 16 servers, {nunits} units consumed "
           f"once in {wall:.3f} s ({nunits / wall:.1f} units/s); device "
           f"solves {counts['device']}, host solves {counts['host']}, "
           f"kernel launches {launches}")
    if solve_s:
        report(f"phase 3: device solves 65536x8192 took "
               f"{sum(solve_s):.3f} s in all ({100 * sum(solve_s) / wall:.1f}% "
               f"of the world's wall time), median "
               f"{1e3 * statistics.median(solve_s):.3f} ms, max "
               f"{1e3 * max(solve_s):.3f} ms each")
    # the same solve (numpy in, numpy out) with no world running: the
    # yardstick for what the world's solves spend waiting on the host
    alone = solve.AssignmentSolver(types=(1, 2, 3, 4), max_tasks=4096,
                                   max_requesters=512, host_threshold_reqs=0)
    arrs = bench_instance(np.random.default_rng(1), 65536, 8192)
    alone_s = []
    for _ in range(21):
        t = time.perf_counter()
        alone._device_solve(*arrs)
        alone_s.append(time.perf_counter() - t)
    report(f"phase 3: the same 65536x8192 device solve with no world "
           f"running: median {1e3 * statistics.median(alone_s[1:]):.3f} ms "
           f"on the host clock")
    if launches == 0 or counts["host"] != 0 \
            or launches != counts["device"]:
        raise AssertionError(f"main path did not run on the kernel: "
                             f"launches={launches} counts={counts}")

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "adlb_tpu" or m.startswith("adlb_tpu.")]
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")

    print(json.dumps({"kernels": [{
        "name": "greedy_sweep",
        "route": "cuda",
        "source": "adlb_tpu_torch/csrc/greedy_sweep.cu",
        "replaces": "adlb_tpu/balancer/pallas_solve.py:63",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
