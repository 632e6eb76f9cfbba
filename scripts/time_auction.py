"""Time the sharded planner's auction kernel against other builds of it,
in one process on the same inputs.

    python3 scripts/time_auction.py [--parent DIR]

Builds this checkout's ``csrc/auction.cu``, two edits of it, and, with
``--parent``, the one of an unpacked other checkout (for instance the
parent commit, unpacked with ``git archive`` into the git-ignored
``build/``). The edits: the lists left in device memory instead of
staged in shared memory (``lists_in_device_memory``), and a fixed
1024-thread block instead of one sized to the round's work
(``block_1024``). All are loaded with ``ctypes`` and launched through
their own C entry: a build with ``adlb_auction_windows`` builds the
requester windows in its prologue from the resident requester table (as
this checkout's device plan launches it, nothing staged), one without it
(a checkout from before the prologue) runs the rounds over the
host-built tables (``_reqwin`` and ``_compact_reqwin``), so beside a
parent it gives the auction's time with and without the prologue.
Each build is launched on five inputs: the lists and requester table of
``plan_bench``'s 10,000-server row (8 shards, T=8, C=512, m=32, D=545,
16 rounds allowed), those of the benchmark cells ``planner131k.churn``
(``benchmark/configs/planner-131k.json`` under ``traffic/churn.json``;
T=4) and ``planner131k.gfmc`` (``gfmc-131k.json`` under ``gfmc.json``;
T=5) at their state after the warm-up rounds, and chip_smoke's phase-4
"10k-row shape" instance (random masks at the same T, m, C) over its first D
columns and over the full [T, 8 * D] merge. Every build's commits and
rounds run must equal this checkout's. The builds are timed in turn, ten
times, the order reversed every other time: the device time per launch
of 50 launches captured in a CUDA graph (chip_smoke's ``graph_ms``, no
host work in the window) and the median per-call CUDA-event window
(chip_smoke's ``time_ms``, the host's launch included). Also times one
block barrier at this checkout's block size (:func:`barrier_ms`,
``scripts/barrier_probe.cu``) and the chain bound it gives. Prints one
JSON line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE_SOURCE = Path(__file__).resolve().parent / "barrier_probe.cu"

#: the variants of this checkout's auction.cu: (line as written, its edit)
VARIANTS = {
    "lists_in_device_memory": (
        "return layout(T, C, m, C + m + 1, scan_words(T, m)).bytes <=\n"
        "         (size_t)g_max_dyn;",
        "return 0;"),
    "block_1024": (
        "return (int)(want < 128 ? 128 : want > kMaxThreads ? kMaxThreads "
        ": want);",
        "return kMaxThreads;"),
}


def barrier_ms(time_ms, threads: int, iters: int = 20_000) -> float:
    """One block barrier's latency on this card at ``threads`` threads, in
    ms: the ``time_ms`` (chip_smoke's per-call CUDA-event median) of a
    chain of ``iters`` barriers less that of an empty launch, over
    ``iters``. Builds ``barrier_probe.cu`` with the port's ``cuda_build``
    (the auction kernel's build)."""
    import torch

    from adlb_tpu_torch.balancer import cuda_build

    lib = ctypes.CDLL(str(cuda_build.build_all([PROBE_SOURCE])[0]))
    fn = lib.adlb_barrier_chain
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.zeros((1,), dtype=torch.int32, device="cuda")

    def chain(n):
        err = fn(threads, n, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"barrier chain launch failed: CUDA error "
                               f"{err}")

    full = time_ms(lambda: chain(iters), reps=9)
    empty = time_ms(lambda: chain(0), reps=9)
    return (full - empty) / iters


def sources(parent) -> dict:
    """{build name: auction.cu path}; the variants are written into the
    git-ignored build/ directory."""
    from adlb_tpu_torch.balancer import auction

    out = {"this": auction.SOURCE}
    if parent:
        out["parent"] = (Path(parent) / "adlb_tpu_torch" / "csrc"
                         / "auction.cu")
    text = auction.SOURCE.read_text()
    where = ROOT / "build" / "auction_variants"
    where.mkdir(parents=True, exist_ok=True)
    for name, (line, edit) in VARIANTS.items():
        if text.count(line) != 1:
            raise RuntimeError(f"variant {name}: {line!r} is not in "
                               f"{auction.SOURCE} once")
        path = where / f"auction_{name}.cu"
        path.write_text(text.replace(line, edit))
        out[name] = path
    return out


def load(name: str, path) -> ctypes.CDLL:
    """One build's library, its entries typed and its init run."""
    lib = ctypes.CDLL(str(path))
    lib.adlb_auction_init.restype = ctypes.c_int
    if hasattr(lib, "adlb_auction_windows"):
        lib.adlb_auction_windows_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.adlb_auction_windows_scratch_bytes.restype = ctypes.c_longlong
        lib.adlb_auction_windows.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
        lib.adlb_auction_windows.restype = ctypes.c_int
    else:
        lib.adlb_auction_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.adlb_auction_scratch_bytes.restype = ctypes.c_longlong
        lib.adlb_auction.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p] * 3)
        lib.adlb_auction.restype = ctypes.c_int
    if lib.adlb_auction_init() != 0:
        raise RuntimeError(f"{name}: auction init failed")
    return lib


def launcher(lib, inp: dict):
    """A function that launches ``lib``'s auction on the input ``inp`` into
    its own output on the current stream, and a function that reads that
    output's (assigned [T, C + 1], rounds run)."""
    import torch

    gp, gg = inp["lists"]
    rwc, lens, open0 = inp["tables"]
    table, order, delta = inp["requesters"]
    rounds, m = inp["rounds"], inp["m"]
    T, C = rwc.shape
    n = T * (C + 1)
    windows = hasattr(lib, "adlb_auction_windows")
    # room for the longest output: assigned, rows, rounds, scanned, lost
    out = torch.empty((2 * n + 3,), dtype=torch.int32, device="cuda")
    nbytes = (lib.adlb_auction_windows_scratch_bytes if windows
              else lib.adlb_auction_scratch_bytes)(T, C, m)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device="cuda")
               if nbytes else None)
    sp = scratch.data_ptr() if scratch is not None else None

    def go():
        stream = torch.cuda.current_stream().cuda_stream
        if windows:
            err = lib.adlb_auction_windows(
                gp.data_ptr(), gg.data_ptr(), gp.shape[1], table.data_ptr(),
                order.data_ptr(), delta.data_ptr(), 0, inp["R"],
                table.shape[1], T, C, m, rounds, out.data_ptr(), sp, stream)
        else:
            err = lib.adlb_auction(
                gp.data_ptr(), gg.data_ptr(), gp.shape[1], rwc.data_ptr(),
                lens.data_ptr(), open0.data_ptr(), T, C, m, rounds,
                out.data_ptr(), sp, stream)
        if err != 0:
            raise RuntimeError(f"auction launch failed: CUDA error {err}")

    def result():
        return out[:n].view(T, C + 1), int(out[2 * n if windows else n])
    return go, result


def cell_solver(seed: int = 2**31 + 15, config: str = "planner-131k",
                traffic: str = "churn"):
    """A device-tier solver at a benchmark cell's state: the cell's
    configuration, its cold ingest and plan and its warm rounds under its
    traffic from ``seed``."""
    from benchmark.planner_cell import build_solver, generator

    conf = json.loads((ROOT / f"benchmark/configs/{config}.json")
                      .read_text())
    traffic = json.loads((ROOT / f"benchmark/traffic/{traffic}.json")
                         .read_text())
    sol = build_solver(conf, "cuda")
    gen = generator(traffic)(traffic, conf["servers"], conf["max_tasks"],
                             conf["max_requesters"], conf["types"], seed)
    sol.ingest(gen.snaps)
    sol.plan()
    for _ in range(int(traffic["warm_rounds"])):
        gen.bursts()
        sol.ingest(gen.snaps)
        gen.consume(sol.plan())
    return sol


def solver_input(chip_smoke, solver) -> dict:
    """A device-tier solver's resident state as an input: its merged lists,
    the host-built tables over its mirror and its requester table (every
    staged row packed by a plan first)."""
    from adlb_tpu_torch.balancer import candidates

    solver._device_plan()
    gp, gg = (x.clone() for x in candidates.merged_candidates(
        *solver._dev_blocks, solver.T, solver.D, work=solver._cand_work))
    rq = solver._reqs
    return {"lists": (gp, gg), "tables": chip_smoke.host_req_tables(solver),
            "requesters": (rq.table, rq.order_dev, rq.delta),
            "R": solver.R, "rounds": solver.rounds, "m": solver.m,
            "scanned": solver.last_scanned}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose auction.cu is "
                    "timed beside this one")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_auction: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from adlb_tpu_torch.balancer import auction, cuda_build
    from adlb_tpu_torch.balancer import plan_bench

    srcs = sources(args.parent)
    libs = {name: load(name, so) for name, so in
            zip(srcs, cuda_build.build_all(list(srcs.values())))}

    kept = []
    plan_bench.run_sweep(scales=[plan_bench.SCALES[3]], reps=2, nshards=8,
                         device="cuda", on_row=lambda s, row: kept.append(s))
    solver = kept[0]
    inputs = {"plan_bench_10k": solver_input(chip_smoke, solver),
              "planner131k_churn": solver_input(chip_smoke, cell_solver()),
              "planner131k_gfmc": solver_input(chip_smoke, cell_solver(
                  config="gfmc-131k", traffic="gfmc"))}
    # chip_smoke's seed for this case: T * 1000 + m * 10 + nshards
    (_, _, rw, _, _), ins, D, win = chip_smoke.auction_instance(
        np.random.default_rng(8328), 8, 32, 8, 16, sl=32)
    # the first launch packs every slot's staged rows into the table
    auction.auction_windows(*ins[:2], *win, win[1].shape[0] - 1, 16, 32,
                            rw.shape[1])
    for name, lists in (("phase4_10k_shape_D",
                         [x[:, :D].contiguous() for x in ins[:2]]),
                        ("phase4_10k_shape_full", ins[:2])):
        inputs[name] = {"lists": tuple(lists), "tables": tuple(ins[2:]),
                        "requesters": tuple(win), "R": 4, "rounds": 16,
                        "m": 32}

    out = {}
    for iname, inp in inputs.items():
        runs = {name: launcher(lib, inp) for name, lib in libs.items()}
        for go, _ in runs.values():
            go()
        torch.cuda.synchronize()
        want, rounds_run = runs["this"][1]()
        for name, (_, result) in runs.items():
            got, rnd = result()
            if not (torch.equal(got, want) and rnd == rounds_run):
                raise AssertionError(f"{name} differs from this checkout's "
                                     f"kernel on {iname}")
        graph = {name: [] for name in runs}
        call = {name: [] for name in runs}
        for r in range(10):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for name in order:
                graph[name].append(chip_smoke.graph_ms(runs[name][0]))
                call[name].append(chip_smoke.time_ms(runs[name][0], reps=50))
        T, C = want.shape[0], want.shape[1] - 1
        out[iname] = {
            "shape": list(inp["lists"][0].shape) + [C, inp["m"]],
            "rounds_run": rounds_run,
            "commits": int((want[:, :C] >= 0).sum()),
            "scanned": inp.get("scanned"),
            "prologue": {name: hasattr(lib, "adlb_auction_windows")
                         for name, lib in libs.items()},
            "graph_ms": {n: statistics.median(v) for n, v in graph.items()},
            "graph_ms_each": graph,
            "call_ms": {n: statistics.median(v) for n, v in call.items()},
        }
    threads = auction.Workspace(solver.T, solver.C, solver.m, "cuda").threads
    bar = barrier_ms(chip_smoke.time_ms, threads)
    for row in out.values():
        row["chain_bound_ms"] = (row["rounds_run"]
                                 * auction.BARRIERS_PER_ROUND * bar)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "builds": {n: str(p) for n, p in
                                               srcs.items()},
                      "threads": threads, "barrier_ms": bar,
                      "barriers_per_round": auction.BARRIERS_PER_ROUND,
                      "timed": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
