"""Time the sharded planner's auction kernel at the 10k-row shape against
other builds of it, in one process on the same inputs.

    python3 scripts/time_auction.py [--parent DIR]

Builds this checkout's ``csrc/auction.cu``, two edits of it, and, with
``--parent``, the one of an unpacked other checkout (for instance the
parent commit, unpacked with ``git archive`` into the git-ignored
``build/``). The edits: the lists left in device memory instead of
staged in shared memory (``lists_in_device_memory``), and a fixed
1024-thread block instead of one sized to the round's work
(``block_1024``). All of them share the C interface of
``adlb_tpu_torch/balancer/auction.py`` and are loaded with ``ctypes``.
Each is launched on three inputs: the lists ``plan_bench``'s 10,000-server
row hands the auction (8 shards, T=8, C=512, m=32, D=545, 16 rounds
allowed), and chip_smoke's phase-4 "10k-row shape" instance (random
masks at the same T, m, C) over its first D columns and over the full
[T, 8 * D] merge. Every build's output must equal this checkout's. The
builds are timed in turn, ten times, the order reversed every other
time: the device time per launch of 50 launches captured in a CUDA
graph (chip_smoke's ``graph_ms``, no host work in the window) and the
median per-call CUDA-event window (chip_smoke's ``time_ms``, the host's
launch included). Also times one block barrier at this checkout's block
size (:func:`barrier_ms`, ``scripts/barrier_probe.cu``) and the chain
bound it gives. Prints one JSON line with the card's name and power
limit. Needs a CUDA device.
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
        "return layout(T, C, m, C + m + 1).bytes <= (size_t)g_max_dyn;",
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


def launcher(lib, ins, rounds: int, m: int):
    """A function that launches ``lib``'s auction on ``ins`` into its own
    output on the current stream, and that output."""
    import torch

    gp, gg, rwc, lens, open0 = ins
    T, C = rwc.shape
    out = torch.empty((T * (C + 1) + 1,), dtype=torch.int32, device="cuda")
    nbytes = lib.adlb_auction_scratch_bytes(T, C, m)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device="cuda")
               if nbytes else None)

    def go():
        err = lib.adlb_auction(
            gp.data_ptr(), gg.data_ptr(), gp.shape[1], rwc.data_ptr(),
            lens.data_ptr(), open0.data_ptr(), T, C, m, rounds,
            out.data_ptr(), scratch.data_ptr() if scratch is not None
            else None, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"auction launch failed: CUDA error {err}")
    return go, out


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
    from adlb_tpu_torch.balancer import auction, candidates, cuda_build
    from adlb_tpu_torch.balancer import plan_bench

    srcs = sources(args.parent)
    libs = {}
    for name, so in zip(srcs, cuda_build.build_all(list(srcs.values()))):
        lib = ctypes.CDLL(str(so))
        lib.adlb_auction_init.restype = ctypes.c_int
        lib.adlb_auction_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.adlb_auction_scratch_bytes.restype = ctypes.c_longlong
        lib.adlb_auction.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p] * 3)
        lib.adlb_auction.restype = ctypes.c_int
        if lib.adlb_auction_init() != 0:
            raise RuntimeError(f"{name}: auction init failed")
        libs[name] = lib

    kept = []
    plan_bench.run_sweep(scales=[plan_bench.SCALES[3]], reps=2, nshards=8,
                         device="cuda", on_row=lambda s, row: kept.append(s))
    solver = kept[0]
    gp, gg = (x.clone() for x in candidates.merged_candidates(
        *solver._dev_blocks, solver.T, solver.D, work=solver._cand_work))
    inputs = {"plan_bench_10k": ((gp, gg) + tuple(solver._dev_req),
                                 solver.rounds, solver.m)}
    # chip_smoke's seed for this case: T * 1000 + m * 10 + nshards
    _, ins, D = chip_smoke.auction_instance(np.random.default_rng(8328), 8,
                                            32, 8, 16, sl=32)
    inputs["phase4_10k_shape_D"] = (
        tuple([x[:, :D].contiguous() for x in ins[:2]] + ins[2:]), 16, 32)
    inputs["phase4_10k_shape_full"] = (tuple(ins), 16, 32)

    out = {}
    for iname, (ins, rounds, m) in inputs.items():
        runs = {name: launcher(lib, ins, rounds, m)
                for name, lib in libs.items()}
        for name, (go, res) in runs.items():
            go()
            torch.cuda.synchronize()
            if not torch.equal(res, runs["this"][1]):
                raise AssertionError(f"{name} differs from this checkout's "
                                     f"kernel on {iname}")
        graph = {name: [] for name in runs}
        call = {name: [] for name in runs}
        for r in range(10):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for name in order:
                graph[name].append(chip_smoke.graph_ms(runs[name][0]))
                call[name].append(chip_smoke.time_ms(runs[name][0], reps=50))
        out[iname] = {
            "shape": list(ins[0].shape) + [ins[2].shape[1], m],
            "rounds_run": int(runs["this"][1][-1]),
            "commits": int((runs["this"][1][:-1] >= 0).sum()),
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
