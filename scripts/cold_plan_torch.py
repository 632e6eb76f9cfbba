"""Time the sharded planner's first planning round in a fresh process, with
its table split one shard per card: what the first round pays when the
solver builds its device state lazily, and what it pays after the solver
was warmed as the engine warms it.

    python3 scripts/cold_plan_torch.py --mode lazy|warm [--ndev 4]
        [--device cuda|cpu]

The process first opens only the planning card's context and builds the
greedy-sweep kernel, as a world's planner or sidecar does before its first
round, then builds ``DistributedAssignmentSolver`` over
``graft_entry.card_placement(ndev)`` at plan_bench's 10k row (10,000
servers x 100 parked requesters, T=8) and runs one round of
``plan_bench.run_sweep``. ``--mode lazy`` leaves the pieces, workspaces,
peer access and events (and every other card's context) to the first
ingest; ``--mode warm`` builds them first with ``solver.warm()``, timed as
``warm_ms``. Prints one JSON line: ``cold_ingest_ms`` and
``first_plan_ms`` (the host clock; their sum, ``first_round_ms``, is the
cold first round's ingest and plan), ``build_ms`` (the solver's device
build, wherever it ran) and ``build_in_first_round_ms`` (the part of it the
first round paid), ``warm_ms``, the placement and the card's name and power
limit. Run each mode in its own process: a context, once opened, stays.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("lazy", "warm"), required=True)
    ap.add_argument("--ndev", type=int, default=4,
                    help="shards, one per card (round-robin when fewer "
                         "cards are visible)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--servers", type=int, default=10_000,
                    help="servers of the row (plan_bench's 10k row: 10000)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    import torch

    from adlb_tpu_torch import graft_entry
    from adlb_tpu_torch.balancer import greedy_sweep, plan_bench
    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver,
    )

    build_ms = []
    ensure_built = DistributedAssignmentSolver._ensure_built

    def timed_build(solver):
        if solver._pieces is not None:
            return
        t = time.perf_counter()
        ensure_built(solver)
        build_ms.append((time.perf_counter() - t) * 1e3)

    DistributedAssignmentSolver._ensure_built = timed_build

    row = next(r for r in plan_bench.SCALES if r[0] == args.servers)
    label = "cpu"
    if args.device == "cuda":
        from adlb_tpu_torch.balancer.cuda_build import card_label

        torch.zeros(1, device="cuda:0")  # the planning card's context only
        greedy_sweep.build()
        label = card_label()
        placement = graft_entry.card_placement(args.ndev)
    else:
        placement = [torch.device("cpu")] * args.ndev
    start_s = time.perf_counter() - t0
    kept = []
    out = plan_bench.run_sweep(scales=[row], reps=1, devices=placement,
                               device=args.device, warm=args.mode == "warm",
                               on_row=lambda s, r: kept.append(s))
    r = out["rows"][0]
    print(json.dumps({
        "mode": args.mode, "card": label,
        "placement": [str(d) for d in placement],
        "cards_visible": (torch.cuda.device_count()
                          if args.device == "cuda" else 0),
        "merge_route": kept[0].merge_route,
        "start_s": start_s, "warm_ms": r["warm_ms"],
        "build_ms": build_ms[0],
        "build_in_first_round_ms": (0.0 if args.mode == "warm"
                                    else build_ms[0]),
        "cold_ingest_ms": r["cold_ingest_ms"],
        "first_plan_ms": r["first_plan_ms"],
        "first_round_ms": r["cold_ingest_ms"] + r["first_plan_ms"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
