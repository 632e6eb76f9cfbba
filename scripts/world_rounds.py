"""Time the planner's rounds in chip_smoke.py's phase-3 world on the card:
the world's units/s, the number of planner rounds, each round's host-clock
time, the device solve's share of it, and the plan pairs per round.

    python3 scripts/world_rounds.py [--root DIR] [--worlds N]
                                    [--min-gap S] [--check]

Imports ``chip_smoke.run_main_path`` and ``adlb_tpu_torch`` from the
checkout under ``--root`` (default: this one), so an unpacked older
checkout is measured the same way. ``--min-gap`` sets the world's
``balancer_min_gap`` (the pause between planner rounds); ``--check`` holds
every device solve of the world against the numpy twin ``_host_greedy``
afterwards. Prints one JSON line per world. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose chip_smoke.py and adlb_tpu_torch run")
    ap.add_argument("--worlds", type=int, default=1)
    ap.add_argument("--min-gap", type=float, default=None,
                    help="balancer_min_gap in seconds (default: Config's)")
    ap.add_argument("--check", action="store_true",
                    help="hold every device solve against _host_greedy")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("world_rounds: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import adlb_tpu_torch
    import chip_smoke
    from adlb_tpu_torch.balancer.engine import PlanEngine
    from adlb_tpu_torch.balancer.solve import AssignmentSolver, _host_greedy

    rounds, solves, seen = [], [], []

    def timed(fn, sink, count_pairs):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t
            sink.append((dt, len(out[0])) if count_pairs else dt)
            return out
        return wrapper

    PlanEngine.round = timed(PlanEngine.round, rounds, True)
    solve = timed(AssignmentSolver._device_solve, solves, False)

    def kept(self, *arrays):
        out = solve(self, *arrays)
        if args.check:
            seen.append(([np.array(a) for a in arrays], np.array(out)))
        return out

    AssignmentSolver._device_solve = kept
    if args.min_gap is not None:
        run_world = adlb_tpu_torch.run_world

        def paced(*a, cfg, **k):
            cfg.balancer_min_gap = args.min_gap
            return run_world(*a, cfg=cfg, **k)
        adlb_tpu_torch.run_world = paced
    nunits = 10_000
    for _ in range(args.worlds):
        rounds.clear()
        solves.clear()
        seen.clear()
        wall = chip_smoke.run_main_path(nunits=nunits)
        round_s = [r[0] for r in rounds]
        wrong = sum(not np.array_equal(out, _host_greedy(*arrays))
                    for arrays, out in seen)
        print(json.dumps({
            "root": str(Path(args.root).resolve()),
            "card": torch.cuda.get_device_name(0),
            "units_per_s": nunits / wall,
            "wall_s": wall,
            "rounds": len(rounds),
            "rounds_with_pairs": sum(1 for r in rounds if r[1]),
            "pairs_per_round_with_pairs": statistics.mean(
                [r[1] for r in rounds if r[1]] or [0]),
            "round_ms_median": 1e3 * statistics.median(round_s),
            "round_s_total": sum(round_s),
            "device_solves": len(solves),
            "solve_ms_median": 1e3 * statistics.median(solves or [0]),
            "solve_s_total": sum(solves),
            "min_gap_s": args.min_gap,
            "solves_checked": len(seen),
            "solves_wrong": wrong,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
