"""Time the sharded planner's plan round and its device plan at plan_bench's
1k and 10k rows, for one checkout.

    python3 scripts/time_device_plan.py [--root DIR] [--reps N]

Runs ``plan_bench.run_sweep`` of the ``adlb_tpu_torch`` under ``--root``
(default: this checkout) on the card at the 1,000- and 10,000-server rows
(8 shards, T=8, C=512, m=32, device tier), then, on each row's final state,
times ``DistributedAssignmentSolver._device_plan`` (the device plan with its
[T, C+1] readback: in this checkout two kernel launches, in older ones the
candidates' torch sorts, the merge sort and the auction launch): the median
of per-call CUDA-event windows and the median on the host clock. Prints one
JSON line with the card's name and power limit: per row the plan round's
p50 and p99 and their median split (ingest, solve, extract), and the device
plan's times. Give ``--root`` an unpacked other checkout to time it the same
way; compare two checkouts only on one card in one sitting, in the order A,
B, B, A. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose sharded planner is timed")
    ap.add_argument("--reps", type=int, default=40,
                    help="plan_bench rounds per row")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("time_device_plan: no CUDA device", file=sys.stderr)
        return 1
    from adlb_tpu_torch.balancer import plan_bench

    def device_plan_ms(solver, reps=50):
        for _ in range(3):
            solver._device_plan()
        ev, host = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            solver._device_plan()
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(a.elapsed_time(b))
        return statistics.median(ev), statistics.median(host)

    rows = {}

    def on_row(solver, row):
        ev, host = device_plan_ms(solver)
        rows[row["servers"]] = {
            "plan_round_p50_ms": row["plan_round_p50_ms"],
            "plan_round_p99_ms": row["plan_round_p99_ms"],
            "ingest_p50_ms": row["ingest_p50_ms"],
            "solve_p50_ms": row["solve_p50_ms"],
            "extract_p50_ms": row["extract_p50_ms"],
            "device_plan_ms": ev, "device_plan_host_clock_ms": host}

    plan_bench.run_sweep(scales=[plan_bench.SCALES[2], plan_bench.SCALES[3]],
                         reps=args.reps, nshards=8, device="cuda",
                         on_row=on_row)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
