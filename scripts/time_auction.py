"""Time the sharded planner's auction kernel alone at the 10k-row shape.

    python3 scripts/time_auction.py [--root DIR] [--reps N]

Builds ``csrc/auction.cu`` of the ``adlb_tpu_torch`` under ``--root``
(default: this checkout), then times one launch on two inputs: the state
``plan_bench``'s 10,000-server row leaves (8 shards, T=8, C=512, m=32,
16 rounds allowed) and chip_smoke's phase-4 "10k-row shape" instance
(random masks at the same T, m, C). Prints one JSON line with, per input,
the median of per-call CUDA-event windows and the back-to-back mean
(chip_smoke's two methods), the rounds run and the commits. Give
``--root`` an unpacked other checkout to time its kernel the same way;
compare two checkouts only on one card in one sitting, in the order
A, B, B, A. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose auction kernel is timed")
    ap.add_argument("--reps", type=int, default=200,
                    help="calls per timing")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_auction: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from adlb_tpu_torch.balancer import auction, plan_bench
    from adlb_tpu_torch.balancer import distributed as dist

    kept = []
    plan_bench.run_sweep(scales=[plan_bench.SCALES[3]], reps=2, nshards=8,
                         device="cuda", on_row=lambda s, row: kept.append(s))
    solver = kept[0]
    cp, cg = dist._shard_candidates(*solver._dev_blocks, solver.T, solver.D)
    gp, gg = dist._merge_candidates(cp, cg)
    inputs = {"plan_bench_10k": ((gp, gg) + tuple(solver._dev_req),
                                 solver.rounds, solver.m)}
    # chip_smoke's seed for this case: T * 1000 + m * 10 + nshards
    _, ins = chip_smoke.auction_instance(np.random.default_rng(8328), 8, 32,
                                         8, 16, sl=32)
    inputs["phase4_10k_shape"] = (tuple(ins), 16, 32)
    out = {}
    for name, (ins, rounds, m) in inputs.items():
        work = auction.Workspace(ins[2].shape[0], ins[2].shape[1], m,
                                 ins[0].device)
        got = work.launch(*ins, rounds)
        out[name] = {
            "ms": chip_smoke.time_ms(lambda: work.launch(*ins, rounds),
                                     reps=args.reps),
            "ms_back_to_back": chip_smoke.back_to_back_ms(
                lambda: work.launch(*ins, rounds), reps=args.reps),
            "rounds_run": int(work.rounds_run),
            "commits": int((got >= 0).sum()),
            "shape": list(ins[0].shape) + [ins[2].shape[1], m],
        }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card,
                      "timed": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
