"""The control: the reference put in the program's place with the
priorities coarsened (``prio >> shift``), which breaks the configurations'
guarantee of strict priority order. It must come out not correct; the
benchmark's own runs never run it.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 --seconds S
        [--shift 4] [--program]

runs the cell at its own size once a seed with the control in the
program's place (with ``--program``, the program too, on the same seeds)
and prints each run's compared numbers, one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_hook(kind: str, shift: int) -> dict:
    """The run's hooks that put the control in the program's place, from
    the cell's own module (``benchmark/<kind>_cell.py``, its
    ``control(shift)``)."""
    from benchmark.run import cell_module

    return cell_module(kind).control(shift)


def main(argv=None) -> int:
    from benchmark import common
    from benchmark.run import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--shift", type=int, default=4)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    common.use_checkout_caches()
    manifest = common.load_manifest()
    _, entry = common.find_cell(manifest, args.workload)
    kind = common.config_file(entry)["kind"]
    sides = (["program"] if args.program else []) + ["control"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in sides:
            hooks = control_hook(kind, args.shift) if side == "control" \
                else {}
            out = run_cell(args.workload, seed, args.seconds, False,
                           t_process=time.perf_counter(), manifest=manifest,
                           **hooks)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": out["correct"],
                              "compared": {k: v["value"] for k, v in
                                           out["compared"].items()},
                              "metrics": {k: v["value"] for k, v in
                                          out["metrics"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
