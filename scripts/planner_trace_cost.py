"""The sharded planner's tracing cost and its phase split, at the size and
traffic of the benchmark's ``planner131k.churn`` cell, in one process.

    python3 scripts/planner_trace_cost.py [--parent DIR] [--seconds S]
        [--rounds N] [--seed N] [--device cuda|cpu] [--servers N]
        [--requesters N]

One solver (``DistributedAssignmentSolver``) fed by the cell's churn
traffic (``benchmark/churn.py``) from ``--seed``:

1. The split: ``--rounds`` churn rounds with a ``runtime.trace.Tracer``
   attached; each phase's spans summed over the rounds, over their number
   (ms a round), and the median and 90th percentile of the rounds in which
   the phase ran (a mean takes in the collector's pauses wherever they
   land), the share of walked servers that had changed, the requester
   rows shipped and ``scanned`` a round, and the children's sums against
   ``last_ingest_ms`` and ``last_solve_ms``.
2. The cost, as an A/B in one process on one state: the snapshots of two
   more churn rounds as their ingests found them (A and B: each with its
   round's bursts on 8 servers, B with A's plan consumed) are ingested and
   planned in turns, A, B, A, ..., so that every round packs, uploads and
   plans a churn round's delta (16 task rows and the re-parked
   requesters), while the code that runs them turns over. For half of
   ``--seconds``, every two rounds between ``parent`` (the
   ``DistributedAssignmentSolver`` of ``DIR``'s ``balancer/distributed.py``,
   an unpacked parent commit, whose other modules are this checkout's: the
   solver's class is switched) and ``off`` (this checkout, tracer None);
   for the other half (all of it without ``--parent``; a parent whose
   solver keeps other state than this checkout's cannot take its place
   on one state), every 40 rounds between ``off`` and ``on`` (the
   tracer attached, its events kept as a window's are, so that the
   collections its events cause land in its own blocks). Each round is
   timed from the call of ``ingest`` to the pairs ``plan`` returns on the
   host clock (the card machine's thread CPU clock ticks in milliseconds).

Prints one JSON line: the split; for each comparison the cost (``off -
parent``, ``on - off``) in us a round as the difference of means with its
standard error, of medians and of neighbouring blocks, each code's round
times and the collections by generation in its rounds with their time;
the device, with the card's name and power limit. On a card only, unless
``--device cpu`` (a rehearsal at a small size: ``--servers 64
--requesters 16``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PHASES = ("planner:ingest", "planner:ingest.diff", "planner:ingest.pack",
          "planner:ingest.upload", "planner:ingest.reqwin",
          "planner:ingest.reqrows", "planner:plan", "planner:plan.enqueue",
          "planner:plan.readback", "planner:plan.extract")
#: the ingest's children: the host tier rebuilds the requester windows
#: (``.reqwin``), the device tier stages the requester rows (``.reqrows``)
INGEST_CHILDREN = PHASES[1:6]


def load_parent(parent: Path):
    """The parent checkout's ``balancer/distributed.py`` as a module of
    its own; its imports resolve to this checkout's package."""
    path = parent / "adlb_tpu_torch" / "balancer" / "distributed.py"
    spec = importlib.util.spec_from_file_location("parent_distributed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_split(events: list, rounds: int, ingest_ms: float,
                solve_ms: float) -> dict:
    dur: dict = {}
    each: dict = {}
    walked = changed = scanned = rows = 0
    for e in events:
        dur[e["name"]] = dur.get(e["name"], 0.0) + e["dur"] * 1e-3
        each.setdefault(e["name"], []).append(e["dur"] * 1e-3)
        if e["name"] == "planner:ingest.diff":
            walked += e["args"]["walked"]
            changed += e["args"]["servers_changed"]
        elif e["name"] == "planner:plan.readback":
            scanned += e["args"].get("scanned") or 0
        elif e["name"] == "planner:ingest.reqrows":
            rows += e["args"]["rows"]
    ms = {k: dur.get(k, 0.0) / rounds for k in PHASES}
    quantiles = {k: {"median": statistics.median(v),
                     "p90": statistics.quantiles(v, n=10)[-1]
                     if len(v) > 1 else v[0], "rounds": len(v)}
                 for k, v in each.items() if k in PHASES}
    return {"rounds": rounds, "ms_per_round": ms, "ms_quantiles": quantiles,
            "last_ingest_ms": ingest_ms / rounds,
            "last_solve_ms": solve_ms / rounds,
            "diff_useful_pct": 100.0 * changed / walked if walked else None,
            "servers_walked_per_round": walked / rounds,
            "scanned_per_round": scanned / rounds,
            "requester_rows_shipped_per_round": rows / rounds,
            "ingest_children_over_ingest": sum(
                ms[k] for k in INGEST_CHILDREN) / (ingest_ms / rounds),
            "enqueue_readback_over_solve": (
                ms["planner:plan.enqueue"] + ms["planner:plan.readback"])
            / (solve_ms / rounds)}


def summary(xs: list) -> dict:
    return {"mean": statistics.fmean(xs), "median": statistics.median(xs),
            "sd": statistics.stdev(xs), "n": len(xs)}


def difference(a: list, b: list, block: int) -> dict:
    """b - a: of the means, with its standard error, and of the medians;
    and of each pair of neighbouring blocks (a's i-th, then b's i-th),
    which leaves out the host's slower drift: their mean, its standard
    error and their median."""
    se = math.sqrt(statistics.variance(a) / len(a)
                   + statistics.variance(b) / len(b))
    n = min(len(a), len(b)) // block
    d = [statistics.fmean(b[i * block:(i + 1) * block])
         - statistics.fmean(a[i * block:(i + 1) * block]) for i in range(n)]
    return {"mean": statistics.fmean(b) - statistics.fmean(a), "se": se,
            "median": statistics.median(b) - statistics.median(a),
            "paired_blocks": {"mean": statistics.fmean(d),
                              "se": statistics.stdev(d) / math.sqrt(n),
                              "median": statistics.median(d), "n": n}}


def card_label(device: str) -> str:
    if device != "cuda":
        return device
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked checkout of the parent commit")
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="time of the A/B, all codes together")
    ap.add_argument("--rounds", type=int, default=3000,
                    help="traced churn rounds for the split")
    ap.add_argument("--seed", type=int, default=2**31 + 14)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--servers", type=int, default=None)
    ap.add_argument("--requesters", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver)
    from adlb_tpu_torch.runtime.trace import Tracer
    from benchmark.churn import Churn

    if args.device == "cuda" and not torch.cuda.is_available():
        print("planner_trace_cost: no CUDA device", file=sys.stderr)
        return 1
    conf = json.loads((ROOT / "benchmark/configs/planner-131k.json")
                      .read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/churn.json").read_text())
    if args.servers:
        conf["servers"] = args.servers
    if args.requesters:
        conf["max_requesters"] = args.requesters
    parent = (load_parent(Path(args.parent)).DistributedAssignmentSolver
              if args.parent else None)
    S, ns = conf["servers"], conf["nshards"]
    sol = DistributedAssignmentSolver(
        conf["types"], conf["max_tasks"], conf["max_requesters"],
        nshards=ns, rounds=conf["auction_rounds"],
        servers_per_shard=-(-S // ns), cand_width=conf["cand_width"],
        auction=conf["auction"], device=args.device)
    sol.warm()
    gen = Churn(traffic, S, conf["max_tasks"], conf["max_requesters"],
                conf["types"], args.seed)

    def churn_round(keep=False):
        """One round of the cell; with ``keep``, a copy of the snapshots
        as the ingest found them."""
        gen.bursts()
        snaps = {s: dict(v) for s, v in gen.snaps.items()} if keep else None
        sol.ingest(gen.snaps)
        gen.consume(sol.plan())
        return snaps

    sol.ingest(gen.snaps)
    sol.plan()
    for _ in range(int(traffic["warm_rounds"])):
        churn_round()
    if args.device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    # 1. the split
    sol.tracer = Tracer(0, pid=1)
    ingest_ms = solve_ms = 0.0
    for _ in range(args.rounds):
        churn_round()
        ingest_ms += sol.last_ingest_ms
        solve_ms += sol.last_solve_ms
    split = phase_split(sol.tracer.events, args.rounds, ingest_ms, solve_ms)
    # 2. the cost: two churn rounds' snapshots, in turns
    sol.tracer = None
    states = [churn_round(keep=True), churn_round(keep=True)]
    on = Tracer(0, pid=1)
    rows: list = []

    def turns(codes, seconds, block):
        """Rounds over A and B in turn, the code turning over every
        ``block`` rounds: each code's round times (us), and the collections
        in its rounds with their time (ms) by generation."""
        wall = {c[0]: [] for c in codes}
        coll = {c[0]: [[0, 0.0] for _ in range(3)] for c in codes}
        now = [codes[0][0], 0.0]

        def on_gc(phase, info):
            if phase == "start":
                now[1] = time.perf_counter()
            else:
                g = coll[now[0]][info["generation"]]
                g[0] += 1
                g[1] += 1e3 * (time.perf_counter() - now[1])

        gc.callbacks.append(on_gc)
        t_end = time.perf_counter() + seconds
        k = 0
        try:
            while time.perf_counter() < t_end:
                name, cls, tracer = codes[(k // block) % len(codes)]
                sol.__class__, sol.tracer = cls, tracer
                now[0] = name
                w0 = time.perf_counter()
                rows.append(sol.ingest(states[k % 2]))
                sol.plan()
                wall[name].append(1e6 * (time.perf_counter() - w0))
                k += 1
        finally:
            gc.callbacks.remove(on_gc)
            sol.__class__, sol.tracer = DistributedAssignmentSolver, None
        return wall, coll

    def cost(a, b, block, res):
        wall, coll = res
        return {"us": difference(wall[a], wall[b], block),
                "round_us": {c: summary(wall[c]) for c in wall},
                "collections_count_ms": coll}

    # off against the parent: the code turns over every two rounds, so
    # each sees A and B; the tracer's collections would land in whichever
    # round comes next, so on against off runs apart, in blocks
    costs = {}
    if parent is not None:
        costs["off-parent"] = cost("parent", "off", 2, turns(
            [("parent", parent, None), ("off", DistributedAssignmentSolver,
                                         None)], args.seconds / 2, 2))
    costs["on-off"] = cost("off", "on", 40, turns(
        [("off", DistributedAssignmentSolver, None),
         ("on", DistributedAssignmentSolver, on)],
        args.seconds / 2 if parent is not None else args.seconds, 40))
    gc.unfreeze()
    out = {
        "device": args.device, "card": card_label(args.device),
        "servers": S, "requesters": conf["max_requesters"],
        "seed": args.seed, "split": split,
        "ab_rows_changed_per_round": statistics.fmean(rows),
        "cost_us": costs,
        "on_events": len(on.events), "dropped": on.dropped,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
