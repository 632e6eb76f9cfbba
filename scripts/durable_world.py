"""Time chip_smoke.py's phase-11 world (the durable planned world) with its
write-ahead log and its spill tier each on or off: the world's wall, rank
0's ``iput`` loop and the ``flush_puts`` that waits for its last acks, the
units consumed before rank 0's checkpoint, the device solves made before
it, the spilled share, the WAL's group commits, and the calls and
host-clock seconds of the servers' spill check (``Server._maybe_spill``,
which scans the queue for victims above the watermark).

    python3 scripts/durable_world.py [--modes wal+spill,spill,wal,none,pyq]
                                     [--after-failover] [--device cuda|cpu]
                                     [--units N] [--apps N] [--servers N]
                                     [--max-tasks N] [--max-requesters N]

Each mode runs the first world of phase 11 (``chip_smoke.checkpoint_app``
under ``chip_smoke.durable_config``) once: ``wal+spill`` is phase 11's
configuration, ``spill`` turns the WAL off, ``wal`` the spill tier (and
with it the Python queue the spill tier forces), ``none`` both, and
``pyq`` turns both off but keeps the Python queue (``native_queues=
"off"``), to tell the spill check's cost from the queue's.
``--after-failover`` then runs phase 10's world (``chip_smoke.
run_master_failover``) and phase 11's configuration once more in the same
process, to tell a cost of the configuration from one that earlier
phases leave behind. Prints one JSON line per world, the card's name and
power limit in each. ``--device cpu`` with small sizes rehearses it
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_world(chip_smoke, mode: str, args) -> dict:
    from adlb_tpu_torch import run_world
    from adlb_tpu_torch.balancer import greedy_sweep, solve
    from adlb_tpu_torch.runtime import server, spill, wal

    spilled, syncs, scans = [], [], []
    put, sync = spill.SpillStore.put, wal.WriteAheadLog._sync
    scan = server.Server._maybe_spill

    def counted_put(store, seqno, blob):
        spilled.append(seqno)
        return put(store, seqno, blob)

    def timed_sync(log):
        t = time.perf_counter()
        out = sync(log)
        syncs.append(time.perf_counter() - t)
        return out

    def timed_scan(srv, *a, **k):
        t = time.perf_counter()
        out = scan(srv, *a, **k)
        scans.append(time.perf_counter() - t)
        return out

    threads = threading.active_count()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.durable_config(args.device, tmp, args.units,
                                        args.max_tasks, args.max_requesters)
        if "wal" not in mode:
            cfg = dataclasses.replace(cfg, wal_dir=None)
        if "spill" not in mode:
            cfg = dataclasses.replace(cfg, spill_dir=None)
        if "pyq" in mode:
            cfg = dataclasses.replace(cfg, native_queues="off")
        app = functools.partial(chip_smoke.checkpoint_app, nunits=args.units,
                                prefix=f"{tmp}/pool", pad=60, hold_s=2.0)
        spill.SpillStore.put = counted_put
        wal.WriteAheadLog._sync = timed_sync
        server.Server._maybe_spill = timed_scan
        greedy_sweep.reset_counts()
        solve.reset_counts()
        try:
            t0 = time.perf_counter()
            res = run_world(num_app_ranks=args.apps, nservers=args.servers,
                            types=chip_smoke.MAIN_TYPES
                            + (chip_smoke.MAIN_ANSWER,),
                            app_fn=app, cfg=cfg, timeout=600)
            wall = time.perf_counter() - t0
        finally:
            spill.SpillStore.put = put
            wal.WriteAheadLog._sync = sync
            server.Server._maybe_spill = scan
    _, captured, timings = res.app_results[0]
    counts = solve.planner_counts()
    return {
        "mode": mode, "card": args.card,
        "threads_at_start": threads, "units": args.units,
        "apps": args.apps, "servers": args.servers, "wall_s": wall,
        "put_s": timings["put_s"],
        "puts_per_s": args.units / timings["put_s"],
        "flush_s": timings["flush_s"],
        "consumed": sum(len(v) for r, v in res.app_results.items() if r),
        "captured": captured, "solves_at_ckpt": timings["solves_at_ckpt"],
        "spilled_share": len(spilled) / args.units,
        "group_commits": len(syncs), "fsync_s_total": sum(syncs),
        "spill_checks": len(scans), "spill_check_s_total": sum(scans),
        "device_solves": counts["device_solves"],
        "greedy_sweep_launches": counts["greedy_sweep_launches"],
        "solves_checked": counts["solves_checked"],
        "solves_wrong": counts["solves_wrong"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="wal+spill,spill,wal,none,pyq")
    ap.add_argument("--after-failover", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--units", type=int, default=10_000)
    ap.add_argument("--apps", type=int, default=64)
    ap.add_argument("--servers", type=int, default=16)
    ap.add_argument("--max-tasks", type=int, default=4096)
    ap.add_argument("--max-requesters", type=int, default=512)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("durable_world: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from adlb_tpu_torch.balancer import greedy_sweep

    args.card = "cpu"
    if args.device == "cuda":
        args.card = chip_smoke.card_label()
        greedy_sweep.build()
    chip_smoke.keep_solves()
    for mode in args.modes.split(","):
        print(json.dumps(one_world(chip_smoke, mode, args)), flush=True)
    if args.after_failover:
        chip_smoke.run_master_failover(greedy_sweep, print,
                                       device=args.device, nunits=args.units,
                                       napps=args.apps, nservers=args.servers,
                                       max_tasks=args.max_tasks,
                                       max_requesters=args.max_requesters,
                                       min_solves=50 if args.device == "cuda"
                                       else 5)
        print(json.dumps({**one_world(chip_smoke, "wal+spill", args),
                          "after": "phase 10"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
