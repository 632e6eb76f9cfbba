"""Time chip_smoke.py's phase-11 world (the durable planned world) with its
write-ahead log and its spill tier each on or off: the world's wall, rank
0's ``iput`` loop and the ``flush_puts`` that waits for its last acks, the
units consumed before rank 0's checkpoint, the device solves made before
it, the spilled share, the WAL's group commits, and the calls and
host-clock seconds of the servers' spill check (``Server._maybe_spill``,
which pops its victims above the watermark from the queue's resident
index).

    python3 scripts/durable_world.py [--modes wal+spill,spill,wal,none,pyq]
                                     [--after-failover] [--device cuda|cpu]
                                     [--profile-hz HZ]
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
without a card. ``--profile-hz`` runs the servers' sampling profiler
(``Config(profile_hz)``, ``obs/profile.py``) and adds to each line the
server reactors' samples by tick phase and their heaviest innermost
frames (``reactor_phases``, ``reactor_frames``).
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
    from adlb_tpu_torch.obs import profile
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

    profiles = []
    stop_profile = profile.stop

    def kept_stop(p):
        if p is not None:
            profiles.append(p.snapshot())
        stop_profile(p)

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
        if args.profile_hz:
            cfg = dataclasses.replace(cfg, profile_hz=args.profile_hz)
        app = functools.partial(chip_smoke.checkpoint_app, nunits=args.units,
                                prefix=f"{tmp}/pool", pad=60, hold_s=2.0)
        spill.SpillStore.put = counted_put
        wal.WriteAheadLog._sync = timed_sync
        server.Server._maybe_spill = timed_scan
        profile.stop = kept_stop
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
            profile.stop = stop_profile
    _, captured, timings = res.app_results[0]
    counts = solve.planner_counts()
    phases, frames = {}, {}
    for snap in profiles:
        for stack, n in snap["stacks"].items():
            parts = stack.split(";")
            if parts[0] != "reactor":
                continue
            phase = parts[1] if parts[1].startswith("phase:") else "-"
            phases[phase] = phases.get(phase, 0) + n
            frames[parts[-1]] = frames.get(parts[-1], 0) + n

    def top(d, k=15):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])
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
        **({"reactor_phases": top(phases), "reactor_frames": top(frames)}
           if args.profile_hz else {}),
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
    ap.add_argument("--profile-hz", type=float, default=0.0,
                    help="sample the server reactors at this rate")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("durable_world: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from adlb_tpu_torch.balancer import greedy_sweep
    from adlb_tpu_torch.balancer.cuda_build import card_label

    args.card = "cpu"
    if args.device == "cuda":
        args.card = card_label()
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
