"""Planning-latency sweep for the sharded balancer.

Measures the full planning round — snapshot-delta ingest -> sharded
solve -> plan extracted on host — of :class:`DistributedAssignmentSolver`
with its task table cut into ``nshards`` shards on one device, at a ladder
of world sizes up to 10,000 servers / 1M parked requesters. Steady state is
engine-faithful: every round ships task deltas for a handful of servers,
the previous round's plan is consumed by the data plane (matched tasks
leave their queues, matched requesters unpark), and stamps ride the
snapshots so the solver's unchanged-server fast path is exercised the way
the engine drives it.

With ``check_host=True`` a second solver on the ``auction="host"`` tier
ingests the same snapshots every round, and each round's pair list must
equal the measured tier's exactly.

    python -m adlb_tpu_torch.balancer.plan_bench [--quick] [--nshards 8]
        [--device cuda|cpu] [--auction device|host] [--check-host]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: (servers, max_tasks K, max_requesters R) ladder; the last row is the
#: acceptance scale: 10,000 servers x 100 parked requesters each = 1M
#: (--quick keeps the first, 1k and 10k rows)
SCALES = [(64, 16, 16), (256, 16, 32), (1000, 16, 100), (10000, 16, 100)]
TYPES = tuple(range(1, 9))
DELTA_SERVERS = 8  # servers receiving a task burst per steady round


def _mk_reqs(rng, s, R):
    return [
        (s * 200 + i, i + 1, [int(rng.integers(1, len(TYPES) + 1))])
        for i in range(R)
    ]


def run_sweep(scales=None, reps: int = 40, nshards: int = 8,
              rounds: int = 16, auction: str = "device",
              device: str = "cuda", check_host: bool = False,
              on_row=None) -> dict:
    """Returns the result dict. ``on_row(solver, row)``, when given, is
    called with each row's measured solver after the row is done."""
    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver,
    )

    rows = []
    for S, K, R in scales or SCALES:
        rng = np.random.default_rng(S)

        def make(tier):
            return DistributedAssignmentSolver(
                TYPES, K, R, nshards=nshards, rounds=rounds,
                servers_per_shard=-(-S // nshards), auction=tier,
                device=device,
            )

        solver = make(auction)
        twin = make("host") if check_host else None
        clock = [1.0]

        def stamp():
            clock[0] += 1.0
            return clock[0]

        snaps = {}
        for s in range(S):
            st = stamp()
            snaps[100 + s] = {
                "tasks": [], "reqs": _mk_reqs(rng, s, R),
                "stamp": st, "task_stamp": st,
            }
        t0 = time.perf_counter()
        solver.ingest(snaps)
        cold_ingest_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        solver.plan()
        first_plan_ms = (time.perf_counter() - t0) * 1e3
        if twin is not None:
            twin.ingest(snaps)
            twin.plan()

        seq = [10**6]

        def add_tasks(sv, n):
            snap = snaps[sv]
            burst = [
                (seq[0] + i, int(rng.integers(1, len(TYPES) + 1)),
                 int(rng.integers(-50, 50)), 64)
                for i in range(n)
            ]
            seq[0] += n
            snap["tasks"] = sorted(
                snap["tasks"] + burst, key=lambda t: -t[2])[:K]
            snap["task_stamp"] = stamp()

        lat, twin_lat, npairs, split = [], [], [], []
        rq = [10**7]
        for it in range(reps):
            for d in range(DELTA_SERVERS):
                add_tasks(100 + (it * DELTA_SERVERS + d) % S, K)
            t0 = time.perf_counter()
            solver.ingest(snaps)
            pairs = solver.plan()
            lat.append((time.perf_counter() - t0) * 1e3)
            npairs.append(len(pairs))
            split.append((solver.last_ingest_ms, solver.last_solve_ms,
                          solver.last_extract_ms))
            if twin is not None:
                t0 = time.perf_counter()
                twin.ingest(snaps)
                twin_pairs = twin.plan()
                twin_lat.append((time.perf_counter() - t0) * 1e3)
                if twin_pairs != pairs:
                    raise AssertionError(
                        f"{S} servers, round {it}: the {auction} tier's "
                        f"{len(pairs)} pairs differ from the host tier's "
                        f"{len(twin_pairs)}")
            # the data plane consumes the plan; a served worker computes,
            # then re-parks (fresh rqseqno) — the pool stays at scale
            touched: dict = {}
            for holder, seqno, req_home, for_rank, rqseqno in pairs:
                touched.setdefault(holder, set()).add(seqno)
                rs = snaps[req_home]
                rq[0] += 1
                rs["reqs"] = [
                    r for r in rs["reqs"]
                    if not (r[0] == for_rank and r[1] == rqseqno)
                ] + [(for_rank, rq[0],
                      [int(rng.integers(1, len(TYPES) + 1))])]
                rs["stamp"] = stamp()
            for h, seqs in touched.items():
                hs = snaps[h]
                hs["tasks"] = [
                    t for t in hs["tasks"] if t[0] not in seqs]
                hs["task_stamp"] = stamp()
        # warm full sweep of the host tier's candidate lists
        t0 = time.perf_counter()
        solver._sweep()
        warm_sweep_ms = (time.perf_counter() - t0) * 1e3

        def pct(v, p):
            v = sorted(v)
            return v[min(int(p * len(v)), len(v) - 1)]

        row = {
            "servers": S, "K": K, "R": R, "parked_reqs": S * R,
            "plan_round_p50_ms": pct(lat, 0.50),
            "plan_round_p90_ms": pct(lat, 0.90),
            "plan_round_p99_ms": pct(lat, 0.99),
            "plan_round_max_ms": max(lat),
            # the round's median split: snapshot-delta ingest, the solve
            # (device plan or host auction) and pair extraction
            "ingest_p50_ms": float(np.median([x[0] for x in split])),
            "solve_p50_ms": float(np.median([x[1] for x in split])),
            "extract_p50_ms": float(np.median([x[2] for x in split])),
            "pairs_per_round_p50": int(np.median(npairs)),
            "pairs_total": int(sum(npairs)),
            "device_sweep_ms": warm_sweep_ms,
            "sweeps": solver.sweep_count,
            "cold_ingest_ms": cold_ingest_ms,
            "first_plan_ms": first_plan_ms,
            "plans": solver.solve_count,
        }
        if twin is not None:
            row["host_tier_p50_ms"] = pct(twin_lat, 0.50)
            row["host_tier_p99_ms"] = pct(twin_lat, 0.99)
            row["rounds_equal_to_host_tier"] = reps
        rows.append(row)
        print(
            f"plan-sweep {S:5d} servers x {R:4d} reqs "
            f"({S*R} parked): p50 {row['plan_round_p50_ms']:7.2f} ms  "
            f"p99 {row['plan_round_p99_ms']:7.2f} ms  "
            f"pairs/round {row['pairs_per_round_p50']}  "
            f"sweep {row['device_sweep_ms']:.1f} ms (x{row['sweeps']})"
        )
        if on_row is not None:
            on_row(solver, row)
    out = {
        "metric": "plan_round_latency",
        "nshards": nshards,
        "device": device,
        "rounds": rounds,
        "auction": auction,
        "delta_servers_per_round": DELTA_SERVERS,
        "rows": rows,
        "note": (
            "full planning round (snapshot-delta ingest -> sharded solve "
            "-> plan extracted on host) with the task table cut into "
            "nshards shards on one device; steady state is "
            "engine-faithful (plans consumed, stamps ride snapshots). "
            "device_sweep_ms is the host tier's full re-sweep (candidates "
            "of every shard on the device, merge on the host), paid at "
            "cold start / large deltas / every RESYNC_INTERVAL plans; the "
            "device tier regenerates its candidates every plan."
        ),
    }
    for r in rows:
        if r["servers"] == 1000:
            out["plan_round_1k_ms"] = r["plan_round_p50_ms"]
        elif r["servers"] == 10000:
            out["plan_round_10k_ms"] = r["plan_round_p50_ms"]
    return out


#: engine-round overhead ladder: (servers, tasks-per-supply-server,
#: reqs-per-server) — parked totals 1k / 10k / 100k
ENGINE_SCALES = [(1000, 16, 1), (1000, 16, 10), (1000, 16, 100)]
SUPPLY_SERVERS = 64  # servers holding queued inventory (cross demand)


class _NullSolver:
    """Measures ENGINE-side admission only: accepts either input shape
    and plans nothing (the solve itself is plan_round_1k_ms's job)."""

    SUPPORTS_VIEW = True

    def solve(self, snapshots, world) -> list:
        return []


def run_engine_sweep(scales=None, reps: int = 40) -> dict:
    """engine.round() overhead at 1k/10k/100k parked requesters, array
    ledger vs the pure-Python twin (the pre-vectorization cost), on a
    steady state that stamps DELTA_SERVERS fresh snapshots per round —
    the O(changed rows) path the resident ledger exists for. Needs no
    devices (null solver): this isolates admission — ledger filter,
    suppression, cross-feasibility gate, pump pre-check, solver-input
    packing — from the solve."""
    import time as _time

    from adlb_tpu_torch.balancer.engine import PlanEngine
    from adlb_tpu_torch.balancer.ledger import SnapshotStore

    rows = []
    for S, K, R in scales or ENGINE_SCALES:
        row = {"servers": S, "parked_reqs": S * R}
        for ledger in ("array", "py"):
            rng = np.random.default_rng(S * R)
            eng = PlanEngine(
                types=TYPES, max_tasks=K, max_requesters=max(R, 4),
                host_ledger=ledger, device="cpu",
            )
            eng.solver = _NullSolver()
            seq = [10**6]
            # the array arm is driven the way the runtime drives it: a
            # versioned SnapshotStore, so the ledger sync touches only
            # the DELTA_SERVERS re-stamped ranks per round instead of
            # comparing all S snapshots. The py twin keeps the plain
            # dict — it re-derives everything per round by definition.
            snaps: dict = SnapshotStore() if ledger == "array" else {}
            t0 = _time.monotonic()
            for s in range(S):
                tasks = []
                if s < SUPPLY_SERVERS:
                    tasks = [
                        (seq[0] + i, int(rng.integers(1, len(TYPES) + 1)),
                         int(rng.integers(-50, 50)), 64)
                        for i in range(K)
                    ]
                    seq[0] += K
                # reqs park on NON-supply servers: cross-server demand,
                # so every round admits the solve (the representative
                # steady state for a serving fleet; consumers stay 0 so
                # the pump never fires — its walk is measured by the
                # hotspot benches)
                reqs = _mk_reqs(rng, s, R) if s >= SUPPLY_SERVERS else []
                snaps[100 + s] = {
                    "tasks": tasks, "reqs": reqs, "consumers": 0,
                    "stamp": t0, "task_stamp": t0,
                }
            lat = []
            rq = [10**7]
            for it in range(max(reps, 4)):
                t1 = _time.perf_counter()
                eng.round(snaps, None)
                dt = (_time.perf_counter() - t1) * 1e6
                if it >= 3:  # first rounds pay allocation/registration
                    lat.append(dt)
                # steady state: a handful of servers re-stamp with fresh
                # parks (everything else rides the unchanged fast path)
                t2 = _time.monotonic()
                for d in range(DELTA_SERVERS):
                    s = SUPPLY_SERVERS + (
                        (it * DELTA_SERVERS + d) % (S - SUPPLY_SERVERS))
                    snap = snaps[100 + s]
                    rq[0] += 1
                    snap["reqs"] = list(snap["reqs"][1:]) + [
                        (s * 200, rq[0],
                         [int(rng.integers(1, len(TYPES) + 1))])
                    ]
                    snap["stamp"] = t2
                    if ledger == "array":
                        snaps.bump(100 + s)  # in-place re-stamp
            lat.sort()
            p50 = lat[len(lat) // 2]
            key = "engine_round_us" if ledger == "array" \
                else "engine_round_py_us"
            row[key] = round(p50, 1)
            if ledger == "array":
                led = eng._ledger
                # the fast path must actually be taken: patches happened,
                # and NOT MORE than the workload explains — cold start
                # builds 2 columns per server, each steady round rebuilds
                # the DELTA_SERVERS re-stamped servers' req columns (a
                # change-key bug that silently rebuilt the world every
                # round would blow straight through this bound), plus a
                # full-resync allowance; full rebuilds only at cadence
                assert led.patch_count > 0, "ledger fast path never taken"
                budget = (
                    2 * S + (max(reps, 4) + 1) * 2 * DELTA_SERVERS
                    + led.resync_count * 2 * S
                )
                assert led.patch_count <= budget, (
                    f"fast path lost: {led.patch_count} patches > "
                    f"{budget} explained by the workload")
                assert led.resync_count <= reps // led.LEDGER_RESYNC_INTERVAL + 1, (
                    led.resync_count)
                # the O(Δ) steady-state claim, reason-labelled: after
                # the one cold full pass, full walks happen ONLY at the
                # cadence resync — a membership-classified walk here
                # would mean the store fast path was never engaged
                assert led.resync_reasons.get("cold", 0) <= 1, (
                    led.resync_reasons)
                assert led.resync_reasons.get("membership", 0) == 0, (
                    f"steady state paid membership walks: "
                    f"{led.resync_reasons}")
                row["ledger_patches"] = led.patch_count
                row["ledger_resyncs"] = led.resync_count
                row["ledger_resync_reasons"] = {
                    k: v for k, v in led.resync_reasons.items() if v}
                row["ledger_rows"] = led.rows_resident()
        row["speedup"] = round(row["engine_round_py_us"]
                               / max(row["engine_round_us"], 1e-9), 1)
        rows.append(row)
        print(
            f"engine-round {row['parked_reqs']:6d} parked: array p50 "
            f"{row['engine_round_us']:9.1f} us  py twin "
            f"{row['engine_round_py_us']:9.1f} us  "
            f"({row['speedup']}x, {row['ledger_patches']} patches, "
            f"{row['ledger_resyncs']} resyncs)"
        )
    out = {
        "metric": "engine_round_overhead",
        "delta_servers_per_round": DELTA_SERVERS,
        "rows": rows,
        "note": (
            "engine.round() admission overhead (ledger filter + "
            "suppression + cross gate + pump pre-check + solver-input "
            "packing; null solver, so the solve itself is excluded) on "
            "a steady state re-stamping DELTA_SERVERS snapshots per "
            "round. engine_round_us = array-resident host ledger "
            "(balancer/ledger.py), engine_round_py_us = the retained "
            "pure-Python twin. The array arm runs on a versioned "
            "SnapshotStore, as the runtime does."
        ),
    }
    for r in rows:
        if r["parked_reqs"] == 1000:
            out["admission_1k_ms"] = round(r["engine_round_us"] / 1e3, 3)
        elif r["parked_reqs"] == 100000:
            out["engine_round_us_100k"] = r["engine_round_us"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer reps, smallest+largest scales only")
    ap.add_argument("--nshards", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the solver's device: cuda (the card) or cpu")
    ap.add_argument("--auction", choices=("device", "host"),
                    default="device",
                    help="sharded-solver auction tier to measure "
                         "(host = the retained reference twin)")
    ap.add_argument("--check-host", action="store_true",
                    help="run the host tier beside the measured one and "
                         "require equal pair lists every round")
    ap.add_argument("--engine-rounds", action="store_true",
                    help="measure engine.round admission overhead "
                         "(host-ledger ladder) instead of the planning "
                         "sweep; needs no devices")
    args = ap.parse_args(argv)

    if args.engine_rounds:
        scales = (
            [ENGINE_SCALES[0], ENGINE_SCALES[-1]] if args.quick
            else ENGINE_SCALES
        )
        out = run_engine_sweep(scales=scales, reps=20 if args.quick else 40)
    else:
        scales = [SCALES[0], SCALES[2], SCALES[-1]] if args.quick else SCALES
        out = run_sweep(scales=scales, reps=20 if args.quick else 40,
                        nshards=args.nshards, auction=args.auction,
                        device=args.device, check_host=args.check_host)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
