"""Planning-latency sweep for the sharded balancer.

Measures the full planning round — snapshot-delta ingest -> sharded
solve -> plan extracted on host — of :class:`DistributedAssignmentSolver`
with its task table cut into shards, one per card with ``--ndev n`` (the
first n cards, round-robin when fewer are visible; the JAX package's
``--ndev`` mesh) or ``--nshards`` logical shards on one device, at a ladder
of world sizes up to 10,000 servers / 1M parked requesters. Steady state is
engine-faithful: every round ships task deltas for a handful of servers,
the previous round's plan is consumed by the data plane (matched tasks
leave their queues, matched requesters unpark), and stamps ride the
snapshots so the solver's unchanged-server fast path is exercised the way
the engine drives it.

With ``check_host=True`` a second solver on the ``auction="host"`` tier
ingests the same snapshots every round, and each round's pair list and
assignment array must equal the measured tier's exactly; with
``check_logical=True`` (across cards) so must those of a solver on the same
tier with the same number of logical shards on the planning device.

    python -m adlb_tpu_torch.balancer.plan_bench [--quick]
        [--nshards 8 | --ndev 8] [--device cuda|cpu]
        [--auction device|host] [--check-host] [--check-logical]
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
              on_row=None, devices=None, check_logical: bool = False,
              merge_route=None, warm: bool = False) -> dict:
    """Returns the result dict. ``devices`` places one shard on each entry
    (``nshards`` is then ``len(devices)``; ``device`` plans; ``merge_route``
    forces the measured solver's merge route across them). ``warm`` builds
    the measured solver's device state before its first ingest, as the
    engine does (``warm_ms``); otherwise the first ingest builds it.
    ``on_row(solver, row)``, when given, is called with each row's measured
    solver after the row is done."""
    from adlb_tpu_torch.balancer.distributed import (
        DistributedAssignmentSolver,
    )

    if devices is not None:
        nshards = len(devices)
    rows = []
    for S, K, R in scales or SCALES:
        rng = np.random.default_rng(S)

        def make(tier, devs=devices, route=None):
            return DistributedAssignmentSolver(
                TYPES, K, R, nshards=nshards, rounds=rounds,
                servers_per_shard=-(-S // nshards), auction=tier,
                device=device, devices=devs, merge_route=route,
            )

        solver = make(auction, route=merge_route)
        warm_ms = None
        if warm:
            t0 = time.perf_counter()
            solver.warm()
            warm_ms = (time.perf_counter() - t0) * 1e3
        twins = {}
        if check_host:
            twins["host_tier"] = make("host")
        if check_logical:
            twins["logical"] = make(auction, None)
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
        for twin in twins.values():
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

        lat, npairs, split = [], [], []
        twin_lat = {name: [] for name in twins}
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
            for name, twin in twins.items():
                t0 = time.perf_counter()
                twin.ingest(snaps)
                twin_pairs = twin.plan()
                twin_lat[name].append((time.perf_counter() - t0) * 1e3)
                if twin_pairs != pairs or not np.array_equal(
                        twin.last_assigned, solver.last_assigned):
                    raise AssertionError(
                        f"{S} servers, round {it}: the {auction} tier's "
                        f"{len(pairs)} pairs or its assignment differ from "
                        f"the {name.replace('_', ' ')}'s "
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
            "ingest_p99_ms": pct([x[0] for x in split], 0.99),
            "solve_p99_ms": pct([x[1] for x in split], 0.99),
            "extract_p99_ms": pct([x[2] for x in split], 0.99),
            "pairs_per_round_p50": int(np.median(npairs)),
            "pairs_total": int(sum(npairs)),
            "device_sweep_ms": warm_sweep_ms,
            "sweeps": solver.sweep_count,
            "warm_ms": warm_ms,
            "cold_ingest_ms": cold_ingest_ms,
            "first_plan_ms": first_plan_ms,
            "plans": solver.solve_count,
        }
        for name, twin in twins.items():
            row[f"{name}_p50_ms"] = pct(twin_lat[name], 0.50)
            row[f"{name}_p99_ms"] = pct(twin_lat[name], 0.99)
            row[f"rounds_equal_to_{name}"] = reps
            row[f"{name}_sweeps"] = twin.sweep_count
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
        "devices": None if devices is None else [str(d) for d in devices],
        "device": device,
        "rounds": rounds,
        "auction": auction,
        "delta_servers_per_round": DELTA_SERVERS,
        "rows": rows,
        "note": (
            "full planning round (snapshot-delta ingest -> sharded solve "
            "-> plan extracted on host) with the task table cut into "
            "nshards shards, one per entry of devices (logical shards on "
            "one device when devices is null); steady state is "
            "engine-faithful (plans consumed, stamps ride snapshots). "
            "device_sweep_ms is the host tier's full re-sweep (candidates "
            "of every shard on its device, merge on the host), paid at "
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
    ap.add_argument("--nshards", type=int, default=8,
                    help="logical shards on one device")
    ap.add_argument("--ndev", type=int, default=None,
                    help="one shard per card over n cards (round-robin "
                         "when fewer are visible; on --device cpu, n CPU "
                         "pieces)")
    ap.add_argument("--device", default="cuda",
                    help="the solver's device: cuda (the card) or cpu")
    ap.add_argument("--auction", choices=("device", "host"),
                    default="device",
                    help="sharded-solver auction tier to measure "
                         "(host = the retained reference twin)")
    ap.add_argument("--check-host", action="store_true",
                    help="run the host tier beside the measured one and "
                         "require equal pair lists every round")
    ap.add_argument("--check-logical", action="store_true",
                    help="with --ndev: run the same tier on as many logical "
                         "shards beside it and require equal plans")
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
        devices = None
        if args.ndev is not None:
            from adlb_tpu_torch.graft_entry import card_placement

            devices = (["cpu"] * args.ndev if args.device == "cpu"
                       else card_placement(args.ndev))
            print(f"plan-sweep placement: {[str(d) for d in devices]}")
        out = run_sweep(scales=scales, reps=20 if args.quick else 40,
                        nshards=args.nshards, auction=args.auction,
                        device=args.device, check_host=args.check_host,
                        devices=devices,
                        check_logical=args.check_logical)
        from adlb_tpu_torch.balancer import auction, candidates

        # the kernels' own counts over the sweep (0 on the CPU, where the
        # plain versions run)
        out["launches"] = {"shard_candidates": candidates.launches,
                           "merge": candidates.merge_launches,
                           "auction": auction.launches,
                           "gather_copies": candidates.gather_copies}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
