"""Plan engine: one balancer round over queue-state snapshots.

Pure planning — callers transport the results. Used by two hosts:

* the in-server balancer thread (Python servers, ``runtime/server.py``);
* the sidecar process driving the native C++ data plane
  (``balancer/sidecar.py``) — SURVEY §7's language split: C++ for the
  data plane, Python/JAX only for the balancer brain.

A round takes the latest per-server snapshots
``{server_rank: {"tasks": [(seqno, type, prio, len)...],
"reqs": [(rank, rqseqno, types|None)...], "nbytes": int, "consumers": int,
"stamp": float}}`` and returns

* ``matches`` — ``(holder, seqno, req_home, for_rank, rqseqno)`` tuples:
  cross-server task->requester assignments from the batched solve;
* ``migrations`` — ``(src, dest, [seqnos], mig_id)``: fair-share inventory
  moves so each server holds its consumer-weighted share of the global
  pool (the global solve's structural advantage over per-unit stealing
  round trips). ``mig_id`` is the planner's batch id; the transport must
  deliver it with the batch so the destination can acknowledge it in
  later snapshots (``mig_acks``).

Re-planning storms are suppressed by remembering when each requester/task
was last planned: both stay ineligible until a *fresh* snapshot (stamp
newer than the plan) shows them still parked/queued. Plan staleness is
compensated at enactment (holders validate against live state).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from adlb_tpu_torch.balancer.jobdim import req_job, task_job

# Plan-age samples: for every round that produced output, the age of the
# OLDEST snapshot the plan was computed from (seconds between that
# state's capture and the plan being handed to the transport). This is
# the end-to-end staleness the snapshot->solve->enact pipeline delivers —
# the quantity the reference's design fixes at qmstat_interval x ring
# hops (reference src/adlb.c:165,1705-1757) and this architecture keeps
# event-driven. Module-level so benches can read it across whichever
# engines (in-server threads, sidecar) a world spawned in-process.
_PLAN_AGES: "collections.deque[float]" = collections.deque(maxlen=4096)


def drain_plan_ages() -> list:
    out = list(_PLAN_AGES)
    _PLAN_AGES.clear()
    return out


def round_gap(min_gap: float, matches, migrations) -> float:
    """Inter-round sleep for a balancer loop (in-proc thread AND sidecar):
    rate-limit idle churn at the full gap, but keep plan-bearing rounds
    coming fast (startup fill, end-game drain) — a full-gap sleep after a
    match round adds the whole gap to every handoff's latency for
    nothing; the ledger suppression already prevents re-planning storms."""
    return min_gap * 0.25 if (matches or migrations) else min_gap


def shard_placement(device: str, count: int,
                    nservers: Optional[int]) -> tuple:
    """Where ``PlanEngine(use_mesh=True)`` puts the sharded planner's shards
    when no ``nshards`` is asked for: one shard per card, ``(devices,
    servers_per_shard)`` with ``devices = [cuda:0, ..., cuda:count-1]`` and
    ``ceil(nservers / count)`` servers a shard (the JAX engine's
    ``servers_per_device``). ``(None, 1)`` — the single-device solver — on
    one card or on the CPU, as the JAX package plans on one chip."""
    if torch.device(device).type != "cuda" or count < 2:
        return None, 1
    return ([torch.device("cuda", i) for i in range(count)],
            _servers_per_shard(nservers, count))


def _servers_per_shard(nservers: Optional[int], nshards: int) -> int:
    return -(-nservers // nshards) if nservers and nservers > nshards else 1


class PlanEngine:
    def __init__(
        self,
        types,
        max_tasks: int,
        max_requesters: int,
        backend: str = "auto",
        max_malloc_per_server: float = 0.0,
        use_mesh: bool = False,
        nservers: Optional[int] = None,
        host_threshold_reqs: Optional[int] = None,
        lookahead: Optional[int] = None,
        look_max: Optional[int] = None,
        grow_window: Optional[float] = None,
        inflow_ttl: Optional[float] = None,
        inflow_min_age: Optional[float] = None,
        host_ledger: str = "array",
        auction: str = "device",
        max_jobs: int = 1,
        job_weights: Optional[dict] = None,
        metrics=None,
        device: str = "cuda",
        nshards: Optional[int] = None,
        devices: Optional[list] = None,
        tracer=None,
    ) -> None:
        from adlb_tpu_torch.balancer.solve import AssignmentSolver

        # multi-job planning (balancer/jobdim.py): how many namespaces
        # the solvers/ledger plan (1 = historical job-0-only, exact),
        # and the live fair-share weights the packers fold into the
        # assignment score as priority biases
        self.max_jobs = max(int(max_jobs), 1)
        self.base_types = tuple(types)
        self._job_weights = dict(job_weights) if job_weights else {}

        # optional obs registry (adlb_tpu_torch/obs/metrics.py): round duration,
        # plan age, and pairs/migrations emitted — attached by the
        # in-server balancer thread (and the sidecar, which owns its own)
        self.metrics = metrics
        # last-seen reason totals for the ledger's cadence resyncs and
        # the sharded solver's full shard re-sweeps; diffed per round so
        # /metrics carries monotone labelled counters (ledger_resyncs /
        # solver_resweeps) without the engine owning the source counts
        self._obs_resync: dict[str, int] = {}
        self._obs_resweep: dict[str, int] = {}

        self.solver = None
        if use_mesh:
            # the sharded planner (balancer/distributed.py): with no nshards,
            # the task table cut into one shard per visible card, each
            # resident on its card, planned on cuda:0 (shard_placement; one
            # card or the CPU plans on the single-device solver); with
            # nshards, that many logical shards on `device`; with devices, one
            # shard on each entry. Each card of a placement gets a CUDA
            # context in this process, here: across devices the solver is
            # warmed (pieces, workspaces, peer access, events) as the JAX
            # engine builds its mesh, so no planning round pays for it. A
            # construction or launch failure on any card propagates —
            # degrading to the single-device solver would hide it. The
            # tracer (runtime/trace.py, None: off) records its phases
            if devices is None and nshards is None:
                devices, _ = shard_placement(
                    device, torch.cuda.device_count()
                    if torch.device(device).type == "cuda" else 1, nservers)
            n = len(devices) if devices is not None else nshards or 1
            if n > 1:
                from adlb_tpu_torch.balancer.distributed import (
                    DistributedAssignmentSolver,
                )

                self.solver = DistributedAssignmentSolver(
                    types=tuple(types),
                    max_tasks_per_server=max_tasks,
                    max_requesters=max_requesters,
                    nshards=n,
                    servers_per_shard=_servers_per_shard(nservers, n),
                    auction=auction,
                    max_jobs=self.max_jobs,
                    job_weights=self._job_weights,
                    device=device,
                    devices=devices,
                    tracer=tracer,
                )
                if devices is not None:
                    self.solver.warm()
        if self.solver is None:
            kw = {}
            if host_threshold_reqs is not None:
                kw["host_threshold_reqs"] = host_threshold_reqs
            self.solver = AssignmentSolver(
                types=tuple(types),
                max_tasks=max_tasks,
                max_requesters=max_requesters,
                backend=backend,
                max_jobs=self.max_jobs,
                job_weights=self._job_weights,
                device=device,
                **kw,
            )
        self.max_malloc_per_server = max_malloc_per_server
        # per-instance overrides of the pump constants (Config knobs)
        if lookahead is not None:
            self.LOOKAHEAD = lookahead
        if look_max is not None:
            self.LOOK_MAX = look_max
        if grow_window is not None:
            self.LOOK_GROW_WINDOW = grow_window
        if inflow_ttl is not None:
            self.INFLOW_TTL = inflow_ttl
        if inflow_min_age is not None:
            self.INFLOW_MIN_AGE = inflow_min_age
        if self.INFLOW_MIN_AGE > self.INFLOW_TTL:
            raise ValueError("inflow_min_age must be <= inflow_ttl")
        if self.LOOK_MAX < max(1, self.LOOKAHEAD):
            raise ValueError("look_max must be >= max(1, lookahead)")
        # Plan ledgers: when each requester/task was last planned. The
        # HOST TIER keeps these and everything derived from them (the
        # per-round filter, suppression budgets, the cross-feasibility
        # gate, the pump pre-check, the solver's packed inputs) resident
        # in numpy columns (balancer/ledger.py, host_ledger="array",
        # default) so round admission costs O(changed rows); the
        # pure-Python twin ("py") is the retained reference semantics,
        # fuzz-proven identical by tests/test_ledger_parity.py. The
        # dicts below stay the authoritative mark store either way —
        # the array ledger's columns cache them via mutation hooks.
        if host_ledger not in ("array", "py"):
            raise ValueError(f"unknown host_ledger {host_ledger!r}")
        from adlb_tpu_torch.balancer.ledger import ArrayLedger, PyLedger, _Marks

        self._planned_reqs: dict[tuple, float] = {}
        self._planned_tasks: dict[tuple, float] = {}
        if host_ledger == "array":
            led = ArrayLedger(self, tuple(types), max_tasks, max_requesters,
                              max_jobs=self.max_jobs,
                              job_weights=self._job_weights)
            self._planned_reqs = _Marks(led.on_req_mark, led.on_req_mark)
            self._planned_tasks = _Marks(led.on_task_mark, led.on_task_mark)
            self._ledger = led
        else:
            self._ledger = PyLedger(self)
        # rank -> [(plan time, nunits, mig_id, src, frozenset(types))] for
        # migration batches en route there; until those units land they
        # are invisible in the
        # destination's inventory, and without crediting them the planner
        # chains phantom top-ups to a destination that is already being
        # fed. Clearing is EXACT when snapshots carry "mig_acks" (src ->
        # highest batch id received from that source): a credit whose id
        # is acked is visible in that snapshot's inventory, an unacked
        # one is still in flight — no transit-time heuristics needed.
        # Snapshots without the field (older planes) fall back to the
        # stamp/min-age window; the TTL backstop covers lost batches
        # either way.
        self._mig_next = 1  # batch-id counter (monotone per dest follows)
        self._planned_in: dict[int, list] = {}
        # rank -> last time OUR plan touched its ledger view (drives the
        # sharded solver's effective ingest stamps)
        self._rank_planned: dict[int, float] = {}
        # rank -> adaptive per-consumer lookahead window and the time it
        # last triggered a top-up (see LOOKAHEAD)
        self._look: dict[int, float] = {}
        self._look_last: dict[int, float] = {}
        self._last_pump = -1e9
        # rank -> last time a snapshot showed a requester actually parked
        # there (RAW reqs, not the ledger-filtered view) — the measured
        # "workers waited here recently" signal the anticipatory pump is
        # gated on (see _plan_migrations)
        self._last_parked: dict[int, float] = {}

    def set_job_weights(self, job_weights: Optional[dict]) -> bool:
        """Live fair-share update (controller / POST /jobs/<id>): fold
        the new biases into every packer twin — the ledger's resident
        columns (forced full rebuild) and the solver's own dict-path
        bias copy (cache flush where the packed prios embed it).
        Returns True when anything actually changed."""
        weights = dict(job_weights) if job_weights else {}
        if weights == self._job_weights:
            return False
        self._job_weights = weights
        changed = False
        if hasattr(self._ledger, "set_job_bias"):
            changed |= self._ledger.set_job_bias(weights)
        if hasattr(self.solver, "set_job_bias"):
            changed |= self.solver.set_job_bias(weights)
        return changed

    def force_host_path(self) -> None:
        """Plan on the numpy twin from here on. Kept for the JAX package's
        API; the port's balancer thread does not call it after a device
        failure — it aborts the world instead (runtime/server.py)."""
        self.solver.host_threshold_reqs = 10**9

    def _prune_credits(self, snapshots: dict, now: float) -> None:
        """Clear in-flight migration credits that this round's snapshots
        acknowledge (per-source ``mig_acks``), plus the TTL backstop and
        the legacy stamp/min-age fallback for ack-less planes. Runs once
        at the top of every round so BOTH the requester-suppression
        filter and the migration planner see clean credits."""
        if not self._planned_in:
            return
        horizon = now - self.INFLOW_TTL
        young = now - self.INFLOW_MIN_AGE
        for rank in list(self._planned_in):
            snap = snapshots.get(rank)
            if snap is None:
                # rank stopped appearing (ended server): TTL-only pruning
                kept = [e for e in self._planned_in[rank] if e[0] > horizon]
                if kept:
                    self._planned_in[rank] = kept
                else:
                    del self._planned_in[rank]
                continue
            tstamp = snap.get("task_stamp", snap.get("stamp", now))
            acks = snap.get("mig_acks")
            live = []
            for e in self._planned_in[rank]:
                ts, _n, mid, src, _types = e
                if ts <= horizon:
                    continue  # TTL backstop: the batch is lost
                if acks is not None:
                    if mid <= acks.get(src, 0):
                        continue  # landed: visible in this snapshot
                elif not (ts > tstamp or ts > young):
                    continue  # legacy stamp/min-age clearing
                live.append(e)
            if live:
                self._planned_in[rank] = live
            else:
                del self._planned_in[rank]

    def round(self, snapshots: dict, world=None):
        """One planning round; returns (matches, migrations)."""
        if not snapshots:
            return [], []
        now = time.monotonic()
        self._prune_credits(snapshots, now)
        led = self._ledger
        # incremental resident-state sync (array ledger: O(changed rows),
        # keyed on the same stamp/delta_seq/req_seq change keys the
        # sharded solver's ingest fast path uses; py twin: no-op)
        led.sync(snapshots, now)
        # raw-park recency, stamped with the SNAPSHOT's capture time, not
        # now: the master re-reads the same snapshot every round, and a
        # satisfied park must age out, not stay forever "recent". The
        # array ledger feeds the O(changed) rebuild events (a rank's
        # park stamp can only move when its snapshot did); the py twin
        # walks the snapshots like it always has.
        parked = led.parked_updates(now)
        if parked is None:
            parked = (
                (rank, snap.get("stamp", now))
                for rank, snap in snapshots.items() if snap["reqs"]
            )
        for rank, stamp in parked:
            if stamp > self._last_parked.get(rank, -1e9):
                self._last_parked[rank] = stamp
        # suppression budgets: only YOUNG credits (a lost batch must
        # not block per-unit matching for the whole 2 s TTL — it
        # stops suppressing after SUPPRESS_TTL and the solve takes
        # over), and at most as many requesters as there are units
        # in flight (a 1-unit batch must not park a whole pool)
        sup: dict = {}
        for rank, entries in self._planned_in.items():
            fed: set = set()
            budget = 0
            for e in entries:
                if e[0] > now - self.SUPPRESS_TTL:
                    fed |= e[4]
                    budget += e[1]
            if budget > 0 and fed:
                sup[rank] = (fed, budget)
        # requester-side ledger filter first (kept rows are few): rounds
        # run at event rate, so a round that can plan nothing must cost
        # O(changed rows), not O(world). A requester whose home server
        # has a live inflow credit covering a type it wants is suppressed
        # outright: the batch already in flight will match it LOCALLY
        # within milliseconds, and solving it too would both burn a
        # round's CPU and deliver a second unit via the expensive
        # per-unit remote-fetch path (the native-64-rank
        # regression: ~3.6k double-served matches per run).
        led.filter_reqs(snapshots, sup, now)
        have_reqs = led.have_reqs()
        # The solve's only useful output is CROSS-server pairs: same-server
        # pairs are dropped below (the data plane's immediate local matching
        # already covers them), so a round where no parked requester's
        # wanted type has supply on a *different* server can skip the solve
        # entirely. In saturated compute-bound worlds (nq/tsp/sudoku) nearly
        # every round is such a round — workers park only transiently
        # against local supply — and on a shared core every skipped solve
        # is cycles handed back to the workers. The gate reads RAW task
        # supply (no per-task ledger lookups): in-flight planned tasks can
        # over-admit a solve for one snapshot generation, which the
        # filtered solve input then corrects.
        cross = have_reqs and led.cross_feasible(snapshots)
        # The fair-share pump runs at most once per PUMP_INTERVAL AND
        # only when the cheap pre-check sees a plausible deficit:
        # deficits cannot change faster than batches land, and each pump
        # round walks every snapshot task (O(servers x K) — milliseconds
        # on wide worlds, stolen from the workers on a shared core).
        # Match-bearing rounds (cross demand) are never delayed, but
        # they no longer walk the pump unconditionally
        # either — in balanced scarce economies that walk was ~5% of
        # throughput for moves that never shipped.
        pump_due = False
        if now - self._last_pump >= self.PUMP_INTERVAL:
            # array ledger answers from resident aggregate columns; it
            # returns None when not synced with these snapshots (direct
            # unit-test calls) and the Python pre-check runs instead
            imb = led.maybe_imbalanced(self, snapshots)
            pump_due = self._maybe_imbalanced(snapshots) if imb is None \
                else imb
        if not cross and not pump_due:
            return [], []  # nothing plannable: skip the task-ledger walk
        if pump_due:
            self._last_pump = now
        # The solver consumes the ledger's resident arrays directly (the
        # "view": packed kept-requester masks + eligible-task rows, per-
        # server generation counters for the sharded solver's delta
        # ingest) — the legacy per-rank dict of filtered tuple lists is
        # materialized only for pump rounds (the migration planner walks
        # tuples) and for the py twin. Materialization happens BEFORE
        # the plan marks below so the pump sees the same pre-plan
        # filtered view it always did.
        view = led.view() if getattr(self.solver, "SUPPORTS_VIEW", False) \
            else None
        filtered = None
        if view is None or pump_due:
            filtered = self._materialize(snapshots, now)
        if cross:
            pairs = self.solver.solve(
                view if view is not None else filtered, world)
        else:
            pairs = []  # still consider migrations below
        t_planned = time.monotonic()
        matches = []
        planned_away: dict[int, set] = {}
        matched_reqs: set = set()
        for holder, seqno, req_home, for_rank, rqseqno in pairs:
            planned_away.setdefault(holder, set()).add(seqno)
            # local pairs are dropped (the data plane matches them), but
            # their unit already sits in planned_away — the requester is
            # spoken for either way, so withholding must skip it too
            matched_reqs.add((req_home, for_rank, rqseqno))
            if holder == req_home:
                continue
            self._planned_reqs[(req_home, for_rank, rqseqno)] = t_planned
            self._planned_tasks[(holder, seqno)] = t_planned
            self._rank_planned[holder] = t_planned
            self._rank_planned[req_home] = t_planned
            matches.append((holder, seqno, req_home, for_rank, rqseqno))
        migrations = []
        if pump_due:
            migrations = self._plan_migrations(
                snapshots, filtered, planned_away, t_planned, matched_reqs,
                now=now,
            )
        if matches or migrations:
            involved = (
                {h for h, *_ in matches}
                | {m[2] for m in matches}  # req_home: the demand side
                | {mv[0] for mv in migrations}
                | {mv[1] for mv in migrations}  # deficit side
            )
            ages = [
                t_planned - snapshots[r].get("stamp", t_planned)
                for r in involved
                if r in snapshots
            ]
            if ages:
                _PLAN_AGES.append(max(ages))
                if self.metrics is not None:
                    self.metrics.histogram("balancer_plan_age_s").observe(
                        max(ages)
                    )
        for src_rank, dest, _seqnos, _mid in migrations:
            self._rank_planned[src_rank] = t_planned
            self._rank_planned[dest] = t_planned
        if self.metrics is not None:
            dur = time.monotonic() - now
            self.metrics.histogram("balancer_round_s").observe(dur)
            # gauges for live scraping (/metrics): last planning-round
            # wall time, and the sharded solver's last device sweep
            self.metrics.gauge("balancer_round_ms").set(dur * 1e3)
            sweep = getattr(self.solver, "last_sweep_ms", None)
            if sweep is not None:
                self.metrics.gauge("solve_shard_ms").set(sweep)
            if led.is_array:
                # host-tier resident ledger: row count + last
                # incremental-sync cost (USERGUIDE §11 "host tier")
                self.metrics.gauge("ledger_rows").set(led.rows_resident())
                self.metrics.gauge("ledger_patch_us").set(
                    round(led.last_sync_us, 1))
            # O(Δ)-steady-state monitors: full ledger rebuilds and full
            # shard re-sweeps, labelled by why they happened. Emitted as
            # deltas of the source dicts so the counters stay monotone
            # across solver/ledger swaps (force_host_path).
            for fam, src, seen in (
                ("ledger_resyncs",
                 getattr(led, "resync_reasons", None), self._obs_resync),
                ("solver_resweeps",
                 getattr(self.solver, "sweep_reasons", None),
                 self._obs_resweep),
            ):
                if src:
                    for reason, total in src.items():
                        d = total - seen.get(reason, 0)
                        if d > 0:
                            self.metrics.counter(
                                fam, reason=reason).inc(d)
                            seen[reason] = total
            if matches:
                self.metrics.counter("balancer_pairs").inc(len(matches))
            if migrations:
                self.metrics.counter("balancer_migrations").inc(
                    len(migrations)
                )
                self.metrics.counter("balancer_migrated_units").inc(
                    sum(len(mv[2]) for mv in migrations)
                )
        # bound the memory of the plan ledgers (per-key deletes so the
        # array ledger's mark hooks keep its columns coherent)
        if len(self._planned_reqs) > 4096 or len(self._planned_tasks) > 4096:
            cutoff = t_planned - 5.0
            for d in (self._planned_reqs, self._planned_tasks):
                for k in [k for k, v in d.items() if v <= cutoff]:
                    del d[k]
        return matches, migrations

    def _materialize(self, snapshots: dict, now: float) -> dict:
        """The legacy filtered-snapshot dict (exact tuple lists), built
        from the ledger's kept/eligible row state. Task eligibility uses
        the task-side stamp: a reqs-only park snapshot must not
        re-eligibilize in-flight planned tasks. Stamps ride along so the
        sharded solver's tuple-path ingest can skip unchanged servers
        without diffing their lists (the single-device solver ignores
        the extra keys): event task deltas / dead-rank req patches
        mutate the snapshot in place WITHOUT a stamp bump (see
        server._merge_task_delta / _patch_snapshots_for_dead), and OUR
        own plans/migrations change the ledger-filtered view with no
        snapshot at all — the sequence numbers and the ledger stamp
        carry those changes. ledger_stamp is a SEPARATE field (never
        max()ed into the snapshot stamps): stamps are the SENDING
        host's monotonic clock while the ledger stamp is the planner's —
        ordering across the two domains is meaningless, and the solver
        only ever compares the key tuple for (in)equality."""
        led = self._ledger
        filtered = {}
        for rank, snap in snapshots.items():
            filtered[rank] = {
                "tasks": led.elig_tasks(rank),
                "reqs": led.kept_reqs(rank),
                "task_stamp": snap.get("task_stamp", snap.get("stamp", now)),
                "stamp": snap.get("stamp", now),
                "delta_seq": snap.get("delta_seq", 0),
                "req_seq": snap.get("req_seq", 0),
                "ledger_stamp": self._rank_planned.get(rank, -1.0),
            }
        return filtered

    def _cross_feasible(self, freqs: dict, snapshots: dict) -> bool:
        """True if some parked requester could be served from another
        server's inventory (the only matches the solve can contribute).
        Demand first (reqs are few), then scan tasks with an early exit —
        a round that can plan nothing must stay cheap even when queues
        are deep."""
        if self.max_jobs <= 1:
            demand: dict[int, set] = {}  # work type -> demander homes
            any_dem: set = set()  # homes of any-type requesters
            for r, reqs in freqs.items():
                for req in reqs:
                    if req[2] is None:
                        any_dem.add(r)
                    else:
                        for t in req[2]:
                            demand.setdefault(t, set()).add(r)
            if not demand and not any_dem:
                return False
            for rank, snap in snapshots.items():
                for t in snap["tasks"]:
                    dem = demand.get(t[1])
                    if dem and (len(dem) > 1 or rank not in dem):
                        return True
                    if any_dem and (
                        len(any_dem) > 1 or rank not in any_dem
                    ):
                        return True
            return False
        # Multi-job worlds: demand is keyed (job, type) — a requester
        # only ever matches units of its own namespace, so an any-type
        # req expands over its OWN job's base types, not everyone's.
        # Overflow jobs (id >= max_jobs) plan via the qmstat fallback,
        # never the solve: skip them on both sides.
        J = self.max_jobs
        jdemand: dict[tuple, set] = {}  # (job, type) -> demander homes
        for r, reqs in freqs.items():
            for req in reqs:
                jb = req_job(req)
                if not 0 <= jb < J:
                    continue
                types = self.base_types if req[2] is None else req[2]
                for t in types:
                    jdemand.setdefault((jb, t), set()).add(r)
        if not jdemand:
            return False
        for rank, snap in snapshots.items():
            for t in snap["tasks"]:
                dem = jdemand.get((task_job(t), t[1]))
                if dem and (len(dem) > 1 or rank not in dem):
                    return True
        return False

    # Per-consumer lookahead window: a server already holding this many
    # ready units per local consumer is never migration-deficient, no
    # matter how far below its proportional share it sits. Without the
    # cap, abundant-but-uneven pools (saturated compute-bound worlds whose
    # untargeted puts round-robin roughly evenly) churn a steady stream of
    # proportional-rebalance moves — each one transfer messages plus a
    # briefly unavailable unit — that no consumer ever needed. Starved
    # servers (hotspot's empty ones) sit far below the window and still
    # trigger immediately.
    #
    # The window is ADAPTIVE per destination: units are a poor proxy for
    # time (a fine-grained workload drains 8 units in a millisecond), so a
    # destination that re-triggers its deficit shortly after the last
    # top-up has its window doubled — transfer batches grow until one
    # batch covers the drain rate times the re-plan round trip (batches
    # are O(1) messages regardless of size, so bigger batches amortize) —
    # and a destination that stays quiet decays back toward the floor.
    LOOKAHEAD = 8
    LOOK_MAX = 512  # per consumer
    LOOK_GROW_WINDOW = 0.25  # s: re-trigger sooner than this -> double
    # Credits for in-flight migration batches expire after this long even
    # if the destination never ships a fresh task snapshot (idle empty
    # servers suppress repeat empty snapshots, and an enactment may drop
    # the batch entirely) — a lost batch must delay re-supply, not
    # suppress it forever.
    INFLOW_TTL = 2.0
    # ... and survive at least this long regardless of snapshot stamps: a
    # destination's snapshot captured after the plan but before the batch
    # LANDS must not wipe the credit (that would re-create the phantom
    # top-up chain for destinations that snapshot faster than batch
    # transit).
    INFLOW_MIN_AGE = 0.05
    # minimum spacing of fair-share pump rounds (see round()); 3 ms
    # (down from 10): mid-run drain imbalances parked whole
    # worker pools for the old interval at a time. The expensive
    # O(tasks) pump walk is additionally gated on the cheap
    # _maybe_imbalanced pre-check in EVERY round (previously
    # match-bearing rounds walked unconditionally, which taxed
    # balanced scarce economies ~5% — an adaptive 3/10 ms backoff was
    # tried instead and reverted: storms are bursts, so the first
    # response to each fresh imbalance paid the idle interval again).
    PUMP_INTERVAL = 0.003
    # in-flight credits older than this stop suppressing the solve for
    # their destination's requesters (the batch is probably lost; the TTL
    # keeps it counted as pump inflow a while longer, but workers must
    # not stay unmatchable for the full TTL)
    SUPPRESS_TTL = 0.25
    # supply counts as CONCENTRATED (enabling the starved full-share
    # bypass) when one server holds more than this fraction of the
    # available pool; hotspot's single-source backlog holds ~everything,
    # while balanced economies' transient bursts rarely clear it
    CONC_FRAC = 0.5
    # WINDOW GROWTH is gated on MEASURED recent waiting: a destination
    # earns transfer-batch growth only if some requester actually parked
    # there within this window (or is parked right now). Hotspot's
    # destinations park hard (startup, between-batch dips) and keep
    # earning scale; a destination that never waits decays to the floor,
    # bounding the batch sizes the pump can shuffle in balanced
    # economies. NOTE: gating the top-ups THEMSELVES on this signal was
    # measured and reverted (see _plan_migrations) — pre-positioning
    # ahead of demand is exactly what long steady-state sinks need.
    PARK_RECENT = 0.5

    def _window(self, rank: int) -> float:
        return self._look.get(rank, float(self.LOOKAHEAD))

    def _need(self, share: int, consumers: int, rank: int) -> int:
        return min(share, int(self._window(rank)) * consumers)

    def _touch_window(self, rank: int, now: float,
                      grow_ok: bool = True) -> None:
        """Called when `rank` triggered a top-up: grow on quick re-trigger,
        decay otherwise. Growth requires ``grow_ok`` — a destination
        whose workers were actually PARKED when fed (they outpace their
        supply; bigger batches pay). Feeding a busy server that merely
        dipped below the band (sudoku's bursty-but-balanced DFS pools)
        must not inflate the window: each doubling there just moves more
        units nobody is waiting for, and the churn compounds."""
        look = self._window(rank)
        if grow_ok and now - self._look_last.get(rank, -1e9) \
                < self.LOOK_GROW_WINDOW:
            self._look[rank] = min(look * 2.0, float(self.LOOK_MAX))
        else:
            # slow re-trigger OR nobody parked: decay toward the floor.
            # A gated quick re-trigger must decay too — otherwise a
            # window inflated during a parked phase would stay pinned at
            # the inflated batch size for as long as the destination
            # keeps dipping below the band
            self._look[rank] = max(float(self.LOOKAHEAD), look / 2.0)
        self._look_last[rank] = now

    def _maybe_imbalanced(self, snaps: dict) -> bool:
        """Cheap pre-check (raw snapshot counts; the ledger is consulted
        only for the handful of req-parked ranks in the scarce branch) for
        whether fair-share migration planning could possibly trigger; the
        exact check re-runs on filtered inventory. Errs a round late on
        ledger-heavy edges, which the next fresh snapshot corrects."""
        consumers = {
            r: snaps[r].get("consumers", 0) for r in snaps
        }
        total_c = sum(consumers.values())
        if total_c == 0:
            return False
        raw = {r: len(snaps[r]["tasks"]) for r in snaps}
        total = sum(raw.values())
        if total < total_c:
            # scarcity: matches handle it (see below) — unless the
            # scarce supply is one server's opening burst and starved
            # parked destinations are waiting on it
            if total == 0 or max(raw.values()) <= self.CONC_FRAC * total:
                return False
            return any(
                c > 0
                and snaps[r].get("reqs")
                and (raw[r] == 0 or self._only_planned_away(r, snaps[r]))
                for r, c in consumers.items()
            )
        return any(
            c > 0
            and 2 * raw[r] < self._need(-(-total * c // total_c), c, r)
            for r, c in consumers.items()
        )

    def _only_planned_away(self, rank: int, snap: dict) -> bool:
        """True when every unit a stale snapshot still lists for ``rank``
        is already spoken for by the plan ledger (matched or migrating
        away). Such a rank is starved NOW even though its raw count is
        nonzero — without this the startup-fill pump stays gated a whole
        snapshot generation after its opening burst is planned out, which
        is exactly the stall class this fix targets. Cost is a
        dict lookup per listed unit and only runs for req-parked ranks in
        the scarce branch (few, by construction)."""
        tasks = snap["tasks"]
        if not tasks:
            return True
        tstamp = snap.get("task_stamp", snap.get("stamp", 0.0))
        return all(
            self._planned_tasks.get((rank, t[0]), -1.0) >= tstamp
            for t in tasks
        )

    def _plan_migrations(
        self, snaps: dict, filtered: dict, planned_away: dict,
        t_planned: float, matched_reqs: Optional[set] = None,
        now: Optional[float] = None,
    ):
        """Fair-share inventory placement (see module docstring)."""
        inv: dict[int, list] = {}
        consumers: dict[int, int] = {}
        inflow: dict[int, int] = {}
        for rank, f in filtered.items():
            avail = [
                t for t in f["tasks"] if t[0] not in planned_away.get(rank, ())
            ]
            if f["reqs"] and avail:
                # Withhold one locally-matchable unit per parked requester:
                # the data plane's local matching hands these over with no
                # cross-server traffic, and when the solve was gated off
                # (supply local-only) nothing else protects them from
                # being migrated out from under their local demander.
                # Requesters the solve just matched cross-server are
                # skipped — they are already consumed by the match, and
                # withholding a second unit for them double-reserves
                # supply against migration sources.
                withheld: set = set()
                for req in f["reqs"]:
                    if matched_reqs and (rank, req[0], req[1]) in matched_reqs:
                        continue
                    types = req[2]
                    rj = req_job(req)
                    for t in avail:
                        if (
                            t[0] not in withheld
                            and task_job(t) == rj
                            and (types is None or t[1] in types)
                        ):
                            withheld.add(t[0])
                            break
                if withheld:
                    avail = [t for t in avail if t[0] not in withheld]
            inv[rank] = avail
            consumers[rank] = snaps.get(rank, {}).get("consumers", 0)
            # credits were pruned at the top of the round (_prune_credits):
            # what remains is in flight
            inflow[rank] = sum(
                e[1] for e in self._planned_in.get(rank, ())
            )
        total_consumers = sum(consumers.values())
        if total_consumers == 0:
            return []
        total_avail = sum(len(v) for v in inv.values())
        # Anticipatory placement only pays when there is a real backlog to
        # pre-position (hotspot's bulk). When work is scarcer than one unit
        # per consumer, the demand-driven match path moves individual units
        # more directly than a migrate round-trip — and scarce pools are
        # exactly where migrate churn (a unit bouncing between servers,
        # briefly unavailable each hop) hurts most (gfmc's shallow
        # answer-economy queues). EXCEPT when the scarce supply is
        # CONCENTRATED on one server (a producer's opening burst): then
        # every match is a per-unit fetch against the one hot reactor
        # that is also absorbing the put stream, and distributing what
        # little is visible starts workers on LOCAL fetches immediately
        # (the startup-fill fix). Scarce+concentrated admits only
        # the starved path below — anticipatory top-ups stay off.
        scarce = total_avail < total_consumers
        concentrated = (
            max((len(lst) for lst in inv.values()), default=0)
            > self.CONC_FRAC * total_avail
        )
        if scarce and not concentrated:
            return []

        def share(r: int) -> int:
            # ceil of the consumer-weighted share, so rounding never
            # strands a destination at zero
            c = consumers.get(r, 0)
            return -(-total_avail * c // total_consumers) if c else 0

        # Hysteresis: only treat a server as deficient when it holds less
        # than HALF its demand-capped need (see LOOKAHEAD). Without the
        # band, servers hovering near the threshold trigger a constant
        # shuffle of inventory moves for no placement benefit.
        #
        # STARVED destinations (nothing on hand, nothing in flight, a
        # requester actually parked there, AND supply CONCENTRATED on one
        # server — the hotspot shape this balancer exists for) bypass
        # both the band and the window cap: the cap exists to stop churn
        # on servers NEAR their share, and an empty server with waiting
        # workers facing a one-server backlog is not that. Ramping the
        # adaptive window from its floor would trickle window-sized
        # refills (a fraction of fair share) while whole worker pools sit
        # idle a re-plan round trip at a time; one full-share batch is
        # the same O(1) messages and seeds the window at the proven
        # drain scale. The guards keep balanced economies on the capped
        # path: transiently-empty servers whose workers are mid-compute
        # (tsp's fluctuating B&B frontier) fail the parked-requester
        # condition (RAW reqs, not the ledger-filtered view), and evenly
        # spread pools (gfmc's round-robin inventory) fail the
        # concentration test — full-share moves there are churn nobody
        # is waiting for. (``concentrated`` is computed alongside the
        # scarcity gate above.)
        starved: set = set()
        deficits: dict[int, int] = {}
        # recentness is judged at snapshot-READ time (round start), not
        # t_planned: a slow solve (first compile) between the two must
        # not age otherwise-fresh parks out of the window. A requester
        # VISIBLE parked in the current snapshot counts as recent no
        # matter the stamp age: servers suppress repeat-identical
        # snapshots, so a continuously-parked destination's stamp goes
        # stale precisely because nothing changed — aging it out of the
        # window would starve the most-waiting destinations (observed:
        # native 64-rank wait%% doubled before this clause).
        t_ref = now if now is not None else t_planned
        recent: dict[int, bool] = {
            r: (
                # LEDGER-FILTERED reqs, not raw: a requester the solve
                # already satisfied (still listed in a stale/suppressed
                # snapshot) must not keep earning growth
                bool(filtered.get(r, {}).get("reqs"))
                or t_ref - self._last_parked.get(r, -1e9) <= self.PARK_RECENT
            )
            for r in consumers
        }
        for r, c in consumers.items():
            if c <= 0:
                continue
            have = len(inv[r]) + inflow.get(r, 0)
            sh = share(r)
            if (
                have == 0 and sh > 0 and concentrated
                and snaps.get(r, {}).get("reqs")
            ):
                starved.add(r)
                deficits[r] = sh
            elif not scarce:
                # anticipatory placement (scarce+concentrated admits only
                # the starved path above). Round 4 MEASURED a stronger
                # gate here — feed only destinations whose workers parked
                # within PARK_RECENT — and reverted it:
                # native 64-rank acquisition wait DOUBLED (10.5% -> 22%,
                # long steady-state runs cycle busy->dry->park instead of
                # being smoothly pre-positioned), while sudoku did not
                # improve (disabling anticipatory feeding there measures
                # 7443 -> 6377 tasks/s — the pump HELPS sudoku; its
                # residual mode gap is fixed per-message/per-round cost,
                # see BASELINE.md). The recent-parked signal still gates
                # WINDOW GROWTH below, which is where the churn bound
                # belongs.
                need = self._need(sh, c, r)
                if 2 * have < need:
                    deficits[r] = need - have
        if not deficits:
            return []
        surpluses = {
            r: lst[share(r):]
            for r, lst in inv.items()
            if len(lst) > share(r)
        }
        cap = self.max_malloc_per_server
        moves: dict[tuple[int, int], list] = {}  # (src,dest)->[(seqno,type)]
        for dest, want in sorted(deficits.items(), key=lambda kv: -kv[1]):
            dest_bytes = snaps.get(dest, {}).get("nbytes", 0)
            for src_rank, lst in surpluses.items():
                if want <= 0:
                    break
                if src_rank == dest or not lst:
                    continue
                take = []
                for t in lst:
                    if len(take) >= want:
                        break
                    if cap > 0 and dest_bytes + t[3] > 0.9 * cap:
                        break  # planner-side admission: dest believed full
                    take.append(t)
                    dest_bytes += t[3]
                if take:
                    surpluses[src_rank] = lst = lst[len(take):]
                    moves.setdefault((src_rank, dest), []).extend(
                        (t[0], t[1]) for t in take
                    )
                    want -= len(take)
        out = []
        got: dict[int, int] = {}
        for (src_rank, dest), seqnos_types in moves.items():
            seqnos = [q for q, _ in seqnos_types]
            mid = self._mig_next
            self._mig_next += 1
            for q in seqnos:
                self._planned_tasks[(src_rank, q)] = t_planned
            self._planned_in.setdefault(dest, []).append(
                (t_planned, len(seqnos), mid, src_rank,
                 frozenset(wt for _, wt in seqnos_types))
            )
            got[dest] = got.get(dest, 0) + len(seqnos)
            out.append((src_rank, dest, seqnos, mid))
        # adapt windows only for destinations that were actually SHIPPED a
        # batch: a deficit no surplus could serve must not inflate the
        # window (it would silently disable the cap when supply returns)
        for dest, n_got in got.items():
            if dest in starved:
                # seed the window at the shipped scale so follow-up
                # top-ups continue at fair-share size instead of
                # re-ramping from the floor
                c = consumers.get(dest, 0) or 1
                self._look[dest] = min(
                    max(self._window(dest), n_got / c),
                    float(self.LOOK_MAX),
                )
                self._look_last[dest] = t_planned
            else:
                # growth keyed on RECENT parking, not currently-parked:
                # a well-timed anticipatory top-up prevents the park it
                # exists to prevent, which under the old
                # currently-parked test made success decay the window
                # (smaller batches -> more dips). A destination whose
                # workers waited within PARK_RECENT keeps earning
                # growth; one that never waits decays to the floor and
                # (per the deficit gate above) stops being fed at all.
                self._touch_window(dest, t_planned, grow_ok=recent[dest])
        return out
