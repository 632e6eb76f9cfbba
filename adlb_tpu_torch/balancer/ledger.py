"""Array-resident host ledger: O(changed rows) round admission.

The plan engine's per-round admission work — the requester ledger filter
(plan-suppression staleness checks), credit-suppression budgets, the
cross-feasibility solve gate, the pump pre-check, and the packing of the
solver's fixed-shape inputs — used to re-walk every parked requester and
every snapshot task in pure Python each round.  That is O(world) per
round, and past ~10k parked requesters it dominates the planning round
(the sharded solve itself is sub-10 ms at 100k parked; see ROADMAP item
1's closing note).

This module keeps that state **resident in numpy arrays**, maintained
incrementally from the same change keys the engine already forwards to
the sharded solver's ingest fast path:

* per-snapshot stamps (``stamp``/``task_stamp``) — full refreshes;
* event sequences (``delta_seq``/``req_seq``) — in-place snapshot
  mutations that deliberately carry no stamp bump (task-delta appends,
  dead-rank requester patches);
* the engine's own plan marks (``_planned_reqs``/``_planned_tasks``) —
  hook-fed per key, so a round that matched 5 servers re-derives 5
  servers' columns, not the world's.

Per round the admission work is then a handful of vectorized column
operations (bool masks over resident columns, [S, T] aggregate
compares), with a full rebuild only on resync — mirroring the sharded
solver's sweep/patch split (``LEDGER_RESYNC_INTERVAL``).

Two interchangeable implementations behind one interface:

* :class:`PyLedger` — the pre-existing pure-Python filter, extracted
  verbatim.  Retained as the semantic twin: ``Config(host_ledger="py")``
  selects it, and ``tests/test_ledger_parity.py`` fuzz-proves the
  vectorized ledger produces identical kept-requester / eligible-task
  sets (and therefore identical plans) across randomized delta /
  suppression / expiry / dead-rank sequences.
* :class:`ArrayLedger` — the vectorized ledger (default).  It also IS
  the :class:`LedgerView` the solvers consume directly (``solve.py`` /
  ``distributed.py`` accept it in ``solve()``), so the solver inputs are
  the resident arrays themselves — no per-round tuple re-derivation.

Exactness contract (same as the sharded solver's stamp fast path): a
snapshot whose content changes with NO key change (no stamp bump, no
sequence bump, no plan of ours touching it) is picked up at its next
keyed refresh.  The runtime never does this — every in-place mutation
bumps a sequence (``server._merge_task_delta`` / ``_patch_snapshots_for_
dead``; the sidecar's delta merge gained its bump in this change) — and
a row-count change without a key bump is additionally caught by a cheap
length check each round.  Snapshots without stamps at all (unit tests,
hand-built harnesses) are re-derived every round, which is exactly the
always-eligible semantics the Python filter gives them.
"""

from __future__ import annotations

import bisect
import time
from typing import Optional

import numpy as np

from adlb_tpu_torch.balancer.jobdim import bias_vector, expand_types

# priority clip shared with the solvers (import kept lazy-free: solve.py
# imports torch; the ledger must stay importable on accelerator-less hosts
# without touching it — jobdim above is numpy-free pure Python)
_NEG = -(2**31) + 1
_PRIO_CLIP = 10**9


class _Marks(dict):
    """The engine's plan-mark dicts (``_planned_reqs``/``_planned_tasks``)
    with mutation hooks, so the array ledger's resident columns stay
    coherent even when a test (or future code) pokes the dict directly.
    Only the mutators the engine and tests actually use are hooked."""

    __slots__ = ("_on_set", "_on_del")

    def __init__(self, on_set=None, on_del=None):
        super().__init__()
        self._on_set = on_set
        self._on_del = on_del

    def __setitem__(self, key, value):
        dict.__setitem__(self, key, value)
        if self._on_set is not None:
            self._on_set(key, value)

    def __delitem__(self, key):
        dict.__delitem__(self, key)
        if self._on_del is not None:
            self._on_del(key)

    def pop(self, key, *default):
        had = key in self
        out = dict.pop(self, key, *default)
        if had and self._on_del is not None:
            self._on_del(key)
        return out


class SnapshotStore(dict):
    """A snapshot dict that *narrates its own changes*: every mutation
    bumps a monotonic version and appends ``(ver, rank)`` to a
    dedup-compacted change log, and membership changes (new rank, death)
    additionally bump ``member_ver``.  :meth:`ArrayLedger.sync` uses
    these to touch only the ranks that changed since its last sync —
    killing the per-round O(servers) compare scan that was the 1k-parked
    admission floor (MULTICHIP_r07) — while staying a plain dict for
    every other consumer (the ``host_ledger="py"`` twin, the sharded
    solver's stamp path, tests).

    In-place snapshot mutations that bypass ``__setitem__`` (the
    task-delta append, dead-rank requester patches) must call
    :meth:`bump`; the producers do (``server._merge_task_delta`` /
    ``_patch_snapshots_for_dead``, the sidecar's delta merge).  A missed
    bump is caught by the ledger's cadence resync, same contract as the
    stamp fast paths.

    :meth:`fork` takes the balancer round's shallow copy (the same
    ``dict(snapshots)`` the worker always took) carrying the version
    counters along, so a concurrently-mutating producer never tears a
    round: the consumer reads the log only up to the fork's ``ver``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.ver = 1
        self.member_ver = 1
        # lineage token: forks share it, distinct stores never do — a
        # consumer's seen-version marks are only meaningful against the
        # same version sequence
        self.lineage = id(self)
        self._log: list = []  # (ver, rank) ascending, dedup-compacted
        if args or kwargs:
            for rank, snap in dict(*args, **kwargs).items():
                self[rank] = snap

    def _touch(self, rank) -> None:
        self.ver += 1
        self._log.append((self.ver, rank))
        if len(self._log) > max(256, 2 * len(self) + 8):
            # lossless dedup-compaction: keep only each rank's LAST
            # entry — any consumer position either already processed the
            # dropped older entries or still sees the survivor
            last: dict = {}
            for v, r in self._log:
                last[r] = v
            self._log = sorted((v, r) for r, v in last.items())

    def __setitem__(self, rank, snap) -> None:
        if rank not in self:
            self.member_ver = self.ver + 1
        dict.__setitem__(self, rank, snap)
        self._touch(rank)

    def bump(self, rank) -> None:
        """Record an in-place mutation of ``self[rank]``."""
        if rank in self:
            self._touch(rank)

    def __delitem__(self, rank) -> None:
        dict.__delitem__(self, rank)
        self.ver += 1
        self.member_ver = self.ver

    def pop(self, rank, *default):
        had = rank in self
        out = dict.pop(self, rank, *default)
        if had:
            self.ver += 1
            self.member_ver = self.ver
        return out

    def fork(self) -> "SnapshotStore":
        """Shallow round-scoped copy sharing the (append-only) change
        log; snapshot values are shared, as the worker's ``dict()`` copy
        always did."""
        f = SnapshotStore()
        # counters first, content second: a producer racing the fork can
        # only make the copy NEWER than its version marks, so the reader
        # at worst re-processes a rank next round — never misses one
        f.ver = self.ver
        f.member_ver = self.member_ver
        f.lineage = self.lineage
        f._log = self._log
        dict.update(f, self)
        return f


class PyLedger:
    """The pure-Python twin: the engine's pre-vectorization per-round
    filter, verbatim.  Stateless across rounds beyond the engine's own
    plan-mark dicts (which it reads in place)."""

    is_array = False

    def __init__(self, engine) -> None:
        self.engine = engine
        self._freqs: dict = {}
        self._snapshots: dict = {}
        self._now = 0.0
        # twin-side counters mirror the array ledger's surface so bench
        # and smoke code can read them unconditionally
        self.patch_count = 0
        self.resync_count = 0
        self.last_sync_us = 0.0

    def sync(self, snapshots: dict, now: float) -> None:
        self._snapshots = snapshots
        self._now = now

    def filter_reqs(self, snapshots: dict, sup: dict, now: float) -> None:
        """``sup``: rank -> (fed type set, budget) for ranks with live
        young in-flight credits (engine-computed; see round())."""
        planned = self.engine._planned_reqs
        freqs = {}
        for rank, snap in snapshots.items():
            stamp = snap.get("stamp", now)
            fed, budget = sup.get(rank, (None, 0))
            kept = []
            for r in snap["reqs"]:
                if planned.get((rank, r[0], r[1]), -1.0) >= stamp:
                    continue
                if (
                    budget > 0
                    and fed
                    and (r[2] is None or not fed.isdisjoint(r[2]))
                ):
                    budget -= 1
                    continue
                kept.append(r)
            freqs[rank] = kept
        self._freqs = freqs

    def have_reqs(self) -> bool:
        return any(self._freqs.values())

    def cross_feasible(self, snapshots: dict) -> bool:
        return self.engine._cross_feasible(self._freqs, snapshots)

    def kept_reqs(self, rank: int) -> list:
        return self._freqs.get(rank, [])

    def elig_tasks(self, rank: int) -> list:
        snap = self._snapshots[rank]
        planned = self.engine._planned_tasks
        tstamp = snap.get("task_stamp", snap.get("stamp", self._now))
        return [
            t for t in snap["tasks"]
            if planned.get((rank, t[0]), -1.0) < tstamp
        ]

    def maybe_imbalanced(self, engine, snapshots: dict) -> Optional[bool]:
        return None  # engine runs its own (identical) Python pre-check

    def parked_updates(self, now: float) -> Optional[list]:
        return None  # engine walks the snapshots itself (the twin loop)

    def view(self):
        return None  # no array view: solvers get the materialized dict

    def rows_resident(self) -> int:
        return 0


class _Srv:
    """One server's resident rows (requester + task columns)."""

    __slots__ = (
        "rank", "slot", "consumers",
        # requester side
        "reqs", "r_n", "r_stamp", "r_key", "r_rank", "r_seq", "r_any",
        "r_mask", "r_planned", "r_elig", "r_index", "r_dups", "r_unknown",
        "round_sup",
        # task side
        "tasks", "t_n", "t_stamp", "t_key", "t_seq", "t_tix", "t_prio",
        "t_planned", "t_elig", "t_index", "t_dups",
    )

    def __init__(self, rank: int, slot: int) -> None:
        self.rank = rank
        self.slot = slot
        self.consumers = 0
        self.reqs = []
        self.r_n = 0
        self.r_stamp = None
        self.r_key = None
        self.r_rank = _EMPTY_I8
        self.r_seq = _EMPTY_I8
        self.r_any = _EMPTY_B
        self.r_mask = None
        self.r_planned = _EMPTY_F8
        self.r_elig = _EMPTY_B
        self.r_index = {}
        self.r_dups = False
        self.r_unknown = False
        self.round_sup = _EMPTY_I8
        self.tasks = []
        self.t_n = 0
        self.t_stamp = None
        self.t_key = None
        self.t_seq = _EMPTY_I8
        self.t_tix = _EMPTY_I4
        self.t_prio = _EMPTY_I8
        self.t_planned = _EMPTY_F8
        self.t_elig = _EMPTY_B
        self.t_index = {}
        self.t_dups = False


_EMPTY_I8 = np.zeros(0, np.int64)
_EMPTY_I4 = np.zeros(0, np.int32)
_EMPTY_F8 = np.zeros(0, np.float64)
_EMPTY_B = np.zeros(0, bool)


class ArrayLedger:
    """The vectorized ledger — and the :class:`LedgerView` the solvers
    consume (one object, two roles: resident maintenance and packed
    exposure; the packed arrays ARE the resident state).

    Solver-facing surface (the "view"): ``servers`` (sorted live ranks),
    ``slot_order`` (their slots), ``pk_tp``/``pk_tt``/``pk_trefs``
    (per-slot [K] task rows, clipped int32 priorities / type indices /
    ``(rank, seqno)`` refs), ``pk_rv``/``pk_rm``/``pk_rrefs`` (per-slot
    [R] kept-requester rows), and per-slot generation counters
    ``t_gen``/``r_gen`` a stateful consumer diffs against.
    """

    is_array = True

    #: full rebuild cadence (belt-and-braces, mirroring the sharded
    #: solver's RESYNC_INTERVAL: the incremental path is exact by
    #: construction, and the resync bounds any drift a key-less
    #: in-place snapshot mutation could ever introduce)
    LEDGER_RESYNC_INTERVAL = 256

    def __init__(self, engine, types, max_tasks: int,
                 max_requesters: int, max_jobs: int = 1,
                 job_weights: Optional[dict] = None) -> None:
        self.engine = engine
        self.base_types = tuple(types)
        self.base_T = max(len(self.base_types), 1)
        self.max_jobs = max(int(max_jobs), 1)
        # composite (job, type) axis — the base types themselves when
        # single-job (exact back-compat); see balancer/jobdim.py
        self.types = expand_types(self.base_types, self.max_jobs)
        self.tix = {t: i for i, t in enumerate(self.types)}
        self.T = max(len(self.types), 1)
        self.job_bias = bias_vector(job_weights, self.max_jobs)
        self.K = max_tasks
        self.R = max_requesters
        self._srv: dict[int, _Srv] = {}
        self._free: list[int] = []
        self._cap = 0
        self._gen = 1
        self._rounds = 0
        self._round_token = 0
        self._order_stale = True
        self._order = np.zeros(0, np.int64)
        self.servers: list = []
        # repack-needed ranks (elig changed without a snapshot rebuild)
        self._stale_rq: set = set()
        self._stale_tk: set = set()
        self._sup_touched: set = set()
        self._round_kept = 0
        self._any_unknown_req = False
        self._unknown_n = 0
        self._parked: list = []
        # SnapshotStore consumption state: the store lineage plus the
        # version and membership version this ledger has fully absorbed
        self._seen_ver = 0
        self._seen_member_ver = None
        self._seen_lineage = None
        # ranks whose snapshots carry no stamp: re-derived every round
        # (the Python filter's "stamp defaults to now" semantics), so
        # the store fast path must visit them even when unchanged
        self._stampless: set = set()
        # membership generation for stateful view consumers (the
        # sharded solver's vectorized ingest): bumped whenever a slot
        # is taken or dropped, so a consumer can skip its own O(S)
        # membership walk on the (vastly common) no-churn round
        self.member_gen = 1
        # stats surfaced by bench / CI smoke / obs gauges
        self.patch_count = 0     # incremental per-server (re)builds
        self.resync_count = 0    # full rebuilds (cold + cadence)
        # why each full pass ran — "cadence" is the periodic safety
        # rebuild; store-backed rounds also classify "cold" (new store
        # lineage / first sync) and "membership" (join/drain/failover
        # moved member_ver). Steady state must show only cadence growth;
        # the engine mirrors these onto /metrics as ledger_resyncs.
        self.resync_reasons: dict = {"cadence": 0, "cold": 0,
                                     "membership": 0, "weights": 0}
        self.last_sync_us = 0.0
        # a pending forced full rebuild and its reason key (a weight
        # change re-biases every resident priority column)
        self._force_resync: Optional[str] = None
        self._alloc(16)

    def set_job_bias(self, job_weights: Optional[dict]) -> bool:
        """Install new per-job priority biases; a change forces a full
        rebuild at the next sync (every packed prio column embeds the
        bias). Returns True when the bias actually changed."""
        bias = bias_vector(job_weights, self.max_jobs)
        if bias == self.job_bias:
            return False
        self.job_bias = bias
        self._force_resync = "weights"
        return True

    # -- storage -----------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        """(Re)allocate the global slot-indexed arrays to ``cap`` slots,
        preserving content.  Only runs at construction and on world
        growth — steady-state rounds never reallocate (guarded by
        tests/test_ledger_parity.py)."""
        T, K, R = self.T, self.K, self.R
        old = self._cap
        if old == 0:
            self.g_dem = np.zeros((cap, T), np.int64)
            self.g_any = np.zeros(cap, np.int64)
            self.g_eligreq = np.zeros(cap, np.int64)
            self.g_sup = np.zeros((cap, T), np.int64)
            self.g_taskcnt = np.zeros(cap, np.int64)
            self.g_eligtask = np.zeros(cap, np.int64)
            # twin of _only_planned_away: every listed task marked at or
            # after the task view (tstamp default 0.0, NOT now — the
            # Python check's exact default for stampless snapshots)
            self.g_planned_away = np.ones(cap, bool)
            self.g_hasreqs = np.zeros(cap, bool)
            self.g_consumers = np.zeros(cap, np.int64)
            self.pk_tp = np.full((cap, K), _NEG, np.int32)
            self.pk_tt = np.full((cap, K), -1, np.int32)
            self.pk_rv = np.zeros((cap, R), bool)
            self.pk_rm = np.zeros((cap, R, T), bool)
            self.t_gen = np.zeros(cap, np.int64)
            self.r_gen = np.zeros(cap, np.int64)
            self.slot_rank = np.full(cap, -1, np.int64)
            self.pk_trefs = [[None] * K for _ in range(cap)]
            self.pk_rrefs = [[None] * R for _ in range(cap)]
        else:
            for name, fill in (
                ("g_dem", 0), ("g_any", 0), ("g_eligreq", 0), ("g_sup", 0),
                ("g_taskcnt", 0), ("g_eligtask", 0),
                ("g_planned_away", True), ("g_hasreqs", False),
                ("g_consumers", 0), ("pk_tp", _NEG), ("pk_tt", -1),
                ("pk_rv", False), ("pk_rm", False), ("t_gen", 0),
                ("r_gen", 0), ("slot_rank", -1),
            ):
                a = getattr(self, name)
                n = np.full((cap,) + a.shape[1:], fill, a.dtype)
                n[:old] = a
                setattr(self, name, n)
            self.pk_trefs.extend([None] * self.K for _ in range(cap - old))
            self.pk_rrefs.extend([None] * self.R for _ in range(cap - old))
        self._free.extend(range(old, cap))
        self._cap = cap

    def _take_slot(self, rank: int) -> _Srv:
        if not self._free:
            self._alloc(self._cap * 2)
        srv = _Srv(rank, self._free.pop())
        self._srv[rank] = srv
        self.slot_rank[srv.slot] = rank
        self.member_gen += 1
        self._order_stale = True
        return srv

    def _drop(self, rank: int) -> None:
        srv = self._srv.pop(rank)
        s = srv.slot
        self.g_dem[s] = 0
        self.g_any[s] = 0
        self.g_eligreq[s] = 0
        self.g_sup[s] = 0
        self.g_taskcnt[s] = 0
        self.g_eligtask[s] = 0
        self.g_planned_away[s] = True
        self.g_hasreqs[s] = False
        self.g_consumers[s] = 0
        self.pk_tp[s] = _NEG
        self.pk_tt[s] = -1
        self.pk_rv[s] = False
        self.pk_rm[s] = False
        self.pk_trefs[s] = [None] * self.K
        self.pk_rrefs[s] = [None] * self.R
        self.t_gen[s] = self._bump()
        self.r_gen[s] = self._bump()
        self.slot_rank[s] = -1
        self.member_gen += 1
        self._free.append(s)
        self._order_stale = True
        self._stale_rq.discard(rank)
        self._stale_tk.discard(rank)
        self._sup_touched.discard(rank)
        self._stampless.discard(rank)
        if srv.r_unknown:
            self._unknown_n -= 1

    def _bump(self) -> int:
        self._gen += 1
        return self._gen

    # -- incremental sync --------------------------------------------------

    def sync(self, snapshots: dict, now: float) -> None:
        t0 = time.perf_counter()
        self._round_token = id(snapshots)
        self._rounds += 1
        resync = self._rounds % self.LEDGER_RESYNC_INTERVAL == 0
        reason = "cadence" if resync else self._force_resync
        if reason is not None:
            resync = True
            self._force_resync = None
            self.resync_count += 1
            self.resync_reasons[reason] = \
                self.resync_reasons.get(reason, 0) + 1
        ver = getattr(snapshots, "ver", None)
        if (
            ver is not None
            and not resync
            and getattr(snapshots, "lineage", None) == self._seen_lineage
            and snapshots.member_ver == self._seen_member_ver
        ):
            # store fast path — membership unchanged since the last
            # sync, so only the change log's tail (ranks whose store
            # version moved past our seen mark) plus the stampless set
            # (re-derived every round by contract) are visited. An idle
            # round touches nothing: O(changed), not O(servers).
            seen = self._seen_ver
            if ver != seen:
                log = snapshots._log
                done: set = set()
                for v, rank in log[bisect.bisect_left(log, (seen + 1,)):]:
                    if v > ver:
                        break  # appended after our fork was taken
                    if rank in done:
                        continue
                    done.add(rank)
                    snap = snapshots.get(rank)
                    if snap is not None:
                        self._sync_one(rank, snap, False, now)
                for rank in tuple(self._stampless):
                    if rank not in done and rank in snapshots:
                        self._sync_one(rank, snapshots[rank], False, now)
            elif self._stampless:
                for rank in tuple(self._stampless):
                    if rank in snapshots:
                        self._sync_one(rank, snapshots[rank], False, now)
            self._seen_ver = ver
        else:
            # full pass: plain dicts (unit tests, hand-built harnesses),
            # the cadence resync, and any store membership change (join,
            # drain, failover — the O(S) walk is paid only on churn)
            if ver is not None and not resync:
                if getattr(snapshots, "lineage", None) != self._seen_lineage:
                    self.resync_reasons["cold"] += 1
                else:
                    self.resync_reasons["membership"] += 1
            for rank, snap in snapshots.items():
                self._sync_one(rank, snap, resync, now)
            if len(self._srv) != len(snapshots):
                for rank in [r for r in self._srv if r not in snapshots]:
                    self._drop(rank)
            if ver is not None:
                self._seen_ver = ver
                self._seen_member_ver = snapshots.member_ver
                self._seen_lineage = getattr(snapshots, "lineage", None)
        if self._order_stale:
            self.servers = sorted(self._srv)
            self._order = np.fromiter(
                (self._srv[r].slot for r in self.servers), np.int64,
                len(self.servers),
            )
            self._order_stale = False
        self._any_unknown_req = self._unknown_n > 0
        self.last_sync_us = (time.perf_counter() - t0) * 1e6

    def _sync_one(self, rank: int, snap: dict, resync: bool,
                  now: float) -> None:
        srv = self._srv.get(rank)
        if srv is None:
            srv = self._take_slot(rank)
        # stampless snapshots re-derive every round (the Python
        # filter's "stamp defaults to now" semantics); the length
        # check catches a key-less in-place append (belt-and-braces
        # next to the resync cadence). Keys are compared component-
        # wise — this body is the per-rank compare floor, so no tuple
        # allocations on the unchanged fast path.
        stamp = snap.get("stamp")
        if (
            resync
            or stamp is None
            or srv.r_stamp != stamp
            or srv.r_key != snap.get("req_seq", 0)
            or srv.r_n != len(snap["reqs"])
        ):
            self._rebuild_reqs(srv, snap, stamp,
                               snap.get("req_seq", 0), now)
            self.patch_count += 1
        tstamp = snap.get("task_stamp", stamp)
        if (
            resync
            or tstamp is None
            or srv.t_stamp != tstamp
            or srv.t_key != snap.get("delta_seq", 0)
            or srv.t_n != len(snap["tasks"])
        ):
            self._rebuild_tasks(srv, snap, tstamp,
                                snap.get("delta_seq", 0), now)
            self.patch_count += 1
        c = snap.get("consumers", 0)
        if srv.consumers != c:
            srv.consumers = c
            self.g_consumers[srv.slot] = c
        if stamp is None or tstamp is None:
            self._stampless.add(rank)
        else:
            self._stampless.discard(rank)

    def _rebuild_reqs(self, srv: _Srv, snap: dict, stamp, rseq,
                      now: float) -> None:
        reqs = list(snap["reqs"])
        n = len(reqs)
        srv.reqs = reqs
        srv.r_n = n
        srv.r_stamp = stamp
        srv.r_key = rseq
        if n:
            # raw-park recency feed for the engine's _last_parked (the
            # pump's window-growth signal): a rank's park stamp can only
            # move when its snapshot rebuilt, so the engine applies
            # these O(changed) events instead of walking every server
            self._parked.append((srv.rank, stamp))
        T = self.T
        tix = self.tix
        planned = self.engine._planned_reqs
        rank = srv.rank
        r_rank = np.empty(n, np.int64)
        r_seq = np.empty(n, np.int64)
        r_any = np.zeros(n, bool)
        r_mask = np.zeros((n, T), bool)
        r_planned = np.empty(n, np.float64)
        index: dict = {}
        dups = unknown = False
        # NOTE: this types->mask packing is the view-producer twin of
        # the dict-path packers in solve.AssignmentSolver.solve and
        # distributed._pack_reqs (which silently drop unknown types;
        # here they flag r_unknown so cross_feasible can fall back
        # exactly). A change to req-type semantics must touch all
        # three — the parity fuzz pins them together. Multi-job: the
        # job column selects the composite (job, type) slots; any-type
        # reqs become full job-BLOCK masks (never r_any, so the
        # vectorized paths stay job-exact) and overflow namespaces get
        # an empty mask — present but never matched (jobdim.py).
        J = self.max_jobs
        T0 = self.base_T
        for i, r in enumerate(reqs):
            fr, sq, types = r[0], r[1], r[2]
            r_rank[i] = fr
            r_seq[i] = sq
            jb = (r[4] if len(r) > 4 else 0) if J > 1 else 0
            if J > 1 and not 0 <= jb < J:
                pass  # overflow job: qmstat-RFR fallback territory
            elif types is None:
                if J <= 1:
                    r_any[i] = True
                    r_mask[i, :] = True
                else:
                    r_mask[i, jb * T0:(jb + 1) * T0] = True
            else:
                for t in types:
                    ti = tix.get(t if J <= 1 else (jb, t))
                    if ti is None:
                        unknown = True
                    else:
                        r_mask[i, ti] = True
            if (fr, sq) in index:
                dups = True
            index[(fr, sq)] = i
            r_planned[i] = planned.get((rank, fr, sq), -1.0)
        srv.r_rank, srv.r_seq = r_rank, r_seq
        srv.r_any, srv.r_mask, srv.r_planned = r_any, r_mask, r_planned
        srv.r_index = index
        srv.r_dups = dups
        if unknown != srv.r_unknown:
            self._unknown_n += 1 if unknown else -1
        srv.r_unknown = unknown
        srv.r_elig = r_planned < (now if stamp is None else stamp)
        srv.round_sup = _EMPTY_I8
        self.g_hasreqs[srv.slot] = n > 0
        self._req_aggregate(srv)
        self._pack_reqs(srv)

    def _rebuild_tasks(self, srv: _Srv, snap: dict, tstamp, tseq,
                       now: float) -> None:
        tasks = list(snap["tasks"])
        n = len(tasks)
        srv.tasks = tasks
        srv.t_n = n
        srv.t_stamp = tstamp
        srv.t_key = tseq
        tix = self.tix
        planned = self.engine._planned_tasks
        rank = srv.rank
        t_seq = np.empty(n, np.int64)
        t_tix = np.empty(n, np.int32)
        t_prio = np.empty(n, np.int64)
        t_planned = np.empty(n, np.float64)
        index: dict = {}
        dups = False
        J = self.max_jobs
        bias = self.job_bias
        nb = len(bias)
        for i, t in enumerate(tasks):
            sq = t[0]
            t_seq[i] = sq
            jb = (t[4] if len(t) > 4 else 0) if J > 1 else 0
            t_tix[i] = tix.get(t[1] if J <= 1 else (jb, t[1]), -1)
            # weight bias folds into the clipped prio at pack time —
            # identically in every packer twin (jobdim.weight_bias
            # keeps the sum int32-safe and above the _NEG sentinel)
            b = bias[jb] if 0 <= jb < nb else 0
            t_prio[i] = max(-_PRIO_CLIP, min(_PRIO_CLIP, t[2])) + b
            if sq in index:
                dups = True
            index[sq] = i
            t_planned[i] = planned.get((rank, sq), -1.0)
        srv.t_seq, srv.t_tix, srv.t_prio = t_seq, t_tix, t_prio
        srv.t_planned = t_planned
        srv.t_index = index
        srv.t_dups = dups
        srv.t_elig = t_planned < (now if tstamp is None else tstamp)
        s = srv.slot
        self.g_taskcnt[s] = n
        known = t_tix[t_tix >= 0]
        self.g_sup[s] = np.bincount(known, minlength=self.T) if known.size \
            else 0
        self.g_eligtask[s] = int(srv.t_elig.sum())
        self.g_planned_away[s] = self._task_away(srv)
        self._pack_tasks(srv)

    def _task_away(self, srv: _Srv) -> bool:
        """Twin of ``PlanEngine._only_planned_away``: tstamp defaults to
        0.0 (not now) for stampless snapshots, exactly like the Python
        check it mirrors."""
        if srv.t_n == 0:
            return True
        ref = srv.t_stamp if srv.t_stamp is not None else 0.0
        return bool((srv.t_planned >= ref).all())

    def _req_aggregate(self, srv: _Srv) -> None:
        s = srv.slot
        e = srv.r_elig
        self.g_eligreq[s] = int(e.sum())
        self.g_any[s] = int((e & srv.r_any).sum())
        te = e & ~srv.r_any
        self.g_dem[s] = srv.r_mask[te].sum(0) if te.any() else 0

    # -- plan-mark hooks (fed by the engine's _Marks dicts) ----------------

    def on_req_mark(self, key, value=None) -> None:
        srv = self._srv.get(key[0])
        if srv is None:
            return
        if srv.r_dups:
            # ambiguous row mapping: re-derive the whole column (rare —
            # duplicate (rank, rqseqno) keys in one snapshot)
            self._recompute_req_planned(srv)
            return
        row = srv.r_index.get((key[1], key[2]))
        if row is None:
            return
        v = self.engine._planned_reqs.get(key, -1.0)
        srv.r_planned[row] = v
        stamp = srv.r_stamp
        elig = True if stamp is None else bool(v < stamp)
        if elig != bool(srv.r_elig[row]):
            srv.r_elig[row] = elig
            self._req_aggregate(srv)
            self._stale_rq.add(srv.rank)

    def on_task_mark(self, key, value=None) -> None:
        srv = self._srv.get(key[0])
        if srv is None:
            return
        if srv.t_dups:
            self._recompute_task_planned(srv)
            return
        row = srv.t_index.get(key[1])
        if row is None:
            return
        v = self.engine._planned_tasks.get(key, -1.0)
        srv.t_planned[row] = v
        tstamp = srv.t_stamp
        elig = True if tstamp is None else bool(v < tstamp)
        if elig != bool(srv.t_elig[row]):
            srv.t_elig[row] = elig
            self.g_eligtask[srv.slot] = int(srv.t_elig.sum())
            self._stale_tk.add(srv.rank)
        self.g_planned_away[srv.slot] = self._task_away(srv)

    def _recompute_req_planned(self, srv: _Srv) -> None:
        planned = self.engine._planned_reqs
        rank = srv.rank
        for i, r in enumerate(srv.reqs):
            srv.r_planned[i] = planned.get((rank, r[0], r[1]), -1.0)
        stamp = srv.r_stamp
        srv.r_elig = (
            np.ones(srv.r_n, bool) if stamp is None
            else srv.r_planned < stamp
        )
        self._req_aggregate(srv)
        self._stale_rq.add(rank)

    def _recompute_task_planned(self, srv: _Srv) -> None:
        planned = self.engine._planned_tasks
        rank = srv.rank
        for i, t in enumerate(srv.tasks):
            srv.t_planned[i] = planned.get((rank, t[0]), -1.0)
        tstamp = srv.t_stamp
        srv.t_elig = (
            np.ones(srv.t_n, bool) if tstamp is None
            else srv.t_planned < tstamp
        )
        self.g_eligtask[srv.slot] = int(srv.t_elig.sum())
        self.g_planned_away[srv.slot] = self._task_away(srv)
        self._stale_tk.add(rank)

    # -- per-round admission ----------------------------------------------

    def filter_reqs(self, snapshots: dict, sup: dict, now: float) -> None:
        """Round-scoped credit suppression over the resident eligibility
        columns.  Only ranks with live young credits are touched — the
        steady state (no migrations in flight) costs nothing here."""
        kept = int(self.g_eligreq[self._order].sum())
        touched = set()
        for rank, (fed, budget) in sup.items():
            srv = self._srv.get(rank)
            if srv is None:
                continue
            touched.add(rank)
            if srv.r_unknown or any(t not in self.tix for t in fed):
                # unknown types on either side: exact per-rank Python
                # fallback (never happens with world-typed traffic)
                rows = self._py_sup_rows(srv, fed, budget)
            else:
                fed_ix = [self.tix[t] for t in fed]
                match = srv.r_elig & (
                    srv.r_any | srv.r_mask[:, fed_ix].any(1)
                )
                rows = np.flatnonzero(match)[:budget]
            if rows.size or srv.round_sup.size:
                if not np.array_equal(rows, srv.round_sup):
                    srv.round_sup = np.asarray(rows, np.int64)
                    self._stale_rq.add(rank)
            kept -= int(len(rows))
        # ranks whose suppression lapsed must repack without it
        for rank in self._sup_touched - touched:
            srv = self._srv.get(rank)
            if srv is not None and srv.round_sup.size:
                srv.round_sup = _EMPTY_I8
                self._stale_rq.add(rank)
        self._sup_touched = touched
        self._round_kept = kept

    def _py_sup_rows(self, srv: _Srv, fed, budget: int) -> np.ndarray:
        rows = []
        for i, r in enumerate(srv.reqs):
            if not srv.r_elig[i]:
                continue
            if budget > 0 and (r[2] is None or not fed.isdisjoint(r[2])):
                rows.append(i)
                budget -= 1
        return np.asarray(rows, np.int64)

    def have_reqs(self) -> bool:
        return self._round_kept > 0

    def cross_feasible(self, snapshots: dict) -> bool:
        """Vectorized twin of ``PlanEngine._cross_feasible`` over the
        maintained [S, T] aggregates (raw supply vs kept demand)."""
        if self._any_unknown_req:
            # exact fallback: materialize kept lists (rare; unit tests
            # with off-world types only)
            freqs = {r: self.kept_reqs(r) for r in snapshots}
            return self.engine._cross_feasible(freqs, snapshots)
        act = self._order
        if act.size == 0:
            return False
        D = self.g_dem[act] > 0            # [S, T] typed-demand homes
        anyh = self.g_any[act] > 0         # [S] any-type demand homes
        for rank in self._sup_touched:
            srv = self._srv.get(rank)
            if srv is None or not srv.round_sup.size:
                continue
            si = self.servers.index(rank)
            kept = srv.r_elig.copy()
            kept[srv.round_sup] = False
            anyh[si] = bool((kept & srv.r_any).any())
            te = kept & ~srv.r_any
            D[si] = srv.r_mask[te].any(0) if te.any() else False
        taskcnt = self.g_taskcnt[act]
        n_any = int(anyh.sum())
        if n_any:
            total = int(taskcnt.sum())
            if n_any > 1:
                if total > 0:
                    return True
            elif total - int(taskcnt[int(np.argmax(anyh))]) > 0:
                return True
        nd = D.sum(0)                      # [T] demand-home counts
        H = self.g_sup[act] > 0            # [S, T] supply homes
        ns = H.sum(0)
        feas = (nd > 1) & (ns > 0)
        single = nd == 1
        if single.any():
            sole = D.argmax(0)             # sole demand home per type
            feas |= single & (
                (ns - H[sole, np.arange(self.T)].astype(np.int64)) > 0
            )
        return bool(feas.any())

    def maybe_imbalanced(self, engine, snapshots: dict) -> Optional[bool]:
        """Vectorized twin of ``PlanEngine._maybe_imbalanced`` over the
        resident aggregate columns.  Returns None when the ledger is not
        synced with these snapshots (direct unit-test calls) so the
        engine falls back to the Python pre-check."""
        if self._round_token != id(snapshots) or len(self._srv) != len(
                snapshots):
            return None
        act = self._order
        cons = self.g_consumers[act]
        total_c = int(cons.sum())
        if total_c == 0:
            return False
        raw = self.g_taskcnt[act]
        total = int(raw.sum())
        if total < total_c:
            if total == 0 or int(raw.max()) <= engine.CONC_FRAC * total:
                return False
            starved = (
                (cons > 0)
                & self.g_hasreqs[act]
                & ((raw == 0) | self.g_planned_away[act])
            )
            return bool(starved.any())
        look = engine._look
        win = np.full(act.size, float(engine.LOOKAHEAD))
        if look:
            for i, rank in enumerate(self.servers):
                w = look.get(rank)
                if w is not None:
                    win[i] = w
        share = -(-(total * cons) // total_c)
        need = np.minimum(share, win.astype(np.int64) * cons)
        return bool(((cons > 0) & (2 * raw < need)).any())

    # -- materialization (legacy dict path: pump rounds, py solvers) -------

    def kept_reqs(self, rank: int) -> list:
        srv = self._srv[rank]
        idx = np.flatnonzero(srv.r_elig)
        if srv.round_sup.size:
            idx = np.setdiff1d(idx, srv.round_sup, assume_unique=True)
        reqs = srv.reqs
        return [reqs[i] for i in idx.tolist()]

    def elig_tasks(self, rank: int) -> list:
        srv = self._srv[rank]
        tasks = srv.tasks
        return [tasks[i] for i in np.flatnonzero(srv.t_elig).tolist()]

    # -- solver view -------------------------------------------------------

    def _pack_tasks(self, srv: _Srv) -> None:
        s = srv.slot
        K = self.K
        kidx = np.flatnonzero(srv.t_elig)[:K]
        k = kidx.size
        self.pk_tp[s, :] = _NEG
        self.pk_tt[s, :] = -1
        if k:
            self.pk_tp[s, :k] = srv.t_prio[kidx]
            self.pk_tt[s, :k] = srv.t_tix[kidx]
        refs = self.pk_trefs[s]
        rank = srv.rank
        seqs = srv.t_seq
        for i in range(K):
            refs[i] = (rank, int(seqs[kidx[i]])) if i < k else None
        self.t_gen[s] = self._bump()

    def _pack_reqs(self, srv: _Srv) -> None:
        s = srv.slot
        R = self.R
        idx = np.flatnonzero(srv.r_elig)
        if srv.round_sup.size:
            idx = np.setdiff1d(idx, srv.round_sup, assume_unique=True)
        idx = idx[:R]
        k = idx.size
        self.pk_rv[s, :] = False
        self.pk_rm[s, :, :] = False
        if k:
            self.pk_rv[s, :k] = True
            self.pk_rm[s, :k, :] = srv.r_mask[idx]
        refs = self.pk_rrefs[s]
        rank = srv.rank
        rr, rs = srv.r_rank, srv.r_seq
        ilist = idx.tolist()
        for i in range(R):
            refs[i] = (
                (rank, int(rr[ilist[i]]), int(rs[ilist[i]]))
                if i < k else None
            )
        self.r_gen[s] = self._bump()

    def view(self) -> "ArrayLedger":
        """Freshen the packed rows of every server whose eligibility or
        suppression changed since the last view, then hand out the
        resident arrays (self doubles as the view object)."""
        for rank in self._stale_tk:
            srv = self._srv.get(rank)
            if srv is not None:
                self._pack_tasks(srv)
        for rank in self._stale_rq:
            srv = self._srv.get(rank)
            if srv is not None:
                self._pack_reqs(srv)
        self._stale_tk.clear()
        self._stale_rq.clear()
        return self

    @property
    def slot_order(self) -> np.ndarray:
        return self._order

    def slot_of(self, rank: int) -> int:
        return self._srv[rank].slot

    def t_gen_of(self, rank: int) -> int:
        return int(self.t_gen[self._srv[rank].slot])

    def r_gen_of(self, rank: int) -> int:
        return int(self.r_gen[self._srv[rank].slot])

    def parked_updates(self, now: float) -> list:
        """Drain the (rank, stamp) park events of this sync (stampless
        snapshots report the round's now, like the Python loop they
        replace)."""
        out = [
            (r, s if s is not None else now) for r, s in self._parked
        ]
        self._parked.clear()
        return out

    def rows_resident(self) -> int:
        return sum(s.r_n + s.t_n for s in self._srv.values())
