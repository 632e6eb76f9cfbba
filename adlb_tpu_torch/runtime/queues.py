"""Server-side queue structures.

Functional equivalent of the reference's ``xq`` library and its five
specialized queues (reference ``src/xq.h:91-134``, ``src/xq.c``), redesigned
around indexes instead of linear scans:

* the reference finds the highest-priority matching unit by walking a doubly
  linked list per Reserve — O(|wq| * ntypes) (reference ``src/xq.c:190-247``);
  here each (type) and (target, type) bucket is a lazy-deletion binary heap, so
  match/insert/remove are O(log n).

The semantic contract preserved from the reference:

* highest ``work_prio`` (algebraically largest) wins; FIFO among equal
  priorities (heap key includes the monotone seqno);
* work targeted at rank R is only ever handed to R, and targeted work takes
  precedence over untargeted work for its target (reference
  ``src/adlb.c:1204-1237``);
* pinned units (reserved but not yet fetched) are invisible to matching
  (reference ``src/xq.h:44-45``, ``src/xq.c:199-201``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Iterable, Optional

from adlb_tpu_torch.types import ADLB_LOWEST_PRIO


@dataclasses.dataclass
class WorkUnit:
    """One queued unit of work, metadata + opaque payload bytes.

    Field set mirrors the reference's ``wq_struct_t`` (reference
    ``src/xq.h:39-56``).
    """

    seqno: int
    work_type: int
    prio: int
    target_rank: int  # -1 = untargeted
    answer_rank: int
    payload: bytes
    home_server: int = -1
    common_len: int = 0
    common_server_rank: int = -1
    common_seqno: int = -1
    pinned: bool = False
    pin_rank: int = -1
    time_stamp: float = dataclasses.field(default_factory=time.monotonic)
    # failure attempts: how many times delivery of this unit failed
    # (owner-death reclaim, lease expiry, undeliverable response).
    # Survives re-enqueue, memory-pressure push, and failover replay;
    # exceeding Config(max_unit_retries) quarantines the unit instead of
    # re-enqueueing it (bounded blast radius for poison units).
    attempts: int = 0
    # job namespace (service mode): 0 = the default/legacy namespace.
    # A unit only ever matches requesters of its own job; non-default
    # jobs live in their own wq partition (PartitionedWorkQueue) with
    # per-job termination and per-tenant admission quotas.
    job: int = 0
    # disk spill tier (Config(spill_dir), runtime/spill.py): when the
    # payload has been spilled, ``payload`` is empty and ``spill_len``
    # remembers its true size; Server._unspill faults it back in before
    # any delivery/ship/snapshot path reads the bytes.
    spilled: bool = False
    spill_len: int = 0
    # unit-lifecycle trace context (Config(trace_sample), obs/journey.py):
    # 0 / None for the unsampled ~everything. A sampled unit carries the
    # client-minted trace id and its accumulated (stage, rank, t_mono)
    # span list; both travel with the unit across every path that moves
    # it (push, migrate, fused relay, replication, WAL).
    trace_id: int = 0
    spans: Optional[list] = None

    @property
    def work_len(self) -> int:
        n = self.spill_len if self.spilled else len(self.payload)
        return n + self.common_len

    @property
    def payload_len(self) -> int:
        """True payload size whether resident or spilled — metadata
        paths (balancer snapshots, push queries) must not read a
        spilled unit as empty."""
        return self.spill_len if self.spilled else len(self.payload)


class WorkQueue:
    """Indexed priority work queue (the reference's ``wq``)."""

    def __init__(self) -> None:
        self._units: dict[int, WorkUnit] = {}
        # type -> heap of (-prio, seqno) over unpinned untargeted units
        self._untargeted: dict[int, list[tuple[int, int]]] = {}
        # (target_rank, type) -> heap of (-prio, seqno) over unpinned targeted units
        self._targeted: dict[tuple[int, int], list[tuple[int, int]]] = {}
        # target_rank -> types with a (possibly stale) bucket, so any-type
        # targeted lookups touch only this rank's buckets, not every
        # (rank, type) pair ever seen; pruned as buckets drain
        self._targeted_types: dict[int, set[int]] = {}
        self.count = 0
        self.max_count = 0
        self.total_bytes = 0
        # O(1) availability signal for the balancer's snapshot gating:
        # number of unpinned untargeted units (exact, unlike the lazy heaps)
        self.untargeted_avail = 0

    # -- insertion / removal -------------------------------------------------

    def add(self, unit: WorkUnit) -> None:
        assert unit.seqno not in self._units
        self._units[unit.seqno] = unit
        self.count += 1
        self.max_count = max(self.max_count, self.count)
        self.total_bytes += len(unit.payload)
        if not unit.pinned:
            self._index(unit)
            if unit.target_rank < 0:
                self.untargeted_avail += 1

    def _index(self, unit: WorkUnit) -> None:
        key = (-unit.prio, unit.seqno)
        if unit.target_rank < 0:
            heapq.heappush(self._untargeted.setdefault(unit.work_type, []), key)
        else:
            heapq.heappush(
                self._targeted.setdefault((unit.target_rank, unit.work_type), []), key
            )
            self._targeted_types.setdefault(unit.target_rank, set()).add(
                unit.work_type
            )

    def get(self, seqno: int) -> Optional[WorkUnit]:
        return self._units.get(seqno)

    def remove(self, seqno: int) -> WorkUnit:
        unit = self._units.pop(seqno)
        self.count -= 1
        self.total_bytes -= len(unit.payload)
        if not unit.pinned and unit.target_rank < 0:
            self.untargeted_avail -= 1
        return unit  # stale heap entries are skipped lazily

    # -- pin discipline ------------------------------------------------------

    def pin(self, seqno: int, rank: int) -> None:
        unit = self._units[seqno]
        if not unit.pinned and unit.target_rank < 0:
            self.untargeted_avail -= 1
        unit.pinned = True
        unit.pin_rank = rank
        # heap entry goes stale; skipped on pop

    def unpin(self, seqno: int) -> None:
        unit = self._units[seqno]
        if unit.pinned and unit.target_rank < 0:
            self.untargeted_avail += 1
        unit.pinned = False
        unit.pin_rank = -1
        self._index(unit)

    # -- matching ------------------------------------------------------------

    def _pop_best(
        self, heap: Optional[list[tuple[int, int]]], targeted_to: int
    ) -> Optional[WorkUnit]:
        """Peek the best live entry of a lazy heap, discarding stale tops."""
        if not heap:
            return None
        while heap:
            neg_prio, seqno = heap[0]
            unit = self._units.get(seqno)
            if (
                unit is None
                or unit.pinned
                or unit.prio != -neg_prio
                or (targeted_to >= 0 and unit.target_rank != targeted_to)
                or (targeted_to < 0 and unit.target_rank >= 0)
            ):
                heapq.heappop(heap)  # stale
                continue
            return unit
        return None

    def _best_of(
        self, heaps: Iterable[tuple[Optional[list[tuple[int, int]]], int]]
    ) -> Optional[WorkUnit]:
        best: Optional[WorkUnit] = None
        for heap, targeted_to in heaps:
            unit = self._pop_best(heap, targeted_to)
            if unit is not None and (
                best is None
                or unit.prio > best.prio
                or (unit.prio == best.prio and unit.seqno < best.seqno)
            ):
                best = unit
        return best

    def find_targeted(self, rank: int, req_types: Optional[frozenset[int]]) -> Optional[WorkUnit]:
        """Best unpinned unit targeted at `rank` with a requested type.

        req_types None means "any type" (reference ADLB_RESERVE_REQUEST_ANY).
        """
        types = self._targeted_types.get(rank)
        if not types:
            return None
        cand = types if req_types is None else types & req_types
        best: Optional[WorkUnit] = None
        for t in list(cand):
            heap = self._targeted.get((rank, t))
            unit = self._pop_best(heap, rank)
            if unit is None:
                if not heap:  # fully drained: prune (unpin re-indexes)
                    self._targeted.pop((rank, t), None)
                    types.discard(t)
                continue
            if best is None or unit.prio > best.prio or (
                unit.prio == best.prio and unit.seqno < best.seqno
            ):
                best = unit
        if not types:
            del self._targeted_types[rank]
        return best

    def find_untargeted(self, req_types: Optional[frozenset[int]]) -> Optional[WorkUnit]:
        """Best unpinned untargeted unit of a requested type."""
        if req_types is None:
            types: Iterable[int] = list(self._untargeted.keys())
        else:
            types = req_types
        return self._best_of((self._untargeted.get(t), -1) for t in types)

    def find_match(self, rank: int, req_types: Optional[frozenset[int]]) -> Optional[WorkUnit]:
        """Reference match order: work targeted at the requester first, then
        best untargeted by priority (reference ``src/adlb.c:1204-1237``)."""
        unit = self.find_targeted(rank, req_types)
        if unit is not None:
            return unit
        return self.find_untargeted(req_types)

    def find_unpinned(self) -> Optional[WorkUnit]:
        """Any unpinned unit — used by the memory-pressure push path
        (reference ``src/xq.c:266-281``). Prefers untargeted (moving targeted
        work requires directory fixups), lowest priority first so urgent work
        stays local."""
        worst: Optional[WorkUnit] = None
        for unit in self._units.values():
            if unit.pinned:
                continue
            if unit.target_rank < 0 and (worst is None or unit.prio < worst.prio):
                worst = unit
        if worst is not None:
            return worst
        for unit in self._units.values():
            if not unit.pinned:
                return unit
        return None

    # -- stats for gossip / balancer -----------------------------------------

    def num_unpinned(self) -> int:
        """All unpinned units. The exhaustion vote compares this against
        ``count``: a difference means pinned units, i.e. handoffs still in
        flight, and the server cannot vote 'exhausted'."""
        return sum(1 for u in self._units.values() if not u.pinned)

    def num_unpinned_untargeted(self) -> int:
        return sum(
            1 for u in self._units.values() if not u.pinned and u.target_rank < 0
        )

    def hi_prio_of_type(self, work_type: int) -> int:
        """Highest priority among available (unpinned, untargeted) units of a
        type, or ADLB_LOWEST_PRIO — one cell of the reference's qmstat vector
        (reference ``src/adlb.c:151-159``)."""
        unit = self._pop_best(self._untargeted.get(work_type), -1)
        return unit.prio if unit is not None else ADLB_LOWEST_PRIO

    def count_of_type(self, work_type: int) -> tuple[int, int]:
        """(total units of type, total bytes) — for Info_num_work_units
        (reference ``src/adlb.c:2466-2496``)."""
        n = 0
        nbytes = 0
        for u in self._units.values():
            if u.work_type == work_type:
                n += 1
                nbytes += u.work_len
        return n, nbytes

    def units(self) -> Iterable[WorkUnit]:
        return self._units.values()

    def depth_sample(self) -> tuple[int, int, int]:
        """(count, unpinned-untargeted, bytes) at O(1) — the periodic
        observability tick's queue-depth gauges (the native core has an
        identical twin, adlb_tpu_torch/native/wq.py)."""
        return self.count, self.untargeted_avail, self.total_bytes


class PartitionedWorkQueue:
    """Per-job wq partitions behind the single-queue surface.

    Job 0 (the default/legacy namespace) keeps whatever implementation
    the config picked — including the C++ core — so single-job worlds
    run exactly the code they always did. Non-default jobs each get
    their own pure-Python :class:`WorkQueue` partition, created lazily
    on first unit and dropped when the job is killed. Seqnos stay a
    single server-wide sequence, so unit-addressed operations (get /
    pin / unpin / remove) route through a seqno->job index and every
    existing call site works unchanged; matching calls gain an optional
    ``job`` argument so a requester only ever sees its own namespace.
    """

    def __init__(self, factory) -> None:
        self._factory = factory
        self._parts: dict[int, object] = {0: factory()}
        self._job_of: dict[int, int] = {}  # seqno -> job, job != 0 only
        self._max_count = 0

    # -- partition plumbing --------------------------------------------------

    def part(self, job: int = 0):
        """The job's partition, or None when it holds nothing (job 0
        always exists)."""
        return self._parts.get(job)

    def _part_of(self, seqno: int):
        return self._parts[self._job_of.get(seqno, 0)]

    def job_ids(self) -> list[int]:
        """Non-default jobs with a (possibly empty) partition."""
        return [j for j in self._parts if j != 0]

    def has_job_units(self, min_job: int = 1) -> bool:
        """Any units queued in namespaces >= ``min_job``? The default 1
        asks about ALL non-default jobs; the tpu balancer passes its
        ``balancer_max_jobs`` so only OVERFLOW namespaces (beyond the
        planner's horizon, served by the qmstat/RFR fallback) count."""
        return any(p.count for j, p in self._parts.items() if j >= min_job)

    def drop_job(self, job: int) -> list[WorkUnit]:
        """Remove a killed job's whole partition; returns its units so
        the caller can settle memory accounting."""
        if job == 0:
            return []  # job 0 is never dropped
        part = self._parts.pop(job, None)
        if part is None:
            return []
        units = list(part.units())
        for u in units:
            self._job_of.pop(u.seqno, None)
        return units

    # -- insertion / removal / pin (seqno-routed) ----------------------------

    def add(self, unit: WorkUnit) -> None:
        job = getattr(unit, "job", 0)
        part = self._parts.get(job)
        if part is None:
            # non-default partitions are always pure-Python: the C++
            # core has no job column, and job partitions are small
            part = self._parts[job] = WorkQueue()
        if job != 0:
            self._job_of[unit.seqno] = job
        part.add(unit)
        self._max_count = max(self._max_count, self.count)

    def get(self, seqno: int) -> Optional[WorkUnit]:
        return self._part_of(seqno).get(seqno)

    def remove(self, seqno: int) -> WorkUnit:
        part = self._part_of(seqno)
        self._job_of.pop(seqno, None)
        return part.remove(seqno)

    def pin(self, seqno: int, rank: int) -> None:
        self._part_of(seqno).pin(seqno, rank)

    def unpin(self, seqno: int) -> None:
        self._part_of(seqno).unpin(seqno)

    # -- matching ------------------------------------------------------------

    def find_targeted(self, rank, req_types, job: int = 0):
        part = self._parts.get(job)
        return None if part is None else part.find_targeted(rank, req_types)

    def find_untargeted(self, req_types, job: int = 0):
        part = self._parts.get(job)
        return None if part is None else part.find_untargeted(req_types)

    def find_match(self, rank, req_types, job: int = 0):
        part = self._parts.get(job)
        return None if part is None else part.find_match(rank, req_types)

    def find_unpinned(self) -> Optional[WorkUnit]:
        # memory-pressure pushes move job-0 work only: job partitions
        # are quota-bounded at admission instead
        return self._parts[0].find_unpinned()

    # -- aggregates ----------------------------------------------------------

    @property
    def count(self) -> int:
        return sum(p.count for p in self._parts.values())

    @property
    def max_count(self) -> int:
        return max(self._max_count, self._parts[0].max_count)

    @property
    def total_bytes(self) -> int:
        return sum(p.total_bytes for p in self._parts.values())

    @property
    def untargeted_avail(self) -> int:
        return sum(p.untargeted_avail for p in self._parts.values())

    def num_unpinned(self) -> int:
        return sum(p.num_unpinned() for p in self._parts.values())

    def num_unpinned_untargeted(self) -> int:
        # qmstat's qlen cell: job-0 inventory only (job work is never
        # stolen type-blind; per-job prios ride the jq gossip table)
        return self._parts[0].num_unpinned_untargeted()

    def hi_prio_of_type(self, work_type: int, job: int = 0) -> int:
        part = self._parts.get(job)
        return ADLB_LOWEST_PRIO if part is None else part.hi_prio_of_type(
            work_type
        )

    def job_hi_prio(self) -> dict:
        """{(job, type): best prio} over non-default partitions — the
        per-job qmstat gossip cells (only nonempty types appear).
        Reads each partition's per-type untargeted index (O(jobs x
        live types) per gossip tick), not a unit scan — non-default
        partitions are always the pure-Python WorkQueue, whose lazy
        heaps hi_prio_of_type already de-stales."""
        out = {}
        for j, p in self._parts.items():
            if j == 0 or not p.count:
                continue
            for t in list(p._untargeted.keys()):
                prio = p.hi_prio_of_type(t)
                if prio > ADLB_LOWEST_PRIO:
                    out[(j, t)] = prio
        return out

    def count_of_type(self, work_type: int) -> tuple[int, int]:
        n = 0
        nbytes = 0
        for p in self._parts.values():
            pn, pb = p.count_of_type(work_type)
            n += pn
            nbytes += pb
        return n, nbytes

    def units(self) -> Iterable[WorkUnit]:
        for p in self._parts.values():
            yield from p.units()

    def depth_sample(self) -> tuple[int, int, int]:
        c, a, b = 0, 0, 0
        for p in self._parts.values():
            pc, pa, pb = p.depth_sample()
            c += pc
            a += pa
            b += pb
        return c, a, b

    def __getattr__(self, name):
        if name == "snapshot_untargeted":
            # balancer fast path: present only when the job-0 partition
            # (the native core) provides it — callers getattr-probe
            return getattr(self._parts[0], "snapshot_untargeted")
        raise AttributeError(name)


@dataclasses.dataclass
class RqEntry:
    """A parked (blocking) Reserve waiting for work (reference
    ``src/xq.h:58-64``). ``fetch`` marks a fused reserve+get (this
    framework's extension): when the match is local and prefix-free the
    payload rides the response. ``prefetch`` marks a pipelined
    ``get_work_stream`` reserve: the rank may still be computing while
    this entry is parked, so it only counts as idle for exhaustion
    voting once the client sends FA_STREAM_IDLE. ``job`` is the
    requester's attached namespace: an entry only ever matches units of
    its own job."""

    world_rank: int
    rqseqno: int
    req_types: Optional[frozenset[int]]  # None = any
    time_stamp: float = dataclasses.field(default_factory=time.monotonic)
    fetch: bool = False
    prefetch: bool = False
    job: int = 0

    def wants(self, work_type: int) -> bool:
        return self.req_types is None or work_type in self.req_types


class ReserveQueue:
    """Waiting requesters, FIFO within compatibility (the reference's ``rq``).

    Since the prefetch pipeline, one rank may park SEVERAL entries at once
    (up to its stream depth); matching stays globally FIFO across entries.
    The global order is an insertion-ordered dict keyed ``(rank, rqseqno)``
    so the per-delivery hot path (remove one entry, demote the rank's
    siblings) costs O(1)/O(depth), not a full-list scan — this runs on
    the GIL-holding reactor thread for every satisfied reserve.
    """

    def __init__(self) -> None:
        # (world_rank, rqseqno) -> entry, in global park order
        self._order: "dict[tuple[int, int], RqEntry]" = {}
        self._by_rank: dict[int, list[RqEntry]] = {}

    @staticmethod
    def _key(entry: RqEntry) -> tuple[int, int]:
        return (entry.world_rank, entry.rqseqno)

    def add(self, entry: RqEntry) -> None:
        self._order[self._key(entry)] = entry
        self._by_rank.setdefault(entry.world_rank, []).append(entry)

    def remove_entry(self, entry: RqEntry) -> Optional[RqEntry]:
        """Remove one specific parked entry (multi-entry ranks must not
        drop a sibling pipeline slot)."""
        key = self._key(entry)
        if key not in self._order:
            return None
        del self._order[key]
        own = self._by_rank.get(entry.world_rank)
        if own is not None:
            try:
                own.remove(entry)  # O(depth): pipeline lists are short
            except ValueError:
                pass
            if not own:
                del self._by_rank[entry.world_rank]
        return entry

    def remove(self, world_rank: int) -> Optional[RqEntry]:
        """Remove and return the rank's OLDEST entry (legacy single-entry
        call shape)."""
        own = self._by_rank.get(world_rank)
        if not own:
            return None
        return self.remove_entry(own[0])

    def remove_rank(self, world_rank: int) -> list[RqEntry]:
        """Remove every entry a rank holds (rank death / finalize)."""
        removed = []
        while world_rank in self._by_rank:
            removed.append(self.remove_entry(self._by_rank[world_rank][0]))
        return removed

    def remove_prefetch(self, world_rank: int) -> list[RqEntry]:
        """Remove the rank's prefetch (stream) entries only — stream
        cancel must not cancel a concurrent blocking reserve."""
        doomed = [e for e in self._by_rank.get(world_rank, ()) if e.prefetch]
        for e in doomed:
            self.remove_entry(e)
        return doomed

    def find_for_type(self, work_type: int, target_rank: int = -1,
                      job: int = 0) -> Optional[RqEntry]:
        """First waiting requester a fresh unit could satisfy (reference
        ``src/xq.c:352-444`` via ``rq_find_rank_queued_for_type``); the
        unit's job namespace must match the entry's."""
        if target_rank >= 0:
            own = self._by_rank.get(target_rank)
            if not own:
                return None
            for e in own:
                if e.job == job and e.wants(work_type):
                    return e
            return None
        for e in self._order.values():
            if e.job == job and e.wants(work_type):
                return e
        return None

    def find_entry(self, world_rank: int, rqseqno: int) -> Optional[RqEntry]:
        for e in self._by_rank.get(world_rank, ()):
            if e.rqseqno == rqseqno:
                return e
        return None

    def demote_rank(self, world_rank: int) -> None:
        """Move the rank's remaining entries to the back of the global
        park order (relative order kept). Called after delivering to the
        rank: its sibling pipeline slots are adjacent in FIFO order, and
        without the demotion a scarce trickle of units piles onto one
        streaming consumer's bank (serialized behind its compute) while
        other consumers idle. O(rank's depth): re-inserting a key moves
        it to the tail of the insertion order."""
        own = self._by_rank.get(world_rank)
        if not own or len(self._order) == len(own):
            return
        for e in own:
            key = self._key(e)
            del self._order[key]
            self._order[key] = e

    def count_for(self, world_rank: int) -> int:
        """Number of entries a rank currently has parked."""
        return len(self._by_rank.get(world_rank, ()))

    def ids_for(self, world_rank: int) -> set[int]:
        """The rank's parked rqseqnos — the idle-note reconciliation
        reads these per rank, not via a global scan."""
        return {e.rqseqno for e in self._by_rank.get(world_rank, ())}

    def has_blocking(self, world_rank: int) -> bool:
        """True when the rank holds at least one NON-prefetch entry —
        i.e. the app is synchronously blocked in reserve/get_work."""
        return any(
            not e.prefetch for e in self._by_rank.get(world_rank, ())
        )

    def waiting_ranks(self) -> list[int]:
        return list(self._by_rank)

    def oldest_age(self, now: float, stream_idle=None) -> float:
        """Age of the longest-parked requester (0 when none) — the
        observability tick's park-age gauge, the direct signal behind a
        'flat wait' shape (every tick shows someone parked this long).
        Prefetch (stream) parks of a rank NOT in ``stream_idle`` are
        excluded: the consumer is computing while its slots wait, which
        is the pipeline working as designed, not a wait."""
        ages = [
            now - e.time_stamp
            for e in self._order.values()
            if not e.prefetch
            or (stream_idle is not None and e.world_rank in stream_idle)
        ]
        return max(ages, default=0.0)

    def entries(self) -> list[RqEntry]:
        return list(self._order.values())

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, world_rank: int) -> bool:
        return world_rank in self._by_rank


class TargetedDirectory:
    """Home server's directory of *off-home* targeted work (the reference's
    ``tq``, ``src/xq.h:73-79``): for each (app_rank, type), on which remote
    server targeted units currently sit and how many. Indexed per app rank so
    lookups touch only that rank's entries."""

    def __init__(self) -> None:
        self._d: dict[int, dict[int, dict[int, int]]] = {}  # rank -> type -> server -> n

    def add(self, app_rank: int, work_type: int, server_rank: int, n: int = 1) -> None:
        by_type = self._d.setdefault(app_rank, {})
        by_server = by_type.setdefault(work_type, {})
        by_server[server_rank] = by_server.get(server_rank, 0) + n
        if by_server[server_rank] <= 0:
            del by_server[server_rank]
            if not by_server:
                del by_type[work_type]
                if not by_type:
                    del self._d[app_rank]

    def remove(self, app_rank: int, work_type: int, server_rank: int, n: int = 1) -> None:
        self.add(app_rank, work_type, server_rank, -n)

    def lookup(
        self, app_rank: int, req_types: Optional[frozenset[int]]
    ) -> Optional[tuple[int, int]]:
        """(remote server rank, work_type) believed to hold work targeted at
        app_rank, or None."""
        by_type = self._d.get(app_rank)
        if not by_type:
            return None
        for wt, by_server in by_type.items():
            if req_types is not None and wt not in req_types:
                continue
            for server_rank in by_server:
                return server_rank, wt
        return None

    def drop_rank(self, app_rank: int) -> None:
        """Forget every directory entry for a dead target: the remote units
        themselves are dropped by their holders on SS_RANK_DEAD, so a
        surviving entry would only misdirect future RFRs."""
        self._d.pop(app_rank, None)

    def repoint(self, old_server: int, new_server: int) -> None:
        """Server failover: units believed held at ``old_server`` now live
        at its buddy (the replica replay re-enqueued them), so every
        directory count moves. Off-by-replication-lag entries are
        harmless — an RFR miss patches them like any stale belief."""
        for by_type in self._d.values():
            for by_server in by_type.values():
                n = by_server.pop(old_server, 0)
                if n:
                    by_server[new_server] = by_server.get(new_server, 0) + n


@dataclasses.dataclass
class Lease:
    """Ownership record for a reserved/pinned unit: which rank holds the
    reservation, when it was granted, and a per-server lease id (for the
    failure-timeline events). No reference analogue — upstream's pins are
    anonymous because a dead owner kills the whole job anyway; under
    ``on_worker_failure="reclaim"`` the owner matters: its death turns
    every lease it holds back into queued work."""

    seqno: int
    owner: int
    lease_id: int
    granted_at: float = dataclasses.field(default_factory=time.monotonic)
    # last explicit extension (ctx.extend_lease / FA_HEARTBEAT with a
    # seqno): the expiry scan ages a lease from max(granted_at,
    # renewed_at, owner's last-heard), so a long unit can opt out of the
    # timeout without touching the owner-wide liveness clock
    renewed_at: float = 0.0


class LeaseTable:
    """seqno -> :class:`Lease` for every currently pinned unit, with an
    owner index so reclaiming a dead rank is O(its leases), not O(wq)."""

    def __init__(self) -> None:
        self._by_seqno: dict[int, Lease] = {}
        self._by_owner: dict[int, set[int]] = {}
        self._next_id = 1

    def grant(self, seqno: int, owner: int) -> Lease:
        lease = Lease(seqno=seqno, owner=owner, lease_id=self._next_id)
        self._next_id += 1
        self._by_seqno[seqno] = lease
        self._by_owner.setdefault(owner, set()).add(seqno)
        return lease

    def renew(self, seqno: int, now: Optional[float] = None) -> bool:
        """Explicit lease extension; False when no such lease exists
        (already expired/consumed — the caller's op will be fenced or
        retried through the normal paths)."""
        lease = self._by_seqno.get(seqno)
        if lease is None:
            return False
        lease.renewed_at = time.monotonic() if now is None else now
        return True

    def leases(self) -> Iterable[Lease]:
        """Snapshot of every outstanding lease (the expiry scan mutates
        the table while iterating)."""
        return list(self._by_seqno.values())

    def oldest_age(self, now: float) -> float:
        """Age of the oldest outstanding lease (0 when none) — the
        lease_age_max_s gauge."""
        return max(
            (now - max(ls.granted_at, ls.renewed_at)
             for ls in self._by_seqno.values()),
            default=0.0,
        )

    def release(self, seqno: int) -> Optional[Lease]:
        lease = self._by_seqno.pop(seqno, None)
        if lease is not None:
            owned = self._by_owner.get(lease.owner)
            if owned is not None:
                owned.discard(seqno)
                if not owned:
                    del self._by_owner[lease.owner]
        return lease

    def owned_by(self, owner: int) -> list[Lease]:
        return [
            self._by_seqno[s] for s in sorted(self._by_owner.get(owner, ()))
        ]

    def get(self, seqno: int) -> Optional[Lease]:
        return self._by_seqno.get(seqno)

    def __len__(self) -> int:
        return len(self._by_seqno)


class CommonStore:
    """Batch-put common-prefix store (the reference's ``cq``,
    ``src/xq.h:81-88``): a shared prefix stored once, refcounted, GC'd when
    every member of the batch has been fetched (reference
    ``src/adlb.c:1135-1160``)."""

    @dataclasses.dataclass
    class Entry:
        seqno: int
        buf: bytes
        refcnt: int = -1  # -1 until End_batch_put ships the final count
        ngets: int = 0
        credits: int = 0  # extra expected gets granted before refcnt known

    def __init__(self, on_gc=None) -> None:
        self._entries: dict[int, CommonStore.Entry] = {}
        self._next_seqno = 1
        self._on_gc = on_gc  # called with the entry when its bytes are freed

    def put(self, buf: bytes) -> int:
        seqno = self._next_seqno
        self._next_seqno += 1
        self._entries[seqno] = CommonStore.Entry(seqno, buf)
        return seqno

    def entries(self) -> list["CommonStore.Entry"]:
        return list(self._entries.values())

    def restore(self, seqno: int, refcnt: int, ngets: int, buf: bytes) -> None:
        """Re-install a checkpointed entry under its original seqno (handles
        and queued units reference it by number)."""
        self._entries[seqno] = CommonStore.Entry(seqno, buf, refcnt, ngets)
        self._next_seqno = max(self._next_seqno, seqno + 1)

    def adopt(self, buf: bytes, refcnt: int, ngets: int,
              credits: int = 0) -> int:
        """Install a prefix taken over from a dead server's replica under
        a FRESH seqno (its original seqno may collide with this store's);
        the caller records the (dead server, old seqno) -> new seqno
        translation. Returns the new seqno — possibly already GC'd when
        the replayed refcount state was already satisfied."""
        seqno = self._next_seqno
        self._next_seqno += 1
        e = CommonStore.Entry(seqno, buf, refcnt, ngets, credits)
        self._entries[seqno] = e
        self._maybe_gc(e)
        return seqno

    def set_refcnt(self, seqno: int, refcnt: int) -> None:
        e = self._entries.get(seqno)
        if e is None:
            return
        e.refcnt = refcnt + e.credits
        e.credits = 0
        self._maybe_gc(e)

    def get(self, seqno: int) -> Optional[bytes]:
        """Prefix bytes, or None when the entry is gone — callers must
        surface an error rather than KeyError the server reactor (a
        reclaim double-get race can outrun a credit; see credit())."""
        e = self._entries.get(seqno)
        if e is None:
            return None
        buf = e.buf
        e.ngets += 1
        self._maybe_gc(e)
        return buf

    def peek(self, seqno: int) -> Optional[bytes]:
        """Prefix bytes without counting a get — for re-serving a
        duplicate (re-sent) fetch that was already accounted."""
        e = self._entries.get(seqno)
        return e.buf if e is not None else None

    def credit(self, seqno: int) -> None:
        """Expect one additional get: a leased member unit was reclaimed
        from a dead owner who may already have fetched the prefix, so its
        re-consumption can fetch it a second time. Without the credit
        that second get could push ngets past refcnt early and GC the
        prefix out from under surviving members; with it, the worst case
        is a prefix that outlives its batch until world teardown (the
        dead owner never actually fetched) — a bounded leak, not a
        crash."""
        e = self._entries.get(seqno)
        if e is None:
            return  # already GC'd: the defensive get() covers the rest
        if e.refcnt >= 0:
            e.refcnt += 1
        else:
            e.credits += 1

    def forfeit(self, seqno: int) -> None:
        """Account a get that will never happen: a batch member referencing
        this prefix was dropped (targeted at a dead rank). Without this the
        refcount never reaches ngets and the prefix bytes leak for the rest
        of the run."""
        e = self._entries.get(seqno)
        if e is None:
            return  # already GC'd (every live member fetched first)
        e.ngets += 1
        self._maybe_gc(e)

    def _maybe_gc(self, e: "CommonStore.Entry") -> None:
        if e.refcnt >= 0 and e.ngets >= e.refcnt:
            del self._entries[e.seqno]
            if self._on_gc is not None:
                self._on_gc(e)

    def __len__(self) -> int:
        return len(self._entries)


class MemoryAccountant:
    """Per-server byte budget and admission control (reference
    ``src/adlb.c:3419-3474``): puts beyond the cap are rejected (the client
    retries elsewhere), and crossing ``push_threshold`` triggers
    memory-pressure pushes to less-loaded servers."""

    PUSH_FRACTION = 0.95  # reference THRESHOLD_TO_START_PUSH (src/adlb.c:93)

    def __init__(self, max_bytes: float, soft_frac: Optional[float] = None,
                 hard_frac: float = 0.0) -> None:
        self.max_bytes = max_bytes
        # soft watermark: pushes engage above it (reference semantics at
        # the default); hard watermark: 0 = backpressure off, else puts
        # above it with no eligible push destination answer ADLB_BACKOFF
        self.soft_frac = (
            self.PUSH_FRACTION if soft_frac is None else soft_frac
        )
        self.hard_frac = hard_frac
        self.curr = 0
        self.total = 0
        self.hwm = 0
        # disk spill tier: bytes whose payloads live in the spill file
        # instead of RAM. ``curr`` is RESIDENT bytes only — watermarks,
        # pushes, and admission all act on what actually occupies
        # memory; ``curr + spilled`` is the logical pool size.
        self.spilled = 0

    def try_alloc(self, nbytes: int) -> bool:
        """Admission-controlled alloc for puts (reference ``pmalloc``)."""
        if self.max_bytes > 0 and self.curr + nbytes > self.max_bytes:
            return False
        self.alloc(nbytes)
        return True

    def alloc(self, nbytes: int) -> None:
        self.curr += nbytes
        self.total += nbytes
        self.hwm = max(self.hwm, self.curr)

    def free(self, nbytes: int) -> None:
        self.curr -= nbytes

    def note_spill(self, nbytes: int) -> None:
        """Payload moved RAM -> spill file: resident shrinks, the bytes
        stay accounted to the pool."""
        self.curr -= nbytes
        self.spilled += nbytes

    def note_faultin(self, nbytes: int) -> None:
        """Payload moved spill file -> RAM."""
        self.curr += nbytes
        self.spilled -= nbytes
        self.hwm = max(self.hwm, self.curr)

    def note_spill_drop(self, nbytes: int) -> None:
        """A spilled payload was discarded outright (dead target, killed
        job) — it never returns to residency."""
        self.spilled -= nbytes

    @property
    def under_pressure(self) -> bool:
        return self.max_bytes > 0 and self.curr > self.soft_frac * self.max_bytes

    @property
    def pressure(self) -> float:
        """Fill fraction (0 when uncapped) — the mem_pressure gauge."""
        return self.curr / self.max_bytes if self.max_bytes > 0 else 0.0

    def above_hard(self, nbytes: int = 0) -> bool:
        """Would admitting nbytes cross the hard watermark? Always False
        when backpressure is off (hard_frac == 0) or uncapped."""
        return (
            self.hard_frac > 0
            and self.max_bytes > 0
            and self.curr + nbytes > self.hard_frac * self.max_bytes
        )

    def has_room(self, nbytes: int) -> bool:
        return self.max_bytes <= 0 or self.curr + nbytes <= self.soft_frac * self.max_bytes
