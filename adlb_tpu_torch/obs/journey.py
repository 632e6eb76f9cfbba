"""Unit-lifecycle tracing: per-unit journeys through the fleet.

The SLO sensor layer: a sampled work unit (``Config(trace_sample)``
head-sampling at put — the client mints a ``trace_id`` that rides
``FA_PUT`` as codec field 98) accumulates a span list of
``(stage, rank, t_mono)`` tuples as it moves through the system:

    put_recv -> enqueue -> [wal_commit] -> [migrate | push | expire |
    adopt | replay]* -> match -> [relay] -> deliver -> finalize

The span list lives ON the unit (``WorkUnit.spans``) so every path that
moves a unit moves its history with it: ``SS_PUSH_WORK``,
``SS_MIGRATE_WORK``, the fused-relay ``SS_RFR_RESP``, the replication
stream / WAL (``replica.OP_TRACE``), and failover adoption. A terminal
event — delivery (``finalize``), quarantine, failover loss — closes the
record into a **journey** dict; the closing server feeds per-stage
latency histograms (``unit_stage_s{stage=,job=,type=}``: the time spent
REACHING each stage from the previous one, so queue wait / plan wait /
relay / fetch attribute separately) and, when ``Config(trace=True)``,
emits the journey into the Chrome-trace stream as a flow-event chain
(``ph: s/t/f`` sharing ``id=trace_id``) binding the hops across rank
lanes.

Closed journeys ride the fleet metrics gossip (``SS_OBS_SYNC``) to the
master, whose ops endpoint serves them on ``/trace/units``; summarize
offline with ``scripts/obs_report.py --journeys``.

**Tail-based promotion** (``Config(trace_tail)``, default on when
``ops_port`` is set): head sampling by construction almost never
records the p99/p999 outliers, so under tail mode EVERY put is armed
with spans (server-minted NEGATIVE trace ids — client-minted head ids
are positive, so the wire field 98 and the retention decision never
collide) and the recorder decides *retention* at terminal close:

* head-sampled (``trace_id > 0``) — kept, as before (``why=["head"]``);
* anomalous terminal — ``quarantined`` / ``dropped`` / ``lost``, or a
  delivered journey that crossed a lease ``expire`` hop — ALWAYS kept,
  so chaos events arrive with their full hop history attached;
* slow — total latency exceeds the live per-(job, type) p99 threshold
  the master computes from the merged fleet ``unit_total_s`` cells and
  gossips back on ``SS_OBS_SYNC`` replies. Hysteresis: a threshold
  only arms once its fleet cell holds ``TAIL_MIN_COUNT`` closes, so a
  cold histogram promotes nothing (anomalous terminals still do).

Unretained tail journeys still feed one ``unit_total_s`` observation
(that histogram IS the p99 estimator; the per-stage ``unit_stage_s``
cells stay head-sampled-only — the unbiased baseline) and skip the
journey-dict build — the hot-path cost of tail mode is spans + one
fold, bounded by the ``trace_tail_overhead_ratio`` bench arm. Promoted
journeys carry
``why=[...]`` and route to ``/trace/tails`` on the master (head
journeys keep ``/trace/units``), plus a ``prof_win`` window-id range
binding them to the continuous profiler's clock-aligned windows
(``obs/profile.py``) for the tail↔profile join.

Clock caveat: spans are ``time.monotonic`` stamps, comparable across
processes on ONE host (Linux CLOCK_MONOTONIC is system-wide). Cross-host
journeys carry each host's own clock — per-stage deltas that cross a
host boundary include the clock skew.
"""

from __future__ import annotations

import struct
from bisect import bisect_left
from collections import deque
from time import monotonic as _monotonic
from typing import Optional

from adlb_tpu_torch.obs.profile import window_of

# Stage registry: the codes are the replica/WAL wire form (OP_TRACE),
# the names are the histogram labels and journey entries. Append-only —
# renumbering would corrupt WAL replays of older logs.
STAGES = (
    "put_recv",    # 1  FA_PUT arrived at the home-of-record server
    "enqueue",     # 2  unit admitted to the work queue
    "wal_commit",  # 3  the group commit covering this put fsynced (ack released)
    "match",       # 4  pinned for a requester (local match, plan, or RFR)
    "migrate",     # 5  landed at a migration destination (SS_MIGRATE_WORK)
    "push",        # 6  landed at a memory-pressure push target (SS_PUSH_WORK)
    "relay",       # 7  payload left the holder in a fused SS_RFR_RESP
    "deliver",     # 8  payload handed to the consuming app rank
    "finalize",    # 9  journey closed (terminal)
    "expire",      # 10 lease expired; unit re-enqueued under a fresh attempt
    "adopt",       # 11 adopted by a failover buddy at promotion
    "replay",      # 12 recovered from the WAL at cold restart
    # elastic membership (append-only — renumbering corrupts old WALs):
    "attach",      # 13 shipped to a scale-out shard's bootstrap rebalance
    "drain",       # 14 crossed a detach/scale-in drain (lease drained,
    #                   shard shipped to the buddy, target departed)
    # tail hedging (append-only — renumbering corrupts old WALs):
    "hedge",       # 15 a hedge sibling was launched for this unit (the
    #                   origin stamps it; the sibling's journey inherits
    #                   the origin's history including this hop)
)
STAGE_CODES = {name: i + 1 for i, name in enumerate(STAGES)}
CODE_STAGES = {v: k for k, v in STAGE_CODES.items()}

# per-unit span cap: a unit bouncing through expiry loops must not grow
# an unbounded history (the journey keeps its most recent window)
MAX_SPANS = 64

# tail-promotion hysteresis: the per-(job, type) p99 threshold only
# arms once the fleet's unit_total_s cell has seen this many closes —
# a cold histogram's p99 is noise and would promote everything
TAIL_MIN_COUNT = 64

_SPANHDR = struct.Struct("<qH")  # trace id, span count
_SPAN = struct.Struct("<Bid")    # stage code, rank, t_mono


def pack_spans(trace_id: int, spans) -> bytes:
    """Wire/WAL form of a unit's trace context (replica OP_TRACE body)."""
    spans = spans or []
    return _SPANHDR.pack(trace_id, len(spans)) + b"".join(
        _SPAN.pack(STAGE_CODES.get(stage, 0), rank, t)
        for stage, rank, t in spans
    )


def unpack_spans(body: bytes) -> tuple[int, list]:
    trace_id, n = _SPANHDR.unpack_from(body, 0)
    spans = []
    off = _SPANHDR.size
    for _ in range(n):
        code, rank, t = _SPAN.unpack_from(body, off)
        off += _SPAN.size
        spans.append((CODE_STAGES.get(code, "?"), rank, t))
    return trace_id, spans


class JourneyRecorder:
    """One server's unit-trace bookkeeping.

    ``begin``/``stamp`` are reactor-thread appends on the unit's own
    span list; ``close`` folds the spans into per-stage latency
    histograms and a bounded closed-journey deque (drained by the
    SS_OBS_SYNC gossip toward the master, or read directly on the
    master). ``live`` caps how many traced units this server will track
    at once — past it, new puts simply go untraced (``trace_dropped``
    counter) instead of growing without bound.
    """

    def __init__(self, rank: int, registry, tracer=None,
                 max_live: int = 4096, max_done: int = 1024) -> None:
        self.rank = rank
        self.registry = registry
        self.tracer = tracer
        self.max_live = max_live
        self.live = 0
        self.done: deque = deque(maxlen=max_done)
        # tail-based promotion (Config(trace_tail)): when armed the
        # server begins a journey on EVERY put (begin_tail) and close
        # decides retention; tail_thr is the fleet-fed per-(job, type)
        # p99 map the master computes and gossips (swapped whole, never
        # mutated in place — the reactor reads it mid-close)
        self.tail = False
        self.tail_thr: dict = {}
        self._tail_seq = 0
        self._m_closed = registry.counter("trace_journeys_closed")
        self._m_dropped = registry.counter("trace_dropped")
        self._m_promoted = registry.counter("trace_tail_promoted")
        # instrument cache: close_spans runs on the delivery hot path,
        # and the registry's kwargs/label lookup per observation is the
        # expensive part — hold the histogram objects by plain key
        self._hists: dict = {}
        self._totals: dict = {}
        self._errs: dict = {}

    # -- span lifecycle ------------------------------------------------------

    def begin(self, unit, trace_id: int, t: float) -> None:
        """Arm a freshly-put unit with its trace context (or drop the
        context at the live cap) and stamp ``put_recv``."""
        if self.live >= self.max_live:
            self._m_dropped.inc()
            return
        self.live += 1
        unit.trace_id = trace_id
        unit.spans = [("put_recv", self.rank, t)]

    def begin_tail(self, unit, t: float) -> None:
        """Arm an un-head-sampled unit under tail mode: the server mints
        a NEGATIVE trace id (rank in the high bits, like the client's
        positive head ids) so retention can tell the two apart at close
        without any extra per-unit state."""
        self.begin(unit, self.mint_tail_id(), t)

    def mint_tail_id(self) -> int:
        """A fresh server-minted (negative) trace id — begin_tail's, and
        the hedge launcher's for sibling journeys that carry a copy of
        the origin's span history under their own identity."""
        self._tail_seq += 1
        return -((self.rank << 40) | self._tail_seq)

    def adopt(self, unit, trace_id: int, spans, stage: Optional[str] = None,
              t: Optional[float] = None) -> None:
        """Attach a context that arrived WITH the unit (push, migrate,
        WAL replay, failover adoption), optionally stamping the arrival
        stage. Counts against the live cap like begin()."""
        if not trace_id:
            return
        if self.live >= self.max_live:
            self._m_dropped.inc()
            return
        self.live += 1
        unit.trace_id = trace_id
        unit.spans = list(spans or [])
        if stage is not None:
            self.stamp(unit, stage, t)

    def stamp(self, unit, stage: str, t: Optional[float] = None) -> None:
        spans = unit.spans
        if spans is None:
            return
        if len(spans) >= MAX_SPANS:
            del spans[1:2]  # keep put_recv; shed the oldest middle hop
        spans.append((stage, self.rank,
                      _monotonic() if t is None else t))

    def forget(self, unit) -> None:
        """Release a unit's context without closing (the fused-relay
        handoff: the requester's HOME closed the journey from the copy
        that rode the SS_RFR_RESP; the holder's original is dropped at
        the SS_DELIVERED consume)."""
        if unit.spans is not None:
            unit.spans = None
            unit.trace_id = 0
            self.live = max(0, self.live - 1)

    # -- closing -------------------------------------------------------------

    def deliver_close(self, unit, t: Optional[float] = None) -> None:
        """Fused deliver-stamp + delivered-close — ONE call on the hot
        delivery path (under tail mode it runs for every unit; the
        deliver and finalize stamps share one clock read, since they
        land in the same handler anyway)."""
        spans = unit.spans
        if spans is None:
            return
        tm = _monotonic() if t is None else t
        if len(spans) >= MAX_SPANS:
            del spans[1:2]
        spans.append(("deliver", self.rank, tm))
        tid = unit.trace_id
        if tid > 0:
            # head journeys keep the head-sampling stage set (finalize last);
            # tail journeys end at deliver (same instant, one fold less)
            spans.append(("finalize", self.rank, tm))
        unit.spans = None
        unit.trace_id = 0
        if self.live > 0:
            self.live -= 1
        self.close_spans(tid, unit.job, unit.work_type, "delivered", spans)

    def close(self, unit, end: str, t: Optional[float] = None) -> None:
        """Terminal event on a locally-held unit: finalize-stamp and fold
        the journey. Tail-minted journeys (negative ids — EVERY unit in
        a tail-armed world) skip the finalize stamp when the last hop is
        already this close's own ``deliver``: the two stamps land in the
        same handler microseconds apart, so the hop carries no
        attribution and costs a span + a fold per unit. Terminal closes
        without a deliver hop (quarantine, drop, loss) still stamp."""
        if unit.spans is None:
            return
        if unit.trace_id > 0 or unit.spans[-1][0] != "deliver":
            self.stamp(unit, "finalize", t)
        spans, trace_id = unit.spans, unit.trace_id
        unit.spans = None
        unit.trace_id = 0
        self.live = max(0, self.live - 1)
        self.close_spans(trace_id, unit.job, unit.work_type, end, spans)

    def close_spans(self, trace_id: int, job: int, work_type: int,
                    end: str, spans: list) -> None:
        """Close an explicit span list into a journey (the relay path
        at the requester's home server, and failover-loss closes, hold
        spans without a live local unit).

        Under tail mode this runs for EVERY unit, so the folds split by
        what each estimator actually needs: the p99 promotion threshold
        is a quantile of TOTAL latency, so the tail bulk (negative ids)
        feeds one ``unit_total_s`` observation and nothing else; the
        per-stage ``unit_stage_s`` cells stay head-sampled-only — they
        exist to be an UNBIASED per-stage baseline (the /jobs view and
        the tails excess attribution), and folding the promoted slow
        journeys into them would bias exactly that baseline, while
        promoted journeys already carry their raw spans for exact
        within-journey deltas. Net: the every-unit path costs one
        histogram observation plus the retention check (written for the
        1-core GIL-coupled worst case — each microsecond here is
        client-visible pop latency on a saturated core)."""
        if not spans:
            return
        self._m_closed.v += 1  # counter.inc() inlined: every-unit path
        total = spans[-1][2] - spans[0][2]
        if total < 0.0:
            total = 0.0
        ht = self._totals.get((job, work_type))
        if ht is None:
            ht = self._totals[(job, work_type)] = self.registry.histogram(
                "unit_total_s", job=str(job), type=str(work_type)
            )
        # Histogram.observe inlined (every-unit path): one bisect + adds
        ht.counts[bisect_left(ht.bounds, total)] += 1
        ht.sum += total
        ht.n += 1
        if end != "delivered":
            # the SLO engine's error-rate numerator: anomalous closes
            # per (job, type), with the total histogram's count as the
            # matching denominator (every close folds both)
            ec = self._errs.get((job, work_type))
            if ec is None:
                ec = self._errs[(job, work_type)] = self.registry.counter(
                    "unit_errors", job=str(job), type=str(work_type)
                )
            ec.v += 1  # counter.inc() inlined: every-unit path
        if trace_id > 0:
            # head-sampled: the unbiased per-stage baseline cells
            hists = self._hists
            prev_t = spans[0][2]
            for span in spans[1:]:
                stage = span[0]
                t = span[2]
                h = hists.get((stage, job, work_type))
                if h is None:
                    h = hists[(stage, job, work_type)] = \
                        self.registry.histogram(
                            "unit_stage_s", stage=stage, job=str(job),
                            type=str(work_type),
                        )
                d = t - prev_t
                h.observe(d if d > 0.0 else 0.0)
                prev_t = t
        # ---- retention decision (the head-vs-tail sampling gap fix):
        # the journey dict below is only built for what we keep; the
        # dominant case — tail-armed clean delivery, below threshold —
        # exits with two dict probes and a span scan
        if trace_id < 0 and end == "delivered":
            why = None
            for s in spans:
                st = s[0]
                if st == "expire":
                    why = ["expired_lease"]
                    break
                if st == "hedge":
                    # a hedge race crossed this journey (this copy won
                    # it — losers are forgotten, never closed): always
                    # keep, so every hedge outcome lands in /trace/tails
                    why = ["hedged"]
                    break
                if st == "attach" or st == "drain":
                    # membership churn crossed this journey (scale-out
                    # bootstrap / detach / scale-in drain): always keep,
                    # so churn events are visible in /trace/tails
                    why = ["churn"]
                    break
            if why is None:
                thr = self.tail_thr.get((job, work_type))
                if thr is None or total <= thr:
                    return
                why = ["slow"]
        else:
            why = self._why(trace_id, job, work_type, end, total, spans)
            if not why:
                return
        if why != ["head"]:
            self._m_promoted.inc()
        self.done.append({
            "trace_id": trace_id,
            "job": job,
            "type": work_type,
            "end": end,
            "why": why,
            "t0": round(spans[0][2], 6),
            "total_s": round(total, 6),
            # the profiler window-id range this journey crossed: window
            # ids are clock-aligned (t // WINDOW_S on the shared host
            # CLOCK_MONOTONIC), so no profiler handshake is needed here
            "prof_win": [window_of(spans[0][2]), window_of(spans[-1][2])],
            "spans": [[stage, rank, round(t, 6)] for stage, rank, t in spans],
        })
        tr = self.tracer
        if tr is not None:
            # flow-event chain into the merged Chrome-trace stream: one
            # s/t/.../f sequence sharing id=trace_id, each step on the
            # lane (tid) of the rank that performed the hop, so Perfetto
            # draws the unit's path across server lanes
            last = len(spans) - 1
            for i, (stage, rank, t) in enumerate(spans):
                ev = {
                    "name": "unit",
                    "cat": "unit",
                    "ph": "s" if i == 0 else ("f" if i == last else "t"),
                    "id": trace_id,
                    "ts": t * 1e6,
                    "pid": tr.pid,
                    "tid": rank,
                    "args": {"stage": stage, "job": job,
                             "type": work_type, "end": end},
                }
                if i == last:
                    ev["bp"] = "e"
                tr._emit(ev)

    def _why(self, trace_id: int, job: int, work_type: int, end: str,
             total: float, spans: list) -> list:
        """Retention reasons for a closed journey (empty = drop).

        Head-sampled ids (positive) always keep — the head-sampling behavior is
        unchanged. Under tail mode, anomalous terminals (anything but a
        clean delivery, plus delivered journeys that crossed a lease
        expiry) always promote, and a clean delivery promotes iff it
        blew past the fleet-fed per-(job, type) p99 threshold."""
        why = []
        if trace_id > 0:
            why.append("head")
        if self.tail:
            if end != "delivered":
                why.append(end)
                for s in spans:
                    if s[0] == "hedge":
                        # an anomalous terminal that crossed a hedge
                        # race still tags it, so /trace/tails answers
                        # "was hedging in play?" for every outcome
                        why.append("hedged")
                        break
            else:
                # plain loop, not any(genexpr): this runs per close
                # under tail mode and the generator allocation is a
                # measured slice of the per-journey cost
                mark = None
                for s in spans:
                    st = s[0]
                    if st == "expire":
                        mark = "expired_lease"
                        break
                    if st == "hedge":
                        mark = "hedged"
                        break
                    if st == "attach" or st == "drain":
                        mark = "churn"
                        break
                if mark is not None:
                    why.append(mark)
                else:
                    thr = self.tail_thr.get((job, work_type))
                    if thr is not None and total > thr:
                        why.append("slow")
        return why

    def take_done(self) -> list:
        """Drain closed journeys (the gossip tick toward the master)."""
        out = []
        while self.done:
            try:
                out.append(self.done.popleft())
            except IndexError:  # pragma: no cover — single-consumer today
                break
        return out


def trace_fields(unit) -> Optional[dict]:
    """The one-key wire form a unit's context rides in pickled SS frames
    (push / migrate dicts, the fused-relay response): ``None`` when the
    unit is untraced, so untraced frames stay byte-identical."""
    if not unit.trace_id or unit.spans is None:
        return None
    return {"id": unit.trace_id, "spans": list(unit.spans)}
