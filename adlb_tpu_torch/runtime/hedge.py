"""Tail hedging: budgeted speculative re-dispatch of p99 stragglers.

The "act" half of the tail story (ROADMAP item 2, Dean/Barroso "The
Tail at Scale"): the fleet metrics plane lets a server *see* that a leased unit's age
crossed the live per-(job, type) p99 threshold the master gossips
(``SS_OBS_SYNC`` ``thr``), and the SLO heuristics *name* stalled lease holders
(``leases_expired_by`` growth / staleness — the shared
:func:`adlb_tpu_torch.obs.slo.suspect_ranks` heuristic). This module lets the
home server do something about it: mint a **hedge sibling** — a copy of
the straggling unit — and hand it to an already-parked requester on a
DIFFERENT rank. First terminal wins and closes the books exactly once;
every losing sibling is fenced through the (seqno, owner)
machinery, so the loser's late fetch answers ``ADLB_FENCED`` exactly
like a lease-expired owner's would. The at-least-once window is the one
already documented for lease expiry — hedging adds no new one.

Two structural properties the server hooks rely on:

* **Budgeted** — a per-job token bucket refilled by deliveries
  (``Config(hedge_budget_frac)`` tokens per delivered unit, small
  burst cap): launches are bounded by ``~frac x deliveries + burst``
  by construction, not by a tuned rate limit.
* **Backpressure-subordinate** — any overload signal at launch time
  (memory watermark, per-job quota, allocation failure) vetoes the
  hedge STICKILY for that straggler: a vetoed origin can never launch
  later ("zero vetoed-then-launched", proven under the put-storm
  bench). Budget and no-parked-taker vetoes are transient — the next
  scan may retry them.

The manager is pure bookkeeping (groups, buckets, veto set); all queue
/ lease / WAL side effects live in ``runtime/server.py`` so the hedge
state can never disagree with the reactor's.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

# a fresh job's bucket: one immediate hedge allowed, then paced by the
# per-delivery refill
INITIAL_TOKENS = 1.0
# bucket cap: bounds the burst after an idle stretch (deliveries keep
# crediting while nothing straggles)
BURST_TOKENS = 4.0
# sticky-veto memory bound, same policy as the server's fence set
MAX_VETOED = 65536


def should_hedge(age_s: float, thr_s: Optional[float],
                 owner_suspect: bool, min_age_s: float) -> bool:
    """The trigger predicate, separated for direct unit testing: hedge
    when the unit's age crossed the fleet-fed p99 threshold for its
    (job, type) — or its lease holder shows a stall signature — but
    never below the ``hedge_min_age_ms`` floor (cold-start thresholds
    are noise and a young unit is not a straggler)."""
    if age_s < min_age_s:
        return False
    if thr_s is not None and age_s > thr_s:
        return True
    return owner_suspect


class HedgeGroup:
    """One straggler's race: the origin unit plus its hedge siblings
    (today exactly one sibling per origin — the server never re-hedges
    an existing member)."""

    __slots__ = ("origin", "members", "job")

    def __init__(self, origin: int, job: int) -> None:
        self.origin = origin
        self.members: set[int] = {origin}
        self.job = job


class HedgeManager:
    """Per-server hedge bookkeeping: open groups, per-job budget
    buckets, and the sticky backpressure-veto set. Reactor-thread only,
    like the queues it annotates."""

    def __init__(self, budget_frac: float,
                 burst: float = BURST_TOKENS) -> None:
        self.budget_frac = budget_frac
        self.burst = burst
        self._tokens: dict[int, float] = {}     # job -> tokens
        self.groups: dict[int, HedgeGroup] = {}  # origin seqno -> group
        self.by_seqno: dict[int, int] = {}       # member -> origin seqno
        self._vetoed: set[int] = set()           # sticky: origin seqnos
        self._veto_order: deque = deque()
        self.launched = 0

    # -- budget --------------------------------------------------------------

    def tokens(self, job: int) -> float:
        return self._tokens.get(job, INITIAL_TOKENS)

    def credit(self, job: int) -> None:
        """One delivered unit funds its job's bucket."""
        self._tokens[job] = min(
            self._tokens.get(job, INITIAL_TOKENS) + self.budget_frac,
            self.burst,
        )

    def try_debit(self, job: int) -> bool:
        t = self._tokens.get(job, INITIAL_TOKENS)
        if t < 1.0:
            return False
        self._tokens[job] = t - 1.0
        return True

    def refund(self, job: int) -> None:
        """Return a debited token (the launch aborted after the debit —
        no taker parked, allocation failed)."""
        self._tokens[job] = min(
            self._tokens.get(job, INITIAL_TOKENS) + 1.0, self.burst
        )

    # -- sticky backpressure veto -------------------------------------------

    def veto(self, origin_seqno: int) -> None:
        """Backpressure said no: this straggler never hedges. Sticky by
        design — overload is exactly when a later retry would be the
        start of a hedge storm."""
        if origin_seqno in self._vetoed:
            return
        self._vetoed.add(origin_seqno)
        self._veto_order.append(origin_seqno)
        if len(self._veto_order) > MAX_VETOED:
            self._vetoed.discard(self._veto_order.popleft())

    def is_vetoed(self, seqno: int) -> bool:
        return seqno in self._vetoed

    # -- group lifecycle -----------------------------------------------------

    def open(self, origin_seqno: int, sib_seqno: int, job: int) -> None:
        g = self.groups.get(origin_seqno)
        if g is None:
            g = self.groups[origin_seqno] = HedgeGroup(origin_seqno, job)
            self.by_seqno[origin_seqno] = origin_seqno
        g.members.add(sib_seqno)
        self.by_seqno[sib_seqno] = origin_seqno
        self.launched += 1

    def group_of(self, seqno: int) -> Optional[HedgeGroup]:
        origin = self.by_seqno.get(seqno)
        return None if origin is None else self.groups.get(origin)

    def is_member(self, seqno: int) -> bool:
        return seqno in self.by_seqno

    def settle(self, seqno: int) -> Optional[tuple[int, list[int]]]:
        """First terminal among a group's members: dissolve the race and
        return ``(origin_seqno, losers)`` — every OTHER member, for the
        server to fence and retire. ``None`` when ``seqno`` is not
        racing (the overwhelmingly common case: one dict probe)."""
        origin = self.by_seqno.get(seqno)
        if origin is None:
            return None
        g = self.groups.pop(origin, None)
        if g is None:  # pragma: no cover — by_seqno implies a group
            self.by_seqno.pop(seqno, None)
            return None
        for m in g.members:
            self.by_seqno.pop(m, None)
        return origin, [m for m in g.members if m != seqno]

    def drop(self, seqno: int) -> None:
        """A member retired WITHOUT terminating (lease expiry /
        unreserve / rank-death while a sibling still races). When only
        one member remains the race is over — the group dissolves and
        the survivor is an ordinary unit again (the server re-logs its
        OP_PUT so recovery stops treating it as a discardable
        sibling)."""
        origin = self.by_seqno.pop(seqno, None)
        if origin is None:
            return
        g = self.groups.get(origin)
        if g is None:
            return
        g.members.discard(seqno)
        if len(g.members) <= 1:
            del self.groups[origin]
            for m in g.members:
                self.by_seqno.pop(m, None)

    def live_siblings(self) -> Iterator[tuple[int, int]]:
        """(sibling seqno, origin seqno) for every open group — the WAL
        compaction seed re-logs these as OP_HEDGE so a cold restart
        still knows which copies are speculative."""
        for origin, g in self.groups.items():
            for m in g.members:
                if m != origin:
                    yield m, origin

    def survivors_of(self, seqno: int) -> list[int]:
        """Other members of ``seqno``'s group (empty when not racing) —
        the member-unpin hook asks this before deciding whether the
        unpinned copy may retire or must re-enqueue (work is never lost
        to hedging: the LAST live copy always stays in service)."""
        g = self.group_of(seqno)
        if g is None:
            return []
        return [m for m in g.members if m != seqno]
