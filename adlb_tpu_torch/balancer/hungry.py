"""Shared tracker for the SS_HUNGRY wanted-type set.

Both balancer hosts — the in-server master thread (``runtime/server.py``)
and the native-plane sidecar (``balancer/sidecar.py``) — must agree on
when servers should pay for put-side event snapshots: some requester is
parked somewhere whose requested types new untargeted inventory could
satisfy. This class owns that state machine so the two planes cannot
drift: set GROWTH broadcasts immediately (a newly wanted type must start
flowing event deltas now); set SHRINKAGE is held for a grace period,
because fine-grained workloads park/unpark the same types many times a
second and flapping would churn broadcasts plus the grew-triggered
snapshot refreshes on every server.
"""

from __future__ import annotations

import time
from typing import Optional


class HungryTracker:
    """Feed per-source parked-requester lists; get broadcast decisions.

    ``update(src, reqs)`` and ``flush(now)`` return ``None`` (nothing to
    broadcast) or ``(hungry, req_types, grew)`` — the SS_HUNGRY payload:
    ``hungry`` bool, ``req_types`` a sorted list of wanted types or None
    for "an any-type requester is parked", ``grew`` whether the wanted
    set grew (receivers refresh their snapshot on growth).
    """

    def __init__(self, shrink_grace: float = 0.1) -> None:
        self.shrink_grace = shrink_grace
        self.hungry = False
        self.hungry_any = False
        self.hungry_types: frozenset = frozenset()
        self._per_src: dict[int, tuple] = {}  # src -> (any, types)
        self._shrink_since: Optional[float] = None

    def _now_state(self) -> tuple[bool, frozenset]:
        return (
            any(v[0] for v in self._per_src.values()),
            frozenset(t for v in self._per_src.values() for t in v[1]),
        )

    def _apply(self, any_type: bool, types: frozenset, grew: bool):
        self.hungry_any = any_type
        self.hungry_types = types
        self.hungry = any_type or bool(types)
        return (
            self.hungry,
            None if any_type else sorted(types),
            grew,
        )

    def update(self, src: int, reqs):
        """Record ``src``'s parked requesters ((rank, rqseqno, types|None)
        tuples); returns a broadcast payload or None."""
        any_type = any(r[2] is None for r in reqs)
        types = frozenset(t for r in reqs if r[2] is not None for t in r[2])
        self._per_src[src] = (any_type, types)
        now_any, now_types = self._now_state()
        grew = (now_any and not self.hungry_any) or bool(
            now_types - self.hungry_types
        )
        if grew:
            self._shrink_since = None
            return self._apply(now_any, now_types, grew=True)
        if (now_any, now_types) == (self.hungry_any, self.hungry_types):
            self._shrink_since = None
            return None
        # pure shrink: hold it; flush() applies it after the grace period
        if self._shrink_since is None:
            self._shrink_since = time.monotonic()
        return None

    def drop(self, src: int) -> None:
        """Forget an ended source. Dropping can only shrink the wanted
        set, so arm the grace timer like any other shrink — otherwise the
        survivors would keep paying for event snapshots until an
        unrelated update happened to re-derive the set."""
        if self._per_src.pop(src, None) is None:
            return
        now_state = self._now_state()
        if (
            now_state != (self.hungry_any, self.hungry_types)
            and self._shrink_since is None
        ):
            self._shrink_since = time.monotonic()

    def flush(self, now: float):
        """Apply a held shrink once stable for the grace period; returns a
        broadcast payload or None."""
        if (
            self._shrink_since is None
            or now - self._shrink_since < self.shrink_grace
        ):
            return None
        self._shrink_since = None
        now_any, now_types = self._now_state()
        if (now_any, now_types) == (self.hungry_any, self.hungry_types):
            return None
        return self._apply(now_any, now_types, grew=False)
