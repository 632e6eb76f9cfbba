"""Event tracing — the rebuild's MPE-equivalent profiling layer.

The reference's wrapper layer can emit MPE state events around every API
call (``LOG_ADLB_INTERNALS``, reference ``src/adlb_prof.c:46-74``) and infer
per-work-type "user state" intervals between consecutive ``Get_reserved``
calls (``LOG_GUESS_USER_STATE``, reference ``src/adlb_prof.c:5-12,185-236``).

Here tracing is a run-time flag (``Config(trace=True)``) instead of a
compile-time one. Each rank's :class:`Tracer` records:

* one complete-span event per public API call (``adlb:put``,
  ``adlb:reserve``, ...), and
* one inferred ``user:type<T>`` span from the moment a ``get_reserved`` of
  type T returns until the rank's next API call — the app's presumed compute
  time on that unit, exactly the reference's user-state guess.

Since the observability unification, **servers trace too**: the reactor
wraps each message handler in a ``srv:<TAG>`` span and the balancer wraps
each planning round in ``balancer:round``, on a tracer whose ``pid``
marks the role. Client tracers run as ``pid=0`` ("apps"), server tracers
as ``pid=1`` ("servers"), so one merged Perfetto/chrome://tracing file
shows both sides of every reserve as two process lanes on a shared
clock. The sharded planner records its phases on the tracer it is given
(``planner:ingest`` and ``planner:plan`` with their children, nested under
the ``balancer:round`` that called it).

Every timestamp is read from :func:`clock`, ``time.perf_counter``: the
clock the benchmark ties ``torch.profiler``'s device trace to (its
``bench_clock_mark``), so a span lies on the device trace's time line
as recorded. All ranks of one ``run_world`` share it. On Linux it is
``CLOCK_MONOTONIC``, the clock ``time.monotonic`` reads too, which is
what the unit journeys' flow events (``obs/journey.py``) are stamped
with.

Events use the Chrome trace-event format (``ph: "X"``, microsecond
timestamps, ``tid`` = world rank) so a merged dump loads directly in
Perfetto / chrome://tracing. :func:`merge` combines per-rank tracers;
:func:`save_chrome_trace` writes the JSON file.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Iterable, Optional

PID_APP = 0
PID_SERVER = 1


def clock() -> float:
    """The tracer's clock, in seconds: ``time.perf_counter``. Spans given
    their own readings (:meth:`Tracer.complete`) must read this clock."""
    return time.perf_counter()


def _now_us() -> float:
    return clock() * 1e6


def _as_given(span: tuple) -> tuple:
    """:meth:`Tracer.complete`'s record is its one span."""
    return (span,)


class Tracer:
    """Per-rank event buffer. Cheap enough to leave on: one dict append per
    event, no locks on the hot path (each rank owns its tracer; the one
    cross-thread writer — the balancer thread into its server's tracer —
    rides CPython's atomic list.append). ``max_events`` bounds memory on
    long server runs; overflow increments ``dropped`` instead of growing.

    :meth:`defer` keeps a caller's record, a tuple, and :attr:`events`
    renders it into spans when it is read: the sharded planner records a
    round's phases as two tuples of plain values, which the collector
    stops walking once it has seen them, where a window's worth of event
    dicts would cost the round their allocation and the collector's walks
    over them. Read :attr:`events` once the recording threads are done, as
    the world harnesses do."""

    def __init__(
        self,
        rank: int,
        pid: int = PID_APP,
        process_name: Optional[str] = None,
        max_events: int = 500_000,
    ) -> None:
        self.rank = rank
        self.pid = pid
        self.max_events = max_events
        self.dropped = 0
        self._events: list[dict] = []
        # defer()'s records by their render function, not yet rendered
        self._deferred: dict = {}
        self._pending = 0  # records in _deferred
        if process_name:
            # Chrome-trace metadata: names the pid lane in Perfetto
            self._events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "ts": 0.0,
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": process_name},
                }
            )
        # pending user-state inference: (work_type, span start in us)
        self._user_since: Optional[tuple[int, float]] = None

    @property
    def events(self) -> list[dict]:
        """Every event kept, as Chrome-trace dicts: the deferred records
        rendered now, after the events recorded otherwise."""
        if self._deferred:
            deferred, self._deferred = self._deferred, {}
            self._pending = 0
            pid, tid = self.pid, self.rank
            for render, records in deferred.items():
                for rec in records:
                    for name, t0, t1, args in render(rec):
                        ev = {"name": name, "ph": "X", "ts": t0 * 1e6,
                              "dur": (t1 - t0) * 1e6, "pid": pid,
                              "tid": tid}
                        if args:
                            ev["args"] = args
                        self._events.append(ev)
        return self._events

    def _emit(self, ev: dict) -> None:
        if len(self._events) + self._pending >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    def defer(self, render, record: tuple) -> None:
        """Keep ``record`` until :attr:`events` is read, then add the spans
        ``render(record)`` gives, each ``(name, t0, t1, args)`` with two
        readings of :func:`clock` in seconds. A record of plain values
        (numbers, strings, None) costs the collector nothing after its
        first look; one record counts once against ``max_events``."""
        if len(self._events) + self._pending >= self.max_events:
            self.dropped += 1
            return
        self._pending += 1
        records = self._deferred.get(render)
        if records is None:
            records = self._deferred[render] = []
        records.append(record)

    @contextmanager
    def span(self, name: str, **args):
        t0 = _now_us()
        try:
            yield
        finally:
            self._emit(
                {
                    "name": name,
                    "ph": "X",
                    "ts": t0,
                    "dur": _now_us() - t0,
                    "pid": self.pid,
                    "tid": self.rank,
                    **({"args": args} if args else {}),
                }
            )

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """One complete-span event over [t0, t1], two readings of
        :func:`clock` in seconds that the caller already took at its phase
        boundaries."""
        self.defer(_as_given, (name, t0, t1, args))

    def instant(self, name: str, **args) -> None:
        self._emit(
            {
                "name": name,
                "ph": "i",
                "ts": _now_us(),
                "s": "t",
                "pid": self.pid,
                "tid": self.rank,
                **({"args": args} if args else {}),
            }
        )

    # -- user-state inference (reference src/adlb_prof.c:185-236) -----------

    def api_entry(self) -> None:
        """Close any open inferred user-state span: the app was presumed
        computing on the last fetched unit until it came back to the API."""
        if self._user_since is None:
            return
        work_type, t0 = self._user_since
        self._user_since = None
        self._emit(
            {
                "name": f"user:type{work_type}",
                "ph": "X",
                "ts": t0,
                "dur": _now_us() - t0,
                "pid": self.pid,
                "tid": self.rank,
                "args": {"work_type": work_type},
            }
        )

    def got_work(self, work_type: int) -> None:
        """A get_reserved of `work_type` just returned — start presuming
        user compute."""
        self._user_since = (work_type, _now_us())


def merge(tracers: Iterable[Tracer]) -> list[dict]:
    events: list[dict] = []
    for t in tracers:
        events.extend(t.events)
    events.sort(key=lambda e: e["ts"])
    return events


def save_chrome_trace(events: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def span_names(events: Iterable[dict]) -> set[str]:
    return {e["name"] for e in events}
