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
clock (all ranks in one ``run_world`` share ``time.monotonic``).

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


def _now_us() -> float:
    return time.monotonic() * 1e6


class Tracer:
    """Per-rank event buffer. Cheap enough to leave on: one dict append per
    event, no locks on the hot path (each rank owns its tracer; the one
    cross-thread writer — the balancer thread into its server's tracer —
    rides CPython's atomic list.append). ``max_events`` bounds memory on
    long server runs; overflow increments ``dropped`` instead of growing."""

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
        self.events: list[dict] = []
        if process_name:
            # Chrome-trace metadata: names the pid lane in Perfetto
            self.events.append(
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

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

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
