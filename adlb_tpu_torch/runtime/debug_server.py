"""Debug-server watchdog.

Equivalent of the reference's optional extra rank (``ADLBP_Debug_server``,
reference ``src/adlb.c:2528-2635``): servers ship periodic counter summaries
(DS_LOG); the watchdog aggregates them and **aborts the whole world if no
message arrives within the timeout** — turning hangs into bounded-time
failures with state dumps, which the reference's docs recommend as the soak-
test harness (reference ``USERGUIDE.txt:60-80``).
"""

from __future__ import annotations

import sys
import time

from adlb_tpu_torch.runtime.messages import Tag, msg
from adlb_tpu_torch.runtime.transport import Endpoint
from adlb_tpu_torch.runtime.world import Config, WorldSpec


class DebugServer:
    def __init__(
        self, world: WorldSpec, cfg: Config, ep: Endpoint, abort_event=None
    ) -> None:
        self.world = world
        self.cfg = cfg
        self.ep = ep
        self._abort_event = abort_event
        self.aggregates: dict[int, dict] = {}
        self.timed_out = False
        # per-interval aggregation of the 11-counter heartbeats, printed
        # the way the reference's debug server does per minute (reference
        # ``src/adlb.c:2539-2551,2569-2610``)
        self.printed_lines: list[str] = []
        self._window: dict[str, float] = {}
        self._window_n = 0

    # DS_LOG fields aggregated per print window (sums of the since-last-log
    # counters; averages of the point-in-time depths)
    _SUM_FIELDS = ("events", "reserves", "reserves_immed", "reserves_parked",
                   "rfr_failed", "ss_msgs")
    _AVG_FIELDS = ("wq_targeted", "wq_count", "rq_count", "backlog",
                   "rss_kb", "nbytes")

    def _print_window(self, span: float) -> None:
        if not self._window_n:
            return
        w = self._window
        navg = max(self._window_n, 1)
        line = (
            f"[adlb debug server] last {span:.1f}s: "
            f"events={int(w.get('events', 0))} "
            f"reserves={int(w.get('reserves', 0))} "
            f"immed={int(w.get('reserves_immed', 0))} "
            f"parked={int(w.get('reserves_parked', 0))} "
            f"rfr_failed={int(w.get('rfr_failed', 0))} "
            f"ss_msgs={int(w.get('ss_msgs', 0))} "
            f"avg_wq_targeted={w.get('wq_targeted', 0) / navg:.1f} "
            f"avg_wq={w.get('wq_count', 0) / navg:.1f} "
            f"avg_rq={w.get('rq_count', 0) / navg:.1f} "
            f"avg_backlog={w.get('backlog', 0) / navg:.1f} "
            f"avg_rss_kb={w.get('rss_kb', 0) / navg:.0f} "
            f"avg_nbytes={w.get('nbytes', 0) / navg:.0f}"
        )
        self.printed_lines.append(line)
        print(line, file=sys.stderr)
        self._window = {}
        self._window_n = 0

    def run(self) -> None:
        ended: set[int] = set()
        last_msg = time.monotonic()
        self._last_print = last_msg
        print_interval = self.cfg.debug_print_interval
        try:
            self._run(ended, last_msg, print_interval)
        finally:
            # flush the final partial window so short runs still get
            # their aggregate line
            if print_interval > 0:
                self._print_window(time.monotonic() - self._last_print)

    def _run(self, ended, last_msg, print_interval) -> None:
        while len(ended) < self.world.nservers:
            if self._abort_event is not None and self._abort_event.is_set():
                return
            m = self.ep.recv(timeout=min(self.cfg.debug_server_timeout / 4, 0.25))
            now = time.monotonic()
            if print_interval > 0 and now - self._last_print >= print_interval:
                self._print_window(now - self._last_print)
                self._last_print = now
            if m is None:
                if now - last_msg > self.cfg.debug_server_timeout:
                    self.timed_out = True
                    print(
                        f"[adlb debug server] no server heartbeat for "
                        f"{self.cfg.debug_server_timeout:.1f}s — aborting world",
                        file=sys.stderr,
                    )
                    # post-mortem artifact: the watchdog's last-known
                    # per-server aggregates (the servers dump their own
                    # flight records when the SS_ABORT below lands)
                    from adlb_tpu_torch.obs.flight import write_artifact

                    write_artifact(
                        self.cfg.flight_dir,
                        "watchdog-timeout",
                        {
                            "role": "debug_server",
                            "reason": "watchdog timeout",
                            "timeout_s": self.cfg.debug_server_timeout,
                            "aggregates": {
                                str(r): dict(a)
                                for r, a in self.aggregates.items()
                            },
                            "recent_lines": self.printed_lines[-20:],
                        },
                    )
                    for s in self.world.server_ranks:
                        self.ep.send(s, msg(Tag.SS_ABORT, self.ep.rank, code=-2))
                    for a in self.world.app_ranks:
                        self.ep.send(a, msg(Tag.TA_ABORT, self.ep.rank, code=-2))
                    if self._abort_event is not None:
                        self._abort_event.set()
                    return
                continue
            last_msg = now
            if m.tag is Tag.DS_END:
                ended.add(m.src)
            elif m.tag is Tag.DS_LOG:
                agg = self.aggregates.setdefault(
                    m.src, {"wq_count": 0, "rq_count": 0, "nbytes": 0, "n": 0}
                )
                agg["wq_count"] = m.wq_count
                agg["rq_count"] = m.rq_count
                agg["nbytes"] = m.nbytes
                agg["n"] += 1
                for f in self._SUM_FIELDS + self._AVG_FIELDS:
                    v = m.data.get(f)
                    if v is not None:
                        self._window[f] = self._window.get(f, 0) + v
                self._window_n += 1
