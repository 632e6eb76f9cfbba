"""Debug plumbing: stamped logging, flight recorder, self-diagnosis.

The rebuild of the reference's L0 debug layer:

* :func:`aprintf` — rank/line/time-stamped stderr prints gated by a flag
  (reference ``aprintf``/``adlbp_dbgprintf``, ``src/adlb.c:3395-3417``);
* :class:`FlightRecorder` — fixed-size circular in-memory log, dumpable on
  abort or by the self-diagnosis pass (reference ``cblog``,
  ``src/adlb.c:176-179,3371-3393``);
* :func:`self_diagnosis` — the server's periodic health dump: requesters
  stuck on the rq, work-queue age by type, message-tag frequency (reference
  the 30-second ``DBG1..DBG9`` dumps, ``src/adlb.c:558-710``).

Like the stats module, output flows through a swappable sink so tests (and
embedding applications) can capture it.
"""

from __future__ import annotations

import sys
import time
from collections import deque

from adlb_tpu_torch.runtime.sink import Sink

_SINK = Sink()
set_sink = _SINK.set
_emit = _SINK.emit


def aprintf(enabled: bool, rank: int, text: str) -> None:
    """Rank/caller/time-stamped debug print, gated by the init-time flag the
    reference threads through ``ADLB_Init`` (reference ``src/adlb.c:3395``)."""
    if not enabled:
        return
    frame = sys._getframe(1)
    where = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
    _emit(f"[rank {rank} {where} @ {time.monotonic():.6f}] {text}")


class FlightRecorder:
    """Circular in-memory log: cheap enough to leave on, dumped only when
    something goes wrong (reference ``cblog``, ``src/adlb.c:3371-3393``)."""

    def __init__(self, rank: int, capacity: int = 512) -> None:
        self.rank = rank
        self._ring: deque[tuple[float, str]] = deque(maxlen=capacity)

    def record(self, text: str) -> None:
        self._ring.append((time.monotonic(), text))

    def __len__(self) -> int:
        return len(self._ring)

    def entries(self) -> list[tuple[float, str]]:
        return list(self._ring)

    def dump(self, reason: str = "") -> None:
        header = f"FLIGHT_RECORDER rank {self.rank}"
        if reason:
            header += f" ({reason})"
        _emit(f"{header}: {len(self._ring)} entries")
        for ts, text in self._ring:
            _emit(f"  [{ts:.6f}] {text}")


def self_diagnosis(server, now: float, stuck_after: float = 5.0) -> list[str]:
    """One periodic health dump for a server — the reference's DBG1..DBG9
    block (reference ``src/adlb.c:558-710``). Returns the emitted lines."""
    lines: list[str] = [
        f"SELFDIAG rank {server.rank}: wq={server.wq.count} "
        f"rq={len(server.rq)} bytes={server.mem.curr} "
        f"loops={server._loops} activity={server.activity}"
    ]
    # peer memory picture from the qmstat table: accountant bytes next to
    # each peer's /proc RSS (the reference prints its memusage probe in
    # the same diagnostics block, src/adlb.c:3347-3369)
    peers = getattr(server, "peers", None)
    if peers:
        mem = " ".join(
            f"s{s}:{st.nbytes}B/{st.rss_kb}kB"
            for s, st in sorted(peers.items())
        )
        lines.append(f"SELFDIAG rank {server.rank}: peer mem {mem}")
    # prefetch (get_work_stream) parks of a BUSY rank are long-lived by
    # design — the consumer is computing while its slots wait — so only
    # blocking reserves and idle-reported streams count as "stuck"
    idle = getattr(server, "_stream_idle", ())
    stuck = [
        (e.world_rank, round(now - e.time_stamp, 3))
        for e in server.rq.entries()
        if now - e.time_stamp > stuck_after
        and (not e.prefetch or e.world_rank in idle)
    ]
    if stuck:
        lines.append(
            f"SELFDIAG rank {server.rank}: stuck requesters "
            + " ".join(f"rank{r}:{age}s" for r, age in stuck)
        )
    # work-queue age by type (reference DBG4: oldest unit per type)
    oldest: dict[int, float] = {}
    for u in server.wq.units():
        age = now - u.time_stamp
        if age > oldest.get(u.work_type, 0.0):
            oldest[u.work_type] = age
    if oldest:
        lines.append(
            f"SELFDIAG rank {server.rank}: wq age by type "
            + " ".join(f"t{t}:{a:.3f}s" for t, a in sorted(oldest.items()))
        )
    # message-tag frequency since the last dump (reference DBG9)
    if server.tag_freq:
        top = sorted(server.tag_freq.items(), key=lambda kv: -kv[1])[:8]
        lines.append(
            f"SELFDIAG rank {server.rank}: tags "
            + " ".join(f"{t.name}:{n}" for t, n in top)
        )
        server.tag_freq.clear()
    for line in lines:
        _emit(line)
    return lines
