"""Core constants and value types.

Return codes and info keys mirror the reference public API so that programs
written against ADLB translate directly (reference ``include/adlb/adlb.h:16-40``).
"""

from __future__ import annotations

import dataclasses
import enum

ADLB_SUCCESS = 1
ADLB_ERROR = -1
ADLB_NO_MORE_WORK = -999999999
ADLB_DONE_BY_EXHAUSTION = -999999998
ADLB_NO_CURRENT_WORK = -999999997
ADLB_PUT_REJECTED = -999999996
# Retriable transient failure (no reference analogue): the server could
# not serve the request *right now* but the condition clears on its own
# (e.g. the requester reconnected while its rank-death fan-out was still
# settling). Clients retry with capped exponential backoff + jitter.
ADLB_RETRY = -999999995
# Fenced operation (no reference analogue; Config(lease_timeout_s) > 0):
# the requester's lease on this unit EXPIRED — the unit was re-enqueued
# under a new attempt, and this late settle attempt from the old owner is
# rejected so a slow-but-alive worker can never double-settle a unit.
# Clients map it onto the ADLB_RETRY backoff path (drop the handle,
# re-reserve).
ADLB_FENCED = -999999994
# Overload backpressure (no reference analogue; Config(mem_hard_frac) > 0):
# the server is above its hard memory watermark and knows no peer with
# room either — retry the SAME request after the carried retry-after
# hint instead of hopping between equally-full servers until the retry
# budget aborts the producer. Does not burn put_max_retries.
ADLB_BACKOFF = -999999993
ADLB_LOWEST_PRIO = -999999999

ADLB_RESERVE_REQUEST_ANY = -1
ADLB_RESERVE_EOL = -1
ADLB_HANDLE_SIZE = 5

# Max number of distinct types one Reserve may request, matching the
# reference's REQ_TYPE_VECT_SZ (reference src/xq.h:37).
REQ_TYPE_VECT_SZ = 16


class InfoKey(enum.IntEnum):
    """Statistics keys for ``Info_get`` (reference include/adlb/adlb.h:25-36)."""

    MALLOC_HWM = 1
    AVG_TIME_ON_RQ = 2
    NPUSHED_FROM_HERE = 3
    NPUSHED_TO_HERE = 4
    NREJECTED_PUTS = 5
    LOOP_TOP_TIME = 6
    MAX_QMSTAT_TRIP_TIME = 7
    AVG_QMSTAT_TRIP_TIME = 8
    NUM_QMS_EXCEED_INT = 9
    NUM_RESERVES = 10
    NUM_RESERVES_PUT_ON_RQ = 11
    MAX_WQ_COUNT = 12
    # beyond-reference L0 introspection: the reference's
    # /proc/self/status memory probe (src/adlb.c:3347-3369) and its
    # MPICH unexpected-message-queue depth (src/adlb.c:3645-3719), whose
    # TCP analogue is the endpoint's received-but-unhandled frame backlog
    RSS_KB = 13
    TRANSPORT_BACKLOG = 14
    # server-failover surface (Config(on_server_failure="failover")): how
    # many takeovers this server performed, units counted lost to
    # replication lag at takeover, and the last promotion's
    # detection->promoted time in ms (the recovery-cost row bench.py
    # records as failover_mttr_ms)
    NUM_FAILOVERS = 15
    FAILOVER_LOST = 16
    FAILOVER_MTTR_MS = 17
    # gray-failure surface: units moved to the per-server dead-letter
    # quarantine after exhausting Config(max_unit_retries) — counted
    # exactly-once under the same conservation contract as FAILOVER_LOST
    # (every unit is completed, re-executed, or counted here), and
    # retrievable via ctx.get_quarantined() / the ops /deadletter view
    QUARANTINED = 18
    # the port's addition: fused relays a holder consumed when the
    # requester's home server died with the relay in flight (at most
    # once). The dead home may or may not have forwarded the payload, so
    # each such unit was either delivered or lost: a conservation check
    # reads FAILOVER_LOST + FAILOVER_RELAYS_UNRESOLVED as the bound on
    # the units missing (the JAX package counts these units nowhere)
    FAILOVER_RELAYS_UNRESOLVED = 19


@dataclasses.dataclass(frozen=True)
class WorkHandle:
    """Opaque-ish handle returned by Reserve, consumed by Get_reserved.

    Mirrors the reference's 5-int handle {wqseqno, holding server rank,
    common_len, common_server_rank, common_seqno} (reference
    src/adlb.c:2935-2947) so a reserved unit can be fetched directly from
    whichever server holds it, and its batch-common prefix from wherever the
    prefix was stored.
    """

    seqno: int
    server_rank: int
    common_len: int = 0
    common_server_rank: int = -1
    common_seqno: int = -1

    def to_ints(self) -> list[int]:
        return [
            self.seqno,
            self.server_rank,
            self.common_len,
            self.common_server_rank,
            self.common_seqno,
        ]

    @staticmethod
    def from_ints(v: list[int]) -> "WorkHandle":
        return WorkHandle(v[0], v[1], v[2], v[3], v[4])


@dataclasses.dataclass(frozen=True)
class ReserveResult:
    """Everything a successful Reserve reports back to the app."""

    work_type: int
    work_prio: int
    handle: WorkHandle
    work_len: int
    answer_rank: int


@dataclasses.dataclass(frozen=True)
class GotWork:
    """A fused reserve+get result (this framework's extension): the unit is
    already consumed — no handle, no second round trip."""

    work_type: int
    work_prio: int
    payload: bytes
    answer_rank: int
    time_on_q: float


class AdlbError(RuntimeError):
    """Raised for API misuse (invalid type, invalid handle, ...)."""


class HomeServerLostError(AdlbError):
    """A protocol peer (home server, or any server this client must
    reach) became permanently unreachable mid-run.

    Under the rank-death fault model this ends the world either way, but
    the HARNESS needs the distinction: when some rank aborted the world,
    a server tearing down can close its clients' connections before
    their TA_ABORT frames arrive — those clients die with this error as
    abort COLLATERAL, and spawn_world classifies the world as aborted
    rather than failed. Without an abort in flight it is a genuine
    failure (server crash) and surfaces as an error."""


class AdlbAborted(RuntimeError):
    """Raised in every rank when some rank called Abort."""

    def __init__(self, code: int):
        super().__init__(f"ADLB aborted with code {code}")
        self.code = code
