"""skel — the configurable synthetic stress probe.

Mirrors the reference ``examples/skel.c`` + ``examples/c2.c``: a fixed
palette of synthetic work types, each with its own payload size, priority
band, and simulated execution delay (reference ``examples/skel.c:10-40``).
Rank 0 floods the pool with a configurable mix; every rank consumes any
type, sleeps the type's delay, and tallies per-type counts. The run is
self-checking: consumed-per-type must equal produced-per-type (the c4-style
work-unit accounting, reference ``examples/c4.c:495-502``).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional, Sequence

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS


@dataclasses.dataclass(frozen=True)
class TypeSpec:
    """One synthetic work type (reference skel's per-type size/prio/delay
    tables, ``examples/skel.c:10-40``)."""

    work_type: int
    count: int
    size: int = 64
    prio: int = 0
    delay: float = 0.0


DEFAULT_MIX = tuple(
    TypeSpec(work_type=t, count=12, size=32 * (t + 1), prio=t % 4,
             delay=0.0005 * (t % 3))
    for t in range(1, 9)  # eight types, like the reference skel
)


@dataclasses.dataclass
class SkelResult:
    produced: dict[int, int]
    consumed: dict[int, int]
    ok: bool
    elapsed: float
    tasks_per_sec: float


def run(
    mix: Sequence[TypeSpec] = DEFAULT_MIX,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> SkelResult:
    types = sorted({s.work_type for s in mix})
    delays: dict[int, float] = {}
    produced: dict[int, int] = {}
    for s in mix:  # aggregate: a type may appear in several specs
        delays[s.work_type] = max(delays.get(s.work_type, 0.0), s.delay)
        if s.count > 0:
            produced[s.work_type] = produced.get(s.work_type, 0) + s.count

    def app(ctx):
        counts: dict[int, int] = {}
        if ctx.rank == 0:
            for s in mix:
                body = struct.pack("<i", s.work_type) + b"\0" * max(
                    0, s.size - 4
                )
                for _ in range(s.count):
                    ctx.put(body, s.work_type, work_prio=s.prio)
        t_first = t_last = None
        while True:
            rc, r = ctx.reserve()
            if rc != ADLB_SUCCESS:
                return counts, t_first, t_last
            rc, buf = ctx.get_reserved(r.handle)
            if t_first is None:
                t_first = time.monotonic()
            (t,) = struct.unpack_from("<i", buf)
            assert t == r.work_type, "payload/type mismatch"
            if delays[t]:
                time.sleep(delays[t])
            counts[t] = counts.get(t, 0) + 1
            t_last = time.monotonic()

    res = run_world(
        num_app_ranks,
        nservers,
        types,
        app,
        cfg=cfg or Config(exhaust_check_interval=0.2),
        timeout=timeout,
    )
    consumed: dict[int, int] = {}
    firsts: list[float] = []
    lasts: list[float] = []
    for counts, t_first, t_last in res.app_results.values():
        for t, n in counts.items():
            consumed[t] = consumed.get(t, 0) + n
        if t_first is not None:
            firsts.append(t_first)
            lasts.append(t_last)
    total = sum(consumed.values())
    # makespan over the ranks' own first->last task stamps: excludes world
    # spinup and the exhaustion-termination tail (the hotspot.py convention)
    elapsed = (max(lasts) - min(firsts)) if firsts else 0.0
    return SkelResult(
        produced=produced,
        consumed=consumed,
        ok=consumed == produced,
        elapsed=elapsed,
        tasks_per_sec=total / elapsed if elapsed > 0 else 0.0,
    )
