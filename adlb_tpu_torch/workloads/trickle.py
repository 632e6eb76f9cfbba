"""Trickle: steady work arrival at one server, consumers elsewhere —
the dispatch-latency scenario.

Complements :mod:`~adlb_tpu_torch.workloads.hotspot` (bulk placement): here the
producer emits small groups of units at a steady rate roughly matching
aggregate consumption, so the pool never builds a backlog and every unit's
cost is dominated by *discovery* — how fast the balancing layer notices new
work at the hot server and routes it to a parked remote worker. Upstream's
stealing discovers via the periodic qmstat gossip (reference
``src/adlb.c:806-822``: 0.1 s ring interval, plus per-hop staleness), so a
trickling unit waits a gossip period before an RFR can fetch it; the global
planner sees parked requesters and fresh inventory in the same solve and
matches them event-driven.

Metrics: per-unit pop-to-exec latency percentiles (time from Put to
Get_reserved, the coinop methodology over a trickle) and tasks/sec.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

TOKEN = 1
NEVER = 2  # parked-on by hot-server ranks so they never consume locally


@dataclasses.dataclass
class TrickleResult:
    tasks: int
    elapsed: float
    tasks_per_sec: float
    dispatch_p50_ms: float
    dispatch_p90_ms: float


def run(
    n_tasks: int = 200,
    interval: float = 0.01,
    group: int = 2,
    work_time: float = 0.002,
    num_app_ranks: int = 8,
    nservers: int = 4,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
    consumer: str = "classic",
    stream_depth: int = 4,
) -> TrickleResult:
    """``consumer`` picks the consumer loop shape:

    * ``"classic"`` — the reference's two-call Reserve + Get_reserved loop
      (the continuity baseline);
    * ``"fused"`` — blocking ``get_work`` (one client-visible round trip
      per unit since the remote fused fetch);
    * ``"stream"`` — the pipelined ``get_work_stream(depth=stream_depth)``
      consumer: reserves stay parked across the compute, so a trickling
      unit never waits out a re-park round trip.
    """
    if consumer not in ("classic", "fused", "stream"):
        raise ValueError(f"unknown consumer {consumer!r}")
    base = cfg or Config()
    cfg = dataclasses.replace(
        base,
        put_routing="home",
        exhaust_check_interval=min(base.exhaust_check_interval, 0.2),
    )

    def app(ctx):
        hot_server = ctx.world.home_server(0)
        if ctx.rank == 0:
            # steady trickle into rank 0's home server; the payload carries
            # the put timestamp so consumers can measure put->get latency
            # (CLOCK_MONOTONIC is machine-wide, and this harness is one host)
            n = 0
            while n < n_tasks:
                for _ in range(min(group, n_tasks - n)):
                    ctx.put(struct.pack("<d", time.monotonic()), TOKEN)
                    n += 1
                time.sleep(interval)
            return None
        if ctx.world.home_server(ctx.rank) == hot_server:
            # co-located with the producer: park on a type nobody puts, so
            # every token must be DISCOVERED by a remote server's balancer
            rc, _ = ctx.reserve([NEVER])
            assert rc != ADLB_SUCCESS
            return None
        lats = []
        t0 = time.monotonic()
        t_last = t0
        if consumer == "stream":
            with ctx.get_work_stream([TOKEN], depth=stream_depth) as ws:
                for w in ws:
                    (t_put,) = struct.unpack("<d", w.payload)
                    lats.append(time.monotonic() - t_put)
                    time.sleep(work_time)
                    t_last = time.monotonic()
            return (lats, t0, t_last)
        while True:
            if consumer == "fused":
                rc, w = ctx.get_work([TOKEN])
                if rc != ADLB_SUCCESS:
                    return (lats, t0, t_last)
                buf = w.payload
            else:
                rc, r = ctx.reserve([TOKEN])
                if rc != ADLB_SUCCESS:
                    return (lats, t0, t_last)
                rc, buf = ctx.get_reserved(r.handle)
            (t_put,) = struct.unpack("<d", buf)
            lats.append(time.monotonic() - t_put)
            time.sleep(work_time)
            t_last = time.monotonic()

    res = run_world(num_app_ranks, nservers, [TOKEN, NEVER], app, cfg=cfg,
                    timeout=timeout)
    workers = [v for k, v in res.app_results.items() if k != 0 and v]
    lats = sorted(x for w in workers for x in w[0])
    assert lats, "no tasks consumed"
    t0 = min(w[1] for w in workers)
    t_last = max(w[2] for w in workers)
    span = max(t_last - t0, 1e-9)
    p = lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]  # noqa: E731
    return TrickleResult(
        tasks=len(lats),
        elapsed=span,
        tasks_per_sec=len(lats) / span,
        dispatch_p50_ms=1e3 * p(0.50),
        dispatch_p90_ms=1e3 * p(0.90),
    )
