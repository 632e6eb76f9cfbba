"""Hotspot: producer-concentrated load that must be rebalanced to be fast.

The scenario the global balancer exists for (BASELINE.json north star): all
work enters at one server (data-locality routing, ``put_routing="home"``)
while consumers are spread across every server. Throughput is then limited
by how quickly cross-server balancing moves work to parked workers — the
reference's answer is qmstat-guided RFR stealing (reference
``src/adlb.c:1802-2070``); this framework's answer is the batched global
solve. Work is a GIL-free sleep so the in-process harness measures balancing,
not Python compute.

Reports tasks/sec and mean worker busy-fraction (1 - idle%), the BASELINE.md
metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

TOKEN = 1


@dataclasses.dataclass
class HotspotResult:
    tasks: int
    elapsed: float
    tasks_per_sec: float
    busy_fraction: float  # mean over workers (NOMINAL compute / elapsed)
    idle_pct: float
    # mean fraction of the makespan workers spent blocked acquiring work
    # (Reserve+Get) — the steal-to-exec quantity, measured directly;
    # 0.0 where the workload does not report it
    wait_pct: float = 0.0


def run(
    n_tasks: int = 300,
    work_time: float = 0.004,
    num_app_ranks: int = 8,
    nservers: int = 4,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
    fused: bool = True,
    batch: int = 4,
) -> HotspotResult:
    """``fused=True`` (default) consumes via the fused ``get_work_batch``
    call (up to ``batch`` units per round trip, inlined only when the
    units are LOCAL to the responding server) — both modes issue the
    identical call, so the mode that pre-positions work locally is paid
    for that locality, which is the quantity this scenario measures.
    ``fused=False`` keeps the two-call Reserve + Get_reserved loop (the
    reference's only consumer shape, ``src/adlb.c:2868-3025``) for
    comparability with earlier rounds."""
    base = cfg or Config()
    cfg = dataclasses.replace(
        base,
        put_routing="home",
        exhaust_check_interval=min(base.exhaust_check_interval, 0.2),
    )

    def app(ctx):
        if ctx.rank == 0:
            # all tokens land on rank 0's home server
            t_first = time.monotonic()
            for i in range(n_tasks):
                ctx.put(b"w", TOKEN, work_prio=0)
            return t_first, t_first, 0, 0.0
        done = 0
        busy = 0.0
        t_start = time.monotonic()
        t_last = t_start
        while True:
            if fused:
                rc, got = ctx.get_work_batch([TOKEN], max_units=batch)
            else:
                rc, r = ctx.reserve([TOKEN])
            if rc != ADLB_SUCCESS:
                # makespan measured to the last completed task; the
                # exhaustion-termination tail is excluded (it is a constant,
                # not a balancing cost)
                return t_start, t_last, done, busy
            n_units = len(got) if fused else 1
            if not fused:
                rc, buf = ctx.get_reserved(r.handle)
            for _ in range(n_units):
                time.sleep(work_time)  # GIL-free "compute"
                # NOMINAL busy (see hotspot_native: wall-clock busy counts
                # scheduler/GIL delay inside the sleep as utilization,
                # which inverts idle% against throughput under contention)
                busy += work_time
                done += 1
                t_last = time.monotonic()

    res = run_world(num_app_ranks, nservers, [TOKEN], app, cfg=cfg,
                    timeout=timeout)
    workers = [v for k, v in res.app_results.items() if k != 0 and v]
    tasks = sum(w[2] for w in workers)
    t_begin = min(v[0] for v in res.app_results.values())
    t_end = max(w[1] for w in workers)
    elapsed = max(t_end - t_begin, 1e-9)
    busy = sum(w[3] / elapsed for w in workers) / len(workers) if workers else 0.0
    return HotspotResult(
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=tasks / elapsed,
        busy_fraction=busy,
        idle_pct=100.0 * (1.0 - busy),
    )
