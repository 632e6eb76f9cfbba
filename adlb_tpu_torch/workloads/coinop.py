"""coinop: the pop-latency microbenchmark.

Mirrors the fork's addition (reference ``examples/coinop.cpp:79-126,190-213``):
one producer floods N tokens through the pool; every worker accumulates the
latency of each Reserve+Get pop in a streaming :class:`RunningStats` (the
reference's stats.c accumulator pattern) and reports mean/stddev (gathered
to the producer in the reference via MPI_Gather; here returned through app
results, along with the raw latencies for harness-side percentiles).
This is the steal-to-exec latency probe used by BASELINE.md.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS
from adlb_tpu_torch.utils import RunningStats

TOKEN = 1


@dataclasses.dataclass
class CoinopResult:
    pops: int
    latency_mean_ms: float
    latency_p50_ms: float
    latency_p95_ms: float
    per_worker: dict[int, tuple[float, float]]  # rank -> (mean ms, stddev ms)
    elapsed: float
    pops_per_sec: float


def run(
    n_tokens: int = 500,
    num_app_ranks: int = 4,
    nservers: int = 2,
    token_bytes: int = 64,
    work_time: float = 0.0,
    cfg: Optional[Config] = None,
    timeout: float = 180.0,
    spawn: bool = False,
    consumer: str = "classic",
) -> CoinopResult:
    """``spawn=True`` runs real processes over spawn_world — the shape
    that exercises the process fabrics (``Config(fabric)``: shm rings vs
    TCP); the default in-proc thread world measures the queue fabric.
    ``consumer="batch:N"`` pops through the batched fused get_work
    (per-pop latency amortizes the round trip over the batch — the
    framework's own best consumer path, as in the native bench rows);
    "classic" keeps the reference's two-call Reserve+Get loop."""
    payload = b"c" * token_bytes
    batch = int(consumer.split(":")[1]) if consumer.startswith("batch") \
        else 0

    def app(ctx):
        if ctx.rank == 0:
            for i in range(n_tokens):
                ctx.put(payload, TOKEN, work_prio=0)
            # producer finalizes immediately; workers drain the pool and the
            # exhaustion protocol ends the world once it runs dry
            return [], 0.0, 0.0
        lats = []
        stats = RunningStats(f"pop-latency-rank{ctx.rank}")
        stats.on()
        if batch > 0:
            while True:
                t0 = time.monotonic()
                rc, units = ctx.get_work_batch([TOKEN], max_units=batch)
                if rc != ADLB_SUCCESS or not units:
                    return lats, stats.mean, stats.stddev
                dt = (time.monotonic() - t0) / len(units)
                for _ in units:
                    lats.append(dt)
                    stats.enter(dt)
                    if work_time > 0:
                        time.sleep(work_time)
        while True:
            t0 = time.monotonic()
            rc, r = ctx.reserve([TOKEN])
            if rc != ADLB_SUCCESS:
                return lats, stats.mean, stats.stddev
            rc, buf, _tq = ctx.get_reserved_timed(r.handle)
            dt = time.monotonic() - t0
            lats.append(dt)
            stats.enter(dt)
            if work_time > 0:
                time.sleep(work_time)

    t0 = time.monotonic()
    if spawn:
        from adlb_tpu_torch.runtime.transport_tcp import spawn_world

        res = spawn_world(
            num_app_ranks,
            nservers,
            [TOKEN],
            app,
            cfg=cfg or Config(exhaust_check_interval=0.25),
            timeout=timeout,
        )
    else:
        res = run_world(
            num_app_ranks,
            nservers,
            [TOKEN],
            app,
            cfg=cfg or Config(exhaust_check_interval=0.25),
            timeout=timeout,
        )
    elapsed = time.monotonic() - t0
    all_lats = sorted(
        lat for rank, (lats, _m, _s) in res.app_results.items()
        for lat in lats
    )
    per_worker = {
        rank: (mean * 1e3, stddev * 1e3)
        for rank, (lats, mean, stddev) in res.app_results.items()
        if rank != 0 and lats
    }
    n = len(all_lats)
    return CoinopResult(
        pops=n,
        latency_mean_ms=(statistics.mean(all_lats) * 1e3) if n else 0.0,
        latency_p50_ms=(all_lats[n // 2] * 1e3) if n else 0.0,
        latency_p95_ms=(all_lats[int(n * 0.95)] * 1e3) if n else 0.0,
        per_worker=per_worker,
        elapsed=elapsed,
        pops_per_sec=n / elapsed if elapsed > 0 else 0.0,
    )
