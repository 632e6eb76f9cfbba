"""Batcher: a bag of heterogeneous jobs, dynamically balanced.

Mirrors the reference batcher (reference ``examples/batcher.c``,
``examples/README-batcher.txt``): a master reads a list of independent jobs
of widely varying cost and Puts them untargeted; workers pull and execute.
The reference runs shell commands; here a job is a timed busy/sleep payload,
and the result of interest is elapsed wall-clock vs the serial sum —
the reference's own published example is 9 jobs / 45 s serial finishing in
25 s on 2 workers (``README-batcher.txt:78-95``).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional, Sequence

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

JOB = 1


@dataclasses.dataclass
class BatcherResult:
    elapsed: float
    serial_time: float
    jobs_run: dict[int, int]  # rank -> count
    speedup: float


def run(
    durations: Sequence[float],
    num_app_ranks: int = 3,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> BatcherResult:
    serial = sum(durations)

    def app(ctx):
        n = 0
        if ctx.rank == 0:
            # longest-job-first priorities: classic makespan heuristic the
            # dynamic pool turns into near-optimal schedules
            for d in durations:
                ctx.put(struct.pack("<d", d), JOB, work_prio=int(d * 1000))
        while True:
            rc, r = ctx.reserve([JOB])
            if rc != ADLB_SUCCESS:
                return n
            rc, buf = ctx.get_reserved(r.handle)
            (d,) = struct.unpack("<d", buf)
            time.sleep(d)  # the "shell job"
            n += 1

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [JOB],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.1),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    return BatcherResult(
        elapsed=elapsed,
        serial_time=serial,
        jobs_run=dict(res.app_results),
        speedup=serial / elapsed if elapsed > 0 else 0.0,
    )
