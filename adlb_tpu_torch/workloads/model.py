"""model — the minimal master/worker dummy-work model.

Mirrors the reference ``examples/model.c``: the master app rank Puts
``numprobs`` untargeted PROBLEM units at a fixed priority; every app rank
(master included) then loops a wildcard Reserve (``req_types[0] = -1``,
reference ``examples/model.c:90-92``), performs a fixed chunk of dummy work
per unit (the reference sleeps 1 s, ``examples/model.c:113``), and counts
units until the run terminates **by exhaustion** — model.c never calls
Set_problem_done, so it exercises the double-pass exhaustion vote end to end
(reference ``src/adlb.c:1575-1650``).

Self-check: the per-rank counts must sum to ``numprobs``.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

PROBLEM = 1
SOLUTION = 2  # declared by the reference but never Put; kept for parity
PROBLEM_PRIORITY = 5


@dataclasses.dataclass
class ModelResult:
    num_done: int
    numprobs: int
    ok: bool
    done_by_rank: dict[int, int]
    elapsed: float


def run(
    numprobs: int = 20,
    work_secs: float = 0.01,
    num_app_ranks: int = 4,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> ModelResult:
    t0 = time.monotonic()

    def app(ctx):
        if ctx.rank == 0:
            for i in range(numprobs):
                rc = ctx.put(
                    struct.pack("<i", i), PROBLEM, work_prio=PROBLEM_PRIORITY
                )
                assert rc == ADLB_SUCCESS
        num_done = 0
        while True:
            rc, r = ctx.reserve()  # wildcard, like req_types[0] = -1
            if rc != ADLB_SUCCESS:
                break  # NO_MORE_WORK / DONE_BY_EXHAUSTION
            assert r.work_type == PROBLEM, f"unexpected type {r.work_type}"
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                break
            time.sleep(work_secs)  # dummy work (model.c sleeps 1 s)
            num_done += 1
        return num_done

    res = run_world(
        num_app_ranks,
        nservers,
        [PROBLEM, SOLUTION],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.25),
        timeout=timeout,
    )
    done_by_rank = dict(res.app_results)
    total = sum(done_by_rank.values())
    return ModelResult(
        num_done=total,
        numprobs=numprobs,
        ok=total == numprobs,
        done_by_rank=done_by_rank,
        elapsed=time.monotonic() - t0,
    )
