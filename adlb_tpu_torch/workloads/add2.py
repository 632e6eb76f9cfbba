"""add2 — the answer-economy smoke workload.

Mirrors the reference ``examples/add2.c``: rank 0 Puts TYPE_AB units each
holding two integers; workers Reserve them, add the pair, and Put the sum
back as a TYPE_C unit targeted at rank 0 (the answer_rank economy); rank 0
collects every sum and verifies the total against the locally computed
expectation — a self-checking test of Put/Reserve/targeting/termination.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Sequence

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

TYPE_AB = 1
TYPE_C = 2


@dataclasses.dataclass
class Add2Result:
    total: int
    expected: int
    ok: bool
    sums_by_rank: dict[int, int]  # rank -> pairs added


def run(
    pairs: Sequence[tuple[int, int]],
    num_app_ranks: int = 3,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> Add2Result:
    if num_app_ranks < 2:
        # rank 0 only collects TYPE_C answers; someone else must serve
        # TYPE_AB or the exhaustion vote flushes rank 0's reserve
        raise ValueError("add2 needs at least 2 app ranks (1 master + workers)")
    expected = sum(a + b for a, b in pairs)
    out: dict = {}

    def app(ctx):
        added = 0
        if ctx.rank == 0:
            for a, b in pairs:
                ctx.put(struct.pack("<qq", a, b), TYPE_AB, answer_rank=0)
            total = 0
            for _ in range(len(pairs)):
                rc, r = ctx.reserve([TYPE_C])
                assert rc == ADLB_SUCCESS
                rc, buf = ctx.get_reserved(r.handle)
                (s,) = struct.unpack("<q", buf)
                total += s
            out["total"] = total
            ctx.set_problem_done()
            return added
        while True:
            rc, r = ctx.reserve([TYPE_AB])
            if rc != ADLB_SUCCESS:
                return added
            rc, buf = ctx.get_reserved(r.handle)
            a, b = struct.unpack("<qq", buf)
            ctx.put(struct.pack("<q", a + b), TYPE_C, target_rank=r.answer_rank)
            added += 1

    res = run_world(
        num_app_ranks,
        nservers,
        [TYPE_AB, TYPE_C],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.25),
        timeout=timeout,
    )
    total = out["total"]
    return Add2Result(
        total=total,
        expected=expected,
        ok=total == expected,
        sums_by_rank=dict(res.app_results),
    )
