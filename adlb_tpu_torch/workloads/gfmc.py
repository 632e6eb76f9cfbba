"""GFMC-style A/B/C/D work-package economy with self-validating counts.

Mirrors the reference's c4 mini-app (reference ``examples/c4.c``), the
abstraction of the GFMC nuclear Monte Carlo production code
(``examples/README-gfmc.txt``): a master emits type-A packages; workers
expand each A into B packages; each B spawns C packages whose *answers* are
routed back (via ``answer_rank`` targeting) to the rank that owns the B,
which combines them into one D result for the master. The expected number of
packages of every type is computable up front, and the run aborts if the
processed counts do not match (reference ``examples/c4.c:176-180,495-502``) —
making this a correctness test of the entire Put/Reserve/answer economy.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

TYPE_A, TYPE_B, TYPE_C, TYPE_C_ANSWER, TYPE_D = 1, 2, 3, 4, 5
PRIO_A, PRIO_B, PRIO_C, PRIO_ANSWER = 1, 2, 3, 9


@dataclasses.dataclass
class GfmcResult:
    ok: bool
    counts: dict[str, int]
    expected: dict[str, int]
    elapsed: float
    tasks_per_sec: float
    tasks_processed: int = 0


def run(
    num_a: int = 6,
    bs_per_a: int = 4,
    cs_per_b: int = 3,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 180.0,
) -> GfmcResult:
    expected = {
        "A": num_a,
        "B": num_a * bs_per_a,
        "C": num_a * bs_per_a * cs_per_b,
        "D": num_a * bs_per_a,
    }

    def app(ctx):
        counts = {"A": 0, "B": 0, "C": 0, "D": 0}
        pending_b: dict[int, tuple[int, int]] = {}  # b_id -> (answers left, acc)
        if ctx.rank == 0:
            for a in range(num_a):
                ctx.put(struct.pack("<i", a), TYPE_A, PRIO_A)
            expected_d = expected["D"]
            got_d = 0
            total = 0
            while got_d < expected_d:
                rc, r = ctx.reserve([TYPE_D])
                assert rc == ADLB_SUCCESS, f"master lost D packages: rc={rc}"
                rc, buf = ctx.get_reserved(r.handle)
                (v,) = struct.unpack("<i", buf)
                total += v
                got_d += 1
                counts["D"] += 1
            ctx.set_problem_done()
            return counts, total
        next_b_id = ctx.rank << 20
        while True:
            rc, r = ctx.reserve([TYPE_A, TYPE_B, TYPE_C, TYPE_C_ANSWER])
            if rc != ADLB_SUCCESS:
                return counts, None
            rc, buf = ctx.get_reserved(r.handle)
            if r.work_type == TYPE_A:
                counts["A"] += 1
                (a,) = struct.unpack("<i", buf)
                for b in range(bs_per_a):
                    ctx.put(
                        struct.pack("<ii", a, b), TYPE_B, PRIO_B,
                        answer_rank=ctx.rank,
                    )
            elif r.work_type == TYPE_B:
                counts["B"] += 1
                a, b = struct.unpack("<ii", buf)
                b_id = next_b_id
                next_b_id += 1
                pending_b[b_id] = [cs_per_b, 0]
                for c in range(cs_per_b):
                    # answer must come back to *this* rank, which owns the
                    # pending-B state (the reference's answer_rank pattern)
                    ctx.put(
                        struct.pack("<iii", b_id, a * 100 + b, c),
                        TYPE_C, PRIO_C, answer_rank=ctx.rank,
                    )
            elif r.work_type == TYPE_C:
                counts["C"] += 1
                b_id, ab, c = struct.unpack("<iii", buf)
                value = ab + c  # the "physics"
                ctx.put(
                    struct.pack("<ii", b_id, value),
                    TYPE_C_ANSWER, PRIO_ANSWER,
                    target_rank=r.answer_rank,
                )
            else:  # TYPE_C_ANSWER
                b_id, value = struct.unpack("<ii", buf)
                st = pending_b[b_id]
                st[0] -= 1
                st[1] += value
                if st[0] == 0:
                    del pending_b[b_id]
                    ctx.put(
                        struct.pack("<i", st[1]), TYPE_D, PRIO_ANSWER,
                        target_rank=0,
                    )
                    counts["D"] += 1

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [TYPE_A, TYPE_B, TYPE_C, TYPE_C_ANSWER, TYPE_D],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.2),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    counts = {"A": 0, "B": 0, "C": 0, "D": 0}
    for rank, (c, _) in res.app_results.items():
        for k, v in c.items():
            counts[k] += v
    # master's D count is receptions; workers' D counts are emissions — count
    # emissions for B/D symmetry
    counts["D"] -= res.app_results[0][0]["D"]
    ok = all(counts[k] == expected[k] for k in ("A", "B", "C", "D"))
    total_tasks = sum(counts.values())
    return GfmcResult(
        ok=ok,
        counts=counts,
        expected=expected,
        elapsed=elapsed,
        tasks_per_sec=total_tasks / elapsed if elapsed > 0 else 0.0,
        tasks_processed=total_tasks,
    )
