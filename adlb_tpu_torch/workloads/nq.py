"""n-queens: recursive DFS over the shared pool.

Mirrors the reference's decomposition (reference ``examples/nq.c:74-140``):
a work unit is a partial board (one queen row per filled column); a worker
expands the first open column, re-Putting each safe child with priority equal
to the column index — deeper subproblems get higher priority, giving the pool
depth-first flavor — until the cutoff depth ``max_depth_for_puts``, below
which it solves the subtree locally. Workers keep local solution counts and
the world terminates by exhaustion (reference nq's quiet mode); the driver
sums and validates against the known answer.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

WORK = 1

KNOWN_SOLUTIONS = {
    4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352, 10: 724,
    # scale rows for the native harness (OEIS A000170)
    11: 2680, 12: 14200, 13: 73712, 14: 365596,
}


def _safe(col: int, row: int, rows: list[int]) -> bool:
    for c in range(col):
        r = rows[c]
        if r == row or r + c == col + row or c - r == col - row:
            return False
    return True


def _count_subtree(n: int, rows: list[int], col: int) -> int:
    if col == n:
        return 1
    total = 0
    for row in range(n):
        if _safe(col, row, rows):
            rows[col] = row
            total += _count_subtree(n, rows, col + 1)
            rows[col] = -1
    return total


@dataclasses.dataclass
class NqResult:
    solutions: int
    tasks_processed: int
    puts: int
    elapsed: float
    tasks_per_sec: float


def app_main(ctx, n: int, max_depth_for_puts: int):
    """Per-rank worker body: returns (solutions, tasks_processed, puts)."""
    fmt = f"<{n}i"
    processed = 0
    puts = 0
    solutions = 0
    if ctx.rank == 0:
        ctx.put(struct.pack(fmt, *([-1] * n)), WORK, work_prio=0)
        puts += 1
    while True:
        rc, r = ctx.reserve([WORK])
        if rc != ADLB_SUCCESS:
            return solutions, processed, puts
        rc, buf = ctx.get_reserved(r.handle)
        rows = list(struct.unpack(fmt, buf))
        processed += 1
        col = n
        for i in range(n):
            if rows[i] < 0:
                col = i
                break
        if col <= max_depth_for_puts and col < n:
            for row in range(n):
                if _safe(col, row, rows):
                    rows[col] = row
                    ctx.put(struct.pack(fmt, *rows), WORK, work_prio=col)
                    puts += 1
                    rows[col] = -1
        else:
            solutions += _count_subtree(n, rows, col)


def run(
    n: int = 8,
    num_app_ranks: int = 4,
    nservers: int = 2,
    max_depth_for_puts: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> NqResult:
    def app(ctx):
        return app_main(ctx, n, max_depth_for_puts)

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [WORK],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.15),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    solutions = sum(v[0] for v in res.app_results.values())
    tasks = sum(v[1] for v in res.app_results.values())
    puts = sum(v[2] for v in res.app_results.values())
    return NqResult(
        solutions=solutions,
        tasks_processed=tasks,
        puts=puts,
        elapsed=elapsed,
        tasks_per_sec=tasks / elapsed if elapsed > 0 else 0.0,
    )
