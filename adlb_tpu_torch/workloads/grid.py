"""Jacobi grid relaxation — the data-affinity mini-app.

Mirrors the reference pair ``examples/grid_daf.c`` / ``examples/grid_uni.c``:
rank 0 owns the authoritative (nrows+2)×(ncols+2) grid with the boundary set
to ``phi(x, y) = x² − y² + x·y`` (reference ``examples/grid_daf.c:24-28``)
and farms one work unit per row and iteration — payload is the row index,
iteration number, and the row's 3-row neighborhood (reference
``examples/grid_daf.c:107-117``). Any worker (including rank 0) Jacobi-updates
the middle row and sends it back targeted at rank 0 as a type-99 "finished
row" (reference ``examples/grid_daf.c:241-246``). Rank 0 keeps every row in
lock step: only when all rows of an iteration have returned does it re-Put
the next iteration from the updated grid, and after ``niters`` it calls
Set_problem_done (reference ``examples/grid_daf.c:216-240``).

Correctness oracle: :func:`run_sequential` is the uniprocessor reference
(``examples/grid_uni.c``) — the distributed run must reproduce its grid
exactly (same Jacobi averages in a different order).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

ROW = 0  # reference type 00
DONE_ROW = 99  # reference type 99, routed to rank 0


def make_grid(nrows: int, ncols: int) -> np.ndarray:
    """Boundary = phi, interior = 0 (reference gridinit,
    ``examples/grid_daf.c:152-175``)."""

    def phi(x, y):
        return (x * x) - (y * y) + (x * y)

    g = np.zeros((nrows + 2, ncols + 2), dtype=np.float64)
    for j in range(ncols + 2):
        g[0, j] = phi(1, j + 1)
        g[nrows + 1, j] = phi(nrows + 2, j + 1)
    for i in range(1, nrows + 2):
        g[i, 0] = phi(i + 1, 1)
        g[i, ncols + 1] = phi(i + 1, ncols + 2)
    return g


def jacobi_row(three: np.ndarray) -> np.ndarray:
    """One row's Jacobi update from its 3-row neighborhood (reference
    compute(), ``examples/grid_daf.c:177-193``)."""
    up, mid, down = three
    new = mid.copy()
    new[1:-1] = (up[1:-1] + down[1:-1] + mid[:-2] + mid[2:]) / 4.0
    return new


def run_sequential(nrows: int, ncols: int, niters: int) -> np.ndarray:
    """The uniprocessor oracle (reference ``examples/grid_uni.c``)."""
    g = make_grid(nrows, ncols)
    for _ in range(niters):
        new = g.copy()
        for i in range(1, nrows + 1):
            new[i] = jacobi_row(g[i - 1 : i + 2])
        g = new
    return g


@dataclasses.dataclass
class GridResult:
    grid: np.ndarray
    average: float
    rows_computed: dict[int, int]  # rank -> row updates performed


def _pack(row_idx: int, it: int, rows: np.ndarray) -> bytes:
    """ROW units carry the 3-row neighborhood; DONE_ROW units carry only the
    updated middle row (rank 0 reads nothing else)."""
    return struct.pack("<ii", row_idx, it) + rows.tobytes()


def _unpack(buf: bytes, ncols: int) -> tuple[int, int, np.ndarray]:
    row_idx, it = struct.unpack_from("<ii", buf)
    arr = np.frombuffer(buf, dtype=np.float64, offset=8).reshape(-1, ncols + 2)
    return row_idx, it, arr


def run(
    nrows: int = 8,
    ncols: int = 8,
    niters: int = 4,
    num_app_ranks: int = 3,
    nservers: int = 1,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
) -> GridResult:
    out: dict = {}

    def app(ctx):
        computed = 0
        if ctx.rank == 0:
            grid = make_grid(nrows, ncols)
            it = 1
            rows_back = 0
            if niters < 1:  # match the oracle: zero iterations = untouched grid
                ctx.set_problem_done()
                out["grid"] = grid
                return computed
            ctx.begin_batch_put(b"")
            for i in range(1, nrows + 1):
                ctx.put(_pack(i, it, grid[i - 1 : i + 2]), ROW)
            ctx.end_batch_put()
            while True:
                rc, r = ctx.reserve()
                if rc != ADLB_SUCCESS:
                    break
                rc, buf = ctx.get_reserved(r.handle)
                if r.work_type == DONE_ROW:
                    row_idx, row_it, rows = _unpack(buf, ncols)
                    grid[row_idx] = rows[0]
                    rows_back += 1
                    if rows_back == nrows:
                        rows_back = 0
                        it += 1
                        if it > niters:
                            ctx.set_problem_done()
                        else:
                            for i in range(1, nrows + 1):
                                ctx.put(_pack(i, it, grid[i - 1 : i + 2]), ROW)
                else:  # rank 0 is also a worker (reference work() on rank 0)
                    computed += _work_one(ctx, buf)
            out["grid"] = grid
            return computed
        while True:
            rc, r = ctx.reserve([ROW])
            if rc != ADLB_SUCCESS:
                return computed
            rc, buf = ctx.get_reserved(r.handle)
            computed += _work_one(ctx, buf)

    def _work_one(ctx, buf: bytes) -> int:
        row_idx, it, three = _unpack(buf, ncols)
        new_mid = jacobi_row(three)
        ctx.put(_pack(row_idx, it, new_mid), DONE_ROW, work_prio=99,
                target_rank=0)
        return 1

    res = run_world(
        num_app_ranks,
        nservers,
        [ROW, DONE_ROW],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.25),
        timeout=timeout,
    )
    grid = out["grid"]
    return GridResult(
        grid=grid,
        average=float(grid[1:-1, 1:-1].mean()),
        rows_computed=dict(res.app_results),
    )
