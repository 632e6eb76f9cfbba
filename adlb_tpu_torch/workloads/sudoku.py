"""Sudoku DFS: known-answer board solve through the pool.

Mirrors the reference's approach (reference ``examples/sudoku.c``): a work
unit is a whole board; a worker picks the most-constrained empty cell,
Puts one child board per legal digit (priority = number of filled cells, so
nearly-complete boards are preferred), and a completed board is sent to rank
0 as a max-priority targeted SOLUTION unit. Rank 0 validates the solution and
declares the problem done (reference prints the solved board,
``examples/sudoku.c:283-287``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.types import ADLB_SUCCESS

WORK = 1
SOLUTION = 2

# A standard 9x9 puzzle (0 = empty) with a unique solution.
DEFAULT_PUZZLE = (
    "530070000"
    "600195000"
    "098000060"
    "800060003"
    "400803001"
    "700020006"
    "060000280"
    "000419005"
    "000080079"
)


def _candidates(board: bytes, idx: int) -> list[int]:
    r, c = divmod(idx, 9)
    used = set()
    for i in range(9):
        used.add(board[r * 9 + i])
        used.add(board[i * 9 + c])
    br, bc = 3 * (r // 3), 3 * (c // 3)
    for i in range(3):
        for j in range(3):
            used.add(board[(br + i) * 9 + (bc + j)])
    return [d for d in range(1, 10) if d not in used]


def _most_constrained(board: bytes) -> tuple[int, list[int]]:
    best_idx, best_cands = -1, None
    for i in range(81):
        if board[i] == 0:
            cands = _candidates(board, i)
            if best_cands is None or len(cands) < len(best_cands):
                best_idx, best_cands = i, cands
                if len(cands) <= 1:
                    break
    return best_idx, best_cands if best_cands is not None else []


def check_solution(board: bytes, puzzle: str) -> bool:
    for i in range(81):
        given = int(puzzle[i])
        if given and board[i] != given:
            return False
    want = set(range(1, 10))
    for r in range(9):
        if {board[r * 9 + c] for c in range(9)} != want:
            return False
    for c in range(9):
        if {board[r * 9 + c] for r in range(9)} != want:
            return False
    for br in range(3):
        for bc in range(3):
            cells = {
                board[(3 * br + i) * 9 + (3 * bc + j)]
                for i in range(3)
                for j in range(3)
            }
            if cells != want:
                return False
    return True


@dataclasses.dataclass
class SudokuResult:
    solution: bytes
    valid: bool
    tasks_processed: int
    elapsed: float


def _relabel(puzzle: str, seed: int) -> str:
    """Digit-relabeled isomorph: permuting the digit alphabet preserves
    sudoku validity but reorders every candidate list, giving a distinct
    search tree — a cheap way to batch independent instances."""
    import random

    perm = list(range(1, 10))
    random.Random(seed).shuffle(perm)
    table = {"0": "0"}
    for i, p in enumerate(perm):
        table[str(i + 1)] = str(p)
    return "".join(table[ch] for ch in puzzle)


def run(
    puzzle: str = DEFAULT_PUZZLE,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 120.0,
    n_puzzles: int = 1,
) -> SudokuResult:
    """Solve ``n_puzzles`` digit-relabeled isomorphs of ``puzzle`` in one
    world (board payloads carry a puzzle-id byte). Batching keeps the pool
    busy long enough that first-solution search luck and the serial warmup
    average out — single-instance runs are rate-noise at benchmark scale."""
    puzzles = [puzzle] + [
        _relabel(puzzle, seed) for seed in range(1, n_puzzles)
    ]
    starts = [
        bytes(int(ch) for ch in p) + bytes([pid])
        for pid, p in enumerate(puzzles)
    ]

    def app(ctx):
        processed = 0
        if ctx.rank == 0:
            for pid, s in enumerate(starts):
                ctx.put(s, WORK, work_prio=sum(1 for b in s[:81] if b))
            # rank 0 collects one solution per puzzle (reference nq/sudoku
            # pattern: collector rank + workers)
            sols: dict[int, bytes] = {}
            while len(sols) < len(starts):
                rc, r = ctx.reserve([SOLUTION])
                if rc != ADLB_SUCCESS:
                    break
                rc, buf = ctx.get_reserved(r.handle)
                sols.setdefault(buf[81], bytes(buf[:81]))
            ctx.set_problem_done()
            return sols, processed
        while True:
            rc, r = ctx.reserve([WORK])
            if rc != ADLB_SUCCESS:
                return None, processed
            rc, buf = ctx.get_reserved(r.handle)
            processed += 1
            board, pid = bytes(buf[:81]), buf[81]
            idx, cands = _most_constrained(board)
            if idx < 0:  # solved
                ctx.put(buf, SOLUTION, 999999999, target_rank=0)
                continue
            filled = sum(1 for b in board if b)
            for d in cands:
                child = bytearray(buf)
                child[idx] = d
                ctx.put(bytes(child), WORK, work_prio=filled + 1)

    t0 = time.monotonic()
    res = run_world(
        num_app_ranks,
        nservers,
        [WORK, SOLUTION],
        app,
        cfg=cfg or Config(exhaust_check_interval=0.2),
        timeout=timeout,
    )
    elapsed = time.monotonic() - t0
    sols = res.app_results[0][0] or {}
    tasks = sum(v[1] for v in res.app_results.values())
    valid = len(sols) == len(puzzles) and all(
        check_solution(sols[pid], puzzles[pid]) for pid in sols
    )
    return SudokuResult(
        solution=sols.get(0),
        valid=valid,
        tasks_processed=tasks,
        elapsed=elapsed,
    )
