"""Sudoku on the all-native plane: C clients (``examples/sudoku_c.c``)
against the C++ server daemons — multi-type reserve with a collector
rank at OS-process scale (reference ``examples/sudoku.c``).  The
harness supplies digit-relabeled isomorphs of the puzzle (one source of
truth with the in-proc port) and re-validates every echoed solution."""

from __future__ import annotations

import dataclasses
from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.sudoku import (
    DEFAULT_PUZZLE,
    _relabel,
    check_solution,
)


@dataclasses.dataclass
class SudokuNativeResult:
    valid: bool  # every puzzle solved and every solution validated twice
    solved: int
    tasks: int  # boards expanded across worker ranks
    elapsed: float
    tasks_per_sec: float
    wait_pct: float


def run(
    puzzle: str = DEFAULT_PUZZLE,
    n_puzzles: int = 1,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> SudokuNativeResult:
    from adlb_tpu_torch.native.capi import (
        parse_probe_lines,
        probe_aggregate,
        run_native_probe,
    )

    if num_app_ranks < 2:
        # rank 0 is a dedicated collector (reserves only SOLUTION); with
        # no worker ranks the WORK pool can never drain and the world
        # hangs until the timeout — fail fast instead
        raise ValueError("sudoku_native needs num_app_ranks >= 2")
    if n_puzzles > 64:
        raise ValueError("sudoku_c.c caps puzzles per run at 64 (MAXP)")
    puzzles = [puzzle] + [
        _relabel(puzzle, seed) for seed in range(1, n_puzzles)
    ]
    results = run_native_probe(
        "sudoku_c.c",
        types=[1, 2],
        env_extra={"ADLB_SUDOKU_PUZZLES": ",".join(puzzles)},
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    # rank 0's exit code already enforced its in-C validation
    # (run_native_probe raises on nonzero); re-check the echoed boards
    # here so harness and client validations are independent
    sols = {}
    for ln in results[0][1].splitlines():
        if ln.startswith("SUDSOL "):
            kv = dict(f.split("=") for f in ln.split()[1:])
            sols[int(kv["pid"])] = bytes(int(ch) for ch in kv["board"])
    valid = len(sols) == len(puzzles) and all(
        check_solution(sols[pid], puzzles[pid]) for pid in sols
    )
    rows = parse_probe_lines(results, "SUD")
    # rank 0 is a dedicated SOLUTION collector (done=0, blocked most of
    # the makespan by design): keep it in the makespan, exclude it from
    # the wait average — same treatment as hotspot_native's producer
    tasks, elapsed, rate, wait_pct = probe_aggregate(
        rows, wait_rows=rows[1:]
    )
    return SudokuNativeResult(
        valid=valid,
        solved=rows[0]["solved"],
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=rate,
        wait_pct=wait_pct,
    )
