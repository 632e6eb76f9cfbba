"""n-queens on the all-native plane: C clients (``examples/nq_c.c``)
against the C++ server daemons — the BASELINE.json north-star workload
(reference ``examples/nq.c``) at OS-process scale, with the same
machine-readable per-rank metrics as the other native probes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.nq import KNOWN_SOLUTIONS


@dataclasses.dataclass
class NqNativeResult:
    solutions: int
    expected: Optional[int]  # known answer when tabulated, else None
    tasks: int  # work units processed across ranks
    elapsed: float
    tasks_per_sec: float
    wait_pct: float  # mean fraction of makespan blocked acquiring work


def run(
    n: int = 7,
    cutoff: int = 2,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> NqNativeResult:
    from adlb_tpu_torch.native.capi import run_native_probe

    results = run_native_probe(
        "nq_c.c",
        types=[1],
        env_extra={
            "ADLB_NQ_N": str(n),
            "ADLB_NQ_CUTOFF": str(cutoff),
        },
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    from adlb_tpu_torch.native.capi import parse_probe_lines, probe_aggregate

    rows = parse_probe_lines(results, "NQ")
    tasks, elapsed, rate, wait_pct = probe_aggregate(rows)
    return NqNativeResult(
        solutions=sum(r["solutions"] for r in rows),
        expected=KNOWN_SOLUTIONS.get(n),
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=rate,
        wait_pct=wait_pct,
    )
