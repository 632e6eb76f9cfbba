"""GFMC A/B/C/D economy on the all-native plane: C clients
(``examples/gfmc_c.c``) against the C++ server daemons — the reference
c4 mini-app's answer economy (reference ``examples/c4.c:31-37``) at
OS-process scale.  The C master self-checks the checksum (nonzero exit
on mismatch); the harness independently checks the package counts."""

from __future__ import annotations

import dataclasses
from typing import Optional

from adlb_tpu_torch.runtime.world import Config


@dataclasses.dataclass
class GfmcNativeResult:
    ok: bool
    counts: dict
    expected: dict
    tasks: int
    elapsed: float
    tasks_per_sec: float
    wait_pct: float


def run(
    num_a: int = 6,
    bs_per_a: int = 4,
    cs_per_b: int = 3,
    num_app_ranks: int = 4,
    nservers: int = 2,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> GfmcNativeResult:
    from adlb_tpu_torch.native.capi import (
        parse_probe_lines,
        probe_aggregate,
        run_native_probe,
    )

    if num_app_ranks < 2:
        # the master is a dedicated collector (reserves only TYPE_D);
        # with no worker ranks the economy can never run — fail fast
        raise ValueError("gfmc_native needs num_app_ranks >= 2")
    expected = {
        "a": num_a,
        "b": num_a * bs_per_a,
        "c": num_a * bs_per_a * cs_per_b,
        "d": num_a * bs_per_a,
    }
    results = run_native_probe(
        "gfmc_c.c",
        types=[1, 2, 3, 4, 5],
        env_extra={
            "ADLB_GFMC_NA": str(num_a),
            "ADLB_GFMC_BPA": str(bs_per_a),
            "ADLB_GFMC_CPB": str(cs_per_b),
        },
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    rows = parse_probe_lines(results, "GFMC")
    counts = {
        k: sum(r[k] for r in rows) for k in ("a", "b", "c", "d")
    }
    # throughput counts every unit a worker consumed, including C-answer
    # receptions (outside the package-count check but real queue traffic).
    # The master (rank 0) is a dedicated collector blocked in Reserve for
    # nearly the whole makespan by design — its row stays in the makespan
    # but is excluded from the wait average (as hotspot_native excludes
    # its producer), else wait_pct carries a ~1/num_app_ranks floor that
    # says nothing about balancing.
    tasks = sum(counts.values()) + sum(r["ans"] for r in rows)
    tasks, elapsed, rate, wait_pct = probe_aggregate(
        rows, tasks=tasks, wait_rows=rows[1:]
    )
    return GfmcNativeResult(
        ok=all(counts[k] == expected[k] for k in expected),
        counts=counts,
        expected=expected,
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=rate,
        wait_pct=wait_pct,
    )
