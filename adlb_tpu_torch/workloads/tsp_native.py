"""Branch-and-bound TSP on the all-native plane: C clients
(``examples/tsp_c.c``) against the C++ server daemons, with the
balancer sidecar planning in tpu mode — the reference's priority-queue
stress (reference ``examples/tsp.c``) at OS-process scale.

The harness generates the city matrix (one source of truth, shared with
the in-proc port in :mod:`adlb_tpu_torch.workloads.tsp`) and hands it to the C
clients via ``ADLB_TSP_DISTS``; ``min(best)`` across ranks is validated
against the brute-force optimum when ``n_cities`` is small enough.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.tsp import brute_force_optimum, dist_matrix, make_cities


@dataclasses.dataclass
class TspNativeResult:
    best: int
    optimum: Optional[int]  # brute-forced when n_cities <= 10, else None
    tasks: int  # WORK units processed across ranks (expansions + prunes)
    elapsed: float
    tasks_per_sec: float
    wait_pct: float  # mean fraction of makespan blocked acquiring work


def run(
    n_cities: int = 9,
    num_app_ranks: int = 4,
    nservers: int = 2,
    seed: int = 0,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
    fetch: str = "single",
) -> TspNativeResult:
    """``fetch="batch"`` / ``"batch:<k>"`` switches the C clients to the
    batched fused fetch (``ADLB_Get_work_batch``); priority order inside
    a batch keeps BOUND_UPDT units ahead of WORK."""
    from adlb_tpu_torch.native.capi import run_native_probe

    dists = dist_matrix(make_cities(n_cities, seed))
    flat = ",".join(str(d) for row in dists for d in row)
    env = {
        "ADLB_TSP_N": str(n_cities),
        "ADLB_TSP_DISTS": flat,
    }
    if fetch != "single":
        env["ADLB_TSP_FETCH"] = fetch
    results = run_native_probe(
        "tsp_c.c",
        types=[1, 2],
        env_extra=env,
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    from adlb_tpu_torch.native.capi import (
        check_fetch_mode,
        parse_probe_lines,
        probe_aggregate,
    )

    rows = parse_probe_lines(results, "TSP")
    check_fetch_mode(rows, fetch, "tsp")
    tasks, elapsed, rate, wait_pct = probe_aggregate(rows)
    return TspNativeResult(
        best=min(r["best"] for r in rows),
        optimum=brute_force_optimum(dists) if n_cities <= 10 else None,
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=rate,
        wait_pct=wait_pct,
    )
