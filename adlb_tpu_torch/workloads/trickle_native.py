"""Trickle on the all-native plane: C clients + C++ server daemons (+ the
balancer sidecar in tpu mode), every rank its own OS process.

The in-process trickle probe measures cross-server dispatch latency with
all ranks GIL-coupled in one interpreter; this twin removes that coupling
— the data path is entirely C/C++, and the only Python in the world is
the balancer brain. Scenario shape and metrics match
:mod:`adlb_tpu_torch.workloads.trickle` (steady arrival at one server via home
routing, consumers parked elsewhere; reference analogue: the steady-state
skel shape, reference ``examples/skel.c:10-40``).
"""

from __future__ import annotations

from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.trickle import TrickleResult


def run(
    n_tasks: int = 240,
    interval_us: int = 10000,
    group: int = 2,
    work_us: int = 2000,
    num_app_ranks: int = 8,
    nservers: int = 4,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> TrickleResult:
    from adlb_tpu_torch.native.capi import run_native_probe

    results = run_native_probe(
        "trickle_c.c",
        types=[1, 2],  # TOKEN + the co-homed ranks' NEVER parking type
        env_extra={
            # home routing concentrates the producer's puts on one server,
            # so every delivery to the (remote) consumers is a cross-server
            # dispatch — the latency under test
            "ADLB_PUT_ROUTING": "home",
            "ADLB_TRICK_NTASKS": str(n_tasks),
            "ADLB_TRICK_INTERVAL_US": str(interval_us),
            "ADLB_TRICK_GROUP": str(group),
            "ADLB_TRICK_WORK_US": str(work_us),
        },
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    lats: list = []
    tasks = 0
    for _rc, out, _err in results:
        line = next(ln for ln in out.splitlines() if ln.startswith("TRICK "))
        n = int(line.split("n=")[1].split()[0])
        tasks += n
        vals = line.split("lat_ms=")[1].split()
        lats.extend(float(v) for v in vals)
    if tasks != n_tasks:
        raise RuntimeError(f"trickle_native: lost work ({tasks}/{n_tasks})")
    lats.sort()

    def p(q: float) -> float:
        return lats[min(int(q * len(lats)), len(lats) - 1)] if lats else 0.0

    # elapsed is arrival-paced, not a throughput measure here
    elapsed = n_tasks / max(group, 1) * (interval_us * 1e-6)
    return TrickleResult(
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=tasks / max(elapsed, 1e-9),
        dispatch_p50_ms=p(0.50),
        dispatch_p90_ms=p(0.90),
    )
