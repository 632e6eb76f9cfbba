"""Hotspot on the all-native plane: C clients + C++ server daemons (+ the
balancer sidecar in tpu mode), every rank its own OS process.

This is the scale story the in-process harness cannot tell: one Python
interpreter caps a threaded world at ~5k messages/s (GIL), while the
native plane runs the entire data path in C/C++ processes — the Python
runtime appears only as the balancer brain. Scenario shape and metrics
match :mod:`adlb_tpu_torch.workloads.hotspot` (all work enters one server via
home routing, consumers spread everywhere; reference analogue: the
skel.c synthetic stress, reference ``examples/skel.c:10-40``).
"""

from __future__ import annotations

from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.hotspot import HotspotResult


def run(
    n_tasks: int = 2000,
    work_us: int = 2000,
    num_app_ranks: int = 32,
    nservers: int = 8,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
    fetch: str = "single",
) -> HotspotResult:
    """``fetch="batch"`` (or ``"batch:<k>"``) switches the consumers to
    the batched fused fetch ``ADLB_Get_work_batch`` so the bench can
    measure the single-vs-batch delta on this plane."""
    from adlb_tpu_torch.native.capi import run_native_probe

    env = {
        "ADLB_PUT_ROUTING": "home",
        "ADLB_HOT_NTASKS": str(n_tasks),
        "ADLB_HOT_WORK_US": str(work_us),
    }
    if fetch != "single":
        env["ADLB_HOT_FETCH"] = fetch
    results = run_native_probe(
        "hotspot_c.c",
        types=[1],
        env_extra=env,
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    from adlb_tpu_torch.native.capi import check_fetch_mode, parse_probe_lines

    raw = parse_probe_lines(results, "HOT")
    check_fetch_mode(raw, fetch, "hotspot", skip_first=True)
    rows = [
        (r["done"], r["busy"], r["t0"], r["t1"], r.get("wait", 0.0))
        for r in raw
    ]
    workers = rows[1:]
    tasks = sum(r[0] for r in workers)
    # rank 0 is a pure producer: the makespan starts at its first put but
    # must END at the last WORKER's finish, so probe_makespan (which maxes
    # over all rows) is deliberately not used here
    t_begin = min(r[2] for r in rows)
    t_end = max(r[3] for r in workers)
    elapsed = max(t_end - t_begin, 1e-9)
    # busy is NOMINAL compute (done x work_us, computed by the C worker):
    # utilization = useful worker-seconds / available worker-seconds. A
    # wall-clock busy measure would count involuntary scheduler delay
    # inside the compute sleep as "busy", inflating utilization exactly
    # in the runs where the oversubscribed kernel scheduler is the
    # bottleneck.
    busy = (
        sum(r[1] / elapsed for r in workers) / len(workers) if workers else 0.0
    )
    wait = (
        sum(r[4] / elapsed for r in workers) / len(workers) if workers else 0.0
    )
    return HotspotResult(
        tasks=tasks,
        elapsed=elapsed,
        tasks_per_sec=tasks / elapsed,
        busy_fraction=busy,
        idle_pct=100.0 * (1.0 - busy),
        wait_pct=100.0 * wait,
    )
