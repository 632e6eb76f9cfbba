"""coinop on the all-native plane: the pop-latency microbenchmark as C
client processes (``examples/coinop_c.c``) against the C++ server
daemons — the fork's own steal-to-exec latency probe (reference
``examples/coinop.cpp:79-126,190-213``) with the GIL coupling of the
in-process twin (:mod:`adlb_tpu_torch.workloads.coinop`) removed.

Each C worker prints its Welford mean/stddev (the moments the reference
gathers to its producer via MPI_Gather) plus the raw per-pop latencies;
the harness gathers both, validates that no token was lost, and returns
the same :class:`~adlb_tpu_torch.workloads.coinop.CoinopResult` shape so the
two planes' numbers are directly comparable.
"""

from __future__ import annotations

from typing import Optional

from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads.coinop import CoinopResult


def run(
    n_tokens: int = 400,
    num_app_ranks: int = 4,
    nservers: int = 2,
    token_bytes: int = 64,
    work_us: int = 0,
    cfg: Optional[Config] = None,
    timeout: float = 300.0,
) -> CoinopResult:
    from adlb_tpu_torch.native.capi import (
        parse_probe_lines,
        probe_makespan,
        run_native_probe,
    )

    results = run_native_probe(
        "coinop_c.c",
        types=[1],
        env_extra={
            "ADLB_COIN_NTOKENS": str(n_tokens),
            "ADLB_COIN_BYTES": str(token_bytes),
            "ADLB_COIN_WORK_US": str(work_us),
        },
        num_app_ranks=num_app_ranks,
        nservers=nservers,
        cfg=cfg,
        timeout=timeout,
    )
    rows = parse_probe_lines(results, "COIN")
    all_lats: list[float] = []
    for _rc, out, _err in results:
        line = next(
            ln for ln in out.splitlines() if ln.startswith("COINLAT")
        )
        all_lats.extend(float(v) for v in line.split()[1:])
    pops = sum(r["pops"] for r in rows)
    if pops != n_tokens or len(all_lats) != n_tokens:
        raise RuntimeError(
            f"coinop_native: lost work (pops={pops}, "
            f"lats={len(all_lats)}, want {n_tokens})"
        )
    all_lats.sort()
    per_worker = {
        r["rank"]: (float(r["mean_ms"]), float(r["stddev_ms"]))
        for r in rows
        if r["rank"] != 0 and r["pops"]
    }
    _t0, _t1, elapsed = probe_makespan(rows)
    n = len(all_lats)
    return CoinopResult(
        pops=n,
        latency_mean_ms=sum(all_lats) / n,
        latency_p50_ms=all_lats[n // 2],
        latency_p95_ms=all_lats[min(int(n * 0.95), n - 1)],
        per_worker=per_worker,
        elapsed=elapsed,
        pops_per_sec=n / elapsed,
    )
