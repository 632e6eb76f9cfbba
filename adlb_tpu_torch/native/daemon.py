"""Bootstrap protocol for the native server daemon (serverd.cpp).

One place for the stdin/stdout handshake both launchers speak
(transport_tcp._native_server_main and capi.run_native_world):

    stdin:  config lines ... "endconfig"
    stdout: "PORT <n>"
    stdin:  "addr <rank> <host> <port>" ... "endaddrs"
    ... runs ...
    stdout: "STATS {json}" (and/or "ABORT <code>")
"""

from __future__ import annotations

import json
import subprocess
from typing import Optional


def spawn_daemon(world, cfg, rank: int) -> subprocess.Popen:
    """Start adlb_serverd for one server rank and ship its config."""
    from adlb_tpu_torch.native.build import ensure_serverd

    proc = subprocess.Popen(
        [ensure_serverd()],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        text=True,
    )
    lines = [
        f"nranks {world.nranks}",
        f"nservers {world.nservers}",
        f"use_debug_server {1 if world.use_debug_server else 0}",
        "types " + " ".join(str(t) for t in world.types),
        f"rank {rank}",
        f"qmstat_interval {cfg.qmstat_interval}",
        f"qmstat_mode {cfg.qmstat_mode}",
        f"exhaust_check_interval {cfg.exhaust_check_interval}",
        f"max_malloc {cfg.max_malloc_per_server}",
        f"debug_log_interval {cfg.debug_log_interval}",
        f"periodic_log_interval {cfg.periodic_log_interval}",
    ]
    if cfg.restore_path:
        lines.append(f"restore_path {cfg.restore_path}")
    if cfg.balancer == "tpu":
        # the balancer sidecar listens at pseudo-rank world.nranks
        lines += [
            "balancer tpu",
            f"balancer_rank {world.nranks}",
            f"balancer_interval {cfg.balancer_interval}",
            f"balancer_min_gap {cfg.balancer_min_gap}",
            f"balancer_max_tasks {cfg.balancer_max_tasks}",
            f"balancer_max_requesters {cfg.balancer_max_requesters}",
        ]
    lines.append("endconfig")
    proc.stdin.write("\n".join(lines) + "\n")
    proc.stdin.flush()
    return proc


def read_hello(proc: subprocess.Popen, rank: int) -> int:
    """Read the PORT line; raises (after killing the daemon) on anything
    else, so a crashed daemon fails loudly instead of hanging the world."""
    line = (proc.stdout.readline() or "").strip()
    if not line.startswith("PORT "):
        proc.kill()
        raise RuntimeError(
            f"native server rank {rank}: bad hello {line!r} "
            f"(exit={proc.poll()})"
        )
    return int(line.split()[1])


def send_addrs(proc: subprocess.Popen, addr_map: dict) -> None:
    lines = [
        f"addr {r} {host} {port}"
        for r, (host, port) in sorted(addr_map.items())
    ] + ["endaddrs"]
    proc.stdin.write("\n".join(lines) + "\n")
    proc.stdin.flush()


def _parse_trailer(lines):
    """Parse STATS/ABORT lines from an iterable; other output (STAT_APS
    chunks, diagnostics) passes through to stdout so the offline decoder
    and the operator still see it. Returns (stats dict (int key -> float)
    or None, abort code or None)."""
    import sys

    stats: Optional[dict] = None
    abort_code: Optional[int] = None
    for line in lines:
        line = line.rstrip("\n")
        stripped = line.strip()
        if stripped.startswith("STATS "):
            stats = {int(k): v for k, v in json.loads(stripped[6:]).items()}
        elif stripped.startswith("ABORT "):
            abort_code = int(stripped.split()[1])
        elif stripped:
            print(line, file=sys.stdout)
    return stats, abort_code


def drain_output(proc: subprocess.Popen):
    """Consume the daemon's stdout to completion; returns
    (stats, abort_code) per :func:`_parse_trailer`."""
    return _parse_trailer(proc.stdout)


def collect_stats(proc: subprocess.Popen, timeout: float = 15.0):
    """Wait for exit and parse trailing output (for callers that did not
    stream stdout); kills on timeout. Returns (stats, abort_code,
    returncode)."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    stats, abort_code = _parse_trailer((out or "").splitlines())
    return stats, abort_code, proc.returncode
