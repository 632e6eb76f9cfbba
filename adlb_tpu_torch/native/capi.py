"""Build + run harness for the native C client library.

``libadlb.so`` implements the public C API (include/adlb/adlb.h) over the
binary wire codec; this module compiles it (plain g++, same no-machinery
spirit as the wq core build) and runs mixed worlds: Python servers on the
TCP fabric + native client processes, rendezvousing through a file — the
moral equivalent of the reference's `mpiexec -n k ./a.out` launch
(reference examples/README-batcher.txt:57).

The library and the example programs linked against it are built into the
git-ignored ``adlb_tpu_torch/_build/native/`` (``build.BUILD_DIR``), and
each example's rpath points there. The C header and the example sources
are the repo root's ``include/`` and ``examples/``.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

from adlb_tpu_torch.native.build import BUILD_DIR, compile_to

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_DIR))
_SRC = os.path.join(_DIR, "libadlb.cpp")
_FSRC = os.path.join(_DIR, "adlbf.c")
_LIB = os.path.join(BUILD_DIR, "libadlb.so")
_INCLUDE = os.path.join(_REPO, "include")

_lock = threading.Lock()


def build_libadlb() -> str:
    """Compile libadlb.so (cached by mtime); returns its path."""
    with _lock:
        srcs = [_SRC] + ([_FSRC] if os.path.exists(_FSRC) else [])
        deps = srcs + [os.path.join(_INCLUDE, "adlb", "adlb.h")]
        try:
            return compile_to(_LIB, deps, lambda tmp: [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                f"-I{_INCLUDE}", "-o", tmp, *srcs,
            ])
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"libadlb build failed:\n{e.stderr}") from e


def build_example(src: str, out: Optional[str] = None) -> str:
    """Compile a C example against the port's libadlb (rpath into the
    build directory's real path, which outlives a link the package was
    imported through); returns the binary path."""
    lib = build_libadlb()
    out = out or os.path.join(
        BUILD_DIR, "adlb_" + os.path.splitext(os.path.basename(src))[0])
    rpath = os.path.realpath(BUILD_DIR)
    try:
        return compile_to(out, [src, lib], lambda tmp: [
            "gcc", "-O2", f"-I{_INCLUDE}", "-o", tmp, src,
            f"-L{BUILD_DIR}", "-ladlb", f"-Wl,-rpath,{rpath}", "-lm",
        ])
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"example build failed:\n{e.stderr}") from e


def run_native_probe(
    example: str,
    types,
    env_extra: dict,
    num_app_ranks: int,
    nservers: int,
    cfg=None,
    timeout: float = 300.0,
):
    """Shared bootstrap for the native benchmark probes
    (workloads/hotspot_native.py, workloads/trickle_native.py): force
    native servers, build ``examples/<example>``, run one C client per app
    rank, and raise on any nonzero client exit. Returns the per-rank
    (rc, stdout, stderr) list."""
    import dataclasses

    from adlb_tpu_torch.runtime.world import Config

    base = cfg or Config()
    cfg = dataclasses.replace(
        base,
        server_impl="native",
        exhaust_check_interval=min(base.exhaust_check_interval, 0.2),
    )
    exe = build_example(os.path.join(_REPO, "examples", example))
    results, _stats = run_native_world(
        n_clients=num_app_ranks,
        nservers=nservers,
        types=list(types),
        exe=exe,
        cfg=cfg,
        env_extra=env_extra,
        timeout=timeout,
    )
    for rank, (rc, out, err) in enumerate(results):
        if rc != 0:
            raise RuntimeError(
                f"{example} rank {rank} exited {rc}\n"
                f"stdout:{out}\nstderr:{err}"
            )
    return results


def parse_probe_lines(results, prefix: str):
    """Parse the per-rank ``PREFIX k=v ...`` metric line each native probe
    client prints (hotspot_c/nq_c/tsp_c/trickle_c share the shape).
    Returns one dict per rank with ints where the value parses as int,
    floats otherwise."""
    rows = []
    for _rc, out, _err in results:
        line = next(
            ln for ln in out.splitlines() if ln.startswith(prefix + " ")
        )
        kv = {}
        for field in line.split()[1:]:
            k, v = field.split("=")
            try:
                kv[k] = int(v)
            except ValueError:
                try:
                    kv[k] = float(v)
                except ValueError:
                    kv[k] = v  # non-numeric marker (e.g. fetch=batch)
        rows.append(kv)
    return rows


def probe_makespan(rows):
    """(t_begin, t_end, elapsed) across parsed probe rows, with the
    division-safe elapsed floor applied in one place."""
    t_begin = min(r["t0"] for r in rows)
    t_end = max(r["t1"] for r in rows)
    return t_begin, t_end, max(t_end - t_begin, 1e-9)


def check_fetch_mode(rows, fetch: str, what: str, skip_first: bool = False):
    """Every consuming rank must report the REQUESTED fetch mode — a
    broken env plumbing falling back to single-unit would silently
    mislabel the bench's batch rows.  ``skip_first`` skips a rank-0
    producer/collector row that predates the field."""
    want = "batch" if fetch.startswith("batch") else "single"
    check = rows[1:] if skip_first else rows
    wrong = [r for r in check if r.get("fetch", "single") != want]
    if wrong:
        raise RuntimeError(
            f"{what} fetch mode mismatch: requested {fetch!r}, "
            f"ranks report {wrong[:2]}"
        )


def probe_aggregate(rows, tasks=None, done_key="done", wait_rows=None):
    """The aggregation every native probe harness repeats: total units,
    cross-process makespan, rate, and mean wait fraction.  ``tasks``
    overrides the default sum of ``done_key`` for probes whose unit count
    is assembled from several fields; ``wait_rows`` restricts the wait
    average to the ranks that actually consume (dedicated producers and
    collectors are blocked by design and would add a ~1/nranks floor
    that says nothing about balancing).  Returns
    (tasks, elapsed, tasks_per_sec, wait_pct)."""
    _t0, _t1, elapsed = probe_makespan(rows)
    if tasks is None:
        tasks = sum(r[done_key] for r in rows)
    wrows = rows if wait_rows is None else wait_rows
    wait = sum(r["wait"] / elapsed for r in wrows) / len(wrows)
    return tasks, elapsed, tasks / elapsed, 100.0 * wait


def run_native_world(
    n_clients: int,
    nservers: int,
    types: Sequence[int],
    exe: str,
    cfg=None,
    use_debug_server: bool = False,
    env_extra: Optional[dict] = None,
    timeout: float = 120.0,
):
    """Python servers (threads) + native client processes (one per app rank).

    Returns (results: list of (returncode, stdout, stderr) per client,
    server_stats: dict rank -> stats), as the JAX package's function does.
    A planning sidecar (native servers with ``balancer="tpu"``) runs on a
    thread of this process; its counts are ``SidecarThread.planner()``.
    """
    from adlb_tpu_torch.runtime.debug_server import DebugServer
    from adlb_tpu_torch.runtime.server import Server
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint, local_addr_map
    from adlb_tpu_torch.runtime.world import Config, WorldSpec

    cfg = cfg or Config()
    world = WorldSpec(
        nranks=n_clients + nservers + (1 if use_debug_server else 0),
        nservers=nservers,
        types=tuple(types),
        use_debug_server=use_debug_server,
    )
    all_native = cfg.server_impl == "native"
    addr_map = local_addr_map(world.nranks)
    binary = set(range(n_clients))  # native ranks speak the TLV codec
    abort_event = threading.Event()

    server_stats: dict[int, dict] = {}
    errors: list[BaseException] = []
    threads = []
    endpoints = {}
    daemons: dict[int, subprocess.Popen] = {}

    sidecar_thread = None
    if all_native:
        # all-native world: C clients + C++ server daemons. Daemons bind
        # their own ports, so the rendezvous map is completed from their
        # PORT hellos before any client starts. A failed bootstrap must not
        # leak the daemons already spawned.
        from adlb_tpu_torch.native import daemon as daemon_mod

        sidecar_ep = None
        try:
            for rank in world.server_ranks:
                daemons[rank] = daemon_mod.spawn_daemon(world, cfg, rank)
            for rank, p in daemons.items():
                addr_map[rank] = ("127.0.0.1", daemon_mod.read_hello(p, rank))
            if cfg.balancer == "tpu":
                # balancer sidecar thread at pseudo-rank world.nranks
                from adlb_tpu_torch.balancer.sidecar import start_sidecar

                sidecar_ep, sidecar_thread = start_sidecar(
                    world, cfg, abort_event
                )
                addr_map[world.nranks] = ("127.0.0.1", sidecar_ep.port)
                sidecar_ep.addr_map.update(addr_map)
                endpoints[world.nranks] = sidecar_ep
                sidecar_thread.start()
            if use_debug_server:
                # the watchdog stays Python even in all-native worlds;
                # daemons heartbeat it with binary DS_LOG frames
                dbg_rank = world.debug_server_rank
                endpoints[dbg_rank] = TcpEndpoint(
                    dbg_rank, addr_map, binary_peers=set(world.server_ranks)
                )
                t = threading.Thread(
                    target=lambda: DebugServer(
                        world, cfg, endpoints[dbg_rank], abort_event
                    ).run(),
                    daemon=True,
                )
                threads.append(t)
                t.start()
            for p in daemons.values():
                daemon_mod.send_addrs(p, addr_map)
        except BaseException:
            for p in daemons.values():
                p.kill()
            abort_event.set()
            if sidecar_ep is not None:
                from adlb_tpu_torch.balancer.sidecar import stop_sidecar

                endpoints.pop(world.nranks, None)
                stop_sidecar(sidecar_ep, sidecar_thread, abort_event)
            raise

    with tempfile.NamedTemporaryFile(
        "w", suffix=".adlb", delete=False
    ) as f:
        # world ranks only: the C client derives the world size from the
        # line count, so the balancer sidecar's pseudo-rank (world.nranks,
        # used by servers alone) must not appear here
        for r, (host, port) in sorted(addr_map.items()):
            if r < world.nranks:
                f.write(f"{r} {host} {port}\n")
        rendezvous = f.name

    if not all_native:
        # bind every Python listener BEFORE any rank starts sending: a
        # server's first DS_LOG can otherwise race the debug server's bind
        # and die on connection-refused
        endpoints = {
            rank: TcpEndpoint(rank, addr_map, binary_peers=binary)
            for rank in (
                list(world.server_ranks)
                + ([world.debug_server_rank] if use_debug_server else [])
            )
        }

        def server_main(rank: int) -> None:
            try:
                server = Server(world, cfg, endpoints[rank], abort_event)
                server.run()
                server_stats[rank] = server.finalize_stats()
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                abort_event.set()

        def debug_main(rank: int) -> None:
            DebugServer(world, cfg, endpoints[rank], abort_event).run()

        for rank in world.server_ranks:
            t = threading.Thread(target=server_main, args=(rank,), daemon=True)
            threads.append(t)
            t.start()
        if use_debug_server:
            t = threading.Thread(
                target=debug_main, args=(world.debug_server_rank,), daemon=True
            )
            threads.append(t)
            t.start()

    env = dict(os.environ)
    env["ADLB_RENDEZVOUS"] = rendezvous
    env["ADLB_NUM_SERVERS"] = str(nservers)
    if use_debug_server:
        env["ADLB_USE_DEBUG_SERVER"] = "1"
    env.update(env_extra or {})

    procs = []
    for rank in range(n_clients):
        e = dict(env)
        e["ADLB_RANK"] = str(rank)
        procs.append(
            subprocess.Popen(
                [exe],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )

    import time as _time

    if sidecar_thread is not None:
        def end_on_sidecar_failure() -> None:
            # C clients and daemons cannot see the abort event: a failed
            # planning round ends the world by ending its processes
            while any(p.poll() is None for p in procs):
                if abort_event.wait(timeout=0.2) \
                        and sidecar_thread.error is not None:
                    for p in procs + list(daemons.values()):
                        if p.poll() is None:
                            p.kill()
                    return

        threading.Thread(target=end_on_sidecar_failure, daemon=True).start()

    results = []
    deadline = _time.monotonic() + timeout  # shared wall-clock bound
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - _time.monotonic(), 0.1)
            )
            results.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        abort_event.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                out, err = p.communicate()
                results.append((-9, out, err))
        raise TimeoutError(
            f"native world did not finish within {timeout}s; "
            f"client outputs: {results}"
        )
    finally:
        for t in threads:
            t.join(timeout=15.0)
        if any(t.is_alive() for t in threads):
            abort_event.set()
            for t in threads:
                t.join(timeout=5.0)
        if sidecar_thread is not None:
            sidecar_thread.join(timeout=10.0)  # exits on servers' DS_ENDs
        for ep in endpoints.values():
            ep.close()
        if daemons:
            from adlb_tpu_torch.native import daemon as daemon_mod

            for rank, p in daemons.items():
                stats, abort_code, rc = daemon_mod.collect_stats(p)
                if stats is not None:
                    server_stats[rank] = stats
                elif abort_code is None and rc not in (-9, -15):
                    # crashed daemon (not one we killed on teardown):
                    # attribute it, parity with transport_tcp's
                    # 'exited without STATS'
                    errors.append(
                        RuntimeError(
                            f"native server rank {rank} exited {rc} "
                            f"without STATS"
                        )
                    )
        os.unlink(rendezvous)

    if sidecar_thread is not None:
        from adlb_tpu_torch.balancer.sidecar import raise_if_failed

        raise_if_failed(sidecar_thread)  # the cause, before its collateral
    if errors:
        raise errors[0]
    return results, server_stats
