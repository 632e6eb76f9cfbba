"""Multi-host world launcher — the ``mpiexec -n k`` replacement.

The reference's deployment story is MPI's launcher (reference
``examples/README-batcher.txt:57``: ``mpiexec -n <k>``); this framework's
worlds span hosts over TCP, so the launcher's job is the rendezvous. Run
one launcher per host with that host's rank range:

    host A:  python -m adlb_tpu_torch.runtime.launch --rendezvous /shared/w1 \
                 --nranks 8 --nservers 2 --types 1,2 --ranks 0-3 -- prog...
    host B:  python -m adlb_tpu_torch.runtime.launch --rendezvous /shared/w1 \
                 --nranks 8 --nservers 2 --types 1,2 --ranks 4-7 -- prog...

Per rank, the launcher publishes ``<dir>/<rank>.addr`` on the shared
rendezvous directory and waits for all ``nranks`` files. Server ranks bind
first and publish their real ports (Python reactors in-launcher, native
daemons as subprocesses); app-rank ports are pre-allocated, and the app
program is exec'd with ``ADLB_RENDEZVOUS``/``ADLB_RANK``/
``ADLB_NUM_SERVERS`` set — the C client's env contract, and the one
:func:`adlb_tpu_torch.api.join_world` reads for Python apps.

With ``--server-impl native --balancer tpu`` the planning sidecar runs on the
master server's host, bound to that host's ``--host`` address so servers
anywhere can stream snapshots to it.

**Channel plane (multiplexed host-pair sockets).** Each launcher runs
one :class:`~adlb_tpu_torch.runtime.channel.ChannelBroker` for its ranks and
publishes ``broker.<host>.<pid>.addr`` (address + the rank list it
serves) in the rendezvous directory; after the rendezvous every broker
learns the full rank->broker routing, so the fleet's python<->python
data plane is O(ranks + hosts^2) sockets instead of O(ranks^2).
``tcp_mux="auto"`` turns the plane ON exactly where that explosion
lives — when this launcher owns a strict subset of the world (a real
multi-launcher fleet) — and stays per-pair for single-launcher worlds
(``ADLB_TCP_MUX=1`` still forces it, the CI hook). App programs inherit
the local broker through ``ADLB_BROKER_ADDR``/``ADLB_MUX_RANKS``.

**Elastic membership** (``adlb_tpu_torch/runtime/membership.py``): a running
world grows without restart. ``--attach N`` execs N copies of the app
program against an ALREADY-RUNNING world's rendezvous directory — each
sets ``ADLB_ATTACH=1`` so :func:`adlb_tpu_torch.api.join_world` negotiates a
fresh rank id + home server from the master instead of reading
``ADLB_RANK``. Attached ranks ride per-pair TCP (brokers route the
static world; the ``mux_ranks`` bound keeps joiners off them).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time


def _parse_ranks(spec: str) -> list[int]:
    out: list[int] = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return sorted(set(out))


def _publish(dirpath: str, rank: int, host: str, port: int) -> None:
    os.makedirs(dirpath, exist_ok=True)
    tmp = os.path.join(dirpath, f".{rank}.addr.tmp")
    with open(tmp, "w") as f:
        f.write(f"{host} {port}\n")
    os.replace(tmp, os.path.join(dirpath, f"{rank}.addr"))


def _await_all(dirpath: str, nranks: int, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    addr_map: dict[int, tuple[str, int]] = {}
    while len(addr_map) < nranks:
        if time.monotonic() > deadline:
            missing = sorted(set(range(nranks)) - set(addr_map))
            raise TimeoutError(
                f"rendezvous incomplete after {timeout}s: waiting for ranks "
                f"{missing[:10]}{'...' if len(missing) > 10 else ''}"
            )
        for r in range(nranks):
            if r in addr_map:
                continue
            try:
                with open(os.path.join(dirpath, f"{r}.addr")) as f:
                    h, p = f.read().split()
                addr_map[r] = (h, int(p))
            except (OSError, ValueError):
                continue
        if len(addr_map) < nranks:
            time.sleep(0.05)
    return addr_map


def _publish_broker(dirpath: str, addr: tuple, ranks) -> None:
    """Publish this launcher's channel broker: address + the world ranks
    it serves (named per launcher, so same-host launchers coexist)."""
    os.makedirs(dirpath, exist_ok=True)
    name = f"broker.{addr[0]}.{os.getpid()}.addr"
    tmp = os.path.join(dirpath, f".{name}.tmp")
    with open(tmp, "w") as f:
        f.write(f"{addr[0]} {addr[1]}\n")
        f.write(",".join(str(r) for r in sorted(ranks)) + "\n")
    os.replace(tmp, os.path.join(dirpath, name))


def _await_brokers(dirpath: str, nranks: int,
                   timeout: float) -> tuple[dict, dict]:
    """Wait until every world rank is covered by some launcher's broker
    publication; returns (rank -> hostkey, hostkey -> broker addr) for
    :meth:`ChannelBroker.set_routes`. Mixed-config fleets (one launcher
    muxed, another not) time out loudly here instead of wedging later."""
    deadline = time.monotonic() + timeout
    while True:
        rank_host: dict[int, str] = {}
        broker_addrs: dict[str, tuple[str, int]] = {}
        try:
            names = os.listdir(dirpath)
        except OSError:
            names = []
        for fn in names:
            if not (fn.startswith("broker.") and fn.endswith(".addr")):
                continue
            try:
                with open(os.path.join(dirpath, fn)) as f:
                    addr_line, ranks_line = f.read().split("\n")[:2]
                h, p = addr_line.split()
                hostkey = f"{h}:{int(p)}"
                broker_addrs[hostkey] = (h, int(p))
                for r in ranks_line.split(","):
                    if r:
                        rank_host[int(r)] = hostkey
            except (OSError, ValueError):
                continue
        if set(range(nranks)) <= set(rank_host):
            return rank_host, broker_addrs
        if time.monotonic() > deadline:
            missing = sorted(set(range(nranks)) - set(rank_host))
            raise TimeoutError(
                f"broker rendezvous incomplete after {timeout}s: no "
                f"broker covers ranks {missing[:10]} — is every "
                f"launcher running with the same tcp_mux setting?"
            )
        time.sleep(0.05)


def _attach_main(args) -> int:
    """``--attach N``: exec N copies of the app program against an
    ALREADY-RUNNING world (elastic membership). Each process negotiates
    a fresh rank id + home server from the master via join_world's
    ``ADLB_ATTACH`` contract — no restart, no rank-range bookkeeping."""
    merged = os.path.join(args.rendezvous, "world.addr")
    deadline = time.monotonic() + args.timeout
    while not os.path.exists(merged):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"--attach: no running world at {merged} (the launcher "
                f"writes it after its rendezvous completes)"
            )
        time.sleep(0.1)
    if not args.prog:
        print("[adlb_launch] --attach needs an app program",
              file=sys.stderr)
        return 2
    procs = []
    for _ in range(args.attach):
        env = dict(os.environ)
        env["ADLB_RENDEZVOUS"] = merged
        env["ADLB_ATTACH"] = "1"
        env["ADLB_NUM_SERVERS"] = str(args.nservers)
        env.pop("ADLB_RANK", None)  # attached ranks are ALLOCATED
        if args.flight_dir:
            env["ADLB_FLIGHT_DIR"] = args.flight_dir
        procs.append(subprocess.Popen(args.prog, env=env))
    rc_final = 0
    for p in procs:
        try:
            p.wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc_final = rc_final or 1
        rc_final = rc_final or (p.returncode or 0)
    return rc_final


def _check_port_clash(addr_map: dict) -> None:
    """Fail fast if two ranks published the same (host, port).

    Concurrent same-host launchers probe with closed sockets and then sit
    in the rendezvous for up to --timeout, so overlapping probe subranges
    can (rarely) hand two ranks one port; the second bind would die
    mid-world and the failure-detection abort would take everything with
    it, minutes later and with a misleading message. Every launcher sees
    the full map here, so they all fail loudly and immediately instead —
    a relaunch redraws the PID-staggered ranges."""
    owners: dict[tuple, list] = {}
    for r, a in sorted(addr_map.items()):
        owners.setdefault(tuple(a), []).append(r)
    clash = {a: rs for a, rs in owners.items() if len(rs) > 1}
    if clash:
        raise RuntimeError(
            f"rendezvous published duplicate addresses {clash}; "
            f"relaunch the world"
        )


def write_rendezvous_file(path: str, addr_map: dict) -> None:
    """The single-file format the C client reads (rank host port lines)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        for r, (h, p) in sorted(addr_map.items()):
            f.write(f"{r} {h} {p}\n")
    os.replace(tmp, path)


def planner_reports(sidecar, servers) -> list:
    """What each planner of a launcher did, for the operator: the
    sidecar's counts, and those of each Python server that planned (the
    master, or a deputy that failover promoted, in a launcher that may
    never have hosted the master), their kept solves checked first."""
    reports = [] if sidecar is None else [sidecar[1].planner()]
    if any(srv._solver is not None for srv in servers):
        from adlb_tpu_torch.balancer.solve import check_kept

        check_kept()
    return reports + [r for r in (srv.planner_report() for srv in servers)
                      if r is not None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch this host's share of an adlb-tpu world."
    )
    ap.add_argument("--rendezvous", required=True,
                    help="shared directory for the world's rendezvous")
    ap.add_argument("--nranks", type=int, default=None)
    ap.add_argument("--nservers", type=int, required=True)
    ap.add_argument("--types", required=True,
                    help="comma-separated work types, e.g. 1,2,3")
    ap.add_argument("--ranks", default=None,
                    help="this host's world ranks, e.g. 0-3 or 0,2,5")
    ap.add_argument("--attach", type=int, default=0, metavar="N",
                    help="elastic membership: attach N NEW app ranks to "
                         "an ALREADY-RUNNING world on this rendezvous "
                         "directory and exec the program once per rank "
                         "(ADLB_ATTACH=1 — join_world negotiates rank "
                         "ids + home servers from the master; no "
                         "restart). --nranks/--ranks are not used; "
                         "python servers only")
    ap.add_argument("--host", default="127.0.0.1",
                    help="address other hosts reach this one at")
    ap.add_argument("--server-impl", default="python",
                    choices=["python", "native"])
    ap.add_argument("--balancer", default="steal", choices=["steal", "tpu"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the planned balancer (--balancer tpu) "
                         "solves: the master server's planner or the "
                         "sidecar, on this launcher's host")
    ap.add_argument("--solver-host-threshold", type=int, default=64,
                    help="parked requesters at or below which a planning "
                         "round solves on the host (numpy) instead of on "
                         "--device; 0 sends every solve to the device")
    ap.add_argument("--fabric", default="auto",
                    choices=["auto", "shm", "tcp"],
                    help="process-world transport: 'auto' upgrades "
                         "same-host rank pairs to the shared-memory ring "
                         "fabric when the host can run it (cross-host "
                         "pairs stay TCP); 'tcp' disables the upgrade "
                         "(exported to app programs as ADLB_FABRIC / "
                         "ADLB_SHM_KEY)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--flight-dir", default=None,
                    help="directory for per-rank flight-record JSON "
                         "artifacts on abort/timeout (exported to app "
                         "programs as ADLB_FLIGHT_DIR)")
    ap.add_argument("--ops-port", type=int, default=None,
                    help="serve /metrics, /healthz, /dump on "
                         "127.0.0.1:<port> of the master server's host "
                         "(0 = ephemeral)")
    ap.add_argument("--on-worker-failure", default="abort",
                    choices=["abort", "reclaim"],
                    help="worker (app rank) death policy: 'abort' kills "
                         "the world (reference semantics); 'reclaim' "
                         "re-enqueues the dead rank's leased work and the "
                         "world keeps running")
    ap.add_argument("--on-server-failure", default="abort",
                    choices=["abort", "failover"],
                    help="server death policy: 'abort' kills the world "
                         "(reference semantics); 'failover' replays the "
                         "dead server's replicated pool shard at its "
                         "ring-successor buddy, which takes over its app "
                         "ranks (python servers only)")
    ap.add_argument("--lease-timeout-s", type=float, default=0.0,
                    help="gray-failure detection: expire (and fence) a "
                         "lease whose owner has been silent this long, "
                         "re-enqueueing its unit; 0 = off (python servers "
                         "only; exported to app programs as "
                         "ADLB_LEASE_TIMEOUT_S so clients heartbeat)")
    ap.add_argument("--max-unit-retries", type=int, default=0,
                    help="retry budget per unit: more failed deliveries "
                         "than this moves the unit to the dead-letter "
                         "quarantine instead of the queue; 0 = unlimited "
                         "(python servers only)")
    ap.add_argument("--mem-hard-frac", type=float, default=0.0,
                    help="overload backpressure: above this fraction of "
                         "max-malloc-per-server with no peer believed to "
                         "have room, puts answer ADLB_BACKOFF with a "
                         "retry-after hint; 0 = off (python servers only)")
    ap.add_argument("--mem-soft-frac", type=float, default=0.95,
                    help="memory-pressure push threshold as a fraction of "
                         "max-malloc-per-server (the reference's 0.95); "
                         "lower it together with --mem-hard-frac to leave "
                         "pushes headroom before backpressure bites "
                         "(validation requires hard >= soft when armed)")
    ap.add_argument("--wal-dir", default=None,
                    help="durable service mode: per-server write-ahead "
                         "log directory — pool mutations are teed to "
                         "<dir>/server.<rank>.log with group-commit "
                         "fsync, and a restarted launcher on the same "
                         "directory replays the pool (python servers "
                         "only; see USERGUIDE §10 for the restart "
                         "runbook)")
    ap.add_argument("--wal-fsync-ms", type=float, default=5.0,
                    help="WAL group-commit window: put acks are held "
                         "for the fsync that makes them durable; 0 = "
                         "fsync every flush (strictest)")
    ap.add_argument("--fault-spec", default=None,
                    help="JSON fault-injection spec "
                         "(adlb_tpu_torch/runtime/faults.py), e.g. "
                         '\'{"seed": 7, "delay": 0.01}\'; applied to the '
                         "server endpoints this launcher runs and exported "
                         "to app programs as ADLB_FAULT_SPEC")
    ap.add_argument("prog", nargs="*",
                    help="app program (exec'd per app rank with "
                         "ADLB_RENDEZVOUS/ADLB_RANK set)")
    args = ap.parse_args(argv)

    if args.attach:
        return _attach_main(args)
    if args.nranks is None or args.ranks is None:
        ap.error("--nranks and --ranks are required (unless --attach)")

    from adlb_tpu_torch.runtime.world import Config, WorldSpec

    types = [int(t) for t in args.types.split(",")]
    world = WorldSpec(nranks=args.nranks, nservers=args.nservers,
                      types=tuple(types))
    fault_spec = None
    if args.fault_spec:
        import json

        fault_spec = json.loads(args.fault_spec)
    cfg = Config(balancer=args.balancer, server_impl=args.server_impl,
                 device=args.device,
                 solver_host_threshold=args.solver_host_threshold,
                 fabric=args.fabric,
                 flight_dir=args.flight_dir, ops_port=args.ops_port,
                 on_worker_failure=args.on_worker_failure,
                 on_server_failure=args.on_server_failure,
                 lease_timeout_s=args.lease_timeout_s,
                 max_unit_retries=args.max_unit_retries,
                 mem_hard_frac=args.mem_hard_frac,
                 mem_soft_frac=args.mem_soft_frac,
                 wal_dir=args.wal_dir,
                 wal_fsync_ms=args.wal_fsync_ms,
                 fault_spec=fault_spec)
    # per-process wire-codec selection (ADLB_CODEC env is the exec'd
    # app ranks' hook; in-launcher server reactors select here)
    from adlb_tpu_torch.runtime.codec import select_codec

    select_codec(cfg.codec)
    my_ranks = _parse_ranks(args.ranks)
    host = args.host
    rdv = args.rendezvous
    # channel plane: one broker per launcher, published through the
    # rendezvous dir. "auto" turns ON exactly where the per-pair socket
    # explosion lives — a launcher owning a strict subset of the world
    # is a multi-launcher fleet — and stays per-pair for single-launcher
    # worlds (ADLB_TCP_MUX=1 still forces it, the CI hook)
    from adlb_tpu_torch.runtime.channel import ChannelBroker, resolve_tcp_mux

    mux_on = cfg.tcp_mux == "on" or (
        cfg.tcp_mux == "auto"
        and (len(my_ranks) < args.nranks or resolve_tcp_mux(cfg))
    )
    broker = ChannelBroker(host=host) if mux_on else None
    if broker is not None:
        _publish_broker(rdv, broker.addr, my_ranks)
    # fabric negotiation: every launcher (and joined client) of this
    # world derives the SAME shm namespace from the rendezvous
    # directory, so same-host pairs find each other's rings while
    # cross-host pairs silently stay on TCP
    from adlb_tpu_torch.runtime.transport_shm import (
        cleanup_world,
        key_for_rendezvous,
        resolve_fabric,
    )

    shm_key = (
        key_for_rendezvous(rdv) if resolve_fabric(cfg) == "shm" else None
    )
    failures: list[str] = []
    threads: list[threading.Thread] = []
    servers: list = []  # this launcher's Python servers
    server_eps = {}   # rank -> TcpEndpoint (python impl)
    daemons = {}      # rank -> Popen (native impl)

    # 1. servers bind first and publish REAL ports
    sidecar = None
    for rank in my_ranks:
        if not world.is_server(rank):
            continue
        if args.server_impl == "native":
            from adlb_tpu_torch.native import daemon

            proc = daemon.spawn_daemon(world, cfg, rank)
            daemons[rank] = proc
            _publish(rdv, rank, host, daemon.read_hello(proc, rank))
        else:
            from adlb_tpu_torch.runtime.faults import maybe_wrap
            from adlb_tpu_torch.runtime.transport_shm import maybe_shm
            from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

            # shm wrapper inside, fault shim outside (faults must apply
            # to ring traffic exactly as to TCP traffic); the mux bound
            # keeps dynamically attached ranks on per-pair sockets
            ep = maybe_wrap(
                maybe_shm(
                    TcpEndpoint(
                        rank, {rank: (host, 0)},
                        mux=broker.addr if broker is not None else None,
                        mux_ranks=world.nranks,
                        compress_min=cfg.compress_min_bytes,
                    ),
                    cfg, shm_key),
                cfg, world)
            server_eps[rank] = ep
            _publish(rdv, rank, host, ep.port)
    if (args.server_impl == "native" and args.balancer == "tpu"
            and world.master_server_rank in my_ranks):
        from adlb_tpu_torch.balancer.sidecar import start_sidecar

        sidecar = start_sidecar(world, cfg, None, host=host)
        _publish(rdv, world.nranks, host, sidecar[0].port)

    # 2. app ranks publish pre-allocated ports — from the staggered
    # below-ephemeral range (probe_free_ports), NOT per-rank bind(0):
    # an ephemeral-range port released here can be re-issued by the
    # kernel as some outbound connection's source port before the app
    # process rebinds it, which killed the rank on bind (the same flake
    # the single-host harness fixed for 100-rank spawn storms)
    from adlb_tpu_torch.runtime.transport_tcp import probe_free_ports

    app_ranks = [r for r in my_ranks if world.is_app(r)]
    for rank, port in zip(app_ranks, probe_free_ports(len(app_ranks), host)):
        _publish(rdv, rank, host, port)

    # 3. global rendezvous
    # with native servers and the planned balancer every launcher also
    # waits for the sidecar's pseudo-rank (world.nranks): a daemon started
    # without its address would never stream snapshots to the planner
    planned = args.server_impl == "native" and args.balancer == "tpu"
    addr_map = _await_all(rdv, world.nranks + planned, args.timeout)
    _check_port_clash(addr_map)
    merged = os.path.join(rdv, "world.addr")
    write_rendezvous_file(
        merged, {r: a for r, a in addr_map.items() if r < world.nranks}
    )
    if broker is not None:
        # every launcher published a broker: teach ours the fleet's
        # rank -> broker routing so cross-host envelopes bridge
        rank_host, broker_addrs = _await_brokers(
            rdv, world.nranks, args.timeout
        )
        broker.set_routes(rank_host, broker_addrs)

    # 4. run servers
    if sidecar is not None:
        sidecar[0].addr_map.update(addr_map)
        sidecar[1].start()
    for rank, proc in daemons.items():
        from adlb_tpu_torch.native import daemon

        daemon.send_addrs(proc, addr_map)

        def wait_daemon(rank=rank, proc=proc):
            from adlb_tpu_torch.native import daemon as dm

            stats, abort_code, rc = dm.collect_stats(proc, timeout=10**9)
            if stats is None and abort_code is None:
                failures.append(f"native server rank {rank} exited {rc}")

        t = threading.Thread(target=wait_daemon, daemon=True)
        threads.append(t)
        t.start()
    for rank, ep in server_eps.items():
        ep.addr_map.update(addr_map)

        def run_server(rank=rank, ep=ep):
            from adlb_tpu_torch.runtime.server import Server

            try:
                server = Server(world, cfg, ep)
                servers.append(server)
                server.run()
            except Exception as e:  # noqa: BLE001
                failures.append(f"server rank {rank}: {e!r}")
            finally:
                ep.close()

        t = threading.Thread(target=run_server, daemon=True)
        threads.append(t)
        t.start()

    # 5. exec app programs
    procs: list[subprocess.Popen] = []
    for rank in my_ranks:
        if world.is_app(rank):
            if not args.prog:
                failures.append(f"app rank {rank}: no program given")
                continue
            env = dict(os.environ)
            env["ADLB_RENDEZVOUS"] = merged
            env["ADLB_RANK"] = str(rank)
            env["ADLB_NUM_SERVERS"] = str(world.nservers)
            if args.flight_dir:
                # app programs (Python join_world or C clients' Python
                # wrappers) opt into flight artifacts via the env contract
                env["ADLB_FLIGHT_DIR"] = args.flight_dir
            if args.fault_spec:
                env["ADLB_FAULT_SPEC"] = args.fault_spec
            if shm_key:
                # joined clients upgrade their same-host pairs too
                env["ADLB_FABRIC"] = "shm"
                env["ADLB_SHM_KEY"] = shm_key
            elif args.fabric == "tcp":
                env["ADLB_FABRIC"] = "tcp"
            if broker is not None:
                # joined clients attach to this host's broker (one
                # data-plane socket each); the bound keeps them off it
                # for dynamically attached ranks
                env["ADLB_BROKER_ADDR"] = (
                    f"{broker.addr[0]}:{broker.addr[1]}"
                )
                env["ADLB_MUX_RANKS"] = str(world.nranks)
            if args.on_worker_failure != "abort":
                env["ADLB_ON_WORKER_FAILURE"] = args.on_worker_failure
            if args.on_server_failure != "abort":
                env["ADLB_ON_SERVER_FAILURE"] = args.on_server_failure
            if args.lease_timeout_s > 0:
                # joined clients arm the liveness heartbeat from this
                env["ADLB_LEASE_TIMEOUT_S"] = str(args.lease_timeout_s)
            if args.server_impl == "native":
                env["ADLB_SERVER_IMPL"] = "native"
            procs.append(subprocess.Popen(args.prog, env=env))

    # apps must not outlive a failed server: without this, a dead server
    # leaves every app blocked in reserve and the launcher waiting forever
    rc_final = 0

    def planning_failed() -> bool:
        # the sidecar has no abort event here: its error is read instead
        return sidecar is not None and sidecar[1].error is not None

    # once the apps are done (or where this launcher runs none), the
    # servers are watched the same way, up to the timeout
    servers_deadline = None
    while True:
        if failures or planning_failed():
            for p in procs + list(daemons.values()):
                if p.poll() is None:
                    p.terminate()
            break
        if not any(p.poll() is None for p in procs):
            if servers_deadline is None:
                servers_deadline = time.monotonic() + args.timeout
            if not any(t.is_alive() for t in threads) \
                    or time.monotonic() > servers_deadline:
                break
        time.sleep(0.2)
    for p in procs:
        try:
            p.wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            failures.append("app process killed after timeout")
        if p.returncode:
            rc_final = p.returncode
    for t in threads:
        t.join(timeout=args.timeout)
        if t.is_alive():
            failures.append("a server did not terminate (hung shutdown?)")
    if sidecar is not None:
        from adlb_tpu_torch.balancer.sidecar import stop_sidecar

        stop_sidecar(*sidecar)
        if sidecar[1].error is not None:
            failures.append(f"balancer sidecar failed: {sidecar[1].error!r}")
    if broker is not None:
        broker.close()
    # best-effort sweep of this world's ring segments/FIFOs: ranks that
    # died without unlinking (SIGKILL chaos) would otherwise leak them.
    # Exactly ONE party sweeps — the launcher hosting the master server —
    # so a same-host sibling launcher still finalizing its ranks never
    # has live rings unlinked from under it (others' strays are replaced
    # at create time by the next incarnation anyway).
    if world.master_server_rank in my_ranks:
        cleanup_world(shm_key)
    for counts in planner_reports(sidecar, servers):
        import json

        print(f"[adlb_launch] planner {json.dumps(counts)}", file=sys.stderr)
    for f in failures:
        print(f"[adlb_launch] {f}", file=sys.stderr)
    return rc_final if not failures else (rc_final or 1)


if __name__ == "__main__":
    sys.exit(main())
