"""Public API.

Two surfaces:

* :class:`AdlbContext` — the per-rank object handed to application code, with
  methods mirroring the reference's public C API one-for-one
  (``ADLB_Put/Reserve/Ireserve/Get_reserved/...``, reference
  ``include/adlb/adlb.h:42-88``) in Pythonic form.
* :func:`run_world` — spins up a world in-process (ranks as threads, the
  analogue of ``mpiexec -n k`` for the reference's examples) and runs an app
  function on every app rank. Multi-process/multi-host worlds use the TCP
  transport entry points instead (``adlb_tpu_torch.runtime.transport_tcp``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

from adlb_tpu_torch.runtime.client import Client
from adlb_tpu_torch.runtime.debug_server import DebugServer
from adlb_tpu_torch.runtime.server import Server
from adlb_tpu_torch.runtime.transport import InProcFabric
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import ADLB_SUCCESS, AdlbAborted, InfoKey, WorkHandle


class AdlbContext:
    """Per-app-rank handle: the reference's client API surface."""

    def __init__(self, client: Client) -> None:
        self._c = client

    @property
    def rank(self) -> int:
        return self._c.rank

    @property
    def num_app_ranks(self) -> int:
        return self._c.world.num_app_ranks

    @property
    def world(self) -> WorldSpec:
        return self._c.world

    # The reference API, in order of include/adlb/adlb.h:
    def put(
        self,
        payload: bytes,
        work_type: int,
        work_prio: int = 0,
        target_rank: int = -1,
        answer_rank: int = -1,
    ) -> int:
        return self._c.put(payload, work_type, work_prio, target_rank, answer_rank)

    def reserve(self, req_types: Optional[Sequence[int]] = None):
        return self._c.reserve(req_types)

    def ireserve(self, req_types: Optional[Sequence[int]] = None):
        return self._c.ireserve(req_types)

    def get_reserved(self, handle: WorkHandle):
        return self._c.get_reserved(handle)

    def get_work(self, req_types: Optional[Sequence[int]] = None):
        """Fused blocking reserve+get: one round trip when the unit is local
        and prefix-free (no reference analogue)."""
        return self._c.get_work(req_types)

    def get_work_batch(
        self,
        req_types: Optional[Sequence[int]] = None,
        max_units: int = 8,
    ):
        """Fused reserve+get of up to max_units LOCAL prefix-free units in
        one round trip (no reference analogue); returns (rc, [GotWork])."""
        return self._c.get_work_batch(req_types, max_units)

    def get_work_stream(
        self, req_types: Optional[Sequence[int]] = None, depth: int = 2
    ):
        """Pipelined consumer: an iterator of GotWork keeping up to
        ``depth`` fused reserves in flight, so the next unit's delivery
        overlaps the current unit's compute (no reference analogue).
        Ends at NO_MORE_WORK / DONE_BY_EXHAUSTION (code in ``.rc``);
        use as a context manager or call ``.close()`` if abandoning the
        stream early::

            with ctx.get_work_stream([TYPE], depth=4) as stream:
                for work in stream:
                    process(work.payload)
        """
        return self._c.get_work_stream(req_types, depth)

    def get_reserved_timed(self, handle: WorkHandle):
        return self._c.get_reserved_timed(handle)

    def iput(
        self,
        payload: bytes,
        work_type: int,
        work_prio: int = 0,
        target_rank: int = -1,
        answer_rank: int = -1,
    ) -> int:
        """Pipelined put (no reference analogue): streams the request and
        settles accept/reject at flush_puts(). A producer is then bounded by
        bandwidth, not one round trip per unit."""
        return self._c.iput(payload, work_type, work_prio, target_rank,
                            answer_rank)

    def flush_puts(self) -> int:
        return self._c.flush_puts()

    def begin_batch_put(self, common_buf: bytes) -> int:
        return self._c.begin_batch_put(common_buf)

    def end_batch_put(self) -> int:
        return self._c.end_batch_put()

    def extend_lease(self, handle: WorkHandle) -> int:
        """Renew this rank's lease on a reserved-but-unfetched unit
        (**extension**, Config(lease_timeout_s) > 0): long units opt out
        of lease expiry explicitly instead of raising the whole world's
        timeout. Fire-and-forget; an already-expired lease stays expired
        (the fetch answers the retriable fencing code)."""
        return self._c.extend_lease(handle)

    def get_quarantined(self):
        """(rc, records): the dead-letter quarantine — units moved aside
        after exhausting Config(max_unit_retries), as plain dicts with
        payload, metadata, attempt count, and the holding server
        (**extension**; also served by the ops endpoint's /deadletter)."""
        return self._c.get_quarantined()

    def set_problem_done(self) -> int:
        return self._c.set_problem_done()

    # -- job namespaces (service mode; **extension** — the reference
    # binds one world to one job): submit a namespace on the running
    # fleet, bind ranks to it, drain/kill it from any rank or over the
    # ops endpoint's /jobs control plane.

    @property
    def job(self) -> int:
        """The namespace this rank is attached to (0 = default)."""
        return self._c.job

    def detach_world(self) -> int:
        """Cleanly LEAVE a running world (**extension** — elastic
        membership): the master drops this rank from every server's
        membership under a fresh fleet epoch, leases drain, and
        exhaustion/END counting forgets the rank. After a successful
        detach the context is dead (finalize is a no-op; just close).
        Distinct from :meth:`attach`, which binds a JOB namespace."""
        return self._c.detach()

    def attach(self, job_id: int) -> "AdlbContext":
        """Bind this rank to a job namespace; returns self so app code
        reads naturally as ``ctx = ctx.attach(job_id)``. Raises on a
        control-plane refusal."""
        rc = self._c.attach(job_id)
        if rc != ADLB_SUCCESS:
            from adlb_tpu_torch.types import AdlbError

            raise AdlbError(f"attach({job_id}) refused (rc={rc})")
        return self

    def submit_job(self, name: str = "",
                   quota_bytes: int = 0) -> tuple[int, int]:
        """(rc, job_id): create a namespace (per-server byte quota
        enforced at put with ADLB_BACKOFF; 0 = unlimited)."""
        return self._c.submit_job(name, quota_bytes)

    def drain_job(self, job_id: int) -> tuple[int, int]:
        return self._c.drain_job(job_id)

    def kill_job(self, job_id: int) -> tuple[int, int]:
        return self._c.kill_job(job_id)

    def job_status(self, job_id: int):
        """(rc, status dict from the master's job table)."""
        return self._c.job_status(job_id)

    def info_num_work_units(self, work_type: int):
        return self._c.info_num_work_units(work_type)

    def info_get(self, key) -> tuple[int, float]:
        return self._c.info_get(int(key))

    def checkpoint(self, path_prefix: str) -> tuple[int, int]:
        return self._c.checkpoint(path_prefix)

    def abort(self, code: int) -> None:
        self._c.abort(code)

    # app<->app messaging: the reference hands app code a dedicated
    # communicator (app_comm from ADLB_Init, reference src/adlb.c:256,318)
    # for ordinary point-to-point traffic next to ADLB calls (c1.c's
    # TAG_B_ANSWER flow); these are its MPI_Send/Iprobe/Recv equivalents.
    def app_send(self, dest_app_rank: int, payload, apptag: int = 0) -> None:
        self._c.app_send(dest_app_rank, payload, apptag)

    def app_iprobe(self, apptag: Optional[int] = None,
                   src: Optional[int] = None) -> bool:
        return self._c.app_iprobe(apptag, src)

    def app_recv(self, apptag: Optional[int] = None, src: Optional[int] = None,
                 timeout: Optional[float] = None):
        return self._c.app_recv(apptag, src, timeout)


@dataclasses.dataclass
class WorldResult:
    """What run_world returns: per-app-rank results and per-server stats."""

    app_results: dict[int, Any]
    server_stats: dict[int, dict[int, float]]
    aborted: bool
    exception: Optional[BaseException] = None
    # merged Chrome-trace events when Config(trace=True) (the reference's
    # MPE output, reference src/adlb_prof.c:46-74)
    trace_events: list[dict] = dataclasses.field(default_factory=list)
    # the watchdog instance when use_debug_server=True (its aggregates and
    # printed per-interval summary lines are inspectable post-run)
    debug_server: Optional[Any] = None
    # app ranks that died mid-run and were absorbed by
    # Config(on_worker_failure="reclaim") — the world completed around
    # them, so they have no entry in app_results
    casualties: list[int] = dataclasses.field(default_factory=list)
    # server ranks that died mid-run and were absorbed by
    # Config(on_server_failure="failover"): their pool shard replayed at
    # the ring-successor buddy, which also took over their app ranks
    server_casualties: list[int] = dataclasses.field(default_factory=list)
    # units moved to the dead-letter quarantine (retry budget exhausted,
    # Config(max_unit_retries) > 0) — summed over surviving servers'
    # InfoKey.QUARANTINED, same conservation contract as FAILOVER_LOST:
    # every unit is completed, re-executed, or counted here
    quarantined: int = 0
    # every planner's solve counts, greedy-sweep launches and checked
    # solves during the world and its planning rounds, keyed by the rank
    # of the server that planned (Server.planner_report: the master, and
    # a deputy that failover promoted), or by the sidecar's pseudo-rank
    # (nranks) in native worlds. A process world's server checks its kept
    # solves before it reports; an in-process world's are checked after
    # the world, by balancer.solve.planner_counts
    planner: dict[int, dict] = dataclasses.field(default_factory=dict)

    def save_trace(self, path: str) -> None:
        from adlb_tpu_torch.runtime.trace import save_chrome_trace

        save_chrome_trace(self.trace_events, path)

    def info_get(self, key: InfoKey) -> float:
        """Aggregate a stats key over servers the way the reference's
        examples read Info_get per server rank (max over servers)."""
        return max((s.get(int(key), 0.0) for s in self.server_stats.values()),
                   default=0.0)


class JoinedWorld:
    """Context manager for an app rank joined to an externally launched
    world (see :mod:`adlb_tpu_torch.runtime.launch`): finalizes the client and
    closes the endpoint on exit."""

    def __init__(self, ctx: AdlbContext, ep) -> None:
        self.ctx = ctx
        self._ep = ep

    def __enter__(self) -> AdlbContext:
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        # finalize even when the app body raised: without FA_LOCAL_APP_DONE
        # the shutdown ring never completes and the whole world hangs
        try:
            self.ctx._c.finalize()
        except Exception:  # teardown races (home server gone) are benign
            pass
        finally:
            self._ep.close()


def join_world(
    types: Sequence[int],
    nservers: Optional[int] = None,
    cfg: Optional[Config] = None,
    rank: Optional[int] = None,
    rendezvous: Optional[str] = None,
) -> JoinedWorld:
    """Join an externally launched world as an app rank (the Python analogue
    of the C client's ADLB_Init env contract). Reads ``ADLB_RANK`` /
    ``ADLB_RENDEZVOUS`` / ``ADLB_NUM_SERVERS`` (and ``ADLB_SERVER_IMPL``)
    when not given:

        with join_world(types=[1]) as ctx:
            ctx.put(b"...", 1)

    The rendezvous file lists every world rank as ``rank host port`` lines;
    this process binds its own rank's port. An explicit ``nservers`` that
    disagrees with the launcher's exported value would silently misroute
    every message, so a mismatch is rejected.
    """
    import os

    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    env_ns = os.environ.get("ADLB_NUM_SERVERS")
    if nservers is None:
        if env_ns is None:
            raise ValueError("nservers not given and ADLB_NUM_SERVERS not set")
        nservers = int(env_ns)
    elif env_ns is not None and int(env_ns) != nservers:
        raise ValueError(
            f"nservers={nservers} disagrees with the launcher's "
            f"ADLB_NUM_SERVERS={env_ns}"
        )
    attach = rank is None and os.environ.get(
        "ADLB_ATTACH", ""
    ).strip().lower() in ("1", "on", "true", "yes")
    if not attach:
        rank = int(os.environ["ADLB_RANK"]) if rank is None else rank
    path = rendezvous or os.environ["ADLB_RENDEZVOUS"]
    addr_map: dict[int, tuple[str, int]] = {}
    with open(path) as f:
        for line in f:
            r, h, p = line.split()
            addr_map[int(r)] = (h, int(p))
    if cfg is None:
        fault_spec = None
        if os.environ.get("ADLB_FAULT_SPEC"):
            import json

            fault_spec = json.loads(os.environ["ADLB_FAULT_SPEC"])
        cfg = Config(
            server_impl=os.environ.get("ADLB_SERVER_IMPL", "python"),
            on_worker_failure=os.environ.get(
                "ADLB_ON_WORKER_FAILURE", "abort"
            ),
            on_server_failure=os.environ.get(
                "ADLB_ON_SERVER_FAILURE", "abort"
            ),
            lease_timeout_s=float(
                os.environ.get("ADLB_LEASE_TIMEOUT_S", "0") or 0
            ),
            fault_spec=fault_spec,
        )
    world = WorldSpec(
        nranks=len(addr_map), nservers=nservers, types=tuple(types)
    )
    binary_peers = (
        set(world.server_ranks) if cfg.server_impl == "native" else None
    )
    from adlb_tpu_torch.runtime.codec import select_codec

    select_codec(cfg.codec)
    if attach:
        # elastic membership (ADLB_ATTACH=1, launch.py --attach): this
        # process is a NEW rank joining the running world — negotiate a
        # rank id + home server from the master instead of reading
        # ADLB_RANK. Attached ranks ride per-pair TCP (the launcher's
        # brokers route only the static world).
        return attach_world(
            world, cfg,
            master_addr=addr_map[world.master_server_rank],
        )
    mux_addr = None
    broker_env = os.environ.get("ADLB_BROKER_ADDR", "").strip()
    if cfg.tcp_mux != "off" and broker_env:
        # the launcher published this host's channel broker: one
        # data-plane socket to it instead of one per peer
        h, _, p = broker_env.rpartition(":")
        mux_addr = (h, int(p))
    elif cfg.tcp_mux == "on":
        # no silent fallback for an explicit ask (the codec="c" rule)
        raise ValueError(
            "tcp_mux='on' requires a broker-running harness "
            "(spawn_world, or the launcher's broker publication via "
            "ADLB_BROKER_ADDR — is the launcher running with the mux "
            "enabled?)"
        )
    mux_ranks = int(os.environ.get("ADLB_MUX_RANKS", "0") or 0) \
        or world.nranks
    ep = TcpEndpoint(rank, addr_map, binary_peers=binary_peers,
                     mux=mux_addr, mux_ranks=mux_ranks,
                     compress_min=cfg.compress_min_bytes)
    # shm ring fabric toward same-host ranks (the launcher exports
    # ADLB_FABRIC/ADLB_SHM_KEY; a bare join derives the key from the
    # rendezvous directory, so all parties of one world agree)
    from adlb_tpu_torch.runtime.transport_shm import (
        key_for_rendezvous,
        maybe_shm,
        resolve_fabric,
    )

    if resolve_fabric(cfg) == "shm":
        shm_key = os.environ.get("ADLB_SHM_KEY") or key_for_rendezvous(
            os.path.dirname(os.path.abspath(path))
        )
        ep = maybe_shm(ep, cfg, shm_key)
    if cfg.fault_spec:
        from adlb_tpu_torch.runtime.faults import maybe_wrap

        ep = maybe_wrap(ep, cfg, world)
    return JoinedWorld(AdlbContext(Client(world, cfg, ep)), ep)


def attach_world(
    world,
    cfg: Optional[Config] = None,
    *,
    fabric=None,
    master_addr=None,
    abort_event=None,
) -> JoinedWorld:
    """Attach a NEW app rank to a RUNNING world (**extension** — elastic
    membership; the reference fixes the world at ADLB_Init). The master
    allocates a rank id + home server under a fresh fleet epoch; the
    returned JoinedWorld finalizes on exit, or call
    ``ctx.detach_world()`` to leave mid-run::

        with attach_world(world, cfg, fabric=fabric) as ctx:
            ctx.put(b"...", 1)

    Exactly one of ``fabric`` (in-proc worlds) or ``master_addr`` (TCP:
    the master server's (host, port)) selects the transport. Python
    servers only."""
    from adlb_tpu_torch.runtime.membership import attach_app

    return attach_app(world, cfg or Config(), fabric=fabric,
                      master_addr=master_addr, abort_event=abort_event)


def run_world(
    num_app_ranks: int,
    nservers: int,
    types: Sequence[int],
    app_fn: Callable[[AdlbContext], Any],
    cfg: Optional[Config] = None,
    use_debug_server: bool = False,
    timeout: float = 120.0,
) -> WorldResult:
    """Run a complete world in one process, one thread per rank."""
    cfg = cfg or Config()
    world = WorldSpec(
        nranks=num_app_ranks + nservers + (1 if use_debug_server else 0),
        nservers=nservers,
        types=tuple(types),
        use_debug_server=use_debug_server,
    )
    fabric = InProcFabric(world.nranks)
    app_results: dict[int, Any] = {}
    server_stats: dict[int, dict[int, float]] = {}
    trace_events: list[dict] = []
    errors: list[BaseException] = []
    casualties: list[int] = []
    server_casualties: list[int] = []
    planner: dict[int, dict] = {}
    lock = threading.Lock()

    from adlb_tpu_torch.runtime.faults import maybe_wrap
    from adlb_tpu_torch.types import HomeServerLostError

    def app_main(rank: int) -> None:
        client = Client(world, cfg,
                        maybe_wrap(fabric.endpoint(rank), cfg, world),
                        fabric.abort_event)
        ctx = AdlbContext(client)
        try:
            result = app_fn(ctx)
            with lock:
                app_results[rank] = result
        except AdlbAborted:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced via WorldResult
            if cfg.on_worker_failure == "reclaim" and isinstance(
                e, HomeServerLostError
            ):
                # a fault-injected disconnect (or real connectivity loss —
                # the client raises HomeServerLostError for ANY peer that
                # stays unreachable) is a CASUALTY under the reclaim
                # policy: the world keeps running without this rank.
                # Application errors (including the app's own OSErrors)
                # still surface as world failures.
                with lock:
                    casualties.append(rank)
            else:
                with lock:
                    errors.append(e)
                fabric.abort_event.set()
        finally:
            try:
                client.finalize()
            except Exception:  # dead endpoint at teardown: benign
                pass
            if client.tracer is not None:
                with lock:
                    trace_events.extend(client.tracer.events)

    def server_main(rank: int) -> None:
        server = Server(world, cfg,
                        maybe_wrap(fabric.endpoint(rank), cfg, world),
                        fabric.abort_event)
        try:
            server.run()
            with lock:
                report = server.planner_report()
                if report is not None:
                    planner[rank] = report
                if server.died:
                    # fault-injected server death absorbed by
                    # on_server_failure="failover": the buddy took over;
                    # this thread exits as the casualty, not an error
                    server_casualties.append(rank)
                else:
                    server_stats[rank] = server.finalize_stats()
        except BaseException as e:  # noqa: BLE001
            with lock:
                errors.append(e)
            fabric.abort_event.set()
        finally:
            if server.tracer is not None:
                # server handler/balancer spans join the same merged
                # Chrome-trace stream as client API calls (pid = role)
                with lock:
                    trace_events.extend(server.tracer.events)

    debug_servers: list[DebugServer] = []

    def debug_main(rank: int) -> None:
        ds = DebugServer(world, cfg, fabric.endpoint(rank), fabric.abort_event)
        debug_servers.append(ds)
        ds.run()

    threads: list[threading.Thread] = []
    # servers (and the debug server) start BEFORE app ranks: app threads
    # begin with protocol round trips, and every server thread still
    # being spawned is pure startup latency charged to the apps'
    # makespans (messages would queue correctly either way — this is a
    # latency ordering, not a correctness one)
    ordered = [r for r in range(world.nranks) if not world.is_app(r)] + [
        r for r in range(world.nranks) if world.is_app(r)
    ]
    for rank in ordered:
        if world.is_app(rank):
            target = app_main
        elif world.is_server(rank):
            target = server_main
        else:
            target = debug_main
        t = threading.Thread(target=target, args=(rank,), daemon=True,
                             name=f"adlb-rank-{rank}")
        threads.append(t)
        t.start()

    import time as _time

    deadline = _time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(deadline - _time.monotonic(), 0.0))
        if t.is_alive():
            fabric.abort_event.set()
            for t2 in threads:
                t2.join(timeout=5.0)
            errors.append(TimeoutError(f"world did not finish within {timeout}s"))
            break

    with lock:  # a timed-out client thread may still be appending
        trace_events = sorted(trace_events, key=lambda e: e["ts"])
    result = WorldResult(
        app_results=app_results,
        server_stats=server_stats,
        aborted=fabric.abort_event.is_set(),
        exception=errors[0] if errors else None,
        trace_events=trace_events,
        debug_server=debug_servers[0] if debug_servers else None,
        casualties=sorted(casualties),
        server_casualties=sorted(server_casualties),
        quarantined=int(sum(
            s.get(int(InfoKey.QUARANTINED), 0)
            for s in server_stats.values()
        )),
        planner=planner,
    )
    if errors:
        raise errors[0]
    return result
