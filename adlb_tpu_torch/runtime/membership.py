"""Elastic membership: ranks and servers that join and leave a running
world.

The reference fixes every process role at ``ADLB_Init`` (PAPER.md
§"Process roles … fixed at ADLB_Init") — a world can only shrink by
dying. This module makes membership dynamic end to end, composing the
mechanisms earlier PRs built:

* **App ranks attach and detach** against a running fleet. Attach
  generalizes resurrection-without-a-prior-death: the MASTER allocates a
  fresh rank id and a home server under a new fleet epoch, fans the
  membership change to every server (``SS_MEMBER``), and only answers
  the joiner once every live server has acked — so by the time the new
  rank's first protocol frame lands anywhere, the whole fleet already
  counts it. Detach is a clean lease-draining rank-dead: the same
  fan-out/ack barrier removes the rank from exhaustion/END counting and
  ``/healthz`` staleness without the loss accounting a real death pays.
* **Servers scale OUT and IN.** Scale-out spawns a new shard (via a
  harness-registered spawner, the ops plane's ``POST /fleet/scale``, or
  automatically under the memory watermarks before spill or
  backpressure engage), attaches it through the same allocation dance,
  and bootstraps it from a DONOR: the master picks the most-loaded live
  server and directs it to rebalance — the donor ships a slice of its
  unpinned untargeted backlog through the acked migration plane (the
  same serialized-unit wire format the WAL/checkpoint shard family
  uses), so every put acked before the scale-out stays fetchable after
  it and a destination death mid-ship hands the units back. Scale-in
  drains a server through the failover promote path WITHOUT counting
  losses: the draining server force-bootstraps a full-state replication
  stream to its ring buddy, flushes it, announces ``drain_done``, and
  exits; the buddy promotes a complete mirror (``failover_lost`` 0 by
  construction) and clients remap via the epoch-stamped
  ``TA_HOME_TAKEOVER`` plane of server failover.
* **Exhaustion/END counting is epoch-based.** Every membership change
  (attach, detach, server join, drain, failover death) bumps one fleet
  epoch; exhaustion and END ring tokens are stamped with it and a token
  crossing an epoch boundary is voided, so a rank joining mid-ring can
  never race a termination verdict. Attach is refused outright once
  termination is underway.

The wire surface is three epoch-stamped tags (``FA_MEMBER`` /
``TA_MEMBER_RESP`` / ``SS_MEMBER``, appended to the codec registry) plus
the ``/fleet`` ops routes; python servers only — native daemons keep the
reference's fixed-world model and an attach toward them is refused
loudly.

:class:`MemberView` is the dynamic world view every server (and every
attached client) holds: it duck-types :class:`WorldSpec`, delegating to
the immutable base spec until membership actually changes, so static
worlds behave identically to pre-elastic builds.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Any, Callable, Optional, Sequence

from adlb_tpu_torch.runtime.messages import Msg, Tag, msg
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import ADLB_SUCCESS, AdlbError

# Provisional rank ids for the attach negotiation: a joiner needs a
# source id before the master has allocated its real one. Ids live far
# above any real rank (and any sidecar pseudo-rank), so every server
# classifies them as neither app nor server; the endpoint is re-keyed to
# the allocated rank the moment TA_MEMBER_RESP arrives.
PROV_BASE = 1 << 30
_prov_counter = itertools.count()


def provisional_rank() -> int:
    """A process-unique provisional id (pid + counter + entropy keep
    concurrent joiners from distinct processes apart)."""
    return (
        PROV_BASE
        + ((os.getpid() & 0xFFF) << 16)
        + ((next(_prov_counter) & 0xFF) << 8)
        + random.getrandbits(8)
    )


def is_provisional(rank: int) -> bool:
    return rank >= PROV_BASE


class MemberView:
    """Dynamic world membership over an immutable :class:`WorldSpec`.

    Duck-types the spec's topology surface (``is_app``/``is_server``/
    ``home_server``/``local_apps``/``server_ranks``/``app_ranks``/
    ``ring_next``/``nservers``…) and adds mutation verbs driven by the
    SS_MEMBER plane. With no dynamic members every answer is the base
    spec's — static worlds are behavior-identical. Attribute reads not
    overridden here (``types``, ``nranks``, ``master_server_rank``,
    ``use_debug_server``, ``validate_type``…) delegate to the spec.

    ``epoch`` is THE fleet epoch: membership ops carry the master's
    allocation, failover deaths fold in via :meth:`note_epoch`, and the
    exhaustion/END tokens key on it.
    """

    def __init__(self, spec: WorldSpec) -> None:
        self.spec = spec
        self.epoch = 0
        # attached app ranks: rank -> home server (survives the home's
        # death — the takeover maps translate, exactly like base ranks)
        self.extra_apps: dict[int, int] = {}
        # scale-out servers, in join (epoch) order — ring order is the
        # base range followed by this list
        self.extra_servers: list[int] = []
        # cleanly departed app ranks (detach): no longer members, but
        # remembered so a late frame/EOF from one is ignorable
        self.detached: set[int] = set()
        # master succession (on_server_failure="failover" covering the
        # master): None means the spec's static master — the common
        # case, and the snapshot() byte-identity case. Set (with the
        # epoch of the promotion) when a deputy takes over.
        self._master_rank: Optional[int] = None
        self._master_epoch = 0

    @classmethod
    def of(cls, world) -> "MemberView":
        return world if isinstance(world, MemberView) else cls(world)

    # -- delegation ----------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["spec"], name)

    # -- topology (the WorldSpec surface, membership-aware) -------------------

    @property
    def nservers(self) -> int:
        return self.spec.nservers + len(self.extra_servers)

    @property
    def num_app_ranks(self) -> int:
        # the BASE app-rank count: rank-id layout math (``rank <
        # num_app_ranks``) belongs to the static spec; dynamic
        # membership questions go through is_app()/app_ranks
        return self.spec.num_app_ranks

    @property
    def server_ranks(self):
        if not self.extra_servers:
            return self.spec.server_ranks
        return list(self.spec.server_ranks) + list(self.extra_servers)

    @property
    def app_ranks(self):
        if not self.extra_apps and not self.detached:
            return self.spec.app_ranks
        base = [r for r in self.spec.app_ranks if r not in self.detached]
        return base + [r for r in self.extra_apps if r not in self.detached]

    @property
    def master_server_rank(self) -> int:
        """The CURRENT master: the spec's static choice until a master
        failover promoted a deputy (set_master). Everything that
        addresses 'the master' — job control, attach RPCs, obs gossip,
        exhaustion init — reads this dynamically."""
        if self._master_rank is not None:
            return self._master_rank
        return self.spec.master_server_rank

    def set_master(self, rank: int, epoch: int = 0) -> None:
        """Master succession (SS_MASTER_TAKEOVER): epoch-guarded, so a
        late frame from an older succession can never roll the fleet
        back to a dead brain."""
        if self._master_rank is not None and epoch < self._master_epoch:
            return
        self._master_rank = rank
        self._master_epoch = epoch
        self.note_epoch(epoch)

    def is_server(self, rank: int) -> bool:
        return self.spec.is_server(rank) or rank in self.extra_servers

    def is_app(self, rank: int) -> bool:
        if rank in self.detached:
            return False
        return self.spec.is_app(rank) or rank in self.extra_apps

    def home_server(self, app_rank: int) -> int:
        if app_rank in self.extra_apps:
            return self.extra_apps[app_rank]
        if app_rank >= self.spec.num_app_ranks:
            # an attached rank this server has not (yet) learned: the
            # caller turns this into a retriable refusal, never silent
            # misrouting through the base modulo formula
            raise KeyError(f"unknown member rank {app_rank}")
        return self.spec.home_server(app_rank)

    def local_apps(self, server_rank: int) -> list[int]:
        base = [
            r for r in self.spec.local_apps(server_rank)
            if r not in self.detached
        ]
        base += [
            r for r, h in self.extra_apps.items()
            if h == server_rank and r not in self.detached
        ]
        return base

    def ring_next(self, server_rank: int) -> int:
        """Ring successor over the DYNAMIC server list (base order, then
        scale-out servers in join order — identical on every server
        because joins are epoch-ordered by the master's fan-out)."""
        if not self.extra_servers:
            return self.spec.ring_next(server_rank)
        ring = list(self.spec.server_ranks) + list(self.extra_servers)
        try:
            i = ring.index(server_rank)
        except ValueError:
            return self.spec.ring_next(server_rank)
        return ring[(i + 1) % len(ring)]

    # -- mutation (the SS_MEMBER plane) ---------------------------------------

    def note_epoch(self, epoch: int) -> None:
        if epoch > self.epoch:
            self.epoch = epoch

    def add_app(self, rank: int, home: int, epoch: int = 0) -> None:
        self.extra_apps[rank] = home
        self.detached.discard(rank)
        self.note_epoch(epoch)

    def remove_app(self, rank: int, epoch: int = 0) -> None:
        self.detached.add(rank)
        self.note_epoch(epoch)

    def add_server(self, rank: int, epoch: int = 0) -> None:
        if rank not in self.extra_servers and not self.spec.is_server(rank):
            self.extra_servers.append(rank)
        self.note_epoch(epoch)

    def snapshot(self) -> dict:
        """The seed a newly attached member receives in TA_MEMBER_RESP."""
        snap = {
            "epoch": self.epoch,
            "extra_apps": dict(self.extra_apps),
            "extra_servers": list(self.extra_servers),
            "detached": sorted(self.detached),
        }
        if self._master_rank is not None:
            # only after a succession: a never-failed-over world's
            # snapshot stays byte-identical to pre-succession builds
            snap["master"] = self._master_rank
            snap["master_epoch"] = self._master_epoch
        return snap

    def seed(self, snap: dict) -> None:
        self.extra_apps.update(snap.get("extra_apps") or {})
        for s in snap.get("extra_servers") or ():
            if s not in self.extra_servers and not self.spec.is_server(s):
                self.extra_servers.append(s)
        self.detached.update(snap.get("detached") or ())
        m = snap.get("master")
        if m is not None:
            self.set_master(
                int(m), int(snap.get("master_epoch", 0) or 0)
            )
        self.note_epoch(snap.get("epoch", 0) or 0)


# --------------------------------------------------------------- attach RPC


def _member_rpc(ep, master: int, fields: dict,
                timeout: float = 15.0) -> Msg:
    """Send one FA_MEMBER from a provisional endpoint and wait for the
    TA_MEMBER_RESP. Stray frames (there should be none toward a
    provisional id beyond PEER_EOF) are dropped."""
    deadline = time.monotonic() + timeout
    last_err = None
    while time.monotonic() < deadline:
        try:
            ep.send(master, msg(Tag.FA_MEMBER, ep.rank, **fields))
            break
        except OSError as e:  # master still binding (races at bring-up)
            last_err = e
            time.sleep(0.05)
    else:
        raise AdlbError(f"member rpc: master unreachable ({last_err!r})")
    while True:
        m = ep.recv(timeout=max(deadline - time.monotonic(), 0.0))
        if m is None:
            raise AdlbError("member rpc: no TA_MEMBER_RESP before timeout")
        if m.tag is Tag.TA_MEMBER_RESP:
            return m
        # anything else toward a provisional id is droppable noise


def _rekey_endpoint(ep, fabric, prov: int, rank: int) -> None:
    """Re-key a provisional endpoint to its allocated rank id."""
    ep.rank = rank
    addr_map = getattr(ep, "addr_map", None)
    if addr_map is not None and prov in addr_map:
        addr_map[rank] = addr_map.pop(prov)
    if fabric is not None:
        fabric.endpoints[rank] = ep
        fabric.endpoints.pop(prov, None)


def attach_app(
    world: WorldSpec,
    cfg: Config,
    *,
    fabric=None,
    master_addr: Optional[tuple] = None,
    self_host: str = "127.0.0.1",
    abort_event=None,
    timeout: float = 15.0,
):
    """Attach a NEW app rank to a running world and return its
    :class:`~adlb_tpu_torch.api.AdlbContext` (wrapped in a JoinedWorld so
    ``with`` finalizes it). Exactly one of ``fabric`` (in-proc worlds)
    or ``master_addr`` (TCP worlds: the master server's (host, port))
    selects the transport. Python servers only.
    """
    from adlb_tpu_torch.api import AdlbContext, JoinedWorld
    from adlb_tpu_torch.runtime.client import Client

    if cfg.server_impl == "native":
        raise AdlbError(
            "elastic attach requires python servers (the native daemon "
            "keeps the reference's fixed-at-init world)"
        )
    base = world.spec if isinstance(world, MemberView) else world
    prov = provisional_rank()
    # the CURRENT master: after a master failover a MemberView resolves
    # the promoted deputy — a joiner dialing the corpse would time out
    master = world.master_server_rank
    if fabric is not None:
        ep = fabric.add_endpoint(prov)
        fields = dict(mop="attach", kind="app")
    else:
        from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

        if master_addr is None:
            raise ValueError("attach_app over TCP needs master_addr")
        ep = TcpEndpoint(prov, {prov: (self_host, 0), master: master_addr})
        fields = dict(mop="attach", kind="app", host=self_host,
                      port=ep.port)
    try:
        resp = _member_rpc(ep, master, fields, timeout)
    except Exception:
        close = getattr(ep, "close", None)
        if close is not None:
            close()
        if fabric is not None:
            fabric.endpoints.pop(prov, None)
        raise
    if resp.data.get("rc", -1) != ADLB_SUCCESS:
        close = getattr(ep, "close", None)
        if close is not None:
            close()
        if fabric is not None:
            fabric.endpoints.pop(prov, None)
        raise AdlbError(
            f"attach refused (rc={resp.data.get('rc')}): "
            f"{resp.data.get('error', 'world not accepting members')}"
        )
    rank = resp.rank
    _rekey_endpoint(ep, fabric, prov, rank)
    view = MemberView(base)
    view.seed(resp.data.get("member") or {})
    view.add_app(rank, resp.home, resp.data.get("epoch", 0))
    # scale-out servers' addresses (TCP): the client must be able to
    # dial them for targeted/routed traffic
    addr_map = getattr(ep, "addr_map", None)
    if addr_map is not None:
        for r, a in (resp.data.get("srv_addrs") or {}).items():
            addr_map.setdefault(int(r), tuple(a))
    client = Client(view, cfg, ep, abort_event)
    client.attached_member = True
    # takeovers/drains that PREDATE this rank: their TA_HOME_TAKEOVER
    # broadcasts can never re-arrive here, so the master seeds the
    # retired-server route map directly — round-robin/targeted traffic
    # toward a retired server resolves to the live shard owner at once
    for dead, succ in (resp.data.get("srv_route") or {}).items():
        client._srv_route.setdefault(int(dead), int(succ))
    return JoinedWorld(AdlbContext(client), ep)


def attach_server(
    world: WorldSpec,
    cfg: Config,
    *,
    fabric=None,
    master_addr: Optional[tuple] = None,
    self_host: str = "127.0.0.1",
    timeout: float = 15.0,
) -> tuple:
    """Allocate a NEW server rank from the running world's master and
    return ``(server, ep)`` — a ready-to-run
    :class:`~adlb_tpu_torch.runtime.server.Server` whose world view is seeded
    with the fleet's current membership. The caller runs
    ``server.run()`` (thread or process); the reactor announces itself
    ready and the master directs a donor rebalance at it."""
    from adlb_tpu_torch.runtime.server import Server

    if cfg.server_impl == "native":
        raise AdlbError("elastic scale-out requires python servers")
    base = world.spec if isinstance(world, MemberView) else world
    prov = provisional_rank()
    master = world.master_server_rank  # succession-aware (MemberView)
    if fabric is not None:
        ep = fabric.add_endpoint(prov)
        fields = dict(mop="attach", kind="server")
    else:
        from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

        if master_addr is None:
            raise ValueError("attach_server over TCP needs master_addr")
        ep = TcpEndpoint(prov, {prov: (self_host, 0), master: master_addr})
        fields = dict(mop="attach", kind="server", host=self_host,
                      port=ep.port)
    resp = _member_rpc(ep, master, fields, timeout)
    if resp.data.get("rc", -1) != ADLB_SUCCESS:
        close = getattr(ep, "close", None)
        if close is not None:
            close()
        if fabric is not None:
            fabric.endpoints.pop(prov, None)
        raise AdlbError(
            f"server attach refused (rc={resp.data.get('rc')}): "
            f"{resp.data.get('error', 'world not accepting members')}"
        )
    rank = resp.rank
    _rekey_endpoint(ep, fabric, prov, rank)
    view = MemberView(base)
    view.seed(resp.data.get("member") or {})
    view.add_server(rank, resp.data.get("epoch", 0))
    addr_map = getattr(ep, "addr_map", None)
    if addr_map is not None:
        for r, a in (resp.data.get("rank_addrs") or {}).items():
            addr_map.setdefault(int(r), tuple(a))
    # a scale-out shard never serves the ops endpoint (the master owns
    # it) and never opens a second flight of the same WAL generation
    import dataclasses as _dc

    scfg = _dc.replace(cfg, ops_port=None)
    server = Server(view, scfg, ep)
    # seed job-namespace lifecycle the fleet already ran (SS_JOB_CTL
    # fan-outs predate this shard)
    for jid, code, quota, name in resp.data.get("jobs") or ():
        server.jobs.restore(jid, code, quota, name)
    # servers retired BEFORE this shard existed: without these its
    # ring/buddy walks and live-member checks would include them and
    # every token forward toward one would have to fail over ad hoc
    for r in resp.data.get("srv_dead") or ():
        server._dead_servers.add(int(r))
        server._member_live.discard(int(r))
    for r in resp.data.get("srv_drained") or ():
        server._drained_servers.add(int(r))
        server._member_live.discard(int(r))
    return server, ep


# --------------------------------------------------------------- harness


class _AppThread:
    def __init__(self, rank: int, thread: threading.Thread,
                 box: dict) -> None:
        self.rank = rank
        self.thread = thread
        self.box = box

    def result(self, timeout: Optional[float] = None):
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError(f"rank {self.rank} still running")
        if "error" in self.box:
            raise self.box["error"]
        return self.box.get("result")


class ElasticWorld:
    """In-process elastic world harness: the `run_world` plumbing opened
    up so tests (and the chaos soak's churn adversity) can attach and
    detach ranks, and scale servers out/in, WHILE the world runs.

    Servers start immediately; app ranks are launched explicitly with
    :meth:`run_app` (base ranks) / :meth:`attach_app` (dynamic ranks).
    The master's ``member_spawner`` is wired to :meth:`_spawn_server`,
    so ``POST /fleet/scale`` and the watermark autoscale path work too.
    """

    def __init__(
        self,
        num_app_ranks: int,
        nservers: int,
        types: Sequence[int],
        cfg: Optional[Config] = None,
        timeout: float = 120.0,
    ) -> None:
        from adlb_tpu_torch.runtime.server import Server
        from adlb_tpu_torch.runtime.transport import InProcFabric

        self.cfg = cfg or Config()
        self.world = WorldSpec(
            nranks=num_app_ranks + nservers,
            nservers=nservers,
            types=tuple(types),
        )
        self.timeout = timeout
        self.fabric = InProcFabric(self.world.nranks)
        self.servers: dict[int, Server] = {}
        self._server_threads: dict[int, threading.Thread] = {}
        self._apps: dict[int, _AppThread] = {}
        self._attached: list = []  # JoinedWorld handles from attach_app
        self._errors: list[BaseException] = []
        self._lock = threading.Lock()
        from adlb_tpu_torch.runtime.faults import maybe_wrap

        for rank in self.world.server_ranks:
            server = Server(
                MemberView(self.world), self.cfg,
                maybe_wrap(self.fabric.endpoint(rank), self.cfg, self.world),
                self.fabric.abort_event,
            )
            self.servers[rank] = server
            t = threading.Thread(
                target=self._server_main, args=(rank, server),
                daemon=True, name=f"adlb-rank-{rank}",
            )
            self._server_threads[rank] = t
            t.start()
        self.master = self.servers[self.world.master_server_rank]
        self.master.member_spawner = self._spawn_server

    @property
    def current_master(self):
        """The server currently holding the master role. After a master
        failover the static ``self.master`` is a corpse; anything that
        polls 'the master' (scale_out readiness, ctl asks) must resolve
        the live brain instead."""
        for s in self.servers.values():
            if s.is_master and not s.done and not s.died:
                return s
        return self.master

    # -- server plumbing ------------------------------------------------------

    def _server_main(self, rank, server) -> None:
        try:
            server.run()
            if server._drained_exit:
                # TCP parity: a drained server's endpoint closes, so a
                # late frame toward it raises OSError at the sender
                # (which already counts the rank retired) instead of
                # parking silently in a dead inbox
                close = getattr(server.ep, "close", None)
                if close is not None:
                    close()
        except BaseException as e:  # noqa: BLE001 — surfaced at finish()
            with self._lock:
                self._errors.append(e)
            self.fabric.abort_event.set()

    def _spawn_server(self, alloc: dict) -> None:
        """The master's scale-out spawner: run the allocation dance off
        the reactor thread and start the new shard in this process."""
        def go():
            try:
                server, _ep = attach_server(
                    self.world, self.cfg, fabric=self.fabric
                )
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._errors.append(e)
                return
            with self._lock:
                self.servers[server.rank] = server
            t = threading.Thread(
                target=self._server_main, args=(server.rank, server),
                daemon=True, name=f"adlb-rank-{server.rank}",
            )
            self._server_threads[server.rank] = t
            t.start()

        threading.Thread(target=go, daemon=True,
                         name="adlb-member-spawn").start()

    # -- app ranks ------------------------------------------------------------

    def _ctx_for(self, rank: int):
        from adlb_tpu_torch.api import AdlbContext
        from adlb_tpu_torch.runtime.client import Client
        from adlb_tpu_torch.runtime.faults import maybe_wrap

        client = Client(
            self.world, self.cfg,
            maybe_wrap(self.fabric.endpoint(rank), self.cfg, self.world),
            self.fabric.abort_event,
        )
        return AdlbContext(client)

    def _app_main(self, ctx, fn, box: dict) -> None:
        from adlb_tpu_torch.types import AdlbAborted

        try:
            box["result"] = fn(ctx)
        except AdlbAborted:
            box["aborted"] = True
        except BaseException as e:  # noqa: BLE001
            box["error"] = e
            self.fabric.abort_event.set()
        finally:
            try:
                ctx._c.finalize()
            except Exception:  # teardown races are benign
                pass

    def run_app(self, rank: int, fn: Callable) -> _AppThread:
        """Launch a BASE app rank's body on its own thread."""
        box: dict = {}
        ctx = self._ctx_for(rank)
        t = threading.Thread(target=self._app_main, args=(ctx, fn, box),
                             daemon=True, name=f"adlb-rank-{rank}")
        handle = _AppThread(rank, t, box)
        self._apps[rank] = handle
        t.start()
        return handle

    def attach_ctx(self):
        """Attach a new dynamic rank; returns the JoinedWorld handle
        (use as a context manager, or call .ctx / detach explicitly)."""
        # dial through the live brain's MemberView: after a master
        # failover the static spec names a corpse
        jw = attach_app(self.current_master.world, self.cfg,
                        fabric=self.fabric,
                        abort_event=self.fabric.abort_event)
        self._attached.append(jw)
        return jw

    def attach_app(self, fn: Callable) -> _AppThread:
        """Attach a new rank and run ``fn(ctx)`` on a thread; the rank
        finalizes (stays a member, counted by the END ring) on return."""
        jw = self.attach_ctx()
        box: dict = {}
        t = threading.Thread(
            target=self._app_main, args=(jw.ctx, fn, box),
            daemon=True, name=f"adlb-rank-{jw.ctx.rank}",
        )
        handle = _AppThread(jw.ctx.rank, t, box)
        self._apps[jw.ctx.rank] = handle
        t.start()
        return handle

    # -- scale ----------------------------------------------------------------

    def scale_out(self, timeout: float = 30.0) -> int:
        """Spawn + attach + bootstrap one new server shard; returns its
        rank once the master has seen it ready."""
        master = self.current_master
        before = set(master.world.extra_servers)
        master.ctl_request({"op": "scale_out"}, timeout=10.0)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            master = self.current_master
            ready = getattr(master, "_member_ready", set())
            new = [s for s in ready if s not in before]
            if new:
                return new[0]
            if self._errors:
                raise self._errors[0]
            time.sleep(0.02)
        raise TimeoutError("scale-out did not complete")

    def scale_in(self, rank: Optional[int] = None,
                 timeout: float = 30.0) -> int:
        req = {"op": "scale_in"}
        if rank is not None:
            req["rank"] = rank
        res = self.current_master.ctl_request(req, timeout=10.0)
        drained = res["rank"]
        t = self._server_threads.get(drained)
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"server {drained} did not drain")
        return drained

    # -- teardown -------------------------------------------------------------

    def finish(self, timeout: Optional[float] = None) -> dict:
        """Join every thread; returns {rank: result}. Raises the first
        captured error, mirroring run_world."""
        deadline = time.monotonic() + (timeout or self.timeout)
        results = {}
        for rank, handle in list(self._apps.items()):
            results[rank] = handle.result(
                max(deadline - time.monotonic(), 0.0)
            )
        for rank, t in list(self._server_threads.items()):
            t.join(max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                self.fabric.abort_event.set()
                raise TimeoutError(f"server {rank} did not finish")
        if self._errors:
            raise self._errors[0]
        return results

    def server_stats(self) -> dict:
        return {
            r: s.finalize_stats() for r, s in self.servers.items()
            if s.done and not s.died
        }
