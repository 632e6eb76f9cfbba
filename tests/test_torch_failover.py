"""Server and master failover in the port (``runtime/replica.py``,
``Server._promote_master``), with the planned balancer on the device path.

* **End to end** — in-process worlds that lose a server or the MASTER
  (fault-injected disconnect) complete with every unit completed,
  re-executed or counted in ``FAILOVER_LOST`` or (a relay consumed at
  its home's death) ``FAILOVER_RELAYS_UNRESOLVED``, in ``steal`` and ``tpu``
  modes (``tests/test_failover.py:532``, ``tests/test_master_failover.py:428``);
  in ``tpu`` mode the promoted deputy builds its planner mid-world and
  makes device solves, and ``WorldResult.planner`` holds both planners.
* **Promotion** — the handler-driven promotion matrix
  (``tests/test_master_failover.py:139``) against the port's ``Server``,
  and unconfigured worlds mint nothing (``:356``).
* **The port's faults on this path** — a process world reports the
  promoted deputy's planner counts; a written-off master's straggler
  planner error does not abort the world, while a live master's and a
  deputy's (its planner failing to build or to solve) still do; planner
  counts and kept solves stay exact under two planner threads; units a
  dead holder relayed, whose consume never reached its buddy, are
  resolved again by the requesters' home servers; a disconnected server
  with nothing to send still exits.
"""

import functools
import struct
import threading
import time

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu_torch.api import run_world
from adlb_tpu_torch.balancer import engine as engine_mod
from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.balancer import solve
from adlb_tpu_torch.runtime.client import Client
from adlb_tpu_torch.runtime.messages import Msg, Tag
from adlb_tpu_torch.runtime.server import Server
from adlb_tpu_torch.runtime.transport import InProcFabric
from adlb_tpu_torch.runtime.transport_tcp import spawn_world
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import ADLB_SUCCESS, InfoKey

T = 1
N_UNITS = 48
# 4 apps x 3 servers: apps 0..3, servers 4 (the master), 5 (its ring
# buddy, the deputy) and 6
MASTER, DEPUTY = 4, 5


def _coverage_economy(ctx, nunits=N_UNITS, work_s=0.002):
    if ctx.rank == 0:
        for i in range(nunits):
            ctx.put(struct.pack("<q", i), T)
    got = []
    while True:
        rc, w = ctx.get_work([T])
        if rc != ADLB_SUCCESS:
            return got
        got.append(struct.unpack("<q", w.payload)[0])
        time.sleep(work_s)


def _until_planned_economy(ctx, planned, put=None, cap=20_000, burst=10):
    """Rank 0 puts ``burst`` units at its home server every 2 ms until
    ``planned`` is set (by the promoted deputy's first device solve), at
    most ``cap``, and records how many in ``put``; every rank consumes
    until the world ends. All units enter rank 0's home
    (``put_routing="home"``), faster than the ranks homed there consume
    them (2 ms each), and a rank homed elsewhere is fed only by a plan:
    the backlog lasts until the deputy has planned, however fast or slow
    the world runs."""
    if ctx.rank == 0:
        n = 0
        while not planned.is_set() and n < cap:
            for _ in range(burst):
                if ctx.put(struct.pack("<q", n), T) != ADLB_SUCCESS:
                    break
                n += 1
            time.sleep(0.002)
        if put is not None:
            put.append(n)
    return _coverage_economy(ctx, nunits=0)


def _assert_coverage_only(res, nunits):
    done = [x for v in res.app_results.values() for x in v]
    lost = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
               + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
               for s in res.server_stats.values())
    missing = set(range(nunits)) - set(done)
    assert len(missing) <= lost, (
        f"units {sorted(missing)} vanished but only {lost} counted lost")


def _assert_coverage(res, expect_casualty, nunits=N_UNITS):
    _assert_coverage_only(res, nunits)
    assert res.server_casualties == [expect_casualty]
    assert not res.aborted
    assert sum(s.get(int(InfoKey.NUM_FAILOVERS), 0.0)
               for s in res.server_stats.values()) >= 1


def _cfg(mode, dead_index, **kw):
    return Config(balancer=mode, device="cpu", solver_host_threshold=0,
                  on_server_failure="failover", exhaust_check_interval=0.2,
                  failover_client_wait=30.0,
                  fault_spec={"seed": 5,
                              "disconnect_server_at": {dead_index: 40}},
                  **kw)


@pytest.mark.parametrize("mode", ["steal", "tpu"])
def test_inproc_server_death_failover_completes(mode):
    res = run_world(4, 3, [T], _coverage_economy, cfg=_cfg(mode, 1),
                    timeout=120.0)
    _assert_coverage(res, expect_casualty=5)  # server index 1 = rank 5


@pytest.mark.parametrize("mode", ["steal", "tpu"])
def test_inproc_master_death_failover_completes(mode, monkeypatch):
    """The master dies at its 40th outbound frame; its deputy promotes. In
    tpu mode the deputy builds a PlanEngine mid-world and plans: its
    device solves are above 0, each on the device path (no host solve),
    and every kept solve of either planner equals the numpy twin. The
    tpu world's backlog lasts until the deputy's first device solve
    (``_until_planned_economy``)."""
    app, cfg, put = _coverage_economy, _cfg(mode, 0), [N_UNITS]
    if mode == "tpu":
        planned, put = threading.Event(), []
        dsolve = solve.AssignmentSolver._device_solve

        def dsolve_(self, *arrays):
            out = dsolve(self, *arrays)
            s = getattr(threading.current_thread(), "server", None)
            if s is not None and s.rank == DEPUTY:
                planned.set()
            return out

        monkeypatch.setattr(solve.AssignmentSolver, "_device_solve", dsolve_)
        app = functools.partial(_until_planned_economy, planned=planned,
                                put=put)
        cfg = _cfg(mode, 0, put_routing="home")
    solve.reset_counts()
    old = solve.check_every
    solve.check_every = 2
    try:
        res = run_world(4, 3, [T], app, cfg=cfg, timeout=120.0)
        counts = solve.planner_counts()
    finally:
        solve.check_every = old
    _assert_coverage(res, expect_casualty=MASTER, nunits=put[0])
    if mode == "steal":
        assert res.planner == {}
        return
    deputy = res.planner[DEPUTY]
    assert deputy["device_solves"] > 0 and deputy["host_solves"] == 0
    assert deputy["solves_kept"] >= (deputy["device_solves"] + 1) // 2
    assert MASTER in res.planner  # it planned before it died
    assert counts["solves_checked"] == sum(
        c["solves_kept"] for c in res.planner.values()) > 0
    assert counts["solves_wrong"] == 0 and counts["host_solves"] == 0


def test_inproc_master_death_abort_policy_unchanged():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        run_world(4, 3, [T], _coverage_economy,
                  cfg=Config(device="cpu", exhaust_check_interval=0.2,
                             fault_spec={"seed": 5,
                                         "disconnect_server_at": {0: 40}}),
                  timeout=60.0)
    assert time.monotonic() - t0 < 45.0, "abort path hung"


# ---------------------------------------------------- promotion (handlers)


def _pair(master_kw=None, deputy_kw=None):
    """A live master (rank 2) and its deputy (rank 3) of a 2-app, 3-server
    world on one in-proc fabric, driven handler by handler."""
    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    fabric = InProcFabric(5)
    m = Server(world, Config(device="cpu", on_server_failure="failover",
                             **(master_kw or {})), fabric.endpoint(2))
    d = Server(world, Config(device="cpu", on_server_failure="failover",
                             **(deputy_kw or {})), fabric.endpoint(3))
    return m, d, fabric


def _drain(fabric, rank):
    out = []
    while (m := fabric.endpoints[rank].recv(timeout=0.0)) is not None:
        out.append(m)
    return out


def _kill_master(m, d, fabric):
    """The brain streamed to the deputy, then the master's EOF."""
    m._repl_brain()
    m._flush_repl()
    for f in _drain(fabric, d.rank):
        d._handle(f)
    d._handle(Msg(tag=Tag.PEER_EOF, src=m.rank))


def test_promotion_state_matrix():
    """The replicated brain lands exactly: job table (name, quota,
    fair-share weight), id watermarks, retired routes, epoch."""
    m, d, fabric = _pair()
    m._handle_ctl({"op": "submit", "name": "tenant-a", "quota_bytes": 0})
    m._handle_ctl({"op": "submit", "name": "tenant-b", "quota_bytes": 4096})
    m._handle_ctl({"op": "update", "job_id": 1, "weight": 3.0})
    m._dead_servers.add(4)
    m._member_next_rank = 17
    _kill_master(m, d, fabric)
    assert d.is_master and d.world.master_server_rank == 3
    assert d.world.epoch >= 1
    ja, jb = d.jobs.get(1), d.jobs.get(2)
    assert ja is not None and ja.name == "tenant-a" and ja.weight == 3.0
    assert jb is not None and jb.quota_bytes == 4096
    assert d._job_next_id >= 3 and d._member_next_rank >= 17
    assert 4 in d._srv_route
    assert d._effective_job_weights().get(1) == 3.0


def test_promoted_deputy_starts_its_planner_with_the_weights():
    """In tpu mode the promoted deputy starts a balancer thread that builds
    its own PlanEngine on its Config's device, with the dead master's live
    job weights."""
    m, d, fabric = _pair(dict(balancer="tpu"), dict(balancer="tpu"))
    m._handle_ctl({"op": "submit", "name": "tenant-a", "quota_bytes": 0})
    m._handle_ctl({"op": "update", "job_id": 1, "weight": 2.5})
    _kill_master(m, d, fabric)
    try:
        assert d.is_master and d._balancer is not None
        assert d._effective_job_weights().get(1) == 2.5
        deadline = time.monotonic() + 30
        while d._solver is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert d._solver is not None and d._solver.device.type == "cpu"
    finally:
        d.done = True
        d._balancer.stop()
        d._balancer.join(timeout=5)


def test_unconfigured_worlds_mint_nothing():
    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    srv = Server(world, Config(device="cpu"), InProcFabric(5).endpoint(2))
    assert srv.repl is None
    srv._repl_brain()  # a no-op, not a crash
    assert "master" not in srv.world.snapshot()
    assert not any("master_failover" in k for k in srv.metrics._gauges)
    assert srv._takeover_pending is None


# ------------------------------------------------ faults of the port's path


def test_process_world_reports_the_promoted_deputys_planner():
    """A process world whose master loses its connectivity: the deputy,
    a rank that never planned before, plans the rest of the world, and its
    counts come back in ``WorldResult.planner`` beside the dead master's.
    Over TCP: under the shm fabric an injected disconnect surfaces as a
    ValueError of the dead rank's ring (the JAX package's too), not as
    the lost connectivity that failover absorbs. Each unit takes 10 ms,
    so the world outlives the master by about a second."""
    res = spawn_world(4, 3, [T], functools.partial(
        _coverage_economy, nunits=300, work_s=0.01),
        cfg=_cfg("tpu", 0, fabric="tcp"), timeout=120.0)
    _assert_coverage(res, expect_casualty=MASTER, nunits=300)
    deputy = res.planner[DEPUTY]
    assert deputy["rounds"] > 0 and deputy["host_solves"] == 0
    assert deputy["greedy_sweep_launches"] == 0  # CPU: the plain version
    assert set(res.planner) <= {MASTER, DEPUTY}


def test_process_world_failover_over_shm():
    """The world above over the shared-memory ring fabric: the master's
    injected disconnect closes its rings while its reactor still holds a
    submit batch, and the world must read that as the lost connectivity
    failover absorbs, not fail with the released ring's ValueError."""
    from adlb_tpu_torch.runtime.transport_shm import shm_available

    if not shm_available():
        pytest.skip("host cannot run the shared-memory fabric")
    res = spawn_world(4, 3, [T], functools.partial(
        _coverage_economy, nunits=300, work_s=0.01),
        cfg=_cfg("tpu", 0, fabric="shm"), timeout=120.0)
    _assert_coverage(res, expect_casualty=MASTER, nunits=300)
    assert res.planner[DEPUTY]["host_solves"] == 0


def test_shm_endpoint_closed_mid_batch_raises_oserror():
    """An endpoint closed inside a submit batch (what the disconnect fault
    does to the rank that sends its fatal frame): the batch's flush rings
    no bell into a released ring, and a frame written into a ring taken
    before the close fails with OSError, as a closed socket's send does."""
    from adlb_tpu_torch.runtime.messages import msg
    from adlb_tpu_torch.runtime.transport_shm import (ShmEndpoint,
                                                      cleanup_world,
                                                      new_world_key,
                                                      shm_available)
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    if not shm_available():
        pytest.skip("host cannot run the shared-memory fabric")
    key = new_world_key()
    a = ShmEndpoint(TcpEndpoint(0, {0: ("127.0.0.1", 0)}), key)
    b = ShmEndpoint(TcpEndpoint(1, {1: ("127.0.0.1", 0)}), key)
    a.addr_map.update(b.addr_map)
    b.addr_map.update(a.addr_map)
    try:
        a.submit_begin()
        a.send(1, msg(Tag.FA_PUT, 0, payload=b"p", work_type=T, prio=0,
                      target_rank=-1, answer_rank=-1))
        ring, bell = a._tx[1]
        a.close()
        a.submit_flush()
        with pytest.raises(OSError, match="endpoint closed"):
            a._write_frame(ring, bell, 1, 4, [b"abcd"])
    finally:
        b.close()
        cleanup_world(key)


class _DeadMasterEndpoint:
    """App rank 1's endpoint after the master died: a send to the master
    is refused, and the deputy's TA_HOME_TAKEOVER note waits unread in
    the queue (the rank was computing when it arrived)."""

    def __init__(self):
        from collections import deque

        from adlb_tpu_torch.runtime.messages import msg

        self.rank, self.metrics, self.sent = 1, None, []
        self.queue = deque([msg(Tag.TA_HOME_TAKEOVER, DEPUTY, dead=MASTER,
                                epoch=2, new_master=DEPUTY)])

    def send(self, dest, m, connect_grace=15.0):
        self.sent.append((dest, connect_grace))
        if dest == MASTER:
            raise ConnectionRefusedError("the master is dead")

    def recv(self, timeout=None):
        return self.queue.popleft() if self.queue else None


def test_first_send_to_a_dead_master_goes_to_its_deputy():
    """A rank's first frame to the master comes after the master died,
    with the takeover note already queued: the send connects with the
    short failover grace, and its failure applies the note and re-sends
    to the deputy at once. It used to retry the dead master
    ``reconnect_attempts`` more times, each with a 15 s connect grace
    (and a shared-memory probe), before it read the note: a spawned
    failover world then waited out most of ``failover_client_wait``."""
    from adlb_tpu_torch.runtime.client import Client
    from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE
    from adlb_tpu_torch.runtime.messages import msg

    ep = _DeadMasterEndpoint()
    client = Client(WorldSpec(nranks=7, nservers=3, types=(T,)),
                    _cfg("tpu", 0), ep)
    client._send_retry(MASTER, msg(Tag.FA_PUT, 1, payload=b"x",
                                   work_type=T, prio=0, target_rank=0,
                                   answer_rank=-1))
    assert ep.sent == [(MASTER, UP_PEER_GRACE), (DEPUTY, UP_PEER_GRACE)]


def test_server_sends_to_servers_take_the_short_grace_under_failover():
    """Under ``on_server_failure="failover"`` a server's sends to other
    servers (snapshots to the master, routed server sends, the
    termination ring) connect with ``UP_PEER_GRACE``: a server whose first
    snapshot to the master came after the master died stalled its reactor
    for the 15 s start-up grace. Without failover nothing changes."""
    from adlb_tpu_torch.runtime.messages import msg
    from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE

    class Recording:
        def __init__(self, ep):
            self.ep, self.kw = ep, []

        def send(self, dest, m, **kw):
            self.kw.append(kw)

        def __getattr__(self, name):
            return getattr(self.ep, name)

    world = WorldSpec(nranks=7, nservers=3, types=(T,))
    fabric = InProcFabric(7)
    for rank, cfg, want in (
            (5, Config(device="cpu", on_server_failure="failover"),
             {"connect_grace": UP_PEER_GRACE}),
            (6, Config(device="cpu"), {})):
        srv = Server(world, cfg, fabric.endpoint(rank))
        srv.ep = Recording(srv.ep)
        srv._send_srv(4, msg(Tag.SS_PERIODIC_STATS, rank, token={}))
        assert srv.ep.kw == [want]


class _Recording:
    """A server endpoint that records (destination, tag) and sends
    nothing."""

    def __init__(self, ep):
        self.ep, self.sent = ep, []

    def send(self, dest, m, **kw):
        self.sent.append((dest, m.tag))

    def __getattr__(self, name):
        return getattr(self.ep, name)


def _failover_server(rank):
    srv = Server(WorldSpec(nranks=7, nservers=3, types=(T,)),
                 Config(device="cpu", on_server_failure="failover"),
                 InProcFabric(7).endpoint(rank))
    srv.ep = _Recording(srv.ep)
    return srv


def test_a_finalize_reaches_the_buddy_before_anything_else():
    """A rank's FA_LOCAL_APP_DONE is replicated at once: the rank exits
    without an answer, so a master that died before its next flush left
    the promoted deputy waiting for a rank that was gone (the ported
    soak's seed 1362 world, killed at frame 48, hung)."""
    srv = _failover_server(MASTER)
    srv._on_local_app_done(Msg(tag=Tag.FA_LOCAL_APP_DONE, src=0))
    assert srv.ep.sent[:1] == [(DEPUTY, Tag.SS_REPL)], srv.ep.sent


@pytest.mark.parametrize("ack", [False, True])
def test_a_finalize_is_answered_after_its_replication(ack):
    """Under failover a rank asks its home to answer its finalize
    (``ack``), and the answer leaves only after the frame that
    replicates the finalize to the buddy: a rank that has the answer
    knows its finalize outlives the home. A finalize that asks for no
    answer gets none, as before."""
    from adlb_tpu_torch.runtime.messages import msg

    srv = _failover_server(MASTER)
    srv._on_local_app_done(msg(Tag.FA_LOCAL_APP_DONE, 0,
                               **({"ack": True} if ack else {})))
    answers = [(d, t) for d, t in srv.ep.sent if d == 0]
    assert srv.ep.sent[:1] == [(DEPUTY, Tag.SS_REPL)], srv.ep.sent
    assert answers == ([(0, Tag.TA_MEMBER_RESP)] if ack else [])


@pytest.mark.parametrize("policy", ["abort", "failover"])
def test_a_finalize_asks_for_an_answer_only_under_failover(policy):
    """Without failover a finalize stays one frame that asks for nothing
    and is not waited on, frame for frame as before; under failover it
    asks for the answer and returns once it has it."""
    world = WorldSpec(nranks=7, nservers=3, types=(T,))
    fabric = InProcFabric(7)
    cfg = Config(device="cpu", on_server_failure=policy)
    client = Client(world, cfg, fabric.endpoint(0), fabric.abort_event)
    if policy == "failover":
        fabric.endpoint(0).inbox.put(Msg(tag=Tag.TA_MEMBER_RESP, src=MASTER,
                                         data={"finalized": True}))
    assert client.finalize() == ADLB_SUCCESS
    fin = fabric.endpoint(MASTER).recv(timeout=0)
    assert fin.tag is Tag.FA_LOCAL_APP_DONE and fin.src == 0
    assert fin.data == ({"ack": True} if policy == "failover" else {})
    assert fabric.endpoint(MASTER).recv(timeout=0) is None
    assert fabric.endpoint(0).recv(timeout=0) is None


class _Forwarding(_Recording):
    """A recording endpoint that also sends."""

    def send(self, dest, m, **kw):
        super().send(dest, m, **kw)
        self.ep.send(dest, m, **kw)


def _wait_frame(ep, tag, src, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = ep.recv(timeout=0.1)
        if m is not None and m.tag is tag and m.src == src:
            return m
    return None


def test_an_adopted_rank_whose_finalize_died_with_the_master():
    """Rank 3 finalized into the master, which died before the frame that
    replicates it left: the deputy's mirror lacks the finalize. The rank
    has no answer yet, so on the deputy's takeover note it re-sends its
    finalize there: the deputy's ``_finalized`` gains it, the END ring
    starts, and the rank's finalize returns. On the parent tree the
    rank exited at once and the deputy waited for it forever."""
    from adlb_tpu_torch.runtime import replica

    world = WorldSpec(nranks=7, nservers=3, types=(T,))
    cfg = Config(device="cpu", on_server_failure="failover",
                 failover_client_wait=10.0)
    fabric = InProcFabric(7)
    srv = Server(world, cfg, fabric.endpoint(DEPUTY))
    srv.ep = _Forwarding(srv.ep)
    srv._on_local_app_done(Msg(tag=Tag.FA_LOCAL_APP_DONE, src=1))
    client = Client(world, cfg, fabric.endpoint(3), fabric.abort_event)
    out = {}
    fin = threading.Thread(target=lambda: out.update(rc=client.finalize()),
                           daemon=True)
    fin.start()
    # the master reads the finalize and dies before answering or
    # replicating it
    assert _wait_frame(fabric.endpoint(MASTER), Tag.FA_LOCAL_APP_DONE, 3)
    fabric.endpoint(3).inbox.put(Msg(tag=Tag.PEER_EOF, src=MASTER))
    mirror = replica.ReplicaMirror(MASTER)
    mirror.finalized.add(0)
    srv.mirrors[MASTER] = mirror
    srv._server_eof_at[MASTER] = time.monotonic()
    srv._dead_servers.add(MASTER)
    srv._promote(MASTER)
    assert 3 not in srv._finalized
    again = _wait_frame(fabric.endpoint(DEPUTY), Tag.FA_LOCAL_APP_DONE, 3)
    assert again is not None, "the rank never re-sent its finalize"
    srv._handle(again)
    srv._master_takeover_done()
    fin.join(timeout=10.0)
    assert out == {"rc": ADLB_SUCCESS}
    assert not srv._aborted
    assert srv._finalized >= {0, 1, 3}
    assert 3 not in srv._dead_ranks
    assert (6, Tag.SS_END_1) in srv.ep.sent, srv.ep.sent


@pytest.mark.parametrize("on_worker_failure", ["reclaim", "abort"])
def test_an_adopted_rank_killed_after_the_adoption_is_a_death(
        on_worker_failure):
    """Rank 3 holds a unit pinned at the master when the master dies; the
    deputy adopts the unit with its lease. Rank 3 is then killed before
    it finalizes: its EOF is a death, judged by the worker policy, as
    before the acknowledged finalize. ``reclaim`` re-runs its unit and
    does not count it finalized; ``abort`` aborts the world."""
    from adlb_tpu_torch.runtime import replica
    from adlb_tpu_torch.runtime.queues import WorkUnit

    srv = Server(WorldSpec(nranks=7, nservers=3, types=(T,)),
                 Config(device="cpu", on_server_failure="failover",
                        on_worker_failure=on_worker_failure),
                 InProcFabric(7).endpoint(DEPUTY))
    srv.ep = _Recording(srv.ep)
    log = replica.ReplicationLog(buddy=DEPUTY)
    log.log_put(WorkUnit(seqno=10, work_type=T, prio=0, target_rank=-1,
                         answer_rank=-1, payload=b"unit"), src=0, put_id=1)
    log.log_pin(10, 3)
    mirror = replica.ReplicaMirror(MASTER)
    mirror.apply(log.take())
    srv.mirrors[MASTER] = mirror
    srv._server_eof_at[MASTER] = time.monotonic()
    srv._dead_servers.add(MASTER)
    srv._promote(MASTER)
    srv._master_takeover_done()
    (unit,) = list(srv.wq.units())
    assert unit.pinned and unit.pin_rank == 3
    srv._handle(Msg(tag=Tag.PEER_EOF, src=3))
    if on_worker_failure == "abort":
        assert srv._aborted
        return
    assert not srv._aborted
    assert 3 in srv._dead_ranks
    (unit,) = list(srv.wq.units())
    assert not unit.pinned
    assert not any(lease.owner == 3 for lease in srv.leases.leases())


def _frame48_world():
    """Seed 1362's master-kill world of ``scripts/chaos_soak_torch.py``
    (3 apps x 4 servers, planned on the CPU with the host threshold 0,
    ``abort`` for workers, 24 units), its master SIGKILLed at its 48th
    outbound frame, where the finalize of a rank homed at the master can
    die with it: 2 of 12 such worlds hung on the parent tree."""
    return spawn_world(
        3, 4, [1, 2], functools.partial(_coverage_economy, nunits=24),
        timeout=20.0,
        cfg=Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                   exhaust_check_interval=0.2, on_worker_failure="abort",
                   on_server_failure="failover", failover_client_wait=30.0,
                   fault_spec={"seed": 1362,
                               "kill_server_at_frame": {0: 48}}))


def test_frame48_master_kill_world_ends():
    """The frame-48 world ends within 20 s, every unit consumed once or
    counted lost, until the kill has landed three times (a world that
    drains before the master's 48th frame loses no server and proves
    nothing; at most five worlds)."""
    killed = 0
    for _ in range(5):
        res = _frame48_world()
        if not res.server_casualties:
            _assert_coverage_only(res, nunits=24)
            continue
        _assert_coverage(res, expect_casualty=3, nunits=24)
        killed += 1
        if killed == 3:
            break
    assert killed >= 1, "the master's kill never landed"


@pytest.mark.parametrize("verdict", ["no_more_work", "done_by_exhaustion"])
def test_a_promoted_master_finishes_the_dead_masters_verdict(verdict):
    """A master that died halfway through declaring the world done left a
    server it had not reached holding a parked rank that nothing would
    release: the promoted deputy, once every survivor acked it, sends the
    verdict it holds to every live server again."""
    srv = _failover_server(DEPUTY)
    setattr(srv, verdict, True)
    srv._dead_servers.add(MASTER)
    srv._master_takeover_done()
    tag = {"no_more_work": Tag.SS_NO_MORE_WORK,
           "done_by_exhaustion": Tag.SS_DONE_BY_EXHAUSTION}[verdict]
    assert (6, tag) in srv.ep.sent, srv.ep.sent


def test_a_dead_servers_late_gossip_is_ignored():
    """A qmstat entry from a server this one already forgot (its death was
    declared by another server before its last frames were drained) is
    dropped; it used to raise KeyError in the reactor and end the world
    (the ported soak's seed 1172 under load)."""
    from adlb_tpu_torch.runtime.messages import msg

    world = WorldSpec(nranks=7, nservers=3, types=(T,))
    fabric = InProcFabric(7)
    srv = Server(world, Config(device="cpu", on_server_failure="failover"),
                 fabric.endpoint(DEPUTY))
    entry = Server(world, Config(device="cpu"),
                   fabric.endpoint(MASTER))._qmstat_entry()
    srv.peers.pop(MASTER)  # what the declared death does
    srv._on_qmstat(msg(Tag.SS_QMSTAT, MASTER, entry=entry))
    srv._on_qmstat(msg(Tag.SS_QMSTAT, 6, table={MASTER: entry},
                       origin=6, t0=time.monotonic()))
    assert MASTER not in srv.peers


def test_relay_consumed_at_its_homes_death_is_counted_lost():
    """A fused relay whose payload went out toward a requester's home
    server when that server died is consumed, at most once, as in the
    JAX package, and now also counted, in ``failover_relays_unresolved``
    (``InfoKey.FAILOVER_RELAYS_UNRESOLVED``): the dead home may never have
    forwarded it, so it was delivered or lost, and a conservation check
    counts it as possibly lost (the ported soak's seed 1025 under load
    lost one unit with a count of 0). ``failover_lost`` keeps the JAX
    package's meaning and does not count it."""
    from adlb_tpu_torch.runtime.messages import msg

    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    fabric = InProcFabric(5)
    srv = Server(world, Config(device="cpu", on_server_failure="failover"),
                 fabric.endpoint(4))
    srv._handle(msg(Tag.FA_PUT, 0, payload=b"relay", work_type=T, prio=0,
                    target_rank=-1, answer_rank=-1, common_len=0,
                    common_server=-1, common_seqno=-1))
    # app rank 1's home is server 3: the payload rides the RFR response
    srv._handle(msg(Tag.SS_RFR, 3, for_rank=1, rqseqno=1, req_types=[T],
                    targeted_lookup=False, lookup_type=-1, fetch=1))
    assert len(srv._relay_inflight) == 1
    srv._server_eof_at[3] = time.monotonic()
    srv._server_tail_drained.add(3)
    srv._handle(msg(Tag.SS_SERVER_DEAD, 2, rank=3, epoch=1))
    assert not list(srv.wq.units())
    assert srv.metrics.value("failover_relays_unresolved") == 1.0
    assert srv.metrics.value("failover_lost") == 0.0
    stats = srv.finalize_stats()
    assert stats[int(InfoKey.FAILOVER_RELAYS_UNRESOLVED)] == 1.0
    assert stats[int(InfoKey.FAILOVER_LOST)] == 0.0


def test_migrated_units_reach_the_buddy_before_the_ack():
    """A server that receives migrated units replicates them to its buddy
    before it acks the source: the ack makes the source forget them, so
    a death between the two frames lost them with no count (the ported
    soak's seed 1362 on the card: one unit missing, ``failover_lost``
    0)."""
    from adlb_tpu_torch.runtime.messages import msg

    srv = _failover_server(MASTER)
    unit = dict(work_type=T, prio=0, answer_rank=-1, payload=b"u",
                home_server=6, common_len=0, common_server=-1,
                common_seqno=-1, time_stamp=0.0)
    srv._on_migrate_work(msg(Tag.SS_MIGRATE_WORK, 6, units=[unit],
                             mig_id=1, mig_tok=1))
    assert srv.ep.sent[:2] == [(DEPUTY, Tag.SS_REPL),
                               (6, Tag.SS_MIGRATE_ACK)], srv.ep.sent


def test_reconnect_to_a_dead_peer_takes_the_short_grace(monkeypatch):
    """A stream to a peer that was up breaks: the one reconnect attempt
    takes ``UP_PEER_GRACE``, not the 15 s start-up grace, so a server
    whose snapshot stream to a dead master broke does not stall its
    reactor for 15 s."""
    from adlb_tpu_torch.runtime.messages import msg
    from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    a = TcpEndpoint(0, {0: ("127.0.0.1", 0)})
    b = TcpEndpoint(1, {1: ("127.0.0.1", 0)})
    a.addr_map.update(b.addr_map)
    graces = []
    connect = TcpEndpoint._connect

    def connect_(self, dest, grace=15.0):
        graces.append(grace)
        return connect(self, dest, grace)

    monkeypatch.setattr(TcpEndpoint, "_connect", connect_)
    try:
        a.send(1, msg(Tag.SS_PERIODIC_STATS, 0, token={"seq": 1}))
        assert b.recv(timeout=5.0).token == {"seq": 1}
        a._out[1].close()  # the stream breaks under the next send
        a.send(1, msg(Tag.SS_PERIODIC_STATS, 0, token={"seq": 2}))
        m = b.recv(timeout=5.0)
        while m.tag is Tag.PEER_EOF:  # the broken stream's end
            m = b.recv(timeout=5.0)
        assert m.token == {"seq": 2}
    finally:
        a.close()
        b.close()
    assert graces == [15.0, UP_PEER_GRACE]


def _blocking_round(patch, raise_when):
    """Patch PlanEngine.round: on the balancer thread of the server that
    ``raise_when(server)`` picks, the round raises (waiting up to 10 s for
    that server to become the one picked)."""
    orig = engine_mod.PlanEngine.round
    fired = []

    def round_(engine, snaps, world):
        s = getattr(threading.current_thread(), "server", None)
        if s is not None and not fired and s.rank == MASTER:
            deadline = time.monotonic() + 10
            while not raise_when(s) and time.monotonic() < deadline:
                time.sleep(0.002)
            if raise_when(s):
                fired.append(s.rank)
                raise RuntimeError("injected planning failure")
        return orig(engine, snaps, world)

    patch.setattr(engine_mod.PlanEngine, "round", round_)
    return fired


def test_casualty_straggler_round_does_not_abort(monkeypatch):
    """The master's planner is inside a round when failover writes the
    master off; the round then fails. The deputy is saving the world, so
    the casualty's error must not end it."""
    fired = _blocking_round(monkeypatch, lambda s: s.died)
    res = run_world(4, 3, [T], _coverage_economy, cfg=_cfg("tpu", 0),
                    timeout=120.0)
    assert fired == [MASTER]
    _assert_coverage(res, expect_casualty=MASTER)
    assert res.planner[DEPUTY]["device_solves"] > 0


def test_live_master_planner_error_aborts(monkeypatch):
    fired = _blocking_round(monkeypatch, lambda s: True)
    with pytest.raises(RuntimeError, match="balancer failed"):
        run_world(4, 3, [T], _coverage_economy,
                  cfg=Config(balancer="tpu", device="cpu",
                             solver_host_threshold=0,
                             exhaust_check_interval=0.2), timeout=60.0)
    assert fired == [MASTER]


@pytest.mark.parametrize("where", ["build", "solve"])
def test_deputy_planner_failure_ends_the_world(where, monkeypatch):
    """The promoted deputy's PlanEngine fails to build, or its solve
    raises: the world ends through balancer_error, as for the first
    master; the deputy never carries on without a planner or on numpy.
    Rank 0 keeps the world's backlog until the deputy's planner has
    failed (``_until_planned_economy``)."""
    planned = threading.Event()

    def on_deputy():
        s = getattr(threading.current_thread(), "server", None)
        if s is not None and s.rank == DEPUTY:
            planned.set()
            raise RuntimeError(f"injected {where} failure")

    if where == "build":
        init = engine_mod.PlanEngine.__init__

        def init_(self, *a, **kw):
            on_deputy()
            init(self, *a, **kw)

        monkeypatch.setattr(engine_mod.PlanEngine, "__init__", init_)
    else:
        dsolve = solve.AssignmentSolver._device_solve

        def dsolve_(self, *arrays):
            on_deputy()
            return dsolve(self, *arrays)

        monkeypatch.setattr(solve.AssignmentSolver, "_device_solve", dsolve_)
    host = solve.solve_counts["host"]
    with pytest.raises(RuntimeError, match=f"injected {where} failure"):
        run_world(4, 3, [T], lambda ctx: _until_planned_economy(ctx, planned),
                  cfg=_cfg("tpu", 0, put_routing="home"), timeout=120.0)
    assert solve.solve_counts["host"] == host


def test_planner_counts_exact_under_two_planner_threads(monkeypatch):
    """Two solvers solve at once (a dead master's straggler round beside
    its deputy's): each keeps its own first solve for the check, and the
    process counts both solves and both checks."""
    import numpy as np

    barrier = threading.Barrier(2, timeout=10)
    plain = greedy_sweep.greedy_assign_torch

    def overlapping(*ins):
        barrier.wait()  # both solves are inside _device_solve here
        return plain(*ins)

    monkeypatch.setattr(greedy_sweep, "greedy_assign_torch", overlapping)
    monkeypatch.setattr(solve, "check_every", 2)
    solve.reset_counts()
    solvers = [solve.AssignmentSolver(types=(1, 2), max_tasks=4,
                                      max_requesters=2, device="cpu")
               for _ in range(2)]
    rng = np.random.default_rng(0)
    arrays = (rng.integers(0, 9, 8).astype(np.int32),
              rng.integers(0, 2, 8).astype(np.int32),
              np.ones((4, 2), bool), np.ones(4, bool))
    threads = [threading.Thread(target=s._device_solve, args=arrays)
               for s in solvers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    counts = solve.planner_counts()
    assert counts["device_solves"] == 2
    assert counts["solves_checked"] == 2 and counts["solves_wrong"] == 0
    for s in solvers:
        c = s.planner_counts()
        assert (c["device_solves"], c["solves_kept"], c["solves_checked"]) \
            == (1, 1, 1)


def test_relays_resolved_again_when_their_holder_dies(monkeypatch):
    """The master relays units to requesters homed on other servers
    (remote fused fetch) and consumes each on its SS_DELIVERED, but those
    consumes never reach its buddy's mirror, as when the replication tail
    dies with the master. The deputy adopts the units pinned for ranks
    that already ran them. The requesters' home servers send their
    resolutions again when they learn of the death, so the deputy
    consumes the units and the world ends with every unit run."""
    import functools

    napps, master = 8, 8
    lagged = []
    delivered = Server._on_delivered

    def consume_unreplicated(self, m):
        if self.rank != master or self.died:
            return delivered(self, m)
        lagged.append(m.seqno)
        wlog, self.wlog = self.wlog, None
        try:
            return delivered(self, m)
        finally:
            self.wlog = wlog

    monkeypatch.setattr(Server, "_on_delivered", consume_unreplicated)
    cfg = _cfg("tpu", 0, put_routing="home")
    cfg.fault_spec = {"seed": 5, "disconnect_server_at": {0: 600}}
    res = run_world(napps, 4, [T], functools.partial(
        _coverage_economy, nunits=1000, work_s=0.01), cfg=cfg, timeout=60.0)
    assert lagged  # the master relayed before it died
    _assert_coverage(res, expect_casualty=master, nunits=1000)
    done = [x for v in res.app_results.values() for x in v]
    assert set(done) == set(range(1000))


def test_disconnected_server_with_nothing_to_send_exits():
    """A server whose injected disconnect surfaced on a send whose error
    was absorbed, and which has nothing more to send, learns of its own
    death at its next periodic tick and exits as the failover casualty,
    so its world can end."""
    from types import SimpleNamespace

    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    ep = InProcFabric(5).endpoint(3)
    ep.plan = SimpleNamespace(disconnected=True)
    srv = Server(world, Config(device="cpu", on_server_failure="failover"),
                 ep)
    loop = threading.Thread(target=srv._run_loop, daemon=True)
    loop.start()
    loop.join(timeout=10)
    assert not loop.is_alive()
    assert srv.died and srv.done


# --------------------------------- what a SIGKILLed planner leaves behind


class _Killed(Exception):
    pass


@pytest.mark.parametrize("planned", [True, False])
def test_an_injected_kill_logs_the_servers_planner_counts(planned, tmp_path,
                                                          monkeypatch):
    """A server behind a fault-injecting endpoint hands its plan a state
    callable; the injected kill writes its planner's counts (None when it
    never planned) to the rank's fault log before the process dies, since
    a SIGKILLed rank sends no ``WorldResult.planner`` entry."""
    import json
    import os

    from adlb_tpu_torch.runtime import faults

    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    plan = faults.FaultPlan({"seed": 3, "kill_at_frame": {2: 1},
                             "log_dir": str(tmp_path)}, 2)
    ep = faults.FaultyEndpoint(InProcFabric(5).endpoint(2), plan)
    srv = Server(world, Config(device="cpu", on_server_failure="failover"),
                 ep)
    assert plan.state == srv._state_at_kill
    if planned:
        srv._solver = solve.AssignmentSolver(types=(T,), max_tasks=8,
                                             max_requesters=8, device="cpu")
        srv._solver.device_solve_count = 3
    monkeypatch.setattr(os, "kill", lambda pid, sig: None)

    def exit_(code):
        raise _Killed(code)

    monkeypatch.setattr(os, "_exit", exit_)
    with pytest.raises(_Killed):
        ep.send(3, Msg(tag=Tag.SS_REPL, src=2))
    doc = json.loads((tmp_path / "faults-rank2.json").read_text())
    assert doc["events"][0][1] == faults.KILL
    got = doc["state"]["planner"]
    if planned:
        assert got["device_solves"] == 3 and got["host_solves"] == 0
    else:
        assert got is None


def test_a_plain_endpoint_gets_no_kill_state():
    world = WorldSpec(nranks=5, nservers=3, types=(T,))
    srv = Server(world, Config(device="cpu"), InProcFabric(5).endpoint(2))
    assert srv._state_at_kill() == {"planner": None}
