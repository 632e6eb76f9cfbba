"""Process worlds of the port (``spawn_world``: one OS process per rank)
against the JAX package's, with Python servers and the planned balancer.

* Over TCP, over the shared-memory ring fabric and over the multiplexed
  channel plane (``tcp_mux``), the same master/worker app consumes every
  unit exactly once and returns the JAX package's answer, and the master's
  planner (a child process) runs device-route solves (the plain torch
  version on ``device="cpu"``), reported back in ``WorldResult.planner``.
* The start without fork (``"spawn"``) runs the nq workload to its known
  answer. A world whose master would plan on the card never forks: its
  default start is ``"spawn"`` and an explicit ``"fork"`` raises before any
  process starts.
* A master whose planning fails ends the world with an error.
* A rank that closes its channel to the broker (``tcp_mux``) while frames
  to it are still in flight loses none of its own last frames.

The JAX package's worlds start their ranks with ``"spawn"`` here: its
master plans with JAX, and a child forked from a test process whose XLA
runtime threads are running can deadlock in XLA's own locks.
"""

import functools
import multiprocessing
import queue
import threading
import time

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu_torch.balancer import greedy_sweep
from adlb_tpu_torch.runtime.transport_tcp import resolve_start_method, spawn_world
from adlb_tpu_torch.runtime.world import Config
from adlb_tpu_torch.workloads import nq

TYPES = (1, 2, 3, 4)
ANSWER = 9
GO = 10
NUNITS = 160
NAPPS = 6


def _value(i):
    return (i * 7919) % 1000003


def master_worker(ctx):
    """Rank 0 puts NUNITS typed, prioritised units at its home server and
    sums the answers; workers reserve and get until the world ends.

    Only a plan can feed a worker homed at another server than rank 0's,
    so the workers that share rank 0's home wait for a ``GO`` unit, which
    each other worker puts to them once it has been fed: every unit stays
    queued until the planner has solved, however fast the world runs."""
    success = 1  # ADLB_SUCCESS in both packages
    home0 = ctx.world.home_server(0)
    local = [r for r in range(1, NAPPS) if ctx.world.home_server(r) == home0]
    if ctx.rank in local:
        rc, r = ctx.reserve([GO])
        if rc != success:
            return []
        ctx.get_reserved(r.handle)
    if ctx.rank == 0:
        for i in range(NUNITS):
            ctx.put(i.to_bytes(4, "little"), TYPES[i % 4],
                    work_prio=(i * 31) % 97)
        total = 0
        for _ in range(NUNITS):
            rc, r = ctx.reserve([ANSWER])
            assert rc == success
            rc, buf = ctx.get_reserved(r.handle)
            total += int.from_bytes(buf, "little")
        ctx.set_problem_done()
        return total
    seen = []
    while True:
        rc, r = ctx.reserve(list(TYPES))
        if rc != success:
            return seen
        rc, buf = ctx.get_reserved(r.handle)
        if rc != success:
            return seen
        i = int.from_bytes(buf, "little")
        if not seen and ctx.rank not in local:
            for r in local:
                ctx.put(b"go", GO, target_rank=r)
        seen.append(i)
        ctx.put(_value(i).to_bytes(8, "little"), ANSWER, target_rank=0)


def _planned(cls, **kw):
    return cls(balancer="tpu", solver_host_threshold=0, put_routing="home",
               balancer_max_tasks=32, balancer_max_requesters=8,
               exhaust_check_interval=0.2, **kw)


def _check(res):
    assert not res.aborted
    consumed = sorted(i for r in range(1, NAPPS) for i in res.app_results[r])
    assert consumed == list(range(NUNITS))  # each unit exactly once
    return res.app_results[0]


FABRICS = {"tcp": dict(fabric="tcp"), "shm": dict(fabric="shm"),
           "tcp_mux": dict(fabric="tcp", tcp_mux="on")}


@pytest.fixture(scope="module")
def reference_total():
    """The JAX package's process world on the same app (TCP)."""
    from adlb_tpu.runtime.transport_tcp import spawn_world as ref_spawn
    from adlb_tpu.runtime.world import Config as RefConfig

    ref = ref_spawn(NAPPS, 2, TYPES + (ANSWER, GO), master_worker,
                    cfg=_planned(RefConfig, fabric="tcp"), timeout=120.0,
                    start_method="spawn")
    return _check(ref)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_process_world_matches_reference(fabric, reference_total):
    if fabric == "shm":
        from adlb_tpu_torch.runtime.transport_shm import shm_available

        if not shm_available():
            pytest.skip("host cannot run the shared-memory fabric")
    port = spawn_world(NAPPS, 2, TYPES + (ANSWER, GO), master_worker,
                       cfg=_planned(Config, device="cpu", **FABRICS[fabric]),
                       timeout=90.0)
    assert _check(port) == reference_total == sum(map(_value, range(NUNITS)))
    master = NAPPS  # the first server rank
    counts = port.planner[master]
    assert list(port.planner) == [master]
    assert counts["device_solves"] > 0 and counts["host_solves"] == 0
    assert counts["greedy_sweep_launches"] == 0  # CPU: the plain version
    assert counts["rounds"] >= counts["device_solves"]
    assert counts["round_s"] > 0


def test_spawn_start_runs_nq_to_its_known_answer(monkeypatch):
    """The spawned master also holds every one of its device solves against
    the numpy twin (``ADLB_CHECK_SOLVES=1`` in its environment) and reports
    the tally back."""
    from adlb_tpu.runtime.transport_tcp import spawn_world as ref_spawn
    from adlb_tpu.runtime.world import Config as RefConfig
    from adlb_tpu.workloads import nq as ref_nq

    monkeypatch.setenv("ADLB_CHECK_SOLVES", "1")
    cfg = dict(balancer="tpu", solver_host_threshold=0,
               exhaust_check_interval=0.2)
    port = spawn_world(3, 2, [nq.WORK],
                       functools.partial(nq.app_main, n=6,
                                         max_depth_for_puts=2),
                       cfg=Config(device="cpu", **cfg), timeout=90.0,
                       start_method="spawn")
    ref = ref_spawn(3, 2, [ref_nq.WORK],
                    functools.partial(ref_nq.app_main, n=6,
                                      max_depth_for_puts=2),
                    cfg=RefConfig(**cfg), timeout=120.0, start_method="spawn")
    total = sum(s for s, _, _ in port.app_results.values())
    assert total == sum(s for s, _, _ in ref.app_results.values()) \
        == nq.KNOWN_SOLUTIONS[6]
    counts = port.planner[3]
    assert counts["device_solves"] > 0
    assert counts["solves_checked"] == counts["device_solves"]
    assert counts["solves_wrong"] == 0


def test_card_planner_never_forks(monkeypatch):
    """A Python-server world with balancer="tpu", device="cuda" starts its
    ranks with "spawn"; "fork" raises before any process starts, and never
    degrades to the CPU. Worlds that do not plan on the card still fork."""
    assert resolve_start_method(Config(), None) == "fork"
    assert resolve_start_method(_planned(Config, device="cpu"), None) == "fork"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = _planned(Config, device="cuda")
    assert resolve_start_method(cfg, None) == "spawn"
    assert resolve_start_method(cfg, "forkserver") == "forkserver"
    native = _planned(Config, device="cuda", server_impl="native")
    assert resolve_start_method(native, None) == "fork"  # sidecar in parent

    def no_build():
        raise AssertionError("built a kernel before refusing the world")

    monkeypatch.setattr(greedy_sweep, "build", no_build)
    before = multiprocessing.active_children()
    with pytest.raises(ValueError, match="fork.*card"):
        spawn_world(NAPPS, 2, TYPES + (ANSWER, GO), master_worker, cfg=cfg,
                    start_method="fork", timeout=30.0)
    assert multiprocessing.active_children() == before


def test_master_planning_failure_ends_the_world(monkeypatch):
    def broken(*args):
        raise RuntimeError("injected device failure")

    # the forked master inherits the broken plain version
    monkeypatch.setattr(greedy_sweep, "greedy_assign_torch", broken)
    with pytest.raises(RuntimeError, match="balancer failed"):
        spawn_world(NAPPS, 2, TYPES + (ANSWER, GO), master_worker,
                    cfg=_planned(Config, device="cpu", fabric="tcp"),
                    timeout=60.0, start_method="fork")


class _ChannelEnd:
    """The part of an endpoint a ChannelClient delivers into."""

    def __init__(self, rank):
        self.rank, self.inbox, self._closed, self.notify = \
            rank, queue.Queue(), False, None
        self.bodies = []

    def _deliver_body(self, body, learn_binary=False):
        self.bodies.append(bytes(body))


def test_channel_close_delivers_the_last_frame():
    """Rank 0 sends a burst ending in one last frame and closes its channel
    while rank 1 floods it. Closing a socket with unread bytes sends a
    reset, which can discard what the broker has not read yet: a rank's
    FA_LOCAL_APP_DONE was lost so and the servers waited forever."""
    from adlb_tpu_torch.runtime.channel import ChannelBroker, ChannelClient
    from adlb_tpu_torch.runtime.transport_tcp import _data_envelope

    filler = b"x" * 4000

    def env(src, dst, body):
        return _data_envelope(src, dst, [body], len(body), 0)[0]

    for _ in range(5):
        broker = ChannelBroker()
        ends = [_ChannelEnd(0), _ChannelEnd(1)]
        a, b = (ChannelClient(e, broker.addr) for e in ends)
        flood = threading.Thread(target=lambda: [
            b.send_batch([env(1, 0, filler)]) for _ in range(300)])
        flood.start()
        a.send_batch([env(0, 1, filler)] * 200 + [env(0, 1, b"LAST")])
        a.close()
        assert not a._reader.is_alive()  # closed after the broker's EOF
        flood.join(timeout=30)
        deadline = time.monotonic() + 10
        while b"LAST" not in ends[1].bodies and time.monotonic() < deadline:
            time.sleep(0.01)
        b.close()
        broker.close()
        assert b"LAST" in ends[1].bodies
