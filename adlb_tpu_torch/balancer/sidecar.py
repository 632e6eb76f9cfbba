"""Balancer sidecar: the Python planning brain driving the native C++ data plane.

SURVEY §7's language split realized end-to-end: native servers
(``adlb_tpu_torch/native/serverd.cpp``) keep the entire data plane — queues,
protocol, payloads — and stream fixed-shape queue-state snapshots
(``SS_STATE``: flattened task/requester metadata, a few KB) to this
process, which runs the batched assignment solve (:mod:`.engine` /
:mod:`.solve`, the greedy-sweep kernel on ``Config.device``) and answers
with ``SS_PLAN_MATCH`` / ``SS_PLAN_MIGRATE``. Payload bytes never cross
into Python — exactly the "balancer brain in a sidecar exchanging
fixed-shape arrays" design.

The sidecar occupies a pseudo-rank one past the world (it is not an app or
a server; no role math changes), speaks the binary TLV codec toward
servers, and exits when every server has sent DS_END (or on abort).

A failed planning round ends the world: in tpu mode the sidecar is the
only cross-server matching mechanism, and planning on numpy instead would
hide a kernel that fails to build or launch. The thread records the error
(:attr:`SidecarThread.error`), sets the abort event when the harness gave
one, and the harness raises it (:func:`raise_if_failed`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from adlb_tpu_torch.runtime.messages import Tag, msg


def start_sidecar(world, cfg, abort_event=None, host: str = "127.0.0.1"):
    """Bind the sidecar's endpoint at pseudo-rank ``world.nranks`` and build
    its (not-yet-started) thread. Returns (endpoint, thread): add the
    endpoint's port to the world's address map, update ``ep.addr_map``,
    then ``thread.start()``. Use :func:`stop_sidecar` to tear down — also
    on bootstrap failure, or the thread/endpoint leak. Pass the host other
    machines reach this one at for multi-host worlds (servers on other
    hosts must stream snapshots here).

    On ``device="cuda"`` the greedy-sweep kernel is built here, and the
    context opened on every card the planner will plan over (with
    ``balancer_mesh="auto"`` the sharded planner's placement, one shard per
    card, whose kernels are built here too), before the world starts, so no
    planning round waits on the compiler or on CUDA's start-up: a small
    world's first consumers drain their home server in well under the
    second the first solve on a cold card took."""
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    if cfg.balancer == "tpu" and cfg.device == "cuda":
        import torch

        from adlb_tpu_torch.balancer import auction, candidates, greedy_sweep
        from adlb_tpu_torch.balancer.engine import shard_placement
        from adlb_tpu_torch.balancer.solve import check_device

        greedy_sweep.build()
        cards = [check_device(cfg.device)]
        if cfg.balancer_mesh == "auto":
            placement, _ = shard_placement(
                cfg.device, torch.cuda.device_count(), world.nservers)
            if placement is not None:
                candidates.build()
                auction.build()
                cards = placement
        for card in cards:
            torch.zeros(1, device=card)  # the context
    ep = TcpEndpoint(
        world.nranks, {world.nranks: (host, 0)},
        binary_peers=set(world.server_ranks),
    )
    return ep, SidecarThread(world, cfg, ep, abort_event)


class SidecarThread(threading.Thread):
    """The sidecar's serve loop (:func:`run_sidecar`) on a daemon thread.
    ``error`` holds the exception that ended the loop (None after a clean
    exit); ``metrics`` is the sidecar's registry."""

    def __init__(self, world, cfg, ep, abort_event=None) -> None:
        from adlb_tpu_torch.balancer.solve import planner_counts
        from adlb_tpu_torch.obs.metrics import Registry

        super().__init__(daemon=True, name="adlb-balancer-sidecar")
        self.world, self.cfg, self.ep = world, cfg, ep
        self.abort_event = abort_event
        self.error: Optional[BaseException] = None
        self.metrics = Registry(rank=world.nranks)
        self._before = planner_counts()

    def run(self) -> None:
        try:
            run_sidecar(self.world, self.cfg, self.ep, self.abort_event,
                        self.metrics)
        except Exception as e:  # noqa: BLE001 — the harness raises it
            self.error = e
            if self.abort_event is not None:
                self.abort_event.set()

    def planner(self) -> dict:
        """The sidecar's solves, kernel launches, checked solves and
        rounds since it was built (see ``solve.planner_since``): the
        harness's ``WorldResult.planner`` entry for its pseudo-rank."""
        from adlb_tpu_torch.balancer.solve import planner_since

        return planner_since(self._before, self.metrics)


def raise_if_failed(thread) -> None:
    """Raise the sidecar's planning failure in the harness's thread."""
    if thread is not None and thread.error is not None:
        raise RuntimeError(
            f"balancer sidecar failed: {thread.error!r}") from thread.error


def stop_sidecar(ep, thread, abort_event=None, timeout: float = 10.0) -> None:
    """Join (the loop exits on the servers' DS_ENDs, or on abort_event) and
    close the endpoint."""
    if thread.is_alive():
        thread.join(timeout=timeout)
        if thread.is_alive() and abort_event is not None:
            abort_event.set()
            thread.join(timeout=2.0)
    ep.close()


def decode_snapshot(m) -> dict:
    """Unflatten a native SS_STATE frame into the engine's snapshot shape."""
    tf = m.data.get("tasks_flat") or []
    tasks = [
        (tf[i], tf[i + 1], tf[i + 2], tf[i + 3]) for i in range(0, len(tf), 4)
    ]
    rf = m.data.get("reqs_flat") or []
    reqs = []
    i = 0
    while i < len(rf):
        rank, rqseqno, ntypes = rf[i], rf[i + 1], rf[i + 2]
        i += 3
        if ntypes < 0:
            types = None
        else:
            types = [int(t) for t in rf[i:i + ntypes]]
            i += ntypes
        reqs.append((rank, rqseqno, types))
    return {
        "tasks": tasks,
        "reqs": reqs,
        "nbytes": m.data.get("nbytes", 0),
        "consumers": m.data.get("consumers", 0),
        "stamp": time.monotonic(),  # receiver clock: never mix hosts' clocks
        # flattened (src, highest id) pairs; absent on pre-ack daemons ->
        # engine falls back to stamp clearing
        "mig_acks": (
            {ma[i]: ma[i + 1] for i in range(0, len(ma), 2)}
            if (ma := m.data.get("mig_acks")) is not None else None
        ),
    }


def run_sidecar(world, cfg, ep, abort_event=None, metrics=None) -> int:
    """Serve balancer rounds until every server says DS_END; returns the
    number of planning rounds executed. A failed round raises."""
    from adlb_tpu_torch.balancer.engine import PlanEngine, round_gap
    from adlb_tpu_torch.obs.metrics import Registry, attach

    # the sidecar is its own process/thread: it owns its registry (round
    # duration, plan ages, pairs) and instruments its endpoint's per-tag
    # traffic like any server
    if metrics is None:
        metrics = Registry(rank=world.nranks)
    attach(ep, metrics)
    engine = PlanEngine(
        types=world.types,
        metrics=metrics,
        max_tasks=cfg.balancer_max_tasks,
        max_requesters=cfg.balancer_max_requesters,
        backend=cfg.solver_backend,
        max_malloc_per_server=cfg.max_malloc_per_server,
        use_mesh=cfg.balancer_mesh == "auto",
        nservers=world.nservers,
        host_threshold_reqs=cfg.solver_host_threshold,
        lookahead=cfg.balancer_lookahead,
        look_max=cfg.balancer_look_max,
        grow_window=cfg.balancer_grow_window,
        inflow_ttl=cfg.balancer_inflow_ttl,
        inflow_min_age=cfg.balancer_inflow_min_age,
        host_ledger=cfg.host_ledger,
        auction=cfg.balancer_auction,
        device=cfg.device,
        # job axis: the native plane advertises only the default
        # namespace today (4-wide flat tasks), but the engine kwargs
        # stay in lockstep with the in-server master so a multi-job
        # config plans identically on either plane
        max_jobs=cfg.balancer_max_jobs,
        job_weights=cfg.job_weights,
    )
    # versioned snapshot table (balancer/ledger.py): the ledger's sync
    # touches only ranks whose snapshots changed since the last round.
    # The sidecar loop is single-threaded, so the engine reads the live
    # store (no fork needed); in-place merges below bump() it.
    from adlb_tpu_torch.balancer.ledger import SnapshotStore

    snapshots: SnapshotStore = SnapshotStore()
    ended: set[int] = set()
    servers = set(world.server_ranks)
    rounds = 0
    dirty = False
    # one state machine shared with the in-server master: growth
    # broadcasts immediately, shrinks held for grace (see hungry.py)
    from adlb_tpu_torch.balancer.hungry import HungryTracker

    tracker = HungryTracker()
    me = world.nranks  # pseudo-rank
    failure: Optional[Exception] = None

    def safe_send(dest: int, m) -> None:
        """Send, treating an unreachable server as ended.

        At end-of-world a server can close its listener between sending
        DS_END and the sidecar draining its inbox (or while a broadcast
        is mid-flight); connection refusal there is the normal teardown
        race, not an error — marking the rank ended lets the loop drain
        out instead of dying with an unhandled thread exception.
        connect_grace is short because every peer here snapshots only
        AFTER binding its listener, so a refusal never means "still
        coming up" — without it each dead destination would stall the
        loop for the transport's 15 s startup grace. A rank wrongly
        ended by a transient error is resurrected by its next
        SS_STATE."""
        try:
            ep.send(dest, m, connect_grace=0.25)
        except OSError:
            ended.add(dest)
            snapshots.pop(dest, None)
            tracker.drop(dest)

    def broadcast(payload) -> None:
        if payload is None:
            return
        is_hungry, req_types, grew = payload
        for s in sorted(servers - ended):
            safe_send(
                s,
                msg(Tag.SS_HUNGRY, me, hungry=int(is_hungry),
                    req_types=req_types, grew=int(grew)),
            )

    try:
        while ended < servers:
            if abort_event is not None and abort_event.is_set():
                break
            m = ep.recv(timeout=0.25)
            while m is not None:
                if m.tag is Tag.SS_STATE:
                    # a fresh snapshot proves the server is alive: resurrect
                    # it if a transient send error wrongly marked it ended
                    # (DS_END is final — an ended-by-DS_END server never
                    # snapshots again, so this cannot resurrect those)
                    ended.discard(m.src)
                    snapshots[m.src] = decode_snapshot(m)
                    broadcast(tracker.update(m.src, snapshots[m.src]["reqs"]))
                    dirty = True
                elif m.tag is Tag.SS_STATE_DELTA:
                    # put-event: append task(s) to the sender's last full
                    # snapshot (stamp unchanged — requester re-eligibility only
                    # comes from full snapshots; see the server's merge).
                    # Batched shape (parallel lists) since round 4; the
                    # single-unit shape is kept for older daemons.
                    snap = snapshots.get(m.src)
                    if snap is not None:
                        if m.data.get("seqnos") is not None:
                            # "jobs" (field 106) rides only when some
                            # unit is non-default; absent -> all job 0
                            jbs = m.data.get("jobs") or [0] * len(m.seqnos)
                            units = zip(m.seqnos, m.work_types, m.prios,
                                        m.work_lens, jbs)
                        else:
                            units = [(m.seqno, m.work_type, m.prio,
                                      m.work_len, 0)]
                        for sq, wt, pr, ln, jb in units:
                            if len(snap["tasks"]) >= cfg.balancer_max_tasks:
                                break
                            if jb:
                                if not 0 <= jb < cfg.balancer_max_jobs:
                                    continue  # overflow namespace
                                snap["tasks"].append((sq, wt, pr, ln, jb))
                            else:
                                snap["tasks"].append((sq, wt, pr, ln))
                        snap["nbytes"] = m.data.get("nbytes", snap["nbytes"])
                        # in-place append with no stamp bump: the delta
                        # sequence is the change signal the resident
                        # ledgers/solver fast paths key on (the server's
                        # _merge_task_delta has always bumped it; the
                        # sidecar merge was the one spot that didn't)
                        snap["delta_seq"] = snap.get("delta_seq", 0) + 1
                        snapshots.bump(m.src)  # in-place append
                        dirty = True
                elif m.tag is Tag.DS_END:
                    ended.add(m.src)
                    snapshots.pop(m.src, None)
                    tracker.drop(m.src)
                elif m.tag is Tag.SS_SERVER_DEAD:
                    # defensive only: TODAY this never fires — the sidecar
                    # plane drives NATIVE daemons, which Config rejects for
                    # on_server_failure="failover", and the Python-plane
                    # fan-out targets only world server ranks. Kept so a
                    # future native failover protocol that does relay the
                    # fan-out retires the dead server's snapshot/tracker
                    # state (like a DS_END) instead of planning onto it.
                    dead_srv = m.rank
                    snapshots.pop(dead_srv, None)
                    tracker.drop(dead_srv)
                    ended.add(dead_srv)
                    dirty = True
                elif m.tag is Tag.SS_RANK_DEAD:
                    # a worker died under on_worker_failure="reclaim":
                    # retire its parked requests from every held snapshot
                    # so the next plan stops matching/migrating toward it
                    # (stale entries would only cost an UNRESERVE bounce,
                    # but the dead rank must not keep attracting work).
                    # Forward-compat: today reclaim requires python
                    # servers (whose master patches its own snapshots),
                    # so this only fires if a future native plane or an
                    # operator tool relays the death here.
                    dead = m.rank
                    for src, snap in snapshots.items():
                        kept = [r for r in snap["reqs"] if r[0] != dead]
                        if len(kept) != len(snap["reqs"]):
                            snap["reqs"] = kept
                            snapshots.bump(src)  # in-place patch
                            dirty = True
                            broadcast(tracker.update(src, kept))
                m = ep.recv(timeout=0.0)
            broadcast(tracker.flush(time.monotonic()))
            if not dirty or not snapshots:
                continue
            dirty = False
            try:
                matches, migrations = engine.round(snapshots, world)
            except Exception as e:  # noqa: BLE001 — recorded, then raised
                failure = e
                raise
            rounds += 1
            for holder, seqno, req_home, for_rank, rqseqno in matches:
                if holder in ended:  # died earlier in this very plan loop
                    continue
                safe_send(
                    holder,
                    msg(Tag.SS_PLAN_MATCH, me, seqno=seqno, for_rank=for_rank,
                        req_home=req_home, rqseqno=rqseqno),
                )
            for src_rank, dest, seqnos, mig_id in migrations:
                if src_rank in ended or dest in ended:
                    continue
                safe_send(
                    src_rank,
                    msg(Tag.SS_PLAN_MIGRATE, me, dest=dest, seqnos=seqnos,
                        mig_id=mig_id),
                )
            if cfg.balancer_min_gap > 0:
                # shared cadence with the in-proc _BalancerWorker
                time.sleep(round_gap(cfg.balancer_min_gap, matches, migrations))
    finally:
        # the registry's round/plan-age/traffic numbers become reachable
        # as a flight artifact when the world opted in — written in a
        # finally so a serve-loop crash (the one case a post-mortem is
        # FOR) still leaves one; the sidecar is the one balancer brain a
        # server post-mortem cannot see into otherwise
        from adlb_tpu_torch.obs.flight import write_artifact

        write_artifact(
            cfg.flight_dir,
            "sidecar",
            {
                "role": "sidecar",
                "rank": me,
                "reason": "failed" if failure is not None else (
                    "aborted" if (abort_event is not None
                                  and abort_event.is_set()) else "exit"),
                "error": repr(failure) if failure is not None else None,
                "rounds": rounds,
                "metrics": metrics.snapshot(),
            },
        )
    return rounds
