"""Server reactor.

Equivalent of the reference's ~2,100-line single-threaded server event loop
(``ADLBP_Server``, reference ``src/adlb.c:382-2506``): poll the transport,
dispatch by tag, run periodic duties (state sync, push-trigger, exhaustion
check, watchdog logging). Re-architected around indexed queues
(:mod:`adlb_tpu_torch.runtime.queues`) and two interchangeable cross-server
balancing strategies:

* **steal** — faithful-in-spirit rebuild of the reference heuristics:
  per-server state broadcast (replacing the 0.1 s qmstat ring pass,
  reference ``src/adlb.c:806-822,1705-1757``), pull-side RFR work stealing
  with stale-state patching and UNRESERVE race compensation (reference
  ``src/adlb.c:1802-2070``), and memory-pressure pushes with PUSH_DEL
  cancellation (reference ``src/adlb.c:509-556,2109-2362``).
* **tpu** — the reference's gossip+greedy matching is replaced by a periodic
  batched global assignment solve: servers stream fixed-shape queue-state
  snapshots to the balancer (the master server), a jitted JAX solve computes
  task->requester placement, and plan entries are enacted through the same
  pin/forward/UNRESERVE discipline so plan staleness is harmless (plan
  entries are hints validated against live state, like the reference's
  PUSH_QUERY_RESP validation, ``src/adlb.c:2182-2192``).

Termination protocols (explicit no-more-work, double-pass exhaustion
detection, held two-phase shutdown) follow the reference's ring-token designs
(reference ``src/adlb.c:754-785,1385-1801``) over the server ring.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from adlb_tpu_torch.obs import profile
from adlb_tpu_torch.obs.flight import FlightRecorder
from adlb_tpu_torch.obs.journey import TAIL_MIN_COUNT, JourneyRecorder, trace_fields
from adlb_tpu_torch.obs.metrics import Registry, attach, quantile_of
from adlb_tpu_torch.runtime.debug import aprintf, self_diagnosis
from adlb_tpu_torch.runtime.hedge import HedgeManager, should_hedge
from adlb_tpu_torch.runtime.messages import Msg, Tag, msg
from adlb_tpu_torch.runtime.trace import PID_SERVER, Tracer
from adlb_tpu_torch.runtime.queues import (
    CommonStore,
    LeaseTable,
    MemoryAccountant,
    PartitionedWorkQueue,
    ReserveQueue,
    RqEntry,
    TargetedDirectory,
    WorkQueue,
    WorkUnit,
)
from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE, Endpoint
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import (
    ADLB_BACKOFF,
    ADLB_DONE_BY_EXHAUSTION,
    ADLB_ERROR,
    ADLB_FENCED,
    ADLB_LOWEST_PRIO,
    ADLB_NO_CURRENT_WORK,
    ADLB_NO_MORE_WORK,
    ADLB_PUT_REJECTED,
    ADLB_RETRY,
    ADLB_SUCCESS,
    AdlbError,
    InfoKey,
    WorkHandle,
)


class _BalancerWorker(threading.Thread):
    """The balancer brain, off the reactor thread.

    The solve's device round-trip (notably over a remote-TPU tunnel, where
    dispatch is milliseconds and first compile is tens of seconds) must never
    block the master's protocol loop, so the master only *updates snapshots*
    and wakes this thread; the thread coalesces to the latest state, solves,
    and sends SS_PLAN_MATCH messages itself (endpoint sends are
    thread-safe). Plan staleness this introduces is already handled by
    enactment-time validation.

    Re-planning storms are suppressed by remembering when each requester/task
    was last planned: both stay ineligible until a *fresh* snapshot (stamp
    newer than the plan) shows them still parked/queued.
    """

    def __init__(self, server: "Server") -> None:
        super().__init__(daemon=True, name=f"adlb-balancer-{server.rank}")
        self.server = server
        self.wake = threading.Event()
        self.stopped = False

    def stop(self) -> None:
        self.stopped = True
        self.wake.set()

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — the world must see it
            self._fail(e)

    def _fail(self, e: Exception) -> None:
        """A planner failure ends the world. In tpu mode the balancer is
        the only cross-server matching mechanism, and planning on numpy
        instead would hide a kernel that fails to build or launch: record
        the error (Server.run raises it) and abort every rank. The one
        exception is a master that failover has written off (``died``):
        its deputy plans now, and the casualty's straggler round must not
        end the world the deputy is saving."""
        s = self.server
        s.flight.record(f"balancer failed: {e!r}")
        if s.died:
            return
        s.balancer_error = e
        if s._abort_event is not None:
            s._abort_event.set()  # the reactor and every client see it
        else:
            s.done = True

    def _run(self) -> None:
        s = self.server
        from adlb_tpu_torch.balancer.engine import PlanEngine

        engine = PlanEngine(
            types=s.world.types,
            max_tasks=s.cfg.balancer_max_tasks,
            max_requesters=s.cfg.balancer_max_requesters,
            backend=s.cfg.solver_backend,
            max_malloc_per_server=s.cfg.max_malloc_per_server,
            use_mesh=s.cfg.balancer_mesh == "auto",
            nservers=s.world.nservers,
            host_threshold_reqs=s.cfg.solver_host_threshold,
            lookahead=s.cfg.balancer_lookahead,
            look_max=s.cfg.balancer_look_max,
            grow_window=s.cfg.balancer_grow_window,
            inflow_ttl=s.cfg.balancer_inflow_ttl,
            inflow_min_age=s.cfg.balancer_inflow_min_age,
            host_ledger=s.cfg.host_ledger,
            auction=s.cfg.balancer_auction,
            metrics=s.metrics,
            max_jobs=s.cfg.balancer_max_jobs,
            job_weights=s.cfg.job_weights,
            device=s.cfg.device,
            tracer=s.tracer,
        )
        s._solver = engine.solver
        s._engine = engine  # weights fan-out (set_job_weights) target
        from adlb_tpu_torch.obs import profile as _profile

        _profile.register_thread("balancer")
        prof = _profile.active()
        # Event-gated loop: sleep on the doorbell (armed by parks, task
        # deltas, qmstat/hungry changes and failover patches) and fall
        # back to a slow insurance tick — an idle world runs ~4 rounds/s
        # instead of spinning through wake/solve cycles, and the sampler
        # attributes waiting to "balancer_idle" so the parity profile's
        # balancer_tick share measures ROUNDS, not thread lifetime.
        idle = s.cfg.balancer_idle_interval
        while True:
            if prof is not None:
                prof.set_phase("balancer_idle")
            self.wake.wait(timeout=idle if idle > 0 else None)
            self.wake.clear()
            if self.stopped or s.done:
                return
            if prof is not None:
                prof.set_phase("balancer_tick")
            gap, produced = self._one_round(engine)
            if prof is not None:
                prof.set_phase("balancer_idle")
            if gap > 0:
                time.sleep(gap)
            if produced:
                # a plan-bearing round usually uncovers follow-on
                # work (the drained holder's next snapshot may lag
                # the insurance tick); re-arm so the next round runs
                # right after the rate-limit gap
                self.wake.set()

    def _one_round(self, engine) -> tuple:
        s = self.server
        # live fair-share weight change (POST /jobs/<id> or controller):
        # applied here, not on the reactor — solver caches are this
        # thread's to flush. dict.pop is atomic, so a concurrent set
        # either lands now or wakes the next round.
        pw = s.__dict__.pop("_pending_job_weights", None)
        if pw is not None:
            engine.set_job_weights(pw)
        snaps = s._snapshots.fork()  # one copy: the round AND the fetch
        # lookup below must see the same view, or a reactor-thread
        # snapshot swap mid-round could silently drop a match's flag.
        # fork() carries the store's version marks so the ledger's sync
        # only touches ranks that changed since the previous round
        if s.tracer is not None:
            with s.tracer.span("balancer:round"):
                matches, migrations = engine.round(snaps, s.world)
        else:
            matches, migrations = engine.round(snaps, s.world)
        if matches:
            # whether each planned requester's park is a fused reserve
            # (get_work/stream): snapshot req tuples carry it as a 4th
            # element (3-tuples from native planes default to False), and
            # the holder uses it to ship the payload in the RFR response
            # instead of a handle (remote fused fetch)
            fetch_by_req: dict[tuple, bool] = {}
            for src, snap in snaps.items():
                for r in snap.get("reqs") or ():
                    fetch_by_req[(src, r[0], r[1])] = (
                        bool(r[3]) if len(r) > 3 else False
                    )
        dead = s._dead_servers
        for holder, seqno, req_home, for_rank, rqseqno in matches:
            if holder in dead or req_home in dead:
                continue  # racing failover: the next round re-plans
            try:
                s.ep.send(
                    holder,
                    msg(
                        Tag.SS_PLAN_MATCH,
                        s.rank,
                        seqno=seqno,
                        for_rank=for_rank,
                        req_home=req_home,
                        rqseqno=rqseqno,
                        fetch=int(
                            fetch_by_req.get(
                                (req_home, for_rank, rqseqno), False
                            )
                        ),
                    ),
                )
            except OSError:
                continue  # the reactor's own evidence declares the death
        for src_rank, dest, seqnos, mig_id in migrations:
            if src_rank in dead or dest in dead:
                continue
            try:
                s.ep.send(
                    src_rank,
                    msg(Tag.SS_PLAN_MIGRATE, s.rank, dest=dest, seqnos=seqnos,
                        mig_id=mig_id),
                )
            except OSError:
                continue
        gap = 0.0
        if s.cfg.balancer_min_gap > 0:
            # module already cached by run()'s deferred import; this stays
            # a plain lookup, not a fresh module load
            from adlb_tpu_torch.balancer.engine import round_gap

            gap = round_gap(s.cfg.balancer_min_gap, matches, migrations)
        # the caller sleeps the gap (under the idle phase marker) and
        # re-arms the doorbell after plan-bearing rounds
        return gap, bool(matches or migrations)


class _PeerState:
    """What this server believes about a peer — the reference's qmstat entry
    {nbytes_used, qlen_unpin_untarg, type_hi_prio[]} (reference
    ``src/adlb.c:151-159``)."""

    def __init__(self) -> None:
        self.nbytes = 0
        self.qlen = 0
        self.hi_prio: dict[int, int] = {}
        # per-job inventory cells {(job, type): prio} — present only
        # while non-default namespaces hold work (service mode)
        self.job_hi: dict[tuple[int, int], int] = {}
        self.rss_kb = 0
        self.stamp = 0.0


class Server:
    def __init__(
        self, world: WorldSpec, cfg: Config, ep: Endpoint, abort_event=None
    ) -> None:
        from adlb_tpu_torch.runtime.membership import MemberView

        # every server holds the DYNAMIC membership view (behavior-
        # identical to the plain spec until membership actually changes);
        # scale-out shards arrive with a pre-seeded view
        world = MemberView.of(world)
        self.world = world
        self.cfg = cfg
        self.ep = ep
        from adlb_tpu_torch.runtime.faults import FaultyEndpoint

        if isinstance(ep, FaultyEndpoint):
            ep.plan.state = self._state_at_kill  # an injected kill's record
        self.rank = ep.rank
        self.is_master = self.rank == world.master_server_rank
        self.local_apps = set(world.local_apps(self.rank))

        # per-job wq partitions behind the single-queue surface: job 0
        # keeps the configured implementation (incl. the C++ core);
        # non-default namespaces get lazy pure-Python partitions
        self.wq = PartitionedWorkQueue(lambda: self._make_wq(cfg))
        self.rq = ReserveQueue()
        self.tq = TargetedDirectory()
        self.mem = MemoryAccountant(
            cfg.max_malloc_per_server,
            soft_frac=cfg.mem_soft_frac,
            hard_frac=cfg.mem_hard_frac,
        )
        self.cq = CommonStore(on_gc=self._on_common_gc)
        # disk spill tier (Config(spill_dir), runtime/spill.py): cold
        # parked payloads move to disk above the spill watermark and
        # fault back in at delivery time — see _maybe_spill/_unspill
        self.spill = None
        if cfg.spill_dir is not None:
            from adlb_tpu_torch.runtime.spill import SpillIndex, SpillStore

            self.spill = SpillStore(cfg.spill_dir, self.rank)
            self.wq.spill_index = SpillIndex()
        # lease per pinned unit (owner rank, lease id, grant time): under
        # on_worker_failure="reclaim" a dead owner's leases turn back into
        # queued work instead of blocking exhaustion forever
        self.leases = LeaseTable()

        # ---- gray-failure state (Config(lease_timeout_s) / quarantine) ----
        # liveness clock per app rank: stamped by EVERY frame the rank
        # sends here (protocol traffic piggybacks liveness) plus its
        # periodic FA_HEARTBEAT; the lease-expiry scan ages a lease from
        # max(grant, renewal, owner last-heard), and the HOME server
        # declares a rank hung after 2x the timeout of total silence —
        # the bounded detection a SIGSTOP'd (gray-failed) worker needs,
        # since it never EOFs
        self._lease_armed = cfg.lease_timeout_s > 0
        self._last_heard: dict[int, float] = {}
        # fencing tokens from expired leases: (seqno, owner) pairs whose
        # lease EXPIRED — the unit re-enqueued under a fresh attempt, and
        # any late Get_reserved from the old owner answers ADLB_FENCED so
        # a slow-but-alive worker can never double-settle it. Bounded
        # like the failover tombstones.
        self._fences: set[tuple[int, int]] = set()
        self._fence_order: deque = deque()
        # fences adopted from a failed-over predecessor, keyed by ITS
        # numbering (the fenced owner's rerouted fetch arrives stamped
        # fo_from): fencing must survive failover or a takeover would
        # quietly un-fence a stalled owner
        self._adopted_fences: set[tuple[int, int, int]] = set()
        # dead-letter quarantine: units whose failure-attempt count
        # exceeded Config(max_unit_retries) — out of the wq (settled for
        # exhaustion voting), counted exactly-once, retrievable via
        # ctx.get_quarantined() / ops /deadletter
        self.quarantine: list[dict] = []

        # ---- server failover (Config(on_server_failure="failover")) ----
        # Each server streams a replication log of its pool mutations to
        # its ring-successor buddy (adlb_tpu_torch/runtime/replica.py) and
        # passively mirrors its ring predecessor's stream; on a server's
        # death the survivors prune it and the buddy replays the mirror
        # into its own queues, taking over home-server duty.
        self._failover = (
            cfg.on_server_failure == "failover" and world.nservers > 1
        )
        self._dead_servers: set[int] = set()
        self._srv_route: dict[int, int] = {}  # dead server -> its buddy
        self.repl = None  # ReplicationLog toward the current buddy
        # primary rank -> ReplicaMirror (normally just the ring
        # predecessor; re-bootstraps after intermediate deaths can add
        # more — see _rebootstrap_repl)
        self.mirrors: dict[int, "object"] = {}
        if self._failover:
            from adlb_tpu_torch.runtime import replica

            self.repl = replica.ReplicationLog(world.ring_next(self.rank))
        # ---- master failover (the brain survives its own death) ----
        # The master's ring buddy is the standing DEPUTY: the master's
        # durable control-plane state (membership/epoch/watermark, live
        # SLO objectives, controller policy, parked scale requests, job
        # weights) rides the SAME replication stream as the pool shard,
        # so a promoted deputy is a fully functioning brain. Succession
        # fans SS_MASTER_TAKEOVER behind an ack barrier (same shape as
        # the membership barrier): exhaustion/END verdicts defer while
        # it is open, so no termination verdict races the new epoch.
        # Plain attrs only — an unconfigured world mints no counters.
        self._takeover_tok = 0
        self._takeover_pending: Optional[dict] = None

        # ---- durable service mode (Config(wal_dir), runtime/wal.py) ----
        # the replica op stream teed to an append-only on-disk log with
        # group-commit fsync; put acks are held for the commit that
        # makes their entries durable (write-ahead across process death)
        self.wal = None
        if cfg.wal_dir:
            from adlb_tpu_torch.runtime import wal as walmod

            self.wal = walmod.WriteAheadLog(
                cfg.wal_dir, self.rank, world,
                fsync_ms=cfg.wal_fsync_ms,
                max_bytes=cfg.wal_max_bytes,
                allow_legacy=cfg.allow_legacy_shards,
            )
        # the ONE mutation-log handle every pool-state change goes
        # through: the network replication log, the WAL, or a tee of
        # both (None when neither is armed)
        self._refresh_wlog()

        # ---- job namespaces (service mode, runtime/jobs.py) ----
        from adlb_tpu_torch.runtime.jobs import JobTable

        self.jobs = JobTable()
        # which namespace each LOCAL app rank is attached to (updated by
        # FA_JOB_CTL attach and by any reserve naming a job): the
        # per-job exhaustion vote reads it for this server's local apps
        self._rank_job: dict[int, int] = {}
        self._job_next_id = 1  # master-allocated job ids
        # control-plane injection from the ops HTTP thread (POST /jobs):
        # the reactor drains this on its periodic pass (see ctl_request)
        self._ctl_inbox: deque = deque()
        # units dropped by a job kill: their outstanding handles answer
        # ADLB_NO_MORE_WORK instead of crashing the reactor (bounded,
        # like fences)
        self._killed_units: set[int] = set()
        self._killed_order: deque = deque()
        self.wal_recovered = 0  # units adopted from the WAL at startup

        # ---- elastic membership (adlb_tpu_torch/runtime/membership.py) ----
        # master's id pool for attached ranks / scale-out servers: above
        # the base world AND the sidecar pseudo-rank (== spec.nranks)
        self._member_next_rank = world.spec.nranks + 1
        # fan-out/ack barrier: the master answers an attach/detach only
        # once every live server acked the membership change, so a new
        # rank's first frame can never outrun its own membership
        self._member_tok = 0
        self._member_pending: dict[int, dict] = {}
        # scale-out shards whose reactors announced "ready" (master);
        # shards published live fleet-wide (server_live fan-out) — only
        # these join rings, fan-outs, and buddy walks
        self._member_ready: set[int] = set()
        self._member_live: set[int] = set(
            s for s in world.extra_servers if s != self.rank
        )
        # scale-in: servers mid-drain, and servers retired CLEANLY
        # (full-mirror promote, zero counted losses)
        self._draining_servers: set[int] = set()
        self._draining_self = False
        self._drain_deadline = 0.0
        self._drained_exit = False
        self._drained_servers: set[int] = set()
        self._clean_retire: set[int] = set()
        # harness hook: callable(alloc) that spawns a new server shard
        # (in-proc thread, subprocess, k8s pod — the harness's business)
        self.member_spawner = None
        # watermark-triggered scale-out with no spawner registered parks
        # here, visible at /fleet — the future autoscaler's feed
        self._scale_pending: Optional[dict] = None
        self._scaleout_t0: Optional[float] = None
        self._next_elastic_check = 0.0
        self._elastic_cooldown_until = 0.0
        # member rank -> published (host, port), for TCP joiners
        self._member_addrs: dict[int, tuple] = {}

        # when each server's death was first observed here (MTTR t0)
        self._server_eof_at: dict[int, float] = {}
        # servers whose inbound connection EOF was HANDLED by this
        # reactor: the reader enqueues PEER_EOF behind the connection's
        # last frame, so handling it proves the replication tail drained.
        # A failed SEND proves nothing of the sort (frames may still be
        # queued inbound) — promotion must key on THIS set, not on
        # _server_eof_at, or a buddy that merely failed a send to the
        # dying server would seal the mirror over unapplied SS_REPL
        # frames and drop an acked put uncountably
        self._server_tail_drained: set[int] = set()
        # (dead server, old seqno) pairs already counted in
        # failover_lost: the owner's (possibly re-sent) fetch of the
        # same lost unit must not count it again
        self._counted_lost: set[tuple[int, int]] = set()
        # SS_SERVER_DEAD arrived before the dead server's own EOF: hold
        # the promotion until the EOF drains the replication tail (or the
        # deadline passes — the death may predate any connection to us)
        self._pending_promotion: dict[int, float] = {}
        # server EOF observed during termination: ambiguous (a finished
        # peer exits, closing connections) — suspected dead, declared
        # only if the world has not completed by the deadline
        self._suspect_servers: dict[int, float] = {}
        # dead server -> wall-clock until which the TA_HOME_TAKEOVER
        # remap is periodically re-announced: the promote-time fan-out is
        # one-shot best-effort, and a connect refused under load would
        # otherwise leave a client waiting out its whole failover window
        self._takeover_renotify: dict[int, float] = {}
        self._next_renotify = 0.0
        # takeover translations: clients and servers keep addressing
        # adopted state by the DEAD server's numbering (stamped fo_from
        # by the reroute), translated here to the buddy's fresh ids
        self._adopted_units: dict[tuple[int, int], int] = {}
        self._adopted_commons: dict[tuple[int, int], int] = {}
        self._adopted_tombs: set[tuple[int, int]] = set()
        # in-flight migration batches by (routed dest -> token -> units):
        # a destination dying mid-transit would otherwise lose the units
        # serialized inside the unacked SS_MIGRATE_WORK
        self._mig_token = 0
        self._migrate_pending: dict[int, dict[int, list]] = {}
        self.died = False  # this server's own (injected) connectivity death
        # app ranks whose connection died before finalize (reclaim policy);
        # a rank that reconnects (network churn, not death) is resurrected
        self._dead_ranks: set[int] = set()
        self._resurrected: set[int] = set()
        # Duplicate-request tolerance: the transport's reconnect (and the
        # client's _send_retry above it) can deliver a request twice — the
        # frame may have been delivered before the socket error. Each
        # destructive RPC dedups its own way:
        #   puts    — per-sender window of accepted ids (idempotent ack);
        #   reserve — echoed rqseqno (a dup re-park would double-pin);
        #   get     — at-most-once cache of the last consumed response
        #             per sender (the consume is unrepeatable);
        #   common  — last fetched prefix seqno (re-serve w/o recount).
        self._seen_puts: dict[int, tuple[set, deque]] = {}
        self._seen_rqseqnos: dict[int, tuple[set, deque]] = {}
        self._last_get_resp: dict[int, tuple[int, Msg]] = {}
        self._last_common: dict[int, int] = {}
        self._seen_forfeits: dict[int, tuple[set, deque]] = {}

        self._next_seqno = 1
        self.peers: dict[int, _PeerState] = {
            s: _PeerState() for s in world.server_ranks
        }

        # stealing state
        # ranks with an outstanding RFR -> send time. The timestamp is
        # the loss-recovery hook: an SS_RFR (or its response) eaten by a
        # one-way partition or a dying link would otherwise hide the
        # requester from every later match pass forever — _periodic
        # re-arms entries older than _rfr_timeout (stray late responses
        # are already handled by the rqseqno match in _on_rfr_resp)
        self._rfr_out: dict[int, float] = {}
        self._rfr_timeout = max(5.0, 20.0 * cfg.qmstat_interval)
        self._rfr_excluded: dict[int, set[int]] = {}  # rank -> servers struck out
        # remote fused fetch: units whose payload left in a
        # payload-carrying SS_RFR_RESP but whose SS_DELIVERED/UNRESERVE
        # resolution has not arrived. They stay pinned under their lease;
        # a rank-death sweep treats them as delivered (the payload may
        # already be at the requester — re-enqueueing could run it twice)
        self._relay_inflight: dict[int, int] = {}  # seqno -> for_rank
        # the requester's side of the same handoffs: this server's latest
        # resolutions (seqno, for_rank, delivered) of each holder's
        # payload-carrying responses. The holder's consume or unpin may
        # not have reached its buddy's mirror when it dies, and the buddy
        # would then keep the unit pinned for a rank that already ran it;
        # so when a holder dies they are sent again, rerouted to the buddy
        self._relay_resolved: dict[int, deque] = {}
        # rerouted resolutions (SS_DELIVERED / SS_UNRESERVE stamped
        # fo_from) for a server whose mirror this one has not promoted
        # yet: held until _promote has adopted its units
        self._held_resolutions: dict[int, list] = {}
        # ranks whose get_work_stream reported an empty bank (FA_STREAM_IDLE):
        # only then do their prefetch-flagged reserves count as parked for
        # exhaustion voting; any delivery to the rank clears the mark
        self._stream_idle: set[int] = set()
        # ranks whose prefetch entries were swept by a rank-death reclaim:
        # if the rank resurrects (the EOF was churn), its stream still
        # counts those reserves as in flight, so the next idle note is
        # answered with enough ADLB_RETRY responses to re-arm the
        # phantom slots instead of hanging the stream forever
        self._swept_streams: set[int] = set()
        # steal/broadcast event qmstat: rate limiter for the
        # empty->nonempty immediate broadcasts
        self._last_qmstat_event = 0.0
        # push state: query_id -> seqno offered; receiver side: query_id -> reserved bytes
        self._push_seq = 0
        self._push_offered: dict[int, int] = {}
        self._push_reserved: dict[int, int] = {}
        # migration batches sent but not yet acked by the destination —
        # in-flight work the exhaustion vote must see (units inside an
        # unacked SS_MIGRATE_WORK live in no wq anywhere)
        self._migrate_unacked = 0
        # src server -> highest planner migration-batch id received from
        # it (per-source: transport ordering only holds per sender pair)
        self._mig_acks: dict[int, int] = {}
        self._last_event_snap = 0.0
        # put-event task deltas accumulated while the min-gap rate limit
        # holds; flushed as ONE batched SS_STATE_DELTA (parallel per-unit
        # lists) the moment the gap elapses, so the balancer's inventory
        # view tracks a streaming producer within one gap instead of one
        # unit per gap (the hotspot startup stall)
        self._pending_delta: list[tuple[int, int, int, int]] = []
        self._delta_deadline = float("inf")

        # termination state
        self.no_more_work = False
        self.done_by_exhaustion = False
        self.done = False
        self._finalized: set[int] = set()
        self._end1_pending = False  # END_1 token held until local apps finish
        self._end1_sent_at = 0.0    # last kick (the lost-END watchdog's t0)
        self._ending = False  # shutdown ring underway: peer EOFs are benign
        self._exhaust_held_since: Optional[float] = None
        self._exhaust_inflight = False
        self._exhaust_sent_at = 0.0
        self._exhaust_token_id = 0
        self.activity = 0  # puts accepted + reservations handed out

        # balancer state (master only, tpu mode). The snapshot table is a
        # SnapshotStore (a dict that versions its own mutations) so the
        # ledger's sync touches only changed ranks instead of walking all
        # S snapshots every round; in-place mutations below bump() it.
        from adlb_tpu_torch.balancer.ledger import SnapshotStore

        self._snapshots: SnapshotStore = SnapshotStore()
        self._solver = None
        # set by the balancer thread when planning fails; Server.run raises
        self.balancer_error: Optional[Exception] = None
        self._balancer: Optional[_BalancerWorker] = None
        if cfg.balancer == "tpu" and self.is_master:
            self._balancer = _BalancerWorker(self)
        # "hungry" = some requester is parked somewhere in the world whose
        # requested types new inventory could satisfy, so an untargeted put
        # of such a type is worth snapshotting immediately. Gates the
        # put-side event snapshots: without it every put pays the O(wq)
        # snapshot walk even when nobody is waiting (a measurable GIL tax
        # on compute-bound workloads). Type-aware so a permanently parked
        # collector of targeted answers (gfmc's master waiting on TYPE_D,
        # which only ever arrives as targeted puts the planner never sees)
        # does not keep the whole world snapshotting. Master tracks parked
        # types from the snapshots it already receives and broadcasts only
        # set changes. A stale-low flag merely defers discovery to the
        # balancer's periodic snapshot heartbeat.
        self._hungry = False  # some parked requester exists (any type)
        self._hungry_any = False  # a parked requester accepts any type
        self._hungry_types: frozenset = frozenset()
        from adlb_tpu_torch.balancer.hungry import HungryTracker

        self._hungry_tracker = HungryTracker()  # master only
        self._park_res_local: dict[int, bool] = {}  # rank -> last park local?
        self._req_sigs: dict[int, tuple] = {}  # src -> last parked-req set
        self._next_idle_snap = 0.0  # slow snapshot heartbeat when not hungry

        # stats (InfoKey surface, reference src/adlb.c:3072-3141)
        self.stats = {k: 0.0 for k in InfoKey}
        self._rq_wait_sum = 0.0
        self._rq_wait_n = 0
        self._loop_t0 = time.monotonic()
        self._loops = 0

        self._abort_event = abort_event
        self._aborted = False

        # unified metrics registry (adlb_tpu_torch/obs/metrics.py): the event
        # counters the old ad-hoc _ds_counters dict held, plus queue-depth
        # gauges/timelines sampled on the periodic tick, plus whatever the
        # transport (per-tag msgs/bytes, send/recv latency) and the
        # balancer engine (round duration, plan age, pairs) record into
        # the same store. DS_LOG, STAT_APS contributions, the ops
        # endpoint's /metrics, and flight-record artifacts all read it.
        self.metrics = Registry(self.rank)
        attach(self.ep, self.metrics)
        self._m_puts = self.metrics.counter("puts")
        self._m_reserves = self.metrics.counter("reserves")
        self._m_rfrs = self.metrics.counter("rfrs")
        self._m_pushes = self.metrics.counter("pushes")
        # failure/reclaim surface (on_worker_failure="reclaim")
        self._m_rank_dead = self.metrics.counter("rank_dead")
        self._m_leases_reclaimed = self.metrics.counter("leases_reclaimed")
        self._m_targeted_dropped = self.metrics.counter("targeted_dropped")
        self._m_reconnects = self.metrics.counter("rank_reconnects")
        # gray-failure surface (lease expiry / quarantine / backpressure)
        self._m_leases_expired = self.metrics.counter("leases_expired")
        self._m_quarantined = self.metrics.counter("quarantined")
        self._m_put_backoffs = self.metrics.counter("put_backoff")
        self._m_heartbeats = self.metrics.counter("heartbeats")
        # tail-hedging surface (Config(hedge_budget_frac) > 0,
        # runtime/hedge.py): manager + counters exist ONLY when armed —
        # an unhedged world's metric snapshots (and therefore its
        # gossip frames) stay byte-identical to an unhedged build
        if cfg.hedge_budget_frac > 0:
            self.hedges = HedgeManager(cfg.hedge_budget_frac)
            self._m_hedges_launched = self.metrics.counter("hedges_launched")
            self._m_hedges_won = self.metrics.counter("hedges_won")
            self._m_hedges_fenced = self.metrics.counter("hedges_fenced")
        else:
            self.hedges = None
        # per-scan memo of the owner-labelled lease-expiry cells (the
        # local stall-signature window for the hedge trigger), plus the
        # decaying rank -> deadline suspicion map it feeds
        self._hedge_expiry_memo: dict[str, float] = {}
        self._hedge_suspect_until: dict[int, float] = {}
        self._g_leases = self.metrics.gauge("leases_outstanding")
        self._g_lease_age = self.metrics.gauge("lease_age_max_s")
        self._g_quarantined = self.metrics.gauge("quarantined")
        self._g_mem_pressure = self.metrics.gauge("mem_pressure")
        # spill tier (Config(spill_dir)): bytes/units currently on disk,
        # spill-out and fault-in counts, and fault-in latency
        self._m_spills = self.metrics.counter("spill_outs")
        self._m_faultins = self.metrics.counter("spill_faultins")
        self._g_spill_bytes = self.metrics.gauge("spill_bytes")
        self._g_spill_units = self.metrics.gauge("spill_units")
        self._h_faultin = self.metrics.histogram("spill_faultin_s")
        # failover surface (on_server_failure="failover")
        self._m_server_dead = self.metrics.counter("server_dead")
        self._m_failover_promoted = self.metrics.counter("failover_promoted")
        self._m_failover_lost = self.metrics.counter("failover_lost")
        self._m_relays_unresolved = self.metrics.counter(
            "failover_relays_unresolved")
        self._g_repl_lag = self.metrics.gauge("repl_lag")
        # durable-service surface (wal_dir / jobs): WAL depth (entries
        # not yet durable) and fsync lag ride /metrics next to repl_lag
        self._g_wal_depth = self.metrics.gauge("wal_depth")
        self._g_wal_lag = self.metrics.gauge("wal_fsync_lag_ms")
        self._m_wal_syncs = self.metrics.counter("wal_syncs")
        self._m_jobs_done = self.metrics.counter("jobs_done")
        self._g_fo_mttr = self.metrics.gauge("failover_mttr_ms")
        # elastic-membership surface: counted ONCE fleet-wide (attach/
        # detach at the home server, joins/drains at the master)
        self._m_attached = self.metrics.counter("ranks_attached")
        self._m_detached = self.metrics.counter("ranks_detached")
        self._m_servers_joined = self.metrics.counter("servers_joined")
        self._m_servers_drained = self.metrics.counter("servers_drained")
        self._g_epoch = self.metrics.gauge("member_epoch")
        self._g_scaleout_mttr = self.metrics.gauge("scaleout_mttr_ms")
        self._g_wq = self.metrics.gauge("wq_depth")
        self._g_rq = self.metrics.gauge("rq_depth")
        self._ts_wq = self.metrics.timeseries("wq_depth")
        self._ts_rq = self.metrics.timeseries("rq_depth")
        # last STAT_APS world aggregate seen at the master (served by the
        # ops endpoint's /metrics as the world-aggregated rows)
        self.last_aggregate = None
        self.ops = None

        # server-side tracing: handler + balancer-round spans into the
        # same Chrome-trace stream as client API calls (pid = role)
        self.tracer = (
            Tracer(self.rank, pid=PID_SERVER, process_name="servers")
            if cfg.trace
            else None
        )
        self._span_names: dict[Tag, str] = {}

        # unit-lifecycle tracing (Config(trace_sample), obs/journey.py):
        # sampled units carry a span list stamped at every hop; terminal
        # events close them into journeys feeding the unit_stage_s
        # histograms, the closed-journey store, and (when trace=True)
        # flow events in the Chrome-trace stream
        self.journeys = JourneyRecorder(
            self.rank, self.metrics, tracer=self.tracer
        )
        # tail-based promotion (Config(trace_tail)): "auto" arms iff the
        # world is observed (ops endpoint configured) — unobserved
        # worlds keep the untraced-put frame identity
        self.journeys.tail = cfg.trace_tail == "on" or (
            cfg.trace_tail == "auto" and cfg.ops_port is not None
        )
        # traced puts whose ack is held for the WAL group commit:
        # (src, put_id) -> unit, stamped "wal_commit" when the covering
        # fsync releases the ack
        self._trace_wal_pending: dict[tuple[int, int], WorkUnit] = {}

        # ---- fleet metrics plane (SS_OBS_SYNC gossip) ----
        # armed only for observed worlds (ops endpoint configured):
        # non-master servers ship delta-encoded registry snapshots +
        # closed journeys to the master every obs_sync_interval; the
        # master merges them for /metrics, /healthz staleness, and
        # /trace/units. Unobserved worlds pay zero gossip traffic.
        self._obs_sync_armed = (
            cfg.ops_port is not None and cfg.obs_sync_interval > 0
        )
        self._obs_last: dict = {}   # delta-snapshot memo (what we sent)
        self._obs_seq = 0
        # master side: rank -> cumulative registry view; rank -> (seq,
        # received-at monotonic) staleness ledger; fleet journey store
        self._fleet_snaps: dict[int, dict] = {}
        self._fleet_seen: dict[int, tuple[int, float]] = {}
        self._journeys_fleet: deque = deque(maxlen=4096)
        # tail-promoted journeys (why != head): the /trace/tails store
        self._tails_fleet: deque = deque(maxlen=2048)
        # per-(job, type) p99 thresholds the master computes from the
        # merged fleet unit_total_s cells (cached per obs tick; replies
        # to gossip frames carry it back to the closing servers)
        self._tail_thr_cache: list = []
        # continuous profiler (Config(profile_hz)): _prof is the OWNED
        # instance (this server started it, gossips it, stops it);
        # _prof_shared is whatever profiler lives in this process (for
        # phase markers — in-proc worlds share one across servers)
        self._prof = None
        self._prof_shared = None
        self._prof_memo: dict = {}
        self._phase_names: dict[Tag, str] = {}
        # master side: per-rank gossiped cumulative folded stacks and
        # sealed sampling windows (the /profile merge + tail join)
        self._prof_fleet: dict[int, dict] = {}
        self._prof_windows: dict[int, deque] = {}
        self._last_aggregate_at = 0.0
        # jobs whose gauges the last gauge tick set (so a dropped
        # partition's gauges get zeroed exactly once, not left frozen)
        self._job_gauged: set[int] = set()
        # ---- SLO engine (obs/slo.py) ----
        # master-only evaluator over the merged fleet registry; created
        # at init from Config(slo=...) or lazily by the first POST /slo.
        # _slo_alerts_wire: compact rows riding SS_OBS_SYNC replies
        # (publish-by-swap — the gossip path reads it mid-reply);
        # _slo_alerts_remote: what a NON-master last heard from the
        # master (the fleet-wide agreement surface); _incidents: the
        # live bundles /incidents serves, newest last.
        self._slo_engine = None
        self._slo_alerts_wire: list = []
        self._slo_alerts_remote: list = []
        self._next_slo_eval = 0.0  # cadence gate (slo_eval_interval)
        self._incidents: deque = deque(maxlen=32)
        self._m_alerts_firing = self.metrics.gauge("alerts_firing")
        if self._obs_sync_armed and self.is_master and cfg.slo:
            from adlb_tpu_torch.obs.slo import SloEngine

            eng = SloEngine(cfg.slo_eval_interval
                            or cfg.obs_sync_interval)
            for doc in cfg.slo:
                eng.add(doc)
            self._slo_engine = eng

        # ---- fleet controller (control/controller.py) ----
        # master-only closed loop over the existing actuators (scale
        # plane + job quotas), riding the obs tick like the SLO engine.
        # Unconfigured worlds carry only this None — no thread, no
        # counters, no per-tick work.
        self._controller = None
        self._next_control = 0.0  # cadence gate (control_interval)
        if self._obs_sync_armed and self.is_master and cfg.control:
            from adlb_tpu_torch.control import Controller

            self._controller = Controller(
                {
                    "dry_run": cfg.control_dry_run,
                    "min_servers": cfg.control_min_servers,
                    "max_servers": cfg.control_max_servers,
                    "cooldown_s": cfg.control_cooldown_s,
                    "scaleout_pressure": cfg.control_scaleout_pressure,
                    "scalein_pressure": cfg.control_scalein_pressure,
                },
                eval_interval=(cfg.control_interval
                               or cfg.obs_sync_interval),
            )

        # timers
        now = time.monotonic()
        self._next_state_sync = now
        self._next_gauge_sample = now  # first tick samples immediately
        self._next_obs_sync = (
            now + cfg.obs_sync_interval
            if self._obs_sync_armed
            else float("inf")
        )
        self._next_lease_scan = (
            now + cfg.lease_timeout_s if self._lease_armed else float("inf")
        )
        self._next_hedge_scan = (
            now + cfg.hedge_min_age_ms / 1e3
            if self.hedges is not None else float("inf")
        )
        self._next_exhaust_check = now + cfg.exhaust_check_interval
        self._next_ds_log = now
        # since-last-DS_LOG bookkeeping for the reference's 11-counter
        # heartbeat payload (reference src/adlb.c:3222-3259)
        self._ds_last = {"events": 0, "ss": 0, "reserves": 0, "immed": 0,
                         "parked": 0, "rfr_failed": 0}
        self._n_reserve_immed = 0
        self._n_rfr_failed = 0

        # periodic cluster-wide stats ring (reference src/adlb.c:712-753)
        self.resolved_reserves = 0
        self._pstats_seq = 0
        self._next_pstats = (
            now + cfg.periodic_log_interval
            if cfg.periodic_log_interval > 0
            else float("inf")
        )

        # debug plumbing (reference src/adlb.c:176-179,558-710); the obs
        # recorder adds JSON post-mortem artifacts on top of the text ring
        self.flight = FlightRecorder(
            self.rank, out_dir=cfg.flight_dir, role="server"
        )
        self.flight.metrics = self.metrics
        self.flight.context = {
            "is_master": self.is_master,
            "balancer": cfg.balancer,
            "nservers": world.nservers,
            "num_app_ranks": world.num_app_ranks,
            "local_apps": sorted(self.local_apps),
        }
        self.tag_freq: dict[Tag, int] = {}
        self._next_selfdiag = (
            now + cfg.selfdiag_interval
            if cfg.selfdiag_interval > 0
            else float("inf")
        )

        if cfg.restore_path:
            self._restore_from_checkpoint(cfg.restore_path)
        if self.wal is not None:
            # cold restart: shard-load + log replay through the replica
            # mirror machinery, adopted into the live queues. Runs after
            # the metrics/flight plumbing exists (it records) and never
            # alongside restore_path (Config refuses the combination).
            self._recover_from_wal()

        self._handlers = {
            Tag.PEER_EOF: self._on_peer_eof,
            Tag.FA_CHECKPOINT: self._on_fa_checkpoint,
            Tag.SS_CHECKPOINT: self._on_ss_checkpoint,
            Tag.FA_PUT: self._on_put,
            Tag.FA_PUT_COMMON: self._on_put_common,
            Tag.FA_BATCH_DONE: self._on_batch_done,
            Tag.FA_DID_PUT_AT_REMOTE: self._on_did_put_at_remote,
            Tag.FA_RESERVE: self._on_reserve,
            Tag.FA_STREAM_IDLE: self._on_stream_idle,
            Tag.FA_STREAM_CANCEL: self._on_stream_cancel,
            Tag.FA_GET_RESERVED: self._on_get_reserved,
            Tag.FA_GET_COMMON: self._on_get_common,
            Tag.FA_HEARTBEAT: self._on_heartbeat,
            Tag.FA_GET_QUARANTINED: self._on_get_quarantined,
            Tag.FA_JOB_CTL: self._on_fa_job_ctl,
            Tag.SS_JOB_CTL: self._on_ss_job_ctl,
            Tag.FA_NO_MORE_WORK: self._on_fa_no_more_work,
            Tag.FA_LOCAL_APP_DONE: self._on_local_app_done,
            Tag.FA_ABORT: self._on_fa_abort,
            Tag.FA_INFO_NUM_WORK_UNITS: self._on_info_num,
            Tag.FA_INFO_GET: self._on_info_get,
            Tag.SS_QMSTAT: self._on_qmstat,
            Tag.SS_RFR: self._on_rfr,
            Tag.SS_RFR_RESP: self._on_rfr_resp,
            Tag.SS_UNRESERVE: self._on_unreserve,
            Tag.SS_DELIVERED: self._on_delivered,
            Tag.SS_PUSH_QUERY: self._on_push_query,
            Tag.SS_PUSH_QUERY_RESP: self._on_push_query_resp,
            Tag.SS_PUSH_WORK: self._on_push_work,
            Tag.SS_PUSH_DEL: self._on_push_del,
            Tag.SS_MOVING_TARGETED_WORK: self._on_moving_targeted,
            Tag.SS_NO_MORE_WORK: self._on_ss_no_more_work,
            Tag.SS_EXHAUST_CHK_1: self._on_exhaust_chk,
            Tag.SS_EXHAUST_CHK_2: self._on_exhaust_chk,
            Tag.SS_DONE_BY_EXHAUSTION: self._on_done_by_exhaustion,
            Tag.SS_END_1: self._on_end_1,
            Tag.SS_END_2: self._on_end_2,
            Tag.SS_ABORT: self._on_ss_abort,
            Tag.SS_PERIODIC_STATS: self._on_periodic_stats,
            Tag.SS_STATE: self._on_state,
            Tag.SS_STATE_DELTA: self._on_state_delta,
            Tag.SS_HUNGRY: self._on_hungry,
            Tag.SS_PLAN_MATCH: self._on_plan_match,
            Tag.SS_PLAN_MIGRATE: self._on_plan_migrate,
            Tag.SS_MIGRATE_WORK: self._on_migrate_work,
            Tag.SS_MIGRATE_ACK: self._on_migrate_ack,
            Tag.FA_MEMBER: self._on_fa_member,
            Tag.SS_MEMBER: self._on_ss_member,
            Tag.SS_RANK_DEAD: self._on_rank_dead,
            Tag.SS_COMMON_FORFEIT: self._on_common_forfeit,
            Tag.SS_REPL: self._on_repl,
            Tag.SS_SERVER_DEAD: self._on_server_dead,
            Tag.SS_MASTER_TAKEOVER: self._on_master_takeover,
            Tag.SS_OBS_SYNC: self._on_obs_sync,
        }

    @staticmethod
    def _make_wq(cfg: Config):
        """Pick the work-queue implementation: C++ core (ctypes) when wanted
        and buildable, else the pure-Python indexed queue. The spill tier
        forces the Python queue: spilling swaps a unit's payload residency
        in place, which the C++ core's unit storage cannot express."""
        if cfg.native_queues == "off" or cfg.spill_dir is not None:
            return WorkQueue()
        try:
            from adlb_tpu_torch.native.wq import NativeWorkQueue

            return NativeWorkQueue()
        except (RuntimeError, OSError, ImportError):
            if cfg.native_queues == "on":
                raise
            return WorkQueue()

    # ------------------------------------------------------------------ loop

    def run(self) -> None:
        aprintf(
            self.cfg.aprintf_flag, self.rank,
            f"server starting (master={self.is_master}, "
            f"apps={sorted(self.local_apps)}, balancer={self.cfg.balancer})",
        )
        try:
            if self.cfg.ops_port is not None and self.is_master:
                from adlb_tpu_torch.obs.ops_server import maybe_start

                self.ops = maybe_start(self, self.cfg)
                if self.ops is not None:
                    aprintf(
                        self.cfg.aprintf_flag, self.rank,
                        f"ops endpoint on 127.0.0.1:{self.ops.port}",
                    )
                    self._announce_ops_endpoint()
            # standing deputy bootstrap: the master's FIRST replication
            # flush already carries the brain, so a death at any point
            # after startup finds a promotable deputy (the config-borne
            # SLO/control state rides it; live POSTs stream deltas)
            if self.is_master and self._failover and self.repl is not None:
                self._repl_brain()
                if self._slo_engine is not None:
                    for o in self._slo_engine.objectives:
                        self.repl.log_slo(dict(o))
                if self._controller is not None:
                    self.repl.log_control(self._controller.policy_doc())
            if self.cfg.profile_hz > 0:
                # per-PROCESS singleton: in-proc worlds run many server
                # threads in one interpreter and the sampler sees them
                # all — the first starter owns (and gossips) it, the
                # rest share it for phase markers only
                self._prof = profile.start(self.cfg.profile_hz, self.rank)
            self._prof_shared = profile.active()
            if self._balancer is not None:
                self._balancer.start()
            if self.rank not in self.world.spec.server_ranks:
                # scale-out shard: the reactor is up — announce ready so
                # the master publishes us live (rings, buddy walks) and
                # directs the donor bootstrap at us
                self.ep.send(
                    self.world.master_server_rank,
                    msg(Tag.SS_MEMBER, self.rank, mop="ready"),
                )
            self._run_loop()
        finally:
            profile.stop(self._prof)
            self._prof = None
            if self.ops is not None:
                self.ops.stop()
            if self.wal is not None:
                # final group commit: any held acks flush (the clients
                # are gone at clean shutdown, so this is about the tail
                # entries being durable for the next incarnation)
                try:
                    for app, resp in self.wal.tick(
                        time.monotonic(), force=True
                    ):
                        self._send_app(app, resp)
                except OSError:
                    pass
                self.wal.close()
            if self.spill is not None:
                self.spill.close()
            if self._balancer is not None:
                self._balancer.stop()
                # bounded join: a straggler round finishing after teardown
                # would otherwise overlap (and contend with) the next world
                # in back-to-back in-process runs; never wait on a wedged
                # device solve, though — the thread is a daemon
                self._balancer.join(timeout=1.0)
            self._notify_debug_server_end()
            aprintf(
                self.cfg.aprintf_flag, self.rank,
                f"server exiting (wq_max={self.wq.max_count}, "
                f"activity={self.activity}, aborted={self._aborted})",
            )
        if self.balancer_error is not None:
            raise RuntimeError(
                f"balancer failed on server {self.rank}: "
                f"{self.balancer_error!r}") from self.balancer_error

    def _run_loop(self) -> None:
        try:
            self._run_loop_inner()
        except OSError as e:
            # this server's own connectivity died (fault-injected
            # disconnect): under the failover policy that is the simulated
            # server death — exit quietly as the casualty (the buddy is
            # taking over), never as a world error
            plan = getattr(self.ep, "plan", None)
            if (
                self.cfg.on_server_failure == "failover"
                and plan is not None
                and getattr(plan, "disconnected", False)
            ):
                self.flight.record(
                    f"own connectivity lost ({e!r}); exiting as failover "
                    f"casualty"
                )
                self.died = True
                self.done = True
                return
            raise

    def _run_loop_inner(self) -> None:
        interval = (
            self.cfg.balancer_interval
            if self.cfg.balancer == "tpu"
            else self.cfg.qmstat_interval
        )
        profile.register_thread("reactor")
        prof = self._prof_shared  # None when profiling is off: the
        # phase markers below cost one None check per transition then
        while not self.done:
            if self._abort_event is not None and self._abort_event.is_set():
                # every server dumps state on abort (the reference gives a
                # 10 s grace for exactly this, src/adlb.c:2508-2526)
                if not self._aborted:
                    self._aborted = True
                    self.flight.record("abort event observed")
                    self.flight.dump(reason="abort")
                return
            now = time.monotonic()
            self._loops += 1
            self._periodic(now, interval)
            deadline = min(
                self._next_state_sync,
                self._delta_deadline,
                self._next_exhaust_check if self.is_master else now + 1.0,
                self._next_ds_log
                if self.world.use_debug_server
                else now + 1.0,
                self._next_pstats if self.is_master else now + 1.0,
                # the WAL's group-commit deadline: held put acks must
                # release on time even when no traffic arrives
                self.wal.next_deadline(now + 1.0)
                if self.wal is not None
                else now + 1.0,
            )
            if prof is not None:
                # "decode" covers the recv wait + frame decode; a sample
                # landing in the idle wait shows poll/recv frames, which
                # the stack itself disambiguates from decode work
                prof.set_phase("decode")
            m = self.ep.recv(timeout=max(deadline - time.monotonic(), 0.0))
            t0 = time.monotonic()
            if m is not None:
                # one submission batch per reactor tick: every doorbell
                # write / channel send this burst of handlers produces
                # drains at the flush below, so N responses cost O(1)
                # wakeups instead of O(N) (a named follow-up)
                self.ep.submit_begin()
                try:
                    self._handle(m)
                    # drain whatever else is queued before paying the
                    # poll timeout — but bounded, so periodic duties
                    # (state sync, watchdog heartbeat, exhaustion
                    # checks) still run under sustained load
                    for _ in range(128):
                        if self.done or time.monotonic() >= deadline:
                            break
                        if prof is not None:
                            prof.set_phase("decode")
                        m2 = self.ep.recv(timeout=0.0)
                        if m2 is None:
                            break
                        self._handle(m2)
                finally:
                    if prof is not None:
                        prof.set_phase("submit_flush")
                    self.ep.submit_flush()
            self._flush_repl()
            self._flush_wal()
            self.stats[InfoKey.LOOP_TOP_TIME] += time.monotonic() - t0

    def _handle(self, m: Msg) -> None:
        """Dispatch one message; when tracing, the handler runs inside a
        ``srv:<TAG>`` span on the server tracer so the merged Chrome
        trace shows the server side of every client round trip."""
        handler = self._handlers.get(m.tag)
        if handler is None:
            raise AdlbError(f"server {self.rank}: no handler for {m.tag}")
        self.tag_freq[m.tag] = self.tag_freq.get(m.tag, 0) + 1
        prof = self._prof_shared
        if prof is not None:
            # phase marker: a profiler sample interrupting this handler
            # attributes to handler:<TAG> (cached string, edge-set)
            pname = self._phase_names.get(m.tag)
            if pname is None:
                pname = self._phase_names[m.tag] = f"handler:{m.tag.name}"
            prof.set_phase(pname)
        if self._lease_armed and self.world.is_app(m.src):
            # every frame from an app rank is liveness evidence: protocol
            # traffic piggybacks the heartbeat, FA_HEARTBEAT only covers
            # the idle-but-computing gaps
            self._last_heard[m.src] = time.monotonic()
        if self._dead_ranks and m.src in self._dead_ranks and (
            m.tag.name.startswith("FA_")
        ):
            # a rank we declared dead is talking again: the EOF was
            # connection churn, not process death. Resurrect it — but its
            # reserve/put gets a retriable code so the request re-arrives
            # after this server's reclaim fan-out has settled (its old
            # leases/rq entries are gone either way; see USERGUIDE §7).
            self._resurrect(m.src)
            if m.tag in (Tag.FA_RESERVE, Tag.FA_PUT):
                resp_tag = (
                    Tag.TA_RESERVE_RESP
                    if m.tag is Tag.FA_RESERVE
                    else Tag.TA_PUT_RESP
                )
                # _send_app, not a raw send: these could be trailing
                # buffered frames from a rank that really IS dead, whose
                # connection refuses — that must not crash the reactor
                self._send_app(
                    m.src,
                    msg(resp_tag, self.rank, rc=ADLB_RETRY,
                        put_id=m.data.get("put_id"),
                        rqseqno=m.data.get("rqseqno")),
                )
                return
        tr = self.tracer
        if tr is None:
            handler(m)
            return
        name = self._span_names.get(m.tag)
        if name is None:
            name = self._span_names[m.tag] = f"srv:{m.tag.name}"
        with tr.span(name, src=m.src):
            handler(m)

    def _periodic(self, now: float, interval: float) -> None:
        plan = getattr(self.ep, "plan", None)
        if self._failover and getattr(plan, "disconnected", False):
            # our own connectivity died (fault-injected) on a send whose
            # failure was absorbed: a server with nothing more to send
            # would otherwise never learn it, and its world never end
            raise OSError(f"server {self.rank}: own connectivity lost")
        if self._ctl_inbox:
            # ops-thread control requests (POST /jobs): serviced on the
            # reactor thread, verdicts handed back via their events
            self._drain_ctl_inbox()
        if self.wal is not None:
            self._g_wal_depth.set(self.wal.depth)
            self._g_wal_lag.set(self.wal.fsync_lag_ms(now))
            if self.wal.maybe_compact(self):
                self._release_wal_acks(self.wal.take_compact_acks())
        if self._draining_self:
            # scale-in drain parked on in-flight push custody: the
            # deadline bounds a pusher that died mid-handshake
            self._maybe_finish_drain()
        if (
            self.is_master and self._end1_pending and not self.done
            and not self._aborted and not self._member_pending
            and not self._takeover_pending
            and self._finalized >= self.local_apps
            and now - self._end1_sent_at
            > 10 * self.cfg.exhaust_check_interval
        ):
            # lost-END recovery: an epoch-voided END_1 dies at the
            # voiding server; once the gossip converges the epochs,
            # re-kick under the current one (token-less ring — the
            # generous deadline, not an id, bounds duplicates)
            self._forward_end1(
                {"origin": self.rank, "epoch": self.world.epoch}
            )
        if (
            self._takeover_pending
            and now >= self._takeover_pending["deadline"]
        ):
            # succession barrier timeout: a wedged survivor must not
            # park termination forever — it is on its way to an EOF-
            # declared death, which releases the barrier anyway
            self.flight.record(
                "master takeover barrier timeout unacked="
                f"{sorted(self._takeover_pending['need'])}"
            )
            self._master_takeover_done()
        if self._rfr_out:
            # RFR loss recovery: a request (or its response) lost to a
            # one-way partition / dying link has no acker — re-arm the
            # requester and re-match immediately instead of hiding it
            # from the balancer until the end of time
            stale = [
                r for r, t0 in self._rfr_out.items()
                if now - t0 > self._rfr_timeout
            ]
            for r in stale:
                del self._rfr_out[r]
                self.flight.record(f"rfr timeout for rank {r}: re-armed")
            for entry in self.rq.entries() if stale else ():
                if entry.world_rank in stale:
                    self._try_rfr(entry)
        if self._member_pending:
            # membership fan-out/ack barrier timeout: a wedged server
            # must not park a joiner forever. The change already applied
            # at every RESPONSIVE server (the fan-out is idempotent), so
            # answer the joiner; the silent server is on its way to an
            # EOF-declared death anyway.
            for tok, p in list(self._member_pending.items()):
                if now >= p["deadline"]:
                    del self._member_pending[tok]
                    self.flight.record(
                        f"member barrier timeout tok={tok} "
                        f"unacked={sorted(p['need'])}"
                    )
                    self._member_reply(p)
        if (
            self.is_master
            and self.cfg.elastic_scaleout == "auto"
            and self.cfg.max_malloc_per_server > 0
            and now >= self._next_elastic_check
        ):
            self._next_elastic_check = now + 0.25
            self._maybe_autoscale(now)
        if self._pending_promotion:
            # SS_SERVER_DEAD arrived but the dead server's own EOF has
            # not: promote at the deadline anyway (the death may predate
            # any connection from it to us)
            for dead, deadline in list(self._pending_promotion.items()):
                if now >= deadline:
                    del self._pending_promotion[dead]
                    self._promote(dead)
        if self._suspect_servers:
            # server EOF during termination: a finished peer's normal
            # exit if the world completes promptly, a real death if not
            for srv, deadline in list(self._suspect_servers.items()):
                if now >= deadline:
                    del self._suspect_servers[srv]
                    if not self.done and srv not in self._dead_servers:
                        self._declare_server_dead(srv)
        if self._takeover_renotify and now >= self._next_renotify:
            # repair lost TA_HOME_TAKEOVER notes (the promote-time fan-out
            # is one connect attempt per rank): re-announce ~1/s to every
            # live, unfinalized app until the client windows close
            self._next_renotify = now + 1.0
            for dead, until in list(self._takeover_renotify.items()):
                if now >= until:
                    del self._takeover_renotify[dead]
                    continue
                for r in self.world.app_ranks:
                    if r in self._dead_ranks or r in self._finalized:
                        continue
                    try:
                        self.ep.send(
                            r, msg(Tag.TA_HOME_TAKEOVER, self.rank,
                                   dead=dead, epoch=self.world.epoch),
                            connect_grace=0.25,
                        )
                    except OSError:
                        pass
        if self._pending_delta and now >= self._delta_deadline:
            self._flush_task_deltas(now)
        if self._lease_armed and now >= self._next_lease_scan:
            # scan well inside the timeout so detection latency is
            # bounded by ~1.25x lease_timeout_s, not 2x
            self._next_lease_scan = now + max(
                self.cfg.lease_timeout_s / 4.0, 0.01
            )
            self._scan_leases(now)
        if self.hedges is not None and now >= self._next_hedge_scan:
            # hedge-trigger scan (runtime/hedge.py): well inside the
            # age floor, same cadence logic as the lease scan above
            self._next_hedge_scan = now + max(
                self.cfg.hedge_min_age_ms / 4e3, 0.01
            )
            self._scan_hedges(now)
        if now >= self._next_gauge_sample:
            # queue-depth gauges + bounded timelines, sampled on their
            # OWN cadence (Config(gauge_interval), 0.25 s default),
            # decoupled from the balancer tick: in tpu mode the state
            # sync runs at balancer_interval (20 ms), and paying the
            # gauge walk + its ctypes GIL crossings 50x/s on the reactor
            # thread was a measured slice of the tpu-mode pop-latency
            # drift (see docs/pop_latency_r06.md). Observability loses
            # nothing: the timelines still cover the same history,
            # just at post-mortem resolution.
            self._next_gauge_sample = now + max(
                interval, self.cfg.gauge_interval)
            wq_d, wq_avail, wq_bytes = self.wq.depth_sample()
            rq_d = len(self.rq)
            self._g_wq.set(wq_d)
            self._g_rq.set(rq_d)
            self._ts_wq.append(now, wq_d)
            self._ts_rq.append(now, rq_d)
            m = self.metrics
            m.gauge("wq_untargeted_avail").set(wq_avail)
            m.gauge("wq_bytes").set(wq_bytes)
            m.gauge("rq_oldest_age_s").set(
                self.rq.oldest_age(now, stream_idle=self._stream_idle)
            )
            self._g_mem_pressure.set(self.mem.pressure)
            if self.spill is not None:
                self._g_spill_bytes.set(self.mem.spilled)
                self._g_spill_units.set(len(self.spill))
            self._g_leases.set(len(self.leases))
            self._g_lease_age.set(self.leases.oldest_age(now))
            self._g_quarantined.set(len(self.quarantine))
            # per-job depth/bytes/age gauges (non-default namespaces
            # only — job 0 IS the world-level gauges above): what
            # /jobs/<id> serves live and the autoscaler watches
            gauged = set()
            for jid in self.wq.job_ids():
                if jid == 0:
                    continue
                part = self.wq.part(jid)
                if part is None:
                    continue
                gauged.add(jid)
                jl = str(jid)
                m.gauge("job_wq_depth", job=jl).set(part.count)
                m.gauge("job_wq_bytes", job=jl).set(part.total_bytes)
                m.gauge("job_oldest_age_s", job=jl).set(max(
                    (now - u.time_stamp for u in part.units()),
                    default=0.0,
                ))
            # a dropped partition (job kill) leaves its gauges frozen at
            # the last sample — zero them once so a dead job cannot
            # report phantom backlog to /jobs/<id> forever (the change
            # also rides the next gossip delta, healing the master)
            for jid in self._job_gauged - gauged:
                jl = str(jid)
                m.gauge("job_wq_depth", job=jl).set(0)
                m.gauge("job_wq_bytes", job=jl).set(0)
                m.gauge("job_oldest_age_s", job=jl).set(0.0)
            self._job_gauged = gauged
            # quota-backoff totals ride the same gossip so /jobs/<id>
            # (and the controller) sees the FLEET's admission pressure,
            # not just the master's shard; cumulative, so no zeroing
            for job in self.jobs.values():
                if job.job_id and job.backoffs:
                    m.gauge(
                        "job_backoffs", job=str(job.job_id)
                    ).set(job.backoffs)
        if self._obs_sync_armed and now >= self._next_obs_sync:
            self._next_obs_sync = now + self.cfg.obs_sync_interval
            if self.is_master:
                # the master's own journeys join the fleet stores
                # directly (head -> /trace/units, promoted -> tails)
                self._route_journeys(self.journeys.take_done())
                if self.journeys.tail:
                    # refresh the per-(job, type) p99 promotion
                    # thresholds from the merged fleet unit_total_s
                    # cells; install locally and cache for the gossip
                    # replies that carry them to the closing servers
                    thr = self._tail_thresholds()
                    self._tail_thr_cache = [
                        [j, t, v] for (j, t), v in thr.items()
                    ]
                    self.journeys.tail_thr = thr
                if self._slo_engine is not None:
                    self._slo_evaluate(now)
                if self._controller is not None:
                    self._control_evaluate(now)
            else:
                self._obs_sync_send()
        if now >= self._next_state_sync:
            self._next_state_sync = now + interval
            if self.cfg.balancer == "tpu":
                # The snapshot walk is O(wq); at the fast balancer cadence
                # it is a real GIL tax on compute-bound workloads. Walk it
                # fast only while it matters: someone is parked (_hungry)
                # AND this server could contribute — untargeted inventory
                # for the solve, or its own parked requesters whose fresh
                # stamps keep them re-plannable. Memory pressure also
                # qualifies (planner-side admission wants fresh nbytes).
                # Otherwise a slow heartbeat (parks themselves send event
                # snapshots immediately).
                # rq length first: it is a plain Python len, while
                # untargeted_avail crosses into the C core (a GIL
                # release/re-acquire per call on this hot tick)
                relevant = self._hungry and (
                    len(self.rq) > 0 or self.wq.untargeted_avail > 0
                )
                if (
                    relevant
                    or self.mem.under_pressure
                    or now >= self._next_idle_snap
                ):
                    self._next_idle_snap = now + 0.25
                    self._send_snapshot()
                if (
                    self.wq.has_job_units(
                        min_job=max(self.cfg.balancer_max_jobs, 1)
                    )
                    and now - self._last_qmstat_event
                    >= self.cfg.qmstat_event_gap
                ):
                    # DOCUMENTED FALLBACK: namespaces the planner does
                    # not cover — ALL non-default jobs when
                    # balancer_max_jobs is 1 (the single-job world), else
                    # only OVERFLOW jobs (id >= balancer_max_jobs) —
                    # reach across servers via the RFR pull, driven by
                    # the same per-job qmstat gossip steal mode uses.
                    # Rate-limited by the steal-mode event limiter: this
                    # used to fire every balancer-cadence tick, an S-1
                    # fan-out each time.
                    self._last_qmstat_event = now
                    self._broadcast_qmstat()
            else:
                self._broadcast_qmstat()
            if self.mem.under_pressure:
                # spill tier first (local disk beats shipping bytes to a
                # peer); pushes remain for what spilling cannot absorb
                if self.spill is not None:
                    self._maybe_spill()
                if self.mem.under_pressure:
                    self._try_push()
        if self.is_master and self.cfg.balancer == "tpu":
            self._flush_hungry_shrink(now)
        if self.is_master and now >= self._next_exhaust_check:
            self._next_exhaust_check = now + self.cfg.exhaust_check_interval
            self._check_exhaustion(now)
            self._check_job_exhaustion(now)
        if self.world.use_debug_server and now >= self._next_ds_log:
            self._next_ds_log = now + self.cfg.debug_log_interval
            self._send_ds_log()
        if self.is_master and now >= self._next_pstats:
            self._next_pstats = now + self.cfg.periodic_log_interval
            self._kick_periodic_stats(now)
        if now >= self._next_selfdiag:
            self._next_selfdiag = now + self.cfg.selfdiag_interval
            self_diagnosis(self, now, stuck_after=self.cfg.selfdiag_stuck_after)

    # ------------------------------------------------------- helpers

    def _pin(self, seqno: int, rank: int) -> None:
        """Pin + lease: every reservation handed out is owned, so a dead
        owner's pins are findable in O(its leases) at reclaim time."""
        if self.spill is not None:
            # delivery needs the bytes: fault a spilled payload in at
            # reservation time (covers fused, handle, RFR, plan paths)
            unit = self.wq.get(seqno)
            if unit is not None and unit.spilled:
                self._unspill(unit)
        self.wq.pin(seqno, rank)
        self.leases.grant(seqno, rank)
        if self.journeys.live:
            unit = self.wq.get(seqno)
            if unit is not None and unit.spans is not None:
                # every reservation path (local match, plan enactment,
                # RFR service) pins here — the "match" hop
                self.journeys.stamp(unit, "match")
        if self.wlog is not None:
            self.wlog.log_pin(seqno, rank)

    def _consume(self, unit) -> None:
        """Remove a fetched/inlined unit and settle its lease + memory."""
        if self.hedges is not None:
            # every delivery funds the per-job hedge bucket, and a
            # delivery IS the terminal that closes a hedge race (the
            # universal settle: fused, handle, and relay-confirm paths
            # all pass through here)
            self.hedges.credit(unit.job)
            self._hedge_settle(unit)
        self.wq.remove(unit.seqno)
        self.leases.release(unit.seqno)
        self.mem.free(len(unit.payload))
        if self.wlog is not None:
            self.wlog.log_consume(unit.seqno)

    def _send_app(self, app: int, m: Msg) -> bool:
        """Protocol response to an app rank. Under the reclaim policy a
        dead destination (already marked, or its connection refuses) is
        absorbed — returns False so the caller can requeue anything it
        consumed — instead of crashing the reactor; the EOF-driven
        reclaim owns the rest of the cleanup."""
        if self.cfg.on_worker_failure == "reclaim" and app in self._dead_ranks:
            return False
        try:
            self.ep.send(app, m)
            return True
        except OSError:
            if self.cfg.on_worker_failure != "reclaim":
                raise
            self.flight.record(
                f"send to rank {app} failed mid-death ({m.tag.name})"
            )
            return False

    def _requeue_consumed(self, unit, prefix_fetched: bool = True) -> None:
        """Put a consumed-but-undeliverable unit back on the queue (its
        requester died between match and delivery). ``prefix_fetched``:
        whether the dead requester already accounted a prefix get for
        this member (True on the Get_reserved path, which orders
        common-first; False on the fused path, whose response carries
        only the suffix)."""
        if unit.target_rank >= 0 and unit.target_rank in self._dead_ranks:
            # targeted at the dead requester itself: dropping IS the
            # reclaim outcome (no other rank may take targeted work), and
            # the rank-dead sweep already ran, so nobody else will drop
            # it. A fused (suffix-only) drop must still forfeit the
            # member's prefix share — no get will ever account it; the
            # Get_reserved path's share was accounted by the dead
            # requester's common-first fetch.
            if not prefix_fetched:
                self._forfeit_common(unit.common_seqno,
                                     unit.common_server_rank)
            self._m_targeted_dropped.inc()
            if unit.spans is not None:
                self.journeys.close(unit, "dropped")
            self.flight.record(
                f"targeted_dropped rank={unit.target_rank} "
                f"seqno={unit.seqno} (undelivered)"
            )
            return
        unit.pinned = False
        unit.pin_rank = -1
        if self._bump_attempts(unit, in_wq=False):
            # retry budget exhausted: quarantined, not re-queued. A fused
            # member's prefix share was never accounted (suffix-only
            # delivery) and never will be — forfeit it so the prefix
            # still GCs under its live members.
            if unit.common_seqno >= 0 and not prefix_fetched:
                self._forfeit_common(unit.common_seqno,
                                     unit.common_server_rank)
            return
        self.mem.alloc(len(unit.payload))
        self.wq.add(unit)
        if self.wlog is not None:
            self.wlog.log_put(unit, -1, None)
        if unit.common_seqno >= 0 and prefix_fetched:
            # the dead requester fetched the prefix before this fetch
            # (Get_reserved orders common-first); the re-consumption
            # fetches it again
            self._forfeit_common(unit.common_seqno, unit.common_server_rank,
                                 op="credit")
        self.flight.record(f"lease_reclaimed seqno={unit.seqno} (undelivered)")
        self._m_leases_reclaimed.inc()

    # ------------------------------------------------------- spill tier
    # Config(spill_dir): above the spill watermark, cold/large parked
    # payloads move to the per-server spill file (runtime/spill.py) and
    # only metadata stays resident; every path that reads payload bytes
    # (pin->deliver, push, migrate, checkpoint, quarantine) faults them
    # back in first. The accountant tracks resident vs spilled bytes, so
    # watermarks/pushes/admission act on real RAM occupancy.

    def _spill_unit(self, unit) -> None:
        n = len(unit.payload)
        self.spill.put(unit.seqno, unit.payload)
        # remove/re-add so the queue's byte accounting and indexes track
        # the residency change (the heaps tolerate the duplicate entry)
        self.wq.remove(unit.seqno)
        unit.payload = b""
        unit.spilled = True
        unit.spill_len = n
        self.wq.add(unit)
        self.mem.note_spill(n)
        self._m_spills.inc()

    def _unspill(self, unit) -> None:
        """Fault a spilled payload back in (transparent to callers)."""
        if self.spill is None or not unit.spilled:
            return
        t0 = time.monotonic()
        payload = self.spill.take(unit.seqno)
        in_wq = self.wq.get(unit.seqno) is unit
        if in_wq:
            self.wq.remove(unit.seqno)
        unit.payload = payload
        unit.spilled = False
        unit.spill_len = 0
        if in_wq:
            self.wq.add(unit)
        self.mem.note_faultin(len(payload))
        self._m_faultins.inc()
        self._h_faultin.observe(time.monotonic() - t0)

    def _spill_drop(self, unit) -> None:
        """A spilled unit is being dropped outright (dead target, killed
        job): release its spill-file entry and accounting."""
        if self.spill is not None and unit.spilled:
            self.mem.note_spill_drop(self.spill.discard(unit.seqno))
            unit.spilled = False
            unit.spill_len = 0

    def _maybe_spill(self, incoming: int = 0) -> None:
        """Move cold parked payloads to disk until ``incoming`` more
        bytes fit under the spill watermark. Victims are unpinned
        resident payloads, largest first (fewest records for the most
        relief), oldest first among equals (cold before hot), at most 64
        a pass: the JAX package's ``nsmallest(64, ...)`` over the whole
        queue, taken here from the queue's resident index
        (``wq.spill_index``, runtime/spill.py), so a put above the
        watermark costs O(victims * log n) and reads no other unit."""
        if self.spill is None or self.mem.max_bytes <= 0:
            return
        frac = self.cfg.spill_watermark_frac or self.mem.soft_frac
        need = self.mem.curr + incoming - frac * self.mem.max_bytes
        if need <= 0:
            return
        index = self.wq.spill_index
        freed = 0
        for _ in range(64):
            if freed >= need:
                break
            u = index.pop()
            if u is None:
                break
            freed += len(u.payload)
            self._spill_unit(u)

    def _spill_fault_in_all(self) -> None:
        """Restore every spilled payload (checkpoint shards and WAL
        compaction snapshots serialize payload bytes; a transient
        resident spike beats silently checkpointing empty payloads)."""
        if self.spill is None:
            return
        for u in list(self.wq.units()):
            if u.spilled:
                self._unspill(u)

    def _least_loaded_peer(self, nbytes_needed: int = 0) -> int:
        """Least-loaded peer believed to have room for nbytes_needed, else
        least-loaded overall, else -1."""
        cap = self.cfg.max_malloc_per_server
        best, best_bytes = -1, None
        fallback, fallback_bytes = -1, None
        for s, st in self.peers.items():
            if s == self.rank:
                continue
            if fallback_bytes is None or st.nbytes < fallback_bytes:
                fallback, fallback_bytes = s, st.nbytes
            if cap > 0 and st.nbytes + nbytes_needed > cap:
                continue
            if best_bytes is None or st.nbytes < best_bytes:
                best, best_bytes = s, st.nbytes
        return best if best >= 0 else fallback

    def _reserve_resp(
        self, app_rank: int, rc: int, unit: Optional[WorkUnit] = None,
        holder: Optional[int] = None, fetch: bool = False,
        rqseqno: Optional[int] = None,
    ) -> None:
        # ``rqseqno`` echoes the request id being answered: reservation
        # responses are otherwise indistinguishable, and the prefetch
        # pipeline needs to match (and dedup re-sent duplicates of)
        # responses against its outstanding slots by id
        if rc != ADLB_SUCCESS:
            self._send_app(
                app_rank,
                msg(Tag.TA_RESERVE_RESP, self.rank, rc=rc, rqseqno=rqseqno),
            )
            return
        self.resolved_reserves += 1
        if fetch and (holder is None or holder == self.rank):
            # fused reserve+get (no reference analogue — upstream always
            # pays a second round trip, src/adlb.c:2976-3025): the unit is
            # local, so consume it now and inline the payload in the
            # reservation response. A batch-common unit inlines only its
            # SUFFIX plus the prefix handle: the client assembles from
            # its prefix cache (one fetch per client per prefix, hits
            # accounted via SS_COMMON_FORFEIT so server refcounts stay
            # exact).
            self._consume(unit)
            fields = dict(
                rc=ADLB_SUCCESS,
                rqseqno=rqseqno,
                work_type=unit.work_type,
                prio=unit.prio,
                work_len=unit.work_len,
                answer_rank=unit.answer_rank,
                payload=unit.payload,
                time_on_q=time.monotonic() - unit.time_stamp,
            )
            if unit.target_rank >= 0:
                # a stream closing early re-puts banked units; carrying
                # the targeting lets it preserve the only-R-may-run-it
                # contract instead of re-pooling the unit untargeted
                fields["target_rank"] = unit.target_rank
            if unit.common_len > 0:
                # The member's prefix share is accounted by the CLIENT
                # (fetch on miss, forfeit note on cache hit) — it cannot
                # be accounted here at consume time, because the prefix
                # must outlive the GC until every member's client has
                # actually read the bytes. A client that dies between
                # this delivery and its accounting therefore leaks the
                # prefix for the rest of the run — the same bounded-leak
                # trade-off the reclaim credit path documents
                # (CommonStore.credit), never a lost unit.
                fields.update(
                    common_len=unit.common_len,
                    common_server=unit.common_server_rank,
                    common_seqno=unit.common_seqno,
                )
            delivered = self._send_app(
                app_rank, msg(Tag.TA_RESERVE_RESP, self.rank, **fields)
            )
            if not delivered:
                # the dead requester never fetched the prefix (fused
                # responses carry only the suffix), so no common credit
                self._requeue_consumed(unit, prefix_fetched=False)
            elif unit.spans is not None:
                # fused local delivery is terminal: the payload left
                # with the reservation response
                self.journeys.deliver_close(unit)
            return
        handle = WorkHandle(
            seqno=unit.seqno,
            server_rank=holder if holder is not None else self.rank,
            common_len=unit.common_len,
            common_server_rank=unit.common_server_rank,
            common_seqno=unit.common_seqno,
        )
        self._send_reserve_handle(app_rank, unit, handle, rqseqno)

    def _reserve_resp_batch(
        self, app_rank: int, units: list, rqseqno: Optional[int] = None,
    ) -> None:
        """One TA_RESERVE_RESP carrying several consumed local units
        (get_work_batch); the binary codec carries the parallel per-unit
        fields as blist/list/flist kinds (codec.py ids 80-84)."""
        now = time.monotonic()
        self.resolved_reserves += len(units)
        for u in units:
            self._consume(u)
        delivered = self._send_app(
            app_rank,
            msg(
                Tag.TA_RESERVE_RESP,
                self.rank,
                rc=ADLB_SUCCESS,
                rqseqno=rqseqno,
                payloads=[u.payload for u in units],
                work_types=[u.work_type for u in units],
                prios=[u.prio for u in units],
                answer_ranks=[u.answer_rank for u in units],
                times_on_q=[now - u.time_stamp for u in units],
            ),
        )
        if not delivered:
            for u in units:
                self._requeue_consumed(u)
        else:
            for u in units:
                if u.spans is not None:
                    self.journeys.deliver_close(u)

    def _send_reserve_handle(self, app_rank, unit, handle,
                             rqseqno=None) -> None:
        # an undeliverable handle needs no requeue here: the unit stays
        # pinned under the dead rank's lease, which the EOF-driven
        # reclaim releases
        self._send_app(
            app_rank,
            msg(
                Tag.TA_RESERVE_RESP,
                self.rank,
                rc=ADLB_SUCCESS,
                rqseqno=rqseqno,
                work_type=unit.work_type,
                prio=unit.prio,
                handle=handle.to_ints(),
                work_len=unit.work_len,
                answer_rank=unit.answer_rank,
            ),
        )

    def _kick_periodic_stats(self, now: float) -> None:
        """Master starts a stats token around the server ring; each server
        adds its contribution and forwards; back at the master the sum is
        printed as STAT_APS chunks (reference ``src/adlb.c:712-753,
        2391-2465``)."""
        from adlb_tpu_torch.runtime import stats as pstats

        if self.no_more_work or self.done_by_exhaustion:
            return  # ring peers may already be shutting down
        self._pstats_seq += 1
        token = {
            "seq": self._pstats_seq,
            "t0": now,
            "entries": {self.rank: pstats.contribution(self)},
        }
        if self.world.nservers == 1:
            self.last_aggregate = pstats.aggregate(token, time.monotonic())
            self._last_aggregate_at = time.monotonic()
            pstats.emit_stat_aps(self.last_aggregate)
            return
        self._forward_pstats(token)

    def _forward_pstats(self, token: dict) -> None:
        # best-effort: a ring peer that already exited must not kill the
        # sender — stats tokens are droppable, the protocol ring is not
        try:
            self.ep.send(
                self._ring_next_live(),
                msg(Tag.SS_PERIODIC_STATS, self.rank, token=token),
            )
        except OSError:
            pass

    def _on_periodic_stats(self, m: Msg) -> None:
        from adlb_tpu_torch.runtime import stats as pstats

        token = m.token
        if self.is_master:
            # kept for the ops endpoint: /metrics serves this aggregate
            # (stamped with its ring seq + an age, so a stalled ring
            # reads as STALE data, not live data)
            self.last_aggregate = pstats.aggregate(token, time.monotonic())
            self._last_aggregate_at = time.monotonic()
            pstats.emit_stat_aps(self.last_aggregate)
            return
        token["entries"][self.rank] = pstats.contribution(self)
        self._forward_pstats(token)

    # ------------------------------------------- fleet metrics plane

    def _obs_sync_send(self) -> None:
        """Ship this server's delta registry snapshot + closed journeys
        to the master (the SS_OBS_SYNC gossip tick). Best-effort like
        the stats ring: the master dying aborts the world anyway."""
        journeys = self.journeys.take_done()
        delta = self.metrics.delta_snapshot(self._obs_last)
        # an empty delta still goes: the seq-stamped frame doubles as
        # the staleness heartbeat /healthz reads — an idle server stays
        # distinguishable from a wedged one
        self._obs_seq += 1
        extra = {}
        if self._prof is not None:
            # owned profiler: changed-stacks-only cumulative counters +
            # windows sealed since the last ship (lost frames heal —
            # same contract as the registry delta)
            pd = self._prof.take_delta(self._prof_memo)
            if pd:
                extra["prof"] = pd
        try:
            self.ep.send(
                self.world.master_server_rank,
                msg(Tag.SS_OBS_SYNC, self.rank, snap=delta,
                    journeys=journeys, seq=self._obs_seq, **extra),
            )
        except OSError:
            pass  # droppable; cumulative values heal on the next tick

    def _on_obs_sync(self, m: Msg) -> None:
        if not self.is_master:
            # master -> server reply: the tail-promotion thresholds
            # computed from the FLEET hist cells (list-of-triples wire
            # form; swapped whole so a mid-close read stays consistent)
            thr = m.data.get("thr")
            if thr is not None:
                self.journeys.tail_thr = {
                    (int(j), int(t)): float(v) for j, t, v in thr
                }
            # the master's alert rows ride the same reply (append-only
            # wire contract: an older server simply never reads the
            # key) — swapped whole, the fleet-wide agreement surface
            alerts = m.data.get("alerts")
            if alerts is not None:
                self._slo_alerts_remote = alerts
            return
        base = self._fleet_snaps.get(m.src) or {
            "counters": {}, "gauges": {}, "histograms": {},
        }
        snap = m.data.get("snap") or {}
        # publish-by-swap, never update-in-place: the ops HTTP thread
        # iterates these dicts concurrently, and an in-place update
        # inserting a first-seen key would blow up its iteration —
        # a fresh dict swapped in under the GIL is always safe to read
        self._fleet_snaps[m.src] = {
            "rank": m.src,
            "counters": {**base["counters"],
                         **snap.get("counters", {})},
            "gauges": {**base["gauges"], **snap.get("gauges", {})},
            "histograms": {**base["histograms"],
                           **snap.get("histograms", {})},
        }
        self._fleet_seen[m.src] = (
            int(m.data.get("seq", 0)), time.monotonic()
        )
        self._route_journeys(m.data.get("journeys") or ())
        pd = m.data.get("prof")
        if pd:
            # cumulative folded stacks overwrite per key (publish-by-
            # swap for the ops thread, like the registry snapshots);
            # sealed windows append to the per-rank ring
            base = self._prof_fleet.get(m.src) or {}
            stacks = pd.get("stacks")
            if stacks:
                self._prof_fleet[m.src] = {**base, **stacks}
            wins = self._prof_windows.get(m.src)
            if wins is None:
                wins = self._prof_windows[m.src] = deque(
                    maxlen=profile.MAX_WINDOWS
                )
            for w in pd.get("win") or ():
                wins.append(w)
        reply = {}
        if self.journeys.tail and self._tail_thr_cache:
            reply["thr"] = self._tail_thr_cache
        if self._slo_alerts_wire:
            reply["alerts"] = self._slo_alerts_wire
        if reply:
            # carry the promotion thresholds + alert rows back on the
            # same plane (best-effort, 1 small frame per gossip tick
            # per server)
            try:
                self.ep.send(
                    m.src, msg(Tag.SS_OBS_SYNC, self.rank, **reply)
                )
            except OSError:
                pass

    def _route_journeys(self, journeys) -> None:
        """Sort closed journeys into the master's fleet stores by their
        retention reasons: head-sampled -> /trace/units (the head-sampling
        store), any tail-promotion reason -> /trace/tails. A journey
        can be both (a head-sampled unit that also blew the p99)."""
        for j in journeys:
            why = j.get("why") or ["head"]
            if "head" in why:
                self._journeys_fleet.append(j)
            if any(w != "head" for w in why):
                self._tails_fleet.append(j)

    def _tail_thresholds(self) -> dict:
        """Per-(job, type) p99 of unit total latency over the MERGED
        fleet ``unit_total_s`` cells (the master's live registry + every
        gossiped snapshot). Hysteresis: a cell arms only past
        TAIL_MIN_COUNT closes, so a cold histogram promotes nothing."""
        agg: dict[tuple, list] = {}

        def add(bounds, counts, n, job, typ):
            key = (job, typ)
            cur = agg.get(key)
            if cur is None:
                agg[key] = [list(bounds), list(counts), n]
            elif len(cur[1]) == len(counts):
                cur[1] = [a + b for a, b in zip(cur[1], counts)]
                cur[2] += n

        for (name, labels), h in self.metrics._stable_items()[2]:
            if name != "unit_total_s":
                continue
            lab = dict(labels)
            try:
                add(h.bounds, h.counts, h.n,
                    int(lab["job"]), int(lab["type"]))
            except (KeyError, ValueError):
                continue
        for snap in list(self._fleet_snaps.values()):
            for key, h in snap.get("histograms", {}).items():
                if not key.startswith("unit_total_s{"):
                    continue
                lab = dict(
                    kv.split("=", 1)
                    for kv in key[len("unit_total_s{"):-1].split(",")
                )
                try:
                    add(h["bounds"], h["counts"], h["count"],
                        int(lab["job"]), int(lab["type"]))
                except (KeyError, ValueError):
                    continue
        return {
            key: quantile_of(bounds, counts, n, 0.99)
            for key, (bounds, counts, n) in agg.items()
            if n >= TAIL_MIN_COUNT
        }

    def _slo_evaluate(self, now: float) -> None:
        """One SLO evaluation tick (master reactor, inside the obs-sync
        tick): merge own registry + every gossiped snapshot, compute
        which live members are stale per the /healthz rule, run the
        engine, then act on transitions — flight event each, the
        ``alerts_firing`` gauge, the wire rows the gossip replies carry
        fleet-wide, and a live incident bundle on a page FIRING."""
        if now < self._next_slo_eval:
            return
        if self.cfg.slo_eval_interval > 0:
            self._next_slo_eval = now + self.cfg.slo_eval_interval
        eng = self._slo_engine
        eng.note_epoch(self.world.epoch, now)
        merged = Registry.merge(
            [self.metrics.snapshot()] + list(self._fleet_snaps.values())
        )
        # staleness per the /healthz rule: a gossiping member whose last
        # snapshot is older than 3 sync intervals has gone quiet — its
        # last values still sit in _fleet_snaps (merged above), so it
        # degrades the evaluation rather than silently zeroing it
        cadence = self.cfg.obs_sync_interval
        stale = [
            r for r, (_seq, at) in list(self._fleet_seen.items())
            if now - at > 3.0 * cadence
        ]
        transitions = eng.evaluate(now, merged, stale)
        self._slo_alerts_wire = eng.wire
        self._m_alerts_firing.set(eng.firing)
        for tr in transitions:
            self.flight.record(
                f"slo_alert {tr['name']} {tr['from']}->{tr['to']} "
                f"sev={tr['severity']} burn_fast={tr['burn_fast']} "
                f"burn_slow={tr['burn_slow']}"
            )
            if tr["to"] == "FIRING" and tr["severity"] == "page":
                self._slo_capture_incident(tr, now)

    def _slo_capture_incident(self, transition: dict, now: float) -> None:
        """Page-severity FIRING: snapshot the evidence bundle (tails +
        stacks + metrics delta + topology) while the world is still
        degraded, write it atomically to flight_dir, and keep it in the
        ring /incidents serves. Evidence capture must never take the
        reactor down — a failed bundle is a flight note, not a crash."""
        from adlb_tpu_torch.obs import flight as _flight
        from adlb_tpu_torch.obs.slo import build_incident

        try:
            doc = build_incident(self, self._slo_engine, transition, now)
        except Exception as e:  # noqa: BLE001 — evidence is best-effort
            self.flight.record(f"incident_build_failed {e!r:.120}")
            return
        path = _flight.write_incident(
            self.flight.out_dir, transition["name"], doc
        )
        if path is not None:
            doc["artifact"] = path
        self._incidents.append(doc)
        self.flight.record(
            f"incident_captured {transition['name']} "
            f"suspects={doc['suspect_ranks']} artifact={path}"
        )

    def _control_evaluate(self, now: float) -> None:
        """One controller tick (master reactor, inside the obs-sync
        tick, right after the SLO evaluation whose ``firing`` count it
        consumes): assemble the sensor frame, run the decision rules,
        enact what came back ``act`` (rewriting the outcome to
        ``enacted``/``error`` in place — the controller's history holds
        the same dicts, so GET /control shows what actually happened),
        flight-record every new decision, and swap the published status
        doc the ops thread serves."""
        if now < self._next_control:
            return
        ctl = self._controller
        self._next_control = now + ctl.eval_interval
        inputs = self._control_inputs(now)
        for d in ctl.evaluate(now, inputs):
            if d["outcome"] == "act":
                self._control_enact(d)
            a = d["action"]
            self.flight.record(
                f"control {d['rule']} kind={a['kind']} "
                f"outcome={d['outcome']}"
            )
        ctl.publish(now, inputs)

    def _control_enact(self, d: dict) -> None:
        """Drive the actuator an ``act`` decision names. An actuator
        error never takes the reactor down — it lands in the decision
        record (outcome ``error``) and the rule retries after its
        cooldown window."""
        a = d["action"]
        kind = a["kind"]
        try:
            if kind == "scale_out":
                # spawnerless worlds park the request (satellite: the
                # registration drain services it) — still an action
                res = self._request_scale_out(
                    f"controller:{d['rule']}",
                    hot_rank=a.get("hot_rank"),
                )
                d["result"] = res
                if res.get("error"):
                    raise RuntimeError(res["error"])
            elif kind == "scale_in":
                d["result"] = self._handle_ctl({"op": "scale_in"})
            elif kind in ("throttle", "unthrottle"):
                # quota -1 restores unlimited (jobs.apply's update
                # encoding); the fanout reaches every server's admission
                # gate, not just the master's shard
                self._job_ctl_fanout(
                    "update", int(a["job"]), quota=int(a["quota_bytes"])
                )
            else:
                raise ValueError(f"unknown action kind {kind!r}")
        except Exception as e:  # noqa: BLE001 — record, don't crash
            d["outcome"] = "error"
            d["error"] = repr(e)
            return
        d["outcome"] = "enacted"
        self._controller.actions_total += 1
        self.metrics.counter("control_actions", kind=kind).inc()

    def _control_inputs(self, now: float) -> dict:
        """The controller's sensor frame, assembled from state the
        master reactor already holds: live membership, per-rank memory
        pressure (own meter + peer-advertised nbytes over cap), per-job
        fleet totals (own partitions + the gossiped ``job_*`` gauges),
        the SLO engine's firing count, quota backoffs, oldest lease."""
        cap = float(self.cfg.max_malloc_per_server)
        live = [
            s for s in self.world.server_ranks
            if s not in self._dead_servers
            and s not in self._draining_servers
            and self._is_live_member(s)
        ]
        pressure: dict = {}
        if cap > 0:
            pressure[self.rank] = self.mem.curr / cap
            for s in live:
                if s == self.rank:
                    continue
                p = self.peers.get(s)
                if p is not None:
                    pressure[s] = p.nbytes / cap
        jobs: dict = {}
        snaps = list(self._fleet_snaps.values())
        for job in self.jobs.values():
            jid = job.job_id
            if jid == 0:
                continue
            part = self.wq.part(jid)
            depth = part.count if part is not None else 0
            nbytes = part.total_bytes if part is not None else 0
            age = max(
                (now - u.time_stamp for u in part.units()), default=0.0
            ) if part is not None else 0.0
            backoffs = job.backoffs
            jl = f"job={jid}"
            for snap in snaps:
                g = snap.get("gauges") or {}
                depth += int(g.get(f"job_wq_depth{{{jl}}}", 0) or 0)
                nbytes += int(g.get(f"job_wq_bytes{{{jl}}}", 0) or 0)
                age = max(age, float(
                    g.get(f"job_oldest_age_s{{{jl}}}", 0.0) or 0.0))
                backoffs += int(g.get(f"job_backoffs{{{jl}}}", 0) or 0)
            jobs[jid] = {
                "depth": depth, "bytes": nbytes,
                "oldest_age_s": round(age, 3), "backoffs": backoffs,
                "quota_bytes": job.quota_bytes, "state": job.state,
            }
        return {
            "live_servers": len(live),
            "pressure": pressure,
            "firing": (self._slo_engine.firing
                       if self._slo_engine is not None else 0),
            "jobs": jobs,
            "backoffs": sum(j["backoffs"] for j in jobs.values()),
            "oldest_lease_s": self.leases.oldest_age(now),
            "epoch": self.world.epoch,
        }

    def _satisfy_parked(self, entry: RqEntry, unit: WorkUnit,
                        holder: Optional[int] = None,
                        local: bool = True) -> None:
        """Hand a unit to a parked requester and account the wait.

        ``local`` records how this rank's park got resolved — by a local
        put (True) or by cross-server delivery (push/migrate/unreserve
        re-match, False) — which drives the adaptive park-event gating in
        ``_on_reserve``."""
        self.rq.remove_entry(entry)
        # a delivery un-idles a streaming rank (it has work to chew on)
        # and demotes its sibling pipeline slots behind other ranks'
        # entries, so scarce inventory spreads instead of piling onto
        # one consumer's bank
        self._stream_idle.discard(entry.world_rank)
        self.rq.demote_rank(entry.world_rank)
        self._park_res_local[entry.world_rank] = local
        self._rfr_excluded.pop(entry.world_rank, None)
        wait = time.monotonic() - entry.time_stamp
        self._rq_wait_sum += wait
        self._rq_wait_n += 1
        self.activity += 1
        self._job_activity(entry.job)
        self._reserve_resp(entry.world_rank, ADLB_SUCCESS, unit,
                           holder=holder, fetch=entry.fetch,
                           rqseqno=entry.rqseqno)

    def _match_rq(self) -> None:
        """Re-scan parked requesters against the local queue — run after any
        event that adds/unpins work (the local analogue of the reference's
        ``check_remote_work_for_queued_apps``, ``src/adlb.c:3536-3579``)."""
        progressed = True
        while progressed:
            progressed = False
            for entry in self.rq.entries():
                unit = self.wq.find_match(entry.world_rank, entry.req_types,
                                          job=entry.job)
                if unit is not None:
                    self._pin(unit.seqno, entry.world_rank)
                    # _match_rq runs after cross-server deliveries
                    # (push/migrate arrivals, unreserve compensation)
                    self._satisfy_parked(entry, unit, local=False)
                    progressed = True
                    break

    # ------------------------------------------------- checkpoint / resume
    # No reference analogue (SURVEY §5: pool serialization absent there).
    # A client's FA_CHECKPOINT reaches the master, which circulates a ring
    # token; every server writes <prefix>.<rank>.ckpt (unpinned units + the
    # batch-common store); the master acks the origin client with the total
    # unit count. Restore happens at server init from the same shards.

    def _restore_from_checkpoint(self, prefix: str) -> None:
        from adlb_tpu_torch.runtime import checkpoint

        stray = set(checkpoint.existing_shard_ranks(prefix)) - set(
            self.world.server_ranks
        )
        if stray:
            # silently dropping higher-rank shards would lose their units;
            # the restore world must match the checkpoint's server set
            raise AdlbError(
                f"checkpoint {prefix} has shards for server ranks "
                f"{sorted(stray)} outside this world "
                f"({list(self.world.server_ranks)}); restore with the same "
                f"world shape"
            )
        units, centries = checkpoint.load_shard(
            prefix, self.rank, self.world,
            allow_legacy=self.cfg.allow_legacy_shards,
        )
        for u in units:
            payload = u.pop("payload")
            self.mem.alloc(len(payload))
            unit = WorkUnit(seqno=self._next_seqno, payload=payload,
                            home_server=self.rank, **u)
            self.wq.add(unit)
            if self.wlog is not None:
                self.wlog.log_put(unit, -1, None)
            self._next_seqno += 1
        for seqno, refcnt, ngets, buf in centries:
            self.mem.alloc(len(buf))
            self.cq.restore(seqno, refcnt, ngets, buf)
            if self.wlog is not None:
                self.wlog.log_common_put(seqno, buf)
                self.wlog.log_common_state(seqno, refcnt, ngets, 0)
        aprintf(
            self.cfg.aprintf_flag, self.rank,
            f"restored {len(units)} units, {len(centries)} common entries "
            f"from {prefix}",
        )

    def _write_checkpoint_shard(self, prefix: str) -> int:
        from adlb_tpu_torch.runtime import checkpoint

        self._spill_fault_in_all()  # shards serialize payload bytes
        return checkpoint.save_shard(prefix, self.rank, self.wq.units(),
                                     self.cq, world=self.world)

    def _on_fa_checkpoint(self, m: Msg) -> None:
        # native clients carry the path as bytes over the TLV codec
        path = m.path.decode() if isinstance(m.path, bytes) else m.path
        fwd = msg(Tag.SS_CHECKPOINT, self.rank, path=path, client=m.src,
                  started=False)
        if self.is_master:
            self._on_ss_checkpoint(fwd)
        else:
            self.ep.send(self.world.master_server_rank, fwd)

    def _on_ss_checkpoint(self, m: Msg) -> None:
        # units inside an unacked SS_MIGRATE_WORK live in no wq; holding
        # the token until the ack lands keeps them out of the lost-update
        # window (they are then in the destination's wq, and the
        # destination is later in the ring or re-sends bounces likewise)
        if self._migrate_unacked != 0:
            # a queue, not a slot: concurrent checkpoints from different
            # clients must all complete (each blocks on its own resp)
            if not hasattr(self, "_held_checkpoints"):
                self._held_checkpoints = []
            self._held_checkpoints.append(m)
            return
        self._process_checkpoint(m)

    def _process_checkpoint(self, m: Msg) -> None:
        if self.is_master and not m.started:
            n = self._write_checkpoint_shard(m.path)
            token = {"path": m.path, "client": m.client,
                     "counts": {self.rank: n}}
            if self.world.nservers == 1:
                self._ack_checkpoint(token)
            else:
                self._ring_forward(
                    lambda nxt: msg(Tag.SS_CHECKPOINT, self.rank,
                                    started=True, token=token)
                )
            return
        token = m.token
        if self.is_master:  # token came back around
            self._ack_checkpoint(token)
            return
        token["counts"][self.rank] = self._write_checkpoint_shard(
            token["path"]
        )
        self._ring_forward(
            lambda nxt: msg(Tag.SS_CHECKPOINT, self.rank, started=True,
                            token=token)
        )

    def _ack_checkpoint(self, token: dict) -> None:
        self.ep.send(
            token["client"],
            msg(Tag.TA_CHECKPOINT_RESP, self.rank, rc=ADLB_SUCCESS,
                count=sum(token["counts"].values())),
        )

    # ------------------------------------------------------- app handlers

    @staticmethod
    def _window_seen(store: dict, src: int, req_id) -> bool:
        """Per-sender bounded replay window: True when req_id was already
        recorded (a duplicate re-sent across connection churn — possibly
        REORDERED behind newer ids by the per-connection reader threads,
        so a high-water mark or last-id check would misclassify), else
        records it."""
        entry = store.get(src)
        if entry is None:
            entry = store[src] = (set(), deque())
        ids, order = entry
        if req_id in ids:
            return True
        ids.add(req_id)
        order.append(req_id)
        if len(order) > 512:
            ids.discard(order.popleft())
        return False

    def _put_seen(self, src: int, put_id) -> bool:
        entry = self._seen_puts.get(src)
        return entry is not None and put_id in entry[0]

    def _put_record(self, src: int, put_id) -> None:
        if put_id is None:
            return
        entry = self._seen_puts.get(src)
        if entry is None:
            entry = self._seen_puts[src] = (set(), deque())
        ids, order = entry
        ids.add(put_id)
        order.append(put_id)
        if len(order) > 512:
            ids.discard(order.popleft())

    def _on_put(self, m: Msg) -> None:
        self._m_puts.inc()
        # every put tags its request with a per-client id, echoed in the
        # response (pipelined puts match out-of-band responses by it; all
        # puts get re-send dedup from it)
        put_id = m.data.get("put_id")
        if put_id is not None and self._put_seen(m.src, put_id):
            # duplicate of an already-accepted put (the client re-sent
            # after a send error): idempotent ack, nothing stored twice
            self._send_app(
                m.src,
                msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_SUCCESS,
                    put_id=put_id),
            )
            return
        if self.no_more_work or self.done_by_exhaustion:
            self.ep.send(
                m.src, msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_NO_MORE_WORK,
                           put_id=put_id)
            )
            return
        jid = int(m.data.get("job_id", 0) or 0)
        job = None
        if jid:
            job = self.jobs.ensure(jid)
            if not job.accepts_puts:
                # draining/done/killed namespace: the job's no-more-work
                self.ep.send(
                    m.src,
                    msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_NO_MORE_WORK,
                        put_id=put_id),
                )
                return
            if job.quota_bytes > 0 and m.target_rank < 0:
                # per-tenant admission quota: the job's queued bytes on
                # THIS server against its per-server cap — the memory-watermark
                # backpressure rc scoped to the tenant. Targeted puts
                # exempt (answer/completion traffic; stalling it
                # starves the consumers that drain the quota).
                part = self.wq.part(jid)
                used = part.total_bytes if part is not None else 0
                if used + len(m.payload) > job.quota_bytes:
                    job.backoffs += 1
                    self._m_put_backoffs.inc()
                    self.flight.record(
                        f"job_quota_backoff job={jid} src={m.src} "
                        f"used={used} quota={job.quota_bytes}"
                    )
                    self.ep.send(
                        m.src,
                        msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_BACKOFF,
                            retry_after_ms=25, put_id=put_id),
                    )
                    return
        if m.target_rank >= 0 and not self.world.is_app(m.target_rank) \
                and m.target_rank not in self._dead_ranks \
                and m.target_rank not in self.world.detached:
            # elastic membership: the CLIENT passed an above-base-world
            # target through (it cannot tell an attached member from a
            # typo) — the servers hold the authoritative membership, so
            # an unknown member is answered loudly, never parked forever
            self._send_app(
                m.src,
                msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_ERROR,
                    put_id=put_id),
            )
            return
        if m.target_rank >= 0 and (
            m.target_rank in self._dead_ranks
            or m.target_rank in self.world.detached
        ):
            # targeted at a dead (or cleanly detached) rank:
            # accept-and-drop (at-most-once — the
            # unit could never be fetched), keeping the batch-common
            # refcount correct so the prefix still GCs
            self._m_targeted_dropped.inc()
            self.flight.record(
                f"targeted_dropped rank={m.target_rank} src={m.src} "
                f"(put to dead target)"
            )
            self._forfeit_common(m.common_seqno, m.common_server)
            self._put_record(m.src, put_id)
            self._send_app(
                m.src,
                msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_SUCCESS,
                    put_id=put_id),
            )
            return
        # empty->nonempty observation must happen BEFORE the unit lands:
        # it drives the steal-mode event qmstat below (peers whose view
        # dates from the last drain believe this type has nothing)
        type_was_empty = (
            (self.cfg.balancer == "steal" or jid != 0)
            and self.cfg.qmstat_mode == "broadcast"
            and self.cfg.qmstat_event_gap > 0
            and m.target_rank < 0
            and self.wq.hi_prio_of_type(m.work_type, job=jid)
            <= ADLB_LOWEST_PRIO
        )
        payload: bytes = m.payload
        if self.spill is not None:
            # spill tier: make room from cold parked payloads BEFORE the
            # watermark checks, so a put storm over the soft watermark
            # degrades to slower-fetch (spilled cold units) instead of
            # ADLB_BACKOFF / ADLB_PUT_REJECTED
            self._maybe_spill(len(payload))
        if (
            m.target_rank < 0
            and self.mem.above_hard(len(payload))
            and not self._peer_has_room(len(payload))
        ):
            # overload backpressure (Config(mem_hard_frac) > 0): above the
            # hard watermark with nowhere to point the putter, a reject
            # hint would only bounce it between equally-full servers
            # until its retry budget aborts the producer — answer
            # ADLB_BACKOFF with a retry-after hint instead, so the
            # producer stalls (shedding load into its own pacing) while
            # consumers drain this server below the watermark.
            # UNTARGETED puts only: a targeted put is answer/completion
            # traffic bound to THIS home server (no peer can take it),
            # and stalling completions starves the very consumers whose
            # fetches drain the pressure — the classic backpressure
            # deadlock. Targeted puts fall through to the reference
            # admission path (hard reject at the cap).
            self._m_put_backoffs.inc()
            self.flight.record(
                f"put_backoff src={m.src} nbytes={len(payload)} "
                f"curr={self.mem.curr}"
            )
            self.ep.send(
                m.src,
                msg(
                    Tag.TA_PUT_RESP,
                    self.rank,
                    rc=ADLB_BACKOFF,
                    retry_after_ms=25,
                    put_id=put_id,
                ),
            )
            return
        if not self.mem.try_alloc(len(payload)):
            self.stats[InfoKey.NREJECTED_PUTS] += 1
            self.flight.record(
                f"put rejected from rank {m.src} ({len(payload)}B, "
                f"curr={self.mem.curr})"
            )
            self.ep.send(
                m.src,
                msg(
                    Tag.TA_PUT_RESP,
                    self.rank,
                    rc=ADLB_PUT_REJECTED,
                    hint=self._least_loaded_peer(len(payload)),
                    put_id=put_id,
                ),
            )
            return
        unit = WorkUnit(
            seqno=self._next_seqno,
            work_type=m.work_type,
            prio=m.prio,
            target_rank=m.target_rank,
            answer_rank=m.answer_rank,
            payload=payload,
            home_server=self.rank,
            common_len=m.common_len,
            common_server_rank=m.common_server,
            common_seqno=m.common_seqno,
            job=jid,
        )
        self._next_seqno += 1
        trace_id = m.data.get("trace_id")
        if trace_id:
            # head-sampled unit: arm the journey (put_recv stamp) before
            # anything else happens to it — the wlog append below then
            # carries the context to the buddy/WAL with the unit
            self.journeys.begin(unit, trace_id, time.monotonic())
        elif self.journeys.tail:
            # tail mode: EVERY put accumulates spans under a server-
            # minted (negative) id; whether the journey is KEPT is
            # decided at terminal close (p99 / anomalous-end promotion)
            self.journeys.begin_tail(unit, time.monotonic())
        self.wq.add(unit)
        if unit.trace_id > 0:
            # the enqueue hop separates admission work from queue wait —
            # meaningful at head-sample volume, but its delta is this
            # handler's own microseconds, so the every-unit tail arm
            # skips it (tail attribution charges the wait to "match")
            self.journeys.stamp(unit, "enqueue")
        if self.wlog is not None:
            self.wlog.log_put(unit, m.src, put_id)
        self.stats[InfoKey.MAX_WQ_COUNT] = max(
            self.stats[InfoKey.MAX_WQ_COUNT], self.wq.count
        )
        self.activity += 1
        if job is not None:
            job.puts += 1
            job.activity += 1
        self._exhaust_held_since = None
        # immediate match against parked requesters (reference
        # rq_find_rank_queued_for_type on FA_PUT_HDR, src/adlb.c:988-1042)
        entry = self.rq.find_for_type(unit.work_type, unit.target_rank,
                                      job=jid)
        if entry is not None:
            self._pin(unit.seqno, entry.world_rank)
            self._satisfy_parked(entry, unit)
        elif unit.target_rank >= 0:
            # elastic membership: a targeted put can land OFF the
            # target's home (a static client's base-modulo route cannot
            # know an attached rank's assigned home, and a rank attached
            # after the putter's view was seeded re-homes under a later
            # epoch). Announce the inventory to the target's home so its
            # TargetedDirectory redirects the rank's reserve here —
            # exactly the off-home directory the failover re-announce
            # path already maintains. Static worlds never take this
            # branch (clients route targeted puts home by construction).
            try:
                t_home = self.world.home_server(unit.target_rank)
            except KeyError:
                t_home = self.rank  # not yet a member here: the rank's
                # own reserve traffic will find it once membership lands
            if t_home != self.rank:
                self._send_srv(
                    t_home,
                    msg(Tag.SS_MOVING_TARGETED_WORK, self.rank,
                        app_rank=unit.target_rank,
                        work_type=unit.work_type,
                        from_server=-1, to_server=self.rank, count=1),
                )
        self._put_record(m.src, put_id)
        # write-ahead replication: the unit's log entry must be on the
        # wire BEFORE the accept ack, or a server death in between loses
        # an acked put uncountably (the client, once acked, never
        # re-sends). One extra one-way frame per accepted put, failover
        # mode only.
        self._flush_repl()
        resp = msg(Tag.TA_PUT_RESP, self.rank, rc=ADLB_SUCCESS,
                   put_id=put_id)
        if self.wal is not None:
            # write-ahead DURABILITY: the ack is held until the group
            # commit that fsyncs this put's entry (released immediately
            # when wal_fsync_ms == 0)
            if unit.spans is not None and put_id is not None:
                # stamp "wal_commit" when the covering fsync releases
                # this ack (see _release_wal_acks)
                self._trace_wal_pending[(m.src, put_id)] = unit
            self.wal.defer_ack(m.src, resp)
            self._flush_wal()
        else:
            self._send_app(m.src, resp)
        if (
            entry is None
            and self.cfg.balancer == "tpu"
            and unit.job == 0
            and unit.target_rank < 0
            and self._hungry_for(unit.work_type)
        ):
            # event-driven like parks: new unmatched inventory reaches the
            # balancer immediately (rate-limited), so a requester parked on
            # ANOTHER server isn't left waiting for the next heartbeat.
            # Only untargeted puts of a type someone is parked for —
            # targeted puts match at the target's home server and never
            # enter snapshots. An O(1) DELTA (just unit metadata), not
            # the O(wq) snapshot walk: at put rates the walk is a
            # measurable GIL tax (the full snapshot still flows on parks,
            # hungry-transitions, and the heartbeat). Units putting
            # faster than the rate limit accumulate and flush as one
            # batched delta (see _send_task_delta).
            self._send_task_delta(unit)
        elif entry is None and type_was_empty:
            # steal-mode dispatch latency: this put flipped a type's
            # advertised inventory from empty to nonempty, and a
            # requester parked on ANOTHER server can only discover it
            # through qmstat — broadcasting now (rate-limited) instead
            # of waiting out the periodic tick turns the trickle p50
            # from gossip-cadence wait into one delivery leg. Peers
            # re-run _try_rfr on every fresh qmstat, so the broadcast
            # alone re-arms their parked entries. Ring mode stays
            # upstream-faithful (interval-only).
            now = time.monotonic()
            if now - self._last_qmstat_event >= self.cfg.qmstat_event_gap:
                self._last_qmstat_event = now
                self._broadcast_qmstat()

    def _on_put_common(self, m: Msg) -> None:
        if self.spill is not None:
            self._maybe_spill(len(m.payload))
        if not self.mem.try_alloc(len(m.payload)):
            self.ep.send(
                m.src,
                msg(Tag.TA_PUT_COMMON_RESP, self.rank, rc=ADLB_PUT_REJECTED,
                    common_seqno=-1),
            )
            return
        seqno = self.cq.put(m.payload)
        if self.wlog is not None:
            self.wlog.log_common_put(seqno, m.payload)
        self._flush_repl()  # write-ahead, like the put ack
        resp = msg(Tag.TA_PUT_COMMON_RESP, self.rank, rc=ADLB_SUCCESS,
                   common_seqno=seqno)
        if self.wal is not None:
            self.wal.defer_ack(m.src, resp)  # durable before acked
            self._flush_wal()
        else:
            self.ep.send(m.src, resp)

    def _on_batch_done(self, m: Msg) -> None:
        cseq = m.common_seqno
        fo = m.data.get("fo_from")
        if fo is not None:
            # rerouted from a failed-over server: translate to the adopted
            # prefix — applying the dead server's seqno untranslated could
            # finalize an UNRELATED local prefix's refcount
            cseq = self._adopted_common_for(fo, cseq)
            if cseq is None:
                return  # prefix lost to replication lag; members' fetches
                #         are counted at _on_get_common
        if self.wlog is not None:
            self.wlog.log_common_refcnt(cseq, m.refcnt)
        self.cq.set_refcnt(cseq, m.refcnt)

    def _on_did_put_at_remote(self, m: Msg) -> None:
        """A targeted put landed off the target's home server; record it and,
        if the target is already parked here, go fetch it (reference
        ``src/adlb.c:2845-2852`` + tq, ``src/xq.h:73-79``)."""
        self.tq.add(m.target_rank, m.work_type, m.server_rank)
        for cand in self.rq.entries():
            if cand.world_rank == m.target_rank and cand.wants(m.work_type):
                self._try_rfr(cand)
                break

    def _on_reserve(self, m: Msg) -> None:
        app = m.src
        rq_id = m.data.get("rqseqno")
        if rq_id is not None:
            # duplicate frame (re-sent across connection churn):
            # processing it again would pin a second unit for the same
            # request. A windowed SEEN-SET, not a monotone high-water
            # mark: with the prefetch pipeline several reserves are in
            # flight, and a reconnect re-send on a NEW connection can be
            # processed before an older frame still queued from the old
            # connection's reader — a max-based filter would discard
            # that never-processed older reserve and leak a stream slot.
            if self._window_seen(self._seen_rqseqnos, app, rq_id):
                return
        self._m_reserves.inc()
        self.stats[InfoKey.NUM_RESERVES] += 1
        # binary-codec clients encode "any type" by omitting the field
        raw_types = m.data.get("req_types")
        req_types = None if raw_types is None else frozenset(raw_types)
        jid = int(m.data.get("job_id", 0) or 0)
        if app in self.local_apps:
            # a reserve names the namespace the rank consumes from —
            # evidence for the per-job exhaustion vote
            self._rank_job[app] = jid
        if self.no_more_work:
            self._reserve_resp(app, ADLB_NO_MORE_WORK, rqseqno=rq_id)
            return
        if self.done_by_exhaustion:
            self._reserve_resp(app, ADLB_DONE_BY_EXHAUSTION, rqseqno=rq_id)
            return
        if jid:
            from adlb_tpu_torch.runtime import jobs as jobsmod

            jstate = self.jobs.ensure(jid).state
            if jstate == jobsmod.DONE:
                self._reserve_resp(app, ADLB_DONE_BY_EXHAUSTION,
                                   rqseqno=rq_id)
                return
            if jstate == jobsmod.KILLED:
                self._reserve_resp(app, ADLB_NO_MORE_WORK, rqseqno=rq_id)
                return
        fetch = bool(m.data.get("fetch", False))
        # clamped: the codec's list element counts are u16, and an
        # unclamped value would make the batch frame unencodable
        fetch_max = min(int(m.data.get("fetch_max", 1) or 1), 4096)
        unit = self.wq.find_match(app, req_types, job=jid)
        if unit is not None:
            self._pin(unit.seqno, app)
            self.activity += 1
            self._job_activity(jid)
            self._n_reserve_immed += 1
            if fetch and fetch_max > 1 and unit.common_len == 0:
                # batched fused fetch: pop up to fetch_max local prefix-free
                # matches into ONE response — the consumer loop's round
                # trips amortize over the batch, and only locally-positioned
                # inventory can batch (remote holders and prefixed units
                # stop the collection), so the mode that pre-positions work
                # locally is the mode that benefits
                units = [unit]
                while len(units) < fetch_max:
                    extra = self.wq.find_match(app, req_types, job=jid)
                    if extra is None or extra.common_len != 0:
                        break
                    self._pin(extra.seqno, app)
                    units.append(extra)
                self._reserve_resp_batch(app, units, rqseqno=rq_id)
                return
            self._reserve_resp(app, ADLB_SUCCESS, unit, fetch=fetch,
                               rqseqno=rq_id)
            return
        if not m.hang:
            self._reserve_resp(app, ADLB_NO_CURRENT_WORK, rqseqno=rq_id)
            return
        self.stats[InfoKey.NUM_RESERVES_PUT_ON_RQ] += 1
        entry = RqEntry(world_rank=app, rqseqno=m.rqseqno,
                        req_types=req_types, fetch=fetch,
                        prefetch=bool(m.data.get("prefetch", False)),
                        job=jid)
        self.rq.add(entry)
        self._rfr_excluded.pop(app, None)
        self._try_rfr(entry)
        if self.cfg.balancer == "tpu" and not self._park_res_local.get(
            app, False
        ):
            # event-driven: a park immediately refreshes this server's
            # requester state at the balancer instead of waiting for the
            # next heartbeat (rate-limited). Reqs-only: the park changed
            # the rq, not the wq, so the O(wq) task walk + fat frame are
            # skipped. Adaptive: skipped entirely for ranks whose last park
            # resolved locally (fine-grained answer economies park per
            # task and are served by local/targeted puts in microseconds —
            # the balancer can't beat that, and the event would be pure
            # GIL tax); a rank the balancer last had to serve remotely
            # keeps the immediate event flow. A misprediction only defers
            # discovery to the heartbeat.
            now = time.monotonic()
            if now - self._last_event_snap >= self.cfg.balancer_min_gap:
                self._last_event_snap = now
                self._send_snapshot(reqs_only=True)

    def _on_stream_idle(self, m: Msg) -> None:
        """The rank's get_work_stream bank ran dry: it is genuinely
        blocked now, so its prefetch reserves become park-eligible for
        exhaustion voting. Any delivery to the rank clears the mark.

        The note carries the client's outstanding reserve ids (slots):
        honoring it only when they exactly match what is parked here
        voids a note that CROSSED a delivery on the wire — the client is
        about to find work in its bank (and may put descendants), so
        marking it idle would open a premature-exhaustion window. The
        client re-announces (1 s cadence) while it stays blocked.

        A rank whose reserves were swept by the rank-death reclaim and
        then resurrected still counts phantom slots no response will
        ever resolve. Those are the claimed ids that are neither parked
        nor in the post-death request window (the window is reset at the
        sweep, so ids the server answered BEFORE the death — responses
        possibly lost with the connection — read as phantom too): each
        is answered with ADLB_RETRY so the stream re-arms it under a
        fresh rqseqno. Claimed ids the server processed after the
        resurrection are deliveries in flight, never re-armed."""
        slots = m.data.get("slots")
        parked_ids = self.rq.ids_for(m.src)
        if m.src in self._swept_streams and slots is not None:
            self._swept_streams.discard(m.src)
            seen = self._seen_rqseqnos.get(m.src)
            seen_ids = seen[0] if seen is not None else ()
            phantom = [i for i in slots
                       if i not in parked_ids and i not in seen_ids]
            for i in phantom:
                self._send_app(
                    m.src,
                    msg(Tag.TA_RESERVE_RESP, self.rank, rc=ADLB_RETRY,
                        rqseqno=i),
                )
            if phantom:
                return  # the re-arms will park; idle re-announces then
        if slots is not None:
            if parked_ids and set(slots) == parked_ids:
                self._stream_idle.add(m.src)
            return
        # legacy count-only note (no slot list): match on count alone
        inflight = m.data.get("inflight")
        if parked_ids and (inflight is None or inflight == len(parked_ids)):
            self._stream_idle.add(m.src)

    def _on_stream_cancel(self, m: Msg) -> None:
        """Drop the rank's prefetch reserves (stream close / finalize).
        Acked so the client can drain deliveries that raced the cancel —
        per-peer FIFO puts any such delivery ahead of this response."""
        self.rq.remove_prefetch(m.src)
        self._stream_idle.discard(m.src)
        self._send_app(
            m.src, msg(Tag.TA_STREAM_CANCEL_RESP, self.rank, rc=ADLB_SUCCESS)
        )

    def _on_get_reserved(self, m: Msg) -> None:
        fo = m.data.get("fo_from")
        if fo is not None:
            # fetch rerouted from a failed-over server: the adopted pin
            # serves under its translated seqno; a consumed-at-death unit
            # (tombstone — its response died with the server) or one lost
            # to replication lag answers ADLB_RETRY (re-reserve), counted
            new = self._adopted_units.get((fo, m.seqno))
            if new is None:
                if (fo, m.seqno, m.src) in self._adopted_fences:
                    # the predecessor fenced this owner's lease before
                    # dying (replicated): a rejected settle, NOT a
                    # counted loss — the re-enqueued unit is live
                    self._send_app(
                        m.src,
                        msg(Tag.TA_GET_RESERVED_RESP, self.rank,
                            rc=ADLB_FENCED),
                    )
                    return
                # once per (dead server, seqno): the promote pass may
                # already have counted it (lost prefix), and a re-sent
                # fetch must not count it twice
                if (fo, m.seqno) not in self._counted_lost:
                    self._counted_lost.add((fo, m.seqno))
                    self._m_failover_lost.inc()
                    self.flight.record(
                        f"failover_lost fetch seqno={m.seqno} from={fo} "
                        f"rank={m.src} "
                        f"tombstoned={(fo, m.seqno) in self._adopted_tombs}"
                    )
                self._send_app(
                    m.src,
                    msg(Tag.TA_GET_RESERVED_RESP, self.rank, rc=ADLB_RETRY),
                )
                return
            m.data["seqno"] = new
        unit = self.wq.get(m.seqno)
        if unit is None or not unit.pinned or unit.pin_rank != m.src:
            cached = self._last_get_resp.get(m.src)
            if cached is not None and cached[0] == m.seqno:
                # duplicate of the fetch we just served (request re-sent
                # across connection churn): the consume is unrepeatable,
                # so replay the cached response instead of raising
                self._send_app(m.src, cached[1])
                return
            if (m.seqno, m.src) in self._fences:
                # the requester's lease on this unit EXPIRED (it went
                # silent past lease_timeout_s) and the unit re-enqueued
                # under a fresh attempt: this late settle is rejected —
                # the fencing half of at-least-once. The client maps
                # ADLB_FENCED onto its ADLB_RETRY path (drop the handle,
                # re-reserve).
                self.flight.record(
                    f"fenced get_reserved seqno={m.seqno} rank={m.src}"
                )
                self._send_app(
                    m.src,
                    msg(Tag.TA_GET_RESERVED_RESP, self.rank,
                        rc=ADLB_FENCED),
                )
                return
            if (
                self.cfg.on_worker_failure == "reclaim"
                and m.src in self._resurrected
            ):
                # the requester was declared dead and came back: its
                # pre-death lease was reclaimed (the unit re-enqueued or
                # already consumed elsewhere), so the handle is void —
                # a retriable code tells it to re-reserve, not to die
                self._send_app(
                    m.src,
                    msg(Tag.TA_GET_RESERVED_RESP, self.rank, rc=ADLB_RETRY),
                )
                return
            if m.seqno in self._killed_units:
                # the unit's job was killed between reserve and fetch:
                # the handle is void and the namespace is closed — the
                # terminal code, not a retry loop
                self._send_app(
                    m.src,
                    msg(Tag.TA_GET_RESERVED_RESP, self.rank,
                        rc=ADLB_NO_MORE_WORK),
                )
                return
            if self._failover:
                # a failover sweep may have unpinned/re-matched this unit
                # (its handoff was routed via a dead home server): the
                # handle is void, not a protocol error — re-reserve
                self.flight.record(
                    f"void handle seqno={m.seqno} rank={m.src} "
                    f"(failover sweep); answering ADLB_RETRY"
                )
                self._send_app(
                    m.src,
                    msg(Tag.TA_GET_RESERVED_RESP, self.rank, rc=ADLB_RETRY),
                )
                return
            # invalid handle — the reference aborts the job here
            # (src/adlb.c:1349-1357)
            raise AdlbError(
                f"server {self.rank}: invalid GET_RESERVED seqno {m.seqno} "
                f"from rank {m.src}"
            )
        # only an HONORED fetch clears a relay marker: a stale replay
        # from a resurrected rank must not erase the at-most-once
        # protection of a live relay to the unit's NEW owner
        self._relay_inflight.pop(m.seqno, None)
        self._consume(unit)
        resp = msg(
            Tag.TA_GET_RESERVED_RESP,
            self.rank,
            rc=ADLB_SUCCESS,
            payload=unit.payload,
            time_on_q=time.monotonic() - unit.time_stamp,
        )
        # at-most-once cache (one response per sender, replaced by its
        # next fetch): a re-sent request replays this instead of raising
        self._last_get_resp[m.src] = (m.seqno, resp)
        delivered = self._send_app(m.src, resp)
        if not delivered:
            self._requeue_consumed(unit)
        elif unit.spans is not None:
            # handle-path fetch served: the terminal hop
            self.journeys.deliver_close(unit)

    def _on_get_common(self, m: Msg) -> None:
        fo = m.data.get("fo_from")
        if fo is not None:
            # fetch rerouted from a failed-over server: translate to the
            # adopted prefix
            new = self._adopted_common_for(fo, m.common_seqno)
            if new is None:
                # prefix lost to replication lag: a counted loss answered
                # with ADLB_RETRY — the consumer discards this member and
                # re-reserves (ADLB_ERROR would read as terminal and the
                # unit would vanish UNcounted, breaking the conservation
                # contract of USERGUIDE §9). Idempotent under re-sends:
                # the same request replayed across churn answers RETRY
                # again without a second count.
                gid = m.data.get("get_id")
                if gid is None or self._last_common.get(m.src) != gid:
                    if gid is not None:
                        self._last_common[m.src] = gid
                    self._m_failover_lost.inc()
                    self.flight.record(
                        f"failover_lost common fo_from={fo} "
                        f"seqno={m.common_seqno} from {m.src}"
                    )
                self._send_app(
                    m.src, msg(Tag.TA_GET_COMMON_RESP, self.rank,
                               rc=ADLB_RETRY, payload=b""),
                )
                return
            m.data["common_seqno"] = new
        get_id = m.data.get("get_id")
        if get_id is not None and self._last_common.get(m.src) == get_id:
            # duplicate of the fetch we just served (matched by request
            # id — the same SEQNO repeats legitimately, one fetch per
            # batch member): re-serve without counting a second get
            # against the refcount; silently drop if GC'd (the original
            # response was already delivered)
            buf = self.cq.peek(m.common_seqno)
            if buf is not None:
                self._send_app(
                    m.src, msg(Tag.TA_GET_COMMON_RESP, self.rank,
                               rc=ADLB_SUCCESS, payload=buf),
                )
            return
        if get_id is not None:
            self._last_common[m.src] = get_id
        if self.wlog is not None:
            self.wlog.log_common_op(
                m.common_seqno, "get", m.src,
                get_id if get_id is not None else -1,
            )
        buf = self.cq.get(m.common_seqno)
        if buf is None:
            # gone: a reclaim double-get outran its credit (narrow race)
            # or an invalid handle — an error response, not a dead server
            from adlb_tpu_torch.types import ADLB_ERROR

            self.flight.record(
                f"get_common miss seqno={m.common_seqno} from {m.src}"
            )
            self._send_app(
                m.src, msg(Tag.TA_GET_COMMON_RESP, self.rank,
                           rc=ADLB_ERROR, payload=b""),
            )
            return
        self._send_app(
            m.src, msg(Tag.TA_GET_COMMON_RESP, self.rank, rc=ADLB_SUCCESS,
                       payload=buf)
        )

    def _on_info_num(self, m: Msg) -> None:
        n, nbytes = self.wq.count_of_type(m.work_type)
        self.ep.send(
            m.src,
            msg(
                Tag.TA_INFO_NUM_RESP,
                self.rank,
                rc=ADLB_SUCCESS,
                count=n,
                nbytes=nbytes,
                max_wq=int(self.stats[InfoKey.MAX_WQ_COUNT]),
            ),
        )

    def _on_info_get(self, m: Msg) -> None:
        """Live Info_get from a client: one stats value from its home server
        (reference ``src/adlb.c:3072-3141``)."""
        try:
            key = InfoKey(m.key)
        except ValueError:
            self.ep.send(
                m.src, msg(Tag.TA_INFO_GET_RESP, self.rank, rc=-1, value=0.0)
            )
            return
        if key is InfoKey.MALLOC_HWM:
            value = float(self.mem.hwm)
        elif key is InfoKey.AVG_TIME_ON_RQ:
            value = self._rq_wait_sum / self._rq_wait_n if self._rq_wait_n else 0.0
        elif key is InfoKey.RSS_KB:
            from adlb_tpu_torch.utils.stats import rss_kb

            value = float(rss_kb())
        elif key is InfoKey.TRANSPORT_BACKLOG:
            value = float(
                self.ep.backlog() if hasattr(self.ep, "backlog") else 0
            )
        else:
            value = float(self.stats.get(key, 0.0))
        self.ep.send(
            m.src,
            msg(Tag.TA_INFO_GET_RESP, self.rank, rc=ADLB_SUCCESS, value=value),
        )

    # ------------------------------------------------------- stealing (pull)

    def _try_rfr(self, entry: RqEntry) -> None:
        """Pick a peer believed to hold matching work and ask it to pin one
        unit for this requester (reference RFR, ``src/adlb.c:1278-1309``)."""
        app = entry.world_rank
        if app in self._rfr_out:
            return
        excluded = self._rfr_excluded.setdefault(app, set())
        # 1) exact directory hit for targeted work parked off-home
        hit = self.tq.lookup(app, entry.req_types)
        if hit is not None and hit[0] not in excluded and hit[0] != self.rank:
            server, wtype = hit
            self._send_rfr(entry, server, targeted_lookup=True, lookup_type=wtype)
            return
        if self.cfg.balancer == "tpu" and \
                0 <= entry.job < self.cfg.balancer_max_jobs:
            return  # untargeted matching is the planner's job — and an
            # outstanding RFR would HIDE this requester from balancer
            # snapshots (the _rfr_out filter), starving the planned
            # path. Only OVERFLOW namespaces (id >= balancer_max_jobs)
            # fall through to the qmstat/RFR pull; in steal mode every
            # job rides it.
        # 2) best advertised priority among peers for the requested types
        best_server, best_prio = -1, ADLB_LOWEST_PRIO
        for s, st in self.peers.items():
            if s == self.rank or s in excluded:
                continue
            if entry.job:
                # per-job inventory gossip: {(job, type): prio} cells
                if entry.req_types is None:
                    cand = [
                        p for (j, _t), p in st.job_hi.items()
                        if j == entry.job
                    ]
                else:
                    cand = [
                        st.job_hi.get((entry.job, t), ADLB_LOWEST_PRIO)
                        for t in entry.req_types
                    ]
                for p in cand:
                    if p > best_prio:
                        best_server, best_prio = s, p
                continue
            types = (
                entry.req_types if entry.req_types is not None else st.hi_prio.keys()
            )
            for t in types:
                p = st.hi_prio.get(t, ADLB_LOWEST_PRIO)
                if p > best_prio:
                    best_server, best_prio = s, p
        if best_server >= 0:
            self._send_rfr(entry, best_server, targeted_lookup=False, lookup_type=-1)

    def _send_rfr(
        self, entry: RqEntry, server: int, targeted_lookup: bool, lookup_type: int
    ) -> None:
        self._rfr_out[entry.world_rank] = time.monotonic()
        self._m_rfrs.inc()
        self.flight.record(
            f"rfr -> server {server} for rank {entry.world_rank} "
            f"(targeted={targeted_lookup})"
        )
        self._send_srv(
            server,
            msg(
                Tag.SS_RFR,
                self.rank,
                for_rank=entry.world_rank,
                rqseqno=entry.rqseqno,
                req_types=None if entry.req_types is None
                else sorted(entry.req_types),
                targeted_lookup=targeted_lookup,
                lookup_type=lookup_type,
                # fused reserve parked here: ask the holder to ship the
                # payload in the RFR response (remote fused fetch) so the
                # requester never pays a GET_RESERVED round trip
                fetch=int(entry.fetch),
                # the requester's namespace: the holder matches only
                # units of this job (omitted/0 = default namespace)
                job_id=entry.job or None,
            ),
        )

    def _rfr_found_resp(
        self, dest: int, for_rank: int, rqseqno: int, unit, fetch: bool
    ) -> None:
        """Pin a matched unit and answer an RFR/plan match toward the
        requester's home server. With ``fetch`` (the park is a fused
        reserve) the payload rides along — remote fused fetch: the home
        server forwards it straight into the TA_RESERVE_RESP and no
        GET_RESERVED leg ever happens. The unit stays PINNED under its
        lease until the home confirms delivery (SS_DELIVERED) or
        compensates (SS_UNRESERVE), so the exhaustion vote and the
        rank-death reclaim see the handoff exactly like a classic pinned
        handoff."""
        self._pin(unit.seqno, for_rank)
        # a handoff is in flight: counts as activity so the exhaustion
        # double-pass cannot declare done around it
        self.activity += 1
        self._job_activity(getattr(unit, "job", 0))
        self._exhaust_held_since = None
        fields = dict(
            found=True,
            for_rank=for_rank,
            rqseqno=rqseqno,
            seqno=unit.seqno,
            work_type=unit.work_type,
            prio=unit.prio,
            target_rank=unit.target_rank,
            work_len=unit.work_len,
            answer_rank=unit.answer_rank,
            common_len=unit.common_len,
            common_server=unit.common_server_rank,
            common_seqno=unit.common_seqno,
        )
        if fetch:
            self._relay_inflight[unit.seqno] = for_rank
            fields.update(
                payload=unit.payload,
                time_on_q=time.monotonic() - unit.time_stamp,
            )
            if unit.spans is not None:
                # the payload leaves with the RFR response: journey
                # custody transfers to the requester's HOME server,
                # which closes it on delivery; our original context is
                # dropped at the SS_DELIVERED consume (an UNRESERVE
                # bounce keeps it — the journey continues here)
                self.journeys.stamp(unit, "relay")
                fields["trace"] = trace_fields(unit)
        if self._send_srv(
            dest, msg(Tag.SS_RFR_RESP, self.rank, **fields)
        ) is None:
            # requester's home died before the response left: undo the
            # pin so the unit stays matchable (like an UNRESERVE)
            self._relay_inflight.pop(unit.seqno, None)
            self.wq.unpin(unit.seqno)
            self.leases.release(unit.seqno)
            if self.wlog is not None:
                self.wlog.log_unpin(unit.seqno)
        elif fetch and self.hedges is not None:
            # defensive: hedge-group members are pinned at launch, so
            # RFR should never relay one — but the payload has now left
            # this server, which IS the commit point for the race. If a
            # member ever does reach here, settle first-wins now rather
            # than let a sibling deliver a second copy.
            self._hedge_settle(unit)

    def _on_rfr(self, m: Msg) -> None:
        req_types = None if m.req_types is None else frozenset(m.req_types)
        jid = int(m.data.get("job_id", 0) or 0)
        unit = self.wq.find_match(m.for_rank, req_types, job=jid)
        if unit is not None:
            self._rfr_found_resp(
                m.src, m.for_rank, m.rqseqno, unit,
                fetch=bool(m.data.get("fetch", False)),
            )
        else:
            self._send_srv(
                m.src,
                msg(
                    Tag.SS_RFR_RESP,
                    self.rank,
                    found=False,
                    for_rank=m.for_rank,
                    rqseqno=m.rqseqno,
                    req_types=m.req_types,
                    targeted_lookup=m.targeted_lookup,
                    lookup_type=m.lookup_type,
                    job_id=jid or None,
                ),
            )

    def _on_rfr_resp(self, m: Msg) -> None:
        app = m.for_rank
        self._rfr_out.pop(app, None)
        if not m.found:
            self._n_rfr_failed += 1
        if m.found:
            entry = self.rq.find_entry(app, m.rqseqno)
            if entry is None or not entry.wants(m.work_type):
                # requester got satisfied (and possibly re-parked with a new
                # request) while the RFR was in flight — compensate
                # (reference SS_UNRESERVE, src/adlb.c:1949-1963). for_rank
                # lets the holder ignore this if the pin already has a new
                # owner (rank-dead reclaim re-matched it). A payload that
                # rode along is simply discarded: the unit is still pinned
                # at the holder, and the UNRESERVE unpins it for re-match.
                self._send_srv(
                    m.src,
                    msg(Tag.SS_UNRESERVE, self.rank, seqno=m.seqno,
                        for_rank=app),
                )
                if self._failover:
                    self._relay_resolved.setdefault(
                        m.src, deque(maxlen=1024)
                    ).append((m.seqno, app, False))
                return
            if m.target_rank >= 0 and app == m.target_rank:
                self.tq.remove(app, m.work_type, m.src)
            self.rq.remove_entry(entry)
            self._stream_idle.discard(app)
            self.rq.demote_rank(app)  # spread scarce inventory (see
            # _satisfy_parked)
            self._park_res_local[app] = False  # RFR/plan = remote delivery
            self._rfr_excluded.pop(app, None)
            wait = time.monotonic() - entry.time_stamp
            self._rq_wait_sum += wait
            self._rq_wait_n += 1
            self.activity += 1
            if "payload" in m.data and entry.fetch:
                # remote fused fetch: the holder shipped the payload in
                # the RFR response — forward it straight into the
                # reservation response (ONE client-visible round trip, no
                # GET_RESERVED leg) and confirm so the holder consumes
                # the pinned unit. Prefixed units carry only their
                # suffix; the client assembles from its prefix cache.
                fields = dict(
                    rc=ADLB_SUCCESS,
                    rqseqno=m.rqseqno,
                    work_type=m.work_type,
                    prio=m.prio,
                    work_len=m.work_len,
                    answer_rank=m.answer_rank,
                    payload=m.payload,
                    time_on_q=m.data.get("time_on_q", 0.0),
                )
                if m.target_rank >= 0:
                    fields["target_rank"] = m.target_rank
                if m.common_len > 0:
                    fields.update(
                        common_len=m.common_len,
                        common_server=m.common_server,
                        common_seqno=m.common_seqno,
                    )
                delivered = self._send_app(
                    app, msg(Tag.TA_RESERVE_RESP, self.rank, **fields)
                )
                tctx = m.data.get("trace")
                if delivered and tctx:
                    # the relayed journey closes HERE: the forwarding is
                    # the delivery, and the deliver hop belongs to this
                    # rank (the holder's copy is dropped at its
                    # SS_DELIVERED consume)
                    spans = list(tctx["spans"])
                    spans.append(("deliver", self.rank, time.monotonic()))
                    spans.append(("finalize", self.rank, time.monotonic()))
                    self.journeys.close_spans(
                        tctx["id"], entry.job, m.work_type, "delivered",
                        spans,
                    )
                self._send_srv(
                    m.src,
                    msg(Tag.SS_DELIVERED, self.rank, seqno=m.seqno,
                        for_rank=app)
                    if delivered
                    else msg(Tag.SS_UNRESERVE, self.rank, seqno=m.seqno,
                             for_rank=app),
                )
                if self._failover:
                    self._relay_resolved.setdefault(
                        m.src, deque(maxlen=1024)
                    ).append((m.seqno, app, bool(delivered)))
                return
            handle = WorkHandle(
                seqno=m.seqno,
                server_rank=m.src,
                common_len=m.common_len,
                common_server_rank=m.common_server,
                common_seqno=m.common_seqno,
            )
            # undeliverable = the requester died since the RFR went out:
            # the remote unit stays pinned under its lease, which the
            # holder's own SS_RANK_DEAD sweep reclaims
            self._send_app(
                app,
                msg(
                    Tag.TA_RESERVE_RESP,
                    self.rank,
                    rc=ADLB_SUCCESS,
                    rqseqno=m.rqseqno,
                    work_type=m.work_type,
                    prio=m.prio,
                    handle=handle.to_ints(),
                    work_len=m.work_len,
                    answer_rank=m.answer_rank,
                ),
            )
        else:
            # stale belief: patch it like the reference patches qmstat
            # (src/adlb.c:1979-2005), strike the peer out for this requester,
            # and retry an alternate candidate.
            jid = int(m.data.get("job_id", 0) or 0)
            if m.targeted_lookup:
                self.tq.remove(app, m.lookup_type, m.src)
            elif jid:
                st = self.peers.get(m.src)
                if st is not None:
                    keys = (
                        [(jid, t) for t in m.req_types]
                        if m.req_types is not None
                        else [k for k in st.job_hi if k[0] == jid]
                    )
                    for k in keys:
                        st.job_hi[k] = ADLB_LOWEST_PRIO
            else:
                st = self.peers.get(m.src)
                if st is not None:
                    types = m.req_types if m.req_types is not None else list(
                        st.hi_prio.keys()
                    )
                    for t in types:
                        st.hi_prio[t] = ADLB_LOWEST_PRIO
            self._rfr_excluded.setdefault(app, set()).add(m.src)
            for cand in self.rq.entries():
                if cand.world_rank == app:
                    self._try_rfr(cand)
                    break

    def _on_unreserve(self, m: Msg) -> None:
        if m.data.get("fo_from") is not None:
            if self._hold_resolution(m):
                return
            new = self._adopted_unit_for(m)
            if new is None:
                return  # the pin did not survive the takeover
            m.data["seqno"] = new
        unit = self.wq.get(m.seqno)
        if unit is None or not unit.pinned:
            self._relay_inflight.pop(m.seqno, None)
            return
        want = m.data.get("for_rank")
        if want is not None and unit.pin_rank != want:
            # the pin has a NEW owner: the rank-dead sweep already
            # reclaimed and re-matched this unit, so this compensation is
            # stale — honoring it would steal a live rank's reservation
            return
        self._relay_inflight.pop(m.seqno, None)
        if self._hedge_member_unpin(unit):
            # requester handed a racing hedge copy back (shutdown /
            # shrink): retire it rather than re-match a duplicate
            return
        self.wq.unpin(m.seqno)
        self.leases.release(m.seqno)
        if self.wlog is not None:
            self.wlog.log_unpin(m.seqno)
        self._match_rq()

    def _on_delivered(self, m: Msg) -> None:
        """Remote fused fetch confirmation: the home server forwarded our
        payload-carrying RFR response to the requester, so the pinned
        unit is now consumed (the delivery IS the fetch)."""
        if m.data.get("fo_from") is not None:
            if self._hold_resolution(m):
                return
            new = self._adopted_unit_for(m)
            if new is None:
                return
            m.data["seqno"] = new
        self._relay_inflight.pop(m.seqno, None)
        unit = self.wq.get(m.seqno)
        if unit is None or not unit.pinned or unit.pin_rank != m.for_rank:
            return  # already resolved (reclaim re-match / stale confirm)
        # the home server closed the relayed journey from its copy;
        # drop ours without a second close
        self.journeys.forget(unit)
        self._consume(unit)

    def _hold_resolution(self, m: Msg) -> bool:
        """A relay resolution rerouted from a dead holder whose mirror is
        still here (this server has not promoted it yet): hold it, since
        its pinned unit has no local seqno before the adoption; _promote
        replays it. Returns True when held."""
        fo = m.data["fo_from"]
        if fo not in self.mirrors:
            return False
        self._held_resolutions.setdefault(fo, []).append(m)
        return True

    def _resend_resolutions(self, dead: int) -> None:
        """Send the dead holder's latest relay resolutions again; the
        reroute takes them to its buddy (this server included), where
        stale ones find no pinned unit and are ignored."""
        for seqno, app, delivered in self._relay_resolved.pop(dead, ()):
            m = msg(Tag.SS_DELIVERED if delivered else Tag.SS_UNRESERVE,
                    self.rank, seqno=seqno, for_rank=app)
            if self._srv_route.get(dead) == self.rank:
                m.data["fo_from"] = dead
                self._handlers[m.tag](m)
            else:
                self._send_srv(dead, m)

    # ------------------------------------------------------- push (memory)

    def _try_push(self) -> None:
        if self._push_offered:
            return  # one outstanding push at a time
        unit = self.wq.find_unpinned()
        if unit is None:
            return
        target = None
        for s, st in self.peers.items():
            if s == self.rank:
                continue
            if (
                s in self._draining_servers
                or s in self._dead_servers
                or not self._is_live_member(s)
            ):
                # elastic membership: a push is custody transfer with no
                # ack — never aim one at a server that is leaving (the
                # drain flushes its wq to the buddy, not frames still in
                # its inbox) or not yet live
                continue
            cap = self.cfg.max_malloc_per_server
            if cap <= 0 or st.nbytes + unit.payload_len <= 0.9 * cap:
                if target is None or st.nbytes < self.peers[target].nbytes:
                    target = s
        if target is None:
            return
        self._push_seq += 1
        qid = (self.rank << 20) | self._push_seq
        self._push_offered[qid] = unit.seqno
        self._m_pushes.inc()
        if self._send_srv(
            target,
            msg(
                Tag.SS_PUSH_QUERY,
                self.rank,
                query_id=qid,
                nbytes=unit.payload_len,
            ),
        ) is None:
            self._push_offered.pop(qid, None)

    def _on_push_query(self, m: Msg) -> None:
        if self._draining_self or self.done:
            # scale-in: no NEW custody once draining — accepted pushes
            # gate the drain's final flush (_maybe_finish_drain), so a
            # query accepted now would only widen that window
            self._send_srv(
                m.src,
                msg(Tag.SS_PUSH_QUERY_RESP, self.rank,
                    query_id=m.query_id, accept=False),
            )
            return
        ok = self.mem.has_room(m.nbytes)
        if ok:
            self.mem.alloc(m.nbytes)  # budget reserved until WORK or DEL
            self._push_reserved[m.query_id] = m.nbytes
        self._send_srv(
            m.src,
            msg(Tag.SS_PUSH_QUERY_RESP, self.rank, query_id=m.query_id,
                accept=ok),
        )

    def _on_push_query_resp(self, m: Msg) -> None:
        seqno = self._push_offered.pop(m.query_id, None)
        if seqno is None:
            return
        unit = self.wq.get(seqno)
        if not m.accept:
            return
        if unit is None or unit.pinned:
            # got reserved while the query was in flight — cancel (reference
            # SS_PUSH_DEL, src/adlb.c:2182-2192)
            self._send_srv(
                m.src, msg(Tag.SS_PUSH_DEL, self.rank, query_id=m.query_id)
            )
            return
        self._unspill(unit)  # shipping needs the bytes
        self.wq.remove(seqno)
        self.mem.free(len(unit.payload))
        if self.wlog is not None:
            self.wlog.log_remove(seqno)
        self.stats[InfoKey.NPUSHED_FROM_HERE] += 1
        if unit.target_rank >= 0:
            home = self.world.home_server(unit.target_rank)
            self._send_srv(
                home,
                msg(
                    Tag.SS_MOVING_TARGETED_WORK,
                    self.rank,
                    app_rank=unit.target_rank,
                    work_type=unit.work_type,
                    from_server=self.rank,
                    to_server=m.src,
                ),
            )
        pushed = dict(
            query_id=m.query_id,
            payload=unit.payload,
            work_type=unit.work_type,
            prio=unit.prio,
            target_rank=unit.target_rank,
            answer_rank=unit.answer_rank,
            home_server=unit.home_server,
            common_len=unit.common_len,
            common_server=unit.common_server_rank,
            common_seqno=unit.common_seqno,
            time_stamp=unit.time_stamp,
            attempts=unit.attempts,
        )
        tf = trace_fields(unit)
        if tf is not None:  # untraced pushes stay byte-identical
            pushed["trace"] = tf
        sent_to = self._send_srv(
            m.src, msg(Tag.SS_PUSH_WORK, self.rank, **pushed)
        )
        if sent_to is None:
            # the accepting peer died before the payload left: a unit
            # already admitted to the system is never dropped — keep it
            self.mem.alloc(len(unit.payload))
            self.wq.add(unit)
            if self.wlog is not None:
                self.wlog.log_put(unit, -1, None)
            self.stats[InfoKey.NPUSHED_FROM_HERE] -= 1
        else:
            # context custody moved with the frame (the receiver adopts)
            self.journeys.forget(unit)

    def _on_push_work(self, m: Msg) -> None:
        self._push_reserved.pop(m.query_id, None)  # budget now owned by the unit
        unit = WorkUnit(
            seqno=self._next_seqno,
            work_type=m.work_type,
            prio=m.prio,
            target_rank=m.target_rank,
            answer_rank=m.answer_rank,
            payload=m.payload,
            home_server=m.home_server,
            common_len=m.common_len,
            common_server_rank=m.common_server,
            common_seqno=m.common_seqno,
            time_stamp=m.time_stamp,
            attempts=int(m.data.get("attempts", 0) or 0),
        )
        self._next_seqno += 1
        tf = m.data.get("trace")
        if tf:
            self.journeys.adopt(unit, tf["id"], tf["spans"], stage="push")
        self.wq.add(unit)
        if self.wlog is not None:
            self.wlog.log_put(unit, -1, None)
        self.stats[InfoKey.NPUSHED_TO_HERE] += 1
        self._match_rq()
        if self._draining_self:
            # the custody this drain was waiting on just landed
            self._maybe_finish_drain()

    def _on_push_del(self, m: Msg) -> None:
        nbytes = self._push_reserved.pop(m.query_id, None)
        if nbytes is not None:
            self.mem.free(nbytes)
        if self._draining_self:
            self._maybe_finish_drain()

    def _on_moving_targeted(self, m: Msg) -> None:
        """Home-server directory fixup when targeted work migrates
        (reference ``src/adlb.c:2071-2108``)."""
        n = int(m.data.get("count", 1) or 1)
        if m.from_server != self.rank:
            self.tq.remove(m.app_rank, m.work_type, m.from_server, n)
        if m.to_server != self.rank:
            self.tq.add(m.app_rank, m.work_type, m.to_server, n)
        # the target may be parked here and able to use it now
        for cand in self.rq.entries():
            if cand.world_rank == m.app_rank and cand.wants(m.work_type):
                self._try_rfr(cand)
                break

    # ------------------------------------------------------- state sync

    def _qmstat_entry(self) -> dict:
        from adlb_tpu_torch.utils.stats import rss_kb

        ent = {
            "nbytes": self.mem.curr,
            "qlen": self.wq.num_unpinned_untargeted(),
            "hi_prio": {t: self.wq.hi_prio_of_type(t) for t in self.world.types},
            # process-level memory truth alongside the accountant's view
            # (the reference feeds its /proc probe into diagnostics the
            # same way, src/adlb.c:3347-3369)
            "rss_kb": rss_kb(),
        }
        jq = self.wq.job_hi_prio()
        if jq:
            # per-job inventory rides along only while job partitions
            # hold work: single-job worlds gossip byte-identically
            ent["jq"] = jq
        if self.world.epoch:
            # elastic membership: the fleet epoch rides the gossip it
            # already pays for, so a server that missed one epoch-bump
            # fan-out (a drain_done toward a peer mid-join, a dropped
            # frame) converges within a tick instead of voiding every
            # exhaustion/END token forever. Static worlds (epoch 0)
            # gossip byte-identically.
            ent["epoch"] = self.world.epoch
        return ent

    def _broadcast_qmstat(self) -> None:
        ent = self._qmstat_entry()
        st = self.peers[self.rank]
        st.nbytes, st.qlen, st.hi_prio = ent["nbytes"], ent["qlen"], ent["hi_prio"]
        st.rss_kb = ent["rss_kb"]
        st.stamp = time.monotonic()
        if self.cfg.qmstat_mode == "ring":
            # reference-faithful store-and-forward ring token: only the
            # master kicks one per interval (reference src/adlb.c:806-822).
            # The token carries the FULL table — each hop installs it,
            # refreshes its own entry, and forwards, so the k-th hop sees
            # everyone else's state k..S hops stale (src/adlb.c:1705-1757).
            if self.is_master and self.world.nservers > 1:
                table = {
                    s: {"nbytes": p.nbytes, "qlen": p.qlen,
                        "hi_prio": dict(p.hi_prio)}
                    for s, p in self.peers.items()
                }
                table[self.rank] = ent
                try:
                    self.ep.send(
                        self._ring_next_live(),
                        msg(Tag.SS_QMSTAT, self.rank,
                            table=table, origin=self.rank,
                            t0=time.monotonic()),
                    )
                except OSError:
                    pass  # droppable token; next interval kicks a fresh one
            return
        for srv in self._live_servers():
            try:
                self.ep.send(srv, msg(Tag.SS_QMSTAT, self.rank, entry=ent))
            except OSError:
                if not self._failover:
                    raise
                self._note_server_unreachable(srv)

    def _apply_qmstat_entry(self, src: int, ent: dict) -> None:
        e = ent.get("epoch")
        if e:
            self.world.note_epoch(e)  # monotonic: only ever heals a lag
        st = self.peers.get(src)
        if st is None:
            # a dead server's last gossip, drained after another server's
            # SS_SERVER_DEAD made us forget it: nothing left to update
            return
        st.nbytes = ent["nbytes"]
        st.qlen = ent["qlen"]
        st.hi_prio = dict(ent["hi_prio"])
        st.job_hi = dict(ent.get("jq") or {})
        st.rss_kb = ent.get("rss_kb", 0)
        st.stamp = time.monotonic()
        # fresh evidence of work at this peer lifts any strike-out, else a
        # requester could permanently ignore a peer that refilled later
        if any(p > ADLB_LOWEST_PRIO for p in st.hi_prio.values()) or any(
            p > ADLB_LOWEST_PRIO for p in st.job_hi.values()
        ):
            for excluded in self._rfr_excluded.values():
                excluded.discard(src)

    def _on_qmstat(self, m: Msg) -> None:
        if "table" in m.data:
            # ring token (reference src/adlb.c:1705-1757): install every
            # entry except our own, then refresh ours and forward — unless
            # the token is back at its origin, which records the trip time
            # (reference src/adlb.c:1731-1743)
            for src, ent in m.table.items():
                if src != self.rank:
                    self._apply_qmstat_entry(src, ent)
            if m.origin == self.rank:
                trip = time.monotonic() - m.t0
                self.stats[InfoKey.MAX_QMSTAT_TRIP_TIME] = max(
                    self.stats[InfoKey.MAX_QMSTAT_TRIP_TIME], trip
                )
                n = self._qmstat_trips = getattr(self, "_qmstat_trips", 0) + 1
                avg = self.stats[InfoKey.AVG_QMSTAT_TRIP_TIME]
                self.stats[InfoKey.AVG_QMSTAT_TRIP_TIME] = (
                    avg + (trip - avg) / n
                )
                if trip > self.cfg.qmstat_interval:
                    self.stats[InfoKey.NUM_QMS_EXCEED_INT] += 1
            else:
                m.table[self.rank] = self._qmstat_entry()
                try:
                    self.ep.send(
                        self._ring_next_live(),
                        msg(Tag.SS_QMSTAT, self.rank, table=m.table,
                            origin=m.origin, t0=m.t0),
                    )
                except OSError:
                    pass  # droppable token
        else:
            self._apply_qmstat_entry(m.src, m.entry)
        # fresh knowledge may unblock parked requesters (reference
        # check_remote_work_for_queued_apps after qmstat, src/adlb.c:3536-3579)
        for entry in self.rq.entries():
            if entry.world_rank not in self._rfr_out:
                self._try_rfr(entry)

    # ------------------------------------------------------- balancer (tpu)

    def _send_snapshot(self, reqs_only: bool = False) -> None:
        """Ship queue state to the balancer. ``reqs_only`` skips the O(wq)
        task walk (and the fat task list in the frame) for events that only
        changed the rq — the receiver keeps its previous task view."""
        if reqs_only:
            tasks = None
        else:
            # the full task walk supersedes any pending put deltas (the
            # pending units are in the wq, so the walk carries them)
            self._pending_delta.clear()
            self._delta_deadline = float("inf")
            K = self.cfg.balancer_max_tasks
            # job 0's best K by (prio desc, seqno): the C++ core sorts in
            # native code, and the Python queue (which the spill tier
            # forces) keeps them sorted, so no Python walk of the queue
            # runs on the reactor thread
            tasks = self.wq.snapshot_untargeted(K)
            tasks = self._merge_job_tasks(tasks, K)
        J = self.cfg.balancer_max_jobs
        reqs = [
            (
                e.world_rank,
                e.rqseqno,
                None if e.req_types is None else sorted(e.req_types),
                # 4th element: fused reserve? drives remote fused fetch
                # on the plan path (3-tuples from native planes read as
                # False — handle delivery, as before). 5th (only when
                # non-zero): the requester's job namespace — the planner
                # only matches within a job, and single-job worlds stay
                # byte-identical on the wire without it.
                bool(e.fetch),
            ) if e.job == 0 else (
                e.world_rank,
                e.rqseqno,
                None if e.req_types is None else sorted(e.req_types),
                bool(e.fetch),
                e.job,
            )
            for e in self.rq.entries()
            if e.world_rank not in self._rfr_out and 0 <= e.job < J
        ][: self.cfg.balancer_max_requesters]
        snap = {
            "tasks": tasks,
            "reqs": reqs,
            "nbytes": self.mem.curr,
            "consumers": len(self.local_apps - self._finalized),
            "stamp": time.monotonic(),
            "mig_acks": dict(self._mig_acks),
        }
        if self.is_master:
            self._accept_snapshot(self.rank, snap)
        else:
            # suppress repeat empty snapshots: an idle server would otherwise
            # wake the master every tick for nothing. An unreported
            # mig_acks change is NOT empty — the ack clears the
            # planner's in-flight credit, and swallowing it would
            # re-open the phantom-credit stall the empty-batch ack
            # exists to close.
            # (reqs-only snapshots do not DELIVER acks — the master
            # inherits the previous task view's acks for them — so they
            # neither satisfy the acks-changed test nor mark the acks
            # as reported)
            empty = (
                not tasks and not reqs
                and (reqs_only or self._mig_acks
                     == getattr(self, "_last_snap_acks", {}))
            )
            if empty and getattr(self, "_last_snap_empty", False):
                return
            self._last_snap_empty = empty
            if not reqs_only:
                self._last_snap_acks = dict(self._mig_acks)
            try:
                self.ep.send(
                    self.world.master_server_rank,
                    msg(Tag.SS_STATE, self.rank, snap=snap),
                    **self._srv_grace(),
                )
            except OSError:
                if not self._failover:
                    raise
                self._note_server_unreachable(self.world.master_server_rank)

    def _merge_job_tasks(self, tasks: list, K: int) -> list:
        """Fold non-default namespaces' untargeted inventory into the
        balancer snapshot as 5-tuples carrying the job id (multi-job
        planning). Job 0 keeps the C++ top-K fast path; the
        other partitions only exist in service mode and are walked in
        Python. The merged list is re-capped at K by EFFECTIVE priority
        (clipped prio + fair-share bias, the planner's own ordering,
        jobdim.weight_bias) so one tenant's flood cannot silently push
        another below the planner's horizon. Identity — and no 5th
        element anywhere — in single-job worlds."""
        J = self.cfg.balancer_max_jobs
        if J <= 1 or not self.wq.has_job_units():
            return tasks
        from adlb_tpu_torch.balancer.jobdim import weight_bias

        extra = []
        for jid in self.wq.job_ids():
            if jid == 0 or not 0 <= jid < J:
                continue  # overflow namespaces keep the qmstat/RFR path
            part = self.wq.part(jid)
            if part is None:
                continue
            for u in part.units():
                if not u.pinned and u.target_rank < 0:
                    extra.append(
                        (u.seqno, u.work_type, u.prio, u.payload_len, jid)
                    )
        if not extra:
            return tasks
        merged = list(tasks) + extra
        if len(merged) > K:
            bias = {
                j: weight_bias(w) for j, w in self.jobs.weights().items()
            }

            def eff(t):
                b = bias.get(t[4], 0) if len(t) > 4 else bias.get(0, 0)
                return max(-(10 ** 9), min(10 ** 9, t[2])) + b

            merged.sort(key=eff, reverse=True)  # stable: ties keep order
            del merged[K:]
        return merged

    def _accept_snapshot(self, src: int, snap: dict) -> None:
        """Master-side snapshot intake, shared by the local and remote
        paths. A reqs-only snapshot (tasks=None) merges with the sender's
        previous task view; stamps are split so a fresh req stamp does not
        re-eligibilize in-flight planned tasks (and vice versa)."""
        prev = self._snapshots.get(src)
        if snap["tasks"] is None:
            snap["tasks"] = prev["tasks"] if prev is not None else []
            snap["task_stamp"] = (
                prev.get("task_stamp", prev["stamp"]) if prev is not None
                else snap["stamp"]
            )
            # the migration-batch acks must stay consistent with the TASK
            # view they ride with: acking a landed batch against a stale
            # task list would clear the credit before the units are
            # visible, re-creating the phantom-top-up chain. When there
            # is NO previous task view at all (first-ever snapshot from
            # this rank is reqs-only), fresh acks would pair with the
            # empty default view above — drop them so the engine falls
            # back to stamp-based clearing until a full view arrives.
            snap["mig_acks"] = (
                prev.get("mig_acks") if prev is not None else None
            )
            # the inherited task list carries its event-delta sequence
            # (the sharded solver keys its fast path on it)
            if prev is not None:
                snap["delta_seq"] = prev.get("delta_seq", 0)
        else:
            snap["task_stamp"] = snap["stamp"]
        self._snapshots[src] = snap
        self._update_parked(src, snap["reqs"])
        self._maybe_wake_balancer(src, snap)

    def _send_task_delta(self, unit) -> None:
        """Event path for new hungry-matched untargeted inventory: ship the
        unit's metadata; the receiver appends it to the sender's last full
        snapshot. Consumed-but-still-listed units are already tolerated
        (plan entries are hints validated at enactment), so a delta
        between full refreshes adds no new race class.

        Units arriving faster than ``balancer_min_gap`` accumulate and
        flush as ONE batched delta the moment the gap elapses: without
        batching, a producer streaming puts at thousands/sec was visible
        to the balancer at one unit per gap — a 30x-lagging inventory
        view that kept the pump's scarcity gate closed while whole worker
        pools idled (the hotspot startup stall)."""
        # payload bytes, NOT unit.work_len (payload + common prefix): full
        # snapshots record payload bytes, and the planner's admission math
        # compares against payload-only memory accounting (spill-aware:
        # a spilled unit's true size, not its empty resident stub)
        nlen = unit.payload_len
        if self.is_master:
            self._merge_task_delta(
                self.rank, [unit.seqno], [unit.work_type], [unit.prio],
                [nlen], self.mem.curr, jobs=[unit.job],
            )
            return
        self._pending_delta.append(
            (unit.seqno, unit.work_type, unit.prio, nlen, unit.job)
        )
        now = time.monotonic()
        if now - self._last_event_snap >= self.cfg.balancer_min_gap:
            self._flush_task_deltas(now)
        else:
            # schedule the flush for when the gap elapses; the run loop's
            # poll deadline honors it so a burst that STOPS inside the
            # gap still reaches the balancer within one gap
            self._delta_deadline = min(
                self._delta_deadline,
                self._last_event_snap + self.cfg.balancer_min_gap,
            )

    def _flush_task_deltas(self, now: float) -> None:
        self._delta_deadline = float("inf")
        if not self._pending_delta:
            return
        seqnos, wtypes, prios, lens, jobs = zip(*self._pending_delta)
        self._pending_delta.clear()
        self._last_event_snap = now
        extra = {}
        if any(jobs):
            # per-unit namespaces ride only when some unit is non-default
            # — single-job deltas stay byte-identical on the wire
            extra["jobs"] = list(jobs)
        try:
            self.ep.send(
                self.world.master_server_rank,
                msg(
                    Tag.SS_STATE_DELTA,
                    self.rank,
                    seqnos=list(seqnos),
                    work_types=list(wtypes),
                    prios=list(prios),
                    work_lens=list(lens),
                    nbytes=self.mem.curr,
                    **extra,
                ),
            )
        except OSError:
            if not self._failover:
                raise
            self._note_server_unreachable(self.world.master_server_rank)

    def _merge_task_delta(
        self, src: int, seqnos, work_types, prios, work_lens, nbytes: int,
        jobs=None,
    ) -> None:
        snap = self._snapshots.get(src)
        if snap is None:
            return  # no baseline yet; the next full snapshot delivers it
        J = self.cfg.balancer_max_jobs
        room = self.cfg.balancer_max_tasks - len(snap["tasks"])
        for i in range(min(room, len(seqnos))):
            j = int(jobs[i]) if jobs is not None else 0
            if j:
                # same 5th-element rule as full snapshots: job carried
                # only when non-default; overflow namespaces (beyond the
                # planner's job axis) stay off the ledger entirely
                if not 0 <= j < J:
                    continue
                snap["tasks"].append(
                    (seqnos[i], work_types[i], prios[i], work_lens[i], j)
                )
            else:
                snap["tasks"].append(
                    (seqnos[i], work_types[i], prios[i], work_lens[i])
                )
        snap["nbytes"] = nbytes
        # NOTE: snap["stamp"] is NOT bumped — requester (re-)eligibility in
        # the plan ledger must only come from full snapshots that re-observe
        # the requester parked; the new task is eligible under any stamp.
        # The delta SEQUENCE lets the sharded solver's unchanged-server
        # fast path notice the in-place append without a stamp bump
        # (bumping task_stamp here would re-eligibilize planned tasks).
        snap["delta_seq"] = snap.get("delta_seq", 0) + 1
        self._snapshots.bump(src)  # in-place append: version it
        if self._balancer is not None:
            self._balancer.wake.set()

    def _on_state_delta(self, m: Msg) -> None:
        if m.data.get("seqnos") is not None:  # batched
            self._merge_task_delta(
                m.src, m.seqnos, m.work_types, m.prios, m.work_lens,
                m.nbytes, jobs=m.data.get("jobs"),
            )
        else:  # single-unit shape (native daemons predating the batch)
            self._merge_task_delta(
                m.src, [m.seqno], [m.work_type], [m.prio], [m.work_len],
                m.nbytes,
            )

    def _on_state(self, m: Msg) -> None:
        # re-stamp on the master's clock: plan-ledger comparisons must never
        # mix monotonic clocks from different hosts
        m.snap["stamp"] = time.monotonic()
        self._accept_snapshot(m.src, m.snap)

    def _maybe_wake_balancer(self, src: int, snap: dict) -> None:
        """Wake the balancer thread only when a round could plan something
        new: this server's parked-requester set changed (a new park to
        match / a satisfied one to retire), or it reports inventory while
        someone somewhere is parked (the match case for event snapshots).
        A permanently parked requester re-reported in every snapshot (a
        collector of targeted answers, e.g. gfmc's master) must NOT keep
        the round loop spinning — rounds cost real GIL time."""
        if self._balancer is None:
            return
        sig = tuple(sorted((r[0], r[1]) for r in snap["reqs"]))
        changed = sig != self._req_sigs.get(src)
        self._req_sigs[src] = sig
        if changed or (
            snap["tasks"]
            and self._hungry
            and (
                self._hungry_any
                or any(t[1] in self._hungry_types for t in snap["tasks"])
            )
        ):
            self._balancer.wake.set()

    def _update_parked(self, src: int, reqs) -> None:
        """Master bookkeeping of which work types parked requesters want;
        the shared :class:`HungryTracker` decides when the wanted-set
        change is worth broadcasting (growth immediately, shrinks held —
        see adlb_tpu_torch/balancer/hungry.py)."""
        self._broadcast_hungry(self._hungry_tracker.update(src, reqs))

    def _flush_hungry_shrink(self, now: float) -> None:
        self._broadcast_hungry(self._hungry_tracker.flush(now))

    def _broadcast_hungry(self, payload) -> None:
        if payload is None:
            return
        hungry, req_types, grew = payload
        self._hungry = hungry
        self._hungry_any = hungry and req_types is None
        self._hungry_types = frozenset(req_types or ())
        for srv in self._live_servers():
            try:
                self.ep.send(
                    srv,
                    msg(
                        Tag.SS_HUNGRY,
                        self.rank,
                        hungry=int(hungry),
                        # req_types omitted (None) = any-type requester
                        req_types=req_types,
                        grew=int(grew),
                    ),
                )
            except OSError:
                if not self._failover:
                    raise
                self._note_server_unreachable(srv)

    def _hungry_for(self, work_type: int) -> bool:
        return self._hungry and (
            self._hungry_any or work_type in self._hungry_types
        )

    def _on_hungry(self, m: Msg) -> None:
        self._hungry = bool(m.hungry)
        raw = m.data.get("req_types")
        self._hungry_any = self._hungry and raw is None
        self._hungry_types = frozenset(raw or ())
        if self._hungry and m.data.get("grew"):
            # the wanted-set grew: our inventory of the newly wanted types
            # may be heartbeat-stale at the balancer — refresh it now
            self._send_snapshot()

    def _on_plan_match(self, m: Msg) -> None:
        """Enact one plan entry: validate against live state, pin, and hand
        off through the RFR response path (plan staleness compensated exactly
        like RFR races)."""
        if m.data.get("fo_from") is not None:
            return  # plan named the dead server's inventory: stale by
            # construction (the master re-plans from the buddy's snapshot)
        unit = self.wq.get(m.seqno)
        if unit is None or unit.pinned or unit.target_rank >= 0:
            return  # stale plan entry; next round will re-plan
        self._rfr_found_resp(
            m.req_home, m.for_rank, m.rqseqno, unit,
            fetch=bool(m.data.get("fetch", False)),
        )

    def _on_plan_migrate(self, m: Msg) -> None:
        """Planner-directed inventory move: ship the named (still live,
        unpinned, untargeted) units to `dest` so consumers there match
        locally. Demand-driven placement — the planner's generalization of
        the reference's memory-pressure-only push (``src/adlb.c:509-556``)."""
        if m.data.get("fo_from") is not None:
            return  # plan named the dead server's inventory: stale
        units = []
        for seqno in m.seqnos:
            unit = self.wq.get(seqno)
            if unit is None or unit.pinned or unit.target_rank >= 0:
                continue  # stale plan entry
            self._unspill(unit)  # shipping needs the bytes
            self.wq.remove(seqno)
            self.mem.free(len(unit.payload))
            if self.wlog is not None:
                self.wlog.log_remove(seqno)
            self.stats[InfoKey.NPUSHED_FROM_HERE] += 1
            shipped = {
                "payload": unit.payload,
                "work_type": unit.work_type,
                "prio": unit.prio,
                "answer_rank": unit.answer_rank,
                "home_server": unit.home_server,
                "common_len": unit.common_len,
                "common_server": unit.common_server_rank,
                "common_seqno": unit.common_seqno,
                "time_stamp": unit.time_stamp,
                "attempts": unit.attempts,
            }
            if getattr(unit, "job", 0):
                # namespace rides the move (omitted = job 0, so
                # single-job batches stay byte-identical on the wire)
                shipped["job"] = unit.job
            tf = trace_fields(unit)
            if tf is not None:  # untraced batches stay byte-identical
                shipped["trace"] = tf
                self.journeys.forget(unit)  # custody rides the dict
            units.append(shipped)
        if units:
            self.activity += 1
            self._exhaust_held_since = None
        # A fully-stale batch (every unit consumed locally before
        # enactment) must STILL be sent, empty, carrying the planner's
        # batch id: the destination's ack is what clears the planner's
        # in-flight credit, and a silently dropped batch left a phantom
        # credit that suppressed both the solve and the pump for that
        # destination until the TTLs expired — observed as whole worker
        # pools parked ~180 ms mid-run while a neighbor held
        # hundreds of units.
        self._send_migrate_batch(
            m.dest, units, bounced=False, mig_id=m.data.get("mig_id", 0)
        )

    def _send_migrate_batch(self, dest: int, units: list, bounced: bool,
                            mig_id: int = 0) -> None:
        """Ship one migration batch, tracked until acked: the units live
        in no wq while serialized in the frame, and a destination dying
        mid-transit must hand them back (see _on_server_dead) instead of
        losing them."""
        self._migrate_unacked += 1
        self._mig_token += 1
        tok = self._mig_token
        sent_to = self._send_srv(
            dest,
            msg(Tag.SS_MIGRATE_WORK, self.rank, units=units, bounced=bounced,
                mig_id=mig_id, mig_tok=tok),
        )
        if sent_to is None:
            # destination (and any buddy route) gone: keep the units
            self._migrate_unacked -= 1
            for u in units:
                self._admit_migrated_unit(u, bounced=bounced)
            return
        self._migrate_pending.setdefault(sent_to, {})[tok] = units

    def _on_migrate_work(self, m: Msg) -> None:
        # ack the planner's batch id via the next snapshot: credits for
        # this source's batches up to this id are now visible in our
        # inventory (bounced resends carry no id — the original sighting
        # already acked it)
        mid = m.data.get("mig_id", 0) or 0
        if mid:
            self._mig_acks[m.src] = max(self._mig_acks.get(m.src, 0), mid)
        bounced_back = []
        for u in m.units:
            # admission control like every other ingress path; a unit already
            # admitted to the system is never dropped, so on a full server it
            # bounces back to the sender once, which then must keep it
            # (overcommit beats losing work)
            if not m.data.get("bounced") and not self.mem.try_alloc(
                len(u["payload"])
            ):
                bounced_back.append(u)
                continue
            if m.data.get("bounced"):
                self.mem.alloc(len(u["payload"]))
            unit = WorkUnit(
                seqno=self._next_seqno,
                work_type=u["work_type"],
                prio=u["prio"],
                target_rank=-1,
                answer_rank=u["answer_rank"],
                payload=u["payload"],
                home_server=u["home_server"],
                common_len=u["common_len"],
                common_server_rank=u["common_server"],
                common_seqno=u["common_seqno"],
                time_stamp=u["time_stamp"],
                attempts=int(u.get("attempts", 0) or 0),
                job=int(u.get("job", 0) or 0),
            )
            self._next_seqno += 1
            tf = u.get("trace")
            if tf:
                self.journeys.adopt(unit, tf["id"], tf["spans"],
                                    stage="migrate")
            self.wq.add(unit)
            if self.wlog is not None:
                self.wlog.log_put(unit, -1, None)
            self.stats[InfoKey.NPUSHED_TO_HERE] += 1
        # write-ahead replication, as for a put: the ack makes the source
        # forget these units, so their log entries must be on the wire to
        # the buddy first, or a death between the two loses them with no
        # count (the ported soak's seed 1362 on the card)
        self._flush_repl()
        self._send_srv(
            m.src,
            msg(Tag.SS_MIGRATE_ACK, self.rank,
                mig_tok=m.data.get("mig_tok", 0)),
        )
        if bounced_back:
            self._send_migrate_batch(m.src, bounced_back, bounced=True)
        if m.units:
            self._match_rq()
        if self.cfg.balancer == "tpu" and (m.units or mid):
            # immediate full snapshot: the batch ack and the post-batch
            # inventory reach the planner now, not a heartbeat later —
            # the follow-up top-up cadence rides on this. Sent for EMPTY
            # id-bearing batches too: the ack clearing the phantom
            # credit must not wait for the next heartbeat (and it must
            # ride a FULL snapshot — reqs-only snapshots deliberately
            # inherit the previous acks).
            self._send_snapshot()

    def _on_migrate_ack(self, m: Msg) -> None:
        tok = m.data.get("mig_tok", 0)
        if tok and self._migrate_pending.get(m.src, {}).pop(tok, None) is None:
            # already settled by the dead-destination requeue (the ack
            # raced the death fan-out): decrementing again would wedge
            # the exhaustion vote on a negative unacked count
            return
        self._migrate_unacked -= 1
        held = getattr(self, "_held_checkpoints", None)
        if held and self._migrate_unacked == 0:
            self._held_checkpoints = []
            for h in held:
                self._process_checkpoint(h)

    # ------------------------------------------------------- termination

    def _flush_rq(self, rc: int) -> None:
        # every parked entry — including each slot of a prefetch
        # pipeline — gets its own termination response, so a streaming
        # client can account all its in-flight reserves and drain
        for entry in self.rq.entries():
            self.rq.remove_entry(entry)
            self._reserve_resp(entry.world_rank, rc, rqseqno=entry.rqseqno)
        self._stream_idle.clear()

    def _on_fa_no_more_work(self, m: Msg) -> None:
        if self.no_more_work:
            return
        if self.is_master:
            self._on_ss_no_more_work(m)
        else:
            self.ep.send(
                self.world.master_server_rank, msg(Tag.SS_NO_MORE_WORK, self.rank)
            )

    def _on_ss_no_more_work(self, m: Msg) -> None:
        if self.no_more_work:
            return
        self.no_more_work = True
        if self.is_master:
            for srv in self._live_servers():
                try:
                    self.ep.send(srv, msg(Tag.SS_NO_MORE_WORK, self.rank))
                except OSError:
                    if not self._failover:
                        raise
                    self._note_server_unreachable(srv)
        self._flush_rq(ADLB_NO_MORE_WORK)

    def _all_local_apps_parked(self) -> bool:
        """True when no active local app is off the rq — vacuously true for a
        server with no (remaining) local apps, so worlds where some server
        homes zero apps can still exhaust. A rank whose only parked entries
        are prefetch slots (get_work_stream) counts as parked only once it
        reported FA_STREAM_IDLE: until then the app may be computing a
        banked unit whose descendants could still be put."""
        active = self.local_apps - self._finalized
        return all(
            r in self.rq
            and (self.rq.has_blocking(r) or r in self._stream_idle)
            for r in active
        )

    def _exhaust_vote(self, parked: Optional[list] = None) -> bool:
        """This server's contribution to the exhaustion ring pass.

        Always required: all local apps parked, no pinned units (a pinned
        unit is an in-flight handoff that resolves to a fetch or an
        UNRESERVE), no migration batch in transit. When the token's global
        parked-requester list is available (pass 2), additionally: no unit
        here could satisfy any parked requester anywhere. Unmatchable
        leftovers (e.g. types nobody asks for) deliberately do NOT block —
        matching the reference, which exhausts with work still queued
        (src/adlb.c:754-785) — while work that is still being balanced
        toward a requester, or serialized inside a migration message, does.
        """
        if not self._all_local_apps_parked():
            return False
        if self._migrate_unacked != 0:
            return False
        if self.wq.count != self.wq.num_unpinned():
            return False  # pinned = handoff in flight
        if parked is not None:
            for rank, req_types in parked:
                types = None if req_types is None else frozenset(req_types)
                if self.wq.find_match(rank, types) is not None:
                    return False
        return True

    def _parked_list(self) -> list:
        return [
            (
                e.world_rank,
                None if e.req_types is None else sorted(e.req_types),
            )
            for e in self.rq.entries()
        ]

    def _check_exhaustion(self, now: float) -> None:
        """Master: if every app everywhere might be blocked, run the two-pass
        ring confirmation (reference ``src/adlb.c:754-785,1575-1650``)."""
        if self.no_more_work or self.done_by_exhaustion:
            return
        if self._takeover_pending:
            # succession mid-barrier: a verdict started now could reach
            # a server that has not seen the new epoch yet
            return
        if self.jobs.any_jobs():
            # service mode: once any namespace exists, termination is
            # per-job (_check_job_exhaustion) and the FLEET idles
            # between jobs instead of declaring the world exhausted
            return
        if self._exhaust_inflight:
            # lost-token recovery: if the ring token has not come home in
            # 10 intervals, assume it died and allow a fresh vote; the
            # token id makes any late straggler harmless
            if now - self._exhaust_sent_at < (
                10 * self.cfg.exhaust_check_interval
            ):
                return
            self._exhaust_inflight = False
        if not self._exhaust_vote():
            self._exhaust_held_since = None
            return
        if self._exhaust_held_since is None:
            self._exhaust_held_since = now
            return
        if now - self._exhaust_held_since < self.cfg.exhaust_check_interval:
            return
        self._exhaust_inflight = True
        self._exhaust_sent_at = now
        self._exhaust_token_id += 1
        token = {
            "origin": self.rank,
            "token_id": self._exhaust_token_id,
            "ok": True,
            "act": {self.rank: self.activity},
            "nparked": len(self.rq),
            "parked": self._parked_list(),
            # exhaustion is EPOCH-based, not fixed-count: the verdict is
            # void if membership changed while the token circulated (a
            # rank attaching mid-ring must not race the verdict)
            "epoch": self.world.epoch,
        }
        self._forward_exhaust(Tag.SS_EXHAUST_CHK_1, token)

    def _forward_exhaust(self, tag: Tag, token: dict) -> None:
        self._ring_forward(
            lambda nxt: msg(tag, self.rank, token=token,
                            complete=nxt == token["origin"])
        )

    def _ring_covered(self, visited) -> bool:
        """Origin-side completeness check for ring verdicts. The epoch
        stamp alone cannot catch a hop whose epoch NUMBER healed (qmstat
        gossip / a prior void) while its membership CONTENT still lags —
        `server_live` is the one fan-out without an ack barrier, so such
        a hop's ring_next silently skips the just-published shard. A
        verdict that missed a live server must not conclude; the void
        costs one round while the SS_MEMBER frame lands."""
        need = {
            s for s in self.world.server_ranks
            if s not in self._dead_servers and self._is_live_member(s)
        }
        return need <= set(visited)

    def _on_exhaust_chk(self, m: Msg) -> None:
        if "job" in m.token:
            self._on_job_exhaust_chk(m)
            return
        token = m.token
        phase1 = m.tag is Tag.SS_EXHAUST_CHK_1
        if token.get("epoch", self.world.epoch) != self.world.epoch:
            # the token crossed a membership-epoch boundary (attach /
            # detach / scale / failover): the vote it carries mixes two
            # worlds — void it so the origin re-votes under the new one.
            # note_epoch heals the LAGGING side (a missed bump fan-out);
            # the qmstat gossip heals the other direction, so the void
            # is one round, never forever.
            token["ok"] = False
            self.world.note_epoch(token.get("epoch", 0) or 0)
        if m.data.get("complete") and token["origin"] == self.rank:
            if token.get("token_id", 0) != self._exhaust_token_id:
                return  # straggler from a token we already gave up on
            # token made it all the way around; pass 2 validates against the
            # globally-gathered parked list from pass 1
            visited = token["act"] if phase1 else (
                set(token.get("seen2", ())) | {self.rank}
            )
            ok = (
                token["ok"]
                and token["nparked"] > 0
                and self._exhaust_vote(token["parked"])
                and self.activity == token["act"].get(self.rank, -1)
                and self._ring_covered(token["act"])
                and self._ring_covered(visited)
            )
            if not ok:
                self._exhaust_held_since = None
                self._exhaust_inflight = False
                return
            if phase1:
                token2 = {
                    "origin": self.rank,
                    "token_id": self._exhaust_token_id,
                    "ok": True,
                    "act": token["act"],
                    "nparked": token["nparked"],
                    "parked": token["parked"],
                    "epoch": self.world.epoch,
                }
                self._forward_exhaust(Tag.SS_EXHAUST_CHK_2, token2)
            else:
                self._exhaust_inflight = False
                self._declare_exhaustion()
            return
        # contribute and forward
        if phase1:
            token["ok"] = token["ok"] and self._exhaust_vote()
            token["act"][self.rank] = self.activity
            token["nparked"] = token.get("nparked", 0) + len(self.rq)
            token["parked"] = token.get("parked", []) + self._parked_list()
        else:
            token["ok"] = (
                token["ok"]
                and self._exhaust_vote(token["parked"])
                and self.activity == token["act"].get(self.rank, -1)
            )
            token.setdefault("seen2", []).append(self.rank)
        self._forward_exhaust(m.tag, token)

    def _declare_exhaustion(self) -> None:
        for srv in self._live_servers():
            try:
                self.ep.send(srv, msg(Tag.SS_DONE_BY_EXHAUSTION, self.rank))
            except OSError:
                if not self._failover:
                    raise
                self._note_server_unreachable(srv)
        self._on_done_by_exhaustion(msg(Tag.SS_DONE_BY_EXHAUSTION, self.rank))

    def _on_done_by_exhaustion(self, m: Msg) -> None:
        if self.done_by_exhaustion:
            return
        self.done_by_exhaustion = True
        self.flight.record("done by exhaustion; flushing rq")
        self._flush_rq(ADLB_DONE_BY_EXHAUSTION)

    def _on_local_app_done(self, m: Msg) -> None:
        self._finalized.add(m.src)
        if self.wlog is not None:
            self.wlog.log_app_done(m.src)
        # the finalize reaches the buddy before anything else leaves: a
        # death in between would leave the promoted deputy waiting for
        # a rank that is gone, and the world would never end
        self._flush_repl()
        if m.data.get("ack"):
            # failover only: the rank waits for this answer, which leaves
            # after the frame above, and re-sends its finalize to the
            # buddy that takes over a home that died before answering
            # (a re-sent finalize is a set-add everywhere, WAL replay too)
            self._send_app(m.src, msg(Tag.TA_MEMBER_RESP, self.rank,
                                      rc=ADLB_SUCCESS, finalized=True))
        # a finalizing rank can never consume again: any leftover parked
        # entries (an abandoned stream's prefetch slots) must not attract
        # deliveries that would then be consumed into a closed endpoint
        self.rq.remove_rank(m.src)
        self._stream_idle.discard(m.src)
        self._maybe_complete_finalize()

    def _maybe_complete_finalize(self) -> None:
        """Kick or release the END_1 ring once every ACTIVE local app is
        accounted for — by finalizing, or (reclaim policy) by dying.
        Shared by FA_LOCAL_APP_DONE and the rank-death path so a world
        whose last straggler was a casualty still ends cleanly."""
        if not (self._finalized >= self.local_apps):
            return
        if self.is_master and (
            self._member_pending or self._takeover_pending
        ):
            # a membership fan-out or master succession is mid-barrier:
            # kicking the END ring now would stamp an epoch some server
            # has not reached yet. The barrier's completion re-calls this.
            return
        held = getattr(self, "_held_end1", None)
        if self._end1_pending and held is not None:
            self._end1_pending = False
            self._held_end1 = None
            self._forward_end1(held)
        elif self.is_master and not self._end1_pending:
            self._end1_pending = True
            self._forward_end1(
                {"origin": self.rank, "epoch": self.world.epoch}
            )

    def _forward_end1(self, token: dict) -> None:
        self._end1_sent_at = time.monotonic()
        # visit record for the origin's coverage check (every forwarder,
        # origin included at kick)
        seen = token.setdefault("seen", [])
        if self.rank not in seen:
            seen.append(self.rank)
        self._ring_forward(
            lambda nxt: msg(Tag.SS_END_1, self.rank, token=token,
                            complete=(nxt == token["origin"]))
        )

    def _on_end_1(self, m: Msg) -> None:
        self._ending = True
        token = m.token
        tok_epoch = token.get("epoch")
        if tok_epoch is not None and tok_epoch != self.world.epoch:
            # membership changed under the ring (a server retire is the
            # only epoch bump possible here — attach/detach/scale are
            # refused once termination is underway): void the token; the
            # master re-kicks under the new epoch (the retire path, the
            # _periodic lost-END watchdog, and _apply_member all do)
            self.world.note_epoch(tok_epoch)  # heal a lagging view
            if (
                self.is_master
                and not self.done
                and self._finalized >= self.local_apps
            ):
                self._end1_pending = True
                self._forward_end1(
                    {"origin": self.rank, "epoch": self.world.epoch}
                )
            return
        if m.data.get("complete") and token["origin"] == self.rank:
            if not self._ring_covered(token.get("seen", ())):
                # a hop's lagging membership skipped a live server (see
                # _ring_covered): drop the verdict; _end1_pending stays
                # set, so the lost-END watchdog re-kicks once the
                # skipped server's SS_MEMBER frame has landed fleet-wide
                return
            # every server's local apps have finalized: circulate phase 2
            self._ring_forward(
                lambda nxt: msg(Tag.SS_END_2, self.rank, token=token,
                                complete=(nxt == token["origin"]))
            )
            if self._ring_next_live() == self.rank:
                self.done = True
            return
        if self._finalized >= self.local_apps:
            self._forward_end1(token)
        else:
            # hold the token until our apps finish (reference held END_LOOP_1,
            # src/adlb.c:1790-1798)
            self._end1_pending = True
            self._held_end1 = token

    def _on_end_2(self, m: Msg) -> None:
        self._ending = True
        token = m.token
        self.done = True
        if not m.data.get("complete"):
            self._ring_forward(
                lambda nxt: msg(Tag.SS_END_2, self.rank, token=token,
                                complete=(nxt == token["origin"]))
            )

    def _on_peer_eof(self, m: Msg) -> None:
        """A peer's connection closed. Benign during termination; before it,
        a rank died without finalizing — the reference's failure model is
        rank-death-kills-job (``MPI_Abort`` paths, reference
        ``src/adlb.c:2508-2526``), and the alternative here is a silent
        world hang. Detection is connection-based: a rank that dies before
        ever sending a frame leaves no connection to EOF, and only the
        launch harness's timeout (or the watchdog, for servers) catches
        it."""
        lost_local_app = (
            self.world.is_app(m.src)
            and m.src in self.local_apps
            and m.src not in self._finalized
        )
        if self.done or self._aborted:
            return
        if self.world.is_server(m.src):
            # server peers get the dedicated path: abort (reference
            # semantics), or failover when the policy allows — including
            # mid-termination, where the death is suspected first (a
            # finished peer's exit also EOFs)
            self._on_server_eof(m.src)
            return
        if self.no_more_work or self.done_by_exhaustion or self._ending:
            # termination underway: peer EOFs are normally benign — but a
            # LOCAL app dying unfinalized would hold the END_1 ring
            # forever. Under "reclaim" the death accounting releases it;
            # under "abort" this stays the reference's behaviour (the
            # harness timeout catches it).
            if lost_local_app and self.cfg.on_worker_failure == "reclaim":
                self._declare_rank_dead(m.src)
            return
        if lost_local_app:
            # only the HOME server judges an app EOF: finalize knowledge is
            # home-local, and a finished app legitimately EOFs at every
            # other server it ever fetched from
            if self.cfg.on_worker_failure == "reclaim":
                aprintf(
                    True, self.rank,
                    f"app rank {m.src} connection lost before finalize; "
                    f"reclaiming its work (on_worker_failure=reclaim)",
                )
                self._declare_rank_dead(m.src)
                return
            aprintf(
                True, self.rank,
                f"app rank {m.src} connection lost before finalize; "
                f"aborting the world (reference rank-failure semantics)",
            )
            self._do_abort(-3, broadcast=True)

    # ------------------------------------------------- gray failures
    # Lease expiry with fencing + retry budgets + dead-letter quarantine
    # (no reference analogue; Config(lease_timeout_s) / max_unit_retries,
    # both inert by default). Reclaim and failover survive CLEAN deaths — an EOF
    # fans out the reclaim — but a worker that HANGS without dying
    # (SIGSTOP, wedged accelerator, live-but-frozen VM) holds its leases
    # forever and never EOFs. Here: a lease whose owner has been silent
    # past the timeout is FENCED (the lease_id becomes a fencing token —
    # late settles from the old owner answer ADLB_FENCED) and its unit
    # re-enqueues under a fresh attempt; a rank silent for 2x the
    # timeout is declared hung by its HOME server (rank-dead under
    # "reclaim", abort under "abort"); and a unit whose attempts exceed
    # the retry budget moves to the dead-letter quarantine instead of
    # serially killing the fleet.

    def _scan_leases(self, now: float) -> None:
        timeout = self.cfg.lease_timeout_s
        # native (C) clients have no heartbeat plane: a compute-bound
        # rank is indistinguishable from a hung one, so binary peers
        # keep reference semantics — their leases never expire and they
        # are never declared hung (libadlb would otherwise be aborted
        # mid-computation by its own liveness watchdog)
        native = getattr(self.ep, "binary_peers", None) or ()
        expired = 0
        for lease in self.leases.leases():
            if lease.owner in self._dead_ranks:
                continue  # the rank-dead sweep owns those
            if lease.owner in native:
                continue
            t0 = max(
                lease.granted_at,
                lease.renewed_at,
                self._last_heard.get(lease.owner, 0.0),
            )
            if now - t0 <= timeout:
                continue
            self._expire_lease(lease, now)
            expired += 1
        if expired:
            # reclaimed inventory is activity (an in-flight exhaustion
            # vote must not conclude around it) and may satisfy parked
            # requesters right now
            self.activity += 1
            self._exhaust_held_since = None
            self._match_rq()
        # hang detection: only the HOME server judges (finalize knowledge
        # is home-local, exactly like the EOF path) — total silence past
        # 2x the timeout is a gray-failed rank. Per-lease expiry above
        # already freed its work at ~1x; this releases its termination
        # accounting so the WORLD still completes around it.
        for r in sorted(self.local_apps):
            if r in self._dead_ranks or r in self._finalized:
                continue
            if r in native:
                continue  # no heartbeat plane: busy, not hung
            last = self._last_heard.get(r)
            if last is None:
                continue  # never heard from: startup grace
            silent = now - last
            if silent <= 2.0 * timeout:
                continue
            if self.cfg.on_worker_failure == "reclaim":
                aprintf(
                    True, self.rank,
                    f"app rank {r} silent {silent:.2f}s "
                    f"(lease_timeout_s={timeout}); declaring it hung "
                    f"(on_worker_failure=reclaim)",
                )
                self.flight.record(
                    f"rank_hung rank={r} silent_s={silent:.3f}"
                )
                self._declare_rank_dead(r)
            else:
                aprintf(
                    True, self.rank,
                    f"app rank {r} silent {silent:.2f}s; aborting the "
                    f"world (on_worker_failure=abort)",
                )
                self.flight.record(
                    f"rank_hung rank={r} silent_s={silent:.3f} (abort)"
                )
                self._do_abort(-3, broadcast=True)
                return

    def _expire_lease(self, lease, now: float) -> None:
        """Fence one expired lease and return its unit to service.

        At-least-once by design: the owner may be slow rather than dead
        — it may already hold (or be receiving) the payload — so the
        re-enqueued unit can execute twice. The fence guarantees the
        narrow thing that must never happen: the old owner double-
        SETTLING the unit (its late fetch answers ADLB_FENCED and the
        stale-relay/unreserve guards ignore it)."""
        seqno, owner = lease.seqno, lease.owner
        self.leases.release(seqno)
        self._add_fence(seqno, owner)
        self._m_leases_expired.inc()
        # owner-labelled expiry counter: the lease OWNER (the stalled
        # app rank) otherwise appears only in this server's flight ring
        # — the SLO incident bundles window-delta this cell to name the
        # suspect rank directly
        self.metrics.counter("leases_expired_by", owner=str(owner)).inc()
        if self.wlog is not None:
            self.wlog.log_fence(seqno, owner)
        self.flight.record(
            f"lease_expired seqno={seqno} owner={owner} "
            f"lease_id={lease.lease_id} "
            f"age_s={now - max(lease.granted_at, lease.renewed_at):.3f}"
        )
        unit = self.wq.get(seqno)
        if unit is None or not unit.pinned or unit.pin_rank != owner:
            return  # already resolved through another path
        # a relay in flight toward the silent owner: unlike the rank-DEAD
        # sweep (at-most-once: the owner is gone, consume), expiry keeps
        # the unit — the documented at-least-once window
        self._relay_inflight.pop(seqno, None)
        if self._hedge_member_unpin(unit):
            # a hedge sibling still races for this unit's logical put:
            # this copy retires instead of re-enqueueing (the fence
            # above already bars the silent owner)
            return
        self.wq.unpin(seqno)
        if unit.spans is not None:
            self.journeys.stamp(unit, "expire")
        if self.wlog is not None:
            self.wlog.log_unpin(seqno)
        quarantined = self._bump_attempts(unit, in_wq=True)
        if unit.common_seqno >= 0 and not quarantined:
            # the silent owner may have fetched the prefix already; the
            # re-consumption fetches it again (bounded-leak direction,
            # as in the rank-death sweep). On quarantine: NO common op.
            # A credit expects a re-consumption that will never come
            # (certain leak); a forfeit assumes the silent owner never
            # fetched — if it did, the overshoot could GC the prefix
            # out from under surviving members. With neither, the books
            # close exactly when every epoch fetched and leak bounded
            # otherwise (the targeted-drop path forfeits only because
            # its suffix-only delivery PROVES the share unaccounted).
            self._forfeit_common(
                unit.common_seqno, unit.common_server_rank, op="credit"
            )

    def _add_fence(self, seqno: int, owner: int) -> None:
        key = (seqno, owner)
        if key in self._fences:
            return
        self._fences.add(key)
        self._fence_order.append(key)
        if len(self._fence_order) > 65536:  # bounded, like tombstones
            self._fences.discard(self._fence_order.popleft())

    # ------------------------------------------------------- tail hedging
    # Config(hedge_budget_frac) > 0 (runtime/hedge.py holds the pure
    # bookkeeping; this section owns every queue/lease/WAL side effect).
    # A straggling leased-but-unfetched unit — age past the live
    # per-(job, type) p99 the master gossips, or its holder showing the
    # lease-holder stall signature — gets a hedge SIBLING minted and handed
    # directly to an already-parked requester on a DIFFERENT rank. The
    # sibling is pinned at launch and never sits unpinned in the queue,
    # so migration/push can never move it off-home and the whole race
    # settles on this reactor. First terminal wins (_hedge_settle, from
    # _consume / _quarantine_unit / the relay-send site); every losing
    # sibling is fenced through the (seqno, owner) machinery and
    # removed — its late fetch answers ADLB_FENCED exactly like an
    # expired-lease owner's. Members that lose their pin WITHOUT
    # terminating (expiry / unreserve / rank-death) retire instead of
    # re-enqueueing while a sibling still races; the LAST live copy
    # always re-enters service, so work is never lost to hedging.

    def _scan_hedges(self, now: float) -> None:
        """Walk the lease table for stragglers worth hedging. Rare-path
        cost: gated on the hedge budget being configured, cadenced well
        inside the age floor."""
        thr_map = self.journeys.tail_thr
        suspects = self._hedge_suspects(now)
        min_age_s = self.cfg.hedge_min_age_ms / 1e3
        hm = self.hedges
        for lease in list(self.leases.leases()):
            seqno, owner = lease.seqno, lease.owner
            if owner in self._dead_ranks:
                continue  # the rank-dead sweep owns those
            if hm.is_member(seqno) or hm.is_vetoed(seqno):
                continue
            if seqno in self._relay_inflight:
                continue  # payload already committed cross-server
            unit = self.wq.get(seqno)
            if unit is None or not unit.pinned or unit.pin_rank != owner:
                continue
            if unit.target_rank >= 0 or unit.common_seqno >= 0:
                # targeted work may not run elsewhere; a fused batch
                # member shares prefix books a duplicate would corrupt
                continue
            if unit.spilled:
                continue  # payload not resident (defensive: pins unspill)
            thr = thr_map.get((unit.job, unit.work_type))
            if should_hedge(now - unit.time_stamp, thr,
                            owner in suspects, min_age_s):
                self._try_hedge(unit, owner, now,
                                why="thr" if thr is not None
                                and now - unit.time_stamp > thr
                                else "suspect")

    def _hedge_suspects(self, now: float) -> set:
        """Stall signatures feeding the trigger — the stall heuristic
        (obs/slo.py suspect_ranks) over THIS server's scan window:
        in-window growth of the owner-labelled lease-expiry cells, plus
        (master only) gossip-stale members under the /healthz rule."""
        from adlb_tpu_torch.obs.slo import suspect_ranks

        cur = self.metrics.labelled("leases_expired_by")
        memo = self._hedge_expiry_memo
        deltas = {k: v - memo.get(k, 0) for k, v in cur.items()}
        self._hedge_expiry_memo = cur
        stale = []
        if self.is_master and self._obs_sync_armed and self._fleet_seen:
            cut = 3.0 * self.cfg.obs_sync_interval
            stale = [r for r, (_seq, at) in self._fleet_seen.items()
                     if now - at > cut]
        # the expiry-growth evidence is a point event (non-zero in
        # exactly the one scan window that straddles it) but the stall
        # it names persists — hold the suspicion for a lease-timeout so
        # a rank that just expired one lease hedges its NEXT straggler
        # promptly instead of only during a single 1/4-floor window
        hold = max(self.cfg.lease_timeout_s,
                   4.0 * self.cfg.hedge_min_age_ms / 1e3)
        for r in suspect_ranks(stale, (), deltas):
            self._hedge_suspect_until[r] = now + hold
        for r in [r for r, t in self._hedge_suspect_until.items()
                  if t <= now]:
            del self._hedge_suspect_until[r]
        return set(self._hedge_suspect_until)

    def _try_hedge(self, unit, owner: int, now: float, why: str) -> None:
        """Launch one hedge sibling for ``unit`` — or veto. Veto order
        matters: backpressure signals veto STICKILY (overload is exactly
        when a later retry would start a storm); an empty budget or no
        parked taker only defers to a later scan."""
        hm = self.hedges
        seqno = unit.seqno
        plen = len(unit.payload)
        job = self.jobs.get(unit.job) if unit.job else None
        over_quota = False
        if job is not None and job.quota_bytes > 0:
            part = self.wq.part(unit.job)
            used = part.total_bytes if part is not None else 0
            over_quota = used + plen > job.quota_bytes
        if self.mem.under_pressure or over_quota:
            hm.veto(seqno)
            self.metrics.counter("hedges_vetoed",
                                 reason="backpressure").inc()
            self.flight.record(
                f"hedge_vetoed seqno={seqno} reason=backpressure "
                f"(pressure={self.mem.under_pressure} quota={over_quota})"
            )
            return
        if not hm.try_debit(unit.job):
            self.metrics.counter("hedges_vetoed", reason="budget").inc()
            return  # transient: deliveries refill the bucket
        # a hedge only launches INTO an already-parked requester on a
        # different, live rank — no taker means no launch (the sibling
        # must pin immediately; it never sits unpinned in open matching)
        entry = None
        for e in self.rq.entries():
            if e.world_rank == owner or e.world_rank in self._dead_ranks:
                continue
            if e.job != unit.job or not e.wants(unit.work_type):
                continue
            entry = e
            break
        if entry is None:
            hm.refund(unit.job)
            self.metrics.counter("hedges_vetoed", reason="no_taker").inc()
            return
        if not self.mem.try_alloc(plen):
            hm.refund(unit.job)
            hm.veto(seqno)  # allocation failure IS backpressure
            self.metrics.counter("hedges_vetoed",
                                 reason="backpressure").inc()
            return
        sib = WorkUnit(
            seqno=self._next_seqno,
            work_type=unit.work_type,
            prio=unit.prio,
            target_rank=-1,
            answer_rank=unit.answer_rank,
            payload=unit.payload,
            home_server=self.rank,
            attempts=unit.attempts,
            job=unit.job,
        )
        self._next_seqno += 1
        hm.open(seqno, sib.seqno, unit.job)
        self._m_hedges_launched.inc()
        if unit.spans is not None:
            # the origin stamps the hedge hop FIRST, then the sibling's
            # journey starts as a copy of that history under its own
            # (tail-minted) id — whichever copy terminates, the
            # promoted journey shows the race (why=["hedged"])
            self.journeys.stamp(unit, "hedge")
            self.journeys.adopt(
                sib, self.journeys.mint_tail_id(), list(unit.spans)
            )
        elif self.journeys.tail:
            self.journeys.begin_tail(sib, now)
            self.journeys.stamp(sib, "hedge")
        self.wq.add(sib)
        if self.wlog is not None:
            self.wlog.log_put(sib, -1, None)
            self.wlog.log_hedge(sib.seqno, seqno)
        self.flight.record(
            f"hedge_launched origin={seqno} sib={sib.seqno} owner={owner} "
            f"taker={entry.world_rank} why={why} "
            f"age_s={now - unit.time_stamp:.3f}"
        )
        # a launch is activity: an in-flight exhaustion vote must not
        # conclude around the race (the fused delivery below settles it
        # synchronously anyway; the handle path keeps it open)
        self.activity += 1
        self._job_activity(unit.job)
        self._exhaust_held_since = None
        self._pin(sib.seqno, entry.world_rank)
        self._satisfy_parked(entry, sib, local=False)

    def _hedge_settle(self, unit) -> None:
        """First terminal among a hedge group's members: close the race
        exactly once, BEFORE the winner's own settle proceeds — every
        other live member is fenced against its pin owner (the loser's
        late fetch answers ADLB_FENCED through the fencing check) and
        removed from service, on this reactor, so no second payload can
        ever leave the books."""
        hm = self.hedges
        if hm is None:
            return
        res = hm.settle(unit.seqno)
        if res is None:
            return
        origin, losers = res
        if unit.seqno != origin:
            self._m_hedges_won.inc()
        removed = 0
        for s in losers:
            u = self.wq.get(s)
            if u is None:
                continue
            if u.pinned:
                self._relay_inflight.pop(s, None)
                self.leases.release(s)
                self._add_fence(s, u.pin_rank)
                if self.wlog is not None:
                    self.wlog.log_fence(s, u.pin_rank)
            self._m_hedges_fenced.inc()
            self._unspill(u)
            self.wq.remove(s)
            self.mem.free(len(u.payload))
            if self.wlog is not None:
                self.wlog.log_remove(s)
            # the loser's journey is released, never closed: the winner
            # carries the hedge hop, and a loser fold would double the
            # unit in every latency estimator
            self.journeys.forget(u)
            removed += 1
            self.flight.record(
                f"hedge_fenced loser={s} winner={unit.seqno} "
                f"origin={origin}"
            )
        if removed:
            self.activity += 1  # inventory changed under the vote

    def _hedge_member_unpin(self, unit) -> bool:
        """An open hedge-group member lost its pin WITHOUT terminating
        (lease expiry / unreserve compensation / rank-death reclaim).
        While a sibling still races, re-enqueueing this copy would put
        two live duplicates into open matching with nobody left to
        fence the loser — so it retires (fenced against its old owner,
        removed, forgotten). Returns True when the caller must skip its
        normal requeue. The LAST live copy returns False and re-enters
        service through the caller's standard path: hedging never loses
        work."""
        hm = self.hedges
        if hm is None:
            return False
        siblings = hm.survivors_of(unit.seqno)
        if not any(self.wq.get(s) is not None for s in siblings):
            if siblings:
                # the race is over with this copy the survivor: dissolve
                # the group and supersede the sibling's OP_HEDGE mark so
                # recovery adopts it like any ordinary unit
                hm.drop(unit.seqno)
                self._hedge_relog(unit)
            return False
        hm.drop(unit.seqno)
        self.leases.release(unit.seqno)
        if unit.pinned and (unit.seqno, unit.pin_rank) not in self._fences:
            self._add_fence(unit.seqno, unit.pin_rank)
            if self.wlog is not None:
                self.wlog.log_fence(unit.seqno, unit.pin_rank)
        self._unspill(unit)
        self.wq.remove(unit.seqno)
        self.mem.free(len(unit.payload))
        if self.wlog is not None:
            self.wlog.log_remove(unit.seqno)
        self.journeys.forget(unit)
        self.flight.record(
            f"hedge_member_retired seqno={unit.seqno} "
            f"(sibling still racing)"
        )
        # whoever survives the race may need to dissolve too: if the
        # retirement left exactly one member, it is an ordinary unit now
        for s in siblings:
            if not hm.survivors_of(s):
                u = self.wq.get(s)
                if u is not None:
                    self._hedge_relog(u)
                break
        return True

    def _hedge_relog(self, unit) -> None:
        """A hedge race dissolved with ``unit`` the sole survivor:
        re-log its OP_PUT so the mirror/WAL's OP_HEDGE mark is
        superseded — recovery must adopt the survivor as an ordinary
        unit, not discard it as a speculative sibling."""
        if self.wlog is not None:
            self.wlog.log_put(unit, -1, None)

    def _bump_attempts(self, unit, in_wq: bool) -> bool:
        """Account one failed delivery attempt; quarantine the unit when
        it exceeds the retry budget. Returns True when quarantined.
        ``in_wq``: whether the unit currently sits (unpinned) in the wq
        — False on the consumed-but-undeliverable path."""
        unit.attempts += 1
        if self.wlog is not None and in_wq:
            self.wlog.log_attempts(unit.seqno, unit.attempts)
        maxr = self.cfg.max_unit_retries
        if maxr <= 0 or unit.attempts <= maxr:
            return False
        self._quarantine_unit(unit, in_wq=in_wq)
        return True

    def _quarantine_record(self, unit) -> dict:
        """Dead-letter record for one unit — the single source of the
        record shape (see _quarantine_unit / _adopt_quarantined). A
        fused batch member carries only its suffix: reattach the prefix
        when this server stores it, so the operator retrieves the
        payload the app would have received; when the prefix lives
        elsewhere the record is flagged ``suffix_only`` and keeps the
        common handle instead of silently passing off the suffix as
        the whole payload."""
        payload, suffix_only = unit.payload, False
        cseq, cs = unit.common_seqno, unit.common_server_rank
        clen = unit.common_len
        if cseq >= 0:
            prefix = self.cq.peek(cseq) if cs in (-1, self.rank) else None
            if prefix is not None:
                payload, cseq, cs, clen = prefix + payload, -1, -1, 0
            else:
                suffix_only = True
        return {
            "seqno": unit.seqno,
            "work_type": unit.work_type,
            "prio": unit.prio,
            "target_rank": unit.target_rank,
            "answer_rank": unit.answer_rank,
            "payload": payload,
            "attempts": unit.attempts,
            "server_rank": self.rank,
            "suffix_only": suffix_only,
            "common_seqno": cseq,
            "common_server_rank": cs,
            "common_len": clen,
        }

    def _quarantine_unit(self, unit, in_wq: bool) -> None:
        """Move a unit to the dead-letter store: out of the wq (settled
        for exhaustion voting — termination never hangs on a poison
        unit), counted exactly-once, payload retained for retrieval."""
        # quarantine is a terminal: it must close any hedge race (and
        # fence the siblings) exactly like a delivery would — without
        # it, a poisoned origin would leave its sibling racing a unit
        # the books already settled. No budget credit: only deliveries
        # fund the bucket.
        self._hedge_settle(unit)
        self._unspill(unit)  # the dead-letter record keeps the payload
        if in_wq:
            self.wq.remove(unit.seqno)
            self.leases.release(unit.seqno)
            self.mem.free(len(unit.payload))
        if self.wlog is not None:
            if not in_wq:
                # the mirror tombstoned this unit at consume; re-install
                # it so the quarantine entry has something to move
                self.wlog.log_put(unit, -1, None)
            self.wlog.log_quarantine(unit.seqno)
        self.quarantine.append(self._quarantine_record(unit))
        self.stats[InfoKey.QUARANTINED] += 1
        self._m_quarantined.inc()
        if unit.spans is not None:
            # quarantine is terminal: close the journey with its cause
            self.journeys.close(unit, "quarantined")
        self.flight.record(
            f"unit_quarantined seqno={unit.seqno} type={unit.work_type} "
            f"attempts={unit.attempts}"
        )

    def _adopt_quarantined(self, f: dict, old_seqno: int,
                           dead: int) -> None:
        """Take over a failed-over predecessor's dead-letter entry under
        a fresh local seqno, re-counting it here (the dead server's own
        QUARANTINED stat died with it — exactly-once holds because only
        the survivor's count reaches the final aggregation). A fused
        member's prefix handle translates through the adopted-commons
        map first, so the record can reattach a prefix this buddy now
        stores."""
        cs = f.get("common_server_rank", -1)
        cseq = f.get("common_seqno", -1)
        if cseq >= 0 and cs == dead:
            new_c = self._adopted_commons.get((dead, cseq))
            if new_c is not None:
                cs, cseq = self.rank, new_c
            # else: prefix lost to replication lag — the stale handle
            # stays in the record, honestly suffix_only
        unit = WorkUnit(
            seqno=self._next_seqno,
            work_type=f["work_type"],
            prio=f["prio"],
            target_rank=f["target_rank"],
            answer_rank=f["answer_rank"],
            payload=f["payload"],
            common_len=f.get("common_len", 0),
            common_server_rank=cs,
            common_seqno=cseq,
            attempts=f.get("attempts", 0),
        )
        self._next_seqno += 1
        self.quarantine.append(self._quarantine_record(unit))
        self.stats[InfoKey.QUARANTINED] += 1
        self._m_quarantined.inc()
        if self.wlog is not None:
            self.wlog.log_put(unit, -1, None)
            self.wlog.log_quarantine(unit.seqno)
        self.flight.record(
            f"unit_quarantined seqno={unit.seqno} (adopted, was "
            f"{old_seqno})"
        )

    def _peer_has_room(self, nbytes: int) -> bool:
        """Any live peer believed able to admit nbytes under its cap —
        the backpressure eligibility test (a push/hint would help)."""
        cap = self.cfg.max_malloc_per_server
        if cap <= 0:
            return True
        for s, st in self.peers.items():
            if s == self.rank or s in self._dead_servers:
                continue
            if st.nbytes + nbytes <= cap:
                return True
        return False

    def _on_heartbeat(self, m: Msg) -> None:
        """Liveness beacon (last-heard already stamped in _handle); with
        a seqno it is an explicit lease extension (ctx.extend_lease). A
        seqno whose lease is gone (expired/consumed) is silently stale —
        the owner's next settle attempt learns through the normal
        fence/retry paths."""
        self._m_heartbeats.inc()
        seqno = m.data.get("seqno")
        if seqno is not None:
            fo = m.data.get("fo_from")
            if fo is not None:
                seqno = self._adopted_units.get((fo, seqno))
                if seqno is None:
                    return
            lease = self.leases.get(seqno)
            if lease is not None and lease.owner == m.src:
                self.leases.renew(seqno)

    def _on_get_quarantined(self, m: Msg) -> None:
        """Dead-letter retrieval: this server's quarantine store, shipped
        as parallel per-unit lists (the codec's batch idiom — plain dicts
        do not cross the TCP fabric); the client zips them back into
        records."""
        q = list(self.quarantine)
        self._send_app(
            m.src,
            msg(
                Tag.TA_QUARANTINED_RESP,
                self.rank,
                rc=ADLB_SUCCESS,
                seqnos=[r["seqno"] for r in q],
                work_types=[r["work_type"] for r in q],
                prios=[r["prio"] for r in q],
                target_ranks=[r["target_rank"] for r in q],
                answer_ranks=[r["answer_rank"] for r in q],
                attempts_list=[r["attempts"] for r in q],
                payloads=[r["payload"] for r in q],
                suffix_onlys=[
                    1 if r.get("suffix_only") else 0 for r in q
                ],
            ),
        )

    # ------------------------------------------------- service mode
    # Durable multi-tenant operation (ROADMAP item 3): the per-server
    # WAL (Config(wal_dir), runtime/wal.py) makes the pool survive
    # process death, and job namespaces (runtime/jobs.py) multiplex
    # many jobs over one persistent fleet — per-job wq partitions,
    # per-job exhaustion rings, per-tenant put quotas, and a /jobs
    # control plane on the ops endpoint + the FA_JOB_CTL round trip.

    def _refresh_wlog(self) -> None:
        """Rebuild the single mutation-log handle (network replication
        log, WAL, tee of both, or None) — called at init and whenever
        the replication stream re-targets."""
        repl = getattr(self, "repl", None)
        wal = getattr(self, "wal", None)
        if repl is not None and wal is not None:
            from adlb_tpu_torch.runtime.wal import TeeLog

            self.wlog = TeeLog([repl, wal])
        else:
            self.wlog = repl if repl is not None else wal

    def _flush_wal(self, force: bool = False) -> None:
        """Write buffered WAL entries; run the group commit when due and
        release the put acks it covers."""
        w = self.wal
        if w is None:
            return
        prof = self._prof_shared
        if prof is not None:
            prof.set_phase("wal_fsync")
        synced_before = w.syncs
        self._release_wal_acks(w.tick(time.monotonic(), force=force))
        if w.syncs != synced_before:
            self._m_wal_syncs.inc(w.syncs - synced_before)

    def _release_wal_acks(self, acks) -> None:
        """Send the put acks a group commit (or compaction) released;
        traced puts among them get their ``wal_commit`` span — the ack
        release IS the durability instant the client observes."""
        for app, resp in acks:
            if self._trace_wal_pending:
                unit = self._trace_wal_pending.pop(
                    (app, resp.data.get("put_id")), None
                )
                if unit is not None and unit.spans is not None:
                    self.journeys.stamp(unit, "wal_commit")
                    # the OP_TRACE written at put time predates this
                    # span: re-log so the durable copy (and the buddy's
                    # mirror) carries the commit hop too
                    if self.wlog is not None:
                        self.wlog.log_trace(unit.seqno, unit.trace_id,
                                            unit.spans)
            self._send_app(app, resp)

    def _wal_seed(self, log) -> None:
        """Durable non-pool state re-seeded into a fresh WAL segment at
        compaction (the ACK2 shard carries the pool itself): quarantine
        records, put-dedup windows, and the job table."""
        from adlb_tpu_torch.runtime.jobs import STATE_CODES

        for q in self.quarantine:
            unit = WorkUnit(
                seqno=q["seqno"], work_type=q["work_type"], prio=q["prio"],
                target_rank=q["target_rank"], answer_rank=q["answer_rank"],
                payload=q["payload"], attempts=q["attempts"],
                common_len=q.get("common_len", 0),
                common_server_rank=q.get("common_server_rank", -1),
                common_seqno=q.get("common_seqno", -1),
            )
            log.log_put(unit, -1, None)
            log.log_quarantine(q["seqno"])
        for src, (_ids, order) in self._seen_puts.items():
            log.log_seen_puts(src, order)
        for job in self.jobs.values():
            if job.job_id:
                log.log_job(job.job_id, STATE_CODES[job.state],
                            job.quota_bytes, job.name)
        # live units' trace contexts: the ACK2 shard cannot carry them,
        # so they re-seed as OP_TRACE entries applied after the manifest
        # installs the units
        for u in self.wq.units():
            if u.trace_id and u.spans is not None:
                log.log_trace(u.seqno, u.trace_id, u.spans)
        # open hedge races: each live sibling's OP_HEDGE mark must
        # survive compaction (the fresh segment re-logs the sibling's
        # OP_PUT above, which would otherwise launder it into an
        # ordinary unit and recovery would adopt BOTH copies)
        if self.hedges is not None:
            for sib, origin in self.hedges.live_siblings():
                if self.wq.get(sib) is not None:
                    log.log_hedge(sib, origin)

    def _recover_from_wal(self) -> None:
        """Cold restart: replay the on-disk log (snapshot shard + tail)
        through a ReplicaMirror and adopt the result into the live
        queues. Units come back unpinned — their owners died with the
        previous fleet — so recovered work re-executes, the standard
        crash-recovery contract; an ACKED put is always here (or in the
        quarantine), never silently gone."""
        mirror = self.wal.recover()
        if mirror is None:
            return
        n_units = 0  # adopted: units, commons, quarantine, job table
        hedge_dropped = 0
        for seqno in sorted(mirror.units):
            if seqno in mirror.hedges:
                # live hedge SIBLING at crash time: a speculative copy
                # of an origin that also recovers — adopting both would
                # hand two live duplicates to a restarted world with the
                # group state gone. Discard the sibling; the origin
                # re-enqueues, re-execution falls inside the documented
                # lease-expiry at-least-once window. (A sibling that WON
                # its race was superseded by OP_CONSUME, and one that
                # survived a dissolved race by a fresh OP_PUT.)
                hedge_dropped += 1
                continue
            f = dict(mirror.units[seqno])
            payload = f.pop("payload")
            trace_id = f.pop("trace_id", 0)
            tspans = f.pop("spans", None)
            unit = WorkUnit(seqno=seqno, payload=payload,
                            home_server=self.rank, **f)
            unit.pinned = False
            unit.pin_rank = -1
            self.mem.alloc(len(payload))
            if trace_id:
                # cold restart keeps the journey: the pre-crash spans
                # (durable via OP_TRACE / the compaction seed) continue
                # with a "replay" hop
                self.journeys.adopt(unit, trace_id, tspans,
                                    stage="replay")
            self.wq.add(unit)
            # re-log toward the buddy only (self.repl): the WAL already
            # holds these entries durably — re-teeing them would double
            # the segment on every restart
            if self.repl is not None:
                self.repl.log_put(unit, -1, None)
            self._next_seqno = max(self._next_seqno, seqno + 1)
            n_units += 1
        for seqno in sorted(mirror.commons):
            buf, refcnt, ngets, _credits = mirror.commons[seqno]
            self.mem.alloc(len(buf))
            self.cq.restore(seqno, refcnt, ngets, buf)
            if self.repl is not None:
                self.repl.log_common_put(seqno, buf)
                self.repl.log_common_state(seqno, refcnt, ngets, 0)
        for seqno in sorted(mirror.quarantined):
            f = mirror.quarantined[seqno]
            unit = WorkUnit(
                seqno=seqno, work_type=f["work_type"], prio=f["prio"],
                target_rank=f["target_rank"], answer_rank=f["answer_rank"],
                payload=f["payload"], attempts=f.get("attempts", 0),
                common_len=f.get("common_len", 0),
                common_server_rank=f.get("common_server_rank", -1),
                common_seqno=f.get("common_seqno", -1),
            )
            self.quarantine.append(self._quarantine_record(unit))
            self.stats[InfoKey.QUARANTINED] += 1
            self._next_seqno = max(self._next_seqno, seqno + 1)
            if self.repl is not None:
                self.repl.log_put(unit, -1, None)
                self.repl.log_quarantine(seqno)
        # mirror.seen_puts is deliberately NOT adopted: the put-dedup
        # window keys on per-client put ids, and a cold restart means
        # NEW client processes whose ids restart from 1 — a restored
        # window would silently swallow their first puts as "duplicates"
        # of the dead world's. (The failover promote path DOES adopt it:
        # there the clients survive and their id streams continue.)
        for jid, (code, quota, name) in mirror.jobs_meta.items():
            self.jobs.restore(jid, code, quota, name)
        self.wal_recovered = n_units
        if n_units or mirror.entries_applied:
            self.flight.record(
                f"wal_recovered units={n_units} "
                f"commons={len(mirror.commons)} "
                f"quarantined={len(mirror.quarantined)} "
                f"jobs={len(mirror.jobs_meta)} "
                f"hedge_siblings_dropped={hedge_dropped} "
                f"torn_tail={self.wal.recovered_torn}"
            )
            aprintf(
                self.cfg.aprintf_flag, self.rank,
                f"WAL recovery: {n_units} units, {len(mirror.commons)} "
                f"common entries, {len(mirror.quarantined)} quarantined, "
                f"{len(mirror.jobs_meta)} jobs "
                f"(torn tail: {self.wal.recovered_torn})",
            )

    def _void_killed_unit(self, seqno: int) -> None:
        self._killed_units.add(seqno)
        self._killed_order.append(seqno)
        if len(self._killed_order) > 65536:
            self._killed_units.discard(self._killed_order.popleft())

    # -- job control plane ---------------------------------------------------

    def ctl_request(self, req: dict, timeout: float = 5.0) -> dict:
        """Thread-safe control-plane injection (the ops HTTP thread's
        POST /jobs): enqueue for the reactor, wait for its verdict."""
        req = dict(req)
        req["done"] = threading.Event()
        self._ctl_inbox.append(req)
        if not req["done"].wait(timeout):
            raise TimeoutError("reactor did not service the control "
                               "request in time")
        if "error" in req:
            raise RuntimeError(req["error"])
        return req["result"]

    def _drain_ctl_inbox(self) -> None:
        while self._ctl_inbox:
            req = self._ctl_inbox.popleft()
            try:
                req["result"] = self._handle_ctl(req)
            except Exception as e:  # noqa: BLE001 — surfaces over HTTP
                req["error"] = repr(e)
            req["done"].set()

    def _handle_ctl(self, req: dict) -> dict:
        op = req["op"]
        if op == "submit":
            jid = self._alloc_job_id()
            self._job_ctl_fanout(
                "submit", jid, name=str(req.get("name", "")),
                quota=int(req.get("quota_bytes", 0) or 0),
            )
            return {"job_id": jid, "state": self.jobs.get(jid).state}
        if op in ("drain", "kill"):
            jid = int(req["job_id"])
            if self.jobs.get(jid) is None:
                raise KeyError(f"unknown job {jid}")
            self._job_ctl_fanout(op, jid)
            return {"job_id": jid, "state": self.jobs.get(jid).state}
        if op == "update":
            # POST /jobs/<id>: live policy tweak — fair-share weight
            # and/or quota (0 = leave unchanged, -1 = unlimited)
            jid = int(req["job_id"])
            if self.jobs.get(jid) is None:
                raise KeyError(f"unknown job {jid}")
            weight = req.get("weight")
            if weight is not None:
                weight = float(weight)
                if not weight > 0.0:
                    raise ValueError("weight must be > 0")
            self._job_ctl_fanout(
                "update", jid,
                quota=int(req.get("quota_bytes", 0) or 0),
                weight=weight,
            )
            return self.jobs.get(jid).summary()
        if op == "fleet":
            return self.fleet_doc()
        if op == "scale_out":
            if not self.is_master:
                raise ValueError("scale_out is a master op")
            if self._member_terminating():
                raise RuntimeError("world terminating")
            return self._request_scale_out("manual")
        if op == "scale_in":
            if not self.is_master:
                raise ValueError("scale_in is a master op")
            if self.cfg.on_server_failure != "failover":
                raise RuntimeError(
                    "scale_in drains through the promote path: "
                    "on_server_failure='failover' required (clients "
                    "must follow TA_HOME_TAKEOVER)"
                )
            if self._member_terminating():
                raise RuntimeError("world terminating")
            live = [
                s for s in self.world.server_ranks
                if s not in self._dead_servers
                and s not in self._draining_servers
                and self._is_live_member(s)
            ]
            rank = req.get("rank")
            if rank is None:
                # newest scale-out shard first, else the highest-ranked
                # non-master base server
                extras = [s for s in live
                          if s not in self.world.spec.server_ranks]
                cands = extras or [
                    s for s in live
                    if s != self.world.master_server_rank
                ]
                if not cands:
                    raise RuntimeError("no drainable server")
                rank = max(cands)
            rank = int(rank)
            if rank == self.world.master_server_rank:
                raise ValueError("cannot drain the master")
            if rank not in live:
                raise ValueError(f"server {rank} is not live")
            if len(live) <= 2:
                raise RuntimeError(
                    "refusing to drain below two live servers (the "
                    "drained shard needs a buddy)"
                )
            epoch = self.world.epoch + 1
            for s in self._live_servers():
                try:
                    self.ep.send(
                        s, msg(Tag.SS_MEMBER, self.rank,
                               mop="server_drain", rank=rank,
                               epoch=epoch),
                    )
                except OSError:
                    self._note_server_unreachable(s)
            self._apply_member(
                dict(mop="server_drain", rank=rank, epoch=epoch)
            )
            return {"rank": rank, "epoch": epoch}
        if op == "slo":
            # POST /slo: add an objective to the live engine (creating
            # it on first use). Master-only — evaluation runs where the
            # merged fleet view lives.
            if not self.is_master:
                raise RuntimeError("slo objectives live on the master")
            if not self._obs_sync_armed:
                raise RuntimeError(
                    "slo needs the obs plane (ops_port + "
                    "obs_sync_interval > 0)"
                )
            from adlb_tpu_torch.obs.slo import SloEngine

            if self._slo_engine is None:
                self._slo_engine = SloEngine(
                    self.cfg.slo_eval_interval
                    or self.cfg.obs_sync_interval
                )
            o = self._slo_engine.add(req.get("objective") or {})
            self.flight.record(f"slo_objective_added {o['name']}")
            if self._failover and self.repl is not None:
                # live-POSTed objectives are brain state: without this
                # the promoted deputy's /slo would silently forget them
                self.repl.log_slo(dict(o))
            return {"objective": o,
                    "n_objectives": len(self._slo_engine.objectives)}
        if op == "control":
            # POST /control: live policy tweak on the fleet controller
            # (thresholds, bounds, cooldown, dry_run) — no restart
            if not self.is_master:
                raise RuntimeError("the controller lives on the master")
            if self._controller is None:
                raise RuntimeError(
                    "controller not configured (Config(control=True))"
                )
            pol = self._controller.update_policy(
                req.get("policy") or {}
            )
            self.flight.record(
                "control_policy_updated "
                + " ".join(f"{k}={v}" for k, v in sorted(pol.items()))
            )
            if self._failover and self.repl is not None:
                self.repl.log_control(dict(pol))
            return {"policy": pol}
        raise ValueError(f"unknown control op {op!r}")

    def _alloc_job_id(self) -> int:
        """Master: next unused job id — floored above every id the table
        has ever seen, so ids restored from the WAL (or adopted in a
        takeover) are never reissued to a new tenant (a reused id would
        inherit the old job's state: a DONE job is born closed, a
        RUNNING one silently merges two tenants)."""
        jid = max(self._job_next_id, self.jobs.max_id() + 1)
        self._job_next_id = jid + 1
        return jid

    def _job_ctl_fanout(self, op: str, jid: int, name: str = "",
                        quota: int = 0,
                        weight: Optional[float] = None) -> None:
        """Master: apply a job lifecycle change and broadcast it."""
        for srv in self._live_servers():
            if srv == self.rank:
                continue
            try:
                self.ep.send(
                    srv,
                    msg(Tag.SS_JOB_CTL, self.rank, op=op, job_id=jid,
                        job_name=name, quota=quota, weight=weight),
                )
            except OSError:
                if not self._failover:
                    raise
                self._note_server_unreachable(srv)
        self._apply_job_ctl(op, jid, name, quota, weight)

    def _on_ss_job_ctl(self, m: Msg) -> None:
        self._apply_job_ctl(
            m.data["op"], m.job_id, m.data.get("job_name", ""),
            m.data.get("quota", 0), m.data.get("weight"),
        )

    def _apply_job_ctl(self, op: str, jid: int, name: str = "",
                       quota: int = 0,
                       weight: Optional[float] = None) -> None:
        from adlb_tpu_torch.runtime.jobs import STATE_CODES

        if weight is None and op == "submit" and self.cfg.job_weights:
            # Config(job_weights) pre-names ids the allocator will hand
            # out: stamp the weight onto the Job at birth so later
            # weights() fan-outs (and /jobs summaries) carry it
            weight = self.cfg.job_weights.get(jid)
        job = self.jobs.apply(op, jid, name=name, quota_bytes=quota,
                              weight=weight)
        if weight is not None:
            # hand the new fair-share map to the balancer thread; it
            # applies set_job_weights() at its next round top (the
            # engine's caches are not safe to flush from the reactor)
            self._pending_job_weights = self._effective_job_weights()
            if self._balancer is not None:
                self._balancer.wake.set()
            self.flight.record(
                f"job_weight job={jid} weight={job.weight:g}"
            )
            if self.is_master and self._failover and self.repl is not None:
                # fair-share weights don't ride wlog.log_job (state/
                # quota/name only): stream them so a promoted deputy's
                # planner starts from the live weight map
                self.repl.log_job_weight(jid, job.weight)
        if self.wlog is not None:
            self.wlog.log_job(jid, STATE_CODES[job.state],
                              job.quota_bytes, job.name)
        if op == "done":
            self._m_jobs_done.inc()
            self.flight.record(f"job_done job={jid}")
            self._flush_rq_job(jid, ADLB_DONE_BY_EXHAUSTION)
        elif op == "kill":
            dropped = self.wq.drop_job(jid)
            for u in dropped:
                self._spill_drop(u)
                self.mem.free(len(u.payload))
                self.leases.release(u.seqno)
                self._relay_inflight.pop(u.seqno, None)
                self._void_killed_unit(u.seqno)
                if u.spans is not None:
                    # a kill is terminal for the journey too (and must
                    # release the recorder's live slot — leaking it
                    # would eventually cap out tracing fleet-wide)
                    self.journeys.close(u, "dropped")
                if u.common_seqno >= 0:
                    # a fused batch member's prefix share will never be
                    # fetched: forfeit it so the common entry still GCs
                    # (same discipline as every other drop path)
                    self._forfeit_common(u.common_seqno,
                                         u.common_server_rank)
                if self.wlog is not None:
                    self.wlog.log_remove(u.seqno)
            self.flight.record(
                f"job_killed job={jid} dropped={len(dropped)}"
            )
            self._flush_rq_job(jid, ADLB_NO_MORE_WORK)

    def _effective_job_weights(self) -> dict:
        """Config(job_weights) as the base layer (ids the allocator may
        not have issued yet), overridden by every job the table actually
        knows — including explicit resets back to neutral."""
        w = dict(self.cfg.job_weights or {})
        for j in self.jobs.values():
            if j.weight != 1.0:
                w[j.job_id] = j.weight
            else:
                w.pop(j.job_id, None)
        return w

    def _on_fa_job_ctl(self, m: Msg) -> None:
        op = m.data["op"]
        jid = int(m.data.get("job_id", 0) or 0)
        if op == "attach":
            # the rank's HOME server records the namespace binding; the
            # per-job exhaustion vote reads it for this server's locals
            self._rank_job[m.src] = jid
            if jid:
                self.jobs.ensure(jid)
            self._send_app(
                m.src,
                msg(Tag.TA_JOB_CTL_RESP, self.rank, rc=ADLB_SUCCESS,
                    job_id=jid),
            )
            return
        if op == "status":
            job = self.jobs.get(jid)
            self._send_app(
                m.src,
                msg(Tag.TA_JOB_CTL_RESP, self.rank,
                    rc=ADLB_SUCCESS if job is not None else -1,
                    job_id=jid,
                    status=None if job is None else job.summary()),
            )
            return
        if not self.is_master:
            # submit/drain/kill are the master's to serialize (it
            # allocates ids and owns the fan-out)
            self._send_app(
                m.src,
                msg(Tag.TA_JOB_CTL_RESP, self.rank, rc=-1, job_id=jid),
            )
            return
        if op == "submit":
            jid = self._alloc_job_id()
            name = m.data.get("job_name", "")
            if isinstance(name, bytes):
                name = name.decode("utf-8", "replace")
            self._job_ctl_fanout(
                "submit", jid, name=name,
                quota=int(m.data.get("quota", 0) or 0),
            )
        elif op in ("drain", "kill"):
            if self.jobs.get(jid) is None:
                self._send_app(
                    m.src,
                    msg(Tag.TA_JOB_CTL_RESP, self.rank, rc=-1, job_id=jid),
                )
                return
            self._job_ctl_fanout(op, jid)
        else:
            self._send_app(
                m.src,
                msg(Tag.TA_JOB_CTL_RESP, self.rank, rc=-1, job_id=jid),
            )
            return
        self._send_app(
            m.src,
            msg(Tag.TA_JOB_CTL_RESP, self.rank, rc=ADLB_SUCCESS,
                job_id=jid),
        )

    # -- per-job termination -------------------------------------------------

    def _flush_rq_job(self, jid: int, rc: int) -> None:
        """Flush ONE job's parked requesters (its termination verdict)
        without touching any other namespace — one job draining never
        blocks another."""
        for entry in self.rq.entries():
            if entry.job == jid:
                self.rq.remove_entry(entry)
                self._reserve_resp(entry.world_rank, rc,
                                   rqseqno=entry.rqseqno)

    def _exhaust_vote_job(self, jid: int) -> bool:
        """This server's per-job exhaustion vote: the job's partition is
        EMPTY here (consumed work only — a job completes when its queue
        drains; unmatchable leftovers keep it running until /jobs kill)
        and every local app attached to the job is parked or finished.
        Ranks attached to other namespaces are invisible — their compute
        never blocks this job's verdict."""
        part = self.wq.part(jid)
        if part is not None and part.count != 0:
            return False
        for r in self.local_apps:
            if r in self._finalized or r in self._dead_ranks:
                continue
            if self._rank_job.get(r, 0) != jid:
                continue
            if not (
                r in self.rq
                and (self.rq.has_blocking(r) or r in self._stream_idle)
            ):
                return False
        return True

    def _check_job_exhaustion(self, now: float) -> None:
        """Master: the WORLD exhaustion logic run per live job — same
        held-vote debounce, same two-pass ring with activity stamps,
        token stamped with the job id."""
        if self.no_more_work or self.done_by_exhaustion:
            return
        for jid in self.jobs.active_ids():
            job = self.jobs.get(jid)
            if job.exhaust_inflight:
                if now - job.exhaust_sent_at < (
                    10 * self.cfg.exhaust_check_interval
                ):
                    continue
                job.exhaust_inflight = False  # lost-token recovery
            if not self._exhaust_vote_job(jid):
                job.exhaust_held_since = None
                continue
            if job.exhaust_held_since is None:
                job.exhaust_held_since = now
                continue
            if now - job.exhaust_held_since < (
                self.cfg.exhaust_check_interval
            ):
                continue
            job.exhaust_inflight = True
            job.exhaust_sent_at = now
            job.exhaust_token_id += 1
            token = {
                "job": jid,
                "origin": self.rank,
                "token_id": job.exhaust_token_id,
                "ok": True,
                "act": {self.rank: job.activity},
                "epoch": self.world.epoch,
            }
            self._forward_exhaust(Tag.SS_EXHAUST_CHK_1, token)

    def _on_job_exhaust_chk(self, m: Msg) -> None:
        token = m.token
        jid = token["job"]
        phase1 = m.tag is Tag.SS_EXHAUST_CHK_1
        job = self.jobs.ensure(jid)
        if token.get("epoch", self.world.epoch) != self.world.epoch:
            # per-job votes key on the membership epoch exactly like the
            # world vote: a rank joining (and attaching to this job)
            # mid-ring voids the verdict (and heals a lagging view)
            token["ok"] = False
            self.world.note_epoch(token.get("epoch", 0) or 0)
        if m.data.get("complete") and token["origin"] == self.rank:
            if token.get("token_id", 0) != job.exhaust_token_id:
                return  # straggler from an abandoned token
            from adlb_tpu_torch.runtime import jobs as jobsmod

            ok = (
                token["ok"]
                and self._exhaust_vote_job(jid)
                and job.activity == token["act"].get(self.rank, -1)
                # same completeness bar as the world vote: a hop whose
                # membership lagged a scale-out shard skipped it
                and self._ring_covered(token["act"])
                # a submitted-but-never-started job must not complete:
                # "done" needs evidence the job RAN (activity somewhere
                # in the fleet) — or an explicit drain, which is the
                # operator saying there is nothing more to wait for
                and (
                    sum(token["act"].values()) > 0
                    or job.state == jobsmod.DRAINING
                )
            )
            if not ok:
                job.exhaust_held_since = None
                job.exhaust_inflight = False
                return
            if phase1:
                token2 = {
                    "job": jid,
                    "origin": self.rank,
                    "token_id": job.exhaust_token_id,
                    "ok": True,
                    "act": token["act"],
                    "epoch": self.world.epoch,
                }
                self._forward_exhaust(Tag.SS_EXHAUST_CHK_2, token2)
            else:
                job.exhaust_inflight = False
                self._job_ctl_fanout("done", jid)
            return
        # contribute and forward
        if phase1:
            token["ok"] = token["ok"] and self._exhaust_vote_job(jid)
            token["act"][self.rank] = job.activity
        else:
            token["ok"] = (
                token["ok"]
                and self._exhaust_vote_job(jid)
                and job.activity == token["act"].get(self.rank, -1)
            )
        self._forward_exhaust(m.tag, token)

    def _job_activity(self, jid: int) -> None:
        if jid:
            self.jobs.ensure(jid).activity += 1

    # ------------------------------------------------- elastic membership
    # adlb_tpu_torch/runtime/membership.py; no reference analogue — upstream
    # fixes every role at ADLB_Init. The MASTER owns allocation (rank
    # ids, home servers, fleet epochs) and the fan-out/ack barrier;
    # every server applies SS_MEMBER ops against its MemberView; the
    # exhaustion/END rings key on the epoch, so a join can never race a
    # termination verdict; scale-out bootstraps a new shard from a
    # donor over the acked migration plane; scale-in drains through the
    # failover promote path with a force-flushed full mirror (zero
    # counted losses).

    @staticmethod
    def _mstr(v) -> str:
        return v.decode("utf-8", "replace") if isinstance(v, bytes) else v

    def _member_terminating(self) -> bool:
        return (
            self.no_more_work or self.done_by_exhaustion or self._ending
            or self._end1_pending or self.done or self._aborted
        )

    def _is_live_member(self, s: int) -> bool:
        """A server eligible for rings/fan-outs/buddy duty: base servers
        always (death is handled by _dead_servers); scale-out shards
        only once their reactor announced ready (server_live fan-out) —
        a not-yet-running shard must not receive ring tokens or become
        someone's replication target."""
        if s in self.world.spec.server_ranks or s == self.rank:
            return True
        return s in self._member_live

    def _buddy_excluded(self) -> set:
        """Servers a buddy walk must skip: the dead, plus joined-but-
        not-yet-live shards (no mirror could exist there)."""
        out = set(self._dead_servers)
        for s in self.world.extra_servers:
            if not self._is_live_member(s):
                out.add(s)
        return out

    def _on_fa_member(self, m: Msg) -> None:
        mop = self._mstr(m.data.get("mop") or "")
        if mop == "detach":
            self._member_detach_req(m)
            return
        if mop != "attach":
            self._member_refuse(m.src, f"unknown member op {mop!r}")
            return
        if not self.is_master:
            self._member_refuse(m.src, "attach goes to the master server")
            return
        if self._member_terminating():
            self._member_refuse(
                m.src, "world terminating", rc=ADLB_NO_MORE_WORK
            )
            return
        kind = self._mstr(m.data.get("kind") or "app")
        host = m.data.get("host")
        port = m.data.get("port")
        addr = (self._mstr(host), int(port)) if host is not None else None
        if addr is not None and hasattr(self.ep, "addr_map"):
            # the joiner's listener: the reply (and everyone's future
            # traffic) dials it; learned under the PROVISIONAL id too so
            # the TA_MEMBER_RESP can be delivered at all
            self.ep.addr_map.setdefault(m.src, addr)
        rank = self._member_next_rank
        self._member_next_rank += 1
        epoch = self.world.epoch + 1
        if addr is not None:
            self._member_addrs[rank] = addr
        if kind == "server":
            fields = dict(mop="server_join", rank=rank, epoch=epoch)
            resp = dict(
                rc=ADLB_SUCCESS, rank=rank, epoch=epoch,
                member=None,  # filled at reply time (fresh snapshot)
                jobs=self._member_jobs_seed(),
                # the new shard must know which base servers are gone:
                # its ring/buddy walks and live-member checks start from
                # the static spec otherwise
                srv_dead=sorted(self._dead_servers),
                srv_drained=sorted(self._drained_servers),
            )
            if hasattr(self.ep, "addr_map"):
                from adlb_tpu_torch.runtime.membership import is_provisional

                resp["rank_addrs"] = {
                    r: a for r, a in self.ep.addr_map.items()
                    if r != rank and not is_provisional(r)
                }
        else:
            home = self._member_pick_home()
            fields = dict(mop="attach", rank=rank, home=home, epoch=epoch)
            # the joiner dialed only the master: it needs EVERY server's
            # listener (its home above all — FA_LOCAL_APP_DONE must land
            # there, or the home counts the rank unfinalized forever)
            srv_addrs = {}
            if hasattr(self.ep, "addr_map"):
                for r in self.world.server_ranks:
                    a = self.ep.addr_map.get(r) or self._member_addrs.get(r)
                    if a is not None:
                        srv_addrs[r] = a
            resp = dict(rc=ADLB_SUCCESS, rank=rank, home=home, epoch=epoch,
                        member=None, srv_addrs=srv_addrs,
                        srv_route=self._member_srv_route())
        if addr is not None:
            fields["host"], fields["port"] = addr
        self._member_barrier(fields, to=m.src, resp=resp)

    def _member_jobs_seed(self) -> list:
        from adlb_tpu_torch.runtime.jobs import STATE_CODES

        return [
            (j.job_id, STATE_CODES[j.state], j.quota_bytes, j.name)
            for j in self.jobs.values() if j.job_id
        ]

    def _member_srv_route(self) -> dict:
        """Retired (dead/drained) server -> the LIVE ring successor that
        owns its shard today, chains collapsed. A joiner missed every
        TA_HOME_TAKEOVER broadcast that predates it, so the attach reply
        must seed its client-side route map directly — otherwise its
        round-robin puts dial the retired listener and time out waiting
        for a takeover note that will never re-arrive."""
        retired = self._dead_servers | self._drained_servers
        route = {}
        ring = self.world.server_ranks
        for r in retired:
            nxt = self.world.ring_next(r)
            for _ in range(len(ring)):
                if nxt not in retired and self._is_live_member(nxt):
                    break
                nxt = self.world.ring_next(nxt)
            if nxt not in retired and nxt != r:
                route[r] = nxt
        return route

    def _member_pick_home(self) -> int:
        """Least-loaded live server by homed-rank count — scale-out
        shards participate, which IS the TargetedDirectory rebalance:
        new ranks (and their targeted traffic) land on new capacity."""
        cands = [
            s for s in self.world.server_ranks
            if s not in self._dead_servers
            and s not in self._draining_servers
            and self._is_live_member(s)
        ]
        return min(cands, key=lambda s: (len(self.world.local_apps(s)), s))

    def _member_refuse(self, to: int, error: str, rc: int = -1) -> None:
        try:
            self.ep.send(
                to, msg(Tag.TA_MEMBER_RESP, self.rank, rc=rc, error=error),
                connect_grace=1.0,
            )
        except OSError:
            pass

    def _member_detach_req(self, m: Msg) -> None:
        rank = m.src
        if not self.is_master:
            self._member_refuse(rank, "detach goes to the master server")
            return
        if not self.world.is_app(rank):
            # idempotent: a re-sent detach after the first applied
            ok = rank in self.world.detached
            self._member_refuse(
                rank, "not a member", rc=ADLB_SUCCESS if ok else -1
            )
            return
        if self._member_terminating():
            # termination already counts the rank out as it finalizes;
            # refuse with the termination rc so the client falls back to
            # a plain finalize
            self._member_refuse(
                rank, "world terminating", rc=ADLB_NO_MORE_WORK
            )
            return
        epoch = self.world.epoch + 1
        self._member_barrier(
            dict(mop="detach", rank=rank, epoch=epoch),
            to=rank,
            resp=dict(rc=ADLB_SUCCESS, rank=rank, epoch=epoch),
        )

    def _member_barrier(self, fields: dict, to: int, resp: dict) -> None:
        """Apply a membership op locally, fan it to every live server,
        and hold the joiner's reply until all acks land (or the barrier
        deadline passes — the op is idempotent and applied everywhere
        responsive). The END ring defers while a barrier is open, so
        the epoch a token carries is never ahead of a voter."""
        self._member_tok += 1
        tok = self._member_tok
        need = set()
        for s in self._live_servers():
            if not self._is_live_member(s):
                continue
            try:
                self.ep.send(
                    s, msg(Tag.SS_MEMBER, self.rank, member_tok=tok,
                           **fields)
                )
                need.add(s)
            except OSError:
                self._note_server_unreachable(s)
        self._apply_member(dict(fields))
        p = {
            "need": need,
            "to": to,
            "resp": resp,
            "deadline": time.monotonic() + 5.0,
            "fields": fields,
        }
        if need:
            self._member_pending[tok] = p
        else:
            self._member_reply(p)

    def _member_reply(self, p: dict) -> None:
        resp = dict(p["resp"])
        if resp.get("member", "x") is None:
            # snapshot at REPLY time: attaches that completed while this
            # barrier was open are included
            resp["member"] = self.world.snapshot()
        try:
            self.ep.send(
                p["to"], msg(Tag.TA_MEMBER_RESP, self.rank, **resp),
                connect_grace=2.0,
            )
        except OSError:
            self.flight.record(
                f"member reply to {p['to']} undeliverable"
            )
        # a deferred END ring can proceed now
        self._maybe_complete_finalize()

    def _on_ss_member(self, m: Msg) -> None:
        mop = self._mstr(m.data.get("mop") or "")
        if mop == "ack":
            p = self._member_pending.get(m.data.get("member_tok"))
            if p is None:
                return
            p["need"].discard(m.src)
            if not p["need"]:
                del self._member_pending[m.data["member_tok"]]
                self._member_reply(p)
            return
        if mop == "ready":
            self._member_on_ready(m.src)
            return
        if mop == "rebalance":
            self._member_rebalance(int(m.data["dest"]))
            return
        if mop == "drain_done":
            rank = int(m.data["rank"])
            self._draining_servers.discard(rank)
            self._clean_retire.add(rank)
            # per-pair FIFO: every SS_REPL frame of the drain's final
            # flush was handled before this frame — the mirror here (if
            # we are the buddy) is COMPLETE, no EOF wait needed
            self._server_tail_drained.add(rank)
            self._on_server_dead(
                msg(Tag.SS_SERVER_DEAD, m.src, rank=rank,
                    epoch=int(m.data.get("epoch", 0) or 0), clean=1)
            )
            return
        if mop == "sync":
            self.world.seed(m.data.get("member") or {})
            for r, a in (m.data.get("addrs") or {}).items():
                if hasattr(self.ep, "addr_map"):
                    self.ep.addr_map.setdefault(int(r), tuple(a))
            for jid, code, quota, name in m.data.get("jobs") or ():
                # close the spawn-window gap: a job submitted / drained
                # / killed between this shard's FA_MEMBER seed and its
                # "ready" fan-out membership never reached it
                self.jobs.restore(jid, code, quota, name)
            self._g_epoch.set(self.world.epoch)
            return
        self._apply_member(dict(m.data))
        tok = m.data.get("member_tok")
        if tok:
            try:
                self.ep.send(
                    m.src, msg(Tag.SS_MEMBER, self.rank, mop="ack",
                               member_tok=tok)
                )
            except OSError:
                pass

    def _apply_member(self, d: dict) -> None:
        mop = self._mstr(d.get("mop") or "")
        epoch = int(d.get("epoch", 0) or 0)
        rank = int(d.get("rank", -1))
        host = d.get("host")
        if host is not None and hasattr(self.ep, "addr_map"):
            self.ep.addr_map.setdefault(
                rank, (self._mstr(host), int(d.get("port", 0)))
            )
        if mop == "attach":
            home = int(d["home"])
            self.world.add_app(rank, home, epoch)
            if home == self.rank:
                self.local_apps.add(rank)
                self._m_attached.inc()  # once fleet-wide: home counts
            self.flight.record(
                f"member_attach rank={rank} home={home} epoch={epoch}"
            )
        elif mop == "detach":
            self._apply_detach(rank, epoch)
        elif mop == "server_join":
            self.world.add_server(rank, epoch)
            self.peers.setdefault(rank, _PeerState())
            if self.is_master:
                self._m_servers_joined.inc()
            self.flight.record(
                f"member_server_join rank={rank} epoch={epoch}"
            )
        elif mop == "server_live":
            self._member_live.add(rank)
            self.world.note_epoch(epoch)
            # ring membership changed: if the live walk now puts the new
            # shard right after us, re-target the replication stream at
            # it (full-state bootstrap — its mirror starts empty)
            if self.cfg.on_server_failure == "failover":
                if not self._failover and self.world.nservers > 1:
                    self._failover = True
                nxt = self._ring_next_live()
                if (
                    self._failover
                    and nxt != self.rank
                    and (self.repl is None or self.repl.buddy != nxt)
                ):
                    self._rebootstrap_repl(nxt)
            self.flight.record(
                f"member_server_live rank={rank} epoch={epoch}"
            )
        elif mop == "server_drain":
            self._draining_servers.add(rank)
            self.world.note_epoch(epoch)
            self.flight.record(
                f"member_server_drain rank={rank} epoch={epoch}"
            )
            if rank == self.rank:
                self._begin_drain()
        # every membership change is activity: an in-flight exhaustion
        # vote must not conclude across it (the epoch stamp catches the
        # ring; this catches the master's own held vote)
        self.activity += 1
        self._exhaust_held_since = None
        self._g_epoch.set(self.world.epoch)
        # master: the deputy's brain mirror tracks every membership
        # mutation (epoch, watermark, homes, live/drained sets)
        self._repl_brain()

    def _apply_detach(self, rank: int, epoch: int) -> None:
        """A clean lease-draining rank-dead: the rank leaves membership
        and termination counting WITHOUT the death bookkeeping (no
        rank_dead count, no attempt bumps, no quarantine pressure).
        Journeys its departure touches carry a ``drain`` hop, so churn
        is visible in /trace/tails."""
        if rank in self.world.detached:
            return
        was_local = rank in self.local_apps
        self.world.remove_app(rank, epoch)
        if was_local:
            self._m_detached.inc()  # once fleet-wide: home counts
        # parked/steal state — same sweep as the death path
        self.rq.remove_rank(rank)
        self._stream_idle.discard(rank)
        self._swept_streams.discard(rank)
        self._rfr_out.pop(rank, None)
        self._rfr_excluded.pop(rank, None)
        self._park_res_local.pop(rank, None)
        self._seen_rqseqnos.pop(rank, None)
        self._last_heard.pop(rank, None)
        self._rank_job.pop(rank, None)
        # leases: drain cleanly — unpin and re-enqueue WITHOUT an
        # attempt bump (leaving is not a delivery failure)
        reclaimed = 0
        for lease in self.leases.owned_by(rank):
            self.leases.release(lease.seqno)
            unit = self.wq.get(lease.seqno)
            if unit is None or not unit.pinned or unit.pin_rank != rank:
                continue
            if self._relay_inflight.get(lease.seqno) == rank:
                # fused relay in flight: the payload may already be at
                # the leaver — at-most-once wins (delivered-at-detach)
                self._relay_inflight.pop(lease.seqno, None)
                self.journeys.forget(unit)
                self._consume(unit)
                continue
            if self._hedge_member_unpin(unit):
                # a hedge sibling still races: the leaver's copy retires
                reclaimed += 1
                continue
            self.wq.unpin(lease.seqno)
            if self.wlog is not None:
                self.wlog.log_unpin(lease.seqno)
            if unit.spans is not None:
                self.journeys.stamp(unit, "drain")
            if unit.common_seqno >= 0:
                self._forfeit_common(
                    unit.common_seqno, unit.common_server_rank,
                    op="credit",
                )
            reclaimed += 1
        if reclaimed:
            self._m_leases_reclaimed.inc(reclaimed)
        # targeted units for the leaver can never be fetched: drop them
        # (refcount-correct), closing their journeys through the drain
        doomed = [u for u in self.wq.units() if u.target_rank == rank]
        for u in doomed:
            self.wq.remove(u.seqno)
            self.leases.release(u.seqno)
            self._spill_drop(u)
            self.mem.free(len(u.payload))
            if u.spans is not None:
                self.journeys.stamp(u, "drain")
                self.journeys.close(u, "dropped")
            if self.wlog is not None:
                self.wlog.log_remove(u.seqno)
            self._forfeit_common(u.common_seqno, u.common_server_rank)
        self.tq.drop_rank(rank)
        if was_local:
            self.local_apps.discard(rank)
            self._finalized.discard(rank)
        if self.is_master and self.cfg.balancer == "tpu":
            self._patch_snapshots_for_dead(rank)
        if reclaimed:
            self._match_rq()
        self.flight.record(
            f"member_detach rank={rank} epoch={epoch} "
            f"reclaimed={reclaimed} targeted_dropped={len(doomed)}"
        )
        # the leaver no longer gates END: its home may be complete now
        self._maybe_complete_finalize()

    def _member_on_ready(self, new: int) -> None:
        """Master: a scale-out shard's reactor is up. Publish it live
        (everyone adds it to rings/buddy walks), sync it to the freshest
        membership, and direct a donor rebalance at it."""
        if not self.is_master or new in self._member_ready:
            return
        self._member_ready.add(new)
        self._member_live.add(new)
        epoch = self.world.epoch + 1
        self.world.note_epoch(epoch)
        # fresh membership + learned addresses for the late arrival —
        # and the job table AGAIN: it was seeded at FA_MEMBER time, and
        # any /jobs submit/drain/kill during the spawn window fanned out
        # to _live_servers(), which excluded the not-yet-ready shard
        try:
            self.ep.send(
                new, msg(Tag.SS_MEMBER, self.rank, mop="sync",
                         member=self.world.snapshot(),
                         addrs=dict(self._member_addrs),
                         jobs=self._member_jobs_seed()),
            )
        except OSError:
            self._note_server_unreachable(new)
            return
        for s in self._live_servers():
            try:
                self.ep.send(
                    s, msg(Tag.SS_MEMBER, self.rank, mop="server_live",
                           rank=new, epoch=epoch),
                )
            except OSError:
                pass
        self._apply_member(dict(mop="server_live", rank=new, epoch=epoch))
        # donor: the most loaded live shard sheds backlog to the new one
        cands = [
            s for s in self.world.server_ranks
            if s != new and s not in self._dead_servers
            and s not in self._draining_servers and self._is_live_member(s)
        ]
        def load(s):
            if s == self.rank:
                return self.mem.curr
            p = self.peers.get(s)
            return p.nbytes if p is not None else 0
        donor = max(cands, key=load) if cands else self.rank
        if self._scaleout_t0 is not None:
            mttr = (time.monotonic() - self._scaleout_t0) * 1e3
            self._g_scaleout_mttr.set(mttr)
            self._scaleout_t0 = None
            self.flight.record(
                f"scaleout_ready rank={new} donor={donor} "
                f"mttr_ms={mttr:.1f}"
            )
        if donor == self.rank:
            self._member_rebalance(new)
        else:
            try:
                self.ep.send(
                    donor, msg(Tag.SS_MEMBER, self.rank, mop="rebalance",
                               dest=new),
                )
            except OSError:
                self._note_server_unreachable(donor)

    def _member_rebalance(self, dest: int) -> None:
        """Donor side of scale-out bootstrap: ship a fair share of the
        unpinned untargeted backlog to the new shard over the ACKED
        migration plane (serialized-unit wire format; a dest death
        mid-transit hands the units back via _migrate_pending), so
        every put acked before the scale-out stays fetchable after it.
        Shipped journeys gain an ``attach`` hop — scale-out churn is
        visible in /trace/tails."""
        if dest in self._dead_servers or self.done:
            return
        pool = [
            u for u in self.wq.units()
            if not u.pinned and u.target_rank < 0 and u.job == 0
        ]
        n_live = max(
            len([
                s for s in self.world.server_ranks
                if s not in self._dead_servers and self._is_live_member(s)
            ]),
            2,
        )
        take = len(pool) // n_live
        if take <= 0:
            return
        pool.sort(key=lambda u: u.time_stamp)  # coldest first
        units = []
        for unit in pool[:take]:
            self._unspill(unit)
            self.wq.remove(unit.seqno)
            self.mem.free(len(unit.payload))
            if self.wlog is not None:
                self.wlog.log_remove(unit.seqno)
            if unit.spans is not None:
                self.journeys.stamp(unit, "attach")
            shipped = {
                "payload": unit.payload,
                "work_type": unit.work_type,
                "prio": unit.prio,
                "answer_rank": unit.answer_rank,
                "home_server": unit.home_server,
                "common_len": unit.common_len,
                "common_server": unit.common_server_rank,
                "common_seqno": unit.common_seqno,
                "time_stamp": unit.time_stamp,
                "attempts": unit.attempts,
            }
            if getattr(unit, "job", 0):
                # namespace rides the move (omitted = job 0, so
                # single-job batches stay byte-identical on the wire)
                shipped["job"] = unit.job
            tf = trace_fields(unit)
            if tf is not None:
                shipped["trace"] = tf
                self.journeys.forget(unit)
            units.append(shipped)
        self.activity += 1
        self._exhaust_held_since = None
        self.flight.record(
            f"scaleout_rebalance dest={dest} shipped={len(units)} "
            f"of={len(pool)}"
        )
        self._send_migrate_batch(dest, units, bounced=False)

    def _begin_drain(self) -> None:
        """This server is being scaled IN. Two phases: mark draining —
        from here no NEW custody is accepted (push queries refuse,
        peers' target pickers skip us) — then, once the custody already
        accepted settles (in-flight SS_PUSH_WORK payloads land),
        :meth:`_maybe_finish_drain` flushes a FULL-state replication
        bootstrap to the buddy, announces drain_done behind the stream
        tail, and exits. The buddy promotes a complete mirror — zero
        counted losses by construction."""
        if self._draining_self or self.done:
            return
        from adlb_tpu_torch.runtime import replica

        buddy = replica.buddy_of(
            self.world, self.rank, self._buddy_excluded()
        )
        if buddy == self.rank:
            self.flight.record("drain refused: no live buddy")
            return
        self._draining_self = True
        # bounded: a pusher that died between QUERY_RESP and WORK would
        # otherwise park this drain on a reservation that never lands
        self._drain_deadline = time.monotonic() + 5.0
        self._maybe_finish_drain()

    def _maybe_finish_drain(self) -> None:
        if not self._draining_self or self.done:
            return
        if self._push_reserved and time.monotonic() < self._drain_deadline:
            return  # accepted pushes still in flight toward us
        from adlb_tpu_torch.runtime import replica

        buddy = replica.buddy_of(
            self.world, self.rank, self._buddy_excluded()
        )
        if self.spill is not None:
            self._spill_fault_in_all()
        for u in self.wq.units():
            if u.spans is not None:
                self.journeys.stamp(u, "drain")
        self._failover = True  # the promote plane is the drain plane
        self._rebootstrap_repl(buddy)
        self._flush_repl()
        note_epoch = self.world.epoch + 1
        for s in self._live_servers():
            try:
                self.ep.send(
                    s, msg(Tag.SS_MEMBER, self.rank, mop="drain_done",
                           rank=self.rank, epoch=note_epoch),
                )
            except OSError:
                pass
        self.flight.record(f"drained to buddy {buddy}; exiting")
        self._drained_exit = True
        self.done = True

    def _maybe_autoscale(self, now: float) -> None:
        """Master, Config(elastic_scaleout='auto'): when any live server
        crosses the soft memory watermark, add a shard BEFORE the spill
        tier or backpressure engage."""
        if (
            self._scaleout_t0 is not None
            or self._scale_pending is not None
            or self._member_terminating()
            or now < self._elastic_cooldown_until
        ):
            return
        soft = self.cfg.max_malloc_per_server * self.cfg.mem_soft_frac
        hot = self.rank if self.mem.curr >= soft else None
        if hot is None:
            for s, p in self.peers.items():
                if (
                    s != self.rank
                    and s not in self._dead_servers
                    and p.nbytes >= soft
                ):
                    hot = s
                    break
        if hot is None:
            return
        self._elastic_cooldown_until = now + self.cfg.elastic_cooldown_s
        self._request_scale_out("mem_watermark", hot_rank=hot)

    @property
    def member_spawner(self):
        """Harness hook: callable(alloc) that spawns a new server shard
        (in-proc thread, subprocess, k8s pod — the harness's business)."""
        return self._member_spawner

    @member_spawner.setter
    def member_spawner(self, fn) -> None:
        self._member_spawner = fn
        if fn is None:
            return
        # Drain the parked scale request on registration: a
        # watermark/controller scale-out that arrived spawnerless parks
        # in the single _scale_pending slot (dedup-collapsed — each new
        # request overwrites, newest wins). A late-registering spawner
        # must service it now, not leave it to rot at /fleet until the
        # next trigger re-fires.
        pending = getattr(self, "_scale_pending", None)
        if pending is None:
            return
        if self._scaleout_t0 is not None or self._member_terminating():
            return
        self._scale_pending = None
        if self.is_master and self._failover and self.repl is not None:
            self.repl.log_scale(None)  # the clearing replicates too
        self.flight.record(
            f"scale_pending_drained reason={pending.get('reason')}"
        )
        self._request_scale_out(
            str(pending.get("reason") or "pending"),
            hot_rank=pending.get("hot_rank"),
        )

    def _request_scale_out(self, reason: str,
                           hot_rank: Optional[int] = None) -> dict:
        self.flight.record(
            f"scale_out_requested reason={reason} hot={hot_rank}"
        )
        if self.member_spawner is None:
            # no spawner registered: park the request, visible at /fleet
            # (the future autoscaler's feed)
            self._scale_pending = {
                "reason": reason, "hot_rank": hot_rank,
                "at": time.time(),
            }
            if self.is_master and self._failover and self.repl is not None:
                # a parked request is brain state: the deputy's /fleet
                # must show it (and its spawner must drain it) after a
                # takeover
                self.repl.log_scale(dict(self._scale_pending))
            return {"requested": False, "pending": True}
        self._scaleout_t0 = time.monotonic()
        try:
            self.member_spawner({"kind": "server", "reason": reason})
        except Exception as e:  # noqa: BLE001 — a broken spawner must
            # not crash the reactor
            self._scaleout_t0 = None
            self._scale_pending = {
                "reason": reason, "error": repr(e), "at": time.time(),
            }
            if self.is_master and self._failover and self.repl is not None:
                self.repl.log_scale(dict(self._scale_pending))
            return {"requested": False, "pending": True,
                    "error": repr(e)}
        return {"requested": True}

    def fleet_doc(self) -> dict:
        """GET /fleet: the live topology + per-rank epoch/state view
        (read by the ops HTTP thread — copies, no mutation). Membership
        containers are snapshotted with the registry's retry discipline
        first: the reactor inserts into extra_apps/detached during an
        attach, and iterating them live would raise RuntimeError exactly
        when /fleet matters most — mid-churn."""
        w = self.world

        def stable(container, ctor):
            for _ in range(8):
                try:
                    return ctor(container)
                except RuntimeError:
                    continue
            return ctor(())

        extra_apps = stable(w.extra_apps, dict)
        detached = stable(w.detached, set)
        servers = []
        for s in list(w.server_ranks):
            if s in self._drained_servers:
                state = "drained"
            elif s in self._dead_servers:
                state = "dead"
            elif s in self._draining_servers:
                state = "draining"
            elif self._is_live_member(s):
                state = "live"
            else:
                state = "joining"
            servers.append({
                "rank": s,
                "state": state,
                "master": s == w.master_server_rank,
                "extra": s not in w.spec.server_ranks,
            })
        apps = []
        ranks = [r for r in w.spec.app_ranks if r not in detached]
        ranks += [r for r in extra_apps if r not in detached]
        for r in ranks:
            if r in extra_apps:
                home = extra_apps[r]
            else:
                home = w.home_server(r)
            if r in self._dead_ranks:
                state = "dead"
            elif r in self._finalized:
                state = "finalized"
            else:
                state = "live"
            apps.append({
                "rank": r,
                "home": home,
                "state": state,
                "attached": r >= w.spec.num_app_ranks,
            })
        return {
            "epoch": w.epoch,
            "master": w.master_server_rank,
            "nservers_live": sum(
                1 for s in servers if s["state"] == "live"
            ),
            "servers": servers,
            "apps": apps,
            "detached": sorted(detached),
            "scale_pending": self._scale_pending,
        }

    # ------------------------------------------------- worker-death reclaim
    # No reference analogue (upstream: any rank failure kills the job,
    # src/adlb.c:2508-2526). Under Config(on_worker_failure="reclaim") an
    # app rank's death is absorbed: its home server fans out SS_RANK_DEAD
    # and every server (a) re-enqueues the rank's leased-but-unfetched
    # units, (b) drops its rq/steal state and targeted work (with a
    # refcount-correct batch-common release), (c) excludes it from
    # termination counting, and (d) — master — patches the balancer's
    # requester snapshots so the dead rank stops attracting matches and
    # migrations. Server death still aborts under both policies.

    def _declare_rank_dead(self, rank: int) -> None:
        """Home server: fan out the death and reclaim locally."""
        if rank in self._dead_ranks:
            return
        for srv in self._live_servers():
            try:
                self.ep.send(srv, msg(Tag.SS_RANK_DEAD, self.rank, rank=rank))
            except OSError:
                pass  # peer already ended: no state left to clean there
        self._on_rank_dead(msg(Tag.SS_RANK_DEAD, self.rank, rank=rank))

    def _on_rank_dead(self, m: Msg) -> None:
        rank = m.rank
        if rank in self._dead_ranks:
            return
        self._dead_ranks.add(rank)
        self._m_rank_dead.inc()
        if self.wlog is not None:
            self.wlog.log_rank_dead(rank)
        self.flight.record(f"rank_dead rank={rank} declared_by={m.src}")
        # 1) the dead requester's park/steal state (every entry — a
        # streaming rank may hold several prefetch slots). Flag the rank
        # unconditionally: if it was streaming, ANY of its in-flight
        # slots may now be phantom — including ones whose entries were
        # already matched but whose responses died with the connection
        # (remove_rank returns [] then) — and a resurrected stream's
        # next idle note re-arms them (see _on_stream_idle). For a
        # non-streaming rank the flag is inert (it never sends idle).
        self.rq.remove_rank(rank)
        self._swept_streams.add(rank)
        # reset the request-id window: the swept-stream re-arm reads
        # "claimed id not in the window" as "request or response died
        # with the connection" — ids must only accumulate again from
        # post-death (post-resurrection) traffic
        self._seen_rqseqnos.pop(rank, None)
        self._stream_idle.discard(rank)
        self._rfr_out.pop(rank, None)
        self._rfr_excluded.pop(rank, None)
        self._park_res_local.pop(rank, None)
        # 2) reclaim leases: pinned-but-unfetched units return to the queue
        reclaimed = 0
        for lease in self.leases.owned_by(rank):
            self.leases.release(lease.seqno)
            unit = self.wq.get(lease.seqno)
            if unit is not None and unit.pinned and unit.pin_rank == rank:
                if self._relay_inflight.get(lease.seqno) == rank:
                    # remote fused fetch in flight to the dead rank: the
                    # payload may already have LANDED there (the home
                    # forwards before confirming), so re-enqueueing could
                    # run the unit twice if the EOF was churn and the
                    # rank resurrects. At-most-once delivery wins: treat
                    # it as delivered-at-death and drop it — the same
                    # outcome as a unit fetched via GET_RESERVED just
                    # before the owner died. NO common forfeit here: the
                    # dead client may already have accounted its prefix
                    # share (it fetches at decode time, before death was
                    # observed), and an over-forfeit would GC the prefix
                    # under a live member — the bounded-leak direction
                    # (prefix outlives the batch if the client never
                    # accounted) is the acceptable one, as everywhere
                    # else in the common accounting.
                    self._relay_inflight.pop(lease.seqno, None)
                    # the home server (if the payload landed) closed the
                    # relayed journey; our copy just releases
                    self.journeys.forget(unit)
                    self._consume(unit)
                    self.flight.record(
                        f"relay_consumed_on_death seqno={lease.seqno} "
                        f"rank={rank}"
                    )
                    continue
                if self._hedge_member_unpin(unit):
                    # a hedge sibling still races for this logical put:
                    # the dead owner's copy retires instead of becoming
                    # a second live duplicate in open matching
                    reclaimed += 1
                    continue
                self.wq.unpin(lease.seqno)
                if self.wlog is not None:
                    self.wlog.log_unpin(lease.seqno)
                # retry budget: a unit that serially kills its owners
                # (poison) must not re-enqueue forever
                quarantined = self._bump_attempts(unit, in_wq=True)
                if unit.common_seqno >= 0 and not quarantined:
                    # the dead owner may have fetched the batch-common
                    # prefix already; the re-consumption will fetch it
                    # again, so grant the prefix one extra expected get.
                    # On quarantine, NO op (as in _expire_lease): a
                    # credit expects a re-consumption that never comes,
                    # a forfeit could over-count a fetch the dead owner
                    # already accounted and GC the prefix under a live
                    # member
                    self._forfeit_common(
                        unit.common_seqno, unit.common_server_rank,
                        op="credit",
                    )
                reclaimed += 1
                self.flight.record(
                    f"lease_reclaimed seqno={lease.seqno} "
                    f"lease_id={lease.lease_id} rank={rank}"
                )
        if reclaimed:
            self._m_leases_reclaimed.inc(reclaimed)
            # reclaim is activity: an in-flight exhaustion vote must not
            # conclude around work that just became available again
            self.activity += 1
            self._exhaust_held_since = None
        # 3) drop units targeted at the dead rank (nobody else may take
        # them), releasing their batch-common refcounts
        doomed = [u for u in self.wq.units() if u.target_rank == rank]
        for u in doomed:
            self.wq.remove(u.seqno)
            self.leases.release(u.seqno)
            self._spill_drop(u)
            self.mem.free(len(u.payload))
            if u.spans is not None:
                self.journeys.close(u, "dropped")
            if self.wlog is not None:
                self.wlog.log_remove(u.seqno)
            self._m_targeted_dropped.inc()
            self._forfeit_common(u.common_seqno, u.common_server_rank)
            self.flight.record(
                f"targeted_dropped rank={rank} seqno={u.seqno}"
            )
        self.tq.drop_rank(rank)
        # 4) termination counting: the rank will never send LOCAL_APP_DONE
        if rank in self.local_apps:
            self._finalized.add(rank)
            self._maybe_complete_finalize()
        # 5) balancer view (master, tpu mode): retire the dead requester
        # from every held snapshot so plans stop targeting it
        if self.is_master and self.cfg.balancer == "tpu":
            self._patch_snapshots_for_dead(rank)
        # reclaimed inventory may satisfy surviving parked requesters
        if reclaimed:
            self._match_rq()
        # a survived death still leaves a post-mortem artifact (when a
        # flight dir is configured): the world lives on, but the operator
        # needs the who-died/what-was-reclaimed timeline
        # (scripts/obs_report.py merges these across ranks)
        self.flight.dump_json(f"rank_dead_{rank}")

    def _patch_snapshots_for_dead(self, rank: int) -> None:
        for src, snap in self._snapshots.items():
            reqs = snap.get("reqs") or []
            kept = [r for r in reqs if r[0] != rank]
            if len(kept) != len(reqs):
                snap["reqs"] = kept
                # no stamp bump (it would re-eligibilize the ledger);
                # the sequence carries the in-place patch to the
                # sharded solver's unchanged-server fast path
                snap["req_seq"] = snap.get("req_seq", 0) + 1
                self._snapshots.bump(src)  # in-place patch: version it
                self._req_sigs[src] = tuple(
                    sorted((r[0], r[1]) for r in kept)
                )
                self._broadcast_hungry(
                    self._hungry_tracker.update(src, kept)
                )
        if self._balancer is not None:
            self._balancer.wake.set()

    def _forfeit_common(self, common_seqno, common_server,
                        op: str = "forfeit") -> None:
        """Fix up a batch-common refcount for a reclaimed member unit:
        ``forfeit`` accounts a get that will never happen (unit dropped),
        ``credit`` expects one extra get (unit re-enqueued; its dead
        owner may already have fetched the prefix). Local when this
        server stores the prefix, else via SS_COMMON_FORFEIT."""
        if common_seqno is None or common_seqno < 0:
            return
        if common_server is None or common_server == self.rank:
            self._apply_common_op(common_seqno, op)
        else:
            self._send_srv(
                common_server,
                msg(Tag.SS_COMMON_FORFEIT, self.rank,
                    common_seqno=common_seqno, op=op),
            )

    def _apply_common_op(self, common_seqno: int, op: str,
                         src: int = -1, op_id: int = -1) -> None:
        if self.wlog is not None:
            self.wlog.log_common_op(
                common_seqno, "credit" if op == "credit" else "forfeit",
                src, op_id,
            )
        if op == "credit":
            self.cq.credit(common_seqno)
        else:
            self.cq.forfeit(common_seqno)

    def _on_common_forfeit(self, m: Msg) -> None:
        fo = m.data.get("fo_from")
        if fo is not None:
            new = self._adopted_common_for(fo, m.common_seqno)
            if new is None:
                return  # prefix did not survive the takeover
            m.data["common_seqno"] = new
        fid = m.data.get("get_id")
        if fid is not None:
            # client cache-hit accounting notes carry an id: a note
            # re-sent across connection churn must not be applied twice
            # (an over-forfeit would GC the prefix one get early, under
            # a live member). A windowed seen-set like the reserve
            # dedup — a re-send on a new connection can be processed
            # before an older note still queued from the old one, so a
            # last-id equality check is not enough. Server-to-server
            # fixups carry no id.
            if self._window_seen(self._seen_forfeits, m.src, fid):
                return
        op = m.data.get("op", "forfeit")
        if isinstance(op, bytes):  # binary-codec peers carry it as bytes
            op = op.decode()
        self._apply_common_op(m.common_seqno, op, m.src,
                              fid if fid is not None else -1)

    def _resurrect(self, rank: int) -> None:
        """A rank we declared dead is talking again: the EOF was network
        churn. Its reclaimed state stays reclaimed (at-most-once for its
        old leases/targeted units), but the rank itself rejoins the
        world's accounting and is served again."""
        self._dead_ranks.discard(rank)
        self._resurrected.add(rank)
        self._m_reconnects.inc()
        self.flight.record(f"reconnect rank={rank} (was declared dead)")
        if rank in self.local_apps:
            self._finalized.discard(rank)

    # ------------------------------------------------- server failover
    # Config(on_server_failure="failover"); no reference analogue — the
    # reference's servers ARE the pool and any server death kills the job
    # (SURVEY §5). Every server streams a replication log of its pool
    # mutations to its ring-successor buddy (adlb_tpu_torch/runtime/replica.py,
    # SS_REPL frames reusing the checkpoint.py unit wire format) and
    # passively mirrors its ring predecessor. On a server's EOF the first
    # observer fans out SS_SERVER_DEAD; every survivor prunes the dead
    # server from rings/gossip/plans and reroutes through its buddy; the
    # buddy replays the mirror into its own queues — pinned units stay
    # pinned under their leases behind a seqno translation, unpinned
    # units re-enqueue — adopts the dead server's app ranks, and remaps
    # clients via epoch-stamped TA_HOME_TAKEOVER.

    def _live_servers(self) -> list:
        return [
            s for s in self.world.server_ranks
            if s != self.rank and s not in self._dead_servers
            and self._is_live_member(s)
        ]

    def _ring_next_live(self) -> int:
        nxt = self.world.ring_next(self.rank)
        while nxt != self.rank and (
            nxt in self._dead_servers or not self._is_live_member(nxt)
        ):
            nxt = self.world.ring_next(nxt)
        return nxt

    def _ring_forward(self, make_msg) -> None:
        """Forward a ring token to the next live successor; a peer that
        turns out unreachable is noted (death evidence under failover)
        and the recomputed successor tried instead. When this server is
        the only live one the token self-delivers — exactly the
        single-server ring shape the termination protocols already
        handle."""
        for _ in range(self.world.nservers):
            nxt = self._ring_next_live()
            try:
                self.ep.send(nxt, make_msg(nxt), **self._srv_grace())
                return
            except OSError:
                if not self._failover or nxt == self.rank:
                    raise
                self._note_server_unreachable(nxt)

    def _send_srv(self, dest: int, m: Msg):
        """Server->server send that survives failover: a dead destination
        reroutes to its buddy — stamped ``fo_from`` so content-addressed
        seqnos translate through the takeover maps — and an unreachable
        one becomes death evidence instead of a reactor crash. Returns
        the rank actually sent to, or None when the send was absorbed."""
        routed = dest
        seen = set()
        while routed in self._dead_servers:
            nxt = self._srv_route.get(routed)
            if nxt is None or nxt in seen:
                return None
            seen.add(nxt)
            routed = nxt
        if routed != dest:
            m.data.setdefault("fo_from", dest)
        try:
            self.ep.send(routed, m, **self._srv_grace())
            return routed
        except OSError:
            if not self._failover:
                raise
            self.flight.record(
                f"send to server {routed} failed ({m.tag.name})"
            )
            self._note_server_unreachable(routed)
            return None

    def _srv_grace(self) -> dict:
        """Send options of a server-bound send that survives failover: the
        short ``UP_PEER_GRACE`` (a refusal means the peer died, and the
        15 s start-up grace would stall this reactor; a server whose
        first snapshot to the master came after the master died waited
        it out)."""
        return {"connect_grace": UP_PEER_GRACE} if self._failover else {}

    def _note_server_unreachable(self, srv: int) -> None:
        """A send to a supposedly-live server failed: treat it as death
        evidence (the EOF may simply not have reached us yet)."""
        if self.world.is_server(srv) and not self._is_live_member(srv):
            # a joined-but-never-live scale-out shard: its absence must
            # not abort the world it never served
            self.flight.record(f"joining server {srv} unreachable")
            return
        plan = getattr(self.ep, "plan", None)
        if plan is not None and getattr(plan, "disconnected", False):
            # OUR endpoint is the dead one (fault-injected server death):
            # every send fails, and blaming the peers would abort the
            # world this policy exists to save — die quietly instead
            # (_run_loop classifies the casualty)
            raise OSError(
                f"server {self.rank}: own connectivity lost"
            )
        if (
            srv in self._dead_servers
            or not self.world.is_server(srv)
            or srv == self.rank
            or self.done
        ):
            return
        self._server_eof_at.setdefault(srv, time.monotonic())
        if self._failover and self._can_failover(srv):
            self._declare_server_dead(srv)
        else:
            self._do_abort(-3, broadcast=True)

    # -- replication (primary side) -----------------------------------------

    def _on_common_gc(self, e) -> None:
        self.mem.free(len(e.buf))
        if self.wlog is not None:
            self.wlog.log_common_op(e.seqno, "gc")

    def _flush_repl(self) -> None:
        r = self.repl
        if r is None:
            return
        self._g_repl_lag.set(r.pending)
        blob = r.take()
        if blob is None:
            return
        try:
            self.ep.send(
                r.buddy, msg(Tag.SS_REPL, self.rank, blob=blob, seq=r.seq)
            )
        except OSError:
            self.flight.record("replication flush failed (buddy gone?)")
            self._note_server_unreachable(r.buddy)

    def _brain_doc(self) -> dict:
        """The master-only durable control-plane state, as one pickled
        snapshot for the deputy's mirror (OP_MEMBER, newest wins). Soft
        state — merged obs registry, p99 thresholds, alert lifecycle,
        profiler stacks — is deliberately NOT here: gossip snapshots are
        cumulative, so the fleet view reconstructs at the new master
        within one sync interval."""
        return {
            "master": self.rank,
            "epoch": self.world.epoch,
            "next_rank": self._member_next_rank,
            "member": self.world.snapshot(),
            "addrs": dict(self._member_addrs),
            "live": sorted(self._member_live),
            "ready": sorted(self._member_ready),
            "dead": sorted(self._dead_servers),
            "drained": sorted(self._drained_servers),
            "srv_route": self._member_srv_route(),
            "job_next_id": self._job_next_id,
            # whether this world is observed: the deputy has ops_port
            # stripped from its own cfg (scale-out shards) or may share
            # the port in-proc — promotion rebinds ephemeral when armed
            "ops_armed": self.cfg.ops_port is not None or (
                self.ops is not None
            ),
        }

    def _repl_brain(self) -> None:
        """Master: stream the brain snapshot to the deputy. Called on
        every membership/route mutation; a non-master (or unconfigured)
        world never emits these, keeping frame identity."""
        if self.is_master and self._failover and self.repl is not None:
            self.repl.log_member(self._brain_doc())

    def _rebootstrap_repl(self, new_buddy: int) -> None:
        """Our buddy died: re-target the replication stream at the next
        live successor, seeding it with a full-state bootstrap (the
        mirror there starts empty)."""
        from adlb_tpu_torch.runtime import replica

        if new_buddy == self.rank:
            self.repl = None  # no live peer left to replicate to
            self._refresh_wlog()
            return
        r = replica.ReplicationLog(new_buddy)
        for u in self.wq.units():
            r.log_put(u, -1, None)  # carries the pin state
        for e in self.cq.entries():
            r.log_common_put(e.seqno, e.buf)
            r.log_common_state(e.seqno, e.refcnt, e.ngets, e.credits)
        for rank in self._finalized:
            r.log_app_done(rank)
        for rank in self._dead_ranks:
            r.log_rank_dead(rank)
        # gray-failure state: fences and the dead-letter store must
        # survive this server's own later death, or a takeover would
        # un-fence stalled owners and silently drop the quarantine count
        for seqno, owner in self._fences:
            r.log_fence(seqno, owner)
        for origin, seqno, owner in self._adopted_fences:
            # fences adopted from predecessors keep their origin — a
            # doubly-rerouted late fetch stamps the ORIGINAL home
            r.log_fence(seqno, owner, origin=origin)
        for q in self.quarantine:
            r.log_put(
                WorkUnit(
                    seqno=q["seqno"],
                    work_type=q["work_type"],
                    prio=q["prio"],
                    target_rank=q["target_rank"],
                    answer_rank=q["answer_rank"],
                    payload=q["payload"],
                    attempts=q["attempts"],
                    common_len=q.get("common_len", 0),
                    common_server_rank=q.get("common_server_rank", -1),
                    common_seqno=q.get("common_seqno", -1),
                ),
                -1, None,
            )
            r.log_quarantine(q["seqno"])
        # dedup windows: without these, a put this server acked (or a
        # get/forfeit it accounted) re-sent after a later death of THIS
        # server would be applied twice by the new buddy
        for src, (_ids, order) in self._seen_puts.items():
            r.log_seen_puts(src, order)
        for src, gid in self._last_common.items():
            r.log_common_op(-1, "get", src, gid)
        for src, (_ids, order) in self._seen_forfeits.items():
            for fid in order:
                r.log_common_op(-1, "forfeit", src, fid)
        if self.is_master:
            # the new buddy is the new DEPUTY: bootstrap the whole brain
            # (the per-event streaming below only ships changes)
            r.log_member(self._brain_doc())
            if self._slo_engine is not None:
                for o in self._slo_engine.objectives:
                    r.log_slo(dict(o))
            if self._controller is not None:
                r.log_control(self._controller.policy_doc())
            if self._scale_pending is not None:
                r.log_scale(dict(self._scale_pending))
            for j in self.jobs.values():
                if j.weight != 1.0:
                    r.log_job_weight(j.job_id, j.weight)
        self.repl = r
        self._refresh_wlog()
        self.flight.record(
            f"replication re-bootstrapped to server {new_buddy} "
            f"({len(list(self.wq.units()))} units)"
        )

    def _on_repl(self, m: Msg) -> None:
        if not self._failover and m.src not in self._draining_servers:
            return  # a misconfigured peer's stream is ignorable
        from adlb_tpu_torch.runtime import replica

        self.mirrors.setdefault(
            m.src, replica.ReplicaMirror(m.src)
        ).apply(m.blob)

    # -- death detection & fan-out ------------------------------------------

    def _can_failover(self, dead: int) -> bool:
        """A server with a live buddy candidate can fail over — the
        MASTER included: its ring buddy is the standing deputy, holding
        the replicated brain (see _promote_master). Only the no-live-
        peer case (last pair dying together) still aborts."""
        if not self._failover:
            return False
        from adlb_tpu_torch.runtime import replica

        return replica.buddy_of(
            self.world, dead, self._buddy_excluded()
        ) != dead

    def _on_server_eof(self, src: int) -> None:
        """A server peer's connection closed mid-run (before this server
        is done): death, unless termination is underway — a finished peer
        exits normally then, so during termination the death is only
        *suspected* and declared if the world has not completed shortly."""
        self._server_eof_at.setdefault(src, time.monotonic())
        # genuine inbound EOF: handled in queue order, so every SS_REPL
        # frame this connection carried has already been applied
        self._server_tail_drained.add(src)
        if src in self._pending_promotion:
            # the fan-out beat the EOF here; the EOF closes the tail
            # window — every replication frame from src has now drained
            del self._pending_promotion[src]
            self._promote(src)
            return
        if src in self._dead_servers:
            return
        if self.no_more_work or self.done_by_exhaustion or self._ending:
            if self._failover and self._can_failover(src):
                self._suspect_servers.setdefault(
                    src, time.monotonic() + 2.0
                )
            return  # abort policy: benign, as in the reference teardown
        if self._failover and self._can_failover(src):
            aprintf(
                True, self.rank,
                f"server rank {src} connection lost mid-run; failing over "
                f"(on_server_failure=failover)",
            )
            self._declare_server_dead(src)
            return
        aprintf(
            True, self.rank,
            f"server rank {src} connection lost mid-run; aborting",
        )
        self._do_abort(-3, broadcast=True)

    def _declare_server_dead(self, dead: int) -> None:
        if dead in self._dead_servers or self.done:
            return
        epoch = self.world.epoch + 1
        for s in self._live_servers():
            if s == dead:
                continue
            try:
                self.ep.send(
                    s, msg(Tag.SS_SERVER_DEAD, self.rank, rank=dead,
                           epoch=epoch)
                )
            except OSError:
                pass  # its own EOF/evidence will catch up
        self._on_server_dead(
            msg(Tag.SS_SERVER_DEAD, self.rank, rank=dead, epoch=epoch)
        )

    def _on_server_dead(self, m: Msg) -> None:
        dead = m.rank
        if dead in self._dead_servers or dead == self.rank:
            return
        from adlb_tpu_torch.runtime import replica

        # clean retire (elastic scale-in drain_done): the shard was
        # fully shipped to the buddy BEFORE this frame, so the promote
        # counts no losses and the death-vs-drain metrics split
        clean = bool(m.data.get("clean")) or dead in self._clean_retire
        if not clean and not self._can_failover(dead):
            # no live buddy left (the last pair died together, or the
            # policy is off): unrecoverable
            aprintf(
                True, self.rank,
                f"server rank {dead} died and cannot fail over "
                f"(no live buddy); aborting",
            )
            self._do_abort(-3, broadcast=True)
            return
        self._dead_servers.add(dead)
        self._suspect_servers.pop(dead, None)
        self._draining_servers.discard(dead)
        if clean:
            self._clean_retire.add(dead)
            self._drained_servers.add(dead)
        self.world.note_epoch(m.data.get("epoch", 0) or 0)
        self._g_epoch.set(self.world.epoch)
        buddy = replica.buddy_of(self.world, dead, self._buddy_excluded())
        self._srv_route[dead] = buddy
        if clean:
            self._m_servers_drained.inc()
        else:
            self._m_server_dead.inc()
        # master: the retired-route map just changed — the deputy's
        # brain must carry it (a promoted master seeds joiners from it)
        self._repl_brain()
        # a retired server can never ack a membership fan-out: release
        # any barrier waiting on it
        for tok in [
            t for t, p in self._member_pending.items()
            if dead in p["need"]
        ]:
            p = self._member_pending[tok]
            p["need"].discard(dead)
            if not p["need"]:
                del self._member_pending[tok]
                self._member_reply(p)
        # ... and a dead server can never ack the succession barrier
        if self._takeover_pending is not None:
            self._takeover_pending["need"].discard(dead)
            if not self._takeover_pending["need"]:
                self._master_takeover_done()
        # master: the retired shard's obs-gossip snapshots must not
        # report stale forever on /healthz (/fleet keeps the topology
        # history; the staleness ledger is for LIVE members)
        if self.is_master:
            self._fleet_seen.pop(dead, None)
            self._fleet_snaps.pop(dead, None)
            self._prof_fleet.pop(dead, None)
            self._prof_windows.pop(dead, None)
            self._member_ready.discard(dead)
        self.flight.record(
            f"server_{'drained' if clean else 'dead'} rank={dead} "
            f"declared_by={m.src} buddy={buddy} "
            f"epoch={self.world.epoch}"
        )
        # 1) gossip/steal state: forget the dead peer, repoint targeted
        # directory entries at its buddy, release RFR/push state that
        # would otherwise block forever on a response that never comes
        self.peers.pop(dead, None)
        self.tq.repoint(dead, buddy)
        self._rfr_out.clear()
        for excluded in self._rfr_excluded.values():
            excluded.discard(dead)
        self._push_offered.clear()
        for qid in [q for q in self._push_reserved if (q >> 20) == dead]:
            self.mem.free(self._push_reserved.pop(qid))
        # 2) migration batches in transit TO the dead server: the units
        # serialized inside unacked SS_MIGRATE_WORK frames live in no wq
        # anywhere — take them back
        for tok, units in self._migrate_pending.pop(dead, {}).items():
            self._migrate_unacked -= 1
            for u in units:
                self._admit_migrated_unit(u, bounced=False)
            self.flight.record(
                f"migrate batch tok={tok} to dead server {dead} "
                f"requeued ({len(units)} units)"
            )
        held = getattr(self, "_held_checkpoints", None)
        if held and self._migrate_unacked == 0:
            self._held_checkpoints = []
            for h in held:
                self._process_checkpoint(h)
        # 3) our own replication stream: if the dead server was our
        # buddy, re-bootstrap toward the next live successor
        if self.repl is not None and self.repl.buddy == dead:
            self._rebootstrap_repl(
                replica.buddy_of(self.world, self.rank, self._buddy_excluded())
            )
        # 4) master: retire the dead server's snapshot so plans stop
        # naming it, and re-kick a possibly-lost END_1 token
        if self.is_master:
            if self.cfg.balancer == "tpu":
                self._snapshots.pop(dead, None)
                self._req_sigs.pop(dead, None)
                self._broadcast_hungry(self._hungry_tracker.update(dead, []))
                if self._balancer is not None:
                    self._balancer.wake.set()
            if not self.done and (self._ending or self._end1_pending) and (
                self._finalized >= self.local_apps
            ):
                self._end1_pending = True
                self._forward_end1(
                    {"origin": self.rank, "epoch": self.world.epoch}
                )
        # the topology change is activity: an exhaustion vote must not
        # conclude across it
        self.activity += 1
        self._exhaust_held_since = None
        # 5) off-home targeted inventory for ranks the buddy adopts: the
        # buddy's directory starts empty, so re-announce what WE hold
        if buddy != self.rank:
            # one pass over the wq (this runs inside the latency-critical
            # failover window; a rescan per announced pair would be
            # O(units x pairs))
            counts: dict[tuple[int, int], int] = {}
            for u in self.wq.units():
                if (
                    u.target_rank >= 0
                    and self.world.home_server(u.target_rank) == dead
                ):
                    key = (u.target_rank, u.work_type)
                    counts[key] = counts.get(key, 0) + 1
            for (t_rank, wtype), n in counts.items():
                try:
                    self.ep.send(
                        buddy,
                        msg(Tag.SS_MOVING_TARGETED_WORK, self.rank,
                            app_rank=t_rank, work_type=wtype,
                            from_server=dead, to_server=self.rank,
                            count=n),
                    )
                except OSError:
                    pass
        # 6) handoffs routed THROUGH the dead home server: units pinned
        # here for its app ranks went out as RFR/plan responses via the
        # dead home, so their resolution (SS_DELIVERED / UNRESERVE / the
        # client's fetch after an undelivered handle) may have died with
        # it. A fused relay's payload may already have been forwarded —
        # at-most-once wins (delivered-at-death, as in the rank-death
        # sweep), and the unit is counted in failover_relays_unresolved
        # (delivered or lost: the dead server may never have forwarded
        # it, and no survivor can tell which); a handle-shaped
        # handoff unpins so the unit re-matches (an owner that DID
        # receive the handle gets ADLB_RETRY on its fetch and
        # re-reserves).
        swept = 0
        for r in self.world.local_apps(dead):
            if r in self._dead_ranks:
                continue
            for lease in self.leases.owned_by(r):
                unit = self.wq.get(lease.seqno)
                if unit is None or not unit.pinned or unit.pin_rank != r:
                    continue
                if self._relay_inflight.get(lease.seqno) == r:
                    self._relay_inflight.pop(lease.seqno, None)
                    self._consume(unit)
                    self._m_relays_unresolved.inc()
                    self.flight.record(
                        f"relay_consumed_on_failover seqno={lease.seqno} "
                        f"rank={r} via={dead} (counted unresolved)"
                    )
                    continue
                self.leases.release(lease.seqno)
                self.wq.unpin(lease.seqno)
                if self.wlog is not None:
                    self.wlog.log_unpin(lease.seqno)
                if unit.common_seqno >= 0:
                    # the owner may have fetched the prefix already (the
                    # handle path orders common-first); the re-match
                    # fetches again — bounded-leak direction, as in the
                    # reclaim sweep
                    self._forfeit_common(
                        unit.common_seqno, unit.common_server_rank,
                        op="credit",
                    )
                swept += 1
        if swept:
            self.flight.record(
                f"unpinned {swept} handoffs routed via dead server {dead}"
            )
            self._match_rq()
        # ... and the other direction: units the dead server relayed to
        # OUR ranks and we resolved may still stand pinned in the buddy's
        # mirror (the consume or unpin died in its replication tail)
        self._resend_resolutions(dead)
        # 7) the buddy replays the mirror and takes over; held until the
        # dead server's own EOF drains its replication tail (bounded —
        # the death may predate any connection from it to us)
        if buddy == self.rank:
            if dead in self._server_tail_drained:
                self._promote(dead)
            else:
                self._pending_promotion[dead] = time.monotonic() + 2.0
        # parked requesters whose RFRs died with the server re-arm
        for entry in self.rq.entries():
            if entry.world_rank not in self._rfr_out:
                self._try_rfr(entry)

    def _admit_migrated_unit(self, u: dict, bounced: bool) -> None:
        """Install one migrated-unit record into the local wq (shared by
        the normal SS_MIGRATE_WORK intake and the dead-destination
        requeue). Admission control only on first sight; a unit already
        admitted to the system is never dropped."""
        self.mem.alloc(len(u["payload"]))
        unit = WorkUnit(
            seqno=self._next_seqno,
            work_type=u["work_type"],
            prio=u["prio"],
            target_rank=-1,
            answer_rank=u["answer_rank"],
            payload=u["payload"],
            home_server=u["home_server"],
            common_len=u["common_len"],
            common_server_rank=u["common_server"],
            common_seqno=u["common_seqno"],
            time_stamp=u["time_stamp"],
            attempts=int(u.get("attempts", 0) or 0),
            job=int(u.get("job", 0) or 0),
        )
        self._next_seqno += 1
        tf = u.get("trace")
        if tf:
            self.journeys.adopt(unit, tf["id"], tf["spans"],
                                stage="migrate")
        self.wq.add(unit)
        if self.wlog is not None:
            self.wlog.log_put(unit, -1, None)
        self.stats[InfoKey.NPUSHED_TO_HERE] += 1

    # -- takeover (buddy side) ----------------------------------------------

    def _promote(self, dead: int) -> None:
        """Replay the dead predecessor's mirrored shard into this
        server's live queues and take over home-server duty for its app
        ranks."""
        if self.done:
            return
        clean = dead in self._clean_retire
        mirror = self.mirrors.pop(dead, None)
        if mirror is None:
            if clean:
                # a drained server with nothing to ship (it flushed an
                # EMPTY full-state bootstrap): promote a blank mirror
                from adlb_tpu_torch.runtime import replica

                mirror = replica.ReplicaMirror(dead)
            else:
                # double failure: the shard died with its buddy before
                # any replication frame reached us — unrecoverable
                aprintf(
                    True, self.rank,
                    f"server rank {dead} died but no replica of its "
                    f"shard exists here (buddy died before promotion?); "
                    f"aborting",
                )
                self._do_abort(-3, broadcast=True)
                return
        mirror.seal()
        t0 = self._server_eof_at.get(dead, time.monotonic())
        # computed BEFORE any mutation: succession (set_master below)
        # rewrites what master_server_rank answers
        was_master = dead == self.world.master_server_rank
        # 1) batch-common prefixes first (units reference them)
        for old_cseq, (buf, refcnt, ngets, credits) in sorted(
            mirror.commons.items()
        ):
            self.mem.alloc(len(buf))
            new_cseq = self.cq.adopt(buf, refcnt, ngets, credits)
            self._adopted_commons[(dead, old_cseq)] = new_cseq
            if self.wlog is not None:
                self.wlog.log_common_put(new_cseq, buf)
                self.wlog.log_common_state(new_cseq, refcnt, ngets, credits)
        # 2) units: pinned-to-a-live-client survive PINNED under their
        # lease behind a seqno translation (the client's in-flight fetch
        # lands here via the fo_from reroute); everything else re-enqueues
        adopted = pinned_kept = lost = 0
        hedge_dropped = 0
        for old_seqno in sorted(mirror.units):
            if old_seqno in mirror.hedges:
                # live hedge SIBLING at takeover: its origin is in this
                # same mirror and adopts normally — adopting the sibling
                # too would hand the new home two live duplicates with
                # no group state to fence the loser. Drop the sibling
                # (not a counted loss: the logical put survives via the
                # origin) and FENCE its pinned owner, so the rerouted
                # late fetch answers ADLB_FENCED (you lost the race —
                # re-reserve) instead of a miscounted failover loss.
                pin_rank = mirror.pins.get(old_seqno, -1)
                if pin_rank >= 0:
                    self._adopted_fences.add((dead, old_seqno, pin_rank))
                    if self.wlog is not None:
                        self.wlog.log_fence(old_seqno, pin_rank,
                                            origin=dead)
                hedge_dropped += 1
                continue
            f = mirror.units[old_seqno]
            pin_rank = mirror.pins.get(old_seqno, -1)
            target = f["target_rank"]
            cs, cseq = f["common_server_rank"], f["common_seqno"]
            clen = f["common_len"]
            if cseq >= 0 and cs == dead:
                new_c = self._adopted_commons.get((dead, cseq))
                if new_c is None:
                    # prefix lost to replication lag: the suffix alone is
                    # not the unit — counted ONCE here (registered so the
                    # pin owner's later fetch answers RETRY uncounted)
                    lost += 1
                    self._counted_lost.add((dead, old_seqno))
                    self._m_failover_lost.inc()
                    if f.get("trace_id"):
                        # failover loss is terminal for the journey too
                        self.journeys.close_spans(
                            f["trace_id"], f.get("job", 0),
                            f["work_type"], "lost",
                            list(f.get("spans") or []),
                        )
                    self.flight.record(
                        f"failover_lost unit={old_seqno} (prefix gone)"
                    )
                    continue
                cs, cseq = self.rank, new_c
            if target >= 0 and (
                target in self._dead_ranks or target in mirror.dead_ranks
            ):
                self._m_targeted_dropped.inc()
                self._forfeit_common(cseq, cs)
                continue
            if pin_rank >= 0 and pin_rank in self._dead_ranks:
                # owner died before its home server did: reclaim rules
                pin_rank = -1
                if cseq >= 0:
                    self._forfeit_common(cseq, cs, op="credit")
            unit = WorkUnit(
                seqno=self._next_seqno,
                work_type=f["work_type"],
                prio=f["prio"],
                target_rank=target,
                answer_rank=f["answer_rank"],
                payload=f["payload"],
                home_server=self.rank,
                common_len=clen,
                common_server_rank=cs,
                common_seqno=cseq,
                pinned=pin_rank >= 0,
                pin_rank=pin_rank if pin_rank >= 0 else -1,
                attempts=f.get("attempts", 0),
                job=f.get("job", 0),
            )
            self._next_seqno += 1
            self.mem.alloc(len(unit.payload))
            if f.get("trace_id"):
                # the journey survives the takeover with an "adopt" hop
                # (and rides our own wlog onward via log_put below);
                # clean drains stamp "drain" instead, so scale-in churn
                # is visible in /trace/tails
                self.journeys.adopt(unit, f["trace_id"], f.get("spans"),
                                    stage="drain" if clean else "adopt")
            self.wq.add(unit)
            if pin_rank >= 0:
                self.leases.grant(unit.seqno, pin_rank)
                self._adopted_units[(dead, old_seqno)] = unit.seqno
                pinned_kept += 1
            adopted += 1
            if self.wlog is not None:
                self.wlog.log_put(unit, -1, None)
        # 3) tombstones: a post-takeover fetch of a consumed unit is a
        # counted loss (the response died with the server), not an
        # invalid-handle abort
        self._adopted_tombs.update((dead, s) for s in mirror.tombstones)
        # ... fencing state rides the stream too: a fenced owner's
        # rerouted late fetch must stay rejected (ADLB_FENCED), never be
        # miscounted as a replication-lag loss or — worse — served. A
        # fence's key is the numbering of the ORIGINAL home (reroutes
        # stamp fo_from with it), so fences the dead server had itself
        # adopted (origin >= 0) keep their origin through the chain —
        # and every adopted fence is logged onward to OUR buddy so a
        # THIRD takeover still rejects the doubly-rerouted fetch
        for (s, o, origin) in mirror.fences:
            key = (dead if origin < 0 else origin, s, o)
            self._adopted_fences.add(key)
            if self.wlog is not None:
                self.wlog.log_fence(s, o, origin=key[0])
        # ... and the predecessor's dead-letter quarantine: re-homed
        # under fresh seqnos and re-counted HERE (its own QUARANTINED
        # stat died with it — only the survivor's count reaches the
        # final aggregation, keeping the conservation total exact)
        for old_seqno in sorted(mirror.quarantined):
            self._adopt_quarantined(mirror.quarantined[old_seqno],
                                    old_seqno, dead)
        # 4) duplicate-put protection survives the failover: the dead
        # server's accepted-put windows merge, so a client re-sending an
        # acked-but-unanswered put gets the idempotent ack, not a dup unit
        for src, ids in mirror.seen_puts.items():
            for pid in ids:
                self._put_record(src, pid)
        # ... and the common-prefix dedup identities: a get/forfeit the
        # dead server already accounted (and replicated) re-sent toward
        # this buddy must be absorbed, not double-accounted against the
        # adopted refcount state. Ids are per-client monotonic, so the
        # newest wins for the last-get check.
        for src, gid in mirror.last_common.items():
            if gid > self._last_common.get(src, -1):
                self._last_common[src] = gid
        for src, fids in mirror.forfeit_ids.items():
            for fid in fids:
                self._window_seen(self._seen_forfeits, src, fid)
        # 5) home-server duty: adopt the dead server's app ranks (with
        # their finalize/death accounting)
        newly = set(self.world.local_apps(dead))
        self.local_apps |= newly
        # job lifecycle the predecessor knew (normally already here via
        # the SS_JOB_CTL fan-out; the replay makes it exact even when a
        # fan-out frame died with the server)
        for jid, (code, quota, jname) in mirror.jobs_meta.items():
            if self.jobs.get(jid) is None:
                self.jobs.restore(jid, code, quota, jname)
        self._finalized |= mirror.finalized & newly
        for r in mirror.dead_ranks:
            self._dead_ranks.add(r)
            self._swept_streams.add(r)
            if r in self.local_apps:
                self._finalized.add(r)
        # adopted ranks' streams may hold phantom slots (reserves parked
        # at the dead server): their next idle note re-arms them
        self._swept_streams |= newly
        # relay resolutions that reached us before this adoption: their
        # pinned units have local seqnos now
        for held in self._held_resolutions.pop(dead, ()):
            self._handlers[held.tag](held)
        if was_master and not clean:
            # the dead server was the BRAIN: restore the replicated
            # control plane, take the master role under a bumped epoch,
            # and fan the succession before any termination verdict can
            # conclude (the takeover barrier gates exhaustion/END)
            self._promote_master(dead, mirror, t0)
        mttr_ms = (time.monotonic() - t0) * 1e3
        if not clean:
            # a drain is not a failover: the promote machinery is shared
            # but the death metrics (and their acceptance oracles —
            # "zero failover_lost, zero failovers on a clean scale-in")
            # stay death-only
            self._m_failover_promoted.inc()
            self._g_fo_mttr.set(mttr_ms)
        self.activity += 1
        self._exhaust_held_since = None
        self.flight.record(
            f"failover_promoted dead={dead} adopted_units={adopted} "
            f"pinned_kept={pinned_kept} lost={lost} "
            f"hedge_siblings_dropped={hedge_dropped} "
            f"commons={len(mirror.commons)} ranks={sorted(newly)} "
            f"mttr_ms={mttr_ms:.1f}"
        )
        aprintf(
            True, self.rank,
            f"took over server {dead}: {adopted} units "
            f"({pinned_kept} pinned), {len(mirror.commons)} common "
            f"prefixes, app ranks {sorted(newly)}, mttr {mttr_ms:.1f} ms",
        )
        # 6) epoch-stamped remap: every live app learns the new home /
        # routing (finished apps' listeners may be gone — best-effort,
        # short connect grace)
        note = dict(dead=dead, epoch=self.world.epoch)
        if was_master and not clean:
            # clients re-point job control / detach / checkpoint asks at
            # the promoted deputy (the srv_route reroute alone would
            # only cover traffic addressed to the DEAD rank)
            note["new_master"] = self.rank
        for r in self.world.app_ranks:
            if r in self._dead_ranks:
                continue
            try:
                self.ep.send(
                    r, msg(Tag.TA_HOME_TAKEOVER, self.rank, **note),
                    connect_grace=1.0,
                )
            except OSError:
                pass
        # the one-shot fan-out above is best-effort; re-announce from the
        # periodic tick until every client's failover window has closed
        # (the client-side apply is idempotent — duplicate notes no-op)
        self._takeover_renotify[dead] = (
            time.monotonic() + self.cfg.failover_client_wait
        )
        self.flight.dump_json(f"failover_{dead}")
        # the adopted shard may satisfy parked requesters right now; and
        # if every adopted rank already finalized, termination proceeds
        self._match_rq()
        self._maybe_complete_finalize()
        if self.cfg.balancer == "tpu":
            self._send_snapshot()

    # -- master succession (deputy side) --------------------------------------

    def _promote_master(self, dead: int, mirror, t0: float) -> None:
        """The dead server was the MASTER and this buddy is its standing
        deputy. Restore the replicated brain (durable control plane),
        take the master role under a bumped fleet epoch, rebuild the
        reconstructed engines (SLO/controller under a churn hold, so
        pre-death alerts re-enter without re-firing), restart the
        balancer, rebind the ops endpoint, and fan the epoch-stamped
        succession behind an ack barrier (exhaustion/END defer on it)."""
        now = time.monotonic()
        brain = getattr(mirror, "brain", None) or {}
        # 1) durable brain state — applied BEFORE set_master, since the
        # snapshot still names the dead master (epoch-guarded)
        self.world.seed(brain.get("member") or {})
        self._member_next_rank = max(
            self._member_next_rank, int(brain.get("next_rank", 0) or 0)
        )
        for r, a in (brain.get("addrs") or {}).items():
            r = int(r)
            self._member_addrs.setdefault(r, tuple(a))
            if hasattr(self.ep, "addr_map"):
                self.ep.addr_map.setdefault(r, tuple(a))
        for s in brain.get("live") or ():
            if s != self.rank and s not in self._dead_servers:
                self._member_live.add(int(s))
        for s in brain.get("ready") or ():
            if s not in self._dead_servers:
                self._member_ready.add(int(s))
        for s in brain.get("drained") or ():
            self._drained_servers.add(int(s))
            self._dead_servers.add(int(s))
            self._clean_retire.add(int(s))
        for r, b in (brain.get("srv_route") or {}).items():
            self._srv_route.setdefault(int(r), int(b))
        self._job_next_id = max(
            self._job_next_id, int(brain.get("job_next_id", 1) or 1)
        )
        weights = dict(getattr(mirror, "job_weights", None) or {})
        for jid, w in weights.items():
            self.jobs.apply("update", int(jid), weight=float(w))
        if weights:
            self._pending_job_weights = self._effective_job_weights()
        # 2) succession under a bumped epoch: every in-flight
        # exhaustion/END token (the dead master's included) now carries
        # a stale epoch and voids at the first live hop
        epoch = max(self.world.epoch, int(brain.get("epoch", 0) or 0)) + 1
        self.world.set_master(self.rank, epoch)
        self.is_master = True
        self.flight.context["is_master"] = True
        self._g_epoch.set(self.world.epoch)
        # 3) reconstructed engines. The obs plane heals itself: every
        # server's next SS_OBS_SYNC targets master_server_rank — us —
        # and gossip snapshots are cumulative, so the merged fleet view
        # converges within one sync interval.
        armed = bool(brain.get("ops_armed")) or (
            self.cfg.ops_port is not None
        )
        if armed and self.cfg.obs_sync_interval > 0:
            if not self._obs_sync_armed:
                self._obs_sync_armed = True
                self._next_obs_sync = now + self.cfg.obs_sync_interval
            slo_docs = list(
                (getattr(mirror, "slo_docs", None) or {}).values()
            )
            if slo_docs or self.cfg.slo or self._slo_engine is not None:
                from adlb_tpu_torch.obs.slo import SloEngine

                if self._slo_engine is None:
                    eng = SloEngine(
                        self.cfg.slo_eval_interval
                        or self.cfg.obs_sync_interval
                    )
                    for doc in self.cfg.slo or ():
                        try:
                            eng.add(doc)
                        except ValueError:
                            pass
                    self._slo_engine = eng
                for doc in slo_docs:
                    try:
                        self._slo_engine.add(doc)
                    except ValueError:
                        pass  # config duplicate: already installed
                # churn hold: alert lifecycles re-enter quietly — the
                # takeover transient must not re-fire a page
                self._slo_engine.note_epoch(
                    int(brain.get("epoch", 0) or 0), now
                )
                self._slo_engine.note_epoch(self.world.epoch, now)
        pol = getattr(mirror, "control_policy", None)
        if self._controller is None and (pol or self.cfg.control):
            from adlb_tpu_torch.control import Controller

            self._controller = Controller(
                {
                    "dry_run": self.cfg.control_dry_run,
                    "min_servers": self.cfg.control_min_servers,
                    "max_servers": self.cfg.control_max_servers,
                    "cooldown_s": self.cfg.control_cooldown_s,
                    "scaleout_pressure": self.cfg.control_scaleout_pressure,
                    "scalein_pressure": self.cfg.control_scalein_pressure,
                },
                eval_interval=(self.cfg.control_interval
                               or self.cfg.obs_sync_interval),
            )
        if self._controller is not None:
            if pol:
                try:
                    self._controller.update_policy(dict(pol))
                except ValueError:
                    pass
            self._controller.note_epoch(
                int(brain.get("epoch", 0) or 0), now
            )
            self._controller.note_epoch(self.world.epoch, now)
        if (
            getattr(mirror, "scale_pending", None) is not None
            and self._scale_pending is None
        ):
            self._scale_pending = dict(mirror.scale_pending)
        # 4) the balancer brain restarts here, against the snapshot
        # store the gossip refills (and the _send_snapshot at the end
        # of _promote primes with our own inventory)
        if self.cfg.balancer == "tpu" and self._balancer is None:
            self._balancer = _BalancerWorker(self)
            self._balancer.start()
        # 5) ops endpoint rebind: always an EPHEMERAL port — the dead
        # master's HTTP thread may still hold cfg.ops_port (in-proc
        # death is a connectivity fault, not a process exit). The new
        # port travels in the takeover frame and the rendezvous dir.
        if armed and self.ops is None:
            from adlb_tpu_torch.obs.ops_server import maybe_start

            self.ops = maybe_start(self, self.cfg, port=0)
        self._announce_ops_endpoint()
        # 6) succession fan-out behind an ack barrier
        self._master_takeover_fan()
        mttr = (now - t0) * 1e3
        # lazily minted: only a world that actually promoted a master
        # carries the row (frame identity for everyone else)
        self.metrics.gauge("master_failover_mttr_ms").set(mttr)
        self.flight.record(
            f"master_takeover dead={dead} epoch={self.world.epoch} "
            f"mttr_ms={mttr:.1f} slo={len(self._slo_engine.objectives) if self._slo_engine else 0} "
            f"control={'y' if self._controller else 'n'} "
            f"ops_port={self.ops.port if self.ops else None}"
        )
        aprintf(
            True, self.rank,
            f"promoted to master (epoch {self.world.epoch}, "
            f"mttr {mttr:.1f} ms)",
        )
        # 7) this new master's own buddy is the NEXT deputy: ship it the
        # whole brain so sequential master deaths keep succeeding
        if self.repl is not None:
            self._repl_brain()
            if self._slo_engine is not None:
                for o in self._slo_engine.objectives:
                    self.repl.log_slo(dict(o))
            if self._controller is not None:
                self.repl.log_control(self._controller.policy_doc())
            if self._scale_pending is not None:
                self.repl.log_scale(dict(self._scale_pending))
            for j in self.jobs.values():
                if j.weight != 1.0:
                    self.repl.log_job_weight(j.job_id, j.weight)

    def _announce_ops_endpoint(self) -> None:
        """Publish the live ops endpoint to Config(ops_announce_dir):
        the out-of-band rendezvous an HTTP consumer polls across a
        succession (the old port dies with the old master)."""
        d = self.cfg.ops_announce_dir
        if not d or self.ops is None:
            return
        try:
            import json as _json
            import os as _os

            tmp = _os.path.join(d, ".ops_endpoint.tmp")
            with open(tmp, "w") as f:
                _json.dump({
                    "host": "127.0.0.1",
                    "port": self.ops.port,
                    "master": self.rank,
                    "epoch": self.world.epoch,
                }, f)
            _os.replace(tmp, _os.path.join(d, "ops_endpoint.json"))
        except OSError:
            pass  # rendezvous is best-effort; the takeover frame is not

    def _master_takeover_fan(self) -> None:
        """Fan SS_MASTER_TAKEOVER to every live server behind an ack
        barrier (the membership-barrier shape): until every survivor
        acks the new epoch, no exhaustion vote starts here and no END
        ring kicks — the no-raced-verdict guarantee."""
        self._takeover_tok += 1
        tok = self._takeover_tok
        fields = dict(
            new_master=self.rank, epoch=self.world.epoch,
            member_tok=tok,
        )
        if self.ops is not None:
            fields["host"], fields["port"] = "127.0.0.1", self.ops.port
        need = set()
        for s in self._live_servers():
            try:
                self.ep.send(
                    s, msg(Tag.SS_MASTER_TAKEOVER, self.rank, **fields)
                )
                need.add(s)
            except OSError:
                self._note_server_unreachable(s)
        if need:
            self._takeover_pending = {
                "need": need, "tok": tok,
                "deadline": time.monotonic() + 5.0,
            }
        else:
            self._master_takeover_done()

    def _master_takeover_done(self) -> None:
        self._takeover_pending = None
        self.activity += 1
        self._exhaust_held_since = None
        if self.no_more_work or self.done_by_exhaustion:
            # finish the dead master's terminal fan-out: it may have died
            # halfway through declaring the world done, and a server it
            # did not reach holds parked ranks nothing else releases (the
            # verdict's handlers ignore a repeat)
            tag = (Tag.SS_NO_MORE_WORK if self.no_more_work
                   else Tag.SS_DONE_BY_EXHAUSTION)
            for srv in self._live_servers():
                try:
                    self.ep.send(srv, msg(tag, self.rank),
                                 **self._srv_grace())
                except OSError:
                    self._note_server_unreachable(srv)
        # re-initiate the termination ring: an END token the dead master
        # originated died with it (or voids on the bumped epoch); if the
        # world was terminating, this master re-kicks under the new epoch
        if (
            not self.done and (self._ending or self._end1_pending)
            and self._finalized >= self.local_apps
        ):
            self._end1_pending = True
            self._forward_end1(
                {"origin": self.rank, "epoch": self.world.epoch}
            )
        else:
            self._maybe_complete_finalize()

    def _on_master_takeover(self, m: Msg) -> None:
        if m.data.get("mop") == "ack":
            p = self._takeover_pending
            if p is None or m.data.get("member_tok") != p["tok"]:
                return
            p["need"].discard(m.src)
            if not p["need"]:
                self._master_takeover_done()
            return
        new_master = int(m.data["new_master"])
        epoch = int(m.data.get("epoch", 0) or 0)
        self.world.set_master(new_master, epoch)
        self._g_epoch.set(self.world.epoch)
        self.flight.record(
            f"master_takeover_seen new_master={new_master} "
            f"epoch={epoch} ops_port={m.data.get('port')}"
        )
        # the succession is activity (a held exhaustion vote must not
        # conclude across it) and voids any stale-epoch token we relay
        self.activity += 1
        self._exhaust_held_since = None
        tok = m.data.get("member_tok")
        if tok:
            try:
                self.ep.send(
                    m.src, msg(Tag.SS_MASTER_TAKEOVER, self.rank,
                               mop="ack", member_tok=tok)
                )
            except OSError:
                pass

    # -- takeover translation (content-addressed messages) --------------------

    def _adopted_unit_for(self, m: Msg):
        """Resolve a rerouted message's (dead server, old seqno) to the
        adopted local seqno; None when the unit did not survive."""
        return self._adopted_units.get((m.data["fo_from"], m.seqno))

    def _adopted_common_for(self, fo_from: int, cseq: int):
        return self._adopted_commons.get((fo_from, cseq))

    # ------------------------------------------------------- abort / watchdog

    def _on_fa_abort(self, m: Msg) -> None:
        self._do_abort(m.data.get("code", -1), broadcast=True)

    def _on_ss_abort(self, m: Msg) -> None:
        self._do_abort(m.data.get("code", -1), broadcast=False)

    def _do_abort(self, code: int, broadcast: bool) -> None:
        if self._aborted:
            return
        self._aborted = True
        aprintf(self.cfg.aprintf_flag, self.rank, f"aborting, code {code}")
        # the reference dumps every server's state on abort with a grace
        # period (src/adlb.c:2508-2526); here: the in-memory flight recorder
        self.flight.record(f"abort code={code} broadcast={broadcast}")
        self.flight.dump(reason=f"abort {code}")
        if broadcast:
            for srv in self.world.server_ranks:
                if srv == self.rank or srv in self._dead_servers:
                    continue
                try:
                    self.ep.send(srv, msg(Tag.SS_ABORT, self.rank, code=code))
                except OSError:
                    pass  # already-dead peer must not block the abort
        for app in self.local_apps:
            if app in self._dead_ranks:
                continue  # no listener left; a connect-retry would stall
            try:
                self.ep.send(app, msg(Tag.TA_ABORT, self.rank, code=code))
            except OSError:
                pass  # already-dead client: the abort_event reaches it
        if self._abort_event is not None:
            self._abort_event.set()
        self.done = True

    def _send_ds_log(self) -> None:
        """The reference's 11-counter heartbeat (``log_at_debug_server``,
        reference ``src/adlb.c:3222-3259``): since-last-log event counts
        plus point-in-time queue depths. The iq and unexpected-queue
        fields map to the transport backlog (received-but-unhandled
        frames); the memory probe is /proc RSS."""
        ds = self.world.debug_server_rank
        if ds is None:
            return
        events = sum(self.tag_freq.values())
        ss = sum(
            n for t, n in self.tag_freq.items() if t.name.startswith("SS_")
        )
        # self_diagnosis clears tag_freq on its own cadence; a counter
        # that went backwards means a reset, so the delta restarts from 0
        if events < self._ds_last["events"] or ss < self._ds_last["ss"]:
            self._ds_last["events"] = 0
            self._ds_last["ss"] = 0
        wq_targeted = sum(
            1 for u in self.wq.units() if u.target_rank >= 0
        )
        last = self._ds_last
        from adlb_tpu_torch.utils.stats import rss_kb

        self.ep.send(
            ds,
            msg(
                Tag.DS_LOG,
                self.rank,
                counters={"puts": self._m_puts.v, "reserves": self._m_reserves.v,
                          "rfrs": self._m_rfrs.v, "pushes": self._m_pushes.v},
                events=events - last["events"],
                wq_targeted=wq_targeted,
                wq_count=self.wq.count,
                rq_count=len(self.rq),
                backlog=self.ep.backlog()
                if hasattr(self.ep, "backlog") else 0,
                reserves=self.stats[InfoKey.NUM_RESERVES] - last["reserves"],
                reserves_immed=self._n_reserve_immed - last["immed"],
                reserves_parked=(
                    self.stats[InfoKey.NUM_RESERVES_PUT_ON_RQ]
                    - last["parked"]
                ),
                rfr_failed=self._n_rfr_failed - last["rfr_failed"],
                ss_msgs=ss - last["ss"],
                rss_kb=rss_kb(),
                nbytes=self.mem.curr,
            ),
        )
        self._ds_last = {
            "events": events,
            "ss": ss,
            "reserves": self.stats[InfoKey.NUM_RESERVES],
            "immed": self._n_reserve_immed,
            "parked": self.stats[InfoKey.NUM_RESERVES_PUT_ON_RQ],
            "rfr_failed": self._n_rfr_failed,
        }

    def _notify_debug_server_end(self) -> None:
        ds = self.world.debug_server_rank
        if ds is not None:
            self.ep.send(ds, msg(Tag.DS_END, self.rank))

    # ------------------------------------------------------- stats surface

    def _state_at_kill(self) -> dict:
        """What an injected SIGKILL of this server takes with it, for the
        fault log (``FaultPlan.state``): its planner's counts so far (None
        when it never planned), the ``WorldResult.planner`` entry a killed
        rank cannot send."""
        s = self._solver
        return {"planner": None if s is None else s.planner_counts()}

    def planner_report(self) -> Optional[dict]:
        """What this server's planner did (``AssignmentSolver.
        planner_counts``) and its planning rounds (``rounds``; ``round_s``,
        their host-clock seconds in all): its ``WorldResult.planner`` entry.
        None when it never planned (a master in steal mode, a server that
        was never promoted)."""
        if self._solver is None:
            return None
        rounds = self.metrics.histogram("balancer_round_s")
        return {**self._solver.planner_counts(),
                "rounds": rounds.n, "round_s": rounds.sum}

    def finalize_stats(self) -> dict:
        from adlb_tpu_torch.utils.stats import rss_kb

        s = self.stats
        s[InfoKey.MALLOC_HWM] = float(self.mem.hwm)
        s[InfoKey.RSS_KB] = float(rss_kb())
        s[InfoKey.NUM_FAILOVERS] = float(
            self.metrics.value("failover_promoted")
        )
        s[InfoKey.FAILOVER_LOST] = float(self.metrics.value("failover_lost"))
        s[InfoKey.FAILOVER_RELAYS_UNRESOLVED] = float(
            self.metrics.value("failover_relays_unresolved"))
        s[InfoKey.FAILOVER_MTTR_MS] = float(self._g_fo_mttr.v)
        s[InfoKey.AVG_TIME_ON_RQ] = (
            self._rq_wait_sum / self._rq_wait_n if self._rq_wait_n else 0.0
        )
        return {int(k): float(v) for k, v in s.items()}
