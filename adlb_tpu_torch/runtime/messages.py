"""Message protocol.

Functional equivalent of the reference's 40-tag MPI wire protocol (reference
``src/adlb.c:44-83``), carried over any `Transport`. Differences from the
reference, by design:

* no rendezvous two-phase PUT (header/ack/Rsend): transports here deliver
  whole messages, and admission control happens at the receiving server,
  which replies with an accept/reject (+ least-loaded hint) like the
  reference's ACK_AND_RC (reference ``src/adlb.c:908-958``);
* the qmstat ring pass is replaced either by direct state broadcast
  (heuristic mode) or by balancer snapshot/plan messages (TPU mode).

Tag families keep the reference's naming: FA_* client->server, TA_*
server->client, SS_* server<->server, DS_* debug-server.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class Tag(enum.Enum):
    # client -> server
    FA_PUT = enum.auto()
    FA_PUT_COMMON = enum.auto()
    FA_BATCH_DONE = enum.auto()
    FA_DID_PUT_AT_REMOTE = enum.auto()
    FA_RESERVE = enum.auto()
    FA_GET_RESERVED = enum.auto()
    FA_GET_COMMON = enum.auto()
    FA_NO_MORE_WORK = enum.auto()
    FA_LOCAL_APP_DONE = enum.auto()
    FA_ABORT = enum.auto()
    FA_INFO_NUM_WORK_UNITS = enum.auto()
    FA_INFO_GET = enum.auto()
    # prefetch pipeline (get_work_stream; no reference analogue): the
    # client's bank ran dry and it is now genuinely blocked — its
    # prefetch-flagged reserves become park-eligible for exhaustion
    # voting (a delivery clears the mark server-side)
    FA_STREAM_IDLE = enum.auto()
    # drop this rank's prefetch reserves (stream close); acked so the
    # client can drain deliveries that raced the cancel
    FA_STREAM_CANCEL = enum.auto()
    # gray-failure detection (Config(lease_timeout_s) > 0; no reference
    # analogue): a client's liveness beacon while idle-but-computing —
    # ordinary protocol traffic already piggybacks liveness, this covers
    # the long-compute gaps. With a ``seqno`` field it doubles as an
    # explicit lease extension (ctx.extend_lease) for units whose
    # compute legitimately outlives the timeout.
    FA_HEARTBEAT = enum.auto()
    # dead-letter retrieval: list this server's quarantined units
    # (payload + metadata + attempt counts); ctx.get_quarantined()
    # aggregates the per-server responses
    FA_GET_QUARANTINED = enum.auto()
    # job control plane (service mode; no reference analogue — upstream
    # is one world = one job): submit/status/drain/kill toward the
    # MASTER (which allocates ids and fans out SS_JOB_CTL), attach
    # toward the rank's HOME server (binding the rank to a namespace
    # for per-job exhaustion voting). Same surface the ops endpoint's
    # /jobs routes expose over HTTP.
    FA_JOB_CTL = enum.auto()

    # server -> client
    TA_PUT_RESP = enum.auto()
    TA_PUT_COMMON_RESP = enum.auto()
    TA_RESERVE_RESP = enum.auto()
    TA_GET_RESERVED_RESP = enum.auto()
    TA_GET_COMMON_RESP = enum.auto()
    TA_INFO_NUM_RESP = enum.auto()
    TA_INFO_GET_RESP = enum.auto()
    TA_STREAM_CANCEL_RESP = enum.auto()
    TA_QUARANTINED_RESP = enum.auto()
    TA_JOB_CTL_RESP = enum.auto()
    TA_ABORT = enum.auto()

    # server <-> server
    SS_QMSTAT = enum.auto()
    SS_RFR = enum.auto()
    SS_RFR_RESP = enum.auto()
    SS_UNRESERVE = enum.auto()
    # remote fused fetch (no reference analogue — upstream always pays a
    # GET_RESERVED round trip to the holder, src/adlb.c:2976-3025): the
    # requester's home server confirms a payload-carrying SS_RFR_RESP
    # landed at the requester, so the holder consumes the pinned unit.
    # Until then the unit stays pinned under its lease — an UNRESERVE
    # race unpins it and a requester death reclaims it, both through the
    # existing paths.
    SS_DELIVERED = enum.auto()
    SS_PUSH_QUERY = enum.auto()
    SS_PUSH_QUERY_RESP = enum.auto()
    SS_PUSH_WORK = enum.auto()
    SS_PUSH_DEL = enum.auto()
    SS_MOVING_TARGETED_WORK = enum.auto()
    SS_NO_MORE_WORK = enum.auto()
    SS_EXHAUST_CHK_1 = enum.auto()
    SS_EXHAUST_CHK_2 = enum.auto()
    SS_DONE_BY_EXHAUSTION = enum.auto()
    SS_END_1 = enum.auto()
    SS_END_2 = enum.auto()
    SS_ABORT = enum.auto()
    SS_PERIODIC_STATS = enum.auto()  # stats ring token (src/adlb.c:2391-2465)
    # failure policy "reclaim" (no reference analogue — upstream's model is
    # rank-death-kills-job): the dead rank's home server fans this out so
    # every server reclaims leases, drops rq/targeted state, and excludes
    # the rank from termination counting
    SS_RANK_DEAD = enum.auto()
    # refcount-correct release of a batch-common prefix whose member unit
    # was dropped (targeted at a dead rank): the common server accounts a
    # forfeited get so the prefix still GCs when live members fetch
    SS_COMMON_FORFEIT = enum.auto()
    # job-namespace lifecycle fan-out (service mode): the master
    # broadcasts submit/drain/done/kill so every server's job table
    # converges; "done" additionally flushes the job's parked
    # requesters with ADLB_DONE_BY_EXHAUSTION (per-job termination)
    SS_JOB_CTL = enum.auto()
    # fleet metrics plane (no reference analogue — upstream's whole
    # diagnostic surface is end-of-run counter dumps): each non-master
    # server ships a delta-encoded registry snapshot (changed
    # counters/gauges/histograms, cumulative values) plus its closed
    # unit journeys to the master on the obs_sync_interval tick, so the
    # master's /metrics serves a merged fleet view, /healthz exposes
    # per-rank snapshot staleness, and /trace/units serves the
    # fleet-wide journey store. Armed only when ops_port is configured.
    SS_OBS_SYNC = enum.auto()

    # elastic membership (adlb_tpu_torch/runtime/membership.py; no reference
    # analogue — upstream fixes every role at ADLB_Init):
    # FA_MEMBER — joiner (provisional id) -> MASTER: attach an app rank
    # or a scale-out server (kind="app"|"server", + listener host/port
    # on TCP fabrics); member rank -> master: clean detach. The master
    # allocates rank id + home under a fresh fleet epoch and answers
    # only after every live server acked the fan-out.
    FA_MEMBER = enum.auto()
    TA_MEMBER_RESP = enum.auto()
    # SS_MEMBER — the membership fan-out/control plane, epoch-stamped:
    # mop="attach"/"detach"/"server_join" (apply + ack toward the
    # master), "ack" (barrier), "ready" (new shard's reactor is up),
    # "rebalance" (master -> donor: ship backlog to the new shard over
    # the acked migration plane), "server_drain" (master -> all: rank S
    # is draining; S itself force-bootstraps a full replication stream
    # to its buddy, flushes, announces "drain_done", and exits — the
    # buddy promotes a COMPLETE mirror, so scale-in counts no losses)
    SS_MEMBER = enum.auto()

    # server failover (Config(on_server_failure="failover"); no reference
    # analogue — upstream's servers ARE the pool and a server death kills
    # the job, SURVEY §5):
    # SS_REPL — a server's asynchronous replication-log flush to its
    # ring-successor buddy: packed pool-mutation entries in the
    # checkpoint.py unit wire format (adlb_tpu_torch/runtime/replica.py)
    SS_REPL = enum.auto()
    # SS_SERVER_DEAD — fan-out when a server's connection EOFs mid-run:
    # survivors prune the dead server from rings/gossip/plans, and its
    # buddy replays the replication log and takes over home-server duty
    SS_SERVER_DEAD = enum.auto()
    # TA_HOME_TAKEOVER — buddy -> app ranks: epoch-stamped remap (dead
    # server -> this server); clients reroute handles, common fetches,
    # round-robin puts, and their home-server traffic. When the dead
    # server was the MASTER the note also carries new_master (the
    # promoted deputy), so clients re-point job control and detach.
    TA_HOME_TAKEOVER = enum.auto()
    # SS_MASTER_TAKEOVER — promoted deputy -> servers: epoch-stamped
    # master succession (new_master, epoch, the rebound ops endpoint's
    # host/port) behind a member_tok ack barrier; exhaustion/END
    # verdicts defer until the barrier resolves so no termination
    # verdict races the succession. Append-only wire tag (1142).
    SS_MASTER_TAKEOVER = enum.auto()

    # balancer (TPU path; no reference analogue — replaces qmstat+RFR)
    SS_STATE = enum.auto()
    SS_STATE_DELTA = enum.auto()  # new task(s) appended to last snapshot
    # (single-unit fields, or batched parallel lists)
    SS_HUNGRY = enum.auto()  # master -> servers: parked requesters exist
    SS_PLAN_MATCH = enum.auto()
    SS_PLAN_MIGRATE = enum.auto()  # planner: move these units to dest
    SS_MIGRATE_WORK = enum.auto()  # holder -> dest: the moved units
    SS_MIGRATE_ACK = enum.auto()  # dest -> holder: units landed (or bounced)

    # checkpoint/resume (no reference analogue — the reference has no pool
    # serialization at all, SURVEY §5; this framework adds it): a client
    # asks its home server, the master circulates a ring token, every
    # server writes its shard, the origin client gets an ack with counts
    FA_CHECKPOINT = enum.auto()
    TA_CHECKPOINT_RESP = enum.auto()
    SS_CHECKPOINT = enum.auto()

    # app <-> app (the reference's app_comm: ADLB_Init hands back a
    # communicator on which app ranks exchange ordinary point-to-point
    # messages, e.g. c1.c's TAG_B_ANSWER answer flow; here the same fabric
    # carries them, tagged AM_APP with a user tag inside)
    AM_APP = enum.auto()

    # debug server
    DS_LOG = enum.auto()
    DS_END = enum.auto()

    # transport-internal, TCP-carried: a rank that just attached a
    # shared-memory ring toward the receiver announces it here (one
    # frame per pair, before any ring traffic). The TCP reader records
    # the sender and swallows the frame — roles never see it — so the
    # connection it rides becomes the pair's death sentinel: a SIGKILLed
    # shm peer EOFs this socket, and the existing PEER_EOF machinery
    # (reclaim, failover, takeover) works unchanged over the ring fabric.
    SHM_HELLO = enum.auto()

    # transport-internal (never on the wire): a peer's connection hit EOF.
    # The reference's failure model is "any rank failure kills the job"
    # (MPI_Abort paths, reference src/adlb.c:2508-2526); over TCP the
    # analogous signal is an app connection closing before LOCAL_APP_DONE.
    PEER_EOF = enum.auto()


@dataclasses.dataclass
class Msg:
    tag: Tag
    src: int
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["data"][name]
        except KeyError:
            raise AttributeError(name) from None


def msg(tag: Tag, src: int, **data: Any) -> Msg:
    return Msg(tag=tag, src=src, data=data)
