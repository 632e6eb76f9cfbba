"""World topology and run configuration.

Role layout matches the reference (reference ``src/adlb.c:238-283``): given W
ranks and S servers, ranks ``0..W-S-1`` (minus an optional trailing debug
server) are app ranks, the next S are servers, and the optional last rank is
the debug-server watchdog. Each app rank has a static *home server*
``num_app_ranks + (rank % nservers)`` (reference ``src/adlb.c:257``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    nranks: int
    nservers: int
    types: tuple[int, ...]
    use_debug_server: bool = False

    def __post_init__(self) -> None:
        if self.nservers < 1:
            raise ValueError("need at least one server rank")
        extra = 1 if self.use_debug_server else 0
        if self.nranks < self.nservers + extra + 1:
            raise ValueError("need at least one app rank")
        if len(set(self.types)) != len(self.types):
            raise ValueError("duplicate work types")

    @property
    def num_app_ranks(self) -> int:
        return self.nranks - self.nservers - (1 if self.use_debug_server else 0)

    @property
    def master_server_rank(self) -> int:
        return self.num_app_ranks

    @property
    def server_ranks(self) -> range:
        return range(self.num_app_ranks, self.num_app_ranks + self.nservers)

    @property
    def app_ranks(self) -> range:
        return range(self.num_app_ranks)

    @property
    def debug_server_rank(self) -> Optional[int]:
        return self.nranks - 1 if self.use_debug_server else None

    def is_server(self, rank: int) -> bool:
        return rank in self.server_ranks

    def is_app(self, rank: int) -> bool:
        return rank < self.num_app_ranks

    def home_server(self, app_rank: int) -> int:
        return self.num_app_ranks + (app_rank % self.nservers)

    def local_apps(self, server_rank: int) -> list[int]:
        """App ranks homed at this server."""
        return [r for r in self.app_ranks if self.home_server(r) == server_rank]

    def ring_next(self, server_rank: int) -> int:
        """Server ring successor (reference rhs_rank, ``src/adlb.c:272-283``),
        used by the termination/exhaustion token passes — and, under
        ``on_server_failure="failover"``, the replication **buddy**: each
        server streams its pool-mutation log to its ring successor."""
        i = server_rank - self.num_app_ranks
        return self.num_app_ranks + (i + 1) % self.nservers

    def validate_type(self, work_type: int) -> bool:
        return work_type in self.types


@dataclasses.dataclass
class Config:
    """Run-time knobs. The reference exposes these as ADLB_Init/Server
    arguments and compile-time constants (reference ``src/adlb.c:93-96,165``;
    ``USERGUIDE.txt:96-130``)."""

    # "steal" = reference-style heuristics (qmstat gossip + RFR pull + memory
    # push); "tpu" = periodic batched global assignment solve (the name is
    # the JAX package's; in this port the solve runs on `device`).
    balancer: str = "steal"
    # where the planned balancer's device solve runs: "cuda" (the
    # greedy-sweep kernel; a tpu-mode world without a card raises) or
    # "cpu" (its plain torch version — tests and CPU-only hosts)
    device: str = "cuda"

    max_malloc_per_server: float = 0.0  # 0 = unlimited (reference hi_malloc)
    qmstat_interval: float = 0.05  # reference 0.1 s (src/adlb.c:165)
    # qmstat propagation: "broadcast" sends each server's entry directly to
    # every peer each interval (this framework's improvement); "ring" is the
    # reference-faithful store-and-forward token pass — the master kicks one
    # token per interval, each server overwrites the table except its own
    # entry and forwards (reference src/adlb.c:806-822,1705-1757), so the
    # k-th hop sees k-hop-stale state. Use "ring" + 0.1 s to reproduce
    # upstream's behavior as a baseline.
    qmstat_mode: str = "broadcast"
    # steal/broadcast mode only: when an untargeted put makes a type's
    # advertised inventory go empty->nonempty, broadcast a fresh qmstat
    # immediately (rate-limited to one event broadcast per this many
    # seconds) instead of waiting out the periodic tick — the trickle
    # dispatch-latency fix. 0 disables the event path. Ring mode stays
    # upstream-faithful (interval-only) regardless.
    qmstat_event_gap: float = 0.005
    balancer_interval: float = 0.02  # TPU-mode snapshot->solve->plan period
    # min gap between event-driven solves (a park triggers an immediate
    # snapshot+solve; this bounds solve rate under churn)
    balancer_min_gap: float = 0.002
    # the balancer worker is event-gated: it sleeps on its doorbell
    # (armed by puts, requester parks and qmstat deltas) and only falls
    # back to this slow insurance tick when no work signal arrives —
    # an idle world pays ~4 ticks/s instead of 50 (the 20 ms tick was
    # 8.3% of single-core samples on the tsp parity bench). 0 disables
    # the insurance tick entirely (pure event-driven; not recommended)
    balancer_idle_interval: float = 0.25
    # untargeted put routing: "round_robin" spreads over servers (reference
    # src/adlb.c:2771-2773); "home" keeps work at the putter's home server
    # (data locality; relies on the balancer to redistribute)
    put_routing: str = "round_robin"
    exhaust_check_interval: float = 0.25  # reference 5 s (src/adlb.c:754-785)
    periodic_log_interval: float = 0.0  # 0 = off
    debug_log_interval: float = 1.0  # DS_LOG cadence (src/adlb.c:842-854)
    debug_server_timeout: float = 30.0
    # debug server's aggregate-print cadence (the reference prints per
    # minute, src/adlb.c:2569-2610); 0 disables the prints
    debug_print_interval: float = 60.0
    put_max_retries: int = 10  # reference retry loop (src/adlb.c:2779-2796)
    # retry pacing: capped exponential backoff with decorrelated jitter
    # (replacing the reference's fixed-interval spin, src/adlb.c:2779-2796):
    # sleep_k ~ U(put_retry_sleep, 3*sleep_{k-1}), capped at put_retry_cap
    put_retry_sleep: float = 0.002  # backoff base (first retry's floor)
    put_retry_cap: float = 0.25  # backoff ceiling per attempt
    # bounded client-side send retries when a peer connection breaks
    # mid-run (network churn): the endpoint already retries once; beyond
    # that the client backs off and re-sends instead of dying on the
    # first OSError. 0 = fail fast (pre-reclaim behaviour).
    reconnect_attempts: int = 4
    # client-side batch-common prefix cache (LRU over (common_server,
    # common_seqno) -> bytes): members of a batch inline only their
    # suffix and the prefix is fetched once per client instead of once
    # per unit; cache hits send an SS_COMMON_FORFEIT accounting note so
    # server refcounts (and prefix GC) stay exact. 0 disables caching
    # (every prefixed unit pays the fetch, as the reference does).
    prefix_cache_bytes: int = 16 << 20
    # worker (app rank) failure policy: "abort" preserves the reference's
    # rank-death-kills-job semantics (MPI_Abort paths, src/adlb.c:2508-2526);
    # "reclaim" survives it — the home server fans out SS_RANK_DEAD, every
    # server re-enqueues the dead rank's leased-but-unfetched units, drops
    # its rq entries and targeted work (refcount-correct common release),
    # and termination counting excludes the rank. Server death aborts
    # under both policies (checkpoint/restore is the recovery path).
    on_worker_failure: str = "abort"
    # server failure policy: "abort" preserves the reference's
    # server-death-kills-world semantics; "failover" survives the death of
    # a NON-master server — every server asynchronously streams a
    # replication log of its pool mutations to its ring-successor buddy
    # (adlb_tpu_torch/runtime/replica.py, SS_REPL frames in the checkpoint.py
    # unit wire format); on a server's EOF the survivors fan out
    # SS_SERVER_DEAD, the buddy replays the log into its own queues and
    # takes over home-server duty for the dead server's app ranks, and
    # clients learn the epoch-stamped remap via TA_HOME_TAKEOVER.
    # Replication-lag losses are bounded and counted (failover_lost /
    # InfoKey.FAILOVER_LOST). The MASTER is covered too: its ring buddy
    # is a standing deputy — the master streams its brain (job table,
    # membership snapshot + fleet epoch, live SLO objectives, control
    # policy, parked scale requests, per-job weights) over the same
    # replication plane, and on the master's death the deputy promotes
    # under a bumped epoch, fans SS_MASTER_TAKEOVER behind an ack
    # barrier, rebinds the ops endpoint, and resumes termination duty
    # with exact unit accounting. A buddy dying before its promotion
    # completes (the double failure) still aborts. Requires
    # server_impl="python"; inert when nservers == 1.
    on_server_failure: str = "abort"
    # how long a client waits for the buddy's TA_HOME_TAKEOVER after
    # losing a server connection before declaring the world dead
    # (failover policy only)
    failover_client_wait: float = 15.0
    # gray-failure detection: a lease (reserved-but-unfetched unit) whose
    # owner has neither sent traffic nor heartbeated for this long is
    # EXPIRED — the unit re-enqueues under a fresh attempt and the old
    # owner is FENCED for it (its late Get_reserved answers ADLB_FENCED;
    # clients map that onto the ADLB_RETRY path). Clients arm a liveness
    # heartbeat (FA_HEARTBEAT at timeout/3 cadence to every server) while
    # this is set; a rank silent for 2x the timeout is declared hung by
    # its home server (declared dead under "reclaim", world abort under
    # "abort" — bounded detection either way; a SIGSTOP'd worker EOFs
    # nothing, so without this the world hangs forever). 0 = off
    # (reference semantics: a hung owner holds its leases forever).
    # CAVEAT: armed expiry makes delivery at-least-once for exactly the
    # expired-lease window (the fenced owner may have fetched the
    # payload before stalling); fencing guarantees no double-SETTLE, not
    # no double-execution. Python clients only (the C client does not
    # heartbeat — a busy native rank would be misread as hung).
    lease_timeout_s: float = 0.0
    # retry budget per unit: a unit whose delivery failed (owner death
    # reclaim, lease expiry, undeliverable response) more than this many
    # times is moved to the per-server dead-letter QUARANTINE instead of
    # the queue — bounded blast radius for a poison unit that crashes
    # every worker it touches. Counted exactly-once
    # (InfoKey.QUARANTINED / WorldResult.quarantined, surviving
    # failover), settled for exhaustion voting, retrievable via
    # ctx.get_quarantined() and the ops endpoint /deadletter.
    # 0 = unlimited retries (reference-faithful: reclaim re-enqueues
    # forever).
    max_unit_retries: int = 0
    # tail hedging (runtime/hedge.py): when > 0 the home server
    # speculatively re-dispatches a leased-but-unfetched unit whose age
    # crossed the live per-(job, type) p99 threshold the master gossips
    # (SS_OBS_SYNC `thr`) — or whose lease holder shows a stall
    # signature (the shared obs/slo.py suspect heuristic) — to a parked
    # requester on a DIFFERENT rank. First terminal wins and closes the
    # books exactly once; every losing sibling is fenced through the
    # (seqno, owner) machinery, so the at-least-once window stays
    # exactly the documented lease-expiry one. The value doubles as the
    # per-job token-bucket refill per delivered unit: launches are
    # bounded by ~frac x deliveries (+ a small burst) by construction,
    # and any backpressure signal (memory watermark, job quota,
    # allocation failure) vetoes a launch stickily — hedging always
    # yields to overload. Requires lease_timeout_s > 0 (the trigger
    # scans the lease table; fencing IS the lease machinery). 0 = off:
    # frame-identical to an unhedged world.
    hedge_budget_frac: float = 0.0
    # age floor (ms) below which a unit is never hedged regardless of
    # threshold or suspicion — cold-start p99 noise must not burn the
    # budget on units that are not stragglers yet
    hedge_min_age_ms: float = 100.0
    # memory watermarks (fractions of max_malloc_per_server): above SOFT
    # the server engages memory-pressure pushes (the reference's
    # THRESHOLD_TO_START_PUSH, src/adlb.c:93 — 0.95 there and here) and
    # reports the mem_pressure gauge; above HARD with no peer believed to
    # have room, puts answer ADLB_BACKOFF with a retry-after hint that
    # feeds the client's decorrelated-jitter backoff (not burning its
    # retry budget), so an overloaded fleet sheds load instead of
    # aborting producers on malloc exhaustion. mem_hard_frac 0 = off
    # (reference behavior: ADLB_PUT_REJECTED hopping until retries
    # exhaust).
    mem_soft_frac: float = 0.95
    mem_hard_frac: float = 0.0
    # seeded deterministic fault injection (adlb_tpu_torch/runtime/faults.py):
    # a plain-data spec dict {seed, drop, delay, delay_s, duplicate,
    # disconnect_at: {rank: frame}, kill_at_frame: {rank: frame},
    # kill_at: {rank: seconds}, ranks: [..], log_dir}. None = off.
    fault_spec: Optional[dict] = None
    # Max queued tasks & waiting requesters per server in one balancer
    # snapshot (fixed shapes for the jitted solve).
    balancer_max_tasks: int = 256
    balancer_max_requesters: int = 64
    # ---- multi-job planning (balancer/jobdim.py) ----
    # how many job namespaces the tpu balancer plans: 1 (default)
    # reproduces the historical job-0-only planner exactly — same
    # shapes, same compiled programs, same pairs — with non-default
    # jobs riding the qmstat RFR fallback; > 1 widens the solver's
    # type axis to max_jobs * len(types) composite (job, type) slots
    # so every namespace below the cap is planned (jobs at or above
    # the cap keep the fallback). Auto-raised to cover job_weights.
    balancer_max_jobs: int = 1
    # per-job weights/shares folded into the assignment score as an
    # int32-safe priority bias (eff_prio = clip(prio) + (w-1)*1e6,
    # see balancer/jobdim.py): {job_id: weight}, 1.0 = neutral. A
    # heavier tenant outranks a lighter one at equal native priority
    # without letting priorities cross job isolation — weights are
    # shares, priorities stay the intra-job ordering. Live updates
    # ride POST /jobs/<id> {"weight": w}. None = all jobs neutral.
    job_weights: Optional[dict] = None
    # Adaptive migration-pump knobs (balancer/engine.py): a server holding
    # >= lookahead ready units per local consumer is never
    # migration-deficient; a destination that re-triggers its deficit
    # within grow_window seconds of the last shipped batch has its
    # per-consumer window doubled (capped at look_max); in-flight batch
    # credits survive at least inflow_min_age seconds and at most
    # inflow_ttl. None = engine defaults.
    balancer_lookahead: "Optional[int]" = None
    balancer_look_max: "Optional[int]" = None
    balancer_grow_window: "Optional[float]" = None
    balancer_inflow_ttl: "Optional[float]" = None
    balancer_inflow_min_age: "Optional[float]" = None
    # device solve implementation: "auto" (the only one) = the greedy-sweep
    # kernel on device="cuda", its plain torch version on device="cpu"
    solver_backend: str = "auto"
    # parked-requester count below which the solve stays on the numpy host
    # path (a device dispatch round-trip would dominate); None = solver
    # default. Set very high when the balancer host has no local
    # accelerator (e.g. a CPU-only sidecar).
    solver_host_threshold: "Optional[int]" = None
    # "auto" = when more than one device is visible, cut the balancer's
    # task table into one shard per device (balancer/distributed.py); on
    # one card (or device="cpu") the single-device solver plans, as the
    # JAX package does on one chip; "off" = single-device solve
    balancer_mesh: str = "off"
    # auction tier of the sharded solver (balancer/distributed.py):
    # "device" runs candidates + merge + auction rounds on the device, the
    # rounds as one launch of the auction kernel (no per-round host
    # merge); "host" is the retained reference twin the device tier is
    # fuzz-proven exactly equal to. Only consulted when the sharded
    # solver is active (balancer_mesh="auto" with more than one device)
    balancer_auction: str = "device"
    # host tier of the plan engine (balancer/ledger.py): "array" keeps
    # parked requesters / snapshot tasks resident in numpy columns so
    # round admission costs O(changed rows); "py" is the pure-Python
    # twin (exact reference semantics, fuzz-proven identical — an
    # escape hatch, not a feature switch)
    host_ledger: str = "array"
    trace: bool = False  # event tracing hooks (reference MPE shims);
    # since the obs unification this traces BOTH sides: client API spans
    # (pid 0) and server handler / balancer-round spans (pid 1) into one
    # merged Chrome-trace stream
    # unit-lifecycle tracing (adlb_tpu_torch/obs/journey.py): head-sampling
    # probability at put — a sampled unit's FA_PUT carries a trace id
    # (codec field 98) and every server it crosses appends
    # (stage, rank, t) spans until a terminal event closes the journey
    # (per-stage latency histograms + /trace/units on the master's ops
    # endpoint). 0 disables it entirely: no wire field, no allocations
    # on the put path — trace_sample=0 worlds are frame-identical to
    # pre-trace builds. Sampling decisions come from a dedicated
    # per-rank seeded RNG, so they are reproducible and never perturb
    # the retry-jitter stream.
    trace_sample: float = 0.01
    # tail-based journey promotion (the head-vs-tail sampling gap fix,
    # obs/journey.py): "auto" arms it whenever the ops endpoint is
    # configured (ops_port is not None) — an observed world captures its
    # p99 by construction; "on"/"off" force it. Armed, EVERY put
    # accumulates spans (server-minted negative trace ids; the put wire
    # stays byte-identical — nothing new rides FA_PUT) and the terminal
    # close decides retention: head-sampled as before, anomalous
    # terminals (quarantined/dropped/lost/expired-lease) always, and
    # clean deliveries only when their total latency exceeds the live
    # fleet per-(job,type) p99 (threshold gossiped back on SS_OBS_SYNC
    # replies; hysteresis: arms at TAIL_MIN_COUNT closes per cell).
    # Promoted journeys serve on the master's /trace/tails.
    trace_tail: str = "auto"
    # continuous sampling profiler (obs/profile.py): per-process
    # folded-stack sampler at this many Hz walking sys._current_frames()
    # into role/phase-keyed collapsed stacks, delta-gossiped over
    # SS_OBS_SYNC; the master serves the merged fleet profile at
    # /profile. 0 = off (no thread at all); 19 Hz recommended (prime —
    # cannot phase-lock the balancer/qmstat cadences).
    profile_hz: float = 0.0
    # fleet metrics plane: non-master servers gossip delta-encoded
    # registry snapshots (changed counters/gauges/histograms, cumulative
    # values) plus their closed journeys to the master every this many
    # seconds, so the master's /metrics serves a merged FLEET view and
    # /healthz exposes per-rank snapshot staleness. Armed only when the
    # ops endpoint is configured (ops_port is not None) — worlds without
    # an observer pay zero gossip traffic. 0 disables the plane.
    obs_sync_interval: float = 1.0
    # Flight-recorder JSON artifacts: directory for per-rank post-mortem
    # dumps on abort / watchdog timeout / lost home server. None defers
    # to the ADLB_FLIGHT_DIR env var; unset = text dumps only
    # (adlb_tpu_torch/obs/flight.py; summarize with scripts/obs_report.py).
    flight_dir: Optional[str] = None
    # Declarative SLO objectives (obs/slo.py), evaluated by the MASTER
    # each obs tick against the merged fleet registry: a tuple of dicts,
    # each e.g. {"job": 0, "type": 3, "p99_ms": 50, "error_frac": 0.001,
    # "window_s": 300} (at least one of p99_ms / error_frac; window_s is
    # the slow burn window — the fast one defaults to window_s/12).
    # None/empty = no evaluation; objectives can also be added to a live
    # world via POST /slo. Requires ops_port (the alert surfaces are
    # ops routes) and obs_sync_interval > 0 (the merged view is the
    # gossip plane's product).
    slo: Optional[tuple] = None
    # SLO evaluation cadence in seconds; 0 (default) evaluates on every
    # obs-sync tick — the natural cadence, since that is when fresh
    # fleet snapshots arrive.
    slo_eval_interval: float = 0.0
    # ---- closed-loop controller (adlb_tpu_torch/control/) ----
    # the fleet brain: a MASTER-side policy loop riding the obs tick
    # (like the SLO engine) that watches the merged registry + alert
    # table (mem_pressure, put_backoff, per-job depth/age, FIRING
    # alerts) and drives the existing actuators — server scale-out/in
    # through the membership plane and per-tenant throttling through
    # job quotas — under explicit hysteresis (per-action cooldowns,
    # min/max bounds, epoch-churn hold). False = no controller thread,
    # no counters, frame-identical to a pre-controller world. Requires
    # obs_sync_interval > 0 (the merged view is the gossip plane's
    # product) and server_impl="python".
    control: bool = False
    # controller evaluation cadence; 0 = every obs-sync tick
    control_interval: float = 0.0
    # log decisions (visible at GET /control) without acting
    control_dry_run: bool = False
    # fleet-size bounds the controller must respect; max 0 = unbounded
    control_min_servers: int = 1
    control_max_servers: int = 0
    # per-action cooldown: after the controller acts (scale/throttle),
    # the same action class is held for this long — a flapping metric
    # produces at most one action per window
    control_cooldown_s: float = 10.0
    # fleet max mem_pressure above which the controller requests a
    # scale-out (and considers throttling the heaviest non-default
    # tenant), and below which — held for a full cooldown window with
    # idle queues — it drains the newest shard back in
    control_scaleout_pressure: float = 0.85
    control_scalein_pressure: float = 0.30
    # Live ops endpoint on the MASTER server: serves /metrics (registry
    # exposition + last STAT_APS world aggregate), /healthz, and /dump
    # (flight-record snapshot) on 127.0.0.1:<ops_port>. None = off;
    # 0 = ephemeral port (the bound port is aprintf-logged and exposed
    # as Server.ops.port). Enable periodic_log_interval for the
    # world-aggregated rows.
    ops_port: Optional[int] = None
    # ops-endpoint rendezvous directory: when set, the serving master
    # atomically writes <dir>/ops_endpoint.json ({"host","port","master",
    # "epoch"}) at startup AND after a master failover rebinds the
    # endpoint on an ephemeral port — external scrapers re-discover the
    # promoted deputy's /metrics without parsing logs. None = off.
    ops_announce_dir: Optional[str] = None
    # restore pool state from checkpoint shards written by ctx.checkpoint()
    # (no reference analogue — SURVEY §5: checkpoint/resume absent there);
    # requires the same world shape the checkpoint was taken with
    restore_path: Optional[str] = None
    # ---- durable service mode (adlb_tpu_torch/runtime/wal.py) ----
    # per-server write-ahead log directory: every pool mutation (the
    # replica op stream, OP_PUT..OP_JOB) is teed to an append-only
    # crc-framed log at <wal_dir>/server.<rank>.log; put acks are held
    # for the group commit that makes their entries durable, so an
    # ACKED put always survives a cold restart (shard-load + replay at
    # server init). None = off (reference semantics: a dead fleet loses
    # the pool). Python servers only.
    wal_dir: Optional[str] = None
    # group-commit window in milliseconds: fsync at most once per
    # window, releasing the put acks the commit covers. 0 = fsync every
    # reactor flush (strict, per-batch durability at per-batch fsync
    # cost). Durability/latency trade-off table in USERGUIDE §10.
    wal_fsync_ms: float = 5.0
    # compaction threshold: when the live segment outgrows this, the
    # server snapshots its pool into the ACK2 checkpoint shard format
    # and starts a fresh segment headed by the seqno manifest. 0 = never
    # compact (the log grows for the fleet's lifetime).
    wal_max_bytes: int = 64 << 20
    # legacy ACK1 (pre-header) checkpoint shards: WAL compaction writes
    # ACK2 only, and silently accepting a headerless shard means
    # silently skipping the world-shape check that keeps targeted units
    # routable — so ACK1 reads now fail LOUDLY unless this flag opts
    # back in (old native daemons' shards; serverd.cpp still writes and
    # validates ACK2 itself).
    allow_legacy_shards: bool = False
    # ops endpoint payload truncation: how many payload bytes /deadletter
    # (and other ops views) hex-encode per record before cutting off.
    # The full payload stays retrievable in-band via ctx.get_quarantined().
    ops_dump_bytes: int = 256
    aprintf_flag: bool = False  # stamped debug prints (src/adlb.c:3395-3417)
    # queue-depth gauge / timeline sampling cadence on the reactor tick
    # (floored at the state-sync interval): decoupled from the 20 ms
    # tpu-mode balancer tick, whose per-tick gauge walk was a measured
    # slice of the tpu-mode pop-latency drift
    gauge_interval: float = 0.25
    selfdiag_interval: float = 30.0  # server health dumps; 0 = off
    # (src/adlb.c:558-710; the reference hard-codes 30 s)
    selfdiag_stuck_after: float = 5.0  # rq age that counts as "stuck"
    # server work-queue implementation: "auto" uses the C++ core when it
    # builds, falling back to the pure-Python queues; "on" requires it
    native_queues: str = "auto"
    # process-world transport fabric (spawn_world / launch.py / joined
    # clients; in-proc thread worlds always use the queue fabric):
    # "auto" upgrades same-host rank pairs to the shared-memory ring
    # fabric (adlb_tpu_torch/runtime/transport_shm.py) whenever the host can
    # run it (honoring the ADLB_FABRIC env override — the CI shm leg's
    # hook), with cross-host pairs staying on TCP; "shm" forces the ring
    # fabric (same-host pairs only — others still fall back to TCP);
    # "tcp" disables the upgrade entirely.
    fabric: str = "auto"
    # per-direction ring capacity per connected pair; frames larger than
    # the ring stream through it, so this bounds /dev/shm footprint
    # (pairs x 2 x this), not payload size. 1 MiB keeps a 2 MiB payload
    # to two backpressure cycles while a 16-app/4-server world still
    # maps under 150 MiB of (reclaimable) tmpfs
    shm_ring_bytes: int = 1 << 20
    # ---- disk spill tier (adlb_tpu_torch/runtime/spill.py) ----
    # directory for the per-server payload spill file: above the spill
    # watermark, cold/large parked payloads move to disk (crc-framed,
    # the WAL's record format) and fault back in transparently at
    # delivery time — memory pressure degrades to slower-fetch instead
    # of ADLB_BACKOFF/ADLB_PUT_REJECTED. None = off (reference
    # semantics). Python servers only.
    spill_dir: Optional[str] = None
    # fraction of max_malloc_per_server above which spilling engages;
    # 0 = track mem_soft_frac (the soft memory watermark)
    spill_watermark_frac: float = 0.0
    # wire-codec implementation for TLV frames (native peers, shm rings,
    # mux'd channels): "auto" uses the compiled C core
    # (adlb_tpu_torch/native/codec.cpp) whenever it builds, falling back to
    # the pure-Python twin; "c" requires it (no silent fallback); "py"
    # forces the Python twin. Selected per-process at world start; the
    # ADLB_CODEC env var sets the import-time default the same way.
    codec: str = "auto"
    # ---- multiplexed cross-host channels (adlb_tpu_torch/runtime/channel.py) ----
    # "auto" rides per-pair TCP today (single-host worlds lose latency
    # on the mux's two hops; engaging it automatically for multi-host
    # fleets — the O(hosts^2)-not-O(ranks^2) socket regime — awaits the
    # launcher's broker publication, ROADMAP item 5); "on" forces the
    # channel plane and requires a harness that runs a broker
    # (spawn_world today; the rendezvous launcher / join_world reject
    # it loudly rather than silently running per-pair) — also
    # forceable via ADLB_TCP_MUX=1 (the CI leg's hook); "off" pins
    # per-pair TCP.
    tcp_mux: str = "auto"
    # compress DATA-envelope bodies at least this large on the channel
    # plane (zlib level 1, flag bit 0 of the envelope header; the
    # receiver inflates before frame decode). 0 = off.
    compress_min_bytes: int = 0
    # elastic scale-out trigger (adlb_tpu_torch/runtime/membership.py):
    # "auto" lets the MASTER request a new server shard when any live
    # server crosses the soft memory watermark — capacity is added
    # BEFORE the spill tier or ADLB_BACKOFF backpressure engage (needs
    # max_malloc_per_server > 0 and a registered member spawner; without
    # a spawner the request parks, visible at /fleet, feeding the
    # future autoscaler). "off" = manual scale only (ops POST
    # /fleet/scale or the harness verbs). Attach/detach and manual
    # scaling are always available on python servers regardless.
    elastic_scaleout: str = "off"
    # cooldown between watermark-triggered scale-out requests
    elastic_cooldown_s: float = 10.0
    # server reactor implementation (spawn_world / TCP worlds only):
    # "python" runs adlb_tpu_torch.runtime.server.Server per server rank; "native"
    # runs the C++ daemon (adlb_tpu_torch/native/serverd.cpp) — the reference's
    # all-native data plane (SURVEY §7 language split). With
    # balancer="tpu", native servers stream snapshots to a Python/JAX
    # balancer sidecar process (adlb_tpu_torch/balancer/sidecar.py) and enact its
    # plan; with "steal" they run the heuristics natively.
    server_impl: str = "python"

    def __post_init__(self) -> None:
        if self.balancer not in ("steal", "tpu"):
            raise ValueError(f"unknown balancer mode {self.balancer!r}")
        if self.put_routing not in ("round_robin", "home"):
            raise ValueError(f"unknown put routing {self.put_routing!r}")
        if self.native_queues not in ("auto", "on", "off"):
            raise ValueError(f"unknown native_queues {self.native_queues!r}")
        if self.solver_backend != "auto":
            raise ValueError(f"unknown solver_backend {self.solver_backend!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")
        if self.balancer == "tpu" and self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "balancer='tpu' with device='cuda' needs a CUDA device; "
                    "pass device='cpu' to plan with the plain torch version"
                )
        if self.host_ledger not in ("array", "py"):
            raise ValueError(f"unknown host_ledger {self.host_ledger!r}")
        if self.server_impl not in ("python", "native"):
            raise ValueError(f"unknown server_impl {self.server_impl!r}")
        if self.elastic_scaleout not in ("off", "auto"):
            raise ValueError(
                f"unknown elastic_scaleout {self.elastic_scaleout!r}"
            )
        if self.elastic_scaleout == "auto" and self.server_impl == "native":
            # the C++ daemon keeps the reference's fixed-at-init world
            raise ValueError(
                "elastic_scaleout='auto' requires server_impl='python'"
            )
        if self.elastic_cooldown_s < 0:
            raise ValueError("elastic_cooldown_s must be >= 0")
        if self.qmstat_mode not in ("broadcast", "ring"):
            raise ValueError(f"unknown qmstat_mode {self.qmstat_mode!r}")
        if self.fabric not in ("auto", "shm", "tcp"):
            raise ValueError(f"unknown fabric {self.fabric!r}")
        if self.codec not in ("auto", "c", "py"):
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.tcp_mux not in ("auto", "on", "off"):
            raise ValueError(f"unknown tcp_mux {self.tcp_mux!r}")
        if self.compress_min_bytes < 0:
            raise ValueError("compress_min_bytes must be >= 0")
        if self.shm_ring_bytes < 4096:
            raise ValueError("shm_ring_bytes must be >= 4096")
        if not (0.0 <= self.spill_watermark_frac <= 1.0):
            raise ValueError("spill_watermark_frac must be in [0, 1]")
        if self.spill_dir is not None and self.server_impl == "native":
            # the C++ daemon has no spill store; its capacity story is
            # the reference admission control only
            raise ValueError("spill_dir requires server_impl='python'")
        if self.spill_dir is not None and self.native_queues == "on":
            # the spill tier swaps payload residency in place, which the
            # C++ queue core cannot express; an explicit 'on' must fail
            # loudly rather than silently losing the native core
            raise ValueError(
                "spill_dir requires the Python work queue "
                "(native_queues='auto' or 'off')"
            )
        if self.on_worker_failure not in ("abort", "reclaim"):
            raise ValueError(
                f"unknown on_worker_failure {self.on_worker_failure!r}"
            )
        if self.on_server_failure not in ("abort", "failover"):
            raise ValueError(
                f"unknown on_server_failure {self.on_server_failure!r}"
            )
        if self.on_worker_failure == "reclaim" and self.server_impl == "native":
            # the C++ daemon implements the reference fault model only;
            # failing here beats a world that silently aborts anyway
            raise ValueError(
                "on_worker_failure='reclaim' requires server_impl='python'"
            )
        if self.on_server_failure == "failover" and self.server_impl == "native":
            # the C++ daemon has no replication stream or takeover protocol
            raise ValueError(
                "on_server_failure='failover' requires server_impl='python'"
            )
        if self.failover_client_wait <= 0:
            raise ValueError("failover_client_wait must be > 0")
        if self.lease_timeout_s < 0:
            raise ValueError("lease_timeout_s must be >= 0")
        if self.lease_timeout_s > 0 and self.server_impl == "native":
            # the C++ daemon has no lease table, heartbeat intake, or
            # fence bookkeeping
            raise ValueError(
                "lease_timeout_s > 0 requires server_impl='python'"
            )
        if self.max_unit_retries < 0:
            raise ValueError("max_unit_retries must be >= 0")
        if self.max_unit_retries > 0 and self.server_impl == "native":
            raise ValueError(
                "max_unit_retries > 0 requires server_impl='python'"
            )
        if not (0.0 <= self.hedge_budget_frac <= 1.0):
            raise ValueError("hedge_budget_frac must be in [0, 1]")
        if self.hedge_min_age_ms < 0:
            raise ValueError("hedge_min_age_ms must be >= 0")
        if self.hedge_budget_frac > 0 and self.server_impl == "native":
            # the C++ daemon has no lease table or hedge bookkeeping
            raise ValueError(
                "hedge_budget_frac > 0 requires server_impl='python'"
            )
        if self.hedge_budget_frac > 0 and self.lease_timeout_s <= 0:
            # the trigger scans the lease table and the loser's fence
            # is the lease-expiry fence — unarmed leases mean neither
            raise ValueError(
                "hedge_budget_frac > 0 requires lease_timeout_s > 0"
            )
        if not (0.0 < self.mem_soft_frac <= 1.0):
            raise ValueError("mem_soft_frac must be in (0, 1]")
        if not (0.0 <= self.mem_hard_frac <= 1.0):
            raise ValueError("mem_hard_frac must be in [0, 1]")
        if self.mem_hard_frac > 0 and self.mem_hard_frac < self.mem_soft_frac:
            raise ValueError(
                "mem_hard_frac, when armed, must be >= mem_soft_frac"
            )
        if self.mem_hard_frac > 0 and self.server_impl == "native":
            # the C++ daemon answers capacity with ADLB_PUT_REJECTED only
            raise ValueError(
                "mem_hard_frac > 0 requires server_impl='python'"
            )
        if self.put_retry_cap < self.put_retry_sleep:
            raise ValueError("put_retry_cap must be >= put_retry_sleep")
        if self.reconnect_attempts < 0:
            raise ValueError("reconnect_attempts must be >= 0")
        if self.prefix_cache_bytes < 0:
            raise ValueError("prefix_cache_bytes must be >= 0")
        if self.qmstat_event_gap < 0:
            raise ValueError("qmstat_event_gap must be >= 0")
        if self.ops_port is not None and not (0 <= self.ops_port <= 65535):
            raise ValueError("ops_port must be None or in 0..65535")
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError("trace_sample must be in [0, 1]")
        if self.trace_tail not in ("auto", "on", "off"):
            raise ValueError(f"unknown trace_tail {self.trace_tail!r}")
        if self.profile_hz < 0:
            raise ValueError("profile_hz must be >= 0")
        if self.obs_sync_interval < 0:
            raise ValueError("obs_sync_interval must be >= 0")
        if self.slo_eval_interval < 0:
            raise ValueError("slo_eval_interval must be >= 0")
        if self.slo:
            # structural gate only (cheap, import-free): full
            # normalization happens in obs/slo.py parse_objective at
            # engine creation, where errors carry the objective name
            for o in self.slo:
                if not isinstance(o, dict):
                    raise ValueError("slo entries must be dicts")
                if o.get("p99_ms") is None and o.get("error_frac") is None:
                    raise ValueError(
                        "each slo entry needs p99_ms and/or error_frac")
                if float(o.get("window_s", 0) or 0) <= 0:
                    raise ValueError("each slo entry needs window_s > 0")
        if self.wal_dir is not None and self.server_impl == "native":
            # the C++ daemon has no WAL writer; its durability story is
            # the explicit checkpoint ring only
            raise ValueError("wal_dir requires server_impl='python'")
        if self.wal_dir is not None and self.restore_path is not None:
            # two competing sources of restored pool state would apply
            # in an arbitrary-looking order; pick one
            raise ValueError(
                "wal_dir and restore_path are mutually exclusive (WAL "
                "recovery IS a restore)"
            )
        if self.wal_fsync_ms < 0:
            raise ValueError("wal_fsync_ms must be >= 0")
        if self.wal_max_bytes < 0:
            raise ValueError("wal_max_bytes must be >= 0")
        if self.ops_dump_bytes < 0:
            raise ValueError("ops_dump_bytes must be >= 0")
        # snapshot lists are flattened into binary-codec list fields whose
        # element count is a u16 (4 entries per task, 3+ntypes per
        # requester); keep a wide safety margin under 65535
        for knob in ("balancer_lookahead", "balancer_look_max",
                     "balancer_grow_window", "balancer_inflow_ttl",
                     "balancer_inflow_min_age"):
            v = getattr(self, knob)
            if v is not None and v < 0:
                raise ValueError(f"{knob} must be >= 0")
        # the engine cannot honor a transit floor above the credit TTL
        # (TTL expiry would silently override the min-age guarantee);
        # literals = the engine defaults (balancer/engine.py INFLOW_TTL /
        # INFLOW_MIN_AGE), not imported here to keep Config import-light
        # look_max below the lookahead floor would let _touch_window decay
        # a destination's window under its own floor — with look_max=0 the
        # window (and thus need) pins to 0 and migrations to that
        # destination are silently disabled forever
        look = 8 if self.balancer_lookahead is None \
            else self.balancer_lookahead
        lmax = 512 if self.balancer_look_max is None \
            else self.balancer_look_max
        if lmax < max(1, look):
            raise ValueError(
                "balancer_look_max must be >= max(1, balancer_lookahead)"
            )
        ttl = 2.0 if self.balancer_inflow_ttl is None \
            else self.balancer_inflow_ttl
        age = 0.05 if self.balancer_inflow_min_age is None \
            else self.balancer_inflow_min_age
        if age > ttl:
            raise ValueError(
                "balancer_inflow_min_age must be <= balancer_inflow_ttl"
            )
        if not (0 < self.balancer_max_jobs <= 16):
            # the composite type axis is max_jobs * len(types) solver
            # columns; 16 namespaces keeps the widened axis far from
            # the u16 wire limits and the one-compile shape reasonable
            raise ValueError("balancer_max_jobs must be in 1..16")
        if self.job_weights is not None:
            for j, w in self.job_weights.items():
                if int(j) < 0:
                    raise ValueError("job_weights keys must be >= 0")
                if not (float(w) > 0.0):
                    raise ValueError("job_weights values must be > 0")
            # weights on jobs the planner cannot see would silently do
            # nothing — widen the planning axis to cover them
            hi = max((int(j) for j in self.job_weights), default=0)
            if hi + 1 > self.balancer_max_jobs:
                if hi + 1 > 16:
                    raise ValueError(
                        "job_weights names a job beyond the planner's "
                        "16-namespace cap"
                    )
                self.balancer_max_jobs = hi + 1
        if self.control:
            if self.server_impl != "python":
                raise ValueError("control=True requires server_impl='python'")
            if self.obs_sync_interval <= 0:
                # the controller's inputs are the merged obs registry
                # and alert table — products of the gossip plane
                raise ValueError("control=True requires obs_sync_interval > 0")
        if self.control_interval < 0:
            raise ValueError("control_interval must be >= 0")
        if self.control_cooldown_s < 0:
            raise ValueError("control_cooldown_s must be >= 0")
        if self.control_min_servers < 1:
            raise ValueError("control_min_servers must be >= 1")
        if self.control_max_servers < 0:
            raise ValueError("control_max_servers must be >= 0")
        if self.control_max_servers and \
                self.control_max_servers < self.control_min_servers:
            raise ValueError(
                "control_max_servers, when bounded, must be >= "
                "control_min_servers"
            )
        if not (0.0 < self.control_scaleout_pressure <= 1.0):
            raise ValueError("control_scaleout_pressure must be in (0, 1]")
        if not (0.0 <= self.control_scalein_pressure
                < self.control_scaleout_pressure):
            raise ValueError(
                "control_scalein_pressure must be in "
                "[0, control_scaleout_pressure)"
            )
        if not (0 < self.balancer_max_tasks <= 8192):
            raise ValueError("balancer_max_tasks must be in 1..8192")
        if not (0 < self.balancer_max_requesters <= 2048):
            raise ValueError("balancer_max_requesters must be in 1..2048")
        if self.balancer_mesh not in ("off", "auto"):
            raise ValueError(f"unknown balancer_mesh {self.balancer_mesh!r}")
        if self.balancer_auction not in ("device", "host"):
            raise ValueError(
                f"unknown balancer_auction {self.balancer_auction!r}"
            )
        if self.balancer_idle_interval < 0:
            raise ValueError("balancer_idle_interval must be >= 0")


def normalize_req_types(
    req_types: Optional[Sequence[int]], valid: Sequence[int]
) -> Optional[frozenset[int]]:
    """Validate a Reserve request vector; None / [-1] means any type
    (reference ADLB_RESERVE_REQUEST_ANY). Raises on unregistered types
    (reference aborts, ``src/adlb.c:2893-2902``)."""
    from adlb_tpu_torch.types import ADLB_RESERVE_REQUEST_ANY, REQ_TYPE_VECT_SZ, AdlbError

    if req_types is None:
        return None
    kept = []
    for t in req_types:
        if t == ADLB_RESERVE_REQUEST_ANY:
            return None
        kept.append(t)
    if not kept:
        return None
    if len(kept) > REQ_TYPE_VECT_SZ:
        raise AdlbError(f"reserve requests at most {REQ_TYPE_VECT_SZ} types")
    for t in kept:
        if t not in valid:
            raise AdlbError(f"unregistered work type {t}")
    return frozenset(kept)
