"""Randomized chaos soak over the PyTorch port's public surface
(``adlb_tpu_torch``): ``scripts/chaos_soak.py`` with its imports rewritten
to the port, its planned worlds on ``--device``, and its apps picklable.

Every world that plans (``balancer="tpu"``, among them ``master_kill``'s
``mid_plan`` draw) plans on ``--device`` (``cuda``, the default, or
``cpu``; ``cuda`` without a card raises, as ``Config`` does), and solves
on the device whenever it has a parked requester (the host threshold is
0: the soak's worlds are small, and at the solver's default of 64 parked
requesters they would never reach the device). A rank of a Python-server
world that plans on the card is started with ``"spawn"``, so each app is
a module-level factory wrapped in :class:`_App`, which a spawned rank can
unpickle. The same seed draws the same world as ``scripts/chaos_soak.py``
(``tests/test_torch_soak.py`` holds the two to it). :data:`PLANNERS`
collects the planners of every ``spawn_world`` world, as
``WorldResult.planner`` reports them, and :data:`KILLED_PLANNERS` those
of its SIGKILLed servers (a killed master's planner among them), from
their fault logs. Its conservation checks bound the
units missing by ``FAILOVER_LOST`` plus the port's
``FAILOVER_RELAYS_UNRESOLVED`` (relays consumed at a home server's death,
each delivered or lost), which the JAX package counts nowhere.
``scripts/soak_seeds_torch.py`` reruns chosen seeds.

Usage: python scripts/chaos_soak_torch.py [--device cuda|cpu]
           [--fabric shm|tcp|auto] <minutes> [seed0]

What follows is the JAX package's description of the soak.

Each iteration builds a random world (shape, balancer mode, server
plane, memory cap), runs a self-validating workload (answer economy
with targeted answers, or known-answer nq), and randomly layers on
adversities: garbage sprayed at the servers' live ports from inside
the world (rank 0 knows the real addresses), a mid-run abort
(validated to unblock the world), a random worker SIGKILLed mid-run
(exercised under BOTH failure policies — `abort` must classify
cleanly without hanging, `reclaim` must still produce the complete
answer set), seeded fault-injection delays on every endpoint
(adlb_tpu/runtime/faults.py — protocol-invisible, timing-hostile),
exhaustion vs explicit termination, or elastic-membership CHURN (ranks
attaching and detaching mid-world plus a server scale-out under a put
storm — exact coverage and zero counted losses asserted under both
worker policies). Any wrong answer, hang (timeout), or unexpected
exception stops the soak with the seed for replay.

``--fabric shm`` pins every spawn-plane world onto the shared-memory
ring fabric (transport_shm.py), so the worker-kill / server-kill /
stall / poison adversities all exercise peers dying mid-ring.

First session of use found a real bug within minutes: a mid-run
abort could be misclassified as a world failure when a tearing-down
server closed its clients' connections before their TA_ABORT
frames landed (fixed: HomeServerLostError / abort-collateral
classification in spawn_world; regression test
tests/test_tcp_world.py::test_abort_classification_survives_teardown_race).
"""
import os
import random
import socket
import struct
import sys
import threading
import time

sys.path.insert(0, __import__("os").path.join(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__)), ".."))

from adlb_tpu_torch.runtime.transport_tcp import probe_free_ports
from adlb_tpu_torch.runtime.transport_tcp import spawn_world as _spawn_world
from adlb_tpu_torch.runtime.world import Config as _Config
from adlb_tpu_torch.types import ADLB_SUCCESS, InfoKey
from adlb_tpu_torch.workloads import nq


#: where the soak's planned worlds solve (``one_iter`` sets the device),
#: and the parked requesters at or below which a round solves on the host
SETTINGS = {"device": "cuda", "solver_host_threshold": 0}
#: ``WorldResult.planner`` of every ``spawn_world`` world this process ran
PLANNERS = []
#: for each of those worlds, the planner counts of its servers that an
#: injected fault SIGKILLed ({rank: counts}; a killed rank sends no
#: ``WorldResult.planner`` entry, so its kill writes them to its fault log)
KILLED_PLANNERS = []


def Config(**kw):
    """The world's ``Config`` with the soak's device and host threshold."""
    return _Config(**kw, **SETTINGS)


def spawn_world(*args, **kw):
    """``spawn_world`` with each rank's fault log in a directory of the
    world's own (under ``ADLB_FAULT_LOG_DIR`` when it is set, else a
    temporary one, removed after), from which :data:`KILLED_PLANNERS`
    reads the killed servers' planner counts."""
    import shutil
    import tempfile

    parent = os.environ.get("ADLB_FAULT_LOG_DIR")
    log_dir = tempfile.mkdtemp(prefix="soak-faults-", dir=parent)
    os.environ["ADLB_FAULT_LOG_DIR"] = log_dir
    try:
        res = _spawn_world(*args, **kw)
    finally:
        if parent is None:
            del os.environ["ADLB_FAULT_LOG_DIR"]
        else:
            os.environ["ADLB_FAULT_LOG_DIR"] = parent
    PLANNERS.append(res.planner)
    KILLED_PLANNERS.append(killed_planners(log_dir))
    if parent is None:
        shutil.rmtree(log_dir, ignore_errors=True)
    return res


def killed_planners(log_dir) -> dict:
    """{rank: planner counts} of the planning ranks whose injected kill
    wrote them to a fault log in ``log_dir`` (``Server._state_at_kill``)."""
    import glob
    import json

    out = {}
    for path in glob.glob(os.path.join(log_dir, "faults-rank*.json")):
        with open(path) as fh:
            doc = json.load(fh)
        counts = (doc.get("state") or {}).get("planner")
        if counts is not None:
            out[int(doc["rank"])] = counts
    return out


class _App:
    """A picklable app: the name of one of this module's app factories and
    its arguments. The rank that calls it builds the factory's app and
    runs it, so a rank started with ``"spawn"`` can take it."""

    def __init__(self, factory, *args, **kw):
        self.factory, self.args, self.kw = factory.__name__, args, kw

    def __call__(self, ctx):
        return globals()[self.factory](*self.args, **self.kw)(ctx)


def load_factor(cap: float = 5.0) -> float:
    """How oversubscribed this host is right now (1.0 = idle enough).

    The gray/two-jobs adversities arm sub-second lease timeouts; their
    quarantine/casualty ORACLES assume the only thing exceeding a lease
    is the injected fault. On a heavily loaded host that assumption
    breaks mechanically, not behaviorally: a HEALTHY worker descheduled
    past lease_timeout_s (its heartbeat thread starved too) gets
    fenced, its unit's attempts bump, and with the deliberately tiny
    retry budget (max_unit_retries=1) a second innocent expiry
    quarantines a NON-poison unit — quarantined becomes 2+ and the
    assert fires. Reproduced identically on ``--fabric tcp``, i.e. it is
    load-induced scheduler starvation, not a fabric
    or quarantine bug: the seed replays green on an idle host.

    Fix: scale the armed lease timeouts by the measured 1-minute load
    per core, capped (a saturated CI box still has to finish). The
    stall durations derive from lease_timeout_s, so the
    short-stall/long-stall ratio semantics are preserved.
    """
    try:
        per_core = os.getloadavg()[0] / max(os.cpu_count() or 1, 1)
    except OSError:  # no /proc: assume idle
        return 1.0
    return min(max(per_core, 1.0), cap)


def coverage_pool(n_units):
    """Self-validating coverage workload for SERVER-kill adversities:
    rank 0 pre-loads ids, everyone consumes via get_work; the world ends
    by exhaustion. Tolerates re-execution (failover may replay a unit
    whose migration/ack was in flight) — the oracle is id coverage
    modulo the COUNTED replication-lag losses, asserted by the caller.
    The answer economy would deadlock instead: rank 0 blocks on exactly
    n_pairs answers, so a single counted loss would hang the world."""
    def app(ctx):
        T = 1
        if ctx.rank == 0:
            for i in range(n_units):
                rc = ctx.put(struct.pack("<q", i), T)
                assert rc == ADLB_SUCCESS
        got = []
        while True:
            rc, w = ctx.get_work([T])
            if rc != ADLB_SUCCESS:
                return got
            got.append(struct.unpack("<q", w.payload)[0])
            time.sleep(0.002)

    return app

GARBAGE = [
    struct.pack("<I", 41) + b"\x01" + os.urandom(40),
    struct.pack("<I", 8) + b"\x99" * 8,
    struct.pack("<I", 0x7FFFFFFF),
    struct.pack("<I", 0),
    struct.pack("<I", 12) + b"\x80" + os.urandom(11),
    struct.pack("<I", 9) + b"\x01" + struct.pack("<HiH", 4242, 0, 0),
]


def answer_economy(n_pairs, do_abort, do_spray, victim=None, kill_after=0,
                   kill_at_end=False):
    def app(ctx):
        T_AB, T_C = 1, 2
        if ctx.rank == victim:
            # the kill adversity: SIGKILL myself (uncatchable, a real
            # preemption) at a work-cycle boundary after kill_after
            # answers — or, if the pool drains first and kill_at_end is
            # set (reclaim iterations), right before finalize (the
            # END-ring-held death). Cycle boundaries keep the oracle
            # exact: no consumed-but-unanswered unit is lost, while a
            # death holding an unfetched reservation still exercises
            # lease reclaim.
            import signal as _signal

            n = 0
            while True:
                rc, r = ctx.reserve([T_AB])
                if rc != ADLB_SUCCESS:
                    if kill_at_end:
                        os.kill(os.getpid(), _signal.SIGKILL)
                    return n
                if n >= kill_after:
                    os.kill(os.getpid(), _signal.SIGKILL)
                rc, buf = ctx.get_reserved(r.handle)
                a, b = struct.unpack("<qq", buf)
                ctx.put(struct.pack("<q", a + b), T_C,
                        target_rank=r.answer_rank)
                n += 1
        if ctx.rank == 0 and do_spray:
            # spray from INSIDE the world: clients know every rank's real
            # address (spawn_world binds ephemeral ports, so an outside
            # observer cannot target them); sprayed-frame count is
            # printed so the harness can assert the adversity engaged
            stop = threading.Event()
            sprayed = [0]

            def _spray_all():
                servers = [
                    r for r in range(ctx.world.nranks)
                    if ctx.world.is_server(r)
                ]
                while not stop.is_set():
                    for s in servers:
                        host, port = ctx._c.ep.addr_map[s]
                        try:
                            c = socket.create_connection((host, port),
                                                         timeout=1.0)
                            c.sendall(random.choice(GARBAGE))
                            c.close()
                            sprayed[0] += 1
                        except OSError:
                            pass
                    time.sleep(0.02)

            t = threading.Thread(target=_spray_all, daemon=True)
            t.start()
            try:
                out = _economy_rank0(ctx, n_pairs, do_abort)
            finally:
                stop.set()
                print(f"SPRAYED {sprayed[0]}", flush=True)
            return out
        if ctx.rank == 0:
            return _economy_rank0(ctx, n_pairs, do_abort)
        n = 0
        while True:
            rc, r = ctx.reserve([T_AB])
            if rc != ADLB_SUCCESS:
                return n
            rc, buf = ctx.get_reserved(r.handle)
            a, b = struct.unpack("<qq", buf)
            ctx.put(struct.pack("<q", a + b), T_C, target_rank=r.answer_rank)
            n += 1

    return app


def _economy_rank0(ctx, n_pairs, do_abort):
    T_AB, T_C = 1, 2
    for a in range(n_pairs):
        rc = ctx.put(struct.pack("<qq", a, a * 3), T_AB, answer_rank=0)
        assert rc == ADLB_SUCCESS
    total = 0
    for i in range(n_pairs):
        if do_abort and i == n_pairs // 2:
            ctx.abort(7)
            return "aborted"
        rc, r = ctx.reserve([T_C])
        assert rc == ADLB_SUCCESS, rc
        rc, buf = ctx.get_reserved(r.handle)
        total += struct.unpack("<q", buf)[0]
    ctx.set_problem_done()
    return total


def gray_economy(n_units, victim=None, stall_s=0.0, poison=False,
                 ops_port=None, slo=False):
    """Answer-at-cycle-boundary economy for the GRAY adversities: rank 0
    puts ids (plus one poison-typed unit when ``poison``) and collects
    answers until coverage is complete; workers reserve/fetch/answer with
    a small compute sleep. ``victim`` SIGSTOPs itself between reserve and
    fetch (holding an unfetched lease) and must survive the fencing of
    its late fetch. Kills at reserve-response (the poison fault) land at
    cycle boundaries, so a casualty loses nothing it already answered
    and the id-coverage oracle stays exact.

    With ``ops_port`` the world is OBSERVED (trace_sample=0 + tail
    promotion armed by the port): rank 0 polls the master's
    /trace/tails before finishing and returns the doc, so the harness
    can assert the quarantined / lease-expired unit's journey was
    captured — observability exercised under faults, not happy path.

    With ``slo`` rank 0 additionally polls /alerts until
    the burn-rate engine has driven a page-severity objective to
    FIRING (the lease expiry is the burn), returning the alert doc so
    the harness can assert the incident bundle on disk names the
    SIGSTOP victim — the fleet pages itself under the adversity."""
    T, T_P, T_ANS = 1, 2, 3

    def app(ctx):
        from adlb_tpu_torch.runtime.faults import sigstop_self

        if ctx.rank == 0:
            for i in range(n_units):
                rc = ctx.put(struct.pack("<q", i), T, answer_rank=0)
                assert rc == ADLB_SUCCESS, rc
            if poison:
                assert ctx.put(b"poison", T_P) == ADLB_SUCCESS
            seen = set()
            while len(seen) < n_units:
                rc, r = ctx.reserve([T_ANS])
                assert rc == ADLB_SUCCESS, rc
                rc, buf = ctx.get_reserved(r.handle)
                if rc != ADLB_SUCCESS:
                    continue
                seen.add(struct.unpack("<q", buf)[0])
            tails = alerts = None
            if ops_port:
                import json as _json
                import urllib.request

                def fetch(route):
                    return _json.loads(urllib.request.urlopen(
                        f"http://127.0.0.1:{ops_port}{route}",
                        timeout=5,
                    ).read().decode())

                # the adversity's journey closes on a server and rides
                # the obs gossip to the master — poll for it (bounded)
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    try:
                        tails = fetch("/trace/tails")
                    except OSError:
                        time.sleep(0.4)
                        continue
                    js = tails.get("journeys") or []
                    if poison and any(
                        j.get("end") == "quarantined" for j in js
                    ):
                        break
                    if not poison and any(
                        "expire" in [s[0] for s in j.get("spans") or ()]
                        for j in js
                    ):
                        break
                    time.sleep(0.4)
                if slo:
                    # the expiry IS the burn: hold the world open until
                    # the evaluator pages (PENDING -> FIRING needs a
                    # couple of sustained ticks past the expiry above)
                    deadline = time.monotonic() + 25.0
                    while time.monotonic() < deadline:
                        try:
                            alerts = fetch("/alerts")
                        except OSError:
                            time.sleep(0.4)
                            continue
                        if any(
                            a.get("state") == "FIRING"
                            for a in alerts.get("alerts") or []
                        ) or any(
                            h.get("to") == "FIRING"
                            for h in alerts.get("history") or []
                        ):
                            break
                        time.sleep(0.4)
            ctx.set_problem_done()
            return len(seen), tails, alerts
        # the SIGSTOP victim never touches the poison type: it must
        # SURVIVE (the adversity under test is the hang, not a kill)
        my_types = [T] if ctx.rank == victim else [T, T_P]
        n, retries, stopped = 0, 0, False
        while True:
            rc, r = ctx.reserve(my_types)
            if rc != ADLB_SUCCESS:
                return n, retries, stopped
            if ctx.rank == victim and n >= 1 and not stopped:
                stopped = True
                sigstop_self(stall_s)
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                retries += 1  # fenced/void handle: re-reserve
                continue
            ctx.put(buf, T_ANS, target_rank=0)
            n += 1
            time.sleep(0.003)

    return app


def two_jobs_economy(n_units, poison=True):
    """Service-mode adversity: two namespaces on one fleet. Rank 0
    produces/collects job A (plus one poison-typed unit when ``poison``
    — the fault spec SIGKILLs job-A workers that reserve it until the
    retry budget quarantines it); rank 1 produces/collects job B; the
    worker pool splits between the jobs by parity. Job B must drain to
    completion with exact coverage REGARDLESS of job A's poison churn —
    per-job exhaustion isolation — and job A itself completes with its
    poison unit quarantined."""
    T, T_P, T_ANS = 1, 2, 3

    def producer(ctx, jid, ids_base):
        ctx.attach(jid)
        for i in range(n_units):
            rc = ctx.put(struct.pack("<q", ids_base + i), T,
                         answer_rank=ctx.rank)
            assert rc == ADLB_SUCCESS, rc
        if poison and jid == 1:
            assert ctx.put(b"poison", T_P) == ADLB_SUCCESS
        seen = set()
        while len(seen) < n_units:
            # the producer doubles as a backstop consumer of its own
            # job's work (it never requests the poison type): even if
            # the poison kills the job's whole worker pool, the job
            # still drains — and answers carry the same id payload, so
            # either way one reserve closes one id
            rc, r = ctx.reserve([T, T_ANS])
            assert rc == ADLB_SUCCESS, rc
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                continue
            seen.add(struct.unpack("<q", buf)[0])
        ctx.drain_job(jid)
        return len(seen)

    def app(ctx):
        if ctx.rank == 0:
            rc, ja = ctx.submit_job("job-a")
            assert (rc, ja) == (ADLB_SUCCESS, 1), (rc, ja)
            rc, jb = ctx.submit_job("job-b")
            assert (rc, jb) == (ADLB_SUCCESS, 2), (rc, jb)
            return producer(ctx, 1, 0)
        if ctx.rank == 1:
            time.sleep(0.3)  # submits land; ids are deterministic
            return producer(ctx, 2, 1000)
        time.sleep(0.3)
        jid = 1 if ctx.rank % 2 == 0 else 2
        my_answer_rank = 0 if jid == 1 else 1
        ctx.attach(jid)
        # only job-A workers touch the poison type: job B's pool must be
        # untouched by job A's adversity
        my_types = [T, T_P] if jid == 1 else [T]
        n = 0
        while True:
            rc, r = ctx.reserve(my_types)
            if rc != ADLB_SUCCESS:
                return jid, n
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                continue
            ctx.put(buf, T_ANS, target_rank=my_answer_rank)
            n += 1
            time.sleep(0.002)

    return app


def churn_world(rng, apps, servers, mode, policy):
    """Elastic-membership adversity (adlb_tpu/runtime/membership.py):
    ranks JOIN and LEAVE mid-world and a server scales OUT under a put
    storm (the memory-watermark autoscale path, with a manual kick as
    the deterministic fallback), optionally scaling back IN through the
    zero-loss drain. Runs on the in-proc ElasticWorld harness — the
    member spawner lives in the master's process by construction.

    Oracles, under BOTH worker policies: exact id coverage (every put
    acked before the scale-out fetchable after it, the detacher's puts
    included), zero counted losses (churn is clean — `failover_lost`
    and `failover_promoted` both 0), and at least one shard actually
    joined."""
    from adlb_tpu_torch.runtime.membership import ElasticWorld

    # sized against the 16 KiB per-server cap below: round-robin spread
    # puts ~10 KiB on each BASE server — over the 8 KiB soft watermark
    # (the autoscale trigger), comfortably under the cap (the static
    # producer cannot route to the new shard, so the storm must fit the
    # base fleet; what the scale-out relieves is the standing backlog)
    payload_len = 480
    n_units = rng.randint(19, 22) * servers
    cfg = Config(
        balancer=mode,
        exhaust_check_interval=0.2,
        on_worker_failure=policy,
        on_server_failure="failover",  # scale-in drains over promote
        elastic_scaleout="auto",
        elastic_cooldown_s=0.5,
        max_malloc_per_server=16 * 1024,
        mem_soft_frac=0.5,
    )
    ew = ElasticWorld(apps, servers, [1], cfg=cfg)
    hold = threading.Event()   # churn done; unleash the consumers
    stormed = threading.Event()  # every base put acked

    def consume(ctx):
        got = []
        while True:
            rc, w = ctx.get_work([1])
            if rc != ADLB_SUCCESS:
                return got
            got.append(struct.unpack("<q", w.payload[:8])[0])

    def producer(ctx):
        for i in range(n_units):
            assert ctx.put(
                struct.pack("<q", i) + b"x" * (payload_len - 8), 1
            ) == ADLB_SUCCESS
        stormed.set()
        hold.wait(90)
        return consume(ctx)

    def holder(ctx):
        hold.wait(90)
        return consume(ctx)

    ew.run_app(0, producer)
    for r in range(1, apps):
        ew.run_app(r, holder)
    assert stormed.wait(60), "put storm never finished"
    # ranks JOIN mid-world ...
    joined = [ew.attach_app(holder) for _ in range(rng.randint(1, 2))]
    # ... and LEAVE: a joiner that puts its own ids then cleanly detaches
    jw = ew.attach_ctx()
    extra = list(range(1000, 1000 + rng.randint(2, 5)))
    for i in extra:
        assert jw.ctx.put(
            struct.pack("<q", i) + b"y" * (payload_len - 8), 1
        ) == ADLB_SUCCESS
    assert jw.ctx.detach_world() == ADLB_SUCCESS
    # server scale-OUT under the storm: the watermark autoscale should
    # have tripped (0.5 * 16 KiB soft mark vs a ~20-45 KiB storm); kick
    # manually if the timing missed it, so the oracle stays exact
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not ew.master._member_ready:
        time.sleep(0.05)
    if not ew.master._member_ready:
        ew.scale_out()
    new_shards = sorted(ew.master._member_ready)
    # optionally scale back IN (needs >= 3 live servers)
    drained = None
    if rng.random() < 0.5 and servers + len(new_shards) >= 3:
        drained = ew.scale_in()
    hold.set()
    results = ew.finish(timeout=120)
    got = sorted(x for v in results.values() if v for x in v)
    want = sorted(list(range(n_units)) + extra)
    assert got == want, (
        f"coverage broke under churn: missing={set(want) - set(got)} "
        f"dup={[x for x in got if got.count(x) > 1][:5]}"
    )
    # churn is CLEAN: no counted losses, no failover promotions
    for r, s in ew.servers.items():
        if r == drained:
            continue
        assert s.metrics.value("failover_lost") == 0.0, r
        assert s.metrics.value("failover_promoted") == 0.0, r
    assert ew.master.metrics.value("servers_joined") >= 1.0
    # counted once fleet-wide, at the detacher's home
    assert sum(
        s.metrics.value("ranks_detached") for s in ew.servers.values()
    ) == 1.0
    return dict(
        workload="churn", apps=apps, servers=servers, mode=mode,
        policy=policy, n_units=n_units, joined=len(joined) + 1,
        shards=new_shards, drained=drained,
    )


def control_world(rng, apps, policy):
    """Fleet-brain adversity (adlb_tpu/control/controller.py): the
    closed-loop controller rides the obs tick over a live ElasticWorld
    while a put storm drives memory pressure past the scale-out rule's
    threshold. The CONTROLLER — no manual kick anywhere — must grow
    the fleet, and the growth must be clean under BOTH worker
    policies: exact id coverage across the scale-out, `failover_lost`
    0 on every server, at least one enacted scale_out action, and the
    hysteresis rail held (enacted scale actions bounded by the elapsed
    cooldown windows)."""
    from adlb_tpu_torch.runtime.membership import ElasticWorld

    payload_len = 2048
    n_units = rng.randint(30, 40)
    cooldown = 3.0
    cfg = Config(
        exhaust_check_interval=0.2,
        on_worker_failure=policy,
        ops_port=0,
        obs_sync_interval=0.1,
        control=True,
        control_cooldown_s=cooldown,
        control_min_servers=2,
        control_max_servers=4,
        control_scaleout_pressure=0.25,
        control_scalein_pressure=0.05,
        max_malloc_per_server=128 * 1024,
    )
    t0 = time.monotonic()
    ew = ElasticWorld(apps, 2, [1], cfg=cfg)
    hold = threading.Event()     # storm parked; unleash the consumers
    stormed = threading.Event()  # every put acked

    def consume(ctx):
        got = []
        while True:
            rc, w = ctx.get_work([1])
            if rc != ADLB_SUCCESS:
                return got
            got.append(struct.unpack("<q", w.payload[:8])[0])

    def producer(ctx):
        for i in range(n_units):
            assert ctx.put(
                struct.pack("<q", i) + b"x" * (payload_len - 8), 1
            ) == ADLB_SUCCESS
        ctx._c.flush_puts()
        stormed.set()
        hold.wait(90)
        return consume(ctx)

    def holder(ctx):
        hold.wait(90)
        return consume(ctx)

    ew.run_app(0, producer)
    for r in range(1, apps):
        ew.run_app(r, holder)
    assert stormed.wait(60), "put storm never finished"
    # the controller — not a manual kick — grows the fleet
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and len(ew.servers) <= 2:
        time.sleep(0.05)
    assert len(ew.servers) > 2, "controller never scaled out"
    hold.set()
    results = ew.finish(timeout=120)
    elapsed = time.monotonic() - t0
    got = sorted(x for v in results.values() if v for x in v)
    want = list(range(n_units))
    assert got == want, (
        f"coverage broke across controller scale-out: "
        f"missing={set(want) - set(got)} "
        f"dup={[x for x in got if got.count(x) > 1][:5]}"
    )
    # controller-driven growth is CLEAN: no counted losses anywhere
    for r, s in ew.servers.items():
        assert s.metrics.value("failover_lost") == 0.0, r
    acts = ew.master.metrics.value("control_actions", kind="scale_out")
    assert acts >= 1.0, "scale-out happened without an enacted action"
    # hysteresis rail: at most one enacted scale action per cooldown
    # window over the world's whole life
    windows = int(elapsed / cooldown) + 1
    assert acts <= windows, (acts, windows, elapsed)
    return dict(
        workload="control", apps=apps, policy=policy, n_units=n_units,
        servers=len(ew.servers), actions=int(acts), windows=windows,
    )


def hedge_app(T, T_ANS, n_units, victim, stall_after, stall_s, port):
    """hedge_world's app."""
    def app(ctx):
        from adlb_tpu_torch.runtime.faults import sigstop_self

        if ctx.rank == 0:
            for i in range(n_units):
                rc = ctx.put(struct.pack("<q", i), T, answer_rank=0)
                assert rc == ADLB_SUCCESS, rc
            seen = set()
            while len(seen) < n_units:
                rc, r = ctx.reserve([T_ANS])
                assert rc == ADLB_SUCCESS, rc
                rc, buf = ctx.get_reserved(r.handle)
                if rc != ADLB_SUCCESS:
                    continue
                seen.add(struct.unpack("<q", buf)[0])
            # hold the world open until the launch is visible in the
            # merged fleet metrics (bounded — the rescue already
            # happened or rank 0 would still be short an answer)
            import urllib.request
            launched = False
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline and not launched:
                try:
                    text = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=5,
                    ).read().decode()
                except OSError:
                    time.sleep(0.4)
                    continue
                for ln in text.splitlines():
                    if ln.startswith("#") or "hedges_launched" not in ln:
                        continue
                    try:
                        launched = launched or float(ln.split()[-1]) > 0
                    except ValueError:
                        pass
                if not launched:
                    time.sleep(0.4)
            ctx.set_problem_done()
            return len(seen), launched
        n, retries, stopped = 0, 0, False
        while True:
            rc, r = ctx.reserve([T])
            if rc != ADLB_SUCCESS:
                return n, retries, stopped
            if ctx.rank == victim and n >= stall_after and not stopped:
                stopped = True
                sigstop_self(stall_s)  # reserved, unfetched, frozen
            rc, buf = ctx.get_reserved(r.handle)
            if rc != ADLB_SUCCESS:
                retries += 1  # fenced: the hedge sibling won the race
                continue
            ctx.put(buf, T_ANS, target_rank=0)
            n += 1
            time.sleep(0.003)

    return app


def hedge_world(rng, apps, mode, policy, fabric=None):
    """Tail-hedging adversity: hedging armed, one worker
    SIGSTOPs while holding an unfetched reservation WITHOUT crossing
    the lease timeout — only the hedge plane can rescue the straggler
    early (the p99 trigger: once the rest of the pool drains, the
    frozen unit's age walks past the gossiped tail threshold and the
    home server speculatively re-dispatches it to a parked worker).

    One server on purpose: the sibling targets a parked requester at
    the straggler's HOME, so a single roof makes the launch
    deterministic. The oracle is zero double-count under both worker
    policies: every id answered exactly once at rank 0 AND executed
    exactly once across the pool (the fenced loser's fetch answers a
    retry, never a second payload), with the launch itself asserted
    through the merged /metrics view so the adversity can't pass
    vacuously."""
    T, T_ANS = 1, 3
    n_units = 120
    victim = rng.randrange(1, apps)
    # stall once the fleet has closed ~70 units: past TAIL_MIN_COUNT
    # (the p99 threshold exists) with plenty of pool left to drain
    stall_after = max(1, 70 // max(apps - 1, 1))
    lease_s = round(2.0 * load_factor(), 2)
    stall_s = round(0.45 * lease_s, 2)  # strictly under expiry
    port = probe_free_ports(1)[0]
    app = _App(hedge_app, T, T_ANS, n_units, victim, stall_after, stall_s,
               port)

    kw = dict(balancer=mode, exhaust_check_interval=0.2,
              on_worker_failure=policy, lease_timeout_s=lease_s,
              hedge_budget_frac=0.5, hedge_min_age_ms=150.0,
              ops_port=port, obs_sync_interval=0.25, trace_sample=0.0)
    if fabric:
        kw["fabric"] = fabric
    res = spawn_world(apps, 1, [T, T_ANS], app, cfg=Config(**kw),
                      timeout=150.0)
    seen, launched = res.app_results[0]
    assert seen == n_units, res.app_results
    executed = sum(res.app_results[r][0] for r in range(1, apps))
    assert executed == n_units, (
        f"double count under hedging: executed={executed} want={n_units}"
    )
    assert launched, "hedge adversity never launched a sibling"
    assert victim in res.app_results, "stalled worker vanished"
    return dict(workload="hedge", apps=apps, servers=1, mode=mode,
                policy=policy, stall_s=stall_s, n_units=n_units)


def master_kill_world(rng, seed, apps, servers, mode, policy, draw,
                      fabric=None):
    """Master-kill adversity: the MASTER dies mid-run under
    ``on_server_failure="failover"`` — SIGKILL on the spawn plane, a
    fault-injected disconnect on the in-proc ``mid_attach`` draw. The
    ring-buddy deputy must promote and the world must complete with
    exact id coverage modulo the counted replication-lag losses
    (``failover_lost``) and the relays consumed at a home server's death
    (``failover_relays_unresolved``, the port's count: each was delivered
    or lost); a promotion additionally mints the
    ``master_failover_mttr_ms`` row. Draws vary WHEN the brain dies:

    * ``idle``          — late frame: the fleet is mostly drained
    * ``mid_plan``      — ``balancer="tpu"``: the brain dies while the
                          planner owns dispatch
    * ``mid_attach``    — in-proc: a rank attaches across the
                          succession; the joiner must land at the
                          promoted deputy, never the corpse
    * ``alerts_firing`` — an SLO objective is live (and likely FIRING)
                          when the master dies; the deputy rebuilds the
                          engine under a churn hold and re-announces
                          the rebound ops endpoint via the rendezvous
                          file
    """
    n_units = rng.randint(24, 60)
    # mid_attach pins steal: the in-proc disconnect is FRAME-based and
    # fires only when the master's outbound counter reaches it — the
    # periodic steal-mode qmstat tick walks it deterministically even
    # while the consumers idle, whereas tpu mode event-gates the
    # broadcast and an idle planner can stall below the kill frame
    # forever (planner-owned succession is mid_plan's job)
    kw = dict(
        balancer="tpu" if draw == "mid_plan"
        else ("steal" if draw == "mid_attach" else mode),
        exhaust_check_interval=0.2,
        on_worker_failure=policy,
        on_server_failure="failover",
        failover_client_wait=30.0,
    )
    desc = dict(workload="master_kill", draw=draw, apps=apps,
                servers=servers, mode=kw["balancer"], policy=policy)
    master_rank = apps  # server index 0

    if draw == "mid_attach":
        from adlb_tpu_torch.runtime.membership import ElasticWorld

        kw["fault_spec"] = {
            "seed": seed,
            "disconnect_server_at": {0: rng.randint(30, 90)},
        }
        cfg = Config(**kw)
        ew = ElasticWorld(apps, servers, [1], cfg=cfg)
        stormed = threading.Event()  # every put acked
        hold = threading.Event()     # succession done; drain the pool

        def consume(ctx):
            hold.wait(90)
            got = []
            while True:
                rc, w = ctx.get_work([1])
                if rc != ADLB_SUCCESS:
                    return got
                got.append(struct.unpack("<q", w.payload)[0])

        def producer(ctx):
            for i in range(n_units):
                assert ctx.put(struct.pack("<q", i), 1) == ADLB_SUCCESS
            stormed.set()
            return consume(ctx)

        ew.run_app(0, producer)
        for r in range(1, apps):
            ew.run_app(r, consume)
        assert stormed.wait(60), "put storm never finished"
        # the master's gossip/reactor traffic walks its frame count to
        # the injected disconnect; wait for the succession, then attach
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            m = ew.current_master
            if m.rank != master_rank and m.is_master:
                break
            time.sleep(0.02)
        promoted = ew.current_master
        assert promoted.rank != master_rank and promoted.is_master, \
            "deputy never promoted"
        # the attach dials the CURRENT master (MemberView-aware): a
        # joiner landing at the corpse would time the rpc out
        joiner = ew.attach_app(consume)
        assert joiner.rank != master_rank
        hold.set()
        results = ew.finish(timeout=120)
        got = sorted(x for v in results.values() if v for x in v)
        lost = sum(
            s.metrics.value("failover_lost")
            + s.metrics.value("failover_relays_unresolved")
            for r, s in ew.servers.items() if r != master_rank
        )
        missing = set(range(n_units)) - set(got)
        assert len(missing) <= lost, (sorted(missing), lost)
        assert promoted.metrics.value("master_failover_mttr_ms") > 0.0
        # the promoted brain's snapshot names the succession
        snap = promoted.world.snapshot()
        assert snap.get("master") == promoted.rank, snap
        desc["promoted"] = promoted.rank
        return desc

    # spawn-plane draws: a real SIGKILL of the master process
    frame = {
        "idle": rng.randint(100, 180),
        "mid_plan": rng.randint(30, 90),
        "alerts_firing": rng.randint(80, 150),
    }[draw]
    if fabric:
        kw["fabric"] = fabric
    announce_dir = None
    if draw == "alerts_firing":
        # every close breaches the 0.01 ms p99 -> the alert is live
        # (likely FIRING) when the master dies; warn severity keeps the
        # incident capture out of the oracle's way
        kw["ops_port"] = probe_free_ports(1)[0]
        kw["obs_sync_interval"] = 0.25
        kw["slo"] = ({
            "name": f"mkill-{seed}", "job": 0, "type": 1,
            "p99_ms": 0.01, "window_s": 60.0, "fast_s": 1.0,
            "for_s": 0.2, "cooldown_s": 5.0, "min_count": 1,
            "severity": "warn",
        },)
        announce_dir = __import__("tempfile").mkdtemp(prefix="adlb-ann-")
        kw["ops_announce_dir"] = announce_dir
    # the kill frame is drawn against an unknown world length: if the
    # world exhausts before the master's outbound frame counter reaches
    # it, the draw proved nothing — retry earlier until the kill LANDS
    # (a frame inside the put storm always exists)
    for _attempt in range(3):
        kw["fault_spec"] = {"seed": seed,
                            "kill_server_at_frame": {0: frame}}
        cfg = Config(**kw)
        res = spawn_world(apps, servers, [1, 2], _App(coverage_pool, n_units),
                          cfg=cfg, timeout=150.0)
        assert not res.aborted
        done = [x for v in res.app_results.values() for x in v]
        lost = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
                   + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
                   for s in res.server_stats.values())
        missing = set(range(n_units)) - set(done)
        assert len(missing) <= lost, (sorted(missing), lost)
        desc["killed"] = master_rank in res.server_casualties
        if desc["killed"]:
            break
        frame = max(10, frame // 2)
    desc["kill_frame"] = frame
    if desc["killed"]:
        # the master actually died mid-run: a promotion must have been
        # counted and timed somewhere in the surviving fleet
        promoted = sum(s.get(int(InfoKey.NUM_FAILOVERS), 0.0)
                       for s in res.server_stats.values())
        assert promoted >= 1, "master died but nobody promoted"
        mttr = max(s.get(int(InfoKey.FAILOVER_MTTR_MS), 0.0)
                   for s in res.server_stats.values())
        assert mttr > 0.0, "promotion did not record an MTTR"
        if announce_dir is not None:
            # the rendezvous file was atomically re-written by the
            # promoted deputy: it must name a SURVIVING master
            import json as _json

            p = os.path.join(announce_dir, "ops_endpoint.json")
            assert os.path.exists(p), "no ops rendezvous written"
            with open(p) as fh:
                doc = _json.load(fh)
            assert doc["master"] != master_rank, doc
    return desc


def one_iter(seed, fabric=None, device="cuda"):
    SETTINGS["device"] = device
    rng = random.Random(seed)
    apps = rng.randint(3, 7)
    servers = rng.randint(2, 4)
    mode = rng.choice(["steal", "steal", "tpu"])
    native = rng.random() < 0.5
    cap = rng.choice([None, None, 64 * 1024, 16 * 1024])
    workload = rng.choice(["economy", "nq"])
    do_spray = workload == "economy" and rng.random() < 0.5
    do_abort = workload == "economy" and rng.random() < 0.25
    # kill adversity: SIGKILL a random worker mid-run, under a randomly
    # chosen failure policy (mutually exclusive with do_abort — a world
    # cannot validate two terminal outcomes at once)
    do_kill = workload == "economy" and not do_abort and rng.random() < 0.35
    policy = rng.choice(["abort", "reclaim"]) if do_kill else "abort"
    # server-kill adversity: SIGKILL a random NON-master server mid-run,
    # under both on_server_failure policies — "abort" must classify
    # cleanly without hanging, "failover" must complete with id coverage
    # modulo the counted replication-lag losses (its own coverage
    # workload; mutually exclusive with the other terminal adversities)
    do_skill = (
        workload == "economy" and not do_abort and not do_kill
        and servers >= 2 and rng.random() < 0.3
    )
    s_policy = rng.choice(["abort", "failover"]) if do_skill else "abort"
    # master-kill adversity: the MASTER dies mid-run under
    # "failover" — the standing deputy must promote and the world must
    # complete with exact id coverage; the draw varies when the brain
    # dies (idle / mid-plan / mid-attach / alerts-firing), under both
    # worker policies
    do_mkill = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and servers >= 2 and rng.random() < 0.3
    )
    mkill_draw = rng.choice(
        ["idle", "mid_plan", "mid_attach", "alerts_firing"]
    ) if do_mkill else None
    # gray adversities (lease_timeout_s armed): a worker SIGSTOPped
    # mid-lease (expiry + fencing must redeliver its unit and reject its
    # post-SIGCONT fetch), or a poison-typed unit that kills every
    # worker reserving it (the retry budget must quarantine it, exactly
    # once, and the fleet must survive) — both run under both worker
    # policies; python servers only (the daemon has no lease table)
    do_stall = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and not do_mkill and apps >= 3
        and rng.random() < 0.35
    )
    do_poison = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and not do_mkill and not do_stall and apps >= 5
        and rng.random() < 0.35
    )
    # service-mode adversity: two jobs multiplexed over one fleet, a
    # poison unit quarantined in job A while job B drains to completion
    # (per-job exhaustion isolation), under both worker policies
    # (apps >= 5 => at least two even-rank job-A workers, so the
    # budget-1 poison is guaranteed to exceed its retry budget and
    # quarantine even though only job A's half-pool ever touches it)
    do_two_jobs = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and not do_mkill and not do_stall and not do_poison
        and apps >= 5 and rng.random() < 0.4
    )
    # tail-hedging adversity: a straggler frozen strictly
    # under the lease timeout — only a speculative sibling can rescue
    # it early; zero double-count asserted under both worker policies
    do_hedge = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and not do_mkill and not do_stall and not do_poison
        and not do_two_jobs and apps >= 3 and rng.random() < 0.3
    )
    # elastic-membership churn: ranks joining/leaving
    # mid-world + a server scale-out under a put storm, both worker
    # policies; python servers only (the daemon keeps the fixed world)
    do_churn = (
        workload == "economy" and not do_abort and not do_kill
        and not do_skill and not do_mkill and not do_stall and not do_poison
        and not do_two_jobs and not do_hedge and rng.random() < 0.35
    )
    if do_mkill:
        return master_kill_world(
            rng, seed, apps, servers, mode,
            policy=rng.choice(["abort", "reclaim"]),
            draw=mkill_draw, fabric=fabric,
        )
    if do_hedge:
        return hedge_world(
            rng, apps, mode,
            policy=rng.choice(["abort", "reclaim"]),
            fabric=fabric,
        )
    if do_churn:
        return churn_world(
            rng, apps, servers, mode,
            policy=rng.choice(["abort", "reclaim"]),
        )
    g_policy = rng.choice(["abort", "reclaim"]) if (do_stall or do_poison) \
        else None
    # seeded delay faults: protocol-invisible, timing-hostile; applied to
    # every endpoint via Config so replays of this seed shake the same
    # interleavings
    do_faults = rng.random() < 0.3
    if workload == "nq":
        # nq runs through run_world — the in-process thread fabric — so
        # there is no native plane or TCP port surface there; keep the
        # descriptor honest (the spawn-plane/native coverage comes from
        # the economy iterations)
        native = False
    if (policy == "reclaim" or do_faults or do_skill or do_stall
            or do_poison or do_two_jobs):
        # the C++ daemon implements neither the reclaim/failover/lease
        # protocols, the (Python-side) fault shim, nor job namespaces
        native = False

    kw = dict(balancer=mode, exhaust_check_interval=0.2,
              on_worker_failure=policy,
              on_server_failure=s_policy)
    if fabric:
        # --fabric shm: every spawn-plane world in the soak rides the
        # shared-memory ring fabric, so the kill/stall/poison/server-kill
        # adversities all exercise a peer dying mid-ring
        kw["fabric"] = fabric
    gray_port = None
    if do_stall or do_poison:
        kw["on_worker_failure"] = g_policy
        # load-aware: the quarantine/casualty oracles assume only the
        # injected fault exceeds a lease — scale the timeout by the
        # host's current oversubscription so a starved-but-healthy
        # worker cannot fence/quarantine innocents (see load_factor)
        kw["lease_timeout_s"] = round(
            rng.choice([0.8, 1.2]) * load_factor(), 2)
        if do_poison:
            kw["max_unit_retries"] = 2
            kw["fault_spec"] = {"seed": seed, "poison_types": [2]}
        # observe the adversity: the ops port alone arms
        # tail promotion (trace_sample stays 0 — nothing head-sampled),
        # so the quarantined / lease-expired unit's journey MUST
        # surface in /trace/tails with its full hop chain — the
        # observability plane exercised under faults, not happy path
        gray_port = probe_free_ports(1)[0]
        kw["ops_port"] = gray_port
        kw["trace_sample"] = 0.0
        kw["obs_sync_interval"] = 0.25
        if do_stall:
            # the fleet pages ITSELF on the adversity: a p99
            # objective on the stalled work type — the expired unit's
            # total time carries the whole lease wait (>= 0.8 s against
            # a ~3 ms healthy close), so its close IS the burn even
            # under "reclaim" where the re-delivery ends the journey
            # "delivered" (no error close). error_frac rides along for
            # the quarantine outcomes. The page-severity FIRING must
            # capture an incident bundle naming the SIGSTOP victim
            # (the leases_expired_by{owner=} window delta). Unique name
            # per seed so the harness can find this iteration's bundle
            # in the shared flight dir.
            kw["slo"] = ({
                "name": f"stall-{seed}", "job": 0, "type": 1,
                "p99_ms": 500.0, "error_frac": 0.05,
                "window_s": 60.0,
                "fast_s": max(2.0, 2 * kw["lease_timeout_s"]),
                "for_s": 0.3, "cooldown_s": 5.0, "min_count": 1,
                "severity": "page",
            },)
    if do_two_jobs:
        # both worker policies: "reclaim" must complete BOTH jobs with
        # the poison quarantined; "abort" must classify the first
        # poison kill cleanly (bounded, never a hang)
        kw["on_worker_failure"] = rng.choice(["abort", "reclaim"])
        # load-aware lease (same rationale as the gray adversities: an
        # innocent expiry under host load would quarantine a second,
        # NON-poison unit and fail the quarantined==1 oracle)
        kw["lease_timeout_s"] = round(
            rng.choice([0.8, 1.2]) * load_factor(), 2)
        # budget 1: the SECOND reclaim quarantines — job A's half-pool
        # (two+ workers) is enough to exceed it
        kw["max_unit_retries"] = 1
        kw["fault_spec"] = {"seed": seed, "poison_types": [2]}
    if native:
        kw["server_impl"] = "native"
    if cap:
        kw["max_malloc_per_server"] = cap
    if do_faults:
        # merge-safe: a gray (poison) spec may already be installed
        kw["fault_spec"] = dict(kw.get("fault_spec") or {},
                                seed=seed, delay=0.03, delay_s=0.002)
    if do_skill:
        # kill a random non-master server a moment into the run (frame
        # counts track protocol activity, so the death lands mid-workload)
        victim_srv = rng.randrange(1, servers)
        kw["fault_spec"] = dict(
            kw.get("fault_spec") or {},
            kill_server_at_frame={victim_srv: rng.randint(30, 120)},
        )
    cfg = Config(**kw)

    if do_stall or do_poison:
        n_units = rng.randint(16, 40)
        victim = rng.randrange(1, apps) if do_stall else None
        # short stalls stay under the 2x hang bar (expiry + fencing only);
        # long ones also trip hang detection (dead-declare + resurrect
        # under "reclaim", world abort under "abort")
        stall_s = round(rng.uniform(1.3, 2.6) * kw["lease_timeout_s"], 2)
        app_fn = _App(gray_economy, n_units, victim=victim, stall_s=stall_s,
                              poison=do_poison, ops_port=gray_port,
                              slo=do_stall)
        desc = dict(apps=apps, servers=servers, mode=mode, cap=cap,
                    workload="gray", stall=do_stall, poison=do_poison,
                    policy=g_policy, stall_s=stall_s if do_stall else None,
                    slo=do_stall, faults=do_faults)
        t0 = time.monotonic()
        try:
            res = spawn_world(apps, servers, [1, 2, 3], app_fn,
                              cfg=cfg, timeout=150.0)
        except RuntimeError:
            # a clean abort classification is a valid outcome under
            # "abort" (hang detection, or a poison kill's EOF) — but it
            # must be CLEAN: bounded, never a hang
            assert g_policy == "abort", "survival policy aborted"
            assert time.monotonic() - t0 < 120.0, "gray abort hung"
            return desc
        if res.aborted:
            assert g_policy == "abort", "survival policy aborted"
            return desc
        # the world completed: coverage must be exact
        n_seen, tails, g_alerts = res.app_results[0]
        assert n_seen == n_units, res.app_results
        # tail-capture oracle: the adversity's journey reached the
        # master's /trace/tails with an anomalous terminal and hops
        # attributed to server ranks only (trace_sample=0, so nothing
        # here came from head sampling)
        server_ranks = set(range(apps, apps + servers))
        js = (tails or {}).get("journeys") or []
        if do_poison:
            quar = [j for j in js if j.get("end") == "quarantined"]
            assert quar, "quarantined journey missing from /trace/tails"
            qj = quar[0]
            assert qj.get("why") == ["quarantined"], qj
            stages = [s[0] for s in qj["spans"]]
            assert stages[0] == "put_recv" and stages[-1] == "finalize", \
                stages
            assert all(s[1] in server_ranks for s in qj["spans"]), \
                qj["spans"]
        if do_stall:
            expired = [
                j for j in js
                if "expire" in [s[0] for s in j.get("spans") or ()]
            ]
            assert expired, "expired-lease journey missing from /trace/tails"
            assert all(
                s[1] in server_ranks for j in expired for s in j["spans"]
            ), expired
        if do_stall:
            # short stall: the victim is fenced, resumes, and reports.
            # long stall (past the 2x hang bar): the world may complete
            # around the hung rank before it resumes — then it is a
            # counted casualty. Either way the FLEET survived with exact
            # coverage; vanishing without a trace is the only failure.
            assert victim in res.app_results or victim in res.casualties, \
                "stalled worker vanished"
            # page oracle: the adversity drove the burn-rate
            # engine to a page-severity FIRING (live /alerts state or
            # the transition history — the alert may already have
            # RESOLVED by the time rank 0's poll sampled it) ...
            ga = g_alerts or {}
            fired = any(
                a.get("state") == "FIRING" for a in ga.get("alerts") or []
            ) or any(
                h.get("to") == "FIRING" for h in ga.get("history") or []
            )
            assert fired, f"stall adversity never paged: {ga}"
            # ... and the FIRING snapshotted an incident bundle to the
            # flight dir whose suspect ranks name the SIGSTOP victim
            import glob as _glob
            import json as _json
            bundles = _glob.glob(os.path.join(
                os.environ.get("ADLB_FLIGHT_DIR", ""),
                f"incident-stall-{seed}-p*.json"))
            assert bundles, "page fired but no incident bundle on disk"
            with open(bundles[0]) as fh:
                bundle = _json.load(fh)
            assert victim in (bundle.get("suspect_ranks") or []), \
                (victim, bundle.get("suspect_ranks"))
        if do_poison:
            assert res.quarantined == 1, res.quarantined
            # poison kills at most budget+1 workers, and someone survives
            assert len(res.casualties) <= 3, res.casualties
        return desc

    if do_two_jobs:
        n_units = rng.randint(12, 30)
        tj_policy = kw["on_worker_failure"]
        app_fn = _App(two_jobs_economy, n_units, poison=True)
        desc = dict(apps=apps, servers=servers, mode=mode, cap=cap,
                    workload="two_jobs", policy=tj_policy,
                    faults=do_faults)
        t0 = time.monotonic()
        try:
            res = spawn_world(apps, servers, [1, 2, 3], app_fn,
                              cfg=cfg, timeout=150.0)
        except RuntimeError:
            assert tj_policy == "abort", "survival policy aborted"
            assert time.monotonic() - t0 < 120.0, "two-jobs abort hung"
            return desc
        if res.aborted:
            assert tj_policy == "abort", "survival policy aborted"
            return desc
        # both producers report full coverage of their OWN namespace
        assert res.app_results[0] == n_units, res.app_results
        assert res.app_results[1] == n_units, res.app_results
        # the poison unit was quarantined exactly once, in job A, and
        # only job-A workers (even ranks) could be casualties — job B's
        # pool must come through untouched
        assert res.quarantined == 1, res.quarantined
        assert all(r >= 2 and r % 2 == 0 for r in res.casualties), \
            res.casualties
        assert len(res.casualties) <= 2, res.casualties
        return desc

    if do_skill:
        n_units = rng.randint(24, 60)
        app_fn = _App(coverage_pool, n_units)
        desc = dict(apps=apps, servers=servers, mode=mode, native=native,
                    cap=cap, workload="coverage", skill=True,
                    s_policy=s_policy, victim_srv=victim_srv,
                    faults=do_faults)
        if s_policy == "abort":
            t0 = time.monotonic()
            try:
                res = spawn_world(apps, servers, [1, 2], app_fn,
                                  cfg=cfg, timeout=90.0)
                # the victim server may die after the pool drained; then
                # the world completes before the death can abort it
                done = [x for v in res.app_results.values() for x in v]
                assert sorted(set(done)) == list(range(n_units)), done
            except RuntimeError:
                assert time.monotonic() - t0 < 75.0, "server abort hung"
            return desc
        res = spawn_world(apps, servers, [1, 2], app_fn,
                          cfg=cfg, timeout=150.0)
        done = [x for v in res.app_results.values() for x in v]
        lost = sum(s.get(int(InfoKey.FAILOVER_LOST), 0.0)
                   + s.get(int(InfoKey.FAILOVER_RELAYS_UNRESOLVED), 0.0)
                   for s in res.server_stats.values())
        missing = set(range(n_units)) - set(done)
        assert len(missing) <= lost, (sorted(missing), lost)
        assert not res.aborted
        return desc

    if workload == "economy":
        n_pairs = rng.randint(8, 40)
        victim = rng.randrange(1, apps) if do_kill else None
        kill_after = rng.randint(0, 3)
        app_fn = _App(answer_economy, n_pairs, do_abort, do_spray,
                                victim=victim, kill_after=kill_after,
                                kill_at_end=policy == "reclaim")
        want = sum(a + a * 3 for a in range(n_pairs))
        if do_kill and policy == "abort":
            # either the EOF-driven abort classified cleanly (RuntimeError,
            # well before the harness timeout) or the victim finished its
            # share before reaching the kill point and the world completed
            t0 = time.monotonic()
            try:
                res = spawn_world(apps, servers, [1, 2], app_fn,
                                  cfg=cfg, timeout=90.0)
                assert victim in res.app_results, "victim vanished quietly"
                assert res.app_results[0] == want, (res.app_results, want)
            except RuntimeError:
                elapsed = time.monotonic() - t0
                assert elapsed < 60.0, f"abort classification hung {elapsed:.0f}s"
            return dict(apps=apps, servers=servers, mode=mode,
                        native=native, cap=cap, workload=workload,
                        spray=do_spray, abort=do_abort, kill=do_kill,
                        policy=policy, faults=do_faults)
        res = spawn_world(apps, servers, [1, 2], app_fn,
                          cfg=cfg, timeout=90.0)
        if do_abort:
            assert res.aborted, "abort did not propagate"
        else:
            assert res.app_results[0] == want, (res.app_results, want)
            if do_kill:
                # reclaim: the answer set is complete even though the
                # victim died (its leased work was re-enqueued); the
                # victim is a casualty, never an error
                assert res.casualties == [victim], res.casualties
                assert not res.aborted
            else:
                consumed = sum(
                    v for k, v in res.app_results.items() if k != 0)
                assert consumed == n_pairs, res.app_results
    else:
        n = rng.choice([6, 7])
        r = nq.run(n=n, num_app_ranks=apps, nservers=servers,
                   cfg=cfg, timeout=90.0)
        assert r.solutions == nq.KNOWN_SOLUTIONS[n], r.solutions
    return dict(apps=apps, servers=servers, mode=mode, native=native,
                cap=cap, workload=workload, spray=do_spray,
                abort=do_abort, kill=do_kill, policy=policy,
                faults=do_faults)


def main():
    args = list(sys.argv[1:])
    fabric = None
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        assert device in ("cuda", "cpu"), device
        del args[i:i + 2]
    if "--fabric" in args:
        i = args.index("--fabric")
        fabric = args[i + 1]
        assert fabric in ("auto", "shm", "tcp"), fabric
        del args[i:i + 2]
    minutes = float(args[0]) if args else 10.0
    seed0 = int(args[1]) if len(args) > 1 else 1000
    # every world in the soak writes flight-record post-mortems, so a
    # failure is diagnosable from artifacts instead of demanding a
    # replay (summarize with scripts/obs_report_torch.py <dir>)
    if "ADLB_FLIGHT_DIR" not in os.environ:
        os.environ["ADLB_FLIGHT_DIR"] = __import__("tempfile").mkdtemp(
            prefix="chaos-flight-"
        )
    flight = os.environ["ADLB_FLIGHT_DIR"]
    deadline = time.monotonic() + minutes * 60
    i = 0
    while time.monotonic() < deadline:
        seed = seed0 + i
        try:
            desc = one_iter(seed, fabric=fabric, device=device)
        except BaseException as e:
            print(f"CHAOS FAIL seed={seed} fabric={fabric} device={device}: "
                  f"{e!r}", flush=True)
            print(f"flight records in {flight} "
                  f"(python scripts/obs_report_torch.py {flight})",
                  flush=True)
            raise
        i += 1
        if i % 10 == 0:
            print(f"{i} iterations ok (last: {desc})", flush=True)
    print(f"CHAOS OK: {i} iterations, no failures")


if __name__ == "__main__":
    main()
