"""Client-side protocol engine.

Equivalent of the reference's L4 layer — ``ADLBP_Put`` / ``adlbp_Reserve`` /
``adlbp_Get_reserved_timed`` / batch puts (reference ``src/adlb.c:2638-3176``)
— over a Transport endpoint instead of tagged MPI sends.

Behavioral contract kept from the reference:

* targeted Puts are routed to the *target's* home server; untargeted Puts
  round-robin over servers (reference ``src/adlb.c:2767-2773``);
* rejected Puts retry at the server hinted by the rejecting server (the
  least-loaded one it knows of), with bounded retries and a short sleep, then
  return ADLB_PUT_REJECTED (reference ``src/adlb.c:2779-2796``);
* a targeted Put accepted off the target's home server notifies the home
  server so its targeted-work directory stays accurate (reference
  ``src/adlb.c:2845-2852``);
* Reserve blocks until work or a termination code; Ireserve returns
  ADLB_NO_CURRENT_WORK immediately (reference ``src/adlb.c:2868-2957``);
* Get_reserved fetches the batch-common prefix (possibly from a different
  server) before the unique payload bytes (reference ``src/adlb.c:2976-3025``).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Iterator, Optional, Sequence

from contextlib import nullcontext

from adlb_tpu_torch.obs.flight import FlightRecorder
from adlb_tpu_torch.obs.metrics import Registry, attach
from adlb_tpu_torch.runtime.messages import Msg, Tag, msg
from adlb_tpu_torch.runtime.trace import PID_APP, Tracer
from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE, Endpoint
from adlb_tpu_torch.runtime.world import Config, WorldSpec, normalize_req_types
from adlb_tpu_torch.types import (
    ADLB_BACKOFF,
    ADLB_FENCED,
    ADLB_NO_CURRENT_WORK,
    ADLB_NO_MORE_WORK,
    ADLB_PUT_REJECTED,
    ADLB_RETRY,
    ADLB_SUCCESS,
    AdlbAborted,
    AdlbError,
    GotWork,
    HomeServerLostError,
    ReserveResult,
    WorkHandle,
)


@dataclasses.dataclass
class _BatchState:
    common_server: int
    common_seqno: int
    common_len: int
    refcnt: int = 0


class Client:
    def __init__(
        self, world: WorldSpec, cfg: Config, ep: Endpoint, abort_event=None
    ) -> None:
        self.world = world
        self.cfg = cfg
        self.ep = ep
        self.rank = ep.rank
        self.home = world.home_server(self.rank)
        self._rr = self.rank % world.nservers  # round-robin cursor
        self._batch: Optional[_BatchState] = None
        # job namespace this rank is attached to (service mode): 0 = the
        # default/legacy namespace; attach() binds another and every
        # subsequent put/reserve rides in it (frames omit the field when
        # 0, so single-job traffic stays byte-identical)
        self.job = 0
        self._rqseqno = 0
        self._abort_event = abort_event
        self.aborted = False
        # MPE-equivalent event tracing (reference src/adlb_prof.c:46-74),
        # a run-time flag here instead of a compile-time one
        self.tracer: Optional[Tracer] = (
            Tracer(self.rank, pid=PID_APP, process_name="apps")
            if cfg.trace
            else None
        )
        # observability: per-rank metrics registry wired into the
        # transport (per-tag msgs/bytes, send/recv latency) + a flight
        # recorder dumped when this rank dies (abort, lost home server)
        self.metrics = Registry(self.rank)
        attach(ep, self.metrics)
        self.flight = FlightRecorder(
            self.rank, out_dir=cfg.flight_dir, role="app"
        )
        self.flight.metrics = self.metrics
        self.flight.context = {"home": self.home}
        self._reserved_types: dict[tuple[int, int], int] = {}  # (holder, seqno) -> type
        # app<->app messages that arrived while waiting for a protocol
        # response (the reference's app_comm traffic is a separate MPI
        # communicator, so it can never be confused with ADLB's tags; here
        # one fabric carries both, so AM_APP frames are stashed)
        self._app_inbox: list[Msg] = []
        # pipelined puts (iput): put_id -> request args, awaiting a
        # TA_PUT_RESP that may arrive out of band
        self._next_put_id = 1
        self._pending_puts: dict[int, dict] = {}
        self._failed_puts = 0
        self._failed_nmw = False
        # retry/backoff state: capped exponential backoff with
        # decorrelated jitter (sleep_k ~ U(base, 3*sleep_{k-1}), capped)
        # replaces the fixed put_retry_sleep spin — under contention the
        # fixed interval synchronized whole worker pools into retry
        # convoys. Seeded per rank: reproducible, and ranks decorrelate.
        self._retry_rng = random.Random(0xADB0 + 7919 * self.rank)
        # unit-lifecycle head sampling (Config(trace_sample)): its OWN
        # seeded RNG, so arming/raising the sample rate never perturbs
        # the retry-jitter stream (and sampling is reproducible per
        # rank). trace_sample=0 never draws — the put path is
        # allocation-identical to a pre-trace build.
        self._trace_rng = random.Random(0x7ACE ^ (104729 * self.rank))
        self._trace_seq = 0
        self._m_traced_puts = self.metrics.counter("traced_puts")
        self._m_put_retries = self.metrics.counter("put_retries")
        self._m_reserve_retries = self.metrics.counter("reserve_retries")
        self._m_reconnects = self.metrics.counter("reconnects")
        # client-side batch-common prefix cache (bounded LRU keyed by
        # (common_server, common_seqno)): members of a batch inline only
        # their suffix; the prefix is fetched once per client and cache
        # hits ship an SS_COMMON_FORFEIT accounting note instead of
        # bytes, keeping server refcounts (and prefix GC) exact
        self._prefix_cache: Optional[OrderedDict[tuple[int, int], bytes]] = (
            OrderedDict() if cfg.prefix_cache_bytes > 0 else None
        )
        self._prefix_cache_bytes = 0
        self._m_prefix_hits = self.metrics.counter("prefix_cache_hits")
        self._m_prefix_misses = self.metrics.counter("prefix_cache_misses")
        # at most one get_work_stream at a time: a concurrent blocking
        # reserve's _wait would race the stream's passive routing for
        # the same response tag
        self._active_stream: Optional[WorkStream] = None
        # server-failover routing (Config(on_server_failure="failover")):
        # dead server -> buddy, learned from epoch-stamped
        # TA_HOME_TAKEOVER notes; every server-bound send resolves
        # through it (stamping fo_from so content-addressed seqnos
        # translate at the buddy). _lost_at tracks when a server's
        # connection was observed gone, bounding how long a blocked wait
        # holds out for the takeover note.
        self._srv_route: dict[int, int] = {}
        self._fo_epoch = 0
        # master succession: TA_HOME_TAKEOVER notes for a dead MASTER
        # carry new_master (the promoted deputy); job control and detach
        # re-point through _master(). None = the spec's static master.
        # Per-instance on purpose — in-proc clients SHARE the WorldSpec.
        self._master_rank: Optional[int] = None
        # elastic membership: True once this rank cleanly detached (a
        # detached rank's finalize is a no-op); attached_member marks a
        # rank that JOINED a running world (membership.attach_app)
        self._detached = False
        self.attached_member = False
        self._lost_at: dict[int, float] = {}
        self._m_failovers = self.metrics.counter("home_takeovers")
        # frames _await_takeover pulled off the endpoint that belong to
        # an OUTER blocking wait (that wait can run nested inside _wait
        # via _apply_takeover's re-sends): queued here and consumed by
        # _recv before the endpoint, never dropped
        self._redeliver: deque = deque()
        # gray-failure surface (Config(lease_timeout_s) > 0): a liveness
        # heartbeat thread — protocol traffic piggybacks liveness, this
        # covers the idle-but-computing gaps so a BUSY rank is never
        # misread as hung while a SIGSTOP'd one (the thread freezes with
        # the process) is detected within the timeout
        self._m_fenced = self.metrics.counter("fenced_fetches")
        self._m_put_backoffs = self.metrics.counter("put_backoffs")
        # continuous-profiler role tag (obs/profile.py): a plain dict
        # write — in-proc worlds share the interpreter with the servers'
        # sampler, so app-rank stacks fold under "client" instead of a
        # raw thread name; a no-op when nothing ever profiles
        from adlb_tpu_torch.obs import profile as _profile

        _profile.register_thread("client")
        self._hb_stop: Optional[threading.Event] = None
        if cfg.lease_timeout_s > 0:
            self._hb_stop = threading.Event()
            threading.Thread(
                target=self._heartbeat_loop,
                daemon=True,
                name=f"adlb-hb-{self.rank}",
            ).start()

    def _heartbeat_loop(self) -> None:
        """FA_HEARTBEAT to every (routed) server at timeout/3 cadence.
        Endpoint sends are thread-safe; a peer that refuses is left to
        the protocol plane's own retry/failover machinery. Beacons are
        best-effort and periodic, so a dead destination gets only a
        short connect grace — the default 15 s grace would stall the
        whole round behind one dead server (the takeover remap happens
        on the main thread) and starve the beacons that keep healthy
        servers from declaring this rank hung."""
        from adlb_tpu_torch.obs import profile as _profile

        _profile.register_thread("heartbeat")
        interval = max(self.cfg.lease_timeout_s / 3.0, 0.005)
        while not self._hb_stop.wait(interval):
            for dest in {self._route(s) for s in self.world.server_ranks}:
                try:
                    self.ep.send(
                        dest, msg(Tag.FA_HEARTBEAT, self.rank),
                        connect_grace=0.25,
                    )
                except OSError:
                    pass

    def _stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()

    def _recv(self, timeout):
        """Endpoint recv that drains takeover-deferred frames first."""
        if self._redeliver:
            return self._redeliver.popleft()
        return self.ep.recv(timeout=timeout)

    def _span(self, name: str, **args):
        """API-call trace span + user-state inference boundary."""
        if self.tracer is None:
            return nullcontext()
        self.tracer.api_entry()
        return self.tracer.span(name, **args)

    def _sample_trace(self):
        """Head-sampling decision for one put: a minted trace id (rank
        in the high bits, per-rank sequence below — unique world-wide)
        or None. The id rides FA_PUT as codec field 98 and the unit's
        journey is recorded server-side (obs/journey.py)."""
        rate = self.cfg.trace_sample
        if not rate or self._trace_rng.random() >= rate:
            return None
        self._trace_seq += 1
        self._m_traced_puts.inc()
        return ((self.rank + 1) << 32) | (self._trace_seq & 0xFFFFFFFF)

    # -- plumbing ------------------------------------------------------------

    def _next_server(self) -> int:
        # indexed through server_ranks, not rank arithmetic: under
        # elastic membership scale-out server ids are not contiguous
        # with the base range (a plain WorldSpec's range indexes the
        # same way)
        servers = self.world.server_ranks
        s = servers[self._rr % len(servers)]
        self._rr = (self._rr + 1) % len(servers)
        return s

    def _route_put(self, target_rank: int) -> int:
        """Initial server for a put (reference src/adlb.c:2767-2773)."""
        if target_rank >= 0:
            try:
                return self.world.home_server(target_rank)
            except KeyError:
                # an attached rank this client's membership view has not
                # learned: route via our own home — the receiving server
                # announces the inventory to the target's real home
                # (off-home TargetedDirectory redirection)
                return self.home
        if self.cfg.put_routing == "home":
            return self.home
        return self._next_server()

    def _retry_server(self, hint) -> int:
        """Where a rejected put retries: the rejecting server's least-loaded
        hint, else round-robin (reference src/adlb.c:2779-2796)."""
        return hint if hint is not None and hint >= 0 else self._next_server()

    def _backoff_sleep(self, prev: float, cap: Optional[float] = None) -> float:
        """Sleep one capped decorrelated-jitter step and return it (feed it
        back in as ``prev`` for the next attempt). ``cap`` overrides
        ``put_retry_cap`` for paths that must stay short."""
        base = self.cfg.put_retry_sleep
        s = min(
            self.cfg.put_retry_cap if cap is None else cap,
            self._retry_rng.uniform(base, max(base, prev * 3.0)),
        )
        time.sleep(s)
        return s

    def _jitter_hint(self, hint_s: float, cap: float) -> float:
        """Decorrelate a server-carried retry-after hint. The server's
        ``retry_after_ms`` is deterministic (the same constant on every
        ADLB_BACKOFF), so honoring it verbatim re-synchronizes every
        backpressured client into a retry convoy exactly one hint
        later. Bounded multiplicative jitter [1.0, 1.5) drawn from this
        client's own seeded retry RNG (never a shared stream) spreads
        the wave without ever undercutting the server's ask; the site's
        cap still wins."""
        return min(cap, hint_s * (1.0 + 0.5 * self._retry_rng.random()))

    def _route(self, dest: int) -> int:
        """Resolve a server destination through the failover map (chains
        of takeovers resolve to the final live buddy)."""
        seen = set()
        while dest in self._srv_route and dest not in seen:
            seen.add(dest)
            dest = self._srv_route[dest]
        return dest

    def _failover_policy(self) -> bool:
        return self.cfg.on_server_failure == "failover"

    def _send_retry(self, dest: int, m: Msg) -> None:
        """Protocol send that survives peer-connection churn: the endpoint
        already retries the socket once; past that the client backs off
        and re-sends up to ``cfg.reconnect_attempts`` times instead of
        dying on the first OSError. Under ``on_server_failure="failover"``
        a server destination additionally resolves through the takeover
        map (stamped ``fo_from`` so the buddy translates content
        addresses), and exhausted retries wait out one takeover window
        before giving up; otherwise an unreachable peer is terminal.

        Under failover a server send connects with a short grace
        (``UP_PEER_GRACE``: every listener was up before the app ran, so
        a refusal means the server died), and each failed send
        first applies the takeover notes already queued for this rank: a
        rank whose first frame to a server comes after that server died
        re-sends to its buddy at once, instead of spending every retry
        on the dead rank's connect grace while the note that remaps it
        waits unread."""
        attempts = self.cfg.reconnect_attempts
        if dest in getattr(self.ep, "binary_peers", ()):
            # native servers implement none of the duplicate-request
            # dedup (put ids, rqseqno, at-most-once get cache) the
            # re-send protocol relies on — fail fast rather than risk a
            # double-stored put or a double-consumed fetch
            attempts = 0
        waited_takeover = False
        sleep = 0.0
        attempt = 0
        while True:
            routed = self._route(dest)
            if routed != dest and self.world.is_server(dest):
                m.data["fo_from"] = dest
            failover = self._failover_policy() and \
                self.world.is_server(routed)
            try:
                if failover:
                    self.ep.send(routed, m, connect_grace=UP_PEER_GRACE)
                else:
                    self.ep.send(routed, m)
                return
            except OSError as e:
                attempt += 1
                if failover and self._poll_takeover(routed):
                    continue  # remapped: re-send to the buddy at once
                if attempt > attempts:
                    if (
                        self._failover_policy()
                        and self.world.is_server(routed)
                        and not waited_takeover
                        and self._await_takeover(routed)
                    ):
                        # buddy announced itself: restart the retry
                        # budget toward the new destination
                        waited_takeover = True
                        attempt = 0
                        continue
                    # a permanently unreachable protocol peer ends this
                    # client — raise the conn-lost error the harnesses
                    # classify (abort collateral / casualty), never a
                    # bare OSError that would read as an application bug
                    self.aborted = True
                    self.flight.record(
                        f"peer {routed} unreachable after "
                        f"{attempt} send attempts: {e!r}"
                    )
                    self.flight.dump_json("home_server_lost")
                    raise HomeServerLostError(
                        f"rank {self.rank}: protocol peer {routed} "
                        f"unreachable ({e!r})"
                    ) from e
                self._m_reconnects.inc()
                self.flight.record(
                    f"reconnect dest={routed} attempt={attempt} ({e!r})"
                )
                sleep = self._backoff_sleep(max(sleep, 0.01))

    def _poll_takeover(self, lost: int) -> bool:
        """Apply the frames already queued for this rank, as
        :meth:`_await_takeover` does, without waiting; returns True when a
        TA_HOME_TAKEOVER among them remapped ``lost``."""
        while self._route(lost) == lost:
            m = self.ep.recv(timeout=0)
            if m is None:
                break
            self._takeover_wait_frame(m)
        return self._route(lost) != lost

    def _await_takeover(self, lost: int) -> bool:
        """Block (reading only control frames; everything else stays in
        the endpoint queue order via a bounded drain-and-redeliver) until
        a TA_HOME_TAKEOVER covers ``lost`` or the failover window
        expires. Returns True when the route changed."""
        self._lost_at.setdefault(lost, time.monotonic())
        deadline = (
            self._lost_at[lost] + self.cfg.failover_client_wait
        )
        while time.monotonic() < deadline:
            if self._abort_event is not None and self._abort_event.is_set():
                self.aborted = True
                raise AdlbAborted(-1)
            if self._route(lost) != lost:
                return True
            m = self.ep.recv(timeout=0.2)
            if m is not None:
                self._takeover_wait_frame(m)
        return self._route(lost) != lost

    def _takeover_wait_frame(self, m: Msg) -> None:
        """One frame read while waiting for a takeover: control frames
        are applied, frames with a home regardless of context dispatched,
        and the rest queued for the next ``_recv``."""
        if m.tag is Tag.TA_HOME_TAKEOVER:
            self._apply_takeover(m)
            return
        if m.tag is Tag.TA_ABORT:
            self._dispatch_passive(m)  # raises AdlbAborted
        if (
            m.tag in (Tag.AM_APP, Tag.PEER_EOF)
            or (m.tag is Tag.TA_PUT_RESP
                and m.data.get("put_id") in self._pending_puts)
            or (m.tag is Tag.TA_RESERVE_RESP
                and self._active_stream is not None)
        ):
            # stash / settle / bank through the normal passive
            # dispatch — these have a home regardless of context
            try:
                self._dispatch_passive(m)
            except AdlbError:
                # an unexpected-for-this-context frame must not turn
                # the takeover wait into a protocol error
                self.flight.record(
                    f"frame {m.tag.name} deferred during takeover wait"
                )
            return
        # anything else may be the very response an OUTER wait is
        # parked on (this wait can run nested inside _wait via
        # _apply_takeover's re-sends): dispatching here would DROP it
        # as a stray and deadlock the outer wait against a healthy
        # server — queue it for redelivery to the next _recv instead
        self._redeliver.append(m)

    def _check_failover_resend(self, sent_to, dest, m_req):
        """While blocked on a response from ``sent_to``: a takeover that
        remapped the destination re-sends the request to the buddy (same
        ids — the replicated dedup windows and fo_from translation make
        that safe); a destination lost past the failover window (or
        under the abort policy) is terminal."""
        if dest is None or not self._failover_policy():
            return sent_to
        routed = self._route(dest)
        if routed != sent_to:
            self.flight.record(
                f"re-sending {m_req.tag.name} to {routed} after takeover"
            )
            self._send_retry(dest, m_req)  # resolves + stamps fo_from
            return routed
        lost = self._lost_at.get(sent_to)
        if (
            lost is not None
            and time.monotonic() - lost > self.cfg.failover_client_wait
        ):
            self.aborted = True
            self.flight.record(
                f"server {sent_to} lost and no takeover within "
                f"{self.cfg.failover_client_wait}s"
            )
            self.flight.dump_json("home_server_lost")
            raise HomeServerLostError(
                f"rank {self.rank}: server {sent_to} lost; no takeover"
            )
        return sent_to

    def _wait_put(self, put_id: int, dest=None, m_req=None) -> Msg:
        """Wait for THIS put's response, matched by id: a frame re-sent
        after a send error can be acked twice, and the stale duplicate
        ack must not be mistaken for a later put's answer."""
        sent_to = self._route(dest) if dest is not None else None
        while True:
            if self._abort_event is not None and self._abort_event.is_set():
                self.aborted = True
                self.flight.record("abort event observed waiting put resp")
                self.flight.dump_json("abort_event")
                raise AdlbAborted(-1)
            m = self._recv(timeout=0.5)
            if m is None:
                sent_to = self._check_failover_resend(sent_to, dest, m_req)
                continue
            if m.tag is Tag.TA_PUT_RESP and m.data.get("put_id") == put_id:
                return m
            self._dispatch_passive(m, waiting=Tag.TA_PUT_RESP)
            sent_to = self._check_failover_resend(sent_to, dest, m_req)

    def _wait(self, want: Tag, dest=None, m_req=None) -> Msg:
        sent_to = self._route(dest) if dest is not None else None
        while True:
            if self._abort_event is not None and self._abort_event.is_set():
                self.aborted = True
                self.flight.record(f"abort event observed waiting {want}")
                self.flight.dump_json("abort_event")
                raise AdlbAborted(-1)
            m = self._recv(timeout=0.5)
            if m is None:
                sent_to = self._check_failover_resend(sent_to, dest, m_req)
                continue
            if m.tag is want and not (
                m.tag is Tag.TA_PUT_RESP
                and m.data.get("put_id") in self._pending_puts
            ):
                # (the guard keeps an out-of-band pipelined-put response
                # from answering a synchronous put)
                return m
            # A late RESERVE_RESP can cross a termination flush only if the
            # origin server double-responded, which the rq discipline forbids.
            self._dispatch_passive(m, waiting=want)
            sent_to = self._check_failover_resend(sent_to, dest, m_req)

    # -- Put family ----------------------------------------------------------

    def put(
        self,
        payload: bytes,
        work_type: int,
        work_prio: int = 0,
        target_rank: int = -1,
        answer_rank: int = -1,
    ) -> int:
        with self._span(
            "adlb:put", work_type=work_type, prio=work_prio, len=len(payload)
        ):
            return self._put(payload, work_type, work_prio, target_rank, answer_rank)

    def _validate_target(self, target_rank: int) -> None:
        """Targeted-put destination check. Ranks ABOVE the base world
        (and the sidecar pseudo-rank) may be dynamically attached
        members this client's — possibly static — view has not learned:
        those pass through, and the SERVERS, which hold the
        authoritative membership, answer an unknown target loudly
        (elastic membership, adlb_tpu_torch/runtime/membership.py). In-range
        non-app ranks are always a caller bug."""
        if target_rank < 0 or self.world.is_app(target_rank):
            return
        from adlb_tpu_torch.runtime.membership import is_provisional

        if target_rank <= self.world.nranks or is_provisional(target_rank):
            raise AdlbError(
                f"target rank {target_rank} is not an app rank"
            )

    def _put(
        self,
        payload: bytes,
        work_type: int,
        work_prio: int,
        target_rank: int,
        answer_rank: int,
    ) -> int:
        if not self.world.validate_type(work_type):
            raise AdlbError(f"unregistered work type {work_type}")
        self._validate_target(target_rank)
        common = self._batch
        if common is not None:
            common.refcnt += 1

        server = self._route_put(target_rank)
        attempts = 0
        sleep = 0.0
        # synchronous puts carry an id too (same counter as iput): a
        # send retried across an OSError may have been delivered the
        # first time, and the server's per-sender dedup window turns the
        # re-send into an idempotent ack instead of a duplicated unit
        put_id = self._next_put_id
        self._next_put_id += 1
        trace_id = self._sample_trace()  # one decision per logical put:
        # retries/re-routes keep the id (the server dedup window keeps
        # re-sends from double-tracing a unit)
        while True:
            pm = msg(
                Tag.FA_PUT,
                self.rank,
                payload=bytes(payload),
                work_type=work_type,
                prio=work_prio,
                target_rank=target_rank,
                answer_rank=answer_rank,
                common_len=common.common_len if common else 0,
                common_server=common.common_server if common else -1,
                common_seqno=common.common_seqno if common else -1,
                put_id=put_id,
            )
            if self.job:
                pm.data["job_id"] = self.job
            if trace_id is not None:
                pm.data["trace_id"] = trace_id
            self._send_retry(server, pm)
            resp = self._wait_put(put_id, dest=server, m_req=pm)
            rc = resp.rc
            if rc == ADLB_BACKOFF:
                # overload backpressure: the server (and, it believes,
                # every peer) is above the hard watermark — hopping
                # would not help. Retry the SAME server after the
                # carried retry-after hint fed into the decorrelated-
                # jitter backoff, WITHOUT burning the retry budget:
                # shedding load, not failing the put.
                self._m_put_backoffs.inc()
                hint_s = self._jitter_hint(
                    float(resp.data.get("retry_after_ms", 25) or 25) / 1e3,
                    self.cfg.put_retry_cap,
                )
                self.flight.record(
                    f"put_backoff server={server} retry_after_s={hint_s}"
                )
                sleep = self._backoff_sleep(max(sleep, hint_s))
                continue
            if rc not in (ADLB_PUT_REJECTED, ADLB_RETRY):
                break
            attempts += 1
            if attempts > self.cfg.put_max_retries:
                if common is not None:
                    common.refcnt -= 1
                # the documented contract for retries-exhausted puts is
                # ADLB_PUT_REJECTED, whatever the last transient rc was
                return ADLB_PUT_REJECTED
            if rc == ADLB_PUT_REJECTED:
                # capacity: try the hinted (least-loaded) server;
                # ADLB_RETRY is transient at THIS server — same target
                server = self._retry_server(resp.data.get("hint"))
            self._m_put_retries.inc()
            sleep = self._backoff_sleep(sleep)
        if rc != ADLB_SUCCESS and common is not None:
            common.refcnt -= 1  # unit never stored; keep prefix GC reachable
        try:
            t_home = (
                self.world.home_server(target_rank)
                if target_rank >= 0 else -1
            )
        except KeyError:
            # an attached member this view has not learned: the
            # receiving server's own off-home announce covers it
            t_home = server
        if (
            rc == ADLB_SUCCESS
            and target_rank >= 0
            and server != t_home
        ):
            self._send_retry(
                t_home,
                msg(
                    Tag.FA_DID_PUT_AT_REMOTE,
                    self.rank,
                    target_rank=target_rank,
                    work_type=work_type,
                    server_rank=server,
                ),
            )
        return rc

    def begin_batch_put(self, common_buf: bytes) -> int:
        """Store a shared prefix once; subsequent puts reference it
        (reference ``src/adlb.c:2638-2722``)."""
        if self._batch is not None:
            raise AdlbError("nested Begin_batch_put")
        ctx = self._span("adlb:begin_batch_put", len=len(common_buf))
        with ctx:
            return self._begin_batch_put(common_buf)

    def _begin_batch_put(self, common_buf: bytes) -> int:
        if len(common_buf) == 0:
            # NULL/empty prefix (the reference allows it, src/adlb.c:2638):
            # batch bracketing with nothing to share — no server round trip,
            # nothing for the server to store or GC
            self._batch = _BatchState(common_server=-1, common_seqno=-1,
                                      common_len=0)
            return ADLB_SUCCESS
        server = self._next_server()
        pm = msg(Tag.FA_PUT_COMMON, self.rank, payload=bytes(common_buf))
        self._send_retry(server, pm)
        resp = self._wait(Tag.TA_PUT_COMMON_RESP, dest=server, m_req=pm)
        if resp.rc != ADLB_SUCCESS:
            return resp.rc
        self._batch = _BatchState(
            common_server=server,
            common_seqno=resp.common_seqno,
            common_len=len(common_buf),
        )
        return ADLB_SUCCESS

    def end_batch_put(self) -> int:
        """Ship the final refcount so the server can GC the prefix once every
        member has been fetched (reference ``src/adlb.c:2724-2751``)."""
        if self._batch is None:
            raise AdlbError("End_batch_put without Begin_batch_put")
        b = self._batch
        self._batch = None
        if b.common_server < 0:  # empty-prefix batch: nothing stored
            return ADLB_SUCCESS
        with self._span("adlb:end_batch_put"):
            self._send_retry(
                b.common_server,
                msg(
                    Tag.FA_BATCH_DONE,
                    self.rank,
                    common_seqno=b.common_seqno,
                    refcnt=b.refcnt,
                ),
            )
        return ADLB_SUCCESS

    # -- Reserve / Get family ------------------------------------------------

    def _reserve_rpc(self, **fields) -> Msg:
        """One FA_RESERVE round trip, retried with backoff on ADLB_RETRY
        (a transient server-side condition, e.g. this rank reconnecting
        while its rank-death fan-out settles). Every retry is a fresh
        rqseqno — the previous request is dead at the server."""
        if self._active_stream is not None:
            # reservation responses carry no request id, so a blocking
            # reserve could not tell its answer from a stream delivery
            raise AdlbError(
                "reserve/get_work while a get_work_stream is open; close "
                "the stream first"
            )
        sleep = 0.0
        while True:
            self._rqseqno += 1
            pm = msg(Tag.FA_RESERVE, self.rank, rqseqno=self._rqseqno,
                     **fields)
            if self.job:
                pm.data["job_id"] = self.job
            self._send_retry(self.home, pm)
            resp = self._wait(Tag.TA_RESERVE_RESP, dest=self.home, m_req=pm)
            if resp.rc != ADLB_RETRY:
                return resp
            self._m_reserve_retries.inc()
            sleep = self._backoff_sleep(sleep)

    def _reserve(
        self, req_types: Optional[Sequence[int]], hang: bool
    ) -> tuple[int, Optional[ReserveResult]]:
        types = normalize_req_types(req_types, self.world.types)
        resp = self._reserve_rpc(
            req_types=None if types is None else sorted(types),
            hang=hang,
        )
        if resp.rc != ADLB_SUCCESS:
            return resp.rc, None
        result = ReserveResult(
            work_type=resp.work_type,
            work_prio=resp.prio,
            handle=WorkHandle.from_ints(resp.handle),
            work_len=resp.work_len,
            answer_rank=resp.answer_rank,
        )
        if self.tracer is not None:
            # remembered so get_reserved can start the inferred user-state
            # span with the unit's type (reference src/adlb_prof.c:185-236);
            # keyed by (holder, seqno) — seqnos are per-server counters
            key = (result.handle.server_rank, result.handle.seqno)
            self._reserved_types[key] = result.work_type
        return ADLB_SUCCESS, result

    def reserve(
        self, req_types: Optional[Sequence[int]] = None
    ) -> tuple[int, Optional[ReserveResult]]:
        """Blocking reserve: returns only with work or a termination code."""
        with self._span("adlb:reserve"):
            return self._reserve(req_types, hang=True)

    def ireserve(
        self, req_types: Optional[Sequence[int]] = None
    ) -> tuple[int, Optional[ReserveResult]]:
        """Non-blocking reserve: ADLB_NO_CURRENT_WORK if nothing matches now."""
        with self._span("adlb:ireserve"):
            rc, res = self._reserve(req_types, hang=False)
        if rc == ADLB_NO_CURRENT_WORK:
            return rc, None
        return rc, res

    def get_reserved_timed(
        self, handle: WorkHandle
    ) -> tuple[int, Optional[bytes], float]:
        with self._span("adlb:get_reserved"):
            rc, buf, t = self._get_reserved_timed(handle)
        if self.tracer is not None:
            wt = self._reserved_types.pop(
                (handle.server_rank, handle.seqno), -1
            )
            if rc == ADLB_SUCCESS:
                self.tracer.got_work(wt)
        return rc, buf, t

    def _fetch_prefix(
        self, common_server: int, common_seqno: int
    ) -> tuple[int, bytes]:
        """Batch-common prefix bytes, through the client LRU cache.

        A hit serves locally and ships an SS_COMMON_FORFEIT accounting
        note (``op="forfeit"`` = count one get without re-sending bytes)
        so the server's refcount — and thus prefix GC — stays exact: one
        accounting event per batch member, fetched or cached. Native
        common servers bypass the cache entirely (their frame decoder
        rejects the forfeit tag), paying the fetch as before."""
        key = (common_server, common_seqno)
        cache = self._prefix_cache
        if common_server in getattr(self.ep, "binary_peers", ()):
            cache = None
        if cache is not None:
            buf = cache.get(key)
            if buf is not None:
                cache.move_to_end(key)
                self._m_prefix_hits.inc()
                # get_id (same counter as put ids): a forfeit re-sent
                # across connection churn must not be applied twice —
                # an over-forfeit would GC the prefix one get early and
                # drop a live member
                fid = self._next_put_id
                self._next_put_id += 1
                self._send_retry(
                    common_server,
                    msg(Tag.SS_COMMON_FORFEIT, self.rank,
                        common_seqno=common_seqno, op="forfeit",
                        get_id=fid),
                )
                return ADLB_SUCCESS, buf
        # get_id (same per-client counter as put ids) lets the server
        # tell a re-sent duplicate from a legitimate second fetch of
        # the same prefix (one fetch per batch member is normal)
        get_id = self._next_put_id
        self._next_put_id += 1
        pm = msg(Tag.FA_GET_COMMON, self.rank,
                 common_seqno=common_seqno, get_id=get_id)
        self._send_retry(common_server, pm)
        resp = self._wait(Tag.TA_GET_COMMON_RESP, dest=common_server,
                          m_req=pm)
        if resp.rc != ADLB_SUCCESS:
            return resp.rc, b""
        self._m_prefix_misses.inc()
        buf = resp.payload
        if cache is not None and len(buf) <= self.cfg.prefix_cache_bytes:
            cache[key] = buf
            self._prefix_cache_bytes += len(buf)
            while self._prefix_cache_bytes > self.cfg.prefix_cache_bytes:
                _, old = cache.popitem(last=False)
                self._prefix_cache_bytes -= len(old)
        return ADLB_SUCCESS, buf

    def _get_reserved_timed(
        self, handle: WorkHandle
    ) -> tuple[int, Optional[bytes], float]:
        prefix = b""
        if handle.common_len > 0:
            rc, prefix = self._fetch_prefix(
                handle.common_server_rank, handle.common_seqno
            )
            if rc == ADLB_RETRY:
                # prefix lost to a server failover (a counted loss): the
                # suffix alone is not the unit, but the reservation must
                # still drain — consume and discard it, then let the
                # caller re-reserve. Returning without the fetch would
                # leak the pin and hang exhaustion on a unit nobody can
                # ever complete.
                pm = msg(Tag.FA_GET_RESERVED, self.rank, seqno=handle.seqno)
                self._send_retry(handle.server_rank, pm)
                self._wait(Tag.TA_GET_RESERVED_RESP,
                           dest=handle.server_rank, m_req=pm)
                return ADLB_RETRY, None, 0.0
            if rc != ADLB_SUCCESS:
                # prefix no longer exists (reclaim edge): surface the
                # error; a truncated payload must never look like success
                return rc, None, 0.0
        pm = msg(Tag.FA_GET_RESERVED, self.rank, seqno=handle.seqno)
        self._send_retry(handle.server_rank, pm)
        resp = self._wait(Tag.TA_GET_RESERVED_RESP, dest=handle.server_rank,
                          m_req=pm)
        if resp.rc == ADLB_FENCED:
            # our lease on this unit EXPIRED (this rank went silent past
            # lease_timeout_s — e.g. it was SIGSTOP'd and resumed): the
            # unit was re-enqueued under a new attempt and this settle
            # is rejected. Mapped onto the existing ADLB_RETRY path —
            # drop the handle and re-reserve — so every retry loop
            # (get_work, streams, app-level reclaim handling) absorbs it
            # unchanged.
            self._m_fenced.inc()
            self.flight.record(
                f"fenced fetch seqno={handle.seqno} -> retry"
            )
            return ADLB_RETRY, None, 0.0
        if resp.rc != ADLB_SUCCESS:
            return resp.rc, None, 0.0
        return ADLB_SUCCESS, prefix + resp.payload, resp.time_on_q

    def get_reserved(self, handle: WorkHandle) -> tuple[int, Optional[bytes]]:
        rc, buf, _ = self.get_reserved_timed(handle)
        return rc, buf

    def get_work(
        self, req_types: Optional[Sequence[int]] = None
    ) -> tuple[int, Optional[GotWork]]:
        """Fused blocking reserve+get (no reference analogue — upstream
        always pays a second round trip for the payload, reference
        ``src/adlb.c:2976-3025``). When the matched unit is local to the
        responding server and has no batch-common prefix, the payload rides
        the reservation response; otherwise this transparently falls back
        to the handle + Get_reserved path (remote holders, prefixed
        units)."""
        with self._span("adlb:get_work"):
            types = normalize_req_types(req_types, self.world.types)
            sleep = 0.0
            while True:
                resp = self._reserve_rpc(
                    req_types=None if types is None else sorted(types),
                    hang=True,
                    fetch=True,
                )
                if resp.rc != ADLB_SUCCESS:
                    return resp.rc, None
                rc, got = self._decode_single_got(resp)
                if rc != ADLB_RETRY:
                    return rc, got
                # void handle (failover tombstone / reclaim resurrect):
                # the unit is gone — re-reserve rather than surface a
                # transient code as termination
                self._m_reserve_retries.inc()
                sleep = self._backoff_sleep(sleep)

    def _decode_single_got(self, resp) -> tuple[int, Optional[GotWork]]:
        """Decode a successful single-unit TA_RESERVE_RESP: fused (payload
        inline — whole for prefix-free units, suffix + common handle for
        batch-common ones) or handle fallback (e.g. a native server that
        predates the remote fuse)."""
        if "payload" in resp.data:  # fused: already consumed
            payload = resp.payload
            if resp.data.get("common_len", 0) > 0:
                rc, prefix = self._fetch_prefix(
                    resp.common_server, resp.common_seqno
                )
                if rc != ADLB_SUCCESS:
                    # prefix gone (reclaim edge): a truncated payload
                    # must never look like success
                    return rc, None
                payload = prefix + payload
            got = GotWork(
                work_type=resp.work_type,
                work_prio=resp.prio,
                payload=payload,
                answer_rank=resp.answer_rank,
                time_on_q=resp.data.get("time_on_q", 0.0),
            )
            if self.tracer is not None:
                self.tracer.got_work(got.work_type)
            return ADLB_SUCCESS, got
        handle = WorkHandle.from_ints(resp.handle)
        rc, buf, t_q = self._get_reserved_timed(handle)
        if rc != ADLB_SUCCESS:
            return rc, None
        if self.tracer is not None:
            self.tracer.got_work(resp.work_type)
        return ADLB_SUCCESS, GotWork(
            work_type=resp.work_type,
            work_prio=resp.prio,
            payload=buf,
            answer_rank=resp.answer_rank,
            time_on_q=t_q,
        )

    def get_work_batch(
        self,
        req_types: Optional[Sequence[int]] = None,
        max_units: int = 8,
    ) -> tuple[int, list[GotWork]]:
        """Blocking fused reserve+get of up to ``max_units`` units in ONE
        round trip (no reference analogue). The responding server inlines
        as many LOCAL prefix-free matches as it holds (capped at
        ``max_units``); remote holders and prefixed units fall back to the
        single-unit path, so a batch never costs extra round trips — it
        only amortizes them when the balancer has pre-positioned local
        inventory. Returns ``(ADLB_SUCCESS, [GotWork, ...])`` (at least
        one), or ``(rc, [])`` on termination."""
        if max_units < 1:
            raise AdlbError("get_work_batch: max_units must be >= 1")
        with self._span("adlb:get_work_batch"):
            types = normalize_req_types(req_types, self.world.types)
            sleep = 0.0
            while True:
                resp = self._reserve_rpc(
                    req_types=None if types is None else sorted(types),
                    hang=True,
                    fetch=True,
                    fetch_max=max_units,
                )
                if resp.rc != ADLB_SUCCESS:
                    return resp.rc, []
                if "payloads" in resp.data:  # batch-fused: already consumed
                    out = []
                    d = resp.data
                    for i, payload in enumerate(d["payloads"]):
                        out.append(GotWork(
                            work_type=d["work_types"][i],
                            work_prio=d["prios"][i],
                            payload=payload,
                            answer_rank=d["answer_ranks"][i],
                            time_on_q=d["times_on_q"][i],
                        ))
                        if self.tracer is not None:
                            self.tracer.got_work(d["work_types"][i])
                    return ADLB_SUCCESS, out
                # single-unit response (a park wake-up, a remote/prefixed
                # fallback, or a server that ignores fetch_max)
                rc, got = self._decode_single_got(resp)
                if rc != ADLB_RETRY:
                    return rc, [got] if got is not None else []
                # void handle (failover tombstone / reclaim resurrect):
                # re-reserve with backoff, as get_work does
                self._m_reserve_retries.inc()
                sleep = self._backoff_sleep(sleep)

    # -- prefetch pipeline (get_work_stream) ----------------------------------

    def get_work_stream(
        self, req_types: Optional[Sequence[int]] = None, depth: int = 2
    ) -> "WorkStream":
        """Iterator of :class:`GotWork` that keeps up to ``depth`` fused
        reserves in flight so the next unit's delivery overlaps the
        current unit's compute (no reference analogue — upstream's
        consumer loop serializes Reserve and Get_reserved round trips
        against the work itself). Ends cleanly at NO_MORE_WORK /
        DONE_BY_EXHAUSTION (the termination code is left in ``.rc``);
        ADLB_RETRY deliveries (reclaim-mode resurrection) re-arm the
        slot with backoff. Toward a native home server — which has no
        multi-entry reserve queue — the stream degrades to repeated
        fused ``get_work`` calls."""
        types = normalize_req_types(req_types, self.world.types)
        if self.home in getattr(self.ep, "binary_peers", ()):
            return _SerialStream(self, req_types)
        if self._active_stream is not None:
            raise AdlbError("only one get_work_stream may be open at a time")
        stream = WorkStream(self, types, depth)
        self._active_stream = stream
        return stream

    # -- app <-> app messaging (the reference's app_comm) ---------------------
    #
    # ADLB_Init returns an app-ranks-only communicator on which applications
    # exchange ordinary point-to-point messages alongside ADLB calls — e.g.
    # c1.c ships B/C answers rank-to-rank with MPI_Send/Iprobe/Recv on
    # app_comm (reference src/adlb.c:256,318; examples/c1.c). Here the same
    # fabric carries those messages under the AM_APP tag with a user tag
    # inside; app rank numbering coincides with world rank numbering for
    # ranks < num_app_ranks, as in the reference (src/adlb.c:252-257).

    def app_send(self, dest_app_rank: int, payload, apptag: int = 0) -> None:
        """Point-to-point message to another app rank (MPI_Send on app_comm)."""
        if not (0 <= dest_app_rank < self.world.num_app_ranks):
            raise AdlbError(f"app_send: {dest_app_rank} is not an app rank")
        self.ep.send(
            dest_app_rank,
            msg(Tag.AM_APP, self.rank, payload=payload, apptag=int(apptag)),
        )

    def _match_app(self, apptag: Optional[int], src: Optional[int]) -> Optional[int]:
        for i, m in enumerate(self._app_inbox):
            if apptag is not None and m.apptag != apptag:
                continue
            if src is not None and m.src != src:
                continue
            return i
        return None

    def app_iprobe(
        self, apptag: Optional[int] = None, src: Optional[int] = None
    ) -> bool:
        """Non-blocking check for a pending app message (MPI_Iprobe)."""
        self._drain_inbox()
        return self._match_app(apptag, src) is not None

    def app_recv(
        self,
        apptag: Optional[int] = None,
        src: Optional[int] = None,
        timeout: Optional[float] = None,
    ):
        """Receive an app message; returns (payload, src_rank, apptag).

        Blocks until a matching message arrives (MPI_Recv), or returns None
        on timeout.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # drain already-delivered frames first so a zero/expired timeout
            # still sees messages sitting in the endpoint queue
            self._drain_inbox()
            i = self._match_app(apptag, src)
            if i is not None:
                m = self._app_inbox.pop(i)
                return m.payload, m.src, m.apptag
            if self._abort_event is not None and self._abort_event.is_set():
                self.aborted = True
                raise AdlbAborted(-1)
            remaining = 0.2
            if deadline is not None:
                remaining = min(remaining, deadline - time.monotonic())
                if remaining <= 0:
                    return None
            m = self._recv(timeout=remaining)
            if m is None:
                continue
            self._dispatch_passive(m)

    def _drain_inbox(self) -> None:
        """Pull everything already delivered without blocking."""
        while True:
            m = self._recv(timeout=0.0)
            if m is None:
                return
            self._dispatch_passive(m)

    def _dispatch_passive(self, m: Msg, waiting: Optional[Tag] = None) -> None:
        """Handle a message that is not the awaited response: abort frames
        raise, app messages are stashed, pipelined-put responses are
        settled, anything else is a protocol error."""
        if m.tag is Tag.TA_ABORT:
            self.aborted = True
            code = m.data.get("code", -1)
            self.flight.record(f"TA_ABORT code={code} from {m.src}")
            self.flight.dump_json("abort")
            raise AdlbAborted(code)
        if m.tag is Tag.AM_APP:
            self._app_inbox.append(m)
            return
        if m.tag is Tag.TA_HOME_TAKEOVER:
            self._apply_takeover(m)
            return
        if (
            m.tag is Tag.TA_PUT_RESP
            and m.data.get("put_id") in self._pending_puts
        ):
            self._settle_put(m)
            return
        if m.tag is Tag.TA_PUT_RESP and m.data.get("put_id") is not None:
            # stale duplicate ack of an already-settled re-sent put
            return
        if (
            m.tag is Tag.TA_RESERVE_RESP
            and self._active_stream is not None
        ):
            # a stream delivery arriving while the client is inside some
            # other wait (a put settle, a prefix fetch, an app_recv):
            # banked raw — decode (which may itself do nested RPCs)
            # happens in stream context, never here
            self._active_stream._on_resp(m)
            return
        if m.tag in (
            Tag.TA_RESERVE_RESP,
            Tag.TA_GET_RESERVED_RESP,
            Tag.TA_GET_COMMON_RESP,
            # a late/duplicate stream-cancel ack (the close() drain
            # already settled, or a re-sent cancel was acked twice)
            Tag.TA_STREAM_CANCEL_RESP,
            # a duplicated dead-letter listing (re-sent across churn)
            Tag.TA_QUARANTINED_RESP,
            # a duplicated membership verdict (detach re-sent across
            # churn; the first response already settled the call)
            Tag.TA_MEMBER_RESP,
        ):
            # stray replay: a request re-sent across connection churn can
            # be answered twice (the server replays its at-most-once
            # cache); the first response already settled the call
            self.flight.record(f"dropped stray {m.tag.name} from {m.src}")
            return
        if m.tag is Tag.PEER_EOF:
            if self._failover_policy() and self.world.is_server(m.src):
                # a server died but the world may survive it: note the
                # loss (bounding the takeover wait) and keep going — the
                # buddy's TA_HOME_TAKEOVER remaps us, and the blocking
                # waits re-send toward it (see _wait)
                self._lost_at.setdefault(m.src, time.monotonic())
                self.flight.record(
                    f"server {m.src} connection lost; awaiting takeover"
                )
                return
            if m.src == self._route(self.home):
                # the lifeline is gone: error out instead of hanging in the
                # next blocking wait (reference: rank failure kills the job)
                self.aborted = True
                self.flight.record(f"home server {m.src} connection lost")
                self.flight.dump_json("home_server_lost")
                raise HomeServerLostError(
                    f"rank {self.rank}: home server {m.src} connection lost"
                )
            return  # other peers closing is normal at termination
        ctx = f" while waiting {waiting}" if waiting is not None else ""
        raise AdlbError(f"rank {self.rank}: unexpected {m.tag}{ctx}")

    # -- server failover ------------------------------------------------------

    def _apply_takeover(self, m: Msg) -> None:
        """An epoch-stamped TA_HOME_TAKEOVER from the buddy that adopted
        a dead server: install the remap, re-point home if it was the
        casualty, re-send pipelined puts that were awaiting the dead
        server's ack (the buddy's replicated dedup window absorbs
        duplicates), and re-arm an open stream's in-flight reserves."""
        dead, buddy, epoch = m.dead, m.src, m.data.get("epoch", 0)
        if self._srv_route.get(dead) == buddy:
            return  # duplicate note
        old_home = self._route(self.home)
        self._fo_epoch = max(self._fo_epoch, epoch)
        self._srv_route[dead] = buddy
        self._lost_at.pop(dead, None)
        self._m_failovers.inc()
        self.flight.record(
            f"home_takeover dead={dead} buddy={buddy} epoch={epoch}"
        )
        home_moved = self._route(self.home) != old_home
        # master succession rides the same note: the promoted deputy
        # stamps new_master so job control / detach re-point to it
        nm = m.data.get("new_master")
        if nm is not None:
            self._master_rank = int(nm)
        # pipelined puts parked on the dead server's ack: re-send (same
        # put_id — the replicated per-sender window makes this idempotent
        # when the original was accepted before the death)
        for put_id, req in list(self._pending_puts.items()):
            if self._route(req["server"]) != req["server"]:
                req["server"] = self._route(req["server"])
                self._send_iput(put_id, req)
        if home_moved and self._active_stream is not None:
            self._active_stream._on_takeover()

    def _check_lost_servers(self) -> None:
        """Raise when a lost server's takeover window expired with no
        buddy announcement (double failure / master death): blocked
        loops must not wait forever."""
        if not self._lost_at:
            return
        now = time.monotonic()
        for srv, t0 in list(self._lost_at.items()):
            if self._route(srv) != srv:
                self._lost_at.pop(srv, None)
                continue
            if now - t0 > self.cfg.failover_client_wait:
                self.aborted = True
                self.flight.record(
                    f"server {srv} lost; no takeover within "
                    f"{self.cfg.failover_client_wait}s"
                )
                self.flight.dump_json("home_server_lost")
                raise HomeServerLostError(
                    f"rank {self.rank}: server {srv} lost; no takeover"
                )

    # -- pipelined puts -------------------------------------------------------
    #
    # No reference analogue: upstream's Put is a synchronous two-phase
    # exchange per unit (reference src/adlb.c:2811-2843), which caps a
    # producer at one network round trip per unit. iput() streams requests
    # with a client-chosen put_id echoed in the response; flush_puts()
    # settles them, replaying rejects at the hinted server like the
    # synchronous retry loop.

    def iput(
        self,
        payload: bytes,
        work_type: int,
        work_prio: int = 0,
        target_rank: int = -1,
        answer_rank: int = -1,
    ) -> int:
        """Asynchronous put: returns ADLB_SUCCESS when queued locally; the
        accept/reject outcome settles at :meth:`flush_puts`. Not usable
        inside a batch-common region (the prefix refcount must be exact)."""
        if self._batch is not None:
            raise AdlbError("iput inside begin_batch_put is not supported")
        if not self.world.validate_type(work_type):
            raise AdlbError(f"unregistered work type {work_type}")
        self._validate_target(target_rank)
        # opportunistically settle responses already delivered, so a pure
        # producer loop's pending map (payload copies!) and the transport
        # queue stay bounded by in-flight work, not the whole stream
        while True:
            m = self._recv(timeout=0.0)
            if m is None:
                break
            self._dispatch_passive(m)
        server = self._route_put(target_rank)
        put_id = self._next_put_id
        self._next_put_id += 1
        req = dict(
            payload=bytes(payload), work_type=work_type, prio=work_prio,
            target_rank=target_rank, answer_rank=answer_rank,
            attempts=0, server=server, job=self.job,
            trace=self._sample_trace(),
        )
        self._pending_puts[put_id] = req
        self._send_iput(put_id, req)
        return ADLB_SUCCESS

    def _send_iput(self, put_id: int, req: dict) -> None:
        pm = msg(
            Tag.FA_PUT,
            self.rank,
            payload=req["payload"],
            work_type=req["work_type"],
            prio=req["prio"],
            target_rank=req["target_rank"],
            answer_rank=req["answer_rank"],
            common_len=0,
            common_server=-1,
            common_seqno=-1,
            put_id=put_id,
        )
        if req.get("job"):
            pm.data["job_id"] = req["job"]
        if req.get("trace"):
            pm.data["trace_id"] = req["trace"]
        self._send_retry(req["server"], pm)

    def _settle_put(self, m: Msg) -> None:
        put_id = m.put_id
        req = self._pending_puts[put_id]
        rc = m.rc
        if rc == ADLB_BACKOFF:
            # backpressured pipelined put: re-send after a pause floored
            # at the server's retry-after hint, without burning the
            # retry budget — replaying at the reject pace would hit the
            # saturated server ~12x faster than it asked. Still capped:
            # settles run inline in whatever recv loop the client is
            # blocked in, so one backpressured put must not stall it.
            self._m_put_backoffs.inc()
            hint_s = self._jitter_hint(
                (m.data.get("retry_after_ms") or 0) / 1e3, 0.05
            )
            slept = self._backoff_sleep(req.get("sleep", 0.0), cap=0.05)
            if hint_s > slept:
                time.sleep(hint_s - slept)
                slept = hint_s
            req["sleep"] = slept
            self._send_iput(put_id, req)
            return
        if rc in (ADLB_PUT_REJECTED, ADLB_RETRY):
            req["attempts"] += 1
            if req["attempts"] <= self.cfg.put_max_retries:
                if rc == ADLB_PUT_REJECTED:
                    req["server"] = self._retry_server(m.data.get("hint"))
                # pacing like the synchronous retry loop (backoff +
                # jitter): without it all retries burn in a few RTTs while
                # consumers are still draining the full servers. Tightly
                # capped: settles run inline in whatever recv loop the
                # client is blocked in (a reserve must not stall 250 ms
                # because an unrelated pipelined put got rejected).
                self._m_put_retries.inc()
                req["sleep"] = self._backoff_sleep(
                    req.get("sleep", 0.0), cap=0.02
                )
                self._send_iput(put_id, req)
                return
        del self._pending_puts[put_id]
        if rc != ADLB_SUCCESS:
            self._failed_puts += 1
            if rc == ADLB_NO_MORE_WORK:
                # termination, not capacity: the producer must see it
                self._failed_nmw = True
            return
        target = req["target_rank"]
        if target >= 0 and req["server"] != self.world.home_server(target):
            self._send_retry(
                self.world.home_server(target),
                msg(
                    Tag.FA_DID_PUT_AT_REMOTE,
                    self.rank,
                    target_rank=target,
                    work_type=req["work_type"],
                    server_rank=req["server"],
                ),
            )

    def flush_puts(self) -> int:
        """Settle every outstanding iput. Returns ADLB_SUCCESS when all were
        accepted; ADLB_NO_MORE_WORK when any failed because the world
        terminated (the producer's stop signal, like the synchronous put's
        rc); else ADLB_PUT_REJECTED for capacity failures after retries."""
        while self._pending_puts:
            if self._abort_event is not None and self._abort_event.is_set():
                self.aborted = True
                raise AdlbAborted(-1)
            self._check_lost_servers()
            m = self._recv(timeout=0.5)
            if m is None:
                continue
            self._dispatch_passive(m)
        failed, self._failed_puts = self._failed_puts, 0
        nmw, self._failed_nmw = self._failed_nmw, False
        if nmw:
            return ADLB_NO_MORE_WORK
        return ADLB_PUT_REJECTED if failed else ADLB_SUCCESS

    # -- control -------------------------------------------------------------

    def set_problem_done(self) -> int:
        """Explicit termination (reference ADLB_Set_problem_done,
        ``src/adlb.c:3054-3062``). Attached to a non-default job, this
        terminates the JOB (drain), not the world — the fleet keeps
        serving every other namespace."""
        if self.job:
            rc, _state = self.drain_job(self.job)
            return rc
        with self._span("adlb:set_problem_done"):
            self._send_retry(self.home, msg(Tag.FA_NO_MORE_WORK, self.rank))
        return ADLB_SUCCESS

    # -- job control plane (service mode) ------------------------------------

    def _master(self) -> int:
        """The CURRENT master: the promoted deputy once a
        TA_HOME_TAKEOVER note stamped new_master, else the spec's."""
        if self._master_rank is not None:
            return self._master_rank
        return self.world.master_server_rank

    def _job_ctl(self, op: str, job_id: int = 0, name: str = "",
                 quota_bytes: int = 0, dest=None) -> Msg:
        """One FA_JOB_CTL round trip: attach goes to the HOME server
        (which owns this rank's exhaustion vote); submit/drain/kill/
        status go to the MASTER (which owns the job table and fan-out)."""
        dest = self._master() if dest is None else dest
        fields = dict(op=op, job_id=job_id)
        if name:
            fields["job_name"] = name
        if quota_bytes:
            fields["quota"] = quota_bytes
        pm = msg(Tag.FA_JOB_CTL, self.rank, **fields)
        self._send_retry(dest, pm)
        return self._wait(Tag.TA_JOB_CTL_RESP, dest=dest, m_req=pm)

    def detach(self) -> int:
        """Cleanly LEAVE the world (elastic membership): settle every
        pipelined put, then ask the MASTER to drop this rank from
        membership. The master fans the change to every server (ack-
        barriered), so exhaustion/END counting and /healthz forget this
        rank before the reply lands. After a successful detach,
        finalize() is a no-op and the endpoint can simply close.

        Returns ADLB_SUCCESS, or ADLB_NO_MORE_WORK when termination was
        already underway — then a plain finalize() is the right exit
        (and this client does NOT mark itself detached)."""
        with self._span("adlb:detach"):
            if self._active_stream is not None:
                try:
                    self._active_stream.close()
                except Exception:  # teardown races: best-effort
                    self._active_stream = None
            if self._pending_puts:
                self.flush_puts()
            master = self._master()
            pm = msg(Tag.FA_MEMBER, self.rank, mop="detach")
            self._send_retry(master, pm)
            resp = self._wait(Tag.TA_MEMBER_RESP, dest=master, m_req=pm)
        rc = resp.data.get("rc", -1)
        if rc == ADLB_SUCCESS:
            self._detached = True
            self._stop_heartbeat()
            self.flight.record("detached from world")
        return rc

    def attach(self, job_id: int) -> int:
        """Bind this rank to a job namespace on the running fleet: every
        subsequent put/reserve/stream rides in it, and this rank's
        parked-ness counts toward THAT job's exhaustion. attach(0)
        returns to the default namespace."""
        with self._span("adlb:attach", job=job_id):
            resp = self._job_ctl("attach", job_id, dest=self.home)
        if resp.rc == ADLB_SUCCESS:
            self.job = job_id
        return resp.rc

    def submit_job(self, name: str = "",
                   quota_bytes: int = 0) -> tuple[int, int]:
        """Create a namespace on the fleet (master allocates the id and
        fans it out). Returns (rc, job_id). ``quota_bytes`` bounds the
        job's queued bytes PER SERVER; 0 = unlimited."""
        with self._span("adlb:submit_job"):
            resp = self._job_ctl("submit", name=name,
                                 quota_bytes=quota_bytes)
        return resp.rc, resp.data.get("job_id", -1)

    def drain_job(self, job_id: int) -> tuple[int, int]:
        """No new puts for the job; queued work completes, then the
        per-job exhaustion ring marks it done. Returns (rc, job_id)."""
        with self._span("adlb:drain_job", job=job_id):
            resp = self._job_ctl("drain", job_id)
        return resp.rc, resp.data.get("job_id", job_id)

    def kill_job(self, job_id: int) -> tuple[int, int]:
        """Drop the job's queued work everywhere and flush its parked
        requesters with ADLB_NO_MORE_WORK. Returns (rc, job_id)."""
        with self._span("adlb:kill_job", job=job_id):
            resp = self._job_ctl("kill", job_id)
        return resp.rc, resp.data.get("job_id", job_id)

    def job_status(self, job_id: int) -> tuple[int, Optional[dict]]:
        """The master's view of a job (state, quota, counters)."""
        resp = self._job_ctl("status", job_id)
        return resp.rc, resp.data.get("status")

    def checkpoint(self, path_prefix: str) -> tuple[int, int]:
        """Snapshot the whole pool to ``<path_prefix>.<server>.ckpt`` shards
        (no reference analogue — upstream loses all queued work on exit).
        Returns (rc, units captured). Units pinned mid-handoff are captured
        too (a restore rolls the pool back to the snapshot, so work consumed
        after it is re-executed — the standard crash-recovery contract);
        restore with ``Config(restore_path=path_prefix)`` on an identical
        world shape."""
        # native servers take the path over the binary codec (bytes);
        # Python servers take the str through the pickled frame — both
        # write the same ACK1 shards, so either plane restores the other's
        path = (
            path_prefix.encode()
            if self.cfg.server_impl == "native" else path_prefix
        )
        with self._span("adlb:checkpoint"):
            pm = msg(Tag.FA_CHECKPOINT, self.rank, path=path)
            self._send_retry(self.home, pm)
            resp = self._wait(Tag.TA_CHECKPOINT_RESP, dest=self.home,
                              m_req=pm)
        return resp.rc, resp.count

    def info_get(self, key: int) -> tuple[int, float]:
        """One live stats value from this rank's home server (reference
        ADLB_Info_get, ``src/adlb.c:3072-3141``)."""
        pm = msg(Tag.FA_INFO_GET, self.rank, key=int(key))
        self._send_retry(self.home, pm)
        resp = self._wait(Tag.TA_INFO_GET_RESP, dest=self.home, m_req=pm)
        return resp.rc, resp.value

    def info_num_work_units(self, work_type: int) -> tuple[int, int, int, int]:
        """(rc, count, total bytes, max wq count) at the home server
        (reference ``src/adlb.c:3027-3046``)."""
        pm = msg(Tag.FA_INFO_NUM_WORK_UNITS, self.rank,
                 work_type=work_type)
        self._send_retry(self.home, pm)
        resp = self._wait(Tag.TA_INFO_NUM_RESP, dest=self.home, m_req=pm)
        return resp.rc, resp.count, resp.nbytes, resp.max_wq

    def extend_lease(self, handle: WorkHandle) -> int:
        """Explicitly renew this rank's lease on a reserved-but-unfetched
        unit (Config(lease_timeout_s) > 0): a unit whose decode/compute
        legitimately outlives the timeout opts out of expiry without
        raising the whole rank's timeout. Fire-and-forget toward the
        holding server (liveness piggybacks on the frame either way); a
        lease already expired stays expired — the eventual fetch answers
        ADLB_FENCED and the caller re-reserves."""
        with self._span("adlb:extend_lease", seqno=handle.seqno):
            self._send_retry(
                handle.server_rank,
                msg(Tag.FA_HEARTBEAT, self.rank, seqno=handle.seqno),
            )
        return ADLB_SUCCESS

    def get_quarantined(self) -> tuple[int, list[dict]]:
        """Retrieve the dead-letter quarantine: every unit the world
        moved aside after it exhausted Config(max_unit_retries), as
        plain dicts (payload + metadata + attempt count + the holding
        server). Aggregated across live Python servers; native servers
        hold no quarantine (the policy requires server_impl='python')."""
        records: list[dict] = []
        with self._span("adlb:get_quarantined"):
            seen: set[int] = set()
            for srv in self.world.server_ranks:
                dest = self._route(srv)
                if dest in seen:
                    continue  # failed-over: its buddy holds the store
                seen.add(dest)
                if dest in getattr(self.ep, "binary_peers", ()):
                    continue
                pm = msg(Tag.FA_GET_QUARANTINED, self.rank)
                self._send_retry(dest, pm)
                resp = self._wait(Tag.TA_QUARANTINED_RESP, dest=dest,
                                  m_req=pm)
                d = resp.data
                suffix_onlys = d.get("suffix_onlys") or ()
                for i, seqno in enumerate(d.get("seqnos") or ()):
                    records.append(
                        {
                            "seqno": seqno,
                            "work_type": d["work_types"][i],
                            "prio": d["prios"][i],
                            "target_rank": d["target_ranks"][i],
                            "answer_rank": d["answer_ranks"][i],
                            "attempts": d["attempts_list"][i],
                            "payload": d["payloads"][i],
                            "server_rank": resp.src,
                            # payload is a fused member's suffix whose
                            # prefix did not survive on the answering
                            # server
                            "suffix_only": bool(
                                suffix_onlys[i] if i < len(suffix_onlys)
                                else 0
                            ),
                        }
                    )
        return ADLB_SUCCESS, records

    def finalize(self) -> int:
        if self._detached:
            # the rank already left membership: there is no home-server
            # accounting left to settle (FA_LOCAL_APP_DONE from a
            # non-member would be noise)
            return ADLB_SUCCESS
        if self.tracer is not None:
            self.tracer.api_entry()  # close any open inferred user span
        self._stop_heartbeat()
        rc = ADLB_SUCCESS
        if not self.aborted:
            if self._active_stream is not None:
                # an abandoned stream's parked reserves must be cancelled
                # (and any banked deliveries handed back to the pool)
                # before LOCAL_APP_DONE, or the server would keep
                # matching work to a rank that will never read it
                try:
                    self._active_stream.close()
                except Exception:  # teardown races: cancel best-effort
                    self._active_stream = None
            if self._pending_puts:
                # un-settled pipelined puts must land before LOCAL_APP_DONE
                # or the shutdown ring could outrun them; a terminal failure
                # here must not vanish silently
                rc = self.flush_puts()
                if rc not in (ADLB_SUCCESS, ADLB_NO_MORE_WORK):
                    import sys

                    print(
                        f"[adlb rank {self.rank}] finalize: pipelined puts "
                        f"terminally rejected (rc={rc})",
                        file=sys.stderr,
                    )
            self._send_retry(self.home, msg(Tag.FA_LOCAL_APP_DONE,
                                            self.rank))
        return rc

    def abort(self, code: int) -> None:
        """Bring the whole world down (reference ADLB_Abort,
        ``src/adlb.c:3165-3176``)."""
        self.aborted = True
        self._stop_heartbeat()
        self.flight.record(f"this rank called abort({code})")
        self.flight.dump_json("abort_initiated")
        try:
            self.ep.send(self._route(self.home),
                         msg(Tag.FA_ABORT, self.rank, code=code))
        except OSError:
            pass  # the abort_event still propagates in-harness
        if self._abort_event is not None:
            self._abort_event.set()
        raise AdlbAborted(code)


class WorkStream:
    """Client half of the prefetch pipeline (``get_work_stream``).

    Keeps up to ``depth`` fused prefetch reserves in flight at the home
    server; deliveries are banked raw (:class:`Msg`) by whatever recv
    loop sees them and decoded — including prefix-cache assembly and the
    handle fallback's fetch — only in stream context, so no nested RPC
    ever runs inside a passive dispatch. Exhaustion safety: prefetch
    parks only count as idle after this client reports an empty bank
    (FA_STREAM_IDLE), so work banked here can still put descendants
    before the world is allowed to declare exhaustion.
    """

    def __init__(self, client: Client, types, depth: int) -> None:
        self._c = client
        self._types = types  # normalized frozenset or None
        self._depth = max(1, int(depth))
        self._bank: deque[Msg] = deque()
        # outstanding reserve ids: responses echo rqseqno, so matching
        # by id both accounts the slots exactly and dedups duplicated
        # responses (a frame re-sent across reconnect) for free
        self._outstanding: set[int] = set()
        self._retry = 0
        self._retry_sleep = 0.0
        self._idle_sent = False
        self._idle_sent_at = 0.0
        self._closed = False
        self.rc: Optional[int] = None  # termination code once observed

    # re-announce idleness at this cadence while blocked: a note lost to
    # churn (or voided server-side — count mismatch, reclaim sweep) must
    # not wedge the exhaustion vote forever, and the swept-stream re-arm
    # (ADLB_RETRY per phantom slot) is triggered by exactly this re-send
    IDLE_REANNOUNCE_S = 1.0

    def __iter__(self) -> Iterator[GotWork]:
        return self

    # -- wiring --------------------------------------------------------------

    def _send_one(self) -> None:
        c = self._c
        c._rqseqno += 1
        self._outstanding.add(c._rqseqno)
        pm = msg(
            Tag.FA_RESERVE,
            c.rank,
            rqseqno=c._rqseqno,
            req_types=None if self._types is None
            else sorted(self._types),
            hang=True,
            fetch=True,
            prefetch=True,
        )
        if c.job:
            pm.data["job_id"] = c.job
        c._send_retry(c.home, pm)

    def _pump(self) -> None:
        if self.rc is not None or self._closed:
            return
        while len(self._outstanding) + len(self._bank) < self._depth:
            self._send_one()

    def _on_takeover(self) -> None:
        """The home server failed over: every reserve parked at the dead
        server is void — re-arm each slot toward the buddy (the retry
        path sends fresh rqseqnos with backoff, in stream context)."""
        n = len(self._outstanding)
        if n == 0:
            return
        self._c.flight.record(
            f"stream: re-arming {n} in-flight reserves after takeover"
        )
        self._outstanding.clear()
        self._retry += n
        self._idle_sent = False

    def _on_resp(self, m: Msg) -> None:
        """Bank one reservation response (called from the client's
        dispatch — NO decoding, no nested RPCs here). Matched by the
        echoed rqseqno: a response whose id is not outstanding is a
        duplicate (re-sent across reconnect) or a stray — processing it
        would run a unit twice, so it is dropped."""
        rid = m.data.get("rqseqno")
        if rid is None or rid not in self._outstanding:
            self._c.flight.record(
                f"stream: dropped stray/duplicate delivery (rqseqno={rid})"
            )
            return
        self._outstanding.discard(rid)
        rc = m.rc
        if rc == ADLB_SUCCESS:
            self._bank.append(m)
            # the delivery un-idled us server-side; re-announce next
            # time the bank runs dry
            self._idle_sent = False
        elif rc == ADLB_RETRY:
            # reclaim-mode resurrection: this rank reconnected while its
            # death fan-out settled — re-arm the slot (with backoff, in
            # stream context). Re-announce idleness afterwards: a note
            # voided server-side (count mismatch) would otherwise never
            # be re-sent, and the exhaustion vote could wait forever.
            self._retry += 1
            self._idle_sent = False
        else:
            self.rc = rc  # NO_MORE_WORK / DONE_BY_EXHAUSTION

    def _decode(self, m: Msg) -> Optional[GotWork]:
        """Decode a banked delivery in stream context: prefix-cache
        assembly for suffix-only payloads, Get_reserved for the handle
        fallback (native servers). Returns None when the unit vanished
        in a reclaim race (recorded, stream continues)."""
        c = self._c
        if "payload" not in m.data and "handle" not in m.data:
            c.flight.record("stream: malformed delivery dropped")
            return None
        rc, got = c._decode_single_got(m)
        if rc != ADLB_SUCCESS or got is None:
            c.flight.record(f"stream: delivery decode failed rc={rc}")
            return None
        return got

    # -- iteration -----------------------------------------------------------

    def __next__(self) -> GotWork:
        c = self._c
        self._pump()
        while True:
            if self._closed and not self._bank:
                # close() cancelled the parked reserves WITHOUT answering
                # them, so the outstanding set never drains — iterating
                # past a close must stop here, not spin on a recv forever
                if c._active_stream is self:
                    c._active_stream = None
                raise StopIteration
            if self._bank:
                m = self._bank.popleft()
                self._pump()
                got = self._decode(m)
                if got is None:
                    continue
                return got
            if self._retry and self.rc is None:
                self._retry -= 1
                c._m_reserve_retries.inc()
                self._retry_sleep = c._backoff_sleep(self._retry_sleep)
                self._send_one()
                continue
            if not self._outstanding:
                # nothing banked, nothing in flight: terminated (or
                # closed mid-iteration)
                if c._active_stream is self:
                    c._active_stream = None
                self._closed = True
                raise StopIteration
            if c._abort_event is not None and c._abort_event.is_set():
                c.aborted = True
                c.flight.record("abort event observed in get_work_stream")
                c.flight.dump_json("abort_event")
                raise AdlbAborted(-1)
            now = time.monotonic()
            if self.rc is None and (
                not self._idle_sent
                or now - self._idle_sent_at >= self.IDLE_REANNOUNCE_S
            ):
                # the bank is dry and we are (still) blocked: tell the
                # home server this rank is genuinely idle, making its
                # prefetch parks eligible for the exhaustion vote. The
                # in-flight count lets the server void a note that
                # crossed a delivery on the wire (see _on_stream_idle);
                # the periodic re-announce repairs voided/lost notes and
                # triggers the swept-stream re-arm after reclaim churn.
                c._send_retry(
                    c.home,
                    msg(Tag.FA_STREAM_IDLE, c.rank,
                        slots=sorted(self._outstanding)),
                )
                self._idle_sent = True
                self._idle_sent_at = now
            c._check_lost_servers()
            m = c._recv(timeout=0.5)
            if m is not None:
                c._dispatch_passive(m)

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        """End the stream early: cancel parked prefetch reserves at the
        server, then hand back anything already matched to us —
        handle-shaped deliveries are UNRESERVEd at their holder (the
        unit unpins and re-matches, targeting intact), fused payloads
        are re-put untargeted (their unit was already consumed). Safe to
        call after normal exhaustion too (no-op then)."""
        if self._closed:
            if self._c._active_stream is self:
                self._c._active_stream = None
            return
        self._closed = True
        c = self._c
        try:
            if self.rc is None and self._outstanding:
                c._send_retry(c.home, msg(Tag.FA_STREAM_CANCEL, c.rank))
                # deliveries that raced the cancel arrive BEFORE the ack
                # (per-peer FIFO with the home server)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    m = c._recv(timeout=0.2)
                    if m is None:
                        continue
                    if m.tag is Tag.TA_STREAM_CANCEL_RESP:
                        break
                    c._dispatch_passive(m)
            while self._bank:
                m = self._bank.popleft()
                if "handle" in m.data and "payload" not in m.data:
                    h = WorkHandle.from_ints(m.handle)
                    c._send_retry(
                        h.server_rank,
                        msg(Tag.SS_UNRESERVE, c.rank, seqno=h.seqno,
                            for_rank=c.rank),
                    )
                    continue
                got = self._decode(m)
                if got is not None:
                    # fused responses carry the unit's target_rank (if
                    # any) precisely so this re-put can preserve the
                    # only-the-target-may-run-it contract
                    c._put(got.payload, got.work_type, got.work_prio,
                           int(m.data.get("target_rank", -1)),
                           got.answer_rank)
        finally:
            if c._active_stream is self:
                c._active_stream = None

    def __enter__(self) -> "WorkStream":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _SerialStream:
    """Degraded stream toward a native home server (no multi-entry
    reserve queue there): repeated fused ``get_work`` calls — still one
    round trip per unit, just no overlap."""

    def __init__(self, client: Client, req_types) -> None:
        self._c = client
        self._types = req_types
        self.rc: Optional[int] = None

    def __iter__(self):
        return self

    def __next__(self) -> GotWork:
        if self.rc is not None:
            raise StopIteration
        rc, got = self._c.get_work(self._types)
        if rc != ADLB_SUCCESS or got is None:
            self.rc = rc
            raise StopIteration
        return got

    def close(self) -> None:
        pass

    def __enter__(self) -> "_SerialStream":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
