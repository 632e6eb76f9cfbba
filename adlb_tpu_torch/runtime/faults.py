"""Deterministic fault-injection transport shim.

The chaos soak finds failure modes with wall-clock randomness; this module
makes every failure path *reproducible*. A :class:`FaultPlan` is seeded
plain data (picklable, so it crosses ``spawn_world``'s process boundary
inside ``Config``); a :class:`FaultyEndpoint` wraps any transport endpoint
(the in-proc fabric or the TCP fabric — both expose ``send``/``recv``) and
injects faults on the **send side**, where decisions can be a pure
function of ``(seed, rank, outbound frame number)``:

* ``drop`` — the frame silently never leaves this rank;
* ``delay`` — the frame is held ``delay_s`` seconds before leaving;
* ``duplicate`` — the frame is sent twice back-to-back;
* ``disconnect_at`` — at outbound frame N this rank's connectivity dies:
  further sends raise ``OSError`` and peers observe EOF (the TCP wrapper
  closes the real endpoint; the in-proc wrapper synthesizes ``PEER_EOF``
  frames, which the in-proc fabric otherwise never produces);
* ``kill_at_frame`` — at outbound frame N the whole process dies with
  SIGKILL (``os._exit`` fallback) — the byte-deterministic analogue of a
  preempted worker, pinned to an exact protocol point;
* ``kill_at`` — the wall-clock variant (seconds after the endpoint is
  wrapped), for soak-style adversities where determinism is not the goal;
* ``stall_at_frame`` / ``stall_at`` — GRAY failure: at outbound frame N
  (or after N wall-clock seconds) the endpoint freezes — outbound frames
  buffer instead of leaving, inbound recv goes silent — while the
  process stays alive, so peers observe no EOF, only silence. After
  ``stall_for_s`` seconds (0 = forever) the endpoint resumes and the
  buffered frames flush in order, modelling a SIGCONT'd process's
  kernel buffers draining: the late-traffic burst that lease fencing
  must reject. For spawned (real-process) worlds :func:`sigstop_self`
  is the non-simulated variant — the whole process, heartbeat threads
  included, really stops;
* ``poison_types`` — a worker receiving a reservation for a unit of a
  marked work type dies on the spot (SIGKILL), the deterministic
  poison-unit: the reserve leaves a lease behind, reclaim re-enqueues
  the unit, and it serially kills every worker that touches it until a
  retry budget (``Config(max_unit_retries)``) quarantines it;
* ``partition`` — ASYMMETRIC one-way partition: frames from ``src`` to
  ``dst`` on each listed ``(src, dst)`` pair are silently dropped while
  the reverse direction (and every connection) stays up — the gray link
  where A can hear B but B never hears A, which ack barriers and death
  ladders must survive without a raced verdict. Schedulable at a frame
  (``at_frame``), at a wall-clock offset (``at``), immediately (neither),
  or mid-run via :meth:`FaultPlan.partition_now` / ``heal_now``; bounded
  by ``for_s`` (0 = until healed).

Probabilistic faults (drop/delay/duplicate) draw from a per-rank
``random.Random`` in frame order, so the injected-event log — a list of
``(frame, action, tag, dest)`` tuples — is identical across runs whenever
the rank's outbound frame sequence is (tests drive a scripted sequence;
live worlds get per-frame determinism relative to each rank's own send
order). The log is exposed at :attr:`FaultPlan.events` and optionally
written as JSON per rank (``ADLB_FAULT_LOG_DIR`` or ``spec["log_dir"]``)
so multi-process runs can be compared offline.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional

from adlb_tpu_torch.runtime.messages import Msg, Tag
from adlb_tpu_torch.types import ADLB_SUCCESS

# actions recorded in the injected-event log
DROP = "drop"
DELAY = "delay"
DUP = "duplicate"
DISCONNECT = "disconnect"
KILL = "kill"
STALL = "stall"
RESUME = "resume"
POISON = "poison"
PARTITION = "partition"
HEAL = "heal"


def _mix(seed: int, rank: int) -> int:
    """Stable per-rank stream seed (splitmix-style constant; must not
    depend on PYTHONHASHSEED, so no hash())."""
    return (seed * 0x9E3779B97F4A7C15 + rank * 0xBF58476D1CE4E5B9) & (
        (1 << 63) - 1
    )


class FaultPlan:
    """One rank's seeded fault schedule + injected-event log."""

    def __init__(self, spec: dict, rank: int) -> None:
        self.spec = dict(spec)
        self.rank = rank
        self.seed = int(spec.get("seed", 0))
        self.p_drop = float(spec.get("drop", 0.0))
        self.p_delay = float(spec.get("delay", 0.0))
        self.delay_s = float(spec.get("delay_s", 0.001))
        self.p_dup = float(spec.get("duplicate", 0.0))
        ranks = spec.get("ranks")
        self.active = ranks is None or rank in set(ranks)
        self.disconnect_at = int(
            dict(spec.get("disconnect_at") or {}).get(rank, 0) or 0
        )
        self.kill_at_frame = int(
            dict(spec.get("kill_at_frame") or {}).get(rank, 0) or 0
        )
        self.kill_at = float(dict(spec.get("kill_at") or {}).get(rank, 0.0)
                             or 0.0)
        self.stall_at_frame = int(
            dict(spec.get("stall_at_frame") or {}).get(rank, 0) or 0
        )
        self.stall_at = float(
            dict(spec.get("stall_at") or {}).get(rank, 0.0) or 0.0
        )
        # stall duration; 0 = stalled forever (the never-resuming hang)
        self.stall_for_s = float(spec.get("stall_for_s", 0.0) or 0.0)
        self.poison_types = frozenset(spec.get("poison_types") or ())
        # asymmetric one-way partition: {"pairs": [[src, dst], ...],
        # "at_frame": N | "at": seconds | neither (immediate),
        # "for_s": duration (0 = until healed)}. Only this rank's
        # OUTBOUND legs matter to this plan — the reverse direction is
        # the other rank's plan (or flows freely: that is the asymmetry).
        part = dict(spec.get("partition") or {})
        self._part_sched = [
            (int(p[0]), int(p[1]))
            for p in (part.get("pairs") or ())
            if int(p[0]) == rank
        ]
        self.part_at_frame = int(part.get("at_frame", 0) or 0)
        self.part_at = float(part.get("at", 0.0) or 0.0)
        self.part_for_s = float(part.get("for_s", 0.0) or 0.0)
        self.log_dir = spec.get("log_dir") or os.environ.get(
            "ADLB_FAULT_LOG_DIR"
        )
        self._rng = random.Random(_mix(self.seed, rank))
        self._lock = threading.Lock()
        self.frame = 0  # outbound frames observed (post-increment)
        self.events: list[tuple[int, str, str, int]] = []
        self.disconnected = False
        # gray-failure stall window: None = not stalled, inf = forever,
        # else the monotonic time at which the endpoint resumes; a stall
        # fires at most once per plan (a resumed endpoint must not
        # re-stall on its next frame)
        self.stalled_until: Optional[float] = None
        self._stall_done = False
        # active one-way drops (src is always this rank) + expiry; the
        # frame/timer trigger fires once, explicit partition_now re-arms
        self._part_pairs: set[tuple[int, int]] = set()
        self._part_until: Optional[float] = None
        self._part_done = False
        if self._part_sched and not self.part_at_frame and not self.part_at:
            # no trigger given: the partition exists from frame one
            self._begin_partition_locked(0)

    # -- decisions -----------------------------------------------------------

    def on_send(self, m: Msg, dest: int) -> str:
        """Account one outbound frame and decide its fate. Returns one of
        the action constants or "" (pass through). Called under the lock
        so the frame counter, the RNG draw order, and the event log stay
        mutually consistent even with multiple sender threads."""
        with self._lock:
            self.frame += 1
            n = self.frame
            if self.disconnected:
                return DISCONNECT
            if self.kill_at_frame and n >= self.kill_at_frame:
                self.events.append((n, KILL, m.tag.name, dest))
                self._flush_log()
                return KILL
            if self.disconnect_at and n >= self.disconnect_at:
                self.disconnected = True
                self.events.append((n, DISCONNECT, m.tag.name, dest))
                self._flush_log()
                return DISCONNECT
            if self._stalled_locked(n, m.tag.name, dest):
                return STALL
            if (
                self.stall_at_frame
                and n >= self.stall_at_frame
                and not self._stall_done
            ):
                self._begin_stall_locked(n, m.tag.name, dest)
                return STALL
            if (
                self.part_at_frame
                and n >= self.part_at_frame
                and not self._part_done
            ):
                self._begin_partition_locked(n)
            if self._partitioned_locked(n, m.tag.name, dest):
                return PARTITION
            if not self.active:
                return ""
            # one draw per probabilistic knob per frame, in fixed order:
            # the decision stream is then a pure function of (seed, rank,
            # frame), independent of which knobs are enabled downstream
            r_drop = self._rng.random()
            r_delay = self._rng.random()
            r_dup = self._rng.random()
            if self.p_drop and r_drop < self.p_drop:
                self.events.append((n, DROP, m.tag.name, dest))
                return DROP
            if self.p_delay and r_delay < self.p_delay:
                self.events.append((n, DELAY, m.tag.name, dest))
                return DELAY
            if self.p_dup and r_dup < self.p_dup:
                self.events.append((n, DUP, m.tag.name, dest))
                return DUP
            return ""

    # -- stall (gray failure) ------------------------------------------------

    def _begin_stall_locked(self, frame: int, tag: str, dest: int) -> None:
        self.stalled_until = (
            time.monotonic() + self.stall_for_s
            if self.stall_for_s > 0
            else float("inf")
        )
        self._stall_done = True
        self.events.append((frame, STALL, tag, dest))
        self._flush_log()

    def _stalled_locked(self, frame: int, tag: str, dest: int) -> bool:
        """Inside the stall window? Clears the window (recording RESUME)
        the first time it is consulted past its end."""
        if self.stalled_until is None:
            return False
        if time.monotonic() < self.stalled_until:
            return True
        self.stalled_until = None
        self.events.append((frame, RESUME, tag, dest))
        return False

    def stall_now(self) -> None:
        """Begin a stall immediately (the wall-clock ``stall_at`` timer's
        entry point, and the deterministic in-proc trigger for tests).
        Unlike the frame-count trigger, explicit calls RE-ARM: a test
        driving repeated gray failures (e.g. stalling the same owner
        until its unit's retry budget quarantines it) stalls once per
        call."""
        with self._lock:
            if self.stalled_until is None:
                self._begin_stall_locked(self.frame, "<timer>", -1)

    def stalled(self) -> bool:
        """Inside the stall window right now? (recv-side check)"""
        if self.stalled_until is None:
            return False  # lock-free: every non-stalled recv lands here
        with self._lock:
            return self._stalled_locked(self.frame, "<recv>", -1)

    # -- asymmetric partition (one-way gray link) ----------------------------

    def _begin_partition_locked(self, frame: int) -> None:
        self._part_pairs = set(self._part_sched)
        self._part_until = (
            time.monotonic() + self.part_for_s
            if self.part_for_s > 0
            else float("inf")
        )
        self._part_done = True
        self.events.append((frame, PARTITION, "<engage>", -1))
        self._flush_log()

    def _partitioned_locked(self, frame: int, tag: str, dest: int) -> bool:
        """Is the (self.rank -> dest) leg inside an active one-way drop?
        Heals (recording HEAL) the first time it is consulted past a
        bounded window's end — the reverse direction was never touched,
        so only the send-side decision needs the check."""
        if not self._part_pairs:
            return False
        if (
            self._part_until is not None
            and time.monotonic() >= self._part_until
        ):
            self._part_pairs = set()
            self._part_until = None
            self.events.append((frame, HEAL, tag, dest))
            return False
        if (self.rank, dest) in self._part_pairs:
            self.events.append((frame, PARTITION, tag, dest))
            return True
        return False

    def partition_now(self, pairs=None) -> None:
        """Engage (or extend) a one-way partition immediately: outbound
        frames on each ``(src, dst)`` pair are silently dropped while
        every connection stays up — peers observe no EOF, only one-way
        silence. ``pairs`` defaults to the spec's schedule; explicit
        calls RE-ARM and may swap the pair set, so a test can drive a
        partition mid-run (e.g. isolate the deputy from the master's
        acks during a takeover barrier) and later :meth:`heal_now` it."""
        with self._lock:
            add = (
                self._part_sched
                if pairs is None
                else [(int(p[0]), int(p[1])) for p in pairs]
            )
            self._part_pairs |= {p for p in add if p[0] == self.rank}
            self._part_until = (
                time.monotonic() + self.part_for_s
                if self.part_for_s > 0
                else float("inf")
            )
            self.events.append((self.frame, PARTITION, "<engage>", -1))
            self._flush_log()

    def heal_now(self) -> None:
        """Drop every active one-way partition leg: subsequent frames
        flow again (nothing buffered — a partitioned frame is LOST, as
        on a real lossy link, unlike a stall's kernel-buffer flush)."""
        with self._lock:
            if self._part_pairs:
                self._part_pairs = set()
                self._part_until = None
                self.events.append((self.frame, HEAL, "<heal>", -1))
                self._flush_log()

    # -- log -----------------------------------------------------------------

    def event_log(self) -> list[tuple[int, str, str, int]]:
        with self._lock:
            return list(self.events)

    def _flush_log(self) -> None:
        """Best-effort durable log (called before a kill/disconnect — the
        process may be about to die, so write NOW, atomically)."""
        if not self.log_dir:
            return
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, f"faults-rank{self.rank}.json")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"rank": self.rank, "seed": self.seed,
                           "events": self.events}, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def flush(self) -> None:
        with self._lock:
            self._flush_log()


class FaultyEndpoint:
    """Endpoint wrapper applying a :class:`FaultPlan` to outbound frames.

    Everything except ``send``/``recv`` (attribute reads AND writes —
    ``attach()`` assigns ``ep.metrics``) is forwarded to the wrapped
    endpoint, so roles and harnesses cannot tell the difference.
    """

    _OWN = ("_ep", "plan", "rank", "_contacted", "_killer", "_staller",
            "_stall_buf", "_parter")

    def __init__(self, ep, plan: FaultPlan) -> None:
        object.__setattr__(self, "_ep", ep)
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "rank", ep.rank)
        object.__setattr__(self, "_contacted", set())
        object.__setattr__(self, "_killer", None)
        object.__setattr__(self, "_staller", None)
        object.__setattr__(self, "_stall_buf", [])
        if plan.kill_at > 0:
            t = threading.Timer(plan.kill_at, self._kill_now)
            t.daemon = True
            object.__setattr__(self, "_killer", t)
            t.start()
        if plan.stall_at > 0:
            t = threading.Timer(plan.stall_at, plan.stall_now)
            t.daemon = True
            object.__setattr__(self, "_staller", t)
            t.start()
        object.__setattr__(self, "_parter", None)
        if plan.part_at > 0 and plan._part_sched:
            t = threading.Timer(plan.part_at, plan.partition_now)
            t.daemon = True
            object.__setattr__(self, "_parter", t)
            t.start()

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ep"), name)

    def __setattr__(self, name, value):
        if name in FaultyEndpoint._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_ep"), name, value)

    # -- fault enactment -----------------------------------------------------

    def _kill_now(self) -> None:
        with self.plan._lock:
            self.plan.events.append((self.plan.frame, KILL, "<timer>", -1))
            self.plan._flush_log()
        try:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        except (OSError, ValueError):
            pass
        os._exit(137)

    def _enact_disconnect(self) -> None:
        """Make the death observable: TCP peers see real EOFs when the
        endpoint closes; in-proc peers get synthetic PEER_EOF frames
        (the in-proc fabric has no connections to EOF)."""
        fabric = getattr(self._ep, "_fabric", None)
        if fabric is not None:
            # every rank, not just contacted ones: a TCP death closes all
            # listeners at once, and the home server must learn even about
            # a rank that died before its first frame reached it
            for peer in list(fabric.endpoints.values()):
                if peer.rank == self.rank:
                    continue
                try:
                    peer.inbox.put(Msg(tag=Tag.PEER_EOF, src=self.rank))
                except AttributeError:
                    pass
        else:
            try:
                self._ep.close()
            except OSError:
                pass

    def _flush_stalled(self) -> None:
        """Drain frames buffered during a stall — the SIGCONT'd process's
        kernel buffers finally going out, in order. The buffer swap holds
        the plan lock: the app thread and the client's heartbeat thread
        can resume concurrently, and a racing double-flush would
        duplicate (or drop) the buffered tail."""
        if not self._stall_buf:
            # lock-free hot-path exit (every non-stalled frame lands
            # here): the truthiness read is GIL-atomic, and a frame a
            # racing stall appends right after it flushes on the next
            # call — the same tolerance the buffer swap already has
            return
        with self.plan._lock:
            buf = self._stall_buf
            if not buf:
                return
            object.__setattr__(self, "_stall_buf", [])
        for dest, m, kw in buf:
            try:
                self._ep.send(dest, m, **kw)
            except OSError:
                pass

    def _maybe_poison(self, m: Msg) -> None:
        """The poison-unit fault: receiving a reservation for a marked
        work type kills this worker on the spot (the lease it just took
        survives it — reclaim's retry budget is what bounds the blast
        radius)."""
        if (
            m.tag is Tag.TA_RESERVE_RESP
            and m.data.get("rc") == ADLB_SUCCESS
            and m.data.get("work_type") in self.plan.poison_types
        ):
            with self.plan._lock:
                self.plan.events.append(
                    (self.plan.frame, POISON, m.tag.name, m.src)
                )
                self.plan._flush_log()
            self._kill_now()

    def send(self, dest: int, m: Msg, **kw) -> None:
        act = self.plan.on_send(m, dest)
        if act == KILL:
            self._kill_now()
            return  # unreachable except under test monkeypatching
        if act == DISCONNECT:
            if not self.plan.disconnected:
                self.plan.disconnected = True
            self._enact_disconnect()
            raise OSError(
                f"fault injection: rank {self.rank} disconnected at frame "
                f"{self.plan.frame}"
            )
        if act == STALL:
            with self.plan._lock:  # vs a concurrent resume's buffer swap
                self._stall_buf.append((dest, m, kw))
            return
        if act == PARTITION:
            return  # one-way lost frame: connection alive, no buffering
        self._flush_stalled()  # a resume flushes before new traffic
        if act == DROP:
            return
        if act == DELAY:
            time.sleep(self.plan.delay_s)
        self._contacted.add(dest)
        self._ep.send(dest, m, **kw)
        if act == DUP:
            self._ep.send(dest, m, **kw)

    def recv(self, timeout: Optional[float] = None) -> Optional[Msg]:
        if self.plan.disconnected:
            # a dead rank hears nothing further; burn the poll budget so
            # reactors don't spin
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        if self.plan.stalled():
            # frozen endpoint: inbound traffic waits in the transport
            # (like a stopped process's socket buffers); burn the poll
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        self._flush_stalled()
        m = self._ep.recv(timeout=timeout)
        if m is not None and self.plan.poison_types:
            self._maybe_poison(m)
        return m


def resolve_spec(spec: dict, world) -> dict:
    """Expand server-targeted kill/stall specs into world-rank form.

    ``kill_server_at_frame`` / ``kill_server_at`` / ``disconnect_server_at``
    / ``stall_server_at_frame`` / ``stall_server_at``
    are keyed by SERVER INDEX (0 = the master, i = the i-th server rank)
    so a spec need not hard-code the world shape; with a ``world`` they
    translate into the corresponding ``kill_at_frame`` / ``kill_at`` /
    ``disconnect_at`` world-rank entries. A ``partition`` spec's
    ``server_pairs`` translate the same way into world-rank ``pairs``
    (one-way: ``[0, 1]`` drops master->server1 only). Idempotent and
    copy-on-write — the input spec is never mutated."""
    if world is None or not spec:
        return spec
    pairs = (
        ("kill_server_at_frame", "kill_at_frame"),
        ("kill_server_at", "kill_at"),
        ("disconnect_server_at", "disconnect_at"),
        ("stall_server_at_frame", "stall_at_frame"),
        ("stall_server_at", "stall_at"),
    )
    part_srv = (dict(spec.get("partition") or {})).get("server_pairs")
    if not any(spec.get(sk) for sk, _ in pairs) and not part_srv:
        return spec
    out = dict(spec)
    if part_srv:
        part = dict(out["partition"])
        rank_pairs = [list(p) for p in (part.get("pairs") or ())]
        for a, b in part.pop("server_pairs"):
            for i in (int(a), int(b)):
                if not (0 <= i < world.nservers):
                    raise ValueError(
                        f"partition server_pairs: server index {i} "
                        f"outside 0..{world.nservers - 1}"
                    )
            rank_pairs.append([
                world.num_app_ranks + int(a), world.num_app_ranks + int(b),
            ])
        part["pairs"] = rank_pairs
        out["partition"] = part
    for srv_key, rank_key in pairs:
        by_idx = out.pop(srv_key, None)
        if not by_idx:
            continue
        merged = dict(out.get(rank_key) or {})
        for idx, v in dict(by_idx).items():
            i = int(idx)
            if not (0 <= i < world.nservers):
                raise ValueError(
                    f"{srv_key}: server index {i} outside 0.."
                    f"{world.nservers - 1}"
                )
            merged[world.num_app_ranks + i] = v
        out[rank_key] = merged
    return out


def sigstop_self(resume_after_s: float) -> None:
    """SIGSTOP the calling process — the REAL gray failure for spawned
    worlds: every thread (heartbeats included) and socket freezes with no
    EOF for peers to observe — after forking a watchdog child that
    SIGCONTs us ``resume_after_s`` seconds later (a stopped process
    cannot resume itself). Execution continues here after the resume, so
    the caller's next protocol op is exactly the "late settle from a
    fenced owner" that lease expiry must reject."""
    import signal

    pid = os.getpid()
    child = os.fork()
    if child == 0:
        # watchdog: nothing but sleep-and-resume, then vanish without
        # running the parent's atexit/harness teardown
        try:
            time.sleep(resume_after_s)
            os.kill(pid, signal.SIGCONT)
        finally:
            os._exit(0)
    os.kill(pid, signal.SIGSTOP)
    # ---- stopped until the watchdog's SIGCONT ----
    try:
        os.waitpid(child, 0)
    except (OSError, ChildProcessError):
        pass


def maybe_wrap(ep, cfg, world=None):
    """Wrap ``ep`` when ``cfg.fault_spec`` is set (else return it
    unchanged) — the single hook every world harness (run_world,
    spawn_world, launch.py, join_world) calls. ``world`` enables
    server-index kill specs (kill-server-at-frame / -at-time)."""
    spec = getattr(cfg, "fault_spec", None)
    if not spec:
        return ep
    return FaultyEndpoint(ep, FaultPlan(resolve_spec(spec, world), ep.rank))
