"""Server failover: replicated pool shards and home-server takeover.

The reference has no server fault tolerance at all — the servers *are*
the work pool, there is no pool serialization, and a dead rank kills the
job (SURVEY §5; ``MPI_Abort`` paths, reference ``src/adlb.c:2508-2526``).
Worker death is a policy (``on_worker_failure``); this module does the same
for server death, composing ingredients that already exist in-tree:

* every server **asynchronously streams a replication log** of its pool
  mutations (put, fetch/delivery consume, pin/unpin, batch-common
  refcount ops, app finalize/death) to its **ring-successor buddy**
  server, as ``SS_REPL`` frames of packed entries reusing the
  ``checkpoint.py`` unit wire format (:data:`_UNIT`);
* the buddy maintains a passive :class:`ReplicaMirror` — the
  predecessor's wq/cq shard reconstructed entry by entry;
* on the predecessor's death (EOF / ``SS_SERVER_DEAD`` fan-out) the
  buddy **replays the mirror into its own queues and takes over
  home-server duty** for the dead server's app ranks: pinned units stay
  pinned under their original leases (live clients fetch them through a
  seqno translation), unpinned units re-enqueue, batch-common prefixes
  re-home with their refcount state, and clients learn the new mapping
  via an epoch-stamped ``TA_HOME_TAKEOVER`` remap.

Loss model: replication is asynchronous, so mutations the dead server
made after its last flushed ``SS_REPL`` frame are gone. The lag is
bounded (flush on every reactor pass and at ``MAX_BUFFER`` entries),
observable (``repl_lag`` gauge at the primary), and the losses are
counted where they become observable: a client fetching a handle whose
unit's consume tombstone replayed (the response died with the server)
gets ``ADLB_RETRY`` and the buddy counts ``failover_lost``. At-most-once
execution is preserved exactly as under worker reclaim — a consume in the log
means the payload may already have landed, so the unit is never
re-enqueued (the delivered-at-death rule).
"""

from __future__ import annotations

import struct
from collections import deque
from typing import Optional

from adlb_tpu_torch.runtime.checkpoint import _UNIT  # unit metadata wire format

# entry opcodes (1 byte on the wire)
OP_PUT = 1        # unit added to the wq
OP_PIN = 2        # unit pinned (lease granted)
OP_UNPIN = 3      # unit unpinned (lease released, still queued)
OP_CONSUME = 4    # unit fetched/delivered (removed; tombstoned)
OP_REMOVE = 5     # unit removed without delivery (migrate/push/drop)
OP_COMMON_PUT = 6     # batch-common prefix stored
OP_COMMON_REFCNT = 7  # End_batch_put shipped the final refcount
OP_COMMON_GET = 8     # one get accounted against the prefix
OP_COMMON_FORFEIT = 9
OP_COMMON_CREDIT = 10
OP_COMMON_GC = 11     # prefix GC'd (refcount satisfied)
OP_APP_DONE = 12      # local app finalized
OP_RANK_DEAD = 13     # app rank declared dead (reclaim policy)
OP_COMMON_STATE = 14  # full refcount state (re-bootstrap after buddy death)
OP_SEEN_PUTS = 15     # a sender's accepted-put dedup window (re-bootstrap)
# gray-failure state (lease expiry / quarantine) — attempt counts and
# fences must survive failover or a takeover would reset a poison unit's
# retry budget and un-fence a stalled owner
OP_ATTEMPTS = 16      # unit's failure-attempt count changed
OP_FENCE = 17         # (seqno, owner) fenced by lease expiry
OP_QUARANTINE = 18    # unit moved to the dead-letter quarantine
# job-namespace control (service mode): a job's state/quota changed —
# rides the stream (and the per-server WAL that tees it) so job
# membership and lifecycle survive failover and cold restart
OP_JOB = 19
# unit-lifecycle trace context (obs/journey.py): a traced unit's
# (trace_id, span list) — logged right behind its OP_PUT so the journey
# survives failover adoption and WAL cold-restart replay
OP_TRACE = 20
# tail hedging (runtime/hedge.py): marks a unit as a speculative hedge
# SIBLING of an origin unit (body: sibling seqno, origin seqno), logged
# right behind the sibling's OP_PUT. Failover adoption and WAL replay
# DISCARD marked siblings and adopt only origins — re-running the
# origin falls inside the documented lease-expiry at-least-once window,
# while adopting both copies would put two live duplicates into open
# matching with nobody left to fence the loser. A fresh OP_PUT of the
# same seqno supersedes the mark (the race dissolved and the survivor
# became an ordinary unit). Append-only, as above.
OP_HEDGE = 21
# master brain state (master failover): the master-only durable control
# plane streams to the master's ring buddy — the standing DEPUTY — over
# the same plane, so promotion rebuilds a fully functioning brain
# without a cold start. Append-only like everything above; a non-master
# primary never emits these, so unconfigured worlds stay frame-identical.
OP_MEMBER = 22     # membership snapshot: epoch, master rank, provisional
#                    watermark, retired srv-route map, addrs, live/ready/
#                    dead/drained sets, ops-armed flag (newest wins)
OP_SLO = 23        # one live SLO objective doc (POST /slo; keyed by name)
OP_CONTROL = 24    # controller policy doc (POST /control; newest wins)
OP_SCALE = 25      # parked scale request, or its clearing (newest wins)
OP_JOB_WEIGHT = 26  # a job's fair-share weight changed (job id + f64)

_HDR = struct.Struct("<BI")       # op, body length
_SEQ = struct.Struct("<q")        # one seqno
_SEQ2 = struct.Struct("<qq")      # seqno + arg (pin rank, refcnt, ...)
_SEQ3 = struct.Struct("<qqq")     # seqno + src + request id (common ops)
# seqno, src, put_id, pinned(pin_rank|-1), attempts, job
_PUTHDR = struct.Struct("<qqqiii")
_JOBHDR = struct.Struct("<qqB")   # job id, quota bytes, state code
_JOBW = struct.Struct("<qd")      # job id, fair-share weight

# flush the buffered log at this many entries even mid-pass
MAX_BUFFER = 256
# bounded tombstone memory at the mirror (consumed seqnos kept so a
# post-takeover fetch of a consumed unit is distinguishable from an
# invalid handle)
MAX_TOMBSTONES = 65536


def _pack_unit(u) -> bytes:
    """Unit metadata + payload in the checkpoint shard layout
    (``_UNIT`` + common_len + payload_len + payload)."""
    return b"".join((
        _UNIT.pack(u.work_type, u.target_rank, u.answer_rank, u.prio,
                   u.common_server_rank, u.common_seqno),
        struct.pack("<II", u.common_len, len(u.payload)),
        u.payload,
    ))


def _unpack_unit(body: bytes, off: int) -> tuple[dict, int]:
    wt, target, answer, prio, cserver, cseqno = _UNIT.unpack_from(body, off)
    off += _UNIT.size
    clen, plen = struct.unpack_from("<II", body, off)
    off += 8
    payload = body[off:off + plen]
    off += plen
    return dict(work_type=wt, target_rank=target, answer_rank=answer,
                prio=prio, common_server_rank=cserver, common_seqno=cseqno,
                common_len=clen, payload=payload), off


class ReplicationLog:
    """Primary side: buffer mutation entries, flush them to the buddy as
    ``SS_REPL`` frames. Append is O(entry); the flush is one endpoint
    send (fire-and-forget — the buddy never acks; TCP's per-pair FIFO is
    the ordering guarantee)."""

    def __init__(self, buddy: int) -> None:
        self.buddy = buddy
        self._buf: list[bytes] = []
        self.seq = 0          # frames flushed
        self.entries_total = 0

    # -- appends -------------------------------------------------------------

    def _append(self, op: int, body: bytes) -> None:
        self._buf.append(_HDR.pack(op, len(body)) + body)
        self.entries_total += 1

    def log_put(self, unit, src: int, put_id) -> None:
        pid = -1 if put_id is None else int(put_id)
        body = _PUTHDR.pack(unit.seqno, src, pid,
                            unit.pin_rank if unit.pinned else -1,
                            getattr(unit, "attempts", 0),
                            getattr(unit, "job", 0))
        self._append(OP_PUT, body + _pack_unit(unit))
        if getattr(unit, "trace_id", 0) and \
                getattr(unit, "spans", None) is not None:
            # the trace context travels with the unit through EVERY
            # log_put site (put intake, push/migrate re-log, promote
            # re-log, WAL recovery re-log) by construction
            self.log_trace(unit.seqno, unit.trace_id, unit.spans)

    def log_trace(self, seqno: int, trace_id: int, spans) -> None:
        from adlb_tpu_torch.obs.journey import pack_spans

        self._append(OP_TRACE,
                     _SEQ.pack(seqno) + pack_spans(trace_id, spans))

    def log_pin(self, seqno: int, rank: int) -> None:
        self._append(OP_PIN, _SEQ2.pack(seqno, rank))

    def log_unpin(self, seqno: int) -> None:
        self._append(OP_UNPIN, _SEQ.pack(seqno))

    def log_consume(self, seqno: int) -> None:
        self._append(OP_CONSUME, _SEQ.pack(seqno))

    def log_remove(self, seqno: int) -> None:
        self._append(OP_REMOVE, _SEQ.pack(seqno))

    def log_common_put(self, seqno: int, buf: bytes) -> None:
        self._append(OP_COMMON_PUT, _SEQ.pack(seqno) + buf)

    def log_common_refcnt(self, seqno: int, refcnt: int) -> None:
        self._append(OP_COMMON_REFCNT, _SEQ2.pack(seqno, refcnt))

    def log_common_op(self, seqno: int, op: str, src: int = -1,
                      op_id: int = -1) -> None:
        """``src``/``op_id`` carry the requester's dedup identity for
        client-driven gets/forfeits, so the buddy's replay windows absorb
        a request re-sent across the takeover (seqno=-1 with src>=0 is a
        pure window entry — the re-bootstrap path — with no accounting)."""
        code = {"get": OP_COMMON_GET, "forfeit": OP_COMMON_FORFEIT,
                "credit": OP_COMMON_CREDIT, "gc": OP_COMMON_GC}[op]
        self._append(code, _SEQ3.pack(seqno, src, op_id))

    def log_common_state(self, seqno: int, refcnt: int, ngets: int,
                         credits: int) -> None:
        self._append(OP_COMMON_STATE,
                     struct.pack("<qqqq", seqno, refcnt, ngets, credits))

    def log_attempts(self, seqno: int, attempts: int) -> None:
        self._append(OP_ATTEMPTS, _SEQ2.pack(seqno, attempts))

    def log_fence(self, seqno: int, owner: int, origin: int = -1) -> None:
        """``origin`` is the server whose numbering ``seqno`` belongs to:
        -1 for this primary's own fences, a rank for fences it ADOPTED in
        an earlier takeover (a doubly-rerouted late fetch still stamps
        the ORIGINAL home in fo_from, so the key must survive chains)."""
        self._append(OP_FENCE, _SEQ3.pack(seqno, owner, origin))

    def log_quarantine(self, seqno: int) -> None:
        self._append(OP_QUARANTINE, _SEQ.pack(seqno))

    def log_hedge(self, sib_seqno: int, origin_seqno: int) -> None:
        """Mark ``sib_seqno`` as a hedge sibling of ``origin_seqno``
        (logged right behind the sibling's OP_PUT, like OP_TRACE)."""
        self._append(OP_HEDGE, _SEQ2.pack(sib_seqno, origin_seqno))

    def log_job(self, job_id: int, state_code: int, quota_bytes: int,
                name: str = "") -> None:
        """Job lifecycle entry (service mode): state codes are
        jobs.STATE_CODES (running/draining/done/killed)."""
        self._append(
            OP_JOB,
            _JOBHDR.pack(job_id, quota_bytes, state_code)
            + name.encode("utf-8", "replace"),
        )

    def log_app_done(self, rank: int) -> None:
        self._append(OP_APP_DONE, _SEQ.pack(rank))

    def log_rank_dead(self, rank: int) -> None:
        self._append(OP_RANK_DEAD, _SEQ.pack(rank))

    # -- master brain state (deputy stream) ----------------------------------
    # Bodies are pickled dicts: these are rare control-plane events (a
    # membership change, an operator POST), not per-unit hot-path ops,
    # and SS_REPL bodies are opaque blobs end to end.

    def log_member(self, doc: dict) -> None:
        """Full membership/brain snapshot, newest wins (epoch, master
        rank, provisional-id watermark, retired-route map, addrs,
        live/ready/dead/drained sets, ops-armed flag)."""
        import pickle

        self._append(OP_MEMBER, pickle.dumps(doc, protocol=4))

    def log_slo(self, doc: dict) -> None:
        """One live SLO objective (the POST /slo body after engine
        normalization), keyed by name at the mirror."""
        import pickle

        self._append(OP_SLO, pickle.dumps(doc, protocol=4))

    def log_control(self, policy: dict) -> None:
        """The controller policy doc (POST /control), newest wins."""
        import pickle

        self._append(OP_CONTROL, pickle.dumps(policy, protocol=4))

    def log_scale(self, parked) -> None:
        """The parked scale request (spawnerless scale-out), or None
        when the park is serviced/cleared. Newest wins."""
        import pickle

        self._append(OP_SCALE, pickle.dumps(parked, protocol=4))

    def log_job_weight(self, job_id: int, weight: float) -> None:
        self._append(OP_JOB_WEIGHT, _JOBW.pack(job_id, weight))

    def log_seen_puts(self, src: int, put_ids) -> None:
        """Re-bootstrap: ship a sender's whole accepted-put window so a
        put acked by THIS server and re-sent after its death is answered
        idempotently by the new buddy (without this, a buddy-death-then-
        primary-death chain would admit the duplicate and run it twice)."""
        ids = list(put_ids)
        self._append(OP_SEEN_PUTS,
                     _SEQ2.pack(src, len(ids))
                     + struct.pack(f"<{len(ids)}q", *ids))

    # -- flush ---------------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._buf)

    def take(self) -> Optional[bytes]:
        """Drain the buffer into one frame body, or None when empty."""
        if not self._buf:
            return None
        blob = b"".join(self._buf)
        self._buf.clear()
        self.seq += 1
        return blob


class ReplicaMirror:
    """Buddy side: the predecessor's pool shard, reconstructed from its
    replication stream. Plain dicts — the mirror is passive until a
    takeover replays it into the buddy's live queues."""

    def __init__(self, primary: int) -> None:
        self.primary = primary
        self.units: dict[int, dict] = {}       # seqno -> unit fields
        self.pins: dict[int, int] = {}         # seqno -> pin_rank
        self.commons: dict[int, list] = {}     # seqno -> [buf, refcnt, ngets,
        #                                        credits]
        self.tombstones: set[int] = set()      # consumed seqnos
        self._tomb_order: deque[int] = deque()
        self.seen_puts: dict[int, list[int]] = {}  # src -> put ids (ordered)
        # per-requester dedup identities for the common-prefix control
        # plane: the last fetch id per src (the primary's _last_common)
        # and the forfeit-note window — merged at promotion so a request
        # the dead server already accounted is absorbed, not re-counted
        self.last_common: dict[int, int] = {}      # src -> last get_id
        self.forfeit_ids: dict[int, list[int]] = {}  # src -> note ids
        # gray-failure state: fences (seqno, owner, origin) from lease
        # expiry at the primary (origin -1 = the primary's own
        # numbering, else the server an earlier takeover adopted them
        # from), and units it moved to its dead-letter quarantine (the
        # takeover adopts both, so attempt budgets and fencing survive
        # the failover)
        self.fences: set[tuple[int, int, int]] = set()
        self.quarantined: dict[int, dict] = {}     # seqno -> unit fields
        # hedge siblings (OP_HEDGE): sibling seqno -> origin seqno.
        # Promotion / WAL replay discard marked units (see the opcode
        # comment); any terminal op on the sibling pops its mark.
        self.hedges: dict[int, int] = {}
        self.finalized: set[int] = set()
        self.dead_ranks: set[int] = set()
        # job-namespace lifecycle: job id -> (state_code, quota, name);
        # replayed into the taker-over's / restarted server's job table
        self.jobs_meta: dict[int, tuple[int, int, str]] = {}
        # master brain state (deputy stream): only populated when the
        # primary is the master under failover. ``brain`` is the newest
        # OP_MEMBER snapshot; slo docs are keyed by objective name;
        # weights by job id; policy / scale_pending are newest-wins.
        self.brain: Optional[dict] = None
        self.slo_docs: dict[str, dict] = {}
        self.control_policy: Optional[dict] = None
        self.scale_pending = None
        self.job_weights: dict[int, float] = {}
        self.entries_applied = 0
        self.frames_applied = 0
        self.sealed = False

    def _tombstone(self, seqno: int) -> None:
        self.tombstones.add(seqno)
        self._tomb_order.append(seqno)
        if len(self._tomb_order) > MAX_TOMBSTONES:
            self.tombstones.discard(self._tomb_order.popleft())

    def apply(self, blob: bytes) -> None:
        if self.sealed:
            return  # late frame after promotion: the shard already replayed
        off = 0
        n = len(blob)
        while off < n:
            op, blen = _HDR.unpack_from(blob, off)
            off += _HDR.size
            body = blob[off:off + blen]
            off += blen
            self._apply_one(op, body)
            self.entries_applied += 1
        self.frames_applied += 1

    def apply_entry(self, op: int, body: bytes) -> None:
        """Apply ONE already-unframed entry — the WAL replay path (the
        on-disk log wraps each entry in its own CRC record, so the
        torn-tail scan unframes record by record)."""
        self._apply_one(op, body)
        self.entries_applied += 1

    def _apply_one(self, op: int, body: bytes) -> None:
        if op == OP_PUT:
            seqno, src, pid, pin_rank, attempts, job = _PUTHDR.unpack_from(
                body, 0
            )
            fields, _ = _unpack_unit(body, _PUTHDR.size)
            fields["attempts"] = attempts
            fields["job"] = job
            self.units[seqno] = fields
            # a re-put of a marked sibling means its race dissolved and
            # it is an ordinary unit now (see OP_HEDGE comment)
            self.hedges.pop(seqno, None)
            if pin_rank >= 0:
                self.pins[seqno] = pin_rank
            if pid >= 0:
                ids = self.seen_puts.setdefault(src, [])
                ids.append(pid)
                if len(ids) > 512:
                    del ids[0]
        elif op == OP_PIN:
            seqno, rank = _SEQ2.unpack(body)
            if seqno in self.units:
                self.pins[seqno] = rank
        elif op == OP_UNPIN:
            (seqno,) = _SEQ.unpack(body)
            self.pins.pop(seqno, None)
        elif op == OP_CONSUME:
            (seqno,) = _SEQ.unpack(body)
            self.units.pop(seqno, None)
            self.pins.pop(seqno, None)
            self.hedges.pop(seqno, None)
            self._tombstone(seqno)
        elif op == OP_REMOVE:
            (seqno,) = _SEQ.unpack(body)
            self.units.pop(seqno, None)
            self.pins.pop(seqno, None)
            self.hedges.pop(seqno, None)
        elif op == OP_COMMON_PUT:
            (seqno,) = _SEQ.unpack_from(body, 0)
            self.commons[seqno] = [body[_SEQ.size:], -1, 0, 0]
        elif op == OP_COMMON_REFCNT:
            seqno, refcnt = _SEQ2.unpack(body)
            e = self.commons.get(seqno)
            if e is not None:
                e[1] = refcnt + e[3]
                e[3] = 0
        elif op in (OP_COMMON_GET, OP_COMMON_FORFEIT):
            seqno, src, op_id = _SEQ3.unpack(body)
            if src >= 0 and op_id >= 0:
                if op == OP_COMMON_GET:
                    self.last_common[src] = max(
                        self.last_common.get(src, -1), op_id
                    )
                else:
                    ids = self.forfeit_ids.setdefault(src, [])
                    ids.append(op_id)
                    if len(ids) > 512:
                        del ids[0]
            e = self.commons.get(seqno)
            if e is not None:
                e[2] += 1
        elif op == OP_COMMON_CREDIT:
            seqno, _src, _id = _SEQ3.unpack(body)
            e = self.commons.get(seqno)
            if e is not None:
                if e[1] >= 0:
                    e[1] += 1
                else:
                    e[3] += 1
        elif op == OP_COMMON_GC:
            seqno, _src, _id = _SEQ3.unpack(body)
            self.commons.pop(seqno, None)
        elif op == OP_COMMON_STATE:
            seqno, refcnt, ngets, credits = struct.unpack("<qqqq", body)
            e = self.commons.get(seqno)
            if e is not None:
                e[1], e[2], e[3] = refcnt, ngets, credits
        elif op == OP_ATTEMPTS:
            seqno, attempts = _SEQ2.unpack(body)
            f = self.units.get(seqno)
            if f is not None:
                f["attempts"] = attempts
        elif op == OP_FENCE:
            seqno, owner, origin = _SEQ3.unpack(body)
            self.fences.add((seqno, owner, origin))
        elif op == OP_QUARANTINE:
            (seqno,) = _SEQ.unpack(body)
            f = self.units.pop(seqno, None)
            self.pins.pop(seqno, None)
            self.hedges.pop(seqno, None)
            if f is not None:
                self.quarantined[seqno] = f
        elif op == OP_APP_DONE:
            (rank,) = _SEQ.unpack(body)
            self.finalized.add(rank)
        elif op == OP_RANK_DEAD:
            (rank,) = _SEQ.unpack(body)
            self.dead_ranks.add(rank)
            self.finalized.add(rank)
        elif op == OP_SEEN_PUTS:
            src, n = _SEQ2.unpack_from(body, 0)
            new = struct.unpack_from(f"<{n}q", body, _SEQ2.size)
            ids = self.seen_puts.setdefault(src, [])
            ids.extend(new)
            if len(ids) > 512:
                del ids[:len(ids) - 512]
        elif op == OP_JOB:
            job_id, quota, state_code = _JOBHDR.unpack_from(body, 0)
            name = body[_JOBHDR.size:].decode("utf-8", "replace")
            self.jobs_meta[job_id] = (state_code, quota, name)
        elif op == OP_TRACE:
            from adlb_tpu_torch.obs.journey import unpack_spans

            (seqno,) = _SEQ.unpack_from(body, 0)
            f = self.units.get(seqno)
            if f is not None:
                tid, spans = unpack_spans(body[_SEQ.size:])
                f["trace_id"] = tid
                f["spans"] = spans
        elif op == OP_HEDGE:
            sib, origin = _SEQ2.unpack(body)
            if sib in self.units:
                self.hedges[sib] = origin
        elif op == OP_MEMBER:
            import pickle

            self.brain = pickle.loads(body)
        elif op == OP_SLO:
            import pickle

            doc = pickle.loads(body)
            name = str(doc.get("name", ""))
            if name:
                self.slo_docs[name] = doc
        elif op == OP_CONTROL:
            import pickle

            self.control_policy = pickle.loads(body)
        elif op == OP_SCALE:
            import pickle

            self.scale_pending = pickle.loads(body)
        elif op == OP_JOB_WEIGHT:
            job_id, weight = _JOBW.unpack(body)
            self.job_weights[job_id] = weight
        # unknown ops are skipped by construction (op byte + length frame)

    def seal(self) -> None:
        self.sealed = True


def buddy_of(world, dead: int, dead_servers=()) -> int:
    """The server expected to hold ``dead``'s replica: its next LIVE ring
    successor. With no intermediate deaths that is the original
    ``ring_next`` the replication stream targeted; after an intermediate
    death the primary re-bootstrapped its stream to the next live
    successor (see ``Server._rebootstrap_repl``). If the walk comes back
    to ``dead`` there is no live peer at all. The buddy may still hold no
    mirror (the double failure: primary and its buddy died back to back,
    before any re-bootstrap) — promotion detects that and aborts."""
    b = world.ring_next(dead)
    while b != dead and b in dead_servers:
        b = world.ring_next(b)
    return b
