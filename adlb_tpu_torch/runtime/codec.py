"""Binary wire codec for the client<->server protocol.

Python ranks exchange pickled `Msg` frames; native (C/C++/Fortran) clients
speak this compact TLV codec instead — the moral equivalent of the
reference's fixed-layout int-vector headers (``IBUF_NUMINTS``, reference
``src/adlb.c:89-91``), but self-describing so the protocol can grow.

Frame body layout (after the transport's u32 length prefix):

    u8  magic      0x01  (pickle bodies start with 0x80 — the PROTO opcode —
                          so the first byte discriminates the codec)
    u16 tag        wire id (reference-style numbering, src/adlb.c:44-83)
    i32 src        sender world rank
    u16 nfields
    then per field:
      u8 field_id
      u8 kind      0 = i64, 1 = bytes (u32 len + data), 2 = i64 list
                   (u16 count + i64s), 3 = f64
      ...value...

All integers little-endian. A field absent from the frame is absent from
``Msg.data`` (the Python side treats missing ``req_types`` as "any type",
matching the reference's ADLB_RESERVE_REQUEST_ANY).

The C twin of this file is ``adlb_tpu_torch/native/libadlb.cpp``; keep the tables
in sync.
"""

from __future__ import annotations

import io
import os
import pickle
import struct

from adlb_tpu_torch.runtime.messages import Msg, Tag

BINARY_MAGIC = 0x01
PICKLE_MAGIC = 0x80  # pickle protocol >= 2 PROTO opcode

# Globals the transport's unpickler will resolve. Plain data (dict, list,
# str, bytes, int, ...) needs no globals at all; what DOES is the Msg
# envelope itself, its Tag enum, and a few container builtins. Everything
# else — os.system, subprocess.*, arbitrary constructors — is refused, so
# a stray or hostile connection cannot turn the Python transport's pickle
# path into code execution (the C planes got the matching frame-decoder
# hardening; this is the Python plane's half).
_SAFE_PICKLE_GLOBALS: set[tuple[str, str]] = {
    ("adlb_tpu_torch.runtime.messages", "Msg"),
    ("adlb_tpu_torch.runtime.messages", "Tag"),
    ("builtins", "complex"),
    ("builtins", "bytearray"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
}


def register_safe_pickle(module: str, *names: str) -> None:
    """Allow app-message payloads to carry instances of the named classes.

    App-to-app messages (``ctx.app_send``) may hold arbitrary picklable
    Python objects between Python ranks; custom classes must be declared
    here (on the RECEIVING process, before the world starts) or the
    transport refuses the frame."""
    for n in names:
        _SAFE_PICKLE_GLOBALS.add((module, n))


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_PICKLE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"pickle global {module}.{name} is not a protocol type; if an "
            f"app message legitimately carries it, declare it with "
            f"adlb_tpu_torch.runtime.codec.register_safe_pickle({module!r}, "
            f"{name!r}) on the receiving rank"
        )


def loads_restricted(body: bytes):
    """Unpickle a transport frame, refusing non-protocol globals."""
    return _RestrictedUnpickler(io.BytesIO(body)).load()

# Wire ids: client-facing tags keep the reference's numbers where one exists
# (reference src/adlb.c:44-83); the rest are assigned in the 11xx block.
WIRE_TAG: dict[Tag, int] = {
    Tag.FA_PUT: 1001,
    Tag.FA_PUT_COMMON: 1003,
    Tag.FA_BATCH_DONE: 1005,
    Tag.FA_DID_PUT_AT_REMOTE: 1006,
    Tag.FA_RESERVE: 1007,
    Tag.FA_GET_RESERVED: 1009,
    Tag.FA_NO_MORE_WORK: 1011,
    Tag.FA_LOCAL_APP_DONE: 1012,
    Tag.FA_ABORT: 1027,
    Tag.FA_INFO_NUM_WORK_UNITS: 1037,
    Tag.FA_GET_COMMON: 1038,
    Tag.FA_INFO_GET: 1041,
    Tag.TA_RESERVE_RESP: 1008,
    Tag.TA_GET_RESERVED_RESP: 1010,
    Tag.TA_PUT_RESP: 1020,
    Tag.TA_GET_COMMON_RESP: 1039,
    Tag.TA_PUT_COMMON_RESP: 1042,
    Tag.TA_INFO_NUM_RESP: 1043,
    Tag.TA_INFO_GET_RESP: 1044,
    Tag.TA_ABORT: 1046,
    # checkpoint/resume (Python-server feature; pickle-only frames — the
    # client refuses it toward native servers)
    Tag.FA_CHECKPOINT: 1048,
    Tag.TA_CHECKPOINT_RESP: 1049,
    # prefetch pipeline (get_work_stream; Python servers only — native
    # daemons reject tags outside their known ranges, so the client
    # degrades the stream to repeated fused get_work toward them)
    Tag.FA_STREAM_IDLE: 1051,
    Tag.FA_STREAM_CANCEL: 1052,
    Tag.TA_STREAM_CANCEL_RESP: 1053,
    # gray-failure surface (Config(lease_timeout_s) / max_unit_retries;
    # Python servers only — the policy is rejected toward native planes,
    # and native daemons parse-and-ignore FA_HEARTBEAT): liveness beacon /
    # lease extension, and the dead-letter retrieval round trip
    Tag.FA_HEARTBEAT: 1054,
    Tag.FA_GET_QUARANTINED: 1055,
    Tag.TA_QUARANTINED_RESP: 1056,
    # job control plane (service mode; Python servers only — the
    # /jobs surface and per-job termination live in the Python reactor.
    # Ids reserved so a native plane can join the protocol; native
    # daemons reject tags outside their known ranges today.)
    Tag.FA_JOB_CTL: 1057,
    Tag.TA_JOB_CTL_RESP: 1058,
    # elastic membership (adlb_tpu_torch/runtime/membership.py; python-only —
    # native daemons keep the fixed-at-init world and reject these tags,
    # which is the loud mixed-version degradation we want)
    Tag.FA_MEMBER: 1059,
    Tag.TA_MEMBER_RESP: 1060,
    # app<->app point-to-point (the reference's app_comm traffic; native
    # clients receive it via ADLB_App_recv — bytes payloads only, enforced
    # by encodable())
    Tag.AM_APP: 1047,
    # server<->server + balancer + debug tags (Python<->Python, normally
    # pickled; ids exist so the codec is total)
    Tag.SS_QMSTAT: 1101,
    Tag.SS_RFR: 1102,
    Tag.SS_RFR_RESP: 1103,
    Tag.SS_UNRESERVE: 1104,
    Tag.SS_PUSH_QUERY: 1105,
    Tag.SS_PUSH_QUERY_RESP: 1106,
    Tag.SS_PUSH_WORK: 1107,
    Tag.SS_PUSH_DEL: 1108,
    Tag.SS_MOVING_TARGETED_WORK: 1109,
    Tag.SS_NO_MORE_WORK: 1110,
    Tag.SS_EXHAUST_CHK_1: 1111,
    Tag.SS_EXHAUST_CHK_2: 1112,
    Tag.SS_DONE_BY_EXHAUSTION: 1113,
    Tag.SS_END_1: 1114,
    Tag.SS_END_2: 1115,
    Tag.SS_ABORT: 1116,
    Tag.SS_STATE: 1117,
    Tag.SS_STATE_DELTA: 1125,
    Tag.SS_HUNGRY: 1124,
    Tag.SS_PLAN_MATCH: 1118,
    Tag.SS_PLAN_MIGRATE: 1119,
    Tag.SS_MIGRATE_WORK: 1120,
    Tag.SS_MIGRATE_ACK: 1121,
    Tag.SS_PERIODIC_STATS: 1122,
    Tag.SS_CHECKPOINT: 1123,
    Tag.DS_LOG: 1131,
    Tag.DS_END: 1132,
    # worker-death reclaim (on_worker_failure="reclaim"; python servers
    # only today — ids reserved so a native plane can join the protocol)
    Tag.SS_RANK_DEAD: 1133,
    Tag.SS_COMMON_FORFEIT: 1134,
    # remote fused fetch delivery confirmation (home -> holder)
    Tag.SS_DELIVERED: 1135,
    # server failover (on_server_failure="failover"; python servers only —
    # the policy is rejected toward native planes, so these never cross
    # the codec; ids exist so the table stays total)
    Tag.SS_REPL: 1136,
    Tag.SS_SERVER_DEAD: 1137,
    Tag.TA_HOME_TAKEOVER: 1138,
    # job-namespace lifecycle fan-out (service mode; python-only today)
    Tag.SS_JOB_CTL: 1139,
    # fleet metrics gossip: server -> master registry-snapshot deltas +
    # closed unit journeys (python-only; pickled dict payloads)
    Tag.SS_OBS_SYNC: 1140,
    # elastic-membership fan-out/control plane (python-only; pickled —
    # the id exists so the codec table stays total and a native plane
    # could one day join the protocol)
    Tag.SS_MEMBER: 1141,
    # master failover (on_server_failure="failover"; python-only —
    # master succession fan-out from the promoted deputy, appended to
    # the registry like every wire change)
    Tag.SS_MASTER_TAKEOVER: 1142,
    # shm-fabric pair announcement (rides the TCP plane once per
    # connected pair; swallowed by the transport reader)
    Tag.SHM_HELLO: 1998,
    # transport-internal synthetic signal (never actually on the wire; the
    # id exists only so the codec table stays total)
    Tag.PEER_EOF: 1999,
}
TAG_FOR_WIRE = {v: k for k, v in WIRE_TAG.items()}

_KIND_I64 = 0
_KIND_BYTES = 1
_KIND_LIST = 2
_KIND_F64 = 3
_KIND_BLIST = 4  # list of byte strings: u16 count, (u32 len + bytes)*
_KIND_FLIST = 5  # list of f64: u16 count, f64*

# field name -> (wire id, kind)
FIELDS: dict[str, tuple[int, int]] = {
    "payload": (1, _KIND_BYTES),
    "work_type": (2, _KIND_I64),
    "prio": (3, _KIND_I64),
    "target_rank": (4, _KIND_I64),
    "answer_rank": (5, _KIND_I64),
    "common_len": (6, _KIND_I64),
    "common_server": (7, _KIND_I64),
    "common_seqno": (8, _KIND_I64),
    "rc": (9, _KIND_I64),
    "hint": (10, _KIND_I64),
    "req_types": (11, _KIND_LIST),
    "hang": (12, _KIND_I64),
    "rqseqno": (13, _KIND_I64),
    "handle": (14, _KIND_LIST),
    "work_len": (15, _KIND_I64),
    "time_on_q": (16, _KIND_F64),
    "count": (17, _KIND_I64),
    "nbytes": (18, _KIND_I64),
    "max_wq": (19, _KIND_I64),
    "code": (20, _KIND_I64),
    "seqno": (21, _KIND_I64),
    "refcnt": (22, _KIND_I64),
    "server_rank": (23, _KIND_I64),
    "key": (24, _KIND_I64),
    "value": (25, _KIND_F64),
    "apptag": (26, _KIND_I64),
    # balancer sidecar <-> native server (ids 27..45 are native-server-only,
    # defined in serverd.cpp; these cross the Python boundary because the
    # sidecar is the Python balancer brain driving native servers)
    "for_rank": (29, _KIND_I64),
    "req_home": (46, _KIND_I64),
    "dest": (47, _KIND_I64),
    "seqnos": (48, _KIND_LIST),
    "tasks_flat": (49, _KIND_LIST),
    "reqs_flat": (50, _KIND_LIST),
    "consumers": (51, _KIND_I64),
    # native server -> Python debug server heartbeats (DS_LOG)
    "wq_count": (54, _KIND_I64),
    "rq_count": (55, _KIND_I64),
    # pipelined puts: client-chosen id echoed in TA_PUT_RESP so responses
    # can arrive out of band (iput/flush_puts)
    "put_id": (58, _KIND_I64),
    # fused reserve+get (get_work): payload rides TA_RESERVE_RESP when the
    # unit is local and prefix-free
    "fetch": (59, _KIND_I64),
    # balancer -> servers: parked requesters exist somewhere, so put-side
    # event snapshots are worth sending (SS_HUNGRY; req_types carries the
    # wanted-type set, omitted = an any-type requester is parked)
    "hungry": (60, _KIND_I64),
    "grew": (61, _KIND_I64),
    # 62 = exhaustion token id (native server<->server only; reserved here)
    # extended DS_LOG heartbeat (the reference's 11 counters,
    # src/adlb.c:3222-3259): native daemons -> Python debug server
    "events": (63, _KIND_I64),
    "wq_targeted": (64, _KIND_I64),
    "reserves": (65, _KIND_I64),
    "reserves_immed": (66, _KIND_I64),
    "reserves_parked": (67, _KIND_I64),
    "rfr_failed": (68, _KIND_I64),
    "ss_msgs": (69, _KIND_I64),
    "backlog": (70, _KIND_I64),
    "rss_kb": (71, _KIND_I64),
    # checkpoint/resume toward native servers (FA_CHECKPOINT carries the
    # shard path prefix as bytes; the SS ring token's per-rank counts ride
    # parallel lists — the Python plane's pickled dict token never crosses
    # this codec)
    "path": (72, _KIND_BYTES),
    "client": (73, _KIND_I64),
    "started": (74, _KIND_I64),
    "ck_counts": (76, _KIND_LIST),
    # migration-batch acknowledgment: the planner stamps each
    # SS_PLAN_MIGRATE with a batch id (mig_id, forwarded in
    # SS_MIGRATE_WORK); destinations report, per SOURCE server, the
    # highest id received (mig_acks: flattened (src, id) pairs) so
    # in-flight credits clear exactly when the batch becomes visible in
    # inventory — per source because transport ordering only holds per
    # sender pair
    "mig_id": (77, _KIND_I64),
    "mig_acks": (78, _KIND_LIST),
    # batched fused fetch (get_work_batch): how many local prefix-free
    # units one TA_RESERVE_RESP may carry, plus the batch RESPONSE's
    # parallel per-unit fields — payloads with the per-unit metadata in
    # matching order. A server that predates the request field ignores
    # it and answers single-unit fused; the client handles either shape.
    "fetch_max": (79, _KIND_I64),
    "payloads": (80, _KIND_BLIST),
    "work_types": (81, _KIND_LIST),
    "prios": (82, _KIND_LIST),
    "answer_ranks": (83, _KIND_LIST),
    "times_on_q": (84, _KIND_FLIST),
    # batched SS_STATE_DELTA (round 4): puts arriving faster than
    # balancer_min_gap accumulate and flush as ONE delta with parallel
    # per-unit lists (seqnos/work_types/prios/work_lens), so the
    # balancer's inventory view tracks a streaming producer within one
    # gap instead of one unit per gap
    "work_lens": (85, _KIND_LIST),
    # worker-death reclaim: the dead world rank (SS_RANK_DEAD) and the
    # batch-common fixup op (SS_COMMON_FORFEIT; "forfeit" | "credit",
    # as bytes over the wire like "path")
    "rank": (86, _KIND_I64),
    "op": (87, _KIND_BYTES),
    # per-client FA_GET_COMMON request id: consecutive fetches of the
    # SAME prefix are legitimate (one per batch member), so duplicate
    # re-sends can only be told apart by id (native daemons parse-and-
    # ignore unknown ids, so this is plane-compatible)
    "get_id": (88, _KIND_I64),
    # prefetch pipeline: FA_RESERVE sent by a get_work_stream slot — the
    # rank may still be computing, so the park only counts as idle for
    # exhaustion voting after FA_STREAM_IDLE (native daemons parse-and-
    # ignore unknown ids)
    "prefetch": (89, _KIND_I64),
    # FA_STREAM_IDLE: the stream's in-flight reserve count — the server
    # honors the idle note only when that many entries are still parked,
    # voiding notes that crossed a delivery on the wire (legacy
    # count-only form; current clients send the slot list below)
    "inflight": (90, _KIND_I64),
    # FA_STREAM_IDLE: the outstanding reserve rqseqnos themselves — the
    # server reconciles them against its parked entries exactly (idle
    # mark on equality; swept-stream phantom slots re-armed by id)
    "slots": (91, _KIND_LIST),
    # gray-failure surface: a unit's failure-attempt count (rides
    # SS_PUSH_WORK so quarantine budgets survive memory-pressure pushes)
    # and the TA_PUT_RESP backpressure retry-after hint (ADLB_BACKOFF)
    "attempts": (92, _KIND_I64),
    "retry_after_ms": (93, _KIND_I64),
    # TA_QUARANTINED_RESP: the dead-letter store as parallel per-unit
    # lists (payloads/work_types/prios/answer_ranks/seqnos reused from
    # the batch-fetch idiom above)
    "target_ranks": (94, _KIND_LIST),
    "attempts_list": (95, _KIND_LIST),
    # ... and per-unit 0/1 flags: payload is a fused member's suffix
    # whose prefix was not stored on (or did not survive to) the
    # answering server
    "suffix_onlys": (96, _KIND_LIST),
    # job namespace (service mode): which tenant a put/reserve/ctl frame
    # belongs to. Omitted = the default namespace 0, so single-job
    # traffic is byte-identical to the pre-service protocol; native
    # daemons parse-and-ignore the field (job matching is a Python-
    # server feature today).
    "job_id": (97, _KIND_I64),
    # unit-lifecycle trace context (Config(trace_sample) head-sampling):
    # a sampled FA_PUT carries the client-minted trace id and the unit's
    # journey is recorded server-side stage by stage (obs/journey.py).
    # Omitted for unsampled puts, so trace_sample=0 worlds stay
    # byte-identical on the wire; native daemons parse-and-ignore it.
    "trace_id": (98, _KIND_I64),
    # elastic membership (FA_MEMBER/TA_MEMBER_RESP/SS_MEMBER; python-only
    # today — ids reserved append-only so a native plane joining later,
    # or a mixed-version fleet, degrades loudly instead of misparsing):
    # the fleet epoch every membership op (and exhaustion/END token)
    # keys on; the membership op name; the joiner's listener endpoint;
    # the fan-out ack token; the allocated home server; member kind
    "epoch": (99, _KIND_I64),
    "mop": (100, _KIND_BYTES),
    "host": (101, _KIND_BYTES),
    "port": (102, _KIND_I64),
    "member_tok": (103, _KIND_I64),
    "home": (104, _KIND_I64),
    "kind": (105, _KIND_BYTES),
    # multi-job planning (SS_STATE_DELTA): per-unit job ids for a
    # batched task delta whose units are not all in the default
    # namespace. Omitted when every unit is job 0, so single-job worlds
    # stay byte-identical; native daemons parse-and-ignore it (the
    # native plane advertises only the default namespace today).
    "jobs": (106, _KIND_LIST),
    # master failover (SS_MASTER_TAKEOVER, wire tag 1142): the promoted
    # deputy's rank. Rides the succession fan-out (and the extended
    # TA_HOME_TAKEOVER note) alongside the reused epoch/mop/host/port/
    # member_tok ids above. Append-only; native daemons parse-and-ignore.
    "new_master": (107, _KIND_I64),
}
FIELD_FOR_WIRE = {v[0]: (k, v[1]) for k, v in FIELDS.items()}

_HDR = struct.Struct("<BHiH")  # magic, tag, src, nfields
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")


def encodable(m: Msg) -> bool:
    """True if every field of m has a binary field id (None values are
    encoded by omission)."""
    if m.tag is Tag.AM_APP:
        # native clients receive app messages via ADLB_App_recv, but only
        # raw bytes survive the TLV form — arbitrary Python payloads would
        # silently corrupt, so they are refused with a clear error
        return isinstance(m.data.get("payload"), (bytes, bytearray))
    return all(k in FIELDS for k, v in m.data.items() if v is not None)


# bytes fields at least this large ride the iovec as zero-copy views;
# smaller ones fold into the accumulating header segment (a syscall's
# iovec slots and a ring's bookkeeping both cost more than a small copy)
IOV_INLINE_MAX = 512


def _bytes_view(value):
    """Normalize a bytes-field value to a flat byte buffer. A memoryview
    with itemsize != 1 must be cast to bytes ('B') first: ``len()`` on
    it counts ITEMS, and emitting an item count as the u32 byte length
    would desync the whole TLV stream."""
    if isinstance(value, (bytes, bytearray)):
        return value
    if isinstance(value, memoryview):
        if value.itemsize == 1 and value.ndim == 1 and value.contiguous:
            return value  # zero-copy fast path; len() == byte length
        return bytes(value)  # flatten (tobytes) — correct byte length
    return bytes(value)


def encode_binary_iov_py(m: Msg) -> list:
    """Scatter-gather form of :func:`encode_binary`: a list of buffers
    whose concatenation is the frame body, with large ``bytes`` payloads
    (put/fetch bodies, batch payload lists) left as zero-copy views
    instead of being concatenated into a fresh body. The TCP plane hands
    the list straight to ``sendmsg`` and the shm fabric writes the
    segments into the ring — either way the payload bytes are copied
    exactly once (into the kernel buffer / the ring), never first into
    an intermediate ``hdr + body`` string."""
    fields = [(k, v) for k, v in m.data.items() if v is not None]
    parts: list = []
    acc = bytearray(_HDR.pack(BINARY_MAGIC, WIRE_TAG[m.tag], m.src,
                              len(fields)))
    for name, value in fields:
        fid, kind = FIELDS[name]
        acc += struct.pack("<BB", fid, kind)
        if kind == _KIND_I64:
            acc += _I64.pack(int(value))
        elif kind == _KIND_BYTES:
            b = _bytes_view(value)
            acc += _U32.pack(len(b))
            if len(b) >= IOV_INLINE_MAX:
                parts.append(bytes(acc))
                acc = bytearray()
                parts.append(b)
            else:
                acc += b
        elif kind == _KIND_LIST:
            seq = [int(x) for x in value]
            if len(seq) > 65535:
                raise ValueError(f"list field {name} overflows u16 bound")
            acc += _U16.pack(len(seq))
            for x in seq:
                acc += _I64.pack(x)
        elif kind == _KIND_BLIST:
            if len(value) > 65535:
                raise ValueError(f"blist field {name} overflows u16 bound")
            acc += _U16.pack(len(value))
            for item in value:
                b = _bytes_view(item)
                acc += _U32.pack(len(b))
                if len(b) >= IOV_INLINE_MAX:
                    parts.append(bytes(acc))
                    acc = bytearray()
                    parts.append(b)
                else:
                    acc += b
        elif kind == _KIND_FLIST:
            seq = [float(x) for x in value]
            if len(seq) > 65535:
                raise ValueError(f"flist field {name} overflows u16 bound")
            acc += _U16.pack(len(seq))
            for x in seq:
                acc += _F64.pack(x)
        else:
            acc += _F64.pack(float(value))
    if acc:
        parts.append(bytes(acc))
    return parts


def decode_binary_py(body) -> Msg:
    magic, wire_tag, src, nfields = _HDR.unpack_from(body, 0)
    if magic != BINARY_MAGIC:
        raise ValueError(f"bad binary frame magic {magic:#x}")
    tag = TAG_FOR_WIRE[wire_tag]
    off = _HDR.size
    data: dict = {}
    for _ in range(nfields):
        fid, kind = struct.unpack_from("<BB", body, off)
        off += 2
        if kind == _KIND_I64:
            (value,) = _I64.unpack_from(body, off)
            off += 8
        elif kind == _KIND_BYTES:
            (n,) = _U32.unpack_from(body, off)
            off += 4
            if off + n > len(body):
                raise ValueError("truncated bytes field in binary frame")
            value = body[off:off + n]
            off += n
        elif kind == _KIND_LIST:
            (cnt,) = _U16.unpack_from(body, off)
            off += 2
            value = [
                _I64.unpack_from(body, off + 8 * i)[0] for i in range(cnt)
            ]
            off += 8 * cnt
        elif kind == _KIND_F64:
            (value,) = _F64.unpack_from(body, off)
            off += 8
        elif kind == _KIND_BLIST:
            (cnt,) = _U16.unpack_from(body, off)
            off += 2
            value = []
            for _i in range(cnt):
                (n,) = _U32.unpack_from(body, off)
                off += 4
                if off + n > len(body):
                    raise ValueError("truncated blist item in binary frame")
                value.append(body[off:off + n])
                off += n
        elif kind == _KIND_FLIST:
            (cnt,) = _U16.unpack_from(body, off)
            off += 2
            value = [
                _F64.unpack_from(body, off + 8 * i)[0] for i in range(cnt)
            ]
            off += 8 * cnt
        else:
            raise ValueError(f"bad field kind {kind}")
        entry = FIELD_FOR_WIRE.get(fid)
        if entry is not None:  # unknown fields are skipped, not fatal
            data[entry[0]] = value
    # protocol-level conveniences: hang arrives as 0/1
    if "hang" in data:
        data["hang"] = bool(data["hang"])
    return Msg(tag=tag, src=src, data=data)


# --------------------------------------------------------- compiled twin
#
# The hot-path encode/decode pair also exists as a C core
# (adlb_tpu_torch/native/codec.cpp, built like wqcore by native/build.py and
# loaded through ctypes.PyDLL, like the queue core: GIL
# held, PyObjects in and out, one plain C call per frame). The Python
# implementations above are retained verbatim as the fallback/reference
# twin; tests/test_codec_fuzz.py holds the two byte-identical in both
# directions. Selection is per-process at import, like wqcore:
# ``ADLB_CODEC`` env ("auto"/"c"/"py", default auto = C when the .so
# builds) decides the initial implementation, and the world harnesses
# re-apply ``Config(codec=...)`` via :func:`select_codec` ("c" there is
# strict — no silent fallback for an explicit ask).

_codec_active = "py"
_c_encode_iov = None
_c_decode = None


def _load_c_codec() -> bool:
    """Bind the compiled codec (building it if needed); False + recorded
    reason when the toolchain is unavailable."""
    global _c_encode_iov, _c_decode
    if _c_encode_iov is not None:
        return True
    from adlb_tpu_torch.native.build import ensure_codec

    mod = ensure_codec()
    if mod is None:
        return False
    # hand the C core the live protocol tables — same objects, so the
    # twins cannot drift within a process
    mod.setup(FIELDS, IOV_INLINE_MAX, WIRE_TAG, TAG_FOR_WIRE, Msg)
    _c_encode_iov = mod.encode_iov
    _c_decode = mod.decode
    return True


_ENC_IOV = encode_binary_iov_py
_DEC = decode_binary_py


def select_codec(which: str = "auto") -> str:
    """Pick the wire-codec implementation for this process: "py" forces
    the Python twin, "c" requires the compiled core (RuntimeError when it
    cannot build), "auto" uses the compiled core when available. Returns
    the implementation now active."""
    global _ENC_IOV, _DEC, _codec_active
    if which not in ("auto", "c", "py"):
        raise ValueError(f"unknown codec {which!r}")
    if which == "py":
        _ENC_IOV, _DEC, _codec_active = encode_binary_iov_py, decode_binary_py, "py"
    elif _load_c_codec():
        _ENC_IOV, _DEC, _codec_active = _c_encode_iov, _c_decode, "c"
    elif which == "c":
        from adlb_tpu_torch.native.build import codec_error

        raise RuntimeError(
            f"Config(codec='c') but the compiled codec is unavailable: "
            f"{codec_error()}"
        )
    else:
        _ENC_IOV, _DEC, _codec_active = encode_binary_iov_py, decode_binary_py, "py"
    return _codec_active


def active_codec() -> str:
    """Which implementation carries this process's frames ("c"/"py")."""
    return _codec_active


def encode_binary_iov(m: Msg) -> list:
    """Scatter-gather frame encode via the active implementation (see
    :func:`select_codec`); the docstring of record is on the Python twin
    :func:`encode_binary_iov_py`."""
    return _ENC_IOV(m)


def decode_binary(body) -> Msg:
    return _DEC(body)


def encode_binary(m: Msg) -> bytes:
    return b"".join(bytes(p) for p in _ENC_IOV(m))


# import-time selection, like wqcore: the env override is the CI hook
select_codec(os.environ.get("ADLB_CODEC", "auto").strip().lower() or "auto")


# ------------------------------------------------------ wire-native gate


_WIRE_NATIVE = (int, float, bytes, bytearray, memoryview)


def wire_native_ok(m: Msg) -> bool:
    """Should this python<->python frame ride the TLV body instead of
    pickle (shm rings and multiplexed TCP channels both ask)? Only
    client<->server traffic — the put/fetch hot path, whose
    TLV-into-Python-server decode is proven by the native C clients —
    and only when every value is wire-native: a str (checkpoint path,
    forfeit op) or richer object would round-trip as a different type
    than the pickle plane delivers, so those frames keep the pickle
    body."""
    name = m.tag.name
    if not (name.startswith("FA_") or name.startswith("TA_")
            or m.tag is Tag.AM_APP):
        return False
    if not encodable(m):
        return False
    for v in m.data.values():
        if v is None or isinstance(v, _WIRE_NATIVE):
            continue
        if isinstance(v, (list, tuple, frozenset, set)):
            if all(isinstance(x, _WIRE_NATIVE) for x in v):
                continue
        return False
    return True
