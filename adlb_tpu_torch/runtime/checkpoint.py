"""Pool-state checkpoint shards.

The reference has **no** pool serialization (SURVEY §5: checkpoint/resume
absent entirely — killing a run loses every queued unit). This framework
adds it: on ``ctx.checkpoint(prefix)`` a ring token makes every server
write its queue shard to ``<prefix>.<server_rank>.ckpt``; a new world
started with ``Config(restore_path=prefix)`` reloads each server's shard at
init. Restore assumes the same world shape (rank numbering), since targeted
units and batch-common references name ranks.

Semantics: the shard is the pool at token-arrival time — pinned units
(reserved but not yet fetched) are captured too, so a restore rolls the
pool back to the snapshot and work consumed after it is re-executed, the
standard crash-recovery contract; it also keeps batch-common refcounts
consistent. Each server holds the token until its in-flight migration
batches are acked, closing the tracked in-transit window; a unit that
migrates INTO an already-checkpointed server while the token is still
circulating is live in the world but absent from the checkpoint — take
checkpoints at quiescent points (e.g. between phases) for exact capture.

Shard format (little-endian): magic ``ACK2``, then a header ``<III``
(format version, world nranks, world nservers), u32 unit count, per unit
``<iiiqqq`` (work_type, target_rank, answer_rank, prio as q, common_server,
common_seqno) + u32 common_len + u32 payload_len + payload bytes; then u32
common-entry count, per entry ``<qqq`` (seqno, refcnt, ngets) + u32 len +
buf.

Restores validate the header's world shape **loudly**: targeted units and
batch-common references name ranks, so loading a shard into a different
shape would silently misroute them. ``ACK1`` shards (pre-header, written
by earlier builds and by older native daemons) carry no shape to check —
loading one silently skips that validation, so since the WAL began
compacting into ACK2-only snapshots the legacy read path is **gated**:
an ACK1 shard raises unless the caller opts in via
``Config(allow_legacy_shards=True)`` (the native daemon, serverd.cpp,
writes and validates ACK2 itself and is unaffected).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Optional

_MAGIC = b"ACK2"
_MAGIC_V1 = b"ACK1"
_VERSION = 2
_SHAPE = struct.Struct("<III")  # version, nranks, nservers
_UNIT = struct.Struct("<iiiqqq")
_U32 = struct.Struct("<I")
_CQE = struct.Struct("<qqq")


class ShardShapeError(ValueError):
    """Restore-time world shape (or format version) mismatch — failing
    loudly beats silently misrouting every targeted unit."""


def shard_path(prefix: str, server_rank: int) -> str:
    return f"{prefix}.{server_rank}.ckpt"


def save_shard(prefix: str, server_rank: int, units: Iterable, cq,
               world=None) -> int:
    """Write one server's shard; returns the number of units captured.
    ``world`` (a WorldSpec, optional for bare callers) stamps the shape
    header so a mismatched restore fails loudly."""
    n = 0
    body = []
    for u in units:
        body.append(
            _UNIT.pack(u.work_type, u.target_rank, u.answer_rank,
                       u.prio, u.common_server_rank, u.common_seqno)
        )
        body.append(_U32.pack(u.common_len))
        body.append(_U32.pack(len(u.payload)))
        body.append(u.payload)
        n += 1
    centries = list(cq.entries()) if cq is not None else []
    nranks = world.nranks if world is not None else 0
    nservers = world.nservers if world is not None else 0
    out = [_MAGIC, _SHAPE.pack(_VERSION, nranks, nservers), _U32.pack(n)]
    out.extend(body)
    out.append(_U32.pack(len(centries)))
    for e in centries:
        out.append(_CQE.pack(e.seqno, e.refcnt, e.ngets))
        out.append(_U32.pack(len(e.buf)))
        out.append(e.buf)
    tmp = f"{shard_path(prefix, server_rank)}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
    os.replace(tmp, shard_path(prefix, server_rank))
    return n


def existing_shard_ranks(prefix: str) -> list[int]:
    """Server ranks that have shards on disk for this prefix."""
    import glob
    import re

    out = []
    for path in glob.glob(f"{prefix}.*.ckpt"):
        m = re.match(re.escape(prefix) + r"\.(\d+)\.ckpt$", path)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def load_shard(prefix: str, server_rank: int, world=None,
               allow_legacy: bool = False):
    """Read one server's shard; returns (units, common_entries) where units
    are dicts of constructor fields (seqnos are assigned by the server) and
    common_entries are (seqno, refcnt, ngets, buf) tuples. Missing shard =
    loud (a server with no queued work writes one anyway). With ``world``
    given, an ACK2 header naming a different world shape raises
    :class:`ShardShapeError` instead of silently misrouting targeted
    units. ACK1 shards carry no shape header, so they can never pass
    that check — reading one is refused unless ``allow_legacy``
    (Config(allow_legacy_shards)) explicitly opts into the unvalidated
    path."""
    path = shard_path(prefix, server_rank)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint shard missing: {path} (was the checkpoint taken "
            f"with the same world shape?)"
        )
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:4]
    off = 4
    if magic == _MAGIC:
        version, nranks, nservers = _SHAPE.unpack_from(data, off)
        off += _SHAPE.size
        if version > _VERSION:
            raise ShardShapeError(
                f"{path}: shard format version {version} is newer than this "
                f"build understands ({_VERSION})"
            )
        if world is not None and nranks and (
            nranks != world.nranks or nservers != world.nservers
        ):
            raise ShardShapeError(
                f"{path}: checkpoint was taken with nranks={nranks}/"
                f"nservers={nservers} but this world is "
                f"nranks={world.nranks}/nservers={world.nservers}; restore "
                f"with the same world shape"
            )
    elif magic == _MAGIC_V1:
        if not allow_legacy:
            raise ShardShapeError(
                f"{path}: legacy ACK1 shard (no world-shape header to "
                f"validate); re-checkpoint with a current build, or opt "
                f"into the unvalidated read with "
                f"Config(allow_legacy_shards=True)"
            )
    else:
        raise ValueError(f"{path}: bad shard magic")
    (n,) = _U32.unpack_from(data, off)
    off += 4
    units = []
    for _ in range(n):
        wt, target, answer, prio, cserver, cseqno = _UNIT.unpack_from(
            data, off
        )
        off += _UNIT.size
        (clen,) = _U32.unpack_from(data, off)
        off += 4
        (plen,) = _U32.unpack_from(data, off)
        off += 4
        payload = data[off:off + plen]
        off += plen
        units.append(
            dict(work_type=wt, target_rank=target, answer_rank=answer,
                 prio=prio, common_server_rank=cserver, common_seqno=cseqno,
                 common_len=clen, payload=payload)
        )
    (nc,) = _U32.unpack_from(data, off)
    off += 4
    centries = []
    for _ in range(nc):
        seqno, refcnt, ngets = _CQE.unpack_from(data, off)
        off += _CQE.size
        (blen,) = _U32.unpack_from(data, off)
        off += 4
        centries.append((seqno, refcnt, ngets, data[off:off + blen]))
        off += blen
    return units, centries
