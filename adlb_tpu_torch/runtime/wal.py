"""Per-server write-ahead log: durable service mode.

The replication stream (``replica.py``) is already *write-ahead for put acks* — an
accepted put's log entry leaves for the ring buddy before the client
sees the ack — but the buddy's mirror lives in memory, so a whole-fleet
crash (power loss, OOM-killer sweep, deliberate restart) still loses
every queued unit, exactly the reference's no-pool-serialization gap
(SURVEY §5). This module tees the same op stream (``replica.OP_*``) to
an append-only on-disk log under ``Config(wal_dir)``:

* **Group-commit fsync** (``Config(wal_fsync_ms)``): entries buffer in
  memory and hit the OS file on every reactor pass, but ``fsync`` runs
  at most once per window — and *put acks are held until the fsync that
  covers them*, so the write-ahead invariant (an acked put is durable)
  holds at amortized, not per-op, fsync cost. ``wal_fsync_ms=0`` fsyncs
  on every flush (strictest, slowest).
* **Record framing**: each entry is wrapped ``<II`` (crc32, length) so
  a torn tail — the crash landing mid-``write`` — is detected, not
  replayed: recovery stops at the first record whose length or CRC does
  not check out and truncates the log there. Everything before it is
  the durable prefix.
* **Compaction** (``Config(wal_max_bytes)``): when the log outgrows the
  threshold, the server snapshots its pool into the existing **ACK2
  checkpoint shard format** (``checkpoint.save_shard``) and starts a
  fresh log segment whose head record is a snapshot *manifest* — the
  shard's units' seqnos/jobs/attempt counts in shard order (the ACK2
  format deliberately carries no seqnos; the manifest restores the
  correlation so the log tail's consume/pin entries resolve exactly).
  Segment and shard swap in atomically (write-new + ``os.replace``),
  and the previous generation's shard is kept until the new segment is
  live.
* **Recovery** reuses the :class:`replica.ReplicaMirror` replay
  machinery rather than a second applier: the log replays into a
  mirror (shard units installed at the manifest record), and the
  server adopts the mirror's pool — units unpinned (their owners died
  with the old fleet), batch-common entries under their original
  seqnos, quarantine records, put-dedup windows, and the job table.
  Cold restart of a server (or the whole fleet) is shard-load + replay.

Loss model: everything fsynced is recovered; the tail after the last
group commit is lost *except that no put in it was ever acked* — the
conservation contract (completed / re-executed / counted lost, zero
silent loss) extends across process death.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Iterable, Optional

from adlb_tpu_torch.runtime.replica import (
    _HDR,
    ReplicaMirror,
    ReplicationLog,
)

# on-disk record framing: crc32 of the entry bytes, then entry length.
# The entry itself is the replica wire form (op byte + body length +
# body), so the mirror replays it unchanged.
_REC = struct.Struct("<II")

# WAL-private ops (replica ops are 1..63; these never cross a socket)
WAL_OP_SNAPSHOT = 200
_SNAPHDR = struct.Struct("<qI")    # shard generation, unit count
_SNAPROW = struct.Struct("<qqi")   # unit seqno, job, attempts

# group-commit backstop: never hold more than this many acks for one
# fsync window, whatever the timer says
MAX_PENDING_ACKS = 256


def log_path(wal_dir: str, rank: int) -> str:
    return os.path.join(wal_dir, f"server.{rank}.log")


def snap_prefix(wal_dir: str, rank: int, generation: int) -> str:
    """Checkpoint-shard prefix for one compaction generation; the shard
    itself lands at ``<prefix>.<rank>.ckpt`` (checkpoint.shard_path)."""
    return os.path.join(wal_dir, f"server.{rank}.g{generation}")


class WriteAheadLog(ReplicationLog):
    """Disk sink with the ReplicationLog append surface.

    Inherits every ``log_*`` method (the tee hands the server ONE call
    shape for both sinks); ``tick()`` moves the buffered entries to the
    file and runs the group commit. Never sends anything — ``buddy`` is
    a vestigial -1.
    """

    def __init__(self, wal_dir: str, rank: int, world=None,
                 fsync_ms: float = 5.0, max_bytes: int = 64 << 20,
                 allow_legacy: bool = False) -> None:
        super().__init__(buddy=-1)
        self.dir = wal_dir
        self.rank = rank
        self.world = world
        self.fsync_ms = fsync_ms
        self.max_bytes = max_bytes
        self.allow_legacy = allow_legacy
        self.path = log_path(wal_dir, rank)
        os.makedirs(wal_dir, exist_ok=True)
        self._f = None
        self.size = 0              # bytes in the current segment
        self.generation = 0        # last compaction's shard generation
        self._unsynced = 0         # entries written but not yet fsynced
        self._first_unsynced_t: Optional[float] = None
        # put acks held for the write-ahead invariant: released by the
        # fsync that covers their entries. (app_rank, Msg) pairs.
        self.pending_acks: list = []
        self.entries_synced = 0
        self.syncs = 0
        self.compactions = 0
        self.recovered_torn = False

    # -- write path ----------------------------------------------------------

    def _open(self) -> None:
        if self._f is None:
            self._f = open(self.path, "ab")
            self.size = self._f.tell()

    def defer_ack(self, app: int, resp) -> None:
        """Hold a put ack until its entry is durable."""
        self.pending_acks.append((app, resp))

    @property
    def depth(self) -> int:
        """Entries not yet durable (buffered + written-unsynced)."""
        return len(self._buf) + self._unsynced

    def fsync_lag_ms(self, now: float) -> float:
        t0 = self._first_unsynced_t
        return 0.0 if t0 is None else (now - t0) * 1e3

    def next_deadline(self, default: float) -> float:
        """When the reactor must wake to run the group commit."""
        if not (self._buf or self._unsynced or self.pending_acks):
            return default
        if self.fsync_ms <= 0:
            return 0.0
        t0 = self._first_unsynced_t
        base = time.monotonic() if t0 is None else t0
        return base + self.fsync_ms / 1e3

    def _write_out(self) -> None:
        """Buffered entries -> OS file (no fsync)."""
        if not self._buf:
            return
        self._open()
        recs = []
        for entry in self._buf:
            recs.append(_REC.pack(zlib.crc32(entry), len(entry)))
            recs.append(entry)
        blob = b"".join(recs)
        self._f.write(blob)
        self.size += len(blob)
        self._unsynced += len(self._buf)
        if self._first_unsynced_t is None:
            self._first_unsynced_t = time.monotonic()
        self._buf.clear()

    def _sync(self) -> list:
        """fsync the segment; returns the acks the commit releases."""
        if self._f is not None and self._unsynced:
            self._f.flush()
            os.fsync(self._f.fileno())
        self.entries_synced += self._unsynced
        self.syncs += 1
        self._unsynced = 0
        self._first_unsynced_t = None
        acks, self.pending_acks = self.pending_acks, []
        return acks

    def tick(self, now: float, force: bool = False) -> list:
        """One reactor pass: write out, group-commit when due. Returns
        the (app, Msg) acks released by a commit (empty otherwise)."""
        self._write_out()
        if not (self._unsynced or self.pending_acks):
            return []
        due = (
            force
            or self.fsync_ms <= 0
            or len(self.pending_acks) >= MAX_PENDING_ACKS
            or (
                self._first_unsynced_t is not None
                and now >= self._first_unsynced_t + self.fsync_ms / 1e3
            )
        )
        return self._sync() if due else []

    def close(self) -> None:
        try:
            self.tick(time.monotonic(), force=True)
        finally:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -- compaction ----------------------------------------------------------

    def maybe_compact(self, server) -> bool:
        if self.max_bytes <= 0 or self.size < self.max_bytes:
            return False
        self.compact(server)
        return True

    def compact(self, server) -> None:
        """Snapshot the live pool into an ACK2 shard + fresh segment.

        The snapshot captures everything the old segment's entries
        produced (the wq/cq ARE that state), so the old segment and the
        previous generation's shard retire together. Held put acks
        release after the new segment is durable — their units are in
        the shard, which is stricter than the fsync they were waiting
        for."""
        from adlb_tpu_torch.runtime import checkpoint

        gen = self.generation + 1
        # spill tier: the snapshot shard serializes payload bytes, so
        # any spilled payloads must be resident first
        fault_in = getattr(server, "_spill_fault_in_all", None)
        if fault_in is not None:
            fault_in()
        units = list(server.wq.units())
        checkpoint.save_shard(
            snap_prefix(self.dir, self.rank, gen), self.rank, units,
            server.cq, world=server.world,
        )
        # fresh segment: manifest first (ACK2 carries no seqnos — this
        # row list restores the correlation for the tail's entries),
        # then the durable non-pool state the shard format cannot hold
        seed = ReplicationLog(buddy=-1)
        body = _SNAPHDR.pack(gen, len(units)) + b"".join(
            _SNAPROW.pack(u.seqno, getattr(u, "job", 0),
                          getattr(u, "attempts", 0))
            for u in units
        )
        entries = [_HDR.pack(WAL_OP_SNAPSHOT, len(body)) + body]
        server._wal_seed(seed)
        entries.extend(seed._buf)
        newpath = self.path + ".new"
        with open(newpath, "wb") as nf:
            for entry in entries:
                nf.write(_REC.pack(zlib.crc32(entry), len(entry)))
                nf.write(entry)
            nf.flush()
            os.fsync(nf.fileno())
            newsize = nf.tell()
        if self._f is not None:
            self._f.close()
        os.replace(newpath, self.path)
        self._f = open(self.path, "ab")
        self.size = newsize
        old_gen, self.generation = self.generation, gen
        self.compactions += 1
        # old generation's shard only retires once the new segment is
        # the live one (a crash between the two replaces leaves both on
        # disk; the manifest names the right generation)
        if old_gen:
            try:
                os.remove(checkpoint.shard_path(
                    snap_prefix(self.dir, self.rank, old_gen), self.rank
                ))
            except OSError:
                pass
        # entries buffered for the old segment are superseded by the
        # snapshot; their acks release now (durable via the shard)
        self._buf.clear()
        self._unsynced = 0
        self._first_unsynced_t = None
        acks, self.pending_acks = self.pending_acks, []
        self._released_by_compact = acks

    def take_compact_acks(self) -> list:
        acks = getattr(self, "_released_by_compact", [])
        self._released_by_compact = []
        return acks

    # -- recovery ------------------------------------------------------------

    def recover(self) -> Optional[ReplicaMirror]:
        """Replay an existing log into a fresh mirror; truncate any torn
        tail; position the writer at the durable end. Returns None when
        no prior log exists (cold start of a brand-new fleet)."""
        if not os.path.exists(self.path):
            self._open()
            return None
        with open(self.path, "rb") as f:
            data = f.read()
        mirror = ReplicaMirror(self.rank)
        off = 0
        n = len(data)
        while off + _REC.size <= n:
            crc, ln = _REC.unpack_from(data, off)
            start = off + _REC.size
            if start + ln > n:
                break  # torn tail: record body cut mid-write
            entry = data[start:start + ln]
            if zlib.crc32(entry) != crc:
                break  # torn tail: record body corrupt
            op, blen = _HDR.unpack_from(entry, 0)
            body = entry[_HDR.size:_HDR.size + blen]
            if op == WAL_OP_SNAPSHOT:
                self._load_snapshot(mirror, body)
            else:
                mirror.apply_entry(op, body)
            off = start + ln
        if off < n:
            self.recovered_torn = True
            os.truncate(self.path, off)
        self._f = open(self.path, "ab")
        self.size = off
        return mirror

    def _load_snapshot(self, mirror: ReplicaMirror, body: bytes) -> None:
        from adlb_tpu_torch.runtime import checkpoint

        gen, count = _SNAPHDR.unpack_from(body, 0)
        rows = [
            _SNAPROW.unpack_from(body, _SNAPHDR.size + i * _SNAPROW.size)
            for i in range(count)
        ]
        units, centries = checkpoint.load_shard(
            snap_prefix(self.dir, self.rank, gen), self.rank, self.world,
            allow_legacy=self.allow_legacy,
        )
        if len(units) != count:
            raise ValueError(
                f"WAL snapshot manifest names {count} units but shard "
                f"generation {gen} holds {len(units)}"
            )
        for (seqno, job, attempts), fields in zip(rows, units):
            fields = dict(fields)
            fields["job"] = job
            fields["attempts"] = attempts
            mirror.units[seqno] = fields
        for seqno, refcnt, ngets, buf in centries:
            mirror.commons[seqno] = [buf, refcnt, ngets, 0]
        self.generation = gen


class TeeLog:
    """Fan one ``log_*`` call out to several sinks (the network
    replication log and the WAL). The server mutates through ONE handle
    so no path can forget a sink."""

    def __init__(self, sinks: Iterable) -> None:
        self.sinks = [s for s in sinks if s is not None]


def _tee(name: str):
    def fan(self, *a, **kw):
        for s in self.sinks:
            getattr(s, name)(*a, **kw)
    fan.__name__ = name
    return fan


for _name in [m for m in dir(ReplicationLog) if m.startswith("log_")]:
    setattr(TeeLog, _name, _tee(_name))


def make_wlog(repl, wal):
    """The server's single mutation-log handle: None, the lone sink, or
    a tee over both."""
    sinks = [s for s in (repl, wal) if s is not None]
    if not sinks:
        return None
    if len(sinks) == 1:
        return sinks[0]
    return TeeLog(sinks)


def scan_records(path: str) -> tuple[list[tuple[int, bytes]], bool]:
    """Diagnostic/test helper: (durable (op, body) list, torn?)."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    off = 0
    n = len(data)
    while off + _REC.size <= n:
        crc, ln = _REC.unpack_from(data, off)
        start = off + _REC.size
        if start + ln > n or zlib.crc32(data[start:start + ln]) != crc:
            return out, True
        entry = data[start:start + ln]
        op, blen = _HDR.unpack_from(entry, 0)
        out.append((op, entry[_HDR.size:_HDR.size + blen]))
        off = start + ln
    return out, off < n
