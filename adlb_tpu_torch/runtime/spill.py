"""Disk spill tier: memory pressure degrades to slower-fetch, not backoff.

The memory watermarks turn an overfull server into backpressure
(``ADLB_BACKOFF``) or reference-style rejects — correct, but they stall
producers while *cold parked payloads* sit in RAM doing nothing.  This
module gives the server a second residency tier under
``Config(spill_dir)``: above the spill watermark (default: the soft
watermark), the server moves the largest/coldest unpinned payloads to an
append-only per-server file and keeps only the unit metadata resident;
delivery faults the bytes back in transparently (``Server._unspill`` at
pin/push/migrate/checkpoint/quarantine time).  ``MemoryAccountant``
tracks resident and spilled bytes separately, so admission control sees
only what actually occupies RAM.

On-disk format reuses the WAL's crc-framed records (``<II`` crc32 +
length, wal.py) over a tiny ``<qI`` (seqno, payload length) header —
a torn or corrupt record is detected at fault-in and surfaces as a
loud error, never silently different bytes.  The file is *residency
management*, not durability: it is truncated at server start (a dead
server's pool recovers via the WAL/replica paths, which always carry
full payloads), and space from faulted-in records is reclaimed by
rewriting live records once dead bytes dominate.
"""

from __future__ import annotations

import os
import struct
import zlib

# record framing shared with the WAL: crc32 of the body, body length
_REC = struct.Struct("<II")
# body header: unit seqno, payload length
_SPILLHDR = struct.Struct("<qI")

# compaction trigger: dead (faulted-in / discarded) bytes must both
# exceed this floor and outweigh the live remainder 2:1
COMPACT_MIN_DEAD = 4 << 20


class SpillCorruption(RuntimeError):
    """A spill record failed its CRC/length check at fault-in."""


class SpillStore:
    """Append-only payload spill file with an in-memory index."""

    def __init__(self, spill_dir: str, rank: int) -> None:
        os.makedirs(spill_dir, exist_ok=True)
        self.path = os.path.join(spill_dir, f"spill.{rank}.dat")
        # a previous incarnation's file indexes nothing we know: truncate
        self._f = open(self.path, "w+b")
        self._index: dict[int, tuple[int, int]] = {}  # seqno -> (off, n)
        self.live_bytes = 0
        self.dead_bytes = 0
        self.spills = 0
        self.faultins = 0
        self.compactions = 0

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, seqno: int) -> bool:
        return seqno in self._index

    def put(self, seqno: int, payload: bytes) -> None:
        assert seqno not in self._index
        body_hdr = _SPILLHDR.pack(seqno, len(payload))
        crc = zlib.crc32(payload, zlib.crc32(body_hdr))
        f = self._f
        f.seek(0, os.SEEK_END)
        off = f.tell()
        f.write(_REC.pack(crc, _SPILLHDR.size + len(payload)))
        f.write(body_hdr)
        f.write(payload)
        # flush to the page cache (no fsync — this is residency, not
        # durability): bytes held in the interpreter's file buffer
        # would defeat the memory relief being bought
        f.flush()
        self._index[seqno] = (off, len(payload))
        self.live_bytes += len(payload)
        self.spills += 1

    def take(self, seqno: int) -> bytes:
        """Fault one payload back in (removes it from the store)."""
        off, n = self._index.pop(seqno)
        f = self._f
        f.seek(off)
        rec = f.read(_REC.size + _SPILLHDR.size + n)
        if len(rec) < _REC.size + _SPILLHDR.size + n:
            raise SpillCorruption(
                f"spill record for seqno {seqno} truncated ({self.path})"
            )
        crc, ln = _REC.unpack_from(rec, 0)
        body = rec[_REC.size:]
        if ln != len(body) or zlib.crc32(body) != crc:
            raise SpillCorruption(
                f"spill record for seqno {seqno} failed CRC ({self.path})"
            )
        sq, pn = _SPILLHDR.unpack_from(body, 0)
        if sq != seqno or pn != n:
            raise SpillCorruption(
                f"spill record at {off} names seqno {sq}, wanted {seqno}"
            )
        self.live_bytes -= n
        self.dead_bytes += n
        self.faultins += 1
        self._maybe_compact()
        return body[_SPILLHDR.size:]

    def discard(self, seqno: int) -> int:
        """Drop a spilled payload that will never be delivered (dead
        targeted rank, killed job); returns the bytes released."""
        entry = self._index.pop(seqno, None)
        if entry is None:
            return 0
        _, n = entry
        self.live_bytes -= n
        self.dead_bytes += n
        self._maybe_compact()
        return n

    # -- space reclamation ---------------------------------------------------

    def _maybe_compact(self) -> None:
        if (self.dead_bytes >= COMPACT_MIN_DEAD
                and self.dead_bytes > 2 * max(self.live_bytes, 1)):
            self.compact()

    def compact(self) -> None:
        """Rewrite live records into a fresh file (atomic swap)."""
        newpath = self.path + ".new"
        new_index: dict[int, tuple[int, int]] = {}
        with open(newpath, "w+b") as nf:
            for seqno, (off, n) in self._index.items():
                self._f.seek(off)
                rec = self._f.read(_REC.size + _SPILLHDR.size + n)
                new_index[seqno] = (nf.tell(), n)
                nf.write(rec)
        os.replace(newpath, self.path)
        self._f.close()
        self._f = open(self.path, "r+b")
        self._index = new_index
        self.dead_bytes = 0
        self.compactions += 1

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
