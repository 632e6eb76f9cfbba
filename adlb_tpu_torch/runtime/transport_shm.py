"""Shared-memory ring fabric: the third transport, for co-located ranks.

The TCP fabric pays the loopback stack (syscalls, softirq, per-frame
wakeups) even when both ranks sit on one host — bench r05/r06 put the
intra-host per-op floor at ~0.66-0.9 ms p50, transport-bound (ROADMAP
item 4).  This module moves the same-host data plane into user space:

* one **SPSC byte ring** per direction per connected pair, living in a
  named shared-memory segment (a ``/dev/shm``-backed ``mmap`` — see
  :class:`ShmRing` for why not ``multiprocessing.shared_memory``); the
  sender creates the ring it writes, the receiver attaches on
  announcement and unlinks at close (the world sweep catches strays);
* **seqlock-style head/tail**: two monotone u64 cursors, each written
  by exactly one side.  A stale cursor read is always *conservative*
  (the reader sees less available, the writer sees less space), so the
  discipline needs no locks — only that the data copy lands before the
  cursor bump, which x86-64's total store order gives the interpreter's
  separate stores;
* a **named-FIFO doorbell** per rank for blocking recv: senders write
  one byte after ring writes, the receiver ``select``\\ s on its FIFO —
  the portable stand-in for a futex/eventfd wakeup that still works
  across ``exec``\\ ed processes (launch.py worlds), where an inherited
  eventfd cannot reach;
* frames bigger than the ring **stream through it**: the writer copies
  what fits, rings the bell, and continues as the reader frees space —
  a >1 MiB payload needs no oversized ring, just one extra wakeup per
  ring-full of bytes.

The fabric is a *wrapper* over :class:`TcpEndpoint`, not a replacement:
the first send toward each peer probes for the peer's doorbell FIFO
(same host + fabric enabled ⇒ it exists), upgrades the pair to a ring
and announces it with one ``SHM_HELLO`` frame over TCP — cross-host
peers, native daemons, and plain-TCP peers silently stay on TCP.  The
HELLO's connection doubles as the pair's **death sentinel**: a
SIGKILLed shm peer EOFs it, the TCP reader synthesizes ``PEER_EOF``,
and every failure-policy ladder (reclaim, failover, lease fencing)
works over the ring fabric unchanged.  ``FaultyEndpoint`` stacks on
top exactly as it does over TCP.

Bodies use the same first-byte discrimination as the TCP plane: frames
whose fields all have TLV ids are written as scatter-gather TLV
segments (``codec.encode_binary_iov`` — header + fields + payload
views straight into the ring, no body-concat copy); everything else is
a restricted-unpickle pickle body.
"""

from __future__ import annotations

import glob
import mmap
import os
import pickle
import queue
import select
import struct
import threading
import time
import uuid
from typing import Optional

from adlb_tpu_torch.runtime.codec import (
    decode_binary,
    encode_binary_iov,
    loads_restricted,
    wire_native_ok,
)
from adlb_tpu_torch.runtime.messages import Msg, Tag, msg

_LEN = struct.Struct("<I")   # per-frame body length prefix inside the ring
_CUR = struct.Struct("<Q")   # head/tail cursors

_TAIL_OFF = 0    # producer cursor: total bytes ever written
_HEAD_OFF = 64   # consumer cursor: total bytes ever read (own cache line)
_DATA_OFF = 128

DEFAULT_RING_BYTES = 1 << 20
# backpressure wait while a ring is full: exponential from 20 us so a
# streaming >ring-size frame resumes almost immediately after the
# reader frees space, capped well under a scheduler timeslice
_FULL_SLEEP_MIN = 20e-6
_FULL_SLEEP_MAX = 1e-3

# a writer stuck on a full ring this long gives up with OSError — the
# reader is dead or wedged, and OSError is the transport-failure signal
# every role already handles (TCP's analogue is a refused reconnect)
FULL_RING_TIMEOUT = 20.0

# receiver insurance: with rings attached, a blocking recv re-scans
# them at least this often even without a bell. Bounds the theoretical
# lost-wakeup window of the sender-side doorbell coalescing (a stale
# head read can make a sender skip a bell the receiver needed; on
# x86-TSO the store->load reorder that requires has never been
# observed at Python's instruction granularity, but 4 spurious
# wakeups/s is cheap certainty)
_INSURANCE_S = 0.25

SHM_DIR = "/dev/shm"


class ShmRing:
    """One direction's SPSC byte ring in a named shared-memory segment.

    The segment is a plain file on the shared-memory filesystem,
    ``mmap``\\ ed by both sides — the same object
    ``multiprocessing.shared_memory`` wraps, taken directly because (a)
    py3.10's resource tracker mis-books attach/unlink (KeyError spam in
    the tracker process, and at-exit unlinks racing ours for segments
    of SIGKILLed chaos ranks), and (b) a raw file needs no tracker:
    lifetime is owned explicitly (owner unlink + world sweep).

    Layout: u64 tail @0, u64 head @64 (separate cache lines), data
    @128.  Cursors are monotone byte counts; ``pos = cursor % cap``.
    Each cursor has exactly one writer, and an 8-byte aligned store is
    a single machine store on the platforms this targets — stale reads
    by the other side only ever under-estimate, never corrupt.
    """

    def __init__(self, name: str, nbytes: int = 0,
                 create: bool = False) -> None:
        self.name = name
        self.path = os.path.join(SHM_DIR, name)
        self.owner = create
        if create:
            # a leftover file under this name is a previous incarnation's
            # (deterministic launch.py keys + a SIGKILLed launcher that
            # never swept): we own the writer side of this name, so
            # replace it rather than erroring every first send
            try:
                os.unlink(self.path)
            except OSError:
                pass
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR,
                         0o600)
            try:
                os.ftruncate(fd, _DATA_OFF + nbytes)
                self._mm = mmap.mmap(fd, _DATA_OFF + nbytes)
            finally:
                os.close(fd)
        else:
            fd = os.open(self.path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        self._buf = memoryview(self._mm)
        self.cap = len(self._buf) - _DATA_OFF

    def _tail(self) -> int:
        return _CUR.unpack_from(self._buf, _TAIL_OFF)[0]

    def _head(self) -> int:
        return _CUR.unpack_from(self._buf, _HEAD_OFF)[0]

    def avail(self) -> int:
        return self._tail() - self._head()

    @property
    def occupancy(self) -> float:
        return self.avail() / self.cap if self.cap else 0.0

    def write_some(self, mv) -> int:
        """Copy as much of ``mv`` as fits; returns bytes written (0 =
        ring full).  Producer side only."""
        tail = self._tail()
        n = min(self.cap - (tail - self._head()), len(mv))
        if n <= 0:
            return 0
        pos = tail % self.cap
        first = min(n, self.cap - pos)
        buf = self._buf
        buf[_DATA_OFF + pos:_DATA_OFF + pos + first] = mv[:first]
        if n > first:
            buf[_DATA_OFF:_DATA_OFF + n - first] = mv[first:n]
        _CUR.pack_into(buf, _TAIL_OFF, tail + n)  # publish AFTER the copy
        return n

    def read_some(self) -> bytes:
        """Consume everything currently available (b"" when empty).
        Consumer side only."""
        head = self._head()
        n = self._tail() - head
        if n <= 0:
            return b""
        pos = head % self.cap
        first = min(n, self.cap - pos)
        buf = self._buf
        out = bytes(buf[_DATA_OFF + pos:_DATA_OFF + pos + first])
        if n > first:
            out += bytes(buf[_DATA_OFF:_DATA_OFF + n - first])
        _CUR.pack_into(buf, _HEAD_OFF, head + n)  # free AFTER the copy
        return out

    def read_into(self, out: bytearray) -> int:
        """Consume everything currently available straight into ``out``
        (one copy, shared memory -> accumulator); returns bytes read.
        Consumer side only."""
        head = self._head()
        n = self._tail() - head
        if n <= 0:
            return 0
        pos = head % self.cap
        first = min(n, self.cap - pos)
        buf = self._buf
        out += buf[_DATA_OFF + pos:_DATA_OFF + pos + first]
        if n > first:
            out += buf[_DATA_OFF:_DATA_OFF + n - first]
        _CUR.pack_into(buf, _HEAD_OFF, head + n)  # free AFTER the copy
        return n

    def close(self, unlink: Optional[bool] = None) -> None:
        unlink = self.owner if unlink is None else unlink
        try:
            self._buf.release()
            self._mm.close()
        except (OSError, BufferError):
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class Doorbell:
    """Named-FIFO wakeup channel.  The owner (receiver) creates the
    FIFO and holds a non-blocking read end; every producer — ring
    writers in other processes, and the owner's own TCP reader threads
    via the ``notify`` hook — writes one byte after delivering.  Bytes
    accumulate until drained, so a bell rung between the receiver's
    empty-check and its ``select`` is never lost."""

    def __init__(self, path: str, create: bool) -> None:
        self.path = path
        self.owner = create
        self._rfd = -1
        self._wfd = -1
        if create:
            try:
                os.mkfifo(path)
            except FileExistsError:
                pass
            self._rfd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)

    def open_write(self) -> None:
        """Open the write end (raises ENOENT when the peer has no
        fabric, ENXIO when its read end is not up yet)."""
        self._wfd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)

    def ring(self) -> None:
        if self._wfd < 0:
            return
        try:
            os.write(self._wfd, b"\x01")
        except BlockingIOError:
            pass  # 64 KiB of undrained bells: wakeup already guaranteed
        except OSError:
            pass  # reader gone: death is signalled via the TCP sentinel

    def probe(self) -> None:
        """Liveness probe: a FIFO whose only reader (the owner) has died
        or closed raises BrokenPipeError on write — the ring fabric's
        fast equivalent of a TCP RST. A SIGSTOPped (gray-failed) owner
        keeps its fds open, so this correctly stays silent for stalls."""
        if self._wfd < 0:
            return
        try:
            os.write(self._wfd, b"\x01")
        except BlockingIOError:
            pass
        except OSError as e:
            raise OSError(
                f"shm doorbell {self.path}: reader gone ({e!r})"
            ) from e

    def drain(self) -> None:
        try:
            while os.read(self._rfd, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def wait(self, timeout: Optional[float]) -> bool:
        try:
            r, _, _ = select.select([self._rfd], [], [], timeout)
            return bool(r)
        except (OSError, ValueError):
            # closed mid-wait: don't busy-spin the caller's retry loop
            time.sleep(min(timeout or 0.05, 0.05))
            return False

    def close(self) -> None:
        for fd in (self._rfd, self._wfd):
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._rfd = self._wfd = -1
        if self.owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass


# the TLV-vs-pickle body decision is shared with the multiplexed TCP
# channel plane and lives in the codec module (codec.wire_native_ok)


class _BellBatch(threading.local):
    """Per-thread submit-batch state for the ring fabric: destinations
    whose bells are owed, rung once at flush."""

    depth = 0
    pending: "Optional[dict]" = None


class _RxState:
    """One inbound ring + its partial-frame reassembly buffer."""

    __slots__ = ("ring", "buf")

    def __init__(self, ring: ShmRing) -> None:
        self.ring = ring
        self.buf = bytearray()


class ShmEndpoint:
    """The ring fabric stacked over a :class:`TcpEndpoint`.

    Send path: first send toward a peer probes its doorbell FIFO —
    present means same host + fabric enabled, so a ring is created,
    announced over TCP (``SHM_HELLO``), and all subsequent frames to
    that peer stream through it; absent (cross-host, native daemon,
    plain-TCP peer) means the pair stays on TCP forever, so ordering
    within the pair is preserved (frames never alternate transports).
    Recv path: drain+parse every attached inbound ring into the shared
    inbox, then block on the doorbell — TCP deliveries ring the same
    bell via the endpoint's ``notify`` hook.
    """

    def __init__(self, tcp_ep, key: str,
                 ring_bytes: int = DEFAULT_RING_BYTES) -> None:
        self._tcp = tcp_ep
        self.rank = tcp_ep.rank
        self.key = key
        self.ring_bytes = max(int(ring_bytes), 4096)
        self._tx: dict[int, tuple[ShmRing, Doorbell]] = {}
        self._no_shm: set[int] = set()
        self._dead: set[int] = set()
        self._eof_flushed: set[int] = set()
        self._rx: dict[int, _RxState] = {}
        self._rx_lock = threading.Lock()
        self._attach_lock = threading.Lock()
        self._send_locks: dict[int, threading.Lock] = {}
        self._recv_lock = threading.Lock()
        self._closed = False
        self._tx_stats: dict = {}
        self._rx_stats: dict = {}
        self._g_occ = None
        self._g_wake = None
        self._g_sup = None
        self._h_send = None  # send_s / recv_wait_s histograms — same
        self._h_recv = None  # exposition contract as the TCP endpoint
        self.doorbell_wakeups = 0
        # doorbell coalescing: per-dest ring tail at the last bell we
        # rang (guarded by that dest's send lock). A peer that has not
        # consumed up to that point either still has our byte in its
        # FIFO or is awake mid-drain — both end in a ring scan that
        # sees any newer frame, so the bell write is skipped.
        self._rung: dict[int, int] = {}
        self.doorbell_suppressed = 0
        self.shm_frames_tx = 0
        self.shm_frames_rx = 0
        # submit batching: per-thread deferred doorbells — a reactor
        # tick's burst of N ring writes rings each destination's bell
        # ONCE at submit_flush instead of per frame (composes with the
        # _rung suppression below)
        self._submit = _BellBatch()
        self._bell = Doorbell(self._bell_path(self.rank), create=True)
        self._bell.open_write()  # self-notify end for the TCP hooks
        tcp_ep.notify = self._bell.ring
        tcp_ep.shm_ctl = self._on_hello

    # -- naming --------------------------------------------------------------

    def _ring_name(self, src: int, dst: int) -> str:
        return f"{self.key}.{src}to{dst}"

    def _bell_path(self, rank: int) -> str:
        return os.path.join(SHM_DIR, f"{self.key}.bell.{rank}")

    # -- attribute passthrough (roles and harnesses see one endpoint) --------

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_tcp"), name)

    @property
    def metrics(self):
        return self._tcp.metrics

    @metrics.setter
    def metrics(self, reg) -> None:
        self._tcp.metrics = reg

    # -- pair upgrade --------------------------------------------------------

    def _on_hello(self, m: Msg) -> None:
        """SHM_HELLO from ``m.src`` (TCP reader thread): attach the ring
        that peer just created toward us and start scanning it."""
        src = m.src
        with self._rx_lock:
            if src in self._rx or self._closed:
                return
            try:
                ring = ShmRing(self._ring_name(src, self.rank))
            except (OSError, FileNotFoundError):
                return  # announced then died before we looked: EOF follows
            self._rx[src] = _RxState(ring)
        self._bell.ring()

    def _attach(self, dest: int, connect_grace: float):
        """Try to upgrade the (self, dest) pair to a ring; returns the
        (ring, bell) pair or None (TCP fallback, recorded so the probe
        runs once per peer). Serialized PER DESTINATION: the probe can
        wait up to ~2 s and the HELLO up to the TCP connect grace, and a
        dead peer must not stall other threads' first sends to healthy
        peers (the same isolation the TCP plane's per-dest send locks
        provide)."""
        with self._attach_lock:  # guards the lock map only
            dlock = self._send_locks.setdefault(dest, threading.Lock())
        with dlock:
            tx = self._tx.get(dest)
            if tx is not None:
                return tx
            if dest in self._no_shm:
                return None
            # different advertised host, or a native daemon (binary
            # peer): no fabric there, don't burn the probe grace
            amap = self._tcp.addr_map
            my_host = amap.get(self.rank, ("",))[0]
            if (amap.get(dest, (None,))[0] != my_host
                    or dest in self._tcp.binary_peers
                    or dest == self.rank):
                self._no_shm.add(dest)
                return None
            bell = Doorbell(self._bell_path(dest), create=False)
            # short probe: a peer we can address has already constructed
            # its endpoint (ports publish after bind), so its FIFO exists
            # if it ever will — the grace only covers same-process races,
            # not a peer that simply runs plain TCP
            deadline = time.monotonic() + max(min(connect_grace, 2.0), 0.25)
            while True:
                try:
                    bell.open_write()
                    break
                except OSError:
                    # ENOENT: same host but the peer runs plain TCP (or
                    # is still starting); ENXIO: FIFO exists, reader not
                    # up yet.  Retry within the grace, then TCP forever.
                    if time.monotonic() >= deadline:
                        self._no_shm.add(dest)
                        return None
                    time.sleep(0.02)
            ring = ShmRing(self._ring_name(self.rank, dest),
                           self.ring_bytes, create=True)
            try:
                # announce over TCP: the receiver attaches on this frame,
                # and the connection it rides is the pair's death sentinel
                self._tcp.send(dest, msg(Tag.SHM_HELLO, self.rank),
                               connect_grace)
            except OSError:
                ring.close(unlink=True)
                bell.close()
                raise
            tx = (ring, bell)
            self._tx[dest] = tx
            return tx

    # -- send ----------------------------------------------------------------

    def send(self, dest: int, m: Msg, connect_grace: float = 15.0) -> None:
        if dest in self._dead:
            raise OSError(f"shm fabric: rank {dest} is dead (PEER_EOF seen)")
        tx = self._tx.get(dest)
        if tx is None:
            tx = self._attach(dest, connect_grace)
            if tx is None:
                self._tcp.send(dest, m, connect_grace)
                return
        ring, bell = tx
        # scatter-gather TLV when every field has a wire id (the whole
        # put/fetch hot path), restricted pickle otherwise; the reader
        # discriminates on the first body byte exactly like the TCP plane
        if wire_native_ok(m):
            parts = encode_binary_iov(m)
        else:
            parts = [pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)]
        nbody = sum(len(p) for p in parts)
        reg = self._tcp.metrics
        t0 = time.monotonic() if reg is not None else 0.0
        with self._send_locks[dest]:
            self._write_frame(ring, bell, dest, nbody, parts)
        self.shm_frames_tx += 1
        if reg is not None:
            st = self._tx_stats.get(m.tag)
            if st is None:
                st = self._tx_stats[m.tag] = (
                    reg.counter("tx_msgs", tag=m.tag.name),
                    reg.counter("tx_bytes", tag=m.tag.name),
                )
            st[0].inc()
            st[1].inc(_LEN.size + nbody)
            # whole-path send latency (ring admission incl. full-ring
            # waits) — the TCP endpoint's send_s, same exposition
            if self._h_send is None:
                self._h_send = reg.histogram("send_s")
            self._h_send.observe(time.monotonic() - t0)
            # suppression is SENDER-side state: export it here, not
            # only from the rx drain (a mostly-sending rank would
            # otherwise scrape a stale 0 forever)
            if self._g_sup is None:
                self._g_sup = reg.gauge("shm_doorbell_suppressed")
            self._g_sup.set(self.doorbell_suppressed)

    def _write_frame(self, ring: ShmRing, bell: Doorbell, dest: int,
                     nbody: int, parts: list) -> None:
        """Stream one length-prefixed frame into the ring, waiting for
        the reader when full (frames larger than the ring flow through
        it in ring-sized installments).

        ONE wakeup per frame, coalesced: the bell rings after the whole
        frame lands (not per segment — a TLV frame used to ring once
        per header/field/payload part), and even that ring is skipped
        when the peer is known-awake: our previous bell's byte is
        unconsumed (head behind the tail it advertised), so the drain
        it triggers will pick this frame up too. The full-ring wait
        needs no extra bell — ``probe()`` writes a byte each lap, which
        doubles as the wakeup for the bytes already streamed. A stale
        head read can only over-skip, never over-ring; recv()'s
        insurance re-scan bounds the (never-observed, theoretical
        store-order) lost-wakeup window."""
        deadline = None
        sleep_s = _FULL_SLEEP_MIN
        for seg in (_LEN.pack(nbody), *parts):
            mv = memoryview(seg)
            while mv.nbytes:
                n = self._closed_as_oserror(ring.write_some, mv)
                if n:
                    mv = mv[n:]
                    deadline = None
                    sleep_s = _FULL_SLEEP_MIN
                    continue
                if dest in self._dead or self._closed:
                    raise OSError(
                        f"shm fabric: ring to rank {dest} abandoned "
                        f"(peer dead or endpoint closed)"
                    )
                # fast death detection while blocked on a full ring: a
                # dead peer's doorbell has no reader and the probe
                # raises (TCP's RST analogue) — without this, a sender
                # whose peer was SIGKILLed waits out the full-ring
                # backstop on EVERY retry (observed: an abort-policy
                # worker kill taking 4 x 20 s to classify)
                bell.probe()
                now = time.monotonic()
                if deadline is None:
                    deadline = now + FULL_RING_TIMEOUT
                elif now >= deadline:
                    raise OSError(
                        f"shm fabric: ring to rank {dest} full for "
                        f"{FULL_RING_TIMEOUT}s (reader wedged or dead)"
                    )
                time.sleep(sleep_s)
                sleep_s = min(sleep_s * 2, _FULL_SLEEP_MAX)
        st = self._submit
        if st.depth > 0 and st.pending is not None:
            # submit batch: the bell is owed, not rung — submit_flush
            # rings each pending destination once (the frame is already
            # IN the ring, so the deferral moves only the wakeup)
            st.pending[dest] = (ring, bell)
            return
        self._ring_bell(dest, ring, bell)

    def _closed_as_oserror(self, op, *args):
        """``op(*args)`` on a ring. Once this endpoint is closed its rings
        are released, and a thread still sending (the frame that enacted
        an injected disconnect, or one racing a close) gets the OSError a
        closed socket gives, which failover absorbs as lost connectivity,
        and not the released memoryview's ValueError."""
        try:
            return op(*args)
        except ValueError:
            if self._closed:
                raise OSError("shm fabric: endpoint closed") from None
            raise

    def _ring_bell(self, dest: int, ring: ShmRing, bell: Doorbell) -> None:
        if self._closed:
            return  # a closed endpoint's frames are never read
        try:
            tail = ring._tail()
        except ValueError:
            if self._closed:
                return
            raise
        last = self._rung.get(dest, -1)
        if last >= 0 and ring._head() < last:
            self.doorbell_suppressed += 1
        else:
            bell.ring()
            self._rung[dest] = tail

    # -- submit batching ------------------------------------------------------

    def submit_begin(self) -> None:
        st = self._submit
        st.depth += 1
        if st.pending is None:
            st.pending = {}
        self._tcp.submit_begin()

    def submit_flush(self) -> None:
        st = self._submit
        if st.depth > 0:
            st.depth -= 1
        if st.depth == 0 and st.pending:
            pending, st.pending = st.pending, {}
            for dest, (ring, bell) in pending.items():
                self._ring_bell(dest, ring, bell)
        self._tcp.submit_flush()

    # -- recv ----------------------------------------------------------------

    def _decode(self, src: int, body: bytes) -> Optional[Msg]:
        try:
            if body[:1] == b"\x01":
                return decode_binary(body)
            m = loads_restricted(body)
            if not isinstance(m, Msg):
                raise pickle.UnpicklingError(
                    f"frame unpickled to {type(m).__name__}, not Msg"
                )
            return m
        except Exception as e:  # noqa: BLE001 — a bad frame must be
            import sys  # diagnosable, not a silent reader death

            print(
                f"[adlb shm rank {self.rank}] dropping undecodable ring "
                f"frame from {src} ({len(body)}B): {e!r}",
                file=sys.stderr,
            )
            return None

    def _parse(self, src: int, st: _RxState) -> int:
        buf = st.buf
        off = 0
        delivered = 0
        reg = self._tcp.metrics
        while True:
            if len(buf) - off < _LEN.size:
                break
            (ln,) = _LEN.unpack_from(buf, off)
            if len(buf) - off - _LEN.size < ln:
                break  # frame still streaming in
            body = bytes(buf[off + _LEN.size:off + _LEN.size + ln])
            off += _LEN.size + ln
            m = self._decode(src, body)
            if m is None:
                continue
            if reg is not None:
                rst = self._rx_stats.get(m.tag)
                if rst is None:
                    rst = self._rx_stats[m.tag] = (
                        reg.counter("rx_msgs", tag=m.tag.name),
                        reg.counter("rx_bytes", tag=m.tag.name),
                    )
                rst[0].inc()
                rst[1].inc(_LEN.size + len(body))
            self._tcp.inbox.put(m)
            delivered += 1
        if off:
            del buf[:off]
        return delivered

    def _drain_rings(self) -> int:
        with self._recv_lock:
            with self._rx_lock:
                items = list(self._rx.items())
            got = 0
            occ = 0.0
            for src, st in items:
                try:
                    occ = max(occ, st.ring.occupancy)
                    n = st.ring.read_into(st.buf)
                except ValueError:
                    if self._closed:
                        return got  # closed under this drain: rings gone
                    raise
                if n:
                    got += self._parse(src, st)
            reg = self._tcp.metrics
            if reg is not None and items:
                if self._g_occ is None:
                    self._g_occ = reg.gauge("shm_ring_occupancy")
                    self._g_wake = reg.gauge("shm_doorbell_wakeups")
                    self._g_sup = reg.gauge("shm_doorbell_suppressed")
                self._g_occ.set(occ)
                self._g_wake.set(self.doorbell_wakeups)
                self._g_sup.set(self.doorbell_suppressed)
            self.shm_frames_rx += got
            if got > 1:
                # a second consumer thread may be parked in select while
                # we return only one of these frames; one insurance bell
                # keeps the inbox drain prompt without a busy loop
                self._bell.ring()
            return got

    # brief ring-poll spin before parking in select: on multi-core
    # hosts the peer's next frame typically lands within microseconds,
    # and the spin saves the full futex wakeup; on a single-core host
    # spinning only steals the sender's timeslice, so it is disabled
    _SPIN_S = 50e-6 if (os.cpu_count() or 1) > 1 else 0.0

    def recv(self, timeout: Optional[float] = None) -> Optional[Msg]:
        deadline = None if timeout is None else time.monotonic() + timeout
        inbox = self._tcp.inbox
        reg = self._tcp.metrics
        t0 = time.monotonic() if reg is not None else 0.0
        spun = False
        while True:
            # inbox first: under bursts the previous drain already
            # parsed a batch, and re-scanning every ring per message is
            # the dominant per-op cost of the recv path (the PEER_EOF
            # branch below still forces its own drain, so the ordering
            # fix is unaffected)
            try:
                m = inbox.get_nowait()
            except queue.Empty:
                self._drain_rings()
                try:
                    m = inbox.get_nowait()
                except queue.Empty:
                    m = None
            if m is not None:
                if m.tag is Tag.PEER_EOF:
                    # sends to a dead shm peer must fail like TCP's
                    # refused reconnect, not fill a ring nobody reads
                    self._dead.add(m.src)
                    if m.src not in self._eof_flushed:
                        # CROSS-CHANNEL ORDERING: the peer's last ring
                        # frames (e.g. FA_LOCAL_APP_DONE) were written
                        # before the close that raised this EOF, but the
                        # EOF rides the TCP reader thread and can enter
                        # the inbox first — delivering it now would read
                        # as "died before finalize" and abort the world.
                        # Drain the rings once more (everything written
                        # happens-before the close, so it is visible
                        # now; a torn mid-write tail cannot parse and is
                        # rightly ignored) and requeue the EOF BEHIND
                        # those frames.
                        self._eof_flushed.add(m.src)
                        self._drain_rings()
                        inbox.put(m)
                        continue
                if reg is not None:
                    # wait-for-message latency (observed only when a
                    # message arrived) — the TCP endpoint's recv_wait_s
                    if self._h_recv is None:
                        self._h_recv = reg.histogram("recv_wait_s")
                    self._h_recv.observe(time.monotonic() - t0)
                return m
            if self._closed:
                return None
            if self._SPIN_S and not spun and self._rx:
                spun = True
                with self._rx_lock:
                    rings = [st.ring for st in self._rx.values()]
                end = time.monotonic() + self._SPIN_S
                try:
                    while time.monotonic() < end:
                        if any(r.avail() for r in rings):
                            break
                except ValueError:
                    if not self._closed:
                        raise
                continue
            if deadline is None:
                remaining = None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
            if self._rx and (remaining is None or remaining > _INSURANCE_S):
                remaining = _INSURANCE_S  # bounded re-scan (see above)
            if self._bell.wait(remaining):
                self.doorbell_wakeups += 1
                self._bell.drain()

    def backlog(self) -> int:
        b = self._tcp.backlog()
        with self._rx_lock:
            for st in self._rx.values():
                if st.buf or st.ring.avail():
                    b += 1
        return b

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        self._bell.ring()  # wake any recv blocked in select
        try:
            self._tcp.close()
        finally:
            with self._attach_lock:
                for ring, bell in self._tx.values():
                    # no unlink here even though we created it: the
                    # receiver may not have processed our SHM_HELLO yet,
                    # and unlinking would strand the final frames it
                    # still has to attach-and-drain (the finalize race).
                    # The receiver unlinks on ITS close; the world sweep
                    # (cleanup_world) catches receivers that died first.
                    ring.close(unlink=False)
                    bell.close()
                self._tx.clear()
            with self._rx_lock:
                for st in self._rx.values():
                    st.ring.close(unlink=True)
                self._rx.clear()
            self._bell.close()


# ----------------------------------------------------------- world plumbing


def new_world_key() -> str:
    """A fresh namespace for one world's segments/FIFOs (spawn_world)."""
    return f"adlb{uuid.uuid4().hex[:12]}"


def key_for_rendezvous(path: str) -> str:
    """Deterministic key shared by every launcher (and joined client) of
    a rendezvous-directory world."""
    import hashlib

    h = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:12]
    return f"adlb{h}"


def cleanup_world(key: str) -> None:
    """Best-effort sweep of a world's leftover segments and FIFOs —
    SIGKILLed ranks (chaos legs) never unlink what they own."""
    if not key:
        return
    for path in glob.glob(os.path.join(SHM_DIR, f"{key}.*")):
        try:
            os.unlink(path)
        except OSError:
            pass


def shm_headroom() -> int:
    """Free bytes on the shared-memory filesystem (0 when absent)."""
    try:
        st = os.statvfs(SHM_DIR)
        return st.f_bavail * st.f_frsize
    except OSError:
        return 0


def shm_available(min_headroom: int = 64 << 20) -> bool:
    """Can this host run the ring fabric? (segment + FIFO probe, plus a
    headroom floor so a nearly-full /dev/shm degrades to TCP instead of
    failing worlds mid-run). Restricted to total-store-order ISAs: the
    ring's publish discipline (data copy, then cursor store, no explicit
    barrier) is only sound under TSO — on weaker memory models (aarch64
    etc.) ``fabric="auto"`` stays on TCP rather than risking silently
    reordered payload bytes."""
    import platform

    if platform.machine().lower() not in ("x86_64", "amd64", "i686",
                                          "i386"):
        return False
    if shm_headroom() < min_headroom:
        return False
    name = f"adlbprobe{os.getpid():x}{uuid.uuid4().hex[:6]}"
    try:
        seg = ShmRing(name, 4096, create=True)
        seg.close()  # owner: unlinks
        fifo = os.path.join(SHM_DIR, f"{name}.fifo")
        os.mkfifo(fifo)
        os.unlink(fifo)
        return True
    except (OSError, ValueError):
        return False


def resolve_fabric(cfg) -> str:
    """Which process-world fabric to run: an explicit ``Config(fabric)``
    wins; ``"auto"`` honors the ``ADLB_FABRIC`` env override (the CI shm
    leg's hook) and otherwise upgrades to shm whenever the host can."""
    f = getattr(cfg, "fabric", "auto")
    if f != "auto":
        return f
    env = os.environ.get("ADLB_FABRIC", "").strip().lower()
    if env in ("shm", "tcp"):
        return env
    return "shm" if shm_available() else "tcp"


def maybe_shm(ep, cfg, key: Optional[str]):
    """Stack the ring fabric over a TcpEndpoint when the resolved fabric
    is shm (the single hook the world harnesses call)."""
    if not key or resolve_fabric(cfg) != "shm":
        return ep
    return ShmEndpoint(ep, key,
                       ring_bytes=getattr(cfg, "shm_ring_bytes",
                                          DEFAULT_RING_BYTES))
