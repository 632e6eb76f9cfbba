"""Multiplexed cross-host channels: one socket per host-pair, not per
rank-pair.

The per-pair TCP plane (transport_tcp.py) holds one persistent socket
per communicating rank pair — O(pairs) kernel state and one syscall per
small frame. At fleet scale (ROADMAP item 5: 1,000 servers) that is the
floor the balancer work cannot touch. This module collapses it:

* every rank on a host attaches to that host's **channel broker** over
  ONE socket and sends ``(src, dst, frame)`` envelopes;
* brokers hold one **bridge** channel per remote host, so the fleet's
  data plane is O(ranks + hosts^2) sockets instead of O(ranks^2);
* per-channel **send queues coalesce**: a writer drains everything
  queued into one ``sendmsg``, so a burst of N small frames costs O(1)
  syscalls (and, with the endpoint's submit batch, O(1) wakeups);
* DATA envelope bodies at least ``Config(compress_min_bytes)`` long are
  **zlib-compressed** end to end (flag bit 0 of the envelope header;
  brokers forward envelopes verbatim and never inflate).

Envelope wire format (after a u32 length prefix covering the rest):

    u8 etype    1 = DATA, 2 = ATTACH, 3 = DETACH, 4 = BRIDGE
    DATA:   u8 flags (bit 0: body zlib-compressed), i32 src, i32 dst,
            then the frame body (the same first-byte-discriminated
            pickle/TLV body the per-pair plane carries)
    ATTACH: i32 rank   (a rank binding this connection)
    DETACH: i32 rank   (rank gone: clean close or death)
    BRIDGE: utf-8 host key (a remote broker binding this connection)

Failure semantics — the per-pair death sentinel, preserved by
construction: a rank's process death EOFs its broker connection; the
broker broadcasts ``DETACH(rank)`` (to local ranks and every bridge,
AFTER the rank's already-read frames — same reader thread, so per-pair
ordering holds), and each endpoint that has seen traffic from that rank
synthesizes the same in-order ``PEER_EOF`` the per-pair reader would
have — every failure-policy ladder (reclaim, failover, lease fencing,
shm-hello sentinels) runs unchanged over the mux. A broker's own death
EOFs every attached rank, which synthesizes ``PEER_EOF`` for every peer
it had heard from — the host-died signal.

Native (C/Fortran) peers never ride channels: they speak raw
length-prefixed TLV on direct per-pair sockets, and the endpoint routes
``binary_peers`` around the mux.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import zlib
from collections import deque
from typing import Optional

E_DATA = 1
E_ATTACH = 2
E_DETACH = 3
E_BRIDGE = 4

_U32 = struct.Struct("<I")
_DATA_HDR = struct.Struct("<IBBii")  # elen, etype, flags, src, dst
_RANK_ENV = struct.Struct("<IBi")    # elen, etype, rank
DATA_OVERHEAD = _DATA_HDR.size - _U32.size  # etype+flags+src+dst

FLAG_COMPRESSED = 0x01

def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """TcpEndpoint._read_exact with OSError folded into the None (EOF)
    outcome — one exact-read implementation, like _send_gather below."""
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    try:
        return TcpEndpoint._read_exact(conn, n)
    except OSError:
        return None


def _send_gather(sock: socket.socket, parts: list) -> None:
    """One frame-burst as gather writes — exactly TcpEndpoint._send_iov
    (IOV_MAX chunking, short-write resume at the unsent offset, EINTR
    resume, no-sendmsg fallback), imported so the wire discipline has
    ONE implementation. transport_tcp imports this module lazily, so the
    top-level import here creates no cycle."""
    from adlb_tpu_torch.runtime.transport_tcp import TcpEndpoint

    TcpEndpoint._send_iov(sock, parts)


def data_envelope(src: int, dst: int, parts: list, nbody: int,
                  compress_min: int = 0) -> tuple[list, int]:
    """Build one DATA envelope as an iovec (header + body parts);
    returns (iovec, bytes_saved_by_compression)."""
    saved = 0
    if compress_min > 0 and nbody >= compress_min:
        z = zlib.compress(b"".join(bytes(p) for p in parts), 1)
        if len(z) < nbody:
            saved = nbody - len(z)
            hdr = _DATA_HDR.pack(DATA_OVERHEAD + len(z), E_DATA,
                                 FLAG_COMPRESSED, src, dst)
            return [hdr, z], saved
    hdr = _DATA_HDR.pack(DATA_OVERHEAD + nbody, E_DATA, 0, src, dst)
    return [hdr, *parts], saved


def rank_envelope(etype: int, rank: int) -> bytes:
    return _RANK_ENV.pack(5, etype, rank)


# ------------------------------------------------------------------ broker


class _BrokerConn:
    """One accepted connection (a local rank or a remote-broker bridge):
    a reader identity plus a coalescing send queue drained by a writer
    thread — a slow or dead peer never head-of-line-blocks the readers
    feeding it."""

    def __init__(self, broker: "ChannelBroker", sock: socket.socket) -> None:
        self.broker = broker
        self.sock = sock
        self.rank: Optional[int] = None        # set by ATTACH
        self.bridge_host: Optional[str] = None  # set by BRIDGE
        self.bridge_seen: set[int] = set()      # srcs seen over a bridge
        self._q: deque = deque()
        self._cv = threading.Condition()
        self.closed = False
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True, name="adlb-chan-writer"
        )
        self._writer.start()

    def enqueue(self, env) -> None:
        """env: bytes, or an iovec list (header + body parts)."""
        with self._cv:
            if self.closed:
                return
            self._q.append(env)
            self._cv.notify()

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self.closed:
                    self._cv.wait()
                if self.closed and not self._q:
                    return
                batch, self._q = list(self._q), deque()
            parts: list = []
            for env in batch:
                if isinstance(env, (bytes, bytearray, memoryview)):
                    parts.append(env)
                else:
                    parts.extend(env)
            if len(batch) > 1:
                self.broker.frames_coalesced += len(batch) - 1
            try:
                _send_gather(self.sock, parts)
            except OSError:
                self.close()
                return

    def close(self) -> None:
        with self._cv:
            if self.closed:
                return
            self.closed = True
            self._cv.notify()
        try:
            self.sock.close()
        except OSError:
            pass


class ChannelBroker:
    """Per-host channel multiplexer. Local ranks attach with one socket
    each; remote brokers bridge with one socket per host-pair; DATA
    envelopes are forwarded verbatim by destination rank."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(256)
        self.addr: tuple[str, int] = self._listener.getsockname()
        self.hostkey = f"{self.addr[0]}:{self.addr[1]}"
        self._lock = threading.Lock()
        self.local: dict[int, _BrokerConn] = {}
        self.bridges: dict[str, _BrokerConn] = {}
        self._conns: list[_BrokerConn] = []
        # rank -> hostkey and hostkey -> broker addr, for multi-host
        # routing (single-host worlds never need them)
        self.rank_host: dict[int, str] = {}
        self.broker_addrs: dict[str, tuple[str, int]] = {}
        # frames for ranks that have not attached yet (the attach race:
        # rendezvous guarantees construction order, not byte order).
        # Bounded per destination: a rank that NEVER attaches (a native
        # peer mistakenly routed here, a misconfigured world) must not
        # grow memory forever — beyond the cap new frames drop like
        # bytes in flight, counted in frames_dropped
        self._pending: dict[int, list] = {}
        self.pending_cap = 4096
        self.frames_dropped = 0
        self._gone: set[int] = set()
        self._closed = False
        # observability (plain attributes: the broker lives in the
        # harness process, outside any rank's registry)
        self.frames_forwarded = 0
        self.frames_coalesced = 0
        self.peak_conns = 0
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="adlb-chan-broker").start()

    @property
    def conns_open(self) -> int:
        with self._lock:
            return sum(1 for c in self._conns if not c.closed)

    def set_routes(self, rank_host: dict[int, str],
                   broker_addrs: dict[str, tuple[str, int]]) -> None:
        """Teach this broker where non-local ranks live (multi-host
        worlds); hostkeys must match the remote brokers' ``hostkey``."""
        with self._lock:
            self.rank_host.update(rank_host)
            self.broker_addrs.update(broker_addrs)

    # -- accept/read ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _BrokerConn(self, sock)
            with self._lock:
                self._conns.append(conn)
                self.peak_conns = max(
                    self.peak_conns,
                    sum(1 for c in self._conns if not c.closed),
                )
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True, name="adlb-chan-reader").start()

    def _read_loop(self, conn: _BrokerConn) -> None:
        try:
            while True:
                hdr = _read_exact(conn.sock, 4)
                if hdr is None:
                    return
                (elen,) = _U32.unpack(hdr)
                payload = _read_exact(conn.sock, elen)
                if payload is None:
                    return
                et = payload[0]
                if et == E_DATA:
                    (dst,) = struct.unpack_from("<i", payload, 6)
                    if conn.bridge_host is not None:
                        (src,) = struct.unpack_from("<i", payload, 2)
                        conn.bridge_seen.add(src)
                    self._route(dst, hdr + payload)
                elif et == E_ATTACH:
                    (rank,) = struct.unpack_from("<i", payload, 1)
                    self._on_attach(conn, rank)
                elif et == E_DETACH:
                    (rank,) = struct.unpack_from("<i", payload, 1)
                    # forward a remote death to local ranks only (each
                    # broker fans out its own ranks' deaths — no loops)
                    self._broadcast_detach(rank, local_only=True)
                elif et == E_BRIDGE:
                    host = payload[1:].decode("utf-8", "replace")
                    conn.bridge_host = host
                    with self._lock:
                        self.bridges.setdefault(host, conn)
                # unknown envelope types are skipped, not fatal: the
                # protocol can grow (native daemons never attach here)
        finally:
            self._on_conn_eof(conn)

    # -- routing -------------------------------------------------------------

    def _route(self, dst: int, env) -> None:
        self.frames_forwarded += 1
        with self._lock:
            c = self.local.get(dst)
            if c is None:
                if dst in self._gone or self._closed:
                    return  # rank detached: drop, like bytes-in-flight
                host = self.rank_host.get(dst)
                if host is not None and host != self.hostkey:
                    bridge = self._bridge_locked(host)
                    if bridge is not None:
                        c = bridge
                if c is None:
                    backlog = self._pending.setdefault(dst, [])
                    if len(backlog) >= self.pending_cap:
                        self.frames_dropped += 1
                    else:
                        backlog.append(env)
                    return
        c.enqueue(env)

    def _bridge_locked(self, host: str) -> Optional[_BrokerConn]:
        """One outbound channel per remote host (caller holds _lock).

        The dial is synchronous under the broker lock: acceptable while
        bridges are harness-configured peers that are already listening
        (single-host worlds never dial at all); the multi-host launcher
        integration should move to an async dial + pending queue so a
        slow remote broker cannot stall local routing."""
        b = self.bridges.get(host)
        if b is not None and not b.closed:
            return b
        addr = self.broker_addrs.get(host)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(addr, timeout=30)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            return None
        conn = _BrokerConn(self, sock)
        conn.bridge_host = host
        conn.enqueue(
            _U32.pack(1 + len(self.hostkey.encode()))
            + bytes([E_BRIDGE]) + self.hostkey.encode()
        )
        self.bridges[host] = conn
        self._conns.append(conn)
        self.peak_conns = max(
            self.peak_conns, sum(1 for c in self._conns if not c.closed)
        )
        threading.Thread(target=self._read_loop, args=(conn,),
                         daemon=True, name="adlb-chan-reader").start()
        return conn

    def _on_attach(self, conn: _BrokerConn, rank: int) -> None:
        # backlog flush and table publish are ONE atomic step under the
        # broker lock: a concurrently routed frame must either land in
        # the pending list (and flush here, in arrival order) or see the
        # published conn — never jump ahead of the backlog, or per-pair
        # ordering breaks for the attach window. conn.enqueue only takes
        # the conn's own cv, so no lock-order cycle.
        with self._lock:
            conn.rank = rank
            self._gone.discard(rank)
            for env in self._pending.pop(rank, []):
                conn.enqueue(env)
            self.local[rank] = conn

    def _broadcast_detach(self, rank: int, local_only: bool = False) -> None:
        env = rank_envelope(E_DETACH, rank)
        with self._lock:
            targets = [c for c in self._conns if not c.closed
                       and c.rank != rank
                       and (not local_only or c.bridge_host is None)]
        for c in targets:
            c.enqueue(env)

    def _on_conn_eof(self, conn: _BrokerConn) -> None:
        rank = conn.rank
        host = conn.bridge_host
        with self._lock:
            if rank is not None and self.local.get(rank) is conn:
                del self.local[rank]
                self._gone.add(rank)
            if host is not None and self.bridges.get(host) is conn:
                del self.bridges[host]
        conn.close()
        if self._closed:
            return
        if rank is not None:
            # the death sentinel: every channel learns this rank is gone
            self._broadcast_detach(rank)
        elif host is not None:
            # a whole remote host vanished: per-rank EOFs for every rank
            # whose traffic crossed this bridge
            for src in sorted(conn.bridge_seen):
                self._broadcast_detach(src, local_only=True)

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()


# ------------------------------------------------------------ rank client


class ChannelClient:
    """A rank's end of the channel plane: one socket to the local
    broker, envelopes out, frames + detach events in. Owned by (and
    plumbed into) a :class:`~adlb_tpu_torch.runtime.transport_tcp.TcpEndpoint`
    — the endpoint keeps its listener for native per-pair peers and
    routes everything else here."""

    def __init__(self, ep, addr: tuple[str, int],
                 compress_min: int = 0) -> None:
        self._ep = ep
        self.compress_min = int(compress_min)
        self._sock = socket.create_connection(addr, timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self.seen: set[int] = set()
        self.dead: set[int] = set()
        self.frames_coalesced = 0
        self._closed = False
        with self._wlock:
            self._sock.sendall(rank_envelope(E_ATTACH, ep.rank))
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"adlb-chan-client-{ep.rank}",
        )
        self._reader.start()

    # -- tx ------------------------------------------------------------------

    def send_batch(self, envs: list[list]) -> None:
        """One gather for a submit batch of prebuilt envelopes — the
        O(1)-syscalls burst path (see TcpEndpoint.submit_flush)."""
        if not envs:
            return
        if len(envs) > 1:
            self.frames_coalesced += len(envs) - 1
        parts: list = []
        for env in envs:
            parts.extend(env)
        with self._wlock:
            _send_gather(self._sock, parts)

    # -- rx ------------------------------------------------------------------

    def _read_loop(self) -> None:
        ep = self._ep
        try:
            while True:
                hdr = _read_exact(self._sock, 4)
                if hdr is None:
                    break
                (elen,) = _U32.unpack(hdr)
                payload = _read_exact(self._sock, elen)
                if payload is None:
                    break
                et = payload[0]
                if et == E_DATA:
                    flags, src = payload[1], struct.unpack_from(
                        "<i", payload, 2)[0]
                    body = payload[10:]
                    if flags & FLAG_COMPRESSED:
                        try:
                            body = zlib.decompress(body)
                        except zlib.error as e:
                            import sys

                            print(
                                f"[adlb chan rank {ep.rank}] dropping "
                                f"undecompressable envelope from {src}: "
                                f"{e!r}",
                                file=sys.stderr,
                            )
                            continue
                    if src in self.dead:
                        # traffic from a "dead" rank: the DETACH was
                        # connection churn (e.g. a bridge drop), not
                        # process death — resurrect, exactly like the
                        # server's _resurrect for per-pair churn EOFs
                        self.dead.discard(src)
                    self.seen.add(src)
                    ep._deliver_body(body, learn_binary=False)
                elif et == E_DETACH:
                    (rank,) = struct.unpack_from("<i", payload, 1)
                    self._peer_gone(rank)
        finally:
            # broker gone (or our own close): per-rank EOFs for every
            # peer we had heard from — the host-died ladder
            if not self._closed:
                for src in sorted(self.seen):
                    self._peer_gone(src)

    def _peer_gone(self, rank: int) -> None:
        from adlb_tpu_torch.runtime.messages import Msg, Tag

        if rank in self.dead:
            return
        self.dead.add(rank)
        ep = self._ep
        if rank in self.seen and not ep._closed:
            ep.inbox.put(Msg(tag=Tag.PEER_EOF, src=rank))
            cb = ep.notify
            if cb is not None:
                cb()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        # the broker closes its end once it has read ours to the EOF; wait
        # for that while the reader drains what is still in flight. Closing
        # with unread bytes would send a reset instead, and a reset can
        # discard our last frames (FA_LOCAL_APP_DONE) before the broker
        # reads them, leaving the servers waiting forever
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass


def resolve_tcp_mux(cfg) -> bool:
    """Should a spawn_world-style single-host harness run the channel
    plane? An explicit ``Config(tcp_mux)`` wins; ``"auto"`` honors the
    ``ADLB_TCP_MUX`` env override (the CI leg's hook) and otherwise
    stays on per-pair TCP for single-host worlds (the mux pays two hops
    on loopback and wins exactly where the socket explosion lives —
    cross-host fleets)."""
    v = getattr(cfg, "tcp_mux", "auto")
    if v == "on":
        return True
    if v == "off":
        return False
    return os.environ.get("ADLB_TCP_MUX", "").strip().lower() in (
        "1", "on", "true", "yes"
    )
