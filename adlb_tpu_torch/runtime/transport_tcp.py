"""TCP transport: ranks as processes, possibly on many hosts.

The multi-process analogue of the reference's MPI substrate (reference
``src/adlb.c:44-83`` tag protocol over ``MPI_Send/Irecv``): every rank runs a
tiny acceptor thread; messages are length-prefixed pickled frames over
persistent sockets, delivered into the same inbox interface the in-process
fabric uses, so the server reactor and client engine are transport-agnostic.

Bootstrap mirrors ``torch.distributed``-style initialization: a rendezvous
file or coordinator address maps rank -> (host, port). For single-host
multi-process use, :func:`spawn_world` forks one process per rank.
"""

from __future__ import annotations

import itertools
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Optional

from adlb_tpu_torch.runtime.channel import data_envelope as _data_envelope
from adlb_tpu_torch.runtime.codec import (
    decode_binary,
    encodable,
    encode_binary_iov,
    loads_restricted,
    wire_native_ok,
)
from adlb_tpu_torch.runtime.messages import Msg, Tag
from adlb_tpu_torch.runtime.transport import UP_PEER_GRACE

_HDR = struct.Struct("<I")

# sentinel: _deliver_body refused a frame in a way that must close a
# per-pair connection (hostile pickle); the channel plane drops instead
_REFUSED = object()


class _SubmitBatch(threading.local):
    """Per-thread submit-batch state (see TcpEndpoint.submit_begin):
    channel-plane envelopes accumulated between begin/flush so a burst
    of N frames costs one gather syscall, not N."""

    depth = 0
    envs: Optional[list] = None
    saved = 0

# staggers the rendezvous-port probe start for successive worlds created
# by the same process (see local_addr_map)
# atomic per-process probe counter (itertools.count.__next__ is a single
# C-level op, so concurrent world creation from multiple threads cannot
# read-modify-write the same value and collapse onto one probe start)
_PORT_PROBE_CALLS = itertools.count()


class TcpEndpoint:
    """One rank's endpoint: an acceptor thread feeding an inbox, plus lazily
    opened persistent outbound connections to peers."""

    def __init__(
        self,
        rank: int,
        addr_map: dict[int, tuple[str, int]],
        binary_peers: Optional[set[int]] = None,
        mux: Optional[tuple[str, int]] = None,
        compress_min: int = 0,
        mux_ranks: Optional[int] = None,
    ) -> None:
        self.rank = rank
        self.addr_map = dict(addr_map)
        self.inbox: "queue.SimpleQueue[Msg]" = queue.SimpleQueue()
        self._out: dict[int, socket.socket] = {}
        self._out_lock = threading.Lock()  # guards the maps only
        self._dest_locks: dict[int, threading.Lock] = {}
        self._closed = False
        # ranks that speak the binary TLV codec (native C/Fortran clients).
        # Learned automatically from inbound frames — clients always send
        # first (FA_*) — or declared upfront via the rendezvous.
        self.binary_peers: set[int] = set(binary_peers or ())
        # observability: the owning role (Server/Client) attaches its
        # metrics Registry here (adlb_tpu_torch.obs.metrics.attach); per-tag
        # counter objects are cached so the per-message cost is one
        # None-check when detached and two dict hits when attached
        self.metrics = None
        self._tx_stats: dict = {}
        self._rx_stats: dict = {}
        self._h_send = None  # send_s / recv_wait_s histograms, cached on
        self._h_recv = None  # first use (hot path: no per-message lookup)
        # shm-fabric hooks (transport_shm.py): ``notify`` fires after
        # every inbox delivery so a recv blocked on the shm doorbell
        # wakes for TCP traffic too; ``shm_ctl`` receives the swallowed
        # SHM_HELLO frames (ring-attach announcements). Both None when
        # no shm wrapper is stacked on this endpoint.
        self.notify = None
        self.shm_ctl = None
        # multiplexed channel plane (adlb_tpu_torch/runtime/channel.py): when a
        # broker address is given, python<->python traffic rides (src,
        # dst, frame) envelopes over ONE socket to the host's broker —
        # O(hosts^2) fleet sockets — while native peers (binary TLV,
        # no envelope support) keep direct per-pair connections, which
        # is also why the listener below stays up under the mux.
        self._mux = None
        # elastic membership: brokers are wired for the STATIC world at
        # launch (rank -> host routes from the rendezvous), so only
        # dests BELOW this bound ride the mux — dynamically attached
        # ranks (ids above the base world) keep per-pair sockets both
        # ways. None = every python peer rides the broker.
        self._mux_ranks = mux_ranks
        self._compress_min = int(compress_min)
        self._submit = _SubmitBatch()
        self._g_ch = None       # tcp_channels_open gauge, cached
        self._c_coal = None     # frames_coalesced counter, cached
        self._c_comp = None     # bytes_compressed counter, cached
        self._h_enc = None      # codec_encode_us histogram, cached

        host, port = self.addr_map[rank]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        # rebind may have picked an ephemeral port
        self.addr_map[rank] = self._listener.getsockname()
        self._acceptor = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"adlb-tcp-acceptor-{rank}"
        )
        self._acceptor.start()
        if mux is not None:
            from adlb_tpu_torch.runtime.channel import ChannelClient

            self._mux = ChannelClient(self, mux, compress_min)

    @property
    def port(self) -> int:
        return self.addr_map[self.rank][1]

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    def _deliver_body(self, body, learn_binary: bool = True):
        """Decode one frame body (first-byte pickle/TLV discrimination)
        and deliver it: rx accounting, SHM_HELLO swallowing, inbox put,
        notify. Shared by the per-pair reader threads and the channel
        plane's client. Returns the Msg, None for a dropped binary
        frame or a swallowed HELLO, or ``_REFUSED`` for a frame whose
        unpickle was refused (the per-pair reader closes on it; the
        channel plane drops and keeps the shared channel up)."""
        if body[:1] == b"\x01":
            try:
                m = decode_binary(body)
            except Exception as e:  # noqa: BLE001 — stale C peer
                # A malformed frame (e.g. a native client built against
                # stale codec tables) must be diagnosable, not a silent
                # reader-thread death + peer hang.
                import sys

                print(
                    f"[adlb tcp rank {self.rank}] dropping "
                    f"undecodable binary frame ({len(body)}B): {e!r}",
                    file=sys.stderr,
                )
                return None
            if learn_binary:
                # inbound TLV on a DIRECT connection marks a native
                # client; TLV over the channel plane is just a python
                # peer's wire-native frame and must not re-route our
                # replies off the mux
                self.binary_peers.add(m.src)
        else:
            try:
                m = loads_restricted(body)
                if not isinstance(m, Msg):
                    raise pickle.UnpicklingError(
                        f"frame unpickled to "
                        f"{type(m).__name__}, not Msg"
                    )
            except Exception as e:  # noqa: BLE001 — hostile bytes
                import sys

                print(
                    f"[adlb tcp rank {self.rank}] refusing "
                    f"unpicklable frame ({len(body)}B): {e!r}",
                    file=sys.stderr,
                )
                return _REFUSED
        if m.tag is Tag.SHM_HELLO:
            # ring-attach announcement: hand the frame to the shm
            # wrapper instead of the role's inbox (the connection — or
            # channel attachment — it rode is the pair's death sentinel)
            ctl = self.shm_ctl
            if ctl is not None:
                ctl(m)
            return m
        reg = self.metrics
        if reg is not None:
            st = self._rx_stats.get(m.tag)
            if st is None:
                st = self._rx_stats[m.tag] = (
                    reg.counter("rx_msgs", tag=m.tag.name),
                    reg.counter("rx_bytes", tag=m.tag.name),
                )
            st[0].inc()
            # header included, so a rank's rx_bytes reconciles
            # with its peers' tx_bytes (which count the frame)
            st[1].inc(_HDR.size + len(body))
        self.inbox.put(m)
        cb = self.notify
        if cb is not None:
            cb()
        return m

    def _reader(self, conn: socket.socket) -> None:
        last_src: Optional[int] = None
        try:
            while True:
                hdr = self._read_exact(conn, _HDR.size)
                if hdr is None:
                    return
                (n,) = _HDR.unpack(hdr)
                body = self._read_exact(conn, n)
                if body is None:
                    return
                m = self._deliver_body(body)
                if m is _REFUSED:
                    # close the connection: for a never-established
                    # stray connection (last_src is None) nothing else
                    # happens; for an established peer stream the
                    # finally below synthesizes PEER_EOF — the
                    # rank-death fail-fast — rather than silently
                    # dropping a frame someone awaits
                    return
                if m is not None:
                    last_src = m.src
        except OSError:
            return
        finally:
            # EOF after the peer's frames: a synthetic in-order signal so
            # role logic can tell a finalized peer from a dead one (the
            # reference's failure model is rank-death-kills-job,
            # src/adlb.c:2508-2526; a silent EOF here would hang instead)
            if last_src is not None and not self._closed:
                self.inbox.put(Msg(tag=Tag.PEER_EOF, src=last_src))
                cb = self.notify
                if cb is not None:
                    cb()
            conn.close()

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    def _connect(self, dest: int, grace: float = 15.0) -> socket.socket:
        """Connect to a peer, tolerating a listener that is still coming up
        (ranks bind at different times in thread/process worlds); ``grace``
        bounds how long refusals are retried — senders that know their
        peers are already up (e.g. the balancer sidecar, whose peers
        snapshot only after binding) pass a short grace so a dead peer
        fails fast instead of stalling the loop 15 s."""
        deadline = time.monotonic() + grace
        while True:
            try:
                sock = socket.create_connection(self.addr_map[dest], timeout=30)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except ConnectionRefusedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def send(self, dest: int, m: Msg, connect_grace: float = 15.0) -> None:
        reg = self.metrics
        # channel-plane routing: python peers ride the broker; native
        # peers (binary TLV, no envelope support) and self keep direct
        # per-pair sockets
        mux = self._mux
        if mux is not None and (
            dest == self.rank
            or dest in self.binary_peers
            or (self._mux_ranks is not None and dest >= self._mux_ranks)
        ):
            mux = None
        if mux is not None and dest in mux.dead:
            # sends to a dead peer must fail like a refused reconnect,
            # not vanish into a dropped envelope
            raise OSError(
                f"channel plane: rank {dest} is dead (DETACH seen)"
            )
        # serialization (pickle/TLV encode) runs OUTSIDE the send lock:
        # only socket I/O is serialized per destination
        t_enc = time.monotonic() if reg is not None else 0.0
        tlv = False
        if dest in self.binary_peers:
            if not encodable(m):
                raise ValueError(
                    f"message {m.tag} carries fields outside the binary "
                    f"codec but rank {dest} is a native (non-pickle) client"
                )
            # scatter-gather encode: the payload views ride the iovec
            # straight into sendmsg — no body-concat copy on the hot path
            parts = encode_binary_iov(m)
            tlv = True
        elif mux is not None and wire_native_ok(m):
            # the channel plane carries TLV for the wire-native hot path
            # (same body rule as the shm rings), pickle for the rest
            parts = encode_binary_iov(m)
            tlv = True
        else:
            parts = [pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)]
        nbody = sum(len(p) for p in parts)
        t0 = time.monotonic() if reg is not None else 0.0
        if reg is not None and tlv:
            if self._h_enc is None:
                self._h_enc = reg.histogram("codec_encode_us")
            self._h_enc.observe((t0 - t_enc) * 1e6)
        if mux is not None:
            env, saved = _data_envelope(self.rank, dest, parts, nbody,
                                        self._compress_min)
            if saved and reg is not None:
                if self._c_comp is None:
                    self._c_comp = reg.counter("bytes_compressed")
                self._c_comp.inc(saved)
            st_b = self._submit
            if st_b.depth > 0 and st_b.envs is not None:
                st_b.envs.append(env)  # one gather at submit_flush
            else:
                mux.send_batch([env])
        else:
            frame = [_HDR.pack(nbody), *parts]
            # per-destination serialization: a slow/dead peer (15 s
            # connect retry) must not stall sends to every other rank
            with self._out_lock:
                dlock = self._dest_locks.setdefault(dest, threading.Lock())
            with dlock:
                with self._out_lock:
                    sock = self._out.get(dest)
                if sock is None:
                    sock = self._connect(dest, connect_grace)
                    with self._out_lock:
                        self._out[dest] = sock
                try:
                    self._send_iov(sock, frame)
                except OSError:
                    # one reconnect attempt (a FRESH stream, so
                    # restarting the frame from its first byte is safe);
                    # beyond that the watchdog handles it. The peer's
                    # listener was up when this stream connected, so a
                    # refusal now means it died (UP_PEER_GRACE)
                    sock = self._connect(dest, min(connect_grace,
                                                   UP_PEER_GRACE))
                    with self._out_lock:
                        self._out[dest] = sock
                    self._send_iov(sock, frame)
        if reg is not None:
            st = self._tx_stats.get(m.tag)
            if st is None:
                st = self._tx_stats[m.tag] = (
                    reg.counter("tx_msgs", tag=m.tag.name),
                    reg.counter("tx_bytes", tag=m.tag.name),
                )
            st[0].inc()
            st[1].inc(_HDR.size + nbody)
            # whole-path send latency: serialization wait + (re)connect +
            # kernel buffer admission — the "how backed up is this peer"
            # signal the reference reads off MPI's unexpected queue
            if self._h_send is None:
                self._h_send = reg.histogram("send_s")
            self._h_send.observe(time.monotonic() - t0)
            # data-plane socket census: direct per-pair sockets plus the
            # one channel to the broker (the O(1)-per-host-pair claim,
            # scraped off /metrics as tcp_channels_open)
            if self._g_ch is None:
                self._g_ch = reg.gauge("tcp_channels_open")
            self._g_ch.set(len(self._out) + (1 if self._mux else 0))

    # -- submit batching ------------------------------------------------------

    def submit_begin(self) -> None:
        """Enter a per-thread submission batch: channel-plane sends
        accumulate and go out as ONE gather at :meth:`submit_flush` (a
        reactor tick's burst of N responses costs O(1) syscalls and
        wakeups). Per-pair sockets stay synchronous — their error
        surface (reconnect-at-caller) must not move to the flush point.
        Nests; only the outermost flush submits."""
        st = self._submit
        st.depth += 1
        if st.envs is None:
            st.envs = []

    def submit_flush(self) -> None:
        st = self._submit
        if st.depth > 0:
            st.depth -= 1
        if st.depth > 0:
            return
        envs, st.envs = st.envs, None
        if not envs:
            return
        mux = self._mux
        if mux is None:  # closed mid-batch
            return
        mux.send_batch(envs)
        if len(envs) > 1:
            reg = self.metrics
            if reg is not None:
                if self._c_coal is None:
                    self._c_coal = reg.counter("frames_coalesced")
                self._c_coal.inc(len(envs) - 1)

    @staticmethod
    def _send_iov(sock: socket.socket, parts: list) -> None:
        """Write one frame as a gather (writev-style) send over an
        arbitrary iovec instead of materializing a concatenated body —
        the old concat copied every payload once more per hop, a
        measurable tax on the work-delivery data plane. A short write
        (kernel buffer full) RESUMES the iovec at the unsent offset:
        the remainder re-gathers into the next sendmsg, so large frames
        never fall back to a concat copy either."""
        # Linux IOV_MAX is 1024 segments; a batched fused fetch can carry
        # more payload views than that — split into sequential gathers
        # (the caller holds the per-destination lock, so the frame stays
        # contiguous on the stream)
        while len(parts) > 1000:
            head, parts = parts[:1000], parts[1000:]
            TcpEndpoint._send_iov(sock, head)
        try:
            sent = sock.sendmsg(parts)
        except InterruptedError:
            # EINTR surfaced by a raising signal handler: nothing was
            # written, resume the same gather (PEP 475 auto-retries the
            # silent case; this covers the loud one)
            sent = 0
        except (AttributeError, NotImplementedError):  # platform without
            for p in parts:  # sendmsg: plain per-segment writes
                sock.sendall(p)
            return
        total = sum(len(p) for p in parts)
        while sent < total:
            total -= sent
            rest = []
            for p in parts:
                if sent >= len(p):
                    sent -= len(p)
                    continue
                rest.append(memoryview(p)[sent:] if sent else p)
                sent = 0
            parts = rest
            try:
                sent = sock.sendmsg(parts)
            except InterruptedError:
                sent = 0

    def backlog(self) -> int:
        """Received-but-unhandled frames — the TCP-era analogue of the
        reference's MPI unexpected-message-queue depth probe (reference
        ``src/adlb.c:3645-3719``)."""
        return self.inbox.qsize()

    def recv(self, timeout: Optional[float] = None) -> Optional[Msg]:
        reg = self.metrics
        t0 = time.monotonic() if reg is not None else 0.0
        try:
            if timeout is None:
                m = self.inbox.get()
            elif timeout <= 0.0:
                # never SimpleQueue.get(timeout=0.0): on this host class a
                # freshly forked child's zero-timeout timed get can park
                # forever in the lock (kernel-level; ~1/10 TCP worlds
                # wedged in the client's first recv — minimal repro is
                # fork + fresh SimpleQueue + get(timeout=0.0); nonblocking
                # gets and positive timeouts are unaffected). get_nowait()
                # checks the list without touching the lock.
                m = self.inbox.get_nowait()
            else:
                m = self.inbox.get(timeout=timeout)
        except queue.Empty:
            return None
        if reg is not None:
            # wait-for-message latency (observed only when a message
            # arrived: empty timeouts measure the poll deadline, not
            # the transport)
            if self._h_recv is None:
                self._h_recv = reg.histogram("recv_wait_s")
            self._h_recv.observe(time.monotonic() - t0)
        return m

    def close(self) -> None:
        self._closed = True
        mux, self._mux = self._mux, None
        if mux is not None:
            # FIN after our queued envelopes: the broker forwards them,
            # then fans out our DETACH — peers see our last frames
            # before the PEER_EOF, exactly like the per-pair plane
            mux.close()
        with self._out_lock:
            for s in self._out.values():
                # Outbound sockets are unidirectional (replies arrive on the
                # peer's own connection to our listener), so they never hold
                # unread inbound data and close() can't RST away buffered
                # frames; shutdown(SHUT_WR) makes the FIN-after-data explicit.
                try:
                    s.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            self._out.clear()
        try:
            self._listener.close()
        except OSError:
            pass


def probe_free_ports(count: int, host: str = "127.0.0.1") -> list[int]:
    """Pick ``count`` free ports on one host for ranks that bind later.

    Ports come from BELOW the kernel's ephemeral range (see
    /proc/sys/net/ipv4/ip_local_port_range, typically 32768+): the ports
    are handed to child processes that bind later, and in a 100+-rank
    spawn storm an OUTBOUND connection's ephemeral port can otherwise
    land on a rank's not-yet-bound listener port — that rank then dies on
    bind and the failure-detection abort takes the whole world with it
    (observed at 64-128 ranks as a few-percent flake; the multi-host
    launcher had the same flake from per-rank ephemeral bind(0) probes).
    The probe start is derived from the PID (plus a per-process call
    counter), so concurrent worlds — distinct processes by
    construction — probe well-separated subranges instead of relying on
    lucky random draws; the bind check still skips any port someone else
    actually holds.
    """
    import os

    # the actual ephemeral floor is tunable; read it so the guarantee
    # holds on hosts with a lowered range (fall back to the Linux default)
    floor = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            floor = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    if floor < 13000 + 2 * count:
        # no usable static range below the ephemeral floor: fall back to
        # kernel-assigned ports (the pre-fix behaviour, collision risk
        # and all — there is nowhere safe to allocate from)
        ports = []
        socks = []
        for _r in range(count):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return ports

    lo = max(1024, floor - 12000)
    hi = floor - 100
    ports = []
    socks = []
    span = hi - lo
    # Knuth-hash the PID so adjacent PIDs (concurrently spawned worlds)
    # land far apart in the range; successive worlds from the SAME
    # process are staggered by the call counter
    start = lo + (os.getpid() * 40503 + next(_PORT_PROBE_CALLS) * 1013) % span
    port = start
    probed = 0
    while len(ports) < count:
        port += 1
        if port >= hi:
            port = lo  # wrap: free ports below the start stay usable
        probed += 1
        if probed > span:
            raise OSError(f"no free rendezvous ports in [{lo},{hi})")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
        except OSError:
            s.close()
            continue
        socks.append(s)
        ports.append(port)
    for s in socks:
        s.close()
    return ports


def local_addr_map(nranks: int, host: str = "127.0.0.1") -> dict[int, tuple[str, int]]:
    """Pick nranks free ports on one host (rendezvous for tests/single-host);
    see :func:`probe_free_ports` for the ephemeral-range rationale."""
    return {
        r: (host, p) for r, p in enumerate(probe_free_ports(nranks, host))
    }


# --------------------------------------------------------------- spawn_world


def _native_server_main(rank, world, cfg, port_q, conn, result_q, abort_event):
    """Wrapper for a native C++ server rank: launch adlb_serverd, relay the
    rendezvous (PORT line out, addr map in), parse the final STATS line.

    The daemon speaks the same binary TLV protocol as the native C client;
    Python app ranks are told to use binary frames toward server ranks (see
    ``binary_peers`` in :func:`_child_main`)."""
    from adlb_tpu_torch.native import daemon

    proc = daemon.spawn_daemon(world, cfg, rank)
    reported = False

    def report(kind, value):
        nonlocal reported
        if not reported:
            reported = True
            result_q.put((kind, rank, value))

    try:
        port_q.put((rank, daemon.read_hello(proc, rank)))
        daemon.send_addrs(proc, conn.recv())

        # kill the daemon if the world aborts around it (an app rank died)
        def watch_abort():
            while proc.poll() is None:
                if abort_event.wait(timeout=0.25):
                    proc.terminate()
                    return

        threading.Thread(target=watch_abort, daemon=True).start()

        stats, abort_code = daemon.drain_output(proc)
        if abort_code is not None:
            abort_event.set()
        proc.wait(timeout=30.0)
        if abort_code is not None:
            # parity with the Python-server path: the abort code must be
            # recoverable from WorldResult, not just the aborted flag
            report("aborted", abort_code)
        elif stats is None:
            if abort_event.is_set():
                report("server", ({}, None))  # killed by watch_abort: not this
                # rank's failure; the erroring rank reports the cause
            else:
                # daemon died without printing STATS: attribute the failure
                # instead of reporting a clean empty-stats server
                raise RuntimeError(
                    f"native server rank {rank} exited {proc.returncode} "
                    f"without STATS"
                )
        else:
            report("server", (stats, None))
    except BaseException as e:  # noqa: BLE001 — surfaced to the parent
        abort_event.set()
        proc.terminate()
        report("error", repr(e))


def _child_main(rank, world, cfg, app_fn, port_q, conn, result_q, abort_event,
                shm_key=None, mux_addr=None):
    """One rank's process body: bind, rendezvous, run role, report result.

    Exactly one message goes on result_q per rank — the parent counts ranks,
    so a success followed by a teardown error must not report twice.
    """
    if cfg.server_impl == "native" and world.is_server(rank):
        _native_server_main(
            rank, world, cfg, port_q, conn, result_q, abort_event
        )
        return

    reported = False

    def report(kind, value):
        nonlocal reported
        if not reported:
            reported = True
            result_q.put((kind, rank, value))

    # per-process codec selection (Config(codec) beats the import-time
    # env default; "c" is strict — an explicit ask must not silently
    # fall back to the Python twin)
    from adlb_tpu_torch.runtime.codec import select_codec

    select_codec(cfg.codec)

    # with native servers, Python ranks must speak the binary codec toward
    # every server rank (the daemon cannot read pickle frames)
    binary_peers = (
        set(world.server_ranks) if cfg.server_impl == "native" else None
    )
    ep = TcpEndpoint(rank, {rank: ("127.0.0.1", 0)},
                     binary_peers=binary_peers, mux=mux_addr,
                     compress_min=cfg.compress_min_bytes,
                     mux_ranks=world.nranks)
    if shm_key:
        # same-host ranks upgrade to the shared-memory ring fabric; the
        # fault shim stacks OUTSIDE it, so injected faults apply to ring
        # traffic exactly as to TCP traffic
        from adlb_tpu_torch.runtime.transport_shm import ShmEndpoint

        ep = ShmEndpoint(ep, shm_key, ring_bytes=cfg.shm_ring_bytes)
    if cfg.fault_spec:
        from adlb_tpu_torch.runtime.faults import maybe_wrap

        ep = maybe_wrap(ep, cfg, world)
    try:
        port_q.put((rank, ep.port))
        ep.addr_map.update(conn.recv())  # full rank -> (host, port) map
        if world.is_app(rank):
            from adlb_tpu_torch.api import AdlbContext
            from adlb_tpu_torch.runtime.client import Client

            client = Client(world, cfg, ep, abort_event)
            try:
                report("app", app_fn(AdlbContext(client)))
            finally:
                try:
                    client.finalize()
                except Exception:  # home server already gone: benign
                    pass
        elif world.is_server(rank):
            from adlb_tpu_torch.runtime.server import Server

            server = Server(world, cfg, ep, abort_event)
            server.run()
            counts = None
            if server._solver is not None:
                # this server planned (the master, or a deputy that
                # failover promoted): its counts go back to the parent
                # with its stats, its kept solves checked first, since
                # they end with this process
                from adlb_tpu_torch.balancer.solve import check_kept

                check_kept()
                counts = server.planner_report()
            if server.died:
                # fault-injected connectivity death absorbed by
                # on_server_failure="failover" (a SIGKILLed server never
                # reports at all; the parent classifies that case)
                report("server_dead", counts)
            else:
                report("server", (server.finalize_stats(), counts))
        else:
            from adlb_tpu_torch.runtime.debug_server import DebugServer

            DebugServer(world, cfg, ep, abort_event).run()
            report("debug", None)
    except BaseException as e:  # noqa: BLE001 — surfaced to the parent
        try:
            from adlb_tpu_torch.types import AdlbAborted, HomeServerLostError

            if isinstance(e, AdlbAborted):
                report("aborted", e.code)
            elif isinstance(e, HomeServerLostError):
                # distinct kind: the parent decides whether this is abort
                # collateral (server closed before the TA_ABORT landed),
                # a reclaim casualty, or a genuine server crash. Under
                # "reclaim" the rest of the world must keep running, so
                # only the abort policy escalates to the shared event.
                if cfg.on_worker_failure != "reclaim":
                    abort_event.set()
                report("conn_lost", repr(e))
            else:
                abort_event.set()
                report("error", repr(e))
        except Exception:  # pragma: no cover
            pass
    finally:
        ep.close()


def spawn_world(
    num_app_ranks: int,
    nservers: int,
    types,
    app_fn,
    cfg=None,
    use_debug_server: bool = False,
    timeout: float = 120.0,
    start_method: Optional[str] = None,
):
    """Run a world with one OS process per rank over TCP — the analogue of
    ``mpiexec -n k`` for the reference's examples (reference
    ``examples/README-batcher.txt:57``), and the building block for
    multi-host deployment (replace the port rendezvous with a shared file).

    Returns :class:`adlb_tpu_torch.api.WorldResult`; its ``planner`` holds
    the solve counts and kernel launches of every process that planned, by
    rank: the master, a deputy that failover promoted (and the master it
    replaced, when that one lived to report), or the sidecar. With
    ``start_method="spawn"`` or ``"forkserver"`` the ``app_fn`` must be
    picklable (module-level).

    ``start_method=None`` forks, unless a rank will plan on the card: the
    master of a Python-server world with ``balancer="tpu"`` and
    ``device="cuda"``. A process cannot use CUDA after a fork from a parent
    that initialised it (``Config`` already asked CUDA for a card),
    so such worlds start their ranks with ``"spawn"``, and an explicit
    ``"fork"`` raises ``ValueError`` before any process starts.
    """
    import multiprocessing as mp

    from adlb_tpu_torch.api import WorldResult
    from adlb_tpu_torch.runtime.world import Config, WorldSpec

    cfg = cfg or Config()
    start_method = resolve_start_method(cfg, start_method)
    if cfg.server_impl == "native":
        from adlb_tpu_torch.native.build import ensure_serverd

        ensure_serverd()  # build once up front, not per server rank
    if cfg.balancer == "tpu" and cfg.device == "cuda":
        # build the greedy-sweep kernel once, here, so that no planner
        # (the sidecar thread or the master rank) runs nvcc inside the
        # world's timeout; a child loads the built library
        from adlb_tpu_torch.balancer import greedy_sweep

        greedy_sweep.build()
    world = WorldSpec(
        nranks=num_app_ranks + nservers + (1 if use_debug_server else 0),
        nservers=nservers,
        types=tuple(types),
        use_debug_server=use_debug_server,
    )
    # fabric negotiation: spawn_world ranks are same-host by
    # construction, so the resolved "shm" fabric upgrades every
    # python<->python pair to rings under one fresh world key (native
    # daemon ranks negotiate down to TCP per pair inside the endpoint)
    from adlb_tpu_torch.runtime.transport_shm import (
        cleanup_world,
        new_world_key,
        resolve_fabric,
    )

    shm_key = new_world_key() if resolve_fabric(cfg) == "shm" else None

    # channel plane (Config(tcp_mux) / ADLB_TCP_MUX): one broker for
    # this single-host world, running in the parent like the balancer
    # sidecar; ranks hold ONE data-plane socket each instead of one per
    # peer. Native server worlds keep direct sockets toward the daemons
    # (binary peers route around the mux inside the endpoint).
    from adlb_tpu_torch.runtime.channel import ChannelBroker, resolve_tcp_mux

    broker = ChannelBroker() if resolve_tcp_mux(cfg) else None
    mux_addr = broker.addr if broker is not None else None

    ctx = mp.get_context(start_method)
    port_q = ctx.Queue()
    result_q = ctx.Queue()
    abort_event = ctx.Event()
    pipes = {}
    procs = {}
    for rank in range(world.nranks):
        parent_end, child_end = ctx.Pipe()
        pipes[rank] = parent_end
        p = ctx.Process(
            target=_child_main,
            args=(rank, world, cfg, app_fn, port_q, child_end, result_q,
                  abort_event, shm_key, mux_addr),
            name=f"adlb-rank-{rank}",
        )
        procs[rank] = p
        p.start()

    # native + tpu: the balancer brain runs as a sidecar thread in the
    # parent at pseudo-rank world.nranks; servers stream snapshots to it
    sidecar_ep = None
    sidecar_thread = None
    if cfg.server_impl == "native" and cfg.balancer == "tpu":
        from adlb_tpu_torch.balancer.sidecar import start_sidecar

        sidecar_ep, sidecar_thread = start_sidecar(world, cfg, abort_event)

    deadline = time.monotonic() + timeout
    addr_map = {}
    try:
        while len(addr_map) < world.nranks:
            try:
                rank, port = port_q.get(timeout=0.25)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "spawn_world: rendezvous did not complete"
                    ) from None
                dead = [r for r, p in procs.items()
                        if not p.is_alive() and r not in addr_map]
                if dead:
                    # surface the child's real startup error if it reported one
                    detail = ""
                    try:
                        kind, r, value = result_q.get(timeout=0.25)
                        if kind == "error":
                            detail = f": rank {r}: {value}"
                    except queue.Empty:
                        pass
                    raise RuntimeError(
                        f"spawn_world: rank(s) {dead} died before "
                        f"rendezvous{detail}"
                    )
                continue
            addr_map[rank] = ("127.0.0.1", port)
        if sidecar_ep is not None:
            addr_map[world.nranks] = ("127.0.0.1", sidecar_ep.port)
            sidecar_ep.addr_map.update(addr_map)
            sidecar_thread.start()
        for conn in pipes.values():
            conn.send(addr_map)
    except Exception:
        abort_event.set()
        for p in procs.values():
            p.terminate()
        if sidecar_ep is not None:
            from adlb_tpu_torch.balancer.sidecar import stop_sidecar

            stop_sidecar(sidecar_ep, sidecar_thread, abort_event)
        if broker is not None:
            broker.close()
        cleanup_world(shm_key)
        raise

    app_results, server_stats, planner = {}, {}, {}
    errors: list[str] = []
    conn_lost: list[str] = []
    casualties: list[int] = []
    server_casualties: list[int] = []
    aborted_code = None
    real_abort = False
    reported: set[int] = set()
    while len(reported) < world.nranks:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            abort_event.set()
            errors.append(f"world did not finish within {timeout}s")
            break
        try:
            kind, rank, value = result_q.get(timeout=min(remaining, 1.0))
        except queue.Empty:
            if all(not p.is_alive() for p in procs.values()):
                missing = sorted(set(procs) - reported)
                if cfg.on_worker_failure == "reclaim":
                    # app ranks that died without reporting are the
                    # casualties the reclaim policy absorbed; the world
                    # completing around them is the success criterion.
                    casualties.extend(
                        r for r in missing if world.is_app(r)
                    )
                    missing = [r for r in missing if not world.is_app(r)]
                if cfg.on_server_failure == "failover":
                    # servers that died without reporting are the
                    # failover casualties (SIGKILLed mid-run); their
                    # buddies completed the world around them — the
                    # MASTER included: its ring buddy is the standing
                    # deputy and promotes (see server._promote_master)
                    server_casualties.extend(
                        r for r in missing if world.is_server(r)
                    )
                    missing = [r for r in missing if not world.is_server(r)]
                if missing:
                    errors.append(
                        f"rank(s) {missing} died without reporting a result"
                    )
                break
            continue
        reported.add(rank)
        if kind == "app":
            app_results[rank] = value
        elif kind == "server":
            server_stats[rank], counts = value
            if counts is not None:
                planner[rank] = counts
        elif kind == "server_dead":
            server_casualties.append(rank)
            if value is not None:  # a master that planned before it died
                planner[rank] = value
        elif kind == "error":
            errors.append(f"rank {rank}: {value}")
        elif kind == "conn_lost":
            conn_lost.append((rank, f"rank {rank}: {value}"))
        elif kind == "aborted":
            aborted_code = value
            # -1 is the abort_event sentinel (AdlbAborted(-1) raised when
            # a sibling set the event), NOT proof a rank called Abort:
            # a conn_lost child sets the event too, so collateral -1
            # reports must not launder a genuine server failure into a
            # clean abort. A real abort always yields a non-sentinel
            # report — Client.abort raises AdlbAborted(code) in the
            # aborting rank itself.
            if value != -1:
                real_abort = True

    for p in procs.values():
        p.join(timeout=max(deadline - time.monotonic(), 1.0))
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
    if sidecar_thread is not None:
        from adlb_tpu_torch.balancer.sidecar import (
            raise_if_failed,
            stop_sidecar,
        )

        stop_sidecar(sidecar_ep, sidecar_thread, abort_event)
        planner[world.nranks] = sidecar_thread.planner()
    if broker is not None:
        broker.close()
    # every child is gone: sweep ring segments/FIFOs whose owners died
    # without unlinking (SIGKILL chaos legs would otherwise leak them)
    cleanup_world(shm_key)

    # a rank losing its home server is abort COLLATERAL when some rank
    # REALLY aborted the world (the server may close its listener before
    # every TA_ABORT frame lands); under the reclaim policy an app rank's
    # lost connectivity is a CASUALTY the world completed around (e.g. a
    # fault-injected disconnect — the client process survives to report
    # conn_lost, the servers reclaim its work); otherwise it is a genuine
    # failure
    if conn_lost and not real_abort:
        if cfg.on_worker_failure == "reclaim":
            casualties.extend(r for r, _ in conn_lost if world.is_app(r))
            errors.extend(s for r, s in conn_lost if not world.is_app(r))
        else:
            errors.extend(s for _, s in conn_lost)
    if sidecar_thread is not None:
        raise_if_failed(sidecar_thread)  # the cause, before its collateral
    if errors:
        raise RuntimeError("; ".join(errors))
    from adlb_tpu_torch.types import InfoKey

    return WorldResult(
        app_results=app_results,
        server_stats=server_stats,
        aborted=abort_event.is_set() or aborted_code is not None,
        exception=None,
        casualties=sorted(casualties),
        server_casualties=sorted(server_casualties),
        quarantined=int(sum(
            s.get(int(InfoKey.QUARANTINED), 0)
            for s in server_stats.values()
        )),
        planner=planner,
    )


def resolve_start_method(cfg, start_method: Optional[str]) -> str:
    """The start method of a process world's ranks (see :func:`spawn_world`):
    never ``"fork"`` when a rank will plan on the card."""
    on_card = (cfg.balancer == "tpu" and cfg.device == "cuda"
               and cfg.server_impl == "python")
    if start_method is None:
        return "spawn" if on_card else "fork"
    if start_method == "fork" and on_card:
        raise ValueError(
            "start_method='fork' with a master that plans on the card "
            "(balancer='tpu', device='cuda', Python servers): CUDA cannot "
            "be used in a process forked after the parent initialised it; "
            "use 'spawn' or 'forkserver'")
    return start_method
