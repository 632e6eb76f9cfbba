"""Transports: how ranks exchange protocol messages.

The reference's substrate is MPI point-to-point with Iprobe polling
(reference ``src/adlb.c:856-868``). Here a `Transport` is a per-rank endpoint
with ``send(dest, msg)`` and ``recv(timeout)``; the server reactor stays a
single-threaded poll loop, as in the reference.

* `InProcFabric` — ranks are threads in one process, inboxes are queues.
  This is the testing substrate (the reference's analogue is ``mpiexec -n k``
  on one host, SURVEY §4) and the low-latency single-host runtime.
* `TcpFabric` (transport_tcp.py) — ranks are processes, possibly on many
  hosts, length-prefixed msgpack-ish frames over sockets.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Protocol

from adlb_tpu_torch.runtime.messages import Msg

#: the connect grace toward a peer whose listener is known to have been up
#: (every rank of a world binds before any rank runs): the one reconnect
#: after a peer's stream broke, and, under ``on_server_failure=
#: "failover"``, every server-bound send. A refusal then means the peer
#: died, and the 15 s start-up grace would stall the sender (a reactor, a
#: client holding the takeover note that remaps it) for nothing
UP_PEER_GRACE = 1.0


class Endpoint(Protocol):
    rank: int

    def send(self, dest: int, m: Msg) -> None: ...

    def recv(self, timeout: Optional[float]) -> Optional[Msg]: ...


class InProcEndpoint:
    def __init__(self, fabric: "InProcFabric", rank: int) -> None:
        self._fabric = fabric
        self.rank = rank
        self.inbox: "queue.SimpleQueue[Msg]" = queue.SimpleQueue()
        self.bytes_sent = 0
        self.msgs_sent = 0
        # observability: owning role attaches its metrics Registry
        # (adlb_tpu_torch.obs.metrics.attach). In-proc delivery is one queue
        # put — there is no wire/decode layer — so only the tx side is
        # instrumented (a rank's rx IS its peers' tx, readable from
        # their registries); rx_*/send_s/recv_wait_s exist on the TCP
        # endpoint where they measure something real
        self.metrics = None
        self._tx_stats: dict = {}

    def submit_begin(self) -> None:
        """Submission batching is a wire-transport concern (deferred
        doorbells / coalesced channel gathers); in-proc delivery is one
        queue put, so the batch surface is a no-op here — kept so role
        code can bracket bursts transport-agnostically."""

    def submit_flush(self) -> None:
        pass

    def close(self) -> None:
        """Dynamically attached ranks (elastic membership) close their
        endpoint on exit, exactly like a TCP joiner: the fabric forgets
        the inbox, so a late frame toward this rank raises OSError at
        the sender — the in-proc analogue of connection refused."""
        self._fabric.remove_endpoint(self)

    def send(self, dest: int, m: Msg, connect_grace: float = 0.0) -> None:
        # connect_grace is a TCP-endpoint knob; accepted (and ignored)
        # here so role code can pass it transport-agnostically
        self.msgs_sent += 1
        payload = m.data.get("payload")
        nbytes = (
            len(payload) if isinstance(payload, (bytes, bytearray)) else 0
        )
        self.bytes_sent += nbytes
        reg = self.metrics
        if reg is not None:
            st = self._tx_stats.get(m.tag)
            if st is None:
                st = self._tx_stats[m.tag] = (
                    reg.counter("tx_msgs", tag=m.tag.name),
                    reg.counter("tx_bytes", tag=m.tag.name),
                )
            st[0].inc()
            st[1].inc(nbytes)
        try:
            peer = self._fabric.endpoints[dest]
        except KeyError:
            # elastic membership: no endpoint (yet/anymore) for this
            # rank — surface it like TCP's connection refused, which
            # every sender path already tolerates
            raise OSError(f"no endpoint for rank {dest}") from None
        peer.inbox.put(m)

    def recv(self, timeout: Optional[float] = None) -> Optional[Msg]:
        try:
            if timeout is None:
                return self.inbox.get()
            if timeout <= 0.0:
                # never SimpleQueue.get(timeout=0.0): on this host class a
                # freshly forked child's zero-timeout timed get can park
                # forever in the lock (kernel-level; ~1/10 TCP worlds
                # wedged in the client's first recv). get_nowait() checks
                # the list without touching the lock and cannot hang.
                return self.inbox.get_nowait()
            return self.inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def backlog(self) -> int:
        """Received-but-unhandled frames — the TCP-era analogue of the
        reference's MPI unexpected-message-queue depth probe (reference
        ``src/adlb.c:3645-3719``)."""
        return self.inbox.qsize()


class InProcFabric:
    """All ranks in one process; message passing via thread-safe queues.

    Endpoints live in a dict so elastic membership can add ranks to a
    RUNNING fabric (attach/scale-out); a send to a rank with no endpoint
    raises OSError, the in-proc analogue of connection refused."""

    def __init__(self, nranks: int) -> None:
        self.nranks = nranks
        self.endpoints: dict[int, InProcEndpoint] = {
            r: InProcEndpoint(self, r) for r in range(nranks)
        }
        self.abort_event = threading.Event()

    def endpoint(self, rank: int) -> InProcEndpoint:
        return self.endpoints[rank]

    def add_endpoint(self, rank: int) -> InProcEndpoint:
        """Elastic membership: an inbox for a newly attached rank (dict
        assignment is atomic under the GIL, so concurrent senders see
        either no endpoint — OSError, retried — or the live one)."""
        ep = InProcEndpoint(self, rank)
        self.endpoints[rank] = ep
        return ep

    def remove_endpoint(self, ep: InProcEndpoint) -> None:
        """The in-proc analogue of closing a TCP listener: subsequent
        sends toward the rank raise OSError (connection refused). Only
        dynamically attached ranks close their endpoints; base ranks
        live for the world."""
        if self.endpoints.get(ep.rank) is ep:
            del self.endpoints[ep.rank]
