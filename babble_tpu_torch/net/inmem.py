"""In-memory transport for tests: RPCs routed between transports through a
shared registry (reference: src/net/inmem_transport.go:34-185).

The Go version routes through per-peer channels with Connect/Disconnect
wiring; here an InmemNetwork object holds the addr -> transport map and a
disconnect set, and request() delivers the RPC straight onto the target's
consumer queue.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, Optional, Set, Tuple

from .rpc import (
    EagerSyncRequest,
    EagerSyncResponse,
    FastForwardRequest,
    FastForwardResponse,
    JoinRequest,
    JoinResponse,
    RPC,
    SyncRequest,
    SyncResponse,
)
from .transport import RemoteError, TransportError

_counter = itertools.count()


class InmemNetwork:
    """Registry connecting InmemTransports (reference: inmem_transport.go
    Connect/Disconnect wiring, :150-185)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._transports: Dict[str, "InmemTransport"] = {}
        self._severed: Set[Tuple[str, str]] = set()

    def new_transport(self, addr: str = "") -> "InmemTransport":
        t = InmemTransport(self, addr or f"inmem://{next(_counter)}")
        with self._lock:
            self._transports[t.advertise_addr()] = t
        return t

    def disconnect(self, a: str, b: str) -> None:
        """Sever the link between two addresses (both directions)."""
        with self._lock:
            self._severed.add((a, b))
            self._severed.add((b, a))

    def reconnect(self, a: str, b: str) -> None:
        with self._lock:
            self._severed.discard((a, b))
            self._severed.discard((b, a))

    def remove(self, addr: str) -> None:
        with self._lock:
            self._transports.pop(addr, None)

    def route(self, src: str, target: str, timeout: float):
        with self._lock:
            if (src, target) in self._severed:
                raise TransportError(f"link severed: {src} -> {target}")
            t = self._transports.get(target)
        if t is None or t.closed:
            raise TransportError(f"no transport listening on {target}")
        return t

    def request(self, src: str, target: str, command, timeout: float = 5.0):
        t = self.route(src, target, timeout)
        rpc = RPC(command)
        rpc.recv_ts = time.time()  # lint: allow(clock: recv_ts is a real arrival stamp; SimTransport leaves it None)
        t.consumer().put(rpc)
        try:
            result, error = rpc.wait(timeout=timeout)
        except queue.Empty:
            raise TransportError(f"rpc timeout to {target}")
        if error:
            raise RemoteError(error)
        return result


class InmemTransport:
    """Channel-routed fake network endpoint
    (reference: inmem_transport.go:34-80)."""

    def __init__(
        self,
        network: InmemNetwork,
        addr: str,
        timeout: float = 5.0,
        join_timeout: float = 30.0,
    ):
        self.network = network
        self.addr = addr
        self.timeout = timeout
        # Joins block on consensus server-side; give them their own longer
        # deadline, mirroring the TCP transport's split.
        self.join_timeout = max(join_timeout, timeout)
        self.closed = False
        self._consumer: "queue.Queue[RPC]" = queue.Queue()

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self.addr

    def advertise_addr(self) -> str:
        return self.addr

    def listen(self) -> None:
        """No-op: delivery is direct onto the consumer queue."""

    def sync(self, target: str, req: SyncRequest) -> SyncResponse:
        return self.network.request(self.addr, target, req, self.timeout)

    def eager_sync(self, target: str, req: EagerSyncRequest) -> EagerSyncResponse:
        return self.network.request(self.addr, target, req, self.timeout)

    def fast_forward(
        self, target: str, req: FastForwardRequest
    ) -> FastForwardResponse:
        return self.network.request(self.addr, target, req, self.timeout)

    def join(self, target: str, req: JoinRequest) -> JoinResponse:
        return self.network.request(self.addr, target, req, self.join_timeout)

    def close(self) -> None:
        self.closed = True
        self.network.remove(self.addr)
