"""Synchronous in-memory transport for the simulation engine.

A ``SimTransport`` satisfies the same surface as
:class:`~babble_tpu_torch.net.inmem.InmemTransport`, but delivery is a direct
function call: ``sync(target, req)`` runs the target's registered RPC
handler *inside the caller's scheduler event* and returns the response.
No queues between nodes, no threads, no timeouts — a request either
reaches a live handler (and its full server-side processing happens
now, deterministically ordered inside the current event) or raises
``TransportError`` immediately (target down / unregistered), which is
exactly what the chaos layer's partitions compose with.

Latency still exists: wrap a ``SimTransport`` in a ``ChaosTransport``
whose controller sleeps on the ``SimClock`` — delay faults advance
virtual time, so commit-latency histograms see them.
"""

from __future__ import annotations

import queue
from typing import Callable, Dict, Set

from ..net.rpc import RPC
from ..net.transport import RemoteError, TransportError


class SimNetwork:
    """addr -> handler registry plus a down-set (crash churn)."""

    def __init__(self) -> None:
        self._handlers: Dict[str, Callable[[RPC], None]] = {}
        self._down: Set[str] = set()
        self.requests = 0

    def register(self, addr: str, handler: Callable[[RPC], None]) -> None:
        self._handlers[addr] = handler

    def unregister(self, addr: str) -> None:
        self._handlers.pop(addr, None)

    def set_down(self, addr: str) -> None:
        self._down.add(addr)

    def set_up(self, addr: str) -> None:
        self._down.discard(addr)

    def is_down(self, addr: str) -> bool:
        return addr in self._down

    def request(self, src: str, target: str, command):
        if src in self._down:
            # a crashed node's in-flight call fails too (the driver stops
            # ticking it, but a sleep-delayed RPC may still be unwinding)
            raise TransportError(f"sim: {src} is down")
        handler = self._handlers.get(target)
        if handler is None or target in self._down:
            raise TransportError(f"sim: no transport listening on {target}")
        self.requests += 1
        rpc = RPC(command)
        handler(rpc)  # synchronous: the peer's full handler runs HERE
        try:
            result, error = rpc.wait(timeout=0)
        except queue.Empty:
            raise TransportError(f"sim: {target} returned no response")
        if error:
            raise RemoteError(error)
        return result


class SimTransport:
    """Transport facade bound to one address on a :class:`SimNetwork`."""

    def __init__(self, network: SimNetwork, addr: str):
        self.network = network
        self.addr = addr
        self.closed = False
        # Node._do_background_work would drain this in threaded mode; the
        # sim never starts that thread, but the attribute keeps the
        # Transport surface complete.
        self._consumer: "queue.Queue[RPC]" = queue.Queue()

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self.addr

    def advertise_addr(self) -> str:
        return self.addr

    def listen(self) -> None:
        """No-op: handlers are registered by the harness."""

    def sync(self, target: str, req):
        return self.network.request(self.addr, target, req)

    def eager_sync(self, target: str, req):
        return self.network.request(self.addr, target, req)

    def fast_forward(self, target: str, req):
        return self.network.request(self.addr, target, req)

    def join(self, target: str, req):
        return self.network.request(self.addr, target, req)

    def close(self) -> None:
        self.closed = True
        self.network.unregister(self.addr)
