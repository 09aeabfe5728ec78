"""Transport interface (reference: src/net/transport.go:5-35).

A Transport gives the node: a consumer queue of incoming RPCs, and four
client calls (sync, eager_sync, fast_forward, join) addressed by the
peer's net address string.
"""

from __future__ import annotations

import queue
from typing import Protocol

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


class TransportError(Exception):
    """Raised when an RPC fails (connection refused, timeout, remote error)."""


class RemoteError(TransportError):
    """The peer RECEIVED the request and answered with an error. The
    network worked; retrying the transport cannot help — callers deciding
    whether to retry (fast-forward's poll loop) treat this as a
    conclusive answer, not a connectivity failure."""


class Transport(Protocol):
    """reference: net/transport.go:5-35."""

    def consumer(self) -> "queue.Queue[RPC]": ...

    def local_addr(self) -> str: ...

    def advertise_addr(self) -> str: ...

    def listen(self) -> None: ...

    def sync(self, target: str, req: SyncRequest) -> SyncResponse: ...

    def eager_sync(
        self, target: str, req: EagerSyncRequest
    ) -> EagerSyncResponse: ...

    def fast_forward(
        self, target: str, req: FastForwardRequest
    ) -> FastForwardResponse: ...

    def join(self, target: str, req: JoinRequest) -> JoinResponse: ...

    def close(self) -> None: ...
