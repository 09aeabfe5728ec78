"""Transport layer: point-to-point request/response RPC between nodes
(reference: src/net/)."""

from .rpc import (
    RPC,
    EagerSyncRequest,
    EagerSyncResponse,
    FastForwardRequest,
    FastForwardResponse,
    JoinRequest,
    JoinResponse,
    SyncRequest,
    SyncResponse,
)
from .transport import RemoteError, Transport, TransportError
from .inmem import InmemNetwork, InmemTransport
from .tcp import TCPTransport
from .atcp import AsyncTCPTransport
from .chaos import (
    ChaosController,
    ChaosTransport,
    LinkFaults,
    Nemesis,
    NemesisStep,
)

__all__ = [
    "RPC",
    "SyncRequest",
    "SyncResponse",
    "EagerSyncRequest",
    "EagerSyncResponse",
    "FastForwardRequest",
    "FastForwardResponse",
    "JoinRequest",
    "JoinResponse",
    "Transport",
    "TransportError",
    "RemoteError",
    "InmemNetwork",
    "InmemTransport",
    "TCPTransport",
    "AsyncTCPTransport",
    "ChaosController",
    "ChaosTransport",
    "LinkFaults",
    "Nemesis",
    "NemesisStep",
]
