"""Application integration layer.

The AppProxy is the contact surface between the consensus engine and the
application being replicated (reference: src/proxy/proxy.go:10-16,
src/proxy/handlers.go:13-28, src/proxy/types.go:6-28).
"""

from .proxy import (
    AppProxy,
    CommitResponse,
    InmemProxy,
    ProxyHandler,
    dummy_commit_response,
)
from .socket_proxy import SocketAppProxy, SocketBabbleProxy

__all__ = [
    "AppProxy",
    "CommitResponse",
    "InmemProxy",
    "ProxyHandler",
    "SocketAppProxy",
    "SocketBabbleProxy",
    "dummy_commit_response",
]
