"""Dummy socket client: the chat-app state served over the socket proxy
pair, for running the app in a separate process from the node
(reference: src/dummy/socket_dummy.go:13-60)."""

from __future__ import annotations

from ..proxy.socket_proxy import SocketBabbleProxy
from .state import State


class DummySocketClient:
    """App process: dummy State behind a SocketBabbleProxy."""

    def __init__(self, bind_addr: str, babble_addr: str):
        self.state = State()
        self.proxy = SocketBabbleProxy(bind_addr, babble_addr, self.state)
        self.addr = self.proxy.addr

    def submit_tx(self, tx: bytes) -> str:
        """Submit a transaction; returns the node's admission verdict
        ("accepted" | "duplicate" | "already_committed" | "full" |
        "throttled" | "oversized" — docs/mempool.md) so clients like
        demo/bombard.py can back off and report shed rates."""
        return self.proxy.submit_tx(tx)

    def close(self) -> None:
        self.proxy.close()
