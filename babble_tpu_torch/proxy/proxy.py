"""AppProxy interfaces and the in-memory implementation.

Reference semantics: src/proxy/proxy.go:10-16 (AppProxy),
src/proxy/handlers.go:13-28 (ProxyHandler), src/proxy/types.go:6-28
(CommitResponse / DummyCommitCallback), src/proxy/inmem/inmem_proxy.go:15-116.

The Go version passes transactions to the node over a channel; here the
submit surface is a thread-safe queue.Queue that the node's background
worker drains.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol

from ..hashgraph.block import Block
from ..hashgraph.internal_transaction import InternalTransactionReceipt


@dataclass
class CommitResponse:
    """Result of committing a block to the application
    (reference: proxy/types.go:6-10)."""

    state_hash: bytes = b""
    receipts: List[InternalTransactionReceipt] = field(default_factory=list)


def dummy_commit_response(block: Block) -> CommitResponse:
    """Accept-everything commit callback for tests
    (reference: proxy/types.go:15-28)."""
    return CommitResponse(
        state_hash=b"",
        receipts=[it.as_accepted() for it in block.internal_transactions()],
    )


class ProxyHandler(Protocol):
    """Application-implemented callbacks (reference: proxy/handlers.go:13-28)."""

    def commit_handler(self, block: Block) -> CommitResponse: ...

    def snapshot_handler(self, block_index: int) -> bytes: ...

    def restore_handler(self, snapshot: bytes) -> bytes: ...

    def state_change_handler(self, state) -> None: ...


class AppProxy(Protocol):
    """What the node needs from the application side
    (reference: proxy/proxy.go:10-16).

    Proxies MAY additionally expose ``set_submit_handler(fn)``: the node
    registers a synchronous admission callback ``fn(tx) -> verdict`` (the
    mempool's, docs/mempool.md) so SubmitTx returns an explicit verdict
    instead of queueing blindly. The node probes for it with hasattr —
    proxies without it keep the queue-only shape."""

    def submit_queue(self) -> "queue.Queue[bytes]": ...

    def commit_block(self, block: Block) -> CommitResponse: ...

    def get_snapshot(self, block_index: int) -> bytes: ...

    def restore(self, snapshot: bytes) -> None: ...

    def on_state_changed(self, state) -> None: ...


class InmemProxy:
    """In-process AppProxy wrapping a ProxyHandler
    (reference: proxy/inmem/inmem_proxy.go:15-116)."""

    def __init__(self, handler: ProxyHandler):
        self.handler = handler
        self._submit: "queue.Queue[bytes]" = queue.Queue()
        self._submit_handler: Optional[Callable[[bytes], str]] = None

    def set_submit_handler(self, fn: Callable[[bytes], str]) -> None:
        """Node-side admission callback; makes submit_tx return verdicts."""
        self._submit_handler = fn

    # -- app-facing ---------------------------------------------------------

    def submit_tx(self, tx: bytes) -> str:
        """Called by the application to submit a transaction
        (reference: inmem_proxy.go:44-52). Returns the mempool admission
        verdict when a node is attached; queues (and reports "accepted")
        before one is."""
        fn = self._submit_handler
        if fn is not None:
            return fn(bytes(tx))
        self._submit.put(bytes(tx))
        return "accepted"

    # -- AppProxy interface -------------------------------------------------

    def submit_queue(self) -> "queue.Queue[bytes]":
        return self._submit

    def commit_block(self, block: Block) -> CommitResponse:
        return self.handler.commit_handler(block)

    def get_snapshot(self, block_index: int) -> bytes:
        return self.handler.snapshot_handler(block_index)

    def restore(self, snapshot: bytes) -> None:
        self.handler.restore_handler(snapshot)

    def on_state_changed(self, state) -> None:
        self.handler.state_change_handler(state)
