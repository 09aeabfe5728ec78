"""Dummy application state: a chat app that chains transaction hashes.

Reference semantics: src/dummy/state.go:19-126 — the state hash is the
iterated two-hash combination of all committed transactions; snapshots are
the state hash recorded per block index; all internal transactions are
accepted.
"""

from __future__ import annotations

from typing import Dict, List

from ..crypto.hashing import sha256, simple_hash_from_two_hashes
from ..hashgraph.block import Block
from ..proxy.proxy import CommitResponse


class State:
    """ProxyHandler implementation (reference: dummy/state.go:19-34)."""

    def __init__(self) -> None:
        self.committed_txs: List[bytes] = []
        self.state_hash: bytes = b""
        self.snapshots: Dict[int, bytes] = {}
        self.babble_state = None

    def commit_handler(self, block: Block) -> CommitResponse:
        """Apply the block: append txs, chain the state hash, snapshot, and
        accept all internal transactions (reference: dummy/state.go:49-98)."""
        txs = block.transactions()
        self.committed_txs.extend(txs)

        h = self.state_hash
        for tx in txs:
            h = simple_hash_from_two_hashes(h, sha256(tx))
        self.state_hash = h

        self.snapshots[block.index()] = h

        receipts = [it.as_accepted() for it in block.internal_transactions()]
        return CommitResponse(state_hash=self.state_hash, receipts=receipts)

    def snapshot_handler(self, block_index: int) -> bytes:
        """reference: dummy/state.go:101-112."""
        if block_index not in self.snapshots:
            raise KeyError(f"snapshot {block_index} not found")
        return self.snapshots[block_index]

    def restore_handler(self, snapshot: bytes) -> bytes:
        """reference: dummy/state.go:115-121."""
        self.state_hash = snapshot
        return self.state_hash

    def state_change_handler(self, state) -> None:
        """reference: dummy/state.go:124-127."""
        self.babble_state = state
