"""Join promise: async response plumbing for membership requests
(reference: src/node/promise.go:9-35)."""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import List

from ..hashgraph.internal_transaction import InternalTransaction
from ..peers.peer import Peer


@dataclass
class JoinPromiseResponse:
    accepted: bool
    accepted_round: int
    peers: List[Peer] = field(default_factory=list)


class JoinPromise:
    def __init__(self, tx: InternalTransaction):
        self.tx = tx
        self._resp: "queue.Queue[JoinPromiseResponse]" = queue.Queue(1)

    def respond(self, accepted: bool, accepted_round: int, peers: List[Peer]) -> None:
        self._resp.put(JoinPromiseResponse(accepted, accepted_round, peers))

    def wait(self, timeout: float) -> JoinPromiseResponse:
        """Block until consensus decides the transaction; raises queue.Empty
        on timeout."""
        return self._resp.get(timeout=timeout)
