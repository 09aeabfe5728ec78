"""RPC message types and the request/response envelope.

Reference semantics: src/net/commands.go:12-68 (the four RPC pairs) and
src/net/rpc.go:4-21 (the RPC envelope whose response rides a channel; here
a one-slot queue.Queue).

Each message has a to_dict/from_dict codec so any byte transport (TCP
framing, tests, future ICI sidecar) can carry it as JSON.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto.canonical import PreNormalized
from ..hashgraph.block import Block
from ..hashgraph.event import WireEvent
from ..hashgraph.frame import Frame
from ..hashgraph.internal_transaction import InternalTransaction
from ..peers.peer import Peer

# Wire type tags, one byte on the TCP framing
# (reference: net/net_transport.go:33-50).
SYNC = 0
EAGER_SYNC = 1
FAST_FORWARD = 2
JOIN = 3


@dataclass
class SyncRequest:
    """Pull leg: ask a peer for events we don't know
    (reference: net/commands.go:12-24).

    ``trace`` is the optional wire trace context
    (obs/provenance.py: {"id", "origin", "hop", "ts"-µs}). It rides the
    payload only when present, so peers that predate the field — in
    either direction — interoperate untouched: an old sender simply
    omits it (``from_dict`` yields None, no trace is recorded), and an
    old receiver ignores the unknown key."""

    from_id: int
    known: Dict[int, int]
    sync_limit: int
    trace: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "from_id": self.from_id,
            "known": {str(k): v for k, v in self.known.items()},
            "sync_limit": self.sync_limit,
        }
        if self.trace is not None:
            d["trace"] = self.trace
        return d

    @staticmethod
    def from_dict(d: dict) -> "SyncRequest":
        return SyncRequest(
            from_id=d["from_id"],
            known={int(k): v for k, v in d["known"].items()},
            sync_limit=d["sync_limit"],
            trace=d.get("trace"),
        )


@dataclass
class SyncResponse:
    """reference: net/commands.go:26-32."""

    from_id: int
    events: List[WireEvent] = field(default_factory=list)
    known: Dict[int, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "from_id": self.from_id,
            # memoized normalized form: each event's bytes are b64'd once
            # per process, not once per peer pushed to (event.py normalized)
            "events": [PreNormalized(e.normalized()) for e in self.events],
            "known": {str(k): v for k, v in self.known.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "SyncResponse":
        return SyncResponse(
            from_id=d["from_id"],
            events=[WireEvent.from_dict(e) for e in d["events"]],
            known={int(k): v for k, v in d["known"].items()},
        )


@dataclass
class EagerSyncRequest:
    """Push leg: send a peer the events they don't know
    (reference: net/commands.go:34-40). ``trace`` as on SyncRequest —
    optional on the wire, absent means no causal context."""

    from_id: int
    events: List[WireEvent] = field(default_factory=list)
    trace: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "from_id": self.from_id,
            "events": [PreNormalized(e.normalized()) for e in self.events],
        }
        if self.trace is not None:
            d["trace"] = self.trace
        return d

    @staticmethod
    def from_dict(d: dict) -> "EagerSyncRequest":
        return EagerSyncRequest(
            from_id=d["from_id"],
            events=[WireEvent.from_dict(e) for e in d["events"]],
            trace=d.get("trace"),
        )


@dataclass
class EagerSyncResponse:
    """reference: net/commands.go:42-46."""

    from_id: int
    success: bool

    def to_dict(self) -> dict:
        return {"from_id": self.from_id, "success": self.success}

    @staticmethod
    def from_dict(d: dict) -> "EagerSyncResponse":
        return EagerSyncResponse(from_id=d["from_id"], success=d["success"])


@dataclass
class FastForwardRequest:
    """Catch-up: request the anchor block + frame + app snapshot
    (reference: net/commands.go:48-51). ``trace`` as on SyncRequest."""

    from_id: int
    trace: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"from_id": self.from_id}
        if self.trace is not None:
            d["trace"] = self.trace
        return d

    @staticmethod
    def from_dict(d: dict) -> "FastForwardRequest":
        return FastForwardRequest(
            from_id=d["from_id"], trace=d.get("trace")
        )


@dataclass
class FastForwardResponse:
    """reference: net/commands.go:53-59."""

    from_id: int
    block: Optional[Block] = None
    frame: Optional[Frame] = None
    snapshot: bytes = b""

    def to_dict(self) -> dict:
        return {
            "from_id": self.from_id,
            "block": self.block.to_dict() if self.block else None,
            "frame": self.frame.to_dict() if self.frame else None,
            "snapshot": self.snapshot.hex(),
        }

    @staticmethod
    def from_dict(d: dict) -> "FastForwardResponse":
        return FastForwardResponse(
            from_id=d["from_id"],
            block=Block.from_dict(d["block"]) if d["block"] else None,
            frame=Frame.from_dict(d["frame"]) if d["frame"] else None,
            snapshot=bytes.fromhex(d["snapshot"]),
        )


@dataclass
class JoinRequest:
    """Membership: a signed PEER_ADD internal transaction
    (reference: net/commands.go:61-63)."""

    internal_transaction: InternalTransaction

    def to_dict(self) -> dict:
        return {"internal_transaction": self.internal_transaction.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "JoinRequest":
        return JoinRequest(
            internal_transaction=InternalTransaction.from_dict(
                d["internal_transaction"]
            )
        )


@dataclass
class JoinResponse:
    """reference: net/commands.go:65-68."""

    from_id: int
    accepted: bool
    accepted_round: int
    peers: List[Peer] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "from_id": self.from_id,
            "accepted": self.accepted,
            "accepted_round": self.accepted_round,
            "peers": [p.to_dict() for p in self.peers],
        }

    @staticmethod
    def from_dict(d: dict) -> "JoinResponse":
        return JoinResponse(
            from_id=d["from_id"],
            accepted=d["accepted"],
            accepted_round=d["accepted_round"],
            peers=[Peer.from_dict(p) for p in d["peers"]],
        )


REQUEST_TYPES = {
    SYNC: SyncRequest,
    EAGER_SYNC: EagerSyncRequest,
    FAST_FORWARD: FastForwardRequest,
    JOIN: JoinRequest,
}

RESPONSE_TYPES = {
    SYNC: SyncResponse,
    EAGER_SYNC: EagerSyncResponse,
    FAST_FORWARD: FastForwardResponse,
    JOIN: JoinResponse,
}

TYPE_OF_REQUEST = {v: k for k, v in REQUEST_TYPES.items()}


class RPC:
    """A command plus a one-slot response queue (reference: net/rpc.go:4-21).

    The transport server puts RPCs on the node's consumer queue; the node
    handles them and calls respond(); the server relays the result back to
    the caller.
    """

    def __init__(self, command):
        self.command = command
        # Transport-arrival stamp (epoch seconds, the transport's clock):
        # set by the server loops when they park the RPC on the consumer
        # queue, so the handler can split "wire" from "queue" time in
        # per-hop trace attribution. None when the transport predates it.
        self.recv_ts: Optional[float] = None
        # Event-driven transports (net/atcp.py) set this instead of
        # parking a thread on wait(): respond() invokes it in the
        # handler's thread, so response serialization happens off the
        # transport's event loop.
        self.on_respond: Optional[Callable[[object, Optional[str]], None]] = None
        self._resp: "queue.Queue[Tuple[object, Optional[str]]]" = queue.Queue(1)

    def respond(self, result, error: Optional[str] = None) -> None:
        self._resp.put((result, error))
        cb = self.on_respond
        if cb is not None:
            try:
                cb(result, error)
            except Exception:
                # a dead connection must not crash the node's handler
                pass

    def wait(self, timeout: Optional[float] = None):
        """Block for the handler's response. Returns (result, error_str)."""
        return self._resp.get(timeout=timeout)
