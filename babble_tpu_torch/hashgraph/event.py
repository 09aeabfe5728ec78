"""Event — the fundamental unit of the hashgraph DAG.

Semantics from the reference (cited for parity checks, not copied):
- EventBody fields and hashing: the reference's src/hashgraph/event.go:21-64
- coordinates maps (lastAncestors / firstDescendants): event.go:70-120
- sign/verify incl. internal-transaction signatures: event.go:201-247
- wire format replacing parent hashes with (creatorID, index): event.go:411-449
- FrameEvent wrapper and the two sort orders (topological vs
  Lamport+signature-R consensus order): event.go:457-511

TPU-first notes: the string-keyed coordinate maps here are the *oracle*
representation. The JAX kernels in ``babble_tpu.ops.dag`` consume dense
``[n_events, n_peers] int32`` snapshots of the same data; ``peer_index`` in
:class:`babble_tpu_torch.peers.PeerSet` fixes the tensor coordinate of each peer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from babble_tpu_torch.crypto.canonical import CacheStats, canonical_dumps
from babble_tpu_torch.crypto.hashing import sha256
from babble_tpu_torch.crypto.keys import PrivateKey, PublicKey, decode_signature
from babble_tpu_torch.hashgraph.internal_transaction import InternalTransaction


#: Event.to_wire() memo effectiveness: a hit means a gossip push/reply
#: reused the cached WireEvent instead of rebuilding it (process-wide;
#: surfaced per node via get_stats as wire_cache_hits/misses).
WIRE_CACHE = CacheStats()


def encode_hash(hash_bytes: bytes) -> str:
    """'0X' + uppercase hex (reference: common/hex.go:10-12)."""
    return "0X" + hash_bytes.hex().upper()


def decode_hash(s: str) -> bytes:
    return bytes.fromhex(s[2:])


@dataclass
class EventCoordinates:
    """(hash, index) of an event, used by the stronglySee predicate
    (reference: event.go:70-74)."""

    hash: str
    index: int


@dataclass
class EventBody:
    """Consensus-visible payload of an Event (reference: event.go:21-35).

    The wire-only fields (creator_id, parent indexes) are kept outside the
    canonical encoding, exactly as the reference excludes its private fields
    from JSON marshalling.
    """

    transactions: List[bytes] = field(default_factory=list)
    internal_transactions: List[InternalTransaction] = field(default_factory=list)
    parents: List[str] = field(default_factory=lambda: ["", ""])  # [self, other]
    creator: bytes = b""
    index: int = -1
    block_signatures: List["BlockSignature"] = field(default_factory=list)
    timestamp: int = 0

    # wire info — not part of the canonical encoding (event.go:30-35)
    creator_id: int = 0
    other_parent_creator_id: int = 0
    self_parent_index: int = -1
    other_parent_index: int = -1

    def normalized(self) -> dict:
        """Canonically normalized to_dict (bytes already base64), memoized.
        Frames re-encode every contained event body per decided round
        (frame.hash, Block.from_frame); the consensus-visible body is
        immutable after creation, so each body pays the b64 walk once per
        process instead of once per frame it appears in."""
        from babble_tpu_torch.crypto.canonical import memo_normalized

        return memo_normalized(self, self.to_dict)

    def invalidate_normalized(self) -> None:
        self._norm = None

    def to_dict(self) -> dict:
        return {
            "Transactions": list(self.transactions),
            "InternalTransactions": [t.to_dict() for t in self.internal_transactions],
            "Parents": list(self.parents),
            "Creator": self.creator,
            "Index": self.index,
            "BlockSignatures": [bs.to_dict() for bs in self.block_signatures],
            "Timestamp": self.timestamp,
        }

    def hash(self) -> bytes:
        """SHA256 of the canonical encoding (reference: event.go:57-64).
        Shares the normalized memo with the frame/wire encoders, so the
        b64 walk happens once per body however it is consumed."""
        from babble_tpu_torch.crypto.canonical import PreNormalized

        return sha256(canonical_dumps(PreNormalized(self.normalized())))

    @staticmethod
    def from_dict(d: dict) -> "EventBody":
        from babble_tpu_torch.crypto.canonical import unb64

        def as_bytes(v):
            return unb64(v) if isinstance(v, str) else bytes(v)

        return EventBody(
            transactions=[as_bytes(t) for t in d.get("Transactions") or []],
            internal_transactions=[
                InternalTransaction.from_dict(t)
                for t in d.get("InternalTransactions") or []
            ],
            parents=list(d.get("Parents") or ["", ""]),
            creator=as_bytes(d.get("Creator", b"")),
            index=d.get("Index", -1),
            block_signatures=[
                BlockSignature.from_dict(b) for b in d.get("BlockSignatures") or []
            ],
            timestamp=d.get("Timestamp", 0),
        )


@dataclass
class BlockSignature:
    """A validator's signature over a block body (reference: block.go:59-66)."""

    validator: bytes  # signer's public key
    index: int  # block index
    signature: str  # base-36 "r|s" encoding

    def validator_hex(self) -> str:
        return encode_hash(self.validator)

    def key(self) -> str:
        """Storage key '<index>-<validator hex>' (reference: block.go:104-106)."""
        return f"{self.index}-{self.validator_hex()}"

    def to_wire(self) -> "WireBlockSignature":
        return WireBlockSignature(index=self.index, signature=self.signature)

    def to_dict(self) -> dict:
        return {
            "Validator": self.validator,
            "Index": self.index,
            "Signature": self.signature,
        }

    @staticmethod
    def from_dict(d: dict) -> "BlockSignature":
        from babble_tpu_torch.crypto.canonical import unb64

        v = d["Validator"]
        return BlockSignature(
            validator=unb64(v) if isinstance(v, str) else bytes(v),
            index=d["Index"],
            signature=d["Signature"],
        )


@dataclass
class WireBlockSignature:
    """Signature as it travels in a WireEvent (reference: block.go:110-113)."""

    index: int
    signature: str

    def to_dict(self) -> dict:
        return {"Index": self.index, "Signature": self.signature}

    @staticmethod
    def from_dict(d: dict) -> "WireBlockSignature":
        return WireBlockSignature(index=d["Index"], signature=d["Signature"])


class Event:
    """EventBody + creator signature + local-only consensus annotations
    (reference: event.go:102-142)."""

    __slots__ = (
        "body",
        "signature",
        "topological_index",
        "round",
        "lamport_timestamp",
        "round_received",
        "last_ancestors",
        "first_descendants",
        "_creator",
        "_hash",
        "_hex",
        "_sig_ok",
        "_wire",
    )

    def __init__(self, body: EventBody, signature: str = ""):
        self.body = body
        self.signature = signature
        self.topological_index: int = -1
        self.round: Optional[int] = None
        self.lamport_timestamp: Optional[int] = None
        self.round_received: Optional[int] = None
        self.last_ancestors: Dict[str, EventCoordinates] = {}
        self.first_descendants: Dict[str, EventCoordinates] = {}
        self._creator: str = ""
        self._hash: bytes = b""
        self._hex: str = ""
        self._sig_ok: Optional[bool] = None
        self._wire: Optional["WireEvent"] = None

    @staticmethod
    def new(
        transactions: List[bytes],
        internal_transactions: List[InternalTransaction],
        block_signatures: List[BlockSignature],
        parents: List[str],
        creator: bytes,
        index: int,
        timestamp: int = 0,
    ) -> "Event":
        """reference: event.go:123-142 (timestamp is explicit, not wall-clock,
        so DAG fixtures are deterministic)."""
        return Event(
            EventBody(
                transactions=list(transactions),
                internal_transactions=list(internal_transactions),
                block_signatures=list(block_signatures),
                parents=list(parents),
                creator=creator,
                index=index,
                timestamp=timestamp,
            )
        )

    # -- identity ----------------------------------------------------------

    def creator(self) -> str:
        if not self._creator:
            self._creator = encode_hash(self.body.creator)
        return self._creator

    def self_parent(self) -> str:
        return self.body.parents[0]

    def other_parent(self) -> str:
        return self.body.parents[1]

    def index(self) -> int:
        return self.body.index

    def timestamp(self) -> int:
        return self.body.timestamp

    def transactions(self) -> List[bytes]:
        return self.body.transactions

    def internal_transactions(self) -> List[InternalTransaction]:
        return self.body.internal_transactions

    def block_signatures(self) -> List[BlockSignature]:
        return self.body.block_signatures

    def is_loaded(self) -> bool:
        """True if the event carries a payload or is its creator's first event
        (reference: event.go:189-198)."""
        if self.body.index == 0:
            return True
        return bool(self.body.transactions) or bool(self.body.internal_transactions)

    def hash(self) -> bytes:
        if not self._hash:
            self._hash = self.body.hash()
        return self._hash

    def hex(self) -> str:
        if not self._hex:
            self._hex = encode_hash(self.hash())
        return self._hex

    def invalidate_hash(self) -> None:
        """Drop cached identity after mutating the body (test fixtures only)."""
        self._hash = b""
        self._hex = ""
        self._creator = ""
        self._sig_ok = None
        self._wire = None
        self.body.invalidate_normalized()

    # -- signatures --------------------------------------------------------

    def sign(self, key: PrivateKey) -> None:
        """reference: event.go:201-215."""
        self.signature = key.sign(self.hash())
        self._wire = None  # wire form carries the signature

    def verify(self) -> bool:
        """Verify the creator's signature AND every internal transaction's
        signature (reference: event.go:219-247).

        If the event was prevalidated through a batch verifier
        (babble_tpu_torch.crypto.batch.prevalidate_events_host, or on the
        card babble_tpu_torch.ops.verify.prevalidate_events), the cached
        verdict is returned without re-doing host-side ECDSA."""
        if self._sig_ok is not None:
            return self._sig_ok
        for itx in self.body.internal_transactions:
            if not itx.verify():
                return False
        try:
            pub = PublicKey.from_bytes(self.body.creator)
        except Exception:
            return False
        return pub.verify(self.hash(), self.signature)

    def prevalidate(self, ok: bool) -> None:
        """Cache a signature verdict computed out-of-band (batch path)."""
        self._sig_ok = bool(ok)

    def prevalidated(self) -> Optional[bool]:
        """The cached batch verdict, or None if never batch-verified."""
        return self._sig_ok

    def clear_prevalidation(self) -> None:
        """Drop the cached verdict so verify() re-runs the scalar path —
        the batch-failure fallback uses this to pinpoint offenders."""
        self._sig_ok = None

    # -- consensus annotations --------------------------------------------

    def set_round(self, r: int) -> None:
        self.round = r

    def set_lamport_timestamp(self, t: int) -> None:
        self.lamport_timestamp = t

    def set_round_received(self, rr: int) -> None:
        self.round_received = rr

    def set_wire_info(
        self,
        self_parent_index: int,
        other_parent_creator_id: int,
        other_parent_index: int,
        creator_id: int,
    ) -> None:
        """reference: event.go:363-371."""
        self.body.self_parent_index = self_parent_index
        self.body.other_parent_creator_id = other_parent_creator_id
        self.body.other_parent_index = other_parent_index
        self.body.creator_id = creator_id
        self._wire = None  # wire form depends on the ids set here

    # -- wire --------------------------------------------------------------

    def wire_block_signatures(self) -> List[WireBlockSignature]:
        return [bs.to_wire() for bs in self.body.block_signatures]

    def to_wire(self) -> "WireEvent":
        """reference: event.go:390-405.

        Cached: the same immutable event is pushed to many peers, and the
        shared WireEvent also memoizes its normalized (base64-applied)
        encoding, so per-transaction b64 work happens once per event
        instead of once per send (set_wire_info invalidates)."""
        if self._wire is not None:
            WIRE_CACHE.hits += 1
            return self._wire
        WIRE_CACHE.misses += 1
        self._wire = WireEvent(
            body=WireBody(
                transactions=list(self.body.transactions),
                internal_transactions=list(self.body.internal_transactions),
                block_signatures=self.wire_block_signatures(),
                creator_id=self.body.creator_id,
                other_parent_creator_id=self.body.other_parent_creator_id,
                index=self.body.index,
                self_parent_index=self.body.self_parent_index,
                other_parent_index=self.body.other_parent_index,
                timestamp=self.body.timestamp,
            ),
            signature=self.signature,
        )
        return self._wire

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Event({self.creator()[:10]}:{self.index()} {self.hex()[:10]})"


@dataclass
class WireBody:
    """Light-weight event body: parent hashes replaced by
    (creatorID, index) pairs (reference: event.go:413-423)."""

    transactions: List[bytes] = field(default_factory=list)
    internal_transactions: List[InternalTransaction] = field(default_factory=list)
    block_signatures: List[WireBlockSignature] = field(default_factory=list)
    creator_id: int = 0
    other_parent_creator_id: int = 0
    index: int = -1
    self_parent_index: int = -1
    other_parent_index: int = -1
    timestamp: int = 0

    def to_dict(self) -> dict:
        return {
            "Transactions": list(self.transactions),
            "InternalTransactions": [t.to_dict() for t in self.internal_transactions],
            "BlockSignatures": [b.to_dict() for b in self.block_signatures],
            "CreatorID": self.creator_id,
            "OtherParentCreatorID": self.other_parent_creator_id,
            "Index": self.index,
            "SelfParentIndex": self.self_parent_index,
            "OtherParentIndex": self.other_parent_index,
            "Timestamp": self.timestamp,
        }

    @staticmethod
    def from_dict(d: dict) -> "WireBody":
        from babble_tpu_torch.crypto.canonical import unb64

        def as_bytes(v):
            return unb64(v) if isinstance(v, str) else bytes(v)

        return WireBody(
            transactions=[as_bytes(t) for t in d.get("Transactions") or []],
            internal_transactions=[
                InternalTransaction.from_dict(t)
                for t in d.get("InternalTransactions") or []
            ],
            block_signatures=[
                WireBlockSignature.from_dict(b) for b in d.get("BlockSignatures") or []
            ],
            creator_id=d.get("CreatorID", 0),
            other_parent_creator_id=d.get("OtherParentCreatorID", 0),
            index=d.get("Index", -1),
            self_parent_index=d.get("SelfParentIndex", -1),
            other_parent_index=d.get("OtherParentIndex", -1),
            timestamp=d.get("Timestamp", 0),
        )


@dataclass
class WireEvent:
    """reference: event.go:427-430."""

    body: WireBody
    signature: str = ""

    def block_signatures(self, validator: bytes) -> List[BlockSignature]:
        """Unpack wire signatures, attributing them to the event's creator
        (reference: event.go:433-449)."""
        return [
            BlockSignature(validator=validator, index=bs.index, signature=bs.signature)
            for bs in self.body.block_signatures
        ]

    def to_dict(self) -> dict:
        return {"Body": self.body.to_dict(), "Signature": self.signature}

    def normalized(self) -> dict:
        """Canonically normalized to_dict (bytes already base64), memoized:
        Event.to_wire shares one WireEvent per event, so each event's
        transactions are b64-encoded once total rather than once per peer
        it is pushed to."""
        from babble_tpu_torch.crypto.canonical import memo_normalized

        return memo_normalized(self, self.to_dict)

    @staticmethod
    def from_dict(d: dict) -> "WireEvent":
        return WireEvent(
            body=WireBody.from_dict(d["Body"]), signature=d.get("Signature", "")
        )


@dataclass
class FrameEvent:
    """Event + its consensus annotations, as shipped in Frames
    (reference: event.go:457-462)."""

    core: Event
    round: int = 0
    lamport_timestamp: int = 0
    witness: bool = False

    def to_dict(self) -> dict:
        from babble_tpu_torch.crypto.canonical import PreNormalized

        return {
            # memoized normalized body: frames re-encode the same immutable
            # event bodies per decided round (see EventBody.normalized)
            "Core": {
                "Body": PreNormalized(self.core.body.normalized()),
                "Signature": self.core.signature,
            },
            "Round": self.round,
            "LamportTimestamp": self.lamport_timestamp,
            "Witness": self.witness,
        }

    @staticmethod
    def from_dict(d: dict) -> "FrameEvent":
        from babble_tpu_torch.crypto.canonical import PreNormalized

        body = d["Core"]["Body"]
        if isinstance(body, PreNormalized):
            # in-process round trip of a to_dict (no codec in between)
            body = body.value
        core = Event(
            EventBody.from_dict(body),
            signature=d["Core"].get("Signature", ""),
        )
        return FrameEvent(
            core=core,
            round=d["Round"],
            lamport_timestamp=d["LamportTimestamp"],
            witness=d["Witness"],
        )


def sort_topological(events: List[Event]) -> List[Event]:
    """Local (per-node) insertion order (reference: event.go:479-490)."""
    return sorted(events, key=lambda e: e.topological_index)


def _signature_r(e: Event) -> int:
    try:
        r, _ = decode_signature(e.signature)
        return r
    except ValueError:
        return 0


def sort_frame_events(events: List[FrameEvent]) -> List[FrameEvent]:
    """Consensus total order: Lamport timestamp, ties broken by the
    signature's R value (reference: event.go:494-511)."""
    return sorted(
        events, key=lambda fe: (fe.lamport_timestamp, _signature_r(fe.core))
    )
