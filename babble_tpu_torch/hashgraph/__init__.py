"""Hashgraph consensus core — data model, store, and engine.

Reference parity map: src/hashgraph/ (event.go, block.go, frame.go, root.go,
roundInfo.go, internal_transaction.go, caches.go, store.go, inmem_store.go,
hashgraph.go). The engine here is the CPU oracle; the device sweep that
takes over fame and round-received lives in babble_tpu_torch.hashgraph.accel.
"""

from babble_tpu_torch.hashgraph.block import Block, BlockBody
from babble_tpu_torch.hashgraph.caches import (
    ParticipantEventsCache,
    PeerSetCache,
    PendingRound,
    PendingRoundsCache,
    SigPool,
)
from babble_tpu_torch.hashgraph.errors import (
    ForkError,
    HashgraphError,
    InvalidSignatureError,
    SelfParentError,
    UnknownParentError,
    UnknownParticipantError,
    classify_rejection,
    is_normal_self_parent_error,
)
from babble_tpu_torch.hashgraph.event import (
    BlockSignature,
    Event,
    EventBody,
    EventCoordinates,
    FrameEvent,
    WireBlockSignature,
    WireBody,
    WireEvent,
    decode_hash,
    encode_hash,
    sort_frame_events,
    sort_topological,
)
from babble_tpu_torch.hashgraph.frame import Frame, Root
from babble_tpu_torch.hashgraph.hashgraph import (
    COIN_ROUND_FREQ,
    ROOT_DEPTH,
    Hashgraph,
    dummy_commit_callback,
    middle_bit,
)
from babble_tpu_torch.hashgraph.internal_transaction import (
    InternalTransaction,
    InternalTransactionBody,
    InternalTransactionReceipt,
    TransactionType,
)
from babble_tpu_torch.hashgraph.round_info import RoundEvent, RoundInfo
from babble_tpu_torch.hashgraph.persistent_store import PersistentStore
from babble_tpu_torch.hashgraph.store import InmemStore, Store

__all__ = [
    "Block",
    "BlockBody",
    "BlockSignature",
    "COIN_ROUND_FREQ",
    "Event",
    "EventBody",
    "EventCoordinates",
    "Frame",
    "FrameEvent",
    "Hashgraph",
    "InmemStore",
    "InternalTransaction",
    "InternalTransactionBody",
    "InternalTransactionReceipt",
    "ParticipantEventsCache",
    "PeerSetCache",
    "PendingRound",
    "PendingRoundsCache",
    "PersistentStore",
    "ROOT_DEPTH",
    "Root",
    "RoundEvent",
    "RoundInfo",
    "SelfParentError",
    "ForkError",
    "HashgraphError",
    "InvalidSignatureError",
    "UnknownParentError",
    "UnknownParticipantError",
    "classify_rejection",
    "SigPool",
    "Store",
    "TransactionType",
    "WireBlockSignature",
    "WireBody",
    "WireEvent",
    "decode_hash",
    "dummy_commit_callback",
    "encode_hash",
    "is_normal_self_parent_error",
    "middle_bit",
    "sort_frame_events",
    "sort_topological",
]
