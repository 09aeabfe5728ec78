"""Mempool subsystem: the bounded, deduplicating transaction pool that
owns every client transaction between app submission and self-event
creation (docs/mempool.md).

Hashgraph itself has no admission story — the reference drains an
unbounded submit channel into an unbounded slice. This package supplies
the missing layer: capacity caps in count and bytes, duplicate
suppression against both pending entries and recently-committed hashes,
FIFO batch drain with per-self-event caps, a token-bucket rate limiter,
and an explicit admission verdict plumbed end-to-end.
"""

from .mempool import (
    ACCEPTED,
    ALREADY_COMMITTED,
    DUPLICATE,
    FULL,
    Mempool,
    OVERSIZED,
    THROTTLED,
    VERDICTS,
)
from .ratelimit import TokenBucket

__all__ = [
    "Mempool",
    "TokenBucket",
    "ACCEPTED",
    "DUPLICATE",
    "ALREADY_COMMITTED",
    "FULL",
    "THROTTLED",
    "OVERSIZED",
    "VERDICTS",
]
