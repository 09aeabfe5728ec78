"""Bounded dedup transaction pool with admission control and shedding.

Every client transaction passes through ``Mempool.submit`` and receives
an explicit verdict (the admission state machine, docs/mempool.md):

    oversized → duplicate / already_committed → throttled → full → accepted

Dedup is checked before the token bucket so retries of known
transactions cost no tokens and get a precise answer; capacity is
checked last so an evict-oldest pool never evicts to make room for a
transaction the dedup layer would have refused anyway.

Lifecycle of an accepted transaction:

    pending ──drain──▶ in-flight ──commit──▶ committed-hash LRU
       ▲                  │
       └─────requeue──────┘   (event creation failed)

``pending`` holds the bytes (FIFO, capped in count and bytes);
``in-flight`` holds only hashes of drained-but-uncommitted transactions
(their bytes live in the self-event) so a client retry during the
commit window is still a ``duplicate``; the committed LRU turns a retry
of a committed transaction into ``already_committed`` instead of a
second commit. All state transitions happen under ONE internal lock —
never the node's core lock — so admission stays race-clean and cheap
while consensus holds the core lock for inserts.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..common.lru import LRU
from ..common.timed_lock import named_lock
from ..crypto.hashing import sha256
from .ratelimit import TokenBucket

# Admission verdicts (wire values: SubmitTx returns these strings).
ACCEPTED = "accepted"
DUPLICATE = "duplicate"
ALREADY_COMMITTED = "already_committed"
FULL = "full"
THROTTLED = "throttled"
OVERSIZED = "oversized"
VERDICTS = frozenset(
    {ACCEPTED, DUPLICATE, ALREADY_COMMITTED, FULL, THROTTLED, OVERSIZED}
)

# Overflow policies.
POLICY_REJECT = "reject"
POLICY_EVICT_OLDEST = "evict-oldest"
_POLICIES = (POLICY_REJECT, POLICY_EVICT_OLDEST)


class Mempool:
    """Bounded dedup pool between app submission and self-event creation."""

    def __init__(
        self,
        max_txs: int = 20000,
        max_bytes: int = 32 * 1024 * 1024,
        overflow: str = POLICY_REJECT,
        event_max_txs: int = 1024,
        event_max_bytes: int = 1024 * 1024,
        committed_lru: int = 65536,
        rate_tx_s: float = 0.0,
        burst: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_txs <= 0 or max_bytes <= 0:
            raise ValueError("mempool caps must be positive")
        if event_max_txs <= 0 or event_max_bytes <= 0:
            raise ValueError("mempool event caps must be positive")
        if overflow not in _POLICIES:
            raise ValueError(
                f"unknown mempool overflow policy {overflow!r}; "
                f"expected one of {_POLICIES}"
            )
        self.max_txs = max_txs
        self.max_bytes = max_bytes
        self.overflow = overflow
        self.event_max_txs = event_max_txs
        self.event_max_bytes = event_max_bytes
        self._clock = clock
        # Named for the BABBLE_LOCKCHECK acquisition-order recorder
        # (common/lockcheck.py): Core drains/requeues under the core
        # lock, so the core->mempool edge is part of the audited model;
        # a raw C lock when the recorder is off (hot admission path).
        self._lock = named_lock("mempool")
        # Commit-latency telemetry (attach_telemetry): per-hash admit and
        # drain timestamps feed commit_latency_seconds and the
        # tx_stage_seconds{mempool_wait,consensus} histograms. The dicts
        # are bounded by construction — keys are a subset of
        # pending ∪ in-flight, both capped — and stay EMPTY (zero
        # overhead) until telemetry is attached.
        self._lat_commit = None
        self._lat_wait = None
        self._lat_consensus = None
        # Commit-provenance table (attach_provenance): admit/drain
        # stamps for the cross-node trace merge; None until attached.
        self._prov = None
        self._admit_ts: Dict[bytes, float] = {}
        self._drain_ts: Dict[bytes, float] = {}
        self._pending: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._pending_bytes = 0
        # Drained-but-uncommitted hashes (bytes already live in the
        # self-event). Bounded: consensus normally retires entries at
        # commit, but a stalled cluster must not grow this without limit
        # — the oldest hashes age out (narrowing the dedup window, never
        # growing memory).
        self._inflight: "OrderedDict[bytes, int]" = OrderedDict()
        self._inflight_cap = max(4 * max_txs, 4096)
        self._committed = LRU(committed_lru) if committed_lru > 0 else None
        self._bucket = (
            TokenBucket(rate_tx_s, burst, clock) if rate_tx_s > 0 else None
        )
        # Counters (surfaced as mempool_* via Node.get_stats and /mempool).
        self.submitted = 0
        self.accepted = 0
        self.rejected_full = 0
        self.rejected_dup = 0
        self.rejected_oversized = 0
        self.rejected_throttled = 0
        self.committed_dedup_hits = 0
        self.evictions = 0
        self.requeued = 0
        self.commit_drops = 0
        self.committed_total = 0
        # In-flight hashes aged out past the cap (each narrows the dedup
        # window for one drained-but-uncommitted tx; nonzero only when
        # consensus lags drains by > _inflight_cap transactions).
        self.inflight_aged = 0

    @classmethod
    def from_config(cls, conf) -> "Mempool":
        """Build from a ``Config`` (mempool_* knobs + the node clock, so
        simulated nodes rate-limit and stamp latencies in virtual time)."""
        return cls(
            clock=conf.clock.monotonic,
            max_txs=conf.mempool_max_txs,
            max_bytes=conf.mempool_max_bytes,
            overflow=conf.mempool_overflow,
            event_max_txs=conf.mempool_event_max_txs,
            event_max_bytes=conf.mempool_event_max_bytes,
            committed_lru=conf.mempool_committed_lru,
            rate_tx_s=conf.mempool_rate,
            burst=conf.mempool_burst,
        )

    def attach_telemetry(self, commit_latency, tx_wait, tx_consensus) -> None:
        """Arm the latency histograms (obs.telemetry wiring): from here
        on accepted transactions are timestamped at admit and drain, and
        ``mark_committed`` observes admit→commit into ``commit_latency``
        plus the mempool_wait / consensus stage splits."""
        self._lat_commit = commit_latency
        self._lat_wait = tx_wait
        self._lat_consensus = tx_consensus

    def attach_provenance(self, prov) -> None:
        """Arm per-transaction commit provenance (obs/provenance.py):
        sampled admissions and first drains get origin-side stamps. The
        table applies its own sampling and no-ops when disabled."""
        self._prov = prov

    # -- admission ----------------------------------------------------------

    def submit(self, tx: bytes) -> str:
        """Admit one transaction; returns a verdict string (VERDICTS)."""
        tx = bytes(tx)
        size = len(tx)
        if size > self.event_max_bytes or size > self.max_bytes:
            # could never fit a self-event (or the pool): permanent reject
            with self._lock:
                self.submitted += 1
                self.rejected_oversized += 1
            return OVERSIZED
        h = sha256(tx)
        with self._lock:
            self.submitted += 1
            if h in self._pending or h in self._inflight:
                self.rejected_dup += 1
                return DUPLICATE
            if self._committed is not None and self._committed.peek(h)[1]:
                self.committed_dedup_hits += 1
                return ALREADY_COMMITTED
            if self._bucket is not None and not self._bucket.try_acquire():
                self.rejected_throttled += 1
                return THROTTLED
            while (
                len(self._pending) >= self.max_txs
                or self._pending_bytes + size > self.max_bytes
            ):
                if self.overflow != POLICY_EVICT_OLDEST or not self._pending:
                    self.rejected_full += 1
                    return FULL
                old_h, old = self._pending.popitem(last=False)
                self._pending_bytes -= len(old)
                self._admit_ts.pop(old_h, None)
                # a requeued tx back in pending can carry a drain stamp
                self._drain_ts.pop(old_h, None)
                self.evictions += 1
            self._pending[h] = tx
            self._pending_bytes += size
            self.accepted += 1
            if self._lat_commit is not None:
                self._admit_ts[h] = self._clock()
            if self._prov is not None:
                self._prov.admit(tx)
            return ACCEPTED

    def submit_many(self, txs) -> List[str]:
        return [self.submit(tx) for tx in txs]

    # -- drain / requeue ----------------------------------------------------

    def drain(self) -> List[bytes]:
        """Pop up to ``event_max_txs`` / ``event_max_bytes`` of pending
        transactions in FIFO order for one self-event. Drained hashes
        move to the in-flight set until committed (or requeued)."""
        out: List[bytes] = []
        nbytes = 0
        with self._lock:
            now = self._clock() if self._lat_commit is not None else 0.0
            while self._pending and len(out) < self.event_max_txs:
                h, tx = next(iter(self._pending.items()))
                if out and nbytes + len(tx) > self.event_max_bytes:
                    break
                del self._pending[h]
                self._pending_bytes -= len(tx)
                out.append(tx)
                nbytes += len(tx)
                self._inflight[h] = len(tx)
                ts = self._admit_ts.get(h)
                if ts is not None and h not in self._drain_ts:
                    # first drain only: a requeued tx keeps its original
                    # drain stamp, so mempool_wait gets exactly ONE
                    # sample per tx (admit → first drain) and its count
                    # matches commit_latency_seconds
                    self._drain_ts[h] = now
                    self._lat_wait.observe(now - ts)
                if self._prov is not None:
                    # provenance drain stamp (the table keeps the first)
                    self._prov.drain(tx)
            while len(self._inflight) > self._inflight_cap:
                aged_h, _ = self._inflight.popitem(last=False)
                self._admit_ts.pop(aged_h, None)
                self._drain_ts.pop(aged_h, None)
                self.inflight_aged += 1
        return out

    def requeue(self, txs: List[bytes]) -> None:
        """Put a drained batch back at the FRONT of the pool (FIFO order
        preserved) after a failed event creation. Entries committed in
        the meantime (the tx arrived via another peer's event) are
        skipped. Accepted transactions are never dropped here, so a
        requeue may transiently push pending above the admission cap."""
        with self._lock:
            for tx in reversed(txs):
                h = sha256(tx)
                self._inflight.pop(h, None)
                # back to pending: BOTH timestamps survive — the client
                # has been waiting the whole time, and keeping the
                # first-drain stamp makes the consensus stage cover
                # first drain → commit (requeue interludes included)
                # without re-observing mempool_wait on the next drain
                if self._committed is not None and self._committed.peek(h)[1]:
                    self._admit_ts.pop(h, None)
                    self._drain_ts.pop(h, None)
                    continue
                if h in self._pending:
                    continue
                self._pending[h] = tx
                self._pending.move_to_end(h, last=False)
                self._pending_bytes += len(tx)
                self.requeued += 1

    # -- commit feed --------------------------------------------------------

    def mark_committed(self, txs) -> None:
        """Record committed transaction hashes (called from the node's
        commit path, under THIS lock — atomically with the pending/
        in-flight cleanup — so a client retry racing the commit can
        never be admitted a second time). Pending copies of a now-
        committed transaction (submitted to several nodes, committed via
        another's event) are dropped before they can double-commit."""
        with self._lock:
            now = self._clock() if self._lat_commit is not None else 0.0
            for tx in txs:
                h = sha256(bytes(tx))
                self.committed_total += 1
                if self._committed is not None:
                    self._committed.add(h, True)
                self._inflight.pop(h, None)
                old = self._pending.pop(h, None)
                if old is not None:
                    self._pending_bytes -= len(old)
                    self.commit_drops += 1
                ts = self._admit_ts.pop(h, None)
                dts = self._drain_ts.pop(h, None)
                if ts is not None:
                    # end-to-end north-star latency: admit → block commit
                    # (only for txs THIS node admitted; gossip-received
                    # txs have no local admit time)
                    self._lat_commit.observe(now - ts)
                    if dts is not None:
                        self._lat_consensus.observe(now - dts)

    # -- views --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def pending_bytes(self) -> int:
        return self._pending_bytes

    def pending_txs(self) -> List[bytes]:
        """Snapshot of pending transaction bytes in FIFO order."""
        with self._lock:
            return list(self._pending.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "pending_bytes": self._pending_bytes,
                "in_flight": len(self._inflight),
                "submitted": self.submitted,
                "accepted": self.accepted,
                "rejected_full": self.rejected_full,
                "rejected_dup": self.rejected_dup,
                "rejected_oversized": self.rejected_oversized,
                "rejected_throttled": self.rejected_throttled,
                "committed_dedup_hits": self.committed_dedup_hits,
                "evictions": self.evictions,
                "requeued": self.requeued,
                "commit_drops": self.commit_drops,
                "committed_total": self.committed_total,
                "inflight_aged": self.inflight_aged,
            }

    def config(self) -> Dict[str, object]:
        return {
            "max_txs": self.max_txs,
            "max_bytes": self.max_bytes,
            "overflow": self.overflow,
            "event_max_txs": self.event_max_txs,
            "event_max_bytes": self.event_max_bytes,
            "committed_lru": (
                self._committed.size if self._committed is not None else 0
            ),
            "rate_tx_s": self._bucket.rate if self._bucket is not None else 0.0,
            "burst": self._bucket.burst if self._bucket is not None else 0.0,
        }
