"""Per-transaction commit provenance: the cross-node causal-tracing
substrate (docs/observability.md §"Causal tracing").

Two pieces live here:

- the **wire trace context** helpers: a compact dict
  ``{"id": str, "origin": int, "hop": int, "ts": int-µs}`` carried on
  ``Sync``/``EagerSync``/``FastForward`` requests (``net/rpc.py``
  serializes it only when present, so peers that predate the field
  interoperate untouched). ``ts`` is integer microseconds since the
  sender's epoch clock — the canonical wire codec rejects floats, and
  µs resolution is far below cross-host clock skew anyway.

- the **ProvenanceTable**: a bounded per-node table keyed by tx hash
  recording where a transaction's latency went *on this node* — admit
  (mempool admission), drain (packaged into a self-event; origin node
  only), first_seen (first inserted via gossip, with wire/queue/insert
  attribution against the carrying sync's context), and commit (block
  index + round received). ``obs/traceview.py`` merges several nodes'
  exports into one cross-node timeline.

Sampling is **deterministic across nodes** — every node must trace the
SAME transactions or the merge shows partial hops. The filter is
``crc32(tx) % inverse == 0`` (cheap, byte-stable, no dependence on the
sha256 the hot ingest path would otherwise have to pay per tx just to
decide "not sampled"); clients (``demo/bombard.py --trace``) apply the
same filter to know which of their submissions are traceable.

Timestamps come from the owning node's ``Config.clock`` (``clock.time``)
— NEVER wall time directly — so simulated runs produce byte-identical
provenance for the same seed (docs/simulation.md), and live nodes stamp
comparable epoch seconds. Cross-host merges inherit host clock skew;
traceview orders hops by first-seen time, which survives modest skew.

``BABBLE_OBS=0`` (or ``sample=0``) disables the table entirely: call
sites gate on ``prov.enabled`` before touching transaction bytes.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

from ..config.config import (
    DEFAULT_TRACE_SAMPLE,
    DEFAULT_TRACE_TABLE_CAP,
)
from ..crypto.hashing import sha256

#: default sampling rate — 1 in 64 transactions. Low enough that the
#: crc+sha cost disappears under the signature-verify budget, high
#: enough that any sustained workload populates the table. Value lives
#: in config.py (single source shared with the Config knobs).
DEFAULT_SAMPLE = DEFAULT_TRACE_SAMPLE
DEFAULT_CAP = DEFAULT_TRACE_TABLE_CAP

_CTX_ID_MAX = 64  # hostile peers must not park megabytes in our table


def make_ctx(trace_id: str, origin: int, ts_s: float, hop: int = 0) -> dict:
    """Build a wire trace context. ``ts_s`` is the sender's epoch clock
    in float seconds; the wire carries integer microseconds."""
    return {
        "id": str(trace_id)[:_CTX_ID_MAX],
        "origin": int(origin),
        "hop": int(hop),
        "ts": int(ts_s * 1e6),
    }


def parse_ctx(d) -> Optional[dict]:
    """Validate a received trace context; anything malformed degrades to
    None (no trace recorded, nothing rejected — the compat contract)."""
    if not isinstance(d, dict):
        return None
    try:
        return {
            "id": str(d["id"])[:_CTX_ID_MAX],
            "origin": int(d.get("origin", -1)),
            "hop": int(d.get("hop", 0)),
            "ts": int(d["ts"]),
        }
    except (KeyError, TypeError, ValueError):
        return None


def ctx_ts_s(ctx: dict) -> float:
    return ctx["ts"] / 1e6


def sample_inverse(sample: float) -> int:
    """Sampling rate -> crc modulus. <=0 disables (returns 0)."""
    if sample <= 0:
        return 0
    if sample >= 1:
        return 1
    return max(1, int(round(1.0 / sample)))


def tx_sampled(tx: bytes, inverse: int) -> bool:
    """The cross-node sampling law. ``inverse`` from sample_inverse()."""
    if inverse <= 0:
        return False
    if inverse == 1:
        return True
    return zlib.crc32(tx) % inverse == 0


class ProvenanceTable:
    """Bounded per-node provenance records, keyed by tx sha256 hex.

    All mutators take the table's own lock (callers already hold the
    mempool or core lock; this lock nests strictly inside both and is
    never held while calling out). Records are plain dicts so export is
    a shallow copy.
    """

    def __init__(self, clock=None, sample: float = DEFAULT_SAMPLE,
                 cap: int = DEFAULT_CAP, enabled: bool = True):
        if clock is None:
            from ..common.clock import WALL

            clock = WALL
        self._clock = clock
        self._lock = threading.Lock()
        self._recs: "OrderedDict[str, dict]" = OrderedDict()
        self.sample = sample
        self._inv = sample_inverse(sample)
        self.cap = max(1, cap)
        self._on = enabled
        # counters (obs catalog: trace_*)
        self.sampled_total = 0
        self.evictions = 0

    # -- knobs ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._on and self._inv > 0

    def configure(self, sample: Optional[float] = None,
                  cap: Optional[int] = None) -> None:
        """Apply Config knobs (Node.__init__ — the table is built by
        NodeTelemetry before the Config is in reach)."""
        with self._lock:
            if sample is not None:
                self.sample = sample
                self._inv = sample_inverse(sample)
            if cap is not None:
                self.cap = max(1, cap)

    def should_trace(self, tx: bytes) -> bool:
        return tx_sampled(tx, self._inv)

    # -- record plumbing -----------------------------------------------------

    def _rec(self, txid: str) -> dict:
        rec = self._recs.get(txid)
        if rec is None:
            rec = {"txid": txid}
            self._recs[txid] = rec
            self.sampled_total += 1
            while len(self._recs) > self.cap:
                self._recs.popitem(last=False)
                self.evictions += 1
        return rec

    # -- stamps --------------------------------------------------------------

    def admit(self, tx: bytes) -> None:
        """Mempool admission on the ORIGIN node."""
        if not self.enabled or not tx_sampled(tx, self._inv):
            return
        now = self._clock.time()
        txid = sha256(tx).hex()
        with self._lock:
            rec = self._rec(txid)
            rec.setdefault("admit", now)

    def drain(self, tx: bytes) -> None:
        """Packaged into a self-event (origin node; first drain wins —
        a requeued tx keeps its original stamp)."""
        if not self.enabled or not tx_sampled(tx, self._inv):
            return
        now = self._clock.time()
        txid = sha256(tx).hex()
        with self._lock:
            rec = self._rec(txid)
            rec.setdefault("drain", now)

    def first_seen_batch(self, txs, hop: Optional[dict]) -> None:
        """One inserted gossip event's transactions: stamp this node's
        first sight of each sampled tx, with per-hop attribution from
        the carrying sync's ``hop`` info (``{"from", "ctx", "recv",
        "start"}`` — see Core.sync)."""
        if not self.enabled:
            return
        inv = self._inv
        sampled = [tx for tx in txs if tx_sampled(tx, inv)]
        if not sampled:
            return
        now = self._clock.time()
        hop = hop or {}
        ctx = hop.get("ctx")
        recv = hop.get("recv")
        start = hop.get("start")
        with self._lock:
            for tx in sampled:
                rec = self._rec(sha256(tx).hex())
                if "first_seen" in rec or "drain" in rec:
                    # first sight wins; locally-drained txs were never a
                    # gossip hop on this node
                    continue
                rec["first_seen"] = now
                if hop.get("from") is not None:
                    rec["from"] = hop["from"]
                if recv is not None:
                    rec["recv"] = recv
                    if start is not None:
                        rec["queue_s"] = round(start - recv, 6)
                if ctx is not None:
                    rec["ctx"] = ctx["id"]
                    rec["origin"] = ctx["origin"]
                    rec["hop"] = ctx["hop"] + 1
                    if recv is not None:
                        rec["wire_s"] = round(recv - ctx_ts_s(ctx), 6)
                if start is not None:
                    rec["insert_s"] = round(now - start, 6)

    def commit_batch(self, txs, block_index: int,
                     round_received: int) -> None:
        """Block commit on THIS node (every node commits every block)."""
        if not self.enabled:
            return
        inv = self._inv
        sampled = [tx for tx in txs if tx_sampled(tx, inv)]
        if not sampled:
            return
        now = self._clock.time()
        with self._lock:
            for tx in sampled:
                rec = self._rec(sha256(tx).hex())
                if "commit" not in rec:
                    rec["commit"] = now
                    rec["block"] = block_index
                    rec["round_received"] = round_received

    # -- views ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._recs)

    def get(self, txid: str) -> Optional[dict]:
        with self._lock:
            rec = self._recs.get(txid)
            return dict(rec) if rec is not None else None

    def export(self, limit: Optional[int] = None) -> List[dict]:
        """Newest-last snapshot of up to ``limit`` records."""
        with self._lock:
            recs = list(self._recs.values())
        if limit is not None and limit >= 0:
            recs = recs[-limit:]
        return [dict(r) for r in recs]

    def stats(self) -> Dict[str, object]:
        return {
            "entries": len(self._recs),
            "sampled_total": self.sampled_total,
            "evictions": self.evictions,
            "sample": self.sample,
            "cap": self.cap,
            "enabled": self.enabled,
        }
