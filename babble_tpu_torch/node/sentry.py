"""Sentry — the per-peer misbehavior ledger behind peer quarantine.

Hashgraph's BFT claim covers up to 1/3 *malicious* validators, but the
protocol layer only ever *refuses* hostile input — it never remembers who
sent it. The sentry closes that loop (docs/robustness.md §Byzantine fault
model):

- every classified ingest rejection (typed errors from
  ``hashgraph/errors.py`` — wrong-key signatures, fabricated parents,
  unknown creators, oversized syncs, forks) adds a weighted score to the
  offending peer's record;
- scores decay exponentially (half-life ``decay_halflife_s``) so an
  isolated hiccup — or an honest peer briefly caught relaying a fork's
  descendants — is forgiven, while a sustained flood is not;
- crossing ``threshold`` puts the peer in **time-boxed quarantine**: the
  gossip selector skips it and inbound syncs from it are refused until
  ``quarantine_s`` elapses, after which the slate is wiped and the peer
  is re-admitted (a falsely-flagged peer recovers on its own);
- **equivocation proofs** are kept separately and forever: a
  :class:`ForkError` carries two signed events at the same
  (creator, index) with different hashes — cryptographic evidence that
  survives restarts via the store's evidence table and is served at the
  ``/suspects`` endpoint.

Scoring is attributed carefully: a fork is scored against the event's
*creator* (honest peers can innocently relay a fork's branches), while
everything else is scored against the *direct sender* (an honest peer
verifies events before relaying, so a wrong-key event can only come from
the node that made it up).

**Trust model caveat**: the RPC envelope's ``from_id`` is NOT
authenticated (same as the reference), so sender-attributed scores are
*advisory* — an attacker can frame an honest id or rotate ids to dodge
its own score. Four properties bound the damage: fork quarantine keys
on *signed* evidence (spoof-proof); unproven-cause quarantines are
capped at the BFT bound f = ⌊(N−1)/3⌋ simultaneously (the framing
guard — more than f peers "misbehaving" at once is framing by
definition, and the selector additionally keeps a liveness floor if its
whole view is quarantined); quarantine is time-boxed with score decay,
so a framed honest peer recovers on its own; and quarantine is a
cost-shedding layer on top of the actual safety checks
(signature/parent/fork verification runs on every event regardless), so
evading it buys the attacker nothing but the full price of per-event
rejection. The per-peer ledger is bounded (MAX_RECORDS, and the
quarantine cap keeps quarantined — unevictable — records to ~f) so
id-rotation cannot balloon memory.

The sentry carries its own narrow lock — it is touched from gossip worker
threads and RPC handlers that deliberately do not hold the core lock.
``clock`` is injectable for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..common.clock import WALL
from ..common.timed_lock import named_lock
from ..config.config import (
    DEFAULT_SENTRY_DECAY_HALFLIFE_S,
    DEFAULT_SENTRY_QUARANTINE_S,
    DEFAULT_SENTRY_THRESHOLD,
)
from ..crypto.canonical import jsonable as _jsonable
from ..hashgraph.errors import (
    ForkError,
    InvalidSignatureError,
    classify_rejection,
)
from ..hashgraph.event import Event, EventBody

# Cause slug -> score added per offence. `fork` lands at the default
# threshold on its own: equivocation is cryptographically proven, so it
# earns no benefit of the doubt. `unknown_creator` stays cheap because
# honest traffic produces it around membership-change races, and
# `unknown_parent` because honest laggards produce it around
# fast-forward evictions. `garbage` is not emitted by the classifier —
# garbage payloads surface as unknown_creator/unknown_parent — it is the
# reserved weight for directly-recorded offences (tools, tests, future
# transport-level classification).
DEFAULT_WEIGHTS: Dict[str, float] = {
    "fork": 8.0,
    "invalid_signature": 2.0,
    "oversized_sync": 2.0,
    "garbage": 2.0,
    "unknown_creator": 1.0,
    "unknown_parent": 0.25,
}

# Bound on the per-peer ledger: from_id is attacker-controlled, so a
# hostile flood of fresh ids must not grow _records without limit.
MAX_RECORDS = 4096

# Bound on durable proofs per equivocating creator: ONE conflicting
# signed pair is already conclusive; a persistent equivocator forking at
# every new height must not grow the proof ledger (memory, evidence
# table, /suspects payload) without limit. Creators are bounded by the
# repertoire (forks only decode for registered validators), so total
# proofs ≤ N × this.
MAX_PROOFS_PER_CREATOR = 8


@dataclass
class EquivocationProof:
    """A signed (event A, event B) pair at the same (creator, index) with
    different hashes — self-contained, independently verifiable evidence
    of equivocation. Serialized as plain JSON so it can ride the store's
    evidence table and the ``/suspects`` endpoint unchanged."""

    creator: str  # event.creator() form ("0X…" encoded pub key)
    index: int
    event_a: dict  # {"Body": …, "Signature": …}, bytes already b64
    event_b: dict
    observed_at: int  # wall-clock seconds (int: proofs ride canonical JSON)

    def key(self) -> str:
        """One proof per forked slot: later conflicting pairs at the same
        (creator, index) are duplicates of the same offence."""
        return f"{self.creator}:{self.index}"

    @staticmethod
    def from_events(
        existing: Event, incoming: Event, observed_at: Optional[float] = None
    ) -> "EquivocationProof":
        def pack(e: Event) -> dict:
            return _jsonable({"Body": e.body.to_dict(), "Signature": e.signature})

        # The production caller (Sentry.observe_rejection) always passes
        # its node clock's wall time, so proofs stamp virtual time under
        # sim and same-seed replays export byte-identical evidence. The
        # bare default — a raw time.time() before the babblelint clock
        # pass caught it — now routes through the WALL abstraction and
        # only serves clockless direct callers (tests, tools).
        return EquivocationProof(
            creator=incoming.creator(),
            index=incoming.index(),
            event_a=pack(existing),
            event_b=pack(incoming),
            observed_at=int(
                observed_at if observed_at is not None else WALL.time()
            ),
        )

    def events(self) -> tuple[Event, Event]:
        def unpack(d: dict) -> Event:
            return Event(
                EventBody.from_dict(d["Body"]), signature=d.get("Signature", "")
            )

        return unpack(self.event_a), unpack(self.event_b)

    def verify(self) -> bool:
        """True iff this really is a fork: both events are signed by the
        claimed creator, sit at the same index, and differ in hash."""
        a, b = self.events()
        return (
            a.creator() == self.creator
            and b.creator() == self.creator
            and a.index() == self.index
            and b.index() == self.index
            and a.hex() != b.hex()
            and a.verify()
            and b.verify()
        )

    def to_dict(self) -> dict:
        return {
            "creator": self.creator,
            "index": self.index,
            "event_a": self.event_a,
            "event_b": self.event_b,
            "observed_at": self.observed_at,
        }

    @staticmethod
    def from_dict(d: dict) -> "EquivocationProof":
        return EquivocationProof(
            creator=d["creator"],
            index=d["index"],
            event_a=d["event_a"],
            event_b=d["event_b"],
            observed_at=int(d.get("observed_at", 0)),
        )


@dataclass
class _PeerRecord:
    """Mutable per-peer ledger entry (guarded by the sentry lock)."""

    score: float = 0.0
    last_update: float = 0.0
    causes: Dict[str, int] = field(default_factory=dict)
    quarantined_until: float = 0.0  # 0 = not quarantined
    quarantines: int = 0
    proven: bool = False  # current quarantine entered on signed evidence


class Sentry:
    """Per-peer misbehavior scores → time-boxed quarantine, plus the
    durable equivocation-proof ledger. See the module docstring."""

    def __init__(
        self,
        threshold: float = DEFAULT_SENTRY_THRESHOLD,
        quarantine_s: float = DEFAULT_SENTRY_QUARANTINE_S,
        decay_halflife_s: float = DEFAULT_SENTRY_DECAY_HALFLIFE_S,
        weights: Optional[Dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.threshold = threshold
        self.quarantine_s = quarantine_s
        self.decay_halflife_s = decay_halflife_s
        self.weights = dict(DEFAULT_WEIGHTS if weights is None else weights)
        self._clock = clock
        self._wall_clock = wall_clock
        # Named for the BABBLE_LOCKCHECK acquisition-order recorder:
        # ingest rejections score under the core lock, so the
        # core->sentry edge is part of the audited model.
        self._lock = named_lock("sentry")
        self._records: Dict[int, _PeerRecord] = {}
        self._proofs: Dict[str, EquivocationProof] = {}
        self._store = None  # evidence persistence hook (attach_store)
        # Peer-set size, for the BFT framing guard (set_peer_count): at
        # most f = ⌊(N−1)/3⌋ peers can actually be malicious, so a state
        # where MORE than f are simultaneously quarantined on spoofable
        # evidence is framing, not mass misbehavior — such quarantines
        # are deferred (score kept, no quarantine). 0 = guard off.
        self._peer_count = 0
        # counters surfaced through stats()
        self.rejects: Dict[str, int] = {}
        self.quarantines_total = 0
        self.readmissions = 0
        self.refused_rpcs = 0
        self.quarantine_deferrals = 0

    @classmethod
    def from_config(cls, conf) -> "Sentry":
        return cls(
            threshold=conf.sentry_threshold,
            quarantine_s=conf.sentry_quarantine_s,
            decay_halflife_s=conf.sentry_decay_halflife_s,
            # the node clock: quarantine time-boxes and proof timestamps
            # follow virtual time under the sim engine
            clock=conf.clock.monotonic,
            wall_clock=conf.clock.time,
        )

    # -- evidence persistence --------------------------------------------

    def attach_store(self, store) -> None:
        """Wire evidence persistence: proofs recorded from now on are
        written through `store.set_evidence`, and proofs already durable
        there are loaded back — so evidence survives a restart with
        ``--store`` (with or without ``--bootstrap``)."""
        if not hasattr(store, "set_evidence"):
            return
        with self._lock:
            self._store = store
            try:
                for key, data in store.all_evidence().items():
                    if key not in self._proofs:
                        self._proofs[key] = EquivocationProof.from_dict(data)
            except Exception:  # noqa: BLE001 — evidence is advisory
                pass

    # -- scoring -----------------------------------------------------------

    def record(
        self,
        peer_id: int,
        cause: str,
        weight: Optional[float] = None,
        proven: Optional[bool] = None,
    ) -> bool:
        """Add one offence to ``peer_id``'s record; returns True when this
        offence pushed the peer into quarantine. ``proven`` marks an
        offence backed by signed evidence on file (a recorded fork
        proof): proven quarantines bypass — and don't consume — the
        framing-guard f budget. Defaults to ``cause == "fork"`` for
        direct callers; observe_rejection passes the exact
        proof-on-file truth."""
        w = self.weights.get(cause, 1.0) if weight is None else weight
        if proven is None:
            proven = cause == "fork"
        now = self._clock()
        with self._lock:
            self.rejects[cause] = self.rejects.get(cause, 0) + 1
            if peer_id not in self._records and len(self._records) >= MAX_RECORDS:
                self._prune(now)
            rec = self._records.setdefault(peer_id, _PeerRecord())
            self._expire(rec, now)
            rec.score = self._decayed(rec, now) + w
            rec.last_update = now
            rec.causes[cause] = rec.causes.get(cause, 0) + 1
            if rec.score >= self.threshold and rec.quarantined_until <= now:
                # Framing guard: from_id is spoofable, so unproven
                # quarantines are capped at the BFT bound f — an attacker
                # framing honest ids can sideline at most f peers, never
                # the cluster. Signed fork evidence bypasses the cap (it
                # names a registered creator cryptographically, and only
                # N creators exist, so it is bounded anyway).
                if not proven and self._quarantine_cap_reached(now):
                    self.quarantine_deferrals += 1
                    return False
                rec.quarantined_until = now + self.quarantine_s
                rec.proven = proven
                rec.quarantines += 1
                self.quarantines_total += 1
                return True
            return False

    def set_peer_count(self, n: int) -> None:
        """Arm the framing guard with the live validator count (wired by
        Core on init and every peer-set change)."""
        self._peer_count = n

    def _quarantine_cap_reached(self, now: float) -> bool:
        """Only UNPROVEN active quarantines count toward the f cap: a
        fork-proven equivocator sitting in quarantine must not shield a
        concurrent flooder from being quarantined too. The cap is
        max(1, ⌊(N−1)/3⌋) — the floor of 1 is deliberate: in clusters
        so small that the BFT f is 0 (N ≤ 3), a flooder must still be
        quarantinable at the price of one frameable slot."""
        if self._peer_count <= 0:
            return False
        f = max(1, (self._peer_count - 1) // 3)
        active = sum(
            1
            for r in self._records.values()
            if r.quarantined_until > now and not r.proven
        )
        return active >= f

    def observe_rejection(self, err: object, from_id: int) -> Optional[str]:
        """Classify an ingest exception, mint a proof when it is a fork,
        and score the right peer (see the attribution note in the module
        docstring; forks resolve the creator's id via
        ``set_creator_resolver``). Returns the cause slug recorded, or
        None when the error is not the peer's fault. An error that ended a
        sync batch carries the forks collected before it (``forks``, set by
        ``Core.sync``): the first is observed before the error, so that its
        proof is on file when the error is classified."""
        forks = getattr(err, "forks", None)
        if forks:
            self.observe_rejection(forks[0], from_id)
        cause = classify_rejection(err)
        if cause is None:
            return None
        target = from_id
        proven = None
        if isinstance(err, ForkError):
            target = self._resolve_creator_id(err.creator, from_id)
            with self._lock:
                already = f"{err.creator}:{err.index}" in self._proofs
            if err.existing is not None and not already:
                # The proof is deduped per forked slot (checked BEFORE
                # paying the canonical-JSON packing — repeat pushes of a
                # known fork hit this path every gossip round), but every
                # re-push still scores: honest relays can't even carry
                # the second branch (known-map gossip tracks only the
                # highest index), so a repeat can only come from the
                # provably-guilty creator itself.
                self.add_proof(
                    EquivocationProof.from_events(
                        err.existing, err.incoming, self._wall_clock()
                    )
                )
            # "proven" (framing-guard bypass + /suspects label) tracks
            # what is actually ON FILE: a fork whose stored branch was
            # already evicted (existing=None) or whose proof write was
            # rejected stays an unproven, f-capped quarantine.
            proven = self._has_proof_for(err.creator)
        elif isinstance(err, InvalidSignatureError) and err.event is not None:
            # A signature failure is ambiguous once a fork is on file:
            # an honest event whose other-parent is the forked creator's
            # event re-hashes against OUR branch and fails verification
            # through no fault of the sender. Reject the event, count
            # the cause, but don't score the (likely honest) relayer.
            if self._fork_adjacent(err.event):
                # counted ONLY under the dedicated slug so
                # sentry_rejects_total still reconciles one-per-rejection
                with self._lock:
                    self.rejects["invalid_signature_fork_adjacent"] = (
                        self.rejects.get("invalid_signature_fork_adjacent", 0)
                        + 1
                    )
                return cause
        self.record(target, cause, proven=proven)
        return cause

    def _has_proof_for(self, creator_hex: str) -> bool:
        with self._lock:
            return any(p.creator == creator_hex for p in self._proofs.values())

    def _fork_adjacent(self, event: Event) -> bool:
        """True when the failed event's parent creators include a creator
        we hold fork evidence for — only FIRST-generation descendants of
        a fork fail with a signature mismatch (deeper ones fail earlier,
        with unknown_parent), so checking the direct parents suffices.
        An attacker can dodge sender-scoring by *claiming* a forked
        creator as other-parent, but only after a fork is already on
        file, and the event is still rejected — the dodge buys immunity
        from a cost-shedding layer, never from the safety checks."""
        with self._lock:
            if not self._proofs:
                return False
            proof_creators = {p.creator for p in self._proofs.values()}
            proof_ids = set()
            for c in proof_creators:
                pid = None
                if self._creator_resolver is not None:
                    try:
                        pid = self._creator_resolver(c)
                    except Exception:  # noqa: BLE001
                        pid = None
                if pid is not None:
                    proof_ids.add(pid)
        if event.creator() in proof_creators:
            return True
        op_cid = event.body.other_parent_creator_id
        return bool(event.other_parent()) and op_cid in proof_ids

    def set_creator_resolver(
        self, resolver: Callable[[str], Optional[int]]
    ) -> None:
        """``resolver(creator_hex) -> peer id`` (or None) — lets fork
        evidence be scored against the equivocator rather than whichever
        honest peer happened to relay the second branch."""
        self._creator_resolver = resolver

    _creator_resolver: Optional[Callable[[str], Optional[int]]] = None

    def _resolve_creator_id(self, creator_hex: str, fallback: int) -> int:
        if self._creator_resolver is not None:
            try:
                pid = self._creator_resolver(creator_hex)
            except Exception:  # noqa: BLE001
                pid = None
            if pid is not None:
                return pid
        return fallback

    def add_proof(self, proof: EquivocationProof) -> bool:
        """Record (and persist) a proof; returns False for a duplicate of
        an already-recorded forked slot, or when the creator already has
        MAX_PROOFS_PER_CREATOR proofs on file (one pair is conclusive —
        a serial forker must not balloon the evidence ledger)."""
        with self._lock:
            if proof.key() in self._proofs:
                return False
            if (
                sum(
                    1
                    for p in self._proofs.values()
                    if p.creator == proof.creator
                )
                >= MAX_PROOFS_PER_CREATOR
            ):
                return False
            self._proofs[proof.key()] = proof
            store = self._store
        if store is not None:
            try:
                store.set_evidence(proof.key(), proof.to_dict())
            except Exception:  # noqa: BLE001 — never let evidence IO
                pass  # failures poison the ingest path
        return True

    def proofs(self) -> List[EquivocationProof]:
        with self._lock:
            return list(self._proofs.values())

    # -- quarantine --------------------------------------------------------

    def is_quarantined(self, peer_id: int) -> bool:
        now = self._clock()
        with self._lock:
            rec = self._records.get(peer_id)
            if rec is None:
                return False
            self._expire(rec, now)
            return rec.quarantined_until > now

    def note_refused(self) -> None:
        """Count an inbound RPC refused because its sender is quarantined."""
        with self._lock:
            self.refused_rpcs += 1

    def _expire(self, rec: _PeerRecord, now: float) -> None:
        """Lazy quarantine expiry: serving out the sentence wipes the
        score, so a falsely-flagged peer re-enters with a clean slate
        (its proofs, if any, remain — evidence is forever)."""
        if 0.0 < rec.quarantined_until <= now:
            rec.quarantined_until = 0.0
            rec.proven = False
            rec.score = 0.0
            rec.last_update = now
            self.readmissions += 1

    def _prune(self, now: float) -> None:
        """Bound the ledger under a fresh-id flood (from_id is
        attacker-controlled): drop decayed-out records first, then the
        lowest scorers — but NEVER a quarantined peer's record, and never
        below MAX_RECORDS/2 so real offenders keep their history."""
        dead = [
            pid
            for pid, rec in self._records.items()
            if rec.quarantined_until <= now and self._decayed(rec, now) < 0.05
        ]
        for pid in dead:
            del self._records[pid]
        if len(self._records) >= MAX_RECORDS:
            evictable = sorted(
                (
                    (self._decayed(rec, now), pid)
                    for pid, rec in self._records.items()
                    if rec.quarantined_until <= now
                ),
            )
            for _, pid in evictable[: len(self._records) - MAX_RECORDS // 2]:
                del self._records[pid]

    def _decayed(self, rec: _PeerRecord, now: float) -> float:
        if rec.score <= 0.0 or self.decay_halflife_s <= 0.0:
            return rec.score
        dt = max(0.0, now - rec.last_update)
        return rec.score * 0.5 ** (dt / self.decay_halflife_s)

    # -- observability -----------------------------------------------------

    def suspects(self) -> dict:
        """The ``/suspects`` payload: live per-peer ledger + proof list
        (docs/robustness.md documents the schema)."""
        now = self._clock()
        with self._lock:
            peers = {}
            for pid, rec in self._records.items():
                self._expire(rec, now)
                peers[str(pid)] = {
                    "score": round(self._decayed(rec, now), 3),
                    "causes": dict(rec.causes),
                    "quarantined": rec.quarantined_until > now,
                    "quarantine_remaining_s": round(
                        max(0.0, rec.quarantined_until - now), 3
                    ),
                    "quarantines": rec.quarantines,
                }
            return {
                "threshold": self.threshold,
                "quarantine_s": self.quarantine_s,
                "decay_halflife_s": self.decay_halflife_s,
                "peers": peers,
                "proofs": [p.to_dict() for p in self._proofs.values()],
            }

    def stats(self) -> Dict[str, object]:
        now = self._clock()
        with self._lock:
            for rec in self._records.values():
                self._expire(rec, now)
            quarantined = sum(
                1
                for rec in self._records.values()
                if rec.quarantined_until > now
            )
            out: Dict[str, object] = {
                "sentry_quarantined_peers": quarantined,
                "sentry_quarantines_total": self.quarantines_total,
                "sentry_quarantine_deferrals": self.quarantine_deferrals,
                "sentry_readmissions": self.readmissions,
                "sentry_refused_rpcs": self.refused_rpcs,
                "sentry_proofs": len(self._proofs),
                "sentry_rejects_total": sum(self.rejects.values()),
            }
            for cause, n in sorted(self.rejects.items()):
                out[f"sentry_rejects_{cause}"] = n
            return out
