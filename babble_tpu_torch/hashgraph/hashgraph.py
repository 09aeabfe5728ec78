"""Hashgraph — the consensus engine.

This is the CPU-reference oracle for the TPU kernels (SURVEY.md §7 step 3):
an exact re-implementation of the reference pipeline semantics —
``insert_event → divide_rounds → decide_fame → decide_round_received →
process_decided_rounds`` — against which ``babble_tpu.ops.dag`` is
differential-tested on the golden DAGs.

Reference mapping (file:line into the reference's src/hashgraph/hashgraph.go):
- predicates ancestor/selfAncestor/see/stronglySee: 96-206
- round / witness / lamportTimestamp: 208-327, 343-387
- coordinates maintenance: 445-519
- insert path with fork checks: 672-750; trusted frame-event insert: 754-802
- DivideRounds: 807-872; DecideFame incl. coin rounds: 875-998
- DecideRoundReceived: 1002-1095; ProcessDecidedRounds/GetFrame: 1100-1289
- sig pool / anchor block: 1295-1408; Reset/Bootstrap: 1431-1536
- wire conversion: 1538-1595; CheckBlock: 1599-1630
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from babble_tpu_torch.common.errors import StoreError, StoreErrorKind, is_store_err
from babble_tpu_torch.common.lru import LRU
from babble_tpu_torch.common.utils import median_int
from babble_tpu_torch.hashgraph.block import Block
from babble_tpu_torch.hashgraph.caches import PendingRound, PendingRoundsCache, SigPool
from babble_tpu_torch.hashgraph.errors import (
    ForkError,
    InvalidSignatureError,
    SelfParentError,
    UnknownParentError,
    UnknownParticipantError,
    is_normal_self_parent_error,
)
from babble_tpu_torch.hashgraph.event import (
    Event,
    EventBody,
    EventCoordinates,
    FrameEvent,
    WireEvent,
    decode_hash,
    sort_frame_events,
)
from babble_tpu_torch.hashgraph.frame import Frame, Root
from babble_tpu_torch.hashgraph.round_info import RoundInfo
from babble_tpu_torch.hashgraph.store import Store
from babble_tpu_torch.obs.trace import staged
from babble_tpu_torch.peers.peer_set import PeerSet

logger = logging.getLogger("babble_tpu_torch.hashgraph")

#: Rounds after the round received of the block that commits a membership
#: change before the change takes effect (the node core's
#: PEER_SET_EFFECTIVE_DELAY, reference core.go:566-569).
PEER_SET_EFFECTIVE_DELAY = 6

# How many FrameEvents are included in a Root. Must be identical across
# peers or they produce different Frames/Blocks (reference: hashgraph.go:15-22).
ROOT_DEPTH = 10

# Frequency of coin rounds in the fame decision (reference: hashgraph.go:24-25).
COIN_ROUND_FREQ = 4

# Verbose per-event rejection logging, resolved once at import: the old
# per-reject `import os` + env read sat inside the hot insert path.
_DEBUG_REJECTS = bool(os.environ.get("BABBLE_DEBUG_REJECTS"))

# InternalCommitCallback: commits a block; the node's core layer processes
# the commit response (reference: hashgraph.go:1677-1688).
CommitCallback = Callable[[Block], None]


def dummy_commit_callback(block: Block) -> None:
    """reference: hashgraph.go:1687-1689."""


# Strongly-see sentinel coordinates: a missing last-ancestor /
# first-descendant entry must never satisfy ``la >= fd``, whatever the
# real (non-negative) indexes are.
_LA_MISSING = -(2**62)
_FD_MISSING = 2**62


class _RoundCtx:
    """Per-round data resolved ONCE and reused across the whole ingest
    batch: the round's peer-set columns, super-majority, witness list, and
    the witnesses' first-descendant coordinates as one dense matrix. This
    turns the per-event ``strongly_see`` loop in ``_round`` (and the
    per-voter loop in DecideFame's oracle) into a single vectorized
    compare — the dict-walk version is the profiled host-tail hotspot.

    Invalidation: a witness added to the round (divide_rounds /
    insert_frame_event) or a cached witness's first_descendants mutating
    (the insert-time walk) drops the entry; a peer-set object swap or a
    created-event count change is caught at lookup time."""

    __slots__ = ("peer_set", "sm", "col", "wits", "wit_set", "fd",
                 "n_created")

    def __init__(self, peer_set, wits, fd, n_created):
        self.peer_set = peer_set
        self.sm = peer_set.super_majority()
        self.col = {pk: i for i, pk in enumerate(peer_set.pub_keys())}
        self.wits = wits
        self.wit_set = frozenset(wits)
        self.fd = fd  # int64 [n_wit, n_peers], missing = _FD_MISSING
        self.n_created = n_created


def middle_bit(ehex: str) -> bool:
    """Pseudo-random bit for coin rounds: the middle byte of the event hash,
    False iff zero (reference: hashgraph.go:1666-1675)."""
    hash_ = decode_hash(ehex)
    if len(hash_) > 0 and hash_[len(hash_) // 2] == 0:
        return False
    return True


class Hashgraph:
    """DAG of events + methods extracting a total consensus order of
    transactions onto a blockchain (reference: hashgraph.go:30-80)."""

    def __init__(
        self,
        store: Store,
        commit_callback: CommitCallback = dummy_commit_callback,
    ):
        self.store = store
        # FIFO of events whose consensus order is not yet determined.
        self.undetermined_events: List[str] = []
        # Subset of undetermined_events still awaiting round/lamport
        # assignment — only fresh inserts land here, so divide_rounds scans
        # the new tail instead of re-fetching the whole backlog (the
        # reference rescans UndeterminedEvents, hashgraph.go:807-812; the
        # skip condition there is exactly "round and lamport already set",
        # which for us is "not in this list").
        self._round_pending: List[str] = []
        self.pending_rounds = PendingRoundsCache()
        self.pending_signatures = SigPool()
        self.last_consensus_round: Optional[int] = None
        self.first_consensus_round: Optional[int] = None
        self.anchor_block: Optional[int] = None
        self.round_lower_bound: Optional[int] = None  # fast-sync boundary
        # Checkpoint-prune retention floor (lifecycle tier): rounds below
        # it have been compacted out of the store. None = never pruned.
        self.prune_floor: Optional[int] = None
        # Lowest round the next prune pass needs to re-examine — rounds
        # below it were either dropped or fell below a previous floor
        # with every created event already gone.
        self._prune_scan_base = 0
        self.last_committed_round_events = 0
        self.consensus_transactions = 0
        self.pending_loaded_events = 0
        self.commit_callback = commit_callback
        self.topological_index = 0
        # Device consensus offload (TensorConsensus), attached by the node's
        # core when --accelerator is on. When set, DecideFame and
        # DecideRoundReceived run as batched device sweeps instead of per
        # insert; inserts between sweeps are counted in _accel_pending.
        self.accel = None
        self._accel_pending = 0
        # Events carrying internal transactions (membership changes) that
        # may still be undecided, while an offload defers the voting: see
        # _membership_change_due.
        self._accel_itx_events: set = set()
        self.forced_decisions = 0  # decide_deferred runs
        # Pipeline-stage observer (obs.telemetry): fn(stage, seconds)
        # feeding the sync_stage_seconds histogram + the active sync
        # trace. None (bare hashgraphs, BABBLE_OBS=0) keeps the staged
        # methods clockless — the decorator checks this attribute.
        self.stage_observer = None
        # Delta channels for the accelerator's incremental WindowState
        # (ops/window_state.py): the insert path records the two mutations
        # a window snapshot cannot otherwise discover in O(ΔE) — witnesses
        # minted by divide_rounds (possibly into OLD rounds, via laggards)
        # and post-insert first_descendant updates on already-stored
        # events. Collection is gated on _accel_track_delta, which the
        # TensorConsensus sets once it resolves its resident mode, so the
        # channels cost nothing on the oracle path and can never grow
        # unconsumed.
        self._accel_track_delta = False
        self._accel_new_witnesses: List[tuple] = []  # (round, hash)
        self._accel_fd_dirty: set = set()  # event hashes with new fds

        cs = store.cache_size()
        self._ancestor_cache = LRU(cs)
        self._self_ancestor_cache = LRU(cs)
        self._strongly_see_cache = LRU(cs)
        self._round_cache = LRU(cs)
        self._timestamp_cache = LRU(cs)
        self._witness_cache = LRU(cs)
        # round -> _RoundCtx, consulted by _round/_witness on every insert.
        # Entries self-validate against the round's created-event count and
        # peer-set identity; the only mutation that check cannot catch — a
        # cached witness gaining a first-descendant entry — is invalidated
        # explicitly in _update_ancestor_first_descendant.
        self._round_ctx: Dict[int, _RoundCtx] = {}

    def init(self, peer_set: PeerSet) -> None:
        """Set the genesis peer-set at round 0 (reference: hashgraph.go:84-89).

        A store recycled from disk already carries round 0 — the reference
        drops Init's KeyAlreadyExists on that path (core.go:137 ignores
        the error), so this does too."""
        try:
            self.store.set_peer_set(0, peer_set)
        except StoreError as err:
            if not is_store_err(err, StoreErrorKind.KEY_ALREADY_EXISTS):
                raise

    # =========================================================================
    # DAG predicates
    # =========================================================================

    def ancestor(self, x: str, y: str) -> bool:
        """True if y is an ancestor of x — O(1) via lastAncestors
        (reference: hashgraph.go:96-128)."""
        k = (x, y)
        v, ok = self._ancestor_cache.get(k)
        if ok:
            return v
        a = self._ancestor(x, y)
        self._ancestor_cache.add(k, a)
        return a

    def _ancestor(self, x: str, y: str) -> bool:
        if x == y:
            return True
        ex = self.store.get_event(x)
        ey = self.store.get_event(y)
        entry = ex.last_ancestors.get(ey.creator())
        return entry is not None and entry.index >= ey.index()

    def self_ancestor(self, x: str, y: str) -> bool:
        """True if y is a self-ancestor of x (reference: hashgraph.go:131-158)."""
        if x == y:
            # Identity holds without store access (the events may be evicted).
            return True
        k = (x, y)
        v, ok = self._self_ancestor_cache.get(k)
        if ok:
            return v
        ex = self.store.get_event(x)
        ey = self.store.get_event(y)
        a = ex.creator() == ey.creator() and ex.index() >= ey.index()
        self._self_ancestor_cache.add(k, a)
        return a

    def see(self, x: str, y: str) -> bool:
        """Fork detection is unnecessary here because insert_event prevents
        two events at the same height per creator (reference: hashgraph.go:160-169)."""
        return self.ancestor(x, y)

    def strongly_see(self, x: str, y: str, peers: PeerSet) -> bool:
        """x strongly sees y: the count of peers p with
        x.lastAncestors[p] >= y.firstDescendants[p] reaches a super-majority
        (reference: hashgraph.go:172-206)."""
        k = (x, y, peers.hash())
        v, ok = self._strongly_see_cache.get(k)
        if ok:
            return v
        ss = self._strongly_see(x, y, peers)
        self._strongly_see_cache.add(k, ss)
        return ss

    def _strongly_see(self, x: str, y: str, peers: PeerSet) -> bool:
        ex = self.store.get_event(x)
        ey = self.store.get_event(y)
        c = 0
        for p in peers.pub_keys():
            xla = ex.last_ancestors.get(p)
            yfd = ey.first_descendants.get(p)
            if xla is not None and yfd is not None and xla.index >= yfd.index:
                c += 1
        return c >= peers.super_majority()

    def _build_round_ctx(self, peer_set, wits, n_created) -> _RoundCtx:
        """Densify the witnesses' first-descendant coordinates into one
        int64 matrix so strongly-see against ALL of a round's witnesses is
        a single vectorized compare (the exact computation the device
        voting window performs on its fd/la tables — see ops/voting)."""
        fd = np.full(
            (len(wits), len(peer_set.pub_keys())), _FD_MISSING, dtype=np.int64
        )
        col = {pk: i for i, pk in enumerate(peer_set.pub_keys())}
        for i, w in enumerate(wits):
            for p, e in self.store.get_event(w).first_descendants.items():
                j = col.get(p)
                if j is not None:
                    fd[i, j] = e.index
        return _RoundCtx(peer_set, wits, fd, n_created)

    def _round_ctx_for(self, r: int, round_info, peer_set) -> _RoundCtx:
        """Cached per-round ctx, revalidated cheaply on every lookup: a
        created-event count change forces a witness-list recompute, and a
        changed witness list (or peer-set swap) forces a matrix rebuild.
        When only non-witness events were added, the ctx survives with its
        count refreshed — the common case on the hot insert path."""
        ctx = self._round_ctx.get(r)
        n_created = len(round_info.created_events)
        if ctx is not None and ctx.peer_set is peer_set:
            if ctx.n_created == n_created:
                return ctx
            wits = round_info.witnesses()
            if ctx.wits == wits:
                ctx.n_created = n_created
                return ctx
        else:
            wits = round_info.witnesses()
        ctx = self._build_round_ctx(peer_set, wits, n_created)
        if len(self._round_ctx) >= 128:
            # Consensus advances monotonically; old rounds stop being
            # parent rounds, so prune from the bottom.
            for k in sorted(self._round_ctx)[:64]:
                del self._round_ctx[k]
        self._round_ctx[r] = ctx
        return ctx

    def _strongly_seen_mask(self, x: str, ctx: _RoundCtx):
        """Boolean mask over ctx.wits: which witnesses x strongly sees.
        Missing-coordinate sentinels guarantee ``la >= fd`` is False when
        either side is absent, for any real (non-negative) index."""
        ex = self.store.get_event(x)
        la = np.full((len(ctx.col),), _LA_MISSING, dtype=np.int64)
        for p, e in ex.last_ancestors.items():
            j = ctx.col.get(p)
            if j is not None:
                la[j] = e.index
        return (la[None, :] >= ctx.fd).sum(axis=1) >= ctx.sm

    # =========================================================================
    # Round / witness / timestamps
    # =========================================================================

    def round(self, x: str) -> int:
        v, ok = self._round_cache.get(x)
        if ok:
            return v
        r = self._round(x)
        self._round_cache.add(x, r)
        return r

    def round_diff(self, x: str, y: str) -> int:
        """round(x) - round(y) (reference: hashgraph.go:329-341)."""
        return self.round(x) - self.round(y)

    def _round(self, x: str) -> int:
        """Parent round, +1 if x strongly sees a super-majority of
        parent-round witnesses (reference: hashgraph.go:220-282)."""
        ex = self.store.get_event(x)
        if ex.round is not None:
            # Already assigned (divide_rounds / frame insert / annotated
            # reload) — rounds are write-once, so this is the value the
            # recursion would rebuild, and it keeps the walk from
            # descending into parents compaction may have dropped.
            return ex.round

        parent_round = -1
        if ex.self_parent() != "":
            parent_round = self.round(ex.self_parent())
        if ex.other_parent() != "":
            op_round = self.round(ex.other_parent())
            if op_round > parent_round:
                parent_round = op_round

        if parent_round == -1:
            return 0

        round_ = parent_round
        parent_round_obj = self.store.get_round(parent_round)
        parent_round_peer_set = self.store.get_peer_set(parent_round)

        # One vectorized compare against the round's witness fd matrix
        # replaces the per-witness strongly_see loop — the profiled host
        # tail of divide_rounds (thousands of dict walks per ingest batch).
        ctx = self._round_ctx_for(
            parent_round, parent_round_obj, parent_round_peer_set
        )
        c = int(self._strongly_seen_mask(x, ctx).sum()) if ctx.wits else 0
        if c >= parent_round_peer_set.super_majority():
            round_ += 1
        return round_

    def witness(self, x: str) -> bool:
        v, ok = self._witness_cache.get(x)
        if ok:
            return v
        r = self._witness(x)
        self._witness_cache.add(x, r)
        return r

    def _witness(self, x: str) -> bool:
        """First event of a round for a creator belonging to that round's
        peer-set (reference: hashgraph.go:297-327)."""
        ex = self.store.get_event(x)
        x_round = self.round(x)
        peer_set = self.store.get_peer_set(x_round)
        if ex.creator() not in peer_set.by_pub_key:
            return False
        sp_round = -1
        if ex.self_parent() != "":
            sp_round = self.round(ex.self_parent())
        return x_round > sp_round

    def round_received(self, x: str) -> int:
        ex = self.store.get_event(x)
        return ex.round_received if ex.round_received is not None else -1

    def lamport_timestamp(self, x: str) -> int:
        v, ok = self._timestamp_cache.get(x)
        if ok:
            return v
        r = self._lamport_timestamp(x)
        self._timestamp_cache.add(x, r)
        return r

    def _lamport_timestamp(self, x: str) -> int:
        """max(parents' timestamps) + 1; an unknown other-parent contributes
        nothing (reference: hashgraph.go:355-387)."""
        ex = self.store.get_event(x)
        if ex.lamport_timestamp is not None:
            # Write-once, same rationale as _round's short-circuit.
            return ex.lamport_timestamp
        plt = -1
        if ex.self_parent() != "":
            plt = self.lamport_timestamp(ex.self_parent())
        if ex.other_parent() != "":
            try:
                self.store.get_event(ex.other_parent())
            except StoreError:
                pass
            else:
                op_lt = self.lamport_timestamp(ex.other_parent())
                if op_lt > plt:
                    plt = op_lt
        return plt + 1

    # =========================================================================
    # Insert path
    # =========================================================================

    def _check_self_parent(self, event: Event) -> None:
        """The self-parent must be the creator's last known event — this is
        what structurally prevents forks (reference: hashgraph.go:405-429).

        On a mismatch, the occupied (creator, index) slot distinguishes
        three cases the reference folds into one "normal" error:

        - same hash at the slot → a benign concurrent duplicate insert;
        - a DIFFERENT hash at the slot → equivocation. The incoming
          event's signature was already verified (insert_event checks it
          first), and the stored branch was verified at its own insert,
          so the pair is cryptographic proof of a fork — raised as
          :class:`ForkError` carrying both events for the sentry;
        - empty slot (index gap / stale parent) → the benign race.

        The reference dropped the second branch silently and kept
        gossiping with the attacker; here the evidence surfaces."""
        self_parent = event.self_parent()
        creator = event.creator()
        try:
            creator_last_known = self.store.last_event_from(creator)
        except StoreError as err:
            if is_store_err(err, StoreErrorKind.EMPTY) and self_parent == "":
                return  # first event
            raise SelfParentError(str(err), normal=False)
        if self_parent != creator_last_known:
            occupant = None
            try:
                occupant = self.store.participant_event(creator, event.index())
            except StoreError:
                pass
            if occupant is not None and occupant != event.hex():
                existing = None
                try:
                    existing = self.store.get_event(occupant)
                except StoreError:
                    pass
                raise ForkError(creator, event.index(), existing, event)
            # Expected under concurrent duplicate inserts — a "normal" error
            # (reference: errors.go:24-32, hashgraph.go:419-428).
            raise SelfParentError(
                "self-parent not last known event by creator", normal=True
            )

    def _check_other_parent(self, event: Event) -> None:
        """reference: hashgraph.go:432-442."""
        other_parent = event.other_parent()
        if other_parent != "":
            try:
                self.store.get_event(other_parent)
            except StoreError:
                raise UnknownParentError("other-parent not known")

    def _init_event_coordinates(self, event: Event) -> None:
        """lastAncestors = element-wise max of parents' lastAncestors;
        firstDescendants/lastAncestors get the event itself for its creator
        (reference: hashgraph.go:445-483)."""
        event.last_ancestors = {}
        event.first_descendants = {}

        self_parent: Optional[Event] = None
        other_parent: Optional[Event] = None
        try:
            self_parent = self.store.get_event(event.self_parent())
        except StoreError:
            pass
        try:
            other_parent = self.store.get_event(event.other_parent())
        except StoreError:
            pass

        if self_parent is None and other_parent is not None:
            event.last_ancestors = dict(other_parent.last_ancestors)
        elif other_parent is None and self_parent is not None:
            event.last_ancestors = dict(self_parent.last_ancestors)
        elif self_parent is not None and other_parent is not None:
            event.last_ancestors = dict(self_parent.last_ancestors)
            for p, ola in other_parent.last_ancestors.items():
                sla = event.last_ancestors.get(p)
                if sla is None or sla.index < ola.index:
                    event.last_ancestors[p] = EventCoordinates(ola.hash, ola.index)

        me = EventCoordinates(event.hex(), event.index())
        event.first_descendants[event.creator()] = me
        event.last_ancestors[event.creator()] = me

    def _update_ancestor_first_descendant(self, event: Event) -> None:
        """Walk each last-ancestor's self-parent chain, recording this event
        as first descendant, stopping at witnesses or already-filled entries
        (reference: hashgraph.go:486-519)."""
        creator = event.creator()
        coords = EventCoordinates(event.hex(), event.index())
        for c in list(event.last_ancestors.values()):
            ah = c.hash
            while True:
                try:
                    a = self.store.get_event(ah)
                except StoreError:
                    break
                if creator not in a.first_descendants:
                    a.first_descendants[creator] = coords
                    self.store.set_event(a)
                    if self._accel_track_delta:
                        self._accel_fd_dirty.add(ah)
                    # A cached round-ctx matrix snapshots witness fds; this
                    # is the one mutation its count check cannot see.
                    if a.round is not None:
                        ctx = self._round_ctx.get(a.round)
                        if ctx is not None and ah in ctx.wit_set:
                            del self._round_ctx[a.round]
                    # Stop at witnesses so the walk doesn't descend to the
                    # bottom of the graph (reference: hashgraph.go:503-512).
                    try:
                        if self.witness(ah):
                            break
                    except StoreError:
                        pass
                    ah = a.self_parent()
                else:
                    break

    def set_wire_info(self, event: Event) -> None:
        """Fill the (creatorID, parent index) wire fields
        (reference: hashgraph.go:596-633)."""
        self_parent_index = -1
        other_parent_creator_id = 0
        other_parent_index = -1

        creator = self.store.repertoire_by_pub_key().get(event.creator())
        if creator is None:
            raise UnknownParticipantError(
                f"creator {event.creator()} not found"
            )

        if event.self_parent() != "":
            self_parent_index = self.store.get_event(event.self_parent()).index()

        if event.other_parent() != "":
            other_parent = self.store.get_event(event.other_parent())
            op_creator = self.store.repertoire_by_pub_key().get(other_parent.creator())
            if op_creator is None:
                raise UnknownParticipantError(
                    f"creator {other_parent.creator()} not found"
                )
            other_parent_creator_id = op_creator.id
            other_parent_index = other_parent.index()

        event.set_wire_info(
            self_parent_index,
            other_parent_creator_id,
            other_parent_index,
            creator.id,
        )

    def insert_event_and_run_consensus(
        self, event: Event, set_wire_info: bool = False
    ) -> None:
        """The per-event consensus pipeline (reference: hashgraph.go:644-668).

        With an accelerator attached, round/witness assignment still happens
        per insert (it gates the insert-time first-descendant walk,
        hashgraph.go:503-512, so it must track every insert exactly like the
        reference), but the voting stages are deferred to a batched device
        sweep — normally once per sync via flush_consensus, or mid-batch
        when enough inserts accumulate."""
        self.insert_event(event, set_wire_info)
        self.divide_rounds()
        if self.accel is not None:
            self._accel_pending += 1
            if self.accel.should_sweep(self._accel_pending):
                self.run_consensus_sweep()
            if self._membership_change_due():
                self.decide_deferred()
            return
        self.run_consensus_sweep()

    def _membership_change_due(self) -> bool:
        """True when the voting an offload defers must run to completion
        before the next insert: an undecided event carries an internal
        transaction (a membership change) and the DAG has reached
        PEER_SET_EFFECTIVE_DELAY rounds past that event's round. The change
        takes effect PEER_SET_EFFECTIVE_DELAY rounds after the round
        received of the block that commits it, which is later than the
        event's round, and is registered when that block commits. The
        reference decides at every insert, so the change is registered
        before any event of that round is inserted; deferred past it, a
        node that replays history in large syncs (a joiner) would divide
        later rounds under a peer-set not yet registered, and fork."""
        first = None
        for h in list(self._accel_itx_events):
            try:
                ev = self.store.get_event(h)
            except StoreError:
                ev = None  # evicted: long decided
            if ev is None or ev.round_received is not None:
                self._accel_itx_events.discard(h)
            elif ev.round is not None and (first is None or ev.round < first):
                first = ev.round
        return (first is not None and
                self.store.last_round() >= first + PEER_SET_EFFECTIVE_DELAY)

    def decide_deferred(self) -> None:
        """Run the voting an offload has deferred over every event inserted
        so far, and apply it: a sweep now and, while a pipelined sweep is in
        flight, waits for it to land and flushes again."""
        self.forced_decisions += 1
        self._accel_pending = max(self._accel_pending, 1)
        self.run_consensus_sweep()
        while self.accel.busy():
            self.accel.wait_landed()
            self.run_consensus_sweep()

    def flush_consensus(self) -> None:
        """Run any deferred accelerated consensus sweep (no-op without an
        accelerator; with one attached, also drains a pipelined sweep's
        pending results even when nothing was inserted since)."""
        if self.accel is not None and (
            self._accel_pending > 0 or self.accel.busy()
        ):
            self.run_consensus_sweep()

    def drain_accel_delta(self) -> tuple:
        """Hand the accumulated delta channels to the accelerator's window
        state (consumed exactly once per snapshot): (new_witnesses,
        fd_dirty). New-witness order is divide_rounds order."""
        nw, self._accel_new_witnesses = self._accel_new_witnesses, []
        fd, self._accel_fd_dirty = self._accel_fd_dirty, set()
        return nw, fd

    def run_consensus_sweep(self) -> None:
        """One batched voting sweep: device kernels when the undecided
        window is big enough to beat the dispatch+readback cost, oracle
        stages otherwise. Output is identical either way."""
        self._accel_pending = 0
        if self.accel is not None and self.accel.flush(self):
            self.process_decided_rounds()
            return
        self.decide_fame()
        self.decide_round_received()
        self.process_decided_rounds()

    @staged("insert")
    def insert_event(self, event: Event, set_wire_info: bool = False) -> None:
        """Verify signature, check parents, prevent forks, maintain
        coordinates, queue for consensus (reference: hashgraph.go:672-750)."""
        if not event.verify():
            if _DEBUG_REJECTS:
                logger.error(
                    "REJECT %s creator=%s idx=%s parents=%r txs=%d itxs=%d "
                    "sigs=%d ts=%s sig=%s",
                    event.hex(), event.creator()[:24], event.index(),
                    [p[:20] for p in event.body.parents],
                    len(event.body.transactions),
                    len(event.body.internal_transactions),
                    len(event.body.block_signatures),
                    event.body.timestamp, event.signature[:40],
                )
            raise InvalidSignatureError(
                f"invalid event signature {event.hex()}", event=event
            )

        self._check_self_parent(event)
        self._check_other_parent(event)

        event.topological_index = self.topological_index
        self.topological_index += 1

        if set_wire_info:
            self.set_wire_info(event)

        self._init_event_coordinates(event)
        self.store.set_event(event)
        self._update_ancestor_first_descendant(event)

        self.undetermined_events.append(event.hex())
        self._round_pending.append(event.hex())
        if self.accel is not None and event.internal_transactions():
            self._accel_itx_events.add(event.hex())

        if event.is_loaded():
            self.pending_loaded_events += 1

        for bs in event.block_signatures():
            self.pending_signatures.add(bs)

    def insert_frame_event(self, frame_event: FrameEvent) -> None:
        """Trusted insert for fast-sync: skips signature/parent checks, primes
        the round/witness/timestamp caches, records as consensus event
        (reference: hashgraph.go:754-802)."""
        event = frame_event.core

        self._round_cache.add(event.hex(), frame_event.round)
        self._witness_cache.add(event.hex(), frame_event.witness)
        self._timestamp_cache.add(event.hex(), frame_event.lamport_timestamp)

        event.set_round(frame_event.round)
        event.set_lamport_timestamp(frame_event.lamport_timestamp)

        try:
            round_info = self.store.get_round(frame_event.round)
        except StoreError as err:
            if not is_store_err(err, StoreErrorKind.KEY_NOT_FOUND):
                raise
            round_info = RoundInfo()
        round_info.add_created_event(event.hex(), frame_event.witness)
        self.store.set_round(frame_event.round, round_info)

        self._init_event_coordinates(event)
        self.store.set_event(event)
        self._update_ancestor_first_descendant(event)
        self.store.add_consensus_event(event)

    # =========================================================================
    # Consensus pipeline
    # =========================================================================

    @staged("divide_rounds")
    def divide_rounds(self) -> None:
        """Assign round + Lamport timestamp to undetermined events, flag
        witnesses, queue pending rounds (reference: hashgraph.go:807-872).

        Scans only the fresh-insert tail (_round_pending): already-assigned
        events can never need reassignment, so re-fetching the full
        undetermined backlog per pass (the reference's loop shape) would be
        pure store/LRU overhead. On error the unprocessed suffix is
        requeued so the next pass retries it.

        set_round writes are coalesced per TOUCHED ROUND rather than issued
        per event: a fresh round still registers immediately (get_round /
        last_round must see it mid-batch), but the per-event re-writes of an
        already-registered round collapse into one flush per round at the
        end of the pass — on the persistent store that turns O(batch) SQL
        upserts into O(distinct rounds). The flush runs in a finally so a
        mid-batch error still persists every mutation already applied to
        the (shared, mutable) RoundInfo objects."""
        pending = self._round_pending
        if not pending:
            return
        self._round_pending = []
        done = 0
        touched: Dict[int, RoundInfo] = {}
        try:
            for hash_ in pending:
                self._assign_round_and_lamport(hash_, touched)
                done += 1
        except BaseException:
            self._round_pending = pending[done:] + self._round_pending
            raise
        finally:
            for r, ri in touched.items():
                self.store.set_round(r, ri)

    def _assign_round_and_lamport(
        self, hash_: str, round_infos: Optional[Dict[int, "RoundInfo"]] = None
    ) -> None:
        ev = self.store.get_event(hash_)
        update_event = False

        if ev.round is None:
            # All fallible reads (round, round-info, witness) run BEFORE the
            # event is mutated: the store hands back this same cached object,
            # so mutating first would make the requeued retry see
            # "round already assigned" and skip witness registration forever.
            round_number = self.round(hash_)
            round_info = (
                None if round_infos is None else round_infos.get(round_number)
            )
            fresh_round = False
            if round_info is None:
                try:
                    round_info = self.store.get_round(round_number)
                except StoreError as err:
                    if not is_store_err(err, StoreErrorKind.KEY_NOT_FOUND):
                        raise
                    round_info = RoundInfo()
                    fresh_round = True
            is_witness = self.witness(hash_)
            ev.set_round(round_number)
            update_event = True

            if (
                not self.pending_rounds.queued(round_number)
                and not round_info.decided
                and (
                    self.round_lower_bound is None
                    or round_number > self.round_lower_bound
                )
            ):
                self.pending_rounds.set(PendingRound(round_number, False))

            round_info.add_created_event(hash_, is_witness)
            if round_infos is None or fresh_round:
                # A fresh round registers immediately — the very next event
                # in the batch may read it via get_round / last_round.
                # Known rounds defer to divide_rounds' per-round flush.
                self.store.set_round(round_number, round_info)
            if round_infos is not None:
                round_infos[round_number] = round_info
            if is_witness and self._accel_track_delta:
                self._accel_new_witnesses.append((round_number, hash_))

        if ev.lamport_timestamp is None:
            # fallible read evaluated before the mutation, same rationale
            lt = self.lamport_timestamp(hash_)
            ev.set_lamport_timestamp(lt)
            update_event = True

        if update_event:
            self.store.set_event(ev)

    @staged("decide_fame")
    def decide_fame(self) -> None:
        """Virtual voting with coin rounds every COIN_ROUND_FREQ rounds
        (reference: hashgraph.go:875-998).

        Per-pass memos: round infos / peer-sets / witness lists are
        fetched once per round, and each voter y's strongly-seen
        witness list of round j-1 is computed once instead of once per
        candidate x — none of it changes within the stage (set_fame only
        mutates the candidate round's info)."""
        votes: Dict[str, Dict[str, bool]] = {}  # votes[y][x] = y's vote on x

        def set_vote(y: str, x: str, vote: bool) -> None:
            votes.setdefault(y, {})[x] = vote

        rounds_memo: Dict[int, tuple] = {}  # j -> (peer_set, witnesses)

        def round_data(j: int) -> tuple:
            e = rounds_memo.get(j)
            if e is None:
                ri = self.store.get_round(j)
                ps = self.store.get_peer_set(j)
                e = (ps, ri.witnesses())
                rounds_memo[j] = e
            return e

        ss_memo: Dict[tuple, list] = {}  # (y, j_prev) -> strongly-seen list
        ctx_memo: Dict[int, _RoundCtx] = {}  # j_prev -> fd-matrix ctx

        def ss_witnesses_of(y: str, j_prev: int) -> list:
            k = (y, j_prev)
            v = ss_memo.get(k)
            if v is None:
                prev_ps, prev_wits = round_data(j_prev)
                # Built from the per-pass captured witness list (NOT the
                # cross-pass _round_ctx), so the voter mask sees exactly
                # the snapshot round_data froze for this stage.
                ctx = ctx_memo.get(j_prev)
                if ctx is None:
                    ctx = self._build_round_ctx(prev_ps, prev_wits, 0)
                    ctx_memo[j_prev] = ctx
                mask = self._strongly_seen_mask(y, ctx)
                v = [w for w, s in zip(prev_wits, mask) if s]
                ss_memo[k] = v
            return v

        decided_rounds: List[int] = []

        for pr in self.pending_rounds.get_ordered_pending_rounds():
            round_index = pr.index
            r_round_info = self.store.get_round(round_index)
            r_peer_set = self.store.get_peer_set(round_index)

            for x in r_round_info.witnesses():
                if r_round_info.is_decided(x):
                    continue
                done = False
                for j in range(round_index + 1, self.store.last_round() + 1):
                    if done:
                        break
                    j_peer_set, j_witnesses = round_data(j)

                    for y in j_witnesses:
                        diff = j - round_index
                        if diff == 1:
                            set_vote(y, x, self.see(y, x))
                        else:
                            # Witnesses of round j-1 strongly seen by y,
                            # based on the round j-1 peer-set.
                            ss_witnesses = ss_witnesses_of(y, j - 1)

                            yays = 0
                            nays = 0
                            for w in ss_witnesses:
                                if votes.get(w, {}).get(x, False):
                                    yays += 1
                                else:
                                    nays += 1
                            v = False
                            t = nays
                            if yays >= nays:
                                v = True
                                t = yays

                            if diff % COIN_ROUND_FREQ > 0:  # normal round
                                if t >= j_peer_set.super_majority():
                                    r_round_info.set_fame(x, v)
                                    set_vote(y, x, v)
                                    done = True  # break out of the j loop
                                    break
                                set_vote(y, x, v)
                            else:  # coin round
                                if t >= j_peer_set.super_majority():
                                    set_vote(y, x, v)
                                else:
                                    set_vote(y, x, middle_bit(y))

            if r_round_info.witnesses_decided(r_peer_set):
                decided_rounds.append(round_index)

            self.store.set_round(round_index, r_round_info)

        self.pending_rounds.update(decided_rounds)

    @staged("round_received")
    def decide_round_received(self) -> None:
        """An event is received at the first decided round whose famous
        witnesses ALL see it (reference: hashgraph.go:1002-1095, quoting the
        whitepaper's 18/03/18 formulation).

        Per-round data (info, decidedness, famous witnesses, threshold) is
        fetched ONCE per pass and shared across the whole undetermined
        scan — none of it can change mid-stage, and the repeated
        store/LRU lookups were the pass's hottest lines. Mutated round
        infos are written back once per round at the end (same final
        store state; received order within a round is the scan order, as
        in the reference)."""
        new_undetermined: List[str] = []
        # round -> None (missing) | (round_info, decided, famous, sm)
        rcache: dict = {}
        dirty: dict = {}
        last_round = self.store.last_round()
        lb = self.round_lower_bound

        def round_entry(i: int):
            e = rcache.get(i, False)
            if e is False:
                try:
                    tr = self.store.get_round(i)
                except StoreError:
                    e = None
                else:
                    tp = self.store.get_peer_set(i)
                    decided = tr.witnesses_decided(tp)
                    fws = tr.famous_witnesses() if decided else ()
                    e = (tr, decided, fws, tp.super_majority())
                rcache[i] = e
            return e

        try:
            self._rr_scan(new_undetermined, round_entry, dirty, last_round, lb)
        finally:
            # flush mutated rounds even if the scan raised mid-pass, so a
            # persistent store's rounds never trail its already-written
            # event rows (the old per-event set_round pairing, batched)
            for i, tr in dirty.items():
                self.store.set_round(i, tr)

        self.undetermined_events = new_undetermined

    def _rr_scan(self, new_undetermined, round_entry, dirty, last_round,
                 lb) -> None:
        for x in self.undetermined_events:
            received = False
            r = self.round(x)

            for i in range(r + 1, last_round + 1):
                entry = round_entry(i)
                if entry is None:
                    if lb is not None and i <= lb:
                        # Compacted round at/below the prune / fast-sync
                        # floor: it is decided and its famous witnesses
                        # are fixed, so it can never receive x — skip
                        # upward exactly as the un-pruned oracle's
                        # decided-round walk does.
                        continue
                    # A joiner's first event can have round 0 while others
                    # have long evicted round 1 (reference:
                    # hashgraph.go:1019-1026).
                    break
                tr, decided, fws, sm = entry

                if not decided:
                    # Rounds below the fast-sync lower bound are never
                    # decided by decide_fame — skip them instead of
                    # bailing (reference: hashgraph.go:1033-1046).
                    if lb is None or lb < i:
                        break
                    else:
                        continue

                if len(fws) >= sm and all(self.see(w, x) for w in fws):
                    received = True
                    ex = self.store.get_event(x)
                    ex.set_round_received(i)
                    self.store.set_event(ex)
                    tr.add_received_event(x)
                    dirty[i] = tr
                    break

            if not received:
                new_undetermined.append(x)

    @staged("commit")
    def process_decided_rounds(self) -> None:
        """Map decided rounds onto Frames and Blocks, committing via the
        callback (reference: hashgraph.go:1100-1181)."""
        processed_rounds: List[int] = []
        try:
            for pr in self.pending_rounds.get_ordered_pending_rounds():
                # Never process a decided round before all earlier rounds are
                # processed (reference: hashgraph.go:1108-1113).
                if not pr.decided:
                    break

                frame = self.get_frame(pr.index)

                if frame.events:
                    for fe in frame.events:
                        self.store.add_consensus_event(fe.core)
                        self.consensus_transactions += len(fe.core.transactions())
                        if fe.core.is_loaded():
                            self.pending_loaded_events -= 1

                    block = Block.from_frame(self.store.last_block_index() + 1, frame)
                    if block.transactions() or block.internal_transactions():
                        # Commit BEFORE publishing via set_block: the
                        # callback mutates the body (state_hash, receipts)
                        # and signs it, and set_block is what advances
                        # last_block_index — publishing first let
                        # concurrent readers hash a half-committed body
                        # and (via the lost-invalidation cache race) left
                        # a stale digest that this node then SIGNED
                        # (surfaced by test_bootstrap_recycle_reproduces_
                        # chain once the batched-ingest path sped gossip
                        # up). The callback's own sign path re-persists
                        # the block; this set_block also covers the
                        # commit-failure case, keeping the reference's
                        # non-fatal semantics (hashgraph.go:1162-1165).
                        try:
                            self.commit_callback(block)
                        except Exception:
                            logger.warning(
                                "failed to commit block %d", block.index(), exc_info=True
                            )
                        self.store.set_block(block)
                    self.last_committed_round_events = len(frame.events)

                processed_rounds.append(pr.index)

                if (
                    self.last_consensus_round is None
                    or pr.index > self.last_consensus_round
                ):
                    self._set_last_consensus_round(pr.index)
        finally:
            self.pending_rounds.clean(processed_rounds)

    # =========================================================================
    # Frames
    # =========================================================================

    def _create_frame_event(self, x: str) -> FrameEvent:
        """reference: hashgraph.go:521-557."""
        ev = self.store.get_event(x)
        round_ = self.round(x)
        round_info = self.store.get_round(round_)
        te = round_info.created_events.get(x)
        if te is None:
            raise ValueError(f"round {round_} created_events[{x}] not found")
        return FrameEvent(
            core=ev,
            round=round_,
            lamport_timestamp=self.lamport_timestamp(x),
            witness=te.witness,
        )

    def _create_root(self, participant: str, head: str) -> Root:
        """Root = the head + up to ROOT_DEPTH prior events of the
        participant, in topological order (reference: hashgraph.go:559-594)."""
        root = Root()
        if head != "":
            head_event = self._create_frame_event(head)
            reverse_root_events = [head_event]
            index = head_event.core.index()
            for _ in range(ROOT_DEPTH):
                index -= 1
                if index < 0:
                    break
                try:
                    peh = self.store.participant_event(participant, index)
                except StoreError:
                    break
                reverse_root_events.append(self._create_frame_event(peh))
            for fe in reversed(reverse_root_events):
                root.insert(fe)
        return root

    def get_frame(self, round_received: int) -> Frame:
        """Compute (or fetch) the Frame of a received round
        (reference: hashgraph.go:1184-1289)."""
        try:
            return self.store.get_frame(round_received)
        except StoreError as err:
            if not is_store_err(err, StoreErrorKind.KEY_NOT_FOUND):
                raise

        round_ = self.store.get_round(round_received)
        peer_set = self.store.get_peer_set(round_received)

        events = [self._create_frame_event(eh) for eh in round_.received_events]
        events = sort_frame_events(events)

        # Roots for participants with events in this frame: built from each
        # participant's first frame-event's self-parent.
        roots: Dict[str, Root] = {}
        for fe in events:
            p = fe.core.creator()
            if p not in roots:
                roots[p] = self._create_root(p, fe.core.self_parent())

        # Every participant known before round_received needs a Root —
        # built from its last consensus event (reference: hashgraph.go:1231-1256).
        for p, peer in self.store.repertoire_by_pub_key().items():
            first_round, ok = self.store.first_round(peer.id)
            if not ok or first_round > round_received:
                continue
            if p not in roots:
                last_consensus_event_hash = self.store.last_consensus_event_from(p)
                roots[p] = self._create_root(p, last_consensus_event_hash)

        all_peer_sets = self.store.get_all_peer_sets()

        # BFT timestamp: median of famous-witness wall-clock timestamps
        # (reference: hashgraph.go:1264-1273).
        timestamps = [
            self.store.get_event(fw).timestamp()
            for fw in round_.famous_witnesses()
        ]
        frame_timestamp = median_int(timestamps)

        res = Frame(
            round=round_received,
            peers=peer_set,
            roots=roots,
            events=events,
            peer_sets=all_peer_sets,
            timestamp=frame_timestamp,
        )
        self.store.set_frame(res)
        return res

    # =========================================================================
    # Signature pool / anchor block
    # =========================================================================

    def process_sig_pool(self) -> None:
        """Match pending block-signatures to stored blocks; validate the
        signer against the block round's peer-set; verify; append
        (reference: hashgraph.go:1295-1367)."""
        for bs in self.pending_signatures.slice():
            try:
                block = self.store.get_block(bs.index)
            except StoreError:
                continue  # block not yet committed locally; keep the sig

            try:
                peer_set = self.store.get_peer_set(block.round_received())
            except StoreError:
                continue

            if bs.validator_hex() not in peer_set.by_pub_key:
                continue  # signer not a validator for that round: drop later

            if not block.verify_signature(bs):
                continue

            block.set_signature(bs)
            self.store.set_block(block)
            self.set_anchor_block(block)
            self.pending_signatures.remove(bs.key())

    def set_anchor_block(self, block: Block) -> None:
        """AnchorBlock = latest block with MORE than 1/3 signatures
        (reference: hashgraph.go:1375-1408)."""
        peer_set = self.store.get_peer_set(block.round_received())
        if len(block.signatures) > peer_set.trust_count() and (
            self.anchor_block is None or block.index() > self.anchor_block
        ):
            self.anchor_block = block.index()

    def get_anchor_block_with_frame(self) -> tuple[Block, Frame]:
        """reference: hashgraph.go:1412-1428."""
        if self.anchor_block is None:
            raise ValueError("no anchor block")
        block = self.store.get_block(self.anchor_block)
        frame = self.get_frame(block.round_received())
        return block, frame

    # =========================================================================
    # Compaction (lifecycle tier — babble_tpu/lifecycle/pruner.py)
    # =========================================================================

    def prune_below(self, floor_round: int) -> Dict[str, int]:
        """Compact history below a sealed anchor: drop events received in
        rounds < floor_round, rounds whose created events are all gone,
        and frames below the floor — from cache AND durable storage.

        Safe because everything at stake is final: rounds below the
        anchor are decided, a decided round's famous witnesses are fixed
        at decision time, and see() only consults coordinates frozen at
        insert — so no event inserted after the prune can ever be
        received at a pruned round, and the live pipeline never reads
        below the floor.  What must survive does: every round ≥ the
        floor and its frame, each participant's last ROOT_DEPTH+1
        consensus events (future _create_root walks), any round below
        the floor that still holds a live created event (its RoundInfo
        backs _create_frame_event for straggler roots), and blocks /
        peer-sets / roots / evidence / consensus counters wholesale.
        """
        if (
            self.last_consensus_round is None
            or floor_round > self.last_consensus_round
        ):
            raise ValueError(
                f"prune floor {floor_round} beyond last consensus round "
                f"{self.last_consensus_round}"
            )
        prev = self.prune_floor
        if prev is not None and floor_round <= prev:
            return {"floor": prev, "events_pruned": 0, "rounds_pruned": 0}

        # Per-participant keep floor: the last ROOT_DEPTH+1 events below
        # each participant's latest consensus event stay, whatever round
        # received them — _create_root walks that far down the index.
        floors: Dict[str, int] = {}
        for p in self.store.repertoire_by_pub_key():
            last = self.store.last_consensus_event_from(p)
            if last == "":
                continue
            try:
                ev = self.store.get_event(last)
            except StoreError:
                continue
            keep_from = ev.index() - ROOT_DEPTH
            if keep_from > 0:
                floors[p] = keep_from

        # Enumerate the drop set from the received-event lists of rounds
        # below the floor. A hash that no longer loads was compacted (or
        # evicted) already — re-listing it only re-issues a no-op delete.
        dropped: set = set()
        drop_events: List[str] = []
        scan_base = self._prune_scan_base
        for r in range(scan_base, floor_round):
            try:
                ri = self.store.get_round(r)
            except StoreError:
                continue
            for h in ri.received_events:
                if h in dropped:
                    continue
                try:
                    ev = self.store.get_event(h)
                except StoreError:
                    dropped.add(h)
                    drop_events.append(h)
                    continue
                fl = floors.get(ev.creator())
                if fl is None or ev.index() >= fl:
                    continue
                dropped.add(h)
                drop_events.append(h)

        # A round goes only when ALL its created events are gone: an
        # event created below the floor but received above it (or still
        # undetermined) keeps its round alive for _create_frame_event.
        drop_rounds: List[int] = []
        new_scan_base = floor_round
        for r in range(scan_base, floor_round):
            try:
                ri = self.store.get_round(r)
            except StoreError:
                continue
            if all(h in dropped for h in ri.created_events):
                drop_rounds.append(r)
                self._round_ctx.pop(r, None)
            elif r < new_scan_base:
                new_scan_base = r

        self.store.prune_below(floor_round, drop_events, drop_rounds, floors)

        self._prune_scan_base = new_scan_base
        self.prune_floor = floor_round
        # Same boundary fast-sync establishes: rounds at/below the floor
        # are never re-queued for fame voting, and the round-received
        # scan skips their gaps (_rr_scan).
        if self.round_lower_bound is None or floor_round > self.round_lower_bound:
            self.round_lower_bound = floor_round

        return {
            "floor": floor_round,
            "events_pruned": len(drop_events),
            "rounds_pruned": len(drop_rounds),
        }

    # =========================================================================
    # Reset / bootstrap
    # =========================================================================

    def reset(self, block: Block, frame: Frame) -> None:
        """Re-base the hashgraph from a frame (fast-sync landing)
        (reference: hashgraph.go:1431-1470)."""
        self.last_consensus_round = None
        self.first_consensus_round = None
        self.anchor_block = None
        self.undetermined_events = []
        self._round_pending = []
        self.pending_rounds = PendingRoundsCache()
        self.pending_loaded_events = 0
        self.topological_index = 0
        self._accel_pending = 0
        self._accel_new_witnesses = []
        self._accel_fd_dirty = set()
        self._accel_itx_events = set()
        self._round_ctx = {}
        if self.accel is not None:
            # An in-flight sweep's snapshot no longer describes this store.
            self.accel.invalidate()

        cs = self.store.cache_size()
        self._ancestor_cache = LRU(cs)
        self._self_ancestor_cache = LRU(cs)
        self._strongly_see_cache = LRU(cs)
        self._round_cache = LRU(cs)
        self._timestamp_cache = LRU(cs)
        self._witness_cache = LRU(cs)

        self.store.reset(frame)

        for fe in frame.sorted_frame_events():
            self.insert_frame_event(fe)

        self.store.set_block(block)
        self._set_last_consensus_round(block.round_received())
        self.round_lower_bound = block.round_received()

    def bootstrap(self) -> None:
        """Replay a persistent store's events through consensus in
        topological order — only from index 0 (reference: hashgraph.go:1481-1536).
        The persistent store provides topological_events(); InmemStore has
        nothing to replay."""
        topo = getattr(self.store, "topological_events", None)
        if topo is None:
            return
        maintenance = getattr(self.store, "set_maintenance_mode", None)
        if maintenance is not None:
            maintenance(True)
        try:
            batch_size = 100
            index = 0
            while True:
                events = topo(index * batch_size, batch_size)
                for e in events:
                    self.insert_event_and_run_consensus(e, set_wire_info=True)
                self.flush_consensus()
                self.process_sig_pool()
                if len(events) < batch_size:
                    break
                index += 1
        finally:
            if maintenance is not None:
                maintenance(False)

    # =========================================================================
    # Wire conversion / block checks
    # =========================================================================

    def read_wire_info(self, wevent: WireEvent, overlay=None) -> Event:
        """WireEvent → Event: resolve (creatorID, index) pairs back to
        parent hashes via the participant indexes (reference: hashgraph.go:1540-1595).

        ``overlay`` is an optional {(pub_key_hex, index): event_hex} map of
        events decoded earlier in the same sync batch but not yet inserted —
        it lets the accelerator path decode a whole batch ahead of insertion
        for batched signature verification without changing the sequential
        semantics (parents still must be in the store by insert time)."""
        self_parent = ""
        other_parent = ""

        def resolve(pub_hex: str, idx: int) -> str:
            try:
                return self.store.participant_event(pub_hex, idx)
            except Exception:
                if overlay is not None:
                    h = overlay.get((pub_hex, idx))
                    if h is not None:
                        return h
                raise UnknownParentError(
                    f"parent ({pub_hex[:16]}…, {idx}) not known"
                )

        creator = self.store.repertoire_by_id().get(wevent.body.creator_id)
        if creator is None:
            raise UnknownParticipantError(
                f"creator {wevent.body.creator_id} not found"
            )
        creator_bytes = creator.pub_key_bytes()

        if wevent.body.self_parent_index >= 0:
            self_parent = resolve(
                creator.pub_key_hex, wevent.body.self_parent_index
            )

        if wevent.body.other_parent_index >= 0:
            op_creator = self.store.repertoire_by_id().get(
                wevent.body.other_parent_creator_id
            )
            if op_creator is None:
                raise UnknownParticipantError(
                    f"participant {wevent.body.other_parent_creator_id} not found"
                )
            other_parent = resolve(
                op_creator.pub_key_hex, wevent.body.other_parent_index
            )

        body = EventBody(
            transactions=wevent.body.transactions,
            internal_transactions=wevent.body.internal_transactions,
            block_signatures=wevent.block_signatures(creator_bytes),
            parents=[self_parent, other_parent],
            creator=creator_bytes,
            index=wevent.body.index,
            timestamp=wevent.body.timestamp,
            self_parent_index=wevent.body.self_parent_index,
            other_parent_creator_id=wevent.body.other_parent_creator_id,
            other_parent_index=wevent.body.other_parent_index,
            creator_id=wevent.body.creator_id,
        )
        return Event(body, signature=wevent.signature)

    def check_block(self, block: Block, peer_set: PeerSet) -> None:
        """Validate a block carries MORE than 1/3 valid signatures from the
        given peer-set (reference: hashgraph.go:1599-1630)."""
        if peer_set.hash() != block.peers_hash():
            raise ValueError("wrong peer-set")
        valid = 0
        for s in block.get_signatures():
            if s.validator_hex() not in peer_set.by_pub_key:
                continue
            if block.verify_signature(s):
                valid += 1
        if valid <= peer_set.trust_count():
            raise ValueError(
                f"not enough valid signatures: got {valid}, "
                f"need more than {peer_set.trust_count()}"
            )

    # =========================================================================
    # Setters
    # =========================================================================

    def _set_last_consensus_round(self, i: int) -> None:
        self.last_consensus_round = i
        if self.first_consensus_round is None:
            self.first_consensus_round = i
