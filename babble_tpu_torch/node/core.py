"""Core: the node's façade over the hashgraph.

Reference semantics: src/node/core.go — head/seq tracking (:143-177),
sync + heads-merge (:210-289), addSelfEvent (:292-333), commit callback
(:486-537), accepted-internal-transaction processing with the +6
effective-round rule (:562-650), eventDiff (:660-703), pools (:740-758).
"""

from __future__ import annotations

import logging
import os
import queue
from typing import Callable, Dict, List, Optional

from ..hashgraph.block import Block
from ..hashgraph.errors import ForkError, is_normal_self_parent_error
from ..hashgraph.event import Event, WireEvent, sort_topological
from ..hashgraph.frame import Frame
from ..hashgraph.hashgraph import Hashgraph
from ..hashgraph.internal_transaction import (
    InternalTransaction,
    InternalTransactionReceipt,
    TransactionType,
)
from ..hashgraph.store import Store
from ..mempool import Mempool
from ..peers.peer_set import PeerSet
from .peer_selector import RandomPeerSelector
from .promise import JoinPromise
from .sentry import Sentry
from .validator import Validator

logger = logging.getLogger(__name__)


# All consistent hashgraphs will have decided the fame of round r witnesses
# by round r+5, so a new peer-set becomes effective at round r+6 (whitepaper
# lemmas 5.15 and 5.17; reference: core.go:566-569).
PEER_SET_EFFECTIVE_DELAY = 6


class PreparedSync:
    """Lock-free ingest work for one incoming sync: the longest decodable
    prefix of the wire events, hashed and batch-signature-verified OUTSIDE
    the core lock. ``Core.sync`` consumes it under the lock, which then
    only pays for the ordered insert + DivideRounds sweep.

    Contract: must be built (``Core.prepare_sync``) from the SAME wire
    event list later passed to ``Core.sync`` — ``decoded[i]`` corresponds
    to ``wire_events[i]``."""

    __slots__ = ("wire_events", "decoded")

    def __init__(self, wire_events: List[WireEvent]):
        self.wire_events = wire_events
        self.decoded: List[Event] = []


class Core:
    """reference: core.go:19-100."""

    def __init__(
        self,
        validator: Validator,
        peers: PeerSet,
        genesis_peers: PeerSet,
        store: Store,
        proxy_commit_callback: Callable[[Block], object],
        maintenance_mode: bool = False,
        accelerated_verify: bool = False,
        accelerator_mesh: int = 0,
        accelerator_device: str = "cuda",
        mempool: Optional[Mempool] = None,
        sentry: Optional[Sentry] = None,
        clock=None,
        selector_rng=None,
        selfevent_burst: int = 0,
    ):
        # Time source (common/clock.py): event timestamps, leave-loop
        # deadlines, selector backoff, and every telemetry duration below
        # read through this handle. Default: the process wall clock; the
        # sim engine injects virtual time (docs/simulation.md).
        from ..common.clock import WALL

        self.clock = clock if clock is not None else WALL
        # The reference's north-star `--accelerator` switch: it turns on
        # the consensus offload below, and with BABBLE_DEVICE_VERIFY=1 on a
        # card, device verification of incoming sync chunks (K3,
        # _batch_prevalidate); otherwise chunks batch through the native
        # C++ verifier.
        self.accelerated_verify = accelerated_verify
        from babble_tpu_torch.crypto import batch as _host_batch

        self._host_batch_verify = _host_batch.available()
        self.validator = validator
        self.genesis_peers = genesis_peers
        self.validators = genesis_peers
        self.peers = peers
        # Misbehavior ledger (node/sentry.py): classified ingest
        # rejections score peers toward time-boxed quarantine; the
        # selector skips quarantined ids via the hook below.
        self.sentry = sentry if sentry is not None else Sentry()
        self.sentry.set_peer_count(len(peers.peers))
        self.peer_selector = RandomPeerSelector(
            peers,
            validator.id(),
            clock=self.clock.monotonic,
            rng=selector_rng,
            quarantine_check=self.sentry.is_quarantined,
        )
        self.proxy_commit_callback = proxy_commit_callback
        self.maintenance_mode = maintenance_mode

        self.head: str = ""
        self.seq: int = -1

        self.accepted_round: int = -1
        self.removed_round: int = -1
        self.target_round: int = -1
        self.last_peer_change_round: int = -1

        # Other-peers' head events awaiting inclusion as self-events
        # (reference: core.go:66-73).
        self.heads: Dict[int, Optional[Event]] = {}

        # Client transactions live in the mempool (bounded, deduplicating,
        # own lock — docs/mempool.md); the internal-transaction pool keeps
        # its own small list path (membership itxs are rare and trusted).
        self.mempool = mempool if mempool is not None else Mempool()
        self.internal_transaction_pool: List[InternalTransaction] = []
        self.self_block_signatures = {}  # key -> BlockSignature
        self.promises: Dict[str, JoinPromise] = {}

        # Batched-ingest fast-path counters (surfaced via Node.get_stats
        # and bench.py): on the happy path every incoming sync costs
        # exactly ONE native batch-verify call, and fallback_singles
        # counts the per-event scalar re-checks that pinpoint offenders
        # after a batch reported failures.
        self.ingest_syncs = 0
        self.ingest_batch_verifies = 0
        self.ingest_batch_size_max = 0
        self.ingest_fallback_singles = 0

        # Coalesced self-event minting (docs/gossip.md §Adaptive
        # scheduling): when the mempool still holds a full event's worth
        # of transactions after the regular per-sync/monologue
        # self-event, mint up to ``selfevent_burst`` extra events in the
        # SAME lock hold — a hot mempool drains at burst x event_max_txs
        # per tick instead of one event cap per gossip round. 0 keeps
        # the reference's one-event-per-tick shape.
        self.selfevent_burst = max(0, int(selfevent_burst))
        self.selfevent_coalesced = 0

        # Commit listeners (docs/clients.md): called AFTER a block is
        # fully committed (state hash + receipts filled, own signature
        # attached) — the hook feeding the tx→block proof index and the
        # subscription hub. Listeners must be cheap/non-blocking; a
        # listener crash is contained so consensus can never stall on
        # the read tier.
        self.commit_listeners: List[Callable[[Block], None]] = []

        self.hg = Hashgraph(store, self.commit)
        self.hg.init(genesis_peers)
        # Fork evidence is scored against the *creator*, not the relaying
        # peer — resolve its id through the live repertoire.
        self.sentry.set_creator_resolver(
            lambda pub_hex: (
                p.id
                if (p := self.hg.store.repertoire_by_pub_key().get(pub_hex))
                is not None
                else None
            )
        )

        if accelerated_verify:
            # The same flag gates the consensus offload: fame and
            # round-received come off the device in batched sweeps
            # (reference hot loop: hashgraph.go:644-668), on the device
            # the caller names (the card by default; no card raises here).
            # Node.init attaches a multi-device mesh (--accelerator-mesh).
            from ..hashgraph.accel import TensorConsensus

            self.accelerator_mesh = accelerator_mesh
            self.hg.accel = TensorConsensus(
                device=accelerator_device,
                clock=self.clock,
                owner=validator.moniker or validator.public_key_hex(),
            )

        # Telemetry (docs/observability.md): the per-node registry wiring
        # every subsystem's counters into instruments, created at the
        # core so standalone cores (benches, tests) measure identically
        # to full nodes. _stage_obs is None under BABBLE_OBS=0 — the
        # timing sites below null-check it and skip even the clock reads.
        from ..obs.telemetry import NodeTelemetry

        self.obs = NodeTelemetry(self)
        self._stage_obs = self.obs.stage_observer
        self.hg.stage_observer = self._stage_obs
        # The @staged decorator times hashgraph stages against this
        # clock, so simulated runs record virtual durations.
        self.hg.stage_clock = self.clock.perf_counter

    # -- head/seq -----------------------------------------------------------

    def set_head_and_seq(self) -> None:
        """reference: core.go:143-177."""
        head = ""
        seq = -1
        if self.validator.id() in self.hg.store.repertoire_by_id():
            try:
                last = self.hg.store.last_event_from(self.validator.public_key_hex())
            except Exception:
                last = ""
            if last:
                head = last
                seq = self.hg.store.get_event(last).index()
        self.head = head
        self.seq = seq

    def bootstrap(self) -> None:
        self.hg.bootstrap()

    def set_peers(self, ps: PeerSet) -> None:
        """reference: core.go:185-188. ``prior`` carries the surviving
        peers' health scores and backoff state across the rebuild, so a
        membership change doesn't amnesty every failing peer."""
        self.peers = ps
        self.sentry.set_peer_count(len(ps.peers))
        self.peer_selector = RandomPeerSelector(
            ps, self.validator.id(), prior=self.peer_selector
        )

    # -- busy ---------------------------------------------------------------

    def busy(self) -> bool:
        """Unfinished work gates the fast heartbeat
        (reference: core.go:196-202)."""
        return (
            self.hg.pending_loaded_events > 0
            or self.mempool.pending_count > 0
            or len(self.internal_transaction_pool) > 0
            or len(self.self_block_signatures) > 0
            or (self.hg.accel is not None and self.hg.accel.busy())
            or (
                self.hg.last_consensus_round is not None
                and self.hg.last_consensus_round < self.target_round
            )
        )

    # -- sync ---------------------------------------------------------------

    def prepare_sync(self, unknown_events: List[WireEvent]) -> PreparedSync:
        """Lock-free ingest stage: decode + hash the longest possible
        prefix of an incoming sync and verify all its signatures in ONE
        native batch call. Callers (node gossip/eager-sync handlers) run
        this BEFORE taking the core lock, so the lock only serializes the
        ordered insert + DivideRounds sweep.

        Thread-safety: the store is append-only for events (an index,
        once assigned, never re-resolves to a different hash), so the
        parent resolution in read_wire_info is snapshot-safe against
        concurrent inserts; the overlay covers parents that ride in the
        same sync. A decode stall (parent/creator only resolvable after
        inserting earlier events, e.g. a mid-batch membership change)
        cuts the prefix — Core.sync re-decodes the tail under the lock
        with the same chunked semantics as the reference's sequential
        decode+insert (core.go:210-289)."""
        prepared = PreparedSync(unknown_events)
        if not (self.accelerated_verify or self._host_batch_verify):
            # Sequential scalar path: decode and verify under the lock,
            # exactly the reference shape.
            return prepared
        decoded, _ = self._decode_chunk(unknown_events, 0)
        if decoded:
            self._batch_prevalidate(decoded)
        prepared.decoded = decoded
        return prepared

    def _decode_chunk(
        self, unknown_events: List[WireEvent], start: int
    ) -> tuple[List[Event], int]:
        """Decode the longest decodable run of ``unknown_events[start:]``,
        resolving same-sync parents through an overlay of the events
        decoded so far. Returns (decoded, next_pos); a decode stall cuts
        the run at next_pos. Shared by the lock-free prepare stage and
        sync's under-lock tail so their semantics can never diverge."""
        obs = self._stage_obs
        t0 = self.clock.perf_counter() if obs is not None else 0.0
        overlay: Dict[tuple, str] = {}
        decoded: List[Event] = []
        j = start
        n = len(unknown_events)
        while j < n:
            try:
                ev = self.hg.read_wire_info(unknown_events[j], overlay)
            except Exception:
                break
            # first decode at a (creator, index) slot wins — mirroring
            # insert semantics, where the first event to occupy a slot is
            # the one that lands and a conflicting twin is refused; a
            # hostile batch carrying both fork branches must not have the
            # SECOND branch hijack later parent resolution.
            overlay.setdefault((ev.creator(), ev.index()), ev.hex())
            decoded.append(ev)
            j += 1
        if obs is not None:
            obs("decode", self.clock.perf_counter() - t0)
        return decoded, j

    def _device_verify(self) -> bool:
        """Whether sync chunks verify on the card (K3): opt-in
        (``BABBLE_DEVICE_VERIFY=1``) with ``--accelerator`` on a CUDA
        device, as the JAX package asks for a live accelerator
        (babble_tpu/node/core.py:323-344). With ``accelerator_device``
        "cpu" the chunk takes the native host batch verifier, the
        reference's rule on its CPU fallback: the caller asked for the
        CPU, so nothing is hidden, and no card run is claimed."""
        return (
            self.accelerated_verify
            and os.environ.get("BABBLE_DEVICE_VERIFY") == "1"
            and self.hg.accel.device.type == "cuda"
        )

    def _batch_prevalidate(self, decoded: List[Event]) -> None:
        """Verify a decoded chunk's signatures in one batch call, then
        pinpoint offenders: events the batch flagged are re-checked
        through the scalar verifier one by one, so a batch-layer artifact
        can never reject a valid event and a genuinely bad event is
        identified exactly (its verdict stays cached for insert to
        reject)."""
        obs = self._stage_obs
        t_verify = self.clock.perf_counter() if obs is not None else 0.0
        if self._device_verify():
            from babble_tpu_torch.ops.verify import prevalidate_events

            # no fallback: a build, launch or CUDA error raises out of here
            prevalidate_events(decoded, self.hg.accel.device)
        else:
            from babble_tpu_torch.crypto.batch import prevalidate_events_host

            if not prevalidate_events_host(decoded):
                # Native library unavailable: scalar verify at insert.
                if obs is not None:
                    obs("batch_verify", self.clock.perf_counter() - t_verify)
                return
        self.ingest_batch_verifies += 1
        if len(decoded) > self.ingest_batch_size_max:
            self.ingest_batch_size_max = len(decoded)
        for ev in decoded:
            if ev.prevalidated() is False:
                ev.clear_prevalidation()
                ev.prevalidate(ev.verify())
                self.ingest_fallback_singles += 1
        if obs is not None:
            obs("batch_verify", self.clock.perf_counter() - t_verify)

    def sync(
        self,
        from_id: int,
        unknown_events: List[WireEvent],
        prepared: Optional[PreparedSync] = None,
        hop: Optional[dict] = None,
    ) -> None:
        """Insert wire events (topological order expected), track the other
        peer's head, and record a new self-event when busy
        (reference: core.go:210-289).

        ``prepared`` is the lock-free stage's output for these SAME wire
        events (see prepare_sync); without it the stage runs inline here,
        preserving the one-batch-verify-per-sync property for direct
        callers.

        ``hop`` is the carrying sync's causal-trace info
        (``{"from", "ctx", "recv"}`` — the node handlers build it from
        the RPC's trace context and arrival stamp); sampled transactions
        in newly inserted events get a first-seen provenance record with
        wire/queue/insert attribution (obs/provenance.py)."""
        self.ingest_syncs += 1
        if prepared is None:
            prepared = self.prepare_sync(unknown_events)
        elif prepared.wire_events is not unknown_events:
            # decoded[i] pairs positionally with wire_events[i]; a
            # prepared stage built from a different list would silently
            # mis-pair verified events with wire bookkeeping
            raise ValueError("prepared sync does not match wire events")
        prov = self.obs.provenance
        if prov is not None and prov.enabled and unknown_events:
            hop = dict(hop) if hop is not None else {}
            hop.setdefault("from", from_id)
            hop["start"] = self.clock.time()
        else:
            hop = None
        other_head: Optional[Event] = None
        n = len(unknown_events)
        # Equivocations are skip-and-collect, not abort: a fork-holding
        # honest peer's diff leads with its branch of the fork every
        # round, and aborting there would permanently wedge ingestion of
        # everything that peer exclusively holds. The first ForkError is
        # re-raised AFTER the batch (and heads/consensus bookkeeping)
        # completes, so the node's sentry still sees it.
        fork_errs: List[ForkError] = []

        pos = len(prepared.decoded)
        try:
            for we, ev in zip(unknown_events[:pos], prepared.decoded):
                other_head = self._ingest_one(
                    we, ev, from_id, other_head, fork_errs, hop
                )

            while pos < n:
                # Tail after a decode stall: re-run decode+batch-verify in
                # chunks under the lock, resuming after the stalled inserts
                # land — identical semantics to the reference's sequential
                # decode+insert, just batched where the DAG allows.
                decoded: List[Event] = []
                j = pos
                if self.accelerated_verify or self._host_batch_verify:
                    decoded, j = self._decode_chunk(unknown_events, pos)
                    if decoded:
                        self._batch_prevalidate(decoded)
                if j == pos:
                    # Sequential path (accelerator off, or chunk stalled at
                    # the first event — let read_wire_info raise its real
                    # error).
                    decoded = [self.hg.read_wire_info(unknown_events[pos])]
                    j = pos + 1

                for we, ev in zip(unknown_events[pos:j], decoded):
                    other_head = self._ingest_one(
                        we, ev, from_id, other_head, fork_errs, hop
                    )
                pos = j
        except Exception as err:
            # An event this store cannot take yet ends the batch: say its
            # creator joined in a block not committed here. With the
            # offload, the decisions on the events inserted so far wait for
            # a flush; without one, a node that replays history (a joiner)
            # never commits the block that registers that creator, and the
            # peer sends the same event first at every sync. Flush before
            # the error propagates (a no-op without the offload, whose
            # oracle decides at every insert).
            self.hg.flush_consensus()
            # A fork collected before that error is evidence the node would
            # never see: it observes only the error raised here. Say an
            # honest peer relays the other branch of a fork and then its own
            # event on that branch, which fails verification against our
            # branch: without the proof on file, the sentry scores the
            # relayer for the equivocator's fork (and can quarantine honest
            # peers up to the framing cap). So the forks ride on the error,
            # and Sentry.observe_rejection observes the first of them before
            # the error itself (outside the core lock, where the node scores).
            if fork_errs:
                err.forks = fork_errs
            raise

        # Do not overwrite a non-empty head with an empty one
        # (reference: core.go:246-252).
        existing = self.heads.get(from_id)
        if (
            from_id not in self.heads
            or existing is None
            or (other_head is not None and other_head.index() > existing.index())
        ):
            self.heads[from_id] = other_head

        # Only record a new self-event when there is something to say
        # (reference: core.go:264-270).
        if self.busy() or self.seq < 0:
            self.record_heads()
            self.drain_hot_mempool()

        # One batched voting sweep per sync covers every event inserted
        # above (device path; no-op on the oracle path).
        self.hg.flush_consensus()

        if fork_errs:
            raise fork_errs[0]

    def _ingest_one(
        self,
        we: WireEvent,
        ev: Event,
        from_id: int,
        other_head: Optional[Event],
        fork_errs: Optional[List[ForkError]] = None,
        hop: Optional[dict] = None,
    ) -> Optional[Event]:
        """Insert one decoded sync event and maintain the heads-merge
        bookkeeping; returns the updated other-peer head. A ForkError is
        collected into ``fork_errs`` (the insert is still refused) so
        the batch continues past it — see Core.sync."""
        try:
            self.insert_event_and_run_consensus(ev, set_wire_info=False)
        except ForkError as err:
            if fork_errs is None:
                raise
            fork_errs.append(err)
            return other_head
        except Exception as err:
            if is_normal_self_parent_error(err):
                # Benign concurrent-duplicate-insert race.
                return other_head
            raise

        if hop is not None and ev.body.transactions:
            # first local sight of this event's transactions: stamp the
            # sampled ones with per-hop attribution (duplicate inserts
            # never reach here — they raise above)
            self.obs.provenance.first_seen_batch(
                ev.body.transactions, hop
            )

        if we.body.creator_id == from_id:
            other_head = ev

        stale = self.heads.get(we.body.creator_id)
        if stale is not None and we.body.index > stale.index():
            del self.heads[we.body.creator_id]
        return other_head

    def record_heads(self) -> None:
        """reference: core.go:274-289."""
        for fid in list(self.heads.keys()):
            ev = self.heads[fid]
            self.add_self_event(ev.hex() if ev is not None else "")
            del self.heads[fid]

    def drain_hot_mempool(self) -> int:
        """Coalesced self-event minting under load: while a FULL
        event's worth of transactions is still pending after the
        regular self-event, mint up to ``selfevent_burst`` more (each
        chained on our own head, like a monologue event) so the backlog
        drains in one lock hold instead of one event cap per gossip
        tick. Deterministic — pure function of mempool/DAG state — so
        the sim engine replays it byte-identically. Returns the number
        of extra events minted."""
        minted = 0
        cap = max(1, self.mempool.event_max_txs)
        while (
            minted < self.selfevent_burst
            and self.mempool.pending_count >= cap
        ):
            before = self.mempool.pending_count
            try:
                self.add_self_event("")
            except Exception:
                logger.debug("coalesced self-event failed", exc_info=True)
                break
            if self.mempool.pending_count >= before:
                break  # no progress (too-early guard or requeue): stop
            minted += 1
        self.selfevent_coalesced += minted
        return minted

    def add_self_event(self, other_head: str) -> None:
        """Package the pools into a new head event
        (reference: core.go:292-333)."""
        if self.hg.store.last_round() < self.accepted_round:
            logger.debug(
                "too early to insert self-event (%d/%d)",
                self.hg.store.last_round(),
                self.accepted_round,
            )
            return

        obs = self._stage_obs
        t_event = self.clock.perf_counter() if obs is not None else 0.0
        sigs = list(self.self_block_signatures.values())
        n_itxs = len(self.internal_transaction_pool)

        # Batch drain under the mempool's caps: each self-event carries at
        # most event_max_txs / event_max_bytes of client transactions, so
        # gossip payloads stay bounded under sustained overload; leftovers
        # keep busy() true and ride the next event (FIFO fairness).
        txs = self.mempool.drain()
        if obs is not None:
            obs("mempool_drain", self.clock.perf_counter() - t_event)

        new_head = Event.new(
            txs,
            self.internal_transaction_pool[:n_itxs],
            sigs,
            [self.head, other_head],
            self.validator.public_key_bytes(),
            self.seq + 1,
            timestamp=int(self.clock.time()),
        )

        # Inserting can add items to the pools via the commit callback, so
        # only the packaged prefix is dropped (reference: core.go:325-330).
        # A failed insert puts the drained batch back at the FRONT of the
        # mempool — accepted transactions are never lost to a transient
        # event-creation failure.
        try:
            self.sign_and_insert_self_event(new_head)
        except Exception:
            self.mempool.requeue(txs)
            raise
        self.internal_transaction_pool = self.internal_transaction_pool[n_itxs:]
        for s in sigs:
            self.self_block_signatures.pop(s.key(), None)
        if obs is not None:
            # whole self-event packaging incl. its insert+DivideRounds
            # (the nested insert/divide_rounds stages record too)
            obs("self_event", self.clock.perf_counter() - t_event)

    def sign_and_insert_self_event(self, event: Event) -> None:
        """reference: core.go:337-343."""
        event.sign(self.validator.key)
        self.insert_event_and_run_consensus(event, set_wire_info=True)

    def insert_event_and_run_consensus(
        self, event: Event, set_wire_info: bool
    ) -> None:
        """reference: core.go:346-355."""
        self.hg.insert_event_and_run_consensus(event, set_wire_info)
        if event.creator() == self.validator.public_key_hex():
            self.head = event.hex()
            self.seq = event.index()

    def known_events(self) -> Dict[int, int]:
        return self.hg.store.known_events()

    # -- fast-forward -------------------------------------------------------

    def fast_forward(self, block: Block, frame: Frame) -> None:
        """Reset the hashgraph from a trusted Block+Frame
        (reference: core.go:367-402)."""
        peer_set = frame.peers

        self.hg.check_block(block, peer_set)

        if block.frame_hash() != frame.hash():
            raise ValueError("invalid frame hash")

        self.hg.reset(block, frame)
        self.set_head_and_seq()
        # The validator-set the block's committers held is the last peer-set
        # registered before it: a change committed in an earlier block is
        # registered PEER_SET_EFFECTIVE_DELAY rounds ahead, so it may not be
        # in effect at the frame's round yet. Starting from the frame's
        # round's set instead, this node would apply the anchor block's own
        # membership receipts (Node._fast_forward) to a stale set, register a
        # different peer-set than its peers and fork (the reference and the
        # JAX package start from frame.peers).
        latest = (PeerSet(frame.peer_sets[max(frame.peer_sets)])
                  if frame.peer_sets else peer_set)
        self.set_peers(latest)
        self.validators = latest

    def get_anchor_block_with_frame(self) -> tuple[Block, Frame]:
        return self.hg.get_anchor_block_with_frame()

    # -- leave --------------------------------------------------------------

    def leave(self, leave_timeout: float, lock=None) -> None:
        """Politely leave: submit a PEER_REMOVE itx and wait for consensus
        (reference: core.go:416-479). ``lock`` is the owning node's core
        lock, held only while mutating the pools — the consensus wait must
        happen outside it."""
        if self.maintenance_mode:
            return
        # A rejoining node can reach BABBLING (its join was accepted
        # remotely) while its OWN replay is still catching up through
        # history — at that instant self.validators may reflect an older
        # epoch that does not contain us (it may even have just replayed
        # our previous leave). Treating that stale view as "not a
        # validator" silently skips the leave and strands a ghost
        # validator in everyone's peer-set forever (found by the looped
        # rejoin hunt, tests/test_node_rejoin_loop.py). Wait for the
        # replay to reach our join before concluding we have nothing to
        # do — capped below leave_timeout so a node that genuinely never
        # joined doesn't stall its shutdown for the whole timeout.
        deadline = self.clock.monotonic() + min(leave_timeout, 5.0)
        while True:
            p = self.validators.by_id.get(self.validator.id())
            if p is not None or self.clock.monotonic() > deadline:
                break
            self.clock.sleep(0.05)
        if p is None or len(self.validators) <= 1:
            return

        itx = InternalTransaction.leave(p)
        itx.sign(self.validator.key)
        if lock is not None:
            with lock:
                promise = self.add_internal_transaction(itx)
        else:
            promise = self.add_internal_transaction(itx)

        try:
            resp = promise.wait(timeout=leave_timeout)
        except queue.Empty:
            raise TimeoutError("timeout waiting for leave request consensus")

        logger.debug("leave accepted at round %d", resp.accepted_round)

        # Wait until consensus reaches the removed round
        # (reference: core.go:458-478).
        if len(self.peers) >= 1:
            deadline = self.clock.monotonic() + leave_timeout
            while (
                self.hg.last_consensus_round is None
                or self.hg.last_consensus_round < self.removed_round
            ):
                if self.clock.monotonic() > deadline:
                    raise TimeoutError("timeout waiting to reach removed round")
                self.clock.sleep(0.05)

    # -- commit -------------------------------------------------------------

    def commit(self, block: Block) -> None:
        """The hashgraph's commit callback: push the block to the app, sign
        it, and process membership receipts (reference: core.go:485-536)."""
        obs = self._stage_obs
        if obs is None:
            commit_response = self.proxy_commit_callback(block)
        else:
            t0 = self.clock.perf_counter()
            try:
                commit_response = self.proxy_commit_callback(block)
            finally:
                obs("proxy_deliver", self.clock.perf_counter() - t0)

        # Feed the committed-hash LRU atomically with the commit (under
        # the mempool's own lock): from here on a client retry of any of
        # these transactions gets `already_committed`, and pending copies
        # (same tx submitted to several nodes, committed via another's
        # event) are dropped before they can double-commit.
        self.mempool.mark_committed(block.transactions())

        # Provenance: close the sampled transactions' records with the
        # commit stamp + block coordinates (every node stamps its own
        # commit; traceview merges the spread).
        prov = self.obs.provenance
        if prov is not None and prov.enabled and block.transactions():
            prov.commit_batch(
                block.transactions(), block.index(), block.round_received()
            )

        block.body.state_hash = commit_response.state_hash
        block.body.internal_transaction_receipts = commit_response.receipts

        # Sign the block if we belong to its validator-set
        # (reference: core.go:510-522).
        block_peer_set = self.hg.store.get_peer_set(block.round_received())
        if self.validator.id() in block_peer_set.by_id:
            sig = self.sign_block(block)
            self.self_block_signatures[sig.key()] = sig

        self.hg.set_anchor_block(block)

        self.process_accepted_internal_transactions(
            block.round_received(), commit_response.receipts
        )

        for listener in self.commit_listeners:
            try:
                listener(block)
            except Exception:  # noqa: BLE001 — the read tier never stalls consensus
                logger.debug("commit listener failed", exc_info=True)

    def sign_block(self, block: Block):
        """reference: core.go:539-556."""
        sig = block.sign(self.validator.key)
        block.set_signature(sig)
        self.hg.store.set_block(block)
        return sig

    def process_accepted_internal_transactions(
        self, round_received: int, receipts: List[InternalTransactionReceipt]
    ) -> None:
        """Apply accepted PEER_ADD/PEER_REMOVE at round_received + 6
        (reference: core.go:562-650)."""
        current_peers = self.peers
        validators = self.validators
        effective_round = round_received + PEER_SET_EFFECTIVE_DELAY

        changed = False
        for r in receipts:
            body = r.internal_transaction.body
            if not r.accepted:
                continue
            if body.type == TransactionType.PEER_ADD:
                validators = validators.with_new_peer(body.peer)
                current_peers = current_peers.with_new_peer(body.peer)
            elif body.type == TransactionType.PEER_REMOVE:
                validators = validators.with_removed_peer(body.peer)
                current_peers = current_peers.with_removed_peer(body.peer)
                if body.peer.id == self.validator.id():
                    self.removed_round = effective_round
            else:
                continue
            changed = True

        if changed:
            self.last_peer_change_round = effective_round
            self.hg.store.set_peer_set(effective_round, validators)
            self.validators = validators
            self.set_peers(current_peers)
            # Force everyone to reach the effective round so joiners can
            # participate (reference: core.go:639-643).
            if effective_round > self.target_round:
                self.target_round = effective_round

        for r in receipts:
            promise = self.promises.pop(r.internal_transaction.hash_string(), None)
            if promise is not None:
                if r.accepted:
                    promise.respond(True, effective_round, self.validators.peers)
                else:
                    promise.respond(False, 0, [])

    # -- diff ---------------------------------------------------------------

    def event_diff(self, other_known: Dict[int, int]) -> List[Event]:
        """Events we know that the other does not, topologically ordered
        (reference: core.go:660-703)."""
        unknown: List[Event] = []
        my_known = self.known_events()
        repertoire = self.hg.store.repertoire_by_id()
        for pid in my_known:
            ct = other_known.get(pid, -1)
            peer = repertoire.get(pid)
            if peer is None:
                continue
            for eh in self.hg.store.participant_events(peer.pub_key_hex, ct):
                unknown.append(self.hg.store.get_event(eh))
        return sort_topological(unknown)

    def to_wire(self, events: List[Event]) -> List[WireEvent]:
        return [e.to_wire() for e in events]

    # -- pools --------------------------------------------------------------

    def process_sig_pool(self) -> None:
        self.hg.process_sig_pool()

    @property
    def transaction_pool(self) -> List[bytes]:
        """FIFO snapshot of the mempool's pending transactions (read-only
        compatibility view of the reference's transactionPool slice)."""
        return self.mempool.pending_txs()

    def add_transactions(self, txs: List[bytes]) -> List[str]:
        """Admit transactions through the mempool; returns the verdicts
        (reference: core.go:740-745 appended unconditionally)."""
        return self.mempool.submit_many(txs)

    def add_internal_transaction(self, tx: InternalTransaction) -> JoinPromise:
        """reference: core.go:747-758."""
        promise = JoinPromise(tx)
        self.promises[tx.hash_string()] = promise
        self.internal_transaction_pool.append(tx)
        return promise

    # -- getters ------------------------------------------------------------

    def get_head(self) -> Event:
        return self.hg.store.get_event(self.head)

    def get_event(self, h: str) -> Event:
        return self.hg.store.get_event(h)

    def get_consensus_events_count(self) -> int:
        return self.hg.store.consensus_events_count()

    def get_undetermined_events(self) -> List[str]:
        return self.hg.undetermined_events

    def get_last_block_index(self) -> int:
        return self.hg.store.last_block_index()

    def get_last_consensus_round_index(self) -> Optional[int]:
        return self.hg.last_consensus_round

    def get_consensus_transactions_count(self) -> int:
        return self.hg.consensus_transactions
