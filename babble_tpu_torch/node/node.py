"""Node: the top-level actor running the gossip state machine.

Reference semantics: src/node/node.go — Init picks the starting state
(:128-164), Run dispatches on state (:168-199), doBackgroundWork drains
the transport and submit queues (:341-361), babble() gossips on timer
ticks (:416-463), gossip = pull + push (:466-615), fastForward (:622-701),
join (:709-751), suspend (:384-408); RPC handlers in src/node/node_rpc.go.

Threading model: one background worker thread (transport consumer +
submit queue), one state-machine thread, gossip rounds on the bounded
routine pool, all hashgraph access serialized by core_lock — mirroring
the reference's coreLock discipline (node.go:35).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional

from ..config.config import Config
from ..hashgraph.errors import is_normal_self_parent_error
from ..hashgraph.event import WireEvent
from ..hashgraph.internal_transaction import InternalTransaction
from ..hashgraph.store import Store
from ..net.rpc import (
    EagerSyncRequest,
    EagerSyncResponse,
    FastForwardRequest,
    FastForwardResponse,
    JoinRequest,
    JoinResponse,
    RPC,
    SyncRequest,
    SyncResponse,
)
from ..net.transport import RemoteError, Transport, TransportError
from ..obs.provenance import parse_ctx
from ..peers.peer import Peer
from ..peers.peer_set import PeerSet
from ..common.latency import LatencyRecorder
from ..common import lockcheck
from ..common.timed_lock import TimedLock
from ..proxy.proxy import AppProxy
from .control_timer import ControlTimer
from .core import Core, PreparedSync
from .state import State, StateManager
from .validator import Validator

logger = logging.getLogger(__name__)


class Node(StateManager):
    """reference: node/node.go:22-75."""

    def __init__(
        self,
        conf: Config,
        validator: Validator,
        peers: PeerSet,
        genesis_peers: PeerSet,
        store: Store,
        trans: Transport,
        proxy: AppProxy,
    ):
        super().__init__()
        self.conf = conf
        self.logger = conf.logger("node")
        # THE node's time source (common/clock.py): every deadline,
        # sleep, and duration measurement below reads through this one
        # handle, so the sim engine can swap in virtual time wholesale.
        self.clock = conf.clock
        from ..mempool import Mempool
        from .sentry import Sentry

        selector_rng = conf.seeded_rng("selector", validator.id())
        # Jitter stream for the join/fast-forward retry backoffs below;
        # None (production) lets backoff draw from the global random.
        self._backoff_rng = conf.seeded_rng("backoff", validator.id())
        self.core = Core(
            validator,
            peers,
            genesis_peers,
            store,
            proxy.commit_block,
            conf.maintenance_mode,
            accelerated_verify=conf.accelerator,
            accelerator_mesh=conf.accelerator_mesh,
            accelerator_device=conf.accelerator_device,
            mempool=Mempool.from_config(conf),
            sentry=Sentry.from_config(conf),
            clock=self.clock,
            selector_rng=selector_rng,
            selfevent_burst=conf.selfevent_burst,
        )
        # Equivocation proofs persist through the store's evidence table
        # (and load back on restart) when the store supports it.
        self.core.sentry.attach_store(store)
        # Telemetry: the core created its registry (docs/observability.md);
        # bind the node-level instruments (RPC counters, queue depth) and
        # take the sync-stage observer for the gossip legs below.
        self.telemetry = self.core.obs
        # Instrumented core lock: get_stats surfaces total acquisition
        # wait (lock_wait_ms_total) so lock-shrinking work stays measured;
        # contended waits also feed the core_lock_wait_seconds histogram.
        self.core_lock = TimedLock(
            observer=self.telemetry.lock_wait_observer,
            clock=self.clock.perf_counter,
            name="core",  # BABBLE_LOCKCHECK order recorder (lockcheck.py)
        )
        self.trans = trans
        self.proxy = proxy
        self.submit_q = proxy.submit_queue()
        # Synchronous admission: a proxy that supports it hands SubmitTx
        # straight to the mempool (its own lock, never the core lock) and
        # returns the verdict to the client; the queue below stays as the
        # fallback for proxies predating verdicts.
        if hasattr(proxy, "set_submit_handler"):
            proxy.set_submit_handler(self._admit_transaction)
        # Jitter stream for the heartbeat timer: seeded under sim so the
        # gossip cadence replays byte-identically (babblelint clock pass
        # caught the old global-random draw; docs/static_analysis.md).
        self.control_timer = ControlTimer(
            rng=conf.seeded_rng("control_timer", validator.id())
        )
        self.shutdown_event = threading.Event()
        self.suspend_event = threading.Event()
        self._threads: List[threading.Thread] = []
        self.start_time = 0.0
        self.sync_requests = 0
        self.sync_errors = 0
        # Per-RPC-type handler error counters (surfaced as rpc_errors_* in
        # get_stats): chaos runs use these to tell "request dropped by the
        # nemesis" (no counter moves) from "handler crashed" (it does).
        self.rpc_errors: Dict[str, int] = {
            "sync": 0,
            "eager_sync": 0,
            "fast_forward": 0,
            "join": 0,
        }
        # Receiving-side sync_limit enforcement: batches above our own
        # configured cap are truncated (both the eager-push handler and
        # the pull response) — a hostile peer must not dictate how much
        # we ingest per request.
        self.sync_limit_truncations = 0
        # Fast-forwards that landed (the store re-based on a peer's anchor
        # block). The port counts them for its fast-sync checks; the JAX
        # package's node has no such counter.
        self.fast_forwards = 0
        # Sender-side twin: OUR diff exceeded sync_limit and was cut
        # before the push. A peer that chronically trails by more than
        # one sync_limit shows up here — silent truncation was how the
        # lag hid.
        self.sync_diff_truncations = 0
        # Outbound gossip rounds lost to TransportErrors — the network-
        # fault counter the chaos soaks assert on (rpc_errors_* counts
        # handler crashes, this counts the wire).
        self.gossip_transport_errors = 0
        # Causal tracing (docs/observability.md §Causal tracing):
        # inbound RPCs carrying a wire trace context, and the last
        # SUCCESSFUL outbound gossip round (node clock, monotonic) — the
        # stall watchdog's gossip-liveness signal.
        self.trace_ctx_rpcs = 0
        self.last_gossip_ok: Optional[float] = None
        # Provenance knobs ride the Config; the table itself was built
        # by the core's NodeTelemetry (so standalone cores trace too).
        self.telemetry.provenance.configure(
            sample=conf.trace_sample, cap=conf.trace_table_cap
        )
        # Stall flight recorder (obs/flight.py): armed by run(), fired
        # when a busy node stops making consensus progress.
        from ..obs.flight import StallWatchdog

        self.watchdog = StallWatchdog(
            self,
            stall_s=conf.watchdog_stall_s,
            interval_s=conf.watchdog_interval_s,
            out_dir=conf.flight_dir,
        )
        # Joining-state backoff: consecutive join failures grow the retry
        # sleep exponentially (capped by conf.join_backoff_cap) so a node
        # stuck outside a partitioned cluster doesn't hammer dead peers.
        self._join_failures = 0
        # Gossip-leg durations, served at /debug/timers (the reference logs
        # the same ns durations per round, node.go:511-514,543-548,593-608).
        self.timers = LatencyRecorder()
        self.initial_undetermined_events = 0
        # Cap overlapping gossip rounds: unbounded overlap just piles
        # threads onto core_lock under the GIL (the Go reference relies on
        # cheap goroutines; here a small in-flight cap keeps the pipeline
        # full). Sized for the adaptive fan-out: a full-fan tick plus one
        # straggler from the previous tick.
        self._gossip_slot_cap = max(2, conf.gossip_max_fanout + 1)
        self._gossip_slots = threading.Semaphore(self._gossip_slot_cap)
        # Rounds currently occupying a slot, and the tick-start snapshot
        # of it (rounds still running FROM THE PREVIOUS tick) — the
        # adaptive controller's "our own gossip is overrunning the
        # cadence" congestion signal. The snapshot, not the live value:
        # sampled right after a fan-out spawn the live count is trivially
        # high and would brake a perfectly healthy node.
        self._gossip_rounds_inflight = 0
        self._rounds_carryover = 0
        self._rounds_lock = threading.Lock()
        # Adaptive gossip scheduler (node/adaptive.py, docs/gossip.md
        # §Adaptive scheduling): maps live load signals to the next
        # tick's interval / fan-out / pipeline soft depth. None (the
        # BABBLE_ADAPT=0 kill switch or adaptive_gossip=false) falls
        # back to the fixed two-speed heartbeat, bit for bit.
        self.adaptive = None
        if conf.adaptive_gossip:
            from .adaptive import AdaptiveGossipController

            self.adaptive = AdaptiveGossipController.from_config(conf)
        self._plan_lock = threading.Lock()
        self._fanout = 1
        # Last stateful controller fold (monotonic): _reset_timer runs
        # after EVERY handled RPC, and each fold moves the EWMAs — so
        # folds are rate-limited to one per fast-rail interval, or an
        # RPC burst would collapse the smoothing exactly when it
        # matters. Between folds the published plan is reused.
        self._last_plan_t = float("-inf")
        # Per-peer lag from exchanged known-maps (healthview's
        # advance-rate idea moved into the node): how many events each
        # peer trails us by, and how many we trail them by — the
        # adaptive controller's spread/tempo signals.
        self._lag_lock = threading.Lock()
        self._peer_behind: Dict[int, int] = {}
        self._self_behind: Dict[int, int] = {}
        # Inbound-sync pipeline (node/pipeline.py): decode+batch-verify
        # overlap across handler threads, the insert tail drains through
        # one serialized inserter, bounded queue backpressures the
        # transport. Wall-clock only — the deterministic sim engine
        # drives _process_rpc single-threaded under virtual time, where
        # a background inserter would break replay determinism.
        from ..common.clock import WALL

        self.pipeline = None
        if conf.gossip_pipeline and self.clock is WALL:
            from .pipeline import SyncPipeline

            self.pipeline = SyncPipeline(
                self, queue_cap=conf.gossip_pipeline_depth
            )
        # Light-client gateway tier (docs/clients.md): the tx→block
        # proof index always runs (GET /proof/<txid> works on any node
        # with a service); the SubscriptionHub binds only when
        # --client-listen is set AND the node runs on the wall clock
        # (the sim engine drives commits deterministically and must not
        # grow a socket thread).
        from ..client.proofs import TxIndex

        self.txindex = TxIndex(conf.txindex_cap)
        # Index commits only when something can serve reads — a
        # subscription hub or the HTTP service (GET /proof). A pure
        # validator (--no-service, no --client-listen) skips the
        # per-commit sha256 walk and the index memory entirely; sim
        # clusters (no_service=True) keep their commit path lean too.
        self._txindex_enabled = bool(conf.client_listen) or not conf.no_service
        self.proofs_served = 0
        self.proof_misses = 0
        self.checkpoint_exports = 0
        # Lifecycle tier (docs/lifecycle.md): checkpoint-prune compaction,
        # driven from the gossip/monologue tails (_maybe_prune). Off by
        # default — prune_every_rounds=0 keeps the store append-only.
        self.pruner = None
        if conf.prune_every_rounds > 0:
            from ..lifecycle.pruner import CheckpointPruner

            self.pruner = CheckpointPruner(
                every_rounds=conf.prune_every_rounds,
                keep_rounds=conf.prune_keep_rounds,
                vacuum=conf.prune_vacuum,
            )
        # /checkpoint requests rejected for falling below the prune floor
        # (clients see the behind_retention slug, not a generic 404).
        self.behind_retention_rejections = 0
        # Store-footprint snapshot memo: size_stats on a persistent store
        # runs COUNT(*) queries, so the stats surface re-reads it at most
        # once a second.
        self._size_stats_memo: Dict[str, object] = {"t": -1.0, "v": None}
        self.client_hub = None
        if conf.client_listen and self.clock is WALL:
            from ..client.subhub import SubscriptionHub

            self.client_hub = SubscriptionHub(
                conf.client_listen,
                block_source=self.get_sealed_block,
                moniker=conf.moniker,
                queue_frames=conf.sub_queue_frames,
                stall_timeout_s=conf.sub_stall_timeout_s,
                shed_lag=conf.sub_shed_lag,
                sndbuf=conf.sub_sndbuf,
                clock=self.clock,
            )
            self.client_hub.listen()
        self.core.commit_listeners.append(self._on_commit_block)
        self.telemetry.bind_node(self)

    # -- lifecycle ----------------------------------------------------------

    def _attach_mesh(self) -> None:
        """Split the offload's sweeps over ``--accelerator-mesh`` cards
        (babble_tpu/node/node.py:314-340): the process's first n CUDA
        devices. A size that is not a power of two, which no power-of-two
        witness bucket divides, an offload on the CPU, or more cards than
        there are, logs a warning and the sweeps run on one device."""
        n = self.conf.accelerator_mesh
        accel = self.core.hg.accel
        if n <= 1 or accel is None:
            return
        if n & (n - 1):
            self.logger.warning(
                "--accelerator-mesh %d is not a power of two; no witness "
                "bucket would ever shard over it — running single-device", n)
            return
        if accel.device.type != "cuda":
            self.logger.warning(
                "--accelerator-mesh %d unavailable on a %s offload; sweeps "
                "run single-device", n, accel.device.type)
            return
        from babble_tpu_torch.parallel.mesh import consensus_mesh

        try:
            accel.mesh = consensus_mesh(n)
        except ValueError:
            self.logger.warning(
                "--accelerator-mesh %d unavailable (fewer cards); sweeps "
                "run single-device", n, exc_info=True)

    def init(self) -> None:
        """Pick the initial state (reference: node.go:128-164)."""
        if self.conf.accelerator:
            # The offload's device was resolved, and its kernels built,
            # when Core made its TensorConsensus: the card unless the
            # config names the CPU, and no card raised there, with no CPU
            # fallback. Nothing compiles while the node runs, so the
            # offload needs no prewarm.
            self._attach_mesh()
            if self.core._device_verify():
                # Device signature verification is opt-in; when asked for
                # on a card, build its kernel and verify one signature
                # before gossip starts (babble_tpu/node/node.py:363-372).
                from babble_tpu_torch.ops.verify import warmup

                warmup(self.core.hg.accel.device)
        if self.conf.bootstrap:
            self.core.bootstrap()
            with self.core_lock:
                self.core.set_head_and_seq()

        if not self.conf.maintenance_mode:
            self.trans.listen()
            if self.core.validator.id() in self.core.peers.by_id:
                self._set_babbling_or_catching_up_state()
            else:
                self._transition(State.JOINING)
        else:
            self._transition(State.SUSPENDED)

        self.initial_undetermined_events = len(self.core.get_undetermined_events())

    def run(self, gossip: bool = True) -> None:
        """Main loop (reference: node.go:168-199)."""
        if self.conf.maintenance_mode:
            return
        self.start_time = self.clock.monotonic()
        if self.telemetry.enabled:
            # flight recorder (no-op when watchdog_stall_s <= 0); only
            # the threaded production path arms the monitor — the sim
            # harness drives nodes without run() and calls check() itself
            self.watchdog.start()
            # always-on sampling profiler (obs/profile.py): ONE
            # process-wide sampler shared by co-located nodes, reading
            # thread stacks only — safe to arm from any node, off under
            # BABBLE_OBS=0 or profile_hz=0
            from ..obs import profile as obs_profile

            obs_profile.ensure_started(self.conf.profile_hz)
        self.control_timer.run(self.conf.heartbeat_timeout)
        bg = threading.Thread(target=self._do_background_work, daemon=True)
        bg.start()
        self._threads.append(bg)

        while True:
            state = self.get_state()
            if state == State.BABBLING:
                self._babble(gossip)
            elif state == State.CATCHING_UP:
                self._fast_forward()
            elif state == State.JOINING:
                self._join()
            elif state == State.SUSPENDED:
                self.clock.sleep(0.2)
            elif state == State.SHUTDOWN:
                return
            else:
                self.clock.sleep(0.05)

    def run_async(self, gossip: bool = True) -> None:
        t = threading.Thread(target=self.run, args=(gossip,), daemon=True)
        t.start()
        self._threads.append(t)

    def leave(self) -> None:
        """Politely leave the network (reference: node.go:207-224)."""
        if self.conf.maintenance_mode:
            return
        try:
            self.core.leave(self.conf.join_timeout, lock=self.core_lock)
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        """reference: node.go:228-246."""
        if self.get_state() != State.SHUTDOWN:
            self.logger.info("SHUTDOWN")
            self._transition(State.SHUTDOWN)
            self.shutdown_event.set()
            self.watchdog.stop()
            if self.pipeline is not None:
                self.pipeline.stop()
            if self.client_hub is not None:
                self.client_hub.close()
            self.control_timer.shutdown()
            self.wait_routines(timeout=2.0)
            if self.trans is not None:
                self.trans.close()
            self.core.hg.store.close()

    def suspend(self) -> None:
        """Stop gossiping but keep answering sync requests
        (reference: node.go:250-262)."""
        if self.get_state() not in (State.SUSPENDED, State.SHUTDOWN):
            self.logger.info("SUSPEND")
            self._transition(State.SUSPENDED)
            self.suspend_event.set()
            # the babble loop blocks on the tick event (no poll): wake
            # it so the suspend is observed now, not next heartbeat
            self.control_timer.poke()
            self.wait_routines(timeout=2.0)

    # -- getters ------------------------------------------------------------

    def get_id(self) -> int:
        return self.core.validator.id()

    def get_pub_key(self) -> str:
        return self.core.validator.public_key_hex()

    def get_block(self, index: int):
        return self.core.hg.store.get_block(index)

    def get_last_block_index(self) -> int:
        return self.core.get_last_block_index()

    def get_last_consensus_round_index(self) -> int:
        lcr = self.core.get_last_consensus_round_index()
        return -1 if lcr is None else lcr

    def get_peers(self) -> List[Peer]:
        return self.core.peers.peers

    def get_validator_set(self, round: int) -> List[Peer]:
        return self.core.hg.store.get_peer_set(round).peers

    def get_all_validator_sets(self) -> Dict[int, List[Peer]]:
        return self.core.hg.store.get_all_peer_sets()

    # -- light-client gateway tier (docs/clients.md) -------------------------

    def _on_commit_block(self, block) -> None:
        """Core commit listener: index the block's transactions for
        proofs (when a read surface exists) and advance the subscription
        hub's head watermark (O(1); the hub encodes and pushes from its
        own thread)."""
        if self._txindex_enabled:
            self.txindex.index_block(block)
        if self.client_hub is not None:
            self.client_hub.publish(block.index())

    def get_sealed_block(self, index: int):
        """Block ``index`` once SEALED — carrying MORE than 1/3
        validator signatures, the bar the anchor logic and every
        stateless verifier use — else None. The hub re-polls Nones, so
        subscribers see each block as soon as enough signatures have
        gossiped in, in order, with no gaps."""
        if index < 0 or index > self.core.get_last_block_index():
            return None
        try:
            block = self.core.hg.store.get_block(index)
            peer_set = self.core.hg.store.get_peer_set(
                block.round_received()
            )
        except Exception:  # noqa: BLE001 — evicted/missing: not servable
            return None
        if len(block.signatures) <= peer_set.trust_count():
            return None
        return block

    def get_proof(self, txid: str) -> Optional[Dict[str, object]]:
        """Signed Merkle inclusion proof for one committed transaction
        (GET /proof/<txid>; None = unknown/aged out → 404). Signatures
        accumulate for a round or two after commit — a proof fetched
        too early simply carries fewer of them and the client retries."""
        from ..client.proofs import build_proof

        loc = self.txindex.lookup(txid)
        if loc is None:
            self.proof_misses += 1
            return None
        try:
            block = self.core.hg.store.get_block(loc[0])
        except Exception:  # noqa: BLE001 — block aged out of the store
            self.proof_misses += 1
            return None
        self.proofs_served += 1
        return build_proof(block, loc[1])

    def get_checkpoint(
        self, at_round: Optional[int] = None, with_snapshot: bool = False
    ) -> Dict[str, object]:
        """Signed fast-sync checkpoint (GET /checkpoint): the anchor
        block + its frame. Raises ValueError while no block is sealed
        yet. ``at_round`` asks for coverage from a specific round: the
        earliest sealed block received at-or-after it. Below the prune
        floor that history is compacted away — BehindRetentionError,
        served as the distinct ``behind_retention`` slug so clients
        ratchet forward instead of retrying forever. ``with_snapshot``
        embeds the app snapshot at the anchor so a REJOINING VALIDATOR
        can proxy.restore before fast_forward (replicas don't need it;
        reference ships the same payload in FastForwardResponse)."""
        from ..client.checkpoint import make_checkpoint
        from ..lifecycle.pruner import BehindRetentionError

        with self.core_lock:
            floor = self.core.hg.prune_floor
            if at_round is not None and floor is not None and at_round < floor:
                self.behind_retention_rejections += 1
                raise BehindRetentionError(requested=at_round, floor=floor)
            if at_round is None:
                block, frame = self.core.get_anchor_block_with_frame()
            else:
                block = self._sealed_block_at_round(at_round)
                if block is None:
                    raise ValueError(
                        f"no sealed block at or after round {at_round}"
                    )
                frame = self.core.hg.get_frame(block.round_received())
            snapshot = None
            if with_snapshot:
                snapshot = self.proxy.get_snapshot(block.index())
            cp = make_checkpoint(block, frame, snapshot)
        self.checkpoint_exports += 1
        return cp

    def _sealed_block_at_round(self, at_round: int):
        """Earliest SEALED block with round_received >= at_round, or
        None. Blocks are round-monotonic in index, so binary search for
        the boundary, then walk forward past any not-yet-sealed blocks
        (signatures accumulate for a round or two after commit)."""
        store = self.core.hg.store
        last = self.core.get_last_block_index()
        if last < 0:
            return None
        lo, hi = 0, last
        while lo < hi:
            mid = (lo + hi) // 2
            try:
                if store.get_block(mid).round_received() < at_round:
                    lo = mid + 1
                else:
                    hi = mid
            except Exception:  # noqa: BLE001 — evicted: search higher
                lo = mid + 1
        for index in range(lo, last + 1):
            block = self.get_sealed_block(index)
            if block is not None and block.round_received() >= at_round:
                return block
        return None

    def get_stats_snapshot(self) -> Dict[str, object]:
        """One TYPED stats snapshot (numbers stay numbers) — the single
        source for ``get_stats`` (string view, the reference contract),
        the mobile JSON surface, and the /stats endpoint. The same
        underlying counters back the registry instruments served at
        /metrics (docs/observability.md; compat contract: docs/parity.md
        #27)."""
        stats: Dict[str, object] = {
            "last_consensus_round": self.get_last_consensus_round_index(),
            "last_block_index": self.get_last_block_index(),
            "consensus_events": self.core.get_consensus_events_count(),
            "undetermined_events": len(self.core.get_undetermined_events()),
            "transactions": self.core.get_consensus_transactions_count(),
            "transaction_pool": self.core.mempool.pending_count,
            "num_peers": len(self.core.peer_selector.get_peers()),
            "last_peer_change": self.core.last_peer_change_round,
            "id": self.get_id(),
            "state": str(self.get_state()),
            "moniker": self.core.validator.moniker,
        }
        # Batched-ingest fast-path counters: one batch
        # verify per sync on the happy path, fallback singles pinpoint
        # offenders, lock_wait measures residual core-lock contention,
        # and the serialization-cache counters are process-wide (shared
        # by co-located nodes).
        from ..crypto.batch import VERIFY_CACHE
        from ..crypto.canonical import NORM_CACHE
        from ..hashgraph.event import WIRE_CACHE

        stats.update(
            {
                "ingest_syncs": self.core.ingest_syncs,
                "ingest_batch_verifies": self.core.ingest_batch_verifies,
                "ingest_batch_size_max": self.core.ingest_batch_size_max,
                "ingest_fallback_singles": self.core.ingest_fallback_singles,
                "lock_wait_ms_total": round(
                    self.core_lock.wait_ms_total(), 1
                ),
                "lock_acquisitions": self.core_lock.acquisitions,
                # BABBLE_LOCKCHECK acquisition-order recorder (process-
                # wide; empty list / 0 while the recorder is disarmed).
                # Any inversion is a latent deadlock — the lockcheck'd
                # chaos and sim CI legs assert this stays 0
                # (docs/static_analysis.md §Lock model).
                "lock_order_edges": lockcheck.RECORDER.edge_list(),
                "lock_order_inversions": len(
                    lockcheck.RECORDER.inversions()
                ),
                "wire_cache_hits": WIRE_CACHE.hits,
                "wire_cache_misses": WIRE_CACHE.misses,
                "norm_cache_hits": NORM_CACHE.hits,
                "norm_cache_misses": NORM_CACHE.misses,
                "verify_cache_hits": VERIFY_CACHE.hits,
                "verify_cache_misses": VERIFY_CACHE.misses,
            }
        )
        # Mempool surface (docs/mempool.md): admission verdict counters,
        # pending gauges, eviction/requeue totals.
        stats.update(
            {
                f"mempool_{k}": v
                for k, v in self.core.mempool.stats().items()
            }
        )
        # Robustness surface: handler crash counters per RPC type, the
        # gossip-side transport failure counter, the peer selector's
        # health/backoff view of the network, and the sentry's
        # misbehavior/quarantine ledger.
        stats.update(
            {f"rpc_errors_{k}": v for k, v in self.rpc_errors.items()}
        )
        stats["gossip_transport_errors"] = self.gossip_transport_errors
        # Causal-tracing / flight-recorder surface
        # (docs/observability.md §Causal tracing)
        stats["trace_ctx_rpcs"] = self.trace_ctx_rpcs
        prov = self.telemetry.provenance.stats()
        stats["trace_sampled_txs"] = prov["sampled_total"]
        stats["trace_provenance_entries"] = prov["entries"]
        stats["trace_provenance_evictions"] = prov["evictions"]
        stats["watchdog_trips"] = self.watchdog.trips
        stats["flight_dumps"] = self.watchdog.dumps
        # Light-client gateway surface (docs/clients.md): subscription
        # hub occupancy (zeros while --client-listen is off) + the
        # proof-serving counters.
        hub = self.client_hub.stats() if self.client_hub is not None else {}
        stats["client_subscribers"] = hub.get("subscribers", 0)
        stats["client_sub_queue_frames_max"] = hub.get("queue_frames_max", 0)
        stats["client_pushed_blocks"] = hub.get("pushed_blocks", 0)
        stats["client_shed_subscribers"] = hub.get("shed", 0)
        stats["client_proofs_served"] = self.proofs_served
        stats["client_proof_misses"] = self.proof_misses
        stats["client_txindex_entries"] = len(self.txindex)
        stats["client_checkpoint_exports"] = self.checkpoint_exports
        # Lifecycle tier surface (docs/lifecycle.md): retention floor,
        # prune counters, and the store's retained-size view — the
        # lifecycle_* instruments and healthview columns read these.
        hg_floor = self.core.hg.prune_floor
        lcr = stats["last_consensus_round"]
        stats["lifecycle_prune_floor"] = -1 if hg_floor is None else hg_floor
        stats["lifecycle_prune_lag_rounds"] = max(
            0, int(lcr) - max(hg_floor or 0, 0)
        )
        stats["lifecycle_prunes"] = 0 if self.pruner is None else self.pruner.prunes
        stats["lifecycle_pruned_events"] = (
            0 if self.pruner is None else self.pruner.events_pruned
        )
        stats["lifecycle_behind_retention"] = self.behind_retention_rejections
        sz = self._store_size_stats()
        stats["lifecycle_events_retained"] = sz.get("events", 0)
        stats["lifecycle_rounds_retained"] = sz.get("rounds", 0)
        stats["lifecycle_store_bytes"] = sz.get("store_bytes", 0)
        stats.update(self.core.peer_selector.stats())
        stats["sync_limit_truncations"] = self.sync_limit_truncations
        stats["fast_forwards"] = self.fast_forwards
        stats["sync_diff_truncations"] = self.sync_diff_truncations
        # Adaptive gossip scheduler surface (docs/gossip.md §Adaptive
        # scheduling): the controller's published plan + change count,
        # coalesced self-event minting, and the per-peer lag extremes
        # feeding the law. With adaptation off the fixed two-speed law
        # is reported in the same keys so dashboards need no branches.
        if self.adaptive is not None:
            stats.update(self.adaptive.stats())
        else:
            # gossip_plan IS the fixed two-speed law (and is
            # side-effect-free) when the controller is off
            interval, fanout = self.gossip_plan()
            stats.update({
                "adaptive_interval_ms": round(1e3 * interval, 3),
                "adaptive_fanout": fanout,
                "adaptive_soft_depth": self.conf.gossip_pipeline_depth,
                "adaptive_ticks": 0,
                "adaptive_adjustments": 0,
            })
        peer_behind, self_behind = self._lag_extremes()
        stats["gossip_peer_behind_max"] = peer_behind
        stats["gossip_self_behind_max"] = self_behind
        stats["selfevent_coalesced"] = self.core.selfevent_coalesced
        # Async gossip engine surface (docs/gossip.md): inbound-sync
        # pipeline occupancy + the process-wide binary codec tallies.
        if self.pipeline is not None:
            stats.update(self.pipeline.stats())
        else:
            stats.update({
                "gossip_inflight_syncs": 0,
                "gossip_inflight_syncs_peak": 0,
                "gossip_pipelined_syncs": 0,
                "gossip_pull_pipelined_syncs": 0,
                "gossip_backpressure_stalls": 0,
                "gossip_pipeline_queue_depth": 0,
                "gossip_pipeline_soft_depth": self.conf.gossip_pipeline_depth,
            })
        from ..net.codec import CODEC_STATS

        stats.update({
            f"codec_{k}": v for k, v in CODEC_STATS.snapshot().items()
        })
        stats.update(self.core.sentry.stats())
        # Commit-latency percentiles from the registry histogram — the
        # north-star p50/p90/p99 (ms), None until the first local commit.
        clat = self.telemetry.commit_latency_ms()
        stats["commit_latency_samples"] = clat["count"]
        stats["commit_latency_p50_ms"] = clat["p50_ms"]
        stats["commit_latency_p90_ms"] = clat["p90_ms"]
        stats["commit_latency_p99_ms"] = clat["p99_ms"]
        accel = self.core.hg.accel
        if accel is not None:
            stats.update(accel.stats())
        else:
            stats["consensus_engine"] = "oracle"
        return stats

    def get_stats(self) -> Dict[str, str]:
        """reference: node.go:277-294 — the reference's stringly map,
        derived at the edge from the typed snapshot."""
        return {k: str(v) for k, v in self.get_stats_snapshot().items()}

    def _store_size_stats(self) -> Dict[str, int]:
        """Memoized store.size_stats() (≤1 read/second — the persistent
        store's implementation runs COUNT(*) queries)."""
        now = self.clock.monotonic()
        memo = self._size_stats_memo
        if memo["v"] is None or now - float(memo["t"]) >= 1.0:
            size_stats = getattr(self.core.hg.store, "size_stats", None)
            memo["v"] = size_stats() if size_stats is not None else {}
            memo["t"] = now
        return memo["v"]

    # -- background ---------------------------------------------------------

    def _do_background_work(self) -> None:
        """Drain transport RPCs and submitted transactions
        (reference: node.go:341-361)."""
        net_q = self.trans.consumer()
        while not self.shutdown_event.is_set():
            handled = False
            try:
                rpc = net_q.get(timeout=0.01)
                handled = True
                started = self.go_func(
                    lambda r=rpc: (self._process_rpc(r), self._reset_timer())
                )
                if not started:
                    # routine pool exhausted: answer instead of dropping
                    # silently, so the caller fails fast rather than
                    # burning its full RPC timeout (backpressure surface)
                    rpc.respond(None, "node busy (routine pool exhausted)")
            except queue.Empty:
                pass
            # Batch-drain the submit queue, BOUNDED per pass: the old
            # one-get_nowait-per-transaction shape admitted one tx per
            # loop iteration under load, while an unbounded drain would
            # starve the transport consumer above. Up to conf.submit_batch
            # transactions go through mempool admission per pass.
            try:
                for _ in range(max(1, self.conf.submit_batch)):
                    tx = self.submit_q.get_nowait()
                    handled = True
                    self._add_transaction(tx)
            except queue.Empty:
                pass
            if handled:
                self._reset_timer()

    def _reset_timer(self) -> None:
        """reference: node.go:365-379 — interval now chosen by
        :meth:`gossip_plan` (adaptive controller, or the reference's
        fixed two-speed law when adaptation is off).

        The signals read are snapshot reads of plain attributes (pool
        lengths, pending counters) — taking the core lock for them only
        added contention on the insert pipeline; a momentarily stale
        choice is harmless (the next tick re-reads)."""
        if not self.control_timer.is_set:
            interval, _ = self.gossip_plan()
            self.control_timer.reset(interval)

    def gossip_plan(self) -> tuple:
        """(interval_s, fanout) for the next gossip tick. With the
        adaptive controller on, one signal snapshot is folded into the
        control law (EWMA + hysteresis, node/adaptive.py) and the
        pipeline's soft depth cap is re-published; with it off, the
        reference's fixed law: heartbeat when busy, slow heartbeat when
        idle, one partner per tick."""
        busy = self.core.busy()
        if self.adaptive is None:
            interval = (
                self.conf.heartbeat_timeout
                if busy
                else self.conf.slow_heartbeat_timeout
            )
            return interval, 1
        from .adaptive import GossipSignals

        peer_behind, self_behind = self._lag_extremes()
        sig = GossipSignals(
            busy=busy,
            mempool_pending=self.core.mempool.pending_count,
            inflight=self.pipeline.inflight if self.pipeline else 0,
            queue_depth=(
                self.pipeline.queue_depth() if self.pipeline else 0
            ),
            peer_behind=peer_behind,
            self_behind=self_behind,
            rounds_inflight=self._rounds_carryover,
            rounds_cap=self._gossip_slot_cap,
        )
        with self._plan_lock:
            now = self.clock.monotonic()
            if now - self._last_plan_t >= self.adaptive.fast_s:
                plan = self.adaptive.update(sig)
                self._last_plan_t = now
            else:
                # mid-interval caller (an RPC-handler _reset_timer):
                # reuse the published plan, don't re-fold the EWMAs
                plan = self.adaptive.current()
            self._fanout = plan.fanout
        if self.pipeline is not None:
            self.pipeline.set_soft_depth(plan.soft_depth)
        return plan.interval, plan.fanout

    # -- per-peer lag (adaptive signals) ------------------------------------

    def _note_peer_known(
        self, peer_id: int, ours: Dict[int, int], theirs: Dict[int, int]
    ) -> None:
        """Fold one exchanged known-map pair into the per-peer lag view:
        total events the peer is missing that we hold (``peer_behind``)
        and vice versa (``self_behind``). Called from both gossip legs,
        so every contact refreshes its partner's entry."""
        peer_behind = 0
        self_behind = 0
        for cid, our_idx in ours.items():
            their_idx = theirs.get(cid, -1)
            if our_idx > their_idx:
                peer_behind += our_idx - their_idx
        for cid, their_idx in theirs.items():
            if their_idx > ours.get(cid, -1):
                self_behind += their_idx - ours.get(cid, -1)
        with self._lag_lock:
            self._peer_behind[peer_id] = peer_behind
            self._self_behind[peer_id] = self_behind

    def _lag_extremes(self) -> tuple:
        """(max events any peer trails us by, max events we trail any
        peer by) over the last contact with each CURRENT peer — entries
        for since-removed peers are ignored (and dropped), so a departed
        laggard can't pin the fan-out open forever."""
        live = {p.id for p in self.core.peer_selector.get_peers().peers}
        with self._lag_lock:
            for d in (self._peer_behind, self._self_behind):
                for pid in [k for k in d if k not in live]:
                    del d[pid]
            peer_behind = max(self._peer_behind.values(), default=0)
            self_behind = max(self._self_behind.values(), default=0)
        return peer_behind, self_behind

    def _check_suspend(self) -> None:
        """Auto-suspend on runaway undetermined events or eviction
        (reference: node.go:384-408)."""
        new_undetermined = (
            len(self.core.get_undetermined_events())
            - self.initial_undetermined_events
        )
        too_many = new_undetermined > self.conf.suspend_limit * len(
            self.core.validators
        )
        evicted = (
            self.core.hg.last_consensus_round is not None
            and self.core.removed_round > 0
            and self.core.removed_round > self.core.accepted_round
            and self.core.hg.last_consensus_round >= self.core.removed_round
        )
        if too_many or evicted:
            self.suspend()

    # -- babbling -----------------------------------------------------------

    def _babble(self, gossip: bool) -> None:
        """Gossip on each timer tick (reference: node.go:416-443).

        The wait is EVENT-driven: the loop blocks on the tick event
        itself (suspend/shutdown poke it, so exits stay prompt) instead
        of the old 100 ms polling wait, which both burned a core and
        floored the achievable gossip interval at the poll quantum —
        the adaptive controller's fast rail is the heartbeat itself,
        not heartbeat-rounded-up-to-100ms. The long timeout below is a
        lost-wakeup guard only, never the cadence."""
        self.logger.info("BABBLING")
        self.suspend_event.clear()
        while True:
            if self.shutdown_event.is_set() or self.suspend_event.is_set():
                return
            if self.get_state() != State.BABBLING:
                return
            if self.control_timer.tick.wait(timeout=5.0):
                if (
                    self.shutdown_event.is_set()
                    or self.suspend_event.is_set()
                ):
                    self.control_timer.tick.clear()
                    return
                self.control_timer.tick.clear()
                # rounds still running from the previous tick = the
                # cadence is overrunning the host (adaptive congestion)
                self._rounds_carryover = self._gossip_rounds_inflight
                if gossip:
                    peers = self.core.peer_selector.next_many(self._fanout)
                    if peers:
                        for peer in peers:
                            if not self._gossip_slots.acquire(blocking=False):
                                break  # fan the rest next tick
                            started = self.go_func(
                                lambda p=peer: self._gossip_with_slot(p)
                            )
                            if not started:
                                self._gossip_slots.release()
                                break
                    else:
                        self._monologue()
                self._reset_timer()
                self._check_suspend()

    def _gossip_with_slot(self, peer: Peer) -> None:
        with self._rounds_lock:
            self._gossip_rounds_inflight += 1
        try:
            self._gossip(peer)
        finally:
            with self._rounds_lock:
                self._gossip_rounds_inflight -= 1
            self._gossip_slots.release()

    def _monologue(self) -> None:
        """Record events even when alone (reference: node.go:447-463)."""
        with self.core_lock:
            if self.core.busy():
                self.core.add_self_event("")
                self.core.drain_hot_mempool()
                self.core.hg.flush_consensus()
                self.core.process_sig_pool()
        self._maybe_prune()

    def _gossip(self, peer: Peer) -> None:
        """Pull-push gossip round (reference: node.go:466-501).

        The whole round runs under one sync trace: stages timed here and
        deep in the core/hashgraph pipeline attach to it through the
        tracer's thread-local, and the finished span lands in the
        /telemetry recent-syncs ring."""
        connected = False
        transport_failure = False
        trace = self.telemetry.start_sync_trace(peer.id)
        try:
            other_known = self._pull(peer)
            self._push(peer, other_known)
            connected = True
            self.last_gossip_ok = self.clock.monotonic()
            self._log_stats()
        except TransportError as err:
            transport_failure = True
            self.gossip_transport_errors += 1
            self.logger.debug("gossip transport error: %s", err)
        except Exception as err:
            # Classified ingest rejections (typed hashgraph errors) feed
            # the sentry: the pull leg's events came from this peer, so
            # hostile payloads score it (forks score their creator).
            cause = self.core.sentry.observe_rejection(err, peer.id)
            if cause is not None:
                self.logger.warning(
                    "gossip rejection from %d (%s): %s", peer.id, cause, err
                )
            else:
                self.logger.warning("gossip error: %s", err)
        finally:
            trace.finish()
            # only NETWORK failures decay the peer's health/backoff; a
            # local error (the generic branch) isn't the peer's fault
            self.core.peer_selector.update_last(
                peer.id, connected, penalize=transport_failure
            )
        self._maybe_prune()

    def _maybe_prune(self) -> None:
        """Checkpoint-prune hook (docs/lifecycle.md), run from the
        gossip/monologue tails — NEVER from the commit listener, where
        compaction would mutate the store mid process_decided_rounds.
        The due() pre-check is lock-free; the prune itself re-evaluates
        under the core lock."""
        if self.pruner is None or not self.pruner.due(self.core):
            return
        with self.core_lock:
            stats = self.pruner.prune(self.core)
        if stats is not None:
            self.logger.info(
                "checkpoint-prune: floor=%d events=%d rounds=%d",
                stats["floor"],
                stats["events_pruned"],
                stats["rounds_pruned"],
            )

    def _pull(self, peer: Peer) -> Dict[int, int]:
        """SyncRequest leg (reference: node.go:504-538).

        With the staged pipeline on, the pulled events go through the
        SAME decode→batch-verify→bounded-queue→single-inserter staging
        as inbound eager syncs (node/pipeline.py): stage 1 runs here in
        the gossip thread (lock-free), the insert tail drains on the
        inserter — so a slow insert never blocks this round's push leg
        or the next pull round-trip. Inline fallback (pipeline off, sim
        clock, or stopped) keeps the pre-pipeline shape."""
        with self.core_lock:
            known = self.core.known_events()
        t0 = self.clock.monotonic()
        resp = self._request_sync(peer.net_addr, known, self.conf.sync_limit)
        # response arrival: the pulled events' "recv" stamp for per-hop
        # trace attribution (no wire ctx on a pull — the latency is OUR
        # request_sync round-trip, not a remote push)
        recv = self.clock.time() if self.telemetry.enabled else None
        dt = self.clock.monotonic() - t0
        self.timers.record("request_sync", dt)
        self.telemetry.observe_stage("request_sync", dt)
        self._note_peer_known(peer.id, known, resp.known)
        if len(resp.events) > self.conf.sync_limit:
            # We asked for at most sync_limit events; a bigger response
            # means the peer ignored the negotiated cap.
            resp.events = resp.events[: self.conf.sync_limit]
            self.sync_limit_truncations += 1
            self.core.sentry.record(peer.id, "oversized_sync")
        t0 = self.clock.monotonic()
        hop = {"from": peer.id, "recv": recv}
        if (
            self.pipeline is not None
            and resp.events
            and self.pipeline.submit_pull(peer.id, resp.events, hop)
        ):
            self.timers.record("sync", self.clock.monotonic() - t0)
            return resp.known
        # Lock-free ingest stage: decode + hash + one batch signature
        # verification happen BEFORE the core lock; the lock then only
        # covers the ordered insert + DivideRounds sweep.
        prepared = self.core.prepare_sync(resp.events)
        with self.core_lock:
            self._sync(peer.id, resp.events, prepared, hop=hop)
        self.timers.record("sync", self.clock.monotonic() - t0)
        return resp.known

    def _push(self, peer: Peer, known_events: Dict[int, int]) -> None:
        """EagerSyncRequest leg (reference: node.go:541-587)."""
        t0 = self.clock.monotonic()
        with self.core_lock:
            diff = self.core.event_diff(known_events)
        dt = self.clock.monotonic() - t0
        self.timers.record("diff", dt)
        self.telemetry.observe_stage("diff", dt)
        if not diff:
            return
        if len(diff) > self.conf.sync_limit:
            # Sender-side truncation is no longer silent: the counter is
            # the receiving side's sync_limit_truncations twin, so a
            # peer chronically more than one sync_limit behind us is
            # visible in get_stats//metrics instead of just staying lag.
            diff = diff[: self.conf.sync_limit]
            self.sync_diff_truncations += 1
        wire = self.core.to_wire(diff)
        t0 = self.clock.monotonic()
        self._request_eager_sync(peer.net_addr, wire)
        dt = self.clock.monotonic() - t0
        self.timers.record("eager_sync", dt)
        self.telemetry.observe_stage("eager_sync", dt)

    def _sync(
        self,
        from_id: int,
        events: List[WireEvent],
        prepared: Optional[PreparedSync] = None,
        hop: Optional[dict] = None,
    ) -> None:
        """Insert events + process the sig pool; callers hold core_lock
        and SHOULD pass the prepare_sync output computed outside it
        (reference: node.go:591-615). ``hop`` is the carrying sync's
        causal-trace info for per-transaction provenance (Core.sync)."""
        try:
            self.core.sync(from_id, events, prepared, hop)
        except Exception as err:
            if not is_normal_self_parent_error(err):
                raise
        finally:
            # Always drain the sig pool: Core.sync defers a ForkError
            # until after the batch's inserts complete, so the block
            # signatures those events carried must not sit unprocessed
            # behind the re-raise.
            t0 = self.clock.monotonic()
            self.core.process_sig_pool()
            dt = self.clock.monotonic() - t0
            self.timers.record("process_sig_pool", dt)
            self.telemetry.observe_stage("process_sig_pool", dt)

    # -- catching up --------------------------------------------------------

    def _fast_forward(self) -> None:
        """reference: node.go:622-666."""
        self.logger.info("CATCHING-UP")
        self.wait_routines(timeout=2.0)

        resp = self._get_best_fast_forward_response()
        if resp is None:
            self._transition(State.BABBLING)
            return

        try:
            self.proxy.restore(resp.snapshot)
            with self.core_lock:
                self.core.fast_forward(resp.block, resp.frame)
            self.core.process_accepted_internal_transactions(
                resp.block.round_received(),
                resp.block.internal_transaction_receipts(),
            )
        except Exception as err:
            self.logger.error("fast-forward failed: %s", err)
            return

        self.fast_forwards += 1
        self._transition(State.BABBLING)

    def _get_best_fast_forward_response(self) -> Optional[FastForwardResponse]:
        """Poll all peers, keep the highest block (reference: node.go:670-701).

        A catching-up node on a flaky network must not give up because ONE
        poll pass hit transport errors: passes retry with exponential
        backoff (jittered) until conf.fast_forward_deadline. A pass where
        every peer ANSWERED (a response or a RemoteError — e.g. "no
        anchor block" in a young cluster) is conclusive — no retry — as
        is a cluster with no other peers. Only connectivity failures,
        which retrying can heal, re-poll."""
        from ..common.backoff import jittered_backoff

        deadline = self.clock.monotonic() + self.conf.fast_forward_deadline
        attempt = 0
        while True:
            best: Optional[FastForwardResponse] = None
            max_block = 0
            transport_errors = 0
            for p in self.core.peer_selector.get_peers().peers:
                if p.id == self.get_id():
                    continue
                try:
                    resp = self._request_fast_forward(p.net_addr)
                except TransportError as err:
                    if not isinstance(err, RemoteError):
                        transport_errors += 1
                    self.logger.debug(
                        "requestFastForward(%s): %s", p.net_addr, err
                    )
                    continue
                if resp.block is not None and resp.block.index() > max_block:
                    best = resp
                    max_block = resp.block.index()
            if best is not None or transport_errors == 0:
                return best
            attempt += 1
            delay = jittered_backoff(attempt, 0.1, 1.0, rng=self._backoff_rng)
            if (
                self.clock.monotonic() + delay > deadline
                or self.shutdown_event.is_set()
            ):
                return None
            self.clock.sleep(delay)

    # -- joining ------------------------------------------------------------

    def _join(self) -> None:
        """reference: node.go:709-751."""
        if self.conf.maintenance_mode:
            return
        self.logger.info("JOINING")
        peer = self.core.peer_selector.next()
        if peer is None:
            self.clock.sleep(0.2)
            return
        try:
            resp = self._request_join(peer.net_addr)
        except TransportError as err:
            self.logger.warning("cannot join via %s: %s", peer.net_addr, err)
            # feed the selector so the next attempt prefers another peer,
            # and back off exponentially (jittered, capped) — the run loop
            # re-enters _join, so the sleep here IS the retry cadence
            from ..common.backoff import backoff_sleep

            self.core.peer_selector.update_last(peer.id, False)
            self._join_failures += 1
            backoff_sleep(
                self._join_failures, 0.2, self.conf.join_backoff_cap,
                rng=self._backoff_rng, sleep=self.clock.sleep,
            )
            return

        self._join_failures = 0
        self.core.peer_selector.update_last(peer.id, True)
        if resp.accepted:
            self.core.accepted_round = resp.accepted_round
            self.core.removed_round = -1
            self._set_babbling_or_catching_up_state()
        else:
            self.logger.info("join request rejected")
            self.shutdown()

    # -- client-side RPCs (reference: node_rpc.go:15-74) --------------------

    def _request_sync(
        self, target: str, known: Dict[int, int], sync_limit: int
    ) -> SyncResponse:
        return self.trans.sync(
            target,
            SyncRequest(
                self.get_id(), known, sync_limit,
                trace=self.telemetry.wire_ctx(self.get_id()),
            ),
        )

    def _request_eager_sync(
        self, target: str, events: List[WireEvent]
    ) -> EagerSyncResponse:
        return self.trans.eager_sync(
            target,
            EagerSyncRequest(
                self.get_id(), events,
                trace=self.telemetry.wire_ctx(self.get_id()),
            ),
        )

    def _request_fast_forward(self, target: str) -> FastForwardResponse:
        return self.trans.fast_forward(
            target,
            FastForwardRequest(
                self.get_id(), trace=self.telemetry.wire_ctx(self.get_id())
            ),
        )

    def _request_join(self, target: str) -> JoinResponse:
        join_tx = InternalTransaction.join(
            Peer(
                net_addr=self.trans.advertise_addr(),
                pub_key_hex=self.core.validator.public_key_hex(),
                moniker=self.core.validator.moniker,
            )
        )
        join_tx.sign(self.core.validator.key)
        return self.trans.join(target, JoinRequest(join_tx))

    # -- server-side RPCs (reference: node_rpc.go:76-315) -------------------

    def _process_rpc(self, rpc: RPC) -> None:
        """Gate on state, dispatch by command type
        (reference: node_rpc.go:76-104)."""
        state = self.get_state()
        is_sync = isinstance(rpc.command, SyncRequest)
        if not (
            state == State.BABBLING or (state == State.SUSPENDED and is_sync)
        ):
            rpc.respond(None, f"not in Babbling state ({state})")
            return

        cmd = rpc.command
        if getattr(cmd, "trace", None) is not None:
            # wire trace context present (absent from old peers — both
            # directions interoperate, docs/observability.md)
            self.trace_ctx_rpcs += 1
        # Quarantined peers get no sync service: their pushes are the
        # attack surface and their pulls only help them keep up. Join and
        # fast-forward stay open (different identity/recovery paths).
        if isinstance(cmd, (SyncRequest, EagerSyncRequest)):
            if self.core.sentry.is_quarantined(cmd.from_id):
                self.core.sentry.note_refused()
                rpc.respond(None, f"peer {cmd.from_id} is quarantined")
                return
        if isinstance(cmd, SyncRequest):
            self._process_sync_request(rpc, cmd)
        elif isinstance(cmd, EagerSyncRequest):
            self._process_eager_sync_request(rpc, cmd)
        elif isinstance(cmd, FastForwardRequest):
            self._process_fast_forward_request(rpc, cmd)
        elif isinstance(cmd, JoinRequest):
            self._process_join_request(rpc, cmd)
        else:
            rpc.respond(None, "unexpected command")

    def _process_sync_request(self, rpc: RPC, cmd: SyncRequest) -> None:
        """reference: node_rpc.go:106-172."""
        self.sync_requests += 1
        resp = SyncResponse(from_id=self.get_id())
        err: Optional[str] = None
        try:
            with self.core_lock:
                diff = self.core.event_diff(cmd.known)
            # clamp: a hostile negative sync_limit must not turn
            # diff[:limit] into serve-almost-everything
            limit = min(max(0, cmd.sync_limit), self.conf.sync_limit)
            if len(diff) > limit:
                diff = diff[:limit]
            resp.events = self.core.to_wire(diff)
            with self.core_lock:
                resp.known = self.core.known_events()
            # the requester told us what it knows: refresh its lag entry
            # (adaptive spread signal) without waiting for our own pull
            self._note_peer_known(cmd.from_id, resp.known, cmd.known)
        except Exception as e:
            self.sync_errors += 1
            self.rpc_errors["sync"] += 1
            self.logger.debug("sync handler error: %s", e, exc_info=True)
            err = str(e)
        rpc.respond(resp, err)

    def _process_eager_sync_request(self, rpc: RPC, cmd: EagerSyncRequest) -> None:
        """reference: node_rpc.go:180-203."""
        if len(cmd.events) > self.conf.sync_limit:
            # Receiving-side cap: the requester-side truncation
            # (node.py _push) is a courtesy honest peers extend; a
            # hostile pusher ignores it, so the cap is enforced here
            # too. Scoring only kicks in past 2x our limit: eager-push
            # has no negotiation leg, so an honest peer configured with
            # a larger --sync-limit would otherwise be punished for a
            # pure config mismatch (the pull leg negotiates explicitly,
            # so there any overshoot is scored).
            egregious = len(cmd.events) > 2 * self.conf.sync_limit
            cmd.events = cmd.events[: self.conf.sync_limit]
            self.sync_limit_truncations += 1
            if egregious:
                self.core.sentry.record(cmd.from_id, "oversized_sync")
        hop = None
        if self.telemetry.enabled:
            hop = {
                "from": cmd.from_id,
                "ctx": parse_ctx(cmd.trace),
                # transport arrival when stamped; else handler entry
                "recv": (
                    rpc.recv_ts if rpc.recv_ts is not None
                    else self.clock.time()
                ),
            }
        # Pipelined path (node/pipeline.py): decode+batch-verify run in
        # THIS thread (stage 1, lock-free, overlapped across concurrent
        # inbound syncs), the insert tail drains through the serialized
        # inserter, and the response fires after the insert lands.
        if self.pipeline is not None and self.pipeline.submit(rpc, cmd, hop):
            return
        # Inline fallback (pipeline disabled or stopped): the
        # pre-pipeline shape — same lock-shrink, same error surface.
        try:
            prepared = self.core.prepare_sync(cmd.events)
        except Exception as e:
            self._fail_eager_sync(rpc, cmd, e)
            return
        self._finish_eager_sync(rpc, cmd, prepared, hop)

    def _fail_eager_sync(self, rpc: RPC, cmd: EagerSyncRequest,
                         e: Exception) -> None:
        """Answer an eager sync whose prepare stage raised, preserving
        the pre-pipeline error attribution: classified (peer-fault)
        rejections score the sender through the sentry; only genuine
        handler crashes count toward rpc_errors."""
        cause = self.core.sentry.observe_rejection(e, cmd.from_id)
        if cause is None:
            self.rpc_errors["eager_sync"] += 1
        self.logger.debug("eager-sync prepare error: %s", e, exc_info=True)
        rpc.respond(EagerSyncResponse(self.get_id(), False), str(e))

    def _finish_eager_sync(self, rpc: RPC, cmd: EagerSyncRequest,
                           prepared, hop: Optional[dict]) -> None:
        """Insert tail of one inbound eager sync + the response. Called
        by the pipeline's inserter thread (or inline when the pipeline
        is off); ``prepared`` is the lock-free stage's output for
        ``cmd.events``."""
        success = True
        err: Optional[str] = None
        try:
            with self.core_lock:
                self._sync(cmd.from_id, cmd.events, prepared, hop)
        except Exception as e:
            success = False
            cause = self.core.sentry.observe_rejection(e, cmd.from_id)
            if cause is None:
                # not the peer's fault — a genuine handler crash
                self.rpc_errors["eager_sync"] += 1
            self.logger.debug(
                "eager-sync handler error: %s", e, exc_info=True
            )
            err = str(e)
        rpc.respond(EagerSyncResponse(self.get_id(), success), err)

    def _fail_pulled_sync(self, from_id: int, e: Exception) -> None:
        """Insert-tail failure of a pulled batch on the inserter thread
        (stage-1 failures propagate out of submit_pull to _gossip's own
        handler instead) — same attribution as the inline pull leg:
        classified hashgraph rejections score the serving peer through
        the sentry; anything else is a local error and only gets
        logged."""
        cause = self.core.sentry.observe_rejection(e, from_id)
        if cause is not None:
            self.logger.warning(
                "gossip rejection from %d (%s): %s", from_id, cause, e
            )
        else:
            self.logger.warning("pulled-sync error: %s", e)

    def _finish_pulled_sync(self, from_id: int, events: List[WireEvent],
                            prepared, hop: Optional[dict]) -> None:
        """Insert tail of one pulled batch. Called by the pipeline's
        inserter thread (or inline on the queue-full backpressure path);
        ``prepared`` is the lock-free stage's output for ``events``.
        There is no RPC to answer. A rejection here lands AFTER the
        gossip round already recorded the contact (the round's success
        is the wire exchange; the staged insert is deliberately off its
        critical path), so the feedback channel for a peer serving bad
        payloads is the sentry — repeated classified rejections
        quarantine it, which the selector hard-excludes — matching the
        inline path's real defense (insert rejections never decayed
        selector health there either; only transport failures do)."""
        try:
            with self.core_lock:
                self._sync(from_id, events, prepared, hop)
        except Exception as e:
            self._fail_pulled_sync(from_id, e)

    def _process_fast_forward_request(
        self, rpc: RPC, cmd: FastForwardRequest
    ) -> None:
        """reference: node_rpc.go:205-247."""
        resp = FastForwardResponse(from_id=self.get_id())
        err: Optional[str] = None
        try:
            with self.core_lock:
                block, frame = self.core.get_anchor_block_with_frame()
            resp.block = block
            resp.frame = frame
            resp.snapshot = self.proxy.get_snapshot(block.index())
        except Exception as e:
            self.rpc_errors["fast_forward"] += 1
            self.logger.debug(
                "fast-forward handler error: %s", e, exc_info=True
            )
            err = str(e)
        rpc.respond(resp, err)

    def _process_join_request(self, rpc: RPC, cmd: JoinRequest) -> None:
        """reference: node_rpc.go:249-315."""
        err: Optional[str] = None
        accepted = False
        accepted_round = 0
        peers: List[Peer] = []

        itx = cmd.internal_transaction
        if not itx.verify():
            err = "unable to verify signature on join request"
        elif itx.body.peer.pub_key_hex in self.core.peers.by_pub_key:
            accepted = True
            lcr = self.core.get_last_consensus_round_index()
            if lcr is not None:
                accepted_round = lcr
            peers = self.core.peers.peers
        else:
            with self.core_lock:
                promise = self.core.add_internal_transaction(itx)
            try:
                presp = promise.wait(timeout=self.conf.join_timeout)
                accepted = presp.accepted
                accepted_round = presp.accepted_round
                peers = presp.peers
            except queue.Empty:
                err = "timeout waiting for join request to reach consensus"
        if err is not None:
            self.rpc_errors["join"] += 1
            self.logger.debug("join handler error: %s", err)
        rpc.respond(
            JoinResponse(self.get_id(), accepted, accepted_round, peers), err
        )

    # -- utils --------------------------------------------------------------

    def _transition(self, state: State) -> None:
        """reference: node.go:758-765."""
        self.set_state(state)
        try:
            self.proxy.on_state_changed(state)
        except Exception as err:
            self.logger.error("OnStateChanged: %s", err)

    def _set_babbling_or_catching_up_state(self) -> None:
        """reference: node.go:768-780."""
        if self.conf.enable_fast_sync:
            self._transition(State.CATCHING_UP)
        else:
            self.core.set_head_and_seq()
            self._transition(State.BABBLING)

    def _add_transaction(self, tx: bytes) -> str:
        """reference: node.go:784-789 — but admission happens under the
        mempool's OWN lock, not the core lock: a submit storm contends
        with other submits, never with the insert/consensus pipeline."""
        return self._admit_transaction(tx)

    def _admit_transaction(self, tx: bytes) -> str:
        """Mempool admission; returns the verdict (proxy submit handler)."""
        return self.core.mempool.submit(tx)

    def get_metrics_text(self) -> str:
        """/metrics service payload: Prometheus text exposition of the
        node registry + the process-global registry."""
        return self.telemetry.render_metrics()

    def get_telemetry(self) -> Dict[str, object]:
        """/telemetry service payload: every instrument as JSON
        (histograms with computed p50/p90/p99) + recent sync traces."""
        return self.telemetry.telemetry_view()

    def get_mempool(self) -> Dict[str, object]:
        """/mempool service payload: knobs + live counters."""
        return {
            "config": self.core.mempool.config(),
            "stats": self.core.mempool.stats(),
        }

    def get_trace(self, txid: str) -> Optional[Dict[str, object]]:
        """/trace/<txid> service payload: THIS node's provenance record
        for one transaction (None → 404; obs/traceview.py merges several
        nodes' answers into the cross-node timeline)."""
        rec = self.telemetry.provenance.get(txid)
        if rec is None:
            return None
        rec["node"] = self.get_id()
        rec["moniker"] = self.core.validator.moniker
        return rec

    def get_traces(self, limit: int = 256) -> Dict[str, object]:
        """/traces service payload: bulk provenance export (newest-last,
        bounded) plus the table's own stats."""
        return {
            "node": self.get_id(),
            "moniker": self.core.validator.moniker,
            "provenance": self.telemetry.provenance.stats(),
            "records": self.telemetry.provenance.export(limit=limit),
        }

    def get_suspects(self) -> Dict[str, object]:
        """/suspects service payload: the sentry's per-peer misbehavior
        ledger + equivocation proofs, with peers annotated by moniker so
        operators can tell who is who (docs/robustness.md)."""
        body = self.core.sentry.suspects()
        by_id = self.core.hg.store.repertoire_by_id()
        for pid_s, entry in body["peers"].items():
            peer = by_id.get(int(pid_s))
            if peer is not None:
                entry["moniker"] = peer.moniker
                entry["pub_key"] = peer.pub_key_hex
        return body

    def _log_stats(self) -> None:
        # guard: get_stats() walks every subsystem (selector sweep,
        # commit-latency summary) — don't build it just to drop the line
        if self.logger.isEnabledFor(logging.DEBUG):
            self.logger.debug("stats: %s", self.get_stats())
