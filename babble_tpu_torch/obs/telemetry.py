"""NodeTelemetry: the per-node metrics registry and its wiring.

One instance is created by ``Core.__init__`` (so cores used standalone
— benches, tests — carry the same instruments as full nodes) and
extended by ``Node`` via ``bind_node``. It owns:

- the **hot instruments**: ``commit_latency_seconds``,
  ``sync_stage_seconds{stage}``, ``tx_stage_seconds{stage}``,
  ``core_lock_wait_seconds`` (observed from the mempool's commit feed,
  the pipeline stage observers, and the TimedLock hook);
- **function-backed instruments** over every subsystem's existing
  counters (core ingest_*, mempool, sentry, selector, accel, node RPC
  counters) — zero hot-path cost, evaluated at scrape;
- the **tracer** (span ring served at ``/telemetry``);
- the **legacy snapshot**: ``stats_snapshot()`` yields the typed
  ``get_stats`` payload (numbers stay numbers; ``Node.get_stats``
  stringifies at the edge — the compatibility contract recorded in
  docs/parity.md).

Every instrument name must exist in ``obs.catalog`` (registration
raises otherwise), which is what keeps the docs table honest.

With ``BABBLE_OBS=0`` the hot instruments are no-ops, the stage
observers are ``None`` (callers skip even the clock reads), and traces
are never opened — only the scrape-time function instruments remain.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from . import catalog
from .metrics import (
    GLOBAL,
    LATENCY_BUCKETS,
    STAGE_BUCKETS,
    Registry,
    enabled as obs_enabled,
    wire_global,
)
from .provenance import ProvenanceTable
from .trace import NULL_TRACE, Tracer


class NodeTelemetry:
    def __init__(self, core, enabled: Optional[bool] = None):
        self.enabled = obs_enabled() if enabled is None else enabled
        self.registry = Registry(enabled=self.enabled)
        wire_global()
        self._core = core
        self._node = None
        # The node's time source: trace spans and stage durations are
        # measured against it, so a simulated node's histograms hold
        # virtual-time latencies instead of host-load noise (the
        # wall-clock stamping bug this replaces made sim percentiles
        # garbage). Cores predating the clock field fall back to wall.
        from ..common.clock import WALL

        self.clock = getattr(core, "clock", None) or WALL

        # -- hot instruments ------------------------------------------------
        self.commit_latency = self._histogram(
            "commit_latency_seconds", LATENCY_BUCKETS
        )
        self._sync_stage = self._histogram(
            "sync_stage_seconds", STAGE_BUCKETS
        )
        self._tx_stage = self._histogram(
            "tx_stage_seconds", LATENCY_BUCKETS
        )
        self.lock_wait = self._histogram(
            "core_lock_wait_seconds", STAGE_BUCKETS
        )
        # Pre-resolved per-stage children so the hot path pays one dict
        # get, not a labels() call.
        self._stage_children: Dict[str, object] = {}
        self.tracer = Tracer(
            stage_sink=self._observe_stage_hist,
            clock=self.clock.perf_counter,
        )
        # Per-transaction commit provenance (docs/observability.md
        # §"Causal tracing"): admit/drain/first-seen/commit stamps keyed
        # by tx hash, deterministically sampled so every node traces the
        # same transactions. Node.__init__ applies the Config knobs via
        # provenance.configure(); standalone cores keep the defaults.
        self.provenance = ProvenanceTable(
            clock=self.clock, enabled=self.enabled
        )

        # The observer the pipeline code null-checks: None when disabled
        # so instrumented code skips even its perf_counter reads.
        self.stage_observer = self.tracer.observe if self.enabled else None
        self.lock_wait_observer = (
            self.lock_wait.observe if self.enabled else None
        )

        self._wire_core(core)
        self._wire_mempool(core.mempool)
        self._wire_sentry(core.sentry)
        self._wire_selector(core)
        if core.hg.accel is not None:
            self._wire_accel(core.hg.accel)

    # -- registration helpers ----------------------------------------------

    def _histogram(self, name, buckets):
        s = catalog.spec(name)
        return self.registry.histogram(name, s.help, buckets, s.labels)

    def _func(self, name, fn):
        s = catalog.spec(name)
        if s.kind == "counter":
            self.registry.func_counter(name, s.help, fn, s.labels)
        else:
            self.registry.func_gauge(name, s.help, fn, s.labels)

    # -- stage observation --------------------------------------------------

    def _observe_stage_hist(self, stage: str, seconds: float) -> None:
        child = self._stage_children.get(stage)
        if child is None:
            child = self._sync_stage.labels(stage=stage)
            self._stage_children[stage] = child
        child.observe(seconds)

    def observe_stage(self, stage: str, seconds: float) -> None:
        """Histogram + active-trace stage record (no-op when disabled)."""
        if self.stage_observer is not None:
            self.stage_observer(stage, seconds)

    def start_sync_trace(self, peer_id: int, kind: str = "sync"):
        if not self.enabled:
            return NULL_TRACE
        return self.tracer.start(kind, peer_id)

    def wire_ctx(self, node_id: int):
        """Trace context for an outbound Sync/EagerSync/FastForward RPC
        (obs/provenance.py wire format), tagged with the active gossip
        span's id so the receiver's records join this round. None when
        telemetry is disabled — the wire field is simply omitted.

        Built inline (not via make_ctx): this runs once per outbound
        gossip RPC, and the ids are short by construction so the
        hostile-length clamp is the receiver's job (parse_ctx)."""
        if not self.enabled:
            return None
        tr = self.tracer.active()
        tid = tr.trace_id if tr is not None else next(self.tracer._ids)
        return {
            "id": f"{node_id:x}-{tid}",
            "origin": node_id,
            "hop": 0,
            "ts": int(self.clock.time() * 1e6),
        }

    # -- wiring -------------------------------------------------------------

    def _wire_core(self, core) -> None:
        self._func("ingest_syncs_total", lambda: core.ingest_syncs)
        self._func(
            "ingest_batch_verifies_total",
            lambda: core.ingest_batch_verifies,
        )
        self._func(
            "ingest_batch_size_max", lambda: core.ingest_batch_size_max
        )
        self._func(
            "ingest_fallback_singles_total",
            lambda: core.ingest_fallback_singles,
        )
        self._func(
            "node_last_block_index", lambda: core.get_last_block_index()
        )
        self._func(
            "node_last_consensus_round",
            lambda: (
                -1
                if core.get_last_consensus_round_index() is None
                else core.get_last_consensus_round_index()
            ),
        )
        self._func(
            "node_consensus_events",
            lambda: core.get_consensus_events_count(),
        )
        self._func(
            "node_undetermined_events",
            lambda: len(core.get_undetermined_events()),
        )
        self._func(
            "node_consensus_transactions_total",
            lambda: core.get_consensus_transactions_count(),
        )
        self._func(
            "node_peers", lambda: len(core.peer_selector.get_peers())
        )

    def _wire_mempool(self, m) -> None:
        if self.enabled:
            m.attach_telemetry(
                self.commit_latency,
                self._tx_stage.labels(stage="mempool_wait"),
                self._tx_stage.labels(stage="consensus"),
            )
            m.attach_provenance(self.provenance)
        self._func(
            "trace_sampled_txs_total",
            lambda: self.provenance.sampled_total,
        )
        self._func(
            "trace_provenance_entries", lambda: len(self.provenance)
        )
        self._func(
            "trace_provenance_evictions_total",
            lambda: self.provenance.evictions,
        )
        self._func("mempool_pending", lambda: m.pending_count)
        self._func("mempool_pending_bytes", lambda: m.pending_bytes)
        self._func("mempool_inflight", lambda: len(m._inflight))
        self._func("mempool_submitted_total", lambda: m.submitted)
        self._func("mempool_accepted_total", lambda: m.accepted)
        self._func(
            "mempool_rejected_total",
            lambda: {
                "full": m.rejected_full,
                "duplicate": m.rejected_dup,
                "oversized": m.rejected_oversized,
                "throttled": m.rejected_throttled,
                "already_committed": m.committed_dedup_hits,
            },
        )
        self._func("mempool_committed_total", lambda: m.committed_total)
        self._func("mempool_evictions_total", lambda: m.evictions)
        self._func("mempool_requeued_total", lambda: m.requeued)
        self._func("mempool_commit_drops_total", lambda: m.commit_drops)
        self._func("mempool_inflight_aged_total", lambda: m.inflight_aged)

    def _wire_sentry(self, s) -> None:
        self._func(
            "sentry_quarantined_peers",
            lambda: s.stats()["sentry_quarantined_peers"],
        )
        self._func(
            "sentry_quarantines_total", lambda: s.quarantines_total
        )
        self._func(
            "sentry_quarantine_deferrals_total",
            lambda: s.quarantine_deferrals,
        )
        self._func("sentry_readmissions_total", lambda: s.readmissions)
        self._func("sentry_refused_rpcs_total", lambda: s.refused_rpcs)
        self._func("sentry_proofs", lambda: len(s._proofs))
        self._func("sentry_rejects_total", lambda: dict(s.rejects))

    def _wire_selector(self, core) -> None:
        # The selector object is REPLACED on membership changes
        # (Core.set_peers), so readers resolve it through the core on
        # every scrape instead of capturing the instance.
        # The two _peers gauges need a sweep over per-peer health state,
        # which only stats() computes (under the selector lock); the
        # plain counters are read as attributes so a scrape doesn't take
        # the selector lock once per instrument. A short-TTL memo lets
        # ONE sweep serve both gauges within a single collect pass.
        sel_memo = {"t": -1.0, "v": None}

        def _sel_stats():
            now = time.monotonic()
            if sel_memo["v"] is None or now - sel_memo["t"] > 0.05:
                sel_memo["v"] = core.peer_selector.stats()
                sel_memo["t"] = now
            return sel_memo["v"]

        for key in (
            "selector_unhealthy_peers",
            "selector_backed_off_peers",
        ):
            self._func(key, lambda k=key: _sel_stats()[k])
        for attr in (
            "backoff_skips",
            "probe_picks",
            "starvation_overrides",
            "quarantine_skips",
            "quarantine_overrides",
        ):
            self._func(
                f"selector_{attr}_total",
                lambda a=attr: getattr(core.peer_selector, a),
            )

    def _wire_accel(self, accel) -> None:
        hist = self._histogram("accel_stage_seconds", STAGE_BUCKETS)
        children: Dict[str, object] = {}

        def observe(stage: str, seconds: float) -> None:
            child = children.get(stage)
            if child is None:
                child = hist.labels(stage=stage)
                children[stage] = child
            child.observe(seconds)

        if self.enabled:
            accel.stage_observer = observe
        self._func("accel_sweeps_total", lambda: accel.sweeps)
        self._func("accel_fallbacks_total", lambda: accel.fallbacks)
        self._func(
            "accel_compile_waits_total", lambda: accel.compile_waits
        )
        self._func("accel_stale_drops_total", lambda: accel.stale_drops)
        self._func(
            "accel_rebuilds_total",
            lambda: (
                accel.window_state.rebuilds
                if accel.window_state is not None
                else 0
            ),
        )
        self._func(
            "accel_rows_delta_total", lambda: accel.rows_delta_total
        )
        self._func(
            "accel_rows_reused_total", lambda: accel.rows_reused_total
        )
        self._func(
            "accel_mesh_pad_rows_total", lambda: accel.mesh_pad_rows
        )
        self._func(
            "accel_mesh_fallbacks_total", lambda: accel.mesh_fallbacks
        )

        def _copro(key: str, default=0):
            from ..hashgraph.sweep_batcher import SweepBatcher

            b = SweepBatcher._instance
            return b.stats().get(key, default) if b is not None else default

        self._func("copro_waves_total", lambda: _copro("copro_waves"))
        self._func("copro_windows_total", lambda: _copro("copro_windows"))
        self._func(
            "copro_validators", lambda: _copro("copro_validators")
        )
        self._func(
            "accel_breaker_state",
            lambda: {"closed": 0, "half_open": 1, "open": 2}.get(
                accel.breaker.stats()["breaker_state"], -1
            ),
        )
        self._func(
            "accel_breaker_opens_total", lambda: accel.breaker.opens
        )

    def bind_node(self, node) -> None:
        """Register the node-level instruments (RPC counters, queue
        depth) once the Node wrapping this core exists."""
        self._node = node
        self._func("sync_requests_total", lambda: node.sync_requests)
        self._func("sync_errors_total", lambda: node.sync_errors)
        self._func("rpc_errors_total", lambda: dict(node.rpc_errors))
        self._func(
            "gossip_transport_errors_total",
            lambda: node.gossip_transport_errors,
        )
        self._func(
            "sync_limit_truncations_total",
            lambda: node.sync_limit_truncations,
        )
        self._func(
            "sync_diff_truncations_total",
            lambda: node.sync_diff_truncations,
        )
        self._func("submit_queue_depth", lambda: node.submit_q.qsize())
        self._func(
            "core_lock_wait_seconds_total",
            lambda: round(node.core_lock.wait_s_total, 6),
        )
        self._func(
            "core_lock_acquisitions_total",
            lambda: node.core_lock.acquisitions,
        )
        self._func(
            "trace_ctx_rpcs_total", lambda: node.trace_ctx_rpcs
        )
        # Async gossip engine (docs/gossip.md): pipeline occupancy.
        # node.pipeline is None when the pipeline is disabled (sim clock
        # or config) — the instruments then read 0.
        self._func(
            "gossip_inflight_syncs",
            lambda: node.pipeline.inflight if node.pipeline else 0,
        )
        self._func(
            "gossip_inflight_syncs_peak",
            lambda: node.pipeline.inflight_peak if node.pipeline else 0,
        )
        self._func(
            "gossip_pipelined_syncs_total",
            lambda: node.pipeline.pipelined_syncs if node.pipeline else 0,
        )
        self._func(
            "gossip_backpressure_stalls_total",
            lambda: (
                node.pipeline.backpressure_stalls if node.pipeline else 0
            ),
        )
        self._func(
            "gossip_pipeline_queue_depth",
            lambda: node.pipeline.queue_depth() if node.pipeline else 0,
        )
        self._func(
            "gossip_pull_pipelined_total",
            lambda: node.pipeline.pull_pipelined if node.pipeline else 0,
        )
        self._func(
            "gossip_pipeline_soft_depth",
            lambda: (
                node.pipeline.soft_depth
                if node.pipeline
                else node.conf.gossip_pipeline_depth
            ),
        )
        # Adaptive gossip scheduler (docs/gossip.md §Adaptive
        # scheduling): the published plan, its change count, and the
        # per-peer lag extremes feeding the control law. With the
        # controller off the gauges read the fixed law's choices.
        self._func(
            "adaptive_interval_seconds",
            lambda: (
                node.adaptive.current().interval
                if node.adaptive is not None
                # gossip_plan IS the fixed law (pure) with the
                # controller off — one implementation, no drift
                else node.gossip_plan()[0]
            ),
        )
        self._func(
            "adaptive_fanout",
            lambda: (
                node.adaptive.current().fanout
                if node.adaptive is not None
                else 1
            ),
        )
        self._func(
            "adaptive_adjustments_total",
            lambda: (
                node.adaptive.adjustments
                if node.adaptive is not None
                else 0
            ),
        )
        # One lag sweep serves both gauges within a collect pass (the
        # sweep takes the selector + lag locks and prunes stale
        # entries — same short-TTL memo shape as the selector gauges).
        lag_memo = {"t": -1.0, "v": (0, 0)}

        def _lag():
            now = time.monotonic()
            if lag_memo["t"] < 0 or now - lag_memo["t"] > 0.05:
                lag_memo["v"] = node._lag_extremes()
                lag_memo["t"] = now
            return lag_memo["v"]

        self._func("gossip_peer_behind_max", lambda: _lag()[0])
        self._func("gossip_self_behind_max", lambda: _lag()[1])
        self._func(
            "selfevent_coalesced_total",
            lambda: node.core.selfevent_coalesced,
        )
        # Light-client gateway tier (docs/clients.md): hub gauges read 0
        # while --client-listen is off; the proof index always runs.
        # One stats() sweep serves all four hub instruments per collect
        # pass (the selector/lag memo shape).
        hub_memo = {"t": -1.0, "v": None}

        def _hub_stats():
            now = time.monotonic()
            if hub_memo["v"] is None or now - hub_memo["t"] > 0.05:
                hub = node.client_hub
                hub_memo["v"] = hub.stats() if hub is not None else {}
                hub_memo["t"] = now
            return hub_memo["v"]

        self._func(
            "client_subscribers",
            lambda: _hub_stats().get("subscribers", 0),
        )
        self._func(
            "client_sub_queue_frames_max",
            lambda: _hub_stats().get("queue_frames_max", 0),
        )
        self._func(
            "client_pushed_blocks_total",
            lambda: _hub_stats().get("pushed_blocks", 0),
        )
        self._func(
            "client_shed_subscribers_total",
            lambda: _hub_stats().get("shed", 0),
        )
        self._func("client_proofs_served_total", lambda: node.proofs_served)
        self._func("client_proof_misses_total", lambda: node.proof_misses)
        self._func("client_txindex_entries", lambda: len(node.txindex))
        self._func(
            "client_checkpoint_exports_total",
            lambda: node.checkpoint_exports,
        )
        # Lifecycle tier (docs/lifecycle.md): compaction progress and
        # the retained store footprint. The size gauges share the
        # node's 1s-TTL size_stats memo (COUNT(*) on a persistent
        # store), so a scrape never runs the queries more than once.
        self._func(
            "lifecycle_events_retained",
            lambda: node._store_size_stats().get("events", 0),
        )
        self._func(
            "lifecycle_rounds_retained",
            lambda: node._store_size_stats().get("rounds", 0),
        )
        self._func(
            "lifecycle_store_bytes",
            lambda: node._store_size_stats().get("store_bytes", 0),
        )
        self._func(
            "lifecycle_prune_floor_round",
            lambda: (
                -1
                if node.core.hg.prune_floor is None
                else node.core.hg.prune_floor
            ),
        )

        def _prune_lag():
            lcr = node.core.get_last_consensus_round_index()
            if lcr is None:
                return 0
            floor = node.core.hg.prune_floor or 0
            return max(0, int(lcr) - max(floor, 0))

        self._func("lifecycle_prune_lag_rounds", _prune_lag)
        self._func(
            "lifecycle_prunes_total",
            lambda: node.pruner.prunes if node.pruner else 0,
        )
        self._func(
            "lifecycle_pruned_events_total",
            lambda: node.pruner.events_pruned if node.pruner else 0,
        )
        self._func(
            "lifecycle_behind_retention_total",
            lambda: node.behind_retention_rejections,
        )
        self._func(
            "watchdog_trips_total",
            lambda: getattr(node.watchdog, "trips", 0),
        )
        self._func(
            "flight_dumps_total",
            lambda: getattr(node.watchdog, "dumps", 0),
        )

    # -- views --------------------------------------------------------------

    def commit_latency_ms(self) -> Dict[str, object]:
        """p50/p90/p99 (ms) + sample count of the end-to-end commit
        latency histogram — the north-star numbers."""
        s = self.commit_latency.summary()
        return {
            "count": s["count"],
            "p50_ms": None if s["p50"] is None else round(1e3 * s["p50"], 1),
            "p90_ms": None if s["p90"] is None else round(1e3 * s["p90"], 1),
            "p99_ms": None if s["p99"] is None else round(1e3 * s["p99"], 1),
        }

    def render_metrics(self) -> str:
        """Prometheus text exposition: node registry + process-global."""
        return self.registry.render() + GLOBAL.render()

    def telemetry_view(self) -> Dict[str, object]:
        """Structured JSON for /telemetry: every instrument (histograms
        with computed p50/p90/p99) + the recent sync-trace ring."""
        out: Dict[str, object] = {
            "enabled": self.enabled,
            "instruments": self.registry.snapshot(),
            "global": GLOBAL.snapshot(),
            "commit_latency_ms": self.commit_latency_ms(),
            "recent_syncs": self.tracer.recent(),
        }
        if self._node is not None:
            out["node"] = {
                "id": self._node.get_id(),
                "moniker": self._core.validator.moniker,
                "state": str(self._node.get_state()),
            }
        return out

    def value(self, name: str, **labels):
        """Assertion helper: current value of one instrument."""
        return self.registry.get(name, **labels)
