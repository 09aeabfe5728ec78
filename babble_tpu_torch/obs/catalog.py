"""Instrument catalog — the single source of truth for every metric.

``NodeTelemetry`` registers instruments BY NAME through this catalog
(an unknown name raises, so an undocumented instrument cannot ship);
``docs/observability.md`` carries the same set as a markdown table; and
``python -m babble_tpu.obs.lint`` fails the JAX package's build when the
two drift in either direction; this copy keeps the same instrument set. Scopes:

- ``node``   — registered for every node;
- ``accel``  — registered only when the node runs with ``--accelerator``;
- ``global`` — process-wide (shared by co-located nodes).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Instrument(NamedTuple):
    name: str
    kind: str  # counter | gauge | histogram
    labels: Tuple[str, ...]
    scope: str  # node | accel | global
    help: str


_C, _G, _H = "counter", "gauge", "histogram"

CATALOG: Tuple[Instrument, ...] = (
    # -- end-to-end latency + pipeline stages -------------------------------
    Instrument(
        "commit_latency_seconds", _H, (), "node",
        "End-to-end submit-to-commit latency for transactions admitted by "
        "THIS node's mempool (admit timestamp to Core.commit).",
    ),
    Instrument(
        "tx_stage_seconds", _H, ("stage",), "node",
        "Transaction lifecycle split: mempool_wait (admit to drain into a "
        "self-event) and consensus (drain to block commit).",
    ),
    Instrument(
        "sync_stage_seconds", _H, ("stage",), "node",
        "Per-stage wall time of the gossip/consensus pipeline: "
        "request_sync, decode, batch_verify, insert, divide_rounds, "
        "decide_fame, round_received, commit, proxy_deliver, "
        "process_sig_pool, diff, eager_sync, mempool_drain, self_event.",
    ),
    Instrument(
        "core_lock_wait_seconds", _H, (), "node",
        "Time spent WAITING to acquire the core lock per contended "
        "acquisition (uncontended acquires are not observed).",
    ),
    # -- core lock / ingest fast path ---------------------------------------
    Instrument(
        "core_lock_wait_seconds_total", _C, (), "node",
        "Total core-lock acquisition wait (the legacy lock_wait_ms_total, "
        "in seconds).",
    ),
    Instrument(
        "core_lock_acquisitions_total", _C, (), "node",
        "Core-lock acquisitions.",
    ),
    Instrument(
        "ingest_syncs_total", _C, (), "node",
        "Incoming syncs ingested (pull responses + eager pushes).",
    ),
    Instrument(
        "ingest_batch_verifies_total", _C, (), "node",
        "Native batch signature-verification calls (one per sync chunk on "
        "the happy path).",
    ),
    Instrument(
        "ingest_batch_size_max", _G, (), "node",
        "Largest batch handed to the batch verifier so far.",
    ),
    Instrument(
        "ingest_fallback_singles_total", _C, (), "node",
        "Per-event scalar signature re-checks after a batch reported "
        "failures (offender pinpointing).",
    ),
    # -- gossip / RPC surface ----------------------------------------------
    Instrument(
        "sync_requests_total", _C, (), "node",
        "SyncRequest RPCs served.",
    ),
    Instrument(
        "sync_errors_total", _C, (), "node",
        "SyncRequest handler errors.",
    ),
    Instrument(
        "rpc_errors_total", _C, ("type",), "node",
        "Handler crashes per RPC type (sync, eager_sync, fast_forward, "
        "join) — crashes, not remote faults.",
    ),
    Instrument(
        "gossip_transport_errors_total", _C, (), "node",
        "Outbound gossip rounds that failed with a TransportError "
        "(network faults, not handler errors).",
    ),
    Instrument(
        "sync_limit_truncations_total", _C, (), "node",
        "Incoming batches truncated to our sync_limit (receiving-side "
        "cap).",
    ),
    Instrument(
        "sync_diff_truncations_total", _C, (), "node",
        "Outbound push diffs cut to sync_limit before sending "
        "(sender-side cap) — a chronically-truncating peer is more than "
        "one sync_limit behind us.",
    ),
    Instrument(
        "submit_queue_depth", _G, (), "node",
        "Transactions sitting in the proxy submit queue (sampled at "
        "scrape).",
    ),
    # -- async gossip engine (docs/gossip.md) -------------------------------
    Instrument(
        "gossip_inflight_syncs", _G, (), "node",
        "Inbound syncs currently in the decode→verify→insert pipeline "
        "(between submit and response).",
    ),
    Instrument(
        "gossip_inflight_syncs_peak", _G, (), "node",
        "High-water mark of gossip_inflight_syncs.",
    ),
    Instrument(
        "gossip_pipelined_syncs_total", _C, (), "node",
        "Inbound syncs that went through the pipeline's bounded insert "
        "queue (vs handled inline).",
    ),
    Instrument(
        "gossip_backpressure_stalls_total", _C, (), "node",
        "Pipeline submits that found the insert queue full "
        "(backpressure propagating to the transport).",
    ),
    Instrument(
        "gossip_pipeline_queue_depth", _G, (), "node",
        "Prepared syncs sitting in the pipeline's bounded insert queue "
        "RIGHT NOW (sampled at scrape; the live-backpressure twin of "
        "the stall counters).",
    ),
    Instrument(
        "gossip_pull_pipelined_total", _C, (), "node",
        "Gossip pull legs whose insert tail went through the staged "
        "pipeline instead of running on the gossip thread.",
    ),
    Instrument(
        "gossip_pipeline_soft_depth", _G, (), "node",
        "Adaptive soft cap on the pipeline's insert queue: submits "
        "backpressure at this depth (shrinks under ingest congestion; "
        "equals the hard depth when uncongested).",
    ),
    # -- adaptive gossip scheduler (docs/gossip.md §Adaptive scheduling) ----
    Instrument(
        "adaptive_interval_seconds", _G, (), "node",
        "Gossip interval currently published by the adaptive scheduler "
        "(the fixed two-speed choice when adaptation is off).",
    ),
    Instrument(
        "adaptive_fanout", _G, (), "node",
        "Distinct gossip partners per tick currently published by the "
        "adaptive scheduler (1 when adaptation is off).",
    ),
    Instrument(
        "adaptive_adjustments_total", _C, (), "node",
        "Times the adaptive scheduler re-published interval, fan-out, "
        "or pipeline soft depth (hysteresis-gated output changes).",
    ),
    Instrument(
        "gossip_peer_behind_max", _G, (), "node",
        "Max events any peer trails US by, from the last exchanged "
        "known-maps (the adaptive spread signal).",
    ),
    Instrument(
        "gossip_self_behind_max", _G, (), "node",
        "Max events WE trail any peer by, from the last exchanged "
        "known-maps (the adaptive tempo signal).",
    ),
    Instrument(
        "selfevent_coalesced_total", _C, (), "node",
        "Extra self-events minted by hot-mempool coalescing (beyond the "
        "reference's one per tick).",
    ),
    # -- consensus progress -------------------------------------------------
    Instrument(
        "node_last_block_index", _G, (), "node",
        "Index of the last committed block.",
    ),
    Instrument(
        "node_last_consensus_round", _G, (), "node",
        "Last round that reached consensus (-1 before the first).",
    ),
    Instrument(
        "node_consensus_events", _G, (), "node",
        "Events that reached consensus order.",
    ),
    Instrument(
        "node_undetermined_events", _G, (), "node",
        "Events whose round-received is still undecided.",
    ),
    Instrument(
        "node_consensus_transactions_total", _C, (), "node",
        "Transactions carried by consensus events so far.",
    ),
    Instrument(
        "node_peers", _G, (), "node",
        "Current peer-set size as seen by the selector.",
    ),
    # -- mempool ------------------------------------------------------------
    Instrument(
        "mempool_pending", _G, (), "node",
        "Pending (admitted, not yet drained) transactions.",
    ),
    Instrument(
        "mempool_pending_bytes", _G, (), "node",
        "Bytes held by pending transactions.",
    ),
    Instrument(
        "mempool_inflight", _G, (), "node",
        "Drained-but-uncommitted transaction hashes tracked for dedup.",
    ),
    Instrument(
        "mempool_submitted_total", _C, (), "node",
        "Admission attempts.",
    ),
    Instrument(
        "mempool_accepted_total", _C, (), "node",
        "Admissions that returned `accepted`.",
    ),
    Instrument(
        "mempool_rejected_total", _C, ("reason",), "node",
        "Rejected admissions by verdict: full, duplicate, oversized, "
        "throttled, already_committed.",
    ),
    Instrument(
        "mempool_committed_total", _C, (), "node",
        "Transactions marked committed through this node's commit path.",
    ),
    Instrument(
        "mempool_evictions_total", _C, (), "node",
        "Oldest-pending evictions under the evict-oldest overflow policy.",
    ),
    Instrument(
        "mempool_requeued_total", _C, (), "node",
        "Drained transactions put back after a failed self-event insert.",
    ),
    Instrument(
        "mempool_commit_drops_total", _C, (), "node",
        "Pending copies dropped because the same tx committed via another "
        "node's event.",
    ),
    Instrument(
        "mempool_inflight_aged_total", _C, (), "node",
        "In-flight hashes aged out past the dedup cap.",
    ),
    # -- light-client gateway tier (docs/clients.md) ------------------------
    Instrument(
        "client_subscribers", _G, (), "node",
        "Live streaming-subscription connections on this node's "
        "SubscriptionHub (0 when --client-listen is off).",
    ),
    Instrument(
        "client_sub_queue_frames_max", _G, (), "node",
        "Largest per-subscriber outbound frame queue right now "
        "(sampled at scrape; the bound is sub_queue_frames).",
    ),
    Instrument(
        "client_pushed_blocks_total", _C, (), "node",
        "Sealed block frames queued to subscribers (one per block per "
        "subscriber).",
    ),
    Instrument(
        "client_shed_subscribers_total", _C, (), "node",
        "Subscribers shed for stalling (no socket progress with queued "
        "frames) or a chronic delivery deficit.",
    ),
    Instrument(
        "client_proofs_served_total", _C, (), "node",
        "GET /proof/<txid> requests answered with a signed Merkle "
        "inclusion proof.",
    ),
    Instrument(
        "client_proof_misses_total", _C, (), "node",
        "Proof lookups for unknown or aged-out transactions (404s).",
    ),
    Instrument(
        "client_txindex_entries", _G, (), "node",
        "Transactions currently indexed for proof serving (bounded by "
        "txindex_cap, oldest aged out).",
    ),
    Instrument(
        "client_checkpoint_exports_total", _C, (), "node",
        "GET /checkpoint fast-sync snapshots exported.",
    ),
    # -- lifecycle tier (docs/lifecycle.md) ---------------------------------
    Instrument(
        "lifecycle_events_retained", _G, (), "node",
        "Events currently held by the hashgraph store (post-compaction "
        "retained set; the plateau signal of checkpoint-prune).",
    ),
    Instrument(
        "lifecycle_rounds_retained", _G, (), "node",
        "Rounds currently held by the hashgraph store.",
    ),
    Instrument(
        "lifecycle_store_bytes", _G, (), "node",
        "Durable store footprint in bytes (SQLite page_count x "
        "page_size; 0 for a purely in-memory store).",
    ),
    Instrument(
        "lifecycle_prune_floor_round", _G, (), "node",
        "Retention floor: consensus history below this round has been "
        "compacted away (-1 before the first prune).",
    ),
    Instrument(
        "lifecycle_prune_lag_rounds", _G, (), "node",
        "Rounds of committed history retained above the prune floor "
        "(last_consensus_round - floor); grows unbounded when pruning "
        "is off or stalled.",
    ),
    Instrument(
        "lifecycle_prunes_total", _C, (), "node",
        "Checkpoint-prune compactions completed.",
    ),
    Instrument(
        "lifecycle_pruned_events_total", _C, (), "node",
        "Events dropped by compaction, cumulative.",
    ),
    Instrument(
        "lifecycle_behind_retention_total", _C, (), "node",
        "/checkpoint requests refused with the behind_retention slug "
        "(client asked for history below the prune floor).",
    ),
    # -- causal tracing / flight recorder ----------------------------------
    Instrument(
        "trace_sampled_txs_total", _C, (), "node",
        "Transactions sampled into the commit-provenance table "
        "(deterministic cross-node sampling, docs/observability.md "
        "§Causal tracing).",
    ),
    Instrument(
        "trace_provenance_entries", _G, (), "node",
        "Live commit-provenance records (bounded table, oldest evicted).",
    ),
    Instrument(
        "trace_provenance_evictions_total", _C, (), "node",
        "Provenance records evicted past the table cap.",
    ),
    Instrument(
        "trace_ctx_rpcs_total", _C, (), "node",
        "Inbound Sync/EagerSync/FastForward RPCs that carried a wire "
        "trace context.",
    ),
    Instrument(
        "watchdog_trips_total", _C, (), "node",
        "Stall-watchdog trips (busy node, no consensus progress past "
        "the threshold).",
    ),
    Instrument(
        "flight_dumps_total", _C, (), "node",
        "Flight-recorder artifacts written (bounded per node).",
    ),
    # -- peer selector / gossip health -------------------------------------
    Instrument(
        "selector_unhealthy_peers", _G, (), "node",
        "Peers with a nonzero consecutive-failure count.",
    ),
    Instrument(
        "selector_backed_off_peers", _G, (), "node",
        "Peers currently inside a backoff window.",
    ),
    Instrument(
        "selector_backoff_skips_total", _C, (), "node",
        "Peer picks skipped because the peer was backed off.",
    ),
    Instrument(
        "selector_probe_picks_total", _C, (), "node",
        "Deterministic probe picks of expired-backoff peers.",
    ),
    Instrument(
        "selector_starvation_overrides_total", _C, (), "node",
        "All-backed-off liveness overrides.",
    ),
    Instrument(
        "selector_quarantine_skips_total", _C, (), "node",
        "Peer picks skipped because the sentry quarantined the peer.",
    ),
    Instrument(
        "selector_quarantine_overrides_total", _C, (), "node",
        "All-quarantined liveness overrides.",
    ),
    # -- sentry -------------------------------------------------------------
    Instrument(
        "sentry_quarantined_peers", _G, (), "node",
        "Peers currently quarantined.",
    ),
    Instrument(
        "sentry_quarantines_total", _C, (), "node",
        "Quarantines imposed.",
    ),
    Instrument(
        "sentry_quarantine_deferrals_total", _C, (), "node",
        "Quarantines deferred by the BFT framing-guard cap.",
    ),
    Instrument(
        "sentry_readmissions_total", _C, (), "node",
        "Quarantine expiries that re-admitted a peer.",
    ),
    Instrument(
        "sentry_refused_rpcs_total", _C, (), "node",
        "Inbound syncs refused from quarantined peers.",
    ),
    Instrument(
        "sentry_proofs", _G, (), "node",
        "Durable equivocation proofs on file.",
    ),
    Instrument(
        "sentry_rejects_total", _C, ("cause",), "node",
        "Classified ingest rejections by cause slug "
        "(docs/robustness.md attack catalog).",
    ),
    # -- accelerator (scope: accel) ----------------------------------------
    Instrument(
        "accel_stage_seconds", _H, ("stage",), "accel",
        "Per-stage device-sweep time: build, delta_scan, pack, dispatch, "
        "kernel, readback, apply.",
    ),
    Instrument(
        "accel_sweeps_total", _C, (), "accel",
        "Voting sweeps executed on the device path.",
    ),
    Instrument(
        "accel_fallbacks_total", _C, (), "accel",
        "Sweeps that fell back to the host oracle.",
    ),
    Instrument(
        "accel_compile_waits_total", _C, (), "accel",
        "Sweeps that waited on a compile (0 in the port: nothing compiles while it runs).",
    ),
    Instrument(
        "accel_stale_drops_total", _C, (), "accel",
        "Sweep results dropped for arriving with a stale window "
        "generation.",
    ),
    Instrument(
        "accel_rebuilds_total", _C, (), "accel",
        "Window-state rebuilds (incremental path fell back to a full "
        "snapshot).",
    ),
    Instrument(
        "accel_rows_delta_total", _C, (), "accel",
        "Window rows uploaded as deltas.",
    ),
    Instrument(
        "accel_rows_reused_total", _C, (), "accel",
        "Window rows served from device-resident buffers.",
    ),
    Instrument(
        "accel_mesh_pad_rows_total", _C, (), "accel",
        "Witness rows padded onto windows to align the W axis with the "
        "mesh shard count.",
    ),
    Instrument(
        "accel_mesh_fallbacks_total", _C, (), "accel",
        "Mesh sweeps that fell back to the single-device program "
        "(unaligned window that could not be padded).",
    ),
    Instrument(
        "copro_waves_total", _C, (), "accel",
        "Coprocessor dispatch waves: batched sweep launches over a "
        "shared device mesh (process-wide).",
    ),
    Instrument(
        "copro_windows_total", _C, (), "accel",
        "Validator windows multiplexed through coprocessor waves "
        "(process-wide).",
    ),
    Instrument(
        "copro_validators", _G, (), "accel",
        "Distinct validators that have shared the coprocessor mesh "
        "(process-wide).",
    ),
    Instrument(
        "accel_breaker_state", _G, (), "accel",
        "Circuit-breaker state: 0=closed, 1=half_open, 2=open.",
    ),
    Instrument(
        "accel_breaker_opens_total", _C, (), "accel",
        "closed-to-open breaker transitions.",
    ),
    # -- process-wide (scope: global) --------------------------------------
    Instrument(
        "wire_cache_hits_total", _C, (), "global",
        "Wire-event serialization cache hits (process-wide).",
    ),
    Instrument(
        "wire_cache_misses_total", _C, (), "global",
        "Wire-event serialization cache misses (process-wide).",
    ),
    Instrument(
        "norm_cache_hits_total", _C, (), "global",
        "Canonical-JSON normalization cache hits (process-wide).",
    ),
    Instrument(
        "norm_cache_misses_total", _C, (), "global",
        "Canonical-JSON normalization cache misses (process-wide).",
    ),
    Instrument(
        "verify_cache_hits_total", _C, (), "global",
        "Signature-verdict cache hits (process-wide).",
    ),
    Instrument(
        "verify_cache_misses_total", _C, (), "global",
        "Signature-verdict cache misses (process-wide).",
    ),
    Instrument(
        "wire_bytes_sent_total", _C, (), "global",
        "Bytes written to gossip sockets, all transports and protocols "
        "(process-wide).",
    ),
    Instrument(
        "wire_bytes_received_total", _C, (), "global",
        "Bytes read from gossip sockets, all transports and protocols "
        "(process-wide).",
    ),
    Instrument(
        "codec_events_encoded_total", _C, (), "global",
        "Wire events encoded into binary blobs (blob-memo misses; "
        "process-wide).",
    ),
    Instrument(
        "codec_event_cache_hits_total", _C, (), "global",
        "Event sends served from the binary blob memo — one encode per "
        "event per process, however many peers it is pushed to.",
    ),
    Instrument(
        "codec_events_decoded_total", _C, (), "global",
        "Binary event blobs decoded at ingest (process-wide).",
    ),
    Instrument(
        "codec_conns_binary_total", _C, (), "global",
        "Inbound connections that negotiated the binary protocol "
        "(process-wide).",
    ),
    Instrument(
        "codec_conns_json_total", _C, (), "global",
        "Inbound connections that fell back to the legacy JSON framing "
        "(process-wide).",
    ),
    Instrument(
        "profile_stage_samples", _C, ("stage",), "global",
        "Sampling-profiler thread-stack samples bucketed into the stage "
        "taxonomy by frame matching (sync + accel stages plus "
        "lock_wait, idle, other; docs/observability.md §Sampling "
        "profiler).",
    ),
)

BY_NAME: Dict[str, Instrument] = {i.name: i for i in CATALOG}

# Stage label values documented for the span tables (docs lint checks
# the stage table too, so a new stage must be documented to ship).
SYNC_STAGES = (
    "request_sync", "decode", "batch_verify", "insert", "divide_rounds",
    "decide_fame", "round_received", "commit", "proxy_deliver",
    "process_sig_pool", "diff", "eager_sync", "mempool_drain",
    "self_event",
)
TX_STAGES = ("mempool_wait", "consensus")
ACCEL_STAGES = (
    "build", "delta_scan", "pack", "dispatch", "kernel", "readback",
    "apply",
)
# Profiler stage buckets (obs/profile.py): the union of the two stage
# families above plus the sampler-only buckets.
PROFILE_STAGES = SYNC_STAGES + ACCEL_STAGES + ("lock_wait", "idle", "other")


def spec(name: str) -> Instrument:
    """Catalog lookup used at registration time: an instrument that is
    not documented here cannot be registered at all."""
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"instrument {name!r} is not in the obs catalog — add it to "
            "babble_tpu_torch/obs/catalog.py"
        ) from None
