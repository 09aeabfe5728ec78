"""Configuration for a node, with the reference's defaults.

Reference semantics: src/config/config.go:34-56 (defaults),
config/config.go:58-197 (fields), config/config.go:287-308 (datadir
conventions). Durations are seconds (float) rather than Go durations.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field


DEFAULT_KEYFILE = "priv_key"
DEFAULT_BADGER_DIR = "badger_db"
DEFAULT_PEERS_FILE = "peers.json"
DEFAULT_GENESIS_PEERS_FILE = "peers.genesis.json"

# Sentry defaults — the single source of truth, shared by the Config
# fields below and Sentry.__init__ (node/sentry.py) so a Core built
# without an injected sentry can't drift from the configured tuning.
DEFAULT_SENTRY_THRESHOLD = 8.0
DEFAULT_SENTRY_QUARANTINE_S = 30.0
DEFAULT_SENTRY_DECAY_HALFLIFE_S = 30.0

# Causal-tracing / flight-recorder defaults — single source of truth,
# shared by the Config fields below, ProvenanceTable (obs/provenance.py)
# and StallWatchdog (obs/flight.py) so standalone cores and bare
# watchdogs can't drift from the configured tuning.
DEFAULT_TRACE_SAMPLE = 1.0 / 64.0
DEFAULT_TRACE_TABLE_CAP = 4096
DEFAULT_WATCHDOG_STALL_S = 10.0
DEFAULT_WATCHDOG_INTERVAL_S = 1.0

# Always-on sampling profiler (obs/profile.py): thread-stack samples per
# second, bucketed into the stage taxonomy and served as collapsed
# stacks at GET /profile. 0 disables; BABBLE_PROFILE_HZ overrides a
# whole cluster; BABBLE_OBS=0 disables regardless.
DEFAULT_PROFILE_HZ = 50.0

# Lifecycle tier defaults (docs/lifecycle.md) — single source of truth,
# shared by the Config fields below and CheckpointPruner so a pruner
# built outside a node can't drift from the configured cadence.
DEFAULT_PRUNE_EVERY_ROUNDS = 0  # 0 = compaction off (append-only store)
DEFAULT_PRUNE_KEEP_ROUNDS = 2
DEFAULT_PRUNE_VACUUM = True


def default_data_dir() -> str:
    """~/.babble equivalent (reference: config/config.go:287-297)."""
    return os.path.join(os.path.expanduser("~"), ".babble_tpu")


@dataclass
class Config:
    """Node configuration (reference: config/config.go:58-197)."""

    data_dir: str = field(default_factory=default_data_dir)
    log_level: str = "info"
    # Structured JSON log lines (obs/log.py): one object per line with
    # ts/level/logger/msg + node correlation fields. Plain text when off.
    log_json: bool = False

    bind_addr: str = "127.0.0.1:1337"
    advertise_addr: str = ""
    service_addr: str = "127.0.0.1:8000"
    no_service: bool = False

    heartbeat_timeout: float = 0.010  # 10 ms busy gossip cadence
    slow_heartbeat_timeout: float = 1.0  # idle gossip cadence
    tcp_timeout: float = 1.0
    join_timeout: float = 10.0

    max_pool: int = 2
    cache_size: int = 10000
    sync_limit: int = 1000
    suspend_limit: int = 100

    # Async gossip engine (docs/gossip.md): "async" builds the
    # event-driven selector transport (net/atcp.py — multiplexed
    # connections, binary framed codec, per-connection version
    # negotiation so JSON peers interoperate); "tcp" keeps the
    # thread-per-connection fallback (net/tcp.py).
    transport: str = "tcp"
    # Inbound-sync pipeline (node/pipeline.py): concurrent decode +
    # batch-verify stages feeding one serialized inserter through a
    # bounded queue (depth = backpressure threshold). Auto-disabled
    # under an injected sim clock (determinism). With the pipeline on,
    # the gossip PULL leg stages through the same queue, so a slow
    # insert never blocks the next pull round-trip.
    gossip_pipeline: bool = True
    gossip_pipeline_depth: int = 64

    # Adaptive gossip scheduler (node/adaptive.py, docs/gossip.md
    # §Adaptive scheduling): sync frequency, fan-out, and pipeline soft
    # depth driven by live load signals (mempool pressure, per-peer lag,
    # pipeline congestion), clamped to [heartbeat_timeout,
    # slow_heartbeat_timeout] x [1, gossip_max_fanout]. BABBLE_ADAPT=0
    # (env, cluster-wide) or adaptive_gossip=false falls back to the
    # reference's fixed two-speed timer, bit for bit. selfevent_burst
    # caps the extra self-events coalesced per tick while the mempool
    # still holds a full event's worth of transactions (0 = reference's
    # one-event-per-tick shape).
    adaptive_gossip: bool = True
    # Fan-out ceiling: 2 measured best on both the in-process 4-node
    # cluster (one GIL: 3 partners/tick thrashes the scheduler) and
    # within noise of 3 on the 8-node multi-process A/B; raise it on
    # hosts with real per-node parallelism.
    gossip_max_fanout: int = 2
    selfevent_burst: int = 4

    # Resilience knobs (docs/robustness.md): total budget for the
    # catching-up node's fast-forward poll loop (each pass polls every
    # peer; transient failures retry with exponential backoff until the
    # deadline), and the cap on the joining node's retry backoff.
    fast_forward_deadline: float = 5.0
    join_backoff_cap: float = 2.0

    # Signal/relay mode (the reference's WebRTC+WAMP analogue,
    # config/config.go:163-187): nodes keep one outbound connection to a
    # rendezvous server and are addressed by public key, so NAT-ed nodes
    # can participate without accepting inbound connections.
    signal: bool = False
    signal_addr: str = "127.0.0.1:2443"
    # Direct-connection upgrade listen address for signal mode (e.g.
    # "0.0.0.0:0"); empty = gossip stays relayed (pre-upgrade behavior).
    signal_direct: str = ""
    # Pinned relay TLS certificate (PEM). Defaults to datadir/cert.pem when
    # present (the reference's cert convention, config/config.go:19-32);
    # empty = plaintext relay link.
    signal_ca: str = ""

    # Mempool (docs/mempool.md): the bounded dedup transaction pool
    # between app submission and self-event creation. Caps are admission
    # bounds in count and bytes; the overflow policy is "reject" (client
    # sees `full`) or "evict-oldest" (oldest pending tx shed, client
    # accepted); event caps bound each self-event so gossip payloads stay
    # small under load; the committed LRU turns retries of committed
    # transactions into `already_committed`; rate>0 arms a token-bucket
    # limiter (`throttled` under sustained overload; burst 0 = 1 s worth).
    mempool_max_txs: int = 20000
    mempool_max_bytes: int = 33554432  # 32 MiB
    mempool_overflow: str = "reject"  # or "evict-oldest"
    mempool_event_max_txs: int = 1024
    mempool_event_max_bytes: int = 1048576  # 1 MiB per self-event
    mempool_committed_lru: int = 65536
    mempool_rate: float = 0.0  # tx/s; 0 disables the limiter
    mempool_burst: float = 0.0  # 0 = one second's worth of tokens
    # Submit-queue drain batch per background pass: bounded so a flood of
    # submissions can't starve transport RPC handling in the same loop.
    submit_batch: int = 256

    # Sentry (docs/robustness.md §Byzantine fault model): classified
    # ingest rejections add per-cause weights to the sender's misbehavior
    # score; crossing `threshold` triggers a `quarantine_s` time-box
    # (selector skips the peer, inbound syncs refused), after which the
    # peer is re-admitted with a clean score. Scores decay with half-life
    # `decay_halflife_s`, so only sustained abuse accumulates.
    sentry_threshold: float = DEFAULT_SENTRY_THRESHOLD
    sentry_quarantine_s: float = DEFAULT_SENTRY_QUARANTINE_S
    sentry_decay_halflife_s: float = DEFAULT_SENTRY_DECAY_HALFLIFE_S

    # Causal tracing + stall flight recorder (docs/observability.md
    # §Causal tracing): trace_sample is the deterministic per-transaction
    # sampling rate for the commit-provenance table (every node traces
    # the SAME transactions; 1.0 = trace everything, 0 = off; env
    # BABBLE_TRACE_SAMPLE overrides for a whole cluster at once);
    # trace_table_cap bounds records per node. watchdog_stall_s is the
    # no-progress-while-busy threshold that trips the flight recorder
    # (0 disables); artifacts land in flight_dir (default:
    # <tmpdir>/babble_tpu_flight). BABBLE_OBS=0 disables all of it.
    trace_sample: float = DEFAULT_TRACE_SAMPLE
    trace_table_cap: int = DEFAULT_TRACE_TABLE_CAP
    watchdog_stall_s: float = DEFAULT_WATCHDOG_STALL_S
    watchdog_interval_s: float = DEFAULT_WATCHDOG_INTERVAL_S
    flight_dir: str = ""
    # Sampling-profiler rate (obs/profile.py; docs/observability.md
    # §Sampling profiler). One process-wide sampler serves co-located
    # nodes; 0 disables, env BABBLE_PROFILE_HZ overrides cluster-wide.
    profile_hz: float = DEFAULT_PROFILE_HZ

    # Light-client gateway tier (docs/clients.md): client_listen binds
    # the SubscriptionHub (streaming commit subscriptions over one
    # selector loop; empty = off). Per-subscriber frame queues are
    # bounded (sub_queue_frames); a subscriber that stalls with queued
    # data for sub_stall_timeout_s, or whose delivery deficit grows past
    # sub_shed_lag blocks, is shed. txindex_cap bounds the txid→block
    # proof index behind GET /proof/<txid>.
    client_listen: str = ""
    sub_queue_frames: int = 256
    sub_stall_timeout_s: float = 10.0
    sub_shed_lag: int = 1024
    # kernel send-buffer cap per subscriber socket (0 = OS default);
    # small values make slow-consumer shedding prompt and deterministic
    sub_sndbuf: int = 0
    # proof-index bound: ~64-byte hex key + coords per entry; 256k
    # entries ≈ tens of MB. Indexing runs only when the node has a read
    # surface (service or client_listen).
    txindex_cap: int = 1 << 18

    # Lifecycle tier (docs/lifecycle.md): checkpoint-prune compaction.
    # Every prune_every_rounds of anchor advance, the node seals its
    # anchor checkpoint and compacts events/rounds/frames below
    # (anchor - prune_keep_rounds) out of the store; prune_vacuum hands
    # the freed SQLite pages back to the OS after each prune. 0 keeps
    # the store append-only (the reference's behavior).
    prune_every_rounds: int = DEFAULT_PRUNE_EVERY_ROUNDS
    prune_keep_rounds: int = DEFAULT_PRUNE_KEEP_ROUNDS
    prune_vacuum: bool = DEFAULT_PRUNE_VACUUM

    enable_fast_sync: bool = False
    store: bool = False  # persistent store (SQLite-backed) vs in-memory
    database_dir: str = ""
    bootstrap: bool = False
    maintenance_mode: bool = False
    moniker: str = ""

    # Time source (common/clock.py): every node-side deadline, sleep,
    # duration measurement, and event timestamp reads through this
    # object. None -> the process wall clock. The deterministic
    # simulation engine (babble_tpu_torch.sim, docs/simulation.md) injects a
    # SimClock here so whole fault scenarios run in virtual time.
    # lint: allow(knobs: runtime injection point, not an operator knob)
    clock: object = None
    # Seed for the node's internal RNG streams (peer-selector pick
    # weighting). None -> OS entropy (production). The sim harness sets
    # it so gossip partner choice is a pure function of the master seed.
    # lint: allow(knobs: runtime injection point, not an operator knob)
    sim_seed: object = None

    # Device offload: fame and round-received come off the device in
    # batched sweeps (hashgraph/accel.py) running the kernels in
    # babble_tpu_torch.ops.
    accelerator: bool = False
    # Multi-device sweeps are not ported yet: Node.init refuses > 1.
    accelerator_mesh: int = 0
    # The torch device of the offload: the CUDA card by default (no card
    # is an error at start-up, never a CPU run); tests pass "cpu".
    accelerator_device: str = "cuda"

    def __post_init__(self) -> None:
        if self.clock is None:
            from ..common.clock import WALL

            self.clock = WALL
        # Cluster-wide sampling override without touching every node's
        # flags/toml — sampling must agree across nodes for hop merges.
        env_sample = os.environ.get("BABBLE_TRACE_SAMPLE")
        if env_sample:
            try:
                self.trace_sample = float(env_sample)
            except ValueError:
                pass
        # Adaptive-scheduler kill switch: one env var flips a whole
        # cluster back to the fixed two-speed timer (A/B benches, and
        # the operator escape hatch if the control law misbehaves).
        env_adapt = os.environ.get("BABBLE_ADAPT")
        if env_adapt:
            self.adaptive_gossip = env_adapt.lower() not in (
                "0", "false", "off", "no",
            )
        if self.gossip_max_fanout < 1:
            raise ValueError(
                f"gossip_max_fanout must be >= 1, got {self.gossip_max_fanout}"
            )
        if not self.database_dir:
            self.database_dir = os.path.join(self.data_dir, DEFAULT_BADGER_DIR)
        # Option forcing (reference: babble/babble.go:133-143):
        # maintenance-mode implies bootstrap, bootstrap implies store.
        if self.maintenance_mode:
            self.bootstrap = True
        if self.bootstrap:
            self.store = True
        if self.transport not in ("tcp", "async"):
            raise ValueError(
                f"transport must be 'tcp' or 'async', got {self.transport!r}"
            )
        if self.mempool_overflow not in ("reject", "evict-oldest"):
            raise ValueError(
                f"mempool_overflow must be 'reject' or 'evict-oldest', "
                f"got {self.mempool_overflow!r}"
            )
        if self.prune_every_rounds < 0 or self.prune_keep_rounds < 0:
            raise ValueError(
                "prune_every_rounds and prune_keep_rounds must be >= 0"
            )

    def seeded_rng(self, stream: str, ident) -> object:
        """Per-actor, per-stream ``random.Random`` derived from the master
        sim seed, or None in production (``sim_seed`` unset) — call sites
        fall back to the process-global random module. The seed string
        ``"{sim_seed}|{stream}|{ident}"`` is a determinism contract: every
        actor (honest node.py, adversary byzantine.py) must derive a given
        stream through THIS helper so same-seed replays stay reproducible."""
        if self.sim_seed is None:
            return None
        import random

        return random.Random(f"{self.sim_seed}|{stream}|{ident}")

    def keyfile_path(self) -> str:
        return os.path.join(self.data_dir, DEFAULT_KEYFILE)

    def peers_path(self) -> str:
        return os.path.join(self.data_dir, DEFAULT_PEERS_FILE)

    def genesis_peers_path(self) -> str:
        return os.path.join(self.data_dir, DEFAULT_GENESIS_PEERS_FILE)

    def logger(self, name: str = "babble_tpu_torch") -> logging.Logger:
        """Per-component logger. Handlers/formatting are centralized in
        obs/log.py (``obs.log.configure_from(conf)`` — the CLI entry
        points call it); this only scopes the name and level."""
        if not name.startswith("babble_tpu_torch"):
            # scope every component under the framework root so the one
            # obs/log handler (and level) covers them all
            name = f"babble_tpu_torch.{name}"
        logger = logging.getLogger(f"{name}.{self.moniker or 'node'}")
        logger.setLevel(getattr(logging, self.log_level.upper(), logging.INFO))
        return logger
