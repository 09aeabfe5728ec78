"""Adaptive gossip scheduler: the control law behind the gossip cadence.

The reference protocol gossips on a fixed two-speed heartbeat (10 ms
busy / 1 s idle, ``control_timer.py``) with exactly ONE partner per
tick. That law is blind to every live signal the node already computes:
how hot the mempool is, how far peers trail us (or we trail them), and
how congested our own ingest pipeline is. The result is the
commit-latency wall ROADMAP item 1 names — under load the node keeps
metronome time while its mempool and its peers' lag say "go faster,
talk to more people", and under ingest overload it keeps soliciting
syncs it cannot insert.

This module is that missing controller. It is deliberately a PURE
control law: no threads, no clocks, no RNG — ``update(signals)`` maps
one signal snapshot to one :class:`GossipPlan` and mutates only the
controller's own smoothing state. That purity is what lets the
deterministic simulation engine (docs/simulation.md) run the SAME
controller under virtual time with byte-identical replays.

Control law (docs/gossip.md §Adaptive scheduling):

- **tempo** (how often to gossip) rises with mempool pressure, with our
  own lag behind peers, and with unfinished consensus work (``busy``);
  the interval lerps from ``slow_s`` (tempo 0) to ``fast_s`` (tempo 1).
- **spread** (how many partners per tick) rises with mempool pressure
  and with how far peers trail US — fan-out only helps when we hold
  events others need.
- **congestion** (our own decode→verify→insert pipeline occupancy)
  brakes both: a node that cannot insert what it already has must stop
  soliciting more, so congestion multiplies the interval back up and
  collapses fan-out toward 1. It also shrinks the pipeline's soft
  depth cap so backpressure reaches senders earlier.
- every raw signal is EWMA-smoothed (``alpha``) and the published
  interval/fan-out only move when the target crosses a **hysteresis**
  band, so the scheduler doesn't flap on tick-to-tick noise.
- outputs are hard-clamped: interval to [fast_s, slow_s], fan-out to
  [1, max_fanout], soft depth to [4, queue_cap].

Kill switch: ``BABBLE_ADAPT=0`` (or ``adaptive_gossip=false``) makes
``Node`` skip constructing the controller entirely and fall back to the
fixed two-speed timer, one partner per tick — the reference's scheduler,
bit for bit. The switch isolates the SCHEDULER only (that is what the
A/B benches compare): coalesced self-event minting and the staged pull
leg keep their own switches (``selfevent_burst=0``,
``gossip_pipeline=false``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GossipSignals:
    """One snapshot of the live load signals, taken by the node."""

    busy: bool = False          # Core.busy(): unfinished consensus work
    mempool_pending: int = 0    # admitted-not-drained transactions
    inflight: int = 0           # gossip_inflight_syncs (pipeline gauge)
    queue_depth: int = 0        # gossip_pipeline_queue_depth
    peer_behind: int = 0        # max events any peer trails US by
    self_behind: int = 0        # max events WE trail any peer by
    rounds_inflight: int = 0    # OUR gossip rounds still running
    rounds_cap: int = 1         # the node's gossip-slot budget


@dataclass(frozen=True)
class GossipPlan:
    """The controller's verdict for the next tick."""

    interval: float   # seconds until the next gossip tick
    fanout: int       # distinct partners to gossip this tick
    soft_depth: int   # pipeline soft queue cap (backpressure threshold)
    tempo: float      # smoothed demand-for-frequency in [0, 1]
    congestion: float  # smoothed ingest congestion in [0, 1]


class AdaptiveGossipController:
    """Signal → (interval, fan-out, pipeline depth) control law."""

    def __init__(
        self,
        fast_s: float,
        slow_s: float,
        max_fanout: int = 3,
        queue_cap: int = 64,
        inflight_cap: int = 8,
        mempool_hot: int = 1024,
        lag_hot: int = 256,
        alpha: float = 0.4,
        hysteresis: float = 0.15,
        congestion_brake: float = 4.0,
    ):
        if fast_s <= 0 or slow_s < fast_s:
            raise ValueError(
                f"need 0 < fast_s <= slow_s, got {fast_s}/{slow_s}"
            )
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.max_fanout = max(1, int(max_fanout))
        self.queue_cap = max(4, int(queue_cap))
        self.inflight_cap = max(1, int(inflight_cap))
        self.mempool_hot = max(1, int(mempool_hot))
        self.lag_hot = max(1, int(lag_hot))
        self.alpha = min(1.0, max(0.01, alpha))
        self.hysteresis = max(0.0, hysteresis)
        self.congestion_brake = max(0.0, congestion_brake)
        # smoothing state
        self._tempo = 0.0
        self._spread = 0.0
        self._congestion = 0.0
        # published outputs (hysteresis compares targets against these)
        self._interval = slow_s
        self._fanout = 1
        self._soft_depth = self.queue_cap
        # counters (obs catalog: adaptive_*)
        self.ticks = 0
        self.adjustments = 0

    @classmethod
    def from_config(cls, conf) -> "AdaptiveGossipController":
        """Tune the law from the node Config: the fixed timer's two
        speeds become the clamp rails, a full self-event's worth of
        pending transactions is 'hot', and a quarter sync_limit of lag
        is 'far behind' (one pull can heal up to sync_limit)."""
        return cls(
            fast_s=conf.heartbeat_timeout,
            slow_s=max(conf.heartbeat_timeout, conf.slow_heartbeat_timeout),
            max_fanout=conf.gossip_max_fanout,
            queue_cap=conf.gossip_pipeline_depth,
            mempool_hot=conf.mempool_event_max_txs,
            lag_hot=max(64, conf.sync_limit // 4),
        )

    # -- the law --------------------------------------------------------

    def update(self, sig: GossipSignals) -> GossipPlan:
        """Fold one signal snapshot into the smoothed state and return
        the plan for the next tick. Deterministic: same controller
        state + same signals → same plan, always."""
        self.ticks += 1
        mem_p = min(1.0, sig.mempool_pending / self.mempool_hot)
        self_p = min(1.0, sig.self_behind / self.lag_hot)
        peer_p = min(1.0, sig.peer_behind / self.lag_hot)
        tempo_raw = max(1.0 if sig.busy else 0.0, mem_p, self_p)
        spread_raw = max(mem_p, peer_p)
        congestion_raw = max(
            min(1.0, sig.queue_depth / self.queue_cap),
            min(1.0, sig.inflight / self.inflight_cap),
            # our own rounds overrunning the cadence: on a CPU-starved
            # host the ingest queue can look empty while every gossip
            # slot is still occupied at the next tick — fanning out
            # there just thrashes the scheduler. ONE carryover round is
            # exempt: a single round-trip outlasting the tick is the
            # normal pipelined state whenever the network RTT exceeds
            # the heartbeat, not a congestion signal.
            min(
                1.0,
                max(0, sig.rounds_inflight - 1)
                / max(1, sig.rounds_cap - 1),
            ),
        )
        # Demand signals attack fast, decay smoothly: an idle node's
        # first transaction must arm the fast cadence THIS tick, not
        # after the EWMA crawls up through seconds of slow-rail
        # intervals — while a single quiet tick doesn't drop the tempo.
        # Congestion stays symmetric-smooth in BOTH directions: queue
        # depth spikes on every burst, and an instant-rise/slow-decay
        # brake rides those spikes into a near-permanent slowdown
        # (measured: ~3x worse smoke commit p50 than the smooth brake).
        a = self.alpha
        self._tempo = max(
            tempo_raw, self._tempo + a * (tempo_raw - self._tempo)
        )
        self._spread = max(
            spread_raw, self._spread + a * (spread_raw - self._spread)
        )
        self._congestion += a * (congestion_raw - self._congestion)

        # interval: lerp slow→fast on tempo, braked back up by congestion
        target = self.slow_s - (self.slow_s - self.fast_s) * self._tempo
        target *= 1.0 + self.congestion_brake * self._congestion
        target = min(self.slow_s, max(self.fast_s, target))
        # absorbing rails: a target inside the hysteresis band of a rail
        # IS the rail — saturated regimes publish the exact clamp value
        # instead of parking an off-rail residue inside the band
        if target <= self.fast_s * (1.0 + self.hysteresis):
            target = self.fast_s
        elif target >= self.slow_s * (1.0 - self.hysteresis):
            target = self.slow_s
        # fan-out: spread wants more partners, congestion collapses it
        fan_exact = 1.0 + (self.max_fanout - 1) * self._spread * max(
            0.0, 1.0 - self._congestion
        )
        # soft pipeline depth: congested nodes backpressure earlier
        depth_exact = self.queue_cap * (1.0 - 0.75 * self._congestion)

        changed = False
        # hysteresis: republish the interval only when the target moved
        # by more than the band (relative), fan-out only when the exact
        # value crosses the half step plus the band. The clamp rails
        # always publish exactly — converging to "almost fast" would
        # leave a permanent off-rail residue inside the band.
        if target != self._interval and (
            abs(target - self._interval) > self.hysteresis * self._interval
            or target in (self.fast_s, self.slow_s)
        ):
            self._interval = target
            changed = True
        fan_target = int(fan_exact + 0.5)
        if fan_target != self._fanout and (
            abs(fan_exact - self._fanout) > 0.5 + self.hysteresis
        ):
            self._fanout = min(self.max_fanout, max(1, fan_target))
            changed = True
        depth_target = max(4, min(self.queue_cap, int(depth_exact + 0.5)))
        if depth_target != self._soft_depth and (
            abs(depth_target - self._soft_depth)
            > max(2, int(self.hysteresis * self.queue_cap))
            or depth_target in (4, self.queue_cap)  # absorbing rails
        ):
            self._soft_depth = depth_target
            changed = True
        if changed:
            self.adjustments += 1
        return GossipPlan(
            interval=self._interval,
            fanout=self._fanout,
            soft_depth=self._soft_depth,
            tempo=self._tempo,
            congestion=self._congestion,
        )

    # -- observability --------------------------------------------------

    def current(self) -> GossipPlan:
        """The last published plan, without folding new signals."""
        return GossipPlan(
            interval=self._interval,
            fanout=self._fanout,
            soft_depth=self._soft_depth,
            tempo=self._tempo,
            congestion=self._congestion,
        )

    def stats(self) -> dict:
        return {
            "adaptive_interval_ms": round(1e3 * self._interval, 3),
            "adaptive_fanout": self._fanout,
            "adaptive_soft_depth": self._soft_depth,
            "adaptive_ticks": self.ticks,
            "adaptive_adjustments": self.adjustments,
        }
