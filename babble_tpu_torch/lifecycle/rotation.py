"""RotationController + AutoscalePolicy — elastic validator membership
(docs/lifecycle.md §Rotation, §Autoscale).

Rotation is the leave → join → fast-sync-from-checkpoint → BABBLING
churn loop. The peer-survival guarantees it leans on already live
elsewhere: Core.set_peers threads the prior selector through a
membership change (peer health/backoff survive), and Sentry.attach_store
reloads the evidence ledger, so a rotation never amnesties an
equivocator or a flaky peer. This module adds the state machine that
sequences the churn and the pure pressure→decision policy that drives
it.

Clock discipline (docs/static_analysis.md): no module-level time reads —
timestamps come from an injected monotonic callable (conf.clock), and
AutoscalePolicy.decide takes ``now`` as an argument.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

# Rotation states. MEMBER is both the start and the goal: a full
# rotation is MEMBER → LEAVING → OUT → JOINING → SYNCING → MEMBER.
MEMBER = "member"
LEAVING = "leaving"
OUT = "out"
JOINING = "joining"
SYNCING = "syncing"

_TRANSITIONS = {
    MEMBER: (LEAVING,),
    LEAVING: (OUT,),
    OUT: (JOINING,),
    JOINING: (SYNCING, OUT),  # OUT = join/fast-sync failed, retry later
    SYNCING: (MEMBER, OUT),
}


class RotationController:
    """Sequences one validator's churn and records each hop's timestamp
    (the rotation-latency evidence the lifecycle tests assert on)."""

    def __init__(
        self,
        moniker: str = "",
        clock: Optional[Callable[[], float]] = None,
        initial: str = MEMBER,
    ):
        if initial not in _TRANSITIONS:
            raise ValueError(f"unknown rotation state {initial!r}")
        self.moniker = moniker
        self._now = clock  # monotonic-seconds callable (conf.clock.monotonic)
        self.state = initial  # OUT for a fresh joiner, MEMBER for a sitting validator
        self.transitions: List[Tuple[str, float]] = []
        self.rotations = 0

    def _stamp(self) -> float:
        return self._now() if self._now is not None else -1.0

    def to(self, state: str) -> None:
        if state not in _TRANSITIONS.get(self.state, ()):
            raise ValueError(
                f"illegal rotation transition {self.state} -> {state}"
            )
        self.state = state
        self.transitions.append((state, self._stamp()))
        if state == MEMBER:
            self.rotations += 1

    # -- drivers -------------------------------------------------------------

    def rotate_out(self, node) -> None:
        """Politely leave: PEER_REMOVE itx through consensus, then node
        shutdown (node.leave blocks until the removal round commits)."""
        self.to(LEAVING)
        node.leave()
        self.to(OUT)

    def rejoin_from_checkpoint(self, core, checkpoint: dict,
                               proxy=None) -> None:
        """Fast-sync a core straight from a sealed checkpoint dict — a
        pruned peer's ``/checkpoint?snapshot=1`` artifact (or a pruner's
        ``last_checkpoint``). Synchronous: the sim harness and tests
        drive this directly; a live node's JOINING state reaches the
        same core.fast_forward through its _fast_forward RPC leg.
        core.fast_forward re-verifies the block signatures and the
        frame hash, so a corrupt checkpoint fails loudly here.

        ``proxy`` is the rejoiner's app proxy: when the checkpoint
        carries a ``snapshot`` the app state is restored BEFORE the
        hashgraph reset (reference node.go:622-666 order), else the
        rejoiner would chain its state hash from whatever prefix it
        committed pre-crash and fork at the app layer — peers refuse to
        countersign its blocks."""
        from babble_tpu_torch.hashgraph.block import Block
        from babble_tpu_torch.hashgraph.frame import Frame

        self.to(JOINING)
        try:
            block = Block.from_dict(checkpoint["block"])
            frame = Frame.from_dict(checkpoint["frame"])
            if proxy is not None and "snapshot" in checkpoint:
                proxy.restore(bytes.fromhex(checkpoint["snapshot"]))
            core.fast_forward(block, frame)
        except Exception:
            self.to(OUT)
            raise
        self.to(SYNCING)

    def on_babbling(self) -> None:
        """The rejoined validator committed its first post-sync block —
        rotation complete."""
        self.to(MEMBER)


class AutoscalePolicy:
    """Pure mempool-pressure → grow/shrink/hold decision with hysteresis
    and a cooldown, so churn never flaps on a noisy load signal. All
    inputs are arguments — no clocks or globals read — which is what
    makes the policy unit-testable and sim-replayable."""

    GROW = "grow"
    SHRINK = "shrink"
    HOLD = "hold"

    def __init__(
        self,
        grow_above: float = 0.75,
        shrink_below: float = 0.10,
        min_validators: int = 3,
        max_validators: int = 16,
        cooldown_s: float = 30.0,
    ):
        if not shrink_below < grow_above:
            raise ValueError("shrink_below must be < grow_above")
        self.grow_above = grow_above
        self.shrink_below = shrink_below
        self.min_validators = min_validators
        self.max_validators = max_validators
        self.cooldown_s = cooldown_s
        self._last_scale_t: Optional[float] = None
        self.grows = 0
        self.shrinks = 0

    def decide(
        self,
        pending_txs: int,
        capacity: int,
        n_validators: int,
        now: float = 0.0,
    ) -> str:
        pressure = (pending_txs / capacity) if capacity > 0 else 0.0
        if (
            self._last_scale_t is not None
            and now - self._last_scale_t < self.cooldown_s
        ):
            return self.HOLD
        if pressure >= self.grow_above and n_validators < self.max_validators:
            self._last_scale_t = now
            self.grows += 1
            return self.GROW
        if pressure <= self.shrink_below and n_validators > self.min_validators:
            self._last_scale_t = now
            self.shrinks += 1
            return self.SHRINK
        return self.HOLD

    def decide_for_node(self, node) -> str:
        """Convenience hook: read the node's live mempool pressure signal
        and validator count, stamped off its own clock."""
        mp = node.core.mempool
        return self.decide(
            pending_txs=mp.pending_count,
            capacity=mp.max_txs,
            n_validators=len(node.core.peers.peers),
            now=node.clock.monotonic(),
        )
