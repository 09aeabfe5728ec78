"""CheckpointPruner — self-compaction of a validator's store
(docs/lifecycle.md §Checkpoint-prune).

Anchor selection: the hashgraph's anchor block — the latest block
carrying MORE than 1/3 validator signatures, the same artifact the
/checkpoint endpoint serves — minus a ``keep_rounds`` straggler margin.
The pruner seals that checkpoint (client/checkpoint.py export, so a
prune can never outrun what the node can still serve), then drops
events, rounds and frames below the floor from both the cache and the
durable store (Hashgraph.prune_below), and finally hands freed SQLite
pages back to the OS.

The driver is deliberately passive: ``due()`` is a cheap lock-free
check the node runs from its gossip/monologue tails, and ``prune()``
does the work under the caller's core lock. Compaction never runs from
the commit listener — mutating the store mid process_decided_rounds is
how you corrupt the very frames you are trying to seal.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from babble_tpu_torch.common.errors import StoreError
from babble_tpu_torch.config.config import (
    DEFAULT_PRUNE_KEEP_ROUNDS,
    DEFAULT_PRUNE_VACUUM,
)

logger = logging.getLogger("babble_tpu_torch.lifecycle")


class BehindRetentionError(Exception):
    """A client asked for history below the prune floor. Distinct from a
    generic miss so /checkpoint can answer with the ``behind_retention``
    slug + the floor, and the client can ratchet forward instead of
    retrying a request this node can never serve again."""

    def __init__(self, requested: int, floor: int):
        super().__init__(
            f"round {requested} is below the prune floor {floor}"
        )
        self.requested = requested
        self.floor = floor


class CheckpointPruner:
    """Policy + driver for periodic checkpoint-prune compaction."""

    def __init__(
        self,
        every_rounds: int,
        keep_rounds: int = DEFAULT_PRUNE_KEEP_ROUNDS,
        vacuum: bool = DEFAULT_PRUNE_VACUUM,
    ):
        self.every_rounds = max(1, int(every_rounds))
        self.keep_rounds = max(0, int(keep_rounds))
        self.vacuum = vacuum
        # Cumulative counters behind the lifecycle_* instruments.
        self.prunes = 0
        self.events_pruned = 0
        self.rounds_pruned = 0
        self.last_floor = -1
        # The checkpoint sealed by the latest prune — the artifact a
        # rotated-out validator fast-syncs back in from.
        self.last_checkpoint: Optional[dict] = None

    # -- policy --------------------------------------------------------------

    def target_floor(self, core) -> Optional[int]:
        """The floor the next prune would compact below, or None while
        nothing is due. Reads only monotonic consensus state, so a
        lock-free pre-check is safe — prune() re-evaluates under the
        lock."""
        hg = core.hg
        if hg.anchor_block is None or hg.last_consensus_round is None:
            return None
        try:
            block = hg.store.get_block(hg.anchor_block)
        except StoreError:
            return None
        floor = (
            min(block.round_received(), hg.last_consensus_round)
            - self.keep_rounds
        )
        if floor <= 0:
            return None
        prev = hg.prune_floor if hg.prune_floor is not None else 0
        if floor - prev < self.every_rounds:
            return None
        return floor

    def due(self, core) -> bool:
        return self.target_floor(core) is not None

    # -- driver --------------------------------------------------------------

    def prune(self, core) -> Optional[Dict[str, int]]:
        """Seal the anchor checkpoint, compact below the floor, vacuum.
        Caller holds the core lock. Returns the prune stats, or None when
        nothing was due after all."""
        floor = self.target_floor(core)
        if floor is None:
            return None
        if core.hg._round_pending:
            # Never compact under a half-assigned ingest batch: a pending
            # event's parents must stay resolvable until divide_rounds
            # stamps its round/lamport.
            return None
        from babble_tpu_torch.client.checkpoint import export_checkpoint

        try:
            self.last_checkpoint = export_checkpoint(core)
        except ValueError:
            return None  # no sealed anchor yet (cluster's first seconds)

        stats = core.hg.prune_below(floor)

        if self.vacuum:
            vac = getattr(core.hg.store, "vacuum", None)
            if vac is not None:
                vac()

        self.prunes += 1
        self.events_pruned += stats["events_pruned"]
        self.rounds_pruned += stats["rounds_pruned"]
        self.last_floor = stats["floor"]
        logger.info(
            "checkpoint-prune: floor=%d events=%d rounds=%d",
            stats["floor"], stats["events_pruned"], stats["rounds_pruned"],
        )
        return stats
