"""Lifecycle tier (docs/lifecycle.md): checkpoint-prune compaction and
elastic validator membership.

``pruner``   — CheckpointPruner: seals the anchor checkpoint, then
               compacts events/rounds/frames below the retention floor
               out of the hashgraph store (Hashgraph.prune_below).
``rotation`` — RotationController: the leave → join → fast-sync →
               BABBLING churn state machine, plus the AutoscalePolicy
               mapping mempool pressure to grow/shrink decisions.
"""

from babble_tpu_torch.lifecycle.pruner import BehindRetentionError, CheckpointPruner
from babble_tpu_torch.lifecycle.rotation import AutoscalePolicy, RotationController

__all__ = [
    "AutoscalePolicy",
    "BehindRetentionError",
    "CheckpointPruner",
    "RotationController",
]
