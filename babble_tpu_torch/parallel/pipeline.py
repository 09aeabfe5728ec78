"""The batched consensus pipeline.

``batched_pipeline`` is the JAX package's ``jax.vmap`` of the single-window
sweep (``babble_tpu/parallel/pipeline.py``) with the batch dimension
written out: every stage of ``ops/dag.py`` already works on a leading
window axis, and K2 takes the whole batch in one launch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.dag import batched_core, synthetic_snapshot
from ..ops.device import DeviceLike, resolve_device


def batched_pipeline(sm: int, round_bound: int,
                     device: DeviceLike = None) -> Callable:
    """A function over [B, ...] snapshot arrays (numpy arrays or tensors,
    in ``batch_of_snapshots`` order) that runs the pipeline on ``device``
    (the card unless said otherwise) and returns the device tensors
    (see [B, E, E], ss [B, E, E], packed [B, 5, E])."""
    dev = resolve_device(device)

    def run(creator, index, sp, op, la, fd, mid):
        args = (torch.as_tensor(a, device=dev)
                for a in (creator, index, sp, op, la, fd, mid))
        return batched_core(*args, sm, round_bound)

    return run


def batch_of_snapshots(n_windows: int, n_peers: int, n_events: int):
    """Stack synthetic windows into [B, ...] arrays for benchmarks and the
    batched run. Returns (arrays, super_majority)."""
    snaps = [
        synthetic_snapshot(n_peers, n_events, seed=11 + i)
        for i in range(n_windows)
    ]
    arrays = (
        np.stack([s.creator for s in snaps]),
        np.stack([s.index for s in snaps]),
        np.stack([s.self_parent for s in snaps]),
        np.stack([s.other_parent for s in snaps]),
        np.stack([s.last_ancestors for s in snaps]),
        np.stack([s.first_descendants for s in snaps]),
        np.stack([s.middle_bit for s in snaps]),
    )
    return arrays, snaps[0].super_majority
