"""The batched consensus pipeline, on one device and over a device mesh.

``batched_pipeline`` is the JAX package's ``jax.vmap`` of the single-window
sweep (``babble_tpu/parallel/pipeline.py``) with the batch dimension
written out: every stage of ``ops/dag.py`` already works on a leading
window axis, and K2 takes the whole batch in one launch.
``sharded_batched_pipeline`` runs it over a (dp, sp) mesh.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.dag import batched_core, synthetic_snapshot
from ..ops.device import DeviceLike, resolve_device
from ..ops.kernels import strongly_see_block
from .mesh import Mesh, all_gather, shard_batched_snapshot


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


def sharded_batched_pipeline(mesh: Mesh, sm: int,
                             round_bound: int) -> Callable:
    """The batched pipeline over a (dp, sp) mesh: a function of the same
    [B, ...] arrays as ``batched_pipeline``'s, B divisible by dp and E by
    sp, returning the same (see, ss, packed) on the mesh's first device.

    The arrays are placed as ``shard_batched_snapshot`` places them: the
    batch over ``dp``, the event axis over ``sp``. Within dp group i, the
    strongly-see matrix (the pipeline's [B, E, E] compare) is split by rows
    over the sp shards: each compares its own la rows with the group's fd
    rows, gathered to it, by one launch of K2's block form, and the row
    blocks are gathered on the group's first device. That device gathers
    the group's other arrays and runs the rest of the pipeline (the
    fixpoint stages, fame and round-received) whole, through
    ``ops.dag.batched_core``'s strongly-see hook.

    The JAX package jits the vmapped pipeline with these shardings and
    lets GSPMD partition every stage and insert the collectives. The
    placement of the work differs; the outputs do not: they equal
    ``batched_pipeline``'s bit for bit (tests/test_torch_parallel.py)."""
    dp, sp = mesh.shape

    def run(creator, index, sp_idx, op, la, fd, mid):
        placed = shard_batched_snapshot(
            mesh, (creator, index, sp_idx, op, la, fd, mid))
        outs = []
        for i in range(dp):
            group = list(mesh.devices[i])
            head = group[0]
            la_rows, fd_rows = placed[4][i], placed[5][i]
            fd_full = all_gather(fd_rows, group, axis=1)

            def split_ss(_la, _fd, threshold):
                blocks = [strongly_see_block(a, f, threshold)
                          for a, f in zip(la_rows, fd_full)]
                return torch.cat([b.to(head) for b in blocks], dim=1)

            whole = [torch.cat([b.to(head) for b in blocks], dim=1)
                     for blocks in (p[i] for p in placed)]
            outs.append(batched_core(*whole, sm, round_bound,
                                     ss_fn=split_ss))
        first = mesh.flat()[0]
        return tuple(torch.cat([o[q].to(first) for o in outs])
                     for q in range(3))

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
