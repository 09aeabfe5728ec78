"""Consensus kernels with their exchanges between shards spelled out.

The PyTorch counterpart of the JAX package's
``babble_tpu/parallel/collectives.py``, whose ``shard_map`` kernels put
event rows on different chips and reduce across them with
``all_gather``/``psum``/``ppermute``. Here one process holds the shards'
blocks on their devices (``parallel/mesh.py``) and moves them itself; each
shard's strongly-see compare is K2's block form
(``ops/kernels.strongly_see_block``), launched on that shard's device.

Each function returns a callable; each callable takes whole arrays (numpy
arrays or tensors), splits them over the mesh as the JAX in_specs do, and
returns the result gathered onto the mesh's first device, as reading a
JAX sharded array gathers it.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..ops.kernels import strongly_see_block
from .mesh import Mesh, all_gather, psum, ppermute, split_rows


def _int32(a, name: str) -> torch.Tensor:
    t = torch.as_tensor(a)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    return t


def sharded_strongly_see(mesh: Mesh, super_majority: int) -> Callable:
    """stronglySee with the x rows split over the whole mesh: each shard
    compares its own la rows with every fd row (fd gathered to every
    shard), by one launch of K2's block form. Returns a function
    (la [E, P], fd [E, P]) -> ss [E, E] bool, E divisible by the mesh
    size."""
    devices = mesh.flat()
    sm = int(super_majority)

    def run(la, fd) -> torch.Tensor:
        la_loc = split_rows(_int32(la, "la"), devices)
        fd_full = all_gather(split_rows(_int32(fd, "fd"), devices), devices)
        rows = [strongly_see_block(a, f, sm)
                for a, f in zip(la_loc, fd_full)]
        return torch.cat([r.to(devices[0]) for r in rows])

    return run


def ring_strongly_see(mesh: Mesh, super_majority: int) -> Callable:
    """stronglySee with both coordinate arrays split and nothing gathered:
    the fd blocks pass around the ring of shards (``ppermute``, n - 1
    steps) while each shard fills the column block of the fd block it holds
    in its own [E/n, E] rows, in place, with one launch of K2's block form
    a step: at step s shard ``me`` holds the block that started on shard
    (me - s) mod n. Each shard's live memory is O(E·P/n) coordinates
    instead of the gather's O(E·P). Takes a 1-D mesh (``ring_mesh``).
    Returns a function (la [E, P], fd [E, P]) -> ss [E, E] bool, equal to
    ``sharded_strongly_see``'s."""
    devices = mesh.flat()
    n = len(devices)
    sm = int(super_majority)

    def run(la, fd) -> torch.Tensor:
        la_loc = split_rows(_int32(la, "la"), devices)
        held = split_rows(_int32(fd, "fd"), devices)
        e_loc = la_loc[0].shape[0]
        outs = [torch.empty((e_loc, e_loc * n), dtype=torch.bool, device=d)
                for d in devices]
        for s in range(n):
            if s:
                held = ppermute(held, devices)
            for me in range(n):
                src = (me - s) % n
                strongly_see_block(la_loc[me], held[me], sm, outs[me],
                                   src * e_loc)
        return torch.cat([o.to(devices[0]) for o in outs])

    return run


def sharded_vote_counts(mesh: Mesh) -> Callable:
    """The super-majority vote tally with the voter rows split over the
    mesh: votes [W, W'] bool (voter w says yay about candidate w'),
    eligible [W] bool. Each shard sums its own rows of ``votes &
    eligible`` per column; the parts are summed across shards (``psum``:
    the DecideFame tally, oracle hashgraph.go:930-960). Returns a function
    (votes, eligible) -> int32 [W']."""
    devices = mesh.flat()

    def run(votes, eligible) -> torch.Tensor:
        v_loc = split_rows(torch.as_tensor(votes), devices)
        e_loc = split_rows(torch.as_tensor(eligible), devices)
        local: List[torch.Tensor] = [
            (v & e[:, None]).sum(dim=0, dtype=torch.int32)
            for v, e in zip(v_loc, e_loc)
        ]
        return psum(local, devices)[0]

    return run
