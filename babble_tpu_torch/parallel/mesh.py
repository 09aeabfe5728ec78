"""Device meshes and the placement of consensus tensors on them.

The PyTorch counterpart of the JAX package's ``babble_tpu/parallel/mesh.py``.
A JAX mesh is one process over N local chips; so is the port's: a
:class:`Mesh` holds a grid of ``torch.device`` entries, and the mesh code
moves each shard's block between them itself (``all_gather``, ``psum`` and
``ppermute`` below), with no ``torch.distributed``. The entries need not
differ: a mesh whose N entries all name one device ("virtual shards") runs
every exchange and every per-shard kernel launch on that device, which is
how the tests run N shards on the CPU and how one card stands in for N.

Mesh axes, as in the JAX package:

- ``dp`` (data parallel): independent DAG windows;
- ``sp`` (sequence parallel): the event dimension within one window;
- ``ring``: the 1-D mesh of the ring kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A grid of shard devices: ``devices`` is an object ndarray of
    ``torch.device`` of shape (dp, sp) or (n,), with the axis names."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    def flat(self) -> List[torch.device]:
        """The shard devices in the flattened mesh's order (row-major, as
        shard_map numbers ``("dp", "sp")`` shards)."""
        return list(self.devices.reshape(-1))

    def key(self) -> tuple:
        """A hashable identity: the shape and the shard devices."""
        return (self.shape, tuple(str(d) for d in self.flat()))

    def __repr__(self) -> str:
        return f"Mesh({'x'.join(map(str, self.shape))}, {self.flat()})"


def _pick(n_devices: Optional[int],
          devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices < 1 or n_devices > len(devices):
        raise ValueError(f"a mesh of {n_devices} devices needs that many; "
                         f"{len(devices)} available")
    return devices[:n_devices]


def consensus_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` devices: the process's
    CUDA cards, or the given ``devices`` list, which may name one device
    several times (the port's counterpart of XLA's forced host device
    count). Raises ValueError when fewer devices are there than asked for.

    ``dp`` defaults to the largest power of two <= sqrt(n) that divides n;
    the rest of the devices go to the ``sp`` axis."""
    picked = _pick(n_devices, devices)
    n = len(picked)
    if dp is None:
        dp = 1
        while dp * 2 <= int(np.sqrt(n)) and n % (dp * 2) == 0:
            dp *= 2
    if dp < 1 or n % dp != 0:
        raise ValueError(f"dp={dp} does not divide n_devices={n}")
    grid = np.empty(n, dtype=object)
    grid[:] = picked
    return Mesh(grid.reshape(dp, n // dp), ("dp", "sp"))


def ring_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh with a single ``ring`` axis, over devices picked as in
    ``consensus_mesh``: the topology of the ring kernels, where blocks pass
    from neighbour to neighbour instead of being gathered."""
    picked = _pick(n_devices, devices)
    grid = np.empty(len(picked), dtype=object)
    grid[:] = picked
    return Mesh(grid, ("ring",))


def aligned_width(W: int, n: int) -> Optional[int]:
    """The smallest W * 2^k that a mesh of ``n`` shards divides, the
    witness bucket a window pads to so that its W splits over the mesh
    (repadding keeps decisions identical). The doubling stops past W * n:
    a mesh size with an odd factor never divides a doubled power-of-two
    bucket, and then the answer is None (the window sweeps on one
    device)."""
    W_m = W
    while W_m % n:
        if W_m > W * n:
            return None
        W_m *= 2
    return W_m


def check_device_type(mesh: Mesh, device: torch.device) -> None:
    """Raise ValueError unless every shard device of ``mesh`` is of
    ``device``'s type: a mesh serves the offload of that device."""
    kinds = {d.type for d in mesh.flat()}
    if kinds != {device.type}:
        raise ValueError(f"mesh devices {sorted(kinds)} differ from the "
                         f"device {device}")


# -- the exchanges between shards ---------------------------------------------


def all_gather(blocks: Sequence[torch.Tensor],
               devices: Sequence[torch.device],
               axis: int = 0) -> List[torch.Tensor]:
    """Every shard's block copied to every shard's device and concatenated
    along ``axis`` there: ``lax.all_gather(..., tiled=True)``."""
    return [torch.cat([b.to(d) for b in blocks], dim=axis) for d in devices]


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard's part copied to every shard's device and summed there:
    ``lax.psum``."""
    out = []
    for d in devices:
        total = parts[0].to(d)
        for p in parts[1:]:
            total = total + p.to(d)
        out.append(total)
    return out


def ppermute(blocks: Sequence[torch.Tensor],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each shard's block copied to the next shard's device (shard i to
    i + 1 mod n): ``lax.ppermute`` around the ring."""
    n = len(blocks)
    return [blocks[(i - 1) % n].to(devices[i]) for i in range(n)]


def split_rows(t: torch.Tensor, devices: Sequence[torch.device],
               axis: int = 0) -> List[torch.Tensor]:
    """``t`` cut into len(devices) equal blocks along ``axis``, block k on
    device k. Raises ValueError when the axis does not divide."""
    n = len(devices)
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not divide "
                         f"over {n} shards")
    return [b.to(d).contiguous()
            for b, d in zip(torch.chunk(t, n, dim=axis), devices)]


def replicate(t: torch.Tensor,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """One copy of ``t`` on every shard's device."""
    return [t.to(d) for d in devices]


def shard_batched_snapshot(mesh: Mesh, arrays: Tuple) -> Tuple:
    """Place a batch of snapshot arrays on a (dp, sp) mesh: the batch axis
    over ``dp``, the event axis over ``sp``, the peer axis whole.
    ``arrays`` = (creator, index, sp_idx, op_idx, la, fd, mid), each with a
    leading [B, E, ...] layout (numpy arrays or tensors). Returns, per
    array, a dp x sp nested list of blocks, block [i][j] on device
    ``mesh.devices[i, j]``: the port's form of the JAX package's sharded
    arrays."""
    dp, sp = mesh.shape
    placed = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % dp or t.shape[1] % sp:
            raise ValueError(f"{tuple(t.shape)} does not split over a "
                             f"({dp}, {sp}) mesh")
        rows = torch.chunk(t, dp, dim=0)
        placed.append([
            split_rows(rows[i], list(mesh.devices[i]), axis=1)
            for i in range(dp)
        ])
    return tuple(placed)
