"""Carry state into the port from any source, as plain data.

The port imports nothing of the JAX package, so state crosses over as
dictionaries and numpy arrays: event bodies as ``EventBody.to_dict()``
with their signatures, voting windows and DAG snapshots as their arrays and
row metadata, and prepared signature batches as their limb arrays.
The differential tests feed both packages identical inputs this way.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Tuple

import numpy as np
import torch

from babble_tpu_torch.hashgraph.event import Event, EventBody
from babble_tpu_torch.ops.dag import SNAPSHOT_FIELDS, DagSnapshot
from babble_tpu_torch.ops.device import DeviceLike, resolve_device
from babble_tpu_torch.ops.verify import VerifyInputs
from babble_tpu_torch.ops.voting import WIN_FIELDS, VotingWindow

# dtype of every window array, in the order of WIN_FIELDS
_WIN_DTYPES = {
    "creator": np.int32, "index": np.int32, "la_w": np.int32,
    "fd_w": np.int32, "rounds_w": np.int32, "valid_w": np.bool_,
    "fame0_w": np.int32, "mid_w": np.bool_, "wit_idx": np.int32,
    "member": np.bool_, "sm_s": np.int32, "psi": np.int32, "sm_r": np.int32,
    "rounds": np.int32, "undet": np.bool_, "exists_r": np.bool_,
    "prior_dec_r": np.bool_, "lb_gate_r": np.bool_,
}

# dtype of every DAG snapshot array, in the order of SNAPSHOT_FIELDS
_SNAP_DTYPES = {
    "creator": np.int32, "index": np.int32, "self_parent": np.int32,
    "other_parent": np.int32, "last_ancestors": np.int32,
    "first_descendants": np.int32, "middle_bit": np.bool_,
}


def events_from_dicts(pairs: Iterable[Tuple[dict, str]]) -> List[Event]:
    """Port Events from ``(EventBody.to_dict(), signature)`` pairs."""
    return [Event(EventBody.from_dict(body), sig) for body, sig in pairs]


def window_from_arrays(fields: Mapping[str, np.ndarray], meta: Mapping,
                       device: DeviceLike = None) -> VotingWindow:
    """A port VotingWindow on ``device`` from a window's arrays.

    ``fields`` maps every name of ``WIN_FIELDS`` to its array; ``meta``
    holds ``base``, ``hashes`` (real E rows in order) and ``wit_hashes``
    (real W rows in order). Raises KeyError for a missing field and
    TypeError for an array of another dtype."""
    dev = resolve_device(device)
    tensors = {}
    for name in WIN_FIELDS:
        arr = np.asarray(fields[name])
        if arr.dtype != _WIN_DTYPES[name]:
            raise TypeError(
                f"window field {name}: dtype {arr.dtype}, want "
                f"{np.dtype(_WIN_DTYPES[name])}"
            )
        tensors[name] = torch.tensor(arr, device=dev)
    hashes = list(meta["hashes"])
    wit_hashes = list(meta["wit_hashes"])
    return VotingWindow(
        **tensors,
        base=int(meta["base"]),
        hashes=hashes,
        row={h: i for i, h in enumerate(hashes)},
        wit_hashes=wit_hashes,
        wit_row={h: i for i, h in enumerate(wit_hashes)},
    )


def snapshot_from_arrays(fields: Mapping[str, np.ndarray], meta: Mapping,
                         device: DeviceLike = None) -> DagSnapshot:
    """A port DagSnapshot whose arrays are tensors on ``device``, from a DAG
    snapshot's arrays.

    ``fields`` maps every name of ``ops.dag.SNAPSHOT_FIELDS`` to its array;
    ``meta`` holds ``n_peers``, ``super_majority`` and ``hashes`` (real E
    rows in order). Raises KeyError for a missing field, TypeError for an
    array of another dtype and ValueError for one of another shape."""
    dev = resolve_device(device)
    n_peers = int(meta["n_peers"])
    hashes = list(meta["hashes"])
    E = len(hashes)
    tensors = {}
    for name in SNAPSHOT_FIELDS:
        arr = np.asarray(fields[name])
        if arr.dtype != _SNAP_DTYPES[name]:
            raise TypeError(
                f"snapshot field {name}: dtype {arr.dtype}, want "
                f"{np.dtype(_SNAP_DTYPES[name])}"
            )
        want = (E, n_peers) if name in ("last_ancestors",
                                        "first_descendants") else (E,)
        if arr.shape != want:
            raise ValueError(f"snapshot field {name}: shape {arr.shape}, "
                             f"want {want}")
        tensors[name] = torch.tensor(arr, device=dev)
    return DagSnapshot(**tensors, n_peers=n_peers, hashes=hashes,
                       super_majority=int(meta["super_majority"]))


def verify_inputs_from_jax(pre_ok, u1, u2, table_x, table_y, table_inf, r, rn,
                           rn_ok, device: DeviceLike = None) -> VerifyInputs:
    """The port's ``ops.verify`` inputs on ``device`` from the nine arrays of
    a prepared signature batch in the JAX package's order and types
    (``babble_tpu.ops.verify._prepare``: uint32 16-bit limbs, bool masks).
    Raises TypeError for another dtype, ValueError for a limb of 2^16 or
    more or an array of another shape."""
    dev = resolve_device(device)
    arrays = dict(zip(VerifyInputs._fields, (pre_ok, u1, u2, table_x, table_y,
                                             table_inf, r, rn, rn_ok)))
    B = np.asarray(pre_ok).shape[0]
    shapes = {"pre_ok": (B,), "rn_ok": (B,), "table_inf": (B, 4),
              "table_x": (B, 4, 16), "table_y": (B, 4, 16)}
    tensors = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        want = shapes.get(name, (B, 16))
        if arr.shape != want:
            raise ValueError(f"verify input {name}: shape {arr.shape}, want "
                             f"{want}")
        if want in ((B,), (B, 4)):
            if arr.dtype != np.bool_:
                raise TypeError(f"verify input {name}: dtype {arr.dtype}, "
                                "want bool")
        else:
            if arr.dtype != np.uint32:
                raise TypeError(f"verify input {name}: dtype {arr.dtype}, "
                                "want uint32")
            if arr.size and int(arr.max()) >= 1 << 16:
                raise ValueError(f"verify input {name}: a limb of 2^16 or "
                                 "more")
            arr = arr.astype(np.int32)
        tensors[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return VerifyInputs(**tensors)
