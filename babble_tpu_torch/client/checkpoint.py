"""Fast-sync checkpoints for read replicas (docs/clients.md §Checkpoints).

A checkpoint is the reference's Frame/fast-sync idea (docs/fastsync.md)
exposed as a client artifact: the current anchor block (the latest
block carrying MORE than 1/3 valid validator signatures) plus the Frame
it closes. Because hashgraph finality makes a signed block a
self-contained proof object, a fresh replica that verifies the
checkpoint against its known validator set can serve inclusion proofs
from block ``anchor+1`` onward in seconds — no DAG replay.

Schema (all bytes b64, JSON-plain):

    {"format": "babble-checkpoint/1",
     "block":  <Block.to_dict()>,       # body + accumulated signatures
     "frame":  <Frame.to_dict()>,       # peer-set history + roots
     "snapshot": <hex>}                 # optional app snapshot at the
                                        # anchor (validator rejoin only)

Verification lives in ``client.verifier.verify_checkpoint`` (extra keys
like ``snapshot`` are ignored — replicas don't need app state). The
snapshot rides along for REJOINING VALIDATORS (docs/lifecycle.md): the
reference ships it in FastForwardResponse, and a rejoiner that skips
``proxy.restore`` would chain its app state hash from a stale prefix and
commit blocks its peers refuse to countersign.
"""

from __future__ import annotations

import json

from ..crypto.canonical import jsonable
from .verifier import CHECKPOINT_FORMAT, verify_checkpoint  # noqa: F401


def make_checkpoint(block, frame, snapshot: bytes = None) -> dict:
    cp = {
        "format": CHECKPOINT_FORMAT,
        "block": jsonable(block.to_dict()),
        "frame": jsonable(frame.to_dict()),
    }
    if snapshot is not None:
        cp["snapshot"] = snapshot.hex()
    return cp


def export_checkpoint(core) -> dict:
    """Checkpoint from a validator's core — the anchor block + frame
    (core.get_anchor_block_with_frame raises while no block has enough
    signatures yet, typically only in a cluster's first seconds)."""
    block, frame = core.get_anchor_block_with_frame()
    return make_checkpoint(block, frame)


def save_checkpoint(cp: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cp, f, separators=(",", ":"))


def load_checkpoint(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)
