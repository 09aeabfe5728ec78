"""Stateless light-client verification (docs/clients.md §Verifying).

Checks an inclusion proof or a fast-sync checkpoint against nothing but
a known validator set — no store, no node, no network. This module is
the part that ships inside clients, so it depends only on the crypto
and peers layers and treats every input as hostile: malformed fields
raise :class:`ProofError` with a stable reason slug, never an arbitrary
exception.

Trust rule (the same finality bar the validators themselves use,
hashgraph.go check_block / peers.PeerSet.trust_count): a block is final
once it carries valid signatures from MORE than 1/3 of the validator
set the client trusts — under the <1/3-Byzantine assumption at least
one of those signers is honest, and honest validators only ever sign
one block per index (Baird 2016 hashgraph finality).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ..crypto.canonical import canonical_dumps, unb64
from ..crypto.hashing import sha256
from ..crypto.keys import PublicKey
from ..crypto.merkle import verify_path
from ..peers.peer import Peer
from ..peers.peer_set import PeerSet
from .proofs import PROOF_FORMAT, txid_hex

CHECKPOINT_FORMAT = "babble-checkpoint/1"


class ProofError(ValueError):
    """Verification failure; ``reason`` is a stable slug for tests and
    counters."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}{': ' + detail if detail else ''}")
        self.reason = reason


def as_peer_set(validators) -> PeerSet:
    """Accept a PeerSet, an iterable of Peers, or an iterable of peer
    dicts ({"NetAddr","PubKeyHex","Moniker"} — the /peers wire shape)."""
    if isinstance(validators, PeerSet):
        return validators
    peers: List[Peer] = []
    for v in validators:
        peers.append(v if isinstance(v, Peer) else Peer.from_dict(v))
    return PeerSet(peers)


def count_valid_signatures(
    body_hash: bytes, signatures: dict, peer_set: PeerSet
) -> int:
    """Signatures over ``body_hash`` from members of ``peer_set``.
    Unknown signers and invalid signatures simply don't count — a
    hostile server can pad the dict, never inflate the count."""
    valid = 0
    for validator_hex, sig in signatures.items():
        peer = peer_set.by_pub_key.get(validator_hex)
        if peer is None or not isinstance(sig, str):
            continue
        try:
            pub = PublicKey.from_hex(validator_hex)
            if pub.verify(body_hash, sig):
                valid += 1
        except Exception:  # noqa: BLE001 — hostile input, never raise
            continue
    return valid


def _header_hash(header: dict) -> bytes:
    """Hash of the signed header exactly as BlockBody.hash() computes it
    (the header dict is canonical-normal already: b64 strings, ints)."""
    if not isinstance(header, dict):
        raise ProofError("bad_header", "header is not an object")
    try:
        return sha256(canonical_dumps(header))
    except (TypeError, ValueError) as err:
        raise ProofError("bad_header", str(err)) from None


def verify_proof(proof: dict, validators, min_signatures: Optional[int] = None) -> dict:
    """Check one inclusion proof against the known validator set.

    Returns ``{"txid", "tx", "block_index", "round_received",
    "signatures_valid"}`` on success, raises :class:`ProofError`
    otherwise. ``min_signatures`` overrides the default
    more-than-one-third bar (e.g. a client wanting a supermajority).
    """
    if not isinstance(proof, dict):
        raise ProofError("bad_proof", "proof is not an object")
    if proof.get("format") != PROOF_FORMAT:
        raise ProofError("bad_format", str(proof.get("format")))
    peer_set = as_peer_set(validators)
    if len(peer_set) == 0:
        raise ProofError("empty_validator_set")
    header = proof.get("header")
    if not isinstance(header, dict):
        raise ProofError("bad_header", "missing header")

    # 1. the transaction is in the signed Merkle root
    try:
        tx = unb64(proof["tx"])
        index = int(proof["index"])
        count = int(proof["count"])
        path = [
            (unb64(step["hash"]), bool(step["right"]))
            for step in proof.get("path", [])
        ]
        root = unb64(header["TxRoot"])
    except (KeyError, TypeError, ValueError) as err:
        raise ProofError("bad_proof", str(err)) from None
    if count != header.get("TxCount"):
        raise ProofError("count_mismatch")
    if txid_hex(tx) != proof.get("txid"):
        raise ProofError("txid_mismatch")
    if not verify_path(tx, index, count, path, root):
        raise ProofError("bad_merkle_path")

    # 2. the header is bound to the validator set the client trusts
    try:
        peers_hash = unb64(header["PeersHash"])
    except (KeyError, TypeError, ValueError) as err:
        raise ProofError("bad_header", str(err)) from None
    if peers_hash != peer_set.hash():
        raise ProofError("wrong_validator_set")

    # 3. enough of those validators signed the header
    body_hash = _header_hash(header)
    signatures = proof.get("signatures")
    if not isinstance(signatures, dict):
        raise ProofError("bad_proof", "missing signatures")
    valid = count_valid_signatures(body_hash, signatures, peer_set)
    need = (
        int(min_signatures)
        if min_signatures is not None
        else peer_set.trust_count() + 1
    )
    if valid < need:
        raise ProofError(
            "not_enough_signatures", f"got {valid}, need >= {need}"
        )
    return {
        "txid": proof["txid"],
        "tx": tx,
        "block_index": header.get("Index"),
        "round_received": header.get("RoundReceived"),
        "signatures_valid": valid,
    }


def verify_block(block, validators, min_signatures: Optional[int] = None) -> int:
    """Full-block variant for subscribers (client.replica): the pushed
    block's body hash must carry enough valid signatures from the known
    set, and its PeersHash must be that set's. Returns the valid-sig
    count, raises ProofError."""
    peer_set = as_peer_set(validators)
    if len(peer_set) == 0:
        raise ProofError("empty_validator_set")
    if block.peers_hash() != peer_set.hash():
        raise ProofError("wrong_validator_set")
    valid = count_valid_signatures(
        block.body.hash(), block.signatures, peer_set
    )
    need = (
        int(min_signatures)
        if min_signatures is not None
        else peer_set.trust_count() + 1
    )
    if valid < need:
        raise ProofError(
            "not_enough_signatures", f"got {valid}, need >= {need}"
        )
    return valid


def verify_checkpoint(cp: dict, validators) -> tuple:
    """Check a fast-sync checkpoint (client.checkpoint schema) against
    the known validator set; returns the parsed (Block, Frame) on
    success. The frame is bound to the block through FrameHash, and the
    block to the validators through PeersHash + signatures — so a
    replica importing this snapshot trusts nothing but its validator
    set."""
    from ..hashgraph.block import Block
    from ..hashgraph.frame import Frame

    if not isinstance(cp, dict) or cp.get("format") != CHECKPOINT_FORMAT:
        raise ProofError("bad_format")
    try:
        block = Block.from_dict(cp["block"])
        frame = Frame.from_dict(cp["frame"])
    except Exception as err:  # noqa: BLE001 — hostile input
        raise ProofError("bad_checkpoint", str(err)) from None
    verify_block(block, validators)
    if block.frame_hash() != frame.hash():
        raise ProofError("bad_frame_hash")
    return block, frame
