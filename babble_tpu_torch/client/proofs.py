"""Server side of signed inclusion proofs (docs/clients.md §Proofs).

``TxIndex`` maps txid (sha256 of the payload) to (block index,
position) as blocks commit; ``build_proof`` assembles the proof object
``GET /proof/<txid>`` serves: the signed block *header* (transactions
committed via the Merkle root, hashgraph/block.py ``header_dict``), the
accumulated validator signatures, and the Merkle audit path. The
client-side check lives in ``client.verifier`` and needs nothing but
the validator set.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from ..crypto.canonical import b64, jsonable
from ..crypto.merkle import merkle_path

PROOF_FORMAT = "babble-proof/1"


def txid_hex(tx: bytes) -> str:
    return hashlib.sha256(tx).hexdigest()


class TxIndex:
    """Bounded txid → (block index, position) map, fed at commit.

    LRU on insertion order: when the cap is reached the OLDEST indexed
    transactions age out first — a proof request for an aged-out txid is
    a 404, exactly like a txid that never committed (the retention
    tradeoff is documented in docs/clients.md). A txid committed twice
    (the cross-node-retry caveat, docs/mempool.md) keeps its FIRST
    coordinates."""

    def __init__(self, cap: int = 1 << 18):
        self.cap = max(1, int(cap))
        self._map: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.indexed_total = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def index_block(self, block) -> None:
        txs = block.transactions()
        if not txs:
            return
        bi = block.index()
        with self._lock:
            for pos, tx in enumerate(txs):
                tid = txid_hex(tx)
                if tid in self._map:  # first commit wins
                    continue
                self._map[tid] = (bi, pos)
                self.indexed_total += 1
            while len(self._map) > self.cap:
                self._map.popitem(last=False)
                self.evictions += 1

    def lookup(self, tid: str) -> Optional[Tuple[int, int]]:
        with self._lock:
            return self._map.get(tid)

    def stats(self) -> dict:
        return {
            "entries": len(self._map),
            "indexed_total": self.indexed_total,
            "evictions": self.evictions,
        }


def build_proof(block, position: int) -> dict:
    """Proof object for ``block.transactions()[position]`` — everything
    a stateless verifier needs besides the validator set. JSON-plain
    (bytes already b64) so it serializes straight onto HTTP."""
    txs = block.transactions()
    tx = txs[position]
    path = merkle_path(txs, position)
    return {
        "format": PROOF_FORMAT,
        "txid": txid_hex(tx),
        "tx": b64(tx),
        "index": position,
        "count": len(txs),
        "path": [{"hash": b64(h), "right": right} for h, right in path],
        "header": jsonable(block.body.header_dict()),
        "signatures": dict(block.signatures),
    }
