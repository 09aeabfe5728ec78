"""JSONPeerSet — peers.json / peers.genesis.json loader
(reference: src/peers/json_peer_set.go:19)."""

from __future__ import annotations

import json
import os

from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet

PEERS_FILE = "peers.json"
GENESIS_PEERS_FILE = "peers.genesis.json"


class JSONPeerSet:
    def __init__(self, base_dir: str, genesis: bool = False):
        name = GENESIS_PEERS_FILE if genesis else PEERS_FILE
        self.path = os.path.join(base_dir, name)

    def peer_set(self) -> PeerSet:
        with open(self.path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return PeerSet([Peer.from_dict(d) for d in raw])

    def write(self, ps: PeerSet) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(ps.to_peer_slice(), f, indent=2)
