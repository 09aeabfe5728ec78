"""Peers / validator sets (reference: src/peers/)."""

from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet
from babble_tpu_torch.peers.json_peer_set import JSONPeerSet

__all__ = ["JSONPeerSet", "Peer", "PeerSet"]
