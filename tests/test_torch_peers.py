"""The port's peers package against the JAX package's: the same exports
(``JSONPeerSet``, ``Peer``, ``PeerSet``, the import of tests/test_peers.py),
and a peers.json that either package writes, the other reads back as the
same validator set."""

import babble_tpu.peers as ref_peers
from babble_tpu.peers import JSONPeerSet as RefJSONPeerSet
from babble_tpu_torch import peers
from babble_tpu_torch.crypto import generate_key
from babble_tpu_torch.peers import JSONPeerSet, Peer, PeerSet


def make_peers(n):
    return [Peer(net_addr=f"127.0.0.1:{9000 + i}",
                 pub_key_hex=generate_key().public_key.hex(),
                 moniker=f"n{i}") for i in range(n)]


def test_exports_equal_the_reference():
    assert peers.__all__ == ref_peers.__all__ == ["JSONPeerSet", "Peer",
                                                  "PeerSet"]


def test_json_roundtrip(tmp_path):
    ps = PeerSet(make_peers(3))
    JSONPeerSet(str(tmp_path)).write(ps)
    loaded = JSONPeerSet(str(tmp_path)).peer_set()
    assert loaded == ps
    assert [p.moniker for p in loaded.peers] == [p.moniker for p in ps.peers]


def test_json_peer_set_crosses_packages(tmp_path):
    ps = PeerSet(make_peers(4))
    JSONPeerSet(str(tmp_path), genesis=True).write(ps)
    ref = RefJSONPeerSet(str(tmp_path), genesis=True).peer_set()
    assert ref.hash() == ps.hash()
    RefJSONPeerSet(str(tmp_path / "b")).write(ref)
    back = JSONPeerSet(str(tmp_path / "b")).peer_set()
    assert back == ps and back.hash() == ps.hash()
