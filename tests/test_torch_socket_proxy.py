"""Twins of tests/test_socket_proxy.py: the socket proxy pair (the app in
another process than the node, src/proxy/socket) round-trips SubmitTx,
CommitBlock, snapshots, restores and state changes over localhost
sockets, and a node commits through it. Each case runs through both
packages (``pkg``) on the same inputs; one more runs one package's app
side against the other's node side, so the wire is held across packages.

Tolerance: exact (bytes, hashes and verdict strings)."""

from __future__ import annotations

import importlib
import time

import pytest

PKGS = ("babble_tpu", "babble_tpu_torch")
# fixed private scalars, so both packages run on the same keys
KEY_D = 0xB1ABB1E


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _pair(app_pkg: str, node_pkg: str, state):
    """A node-side ``SocketAppProxy`` of ``node_pkg`` and an app-side
    ``SocketBabbleProxy`` of ``app_pkg`` wired to each other."""
    babble_proxy = _m(node_pkg, "proxy.socket_proxy").SocketAppProxy(
        "127.0.0.1:0", client_addr="")
    app_proxy = _m(app_pkg, "proxy.socket_proxy").SocketBabbleProxy(
        "127.0.0.1:0", babble_proxy.addr, state)
    babble_proxy.set_client_addr(app_proxy.addr)
    return babble_proxy, app_proxy


def _round_trip(app_pkg: str, node_pkg: str) -> None:
    keys = _m(node_pkg, "crypto.keys")
    Peer = _m(node_pkg, "peers.peer").Peer
    PeerSet = _m(node_pkg, "peers.peer_set").PeerSet
    Block = _m(node_pkg, "hashgraph.block").Block
    k = keys.PrivateKey(KEY_D)
    peers = PeerSet([Peer("s://0", k.public_key.hex(), "n0")])
    state = _m(app_pkg, "dummy.state").State()
    babble_proxy, app_proxy = _pair(app_pkg, node_pkg, state)
    try:
        app_proxy.submit_tx(b"hello world")
        assert babble_proxy.submit_queue().get(timeout=5) == b"hello world"

        block = Block.new(0, 1, b"fh", peers, [b"a", b"b"], [], 42)
        resp = babble_proxy.commit_block(block)
        assert state.committed_txs == [b"a", b"b"]
        assert resp.state_hash == state.state_hash
        assert resp.receipts == []

        assert babble_proxy.get_snapshot(0) == state.snapshots[0]
        babble_proxy.restore(b"\x01\x02")
        assert state.state_hash == b"\x01\x02"

        babble_proxy.on_state_changed("Babbling")
        assert state.babble_state == "Babbling"
    finally:
        babble_proxy.close()
        app_proxy.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_socket_pair_round_trip(pkg):
    """Submit a transaction app -> node, commit a block node -> app, take a
    snapshot, restore one and report a state change, over real localhost
    sockets."""
    _round_trip(pkg, pkg)


@pytest.mark.parametrize("app_pkg,node_pkg", [PKGS, PKGS[::-1]])
def test_socket_pair_crosses_packages(app_pkg, node_pkg):
    """One package's app side against the other's node side: the same
    round trip, so the two speak one wire. The app's chained state hash
    is the same whichever package commits the block."""
    _round_trip(app_pkg, node_pkg)
    states = []
    for pkg in PKGS:
        block_mod = _m(pkg, "hashgraph.block")
        keys = _m(pkg, "crypto.keys")
        peers = _m(pkg, "peers.peer_set").PeerSet(
            [_m(pkg, "peers.peer").Peer(
                "s://0", keys.PrivateKey(KEY_D).public_key.hex(), "n0")])
        st = _m(pkg, "dummy.state").State()
        st.commit_handler(block_mod.Block.new(0, 1, b"fh", peers,
                                              [b"a", b"b"], [], 42))
        states.append(st.state_hash)
    assert states[0] == states[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_node_commits_through_socket_proxy(pkg):
    """A single node (monologue) commits blocks to an app behind the socket
    pair: the whole commit path across the wire; the block's state hash is
    among the app's snapshots."""
    keys = _m(pkg, "crypto.keys")
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    Config = _m(pkg, "config.config").Config
    k = keys.PrivateKey(KEY_D)
    peers = PeerSet([Peer("inmem://n0", k.public_key.hex(), "n0")])
    net = _m(pkg, "net.inmem").InmemNetwork()
    babble_proxy = _m(pkg, "proxy.socket_proxy").SocketAppProxy(
        "127.0.0.1:0", client_addr="")
    client = _m(pkg, "dummy.socket_client").DummySocketClient(
        "127.0.0.1:0", babble_proxy.addr)
    babble_proxy.set_client_addr(client.addr)
    conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.1,
                  moniker="n0", log_level="warning")
    node = _m(pkg, "node.node").Node(
        conf, _m(pkg, "node.validator").Validator(k, "n0"), peers, peers,
        _m(pkg, "hashgraph.store").InmemStore(conf.cache_size),
        net.new_transport("inmem://n0"), babble_proxy)
    node.init()
    node.run_async()
    try:
        deadline = time.monotonic() + 60
        i = 0
        while node.get_last_block_index() < 1 and time.monotonic() < deadline:
            client.submit_tx(f"tx {i}".encode())
            i += 1
            time.sleep(0.01)
        assert node.get_last_block_index() >= 1
        assert len(client.state.committed_txs) > 0
        # the app's snapshot can trail the node's block store by a beat
        ok = False
        check_deadline = time.monotonic() + 10
        while not ok and time.monotonic() < check_deadline:
            blk = node.get_block(node.get_last_block_index())
            ok = blk.state_hash() in client.state.snapshots.values()
            if not ok:
                time.sleep(0.05)
        assert ok, "block state-hash never appeared in app snapshots"
    finally:
        node.shutdown()
        babble_proxy.close()
        client.close()
