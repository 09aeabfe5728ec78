"""The port's light-client tier against the JAX package's (docs/clients.md).

Tolerance: exact. Everything compared is bytes, JSON or a verdict.

- Pure functions: the same seeded inputs (fixed keys, RFC 6979 signing)
  go through both packages: Merkle roots and paths, block headers,
  ``build_proof``, ``TxIndex``, ``verify_proof``, ``verify_block``,
  ``verify_checkpoint``, checkpoint export and ``encode_block_frame``.
- Each package verifies the other's proofs and checkpoints, and both
  reject the same tampered copies with the same reason.
- The subscription hub (ordering, backfill, shedding, hostile frames) of
  the port, and the wire across packages: one package's client on the
  other's hub receives frames its own ``verify_block`` accepts.
- The same-seed push digest of ``SimCluster`` runs equal across packages.
- The clientsmoke twin: 4 port validators on the CPU, a port gateway and a
  100-subscriber port swarm; every sampled proof verifies under both
  packages.
- The gateway's command line, and its spawned shards' imports.
"""

from __future__ import annotations

import base64
import hashlib
import importlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "babble_tpu", "babble_tpu_torch"
PKGS = (REF, PORT)
# fixed private scalars: four validators and one outsider
KEY_SEEDS = (0xA11CE, 0xB0B, 0xCA401, 0xD0D0)
OUTSIDER_SEED = 0x5EED


def _mods(pkg: str) -> types.SimpleNamespace:
    """The client tier's modules of package ``pkg``."""
    names = {
        "merkle": "crypto.merkle", "canonical": "crypto.canonical",
        "keys": "crypto.keys", "block": "hashgraph.block",
        "peer": "peers.peer", "peer_set": "peers.peer_set",
        "proofs": "client.proofs", "verifier": "client.verifier",
        "checkpoint": "client.checkpoint", "subhub": "client.subhub",
        "swarm": "client.swarm",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


@pytest.fixture()
def deterministic():
    """RFC 6979 signing in both packages, so equal keys sign equally."""
    prev = {p: _mods(p).keys.set_deterministic_signing(True) for p in PKGS}
    try:
        yield
    finally:
        for p, v in prev.items():
            _mods(p).keys.set_deterministic_signing(v)


def _keys(m, seeds=KEY_SEEDS):
    return [m.keys.PrivateKey(d) for d in seeds]


def _peer_set(m, keys):
    return m.peer_set.PeerSet(
        [m.peer.Peer(f"addr{i}", k.public_key.hex(), f"v{i}")
         for i, k in enumerate(keys)])


def _signed_block(m, keys, peer_set, txs, index=0):
    block = m.block.Block.new(index, 1, b"frame", peer_set, txs, [], 42)
    block.body.state_hash = b"state"
    for k in keys:
        block.set_signature(block.sign(k))
    return block


def _proof_setup(pkg):
    m = _mods(pkg)
    keys = _keys(m)
    peer_set = _peer_set(m, keys)
    txs = [f"payload {i}".encode() for i in range(5)]
    return m, keys, peer_set, txs, _signed_block(m, keys, peer_set, txs)


def _verdict(fn, *args):
    """``fn``'s result, or ("rejected", reason) for a ProofError (either
    package's: both subclass ValueError and carry ``reason``)."""
    try:
        return fn(*args)
    except ValueError as err:
        return ("rejected", getattr(err, "reason", type(err).__name__))


def _jsonable_result(res):
    return {k: (base64.b64encode(v).decode() if isinstance(v, bytes) else v)
            for k, v in res.items()}


# -- merkle and the signed header --------------------------------------------


def test_merkle_roots_and_paths_equal_across_packages():
    ref, port = _mods(REF).merkle, _mods(PORT).merkle
    for n in range(0, 18):
        txs = [f"leaf {i}".encode() for i in range(n)]
        root = port.merkle_root(txs)
        assert root == ref.merkle_root(txs)
        if n == 0:
            assert root == port.EMPTY_ROOT == ref.EMPTY_ROOT
            continue
        for i in range(n):
            path = port.merkle_path(txs, i)
            assert path == ref.merkle_path(txs, i)
            for check in (port.verify_path, ref.verify_path):
                assert check(txs[i], i, n, path, root)
                assert (not check(txs[i], (i + 1) % n, n, path, root)
                        or n == 1)
                assert not check(b"not the leaf", i, n, path, root)
                assert not check(txs[i], i, 0, path, root)
                assert not check(txs[i], n, n, path, root)
    with pytest.raises(IndexError):
        port.merkle_path([b"x"], 1)
    assert port.leaf_hash(b"ab") == ref.leaf_hash(b"ab")
    assert port.leaf_hash(b"ab") != port.node_hash(b"a", b"b")
    assert port.node_hash(b"a", b"b") == ref.node_hash(b"a", b"b")
    assert port.merkle_root([b"a", b"b"]) != port.merkle_root([b"b", b"a"])


def test_merkle_tampered_path_rejected_by_both():
    txs = [f"t{i}".encode() for i in range(7)]
    for pkg in PKGS:
        mk = _mods(pkg).merkle
        root = mk.merkle_root(txs)
        path = mk.merkle_path(txs, 3)
        sib, right = path[1]
        bad = path[:1] + [(bytes([sib[0] ^ 1]) + sib[1:], right)] + path[2:]
        bad2 = path[:1] + [(sib, not right)] + path[2:]
        for other in PKGS:
            check = _mods(other).merkle.verify_path
            assert check(txs[3], 3, 7, path, root)
            assert not check(txs[3], 3, 7, bad, root)
            assert not check(txs[3], 3, 7, bad2, root)
            assert not check(txs[3], 3, 7, path[:-1], root)
            assert not check(txs[3], 3, 7, path + [(b"0" * 32, True)], root)


def test_blockbody_header_equal_across_packages():
    out = {}
    for pkg in PKGS:
        m = _mods(pkg)
        body = m.block.BlockBody(index=3, round_received=5, timestamp=7,
                                 transactions=[b"a", b"b", b"c"])
        header = body.header_dict()
        assert header["TxRoot"] == m.merkle.merkle_root([b"a", b"b", b"c"])
        assert header["TxCount"] == 3 and "Transactions" not in header
        h0 = body.hash()
        body.transactions = [b"a", b"b", b"x"]
        assert body.hash() != h0
        d = body.to_dict()
        legacy = {k: v for k, v in d.items() if k != "TxRoot"}
        assert m.block.BlockBody.from_dict(legacy).hash() == body.hash()
        out[pkg] = (m.canonical.jsonable(header), h0, body.hash(),
                    m.canonical.canonical_dumps(d))
    assert out[PORT] == out[REF]


# -- proofs ------------------------------------------------------------------


def test_proofs_equal_and_verified_across_packages(deterministic):
    made = {pkg: _proof_setup(pkg) for pkg in PKGS}
    proofs = {pkg: [json.loads(json.dumps(made[pkg][0].proofs.build_proof(
        made[pkg][4], i))) for i in range(5)] for pkg in PKGS}
    assert proofs[PORT] == proofs[REF]
    for maker in PKGS:
        for checker in PKGS:
            m, _, peer_set, txs, _ = made[checker]
            for i, proof in enumerate(proofs[maker]):
                res = m.verifier.verify_proof(proof, peer_set)
                assert res["tx"] == txs[i]
                assert res["block_index"] == 0
                assert res["round_received"] == 1
                assert res["signatures_valid"] == 4
                assert m.verifier.verify_proof(
                    proof, [p.to_dict() for p in peer_set.peers])
            # the maker's whole block, parsed by the checker: what a
            # subscriber of the other package checks
            wire = made[maker][0].canonical.jsonable(made[maker][4].to_dict())
            block = m.block.Block.from_dict(json.loads(json.dumps(wire)))
            assert m.verifier.verify_block(block, peer_set) == 4
    results = {pkg: [_jsonable_result(made[pkg][0].verifier.verify_proof(
        p, made[pkg][2])) for p in proofs[pkg]] for pkg in PKGS}
    assert results[PORT] == results[REF]


def _tampered(name, proof, m, keys, block):
    """One hostile variant of ``proof`` of ``block`` (package ``m``)."""
    b64, unb64 = m.canonical.b64, m.canonical.unb64
    member = keys[0].public_key.hex()
    outsider = m.keys.PrivateKey(OUTSIDER_SEED)
    forged = outsider.sign(block.body.hash())
    if name == "merkle_path":
        step = dict(proof["path"][0])
        raw = bytearray(unb64(step["hash"]))
        raw[0] ^= 1
        step["hash"] = b64(bytes(raw))
        return {**proof, "path": [step] + proof["path"][1:]}
    if name == "tx":
        return {**proof, "tx": b64(b"evil")}
    if name == "tx_and_txid":
        return {**proof, "tx": b64(b"evil"),
                "txid": m.proofs.txid_hex(b"evil")}
    if name == "forged_signature":
        return {**proof, "signatures": {member: forged}}
    if name == "one_signature":
        return {**proof,
                "signatures": {member: proof["signatures"][member]}}
    if name == "padded":
        return {**proof, "signatures": {
            member: proof["signatures"][member], "zz": "junk",
            outsider.public_key.hex(): forged}}
    if name == "header_index":
        return {**proof, "header": {**proof["header"], "Index": 9}}
    if name == "count":
        return {**proof, "count": 99}
    raise KeyError(name)


TAMPERS = ("merkle_path", "tx", "tx_and_txid", "forged_signature",
           "one_signature", "padded", "header_index", "count")
HOSTILE = (None, [], "proof", {}, {"format": "nope"},
           {"format": "babble-proof/1"})


@pytest.mark.parametrize("tamper", TAMPERS)
def test_tampered_proof_rejected_by_both_with_one_reason(deterministic,
                                                         tamper):
    verdicts = {}
    for maker in PKGS:
        m, keys, _, _, block = _proof_setup(maker)
        proof = _tampered(tamper, m.proofs.build_proof(block, 2), m, keys,
                          block)
        proof = json.loads(json.dumps(proof))
        for checker in PKGS:
            c = _mods(checker)
            verdicts[(maker, checker)] = _verdict(
                c.verifier.verify_proof, proof, _peer_set(c, _keys(c)))
    assert len(set(map(str, verdicts.values()))) == 1, verdicts
    verdict = verdicts[(PORT, PORT)]
    assert verdict[0] == "rejected"
    want = {"merkle_path": "bad_merkle_path", "tx": "txid_mismatch",
            "tx_and_txid": "bad_merkle_path",
            "forged_signature": "not_enough_signatures",
            "header_index": "not_enough_signatures"}
    if tamper in want:
        assert verdict[1] == want[tamper]


def test_wrong_set_and_malformed_proofs_rejected_by_both(deterministic):
    verdicts = {}
    for pkg in PKGS:
        m, _, peer_set, _, block = _proof_setup(pkg)
        proof = m.proofs.build_proof(block, 0)
        stranger = _peer_set(m, _keys(m, (11, 12, 13, 14)))
        verdicts[pkg] = ([_verdict(m.verifier.verify_proof, proof, stranger)]
                         + [_verdict(m.verifier.verify_proof, h, peer_set)
                            for h in HOSTILE])
    assert verdicts[PORT] == verdicts[REF]
    assert verdicts[PORT][0] == ("rejected", "wrong_validator_set")
    assert all(v[0] == "rejected" for v in verdicts[PORT])


def test_txindex_equal_across_packages(deterministic):
    out = {}
    for pkg in PKGS:
        m, keys, peer_set, txs, block = _proof_setup(pkg)
        idx = m.proofs.TxIndex(cap=3)
        idx.index_block(block)
        idx2 = m.proofs.TxIndex()
        idx2.index_block(block)
        dup = _signed_block(m, keys, peer_set, [txs[1]], index=7)
        idx2.index_block(dup)
        tids = [m.proofs.txid_hex(t) for t in txs]
        out[pkg] = (len(idx), idx.evictions, [idx.lookup(t) for t in tids],
                    [idx2.lookup(t) for t in tids], idx.stats(),
                    idx2.stats())
    assert out[PORT] == out[REF]
    lookups = out[PORT][2]
    assert out[PORT][:2] == (3, 2) and lookups[0] is None
    assert lookups[4] == (0, 4) and out[PORT][3][1] == (0, 1)


# -- checkpoints -------------------------------------------------------------


def _mini_cluster(pkg, n):
    """``n`` nodes of package ``pkg`` over its in-memory transport, with
    fixed keys. Returns (nodes, proxies, states, peers)."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    Config = mod("config.config").Config
    net = mod("net.inmem").InmemNetwork()
    m = _mods(pkg)
    transports = [net.new_transport(f"inmem://c{i}") for i in range(n)]
    keys = _keys(m, KEY_SEEDS[:n])
    peers = m.peer_set.PeerSet(
        [m.peer.Peer(t.advertise_addr(), k.public_key.hex(), f"c{i}")
         for i, (t, k) in enumerate(zip(transports, keys))])
    nodes, proxies, states = [], [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=0.01, slow_heartbeat_timeout=0.2,
                      moniker=f"c{i}", log_level="error")
        st = mod("dummy.state").State()
        pr = mod("proxy.proxy").InmemProxy(st)
        node = mod("node.node").Node(
            conf, mod("node.validator").Validator(k, f"c{i}"), peers, peers,
            mod("hashgraph.store").InmemStore(conf.cache_size),
            transports[i], pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
        states.append(st)
    return nodes, proxies, states, peers


def _wait(pred, deadline_s=60.0, msg="condition"):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.03)
    raise AssertionError(f"timeout waiting for {msg}")


def _quiet(sample, still_s, deadline_s, msg):
    """Wait until ``sample()`` has not changed for ``still_s`` seconds."""
    deadline = time.monotonic() + deadline_s
    last, since = sample(), time.monotonic()
    while time.monotonic() - since < still_s:
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout waiting for {msg}")
        time.sleep(0.1)
        now = sample()
        if now != last:
            last, since = now, time.monotonic()


def _live_checkpoint(pkg):
    """A checkpoint exported by a live 3-node cluster of ``pkg``, through
    the HTTP round trip's JSON, and the cluster's peers as dicts."""
    nodes, proxies, states, peers = _mini_cluster(pkg, 3)
    try:
        for n in nodes:
            n.run_async()
        assert proxies[0].submit_tx(b"cp tx") == "accepted"
        _wait(lambda: all(b"cp tx" in s.committed_txs for s in states),
              msg="commit")
        deadline = time.monotonic() + 60.0
        while True:
            try:
                cp = nodes[0].get_checkpoint()
                break
            except ValueError:  # no anchor block yet
                assert time.monotonic() < deadline, "anchor never sealed"
                time.sleep(0.05)
        return (json.loads(json.dumps(cp)),
                [p.to_dict() for p in peers.peers])
    finally:
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("maker", PKGS)
def test_checkpoint_verified_and_reexported_across_packages(maker):
    cp, peer_dicts = _live_checkpoint(maker)
    bad_sigs = json.loads(json.dumps(cp))
    bad_sigs["block"]["Signatures"] = {
        who: sig[:-2] + ("11" if not sig.endswith("11") else "22")
        for who, sig in bad_sigs["block"]["Signatures"].items()}
    bad_frame = json.loads(json.dumps(cp))
    bad_frame["frame"]["Timestamp"] = bad_frame["frame"]["Timestamp"] + 1
    verdicts = {}
    for checker in PKGS:
        c = _mods(checker)
        peers = c.verifier.as_peer_set(peer_dicts)
        block, frame = c.verifier.verify_checkpoint(cp, peers)
        assert block.frame_hash() == frame.hash()
        # exported again from the parsed objects: the same checkpoint
        assert c.checkpoint.make_checkpoint(block, frame) == cp
        stranger = _peer_set(c, _keys(c, (21, 22, 23)))
        verdicts[checker] = [
            _verdict(c.verifier.verify_checkpoint, bad_sigs, peers),
            _verdict(c.verifier.verify_checkpoint, bad_frame, peers),
            _verdict(c.verifier.verify_checkpoint, cp, stranger),
            _verdict(c.verifier.verify_checkpoint, {"format": "junk"}, peers),
        ]
    assert verdicts[PORT] == verdicts[REF]
    got = verdicts[PORT]
    assert got[0] == ("rejected", "not_enough_signatures")
    assert got[1][1] in ("bad_frame_hash", "bad_checkpoint")
    assert all(v[0] == "rejected" for v in got)


# -- the pushed frame and the subscription hub -------------------------------


def test_block_frame_equal_across_packages(deterministic):
    frames = {}
    for pkg in PKGS:
        m, _, _, _, block = _proof_setup(pkg)
        frames[pkg] = (m.subhub.encode_block_frame(block),
                       m.subhub.encode_block_frame(block, ts=1234.5))
    assert frames[PORT] == frames[REF]
    for pkg in PKGS:
        buf = bytearray(frames[PORT][0] + frames[PORT][1][:-3])
        got = _mods(pkg).subhub.parse_frames(buf)
        assert len(got) == 1 and got[0]["type"] == "block"
        assert "ts" not in got[0] and len(buf) == len(frames[PORT][1]) - 3


class _FakeBlock:
    def __init__(self, i, fill=0):
        self.i = i
        self._fill = "x" * fill

    def index(self):
        return self.i

    def to_dict(self):
        return {"Body": {"Index": self.i, "Transactions": [],
                         "Fill": self._fill},
                "Signatures": {}}


@pytest.mark.parametrize("client_pkg", PKGS)
def test_subhub_in_order_no_gaps_and_backfill(client_pkg):
    from babble_tpu_torch.client.subhub import SubscriptionHub

    Client = _mods(client_pkg).swarm.SubscriberClient
    blocks = {}
    hub = SubscriptionHub("127.0.0.1:0", blocks.get, moniker="unit",
                          queue_frames=8)
    addr = hub.listen()
    try:
        early = Client(addr, start=0)
        for i in range(6):
            blocks[i] = _FakeBlock(i)
            hub.publish(i)
        got = [early.recv(timeout=5)["block"]["Body"]["Index"]
               for _ in range(6)]
        assert got == list(range(6))
        live = Client(addr, start=-1)
        assert live.hello["next"] == 6
        blocks[6] = _FakeBlock(6)
        hub.publish(6)
        assert live.recv(timeout=5)["block"]["Body"]["Index"] == 6
        assert early.recv(timeout=5)["block"]["Body"]["Index"] == 6
        blocks[8] = _FakeBlock(8)
        hub.publish(8)
        with pytest.raises((socket.timeout, TimeoutError)):
            live.recv(timeout=0.6)
        blocks[7] = _FakeBlock(7)
        assert live.recv(timeout=5)["block"]["Body"]["Index"] == 7
        assert live.recv(timeout=5)["block"]["Body"]["Index"] == 8
        stats = hub.stats()
        assert stats["subscribers"] == 2 and stats["shed"] == 0
        early.close()
        live.close()
    finally:
        hub.close()


def test_subhub_sheds_stalled_subscriber_without_hurting_healthy():
    from babble_tpu_torch.client.subhub import SubscriptionHub
    from babble_tpu_torch.client.swarm import SubscriberClient

    blocks = {}
    hub = SubscriptionHub("127.0.0.1:0", blocks.get, moniker="unit",
                          queue_frames=4, stall_timeout_s=0.8, sndbuf=8192)
    addr = hub.listen()
    try:
        healthy = SubscriberClient(addr, start=0)
        host, port_s = addr.rsplit(":", 1)
        bait = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        bait.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        bait.connect((host, int(port_s)))
        body = json.dumps({"type": "subscribe", "from": 0}).encode()
        bait.sendall(struct.pack(">I", len(body)) + body)
        _wait(lambda: hub.stats()["subscribers"] == 2, 10, "both subscribed")
        for i in range(40):
            blocks[i] = _FakeBlock(i, fill=8192)
            hub.publish(i)
        got = [healthy.recv(timeout=10)["block"]["Body"]["Index"]
               for i in range(40)]
        assert got == list(range(40)), "healthy subscriber saw gap/disorder"
        _wait(lambda: hub.stats()["shed"] == 1, 20, "stalled subscriber shed")
        _wait(lambda: hub.stats()["subscribers"] == 1, 5,
              "bait gone, healthy alive")
        assert hub.stats()["shed_reasons"].get("stalled", 0) == 1
        blocks[40] = _FakeBlock(40)
        hub.publish(40)
        assert healthy.recv(timeout=5)["block"]["Body"]["Index"] == 40
        healthy.close()
        bait.close()
    finally:
        hub.close()


def test_subhub_survives_hostile_frames():
    from babble_tpu_torch.client.subhub import SubscriptionHub, parse_frames
    from babble_tpu_torch.client.swarm import SubscriberClient

    blocks = {0: _FakeBlock(0)}
    hub = SubscriptionHub("127.0.0.1:0", blocks.get, moniker="unit")
    addr = hub.listen()
    try:
        host, port_s = addr.rsplit(":", 1)
        for hostile in (b"[1,2,3]", b"42", b'"subscribe"', b"not json"):
            s = socket.create_connection((host, int(port_s)), timeout=5)
            s.sendall(struct.pack(">I", len(hostile)) + hostile)
            s.close()
        _wait(lambda: hub.stats()["shed_reasons"].get("protocol", 0) >= 3,
              10, "hostile clients shed as protocol errors")
        assert hub._thread.is_alive()
        good = SubscriberClient(addr, start=0)
        hub.publish(0)
        assert good.recv(timeout=5)["block"]["Body"]["Index"] == 0
        good.close()
    finally:
        hub.close()
    bad = bytearray(struct.pack(">I", 7) + b"[1,2,3]")
    with pytest.raises(ValueError):
        parse_frames(bad)


@pytest.mark.parametrize("hub_pkg", PKGS)
def test_signed_stream_crosses_packages(deterministic, hub_pkg):
    """One package's hub serves signed blocks; the other package's
    SubscriberClient receives them in order, and its verify_block accepts
    every one against its own copy of the validator set."""
    client_pkg = PORT if hub_pkg == REF else REF
    h = _mods(hub_pkg)
    keys = _keys(h)
    peer_set = _peer_set(h, keys)
    blocks = {i: _signed_block(h, keys, peer_set,
                               [f"wire {i} {j}".encode() for j in range(3)],
                               index=i)
              for i in range(4)}
    hub = h.subhub.SubscriptionHub("127.0.0.1:0", blocks.get, moniker="x")
    addr = hub.listen()
    c = _mods(client_pkg)
    client = c.swarm.SubscriberClient(addr, start=0)
    try:
        for i in range(4):
            hub.publish(i)
        their_set = _peer_set(c, _keys(c))
        for i in range(4):
            frame = client.recv(timeout=5)
            block = c.block.Block.from_dict(frame["block"])
            assert block.index() == i
            assert block.body.hash() == blocks[i].body.hash()
            assert c.verifier.verify_block(block, their_set) == 4
    finally:
        client.close()
        hub.close()


# -- deterministic sim-clock push digests ------------------------------------


def _push_digest(pkg: str, seed: int) -> str:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    keys = mod("crypto.keys")
    encode = mod("client.subhub").encode_block_frame
    prev = keys.set_deterministic_signing(True)
    cluster = None
    try:
        sch = mod("sim.scheduler").SimScheduler(seed)
        cluster = mod("sim.harness").SimCluster(sch, 4, heartbeat_s=0.05)
        cluster.start()
        txrng = sch.rng("txmix")
        for k in range(10):
            sch.at(0.05 + 0.06 * k, lambda: cluster.submit_auto(txrng), "tx")
        sch.run_until(3.0)
        node = cluster.nodes[0]
        assert node.get_last_block_index() >= 0, "nothing committed"
        h = hashlib.sha256()
        for bi in range(node.get_last_block_index() + 1):
            h.update(encode(node.get_block(bi)))
        return h.hexdigest()
    finally:
        try:
            if cluster is not None:
                cluster.shutdown()
        finally:
            keys.set_deterministic_signing(prev)


@pytest.mark.sim
def test_same_seed_push_digest_equal_across_packages():
    port77 = _push_digest(PORT, 77)
    assert port77 == _push_digest(REF, 77)
    assert port77 == _push_digest(PORT, 77)
    assert port77 != _push_digest(PORT, 78)


# -- the clientsmoke twin ----------------------------------------------------


@pytest.mark.client
def test_clientsmoke_port_cluster_gateway_swarm_proofs():
    """4 port TCP validators on the CPU (hub + HTTP service each), a port
    gateway (threads, 2 shards) and a port swarm of 100 subscribers, 5 of
    them stalled. Every sampled transaction's proof verifies under both
    packages; healthy subscribers see every block in order; stalled ones
    are shed; a checkpoint spins up a port read replica that serves a
    proof; the JAX package's SubscriberClient on a port hub receives
    frames its verify_block accepts."""
    from babble_tpu.client.swarm import SubscriberClient as RefClient
    from babble_tpu.client.verifier import verify_block as ref_verify_block
    from babble_tpu.client.verifier import verify_proof as ref_verify_proof
    from babble_tpu.hashgraph.block import Block as RefBlock
    from babble_tpu_torch.client.gateway import Gateway
    from babble_tpu_torch.client.proofs import txid_hex
    from babble_tpu_torch.client.replica import ReadReplica
    from babble_tpu_torch.client.swarm import SubscriberSwarm
    from babble_tpu_torch.client.verifier import (
        ProofError,
        verify_checkpoint,
        verify_proof,
    )
    from babble_tpu_torch.config.config import Config
    from babble_tpu_torch.dummy.socket_client import DummySocketClient
    from babble_tpu_torch.dummy.state import State as DummyState
    from babble_tpu_torch.hashgraph.store import InmemStore
    from babble_tpu_torch.net.tcp import TCPTransport
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet
    from babble_tpu_torch.proxy.proxy import InmemProxy
    from babble_tpu_torch.proxy.socket_proxy import (
        JsonRpcClient,
        SocketAppProxy,
    )
    from babble_tpu_torch.service.service import Service

    n_nodes, n_subs, n_stalled = 4, 100, 5
    transports = [TCPTransport("127.0.0.1:0", max_pool=2, timeout=5.0)
                  for _ in range(n_nodes)]
    for t in transports:
        t.listen()
    m = _mods(PORT)
    keys = _keys(m)
    peers = PeerSet([Peer(t.advertise_addr(), k.public_key.hex(), f"v{i}")
                     for i, (t, k) in enumerate(zip(transports, keys))])
    peer_dicts = [p.to_dict() for p in peers.peers]
    sock_proxies, dummies = [], []
    for _ in range(2):
        sp = SocketAppProxy("127.0.0.1:0", "127.0.0.1:0")
        dc = DummySocketClient("127.0.0.1:0", sp.addr)
        sp.set_client_addr(dc.addr)
        sock_proxies.append(sp)
        dummies.append(dc)
    nodes, proxies, states, services = [], [], [], []
    gw = swarm = None
    try:
        for i, k in enumerate(keys):
            conf = Config(heartbeat_timeout=0.01, slow_heartbeat_timeout=0.2,
                          moniker=f"v{i}", log_level="error",
                          client_listen="127.0.0.1:0", sub_queue_frames=32,
                          sub_stall_timeout_s=3.0, sub_sndbuf=8192)
            if i < 2:
                pr, st = sock_proxies[i], dummies[i].state
            else:
                st = DummyState()
                pr = InmemProxy(st)
            node = Node(conf, Validator(k, f"v{i}"), peers, peers,
                        InmemStore(conf.cache_size), transports[i], pr)
            node.init()
            nodes.append(node)
            proxies.append(pr)
            states.append(st)
            srv = Service("127.0.0.1:0", node, logger=None)
            srv.serve_async()
            services.append(srv)
        for n in nodes:
            n.run_async()

        gw = Gateway([sp.addr for sp in sock_proxies],
                     nodes[2].client_hub.bind_addr, peer_dicts,
                     listen="127.0.0.1:0", sub_listen="127.0.0.1:0",
                     http_addr="127.0.0.1:0", shards=2, processes=False)
        gw.start()
        swarm = SubscriberSwarm([n.client_hub.bind_addr for n in nodes],
                                n_subs, start=0,
                                stall_frac=n_stalled / n_subs)
        swarm.start_all()
        assert swarm.connect_errors == 0
        _wait(lambda: sum(n.client_hub.stats()["subscribers"]
                          for n in nodes) == n_subs + 1,
              60, "all subscribers attached")

        gw_client = JsonRpcClient(gw.listen_addr)
        accepted = []
        for i in range(60):
            tx = (f"gw tx {i} " + "x" * 1000).encode()
            v = gw_client.call("Babble.SubmitTx",
                               base64.b64encode(tx).decode("ascii"))
            assert v == "accepted", (i, v)
            accepted.append(tx)
        for i in range(40):
            tx = (f"direct tx {i} " + "y" * 1000).encode()
            if proxies[2 + (i % 2)].submit_tx(tx) == "accepted":
                accepted.append(tx)
        assert gw_client.call(
            "Babble.SubmitTx", base64.b64encode(accepted[0]).decode("ascii"),
        ) in ("duplicate", "already_committed")
        _wait(lambda: all(all(tx in st.committed_txs for tx in accepted)
                          for st in states),
              120, "all accepted txs committed everywhere")

        sample = accepted[:: max(1, len(accepted) // 12)][:12]
        for j, tx in enumerate(sample):
            tid = txid_hex(tx)
            srv = services[j % n_nodes]
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://{srv.bind_addr}/proof/{tid}",
                            timeout=5.0) as r:
                        proof = json.loads(r.read())
                    assert verify_proof(proof, peers)["tx"] == tx
                    break
                except (ProofError, urllib.error.HTTPError, OSError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            assert ref_verify_proof(proof, peer_dicts)["tx"] == tx
            bad = {**proof, "tx": base64.b64encode(b"evil").decode()}
            for check in (verify_proof, ref_verify_proof):
                assert _verdict(check, bad, peer_dicts) == (
                    "rejected", "txid_mismatch")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://{services[0].bind_addr}/proof/{'0' * 64}",
                timeout=5.0)
        assert ei.value.code == 404

        gw_tid = txid_hex(accepted[0])
        _wait(lambda: gw.get_proof(gw_tid) is not None, 60,
              "gateway replica indexed the tx")
        for check in (verify_proof, ref_verify_proof):
            assert check(json.loads(json.dumps(gw.get_proof(gw_tid))),
                         peer_dicts)["tx"] == accepted[0]
        assert gw.replica.rejected_blocks == 0

        _wait(lambda: sum(n.client_hub.stats()["shed"]
                          for n in nodes) >= n_stalled,
              60, "stalled subscribers shed")
        _quiet(lambda: ([mb.blocks for mb in swarm.members],
                        [n.client_hub.stats()["pushed_blocks"]
                         for n in nodes]),
               2.0, 60, "the stream's tail reached the swarm")
        st = swarm.stats()
        assert st["gaps"] == 0, st
        healthy = swarm.healthy()
        # a loaded host can make the swarm's one reader thread look like a
        # slow consumer itself: the hub shedding a few of those is right
        alive = [mb for mb in healthy if not mb.closed]
        assert len(alive) >= 0.9 * len(healthy)
        assert min(mb.blocks for mb in alive) > 0
        by_hub = {}
        for mb in alive:
            by_hub.setdefault(mb.idx % n_nodes, set()).add(mb.blocks)
        for counts in by_hub.values():
            assert max(counts) - min(counts) <= 1, counts

        # the JAX package's client on a port hub: frames its own
        # verify_block accepts
        ref_client = RefClient(nodes[1].client_hub.bind_addr, start=0)
        try:
            for i in range(2):
                frame = ref_client.recv(timeout=60)
                block = RefBlock.from_dict(frame["block"])
                assert block.index() == i
                assert ref_verify_block(block, peer_dicts) >= 2
        finally:
            ref_client.close()

        with urllib.request.urlopen(
                f"http://{services[0].bind_addr}/checkpoint",
                timeout=5.0) as r:
            cp = json.loads(r.read())
        block, _ = verify_checkpoint(cp, peers)
        replica = ReadReplica(nodes[3].client_hub.bind_addr, peer_dicts,
                              checkpoint=cp, http_addr="127.0.0.1:0")
        assert replica.last_verified == block.index()
        replica.start()
        try:
            cp_txs = [t for t in block.transactions() if t in accepted]
            probe = cp_txs[0] if cp_txs else accepted[0]
            _wait(lambda: replica.get_proof(txid_hex(probe)) is not None,
                  60, "replica serves the proof")
            with urllib.request.urlopen(
                    f"http://{replica.http_addr}/proof/{txid_hex(probe)}",
                    timeout=5.0) as r:
                proof = json.loads(r.read())
            for check in (verify_proof, ref_verify_proof):
                assert check(proof, peer_dicts)["tx"] == probe
            assert replica.rejected_blocks == 0
        finally:
            replica.close()
        snap = nodes[0].get_stats_snapshot()
        assert snap["client_pushed_blocks"] > 0
        assert snap["client_txindex_entries"] > 0
        gw_stats = gw.stats()
        assert gw_stats["shards"] == 2 and gw_stats["submitted"] == 61
    finally:
        if swarm is not None:
            swarm.stop()
        if gw is not None:
            gw.close()
        for srv in services:
            srv.shutdown()
        for n in nodes:
            n.shutdown()
        for dc in dummies:
            dc.close()


# -- the gateway's command line and its shard processes ----------------------


def test_gateway_module_help():
    out = subprocess.run(
        [sys.executable, "-m", "babble_tpu_torch.client.gateway", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--forward" in out.stdout and "--processes" in out.stdout
    assert "babble_tpu_torch.client.gateway" in out.stdout


def test_gateway_shard_process_imports_only_the_port(tmp_path):
    """A shard spawned as the gateway spawns it (a fresh interpreter that
    re-imports its target by module path) forwards an accepted
    transaction to a validator's SubmitTx, and has loaded nothing of the
    JAX package or JAX."""
    script = tmp_path / "shard_probe.py"
    script.write_text(textwrap.dedent("""
        import multiprocessing as mp
        import sys

        from babble_tpu_torch.client import gateway
        from babble_tpu_torch.proxy.socket_proxy import JsonRpcServer


        def shard(tasks, resps, loaded):
            gateway._worker_loop(0, [sys.argv[1]], {}, tasks, resps)
            loaded.put(sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "babble_tpu")))


        if __name__ == "__main__":
            got = []
            srv = JsonRpcServer("127.0.0.1:0", {
                "Babble.SubmitTx": lambda tx: got.append(tx) or True})
            sys.argv[1:] = [srv.addr]
            ctx = mp.get_context("spawn")
            tasks, resps, loaded = ctx.Queue(), ctx.Queue(), ctx.Queue()
            p = ctx.Process(target=shard, args=(tasks, resps, loaded))
            p.start()
            tasks.put(("tx", 1, b"probe tx"))
            verdict = resps.get(timeout=60)
            tasks.put(None)
            mods = loaded.get(timeout=60)
            p.join(timeout=30)
            srv.close()
            print(verdict[2], len(got), p.exitcode, mods)
    """))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (ROOT, os.environ.get("PYTHONPATH"))))}
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["accepted", "1", "0", "[]"], out.stdout


def test_gateway_final_stats_waits_for_a_late_shard():
    """A shard still forwarding to its validator answers the final stats
    request late. ``final_stats`` names it in ``workers_missing`` while it
    is held past the deadline, and reports its counters once it answers.
    The fixed 0.5 s wait that ``main`` used before printed such a line
    without that shard and without saying so."""
    from babble_tpu_torch.client import gateway as gwmod
    from babble_tpu_torch.proxy.socket_proxy import JsonRpcServer

    release = threading.Event()

    def slow_submit(tx_b64):
        release.wait(60)
        return True

    validator = JsonRpcServer("127.0.0.1:0", {"Babble.SubmitTx": slow_submit})
    dead = socket.socket()  # bound, never listening: refuses connections
    dead.bind(("127.0.0.1", 0))
    m = _mods(PORT)
    peers = [p.to_dict() for p in _peer_set(m, _keys(m)).peers]
    gw = gwmod.Gateway([validator.addr],
                       f"127.0.0.1:{dead.getsockname()[1]}", peers,
                       shards=2, submit_timeout=60.0)
    gw.start()
    verdicts = []
    submitter = None
    try:
        tx = next(t for t in (b"late tx %d" % i for i in range(64))
                  if gwmod._shard_of(t, 2) == 1)
        submitter = threading.Thread(
            target=lambda: verdicts.append(gw.submit(tx)))
        submitter.start()
        _wait(lambda: gw._task_qs[1].empty() and gw.submitted == 1, 30,
              "shard 1 took the transaction")
        held = gwmod.final_stats(gw, timeout=0.5)
        assert 1 in held["workers_missing"]
        assert sorted([*held["workers"], *held["workers_missing"]]) == [0, 1]
        # the validator answers 2 s into the final wait
        timer = threading.Timer(2.0, release.set)
        timer.start()
        t0 = time.monotonic()
        final = gwmod.final_stats(gw, timeout=60.0)
        assert time.monotonic() - t0 >= 2.0
        timer.join(timeout=10)
        assert final["workers_missing"] == []
        assert sorted(final["workers"]) == [0, 1]
        assert final["workers"][0]["submitted"] == 0
        assert final["workers"][1]["submitted"] == 1
        assert final["workers"][1]["accepted"] == 1
        submitter.join(timeout=60)
        assert not submitter.is_alive() and verdicts == ["accepted"]
    finally:
        release.set()
        gw.close()
        validator.close()
        dead.close()
        if submitter is not None:
            submitter.join(timeout=60)


def test_gateway_cli_processes_serve_and_shut_down(tmp_path):
    """``python -m babble_tpu_torch.client.gateway --processes`` starts its
    shard processes, answers SubmitTx (no validator is up, so a fresh
    transaction is ``unavailable`` and its retry a ``duplicate``), serves
    its replica's /stats, and on SIGTERM prints its final stats() (every
    shard's counters included) as one JSON line and exits 0."""
    from babble_tpu_torch.proxy.socket_proxy import JsonRpcClient

    # The gateway binds its own ports (":0") and names them on its "gateway
    # up" line; the dead validator is a socket held bound and never
    # listening, so no other process can take its port while the test runs.
    dead_sock = socket.socket()
    dead_sock.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{dead_sock.getsockname()[1]}"
    m = _mods(PORT)
    peers = tmp_path / "peers.json"
    peers.write_text(json.dumps([p.to_dict() for p in
                                 _peer_set(m, _keys(m)).peers]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "babble_tpu_torch.client.gateway",
         "--forward", dead, "--upstream", dead, "--peers", str(peers),
         "--listen", "127.0.0.1:0", "--sub-listen", "127.0.0.1:0",
         "--http", "127.0.0.1:0", "--shards", "2", "--processes"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err_lines = []
    reader = threading.Thread(target=lambda: err_lines.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 120
        while not any(ln.startswith("gateway up") for ln in err_lines):
            assert proc.poll() is None, "".join(err_lines)
            assert time.monotonic() < deadline, "gateway never came up"
            time.sleep(0.1)
        up = next(ln for ln in err_lines if ln.startswith("gateway up"))
        fields = dict(part.strip().split(" ", 1)
                      for part in up.split(":", 1)[1].split(","))
        listen, http = fields["submit"], fields["http"]
        assert fields["subscribe"].startswith("127.0.0.1:")
        with urllib.request.urlopen(f"http://{http}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["upstream"] == dead and stats["validators"] == 4
        client = JsonRpcClient(listen, timeout=60.0)
        tx = base64.b64encode(b"cli tx").decode()
        assert client.call("Babble.SubmitTx", tx) == "unavailable"
        assert client.call("Babble.SubmitTx", tx) == "duplicate"
        client.close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        out = proc.stdout.read()
        reader.join(timeout=10)
        assert proc.returncode == 0, "".join(err_lines)
        final = json.loads(out.strip().splitlines()[-1])
        assert final["shards"] == 2 and final["processes"] is True
        assert final["submitted"] == 2 and final["forward_unavailable"] == 1
        assert final["replica"]["rejected_blocks"] == 0
        assert "hub" in final
        # both shard processes answered: one saw the transaction twice
        workers = sorted(final["workers"].values(),
                         key=lambda w: w["submitted"])
        assert [w["submitted"] for w in workers] == [0, 2]
        assert workers[1]["accepted"] == 1 and workers[1]["rejected_dup"] == 1
        assert final["workers_missing"] == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
        reader.join(timeout=10)
        dead_sock.close()
