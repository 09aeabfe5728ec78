"""The port's embedding binding (``babble_tpu_torch.mobile``) against the
JAX package's (``babble_tpu.mobile``).

- Two port MobileNodes over loopback TCP commit identical canonical-JSON
  blocks to their hosts. Their ports come from the OS (bound to port 0),
  never from a fixed range, so this file runs beside the JAX package's
  mobile test on another worker.
- One block through both packages' ``_MobileApp.commit_handler`` gives the
  same JSON string and the same ``CommitResponse`` (exact).
- ``accelerator=True`` asks for the card: without one the node raises at
  init (and reports it to the exception handler); with
  ``accelerator_device="cpu"`` the pair runs its offload on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import time

import pytest
import torch

from babble_tpu_torch.crypto.keyfile import SimpleKeyfile
from babble_tpu_torch.crypto.keys import PrivateKey
from babble_tpu_torch.mobile import MobileNode

KEY_SEEDS = (0x3A11, 0x3B22)


def _free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _datadirs(tmp_path, gossip_ports):
    keys = [PrivateKey(d) for d in KEY_SEEDS]
    peers = [{"NetAddr": f"127.0.0.1:{port}",
              "PubKeyHex": k.public_key.hex(), "Moniker": f"m{i}"}
             for i, (k, port) in enumerate(zip(keys, gossip_ports))]
    dirs = []
    for i, k in enumerate(keys):
        dd = os.path.join(str(tmp_path), f"m{i}")
        os.makedirs(dd)
        SimpleKeyfile(os.path.join(dd, "priv_key")).write_key(k)
        for fn in ("peers.json", "peers.genesis.json"):
            with open(os.path.join(dd, fn), "w") as f:
                json.dump(peers, f)
        dirs.append(dd)
    return dirs


def _state_hash(block_json: str) -> bytes:
    d = json.loads(block_json)
    return hashlib.sha256((str(d["Body"]["Index"])
                           + str(d["Body"]["Transactions"])).encode()).digest()


def _run_pair(tmp_path, target_block: int = 1, **overrides):
    """Two MobileNodes on OS-assigned ports, fed transactions until both
    pass ``target_block``. Returns (block JSON strings per node, state
    changes per node, errors, node 0's stats)."""
    ports = _free_ports(4)
    gossip, service = ports[:2], ports[2:]
    dirs = _datadirs(tmp_path, gossip)
    committed, states, errors = [[], []], [[], []], []

    def handler(i):
        def commit(block_json: str) -> bytes:
            committed[i].append(block_json)
            return _state_hash(block_json)
        return commit

    nodes = []
    try:
        for i, dd in enumerate(dirs):
            nodes.append(MobileNode(
                dd, handler(i), exception_handler=errors.append,
                state_change_handler=states[i].append,
                bind_addr=f"127.0.0.1:{gossip[i]}",
                service_addr=f"127.0.0.1:{service[i]}",
                heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                log_level="error", moniker=f"m{i}", **overrides))
        for n in nodes:
            n.run()
        deadline = time.monotonic() + 60
        i = 0
        while not all(n.get_last_block_index() >= target_block
                      for n in nodes):
            nodes[i % 2].submit_tx(f"mob tx {i}".encode())
            i += 1
            assert time.monotonic() < deadline, "mobile nodes never committed"
            time.sleep(0.01)
        return committed, states, errors, json.loads(nodes[0].get_stats())
    finally:
        for n in nodes:
            n.shutdown()


def _by_index(jsons):
    return {json.loads(j)["Body"]["Index"]: j for j in jsons}


def test_mobile_nodes_commit_identical_json_blocks(tmp_path):
    committed, states, errors, stats = _run_pair(tmp_path)
    a, b = _by_index(committed[0]), _by_index(committed[1])
    common = sorted(set(a) & set(b))
    assert common[:2] == [0, 1]
    for bi in common:
        assert a[bi] == b[bi]
    assert any("Babbling" in s for s in states[0]), states[0]
    assert not errors, errors
    assert stats["state"]


def _mobile_block(pkg: str):
    """A block with two transactions and one PEER_ADD internal
    transaction, built from fixed keys in package ``pkg``."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    keys = mod("crypto.keys")
    itx_mod = mod("hashgraph.internal_transaction")
    Peer = mod("peers.peer").Peer
    k = [keys.PrivateKey(d) for d in KEY_SEEDS]
    peer_set = mod("peers.peer_set").PeerSet(
        [Peer(f"127.0.0.1:{i}", key.public_key.hex(), f"m{i}")
         for i, key in enumerate(k)])
    newcomer = keys.PrivateKey(0x3C33)
    itx = itx_mod.InternalTransaction(itx_mod.InternalTransactionBody(
        itx_mod.TransactionType.PEER_ADD,
        Peer("127.0.0.1:9", newcomer.public_key.hex(), "new"), nonce=7))
    itx.sign(newcomer)
    block = mod("hashgraph.block").Block.new(
        4, 9, b"frame hash", peer_set, [b"tx one", b"tx two"], [itx], 1234)
    return block


def test_commit_handler_equal_across_packages():
    import babble_tpu.crypto.keys as jkeys
    import babble_tpu.mobile as jmobile
    import babble_tpu_torch.crypto.keys as pkeys
    import babble_tpu_torch.mobile as pmobile

    out = {}
    for pkg, mobile, keys in (("babble_tpu", jmobile, jkeys),
                              ("babble_tpu_torch", pmobile, pkeys)):
        prev = keys.set_deterministic_signing(True)
        try:
            block = _mobile_block(pkg)
        finally:
            keys.set_deterministic_signing(prev)
        seen, changes = [], []
        app = mobile._MobileApp(
            lambda j, seen=seen: seen.append(j) or _state_hash(j),
            None, changes.append)
        resp = app.commit_handler(block)
        app.state_change_handler("Babbling")
        out[pkg] = (seen, resp.state_hash,
                    [r.to_dict() for r in resp.receipts], changes,
                    app.snapshot_handler(4), app.restore_handler(b"x"))
    assert out["babble_tpu_torch"] == out["babble_tpu"]
    seen, state_hash, receipts = out["babble_tpu_torch"][:3]
    assert json.loads(seen[0])["Body"]["Index"] == 4
    assert state_hash == _state_hash(seen[0])
    assert len(receipts) == 1 and receipts[0]["Accepted"] is True


def test_commit_handler_fault_stays_on_the_host_side():
    import babble_tpu.mobile as jmobile
    import babble_tpu_torch.mobile as pmobile

    out = {}
    for pkg, mobile in (("babble_tpu", jmobile),
                        ("babble_tpu_torch", pmobile)):
        errors = []

        def boom(_json):
            raise RuntimeError("host app failed")

        resp = mobile._MobileApp(boom, errors.append, None).commit_handler(
            _mobile_block(pkg))
        out[pkg] = (errors, resp.state_hash, len(resp.receipts))
    assert out["babble_tpu_torch"] == out["babble_tpu"]
    assert out["babble_tpu_torch"] == (["host app failed"], b"", 1)


def test_accelerator_mobile_node_raises_without_a_card(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gossip = _free_ports(1)[0]
    dd = _datadirs(tmp_path, [gossip, _free_ports(1)[0]])[0]
    errors = []
    with pytest.raises(RuntimeError, match="CUDA"):
        MobileNode(dd, _state_hash, exception_handler=errors.append,
                   bind_addr=f"127.0.0.1:{gossip}", log_level="error",
                   accelerator=True)
    assert len(errors) == 1 and errors[0].startswith("init: ")


def test_accelerator_mobile_nodes_on_the_cpu(tmp_path, monkeypatch):
    """``accelerator_device="cpu"`` runs the offload on the CPU: the pair
    commits identical blocks, with device sweeps (min_window 0, since two
    validators' windows stay below the default) and no fallback."""
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")
    committed, _, errors, stats = _run_pair(
        tmp_path, accelerator=True, accelerator_device="cpu")
    a, b = _by_index(committed[0]), _by_index(committed[1])
    common = sorted(set(a) & set(b))
    assert common[:2] == [0, 1]
    assert all(a[bi] == b[bi] for bi in common)
    assert not errors, errors
    assert stats["consensus_engine"] == "device"
    assert stats["accel_sweeps"] > 0 and stats["accel_fallbacks"] == 0
