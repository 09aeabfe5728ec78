"""Twins of tests/test_adversarial.py: hostile sync payloads against the
port's node, core and sentry (``babble_tpu_torch/node/sentry.py``), held
against the JAX package's on the same inputs.

Each case of the reference runs here on the port. Where its outcome is
deterministic, the same scenario also runs through ``babble_tpu`` and
the two must agree exactly: the rejection's class and error, the node's
state after it, every sentry score, cause count, quarantine state and
counter, and ``EquivocationProof.to_dict()`` byte for byte. Keys come from
``sim_key(seed, i)`` and signing is RFC 6979 on both sides, so both
packages build and sign the same events. A proof minted by either
package verifies in the other. The live cases (the junk flood and the
wrong-key flood) are not deterministic; they run on the port alone, on
the host oracle and with the consensus offload on the CPU
(``accelerator=True, accelerator_device="cpu"``).
"""

from __future__ import annotations

import importlib
import threading
import time

import pytest

PKGS = ("babble_tpu", "babble_tpu_torch")
SEED = 23
BYZ_FROM = 999  # the from_id a hostile push claims


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def deterministic_signing():
    prev = [_m(p, "crypto.keys").set_deterministic_signing(True)
            for p in PKGS]
    yield
    for p, v in zip(PKGS, prev):
        _m(p, "crypto.keys").set_deterministic_signing(v)


def _key(pkg: str, i: int):
    """Key #i of SEED, the same scalar in either package."""
    d = _m("babble_tpu_torch", "sim.harness").sim_key(SEED, i).d
    return _m(pkg, "crypto.keys").PrivateKey(d)


def _event(pkg: str, txs, parents, key, index: int, signer=None):
    ev = _m(pkg, "hashgraph.event").Event.new(
        txs, [], [], parents, key.public_key.bytes(), index)
    ev.sign(signer or key)
    return ev


def _cluster(pkg: str, n: int, **conf_kw):
    """n nodes of ``pkg`` on one inmem network, keyed by _key(pkg, 0..n-1)
    (tests/test_node.py::make_cluster with fixed keys)."""
    Config = _m(pkg, "config.config").Config
    Node = _m(pkg, "node.node").Node
    Validator = _m(pkg, "node.validator").Validator
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    InmemStore = _m(pkg, "hashgraph.store").InmemStore
    InmemProxy = _m(pkg, "proxy.proxy").InmemProxy
    DummyState = _m(pkg, "dummy.state").State
    network = _m(pkg, "net.inmem").InmemNetwork()
    keys = [_key(pkg, i) for i in range(n)]
    peers = PeerSet([Peer(f"inmem://node{i}", k.public_key.hex(), f"node{i}")
                     for i, k in enumerate(keys)])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}
    nodes, proxies = [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                      moniker=f"node{i}", log_level="warning", **conf_kw)
        proxy = InmemProxy(DummyState())
        node = Node(conf, Validator(k, f"node{i}"), peers, peers,
                    InmemStore(conf.cache_size),
                    network.new_transport(addr_of[k.public_key.hex()]),
                    proxy)
        node.init()
        nodes.append(node)
        proxies.append(proxy)
    return nodes, proxies


def _shutdown(nodes) -> None:
    for n in nodes:
        n.shutdown()


def _eager(pkg: str, node, events, from_id: int = BYZ_FROM):
    rpc_mod = _m(pkg, "net.rpc")
    rpc = rpc_mod.RPC(rpc_mod.EagerSyncRequest(from_id, events))
    node._process_rpc(rpc)
    return rpc.wait(timeout=5)


def _sentry_state(sentry, live: bool = False) -> dict:
    """Everything a sentry decided. A live node's sentry runs on the real
    clock, so its decayed scores and remaining quarantine time depend on
    timing: ``live`` leaves those two out (causes, quarantine states and
    counts, counters and proofs stay)."""
    peers = sentry.suspects()["peers"]
    if live:
        peers = {pid: {k: v for k, v in rec.items()
                       if k not in ("score", "quarantine_remaining_s")}
                 for pid, rec in peers.items()}
    return {"stats": sentry.stats(), "peers": peers,
            "proofs": [p.to_dict() for p in sentry.proofs()]}


def _both(scenario):
    """``scenario(pkg)`` through each package; the two results equal."""
    jax, port = (scenario(p) for p in PKGS)
    assert port == jax
    return port


def _junk(pkg: str, creator_id: int, index: int, self_parent: int,
          sig: str = "1|1", txs=(b"evil",)):
    ev = _m(pkg, "hashgraph.event")
    return ev.WireEvent(body=ev.WireBody(
        transactions=list(txs), creator_id=creator_id, index=index,
        self_parent_index=self_parent, other_parent_index=-1),
        signature=sig)


def _node_outcome(node, resp, err) -> dict:
    return {"success": resp.success if resp is not None else None,
            "err": err, "topo": node.core.hg.topological_index,
            "sentry": _sentry_state(node.core.sentry, live=True)}


# -- the insert path's rejection classes ------------------------------------


def test_unknown_creator_id_rejected():
    def scenario(pkg):
        nodes, _ = _cluster(pkg, 2)
        try:
            nodes[0].run_async(gossip=False)
            resp, err = _eager(pkg, nodes[0],
                               [_junk(pkg, 0xDEADBEEF, 0, -1)])
            return _node_outcome(nodes[0], resp, err)
        finally:
            _shutdown(nodes)

    out = _both(scenario)
    assert out["err"] is not None and "not found" in out["err"]
    assert out["success"] is False and out["topo"] == 0
    assert out["sentry"]["stats"]["sentry_rejects_unknown_creator"] == 1


def test_bad_signature_event_rejected():
    def scenario(pkg):
        nodes, _ = _cluster(pkg, 2)
        try:
            nodes[0].run_async(gossip=False)
            victim = next(iter(nodes[0].core.peers.peers))
            forged = _m(pkg, "hashgraph.event").Event.new(
                [b"forged tx"], [], [], ["", ""], victim.pub_key_bytes(), 0)
            forged.sign(_key(pkg, 7))  # not the claimed creator's key
            nodes[0].core.hg.set_wire_info(forged)
            resp, err = _eager(pkg, nodes[0], [forged.to_wire()])
            out = _node_outcome(nodes[0], resp, err)
            out["victim_slot"] = nodes[0].core.known_events()[victim.id]
            return out
        finally:
            _shutdown(nodes)

    out = _both(scenario)
    assert out["err"] is not None and out["topo"] == 0
    assert out["victim_slot"] == -1
    assert out["sentry"]["stats"]["sentry_rejects_invalid_signature"] == 1
    assert out["sentry"]["peers"][str(BYZ_FROM)]["causes"] == {
        "invalid_signature": 1}


def test_out_of_order_parent_index_rejected():
    def scenario(pkg):
        nodes, _ = _cluster(pkg, 2)
        try:
            nodes[0].run_async(gossip=False)
            victim = next(iter(nodes[0].core.peers.peers))
            resp, err = _eager(pkg, nodes[0],
                               [_junk(pkg, victim.id, 7, 6, txs=())])
            return _node_outcome(nodes[0], resp, err)
        finally:
            _shutdown(nodes)

    out = _both(scenario)
    assert out["err"] is not None and out["topo"] == 0
    assert out["sentry"]["stats"]["sentry_rejects_unknown_parent"] == 1


def _flood_cluster(accelerator: bool, flood_once):
    """3 port nodes (with the offload on the CPU when ``accelerator``)
    committing to block 2 while ``flood_once(nodes, i)`` runs every 5-10
    ms on a thread; returns the nodes, still running."""
    from test_torch_node import bombard_and_wait, check_gossip

    kw = ({"accelerator": True, "accelerator_device": "cpu"}
          if accelerator else {})
    nodes, proxies = _cluster("babble_tpu_torch", 3, **kw)
    for n in nodes:
        n.run_async()
    stop = threading.Event()

    def flood():
        i = 0
        while not stop.is_set():
            try:
                flood_once(nodes, i)
            except Exception:
                pass
            i += 1
            time.sleep(0.005)

    t = threading.Thread(target=flood, daemon=True)
    t.start()
    try:
        bombard_and_wait(nodes, proxies, target_block=2, timeout=90.0)
    finally:
        stop.set()
        t.join(timeout=5)
    check_gossip(nodes, 2)
    if accelerator:
        for n in nodes:
            stats = n.get_stats_snapshot()
            assert stats["consensus_engine"] == "device"
            assert stats["accel_sweeps"] > 0
            assert stats["accel_fallbacks"] == 0
    return nodes


@pytest.mark.parametrize("accelerator", [False, True],
                         ids=["oracle", "cpu-offload"])
def test_cluster_survives_junk_flood_under_load(accelerator, monkeypatch):
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")  # every window swept
    pkg = "babble_tpu_torch"

    def junk(nodes, i):
        _eager(pkg, nodes[0], [_junk(pkg, 0xBAD0 + (i % 7), i, i - 1,
                                     sig="2|3", txs=[f"junk {i}".encode()])])

    nodes = _flood_cluster(accelerator, junk)
    try:
        for bi in range(3):
            for tx in nodes[0].get_block(bi).transactions():
                assert not tx.startswith(b"junk"), "junk tx reached a block"
        assert nodes[0].core.sentry.rejects.get("unknown_creator", 0) > 0
    finally:
        _shutdown(nodes)


@pytest.mark.parametrize("accelerator", [False, True],
                         ids=["oracle", "cpu-offload"])
def test_wrong_key_flood_drives_quarantine_without_stalling_gossip(
        accelerator, monkeypatch):
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")  # every window swept
    pkg = "babble_tpu_torch"
    mallory_id = 424242
    mallory = _key(pkg, 9)

    def forge(nodes, i):
        victim = next(iter(nodes[0].core.peers.peers))
        forged = _m(pkg, "hashgraph.event").Event.new(
            [f"forged {i}".encode()], [], [], ["", ""],
            victim.pub_key_bytes(), 0)
        forged.sign(mallory)
        nodes[0].core.hg.set_wire_info(forged)
        _eager(pkg, nodes[0], [forged.to_wire()], mallory_id)
        time.sleep(0.005)

    nodes = _flood_cluster(accelerator, forge)
    try:
        victim = next(iter(nodes[0].core.peers.peers))
        sentry = nodes[0].core.sentry
        assert sentry.rejects.get("invalid_signature", 0) > 0
        assert sentry.is_quarantined(mallory_id)
        assert not sentry.is_quarantined(victim.id)
        stats = nodes[0].get_stats()
        assert int(stats["sentry_rejects_invalid_signature"]) > 0
        assert int(stats["sentry_quarantines_total"]) >= 1
    finally:
        _shutdown(nodes)


# -- equivocation proofs ------------------------------------------------------


def _forked_pair(pkg: str, key, store):
    """A second signed event at (creator, 0) raises ForkError."""
    Hashgraph = _m(pkg, "hashgraph.hashgraph").Hashgraph
    ForkError = _m(pkg, "hashgraph.errors").ForkError
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    h = Hashgraph(store)
    h.init(PeerSet([Peer("inmem://solo", key.public_key.hex(), "solo")]))
    h.insert_event(_event(pkg, [b"first"], ["", ""], key, 0))
    with pytest.raises(ForkError) as ei:
        h.insert_event(_event(pkg, [b"second"], ["", ""], key, 0))
    return ei.value


def _fixed_sentry(pkg: str, **kw):
    now = [0.0]
    sentry = _m(pkg, "node.sentry").Sentry(
        clock=lambda: now[0], wall_clock=lambda: 1700000000.0, **kw)
    return sentry, now


def test_equivocation_proof_roundtrip_survives_restart(tmp_path):
    def scenario(pkg):
        PersistentStore = _m(pkg, "hashgraph.persistent_store") \
            .PersistentStore
        db = str(tmp_path / f"{pkg}.db")
        store = PersistentStore(cache_size=100, path=db)
        err = _forked_pair(pkg, _key(pkg, 0), store)
        assert err.existing is not None
        sentry, _ = _fixed_sentry(pkg)
        sentry.attach_store(store)
        cause = sentry.observe_rejection(err, from_id=42)
        proofs = [p.to_dict() for p in sentry.proofs()]
        quarantined = sentry.is_quarantined(42)
        store.close()
        store2 = PersistentStore(cache_size=100, path=db)
        sentry2 = _m(pkg, "node.sentry").Sentry()
        sentry2.attach_store(store2)
        reloaded = sentry2.proofs()
        a, b = reloaded[0].events()
        out = {"cause": cause, "proofs": proofs, "quarantined": quarantined,
               "reloaded": [p.to_dict() for p in reloaded],
               "verify": [p.verify() for p in reloaded],
               "slots": (a.creator() == b.creator(), a.index() == b.index(),
                         a.hex() != b.hex())}
        store2.close()
        return out

    out = _both(scenario)
    assert out["cause"] == "fork" and out["quarantined"]
    assert len(out["proofs"]) == 1 and out["reloaded"] == out["proofs"]
    assert out["verify"] == [True] and out["slots"] == (True, True, True)


def test_proofs_minted_by_either_package_verify_in_the_other():
    minted = {}
    for pkg in PKGS:
        Sentry = _m(pkg, "node.sentry")
        key = _key(pkg, 1)
        a = _event(pkg, [b"a"], ["", ""], key, 3)
        b = _event(pkg, [b"b"], ["", ""], key, 3)
        minted[pkg] = Sentry.EquivocationProof.from_events(a, b, 1700000000)
    assert (minted["babble_tpu"].to_dict()
            == minted["babble_tpu_torch"].to_dict())
    for src, dst in (PKGS, PKGS[::-1]):
        proof = _m(dst, "node.sentry").EquivocationProof.from_dict(
            minted[src].to_dict())
        assert proof.verify()
        assert proof.key() == minted[src].key()
        forged = dict(minted[src].to_dict())
        forged["event_b"] = dict(forged["event_b"],
                                 Signature=forged["event_a"]["Signature"])
        assert not _m(dst, "node.sentry").EquivocationProof.from_dict(
            forged).verify()


def test_proof_ledger_capped_per_creator():
    def scenario(pkg):
        sentry_mod = _m(pkg, "node.sentry")
        sentry, _ = _fixed_sentry(pkg)
        key = _key(pkg, 2)
        added = []
        for i in range(sentry_mod.MAX_PROOFS_PER_CREATOR + 3):
            a = _event(pkg, [b"a"], ["", ""], key, i)
            b = _event(pkg, [b"b"], ["", ""], key, i)
            added.append(sentry.add_proof(
                sentry_mod.EquivocationProof.from_events(a, b, 1700000000)))
        return {"added": added, "cap": sentry_mod.MAX_PROOFS_PER_CREATOR,
                "state": _sentry_state(sentry)}

    out = _both(scenario)
    cap = out["cap"]
    assert out["added"] == [True] * cap + [False] * 3
    assert len(out["state"]["proofs"]) == cap


def test_proof_verify_rejects_tampering():
    def scenario(pkg):
        EquivocationProof = _m(pkg, "node.sentry").EquivocationProof
        key = _key(pkg, 3)
        e = _event(pkg, [b"x"], ["", ""], key, 0)
        other = _event(pkg, [b"y"], ["", ""], key, 0, signer=_key(pkg, 4))
        return [EquivocationProof.from_events(e, e, 0).verify(),
                EquivocationProof.from_events(e, other, 0).verify()]

    assert _both(scenario) == [False, False]


# -- scoring, quarantine expiry, the framing guard ---------------------------


def _peer_set(pkg: str, n: int, base: int = 10):
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    return PeerSet([Peer(f"inmem://n{i}", _key(pkg, base + i).public_key
                         .hex(), f"n{i}") for i in range(n)])


def test_quarantine_expiry_readmits_falsely_flagged_peer():
    def scenario(pkg):
        sentry, now = _fixed_sentry(pkg, threshold=4.0, quarantine_s=10.0,
                                    decay_halflife_s=1e9)
        peers = _peer_set(pkg, 3)
        ids = [p.id for p in peers.peers]
        sel = _m(pkg, "node.peer_selector").RandomPeerSelector(
            peers, ids[0], quarantine_check=sentry.is_quarantined,
            clock=lambda: now[0])
        out = {"strikes": [sentry.record(ids[1], "garbage")
                           for _ in range(2)],
               "quarantined": sentry.is_quarantined(ids[1])}
        out["picks"] = {sel.next().id for _ in range(20)}
        out["skips"] = sel.quarantine_skips > 0
        now[0] = 10.5
        out["after"] = (sentry.is_quarantined(ids[1]),
                        _sentry_state(sentry))
        out["readmitted"] = ids[1] in {sel.next().id for _ in range(50)}
        out["ids"] = ids
        return out

    out = _both(scenario)
    ids = out["ids"]
    assert out["strikes"] == [False, True] and out["quarantined"]
    assert out["picks"] == {ids[2]} and out["skips"]
    assert out["after"][0] is False
    assert out["after"][1]["peers"][str(ids[1])]["score"] == 0.0
    assert out["after"][1]["stats"]["sentry_readmissions"] >= 1
    assert out["readmitted"]


def test_framing_guard_caps_spoofable_quarantines_at_bft_f():
    def scenario(pkg):
        sentry, _ = _fixed_sentry(pkg, threshold=2.0, quarantine_s=30.0)
        sentry.set_peer_count(5)  # f = 1
        out = {"first": [sentry.record(1, "oversized_sync"),
                         sentry.record(2, "oversized_sync"),
                         sentry.record(3, "fork")],
               "state": _sentry_state(sentry)}
        s2, _ = _fixed_sentry(pkg, threshold=2.0, quarantine_s=30.0)
        s2.set_peer_count(5)
        out["second"] = [s2.record(10, "fork"),
                         s2.record(11, "oversized_sync"),
                         s2.is_quarantined(10), s2.is_quarantined(11)]
        peers = _peer_set(pkg, 3, base=20)
        ids = [p.id for p in peers.peers]
        sel = _m(pkg, "node.peer_selector").RandomPeerSelector(
            peers, ids[0], quarantine_check=lambda pid: True,
            clock=lambda: 0.0)
        out["floor"] = (sel.next() is not None,
                        sel.quarantine_overrides >= 1)
        return out

    out = _both(scenario)
    assert out["first"] == [True, False, True]
    assert out["state"]["stats"]["sentry_quarantine_deferrals"] == 1
    assert out["second"] == [True, True, True, True]
    assert out["floor"] == (True, True)


def test_invalid_signature_not_scored_when_fork_adjacent():
    def scenario(pkg):
        sentry_mod = _m(pkg, "node.sentry")
        InvalidSignatureError = _m(pkg, "hashgraph.errors") \
            .InvalidSignatureError
        forker, honest = _key(pkg, 5), _key(pkg, 6)
        sentry, _ = _fixed_sentry(pkg)
        a = _event(pkg, [b"a"], ["", ""], forker, 0)
        b = _event(pkg, [b"b"], ["", ""], forker, 0)
        sentry.add_proof(sentry_mod.EquivocationProof.from_events(
            a, b, 1700000000))
        ev = _event(pkg, [b"fine"], ["", a.hex()], honest, 3)
        sentry.set_creator_resolver(
            lambda pub: 777 if pub == a.creator() else None)
        ev.body.other_parent_creator_id = 777
        first = sentry.observe_rejection(
            InvalidSignatureError("cross-branch mismatch", event=ev), 555)
        adjacent = _sentry_state(sentry)
        plain = _event(pkg, [b"x"], ["", ""], honest, 0, signer=_key(pkg, 8))
        sentry.observe_rejection(InvalidSignatureError("forged", event=plain),
                                 555)
        return {"first": first, "adjacent": adjacent,
                "after": _sentry_state(sentry)}

    out = _both(scenario)
    assert out["first"] == "invalid_signature"
    assert out["adjacent"]["stats"][
        "sentry_rejects_invalid_signature_fork_adjacent"] == 1
    assert "555" not in out["adjacent"]["peers"]
    assert "555" in out["after"]["peers"]


def test_fork_quarantine_without_evidence_is_not_proven():
    def scenario(pkg):
        ForkError = _m(pkg, "hashgraph.errors").ForkError
        twin = _event(pkg, [b"b"], ["", ""], _key(pkg, 0), 0)
        sentry, _ = _fixed_sentry(pkg, threshold=2.0)
        sentry.set_peer_count(5)
        cause = sentry.observe_rejection(
            ForkError(twin.creator(), 0, None, twin), from_id=9)
        return {"cause": cause, "q9": sentry.is_quarantined(9),
                "proofs": len(sentry.proofs()),
                "r10": sentry.record(10, "oversized_sync"),
                "state": _sentry_state(sentry)}

    out = _both(scenario)
    assert out["cause"] == "fork" and out["q9"] and out["proofs"] == 0
    assert out["r10"] is False
    assert out["state"]["stats"]["sentry_quarantine_deferrals"] == 1


def test_misbehavior_ledger_bounded_under_id_rotation():
    def scenario(pkg):
        MAX_RECORDS = _m(pkg, "node.sentry").MAX_RECORDS
        sentry, _ = _fixed_sentry(pkg, threshold=4.0)
        sentry.record(7, "fork")
        for i in range(1000, 1000 + MAX_RECORDS + 500):
            sentry.record(i, "unknown_creator")
        return {"n": len(sentry._records), "cap": MAX_RECORDS,
                "kept": 7 in sentry._records,
                "q7": sentry.is_quarantined(7),
                "stats": sentry.stats()}

    out = _both(scenario)
    assert out["n"] <= out["cap"] and out["kept"] and out["q7"]


def test_scores_decay_between_offences():
    def scenario(pkg):
        sentry, now = _fixed_sentry(pkg, threshold=4.0, quarantine_s=10.0,
                                    decay_halflife_s=1.0)
        out = []
        for _ in range(10):
            out.append(sentry.record(5, "garbage"))
            now[0] += 5.0
        return {"records": out, "q": sentry.is_quarantined(5),
                "state": _sentry_state(sentry)}

    out = _both(scenario)
    assert out["records"] == [False] * 10 and not out["q"]


# -- the core's batch semantics and the receiving-side cap ------------------


def _init_cores(pkg: str, n: int, **core_kw):
    """tests/test_core.py::init_cores with keys _key(pkg, 0..n-1)."""
    Core = _m(pkg, "node.core").Core
    Validator = _m(pkg, "node.validator").Validator
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    InmemStore = _m(pkg, "hashgraph.store").InmemStore
    dummy = _m(pkg, "proxy.proxy").dummy_commit_response
    keys = [_key(pkg, i) for i in range(n)]
    pirs = [Peer("", k.public_key.hex(), "") for k in keys]
    ps = PeerSet(pirs)
    key_of = {k.public_key.id(): k for k in keys}
    cores = []
    for peer in ps.peers:
        core = Core(Validator(key_of[peer.id], ""), ps, PeerSet(list(pirs)),
                    InmemStore(1000), dummy, **core_kw)
        core.sign_and_insert_self_event(_m(pkg, "hashgraph.event").Event.new(
            [], [], [], ["", ""], core.validator.key.public_key.bytes(), 0,
            timestamp=1700000000))
        cores.append(core)
    return cores


@pytest.mark.parametrize("offload", [False, True], ids=["oracle",
                                                         "cpu-offload"])
def test_fork_in_batch_does_not_block_later_events(offload, monkeypatch):
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")

    def scenario(pkg):
        kw = {}
        if offload and pkg == "babble_tpu_torch":
            kw = {"accelerated_verify": True, "accelerator_device": "cpu"}
        cores = _init_cores(pkg, 2, **kw)
        ForkError = _m(pkg, "hashgraph.errors").ForkError
        cores[0].add_self_event("")
        id0 = cores[0].validator.id()
        wires = list(cores[0].to_wire(
            cores[0].event_diff(cores[1].known_events())))
        twin = _event(pkg, [b"twin"], ["", ""], cores[0].validator.key, 0)
        cores[0].hg.set_wire_info(twin)
        with pytest.raises(ForkError) as ei:
            cores[1].sync(id0, [wires[0], twin.to_wire(), wires[1]])
        sentry = cores[1].sentry
        cause = sentry.observe_rejection(ei.value, from_id=id0)
        return {"n_wires": len(wires), "known": cores[1].known_events()[id0],
                "cause": cause,
                "proof_keys": [p.key() for p in sentry.proofs()],
                "stats": sentry.stats()}

    out = _both(scenario)
    assert out["n_wires"] == 2 and out["known"] == 1
    assert out["cause"] == "fork" and len(out["proof_keys"]) == 1


def test_oversized_eager_sync_truncated_and_scored():
    def scenario(pkg):
        nodes, _ = _cluster(pkg, 2)
        try:
            node = nodes[0]
            node.run_async(gossip=False)
            limit = node.conf.sync_limit

            def batch(n):
                return [_junk(pkg, 0xBEEF, i, i - 1, txs=[b"owt"])
                        for i in range(n)]

            out = {}
            resp, err = _eager(pkg, node, batch(limit + 5))
            out["mild"] = (err is not None, node.sync_limit_truncations,
                           node.get_stats()["sync_limit_truncations"],
                           node.core.sentry.rejects.get("oversized_sync"))
            huge = batch(2 * limit + 5)
            _eager(pkg, node, huge)
            out["egregious"] = node.core.sentry.rejects.get("oversized_sync")
            for _ in range(4):
                _eager(pkg, node, huge)
            out["quarantined"] = node.core.sentry.is_quarantined(BYZ_FROM)
            before = node.sync_limit_truncations
            resp, err = _eager(pkg, node, huge)
            out["refused"] = (err is not None and "quarantined" in err,
                              node.sync_limit_truncations == before,
                              node.core.sentry.refused_rpcs)
            out["sentry"] = _sentry_state(node.core.sentry, live=True)
            return out
        finally:
            _shutdown(nodes)

    out = _both(scenario)
    assert out["mild"] == (True, 1, "1", None)
    assert out["egregious"] == 1
    assert out["quarantined"]
    assert out["refused"][:2] == (True, True) and out["refused"][2] >= 1


@pytest.mark.parametrize("offload", [False, True], ids=["oracle",
                                                         "cpu-offload"])
def test_fork_evidence_survives_a_later_rejection_in_the_batch(offload,
                                                               monkeypatch):
    """A fork lost to a later error in the batch (ROADMAP Queue C), found
    by the storm twin with the offload: an honest peer holding branch Y of a fork relays Y and then
    its own event on Y to a node that already holds branch X. Y raises a
    ForkError, which the batch collects; the honest event then fails
    verification against X, and that error ends the batch. The node
    observes only the error it raises, so without R1 the fork was never
    observed: no proof, the equivocator unscored, and the honest relayer
    scored for invalid_signature (split-brain equivocation made a node
    quarantine two honest peers, fill the framing cap and defer the
    wrong-key flooder's quarantine). With R1 the core observes the first
    collected fork before the error propagates: the proof is on file, so
    the relayer's failure counts as fork-adjacent and is not scored. The
    JAX package's ``Core.sync`` shares the fault (the same scenario there
    ends with no proof and the relayer scored); it is not edited."""
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")
    pkg = "babble_tpu_torch"
    kw = ({"accelerated_verify": True, "accelerator_device": "cpu"}
          if offload else {})
    eq, a, b = _init_cores(pkg, 3, **kw)
    Event = _m(pkg, "hashgraph.event").Event
    branches = []
    for tx in (b"X", b"Y"):
        ev = Event.new([tx], [], [], [eq.head, ""],
                       eq.validator.public_key_bytes(), 1,
                       timestamp=1700000001)
        ev.sign(eq.validator.key)
        eq.hg.set_wire_info(ev)
        branches.append(ev)
    x, y = branches
    e0 = list(eq.to_wire(eq.event_diff(b.known_events())))
    b.sync(eq.validator.id(), e0)
    a.sync(eq.validator.id(), e0 + [y.to_wire()])
    a.add_self_event(y.hex())
    batch = list(a.to_wire(a.event_diff(b.known_events())))
    assert any(w.body.creator_id == eq.validator.id() for w in batch)
    b.sync(eq.validator.id(), [x.to_wire()])  # X reaches b first
    InvalidSignatureError = _m(pkg, "hashgraph.errors").InvalidSignatureError
    with pytest.raises(InvalidSignatureError) as ei:
        b.sync(a.validator.id(), batch)
    assert b.sentry.observe_rejection(ei.value, a.validator.id()) == \
        "invalid_signature"
    proofs = b.sentry.proofs()
    assert len(proofs) == 1 and proofs[0].verify()
    peers = b.sentry.suspects()["peers"]
    assert peers[str(eq.validator.id())]["causes"] == {"fork": 1}
    assert b.sentry.is_quarantined(eq.validator.id())
    assert str(a.validator.id()) not in peers
    assert b.sentry.rejects["invalid_signature_fork_adjacent"] == 1
