"""The port's traceview against the JAX package's (twins of the traceview
tests of tests/test_trace.py on babble_tpu_torch.obs.traceview): a live
4-node TCP cluster of port nodes whose committed transaction merges into a
multi-hop timeline over the port services' HTTP routes, the trace context
over the port's async binary transport, and the CLI over saved exports.
``merge_tx``, ``merge_all``, ``render`` and ``attribution_summary`` give
the reference's output on the same exports."""

from __future__ import annotations

import hashlib
import json
import time
import urllib.error
import urllib.request

import pytest

from babble_tpu.obs import traceview as ref_traceview
from babble_tpu_torch.config.config import Config
from babble_tpu_torch.crypto.keys import generate_key
from babble_tpu_torch.dummy.state import State as DummyState
from babble_tpu_torch.hashgraph.store import InmemStore
from babble_tpu_torch.node.node import Node
from babble_tpu_torch.node.validator import Validator
from babble_tpu_torch.obs import traceview
from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet
from babble_tpu_torch.proxy.proxy import InmemProxy


def _txid(tx: bytes) -> str:
    return hashlib.sha256(tx).hexdigest()


def _same_as_reference(exports, merged_list) -> None:
    """The pure functions give the reference's output on these exports."""
    exports = json.loads(json.dumps(exports))
    assert traceview.merge_all(exports) == ref_traceview.merge_all(exports)
    for m in merged_list:
        assert m == ref_traceview.merge_tx(m["txid"], exports)
        assert traceview.render(m) == ref_traceview.render(m)
    assert (traceview.attribution_summary(merged_list)
            == ref_traceview.attribution_summary(merged_list))


# -- cluster helpers --------------------------------------------------------


def _make_cluster(n: int, transports, conf_extra=None) -> tuple:
    keys = [generate_key() for _ in range(n)]
    addrs = [t.advertise_addr() for t in transports]
    peers = PeerSet(
        [Peer(addrs[i], k.public_key.hex(), f"t{i}")
         for i, k in enumerate(keys)]
    )
    nodes, proxies, states = [], [], []
    for i, k in enumerate(keys):
        conf = Config(
            heartbeat_timeout=0.01,
            slow_heartbeat_timeout=0.2,
            moniker=f"t{i}",
            log_level="error",
            trace_sample=1.0,
            **(conf_extra or {}),
        )
        st = DummyState()
        pr = InmemProxy(st)
        node = Node(conf, Validator(k, f"t{i}"), peers, peers,
                    InmemStore(conf.cache_size), transports[i], pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
        states.append(st)
    return nodes, proxies, states


def _wait_commit(states, tx: bytes, deadline_s: float = 60.0) -> None:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if all(tx in st.committed_txs for st in states):
            return
        time.sleep(0.02)
    raise AssertionError(f"{tx!r} did not commit everywhere in time")


@pytest.mark.trace
def test_cluster_trace_merges_multi_hop_over_http():
    """4-node TCP cluster with HTTP services, every tx traced: the
    committed transaction's per-node /trace/<txid> records merge into
    one timeline with admit -> self-event -> >= 2 gossip hops (monotone
    first-seen stamps) -> commit on every node, with per-hop latency
    attribution; /traces bulk + traceview.merge_all cover the same
    ground."""
    from babble_tpu_torch.net.tcp import TCPTransport
    from babble_tpu_torch.service.service import Service

    transports = [
        TCPTransport("127.0.0.1:0", max_pool=2, timeout=5.0)
        for _ in range(4)
    ]
    for t in transports:
        t.listen()  # resolve ephemeral ports before building the peerset
    nodes, proxies, states = _make_cluster(4, transports)
    services = []
    try:
        for n in nodes:
            srv = Service("127.0.0.1:0", n, logger=None)
            srv.serve_async()
            services.append(srv)
        for n in nodes:
            n.run_async()
        tx = b"traced tx 1"
        assert proxies[0].submit_tx(tx) == "accepted"
        _wait_commit(states, tx)
        txid = _txid(tx)

        exports = []
        for srv in services:
            exp = traceview.fetch_node(srv.bind_addr, txid=txid)
            if exp is not None:
                exports.append(exp)
        assert len(exports) == 4, "every node should hold the record"
        merged = traceview.merge_tx(txid, exports)
        assert merged is not None
        assert merged["origin"] == nodes[0].get_id()
        assert merged["admit"] is not None and merged["drain"] is not None
        # every non-origin node is one gossip hop; >= 2 prove multi-hop
        assert len(merged["hops"]) >= 2, merged
        assert merged["monotone"], merged
        assert merged["committed_on"] == 4
        assert merged["block"] is not None
        assert merged["round_received"] is not None
        assert merged["e2e_s"] is not None and merged["e2e_s"] >= 0
        # attribution: every hop carries the insert split; at least one
        # eager-pushed hop carries wire+queue from the carried context
        assert all(h["insert_s"] is not None for h in merged["hops"])
        assert all(
            h["consensus_s"] is not None and h["consensus_s"] >= 0
            for h in merged["hops"]
        )
        # the human renderer and the attribution summary both run
        text = traceview.render(merged)
        assert txid[:16] in text and "hop1" in text
        summary = traceview.attribution_summary([merged])
        assert summary["insert"]["n"] >= 2
        assert summary["e2e"]["n"] == 1

        # bulk export + merge_all (what --nodes scraping does)
        bulk = [
            traceview.fetch_node(srv.bind_addr, limit=64)
            for srv in services
        ]
        merged_all = traceview.merge_all(bulk)
        assert any(m["txid"] == txid for m in merged_all)
        _same_as_reference(exports, [merged])
        _same_as_reference(bulk, merged_all)

        # /trace of an unknown txid is a clean 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://{services[0].bind_addr}/trace/{'0' * 64}",
                timeout=5.0,
            )
        assert ei.value.code == 404

        # live contexts were actually carried on the wire
        assert sum(n.trace_ctx_rpcs for n in nodes) > 0
    finally:
        for srv in services:
            srv.shutdown()
        for n in nodes:
            n.shutdown()


@pytest.mark.trace
def test_trace_attribution_survives_async_binary_transport():
    """Provenance must survive the binary wire: a 2-node cluster on
    the event-driven selector transport (`--transport async`) with the
    BINARY framed codec negotiated carries the trace context end to
    end — the remote hop's wire/queue/insert attribution is present
    after merge, not just on the legacy JSON framing."""
    from babble_tpu_torch.net.atcp import AsyncTCPTransport
    from babble_tpu_torch.net.codec import CODEC_STATS

    transports = [
        AsyncTCPTransport("127.0.0.1:0", timeout=5.0) for _ in range(2)
    ]
    for t in transports:
        t.listen()  # resolve ephemeral ports before the peerset
    decoded_before = CODEC_STATS.events_decoded
    nodes, proxies, states = _make_cluster(
        2, transports, conf_extra={"transport": "async"}
    )
    try:
        for n in nodes:
            n.run_async()

        def merged_trace(tx: bytes):
            _wait_commit(states, tx)
            txid = _txid(tx)
            exports = []
            for i, n in enumerate(nodes):
                rec = n.get_trace(txid)
                assert rec is not None, f"node {i} holds no record"
                exports.append(
                    {"node": n.get_id(), "moniker": f"t{i}",
                     "records": [rec]}
                )
            m = traceview.merge_tx(txid, exports)
            _same_as_reference(exports, [m])
            assert m is not None and m["monotone"], m
            assert m["committed_on"] == 2
            assert len(m["hops"]) == 1, m
            return m

        tx = b"binary-framed traced tx"
        assert proxies[0].submit_tx(tx) == "accepted"
        merged = merged_trace(tx)
        assert merged["origin"] == nodes[0].get_id()

        # the binary protocol actually carried events (not a silent
        # JSON fallback), and contexts arrived over it
        assert CODEC_STATS.events_decoded > decoded_before
        assert CODEC_STATS.conns_binary > 0
        assert sum(n.trace_ctx_rpcs for n in nodes) > 0

        # queue/insert/consensus attribution is present on every hop
        hop = merged["hops"][0]
        assert hop["insert_s"] is not None and hop["insert_s"] >= 0
        assert hop["queue_s"] is not None and hop["queue_s"] >= 0
        assert hop["consensus_s"] is not None and hop["consensus_s"] >= 0

        # WIRE attribution (send stamp from the carried context) only
        # exists when the first arrival rode an eager push — the pull
        # leg can win the race, so feed transactions until one hop
        # carries it; losing it ENTIRELY would mean the binary codec
        # dropped the context's send stamp.
        wire_hop = hop if hop["wire_s"] is not None else None
        deadline = time.monotonic() + 60.0
        i = 0
        while wire_hop is None and time.monotonic() < deadline:
            tx_i = f"binary-framed traced tx {i}".encode()
            i += 1
            assert proxies[i % 2].submit_tx(tx_i) == "accepted"
            h = merged_trace(tx_i)["hops"][0]
            if h["wire_s"] is not None:
                wire_hop = h
        assert wire_hop is not None, (
            "wire attribution lost on every tx: the binary codec "
            "dropped the carried trace context's send stamp"
        )
        assert wire_hop["ctx"], "no wire context on the wire-stamped hop"
    finally:
        for n in nodes:
            n.shutdown()


# -- traceview --from-json (the sim-harness merge path) ---------------------


def test_traceview_merges_saved_exports(tmp_path, capsys):
    """The CLI merges a saved list of /traces payloads — the format the
    sim harness (SimCluster.provenance_exports) and saved scrapes
    produce."""
    t0 = 1000.0
    exports = [
        {"node": 1, "moniker": "a", "records": [
            {"txid": "ab" * 32, "admit": t0, "drain": t0 + 0.002,
             "commit": t0 + 0.050, "block": 2, "round_received": 3},
        ]},
        {"node": 2, "moniker": "b", "records": [
            {"txid": "ab" * 32, "first_seen": t0 + 0.010, "from": 1,
             "ctx": "1-4", "hop": 1, "recv": t0 + 0.008,
             "wire_s": 0.001, "queue_s": 0.002, "insert_s": 0.002,
             "commit": t0 + 0.055, "block": 2, "round_received": 3},
        ]},
        {"node": 3, "moniker": "c", "records": [
            {"txid": "ab" * 32, "first_seen": t0 + 0.020, "from": 2,
             "commit": t0 + 0.060, "block": 2, "round_received": 3},
        ]},
    ]
    path = tmp_path / "exports.json"
    path.write_text(json.dumps(exports))
    rc = traceview.main(["--from-json", str(path), "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert ref_traceview.main(["--from-json", str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == out
    _same_as_reference(exports, out["traces"])
    (m,) = out["traces"]
    assert m["origin"] == 1 and len(m["hops"]) == 2 and m["monotone"]
    assert m["hops"][0]["node"] == 2 and m["hops"][1]["node"] == 3
    assert m["committed_on"] == 3
    assert out["attribution"]["wire"]["n"] == 1
    # --txid filter + not-found exit code
    assert traceview.main(
        ["--from-json", str(path), "--txid", "ab" * 32]
    ) == 0
    text = capsys.readouterr().out
    assert ref_traceview.main(
        ["--from-json", str(path), "--txid", "ab" * 32]
    ) == 0
    assert capsys.readouterr().out == text
    assert traceview.main(
        ["--from-json", str(path), "--txid", "cd" * 32]
    ) == 1
