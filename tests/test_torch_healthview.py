"""The port's cluster healthview against the JAX package's (twins of
tests/test_healthview.py on babble_tpu_torch.obs.healthview): merge math on
synthetic samples, saved-export (sim) mode — each pure function's output
equal to the reference's on the same inputs — and the healthsmoke over
four port nodes with port services, merged over live HTTP with every node
healthy and the commit-p50-vs-500ms SLO scored."""

import json
import time

import pytest

from babble_tpu.obs import healthview as ref_hv
from babble_tpu_torch.obs import healthview as hv


def _same(view, ref_view):
    """Two merged views are equal but for the time they were made."""
    assert {**view, "ts": 0} == {**ref_view, "ts": 0}


# -- parsing + merge units ---------------------------------------------------


def _sample(round_, block, p50_bucketed=None, extra_metrics=None,
            moniker="n", ts=0.0):
    """Synthetic scrape sample. ``p50_bucketed``: (count_le_half,
    count_total) for a two-bucket commit-latency histogram around the
    500 ms target."""
    metrics = {
        "node_last_consensus_round": float(round_),
        "node_last_block_index": float(block),
        "submit_queue_depth": 0.0,
        "gossip_inflight_syncs": 0.0,
        "gossip_pipeline_queue_depth": 0.0,
        "mempool_pending": 0.0,
        "sentry_quarantined_peers": 0.0,
    }
    metrics.update(extra_metrics or {})
    clat = None
    if p50_bucketed is not None:
        under, total = p50_bucketed
        clat = {
            "buckets": [(0.5, float(under)), (float("inf"), float(total))],
            "sum": 0.0,
            "count": float(total),
        }
    return {
        "endpoint": f"{moniker}:1",
        "moniker": moniker,
        "ts": ts,
        "metrics": metrics,
        "clat": clat,
        "stats": {"moniker": moniker, "state": "Babbling"},
        "suspects": {},
    }


def test_parse_prom_and_hist_quantile():
    text = (
        "# HELP x y\n# TYPE x histogram\n"
        'x_bucket{le="0.1"} 5\nx_bucket{le="0.5"} 8\n'
        'x_bucket{le="+Inf"} 10\nx_sum 2.0\nx_count 10\nnot a sample\n'
    )
    samples = hv.parse_prom(text)
    assert samples == ref_hv.parse_prom(text)
    h = hv.prom_histogram(samples, "x")
    assert h == ref_hv.prom_histogram(samples, "x")
    assert h["count"] == 10
    q50 = hv.hist_quantile(h, 0.5)
    assert q50 == ref_hv.hist_quantile(h, 0.5)
    assert 0.0 < q50 <= 0.1  # 5/10 land in the first bucket
    assert hv.hist_quantile({"buckets": [(1.0, 0.0)], "count": 0.0,
                             "sum": 0.0}, 0.5) is None


def test_merge_rates_lag_and_slo_ok():
    s0 = [_sample(10, 4, (90, 100), moniker="a"),
          _sample(10, 4, (90, 100), moniker="b")]
    s1 = [_sample(20, 8, (180, 200), moniker="a"),
          _sample(18, 7, (178, 198), moniker="b")]
    view = hv.merge(s0, s1, window_s=5.0)
    _same(view, ref_hv.merge(s0, s1, window_s=5.0))
    a, b = view["nodes"]
    assert a["round_rate_per_s"] == 2.0
    assert a["lag_rounds"] == 0 and b["lag_rounds"] == 2
    assert a["healthy"] and b["healthy"]  # lag 2 <= max_lag 3
    # 10% of window commits over 500ms -> burn 0.2 of the 50% budget
    assert a["slo_burn_rate"] == pytest.approx(0.2)
    c = view["cluster"]
    assert c["slo_verdict"] == "ok" and c["all_healthy"]
    assert c["worst_lag_node"]["moniker"] == "b"
    assert c["n_healthy"] == 2


def test_merge_flags_stalled_lagging_and_breaching_nodes():
    s0 = [_sample(10, 4, (100, 100), moniker="a"),
          _sample(10, 4, (10, 100), moniker="b")]
    s1 = [_sample(30, 9, (200, 200), moniker="a"),
          _sample(10, 4, (10, 200), moniker="b")]  # b frozen + slow
    view = hv.merge(s0, s1, window_s=5.0)
    _same(view, ref_hv.merge(s0, s1, window_s=5.0))
    a, b = view["nodes"]
    assert b["round_rate_per_s"] == 0.0 and b["lag_rounds"] == 20
    assert not b["healthy"]
    # every commit in b's window exceeded 500ms: share 1.0 / budget 0.5
    assert b["slo_burn_rate"] == pytest.approx(2.0)
    c = view["cluster"]
    assert not c["all_healthy"]
    assert c["slo_verdict"] == "breach"  # worst node's p50 carries it
    assert c["worst_lag_node"]["moniker"] == "b"


def test_merge_reports_down_nodes():
    s1 = [_sample(5, 2, moniker="a"), None]
    view = hv.merge([None, None], s1, window_s=None)
    _same(view, ref_hv.merge([None, None], s1, window_s=None))
    assert view["nodes"][1]["down"]
    assert view["cluster"]["n_up"] == 1
    assert not view["cluster"]["all_healthy"]


def test_quarantine_state_marks_unhealthy():
    s1 = [_sample(5, 2, moniker="a",
                  extra_metrics={"sentry_quarantined_peers": 1.0})]
    view = hv.merge([], s1, window_s=None)
    _same(view, ref_hv.merge([], s1, window_s=None))
    assert view["nodes"][0]["quarantined_peers"] == 1
    assert not view["nodes"][0]["healthy"]


# -- saved-export (sim / bench) mode ----------------------------------------


def _stats_entry(moniker, round_, block, p50_ms, pending=0):
    return {
        "node": hash(moniker) % 97,
        "moniker": moniker,
        "stats": {
            "last_consensus_round": round_,
            "last_block_index": block,
            "transaction_pool": pending,
            "gossip_inflight_syncs": 0,
            "gossip_pipeline_queue_depth": 0,
            "sentry_quarantined_peers": 0,
            "commit_latency_samples": 50,
            "commit_latency_p50_ms": p50_ms,
            "moniker": moniker,
            "state": "Babbling",
        },
    }


def test_from_export_single_sample_list():
    payload = [
        _stats_entry("s0", 12, 5, 240.0),
        _stats_entry("s1", 11, 5, 260.0),
    ]
    view = hv.from_export(payload)
    _same(view, ref_hv.from_export(payload))
    assert ([hv.sample_from_stats(e) for e in payload]
            == [ref_hv.sample_from_stats(e) for e in payload])
    assert view["cluster"]["slo_verdict"] == "ok"
    assert view["cluster"]["commit_p50_ms_worst"] == 260.0
    assert view["nodes"][1]["lag_rounds"] == 1
    assert view["cluster"]["all_healthy"]
    # single sample: no rates, no burn window
    assert view["nodes"][0]["round_rate_per_s"] is None


def test_from_export_two_sample_windows_and_breach():
    payload = {
        "window_s": 10.0,
        "samples": [
            [_stats_entry("s0", 10, 4, 700.0)],
            [_stats_entry("s0", 30, 9, 700.0)],
        ],
    }
    view = hv.from_export(payload)
    _same(view, ref_hv.from_export(payload))
    assert view["nodes"][0]["round_rate_per_s"] == 2.0
    assert view["cluster"]["slo_verdict"] == "breach"  # 700ms > 500ms


def test_from_export_rejects_garbage():
    with pytest.raises(ValueError):
        hv.from_export({"nope": 1})
    with pytest.raises(ValueError):
        ref_hv.from_export({"nope": 1})


def test_render_and_summary_line_smoke():
    view = hv.merge(
        [_sample(10, 4, (90, 100))], [_sample(20, 8, (180, 200))], 5.0
    )
    out = hv.render(view)
    assert out == ref_hv.render(view)
    assert "SLO commit p50" in out and "ok" in out
    line = hv.summary_line(view)
    assert line == ref_hv.summary_line(view)
    assert line.startswith("healthview:") and "worst lag" in line


# -- healthsmoke: live 4-node cluster over HTTP -----------------------------


@pytest.mark.healthview
def test_healthview_merges_live_4node_cluster():
    """The healthsmoke on the port: boot 4 gossiping port nodes with port
    services, commit traffic, merge the cluster over real HTTP — every
    node up and healthy, per-node lag + advance rates present, SLO
    scored."""
    from babble_tpu_torch.config.config import Config
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.dummy.state import State
    from babble_tpu_torch.hashgraph.store import InmemStore
    from babble_tpu_torch.net.inmem import InmemNetwork
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet
    from babble_tpu_torch.proxy.proxy import InmemProxy
    from babble_tpu_torch.service.service import Service

    net = InmemNetwork()
    keys = [generate_key() for _ in range(4)]
    peers = PeerSet(
        [Peer(f"inmem://h{i}", k.public_key.hex(), f"h{i}")
         for i, k in enumerate(keys)]
    )
    nodes, proxies, states, services = [], [], [], []
    for i, k in enumerate(keys):
        conf = Config(
            heartbeat_timeout=0.01, slow_heartbeat_timeout=0.2,
            log_level="error", moniker=f"h{i}",
        )
        st = State()
        pr = InmemProxy(st)
        n = Node(conf, Validator(k, f"h{i}"), peers, peers,
                 InmemStore(conf.cache_size),
                 net.new_transport(f"inmem://h{i}"), pr)
        n.init()
        svc = Service("127.0.0.1:0", n)
        svc.serve_async()
        nodes.append(n)
        proxies.append(pr)
        states.append(st)
        services.append(svc)
    try:
        for n in nodes:
            n.run_async()
        # sustained background traffic so the scrape window sees motion
        import threading

        stop = threading.Event()

        def feed():
            i = 0
            while not stop.is_set():
                proxies[i % 4].submit_tx(f"hv tx {i}".encode())
                i += 1
                time.sleep(0.005)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        deadline = time.monotonic() + 60.0
        while (
            min(len(s.committed_txs) for s in states) < 30
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        assert min(len(s.committed_txs) for s in states) >= 30

        eps = [svc.bind_addr for svc in services]
        # max_lag 10: an in-process cluster on this shared core advances
        # ~10 rounds/s, so sub-second scrape skew IS a few rounds of
        # "lag"; production clusters at the 500ms cadence fit the
        # default budget
        view = hv.collect(eps, window_s=2.0, max_lag=10)
        stop.set()
        feeder.join(timeout=2.0)

        c = view["cluster"]
        assert c["n_up"] == 4, view
        assert c["all_healthy"], view
        assert c["n_healthy"] == 4
        assert c["slo_verdict"] in ("ok", "breach")  # scored, not no-data
        assert c["commit_p50_ms_worst"] is not None
        for n_view in view["nodes"]:
            assert n_view["lag_rounds"] <= 10
            assert n_view["round_rate_per_s"] is not None
            assert n_view["queues"]["mempool_pending"] >= 0
        # the same snapshot round-trips through the JSON renderers
        json.dumps(view)
        assert "healthview:" in hv.summary_line(view)

        # saved-export parity: dump the nodes' typed stats and merge
        # through the sim/bench path
        export = [
            {"node": n.get_id(), "moniker": f"h{i}",
             "stats": n.get_stats_snapshot()}
            for i, n in enumerate(nodes)
        ]
        export = json.loads(json.dumps(export, default=str))
        sim_view = hv.from_export(export)
        _same(sim_view, ref_hv.from_export(export))
        assert hv.render(view) == ref_hv.render(view)
        assert sim_view["cluster"]["n_up"] == 4
        assert sim_view["cluster"]["commit_p50_ms_worst"] is not None
    finally:
        for svc in services:
            svc.shutdown()
        for n in nodes:
            n.shutdown()
