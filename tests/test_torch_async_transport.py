"""Twin of tests/test_async_transport.py for the port's async gossip engine
(``babble_tpu_torch/net/atcp.py`` and ``node/pipeline.py``): each of the
reference's nine cases runs through both packages (RPC pairs over the
selector transport in every protocol pairing, remote errors, dial
failures, multiplexing, the retry after a server restart, chaos over the
engine, full-node clusters on it, the mixed-version pair and the pipeline
guard under the sim clock). Across the packages: a port client against a
JAX-package server, and the other way round, over both engines in every
pairing."""

from __future__ import annotations

import importlib
import threading
import time
import types
from typing import List

import pytest

from tests.test_node import bombard_and_wait, check_gossip, shutdown_all

REF, PORT = "babble_tpu", "babble_tpu_torch"
PKGS = (REF, PORT)
KINDS = ("async", "tcp")


def _mods(pkg: str) -> types.SimpleNamespace:
    names = {"config": "config.config", "keys": "crypto.keys",
             "dummy": "dummy.state", "event": "hashgraph.event",
             "store": "hashgraph.store", "atcp": "net.atcp",
             "chaos": "net.chaos", "rpc": "net.rpc", "tcp": "net.tcp",
             "transport": "net.transport", "node": "node.node",
             "validator": "node.validator", "peer": "peers.peer",
             "peer_set": "peers.peer_set", "proxy": "proxy.proxy",
             "codec": "net.codec", "inmem": "net.inmem",
             "clock": "sim.clock"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _wire_event(m):
    return m.event.WireEvent(
        body=m.event.WireBody(
            transactions=[b"t1", b"t2"], creator_id=7,
            other_parent_creator_id=3, index=4, self_parent_index=3,
            other_parent_index=2, timestamp=99),
        signature="abc|def")


def _responder(m, trans, stop: threading.Event):
    """Serve canned responses, made of ``m``'s classes, for sync and
    eager-sync (and an error for anything else)."""

    def run():
        while not stop.is_set():
            try:
                rpc = trans.consumer().get(timeout=0.1)
            except Exception:
                continue
            cmd = rpc.command
            if isinstance(cmd, m.rpc.SyncRequest):
                rpc.respond(m.rpc.SyncResponse(
                    from_id=9, events=[_wire_event(m)], known={1: 2}), None)
            elif isinstance(cmd, m.rpc.EagerSyncRequest):
                rpc.respond(m.rpc.EagerSyncResponse(9, True), None)
            else:
                rpc.respond(None, "nope")

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.fixture
def stop():
    ev = threading.Event()
    yield ev
    ev.set()


def _new(m, kind: str):
    cls = m.atcp.AsyncTCPTransport if kind == "async" else m.tcp.TCPTransport
    t = cls("127.0.0.1:0", timeout=5.0)
    t.listen()
    return t


def _pair_round_trip(client_m, client, server_addr) -> None:
    resp = client.sync(server_addr, client_m.rpc.SyncRequest(1, {2: 3}, 100))
    assert isinstance(resp, client_m.rpc.SyncResponse)
    assert resp.known == {1: 2}
    assert [e.body.transactions for e in resp.events] == [[b"t1", b"t2"]]
    assert [e.signature for e in resp.events] == ["abc|def"]
    eresp = client.eager_sync(
        server_addr, client_m.rpc.EagerSyncRequest(1, [_wire_event(client_m)]))
    assert isinstance(eresp, client_m.rpc.EagerSyncResponse) and eresp.success


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize(
    "client_kind,server_kind",
    [("async", "async"), ("async", "tcp"), ("tcp", "async")],
)
def test_rpc_pairs_across_protocol_pairings(pkg, client_kind, server_kind,
                                            stop):
    """Sync and EagerSync round-trip in every client/server pairing: the
    per-connection version negotiation keeps old JSON peers interoperable
    with binary peers."""
    m = _mods(pkg)
    client, server = _new(m, client_kind), _new(m, server_kind)
    _responder(m, server, stop)
    try:
        _pair_round_trip(m, client, server.local_addr())
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_remote_error_surfaces_as_remote_error(pkg, stop):
    m = _mods(pkg)
    client, server = _new(m, "async"), _new(m, "async")

    def err_responder():
        while not stop.is_set():
            try:
                rpc = server.consumer().get(timeout=0.1)
            except Exception:
                continue
            rpc.respond(None, "handler exploded")

    threading.Thread(target=err_responder, daemon=True).start()
    try:
        with pytest.raises(m.transport.RemoteError):
            client.sync(server.local_addr(), m.rpc.SyncRequest(1, {}, 10))
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_dial_failure_is_transport_error(pkg):
    m = _mods(pkg)
    client = m.atcp.AsyncTCPTransport("127.0.0.1:0", timeout=1.0,
                                      dial_timeout=0.5)
    try:
        with pytest.raises(m.transport.TransportError):
            client.sync("127.0.0.1:9", m.rpc.SyncRequest(1, {}, 10))
    finally:
        client.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_multiplexes_concurrent_rpcs(pkg, stop):
    """Many RPCs in flight over ONE connection: the req_id multiplexing
    that replaces the per-socket one-at-a-time pool."""
    m = _mods(pkg)
    client, server = _new(m, "async"), _new(m, "async")
    _responder(m, server, stop)
    errs: List[Exception] = []

    def hammer(i):
        try:
            r = client.sync(server.local_addr(), m.rpc.SyncRequest(i, {}, 10))
            assert isinstance(r, m.rpc.SyncResponse)
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:3]
        assert client.peers_binary == 1  # one negotiated conn, 32 RPCs
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_retries_once_after_server_restart(pkg, stop):
    """A stale multiplexed connection (peer restarted between RPCs) is
    retried once on a fresh dial, mirroring tcp.py's pool-eviction
    retry."""
    m = _mods(pkg)
    client, server = _new(m, "async"), _new(m, "async")
    _responder(m, server, stop)
    addr = server.local_addr()
    try:
        assert isinstance(client.sync(addr, m.rpc.SyncRequest(1, {}, 10)),
                          m.rpc.SyncResponse)
        server.close()
        server = m.atcp.AsyncTCPTransport(addr, timeout=5.0)
        server.listen()
        _responder(m, server, stop)
        assert isinstance(client.sync(addr, m.rpc.SyncRequest(2, {}, 10)),
                          m.rpc.SyncResponse)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_composes_over_async_transport(pkg, stop):
    """ChaosTransport wraps the async engine exactly like the threaded one:
    faults on, RPCs fail; faults off, RPCs pass."""
    m = _mods(pkg)
    client, server = _new(m, "async"), _new(m, "async")
    _responder(m, server, stop)
    ctl = m.chaos.ChaosController(seed=1, drop_hold_s=0.01)
    wrapped = m.chaos.ChaosTransport(client, ctl)
    try:
        assert isinstance(
            wrapped.sync(server.local_addr(), m.rpc.SyncRequest(1, {}, 10)),
            m.rpc.SyncResponse)
        ctl.set_default_faults(m.chaos.LinkFaults(drop=1.0))
        with pytest.raises(m.transport.TransportError):
            wrapped.sync(server.local_addr(), m.rpc.SyncRequest(2, {}, 10))
        ctl.set_default_faults(m.chaos.LinkFaults())
        assert isinstance(
            wrapped.sync(server.local_addr(), m.rpc.SyncRequest(3, {}, 10)),
            m.rpc.SyncResponse)
    finally:
        wrapped.close()
        server.close()


# -- full-node clusters ---------------------------------------------------


def _make_cluster(m, kinds: List[str], heartbeat: float = 0.02):
    """Full nodes of ``m``'s package over localhost TCP, one transport kind
    per node: mixed lists build mixed-version clusters."""
    keys = [m.keys.generate_key() for _ in kinds]
    transports = [_new(m, kind) for kind in kinds]
    peers = m.peer_set.PeerSet([
        m.peer.Peer(net_addr=t.local_addr(), pub_key_hex=k.public_key.hex(),
                    moniker=f"x{i}")
        for i, (k, t) in enumerate(zip(keys, transports))])
    nodes, proxies = [], []
    for i, (k, t) in enumerate(zip(keys, transports)):
        conf = m.config.Config(heartbeat_timeout=heartbeat,
                               slow_heartbeat_timeout=0.2, moniker=f"x{i}",
                               log_level="error")
        pr = m.proxy.InmemProxy(m.dummy.State())
        node = m.node.Node(conf, m.validator.Validator(k, f"x{i}"), peers,
                           peers, m.store.InmemStore(conf.cache_size), t, pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
    for n in nodes:
        n.run_async()
    return nodes, proxies


@pytest.mark.parametrize("pkg", PKGS)
def test_async_cluster_commits_and_pipeline_engages(pkg):
    """4 nodes on the async engine commit identical chains, and the
    inbound-sync pipeline carries the load: pipelined syncs counted, the
    inflight gauge returns to zero, and the stats surface exposes the
    gossip_* counters."""
    nodes, proxies = _make_cluster(_mods(pkg), ["async"] * 4)
    try:
        bombard_and_wait(nodes, proxies, target_block=3, timeout=120.0)
        check_gossip(nodes, 0, 3)
        assert sum(n.pipeline.pipelined_syncs for n in nodes
                   if n.pipeline) > 0, "pipeline never engaged"
        snap = nodes[0].get_stats_snapshot()
        for key in ("gossip_inflight_syncs", "gossip_inflight_syncs_peak",
                    "gossip_pipelined_syncs", "gossip_backpressure_stalls",
                    "codec_events_encoded", "codec_events_decoded"):
            assert key in snap, key
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if all(n.pipeline is None or n.pipeline.inflight == 0
                   for n in nodes):
                break
            time.sleep(0.05)
        assert all(n.pipeline is None or n.pipeline.inflight == 0
                   for n in nodes), "inflight gauge did not drain"
    finally:
        shutdown_all(nodes)


@pytest.mark.parametrize("pkg", PKGS)
def test_mixed_version_cluster_interop(pkg):
    """A binary (async-engine) node and a legacy JSON node form a 2-node
    cluster, commit blocks with byte-identical bodies, and neither side
    rejects anything: the wire negotiation makes the codec upgrade
    invisible to consensus."""
    m = _mods(pkg)
    nodes, proxies = _make_cluster(m, ["async", "tcp"])
    try:
        bombard_and_wait(nodes, proxies, target_block=2, timeout=120.0)
        check_gossip(nodes, 0, 2)
        for n in nodes:
            snap = n.get_stats_snapshot()
            assert snap["sentry_quarantined_peers"] == 0
            assert snap["rpc_errors_sync"] == 0
            assert snap["rpc_errors_eager_sync"] == 0
        assert (m.codec.CODEC_STATS.conns_json > 0
                or nodes[0].trans.peers_json > 0)
    finally:
        shutdown_all(nodes)


@pytest.mark.parametrize("pkg", PKGS)
def test_pipeline_disabled_under_sim_clock(pkg):
    """Determinism guard: a node built with an injected (non-wall) clock
    must not construct the pipeline: the sim engine drives _process_rpc
    single-threaded."""
    m = _mods(pkg)
    k = m.keys.generate_key()
    peers = m.peer_set.PeerSet([m.peer.Peer("inmem://solo",
                                            k.public_key.hex(), "solo")])
    conf = m.config.Config(moniker="solo", log_level="error",
                           clock=m.clock.SimClock(), sim_seed=1)
    node = m.node.Node(
        conf, m.validator.Validator(k, "solo"), peers, peers,
        m.store.InmemStore(conf.cache_size),
        m.inmem.InmemNetwork().new_transport("inmem://solo"),
        m.proxy.InmemProxy(m.dummy.State()))
    try:
        assert node.pipeline is None
        assert node.get_stats_snapshot()["gossip_inflight_syncs"] == 0
    finally:
        node.shutdown()


# -- across the packages ----------------------------------------------------


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT)])
@pytest.mark.parametrize("client_kind", KINDS)
@pytest.mark.parametrize("server_kind", KINDS)
def test_rpc_pairs_across_packages(client_pkg, server_pkg, client_kind,
                                   server_kind, stop):
    """A client of one package against a server of the other, on either
    engine at either end: Sync and EagerSync round-trip, the binary codec
    negotiated where both ends speak it and JSON otherwise."""
    cm, sm = _mods(client_pkg), _mods(server_pkg)
    client, server = _new(cm, client_kind), _new(sm, server_kind)
    _responder(sm, server, stop)
    try:
        _pair_round_trip(cm, client, server.local_addr())
        if client_kind == server_kind == "async":
            assert client.peers_binary == 1
    finally:
        client.close()
        server.close()


def test_mixed_package_cluster_on_the_async_engine():
    """Two port nodes and two JAX-package nodes, all on the async engine,
    in one cluster: identical bodies to block 2, no RPC error and no
    quarantine on any node."""
    ref, port = _mods(REF), _mods(PORT)
    mods = [port, ref, port, ref]
    keys = [m.keys.generate_key() for m in mods]
    transports = [_new(m, "async") for m in mods]
    nodes, proxies = [], []
    for i, (m, k, t) in enumerate(zip(mods, keys, transports)):
        peers = m.peer_set.PeerSet([
            m.peer.Peer(net_addr=tt.local_addr(),
                        pub_key_hex=kk.public_key.hex(), moniker=f"x{j}")
            for j, (kk, tt) in enumerate(zip(keys, transports))])
        conf = m.config.Config(heartbeat_timeout=0.02,
                               slow_heartbeat_timeout=0.2, moniker=f"x{i}",
                               log_level="error")
        pr = m.proxy.InmemProxy(m.dummy.State())
        node = m.node.Node(conf, m.validator.Validator(k, f"x{i}"), peers,
                           peers, m.store.InmemStore(conf.cache_size), t, pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
    for n in nodes:
        n.run_async()
    try:
        bombard_and_wait(nodes, proxies, target_block=2, timeout=120.0)
        check_gossip(nodes, 0, 2)
        for n in nodes:
            snap = n.get_stats_snapshot()
            assert snap["sentry_quarantined_peers"] == 0
            assert snap["rpc_errors_sync"] == 0
            assert snap["rpc_errors_eager_sync"] == 0
    finally:
        shutdown_all(nodes)
