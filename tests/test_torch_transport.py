"""Twin of tests/test_transport.py for the port's transports
(``babble_tpu_torch/net/{inmem,tcp,signal,transport}.py``): each of the
reference's fifteen cases runs through both packages (every RPC pair over
the inmem, TCP, relay and relay-with-direct-upgrade transports, typed
remote errors, dial failures, a full-node gossip run over localhost TCP,
and the TCP pool's hardening). The twin of the stale-pooled-socket case
counts a served RPC before its answer is sent, so the client can never
read its answer before the count (the reference counts after), and the
relay pairs start once the relay holds both registrations. Across the
packages: every RPC pair between a port TCP transport and a JAX-package
one, both ways."""

from __future__ import annotations

import importlib
import socket
import struct
import threading
import time
import types

import pytest

REF, PORT = "babble_tpu", "babble_tpu_torch"
PKGS = (REF, PORT)


def _mods(pkg: str) -> types.SimpleNamespace:
    names = {"config": "config.config", "canonical": "crypto.canonical",
             "keys": "crypto.keys", "dummy": "dummy.state",
             "event": "hashgraph.event",
             "itx": "hashgraph.internal_transaction",
             "store": "hashgraph.store", "inmem": "net.inmem",
             "rpc": "net.rpc", "tcp": "net.tcp", "signal": "net.signal",
             "transport": "net.transport", "node": "node.node",
             "validator": "node.validator", "peer": "peers.peer",
             "peer_set": "peers.peer_set", "proxy": "proxy.proxy"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _wire_event(m):
    return m.event.WireEvent(
        body=m.event.WireBody(
            transactions=[b"t1", b"t2"], creator_id=7,
            other_parent_creator_id=3, index=4, self_parent_index=3,
            other_parent_index=2, timestamp=99),
        signature="abc|def")


def _responder(trans, responses: dict, stop: threading.Event):
    """Serve canned responses keyed by request class name."""

    def run():
        while not stop.is_set():
            try:
                rpc = trans.consumer().get(timeout=0.1)
            except Exception:
                continue
            resp = responses.get(type(rpc.command).__name__)
            if isinstance(resp, str):
                rpc.respond(None, resp)
            else:
                rpc.respond(resp, None)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _registered(relay, *ends, timeout: float = 10.0) -> None:
    """Waits until the relay holds every end's registration: ``listen``
    returns once its register frame is sent, and a request the relay
    routes before the other end's registration lands is answered
    "unreachable peer" (the reference's pair has that race)."""
    want = {end._pub for end in ends}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with relay._lock:
            if want <= relay._clients.keys():
                return
        time.sleep(0.01)
    raise AssertionError("the relay did not register both ends")


def _make_pair(m, kind):
    """Returns (client, server, cleanup)."""
    if kind == "inmem":
        net = m.inmem.InmemNetwork()
        a = net.new_transport("inmem://a")
        b = net.new_transport("inmem://b")
        return a, b, lambda: (a.close(), b.close())
    if kind in ("signal", "signal-direct"):
        # relay-routed pair: both sides dial OUT to a rendezvous server and
        # are addressed by public key; "signal-direct" also enables the p2p
        # upgrade, so after the first RPC the traffic rides direct links
        direct = "127.0.0.1:0" if kind == "signal-direct" else None
        relay = m.signal.SignalServer("127.0.0.1:0")
        relay.listen()
        ka, kb = m.keys.generate_key(), m.keys.generate_key()
        a = m.signal.SignalTransport(relay.addr(), ka, timeout=20.0,
                                     direct_listen=direct)
        b = m.signal.SignalTransport(relay.addr(), kb, timeout=20.0,
                                     direct_listen=direct)
        a.listen()
        b.listen()
        _registered(relay, a, b)
        return a, b, lambda: (a.close(), b.close(), relay.close())
    srv = m.tcp.TCPTransport("127.0.0.1:0")
    srv.listen()
    cli = m.tcp.TCPTransport("127.0.0.1:0")
    cli.listen()
    return cli, srv, lambda: (cli.close(), srv.close())


@pytest.fixture(params=[(pkg, kind) for pkg in PKGS
                        for kind in ("inmem", "tcp", "signal",
                                     "signal-direct")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    pkg, kind = request.param
    m = _mods(pkg)
    cli, srv, cleanup = _make_pair(m, kind)
    stop = threading.Event()
    yield m, cli, srv, stop
    stop.set()
    cleanup()


def test_sync_rpc(pair):
    m, cli, srv, stop = pair
    want = m.rpc.SyncResponse(from_id=2, events=[_wire_event(m)],
                              known={1: 5, 2: 9})
    _responder(srv, {"SyncRequest": want}, stop)
    got = cli.sync(srv.advertise_addr(),
                   m.rpc.SyncRequest(from_id=1, known={1: 2}, sync_limit=500))
    assert got.from_id == 2
    assert got.known == {1: 5, 2: 9}
    assert len(got.events) == 1
    assert got.events[0].body.transactions == [b"t1", b"t2"]
    assert got.events[0].signature == "abc|def"


def test_eager_sync_rpc(pair):
    m, cli, srv, stop = pair
    _responder(srv, {"EagerSyncRequest": m.rpc.EagerSyncResponse(2, True)},
               stop)
    got = cli.eager_sync(srv.advertise_addr(), m.rpc.EagerSyncRequest(
        from_id=1, events=[_wire_event(m)]))
    assert got.success is True


def test_fast_forward_rpc(pair):
    m, cli, srv, stop = pair
    want = m.rpc.FastForwardResponse(from_id=2, block=None, frame=None,
                                     snapshot=b"\x01\x02")
    _responder(srv, {"FastForwardRequest": want}, stop)
    got = cli.fast_forward(srv.advertise_addr(),
                           m.rpc.FastForwardRequest(from_id=1))
    assert got.snapshot == b"\x01\x02"


def test_join_rpc(pair):
    m, cli, srv, stop = pair
    k = m.keys.generate_key()
    peer = m.peer.Peer("tcp://x", k.public_key.hex(), "joiner")
    itx = m.itx.InternalTransaction.join(peer)
    itx.sign(k)
    want = m.rpc.JoinResponse(from_id=2, accepted=True, accepted_round=11,
                              peers=[peer])
    _responder(srv, {"JoinRequest": want}, stop)
    got = cli.join(srv.advertise_addr(),
                   m.rpc.JoinRequest(internal_transaction=itx))
    assert got.accepted is True
    assert got.accepted_round == 11
    assert got.peers[0].pub_key_hex == peer.pub_key_hex


def test_remote_error_propagates(pair):
    m, cli, srv, stop = pair
    _responder(srv, {"SyncRequest": "something broke"}, stop)
    with pytest.raises(m.transport.TransportError):
        cli.sync(srv.advertise_addr(),
                 m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10))


@pytest.mark.parametrize("pkg", PKGS)
def test_remote_errors_are_typed(pkg):
    """Handler errors over inmem and TCP surface as RemoteError: the
    network worked, so retry loops (fast-forward) treat them as conclusive
    answers, not connectivity failures."""
    m = _mods(pkg)
    for kind in ("inmem", "tcp"):
        cli, srv, cleanup = _make_pair(m, kind)
        stop = threading.Event()
        _responder(srv, {"SyncRequest": "handler exploded"}, stop)
        try:
            with pytest.raises(m.transport.RemoteError):
                cli.sync(srv.advertise_addr(),
                         m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10))
        finally:
            stop.set()
            cleanup()


@pytest.mark.parametrize("pkg", PKGS)
def test_dial_failure(pkg):
    m = _mods(pkg)
    cli = m.tcp.TCPTransport("127.0.0.1:0")
    with pytest.raises(m.transport.TransportError):
        cli.sync("127.0.0.1:1",
                 m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10))
    cli.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_gossip_over_tcp(pkg):
    """3 full nodes over real localhost TCP sockets reach identical
    blocks."""
    m = _mods(pkg)
    n = 3
    keys = [m.keys.generate_key() for _ in range(n)]
    transports = []
    for _ in range(n):
        t = m.tcp.TCPTransport("127.0.0.1:0")
        t.listen()
        transports.append(t)
    peers = m.peer_set.PeerSet([
        m.peer.Peer(transports[i].advertise_addr(), k.public_key.hex(),
                    f"n{i}") for i, k in enumerate(keys)])
    nodes, proxies = [], []
    for i, k in enumerate(keys):
        conf = m.config.Config(heartbeat_timeout=0.02,
                               slow_heartbeat_timeout=0.2, moniker=f"n{i}",
                               log_level="warning")
        pr = m.proxy.InmemProxy(m.dummy.State())
        node = m.node.Node(conf, m.validator.Validator(k, f"n{i}"), peers,
                           peers, m.store.InmemStore(conf.cache_size),
                           transports[i], pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
    try:
        for nd in nodes:
            nd.run_async()
        deadline = time.monotonic() + 60
        i = 0
        while (min(nd.get_last_block_index() for nd in nodes) < 1
               and time.monotonic() < deadline):
            proxies[i % n].submit_tx(f"tx {i}".encode())
            i += 1
            time.sleep(0.005)
        assert min(nd.get_last_block_index() for nd in nodes) >= 1
        b0 = [nodes[0].get_block(j).body.hash() for j in range(2)]
        for nd in nodes[1:]:
            assert [nd.get_block(j).body.hash() for j in range(2)] == b0
    finally:
        for nd in nodes:
            nd.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_pooled_connections(pkg):
    """Concurrent RPCs to one target succeed and the connection pool never
    retains more than max_pool sockets, and pooled sockets are reused."""
    m = _mods(pkg)
    srv = m.tcp.TCPTransport("127.0.0.1:0")
    srv.listen()
    cli = m.tcp.TCPTransport("127.0.0.1:0", max_pool=2)
    cli.listen()
    stop = threading.Event()
    _responder(srv, {"SyncRequest": m.rpc.SyncResponse(
        from_id=2, events=[], known={})}, stop)
    try:
        results, errs = [], []

        def one(k):
            try:
                got = cli.sync(srv.advertise_addr(), m.rpc.SyncRequest(
                    from_id=k, known={}, sync_limit=10))
                results.append(got.from_id)
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=one, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        assert results == [2] * 8
        with cli._pool_lock:
            pooled = sum(len(v) for v in cli._pool.values())
        assert pooled <= 2, f"pool retained {pooled} > max_pool sockets"
        with cli._pool_lock:
            pooled_ids = {id(c) for v in cli._pool.values() for c in v}
        assert pooled_ids, "nothing pooled to reuse"
        for k in range(4):
            cli.sync(srv.advertise_addr(),
                     m.rpc.SyncRequest(from_id=k, known={}, sync_limit=10))
        with cli._pool_lock:
            after_ids = {id(c) for v in cli._pool.values() for c in v}
        assert after_ids & pooled_ids, (
            "sequential calls dialed fresh sockets instead of reusing the "
            "pool")
    finally:
        stop.set()
        cli.close()
        srv.close()


def _raw_server(m, serve_conn):
    """A raw framed-protocol server on port 0 (its bound address read back,
    never bound and closed first): each accepted connection goes to
    ``serve_conn(conn)`` on the server's one thread, then is closed.
    Returns (listener, address, stop)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()

    def run():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                serve_conn(conn, stop)
            except Exception:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    threading.Thread(target=run, daemon=True).start()
    return srv, "127.0.0.1:%d" % srv.getsockname()[1], stop


def _read_request(m, conn) -> str:
    type_byte = m.tcp._recv_exact(conn, 1)[0]
    (length,) = struct.unpack(">I", m.tcp._recv_exact(conn, 4))
    m.tcp._recv_exact(conn, length)
    return m.rpc.REQUEST_TYPES[type_byte].__name__


def _answer(m, conn, resp) -> None:
    m.tcp._send_frame(conn, None, m.canonical.canonical_dumps(
        {"error": None, "payload": resp.to_dict()}))


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_stale_pooled_socket_retries_on_fresh_dial(pkg):
    """A pooled socket the peer has since closed must not fail the RPC: the
    pool is evicted and the RPC retried once on a fresh dial. The server
    answers one RPC a connection, then hangs up."""
    m = _mods(pkg)
    served = []

    def one_shot(conn, stop):
        name = _read_request(m, conn)
        served.append(name)  # counted before the answer can reach the client
        _answer(m, conn, m.rpc.SyncResponse(from_id=5, events=[], known={}))

    srv, addr, stop = _raw_server(m, one_shot)
    cli = m.tcp.TCPTransport("127.0.0.1:0")
    try:
        req = m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10)
        assert cli.sync(addr, req).from_id == 5
        # the socket went back to the pool, but the server closed its end
        with cli._pool_lock:
            assert sum(len(v) for v in cli._pool.values()) == 1
        time.sleep(0.1)  # let the server-side FIN land
        assert cli.sync(addr, req).from_id == 5  # salvaged by the retry
        assert cli.retries == 1
        assert cli.pool_evictions >= 1
        assert served == ["SyncRequest", "SyncRequest"]
    finally:
        stop.set()
        srv.close()
        cli.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_timeout_on_pooled_socket_is_not_retried(pkg):
    """An RPC timeout means the peer is slow or gone, not that the pooled
    socket was stale: it surfaces after ONE timeout period and never
    triggers the fresh-dial retry."""
    m = _mods(pkg)
    served = []

    def answer_once_then_stall(conn, stop):
        while True:
            name = _read_request(m, conn)
            if served:
                stop.wait(5.0)  # stall well past the RPC timeout
                return
            _answer(m, conn, m.rpc.SyncResponse(from_id=3, events=[],
                                                known={}))
            served.append(name)

    srv, addr, stop = _raw_server(m, answer_once_then_stall)
    cli = m.tcp.TCPTransport("127.0.0.1:0", timeout=0.5)
    try:
        req = m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10)
        assert cli.sync(addr, req).from_id == 3  # pooled afterwards
        t0 = time.monotonic()
        with pytest.raises(m.transport.TransportError):
            cli.sync(addr, req)  # pooled socket, server stalls
        elapsed = time.monotonic() - t0
        assert cli.retries == 0, "timeout must not trigger a retry"
        assert elapsed < 1.5, f"timeout surfaced after {elapsed:.1f}s"
    finally:
        stop.set()
        srv.close()
        cli.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_remote_error_is_not_retried(pkg):
    """A remote handler error means the peer processed the request: it
    surfaces at once and never triggers the fresh-dial retry."""
    m = _mods(pkg)
    srv = m.tcp.TCPTransport("127.0.0.1:0")
    srv.listen()
    cli = m.tcp.TCPTransport("127.0.0.1:0")
    stop = threading.Event()
    _responder(srv, {"SyncRequest": "handler exploded"}, stop)
    try:
        req = m.rpc.SyncRequest(from_id=1, known={}, sync_limit=10)
        for _ in range(2):  # the second call uses the pooled socket
            with pytest.raises(m.transport.TransportError,
                               match="remote error"):
                cli.sync(srv.advertise_addr(), req)
        assert cli.retries == 0
    finally:
        stop.set()
        cli.close()
        srv.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_dial_timeout_is_explicit(pkg):
    """The connect deadline is the dial timeout, not the (much longer) RPC
    timeout."""
    m = _mods(pkg)
    cli = m.tcp.TCPTransport("127.0.0.1:0", timeout=30.0, dial_timeout=0.5)
    try:
        assert cli._dial_timeout == 0.5
        t0 = time.monotonic()
        with pytest.raises(m.transport.TransportError):
            cli.sync("127.0.0.1:1",
                     m.rpc.SyncRequest(from_id=1, known={}, sync_limit=1))
        assert time.monotonic() - t0 < 5.0
    finally:
        cli.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_bad_addr(pkg):
    """An unbindable address fails loudly at listen."""
    t = _mods(pkg).tcp.TCPTransport("256.256.256.256:0")
    try:
        with pytest.raises(OSError):
            t.listen()
    finally:
        t.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tcp_with_advertise(pkg):
    """advertise_addr is what peers are told; the bind address still
    serves."""
    m = _mods(pkg)
    srv = m.tcp.TCPTransport("127.0.0.1:0",
                             advertise_addr="node77.example:9000")
    srv.listen()
    try:
        assert srv.advertise_addr() == "node77.example:9000"
        assert srv.local_addr() != srv.advertise_addr()
        stop = threading.Event()
        _responder(srv, {"SyncRequest": m.rpc.SyncResponse(
            from_id=9, events=[], known={})}, stop)
        cli = m.tcp.TCPTransport("127.0.0.1:0")
        cli.listen()
        try:
            got = cli.sync(srv.local_addr(), m.rpc.SyncRequest(
                from_id=1, known={}, sync_limit=5))
            assert got.from_id == 9
        finally:
            stop.set()
            cli.close()
    finally:
        srv.close()


# -- across the packages ----------------------------------------------------


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT)])
def test_every_rpc_pair_across_packages_over_tcp(client_pkg, server_pkg):
    """A TCP client of one package against a TCP server of the other: sync,
    eager-sync, fast-forward and join round-trip, and a handler error
    arrives as the client's RemoteError."""
    cm, sm = _mods(client_pkg), _mods(server_pkg)
    srv = sm.tcp.TCPTransport("127.0.0.1:0")
    srv.listen()
    cli = cm.tcp.TCPTransport("127.0.0.1:0")
    cli.listen()
    k = sm.keys.generate_key()
    peer = sm.peer.Peer("tcp://x", k.public_key.hex(), "joiner")
    stop = threading.Event()
    _responder(srv, {
        "SyncRequest": sm.rpc.SyncResponse(from_id=2,
                                           events=[_wire_event(sm)],
                                           known={1: 5}),
        "EagerSyncRequest": sm.rpc.EagerSyncResponse(2, True),
        "FastForwardRequest": "no snapshot here",
        "JoinRequest": sm.rpc.JoinResponse(from_id=2, accepted=True,
                                           accepted_round=11, peers=[peer]),
    }, stop)
    try:
        addr = srv.advertise_addr()
        got = cli.sync(addr, cm.rpc.SyncRequest(from_id=1, known={1: 2},
                                                sync_limit=500))
        assert (got.from_id, got.known) == (2, {1: 5})
        assert got.events[0].body.transactions == [b"t1", b"t2"]
        assert cli.eager_sync(addr, cm.rpc.EagerSyncRequest(
            from_id=1, events=[_wire_event(cm)])).success is True
        with pytest.raises(cm.transport.RemoteError):
            cli.fast_forward(addr, cm.rpc.FastForwardRequest(from_id=1))
        ck = cm.keys.generate_key()
        itx = cm.itx.InternalTransaction.join(
            cm.peer.Peer("tcp://x", ck.public_key.hex(), "joiner"))
        itx.sign(ck)
        got = cli.join(addr, cm.rpc.JoinRequest(internal_transaction=itx))
        assert (got.accepted, got.accepted_round) == (True, 11)
        assert got.peers[0].pub_key_hex == peer.pub_key_hex
    finally:
        stop.set()
        cli.close()
        srv.close()
