"""Twins of tests/test_mempool.py (docs/mempool.md): admission caps, both
overflow policies, dedup (pending, in flight, the committed LRU), drain
order and requeue, verdicts through the in-memory and socket proxies, the
rate limiter under a fake clock, and node integration: the stats and
/mempool surface, a retried committed transaction, and an overload soak in
which every admitted transaction commits exactly once on every node. Each
case runs through both packages (``pkg``) on the same inputs; the node
cases on keys from a fixed seed.

Tolerance: exact (verdict strings, counters, transaction bytes)."""

from __future__ import annotations

import importlib
import json
import random
import time
import urllib.request

import pytest

PKGS = ("babble_tpu", "babble_tpu_torch")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- unit: caps and overflow policies ---------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_count_cap_reject(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(max_txs=3, overflow="reject")
    assert [mp.submit(f"t{i}".encode()) for i in range(3)] == [mp_.ACCEPTED] * 3
    assert mp.submit(b"t3") == mp_.FULL
    assert mp.pending_count == 3
    assert mp.stats()["rejected_full"] == 1
    assert mp.stats()["evictions"] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_byte_cap_reject(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(max_bytes=100, event_max_bytes=100)
    assert mp.submit(b"a" * 60) == mp_.ACCEPTED
    assert mp.submit(b"b" * 60) == mp_.FULL  # 120 > 100
    assert mp.submit(b"c" * 40) == mp_.ACCEPTED  # fits exactly
    assert mp.pending_bytes == 100


@pytest.mark.parametrize("pkg", PKGS)
def test_evict_oldest_policy(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(max_txs=3, overflow="evict-oldest")
    for i in range(3):
        mp.submit(f"t{i}".encode())
    assert mp.submit(b"t3") == mp_.ACCEPTED  # t0 evicted
    assert mp.pending_txs() == [b"t1", b"t2", b"t3"]
    assert mp.stats()["evictions"] == 1
    # byte-cap eviction can shed several oldest entries for one big tx
    mp2 = mp_.Mempool(max_bytes=100, event_max_bytes=100,
                  overflow="evict-oldest")
    mp2.submit(b"a" * 40)
    mp2.submit(b"b" * 40)
    assert mp2.submit(b"c" * 90) == mp_.ACCEPTED
    assert mp2.pending_txs() == [b"c" * 90]
    assert mp2.stats()["evictions"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_oversized(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(event_max_bytes=64)
    assert mp.submit(b"x" * 65) == mp_.OVERSIZED
    assert mp.submit(b"x" * 64) == mp_.ACCEPTED
    assert mp.stats()["rejected_oversized"] == 1


# -- unit: dedup ------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_pending_and_inflight_dedup(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(event_max_txs=1)
    assert mp.submit(b"tx") == mp_.ACCEPTED
    assert mp.submit(b"tx") == mp_.DUPLICATE
    # drained into an event but not committed: STILL a duplicate (the
    # commit/retry window must not re-admit)
    batch = mp.drain()
    assert batch == [b"tx"]
    assert mp.pending_count == 0
    assert mp.submit(b"tx") == mp_.DUPLICATE
    assert mp.stats()["rejected_dup"] == 2
    assert mp.stats()["in_flight"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_committed_lru_dedup(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool()
    mp.submit(b"tx")
    drained = mp.drain()
    mp.mark_committed(drained)
    assert mp.submit(b"tx") == mp_.ALREADY_COMMITTED
    assert mp.stats()["committed_dedup_hits"] == 1
    assert mp.stats()["in_flight"] == 0
    # commit of a tx arriving via ANOTHER node's event drops our pending
    # copy before it can double-commit
    mp.submit(b"other")
    mp.mark_committed([b"other"])
    assert mp.pending_count == 0
    assert mp.stats()["commit_drops"] == 1
    assert mp.submit(b"other") == mp_.ALREADY_COMMITTED


@pytest.mark.parametrize("pkg", PKGS)
def test_committed_lru_bounded(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(committed_lru=4)
    for i in range(8):
        tx = f"c{i}".encode()
        mp.submit(tx)
        mp.mark_committed(mp.drain())
    # oldest hashes aged out of the window: re-admission is possible again
    assert mp.submit(b"c0") == mp_.ACCEPTED
    assert mp.submit(b"c7") == mp_.ALREADY_COMMITTED


# -- unit: drain fairness and requeue ---------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_fifo_and_event_caps(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(event_max_txs=3)
    for i in range(7):
        mp.submit(f"t{i}".encode())
    assert mp.drain() == [b"t0", b"t1", b"t2"]
    assert mp.drain() == [b"t3", b"t4", b"t5"]
    assert mp.drain() == [b"t6"]
    assert mp.drain() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_byte_cap(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(event_max_bytes=100)
    mp.submit(b"a" * 60)
    mp.submit(b"b" * 60)
    mp.submit(b"c" * 10)
    # first fits alone; second would exceed 100 so the batch cuts there
    assert mp.drain() == [b"a" * 60]
    assert mp.drain() == [b"b" * 60, b"c" * 10]


@pytest.mark.parametrize("pkg", PKGS)
def test_requeue_preserves_fifo(pkg):
    mp_ = _m(pkg, "mempool")
    mp = mp_.Mempool(event_max_txs=2)
    for i in range(4):
        mp.submit(f"t{i}".encode())
    batch = mp.drain()
    assert batch == [b"t0", b"t1"]
    mp.requeue(batch)
    # requeued batch sits at the FRONT, ahead of t2/t3
    assert mp.pending_txs() == [b"t0", b"t1", b"t2", b"t3"]
    assert mp.stats()["in_flight"] == 0
    assert mp.stats()["requeued"] == 2
    # a tx committed while in flight is NOT requeued
    batch = mp.drain()
    mp.mark_committed([b"t0"])
    mp.requeue(batch)
    assert mp.pending_txs() == [b"t1", b"t2", b"t3"]


# -- unit: rate limiter -----------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_token_bucket_deterministic_under_fake_clock(pkg):
    mp_ = _m(pkg, "mempool")
    t = {"now": 0.0}
    bucket = mp_.TokenBucket(rate=10.0, burst=5.0, clock=lambda: t["now"])
    # burst drains, then refusal — byte-identical on every run
    assert [bucket.try_acquire() for _ in range(6)] == [True] * 5 + [False]
    t["now"] = 0.1  # one token refilled
    assert bucket.try_acquire() is True
    assert bucket.try_acquire() is False
    t["now"] = 10.0  # refill clamps at burst
    assert [bucket.try_acquire() for _ in range(6)] == [True] * 5 + [False]


@pytest.mark.parametrize("pkg", PKGS)
def test_mempool_throttles_deterministically(pkg):
    mp_ = _m(pkg, "mempool")
    t = {"now": 0.0}
    mp = mp_.Mempool(rate_tx_s=5.0, burst=2.0, clock=lambda: t["now"])
    verdicts = [mp.submit(f"r{i}".encode()) for i in range(4)]
    assert verdicts == [mp_.ACCEPTED, mp_.ACCEPTED, mp_.THROTTLED, mp_.THROTTLED]
    assert mp.stats()["rejected_throttled"] == 2
    # dedup outranks the bucket: a retry of a pending tx costs no token
    # and is reported precisely even while throttled
    assert mp.submit(b"r0") == mp_.DUPLICATE
    t["now"] = 0.2  # one token back
    assert mp.submit(b"r4") == mp_.ACCEPTED
    assert mp.submit(b"r5") == mp_.THROTTLED


# -- verdict plumbing through the proxies -----------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_inmem_proxy_returns_verdicts(pkg):
    mp_ = _m(pkg, "mempool")
    proxy = _m(pkg, "proxy.proxy").InmemProxy(_m(pkg, "dummy.state").State())
    # before a node attaches: queue fallback reports accepted
    assert proxy.submit_tx(b"early") == "accepted"
    assert proxy.submit_queue().get_nowait() == b"early"
    mp = mp_.Mempool(max_txs=1)
    proxy.set_submit_handler(mp.submit)
    assert proxy.submit_tx(b"a") == mp_.ACCEPTED
    assert proxy.submit_tx(b"a") == mp_.DUPLICATE
    assert proxy.submit_tx(b"b") == mp_.FULL


@pytest.mark.parametrize("pkg", PKGS)
def test_socket_pair_verdict_round_trip(pkg):
    """SubmitTx carries the verdict string across the wire; a bare proxy
    (no node attached) still answers the reference's ``true`` which maps
    to "accepted" client-side."""
    mp_ = _m(pkg, "mempool")
    sp = _m(pkg, "proxy.socket_proxy")
    babble_proxy = sp.SocketAppProxy("127.0.0.1:0", client_addr="")
    app_proxy = sp.SocketBabbleProxy(
        "127.0.0.1:0", babble_proxy.addr, _m(pkg, "dummy.state").State()
    )
    babble_proxy.set_client_addr(app_proxy.addr)
    try:
        # bare proxy: queue fallback, wire-compatible bool
        assert app_proxy.submit_tx(b"pre") == "accepted"
        assert babble_proxy.submit_queue().get(timeout=5) == b"pre"
        # with the mempool attached: verdicts cross the wire
        mp = mp_.Mempool(max_txs=1)
        babble_proxy.set_submit_handler(mp.submit)
        assert app_proxy.submit_tx(b"x") == mp_.ACCEPTED
        assert app_proxy.submit_tx(b"x") == mp_.DUPLICATE
        assert app_proxy.submit_tx(b"y") == mp_.FULL
        mp.mark_committed(mp.drain())
        assert app_proxy.submit_tx(b"x") == mp_.ALREADY_COMMITTED
    finally:
        babble_proxy.close()
        app_proxy.close()


# -- node integration -------------------------------------------------------


def _make_cluster(pkg: str, n: int, mempool_max_txs: int = 20000,
                  overflow: str = "reject", heartbeat: float = 0.01):
    """``n`` nodes of package ``pkg`` over one inmem network, each with the
    dummy app behind an InmemProxy, on keys from a fixed seed."""
    keys = _m(pkg, "crypto.keys")
    Peer = _m(pkg, "peers.peer").Peer
    PeerSet = _m(pkg, "peers.peer_set").PeerSet
    network = _m(pkg, "net.inmem").InmemNetwork()
    rng = random.Random(4242 + n)
    privs = [keys.PrivateKey(rng.randrange(1, 2**255)) for _ in range(n)]
    peers = PeerSet([Peer(f"inmem://m{i}", k.public_key.hex(), f"m{i}")
                     for i, k in enumerate(privs)])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}
    nodes, proxies, states = [], [], []
    for i, k in enumerate(privs):
        conf = _m(pkg, "config.config").Config(
            heartbeat_timeout=heartbeat,
            slow_heartbeat_timeout=0.2,
            moniker=f"m{i}",
            log_level="error",
            mempool_max_txs=mempool_max_txs,
            mempool_overflow=overflow,
        )
        st = _m(pkg, "dummy.state").State()
        proxy = _m(pkg, "proxy.proxy").InmemProxy(st)
        node = _m(pkg, "node.node").Node(
            conf, _m(pkg, "node.validator").Validator(k, f"m{i}"), peers,
            peers, _m(pkg, "hashgraph.store").InmemStore(conf.cache_size),
            network.new_transport(addr_of[k.public_key.hex()]), proxy)
        node.init()
        nodes.append(node)
        proxies.append(proxy)
        states.append(st)
    return nodes, proxies, states


@pytest.mark.parametrize("pkg", PKGS)
def test_node_stats_and_service_surface(pkg):
    """mempool_* counters ride get_stats, and get_mempool serves the
    /mempool endpoint payload (knobs + counters)."""
    mp_ = _m(pkg, "mempool")
    nodes, proxies, states = _make_cluster(pkg, 1, mempool_max_txs=2)
    try:
        assert proxies[0].submit_tx(b"s1") == mp_.ACCEPTED
        assert proxies[0].submit_tx(b"s1") == mp_.DUPLICATE
        assert proxies[0].submit_tx(b"s2") == mp_.ACCEPTED
        assert proxies[0].submit_tx(b"s3") == mp_.FULL
        stats = nodes[0].get_stats()
        assert stats["mempool_pending"] == "2"
        assert stats["mempool_accepted"] == "2"
        assert stats["mempool_rejected_dup"] == "1"
        assert stats["mempool_rejected_full"] == "1"
        assert stats["transaction_pool"] == "2"
        mp = nodes[0].get_mempool()
        assert mp["config"]["max_txs"] == 2
        assert mp["config"]["overflow"] == "reject"
        assert mp["stats"]["pending"] == 2
        # the /mempool service endpoint serves the same payload
        svc = _m(pkg, "service.service").Service("127.0.0.1:0", nodes[0])
        svc.serve_async()
        try:
            with urllib.request.urlopen(
                f"http://{svc.bind_addr}/mempool", timeout=5.0
            ) as r:
                body = json.load(r)
            assert body["config"]["max_txs"] == 2
            assert body["stats"]["pending"] == 2
            assert body["stats"]["rejected_full"] == 1
        finally:
            svc.shutdown()
    finally:
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_of_committed_tx_reports_already_committed(pkg):
    """Single-node monologue: a committed transaction retried by the
    client is refused with already_committed, not committed twice."""
    mp_ = _m(pkg, "mempool")
    nodes, proxies, states = _make_cluster(pkg, 1)
    try:
        nodes[0].run_async()
        assert proxies[0].submit_tx(b"once") == mp_.ACCEPTED
        deadline = time.monotonic() + 60
        while (
            b"once" not in states[0].committed_txs
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        assert states[0].committed_txs.count(b"once") == 1
        assert proxies[0].submit_tx(b"once") == mp_.ALREADY_COMMITTED
        time.sleep(0.5)
        assert states[0].committed_txs.count(b"once") == 1
    finally:
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_overload_soak_bounded_and_exactly_once(pkg):
    """Submit rate ≫ commit rate against a small admission cap: pending
    never exceeds the cap, a nonzero share is shed, and every accepted
    transaction commits exactly once on every node (no loss, no
    duplicate commit). The flood runs until ``full`` has fired several
    times, whatever the host's speed, not for a fixed count."""
    mp_ = _m(pkg, "mempool")
    cap = 256
    target_sheds = 10
    max_flood = 50000
    nodes, proxies, states = _make_cluster(pkg, 3, mempool_max_txs=cap)
    try:
        for n in nodes:
            n.run_async()
        accepted = []
        verdicts = {"accepted": 0, "full": 0, "other": 0}
        pending_max = 0
        i = 0
        while i < max_flood and verdicts["full"] < target_sheds:
            tx = f"soak tx {i}".encode()
            i += 1
            v = proxies[0].submit_tx(tx)
            if v == mp_.ACCEPTED:
                accepted.append(tx)
                verdicts["accepted"] += 1
            elif v == mp_.FULL:
                verdicts["full"] += 1
            else:
                verdicts["other"] += 1
            pending = nodes[0].core.mempool.pending_count
            pending_max = max(pending_max, pending)
        assert pending_max <= cap, f"pending {pending_max} exceeded cap {cap}"
        assert verdicts["full"] >= target_sheds, (
            f"no shedding after {i} txs: {verdicts}"
        )
        assert verdicts["accepted"] >= cap  # cap itself plus drain headroom

        # drain phase: every accepted tx must commit (exactly once) on
        # EVERY node — the wait covers all of them, so the per-node
        # assertions below can't race the last node's commit lag
        deadline = time.monotonic() + 120
        want = set(accepted)
        while time.monotonic() < deadline:
            if all(want.issubset(set(st.committed_txs)) for st in states):
                break
            time.sleep(0.05)
        committed = states[0].committed_txs
        missing = want - set(committed)
        assert not missing, f"{len(missing)} accepted txs never committed"
        for tx in accepted:
            assert committed.count(tx) == 1, f"duplicate commit of {tx!r}"
        # all nodes agree (commit feed kept every mempool's LRU coherent)
        for st in states[1:]:
            assert want.issubset(set(st.committed_txs))
        assert nodes[0].core.mempool.stats()["rejected_full"] > 0
    finally:
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_evict_oldest_under_node_load(pkg):
    """evict-oldest policy: admission never reports full; the oldest
    pending transactions are shed instead and counted."""
    mp_ = _m(pkg, "mempool")
    nodes, proxies, states = _make_cluster(
        pkg, 1, mempool_max_txs=8, overflow="evict-oldest"
    )
    try:
        # node NOT running: pure admission behavior
        for i in range(32):
            assert proxies[0].submit_tx(f"e{i}".encode()) == mp_.ACCEPTED
        mp = nodes[0].core.mempool
        assert mp.pending_count == 8
        assert mp.stats()["evictions"] == 24
        assert mp.pending_txs()[0] == b"e24"
    finally:
        for n in nodes:
            n.shutdown()
