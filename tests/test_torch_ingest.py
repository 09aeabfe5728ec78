"""Twins of tests/test_ingest_fastpath.py, the batched-ingest fast path:
one native batch verification per incoming sync, the scalar re-check that
pinpoints a bad event after a batch failure, decode and verification
outside the core lock, the lock's contention accounting, the event
serialization memo's invalidation, and commit before publish. Each case
runs through both packages (``pkg``) on keys from a fixed seed; the cores
come from tests/test_torch_core.py's own ``init_cores``.

Tolerance: exact (counters, event indexes, hashes)."""

from __future__ import annotations

import importlib
import random
import threading
import time

import pytest

from tests.test_torch_core import (
    CONSENSUS_PLAYBOOK,
    PKGS,
    init_cores,
    sync_and_run_consensus,
)


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _host_batch(pkg: str):
    batch = _m(pkg, "crypto.batch")
    if not batch.available():
        pytest.skip("native batch verifier unavailable")
    return batch


def _node_pair(pkg: str, network):
    """Two nodes of ``pkg`` over ``network`` (tests/test_node.py's
    make_cluster at its defaults), on keys from a fixed seed."""
    keys = _m(pkg, "crypto.keys")
    Peer = _m(pkg, "peers.peer").Peer
    rng = random.Random(77)
    privs = [keys.PrivateKey(rng.randrange(1, 2**255)) for _ in range(2)]
    peers = _m(pkg, "peers.peer_set").PeerSet(
        [Peer(net_addr=f"inmem://node{i}", pub_key_hex=k.public_key.hex(),
              moniker=f"node{i}") for i, k in enumerate(privs)])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}
    nodes = []
    for i, k in enumerate(privs):
        conf = _m(pkg, "config.config").Config(
            heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
            moniker=f"node{i}", log_level="warning")
        node = _m(pkg, "node.node").Node(
            conf, _m(pkg, "node.validator").Validator(k, f"node{i}"), peers,
            peers, _m(pkg, "hashgraph.store").InmemStore(conf.cache_size),
            network.new_transport(addr_of[k.public_key.hex()]),
            _m(pkg, "proxy.proxy").InmemProxy(_m(pkg, "dummy.state").State()))
        node.init()
        nodes.append(node)
    return nodes


# -- one batch verify per sync -------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_happy_path_one_batch_verify_per_sync(pkg):
    _host_batch(pkg)
    cores, _, _ = init_cores(pkg, 2)
    for _ in range(3):
        cores[0].add_self_event("")
    diff = cores[0].event_diff(cores[1].known_events())
    wires = cores[0].to_wire(diff)
    assert len(wires) >= 4  # the initial event and 3 chained

    before = cores[1].ingest_batch_verifies
    cores[1].sync(cores[0].validator.id(), wires)
    assert cores[1].ingest_batch_verifies == before + 1
    assert cores[1].ingest_batch_size_max >= len(wires)
    assert cores[1].ingest_fallback_singles == 0
    assert (cores[1].known_events()[cores[0].validator.id()]
            == diff[-1].index())


@pytest.mark.parametrize("pkg", PKGS)
def test_mixed_valid_invalid_sync_pinpoints_bad_event(pkg):
    _host_batch(pkg)
    WireEvent = _m(pkg, "hashgraph.event").WireEvent
    cores, _, _ = init_cores(pkg, 2)
    for _ in range(2):
        cores[0].add_self_event("")
    diff = cores[0].event_diff(cores[1].known_events())
    wires = list(cores[0].to_wire(diff))
    assert len(wires) == 3
    # a decodable but wrong signature on the middle event, on a copy of its
    # WireEvent (to_wire() memoizes: mutating it would poison core 0's)
    bad_index = 1
    wires[bad_index] = WireEvent(body=wires[bad_index].body, signature="1|1")
    bad_hex = diff[bad_index].hex()

    fallbacks_before = cores[1].ingest_fallback_singles
    with pytest.raises(ValueError) as exc:
        cores[1].sync(cores[0].validator.id(), wires)
    assert bad_hex in str(exc.value)
    # the batch flagged it; the scalar pass re-checked only it
    assert cores[1].ingest_fallback_singles == fallbacks_before + 1
    # the valid prefix went in, the suffix after the offender did not
    assert (cores[1].known_events()[cores[0].validator.id()]
            == diff[bad_index - 1].index())


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_artifact_cannot_reject_valid_event(pkg):
    """A batch verdict of False on every event is re-checked by the scalar
    path, so no valid event is rejected."""
    host_batch = _host_batch(pkg)
    cores, _, _ = init_cores(pkg, 2)
    cores[0].add_self_event("")
    diff = cores[0].event_diff(cores[1].known_events())
    wires = cores[0].to_wire(diff)

    orig = host_batch.prevalidate_events_host

    def all_flagged(events):
        for ev in events:
            ev.prevalidate(False)
        return True

    host_batch.prevalidate_events_host = all_flagged
    try:
        cores[1].sync(cores[0].validator.id(), wires)
    finally:
        host_batch.prevalidate_events_host = orig
    assert cores[1].ingest_fallback_singles >= len(wires)
    assert (cores[1].known_events()[cores[0].validator.id()]
            == diff[-1].index())


# -- verification happens outside the core lock ---------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_signature_verification_outside_core_lock(pkg):
    """The eager-sync handler decodes and batch-verifies before it takes
    the core lock; only the insert sweep runs under it."""
    host_batch = _host_batch(pkg)
    rpc_mod = _m(pkg, "net.rpc")
    nodes = _node_pair(pkg, _m(pkg, "net.inmem").InmemNetwork())
    try:
        a, b = nodes
        b.core.add_self_event("")
        diff = b.core.event_diff(a.core.known_events())
        wires = b.core.to_wire(diff)
        assert wires

        seen = {}
        orig_prev = host_batch.prevalidate_events_host

        def spy_prevalidate(events):
            seen["verify_locked"] = a.core_lock.locked()
            return orig_prev(events)

        orig_insert = a.core.insert_event_and_run_consensus

        def spy_insert(ev, set_wire_info=False):
            seen.setdefault("insert_locked", a.core_lock.locked())
            return orig_insert(ev, set_wire_info)

        host_batch.prevalidate_events_host = spy_prevalidate
        a.core.insert_event_and_run_consensus = spy_insert
        try:
            rpc = rpc_mod.RPC(rpc_mod.EagerSyncRequest(b.get_id(), wires))
            a._process_eager_sync_request(rpc, rpc.command)
            resp, err = rpc.wait(timeout=5.0)
        finally:
            host_batch.prevalidate_events_host = orig_prev
            a.core.insert_event_and_run_consensus = orig_insert

        assert err is None and resp.success
        assert seen["verify_locked"] is False, (
            "batch signature verification ran under the core lock")
        assert seen["insert_locked"] is True, (
            "the insert sweep must still be serialized by the core lock")
    finally:
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_timed_lock_accounts_contention(pkg):
    lock = _m(pkg, "common.timed_lock").TimedLock()
    assert lock.acquire()
    assert lock.locked()
    waited = []

    def contender():
        t0 = time.perf_counter()
        with lock:
            waited.append(time.perf_counter() - t0)

    t = threading.Thread(target=contender)
    t.start()
    time.sleep(0.05)
    lock.release()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert waited and waited[0] >= 0.04
    assert lock.wait_s_total >= 0.04
    assert lock.acquisitions == 2
    assert not lock.locked()


# -- serialization memo invalidation --------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_wire_cache_hits_and_invalidation_on_mutation(pkg):
    event_mod = _m(pkg, "hashgraph.event")
    WIRE_CACHE = event_mod.WIRE_CACHE
    key = _m(pkg, "crypto.keys").PrivateKey(0xE7E47)
    ev = event_mod.Event.new([b"payload"], [], [], ["", ""],
                             key.public_key.bytes(), 0, timestamp=7)
    ev.sign(key)

    h0, m0 = WIRE_CACHE.hits, WIRE_CACHE.misses
    w1 = ev.to_wire()
    w2 = ev.to_wire()
    assert w2 is w1  # one shared WireEvent per event
    assert WIRE_CACHE.misses == m0 + 1
    assert WIRE_CACHE.hits == h0 + 1

    ev.set_wire_info(3, 4, 5, 6)  # wire info invalidates
    w3 = ev.to_wire()
    assert w3 is not w1
    assert w3.body.creator_id == 6

    ev.sign(key)  # so does a new signature
    w4 = ev.to_wire()
    assert w4 is not w3


@pytest.mark.parametrize("pkg", PKGS)
def test_hash_and_normalized_memo_invalidated_on_body_mutation(pkg):
    key = _m(pkg, "crypto.keys").PrivateKey(0xE7E47)
    ev = _m(pkg, "hashgraph.event").Event.new(
        [b"a"], [], [], ["", ""], key.public_key.bytes(), 0, timestamp=1)
    h1 = ev.hash()
    n1 = ev.body.normalized()
    assert ev.body.normalized() is n1

    ev.body.transactions.append(b"b")
    ev.invalidate_hash()
    h2 = ev.hash()
    n2 = ev.body.normalized()
    assert h2 != h1
    assert n2 is not n1
    assert ev.hex() != ""


def test_event_hash_equal_across_packages():
    """The same body (fixed key and timestamp) hashes to the same digest in
    both packages, before and after the same mutation."""
    digests = []
    for pkg in PKGS:
        key = _m(pkg, "crypto.keys").PrivateKey(0xE7E47)
        ev = _m(pkg, "hashgraph.event").Event.new(
            [b"a"], [], [], ["", ""], key.public_key.bytes(), 0, timestamp=1)
        first = ev.hash()
        ev.body.transactions.append(b"b")
        ev.invalidate_hash()
        digests.append((first, ev.hash()))
    assert digests[0] == digests[1]


# -- commit before publish ------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_commit_completes_before_block_is_published(pkg):
    """The commit callback mutates and signs the block body, and set_block
    publishes it; a block published first could have its half-committed
    body hash cached by a reader and signed."""
    canonical_dumps = _m(pkg, "crypto.canonical").canonical_dumps
    sha256 = _m(pkg, "crypto.hashing").sha256
    cores, _, _ = init_cores(pkg, 3)
    core = cores[0]
    seen = []
    orig = core.hg.commit_callback

    def spy(block):
        # at commit time the block is not yet visible in the store
        seen.append(core.hg.store.last_block_index() < block.index())
        return orig(block)

    core.hg.commit_callback = spy
    for from_i, to_i, payload in CONSENSUS_PLAYBOOK:
        sync_and_run_consensus(cores, from_i, to_i, [payload])

    assert seen, "the playbook never reached a commit"
    assert all(seen), "a block was published before its commit completed"
    blk = core.hg.store.get_block(core.hg.store.last_block_index())
    # the signed digest covers the header form (transactions by TxRoot and
    # TxCount, docs/parity.md)
    assert blk.body.hash() == sha256(canonical_dumps(blk.body.header_dict()))


@pytest.mark.parametrize("pkg", PKGS)
def test_block_body_hash_cache_survives_racing_invalidation(pkg):
    """A digest computed against a body that changed mid-walk is not
    brought back as the current hash."""
    BlockBody = _m(pkg, "hashgraph.block").BlockBody
    canonical_dumps = _m(pkg, "crypto.canonical").canonical_dumps
    sha256 = _m(pkg, "crypto.hashing").sha256
    body = BlockBody(index=1, round_received=2, transactions=[b"a"])
    h1 = body.hash()
    # the lost invalidation: a stale digest written back after a mutation
    # bumped the version
    stale = (getattr(body, "_hash_version", 0), h1)
    body.state_hash = b"s" * 32
    object.__setattr__(body, "_hash_cache", stale)
    h2 = body.hash()
    assert h2 != h1
    assert h2 == sha256(canonical_dumps(body.header_dict()))
