"""The port's offload through a reset, a flapping device and the matrix of
stores and transports, against the JAX package.

Twins of the JAX package's accelerated resilience tests, through the port's
own API (device ``"cpu"``, K1's plain version):

- tests/test_hardening.py::test_reset_invalidates_inflight_sweep_without_
  corruption: a pipelined sweep (holding an admission slot, or riding a
  sweep batcher ticket) dropped by ``invalidate()`` before it applies;
- tests/test_breaker.py's accel cases: injected failures open the device
  breaker, an open breaker refuses flushes before the device is touched, a
  probe after the cooldown closes it, fewer failures keep it closed. The
  port's offload falls back only on a ``StoreError`` (any other error on
  the device path raises out of ``flush``), so the failures injected are
  store errors where the JAX test raises ``RuntimeError``;
- tests/test_matrix_cells.py: the offload writing through the persistent
  store, a batched offload gossip cluster, and a relay-to-direct upgrade
  with the offload;
- tests/test_signal.py::test_gossip_over_relay_with_accelerator.
"""

from __future__ import annotations

import threading
import time

import pytest

from babble_tpu.hashgraph.accel import TensorConsensus as JTensorConsensus
from babble_tpu_torch.common.breaker import CLOSED, OPEN, CircuitBreaker
from babble_tpu_torch.common.errors import StoreError, StoreErrorKind
from babble_tpu_torch.config.config import Config
from babble_tpu_torch.crypto.keys import generate_key
from babble_tpu_torch.dummy.state import State as DummyState
from babble_tpu_torch.hashgraph import Hashgraph
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.hashgraph.persistent_store import PersistentStore
from babble_tpu_torch.hashgraph.store import InmemStore
from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
from babble_tpu_torch.net.inmem import InmemNetwork
from babble_tpu_torch.net.signal import SignalServer, SignalTransport
from babble_tpu_torch.node.node import Node
from babble_tpu_torch.node.validator import Validator
from babble_tpu_torch.ops import voting
from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet
from babble_tpu_torch.proxy.proxy import InmemProxy

from tests.test_accel import BUILDERS, _ordered_events
from tests.test_torch_accel import _assert_same, _jax_replay, _port_unflushed
from tests.test_torch_membership import check_gossip
from tests.test_torch_node import bombard_and_wait, make_nodes
from tests.test_torch_voting import port_events, port_hashgraph_like


# -- a reset while a sweep is in flight ---------------------------------------


def drain(h, timeout: float = 30.0) -> None:
    """Flush until no sweep is in flight, on the wall clock: a batcher
    ticket lands when the dispatcher has swept it, some ms after it was
    queued."""
    h._accel_pending = max(h._accel_pending, 1)
    h.flush_consensus()
    deadline = time.monotonic() + timeout
    while h.accel.busy():
        assert time.monotonic() < deadline, "pipelined sweeps never drained"
        time.sleep(0.001)
        h.flush_consensus()


class _Running:
    """A CUDA event stand-in for a sweep still on the card."""

    def query(self) -> bool:
        return False


@pytest.mark.parametrize("path", ["slot", "batcher"])
def test_reset_drops_inflight_sweep_and_frees_its_slot(monkeypatch, path):
    """Half the stream, a flush that launches a pipelined sweep, then
    ``invalidate()`` (what ``Hashgraph.reset`` calls on a fast-sync
    landing) before the sweep applies: the sweep is dropped and counted in
    ``stale_drops``, its admission slot (or batcher ticket) no longer holds
    the node, and consensus over the rest of the stream equals the oracle."""
    h0, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)
    slots = threading.Semaphore(1)
    monkeypatch.setattr(
        "babble_tpu_torch.hashgraph.accel._inflight_slots", lambda: slots)
    h = port_hashgraph_like(oracle)
    acc = TensorConsensus(device="cpu", sweep_events=10**9, min_window=0,
                          pipeline=True, batcher=(path == "batcher"))
    h.accel = acc
    events = port_events(ordered)
    half = len(events) // 2
    batcher = SweepBatcher.instance()
    held = batcher._lock if path == "batcher" else threading.RLock()
    with held:  # the batcher's dispatcher waits: the ticket stays open
        for ev in events[:half]:
            ev.prevalidate(True)
            h.insert_event_and_run_consensus(ev, set_wire_info=True)
        h.flush_consensus()
        inf = acc._inflight
        assert inf is not None and acc.busy(), "no sweep was launched"
        if path == "slot":
            # on the CPU the sweep is done at launch: make it look as if it
            # were still on the card, holding the one slot
            assert slots.acquire(blocking=False)
            inf.done = _Running()
            inf.hold(slots, inf.t_enqueued)
            assert not slots.acquire(blocking=False)
        else:
            assert not inf.ticket.done.is_set()
        assert acc.stale_drops == 0
        acc.invalidate()
    assert acc.stale_drops == 1 and not acc.busy()
    if path == "slot":
        assert inf.slots is None and slots.acquire(blocking=False)
        slots.release()
    for ev in events[half:]:
        ev.prevalidate(True)
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    drain(h)
    h.process_sig_pool()
    assert acc.sweeps > 0 and acc.fallbacks == 0
    _assert_same(h, oracle)


# -- the device breaker -------------------------------------------------------


class FakeClock:
    """A clock the test moves: monotonic for the breaker, perf_counter for
    the offload's stage timers."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _breaker_fixture(monkeypatch, how: str):
    """tests/test_breaker.py::_accel_fixture on the port: the consensus DAG
    inserted with its sweep still to run, and an offload whose breaker
    opens after 2 failures and cools down for 5 s on a fake clock, given
    as ``breaker=`` or read from BABBLE_ACCEL_BREAKER_* with ``clock=``.
    Without resident windows, so the window build is the snapshot the
    failures are injected into."""
    clock = FakeClock()
    if how == "argument":
        kw = {"breaker": CircuitBreaker(threshold=2, window_s=60.0,
                                        cooldown_s=5.0, clock=clock)}
    else:
        monkeypatch.setenv("BABBLE_ACCEL_BREAKER_N", "2")
        monkeypatch.setenv("BABBLE_ACCEL_BREAKER_WINDOW_S", "60")
        monkeypatch.setenv("BABBLE_ACCEL_BREAKER_COOLDOWN_S", "5")
        kw = {"clock": clock}
    oracle, hg = _port_unflushed("consensus", pipeline=False, resident=False,
                                 **kw)
    return oracle, hg, hg.accel.breaker, clock


def _evicted(_hg=None):
    raise StoreError("Event", StoreErrorKind.TOO_LATE, "injected eviction")


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_breaker_opens_skips_and_recloses_on_a_probe(monkeypatch, how):
    """Two injected failures (M >= N) open the breaker; while it is open a
    flush is refused before the device is touched (the injected failure
    does not fire again); after the cooldown the probe sweep runs for real
    and closes it, and consensus equals the oracle."""
    oracle, hg, breaker, clock = _breaker_fixture(monkeypatch, how)
    accel = hg.accel
    assert breaker.state == CLOSED
    calls = {"n": 0}

    def boom(_hg):
        calls["n"] += 1
        _evicted()

    monkeypatch.setattr(voting, "build_voting_window", boom)
    for _ in range(2):
        assert accel.flush(hg) is False
    assert accel.fallbacks == 2 and calls["n"] == 2
    assert breaker.state == OPEN
    assert accel.stats()["accel_breaker_open"] == 1

    assert accel.flush(hg) is False
    assert calls["n"] == 2 and accel.fallbacks == 2, "the device was touched"
    assert accel.stats()["accel_breaker_skips"] >= 1
    clock.advance(4.9)
    assert accel.flush(hg) is False and calls["n"] == 2

    monkeypatch.undo()
    clock.advance(1.1)
    assert accel.flush(hg) is True  # the probe sweep ran and succeeded
    assert breaker.state == CLOSED
    s = accel.stats()
    assert s["accel_breaker_probes"] >= 1
    assert s["accel_breaker_state"] == CLOSED
    assert accel.sweeps == 1
    hg.flush_consensus()
    _assert_same(hg, oracle)


def test_breaker_below_threshold_keeps_the_device(monkeypatch):
    """One failure (M < N): the breaker stays closed and the next flush
    reaches the device again."""
    oracle, hg, breaker, _clock = _breaker_fixture(monkeypatch, "argument")
    accel = hg.accel
    real = voting.build_voting_window
    calls = {"n": 0}

    def flaky(h):
        calls["n"] += 1
        if calls["n"] == 1:
            _evicted()
        return real(h)

    monkeypatch.setattr(voting, "build_voting_window", flaky)
    assert accel.flush(hg) is False  # the one failure rode the oracle
    assert breaker.state == CLOSED and accel.fallbacks == 1
    assert accel.flush(hg) is True
    assert calls["n"] == 2 and accel.sweeps == 1
    assert accel.stats()["accel_breaker_skips"] == 0
    hg.flush_consensus()
    _assert_same(hg, oracle)


def test_breaker_stats_names_match_the_jax_package():
    """The ``accel_breaker_*`` keys of ``stats()`` are the JAX package's."""
    port = {k for k in TensorConsensus(device="cpu").stats()
            if k.startswith("accel_breaker_")}
    jax = {k for k in JTensorConsensus(async_compile=False).stats()
           if k.startswith("accel_breaker_")}
    assert port == jax and len(port) >= 5


# -- the matrix cells ---------------------------------------------------------


@pytest.mark.parametrize("graph", ["consensus", "funky_full"])
def test_offload_with_persistent_store_matches_oracle(graph, tmp_path):
    """Device sweeps writing through the SQLite store decide as the oracle
    does, and a cold reopen of the database holds the oracle's last
    block."""
    h0, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)
    path = str(tmp_path / f"{graph}.db")
    store = PersistentStore(cache_size=1000, path=path)
    h = Hashgraph(store)
    h.init(port_hashgraph_like(oracle).store.get_peer_set(0))
    h.accel = TensorConsensus(device="cpu", sweep_events=8, min_window=0)
    for ev in port_events(ordered):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    h.flush_consensus()
    assert h.accel.fallbacks == 0 and h.accel.sweeps > 0
    _assert_same(h, oracle)
    store.close()
    cold = PersistentStore(cache_size=1000, path=path)
    try:
        assert cold.db_last_block_index() == oracle.store.last_block_index()
    finally:
        cold.close()


def test_batched_offload_gossip_cluster(monkeypatch):
    """Four port nodes whose sweeps all ride the sweep batcher: blocks
    commit, byte-identical, with no fallback."""
    monkeypatch.setenv("BABBLE_ACCEL_BATCH", "1")
    nodes, proxies = make_nodes(4, InmemNetwork(), accelerator=True,
                                accelerator_device="cpu")
    for n in nodes:
        n.core.hg.accel = TensorConsensus(device="cpu", min_window=0,
                                          batcher=True)
    batcher = SweepBatcher.instance()
    windows0 = batcher.stats()["batch_windows"]
    try:
        for n in nodes:
            n.run_async()
        bombard_and_wait(nodes, proxies, 2, timeout=90.0)
        check_gossip(nodes, 0, 2)
    finally:
        for n in nodes:
            n.shutdown()
    assert all(n.core.hg.accel.fallbacks == 0 for n in nodes)
    assert any(n.core.hg.accel.sweeps > 0 for n in nodes)
    assert batcher.stats()["batch_windows"] > windows0


def make_relay_cluster(server, n: int, prefix: str, direct: bool = False):
    """tests/test_signal.py::make_relay_cluster with port nodes, each with
    the offload on the CPU: ``n`` nodes that gossip only through the relay
    (a peer's address is its public key), and with ``direct`` also listen
    for the direct upgrade."""
    keys = [generate_key() for _ in range(n)]
    peers = PeerSet([Peer(k.public_key.hex(), k.public_key.hex(),
                          f"{prefix}{i}") for i, k in enumerate(keys)])
    nodes, proxies = [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                      log_level="warning", moniker=f"{prefix}{i}",
                      accelerator=True, accelerator_device="cpu")
        trans = SignalTransport(
            server.addr(), k,
            direct_listen="127.0.0.1:0" if direct else None)
        pr = InmemProxy(DummyState())
        node = Node(conf, Validator(k, f"{prefix}{i}"), peers, peers,
                    InmemStore(conf.cache_size), trans, pr)
        node.init()
        node.core.hg.accel = TensorConsensus(device="cpu", min_window=0)
        nodes.append(node)
        proxies.append(pr)
    return nodes, proxies


@pytest.fixture
def relay():
    srv = SignalServer("127.0.0.1:0")
    srv.listen()
    yield srv
    srv.close()


def test_gossip_over_relay_with_offload(relay):
    """Device sweeps riding the relay transport: blocks byte-identical,
    sweeps on every node, no fallback."""
    nodes, proxies = make_relay_cluster(relay, 2, "ra")
    try:
        for n in nodes:
            n.run_async()
        bombard_and_wait(nodes, proxies, 1, timeout=90.0)
        check_gossip(nodes, 0, 1)
    finally:
        for n in nodes:
            n.shutdown()
    for n in nodes:
        assert n.core.hg.accel.sweeps > 0
        assert n.core.hg.accel.fallbacks == 0


def test_direct_upgrade_with_offload(relay):
    """Device sweeps over the direct links after a relay-signalled
    upgrade, still committing after the relay is gone."""
    nodes, proxies = make_relay_cluster(relay, 2, "dacc", direct=True)
    try:
        for n in nodes:
            n.run_async()
        bombard_and_wait(nodes, proxies, 1, timeout=90.0)

        def all_direct() -> bool:
            for n in nodes:
                with n.trans._dlock:
                    if not n.trans._direct:
                        return False
            return True

        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not all_direct():
            time.sleep(0.2)
        assert all_direct(), "pair never upgraded to a direct link"
        relay.close()
        time.sleep(0.3)
        mark = max(n.get_last_block_index() for n in nodes)
        bombard_and_wait(nodes, proxies, mark + 1, timeout=60.0)
        check_gossip(nodes, 0, mark + 1)
    finally:
        for n in nodes:
            n.shutdown()
    for n in nodes:
        assert n.core.hg.accel.sweeps > 0
        assert n.core.hg.accel.fallbacks == 0
