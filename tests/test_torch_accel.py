"""The PyTorch port's TensorConsensus against the JAX package, end to end.

Twins of tests/test_accel.py: the same signed events are replayed through
the JAX package's oracle (voting per insert), the JAX package's
TensorConsensus, and the port's Hashgraph with its own TensorConsensus on
the CPU (K1's plain version). Everything consensus decides must be
identical: event hashes, rounds, lamport timestamps, fame, round-received,
committed block bodies byte for byte, and the undetermined set.
"""

from __future__ import annotations

import threading

import pytest

from babble_tpu.crypto.canonical import canonical_dumps as j_dumps
from babble_tpu.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu.hashgraph.accel import TensorConsensus as JTensorConsensus
from babble_tpu.parallel.voting_shard import synthetic_voting_window
from babble_tpu_torch.common.errors import StoreError, StoreErrorKind
from babble_tpu_torch.crypto.canonical import canonical_dumps as p_dumps
from babble_tpu_torch.hashgraph import accel as accel_mod
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.ops import kernels, voting

from tests.test_accel import BUILDERS, _ordered_events
from tests.test_torch_voting import (
    port_events,
    port_hashgraph_like,
    port_peer_set,
)


def _jax_replay(ordered, peer_set, sweep_events=None, peer_sets=()):
    """The JAX package's live pipeline: oracle per insert, or its
    TensorConsensus on the CPU with ``sweep_events``."""
    h = Hashgraph(InmemStore(100000))
    h.init(peer_set)
    for r, ps in peer_sets:
        h.store.set_peer_set(r, ps)
    if sweep_events is not None:
        h.accel = JTensorConsensus(sweep_events=sweep_events,
                                   async_compile=False, min_window=0)
    for ev in ordered:
        h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                         set_wire_info=True)
    h.flush_consensus()
    return h


def _port_replay(like, ordered, **tc_kwargs):
    """The port's live pipeline with its TensorConsensus on the CPU; ``like``
    is a JAX hashgraph whose peer-sets the port copies."""
    h = port_hashgraph_like(like)
    h.accel = TensorConsensus(device="cpu", min_window=0, **tc_kwargs)
    for ev in port_events(ordered):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    if h.accel.pipeline:
        drain_pipelined(h)
    else:
        h.flush_consensus()
    return h


def drain_pipelined(hg, max_iters: int = 200) -> None:
    """Flush a pipelined hashgraph until nothing is in flight: each flush
    applies the in-flight sweep's results and may launch another."""
    hg._accel_pending = max(hg._accel_pending, 1)
    hg.flush_consensus()
    for _ in range(max_iters):
        if not hg.accel.busy():
            return
        hg.flush_consensus()
    raise AssertionError("pipelined sweeps never drained")


def consensus_state(h, dumps):
    """Everything consensus decides, keyed by event hash / round / block;
    block bodies as their canonical bytes."""
    store = h.store
    events = {}
    for pk in store.repertoire_by_pub_key():
        try:
            hashes = store.participant_events(pk, -1)
        except Exception:
            continue
        for eh in hashes:
            ev = store.get_event(eh)
            events[eh] = (ev.round, ev.lamport_timestamp, ev.round_received)
    rounds = {}
    for r in range(store.last_round() + 1):
        try:
            ri = store.get_round(r)
        except Exception:
            continue
        rounds[r] = (
            {x: (e.witness, int(e.famous)) for x, e in ri.created_events.items()},
            sorted(ri.received_events),
        )
    blocks = {
        b: dumps(store.get_block(b).body.to_dict())
        for b in range(store.last_block_index() + 1)
    }
    return events, rounds, blocks, sorted(h.undetermined_events)


def _assert_same(port_h, jax_h):
    p = consensus_state(port_h, p_dumps)
    j = consensus_state(jax_h, j_dumps)
    assert p[0] == j[0], "events: round / lamport / round-received"
    assert p[1] == j[1], "rounds: witnesses, fame, received events"
    assert p[2] == j[2], "committed block bodies"
    assert p[3] == j[3], "undetermined set"


@pytest.mark.parametrize("graph", list(BUILDERS))
@pytest.mark.parametrize("sweep_events", [1, 7, 10_000])
def test_accel_matches_oracle(graph, sweep_events):
    h, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, peer_set)
    jaccel = _jax_replay(ordered, peer_set, sweep_events=sweep_events)
    port = _port_replay(oracle, ordered, sweep_events=sweep_events,
                        pipeline=False)
    assert port.accel.sweeps > 0, "device sweep never ran"
    assert port.accel.fallbacks == 0, "device path fell back to oracle"
    _assert_same(port, oracle)
    _assert_same(port, jaccel)
    assert port.store.last_block_index() == oracle.store.last_block_index()


@pytest.mark.parametrize("graph", list(BUILDERS))
def test_accel_pipelined_matches_oracle(graph):
    """Pipelined mode (the default on a card: each flush applies the
    PREVIOUS sweep's results) converges to the oracle's exact state."""
    h, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, peer_set)
    port = _port_replay(oracle, ordered, sweep_events=3, pipeline=True)
    assert port.accel.sweeps > 0
    assert port.accel.fallbacks == 0
    assert not port.accel.busy()
    _assert_same(port, oracle)


@pytest.mark.parametrize("seed,n_peers", [(11, 4), (12, 6), (13, 9)])
def test_accel_matches_oracle_random_streams(seed, n_peers):
    """Seeded random gossip streams through the JAX oracle and the port's
    device sweep: identical fame, round-received and blocks."""
    h, _ = synthetic_voting_window(
        n_peers=n_peers, n_events=120, seed=seed, peer_change=False
    )
    ordered = _ordered_events(h)
    peer_set = h.store.get_peer_set(0)
    oracle = _jax_replay(ordered, peer_set)
    port = _port_replay(oracle, ordered, sweep_events=13, pipeline=False)
    assert port.accel.sweeps > 0
    assert port.accel.fallbacks == 0
    _assert_same(port, oracle)


@pytest.mark.parametrize("pipeline", [False, True])
def test_accel_matches_oracle_peer_change(pipeline):
    """A peer leaves from round 3 on: rounds of one window vote under two
    peer-sets (S = 2), through the whole live pipeline."""
    h, _ = synthetic_voting_window(
        n_peers=6, n_events=160, seed=3, peer_change=True
    )
    ordered = _ordered_events(h)
    peer_set = h.store.get_peer_set(0)
    later = [(3, h.store.get_peer_set(3))]
    assert len(later[0][1].peers) == len(peer_set.peers) - 1
    oracle = _jax_replay(ordered, peer_set, peer_sets=later)
    jaccel = _jax_replay(ordered, peer_set, sweep_events=17, peer_sets=later)
    port = _port_replay(oracle, ordered, sweep_events=17, pipeline=pipeline)
    assert port.accel.sweeps > 0
    assert port.accel.fallbacks == 0
    _assert_same(port, oracle)
    _assert_same(port, jaccel)


def test_accel_stats_surface():
    """The node-facing stats report the device engine and sweep counters."""
    h, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h)
    kernels.reset_launch_counts()
    port = _port_replay(_jax_replay(ordered, peer_set), ordered,
                        sweep_events=5, pipeline=False)
    s = port.accel.stats()
    assert s["consensus_engine"] == "device"
    assert s["accel_device"] == "cpu"
    assert s["accel_kernel"] == "plain"
    assert s["accel_sweeps"] >= 1
    assert s["accel_fallbacks"] == 0
    assert s["accel_last_window_events"] > 0
    assert s["accel_avg_sweep_ms"] > 0
    assert set(s["accel_stage_ms"]) == {
        "build", "delta_scan", "pack", "dispatch", "readback", "kernel",
        "apply",
    }
    # on the CPU K1 runs its plain version: no kernel launch is counted
    assert kernels.launch_counts()["member_ss_counts"] == 0


def test_accel_small_window_gate_routes_to_oracle():
    """Windows below min_window stay on the host oracle and are counted;
    the result is still the oracle's."""
    h, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, peer_set)
    ph = port_hashgraph_like(oracle)
    ph.accel = TensorConsensus(device="cpu", sweep_events=4,
                               min_window=10_000, pipeline=False)
    for ev in port_events(ordered):
        ph.insert_event_and_run_consensus(ev, set_wire_info=True)
    ph.flush_consensus()
    assert ph.accel.sweeps == 0
    assert ph.accel.small_windows > 0
    _assert_same(ph, oracle)


def _port_unflushed(graph, **tc_kwargs):
    """The oracle's JAX hashgraph and a port hashgraph holding every event
    with its sweep still to run."""
    h, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, peer_set)
    ph = port_hashgraph_like(oracle)
    ph.accel = TensorConsensus(device="cpu", sweep_events=10_000,
                               min_window=0, **tc_kwargs)
    for ev in port_events(ordered):
        ph.insert_event_and_run_consensus(ev, set_wire_info=True)
    return oracle, ph


@pytest.mark.parametrize("pipeline", [False, True])
def test_accel_store_error_falls_back_to_oracle(monkeypatch, pipeline):
    """A store eviction while the window is snapshotted is consensus
    semantics: the oracle carries the flush, it counts in fallbacks, and
    the result is still the oracle's."""
    oracle, ph = _port_unflushed("consensus", pipeline=pipeline)

    def evicted(hg):
        raise StoreError("Event", StoreErrorKind.TOO_LATE, "x")

    monkeypatch.setattr(voting, "build_voting_window", evicted)
    ph.flush_consensus()
    assert ph.accel.fallbacks == 1
    assert ph.accel.sweeps == 0
    assert not ph.accel.busy()
    _assert_same(ph, oracle)


@pytest.mark.parametrize("pipeline", [False, True])
def test_accel_sweep_error_propagates(monkeypatch, pipeline):
    """Any other failure inside a sweep — on a card, a kernel launch or CUDA
    error — propagates out of flush instead of becoming an oracle run, and
    counts no fallback."""
    _oracle, ph = _port_unflushed("consensus", pipeline=pipeline)

    def broken(la, fd, member):
        raise RuntimeError("member_ss_counts: CUDA launch failed with "
                           "cudaError_t 9")

    # K1 behind the operator every sweep calls: single, resident, batched
    monkeypatch.setattr(kernels, "member_ss_counts", broken)
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        ph.flush_consensus()
    assert ph.accel.fallbacks == 0
    assert ph.accel.sweeps == 0


@pytest.mark.parametrize("kwarg", [
    {"mesh": object()}, {"batcher": True}, {"resident": True},
])
def test_unported_modes_raise(kwarg):
    """Only the mesh is still to port: it raises; the batcher and resident
    windows, ported, construct."""
    if "mesh" in kwarg:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TensorConsensus(device="cpu", **kwarg)
        return
    acc = TensorConsensus(device="cpu", **kwarg)
    (name, want), = kwarg.items()
    assert getattr(acc, name) is want


def test_port_peer_set_hashes_match():
    """The peer-set copy the replays rely on hashes like the original."""
    h, _index, _nodes, peer_set = BUILDERS["basic"]()
    assert port_peer_set(peer_set).hash() == peer_set.hash()


# -- admission control and deferral (the node path's sharing of one card) -----


def test_flock_slots_are_shared_across_holders(tmp_path):
    """BABBLE_ACCEL_SLOT_DIR's slots: n flock-guarded files, so two holders
    (processes on one card; here two in one process, each with its own
    open files) never hold more than n between them."""
    a = accel_mod._FlockSlots(str(tmp_path), 2)
    b = accel_mod._FlockSlots(str(tmp_path), 2)
    assert a.acquire() and a.acquire()
    assert not b.acquire()
    a.release()
    assert b.acquire()
    assert not a.acquire()
    with pytest.raises(ValueError):
        a.acquire(blocking=True)


class _NoSlots:
    def acquire(self, blocking=False):
        return False

    def release(self):
        raise AssertionError("released a slot never acquired")


def test_contended_launch_rides_the_oracle(monkeypatch):
    """With every admission slot taken, a pipelined flush lets the oracle
    decide and counts the launch as contended, not as a fallback."""
    monkeypatch.setattr(accel_mod, "_inflight_slots", lambda: _NoSlots())
    h, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, peer_set)
    port = _port_replay(oracle, ordered, sweep_events=3, pipeline=True)
    assert port.accel.sweeps == 0
    assert port.accel.contended > 0
    assert port.accel.fallbacks == 0
    _assert_same(port, oracle)


class _Running:
    """A CUDA event stand-in for a sweep still on the card: ``query()``
    is False until ``land()``."""

    def __init__(self):
        self.landed = False

    def query(self):
        return self.landed

    def land(self):
        self.landed = True


def _hold_running(inf, slots):
    """Make a CPU sweep look as if it were still on the card, holding a
    slot of ``slots`` (its ``start`` unused: device time stays None)."""
    assert slots.acquire(blocking=False)
    inf.done = _Running()
    inf.hold(slots, inf.t_enqueued)


def _device_seconds_none(monkeypatch):
    monkeypatch.setattr(accel_mod._Inflight, "device_seconds",
                        lambda self: None)


def test_flush_defers_while_the_sweep_runs_then_applies(monkeypatch):
    """A flush that finds its sweep still on the device defers (decisions
    land at a later flush) and holds the admission slot until a flush
    finds the sweep landed; then it applies, frees the slot and counts
    the time it held it."""
    _device_seconds_none(monkeypatch)
    oracle, ph = _port_unflushed("consensus", pipeline=True)
    slots = threading.Semaphore(1)
    ph.flush_consensus()
    inf = ph.accel._inflight
    assert inf is not None and inf.slots is None  # CPU: freed at launch
    _hold_running(inf, slots)
    ph._accel_pending = 1
    ph.flush_consensus()
    assert ph.accel.deferred == 1 and ph.accel.busy()
    assert ph.accel.sweeps == 0
    assert not slots.acquire(blocking=False)  # still held
    inf.done.land()
    ph._accel_pending = 1
    ph.flush_consensus()
    assert ph.accel.sweeps == 1 and not ph.accel.busy()
    assert inf.slots is None and slots.acquire(blocking=False)
    assert ph.accel.slot_held_s >= 0.0 and ph.accel.fallbacks == 0
    _assert_same(ph, oracle)


def test_sweep_outliving_the_readback_timeout_raises(monkeypatch):
    """A sweep still not done ``readback_timeout_s`` after it was enqueued
    (a wedged card) raises out of flush: it is not a fallback, and the
    oracle does not quietly take the node over."""
    _device_seconds_none(monkeypatch)
    _oracle, ph = _port_unflushed("consensus", pipeline=True)
    ph.flush_consensus()
    inf = ph.accel._inflight
    _hold_running(inf, threading.Semaphore(1))
    ph.accel.readback_timeout_s = 0.0
    ph._accel_pending = 1
    with pytest.raises(TimeoutError, match="not done"):
        ph.flush_consensus()
    assert ph.accel.fallbacks == 0 and ph.accel.sweeps == 0
    assert ph.accel.busy()  # the next flush raises again


def test_launch_reaps_landed_sweeps_of_silent_nodes(monkeypatch):
    """A node that stops flushing does not keep its slot: a launch that
    finds every slot taken frees those of sweeps that have landed, and
    their owners still apply them at their next flush."""
    _device_seconds_none(monkeypatch)
    slots = threading.Semaphore(1)
    monkeypatch.setattr(accel_mod, "_inflight_slots", lambda: slots)
    oracle, silent = _port_unflushed("consensus", pipeline=True)
    silent.flush_consensus()
    inf = silent.accel._inflight
    assert inf.slots is None
    _hold_running(inf, slots)

    _oracle, other = _port_unflushed("consensus", pipeline=True)
    other.flush_consensus()  # the silent node's sweep is still running
    assert other.accel.contended == 1 and other.accel._inflight is None
    inf.done.land()
    other._accel_pending = 1
    other.flush_consensus()  # reaps the landed sweep, takes its slot
    assert other.accel.contended == 1 and other.accel.busy()
    assert inf.slots is None
    silent._accel_pending = 1
    silent.flush_consensus()
    assert silent.accel.sweeps == 1 and silent.accel.fallbacks == 0
    _assert_same(silent, oracle)
