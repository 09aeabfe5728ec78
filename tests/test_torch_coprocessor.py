"""The port's mesh lanes against the JAX package's, on the CPU: resident
windows under a mesh (per-shard buffers, the sharded delta program), the
sweep batcher's coprocessor lane (validators multiplexed on one mesh), and
the witness-axis alignment to the mesh.

Twins of tests/test_coprocessor.py. The JAX side runs on the conftest's
8-device virtual CPU mesh; the port on N CPU shards in one process, at
N = 8 and at N = 1, 2 and 4, over the same signed events replayed into
both packages. Every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu.hashgraph.accel import TensorConsensus as JTensorConsensus
from babble_tpu.ops import voting as jvoting
from babble_tpu.parallel.mesh import consensus_mesh as jax_mesh
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
from babble_tpu_torch.ops import kernels, voting
from babble_tpu_torch.parallel import consensus_mesh

from tests.test_incremental_window import _stream
from tests.test_torch_accel import (
    _assert_same,
    _jax_replay,
    consensus_state,
    drain_pipelined,
)
from tests.test_torch_voting import synthetic_windows
from tests.test_torch_window_state import _checked_snapshots, _port_replay

CPU = torch.device("cpu")
#: shard counts of the port's meshes: the JAX mesh's 8, and 1, 2, 4
SHARDS = [1, 2, 4, 8]


def cpu_mesh(n: int):
    return consensus_mesh(n, devices=[CPU] * n)


def _jax_mesh_replay(events, peers, peer_sets=(), **kw):
    """The JAX package's offload on its 8-device mesh over the stream."""
    h = Hashgraph(InmemStore(100000))
    h.init(peers)
    for r, ps in peer_sets:
        h.store.set_peer_set(r, ps)
    h.accel = JTensorConsensus(async_compile=False, min_window=0,
                               mesh=jax_mesh(8), **kw)
    for ev in events:
        e = Event(ev.body, ev.signature)
        e.prevalidate(True)
        h.insert_event_and_run_consensus(e, set_wire_info=True)
    h.flush_consensus()
    return h


def _jax_same(a, b) -> None:
    from babble_tpu.crypto.canonical import canonical_dumps

    assert consensus_state(a, canonical_dumps) == consensus_state(
        b, canonical_dumps)


def _blocks(h) -> list:
    return [h.store.get_block(b).body.hash()
            for b in range(h.store.last_block_index() + 1)]


@pytest.fixture(scope="module")
def churn_case():
    """The churn stream, its JAX oracle, and the JAX resident offload on
    the 8-device mesh, which must equal the oracle."""
    events, peers, _keys = _stream(n_peers=6, n_events=200, seed=3)
    oracle = _jax_replay(events, peers)
    jmesh = _jax_mesh_replay(events, peers, sweep_events=8, pipeline=False,
                             batcher=False, resident=True)
    assert jmesh.accel.stats()["accel_rows_reused"] > 0
    _jax_same(jmesh, oracle)
    return events, oracle


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_resident_parity_under_churn(churn_case, monkeypatch, n):
    """Under a mesh of n shards the resident state equals a from-scratch
    rebuild after every snapshot, the sharded delta program runs, every
    resident buffer lies on every shard, and consensus equals the JAX
    oracle's (and so the JAX mesh offload's)."""
    events, oracle = churn_case
    checked = _checked_snapshots(monkeypatch)
    acc = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                          pipeline=False, batcher=False, resident=True,
                          mesh=cpu_mesh(n))
    h = _port_replay(oracle, events, acc)
    h.flush_consensus()
    assert checked["count"] > 0, "no snapshot was ever checked"
    _assert_same(h, oracle)
    assert h.store.last_block_index() >= 0, "stream decided nothing"
    s = acc.stats()
    assert s["accel_sweeps"] > 0 and s["accel_fallbacks"] == 0
    assert s["accel_rows_reused"] > 0 and s["accel_delta_sweeps"] > 0, (
        "mesh delta path never used")
    assert s["accel_mesh"] == "x".join(map(str, cpu_mesh(n).shape))
    assert s["accel_mesh_fallbacks"] == 0
    state = acc.window_state
    assert state.key[0] % n == 0
    for buf in state.device:
        assert len(buf) == n and all(t.device == CPU for t in buf)


def test_mesh_resident_parity_with_peer_set_change(monkeypatch):
    """A peer-set change at round 3 flows through the sharded delta sweeps
    (two slots in K1's rectangular launches) with rebuild equality
    throughout, at every shard count, equal to the JAX oracle (which
    tests/test_coprocessor.py holds the JAX mesh offload to on this
    stream)."""
    events, peers, _keys = _stream(n_peers=6, n_events=140, seed=12)
    later = [(3, peers.with_removed_peer(peers.peers[-1]))]
    oracle = _jax_replay(events, peers, peer_sets=later)
    checked = _checked_snapshots(monkeypatch)
    for n in SHARDS:
        acc = TensorConsensus(device="cpu", sweep_events=7, min_window=0,
                              pipeline=False, batcher=False, resident=True,
                              mesh=cpu_mesh(n))
        h = _port_replay(oracle, events, acc)
        h.flush_consensus()
        assert acc.fallbacks == 0 and acc.delta_sweeps > 0, n
        _assert_same(h, oracle)
    assert checked["slots"] >= 2, "peer-set change never reached a window"


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_stale_generation_drop(n):
    """A pipelined sharded sweep whose resident state mutated before its
    results applied is dropped (stale_drops), the oracle carries the flush,
    and consensus equals the JAX oracle's."""
    events, peers, _keys = _stream(n_peers=6, n_events=160, seed=7)
    oracle = _jax_replay(events, peers)
    acc = TensorConsensus(device="cpu", sweep_events=3, min_window=0,
                          pipeline=True, batcher=False, resident=True,
                          mesh=cpu_mesh(n))
    h = _port_replay(oracle, events, acc)
    if acc._inflight is None:
        acc._last_snapshot_topo = -1
        h._accel_pending = 1
        h.run_consensus_sweep()
    inf = acc._inflight
    assert inf is not None and inf.landed(), "no sweep in flight"
    acc.window_state.mark_dirty("test-mutation")
    h._accel_pending = 1
    h.run_consensus_sweep()
    assert acc.stale_drops >= 1, "stale readback was not detected"
    drain_pipelined(h)
    _assert_same(h, oracle)


def test_copro_two_validators_share_one_mesh():
    """Two validators with different peer sets and DAGs multiplex their
    windows through one mesh on the batcher's coprocessor lane: each
    commits its own JAX oracle's blocks (as the JAX coprocessor does), and
    the batcher accounts both owners; at every shard count."""
    ev1, p1, _ = _stream(n_peers=6, n_events=160, seed=3)
    ev2, p2, _ = _stream(n_peers=5, n_events=160, seed=11)
    oracles = [_jax_replay(ev1, p1), _jax_replay(ev2, p2)]
    svc = SweepBatcher.instance()
    for n in SHARDS:
        mesh = cpu_mesh(n)
        base = svc.stats()
        accs = [TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                                pipeline=False, batcher=True,
                                resident=False, mesh=mesh,
                                owner=f"val-{n}-{i}") for i in (1, 2)]
        for acc, events, oracle in zip(accs, (ev1, ev2), oracles):
            h = _port_replay(oracle, events, acc)
            h.flush_consensus()
            _assert_same(h, oracle)
            assert acc.fallbacks == 0 and acc.sweeps > 0
        s = svc.stats()
        assert s["copro_windows"] > base["copro_windows"], (
            "mesh lane never dispatched")
        assert s["copro_waves"] > base["copro_waves"]
        assert s["copro_validators"] >= base["copro_validators"] + 2
    # the JAX coprocessor on its 8-device mesh commits the same blocks
    for events, peers, oracle in ((ev1, p1, oracles[0]),
                                  (ev2, p2, oracles[1])):
        jh = _jax_mesh_replay(events, peers, sweep_events=8, pipeline=False,
                              batcher=True, resident=False, owner="jax")
        assert _blocks(jh) == _blocks(oracle)


@pytest.mark.parametrize("n", SHARDS)
def test_copro_wave_multiplexes_concurrent_windows(n):
    """Two windows submitted together land in one coprocessor wave, padded
    to one mesh-aligned bucket, and each reads back its own decisions,
    equal to the JAX package's single sweep of the same window."""
    jw1, pw1 = synthetic_windows(n_peers=6, n_events=160, seed=3)
    jw2, pw2 = synthetic_windows(n_peers=5, n_events=128, seed=11)
    want = [jvoting.run_sweep(jw1), jvoting.run_sweep(jw2)]
    mesh = cpu_mesh(n)
    svc = SweepBatcher()
    base = svc.stats()
    kernels.reset_launch_counts()
    with svc._lock:  # both queued before the dispatcher takes the wave
        tickets = [svc.submit(w, device="cpu", mesh=mesh, owner=o)
                   for w, o in ((pw1, "copro-a"), (pw2, "copro-b"))]
    for t, (fame_want, rr_want), win in zip(tickets, want, (pw1, pw2)):
        assert t.done.wait(120.0) and t.error is None, t.error
        fame_got, rr_got = t.result
        np.testing.assert_array_equal(fame_got, np.asarray(fame_want))
        np.testing.assert_array_equal(rr_got, np.asarray(rr_want))
        assert len(fame_got) == win.n_witnesses
        assert len(rr_got) == win.n_events
        assert t.batch_size == 2
    s = svc.stats()
    assert s["copro_waves"] == base["copro_waves"] + 1
    assert s["copro_windows"] == base["copro_windows"] + 2
    assert s["copro_validators"] == 2
    assert kernels.launch_counts()["member_ss_counts"] == 0  # plain on CPU


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_pad_rows_counted_and_sharded(n):
    """A witness axis the mesh size does not divide is padded to it
    (counted in accel_mesh_pad_rows), not sent to one device, and the padded
    window's decisions equal the original's; at n = 8 the padding equals
    the JAX package's."""
    jwin, pwin = synthetic_windows(n_peers=6, n_events=160, seed=3)
    key = voting.bucket_key(pwin)
    W_odd = key[0] + max(1, n // 2)
    odd = voting.repad_window(pwin, (W_odd,) + key[1:])
    acc = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                          pipeline=False, batcher=False, resident=False,
                          mesh=cpu_mesh(n))
    aligned = acc._mesh_align(odd)
    assert aligned.n_witnesses % n == 0
    assert acc.mesh_pad_rows == aligned.n_witnesses - W_odd
    assert acc.mesh_fallbacks == 0
    assert acc._use_mesh(aligned)
    assert acc._use_mesh(odd) == (n == 1)
    if n == 8:
        jacc = JTensorConsensus(sweep_events=8, async_compile=False,
                                min_window=0, pipeline=False, batcher=False,
                                resident=False, mesh=jax_mesh(8))
        jodd = jvoting.repad_window(jwin, (W_odd,) + key[1:])
        assert jacc._mesh_align(jodd).n_witnesses == aligned.n_witnesses
        assert jacc.mesh_pad_rows == acc.mesh_pad_rows

    from babble_tpu_torch.parallel.voting_shard import run_sharded_sweep

    fame_ref, rr_ref = jvoting.run_sweep(jwin)
    fame_sh, rr_sh = run_sharded_sweep(cpu_mesh(n), aligned)
    # real rows keep their indexes under the repad: slice back
    np.testing.assert_array_equal(fame_sh[:pwin.n_witnesses],
                                  np.asarray(fame_ref))
    np.testing.assert_array_equal(rr_sh[:pwin.n_events], np.asarray(rr_ref))


@pytest.mark.parametrize("n", [3, 6])
def test_mesh_align_odd_mesh_counts_fallback(n):
    """A mesh whose size has an odd factor never divides a doubled
    power-of-two W bucket: _mesh_align gives up after a bounded climb,
    counts a fallback and hands the window back unchanged, as the JAX
    package's does; a replay on such a mesh sweeps on one device, counted,
    and still commits the JAX oracle's blocks."""
    from types import SimpleNamespace

    jwin, pwin = synthetic_windows(n_peers=6, n_events=160, seed=3)
    jacc = JTensorConsensus(sweep_events=8, async_compile=False,
                            min_window=0, pipeline=False, batcher=False,
                            resident=False)
    jacc.mesh = SimpleNamespace(devices=np.zeros(n))
    assert jacc._mesh_align(jwin) is jwin and jacc.mesh_fallbacks == 1
    acc = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                          pipeline=False, batcher=False, resident=False,
                          mesh=cpu_mesh(n))
    assert acc._mesh_align(pwin) is pwin
    assert acc.mesh_fallbacks == 1 and acc.mesh_pad_rows == 0

    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=5)
    oracle = _jax_replay(events, peers)
    for resident in (False, True):
        acc = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                              pipeline=False, batcher=False,
                              resident=resident, mesh=cpu_mesh(n))
        h = _port_replay(oracle, events, acc)
        h.flush_consensus()
        _assert_same(h, oracle)
        assert acc.sweeps > 0 and acc.mesh_fallbacks >= acc.sweeps


def test_mesh_of_another_device_type_is_refused():
    """The shard devices must be of the offload device's type."""
    cuda_mesh = consensus_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="differ"):
        TensorConsensus(device="cpu", mesh=cuda_mesh)
    acc = TensorConsensus(device="cpu", resident=True)
    with pytest.raises(ValueError, match="differ"):
        acc.mesh = cuda_mesh
    acc.mesh = cpu_mesh(2)
    assert acc.window_state.mesh is acc.mesh
    assert acc.stats()["accel_mesh"] == "1x2"
    acc.mesh = None
    assert acc.window_state.mesh is None and acc.stats()["accel_mesh"] is None
