"""The PyTorch port's DAG consensus pipeline against the JAX package's, bit
for bit, on the CPU.

Inputs are made from numpy seeds (or the golden play-script DAGs) and go
through both packages:

- K2's plain version (``ops/kernels.strongly_see`` on CPU tensors) against
  the JAX ``strongly_see_matrix`` and ``strongly_see_pallas`` in
  interpreter mode, single and batched;
- every stage of ``ops/dag.py`` against its JAX function, the fixpoint
  sweeps with their pass caps, and the shortened round loops against the
  reference's full bound;
- ``synthetic_snapshot``, ``batch_of_snapshots`` and
  ``snapshot_from_hashgraph`` array for array;
- ``run_pipeline`` against the JAX pipeline and the host oracle on the six
  golden DAGs, and ``batched_pipeline`` against the JAX ``jax.vmap``.

``tests/test_ops_dag.py::test_jit_compiles_once`` has no counterpart: the
port runs eagerly and has no compile cache. The K2 kernel itself is held
against its plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.common.trilean import Trilean
from babble_tpu.ops import dag as jdag
from babble_tpu.ops.pallas_kernels import strongly_see_pallas
from babble_tpu.parallel import pipeline as jpipeline
from babble_tpu_torch import interop
from babble_tpu_torch.ops import dag as pdag
from babble_tpu_torch.ops import kernels
from babble_tpu_torch.parallel import pipeline as ppipeline

from tests.test_ops_dag import BUILDERS
from chip_smoke import edge_coordinates, edge_super_majority
from tests.test_torch_voting import (
    port_events,
    port_hashgraph_like,
    replay_inserts,
)
from tests.test_accel import _ordered_events

CPU = torch.device("cpu")
INT32_MAX = np.int32(2**31 - 1)
INT32_MIN = np.int32(-2**31)

SS_SHAPES = [(64, 4), (100, 6), (128, 8), (256, 16), (512, 40)]
# edge-value shapes: one event, P = 1, P off every multiple of 8 and 16
EDGE_SS_SHAPES = [(1, 1), (33, 5), (65, 1), (100, 17), (130, 40)]
SYNTHETIC = [(4, 64), (7, 100), (16, 256)]


def _coords(E, P, seed, batch=()):
    """Random coordinates with both sentinels mixed in, as the JAX
    package's own strongly-see test makes them."""
    rng = np.random.RandomState(seed)
    shape = (*batch, E, P)
    la = rng.randint(-1, 40, size=shape).astype(np.int32)
    fd = rng.randint(0, 40, size=shape).astype(np.int32)
    fd[rng.rand(*shape) < 0.25] = INT32_MAX
    la[rng.rand(*shape) < 0.1] = -1
    return la, fd


def _t(a):
    """A CPU tensor with a leading batch axis of 1."""
    return torch.from_numpy(np.array(a))[None]


def _np(t):
    return t[0].numpy()


# -- K2 -----------------------------------------------------------------------


@pytest.mark.parametrize("E,P", SS_SHAPES)
def test_strongly_see_plain_matches_jax(E, P):
    la, fd = _coords(E, P, seed=E + P)
    sm = 2 * P // 3 + 1
    want = np.asarray(jdag.strongly_see_matrix(jnp.asarray(la),
                                               jnp.asarray(fd), sm))
    pallas = np.asarray(strongly_see_pallas(jnp.asarray(la), jnp.asarray(fd),
                                            sm, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    kernels.reset_launch_counts()
    got = kernels.strongly_see(torch.from_numpy(la), torch.from_numpy(fd), sm)
    assert got.dtype == torch.bool and tuple(got.shape) == (E, E)
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain version: no kernel launch
    assert kernels.launch_counts()["strongly_see"] == 0


def test_strongly_see_batched_matches_stacked():
    la, fd = _coords(100, 6, seed=5, batch=(3,))
    sm = 5
    got = kernels.strongly_see(torch.from_numpy(la), torch.from_numpy(fd), sm)
    assert tuple(got.shape) == (3, 100, 100)
    for b in range(3):
        one = kernels.strongly_see(torch.from_numpy(la[b]),
                                   torch.from_numpy(fd[b]), sm)
        assert torch.equal(got[b], one)
        np.testing.assert_array_equal(one.numpy(), np.asarray(
            jdag.strongly_see_matrix(jnp.asarray(la[b]), jnp.asarray(fd[b]),
                                     sm)))
    # rows past the plain version's chunk compare like the first rows
    la, fd = _coords(kernels._PLAIN_ROWS + 37, 3, seed=9)
    got = kernels.strongly_see(torch.from_numpy(la), torch.from_numpy(fd), 2)
    want = (la[:, None, :] >= fd[None, :, :]).sum(-1) >= 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_strongly_see_empty_and_bad_inputs():
    empty = torch.zeros((0, 4), dtype=torch.int32)
    assert tuple(kernels.strongly_see(empty, empty, 3).shape) == (0, 0)
    la, fd = (torch.from_numpy(a) for a in _coords(16, 4, seed=1))
    with pytest.raises(TypeError):
        kernels.strongly_see(la.to(torch.int64), fd, 3)
    with pytest.raises(TypeError):
        kernels.strongly_see(la, fd.to(torch.float32), 3)
    with pytest.raises(ValueError):
        kernels.strongly_see(la, fd[:8], 3)
    with pytest.raises(ValueError):
        kernels.strongly_see(la[0], fd[0], 3)
    with pytest.raises(ValueError):
        kernels.strongly_see(la[None, None], fd[None, None], 3)


def _counts(la, fd):
    return (la[..., :, None, :].astype(np.int64)
            >= fd[..., None, :, :]).sum(-1)


@pytest.mark.parametrize("E,P", EDGE_SS_SHAPES)
def test_strongly_see_edge_values_match_pallas(E, P):
    """Coordinates at the edges of int32 (per-peer bases 0, 2^24 - 3,
    2^31 - 2^12 and 2^12 - 2^31; INT32_MIN and INT32_MAX on either side, so
    la - fd overflows; ties la == fd; both sentinels), at a threshold with
    counts of exactly sm - 1 and sm: the plain version equals the Pallas
    kernel and the jnp branch bit for bit."""
    la, fd = edge_coordinates((E, P), seed=E + 7 * P)
    sm = edge_super_majority(la, fd)
    counts = _counts(la, fd)
    if E > 1:
        assert (counts == sm).any() and (counts == sm - 1).any()
        assert (la == fd).any()
    pallas = np.asarray(strongly_see_pallas(jnp.asarray(la), jnp.asarray(fd),
                                            sm, interpret=True))
    np.testing.assert_array_equal(pallas, counts >= sm)
    np.testing.assert_array_equal(pallas, np.asarray(
        jdag.strongly_see_matrix(jnp.asarray(la), jnp.asarray(fd), sm)))
    got = kernels.strongly_see_plain(torch.from_numpy(la),
                                     torch.from_numpy(fd), sm)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_strongly_see_edge_values_batched_match_pallas():
    """A batch of three edge-value windows equals the Pallas kernel window
    by window, at thresholds sm - 1, sm and sm + 1."""
    la, fd = edge_coordinates((3, 37, 7), seed=11)
    sm = edge_super_majority(la, fd)
    assert la.min() == INT32_MIN and la.max() == INT32_MAX
    for t in (sm - 1, sm, sm + 1):
        got = kernels.strongly_see(torch.from_numpy(la),
                                   torch.from_numpy(fd), t)
        for b in range(3):
            want = np.asarray(strongly_see_pallas(
                jnp.asarray(la[b]), jnp.asarray(fd[b]), t, interpret=True))
            np.testing.assert_array_equal(got[b].numpy(), want)


# -- stages -------------------------------------------------------------------


def _stage_inputs(n_peers, n_events, seed):
    snap = jdag.synthetic_snapshot(n_peers, n_events, seed=seed)
    return snap, {f: getattr(snap, f) for f in pdag.SNAPSHOT_FIELDS}


@pytest.mark.parametrize("seed", [7, 3])
@pytest.mark.parametrize("n_peers,n_events", SYNTHETIC)
def test_stages_match_jax(n_peers, n_events, seed):
    snap, a = _stage_inputs(n_peers, n_events, seed)
    sm = snap.super_majority
    j = {k: jnp.asarray(v) for k, v in a.items()}
    p = {k: _t(v) for k, v in a.items()}

    see = np.asarray(jdag.see_matrix(j["creator"], j["index"],
                                     j["last_ancestors"]))
    got_see = pdag.see_matrix(p["creator"], p["index"], p["last_ancestors"])
    np.testing.assert_array_equal(_np(got_see), see)

    ss = np.asarray(jdag.strongly_see_matrix(j["last_ancestors"],
                                             j["first_descendants"], sm))
    got_ss = pdag.strongly_see_matrix(p["last_ancestors"],
                                      p["first_descendants"], sm)
    np.testing.assert_array_equal(_np(got_ss), ss)

    rounds, wit = jdag.compute_rounds(j["creator"], j["self_parent"],
                                      j["other_parent"], jnp.asarray(ss), sm)
    got_r, got_w = pdag.compute_rounds(p["creator"], p["self_parent"],
                                       p["other_parent"], got_ss, sm)
    np.testing.assert_array_equal(_np(got_r), np.asarray(rounds))
    np.testing.assert_array_equal(_np(got_w), np.asarray(wit))

    lamport = jdag.compute_lamport(j["self_parent"], j["other_parent"])
    got_l = pdag.compute_lamport(p["self_parent"], p["other_parent"])
    np.testing.assert_array_equal(_np(got_l), np.asarray(lamport))

    bound = n_events // sm + 2
    fame = jdag.decide_fame(rounds, wit, jnp.asarray(see), jnp.asarray(ss),
                            j["middle_bit"], sm, bound)
    got_f = pdag.decide_fame(got_r, got_w, got_see, got_ss, p["middle_bit"],
                             sm, bound)
    np.testing.assert_array_equal(_np(got_f), np.asarray(fame))

    rr = jdag.decide_round_received(rounds, wit, fame, jnp.asarray(see), sm,
                                    bound)
    got_rr = pdag.decide_round_received(got_r, got_w, got_f, got_see, sm,
                                        bound)
    np.testing.assert_array_equal(_np(got_rr), np.asarray(rr))


@pytest.mark.parametrize("cap", [1, 2, 3, 17, 33])
def test_fixpoint_caps_match_jax(cap):
    """A sweep capped before its fixpoint stops where the reference stops,
    also when the cap falls inside a block of unchecked passes."""
    snap, a = _stage_inputs(4, 64, 7)
    sm = snap.super_majority
    j = {k: jnp.asarray(v) for k, v in a.items()}
    p = {k: _t(v) for k, v in a.items()}
    ss = jdag.strongly_see_matrix(j["last_ancestors"], j["first_descendants"],
                                  sm)
    rounds, wit = jdag.compute_rounds(j["creator"], j["self_parent"],
                                      j["other_parent"], ss, sm,
                                      max_iters=cap)
    stats = {}
    got_r, got_w = pdag.compute_rounds(p["creator"], p["self_parent"],
                                       p["other_parent"], _t(ss), sm,
                                       max_iters=cap, stats=stats)
    np.testing.assert_array_equal(_np(got_r), np.asarray(rounds))
    np.testing.assert_array_equal(_np(got_w), np.asarray(wit))
    assert stats["rounds_passes"] <= cap
    lamport = jdag.compute_lamport(j["self_parent"], j["other_parent"],
                                   max_iters=cap)
    got_l = pdag.compute_lamport(p["self_parent"], p["other_parent"],
                                 max_iters=cap, stats=stats)
    np.testing.assert_array_equal(_np(got_l), np.asarray(lamport))
    assert stats["lamport_passes"] <= cap


@pytest.mark.parametrize("n_peers,n_events", [(4, 64), (16, 512)])
def test_round_loop_early_stop_matches_reference_bound(n_peers, n_events):
    """The pipeline's fame and round-received loops stop after round
    max(rounds); the result equals the loops run to the reference's bound,
    and the JAX pipeline at the compile check's bound (round_bound = E)."""
    snap, a = _stage_inputs(n_peers, n_events, 7)
    sm = snap.super_majority
    args = [torch.from_numpy(a[f]) for f in pdag.SNAPSHOT_FIELDS]
    stats = {}
    see, ss, packed = pdag.pipeline_core(*args, sm, n_events, stats)
    assert stats["round_loop"] < stats["round_bound"] == n_events
    jsee, jss, jpacked = jdag.pipeline_core(
        *(jnp.asarray(a[f]) for f in pdag.SNAPSHOT_FIELDS), sm, n_events)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(see.numpy(), np.asarray(jsee))
    np.testing.assert_array_equal(ss.numpy(), np.asarray(jss))

    rounds, wit = packed[0][None], packed[1][None].bool()
    fame = pdag.decide_fame(rounds, wit, see[None], ss[None],
                            _t(a["middle_bit"]), sm, n_events)
    rr = pdag.decide_round_received(rounds, wit, fame, see[None], sm,
                                    n_events)
    np.testing.assert_array_equal(_np(fame), packed[3].numpy())
    np.testing.assert_array_equal(_np(rr), packed[4].numpy())


# -- snapshots ----------------------------------------------------------------


def _assert_snapshots_equal(got, want):
    for f in pdag.SNAPSHOT_FIELDS:
        g = np.asarray(getattr(got, f))
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.n_peers == want.n_peers
    assert got.super_majority == want.super_majority
    assert got.hashes == want.hashes


@pytest.mark.parametrize("n_peers,n_events,seed",
                         [(4, 64, 7), (7, 100, 3), (16, 256, 7), (13, 13, 2),
                          (64, 300, 11)])
def test_synthetic_snapshot_matches_jax(n_peers, n_events, seed):
    _assert_snapshots_equal(
        pdag.synthetic_snapshot(n_peers, n_events, seed),
        jdag.synthetic_snapshot(n_peers, n_events, seed),
    )


def test_batch_of_snapshots_matches_jax():
    got, sm = ppipeline.batch_of_snapshots(3, 5, 70)
    want, jsm = jpipeline.batch_of_snapshots(3, 5, 70)
    assert sm == jsm
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _golden(graph):
    """(JAX oracle, port oracle) of one golden DAG: its signed events
    replayed into each package's Hashgraph in topological order, with
    rounds, fame and round-received decided."""
    from babble_tpu.hashgraph import Event, Hashgraph, InmemStore

    h0, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h0)
    h = Hashgraph(InmemStore(100000))
    h.init(peer_set)
    replay_inserts(h, [Event(e.body, e.signature) for e in ordered])
    ph = port_hashgraph_like(h)
    replay_inserts(ph, port_events(ordered))
    for g in (h, ph):
        g.decide_fame()
        g.decide_round_received()
    return h, ph


@pytest.mark.parametrize("graph", list(BUILDERS))
def test_snapshot_from_hashgraph_matches_jax(graph):
    h, ph = _golden(graph)
    jsnap = jdag.snapshot_from_hashgraph(h)
    _assert_snapshots_equal(pdag.snapshot_from_hashgraph(ph), jsnap)
    sub = jsnap.hashes[::2]
    _assert_snapshots_equal(pdag.snapshot_from_hashgraph(ph, sub),
                            jdag.snapshot_from_hashgraph(h, sub))


def _oracle_outputs(h, hashes):
    """What the host oracle decided for every row: see and strongly-see
    matrices, rounds, witness, lamport, fame (witnesses; 0 elsewhere) and
    round-received (-1 when undetermined)."""
    peer_set = h.store.get_peer_set(0)
    fame_of = {Trilean.TRUE: 1, Trilean.FALSE: -1, Trilean.UNDEFINED: 0}
    fame = {}
    for r in range(h.store.last_round() + 1):
        for x, e in h.store.get_round(r).created_events.items():
            if e.witness:
                fame[x] = fame_of[e.famous]
    rr = [h.store.get_event(eh).round_received for eh in hashes]
    return {
        "see": np.array([[h.see(x, y) for y in hashes] for x in hashes]),
        "strongly_see": np.array([[h.strongly_see(x, y, peer_set)
                                   for y in hashes] for x in hashes]),
        "rounds": np.array([h.round(eh) for eh in hashes]),
        "witness": np.array([h.witness(eh) for eh in hashes]),
        "lamport": np.array([h.lamport_timestamp(eh) for eh in hashes]),
        "fame": np.array([fame.get(eh, 0) for eh in hashes]),
        "round_received": np.array([-1 if r is None else r for r in rr]),
    }


@pytest.mark.parametrize("graph", list(BUILDERS))
def test_run_pipeline_matches_jax_and_oracle(graph):
    h, ph = _golden(graph)
    jsnap = jdag.snapshot_from_hashgraph(h)
    want = jdag.run_pipeline(jsnap, return_matrices=True)
    got = pdag.run_pipeline(pdag.snapshot_from_hashgraph(ph),
                            return_matrices=True, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name, oracle in (("jax", h), ("port", ph)):
        for k, v in _oracle_outputs(oracle, jsnap.hashes).items():
            np.testing.assert_array_equal(got[k], v,
                                          err_msg=f"{k} vs {name} oracle")


def test_batched_pipeline_matches_jax_vmap():
    arrays, sm = ppipeline.batch_of_snapshots(3, 4, 64)
    round_bound = 64
    want = jax.jit(jpipeline.batched_pipeline(sm, round_bound))(
        *(jnp.asarray(a) for a in arrays))
    got = ppipeline.batched_pipeline(sm, round_bound, device="cpu")(*arrays)
    for name, g, w in zip(("see", "ss", "packed"), got, want):
        assert g.device == CPU
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # each window of the batch is the single-window pipeline
    for b in range(3):
        one = pdag.pipeline_core(*(torch.from_numpy(a[b]) for a in arrays),
                                 sm, round_bound)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def test_snapshot_from_arrays_runs_like_jax():
    jsnap = jdag.synthetic_snapshot(5, 90, seed=4)
    fields = {f: getattr(jsnap, f) for f in pdag.SNAPSHOT_FIELDS}
    meta = {"n_peers": jsnap.n_peers, "super_majority": jsnap.super_majority,
            "hashes": jsnap.hashes}
    psnap = interop.snapshot_from_arrays(fields, meta, device="cpu")
    assert isinstance(psnap.creator, torch.Tensor)
    assert psnap.n_events == 90
    got = pdag.run_pipeline(psnap, device="cpu")
    want = jdag.run_pipeline(jsnap)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = dict(fields, creator=fields["creator"].astype(np.int64))
    with pytest.raises(TypeError):
        interop.snapshot_from_arrays(bad, meta, device="cpu")
    bad = dict(fields, last_ancestors=fields["last_ancestors"][:, :3])
    with pytest.raises(ValueError):
        interop.snapshot_from_arrays(bad, meta, device="cpu")
