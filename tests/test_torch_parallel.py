"""The port's multi-device code (babble_tpu_torch/parallel/) against the JAX
package's (babble_tpu/parallel/), bit for bit, on the CPU.

Twins of tests/test_parallel.py. The JAX side runs on the conftest's
8-device virtual CPU mesh; the port runs the same inputs on N CPU shards in
one process (a ``Mesh`` whose N entries all name the CPU), at N = 8 as the
JAX mesh and at N = 1, 2 and 4. The JAX sharded sweep and collectives use
XLA compares, no Pallas; the port's go through the plain versions of K1
and K2's block form on the CPU. Inputs are seeded numpy arrays or the JAX
package's own synthetic window, replayed into the port.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.parallel import collectives as jcoll
from babble_tpu.parallel import mesh as jmesh
from babble_tpu.parallel import pipeline as jpipe
from babble_tpu.parallel import voting_shard as jvs
from babble_tpu_torch.ops import kernels
from babble_tpu_torch.ops import voting as pvoting
from babble_tpu_torch.parallel import (
    batch_of_snapshots,
    batched_pipeline,
    consensus_mesh,
    ring_mesh,
    ring_strongly_see,
    shard_batched_snapshot,
    sharded_batched_pipeline,
    sharded_strongly_see,
    sharded_vote_counts,
)
from babble_tpu_torch.parallel import voting_shard as pvs

from chip_smoke import K2_BLOCK_SHAPES, K2_SQUARE_BLOCKS, k2_tile_rule
from tests.test_accel import _ordered_events
from tests.test_torch_accel import _jax_replay
from tests.test_torch_voting import (
    port_events,
    port_hashgraph_like,
    replay_inserts,
    synthetic_windows,
)

CPU = torch.device("cpu")
INT32_MAX = np.iinfo(np.int32).max
#: shard counts of the port's meshes: the JAX mesh's 8, and 1, 2, 4
SHARDS = [1, 2, 4, 8]


def cpu_mesh(n: int, dp=None):
    return consensus_mesh(n, dp=dp, devices=[CPU] * n)


#: the tile K2's block form should take at each (B, X, Y, P) of the tile
#: table measured on the card (``chip_smoke.py --k2-tiles``; PERF.md,
#: section 6): the fastest tile in both of its runs, except where two
#: shapes that differ only in P share the picker's (X, Y, B) and disagree:
#: (512, 512) takes the 32 tile, the fastest at P 16 (a square K2 row), at
#: 3.1-3.7% over 64 x 64 at P 64 (a ring step of 8 shards); and (4096,
#: 4096) the 128 tile, the fastest at P 64, at 1.3-1.4% over 64 x 128 at P
#: 16
K2_TABLE_TILES = {
    (1, 2048, 4096, 64): "128x128", (1, 1024, 4096, 64): "128x128",
    (1, 512, 4096, 64): "64x128", (1, 1024, 4096, 16): "128x128",
    (1, 2048, 2048, 64): "128x128", (1, 1024, 1024, 64): "64x64",
    (1, 512, 512, 64): "32x32", (4, 256, 512, 16): "64x64",
    (8, 128, 512, 16): "64x64", (1, 4096, 4096, 16): "128x128",
    (1, 4096, 4096, 64): "128x128", (1, 512, 512, 16): "32x32",
    (8, 512, 512, 16): "64x128",
}


def test_k2_tile_table_covers_the_collectives_and_square_shapes():
    """The table holds every block shape the collectives launch and every
    square K2 row."""
    shapes = [s for s, _ in K2_BLOCK_SHAPES] + K2_SQUARE_BLOCKS
    assert sorted(K2_TABLE_TILES) == sorted(tuple(s[:4]) for s in shapes)


@pytest.mark.parametrize("shape", sorted(K2_TABLE_TILES))
def test_k2_tile_rule_reproduces_the_measured_table(shape):
    """The picker's rule (the C entry's, in Python; the card tests hold the
    two equal) takes the table's tile at every shape."""
    B, X, Y, _P = shape
    assert k2_tile_rule(X, Y, B) == K2_TABLE_TILES[shape]


def test_mesh_shapes_follow_the_jax_rule():
    """consensus_mesh's default dp is the JAX package's (the largest power
    of two <= sqrt(n) dividing n); a mesh of more devices than there are
    raises, as ``jax.devices()[:n]`` makes the JAX call fail."""
    for n in range(1, 9):
        assert cpu_mesh(n).shape == jmesh.consensus_mesh(n).devices.shape
        assert ring_mesh(n, devices=[CPU] * n).shape == (n,)
    m = cpu_mesh(8, dp=4)
    assert m.shape == (4, 2) and m.size == 8 and m.flat() == [CPU] * 8
    with pytest.raises(ValueError, match="available"):
        consensus_mesh(3, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="available"):
        consensus_mesh(torch.cuda.device_count() + 1)  # the real cards
    with pytest.raises(ValueError, match="divide"):
        cpu_mesh(6, dp=4)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_vote_counts_matches_numpy(n):
    rng = np.random.RandomState(3)
    votes = rng.rand(32, 32) > 0.5
    eligible = rng.rand(32) > 0.3
    want = (votes & eligible[:, None]).sum(0)
    jax_got = np.asarray(jcoll.sharded_vote_counts(
        jmesh.consensus_mesh(8))(votes, eligible))
    got = sharded_vote_counts(cpu_mesh(n))(votes, eligible)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def ring_case():
    """The JAX test's inputs (a real window's witness coordinates, padded
    to a multiple of 8 rows) and the JAX ring and all-gather results on
    its 8-device mesh."""
    _, win = jvs.synthetic_voting_window(n_peers=6, n_events=160,
                                         peer_change=False)
    la = np.asarray(win.la_w)
    fd = np.asarray(win.fd_w)
    pad = (-la.shape[0]) % 8
    la = np.pad(la, ((0, pad), (0, 0)))
    fd = np.pad(fd, ((0, pad), (0, 0)), constant_values=INT32_MAX)
    sm = int(np.asarray(win.sm_s).max())
    want = (la[:, None, :] >= fd[None, :, :]).sum(-1) >= sm
    got_ring = np.asarray(jcoll.ring_strongly_see(jmesh.ring_mesh(8),
                                                  sm)(la, fd))
    got_ag = np.asarray(jcoll.sharded_strongly_see(
        jmesh.consensus_mesh(8), sm)(la, fd))
    return la, fd, sm, want, got_ring, got_ag


@pytest.mark.parametrize("n", SHARDS)
def test_ring_strongly_see_matches_all_gather_kernel(ring_case, n):
    """The ring formulation (fd blocks passed shard to shard, each step
    K2's block form into its column block) equals the all-gather
    formulation, numpy, and both JAX kernels, on a real window's
    coordinates."""
    la, fd, sm, want, got_ring, got_ag = ring_case
    np.testing.assert_array_equal(got_ring, want)
    np.testing.assert_array_equal(got_ag, want)
    kernels.reset_launch_counts()
    ring = ring_strongly_see(ring_mesh(n, devices=[CPU] * n), sm)(la, fd)
    ag = sharded_strongly_see(cpu_mesh(n), sm)(la, fd)
    assert ring.dtype == torch.bool and tuple(ring.shape) == want.shape
    np.testing.assert_array_equal(ring.numpy(), want)
    np.testing.assert_array_equal(ag.numpy(), want)
    # on the CPU the block form takes its plain version: no launch counted
    assert kernels.launch_counts()["strongly_see_block"] == 0


#: (E, P) of the ragged splits: E / n rows a shard off every multiple of
#: the block form's tiles (32, 64, 128) at n = 2, 4 and 8, and P off the
#: 16-peer chunk
RAGGED = [(8 * 100, 37), (8 * 36, 5)]


@pytest.fixture(scope="module", params=RAGGED, ids=lambda c: f"E{c[0]}-P{c[1]}")
def ragged_case(request):
    """Seeded coordinates with both sentinels at a ragged (E, P), and the
    JAX ring and all-gather results on its 8-device mesh."""
    E, P = request.param
    rng = np.random.RandomState(E + P)
    la = rng.randint(-1, 30, size=(E, P)).astype(np.int32)
    fd = rng.randint(0, 30, size=(E, P)).astype(np.int32)
    fd[rng.rand(E, P) < 0.25] = INT32_MAX
    sm = 2 * P // 3 + 1
    got_ring = np.asarray(jcoll.ring_strongly_see(jmesh.ring_mesh(8),
                                                  sm)(la, fd))
    got_ag = np.asarray(jcoll.sharded_strongly_see(
        jmesh.consensus_mesh(8), sm)(la, fd))
    np.testing.assert_array_equal(got_ring, got_ag)
    return la, fd, sm, got_ag


@pytest.mark.parametrize("n", SHARDS)
def test_collectives_on_ragged_splits(ragged_case, n):
    """The port's sharded and ring strongly-see on n shards whose row
    blocks leave a ragged last tile of K2's block form (and a ragged peer
    chunk) equal the JAX package's collectives on its 8 devices."""
    la, fd, sm, want = ragged_case
    ring = ring_strongly_see(ring_mesh(n, devices=[CPU] * n), sm)(la, fd)
    ag = sharded_strongly_see(cpu_mesh(n), sm)(la, fd)
    np.testing.assert_array_equal(ring.numpy(), want)
    np.testing.assert_array_equal(ag.numpy(), want)


@pytest.fixture(scope="module")
def ragged_pipeline_case():
    """A batch of 4 windows of 100 events (25 rows a shard on the JAX
    (dp 2, sp 4) mesh) and the JAX sharded pipeline's outputs there."""
    mesh = jmesh.consensus_mesh(8)
    arrays, sm = jpipe.batch_of_snapshots(4, n_peers=5, n_events=100)
    got = jpipe.sharded_batched_pipeline(mesh, sm, 100)(
        *jmesh.shard_batched_snapshot(mesh, arrays))
    return arrays, sm, tuple(np.asarray(a) for a in got)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pipeline_on_ragged_splits(ragged_pipeline_case, n):
    """sharded_batched_pipeline with 100-event windows split over sp (25,
    50 or 100 rows a shard: ragged against every tile of K2's block form)
    equals the JAX package's sharded pipeline on its (dp 2, sp 4) mesh."""
    arrays, sm, want = ragged_pipeline_case
    got = sharded_batched_pipeline(cpu_mesh(n), sm, 100)(*arrays)
    for name, g, w in zip(("see", "ss", "packed"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.fixture(scope="module")
def live_case():
    """The JAX test's live window (a peer-set change: two slots), its JAX
    single-device and 8-device sharded sweeps, and the port's window of the
    same events."""
    jwin, pwin = synthetic_windows(n_peers=6, n_events=160,
                                   peer_change=True)
    assert jwin.member.shape[0] >= 2, "window must span a peer-set change"
    from babble_tpu.ops import voting as jvoting

    ref = jvoting.run_sweep(jwin)
    sharded = jvs.run_sharded_sweep(jmesh.consensus_mesh(8), jwin)
    for a, b in zip(ref, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return jwin, pwin, tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_live_voting_sweep_matches_single_device(live_case, n):
    """The live fused sweep with its witness axis split over n CPU shards
    returns fame and round-received equal to the port's single-device
    sweep and to the JAX package's single and sharded sweeps, on a window
    spanning a peer-set change; every shard holds the same output."""
    _jwin, pwin, (fame_ref, rr_ref) = live_case
    assert (fame_ref != 0).any(), "nothing decided: window too small"
    assert (rr_ref >= 0).any(), "nothing received: window too small"
    fame_1, rr_1 = pvoting.run_sweep(pwin, CPU)
    np.testing.assert_array_equal(fame_1, fame_ref)
    np.testing.assert_array_equal(rr_1, rr_ref)

    mesh = cpu_mesh(n)
    fame_sh, rr_sh = pvs.run_sharded_sweep(mesh, pwin)
    np.testing.assert_array_equal(fame_sh, fame_ref)
    np.testing.assert_array_equal(rr_sh, rr_ref)
    placed = pvs.place_window(mesh, pwin)
    outs = pvs._sweep_shards(mesh.flat(),
                             dict(zip(pvoting.WIN_FIELDS, placed)))
    assert len(outs) == n
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), outs[0].numpy())


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_sweep_applies_to_live_hashgraph(n):
    """Applying the sharded sweep's results through the host apply path
    commits the blocks the JAX package's oracle commits on the same
    events."""
    h, _jwin = jvs.synthetic_voting_window(n_peers=6, n_events=160,
                                           peer_change=True)
    ordered = _ordered_events(h)
    oracle = _jax_replay(ordered, h.store.get_peer_set(0),
                         peer_sets=[(3, h.store.get_peer_set(3))])
    hp = port_hashgraph_like(h)
    replay_inserts(hp, port_events(ordered))
    win = pvoting.build_voting_window(hp)
    fame, rr = pvs.run_sharded_sweep(cpu_mesh(n), win)
    pvoting.apply_fame(hp, win, fame)
    pvoting.apply_round_received(hp, win, rr)
    hp.process_decided_rounds()
    assert hp.store.last_block_index() == oracle.store.last_block_index()
    assert hp.store.last_block_index() >= 0, "nothing committed"
    for b in range(oracle.store.last_block_index() + 1):
        assert (hp.store.get_block(b).body.hash()
                == oracle.store.get_block(b).body.hash())


@pytest.fixture(scope="module")
def dryrun_case():
    """``__graft_entry__.dryrun_multichip(8)``'s inputs on the JAX (dp 2,
    sp 4) mesh, and the JAX sharded and single-device pipelines' outputs."""
    mesh = jmesh.consensus_mesh(8)
    dp, sp = mesh.devices.shape
    n_events = sp * 8
    arrays, sm = jpipe.batch_of_snapshots(dp * 2, n_peers=4,
                                          n_events=n_events)
    sharded = jpipe.sharded_batched_pipeline(mesh, sm, n_events)(
        *jmesh.shard_batched_snapshot(mesh, arrays))
    ref = jax.jit(jpipe.batched_pipeline(sm, n_events))(
        *[jnp.asarray(a) for a in arrays])
    for a, b in zip(sharded, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return (dp, sp), arrays, sm, tuple(np.asarray(a) for a in sharded)


@pytest.mark.parametrize("n", SHARDS)
def test_dryrun_multichip_8(dryrun_case, n):
    """The JAX dry run's contract on the port: the batched pipeline over a
    mesh (at n = 8 the JAX one's (dp 2, sp 4)) equals the port's
    single-device batched pipeline and the JAX sharded pipeline; the
    collectives equal numpy and the ring its gcd-sized mesh."""
    (dp8, sp8), arrays, sm, want = dryrun_case
    port_arrays, port_sm = batch_of_snapshots(dp8 * 2, 4, sp8 * 8)
    for a, b in zip(port_arrays, arrays):
        np.testing.assert_array_equal(a, b)
    assert port_sm == sm
    n_events = sp8 * 8
    mesh = cpu_mesh(n, dp=2 if n == 8 else None)
    assert n != 8 or mesh.shape == (dp8, sp8)
    dp, sp = mesh.shape
    placed = shard_batched_snapshot(mesh, arrays)
    assert len(placed) == 7 and len(placed[4]) == dp and len(placed[4][0]) == sp
    assert tuple(placed[4][0][0].shape) == (len(arrays[4]) // dp,
                                            n_events // sp, 4)
    got = sharded_batched_pipeline(mesh, sm, n_events)(*arrays)
    single = batched_pipeline(sm, n_events, device="cpu")(*arrays)
    for name, g, s, w in zip(("see", "ss", "packed"), got, single, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(s.numpy(), w, err_msg=name)

    la, fd = arrays[4][0], arrays[5][0]
    ss_ref = (la[:, None, :] >= fd[None, :, :]).sum(-1) >= sm
    ss = sharded_strongly_see(mesh, sm)(la, fd).numpy()
    np.testing.assert_array_equal(ss, ss_ref)
    votes = ss[:n_events, :n_events]
    counts = sharded_vote_counts(mesh)(votes, np.ones(n_events, bool))
    np.testing.assert_array_equal(counts.numpy(), votes.sum(0))
    ring_n = math.gcd(n_events, n)
    ring = ring_strongly_see(ring_mesh(ring_n, devices=[CPU] * ring_n), sm)
    np.testing.assert_array_equal(ring(la, fd).numpy(), ss_ref)


def test_resident_sweep_scatters_each_row_into_its_owner():
    """The mesh resident program: a delta scattered into per-shard buffers
    (witness rows only into the shard that owns them, padding into the
    scratch rows) sweeps like the whole window with the delta applied,
    and leaves every shard's rows equal to that window's."""
    _jwin, pwin = synthetic_windows(n_peers=6, n_events=160,
                                    peer_change=True)
    W, E = pwin.n_witnesses, pwin.n_events
    mesh = cpu_mesh(4)
    bufs = pvs.place_resident(mesh, pwin)
    assert pvs.resident_shardings(mesh) == ("rep",) * 5 + ("rows",) * 6
    assert [tuple(b[0].shape)[0] for b in bufs] == [E + 1] * 4 + [W + 1] + [
        W // 4 + 1] * 6
    # a delta: rewrite witness rows 1 and W - 2 (shards 0 and 3) and event
    # row 5, with padding rows at the scratch indexes
    from babble_tpu_torch.ops.window_state import FRESH_FIELDS

    rng = np.random.RandomState(4)
    P = pwin.la_w.shape[1]
    w_rows = [1, W - 2]
    delta = [
        np.array([5, E, E], np.int32), np.array([2, 0, 0], np.int32),
        np.array([7, -1, -1], np.int32), np.array([1, -10, -10], np.int32),
        np.array([True, False, False]),
        np.array(w_rows + [W], np.int32), np.array([3, 4, 0], np.int32),
        rng.randint(-1, 9, size=(3, P)).astype(np.int32),
        rng.randint(0, 9, size=(3, P)).astype(np.int32),
        np.array([1, 2, -10], np.int32), np.array([True, True, False]),
        np.array([0, 1, 0], np.int32), np.array([True, False, False]),
    ]
    want = pvoting.repad_window(pwin, pvoting.bucket_key(pwin))
    fields = {f: getattr(want, f).clone() for f in pvoting.WIN_FIELDS}
    fields["creator"][5], fields["index"][5] = 2, 7
    fields["rounds"][5], fields["undet"][5] = 1, True
    names = ("wit_idx", "la_w", "fd_w", "rounds_w", "valid_w", "fame0_w",
             "mid_w")
    for k, w in enumerate(w_rows):
        for q, f in enumerate(names):
            fields[f][w] = torch.as_tensor(delta[6 + q][k])
    fresh = [getattr(pwin, f) for f in FRESH_FIELDS]
    bufs, out = pvs.resident_sweep_fn(mesh)(
        bufs, [torch.from_numpy(a) for a in delta], fresh)
    ref = pvoting.launch_sweep(
        pvoting.VotingWindow(**fields, base=pwin.base), CPU)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    for q, f in enumerate(pvs.RESIDENT_FIELDS):
        whole = torch.cat([b[:-1] for b in bufs[q]]) if q >= 5 else None
        for k in range(4):
            got = whole if whole is not None else bufs[q][k][:-1]
            np.testing.assert_array_equal(got.numpy(), fields[f].numpy(),
                                          err_msg=f)
