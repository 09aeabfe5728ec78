"""Tests of the PyTorch port that need an NVIDIA card: the CUDA kernels have
no CPU mode. They skip without a card. This file imports neither JAX nor
the JAX package, so on a machine without JAX run it without the repo's
conftest (which sets JAX up):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from babble_tpu_torch.crypto.keys import PrivateKey
from babble_tpu_torch.crypto.secp256k1 import N as CURVE_N
from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.ops import dag, kernels, voting
from babble_tpu_torch.ops.intdot import vote_matmul
from babble_tpu_torch.parallel import batch_of_snapshots, batched_pipeline
from babble_tpu_torch.peers import Peer, PeerSet

from chip_smoke import (
    K2_BLOCK_SHAPES,
    Pump,
    check_field_ops,
    cluster_arm,
    edge_coordinates,
    edge_super_majority,
    field_edge_pairs,
    http_get,
    k1_edge_inputs,
    k2_tile_rule,
    ladder_edge_items,
    native_verify_items,
    noncanonical_pairs,
    oracle_verdicts,
    signature_batch,
    tcp_cluster,
    trace_device_summary,
    verify_vectors,
)

INT32_MAX = np.int32(2**31 - 1)

pytestmark = pytest.mark.cuda

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _k1_inputs(W, P, S, seed):
    rng = np.random.RandomState(seed)
    la = rng.randint(-1, 50, size=(W, P)).astype(np.int32)
    fd = rng.randint(0, 50, size=(W, P)).astype(np.int32)
    fd[rng.rand(W, P) < 0.3] = INT32_MAX
    la[rng.rand(W, P) < 0.1] = -1
    member = rng.rand(S, P) < 0.7
    return la, fd, member


# K1 shapes: the live buckets and ragged ones; W off every multiple of the
# 32 and 128 tiles, P = 1, P off every multiple of the 16-peer chunk, P at
# the stated limit, S = 3 (two slot groups), and W large enough for the
# 128 tile with one and with two slots per block
K1_CARD_SHAPES = [
    (16, 4, 1), (37, 13, 3), (128, 16, 1), (256, 16, 1), (512, 64, 2),
    (1024, 64, 2), (33, 900, 1), (1, 1, 1), (70, 17, 2), (200, 33, 3),
    (2100, 5, 1), (2100, 7, 2), (2, kernels.MEMBER_SS_MAX_P, 1),
]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("W,P,S", K1_CARD_SHAPES)
def test_k1_kernel_equals_plain(card, W, P, S, values):
    """The kernel equals its plain version, bit for bit, on random
    coordinates and on coordinates at the int32 edges (la below INT32_MAX,
    K1's domain), and counts one launch; the plain version on the card
    equals it on the CPU."""
    make = _k1_inputs if values == "random" else k1_edge_inputs
    arrays = make(W, P, S, seed=W + P + S)
    la, fd, member = (torch.from_numpy(a).to(card) for a in arrays)
    kernels.reset_launch_counts()
    got = kernels.member_ss_counts(la, fd, member)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"member_ss_counts": 1,
                                      "strongly_see": 0,
                                      "strongly_see_block": 0,
                                      "ecdsa_shamir": 0, "field_ops": 0}
    assert torch.equal(got, kernels.member_ss_counts_plain(la, fd, member))
    cpu = kernels.member_ss_counts(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(got.cpu(), cpu)


def test_k1_refuses_what_it_cannot_take(card):
    la, fd, member = (torch.from_numpy(a).to(card)
                      for a in _k1_inputs(32, 8, 1, seed=1))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.member_ss_counts(la.t().contiguous().t(), fd, member)
    P = kernels.MEMBER_SS_MAX_P + 1
    big = torch.zeros((16, P), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.member_ss_counts(
            big, big, torch.ones((1, P), dtype=torch.bool, device=card)
        )


def test_vote_matmul_exact_on_card(card):
    rng = np.random.RandomState(3)
    a = rng.rand(512, 1024) < 0.5
    b = rng.rand(1024, 512) < 0.5
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = vote_matmul(torch.from_numpy(a).to(card), torch.from_numpy(b).to(card))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _gossip_stream(n_peers=7, n_events=200, seed=5):
    """A seeded gossip stream of signed events and a port Hashgraph for it
    (no event inserted yet), a peer leaving at round 3."""
    rng = random.Random(seed)
    keys = [PrivateKey(rng.randrange(1, CURVE_N)) for _ in range(n_peers)]
    peers = PeerSet([Peer(f"inmem://p{i}", k.public_key.hex(), f"p{i}")
                     for i, k in enumerate(keys)])
    h = Hashgraph(InmemStore(100000))
    h.init(peers)
    h.store.set_peer_set(3, peers.with_removed_peer(peers.peers[-1]))
    heads, seqs, events = [""] * n_peers, [-1] * n_peers, []
    order = list(range(n_peers))
    while len(events) < n_events:
        rng.shuffle(order)
        for i in order:
            if len(events) >= n_events:
                break
            op = ""
            if events:
                j = rng.randrange(n_peers - 1)
                op = heads[j if j < i else j + 1]
                if op == "":
                    continue
            idx = seqs[i] + 1
            e = Event.new([b"t"] if idx else [], [], [], [heads[i], op],
                          keys[i].public_key.bytes(), idx,
                          timestamp=len(events))
            e.sign(keys[i])
            e.prevalidate(True)
            heads[i], seqs[i] = e.hex(), idx
            events.append(e)
    return h, events


def _insert(h, events) -> None:
    for e in events:
        h.insert_event(e, set_wire_info=True)
        h.divide_rounds()


def _gossip_hashgraph(n_peers=7, n_events=200, seed=5):
    """A port Hashgraph over a seeded gossip stream, voting deferred, a peer
    leaving at round 3."""
    h, events = _gossip_stream(n_peers, n_events, seed)
    _insert(h, events)
    return h


def _window():
    return voting.build_voting_window(_gossip_hashgraph())


def test_sweep_on_card_equals_cpu(card):
    """The fused sweep on the card, through K1, returns the CPU sweep's
    exact [fame | rr] vector (the CPU sweep is held against the JAX
    package by tests/test_torch_voting.py)."""
    win = _window()
    assert win.member.shape[0] == 2
    kernels.reset_launch_counts()
    got = voting.launch_sweep(win, card).cpu()
    assert kernels.launch_counts() == {"member_ss_counts": 1,
                                      "strongly_see": 0,
                                      "strongly_see_block": 0,
                                      "ecdsa_shamir": 0, "field_ops": 0}
    assert torch.equal(got, voting.launch_sweep(win, torch.device("cpu")))


class _FailingLib:
    """A K1 library whose launch reports cudaErrorInvalidConfiguration."""

    def bt_member_ss_counts(self, *args):
        return 9


@pytest.mark.parametrize("pipeline", [False, True])
def test_failing_k1_launch_raises_out_of_flush(card, monkeypatch, pipeline):
    """A K1 launch that fails on the card raises out of flush: it is never
    turned into an oracle run on the host, and counts no fallback."""
    h = _gossip_hashgraph()
    h.accel = TensorConsensus(device=card, min_window=0, pipeline=pipeline,
                              batcher=False)
    monkeypatch.setattr(kernels, "_lib", _FailingLib())
    h._accel_pending = 1
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        h.flush_consensus()
    assert h.accel.fallbacks == 0
    assert h.accel.sweeps == 0


# -- the batch axis, resident windows and the sweep batcher on the card ------

# (B, W, P, S): a ragged batch, the live 16- and 64-validator buckets of
# co-located nodes' waves (both tiles), and two slot groups a window
K1_BATCH_CARD_SHAPES = [(3, 37, 13, 3), (16, 128, 16, 1), (16, 256, 64, 2),
                        (2, 2100, 7, 2), (5, 70, 17, 2)]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("B,W,P,S", K1_BATCH_CARD_SHAPES)
def test_k1_batched_kernel_equals_plain(card, B, W, P, S, values):
    """One launch over B windows equals the plain version bit for bit, on
    random and on int32-edge coordinates, and each window equals its own
    one-window launch."""
    make = _k1_inputs if values == "random" else k1_edge_inputs
    parts = [make(W, P, S, seed=W + P + S + b) for b in range(B)]
    la, fd, member = (torch.from_numpy(np.stack(a)).to(card)
                      for a in zip(*parts))
    kernels.reset_launch_counts()
    got = kernels.member_ss_counts(la, fd, member)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["member_ss_counts"] == 1
    assert tuple(got.shape) == (B, S, W, W)
    assert torch.equal(got, kernels.member_ss_counts_plain(la, fd, member))
    for b in (0, B - 1):
        assert torch.equal(got[b], kernels.member_ss_counts(la[b], fd[b],
                                                            member[b]))


def test_resident_delta_program_equals_full_upload(card):
    """The resident program on the card: a first snapshot seeds the
    buffers by a full upload, a second uploads only its delta into them;
    that sweep equals a full upload of the same window and the CPU's, and
    each sweep is one K1 launch."""
    from babble_tpu_torch.ops import window_state as ws

    h, events = _gossip_stream(n_events=240)
    h._accel_track_delta = True
    state = ws.WindowState()
    _insert(h, events[:180])
    snap = state.snapshot(h, {})
    kernels.reset_launch_counts()
    _out, used = state.dispatch(snap, card)
    assert not used and state.device is not None
    _insert(h, events[180:196])
    snap2 = state.snapshot(h, {})
    assert snap2.delta is not None and not snap2.rebuilt
    got, used2 = state.dispatch(snap2, card)
    assert used2
    full = voting.launch_sweep(snap2.win, card)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["member_ss_counts"] == 3
    assert torch.equal(got, full)
    assert torch.equal(got.cpu(), voting.launch_sweep(snap2.win,
                                                      torch.device("cpu")))


def test_batcher_wave_equals_singles_on_card(card):
    """Three windows of different buckets queued as one wave: one batched
    sweep (one K1 launch), each window's result equal to its single sweep
    on the card."""
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher

    wins = []
    for n, seed in ((7, 5), (7, 6), (9, 7)):
        wins.append(voting.build_voting_window(
            _gossip_hashgraph(n_peers=n, n_events=150 + 20 * len(wins),
                              seed=seed)))
    singles = [voting.run_sweep(w, card) for w in wins]
    svc = SweepBatcher()
    kernels.reset_launch_counts()
    with svc._lock:  # hold the dispatcher until the wave is queued
        tickets = [svc.submit(w, device=card) for w in wins]
    for t in tickets:
        assert t.done.wait(120)
        assert t.error is None, t.error
    assert [t.batch_size for t in tickets] == [3, 3, 3]
    assert kernels.launch_counts()["member_ss_counts"] == 1
    assert svc.batches == 1 and sum(svc.sweep_shapes.values()) == 1
    for t, (fame, rr) in zip(tickets, singles):
        np.testing.assert_array_equal(t.result[0], fame)
        np.testing.assert_array_equal(t.result[1], rr)


@pytest.mark.parametrize("pipeline", [False, True])
def test_failing_k1_launch_in_the_batcher_raises_out_of_flush(
        card, monkeypatch, pipeline):
    """A K1 launch that fails in the batcher's sweep fails the ticket, and
    the node's flush re-raises it: no oracle run, no fallback."""
    h = _gossip_hashgraph()
    h.accel = TensorConsensus(device=card, min_window=0, pipeline=pipeline,
                              batcher=True)
    monkeypatch.setattr(kernels, "_lib", _FailingLib())
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        for _ in range(1000):
            h._accel_pending = 1
            h.flush_consensus()
            time.sleep(0.01)
    assert h.accel.fallbacks == 0
    assert h.accel.sweeps == 0


# -- K2 and the DAG pipeline --------------------------------------------------


def _k2_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    la = rng.randint(-1, 40, size=shape).astype(np.int32)
    fd = rng.randint(0, 40, size=shape).astype(np.int32)
    fd[rng.rand(*shape) < 0.25] = INT32_MAX
    la[rng.rand(*shape) < 0.1] = -1
    return la, fd


# K2 shapes: the DAG path's four, ragged ones, E off every multiple of the
# 32 and 128 tiles with either tile (single and batched), P = 1, P off
# every multiple of the 16-peer chunk, P at the stated limit, B > 1
K2_CARD_SHAPES = [
    (1, 1), (33, 5), (64, 4), (100, 6), (512, 16), (1000, 40), (4096, 64),
    (65, 900), (3, 37, 7), (8, 512, 16), (4096, 16), (130, 1), (4100, 17),
    (4, 1100, 5), (2, kernels.STRONGLY_SEE_MAX_P),
]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("shape", K2_CARD_SHAPES)
def test_k2_kernel_equals_plain(card, shape, values):
    """K2 equals its plain version, bit for bit, single and batched, at
    ragged and full shapes, on random coordinates and on coordinates at the
    int32 edges (at a threshold that counts of sm - 1 and sm straddle), and
    counts one launch; the plain version on the card equals it on the
    CPU."""
    if values == "random":
        la_np, fd_np = _k2_inputs(shape, seed=sum(shape))
        sm = 2 * shape[-1] // 3 + 1
    else:
        la_np, fd_np = edge_coordinates(shape, seed=sum(shape))
        sm = edge_super_majority(la_np, fd_np)
    la, fd = torch.from_numpy(la_np).to(card), torch.from_numpy(fd_np).to(card)
    kernels.reset_launch_counts()
    got = kernels.strongly_see(la, fd, sm)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"member_ss_counts": 0,
                                      "strongly_see": 1,
                                      "strongly_see_block": 0,
                                      "ecdsa_shamir": 0, "field_ops": 0}
    assert got.dtype == torch.bool
    assert tuple(got.shape) == (*shape[:-1], shape[-2])
    assert torch.equal(got, kernels.strongly_see_plain(la, fd, sm))
    if shape[-2] <= 1000:
        cpu = kernels.strongly_see(torch.from_numpy(la_np),
                                   torch.from_numpy(fd_np), sm)
        assert torch.equal(got.cpu(), cpu)


def test_card_shapes_take_both_tiles(card):
    """The shapes above launch both tile sizes of the shared tile loop,
    for K1 with one and with two slots per block, and K2 the 32 and 128
    tiles."""
    k1 = {(kernels.member_ss_tile(W, S), min(S, 2))
          for W, _P, S in K1_CARD_SHAPES}
    assert {(32, 1), (32, 2), (128, 1), (128, 2)} <= k1
    k2 = {kernels.strongly_see_tile(s[-2], s[0] if len(s) == 3 else 1)
          for s in K2_CARD_SHAPES}
    assert {"32x32", "128x128"} <= k2


def test_k2_refuses_what_it_cannot_take(card):
    la, fd = (torch.from_numpy(a).to(card) for a in _k2_inputs((32, 8), 1))
    with pytest.raises(TypeError):
        kernels.strongly_see(la.to(torch.int64), fd.to(torch.int64), 5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.strongly_see(la.t().contiguous().t(), fd, 5)
    with pytest.raises(ValueError, match="one device"):
        kernels.strongly_see(la, fd.cpu(), 5)
    P = kernels.STRONGLY_SEE_MAX_P + 1
    big = torch.zeros((16, P), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.strongly_see(big, big, 3)
    empty = torch.zeros((0, 8), dtype=torch.int32, device=card)
    kernels.reset_launch_counts()
    assert tuple(kernels.strongly_see(empty, empty, 3).shape) == (0, 0)
    assert kernels.launch_counts()["strongly_see"] == 0


def test_pipeline_on_card_equals_cpu_one_k2_launch_per_run(card):
    """run_pipeline on the card equals the CPU run (held against the JAX
    package by tests/test_torch_dag.py), and each run launches K2 once."""
    snap = dag.synthetic_snapshot(16, 512)
    want = dag.run_pipeline(snap, return_matrices=True, device="cpu")
    kernels.reset_launch_counts()
    for runs in (1, 2):
        got = dag.run_pipeline(snap, return_matrices=True, device=card)
        assert kernels.launch_counts() == {"member_ss_counts": 0,
                                          "strongly_see": runs,
                                          "strongly_see_block": 0,
                                          "ecdsa_shamir": 0, "field_ops": 0}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batched_pipeline_on_card_equals_cpu(card):
    arrays, sm = batch_of_snapshots(3, 4, 64)
    want = batched_pipeline(sm, 64, device="cpu")(*arrays)
    kernels.reset_launch_counts()
    got = batched_pipeline(sm, 64, device=card)(*arrays)
    assert kernels.launch_counts()["strongly_see"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


class _FailingK2Lib:
    """A kernel library whose K2 launch reports
    cudaErrorInvalidConfiguration."""

    def bt_strongly_see(self, *args):
        return 9


def test_failing_k2_launch_raises_out_of_pipeline(card, monkeypatch):
    monkeypatch.setattr(kernels, "_lib", _FailingK2Lib())
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        dag.run_pipeline(dag.synthetic_snapshot(4, 64), device=card)
    assert kernels.launch_counts()["strongly_see"] == 0


# -- the node stack on the card -----------------------------------------------


@pytest.mark.parametrize("arm,env", [
    ("defaults", {}), ("min_window=0", {"BABBLE_ACCEL_MIN_WINDOW": "0"}),
])
def test_node_cluster_on_card(card, arm, env):
    """Four port nodes over loopback TCP with the offload on the card at
    its defaults (the sweep batcher and resident windows; chip_smoke.py
    phase 8 at a smaller size): identical blocks on every node, node 0's
    chain equal to the host replay of its events, no fallback, and one K1
    launch per batcher sweep. With min_window 0 every window sweeps, and a
    profiled window must hold K1's kernel records."""
    sweeping = arm == "min_window=0"
    rec = cluster_arm(arm, True, env, n=4, warmup_s=3.0, window_s=4.0,
                      profile=sweeping)
    assert rec["batcher"]
    assert rec["common_block"] >= 1
    assert rec["fallbacks"] == 0
    assert rec["launches"] == rec["expected_launches"]
    assert rec["launches"] == (rec["wave"]["batch_batches"]
                               + rec["wave"]["batch_singles"])
    if sweeping:
        assert rec["sweeps"] > 0
        assert rec["device_profile"]["k1_kernels"] > 0


def test_profile_hook_on_card(card, monkeypatch):
    """GET /profile?format=torch on a node whose offload sweeps on the card
    answers with a chrome trace of CPU and CUDA activities that holds K1's
    kernel records. A window counts as holding a sweep when the node's
    accel_sweeps advanced by two inside it (the second sweep was launched
    after the first was applied, and applied before the window closed):
    one-second captures are taken until one such window is seen (at most
    ten), and it must hold K1."""
    from babble_tpu_torch.service.service import Service

    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")
    nodes, proxies, states = tcp_cluster(4, True)
    svc = Service("127.0.0.1:0", nodes[0])
    svc.serve_async()
    pump = Pump(proxies, states)
    stop = threading.Event()
    loader = threading.Thread(target=pump.until,
                              args=(time.monotonic() + 90, stop), daemon=True)

    def capture():
        body = json.loads(http_get(
            f"http://{svc.bind_addr}/profile?format=torch&seconds=1"))
        assert body["activities"] == ["CPU", "CUDA"]
        first, last = body["accel_sweeps"]
        summary = trace_device_summary(body["trace_file"], body["window_s"])
        return last - first, summary, body["window_s"]

    try:
        for n in nodes:
            n.run_async()
        loader.start()
        time.sleep(3.0)
        seen = []
        for _ in range(10):
            seen.append(capture())
            if seen[-1][0] >= 2:
                break
        print("one-second captures (sweeps applied, K1 records, s): "
              f"{[(a, s['k1_kernels'], w) for a, s, w in seen]}")
        applied, summary, _ = seen[-1]
        assert applied >= 2
        assert summary["k1_kernels"] > 0
    finally:
        stop.set()
        loader.join(timeout=10)
        svc.shutdown()
        for n in nodes:
            n.shutdown()


# -- K3: batched signature verification on the card ---------------------------


def _verify_items(B: int):
    """B signature items: the JAX tests' vectors with the ladder's rare
    cases, or a seeded batch with every eighth corrupted."""
    if B == 24:
        return verify_vectors() + ladder_edge_items()
    return signature_batch(B, 16, seed=B)


@pytest.mark.parametrize("B", [1, 24, 64, 1000])
def test_k3_equals_plain_and_batch_verify_the_oracle(card, B):
    """K3 equals its plain version on the card's tensors, bit for bit, and
    batch_verify on the card equals the Python oracle and the native
    verifier; each batch_verify launches K3 once."""
    from babble_tpu_torch.ops import verify

    items = _verify_items(B)
    inputs = verify._prepare(items, card)
    kernels.reset_launch_counts()
    got = verify.shamir(*inputs[1:])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ecdsa_shamir"] == 1
    assert got.dtype == torch.bool and tuple(got.shape) == (B,)
    assert torch.equal(got, verify.shamir_plain(*inputs[1:]))
    verdicts = verify.batch_verify(items, card)
    assert kernels.launch_counts()["ecdsa_shamir"] == 2
    oracle = oracle_verdicts(items)
    assert verdicts.tolist() == oracle
    assert native_verify_items(items) == oracle


def test_k3_field_layer_equals_python_ints(card):
    """bt_field_ops, on K3's cooperative field layer, equals Python integers
    at every group size for mul, sqr, add and sub mod p at the edges (both
    folds, the final subtract), on non-canonical add and sub operands and
    on 4096 random pairs: one launch an operation, operand set and group
    size."""
    kernels.reset_launch_counts()
    assert check_field_ops(seed=5) == (len(field_edge_pairs()) + 4096
                                       + len(noncanonical_pairs()))
    assert kernels.launch_counts()["field_ops"] == 6 * len(kernels.ECDSA_GROUPS)
    assert kernels.launch_counts()["ecdsa_shamir"] == 0


def _k3_at_every_group(items, card):
    """K3 at its own group size and at every other equals its plain version
    on the card, bit for bit, and its verdicts ANDed with the host's equal
    the Python oracle."""
    from babble_tpu_torch.ops import verify

    inputs = verify._prepare(items, card)
    plain = verify.shamir_plain(*inputs[1:])
    for group in (None, *kernels.ECDSA_GROUPS):
        got = kernels._ecdsa_shamir_at(group, *inputs[1:])
        torch.cuda.synchronize()
        assert torch.equal(got, plain), (len(items), group)
    assert (plain & inputs.pre_ok).cpu().tolist() == oracle_verdicts(items)


@pytest.mark.parametrize("B", [1, 3, 33, 127, 1000])
def test_k3_partial_groups_and_warps(card, B):
    """Batches that leave a partial warp or block at every group size: the
    groups past B run the last signature again and store nothing."""
    _k3_at_every_group(signature_batch(B, 16, seed=100 + B), card)


def test_k3_rare_cases_beside_ordinary_signatures(card):
    """The ladder's rare cases (P1 == P2, P1 == -P2 then a lift, R at
    infinity) at positions 5, 17 and 30 of 64 signatures: one group of a
    warp takes a rare case while its warp-mates do not."""
    items = signature_batch(61, 16, seed=7)
    for pos, item in zip((5, 17, 30), ladder_edge_items()):
        items.insert(pos, item)
    _k3_at_every_group(items, card)


def test_k3_host_rejected_slots_in_one_warp(card):
    """Host-rejected items (r = 0, s = 0, r = n, a key off the curve) take
    dummy slots beside valid and invalid signatures within one warp."""
    vec = verify_vectors()
    rejected = [vec[i] for i in (15, 16, 17, 19)]  # r = 0, r = n, s = 0, off
    items = signature_batch(12, 8, seed=9)
    for pos, item in zip((1, 2, 6, 11), rejected):
        items.insert(pos, item)
    _k3_at_every_group(items, card)


def test_k3_launch_count_rises_once_per_batch_verify(card):
    from babble_tpu_torch.ops import verify

    items = verify_vectors()
    kernels.reset_launch_counts()
    for k in (1, 2, 3):
        verify.batch_verify(items[:k * 5], card)
        assert kernels.launch_counts()["ecdsa_shamir"] == k
    assert verify.batch_verify([], card).shape == (0,)
    assert kernels.launch_counts()["ecdsa_shamir"] == 3


def test_k3_refuses_what_it_cannot_take(card):
    from babble_tpu_torch.ops import verify

    inputs = verify._prepare(verify_vectors()[:4], card)
    args = list(inputs[1:])
    with pytest.raises(TypeError, match="int32"):
        verify.shamir(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="several devices"):
        verify.shamir(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ecdsa_shamir(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ecdsa_shamir(*(a.cpu() for a in args))
    for group in (2, 3, 8):
        with pytest.raises(ValueError, match="group"):
            kernels._ecdsa_shamir_at(group, *args)
    with pytest.raises(ValueError, match="group"):
        kernels.field_ops("mul", args[0], args[1], 16)


def _signed_events(n: int):
    from babble_tpu_torch.crypto.keys import generate_key

    events = []
    for i in range(n):
        k = generate_key()
        ev = Event.new([f"tx {i}".encode()], [], [], ["", ""],
                       k.public_key.bytes(), 0)
        ev.sign(k)
        events.append(ev)
    return events


def _verify_core(device):
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.proxy.proxy import dummy_commit_response

    key = generate_key()
    peers = PeerSet([Peer("", key.public_key.hex(), "")])
    return Core(Validator(key, ""), peers, peers, InmemStore(100),
                dummy_commit_response, accelerated_verify=True,
                accelerator_device=device)


def test_core_verifies_sync_chunks_through_k3(card, monkeypatch):
    """With BABBLE_DEVICE_VERIFY=1 on the card, a chunk's signatures go
    through one K3 launch; the corrupted event stays flagged after its
    single re-check, the others valid."""
    monkeypatch.setenv("BABBLE_DEVICE_VERIFY", "1")
    core = _verify_core(str(card))
    events = _signed_events(5)
    events[2].signature = events[0].signature
    kernels.reset_launch_counts()
    core._batch_prevalidate(events)
    assert kernels.launch_counts()["ecdsa_shamir"] == 1
    assert [ev.prevalidated() for ev in events] == [True, True, False, True,
                                                   True]
    assert core.ingest_batch_verifies == 1
    assert core.ingest_fallback_singles == 1


class _FailingK3Lib:
    """A K3 library whose launch reports cudaErrorInvalidConfiguration."""

    def bt_ecdsa_shamir(self, *args):
        return 9


def test_failing_k3_launch_raises_out_of_the_core(card, monkeypatch):
    """A refused K3 launch raises out of the core's batch verification: the
    chunk never goes to the host verifier instead."""
    monkeypatch.setenv("BABBLE_DEVICE_VERIFY", "1")
    core = _verify_core(str(card))
    monkeypatch.setattr(kernels, "_lib", _FailingK3Lib())
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        core._batch_prevalidate(_signed_events(2))
    assert kernels.launch_counts()["ecdsa_shamir"] == 0
    assert core.ingest_batch_verifies == 0


# -- the mesh: rectangular K1, K2's block form, virtual shards -----------------

# (B, V, W, P, S), B 0 for one window: the sharded sweep's shard shapes at
# N = 4, V above W, ragged edges, and one large enough for the 128 tile
K1_RECT_CARD_SHAPES = [
    (0, 32, 128, 16, 1), (0, 64, 256, 64, 2), (0, 1, 37, 13, 3),
    (0, 200, 70, 17, 2), (0, 1100, 4096, 5, 1), (3, 16, 48, 8, 2),
    (4, 64, 256, 64, 2),
]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("B,V,W,P,S", K1_RECT_CARD_SHAPES)
def test_k1_rectangular_equals_plain(card, B, V, W, P, S, values):
    """K1 of V voter rows against W candidates equals its plain version,
    bit for bit, and its first V rows equal the square launch's; one
    launch."""
    lead = (B,) if B else ()
    n = max(V, W)
    if values == "random":
        la, fd, member = _k1_inputs(n, P, S, seed=V + W + P)
        if B:
            la, fd, member = (np.stack([a] * B) for a in (la, fd, member))
    else:
        la, fd, member = k1_edge_inputs(n, P, S, V + W + P, *lead)
    la_t, fd_t, member_t = (torch.from_numpy(a).to(card)
                            for a in (la, fd, member))
    a = la_t[..., :V, :].contiguous()
    f = fd_t[..., :W, :].contiguous()
    kernels.reset_launch_counts()
    got = kernels.member_ss_counts(a, f, member_t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["member_ss_counts"] == 1
    assert tuple(got.shape) == (*lead, S, V, W)
    assert torch.equal(got, kernels.member_ss_counts_plain(a, f, member_t))
    if V <= W:
        square = kernels.member_ss_counts(la_t[..., :W, :].contiguous(), f,
                                          member_t)
        assert torch.equal(got, square[..., :V, :])


def test_rectangular_shapes_take_both_tiles(card):
    """K1's rectangular shapes launch both of its tiles; K2's block form
    takes, at every shape of the collectives' table and of a grid of
    others, the tile its rule picks (``chip_smoke.k2_tile_rule``, the C
    entry's rule in Python)."""
    tiles = {kernels.member_ss_tile(W, S, max(B, 1), V=V)
             for B, V, W, _P, S in K1_RECT_CARD_SHAPES}
    assert tiles == {32, 128}
    shapes = [(X, Y, B) for (B, X, Y, *_rest), _what in K2_BLOCK_SHAPES]
    shapes += [(X, Y, B) for X in (1, 100, 512, 1000, 2048, 4096)
               for Y in (1, 512, 1024, 4096, 8192) for B in (1, 3, 8)]
    picks = {shape: kernels.strongly_see_block_tile(*shape)
             for shape in shapes}
    assert picks == {shape: k2_tile_rule(*shape) for shape in shapes}
    assert set(picks.values()) == set(kernels.K2_TILES)


# (B, X, Y, P, ldo, col0), B 0 for one block: the collectives' shapes
# (K2_BLOCK_SHAPES: sharded_strongly_see shards at n 2, 4 and 8, ring steps,
# the sharded pipeline's batched shards), a byte-wise epilogue (Y, ldo and
# col0 off multiples of 4), the 128 tile at an offset, and a batch
K2_BLOCK_CARD_SHAPES = [
    (B if B > 1 else 0, X, Y, P, ldo, col0)
    for (B, X, Y, P, ldo, col0), _what in K2_BLOCK_SHAPES
] + [(0, 37, 50, 6, 101, 3), (0, 2100, 2096, 9, 4200, 2100),
     (3, 100, 60, 8, 64, 4)]


@pytest.mark.parametrize("tile", [None, *kernels.K2_TILES])
@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("B,X,Y,P,ldo,col0", K2_BLOCK_CARD_SHAPES)
def test_k2_block_equals_plain(card, B, X, Y, P, ldo, col0, values, tile):
    """K2's block form, at every tile and at the one its C entry picks
    (None), writes exactly columns col0 .. col0 + Y of its output, equal
    to the plain version's and to the square launch's sub-block, and
    leaves every other byte; one launch."""
    lead = (B,) if B else ()
    n = max(X, Y)
    if values == "random":
        la_np, fd_np = _k2_inputs((*lead, n, P), seed=X + Y + P)
        sm = 2 * P // 3 + 1
    else:
        la_np, fd_np = edge_coordinates((*lead, n, P), seed=X + Y + P)
        sm = edge_super_majority(la_np, fd_np)
    la, fd = torch.from_numpy(la_np).to(card), torch.from_numpy(fd_np).to(card)
    a = la[..., :X, :].contiguous()
    f = fd[..., :Y, :].contiguous()
    before = torch.from_numpy(
        np.random.RandomState(X).rand(*lead, X, ldo) < 0.5).to(card)
    kernels.reset_launch_counts()
    got = kernels._strongly_see_block_at(tile, a, f, sm, before.clone(),
                                         col0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["strongly_see_block"] == 1
    assert kernels.launch_counts()["strongly_see"] == 0
    want = kernels.strongly_see_block_plain(a, f, sm, before.clone(), col0)
    assert torch.equal(got, want)
    square = kernels.strongly_see(la, fd, sm)
    assert torch.equal(got[..., col0:col0 + Y], square[..., :X, :Y])


def _mesh_replay_16(card, n_events=1024):
    from chip_smoke import consensus_state, gossip_stream, replay

    events, _keys, peers = gossip_stream(16, n_events, 5)
    oracle, _ = replay(events, peers)
    return events, peers, consensus_state(oracle)


def test_mesh_sweep_on_virtual_shards(card):
    """A 16-validator stream through TensorConsensus on a mesh of 4 shards
    that all name the card (resident windows, syncs of 16 so that the delta
    path runs) commits the oracle's blocks; K1 launches 4 times a sweep,
    rectangular, on the card."""
    from chip_smoke import mesh_replay

    events, peers, want = _mesh_replay_16(card)
    for n in (1, 4):
        rec = mesh_replay("16", events, peers, want, n, sync=16)
        assert all(V * n == W for V, W, _P, _S in rec["shapes"])


def test_mesh_collectives_and_sharded_pipeline_on_card(card):
    """sharded_strongly_see and ring_strongly_see on 2, 4 and 8 virtual
    shards, sharded_vote_counts, and sharded_batched_pipeline at (dp 2, sp
    2) and (dp 1, sp 4) equal K2, the plain tally and batched_pipeline on
    the card, with one block-form launch a shard (and ring step) at each
    shape of the collectives' table."""
    from chip_smoke import mesh_collectives

    arrays, sm = batch_of_snapshots(8, 16, 512)
    assert mesh_collectives(arrays, sm, 3) == {
        (1, 2048, 4096, 64): 2, (1, 1024, 4096, 64): 4,
        (1, 512, 4096, 64): 8, (1, 1024, 4096, 16): 4,
        (1, 2048, 2048, 64): 4, (1, 1024, 1024, 64): 16,
        (1, 512, 512, 64): 64, (4, 256, 512, 16): 4, (8, 128, 512, 16): 4}


def test_copro_lane_on_card(card, monkeypatch):
    """Two validators on one 4-shard virtual mesh through the batcher's
    coprocessor lane: each commits its oracle's blocks, a wave serves both,
    and K1 launches 4 times a window."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "COPRO_EVENTS", 1024)
    events, peers, want = _mesh_replay_16(card)
    rec = chip_smoke.copro_lane(events, peers, want, 7)
    assert rec["waves"] >= 1 and rec["launches"] == 4 * rec["windows"]
