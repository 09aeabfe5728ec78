#!/usr/bin/env python3
"""Chip smoke for babble_tpu_torch, the PyTorch/CUDA port: the quickest proof
that the port builds and runs its consensus paths on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and g++;
imports only babble_tpu_torch, torch, numpy and the standard library.
Phases, each of which fails the run (non-zero exit) on any error:

1. device and build: the card, its power limit, the kernel library (K1, K2
   and K3, built from csrc/) and native crypto builds, the host-crypto
   path;
2. the launch floor (an empty kernel's device time), then every kernel
   against its plain PyTorch version on the card, bit for bit, on random
   coordinates and on coordinates at the edges of int32 (per-peer bases up
   to 2^31 - 2^12, INT32_MIN and INT32_MAX, ties, both sentinels), with its
   time, its plain version's time, its bound and its share of the bound:
   K1 at the live sweep's shapes, single and over a batch of 16 windows
   (the sweep batcher's waves), K2 at the DAG pipeline's, single and
   batched;
3. the live offload at 16 validators: a seeded signed gossip stream
   replayed through the port's Hashgraph in syncs of 64 events with a flush
   after each — host oracle, TensorConsensus at its defaults, and with
   min_window=0, both without the batcher so that the resident windows'
   device program runs, and min_window=0 without resident windows (a full
   build and upload each sweep) — committing byte-identical blocks, with
   no fallback, one K1 launch per device sweep, and (min_window=0, resident)
   reused window rows;
4. the same (resident arms only) at 64 validators, one of which leaves
   from round 3 on, so sweeps carry two peer-set slots through K1; the
   stream is long enough that several blocks commit after the change;
5. the all-at-once DAG pipeline (``ops.dag.run_pipeline``) on the card over
   ``snapshot_from_hashgraph`` of the 16-validator oracle and of a new
   64-validator stream of 4096 signed events (oracle replay only), equal to
   the host oracle on every event's round, witness, lamport and
   round-received and every witness's fame, and its strongly-see matrix
   equal to K2's plain version on the snapshot's own coordinates;
6. the pipeline on the card equal to the port's CPU path on a synthetic
   window at bench.py's shape and on a batch of 8 such windows, see,
   strongly-see and the packed per-event results; phases 5 and 6 launch K2
   once per pipeline run, once at each of its four shapes;
7. the pipeline's times: wall ms per run and events/s at four windows, ms
   per window of the batch, peak device memory and host-clock ms per stage
   at (64, 4096), and a profile of one run there (in a fresh process);
8. a node cluster on the card, in a fresh process: 16 port Nodes over
   loopback TCP (bench.py's threaded 16-validator cell: heartbeat 0.05 s,
   slow heartbeat 0.3 s, closed-loop 100-byte transactions stamped with
   their submit time, 8 s of warm-up, a 12 s window) in four arms —
   oracle; the offload at its defaults (the sweep batcher and resident
   windows); the same with min_window 0; and min_window 0 with resident
   windows but without the batcher (one sweep per node) — each with identical
   blocks on every node and monotonic timestamps; in the card arms node
   0's chain equals a host-oracle replay of its own events and no fallback;
   K1's launches equal the batcher's sweeps (batched and single; at least
   one of two windows or more) in the batcher arms, the device sweeps the
   nodes launched in the last; committed tx/s and submit-to-commit p50/p95
   per arm, when each node committed each block, the batcher's counters
   and per-sweep times, /metrics scraped
   over HTTP, and a profiled window (torch.profiler and the host sampler)
   of the defaults arm;
9. the command line: four ``python -m babble_tpu_torch run --accelerator``
   processes (their own datadirs, services, socket proxies, min_window 0;
   two at the offload's defaults, two without the batcher sharing one
   admission-slot directory) fed by socket clients until all pass a block,
   which they must agree on, each with device sweeps, resident windows on,
   the batcher as set, no fallback, and time held in the shared slots
   without it; ``/profile?format=torch`` on one of them must hold CUDA
   kernel records;
10. device signature verification (K3, ``ops/verify.py``): the cooperative
   field layer on the card (``kernels.field_ops``) at every group size
   equal to Python integers at the edges, on non-canonical add and sub
   operands and on 4096 random pairs; 4096 signatures from 64 keys, one in
   eight corrupted (CORRUPTIONS) and three that take the ladder's rare
   cases, on whose verdicts K3 (at its group size and at every other), the
   plain ladder on the card, the native verifier, the Python oracle and
   ``batch_verify`` agree; at B = 1 to 16384, K3's device ms at its group
   size and at the other beside its bound and K3's own count of multiplies
   (``k3_own_ms``), host ``_prepare`` and end-to-end
   ``batch_verify`` µs a signature beside the native verifier's, and the
   first B at which ``batch_verify`` beats it (or "none"); then four port
   Nodes over loopback TCP with ``--accelerator`` to block 3, with the host
   verifier and with ``BABBLE_DEVICE_VERIFY=1``: identical blocks, node 0's
   chain equal to a host replay, no single re-check, no offload fallback,
   and with device verification one K3 launch per batch verification
   (counted from 0 once the nodes are up), with the median time of a batch
   verification in each arm.

For each live path (the replays of phases 3 and 4, and the node cluster of
phase 8: its batched waves and its per-node sweeps), K1 is also held
against its plain version, and timed, at the shape that path gave it most
often; K3 likewise at the batch size phase 10's cluster gave it most
often. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab dist/old dist/new dist/new dist/old

runs phase 2's timings only, in each given checkout of the repo in turn
(each builds its own kernels in a fresh process), and exits: two commits
compared on one card; K3 at every B of VERIFY_TIMED_B (1 to 16384) only
where every tree has it. ``--nodes-ab`` does the same with phase 8's node
cluster.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time
from collections import Counter

SYNC_EVENTS = 64
TX_PER_EVENT = 4
TX_BYTES = 100
# events per stream: 256 per validator at 16 validators, and at 64 enough
# for the run to commit well past the peer-set change
EVENTS_16 = 4096
EVENTS_64 = 16384
# the DAG pipeline's 64-validator stream: as large a window as the live
# 64-validator sweeps reach, with no peer-set change (snapshot_from_hashgraph
# models peer-set 0 only)
EVENTS_DAG_64 = 4096
# the 64-validator path: the round from which one validator is gone, and the
# blocks that must commit from rounds after it
CHANGE_ROUND = 3
MIN_BLOCKS_AFTER_CHANGE = 16
# how long a replay may wait for its last pipelined sweep to land
DRAIN_S = 60.0

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the 32-bit rate of
# the CUDA cores outside the tensor cores; K1's compare-adds run there.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# (W, P, S): the smallest witness bucket, a ragged shape, and the live
# buckets of 16-validator (P = 16) and 64-validator (P = 64, S = 1 or 2)
# windows.
K1_SHAPES = [(16, 4, 1), (37, 13, 3), (128, 16, 1), (256, 16, 1),
             (256, 64, 1), (256, 64, 2), (512, 64, 2), (1024, 64, 2)]
# K1 over a batch of windows (B, W, P, S): waves of 16 co-located
# validators' windows as the sweep batcher launches them, at the live
# 16-validator bucket and at the 64-validator one with two slots
K1_BATCH_SHAPES = [(16, 128, 16, 1), (16, 256, 64, 2)]
# K2 (B, E, P): ragged and full single windows up to the pipeline's largest
# (4096 events at 64 validators), the 16-validator stream's window (4096,
# 16), bench.py's window (512, 16), and a batch of 8 of those
K2_SHAPES = [(1, 64, 4), (1, 100, 6), (1, 512, 16), (1, 1000, 40),
             (1, 4096, 16), (1, 4096, 64), (8, 512, 16)]
# the K2 rows of the kernels line: every shape the DAG path launches K2 at
K2_ROWS = [(1, 4096, 16), (1, 4096, 64), (1, 512, 16), (8, 512, 16)]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ----------------------------------------------------------------


def time_on_device(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device milliseconds of one ``fn()`` call. A sleep kernel
    queued first keeps the card busy while the host enqueues every rep, so
    each CUDA event pair brackets device work only, not host overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def launch_floor_ms() -> float:
    """Device ms of an empty kernel (``torch.cuda._sleep(0)``), timed as the
    kernels are: the floor under every kernel time."""
    import torch

    return time_on_device(lambda: torch.cuda._sleep(0))


def k1_bound_ms(W: int, P: int, S: int):
    """Least time for K1's work on an H100 SXM: each input read once and
    the output written once at HBM rate, or S·W²·P compare-adds (two 32-bit
    operations each) at the CUDA cores' rate — whichever is larger."""
    nbytes = 2 * 4 * W * P + S * P + 4 * S * W * W
    ops = 2 * S * W * W * P
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_inputs(W: int, P: int, S: int, seed: int, B: int = 0):
    """Random coordinates with both sentinels mixed in: [W, P] and [S, P],
    or with ``B`` a batch [B, W, P] and [B, S, P]."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    lead = (B,) if B else ()
    la = rng.randint(-1, 50, size=(*lead, W, P)).astype(np.int32)
    fd = rng.randint(0, 50, size=(*lead, W, P)).astype(np.int32)
    fd[rng.rand(*lead, W, P) < 0.3] = np.int32(2**31 - 1)
    la[rng.rand(*lead, W, P) < 0.1] = -1
    member = rng.rand(*lead, S, P) < 0.7
    return tuple(torch.from_numpy(a).cuda() for a in (la, fd, member))


# per-peer coordinate bases at the edges of int32 (live coordinates are
# absolute sequence numbers, unbounded over a node's life), and values far
# from every base, so that la - fd overflows int32
EDGE_BASES = (0, 2**24 - 3, 2**31 - 2**12, 2**12 - 2**31)
EDGE_FAR = (-2**31, -2**31 + 1, -1, 0, 2**31 - 2**12, 2**31 - 2, 2**31 - 1)


def edge_coordinates(shape, seed: int, la_below_max: bool = False):
    """numpy int32 la and fd of ``shape`` ([..., n, P]) at the edges of
    int32: each peer gets a base from EDGE_BASES and la, fd lie within 3 of
    it (frequent ties); 5% of la and of fd are EDGE_FAR values, and the
    sentinels la = -1 (10%) and fd = INT32_MAX (20%) are mixed in. With
    ``la_below_max``, la stays below INT32_MAX (K1's domain). The tests
    of the port use the same values."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = np.array(EDGE_BASES, dtype=np.int64)[
        rng.randint(len(EDGE_BASES), size=shape[-1])]
    far = np.array(EDGE_FAR, dtype=np.int64)
    la = base + rng.randint(-3, 4, size=shape)
    fd = base + rng.randint(-3, 4, size=shape)
    for a in (la, fd):
        pick = rng.rand(*shape) < 0.05
        a[pick] = far[rng.randint(len(far), size=int(pick.sum()))]
    la[rng.rand(*shape) < 0.1] = -1
    fd[rng.rand(*shape) < 0.2] = 2**31 - 1
    if la_below_max:
        la[la == 2**31 - 1] = 2**31 - 2
    return la.astype(np.int32), fd.astype(np.int32)


def k1_edge_inputs(W: int, P: int, S: int, seed: int, B: int = 0):
    """numpy la, fd and member for K1 on edge-value coordinates, la below
    INT32_MAX; with ``B`` a batch of B windows."""
    import numpy as np

    lead = (B,) if B else ()
    la, fd = edge_coordinates((*lead, W, P), seed, la_below_max=True)
    member = np.random.RandomState(seed + 1).rand(*lead, S, P) < 0.7
    return la, fd, member


def edge_super_majority(la, fd) -> int:
    """A threshold at the median count of the first 256 rows of ``la``
    against the first 256 of ``fd``, so that counts of exactly sm - 1 and
    sm both occur."""
    import numpy as np

    counts = (la[..., :256, None, :].astype(np.int64)
              >= fd[..., None, :256, :]).sum(-1)
    return max(1, int(np.median(counts)))


def k1_edge_check(shape, seed: int) -> None:
    """K1 equal to its plain version on edge-value coordinates; ``shape``
    is (W, P, S) or (B, W, P, S)."""
    import torch

    from babble_tpu_torch.ops import kernels

    *batch, W, P, S = shape
    la, fd, member = (torch.from_numpy(a).cuda()
                      for a in k1_edge_inputs(W, P, S, seed, *batch))
    got = kernels.member_ss_counts(la, fd, member)
    want = kernels.member_ss_counts_plain(la, fd, member)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K1 {shape} edge values: {bad} counts differ "
                             "from plain")


def k2_edge_check(shape, seed: int) -> None:
    """K2 equal to its plain version on edge-value coordinates, at the
    threshold ``edge_super_majority`` picks."""
    import torch

    from babble_tpu_torch.ops import kernels

    B, E, P = shape
    la_np, fd_np = edge_coordinates((B, E, P) if B > 1 else (E, P), seed)
    sm = edge_super_majority(la_np, fd_np)
    la, fd = torch.from_numpy(la_np).cuda(), torch.from_numpy(fd_np).cuda()
    got = kernels.strongly_see(la, fd, sm)
    want = kernels.strongly_see_plain(la, fd, sm)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K2 {shape} edge values: {bad} entries differ "
                             "from plain")


def check_k1(shape, seed: int) -> dict:
    """K1 equal to its plain version on random and on edge-value
    coordinates, and timed on the random ones; ``shape`` is (W, P, S), or
    (B, W, P, S) for one launch over B windows, whose bound is B times one
    window's."""
    import torch

    from babble_tpu_torch.ops import kernels

    *batch, W, P, S = shape
    la, fd, member = k1_inputs(W, P, S, seed, *batch)
    got = kernels.member_ss_counts(la, fd, member)
    want = kernels.member_ss_counts_plain(la, fd, member)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K1 {shape}: {bad} counts differ from plain")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    k1_edge_check(shape, seed)
    ms = time_on_device(lambda: kernels.member_ss_counts(la, fd, member))
    plain_ms = time_on_device(
        lambda: kernels.member_ss_counts_plain(la, fd, member), reps=20
    )
    bound_ms, bound_by = k1_bound_ms(W, P, S)
    bound_ms *= batch[0] if batch else 1
    return {"shape": list(shape), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def k2_bound_ms(B: int, E: int, P: int):
    """Least time for K2's work on an H100 SXM: la and fd read once and the
    bool output written once at HBM rate, or B·E²·P compare-adds (two
    32-bit operations each) at the CUDA cores' rate — whichever is
    larger."""
    nbytes = 2 * 4 * B * E * P + B * E * E
    ops = 2 * B * E * E * P
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_inputs(B: int, E: int, P: int, seed: int):
    """Random coordinates with both sentinels mixed in; [E, P] for B = 1,
    else [B, E, P]."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    shape = (B, E, P) if B > 1 else (E, P)
    la = rng.randint(-1, 40, size=shape).astype(np.int32)
    fd = rng.randint(0, 40, size=shape).astype(np.int32)
    fd[rng.rand(*shape) < 0.25] = np.int32(2**31 - 1)
    la[rng.rand(*shape) < 0.1] = -1
    return torch.from_numpy(la).cuda(), torch.from_numpy(fd).cuda()


def check_k2(shape, seed: int) -> dict:
    """K2 equal to its plain version on random and on edge-value
    coordinates, and timed on the random ones."""
    import torch

    from babble_tpu_torch.ops import kernels

    B, E, P = shape
    sm = 2 * P // 3 + 1
    la, fd = k2_inputs(B, E, P, seed)
    got = kernels.strongly_see(la, fd, sm)
    want = kernels.strongly_see_plain(la, fd, sm)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K2 {shape}: {bad} entries differ from plain")
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    k2_edge_check(shape, seed)
    ms = time_on_device(lambda: kernels.strongly_see(la, fd, sm))
    plain_ms = time_on_device(
        lambda: kernels.strongly_see_plain(la, fd, sm), reps=20
    )
    bound_ms, bound_by = k2_bound_ms(B, E, P)
    return {"shape": [B, E, P], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


# -- the signed event stream -------------------------------------------------


def gossip_stream(n_peers: int, n_events: int, seed: int):
    """A seeded random-gossip stream of signed events: each event's self-
    parent is its creator's head, its other-parent a random peer's head,
    and it carries TX_PER_EVENT random transactions of TX_BYTES bytes.
    Returns (events, keys, peer_set)."""
    from babble_tpu_torch.crypto.keys import PrivateKey
    from babble_tpu_torch.crypto.secp256k1 import N as CURVE_N
    from babble_tpu_torch.hashgraph.event import Event
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet

    rng = random.Random(seed)
    keys = [PrivateKey(rng.randrange(1, CURVE_N)) for _ in range(n_peers)]
    peers = PeerSet([
        Peer(f"inmem://p{i}", k.public_key.hex(), f"p{i}")
        for i, k in enumerate(keys)
    ])
    heads = [""] * n_peers
    seqs = [-1] * n_peers
    events = []
    order = list(range(n_peers))
    while len(events) < n_events:
        rng.shuffle(order)
        for i in order:
            if len(events) >= n_events:
                break
            op = ""
            if events:
                j = rng.randrange(n_peers - 1)
                j = j if j < i else j + 1
                op = heads[j]
                if op == "":
                    continue
            idx = seqs[i] + 1
            txs = [rng.randbytes(TX_BYTES) for _ in range(TX_PER_EVENT)]
            e = Event.new(txs, [], [], [heads[i], op],
                          keys[i].public_key.bytes(), idx,
                          timestamp=len(events))
            e.sign(keys[i])
            heads[i] = e.hex()
            seqs[i] = idx
            events.append(e)
    return events, keys, peers


# -- replays -----------------------------------------------------------------


def replay(events, peers, accel=None, peer_sets=()):
    """Replay the stream through the port's live pipeline in syncs of
    SYNC_EVENTS events with a flush after each (Core.sync's cadence), then
    drain any in-flight sweep (wall time included). Returns (hashgraph,
    wall seconds)."""
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore

    h = Hashgraph(InmemStore(1_000_000))
    h.init(peers)
    for r, ps in peer_sets:
        h.store.set_peer_set(r, ps)
    h.accel = accel
    t0 = time.perf_counter()
    for b in range(0, len(events), SYNC_EVENTS):
        for ev in events[b:b + SYNC_EVENTS]:
            h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                             set_wire_info=True)
        h.flush_consensus()
    if accel is not None:
        # a flush defers while the in-flight sweep is still on the card:
        # flush until it lands and is applied
        deadline = time.monotonic() + DRAIN_S
        while accel.busy():
            if time.monotonic() > deadline:
                raise AssertionError("pipelined sweep never drained")
            time.sleep(0.001)
            h.flush_consensus()
    return h, time.perf_counter() - t0


def consensus_state(h):
    """What consensus decided: per event (round, lamport, round-received),
    per round (witness, fame) and received events, every committed block
    body as canonical bytes, and the undetermined set."""
    from babble_tpu_torch.crypto.canonical import canonical_dumps

    store = h.store
    events = {}
    for pk in store.repertoire_by_pub_key():
        for eh in store.participant_events(pk, -1):
            ev = store.get_event(eh)
            events[eh] = (ev.round, ev.lamport_timestamp, ev.round_received)
    rounds = {}
    for r in range(store.last_round() + 1):
        ri = store.get_round(r)
        rounds[r] = (
            {x: (e.witness, int(e.famous)) for x, e in ri.created_events.items()},
            sorted(ri.received_events),
        )
    blocks = [canonical_dumps(store.get_block(b).body.to_dict())
              for b in range(store.last_block_index() + 1)]
    return events, rounds, blocks, sorted(h.undetermined_events)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else 0.0


def run_main_path(label, events, peers, peer_sets=(), min_slots=1,
                  min_blocks_after=(-1, 1), no_resident_arm=False):
    """Oracle, accel at defaults, accel with min_window=0 (both on resident
    windows), and with ``no_resident_arm`` min_window=0 without them (a
    full window build and upload every sweep): identical consensus, no
    fallback, one K1 launch per device sweep. The oracle must commit at
    least ``min_blocks_after[1]`` blocks received in rounds after
    ``min_blocks_after[0]``. Returns (one record per arm, oracle)."""
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.ops import kernels

    oracle, oracle_s = replay(events, peers, peer_sets=peer_sets)
    want = consensus_state(oracle)
    n_blocks = len(want[2])
    n_tx = sum(len(oracle.store.get_block(b).transactions())
               for b in range(n_blocks))
    log(f"[{label}] oracle: {len(events)} events in {oracle_s:.3f} s "
        f"({len(events) / oracle_s:.1f} events/s), {n_blocks} blocks, "
        f"{n_tx} tx committed, {len(want[3])} undetermined")
    after_round, min_after = min_blocks_after
    rounds_received = [oracle.store.get_block(b).round_received()
                       for b in range(n_blocks)]
    n_after = sum(r > after_round for r in rounds_received)
    log(f"[{label}] blocks by round received: {rounds_received}")
    if n_after < min_after:
        raise AssertionError(f"[{label}] the oracle committed {n_after} blocks "
                             f"after round {after_round}, fewer than "
                             f"{min_after}")
    results = []
    arms = [("defaults", {}), ("min_window=0", {"min_window": 0})]
    if no_resident_arm:
        arms.append(("min_window=0, no resident",
                     {"min_window": 0, "resident": False}))
    for arm, kw in arms:
        # one node alone: no batcher (BABBLE_ACCEL_BATCH=0), so the
        # resident windows' device program runs (or, without them,
        # build_voting_window and launch_sweep)
        accel = TensorConsensus(device="cuda", batcher=False, **kw)
        assert accel.resident == kw.get("resident", True), (
            "resident windows did not resolve as asked")
        samples = {k: [] for k in accel.stage_s}
        accel.stage_observer = lambda st, s: samples[st].append(s)
        kernels.reset_launch_counts()
        h, wall = replay(events, peers, accel=accel, peer_sets=peer_sets)
        launches = kernels.launch_counts()["member_ss_counts"]
        st = accel.stats()
        got = consensus_state(h)
        for i, what in enumerate(("events", "rounds/fame", "blocks",
                                  "undetermined")):
            if got[i] != want[i]:
                raise AssertionError(f"[{label}/{arm}] {what} differ from "
                                     "the host oracle")
        if accel.fallbacks:
            raise AssertionError(f"[{label}/{arm}] {accel.fallbacks} fallbacks")
        if accel.sweeps <= 0:
            raise AssertionError(f"[{label}/{arm}] no device sweep ran")
        if launches != accel.sweeps:
            raise AssertionError(f"[{label}/{arm}] K1 launches {launches} != "
                                 f"device sweeps {accel.sweeps}")
        if arm == "min_window=0" and accel.rows_reused_total <= 0:
            raise AssertionError(f"[{label}/{arm}] no resident window row "
                                 "was reused")
        max_s = max(k[3] for k in accel.buckets)
        if max_s < min_slots:
            raise AssertionError(f"[{label}/{arm}] no sweep had {min_slots} "
                                 "peer-set slots")
        split = {k: {"median_ms": 1e3 * statistics.median(v),
                     "p90_ms": 1e3 * _pct(v, 0.9), "n": len(v)}
                 for k, v in samples.items() if v}
        log(f"[{label}/{arm}] blocks identical to the oracle "
            f"({n_blocks}); sweeps {accel.sweeps}, small_windows "
            f"{accel.small_windows}, fallbacks 0, K1 launches {launches}; "
            f"{len(events) / wall:.1f} events/s ({wall:.3f} s)")
        log(f"[{label}/{arm}] buckets (W,E,P,S,R): {st['accel_buckets']}")
        log(f"[{label}/{arm}] per-sweep stages: {json.dumps(split)}")
        n = max(1, accel.sweeps)
        if not accel.resident:
            log(f"[{label}/{arm}] no resident windows: ms per sweep: build "
                f"{1e3 * accel.stage_s['build'] / n:.3f}")
            results.append({"arm": arm, "launches": launches,
                            "buckets": accel.buckets})
            continue
        log(f"[{label}/{arm}] resident windows: rows_delta "
            f"{accel.rows_delta_total}, rows_reused {accel.rows_reused_total},"
            f" rebuilds {accel.window_state.rebuilds}, delta sweeps "
            f"{accel.delta_sweeps} of {accel.sweeps}; ms per sweep: build "
            f"{1e3 * accel.stage_s['build'] / n:.3f}, delta_scan + pack "
            f"{1e3 * (accel.stage_s['delta_scan'] + accel.stage_s['pack']) / n:.3f}")
        results.append({"arm": arm, "launches": launches,
                        "buckets": accel.buckets})
    return results, oracle


def profile_sweep(label, h, reps: int = 10) -> None:
    """Where one live sweep's time goes: ``h``'s undecided window swept on
    the card, wall time per sweep (host clock, synchronised) against the
    device time of its kernels and copies (torch.profiler), and the
    kernels that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops import voting

    win = voting.build_voting_window(h)
    if win is None:
        log(f"[{label}] profile: nothing undecided")
        return
    dev = torch.device("cuda")
    for _ in range(3):
        voting.run_sweep(win, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        voting.run_sweep(win, dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            voting.run_sweep(win, dev)
        torch.cuda.synchronize()
    by_name = Counter()
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n += 1
    if n == 0:
        log(f"[{label}] profile: the profiler saw no device activity; "
            f"device busy share not measured (wall {wall_ms:.3f} ms/sweep)")
        return
    busy_ms = sum(by_name.values()) / 1e3 / reps
    top = [(k, round(v / 1e3 / reps, 4)) for k, v in by_name.most_common(6)]
    log(f"[{label}] profile of one sweep, bucket {voting.bucket_key(win)}: "
        f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {n / reps:.0f} device ops; "
        f"top (name, ms): {top}")


def k1_shapes(res) -> Counter:
    """(W, P, S) -> device sweeps applied, over the arms of a path."""
    shapes = Counter()
    for r in res:
        for (W, _E, P, S, _R), n in r["buckets"].items():
            shapes[(W, P, S)] += n
    return shapes


def k1_row(label, shapes: Counter, launches: dict, main_arm: str,
           seed: int) -> dict:
    """K1 held against its plain version, and timed, at the shape this
    path gave it most often (``shapes``: (W, P, S), or (B, W, P, S) for a
    batched launch); ``launches`` holds each arm's K1 launches, counted
    from 0 for that arm's run, and the row's are the ``main_arm``'s."""
    shape = max(shapes, key=shapes.get)
    row = check_k1(shape, seed)
    log(f"K1 at the {label} path's most frequent shape {shape}: equal to "
        f"plain; kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
        f"bound {row['bound_ms']:.3g} ms ({row['bound_by']}); launches per "
        f"arm {launches}; shapes "
        f"{json.dumps({'x'.join(map(str, k)): n for k, n in shapes.items()})}")
    return {
        "name": f"member_ss_counts[{label}]",
        "route": "cuda",
        "source": "babble_tpu_torch/csrc/member_ss.cu",
        "replaces": "babble_tpu/ops/pallas_kernels.py:104",
        "launches": launches[main_arm],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "shape": row["shape"],
        "launches_by_arm": launches,
    }


# -- the DAG pipeline ---------------------------------------------------------


def oracle_decisions(h, hashes):
    """What the host oracle decided for each row of a snapshot: round,
    witness, lamport, fame (witnesses; 0 elsewhere) and round-received (-1
    when undetermined), as the pipeline packs them."""
    import numpy as np

    from babble_tpu_torch.common.trilean import Trilean

    fame_of = {Trilean.TRUE: 1, Trilean.FALSE: -1, Trilean.UNDEFINED: 0}
    fame = {}
    for r in range(h.store.last_round() + 1):
        for x, e in h.store.get_round(r).created_events.items():
            if e.witness:
                fame[x] = fame_of[e.famous]
    rr = [h.store.get_event(eh).round_received for eh in hashes]
    return {
        "rounds": np.array([h.round(eh) for eh in hashes]),
        "witness": np.array([h.witness(eh) for eh in hashes]),
        "lamport": np.array([h.lamport_timestamp(eh) for eh in hashes]),
        "fame": np.array([fame.get(eh, 0) for eh in hashes]),
        "round_received": np.array([-1 if r is None else r for r in rr]),
    }


def k2_launched(shape, k2_at: Counter, fn):
    """``fn()``, adding the K2 launches it made to ``k2_at[shape]``."""
    from babble_tpu_torch.ops import kernels

    before = kernels.strongly_see.launches
    out = fn()
    k2_at[shape] += kernels.strongly_see.launches - before
    return out


def dag_against_oracle(label, h, k2_at: Counter):
    """run_pipeline on the card over ``h``'s snapshot must equal what the
    oracle ``h`` decided, event for event, and its strongly-see matrix
    (K2's output on the path) must equal K2's plain version on the
    snapshot's own coordinates. Returns the snapshot."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import dag, kernels

    t0 = time.perf_counter()
    snap = dag.snapshot_from_hashgraph(h)
    build_s = time.perf_counter() - t0
    stats = {}
    got = k2_launched(
        (1, snap.n_events, snap.n_peers), k2_at,
        lambda: dag.run_pipeline(snap, return_matrices=True, device="cuda",
                                 stats=stats))
    want = oracle_decisions(h, snap.hashes)
    for k, v in want.items():
        if not np.array_equal(got[k], v):
            bad = int((got[k] != v).sum())
            raise AssertionError(f"[dag {label}] {k}: {bad} of "
                                 f"{len(v)} events differ from the oracle")
    la, fd = (torch.as_tensor(a, device="cuda")
              for a in (snap.last_ancestors, snap.first_descendants))
    plain = kernels.strongly_see_plain(la, fd, snap.super_majority)
    if not np.array_equal(got["strongly_see"], plain.cpu().numpy()):
        bad = int((got["strongly_see"] != plain.cpu().numpy()).sum())
        raise AssertionError(f"[dag {label}] strongly-see: {bad} entries "
                             "differ from K2's plain version")
    n_wit = int(want["witness"].sum())
    log(f"[dag {label}] run_pipeline on the card equals the oracle: "
        f"{snap.n_events} events, P {snap.n_peers}, sm "
        f"{snap.super_majority}, {int(want['rounds'].max()) + 1} rounds, "
        f"{n_wit} witnesses ({int((want['fame'] != 0).sum())} decided), "
        f"{int((want['round_received'] >= 0).sum())} events received; "
        f"strongly-see equal to K2's plain version on the snapshot; "
        f"snapshot built in {build_s:.2f} s; passes {stats}")
    return snap


def dag_against_cpu(k2_at: Counter):
    """The card equals the port's CPU path on see, strongly-see (so K2
    equals its plain version on the path's inputs) and the packed results:
    one synthetic window at bench.py's shape, and a batch of 8. Returns
    (snapshot, batch arrays, super-majority); two pipeline runs on the
    card."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import dag
    from babble_tpu_torch.parallel import batch_of_snapshots, batched_pipeline

    snap = dag.synthetic_snapshot(16, 512)
    got = k2_launched(
        (1, 512, 16), k2_at,
        lambda: dag.run_pipeline(snap, return_matrices=True, device="cuda"))
    want = dag.run_pipeline(snap, return_matrices=True, device="cpu")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"[dag synthetic] {k} differs card vs CPU")
    arrays, sm = batch_of_snapshots(8, 16, 512)
    round_bound = 512 // sm + 2
    got_b = k2_launched(
        (8, 512, 16), k2_at,
        lambda: batched_pipeline(sm, round_bound, device="cuda")(*arrays))
    want_b = batched_pipeline(sm, round_bound, device="cpu")(*arrays)
    for name, g, w in zip(("see", "ss", "packed"), got_b, want_b):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"[dag batch] {name} differs card vs CPU")
    log(f"[dag] card equals CPU on synthetic (16, 512): "
        f"{int(got['rounds'].max()) + 1} rounds, "
        f"{int((got['round_received'] >= 0).sum())} received; and on the "
        f"batch of 8 windows (see, ss, packed)")
    return snap, arrays, sm


def _wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_trace(fn) -> list:
    """(name, µs) of every device kernel, copy and fill of one ``fn()``
    call, from torch.profiler's exported trace, which keeps kernels that
    no PyTorch operation launched (K1 and K2 launch through ctypes)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["name"], float(e["dur"])) for e in trace["traceEvents"]
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def profile_dag(snap, wall_ms: float) -> dict:
    """Where one pipeline run's time goes at ``snap``: device busy time
    (torch.profiler) against ``wall_ms``, the unprofiled median wall time
    of a run, the top device operations, and the shares of K2 and of
    vote_matmul's float32 products (cuBLAS GEMMs) in the busy time."""
    from babble_tpu_torch.ops import dag

    dag.run_pipeline(snap, device="cuda")
    ops = device_trace(lambda: dag.run_pipeline(snap, device="cuda"))
    if not ops:
        log("[dag profile] the profiler saw no device activity; device busy "
            "share not measured")
        return {"busy_ms": None}
    by_name = Counter()
    for name, us in ops:
        by_name[name] += us
    busy_us = sum(by_name.values())
    k2_us = sum(v for k, v in by_name.items() if "strongly_see" in k)
    n_k2 = sum("strongly_see" in name for name, _us in ops)
    gemm_us = sum(v for k, v in by_name.items()
                  if "gemm" in k.lower() or "nvjet" in k)
    top = [(k[:60], round(v / 1e3, 4)) for k, v in by_name.most_common(8)]
    rec = {"busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / wall_ms,
           "device_ops": len(ops), "k2_ms": k2_us / 1e3,
           "k2_share": k2_us / busy_us, "gemm_ms": gemm_us / 1e3,
           "vote_matmul_share": gemm_us / busy_us}
    log(f"[dag profile] one run at (P {snap.n_peers}, E {snap.n_events}): "
        f"device busy {rec['busy_ms']:.3f} ms over {len(ops)} device ops, "
        f"{100 * rec['busy_share']:.1f}% of the {wall_ms:.3f} ms median "
        f"wall time; K2 {rec['k2_ms']:.4f} ms in {n_k2} launch(es) "
        f"({100 * rec['k2_share']:.2f}% of busy), vote_matmul's products "
        f"{rec['gemm_ms']:.3f} ms ({100 * rec['vote_matmul_share']:.1f}%); "
        f"top (name, ms): {top}")
    return rec


def stage_breakdown(snap, reps: int = 3) -> dict:
    """Host-clock ms of each pipeline stage at ``snap``, each ending in a
    synchronize (median of ``reps``): the stages of ``ops.dag.batched_core``
    called one by one on the card."""
    import torch

    from babble_tpu_torch.ops import dag

    creator, index, sp, op, la, fd, mid = (
        t[None] for t in dag.snapshot_tensors(snap, torch.device("cuda")))
    sm = snap.super_majority
    bound = snap.n_events // sm + 2
    samples = {k: [] for k in ("see", "strongly_see", "rounds", "lamport",
                               "fame", "round_received")}
    stats = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps + 1):
        see = timed("see", lambda: dag.see_matrix(creator, index, la))
        ss = timed("strongly_see",
                   lambda: dag.strongly_see_matrix(la, fd, sm))
        rounds, wit = timed("rounds", lambda: dag.compute_rounds(
            creator, sp, op, ss, sm, stats=stats))
        timed("lamport", lambda: dag.compute_lamport(sp, op, stats=stats))
        loop = min(bound, int(rounds.max()))
        fame = timed("fame", lambda: dag.decide_fame(
            rounds, wit, see, ss, mid, sm, loop))
        timed("round_received", lambda: dag.decide_round_received(
            rounds, wit, fame, see, sm, loop))
    med = {k: statistics.median(v[1:]) for k, v in samples.items()}
    log(f"[dag stages] (P {snap.n_peers}, E {snap.n_events}), host-clock ms "
        f"per stage, synchronised, median of {reps}: "
        f"{json.dumps({k: round(v, 3) for k, v in med.items()})}; "
        f"passes {stats}, round loop {loop} of bound {bound}")
    return med


def dag_times(windows, batch) -> None:
    """Median wall ms per run_pipeline and events/s at each window; ms per
    window of the batched pipeline; peak device memory of one run at the
    last window."""
    import torch

    from babble_tpu_torch.ops import dag
    from babble_tpu_torch.parallel import batched_pipeline

    for label, snap, reps in windows:
        stats = {}
        ms = _wall_ms(lambda: dag.run_pipeline(snap, device="cuda",
                                               stats=stats), reps)
        log(f"[dag times] {label} (P {snap.n_peers}, E {snap.n_events}): "
            f"run_pipeline {ms:.3f} ms median of {reps}, "
            f"{snap.n_events / ms * 1e3:.1f} events/s; round loop "
            f"{stats['round_loop']} of bound {stats['round_bound']}")
    arrays, sm = batch
    B, E = arrays[0].shape
    fn = batched_pipeline(sm, E // sm + 2, device="cuda")
    ms = _wall_ms(lambda: fn(*arrays)[2].cpu(), 5)
    log(f"[dag times] batched pipeline, {B} windows of (16, {E}): "
        f"{ms:.3f} ms per batch, {ms / B:.3f} ms per window, "
        f"{B * E / ms * 1e3:.1f} events/s")
    big = windows[-1][1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dag.run_pipeline(big, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[dag times] peak device memory of one run at (P {big.n_peers}, "
        f"E {big.n_events}): {(peak - base) / 2**20:.1f} MiB above the "
        f"{base / 2**20:.1f} MiB held before it")


def profile_child() -> None:
    """The (64, 4096) profile, run by ``profile_dag_fresh`` in a process of
    its own: median wall time of a run, then one profiled run."""
    from babble_tpu_torch.ops import dag, kernels

    kernels.build()
    snap = dag.synthetic_snapshot(64, 4096)
    wall = _wall_ms(lambda: dag.run_pipeline(snap, device="cuda"), 5)
    profile_dag(snap, wall)


def profile_dag_fresh() -> None:
    """``profile_child`` in a fresh interpreter, waited for. In this
    process, minutes old, the profiler's trace of the same run lost device
    records, K2's among them, where a young process kept every one."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.profile_child()"],
        cwd=here, capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise AssertionError(f"profile process exit {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")


def k2_row(row: dict, launches: int, by_phase: dict) -> dict:
    """K2's kernels-line row at one shape: its launches on the DAG path at
    that shape, and the time and bound measured in phase 2."""
    B, E, P = row["shape"]
    return {
        "name": f"strongly_see[B {B}, E {E}, P {P}]",
        "route": "cuda",
        "source": "babble_tpu_torch/csrc/strongly_see.cu",
        "replaces": "babble_tpu/ops/pallas_kernels.py:142",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "shape": row["shape"],
        "launches_by_phase": by_phase,
    }


# -- phase 8: a node cluster on the card, in one process ----------------------

# bench.py's 16-validator threaded cell (BASELINE.json config 3):
# heartbeats, warm-up and window as bench_16node_threads runs them
NODES = 16
HEARTBEAT_S = 0.05
SLOW_HEARTBEAT_S = 0.3
WARMUP_S = 8.0
WINDOW_S = 12.0
# closed loop as bench.py's _measure_rate: PUMP_BATCH transactions every
# PUMP_S while fewer than MAX_BACKLOG are submitted and not committed
PUMP_BATCH = 16
PUMP_S = 0.003
MAX_BACKLOG = 2000
# keeps every event in a node's store, for the replay of node 0's events
NODE_CACHE = 200_000
# the profiled window after the measured one (defaults arm)
PROFILE_S = 2.0
# after the windows, with the load stopped: the block every node must reach
# before the checks, and how long it may take (16 nodes in one process
# reached block 1 from 0 to 31 s after the load stopped, on the H100's host)
SETTLE_BLOCK = 1
SETTLE_S = 90.0
# the arm whose nodes each sweep their own window on resident buffers
NO_BATCHER_ARM = "min_window=0, resident, no batcher"


def free_ports(n: int):
    """``n`` free TCP ports on the loopback interface."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def tcp_cluster(n: int, accelerator: bool):
    """``n`` port Nodes over loopback TCP in this process, each with the
    dummy app behind an InmemProxy (bench.py's _make_tcp_cluster), the
    offload on the card when ``accelerator``. Returns (nodes, proxies,
    states), the nodes initialised and not yet running."""
    from babble_tpu_torch.config.config import Config
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.dummy.state import State as DummyState
    from babble_tpu_torch.hashgraph.store import InmemStore
    from babble_tpu_torch.net.tcp import TCPTransport
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet
    from babble_tpu_torch.proxy.proxy import InmemProxy

    keys = [generate_key() for _ in range(n)]
    peers = PeerSet([
        Peer(f"127.0.0.1:{port}", k.public_key.hex(), f"t{i}")
        for i, (k, port) in enumerate(zip(keys, free_ports(n)))
    ])
    addr = {p.pub_key_hex: p.net_addr for p in peers.peers}
    nodes, proxies, states = [], [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=HEARTBEAT_S,
                      slow_heartbeat_timeout=SLOW_HEARTBEAT_S,
                      log_level="error", moniker=f"t{i}",
                      accelerator=accelerator, cache_size=NODE_CACHE)
        st = DummyState()
        pr = InmemProxy(st)
        node = Node(conf, Validator(k, f"t{i}"), peers, peers,
                    InmemStore(conf.cache_size),
                    TCPTransport(addr[k.public_key.hex()], timeout=2.0), pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
        states.append(st)
    return nodes, proxies, states


def stamped_tx(i: int) -> bytes:
    """A TX_BYTES transaction carrying its submit time and a serial."""
    import struct

    head = struct.pack(">dQ", time.monotonic(), i)
    return head + bytes(TX_BYTES - len(head))


class Pump:
    """bench.py's closed-loop load: PUMP_BATCH stamped transactions every
    PUMP_S, round-robin over the nodes' proxies, while fewer than
    MAX_BACKLOG are submitted and not yet committed on every node."""

    def __init__(self, proxies, states):
        self.proxies = proxies
        self.states = states
        self.i = 0

    def committed(self) -> int:
        return min(len(s.committed_txs) for s in self.states)

    def until(self, t_end: float, stop=None) -> None:
        while time.monotonic() < t_end and not (stop and stop.is_set()):
            if self.i - self.committed() < MAX_BACKLOG:
                for _ in range(PUMP_BATCH):
                    self.proxies[self.i % len(self.proxies)].submit_tx(
                        stamped_tx(self.i))
                    self.i += 1
            time.sleep(PUMP_S)


def tx_latencies(commits, t0: float, t1: float):
    """Submit-to-commit seconds of the stamped transactions that node 0
    committed between t0 and t1; ``commits`` holds (commit time, block)."""
    import struct

    out = []
    for t_commit, block in commits:
        if t0 <= t_commit <= t1:
            out += [t_commit - struct.unpack(">d", tx[:8])[0]
                    for tx in block.transactions() if len(tx) == TX_BYTES]
    return out


def check_cluster_blocks(label, nodes) -> int:
    """Every node's chain up to the common block, which must be at least
    SETTLE_BLOCK: byte-identical bodies (tests/test_node.py::check_gossip)
    and monotonic timestamps. Returns the common block index."""
    common = min(n.get_last_block_index() for n in nodes)
    if common < SETTLE_BLOCK:
        raise AssertionError(f"[{label}] common block {common}: the cluster "
                             "did not commit")
    for bi in range(common + 1):
        ref = nodes[0].get_block(bi).body.hash()
        for n in nodes[1:]:
            if n.get_block(bi).body.hash() != ref:
                raise AssertionError(f"[{label}] block {bi} differs between "
                                     "nodes")
    for n in nodes:
        stamps = [n.get_block(bi).timestamp() for bi in range(common + 1)]
        if stamps != sorted(stamps):
            raise AssertionError(f"[{label}] non-monotonic block timestamps")
    return common


def replay_own_events(label, node) -> int:
    """Node ``node``'s chain against a host-oracle replay of its own events
    in its topological order, through a fresh port Hashgraph with no
    offload and the dummy app's commit: every block body hash equal.
    Returns the number of events replayed."""
    from babble_tpu_torch.dummy.state import State as DummyState
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore

    store = node.core.hg.store
    events = sorted(
        (store.get_event(eh)
         for pk in store.repertoire_by_pub_key()
         for eh in store.participant_events(pk, -1)),
        key=lambda e: e.topological_index,
    )
    app = DummyState()

    def commit(block):
        resp = app.commit_handler(block)
        block.body.state_hash = resp.state_hash
        block.body.internal_transaction_receipts = resp.receipts

    h = Hashgraph(InmemStore(NODE_CACHE), commit)
    h.init(node.core.genesis_peers)
    for ev in events:
        h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                         set_wire_info=True)
    last = node.get_last_block_index()
    if h.store.last_block_index() < last:
        raise AssertionError(f"[{label}] the replay committed "
                             f"{h.store.last_block_index() + 1} blocks, node "
                             f"0 {last + 1}")
    for bi in range(last + 1):
        if h.store.get_block(bi).body.hash() != node.get_block(bi).body.hash():
            raise AssertionError(f"[{label}] node 0's block {bi} differs from "
                                 "the host replay of its events")
    return len(events)


def http_get(url: str, timeout: float = 60.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {url}: HTTP {resp.status}")
        return resp.read()


def trace_device_summary(path: str, seconds: float) -> dict:
    """From a chrome trace of torch.profiler: the device's busy share over
    ``seconds`` (union of kernel and copy intervals), kernel ms by name,
    and K1's launches."""
    with open(path) as f:
        trace = json.load(f)
    spans, by_name, k1, n_kernels = [], Counter(), 0, 0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
        if ev["cat"] == "kernel":
            n_kernels += 1
            by_name[ev["name"][:60]] += ev.get("dur", 0)
            k1 += "member_ss" in ev["name"]
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {
        "kernels": n_kernels, "k1_kernels": k1,
        "busy_ms": busy / 1e3,
        "busy_share": busy / 1e6 / seconds,
        "top_ms": [(k, round(v / 1e3, 3)) for k, v in by_name.most_common(6)],
    }


def device_profile(seconds: float) -> dict:
    """The card's activity over ``seconds`` of whatever runs meanwhile:
    torch.profiler with CUDA activities only (kernels, copies), from this
    thread, summarised by ``trace_device_summary`` (nothing for 0 s, which
    only starts and stops the tracing). Without CPU activities the trace
    stays small enough to stop and export while 16 node threads hold the
    GIL (a CPU and CUDA capture through the service timed out there)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(seconds)
        torch.cuda.synchronize()
    if seconds <= 0:
        return {}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_device_summary(path, seconds)
    finally:
        os.remove(path)


def cluster_arm(label: str, accelerator: bool, env: dict, n: int = NODES,
                warmup_s: float = WARMUP_S, window_s: float = WINDOW_S,
                profile: bool = False, require_batched: bool = False) -> dict:
    """One arm: an ``n``-node cluster under closed-loop load, ``warmup_s``
    then a ``window_s`` measured window (and with ``profile`` a profiled
    window after it), then the checks. K1's launches are counted from 0
    for the arm. With the sweep batcher they must equal its sweeps in the
    arm, batched and single (and with ``require_batched`` at least one
    sweep must have batched two windows or more); without it, the device
    sweeps the nodes launched: applied, dropped stale, and in flight when
    the nodes stopped."""
    import os
    import threading

    import torch

    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.service.service import Service

    batcher = SweepBatcher.instance()
    batch0 = batcher.stats()
    shapes0 = Counter(batcher.sweep_shapes)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        kernels.reset_launch_counts()
        t_setup = time.perf_counter()
        nodes, proxies, states = tcp_cluster(n, accelerator)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    commits = []
    nodes[0].core.commit_listeners.append(
        lambda block: commits.append((time.monotonic(), block)))
    # every node's block commits, as (time, block index): whether the
    # slowest node lags the others or all commit each block together
    node_commits = [[] for _ in nodes]
    for node, mine in zip(nodes, node_commits):
        node.core.commit_listeners.append(
            lambda block, mine=mine: mine.append((time.monotonic(),
                                                  block.index())))
    svc = Service("127.0.0.1:0", nodes[0])
    svc.serve_async()
    rec = {"arm": label}
    try:
        for node in nodes:
            node.run_async()
        log(f"[nodes/{label}] {n} nodes up in "
            f"{time.perf_counter() - t_setup:.2f} s (set-up)")
        pump = Pump(proxies, states)
        pump.until(time.monotonic() + warmup_s)
        base = [len(st.committed_txs) for st in states]
        t0 = time.monotonic()
        pump.until(t0 + window_s)
        t1 = time.monotonic()
        in_window = [len(st.committed_txs) - b
                     for st, b in zip(states, base)]
        # bench.py's rate: the least node's count at the end less the least
        # node's at the start
        rec["tx_per_s"] = (pump.committed() - min(base)) / (t1 - t0)
        rec["window_tx_by_node"] = in_window
        lat = tx_latencies(commits, t0, t1)
        rec["p50_ms"] = 1e3 * _pct(lat, 0.5) if lat else None
        rec["p95_ms"] = 1e3 * _pct(lat, 0.95) if lat else None
        rec["latency_samples"] = len(lat)
        metrics = http_get(f"http://{svc.bind_addr}/metrics").decode()
        if "accel_sweeps_total" not in metrics and accelerator:
            raise AssertionError(f"[nodes/{label}] /metrics lacks the "
                                 "offload's counters")
        if profile:
            stop = threading.Event()
            loader = threading.Thread(
                target=pump.until, args=(time.monotonic() + 120, stop),
                daemon=True)
            loader.start()
            try:
                rec["device_profile"] = device_profile(PROFILE_S)
                cap = json.loads(http_get(
                    f"http://{svc.bind_addr}/profile?format=json"
                    f"&seconds={PROFILE_S}"))
                total = sum(cap["stages"].values()) or 1
                rec["host_stages"] = {
                    k: round(v / total, 3)
                    for k, v in sorted(cap["stages"].items(),
                                       key=lambda kv: -kv[1])}
            finally:
                stop.set()
                loader.join(timeout=10)
        t_settle = time.monotonic()
        while (min(node.get_last_block_index() for node in nodes)
               < SETTLE_BLOCK and time.monotonic() - t_settle < SETTLE_S):
            time.sleep(0.25)
        rec["settle_s"] = time.monotonic() - t_settle
        stats = [node.get_stats_snapshot() for node in nodes]
        # per block: when its first and its last node committed it, and
        # which node was last, in seconds from the window's start
        by_block = {}
        for i, mine in enumerate(node_commits):
            for t, bi in mine:
                by_block.setdefault(bi, []).append((t - t0, i))
        rec["block_commits"] = [
            [bi, round(min(v)[0], 2), round(max(v)[0], 2), max(v)[1], len(v)]
            for bi, v in sorted(by_block.items())]
        # per node, to tell a lagging node apart: syncs ingested, core-lock
        # wait, undetermined events, and its offload's sweeps, contended
        # flushes, rebuilds and snapshot ms (build + delta_scan + pack)
        rec["per_node"] = [
            [s["ingest_syncs"], s["lock_wait_ms_total"],
             s["undetermined_events"], s.get("accel_sweeps", 0),
             s.get("accel_contended", 0), s.get("accel_rebuilds", 0),
             round(sum(s.get("accel_stage_ms", {}).get(k, 0.0)
                       for k in ("build", "delta_scan", "pack")), 1)]
            for s in stats]
    finally:
        t_down = time.monotonic()
        svc.shutdown()
        # all at once: each node waits up to 2 s for its gossip routines
        stoppers = [threading.Thread(target=node.shutdown) for node in nodes]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=120)
        for node in nodes:
            with node.core_lock:  # a sync still in flight finishes first
                pass
        rec["shutdown_s"] = time.monotonic() - t_down
    if accelerator:
        # the batcher sweeps the windows the nodes queued before they
        # stopped; count its launches once it is done
        deadline = time.monotonic() + 60
        while not batcher.idle():
            if time.monotonic() > deadline:
                raise AssertionError(f"[nodes/{label}] the sweep batcher "
                                     "never went idle")
            time.sleep(0.05)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()["member_ss_counts"]
    rec["common_block"] = check_cluster_blocks(f"nodes/{label}", nodes)
    rec["node0_commit_p50_ms"] = stats[0]["commit_latency_p50_ms"]
    rec["launches"] = launches
    if not accelerator:
        if launches:
            raise AssertionError(f"[nodes/{label}] the oracle launched K1")
        return rec
    accels = [node.core.hg.accel for node in nodes]
    applied = sum(a.sweeps for a in accels)
    stale = sum(a.stale_drops for a in accels)
    in_flight = sum(a.busy() for a in accels)
    rec.update(
        sweeps=applied, stale_drops=stale, in_flight=in_flight,
        small_windows=sum(a.small_windows for a in accels),
        contended=sum(a.contended for a in accels),
        fallbacks=sum(a.fallbacks for a in accels),
        buckets=sum((a.buckets for a in accels), Counter()),
    )
    batched = accels[0].batcher
    if any(a.batcher != batched or not a.resident for a in accels):
        raise AssertionError(f"[nodes/{label}] nodes resolved different "
                             "offload options, or resident windows off")
    rec["batcher"] = batched
    rec["rows_delta"] = sum(a.rows_delta_total for a in accels)
    rec["rows_reused"] = sum(a.rows_reused_total for a in accels)
    rec["rebuilds"] = sum(a.window_state.rebuilds for a in accels)
    rec["delta_sweeps"] = sum(a.delta_sweeps for a in accels)
    if batched:
        b1 = batcher.stats()
        wave = {k: b1[k] - batch0[k] for k in (
            "batch_batches", "batch_singles", "batch_windows",
            "batch_refused", "batch_dispatch_ms", "batch_dispatch_cpu_ms",
            "batch_readback_ms")}
        shapes = Counter(batcher.sweep_shapes) - shapes0
        wave["batch_max"] = max((k[0] for k in shapes), default=0)
        rec["wave"] = wave
        rec["sweep_shapes"] = shapes
        rec["expected_launches"] = (wave["batch_batches"]
                                    + wave["batch_singles"])
    else:
        rec["expected_launches"] = applied + stale + in_flight
    busiest = max(stats, key=lambda s: s["accel_sweeps"])
    rec["busiest"] = {k: busiest[k] for k in (
        "accel_sweeps", "accel_avg_sweep_ms", "accel_contended",
        "accel_deferred", "accel_small_windows")}
    # where a sweep's time goes, per sweep launched and not in flight: the
    # stages, the dispatch thread's CPU time and the slot's hold time
    rec["busiest_per_sweep_ms"] = per_sweep_ms(
        busiest["accel_stage_ms"], busiest["accel_dispatch_cpu_ms"],
        busiest["accel_slot_held_ms"],
        busiest["accel_sweeps"] + busiest["accel_stale_drops"])
    rec["cluster_per_sweep_ms"] = per_sweep_ms(
        {k: 1e3 * sum(a.stage_s[k] for a in accels)
         for k in accels[0].stage_s},
        1e3 * sum(a.dispatch_cpu_s for a in accels),
        1e3 * sum(a.slot_held_s for a in accels), applied + stale)
    if rec["fallbacks"]:
        raise AssertionError(f"[nodes/{label}] {rec['fallbacks']} fallbacks")
    if any(s["accel_kernel"] != "cuda" for s in stats):
        raise AssertionError(f"[nodes/{label}] a node's sweep is not on K1")
    if launches != rec["expected_launches"]:
        what = ("the batcher's sweeps (batched + single)" if batched else
                f"device sweeps launched (applied {applied}, stale {stale},"
                f" in flight {in_flight})")
        raise AssertionError(f"[nodes/{label}] K1 launches {launches} != "
                             f"{rec['expected_launches']}, {what}")
    if require_batched and not (batched and rec["wave"]["batch_batches"] > 0
                                and rec["wave"]["batch_max"] >= 2):
        raise AssertionError(f"[nodes/{label}] no batched sweep of two or "
                             f"more windows: {rec['wave']}")
    t_replay = time.monotonic()
    rec["replayed_events"] = replay_own_events(f"nodes/{label}", nodes[0])
    rec["replay_s"] = time.monotonic() - t_replay
    return rec


def per_sweep_ms(stage_ms: dict, dispatch_cpu_ms: float,
                 slot_held_ms: float, n: int) -> dict:
    n = max(1, n)
    out = {k: round(v / n, 3) for k, v in stage_ms.items()}
    out["dispatch_cpu"] = round(dispatch_cpu_ms / n, 3)
    out["slot_held"] = round(slot_held_ms / n, 3)
    return out


def log_arm(rec: dict, name_power: str) -> None:
    def ms(x):
        return "n/a" if x is None else f"{x:.1f}"

    log(f"[nodes/{rec['arm']}] block commits (block, first node s, last "
        f"node s from the window's start, last node, nodes): "
        f"{json.dumps(rec['block_commits'])}; tx committed in the window by "
        f"node {rec['window_tx_by_node']}")
    log(f"[nodes/{rec['arm']}] per node (syncs, lock wait ms, undetermined, "
        f"sweeps, contended, rebuilds, snapshot ms): "
        f"{json.dumps(rec['per_node'])}")
    log(f"[nodes/{rec['arm']}] {rec['tx_per_s']:.1f} committed tx/s; "
        f"submit-to-commit p50 {ms(rec['p50_ms'])} ms, p95 "
        f"{ms(rec['p95_ms'])} ms ({rec['latency_samples']} tx); node 0 "
        f"commit_latency_p50_ms {rec['node0_commit_p50_ms']}; blocks "
        f"identical on every node up to block {rec['common_block']} "
        f"(reached {rec['settle_s']:.1f} s after the load stopped; nodes "
        f"stopped in {rec['shutdown_s']:.1f} s); {name_power}")
    if "sweeps" not in rec:
        return
    log(f"[nodes/{rec['arm']}] sweeps applied {rec['sweeps']}, stale "
        f"{rec['stale_drops']}, in flight {rec['in_flight']}; K1 launches "
        f"{rec['launches']}; small_windows {rec['small_windows']}, contended "
        f"{rec['contended']}, fallbacks 0; node 0's chain equals the host "
        f"replay of its {rec['replayed_events']} events ({rec['replay_s']:.1f}"
        f" s); busiest node "
        f"{json.dumps(rec['busiest'])}")
    log(f"[nodes/{rec['arm']}] resident windows: rows_delta "
        f"{rec['rows_delta']}, rows_reused {rec['rows_reused']}, rebuilds "
        f"{rec['rebuilds']}, sweeps that uploaded only the delta "
        f"{rec['delta_sweeps']}")
    if rec["batcher"]:
        w = rec["wave"]
        n = max(1, w["batch_batches"] + w["batch_singles"])
        log(f"[nodes/{rec['arm']}] sweep batcher: {json.dumps(w)}; K1 "
            f"launches {rec['launches']} = batched {w['batch_batches']} + "
            f"single {w['batch_singles']} (1 per sweep); per sweep: dispatch "
            f"{w['batch_dispatch_ms'] / n:.3f} ms wall, "
            f"{w['batch_dispatch_cpu_ms'] / n:.3f} ms CPU, readback "
            f"{w['batch_readback_ms'] / n:.3f} ms, "
            f"{w['batch_windows'] / n:.2f} windows; launch shapes (B,W,P,S) "
            f"{json.dumps({'x'.join(map(str, k)): v for k, v in rec['sweep_shapes'].most_common()})}")
    log(f"[nodes/{rec['arm']}] ms per sweep (readback: enqueue end to the "
        f"flush that finds it landed; dispatch_cpu: the dispatching "
        f"thread's CPU time): busiest node "
        f"{json.dumps(rec['busiest_per_sweep_ms'])}, all nodes "
        f"{json.dumps(rec['cluster_per_sweep_ms'])}")
    buckets = {"x".join(map(str, k)): v
               for k, v in rec["buckets"].most_common()}
    log(f"[nodes/{rec['arm']}] buckets (W,E,P,S,R): {json.dumps(buckets)}")
    if "device_profile" in rec:
        prof = rec["device_profile"]
        log(f"[nodes/{rec['arm']}] profiled {PROFILE_S} s under load: device "
            f"busy {prof['busy_ms']:.1f} ms ({prof['busy_share']:.1%}), "
            f"{prof['kernels']} kernels, {prof['k1_kernels']} of them K1; "
            f"top (name, ms): {prof['top_ms']}")
        log(f"[nodes/{rec['arm']}] host sampler, share of thread samples by "
            f"stage: {json.dumps(rec['host_stages'])}")


def node_cluster_child() -> None:
    """Phase 8, in a process of its own: oracle, the card at its defaults,
    the card with min_window 0. Prints each arm, then one ``NODES`` line of
    JSON for the parent."""
    import torch

    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.ops.device import nvidia_smi_name_power

    kernels.build()
    torch.cuda.init()
    name_power = nvidia_smi_name_power() or "nvidia-smi: not available"
    # Start the profiler's CUDA tracing once while this process has one
    # thread: its first start under 16 node threads took 208 s.
    t0 = time.perf_counter()
    device_profile(0.0)
    log(f"[nodes] profiler warmed up in {time.perf_counter() - t0:.2f} s "
        "(set-up)")
    arms = []
    for label, acc, env, prof in (
        ("oracle", False, {}, False),
        ("defaults", True, {}, True),
        ("min_window=0", True, {"BABBLE_ACCEL_MIN_WINDOW": "0"}, False),
        (NO_BATCHER_ARM, True,
         {"BABBLE_ACCEL_MIN_WINDOW": "0", "BABBLE_ACCEL_BATCH": "0"}, False),
    ):
        t0 = time.perf_counter()
        rec = cluster_arm(label, acc, env, profile=prof,
                          require_batched=acc and "BABBLE_ACCEL_BATCH" not in env)
        log_arm(rec, name_power)
        log(f"[nodes/{label}] arm wall {time.perf_counter() - t0:.1f} s")
        arms.append(rec)
    for rec in arms[2:]:
        if rec["sweeps"] <= 0:
            raise AssertionError(f"[nodes/{rec['arm']}] no device sweep ran")
    if arms[3]["delta_sweeps"] <= 0:
        raise AssertionError(f"[nodes/{arms[3]['arm']}] no sweep ran on the "
                             "resident buffers with only its delta")
    for rec in arms:
        for key in ("buckets", "sweep_shapes"):
            if key in rec:
                rec[key] = [[list(k), v] for k, v in rec[key].items()]
    print("NODES " + json.dumps(arms), flush=True)


def node_cluster_fresh() -> list:
    """``node_cluster_child`` in a fresh interpreter (a young process keeps
    every device record in its profile, see ``profile_dag_fresh``, and the
    cluster's threads start from a clean process). Returns its arms."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.node_cluster_child()"],
        cwd=here, capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.splitlines()
    sys.stdout.write("".join(ln + "\n" for ln in lines
                             if not ln.startswith("NODES ")))
    sys.stdout.flush()
    if proc.returncode != 0:
        raise AssertionError(f"node cluster process exit {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    arms = json.loads([ln for ln in lines if ln.startswith("NODES ")][0][6:])
    for rec in arms:
        for key in ("buckets", "sweep_shapes"):
            if key in rec:
                rec[key] = Counter({tuple(k): v for k, v in rec[key]})
    return arms


# -- phase 9: the command line, as processes ---------------------------------

CLI_NODES = 4
# the first CLI_BATCHED node processes run the batcher, the others share
# admission slots
CLI_BATCHED = 2
CLI_TARGET_BLOCK = 4
CLI_PROFILE_S = 1.0
CLI_TIMEOUT_S = 180.0


def cli_cluster() -> dict:
    """CLI_NODES ``python -m babble_tpu_torch run --accelerator`` processes
    on the card, each with its own datadir (keygen, peers.json), service,
    socket proxy and dummy client, with BABBLE_ACCEL_MIN_WINDOW=0
    (bench.py's bench_subprocess_cluster): the first CLI_BATCHED at the
    offload's defaults (the sweep batcher and resident windows, each
    process with its own batcher), the others with BABBLE_ACCEL_BATCH=0
    and one shared BABBLE_ACCEL_SLOT_DIR (the cross-process admission
    slots, flock files). Clients submit until every node passes
    CLI_TARGET_BLOCK; then every node must agree on that block's body,
    report device sweeps, resident windows on, the batcher as set, no
    fallback, and (without the batcher) time held in a shared slot, whose
    files must exist; node 0's torch profile must hold CUDA kernel records.
    The children are killed at the end; one that exits early fails the
    phase."""
    import os
    import shutil
    import subprocess
    import tempfile
    import threading

    from babble_tpu_torch.crypto.keyfile import SimpleKeyfile
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.dummy.socket_client import DummySocketClient
    from babble_tpu_torch.hashgraph.block import BlockBody

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    n, target_block = CLI_NODES, CLI_TARGET_BLOCK
    ports = free_ports(4 * n)
    gossip, service, proxy, client = (ports[i * n:(i + 1) * n]
                                      for i in range(4))
    keys = [generate_key() for _ in range(n)]
    peers = [{"NetAddr": f"127.0.0.1:{gossip[i]}",
              "PubKeyHex": k.public_key.hex(), "Moniker": f"c{i}"}
             for i, k in enumerate(keys)]
    env = {**os.environ, "BABBLE_ACCEL_MIN_WINDOW": "0"}
    slot_dir = os.path.join(tmp, "slots")
    env_slots = {**env, "BABBLE_ACCEL_BATCH": "0",
                 "BABBLE_ACCEL_SLOT_DIR": slot_dir}
    procs, clients, errs = [], [], []

    def check_alive() -> None:
        for i, p in enumerate(procs):
            if p.poll() is not None:
                errs[i].flush()
                with open(errs[i].name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"[cli] node {i} exited early with "
                                     f"{p.returncode}:\n{tail}")

    def stats(i: int) -> dict:
        """A node's /stats: the reference's map of strings."""
        return json.loads(http_get(f"http://127.0.0.1:{service[i]}/stats",
                                   timeout=5))

    try:
        t_start = time.perf_counter()
        for i, k in enumerate(keys):
            dd = os.path.join(tmp, f"c{i}")
            os.makedirs(dd)
            SimpleKeyfile(os.path.join(dd, "priv_key")).write_key(k)
            for fn in ("peers.json", "peers.genesis.json"):
                with open(os.path.join(dd, fn), "w") as f:
                    json.dump(peers, f)
            errs.append(open(os.path.join(tmp, f"c{i}.err"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "babble_tpu_torch", "run",
                 "--accelerator", "--datadir", dd,
                 "--listen", f"127.0.0.1:{gossip[i]}",
                 "--service-listen", f"127.0.0.1:{service[i]}",
                 "--proxy-listen", f"127.0.0.1:{proxy[i]}",
                 "--client-connect", f"127.0.0.1:{client[i]}",
                 "--heartbeat", str(HEARTBEAT_S),
                 "--slow-heartbeat", str(SLOW_HEARTBEAT_S),
                 "--moniker", f"c{i}", "--log", "error"],
                stdout=subprocess.DEVNULL, stderr=errs[i], cwd=here,
                env=env if i < CLI_BATCHED else env_slots,
            ))
            clients.append(DummySocketClient(f"127.0.0.1:{client[i]}",
                                             f"127.0.0.1:{proxy[i]}"))
        deadline = time.monotonic() + CLI_TIMEOUT_S
        up = set()
        while len(up) < n:
            check_alive()
            if time.monotonic() > deadline:
                raise AssertionError(f"[cli] only {len(up)}/{n} nodes came up")
            for i in set(range(n)) - up:
                try:
                    if stats(i).get("state") == "Babbling":
                        up.add(i)
                except OSError:
                    pass
            time.sleep(0.5)
        log(f"[cli] {n} node processes babbling "
            f"{time.perf_counter() - t_start:.1f} s after launch (set-up)")
        stop = threading.Event()

        def submit() -> None:
            j = 0
            while not stop.is_set():
                clients[j % n].submit_tx(stamped_tx(j))
                j += 1
                time.sleep(0.002)

        loader = threading.Thread(target=submit, daemon=True)
        loader.start()
        try:
            t0 = time.perf_counter()
            while min(int(stats(i)["last_block_index"])
                      for i in range(n)) < target_block:
                check_alive()
                if time.monotonic() > deadline:
                    raise AssertionError("[cli] the nodes did not reach "
                                         f"block {target_block}")
                time.sleep(0.25)
            t_blocks = time.perf_counter() - t0
            prof = json.loads(http_get(
                f"http://127.0.0.1:{service[0]}/profile?format=torch"
                f"&seconds={CLI_PROFILE_S}"))
            t_prof = time.perf_counter() - t0 - t_blocks
        finally:
            stop.set()
            loader.join(timeout=10)
        bodies = [json.loads(http_get(
            f"http://127.0.0.1:{service[i]}/block/{target_block}"))["Body"]
            for i in range(n)]
        hashes = {BlockBody.from_dict(b).hash().hex() for b in bodies}
        if len(hashes) != 1:
            raise AssertionError(f"[cli] block {target_block} differs across "
                                 f"nodes: {hashes}")
        all_stats = [stats(i) for i in range(n)]
        for i, st in enumerate(all_stats):
            batched = i < CLI_BATCHED
            if (st["consensus_engine"] != "device"
                    or int(st["accel_sweeps"]) <= 0
                    or int(st["accel_fallbacks"]) != 0
                    or st["accel_kernel"] != "cuda"
                    or st["accel_batcher"] != str(batched)
                    or st["accel_resident"] != "True"
                    or (not batched
                        and float(st["accel_slot_held_ms"]) <= 0)):
                raise AssertionError(f"[cli] node {i}: engine "
                                     f"{st['consensus_engine']}, kernel "
                                     f"{st['accel_kernel']}, sweeps "
                                     f"{st['accel_sweeps']}, fallbacks "
                                     f"{st['accel_fallbacks']}, batcher "
                                     f"{st['accel_batcher']} (want "
                                     f"{batched}), resident "
                                     f"{st['accel_resident']}, slot held "
                                     f"{st['accel_slot_held_ms']} ms")
        slot_files = sorted(os.listdir(slot_dir))
        if not slot_files or any(not f.startswith("sweep-slot-")
                                 for f in slot_files):
            raise AssertionError(f"[cli] shared slot dir holds {slot_files}, "
                                 "not the admission slot files")
        summary = trace_device_summary(prof["trace_file"], CLI_PROFILE_S)
        if summary["kernels"] <= 0:
            raise AssertionError("[cli] the torch profile holds no CUDA "
                                 "kernel records")
        check_alive()
        rec = {
            "block": target_block, "body_hash": hashes.pop(),
            "seconds_to_block": t_blocks,
            "sweeps": [int(st["accel_sweeps"]) for st in all_stats],
            "contended": [int(st["accel_contended"]) for st in all_stats],
            "batched": [int(st.get("batch_batches", 0))
                        for st in all_stats],
            "slot_held_ms": [float(st["accel_slot_held_ms"])
                             for st in all_stats],
            "rows_reused": [int(st["accel_rows_reused"])
                            for st in all_stats],
            "profile": summary,
        }
        log(f"[cli] {n} processes agree on block {target_block} (body "
            f"{rec['body_hash'][:16]}…, reached in {t_blocks:.1f} s); "
            f"consensus_engine device, resident windows on, the batcher on "
            f"nodes 0-{CLI_BATCHED - 1} and off on the others, which share "
            f"the slot files {slot_files}; sweeps {rec['sweeps']}, batched "
            f"sweeps {rec['batched']}, rows_reused {rec['rows_reused']}, "
            f"contended {rec['contended']}, slot held ms "
            f"{rec['slot_held_ms']}, fallbacks 0; /profile?format=torch over "
            f"{CLI_PROFILE_S} s on node 0 (answered in {t_prof:.1f} s): "
            f"{summary['kernels']} CUDA kernel records, "
            f"{summary['k1_kernels']} of them K1, device busy "
            f"{summary['busy_share']:.1%}")
        return rec
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)
        for c in clients:
            c.close()
        for f in errs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 10: device signature verification (K3) ---------------------------

# the verdict batch: signatures from VERIFY_KEYS keys, about one in eight
# corrupted (CORRUPTIONS in turn), and the ladder's rare cases
VERIFY_N = 4096
VERIFY_KEYS = 64
# batch sizes timed; the timing batch repeats the verdict batch
VERIFY_TIMED_B = (1, 64, 256, 1024, 4096, 16384)
# how many ways a signature is made invalid, in order (signature_batch)
CORRUPTIONS = ("wrong hash", "r + 1", "r - 1", "s + 1", "s - 1", "r = 0",
               "r = n", "s = 0", "wrong key", "key off the curve", "Q = -G")
# the 4-node cluster: run until every node has committed this block
VERIFY_CLUSTER_NODES = 4
VERIFY_BLOCK = 3
VERIFY_CLUSTER_S = 90.0
# H100 SXM: 32-bit integer multiplies a clock per SM for compute capability
# 9.0 (CUDA C Programming Guide, arithmetic instruction throughput), SMs
INT_MULS_PER_CLOCK_SM = 64
H100_SMS = 132
# multiply instructions per field multiplication or squaring in K3: 64
# 32 x 32-bit partial products, low and high words (the folds' few
# multiplies by 977 are not counted)
MULS_PER_FIELD_MUL = 128
# K3's threads a block (csrc/ecdsa_verify.cu kThreads)
K3_THREADS = 128
# field multiplications: a doubling (2M + 5S), a mixed addition (8M + 3S),
# the final projective check (Z^2, r Z^2, rn Z^2)
FIELD_MULS_DOUBLE = 7
FIELD_MULS_ADD = 11
FIELD_MULS_CHECK = 3
# the squarings among them
FIELD_SQRS_DOUBLE = 5
FIELD_SQRS_ADD = 3
FIELD_SQRS_CHECK = 1
# K3's own multiply instructions a field squaring, by group size: one lane
# forms 36 products (28 cross products, doubled, and 8 squares), four lanes
# all 64 (csrc/ecdsa_verify.cu sqr_rows, fe_mul_n)
K3_MULS_PER_SQR = {1: 72, 4: 128}


def field_edge_pairs():
    """(x, y) pairs at the edges of K3's field layer: every pair of edge
    values below p, (p - 1)^2 (its reduction ends in the conditional
    subtract of p), and a product whose second fold carries out of 2^256
    (2^255 times a constructed y)."""
    from babble_tpu_torch.ops.limbs import P_INT

    edges = [0, 1, 2, 977, (1 << 32) + 977, P_INT - (1 << 32), 1 << 255,
             (1 << 255) + 12345, P_INT - 2, P_INT - 1]
    pairs = [(x, y) for x in edges for y in edges]
    pairs.append((1 << 255, int("459169e1800aea6656576f707c4fb3b5"
                                "93d32806d7243de4eeafc94d1320c0db", 16)))
    return pairs


def check_field_ops(seed: int, n_random: int = 4096) -> int:
    """K3's cooperative field layer on the card (``kernels.field_ops``) at
    every group size equal to Python integers for mul, sqr, add and sub mod
    p at the edges, on non-canonical add and sub operands and on
    ``n_random`` random pairs; one launch an operation and group size.
    Returns the pairs checked."""
    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.ops.limbs import P_INT, ints_to_limbs

    rng = random.Random(seed)
    pairs = field_edge_pairs() + [(rng.randrange(P_INT), rng.randrange(P_INT))
                                  for _ in range(n_random)]
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    a, b = ints_to_limbs(xs).cuda(), ints_to_limbs(ys).cuda()
    loose = noncanonical_pairs()
    la = ints_to_limbs([x for x, _ in loose]).cuda()
    lb = ints_to_limbs([y for _, y in loose]).cuda()
    want = {"mul": lambda x, y: x * y % P_INT, "sqr": lambda x, y: x * x % P_INT,
            "add": add_mod_p_int, "sub": sub_mod_p_int}
    for group in kernels.ECDSA_GROUPS:
        for op, fn in want.items():
            cases = [(pairs, a, b)]
            if op in ("add", "sub"):
                cases.append((loose, la, lb))
            for ps, x_l, y_l in cases:
                got = kernels.field_ops(op, x_l, y_l, group)
                vals = [int.from_bytes(row.tobytes(), "little")
                        for row in got.cpu().numpy().astype("<u2")]
                bad = [i for i, (x, y) in enumerate(ps) if vals[i] != fn(x, y)]
                if bad:
                    raise AssertionError(
                        f"K3 field {op} at G {group}: {len(bad)} of "
                        f"{len(ps)} differ from Python ints, first {bad[:5]}")
    return len(pairs) + len(loose)


def add_mod_p_int(x: int, y: int) -> int:
    """The JAX package's add_mod_p on any 256-bit x and y: s = x + y, then
    s - p (mod 2^256) where s reaches p, else s."""
    from babble_tpu_torch.ops.limbs import P_INT

    s = x + y
    return (s - P_INT) % 2**256 if s >= P_INT else s


def sub_mod_p_int(x: int, y: int) -> int:
    """The JAX package's sub_mod_p: x + ((p - y) mod 2^256)."""
    from babble_tpu_torch.ops.limbs import P_INT

    return add_mod_p_int(x, (P_INT - y) % 2**256)


def noncanonical_pairs():
    """Add and subtract operands at or above p, up to 2^256 - 1, against
    each other and the edges below p: their sums and differences differ
    from a + b and a - b mod p, and K3 must give the JAX package's."""
    from babble_tpu_torch.ops.limbs import P_INT

    high = [P_INT, P_INT + 1, P_INT + 977, 2**256 - 2**32, 2**256 - 2,
            2**256 - 1]
    low = [0, 1, 2**32 + 977, P_INT - 1, 1 << 255]
    return ([(x, y) for x in high for y in high + low]
            + [(x, y) for x in low for y in high])


def verify_vectors():
    """The 21 vectors of the JAX package's verifier tests
    (tests/test_ops_verify.py::_vectors, built the same way from seed 11
    with the port's curve): 12 valid signatures, then a wrong hash, r + 1,
    s + 1, r = 0, r = n, s = 0, a wrong key, a key off the curve and
    Q == -G (whose G + Q table entry is infinite)."""
    import hashlib

    from babble_tpu_torch.crypto import secp256k1 as ref

    rng = random.Random(11)
    items = []
    for i in range(12):
        d = rng.randrange(1, ref.N)
        pub = ref.pubkey_from_scalar(d)
        h = hashlib.sha256(f"msg {i}".encode()).digest()
        r, s = ref.sign(d, h)
        items.append((pub, h, r, s))
    d = rng.randrange(1, ref.N)
    pub = ref.pubkey_from_scalar(d)
    h = hashlib.sha256(b"a").digest()
    r, s = ref.sign(d, h)
    return items + [
        (pub, hashlib.sha256(b"b").digest(), r, s),
        (pub, h, (r + 1) % ref.N, s),
        (pub, h, r, (s + 1) % ref.N),
        (pub, h, 0, s),
        (pub, h, ref.N, s),
        (pub, h, r, 0),
        (ref.pubkey_from_scalar(d + 1), h, r, s),
        ((pub[0], (pub[1] + 1) % ref.P), h, r, s),
        ((ref.GX, ref.P - ref.GY), h, 12345, 67890),
    ]


def ladder_edge_items():
    """Valid and invalid signatures whose ladders take the mixed addition's
    rare cases: P1 == P2 (u1 = 2, u2 = 1, Q = 2G: a doubling inside the
    addition, R = 4G), P1 == -P2 followed by a lift (u1 = 5, u2 = 2,
    Q = -2G: R = G) and R at infinity (u1 = 4, u2 = 2, Q = -2G). Each is
    (pub, hash, r, s), made from u1 = e / s and u2 = r / s (mod n)."""
    from babble_tpu_torch.crypto import secp256k1 as ref

    n = ref.N
    g2 = ref.point_mul(2, ref.G)
    neg_g2 = (g2[0], ref.P - g2[1])
    r4 = ref.point_mul(4, ref.G)[0] % n
    rg = ref.GX % n
    half = rg * pow(2, -1, n) % n  # s with u2 = r / s = 2
    return [
        (g2, (2 * r4 % n).to_bytes(32, "big"), r4, r4),
        (neg_g2, (5 * half % n).to_bytes(32, "big"), rg, half),
        (neg_g2, (4 * half % n).to_bytes(32, "big"), rg, half),
    ]


def signature_batch(n: int, n_keys: int, seed: int):
    """``n`` ECDSA items (pub, hash, r, s) from ``n_keys`` seeded keys, signed
    by the native library (pure Python where it is missing); every eighth
    is corrupted, by each way of CORRUPTIONS in turn."""
    import hashlib

    from babble_tpu_torch import native_crypto
    from babble_tpu_torch.crypto import secp256k1 as ref

    rng = random.Random(seed)
    privs = [rng.randrange(1, ref.N) for _ in range(n_keys)]
    pubs = [native_crypto.pubkey(d.to_bytes(32, "big"))
            or ref.pubkey_from_scalar(d) for d in privs]
    items = []
    for i in range(n):
        k = i % n_keys
        h = hashlib.sha256(f"{seed} {i}".encode()).digest()
        r, s = (native_crypto.sign(privs[k].to_bytes(32, "big"), h)
                or ref.sign(privs[k], h))
        pub = pubs[k]
        if i % 8 == 7:
            how = CORRUPTIONS[(i // 8) % len(CORRUPTIONS)]
            if how == "wrong hash":
                h = hashlib.sha256(h).digest()
            elif how in ("r + 1", "r - 1"):
                r = (r + (1 if how == "r + 1" else -1)) % ref.N
            elif how in ("s + 1", "s - 1"):
                s = (s + (1 if how == "s + 1" else -1)) % ref.N
            elif how == "r = 0":
                r = 0
            elif how == "r = n":
                r = ref.N
            elif how == "s = 0":
                s = 0
            elif how == "wrong key":
                pub = pubs[(k + 1) % n_keys]
            elif how == "key off the curve":
                pub = (pub[0], (pub[1] + 1) % ref.P)
            else:
                pub = (ref.GX, ref.P - ref.GY)
        items.append((pub, h, r, s))
    return items


def native_verify_items(items):
    """The native batch verifier on ``items``, as the node's host path calls
    it (crypto.batch.prevalidate_events_host without its verdict cache)."""
    from babble_tpu_torch import native_crypto

    pubs = [x.to_bytes(32, "big") + y.to_bytes(32, "big")
            for (x, y), _, _, _ in items]
    got = native_crypto.verify_batch(pubs, [h for _, h, _, _ in items],
                                     [(r, s) for _, _, r, s in items])
    if got is None:
        raise AssertionError("native crypto library unavailable")
    return got


def _oracle_chunk(items):
    from babble_tpu_torch.crypto import secp256k1 as ref

    return [ref.verify(*it) for it in items]


def oracle_verdicts(items, workers: int = 8):
    """``crypto.secp256k1.verify`` (pure Python) of every item, over
    ``workers`` spawned processes, which are shut down before it returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    chunks = [items[i:i + 64] for i in range(0, len(items), 64)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return [v for part in pool.map(_oracle_chunk, chunks) for v in part]


def _k3_ladder_counts(inputs):
    """Per signature of ``inputs`` (a VerifyInputs): the mixed additions of
    K3's ladder, one at every step whose table entry is finite after the
    first such step (that one lifts the entry), and whether it ends with
    the final check (the ladder's point finite)."""
    import numpy as np

    u1 = inputs.u1.cpu().numpy().astype(np.int64)
    u2 = inputs.u2.cpu().numpy().astype(np.int64)
    tinf = inputs.table_inf.cpu().numpy()
    shifts = np.arange(16)
    bits1 = ((u1[:, :, None] >> shifts) & 1).reshape(len(u1), 256)
    bits2 = ((u2[:, :, None] >> shifts) & 1).reshape(len(u2), 256)
    sel = bits1 + 2 * bits2
    finite = (sel != 0) & ~np.take_along_axis(tinf, sel, axis=1)
    n_finite = finite.sum(1)
    return np.maximum(n_finite - 1, 0), n_finite > 0


def k3_field_muls(inputs) -> int:
    """Field multiplications K3 does on ``inputs`` (a VerifyInputs): per
    signature 256 doublings, the mixed additions and the final check of
    ``_k3_ladder_counts``. Doublings inside an addition (P1 == P2) are not
    counted."""
    adds, checks = _k3_ladder_counts(inputs)
    return int((256 * FIELD_MULS_DOUBLE + FIELD_MULS_CHECK * checks
                + FIELD_MULS_ADD * adds).sum())


def k3_own_muls(inputs, group: int) -> int:
    """K3's own count of multiply instructions on ``inputs`` at ``group``
    lanes a signature: ``k3_field_muls`` x MULS_PER_FIELD_MUL, less what its
    squarings save (K3_MULS_PER_SQR). The bound (``k3_bound_ms``) keeps
    the reference ladder's count, so that every form of K3 is read against
    the same work; this count stands beside it."""
    adds, checks = _k3_ladder_counts(inputs)
    sqrs = int((256 * FIELD_SQRS_DOUBLE + FIELD_SQRS_CHECK * checks
                + FIELD_SQRS_ADD * adds).sum())
    return (k3_field_muls(inputs) * MULS_PER_FIELD_MUL
            - sqrs * (MULS_PER_FIELD_MUL - K3_MULS_PER_SQR[group]))


def k3_own_ms(inputs, group: int, clock_mhz: float) -> float:
    """``k3_own_muls`` at 64 a clock on each of 132 SMs at ``clock_mhz``:
    the operations time of ``k3_bound_ms`` for the multiplies that K3 at
    ``group`` lanes does (its bytes take far less)."""
    return (k3_own_muls(inputs, group)
            / (INT_MULS_PER_CLOCK_SM * H100_SMS * clock_mhz * 1e6) * 1e3)


def sm_clock_mhz() -> float:
    """The SM's maximum clock as nvidia-smi reports it (clocks.max.sm)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=30).stdout
    return float(out.splitlines()[0])


def k3_bound_ms(inputs, clock_mhz: float):
    """Least time for K3's work on an H100 SXM: its integer multiplies
    (``k3_field_muls`` x MULS_PER_FIELD_MUL) at 64 a clock on each of 132
    SMs at ``clock_mhz``, or its bytes (inputs read once, the verdicts
    written once, 775 a signature) at HBM rate, whichever is larger."""
    B = inputs.u1.shape[0]
    muls = k3_field_muls(inputs) * MULS_PER_FIELD_MUL
    t_ops = muls / (INT_MULS_PER_CLOCK_SM * H100_SMS * clock_mhz * 1e6) * 1e3
    t_bytes = B * (4 * 16 * 4 + 2 * 4 * 16 * 4 + 4 + 1 + 1) / PEAK_BYTES_PER_S
    t_bytes *= 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_against_plain(items, clock_mhz: float) -> dict:
    """K3 on ``items``' prepared inputs equal to its plain version on the
    card, bool for bool; K3 timed (CUDA events, median of 30), the plain
    version timed once (host clock), and K3's bound on these inputs."""
    import torch

    from babble_tpu_torch.ops import kernels, verify

    inputs = verify._prepare(items, torch.device("cuda"))
    k3 = verify.shamir(*inputs[1:])
    t0 = time.perf_counter()
    plain = verify.shamir_plain(*inputs[1:])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((k3.int() - plain.int()).abs().max())
    for group in kernels.ECDSA_GROUPS:  # every group size, not only B's
        got = kernels._ecdsa_shamir_at(group, *inputs[1:])
        err = max(err, int((got.int() - plain.int()).abs().max()))
    if err:
        raise AssertionError(f"K3 differs from its plain version at B "
                             f"{len(items)} (at its group size or another)")
    group = kernels.ecdsa_group(len(items))
    return {"B": len(items), "inputs": inputs, "k3": k3, "max_abs_err": err,
            "plain_ms": plain_ms, "group": group,
            "ms": time_on_device(lambda: kernels.ecdsa_shamir(*inputs[1:])),
            "bound": k3_bound_ms(inputs, clock_mhz),
            "own_ms": k3_own_ms(inputs, group, clock_mhz)}


def check_verdicts(items, clock_mhz: float) -> dict:
    """K3 (on its own and through ``batch_verify``), the plain ladder on the
    card, the native verifier and the Python oracle agree on every item's
    verdict; returns ``k3_against_plain``'s record with the verdicts'
    counts."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import verify

    rec = k3_against_plain(items, clock_mhz)
    k3 = (rec["k3"] & rec["inputs"].pre_ok).cpu().numpy()
    e2e = verify.batch_verify(items, torch.device("cuda"))
    native = np.array(native_verify_items(items))
    t0 = time.perf_counter()
    oracle = np.array(oracle_verdicts(items))
    rec["oracle_s"] = time.perf_counter() - t0
    for name, got in (("K3 and its plain version", k3), ("native", native),
                      ("batch_verify", e2e)):
        if not np.array_equal(got, oracle):
            bad = np.flatnonzero(got != oracle)
            raise AssertionError(f"verdicts of {name} differ from the oracle "
                                 f"at {len(bad)} of {len(items)}, first "
                                 f"{bad[:5].tolist()}")
    rec.update(valid=int(oracle.sum()), invalid=int((~oracle).sum()))
    return rec


def verify_times(items, clock_mhz: float) -> list:
    """At each B of VERIFY_TIMED_B (the first B of ``items``): K3's device ms
    (CUDA events, median of 30) at the group size it takes and at the
    other, its bound and, beside it, the operations time of K3's own
    multiplies (``k3_own_ms``), host ``_prepare`` µs a signature, end-to-end
    ``batch_verify`` µs a signature and the native verifier's µs a
    signature from the same items (host clock, median of 3 after one
    warm-up run)."""
    import torch

    from babble_tpu_torch.ops import kernels, verify

    dev = torch.device("cuda")
    rows = []
    for B in VERIFY_TIMED_B:
        part = items[:B]
        inputs = verify._prepare(part, dev)
        ms = time_on_device(lambda: kernels.ecdsa_shamir(*inputs[1:]))
        by_group = {g: time_on_device(
            lambda: kernels._ecdsa_shamir_at(g, *inputs[1:]))
            for g in kernels.ECDSA_GROUPS}
        bound_ms, bound_by = k3_bound_ms(inputs, clock_mhz)
        group = kernels.ecdsa_group(B)
        own_ms = k3_own_ms(inputs, group, clock_mhz)

        row = {"B": B, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "group": group, "own_ms": own_ms, "ms_by_group": by_group,
               "prepare_us": _wall_ms(lambda: verify._prepare(part, dev), 3)
               / B * 1e3,
               "batch_verify_us": _wall_ms(
                   lambda: verify.batch_verify(part, dev), 3) / B * 1e3,
               "native_us": _wall_ms(lambda: native_verify_items(part), 3)
               / B * 1e3}
        rows.append(row)
        log(f"[verify] B {B}: K3 {ms:.4f} ms at G {row['group']} ("
            + ", ".join(f"G {g} {t:.4f}" for g, t in by_group.items())
            + f" ms), bound {bound_ms:.4g} ms "
            f"({bound_by}, {bound_ms / ms:.2%} of it), K3's own multiplies "
            f"at G {group} {own_ms:.4g} ms ({own_ms / ms:.2%} of it); host "
            "_prepare "
            f"{row['prepare_us']:.2f} µs/sig; batch_verify "
            f"{row['batch_verify_us']:.2f} µs/sig; native "
            f"{row['native_us']:.2f} µs/sig")
    return rows


def verify_cluster_arm(label: str, device_verify: bool) -> dict:
    """VERIFY_CLUSTER_NODES port Nodes (``--accelerator``, the offload at its
    defaults) over loopback TCP under closed-loop load until every node has
    committed block VERIFY_BLOCK, with ``BABBLE_DEVICE_VERIFY=1`` or
    without it. Checks identical blocks, node 0's chain against a host
    replay of its events, no single re-checks and no offload fallback;
    with device verification, K3 launches (counted from 0 once the nodes
    are up) equal the cores' batch verifies, and without it K3 never
    launches. Each core's batch verification is timed per call."""
    import os
    import threading

    import torch

    from babble_tpu_torch.crypto.batch import collect_signature_items
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.ops import kernels

    saved = os.environ.get("BABBLE_DEVICE_VERIFY")
    if device_verify:
        os.environ["BABBLE_DEVICE_VERIFY"] = "1"
    else:
        os.environ.pop("BABBLE_DEVICE_VERIFY", None)
    nodes, loader = [], None
    stop = threading.Event()
    lock = threading.Lock()
    calls = []  # (seconds, signatures) per batch verification
    try:
        kernels.reset_launch_counts()
        nodes, proxies, states = tcp_cluster(VERIFY_CLUSTER_NODES, True)
        warmups = kernels.launch_counts()["ecdsa_shamir"]
        for node in nodes:
            def timed(decoded, orig=node.core._batch_prevalidate):
                n_items = len(collect_signature_items(decoded)[0])
                t0 = time.perf_counter()
                orig(decoded)
                with lock:
                    calls.append((time.perf_counter() - t0, n_items))
            node.core._batch_prevalidate = timed
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        for node in nodes:
            node.run_async()
        loader = threading.Thread(
            target=Pump(proxies, states).until,
            args=(t0 + VERIFY_CLUSTER_S, stop), daemon=True)
        loader.start()
        while (min(node.get_last_block_index() for node in nodes)
               < VERIFY_BLOCK and time.monotonic() - t0 < VERIFY_CLUSTER_S):
            time.sleep(0.1)
        run_s = time.monotonic() - t0
    finally:
        stop.set()
        # all at once: each node waits up to 2 s for its gossip routines
        stoppers = [threading.Thread(target=node.shutdown) for node in nodes]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=120)
        if loader is not None:
            loader.join(timeout=10)
        for node in nodes:
            with node.core_lock:  # a sync still in flight finishes first
                pass
        if saved is None:
            os.environ.pop("BABBLE_DEVICE_VERIFY", None)
        else:
            os.environ["BABBLE_DEVICE_VERIFY"] = saved
    deadline = time.monotonic() + 60
    while not SweepBatcher.instance().idle():
        if time.monotonic() > deadline:
            raise AssertionError(f"[verify/{label}] the sweep batcher never "
                                 "went idle")
        time.sleep(0.05)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["ecdsa_shamir"]
    common = check_cluster_blocks(f"verify/{label}", nodes)
    if common < VERIFY_BLOCK:
        raise AssertionError(f"[verify/{label}] common block {common} < "
                             f"{VERIFY_BLOCK} after {run_s:.1f} s")
    cores = [node.core for node in nodes]
    rec = {
        "arm": label, "run_s": run_s, "common_block": common,
        "warmup_launches": warmups, "launches": launches,
        "batch_verifies": sum(c.ingest_batch_verifies for c in cores),
        "fallback_singles": sum(c.ingest_fallback_singles for c in cores),
        "fallbacks": sum(c.hg.accel.fallbacks for c in cores),
        "calls": len(calls),
        "median_ms": 1e3 * statistics.median(t for t, _ in calls),
        "signatures": Counter(n for _, n in calls),
    }
    if rec["fallback_singles"] or rec["fallbacks"]:
        raise AssertionError(f"[verify/{label}] single re-checks "
                             f"{rec['fallback_singles']}, offload fallbacks "
                             f"{rec['fallbacks']}")
    if device_verify:
        if warmups != VERIFY_CLUSTER_NODES:
            raise AssertionError(f"[verify/{label}] {warmups} warm-up "
                                 "launches, not one a node")
        if not 0 < launches == rec["batch_verifies"]:
            raise AssertionError(f"[verify/{label}] K3 launches {launches} "
                                 f"!= batch verifies {rec['batch_verifies']}"
                                 " (or none)")
    elif launches or warmups:
        raise AssertionError(f"[verify/{label}] the host arm launched K3")
    rec["replayed_events"] = replay_own_events(f"verify/{label}", nodes[0])
    log(f"[verify/{label}] {VERIFY_CLUSTER_NODES} nodes to block {common} in "
        f"{run_s:.1f} s: batch verifications {rec['calls']}, median "
        f"{rec['median_ms']:.3f} ms a call; K3 launches {launches} (warm-up "
        f"{warmups}), batch verifies {rec['batch_verifies']}; signatures a "
        f"call {dict(sorted(rec['signatures'].items()))}; node 0 = host "
        f"replay of {rec['replayed_events']} events")
    return rec


def k3_row(label: str, rec: dict, launches: int,
           launches_on_path: int) -> dict:
    """K3's kernels-line row from a ``k3_against_plain`` record."""
    return {
        "name": f"ecdsa_shamir[{label}, B {rec['B']}]",
        "route": "cuda",
        "source": "babble_tpu_torch/csrc/ecdsa_verify.cu",
        "replaces": "babble_tpu/ops/verify.py:127",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound"][0],
        "bound_by": rec["bound"][1],
        "library_ms": None,
        "shape": [rec["B"]],
        "group": rec["group"],
        "own_muls_ms": rec["own_ms"],
        "launches_on_path": launches_on_path,
    }


def device_verification(seed: int) -> list:
    """Phase 10; returns K3's rows of the kernels line."""
    from babble_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    n_pairs = check_field_ops(seed)
    log(f"[verify] cooperative field layer on the card = Python ints at G "
        f"{', '.join(map(str, kernels.ECDSA_GROUPS))}: mul, sqr, add, sub on "
        f"{n_pairs} pairs (add and sub also on non-canonical operands) "
        f"({time.perf_counter() - t0:.1f} s); K3 takes G "
        f"{dict((B, kernels.ecdsa_group(B)) for B in VERIFY_TIMED_B)} "
        f"lanes a signature by B, {K3_THREADS} threads a block (one warp or "
        "a few where B G is smaller)")
    clock = sm_clock_mhz()

    t0 = time.perf_counter()
    items = (signature_batch(VERIFY_N - 3, VERIFY_KEYS, seed)
             + ladder_edge_items())
    log(f"[verify] {len(items)} signatures from {VERIFY_KEYS} keys in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    ver = check_verdicts(items, clock)
    log(f"[verify] B {ver['B']}: K3 = plain on the card = native = Python "
        f"oracle = batch_verify on every verdict ({ver['valid']} valid, "
        f"{ver['invalid']} invalid; oracle {ver['oracle_s']:.1f} s); K3 "
        f"{ver['ms']:.4f} ms, plain {ver['plain_ms']:.1f} ms")
    at64 = k3_against_plain(items[:64], clock)
    log(f"[verify] B 64: K3 = plain on the card; K3 {at64['ms']:.4f} ms, "
        f"shamir_plain {at64['plain_ms']:.1f} ms (one run)")

    rows = verify_times(items * (VERIFY_TIMED_B[-1] // len(items)), clock)
    wins = [r["B"] for r in rows if r["batch_verify_us"] < r["native_us"]]
    log(f"[verify] batch_verify first beats the native verifier at B "
        f"{wins[0] if wins else 'none'} (SM clock {clock:.0f} MHz)")

    # the node path: counts from 0 once the nodes are up
    host = verify_cluster_arm("host verifier", False)
    card = verify_cluster_arm("BABBLE_DEVICE_VERIFY=1", True)
    log(f"[verify] median batch verification a sync: card "
        f"{card['median_ms']:.3f} ms, host {host['median_ms']:.3f} ms")
    by_b = card["signatures"]
    path_b = max(by_b, key=by_b.get)
    at_path = k3_against_plain(items[:path_b], clock)
    log(f"[verify] B {path_b}, the node path's most frequent: K3 = plain on "
        f"the card; K3 {at_path['ms']:.4f} ms, plain "
        f"{at_path['plain_ms']:.1f} ms")
    return [k3_row(label, rec, by_b.get(rec["B"], 0), card["launches"])
            for label, rec in (("node path, most frequent", at_path),
                               ("timed", at64), ("verdicts", ver))]


# Run in a tree of the repo (this one or an earlier commit's) by
# ``kernel_ab``: phase 2's times there, through functions every version of
# this script has.
_AB_CHILD = """
import json, sys, torch
import chip_smoke as c
from babble_tpu_torch.ops import kernels
kernels.build()
k1, k2, k3_b = json.loads(sys.argv[1])
k3 = None
if hasattr(kernels, "ecdsa_shamir"):
    import hashlib
    from babble_tpu_torch.crypto import secp256k1 as ref
    from babble_tpu_torch.ops import verify
    items = []
    for i in range(64):
        h = hashlib.sha256(b"ab %d" % i).digest()
        items.append((ref.pubkey_from_scalar(i + 2), h,
                      *ref.sign(i + 2, h)))
    k3 = {}
    for B in k3_b:
        inp = verify._prepare((items * (B // 64 + 1))[:B], "cuda")
        k3[B] = c.time_on_device(lambda: kernels.ecdsa_shamir(*inp[1:]))
print("AB " + json.dumps({
    "floor_ms": c.time_on_device(lambda: torch.cuda._sleep(0)),
    "k1": [c.check_k1(tuple(s), seed=1 + i)["ms"] for i, s in enumerate(k1)],
    "k2": [c.check_k2(tuple(s), seed=51 + i)["ms"] for i, s in enumerate(k2)],
    "k3": k3,
}))
"""


def kernel_ab(trees) -> None:
    """Phase 2's kernel times, and K3's at every B of VERIFY_TIMED_B, in
    each tree of ``trees`` (checkouts of this repo, each with its own
    build), one fresh process per tree, in the
    order given (old, new, new, old compares two commits on one card);
    prints one line per tree and shape, and a table of the per-tree
    medians."""
    import os
    import subprocess

    shapes = json.dumps([K1_SHAPES, K2_SHAPES, VERIFY_TIMED_B])
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _AB_CHILD, shapes],
                              cwd=tree, capture_output=True, text=True,
                              timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            raise AssertionError(f"A/B run in {tree} exit {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}")
        runs.append((os.path.abspath(tree), json.loads(line[0][3:])))
        log(f"[ab] {tree}: {line[0][3:]}")
    by_tree = {}
    for tree, rec in runs:
        by_tree.setdefault(tree, []).append(rec)
    names = ([("K1", s) for s in K1_SHAPES] + [("K2", s) for s in K2_SHAPES])
    for tree, recs in by_tree.items():
        floor = statistics.median(r["floor_ms"] for r in recs)
        log(f"[ab] {tree}: {len(recs)} runs, launch floor {floor:.5f} ms")
        for k, (kind, shape) in enumerate(names):
            key, idx = ("k1", k) if kind == "K1" else ("k2", k - len(K1_SHAPES))
            ms = [r[key][idx] for r in recs]
            log(f"[ab] {tree} {kind} {shape}: median {statistics.median(ms):.5f}"
                f" ms of {[round(m, 5) for m in ms]}")
    if all(rec.get("k3") for _, rec in runs):
        for tree, recs in by_tree.items():
            for B in map(str, VERIFY_TIMED_B):
                ms = [r["k3"][B] for r in recs]
                log(f"[ab] {tree} K3 B {B}: median "
                    f"{statistics.median(ms):.5f} ms of "
                    f"{[round(m, 5) for m in ms]}")
    else:
        log("[ab] K3 not timed: a tree has no K3")


def nodes_ab(trees) -> None:
    """Phase 8 (``node_cluster_child``) in each tree of ``trees``
    (checkouts of this repo, each with its own build), one fresh process
    per tree, in the order given (old, new, new, old compares two commits
    on one card); prints each arm's committed tx/s, submit-to-commit
    p50/p95, seconds to settle and, where the tree records it, when each
    block committed on its first and last node."""
    import os
    import subprocess

    for tree in trees:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.node_cluster_child()"],
            cwd=tree, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        sys.stdout.write("".join(f"[nodes-ab] {tree}: {ln}\n" for ln in lines
                                 if not ln.startswith("NODES ")))
        line = [x for x in lines if x.startswith("NODES ")]
        if proc.returncode != 0 or not line:
            raise AssertionError(f"node cluster in {tree} exit "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        wall = time.perf_counter() - t0
        for rec in json.loads(line[0][6:]):
            keep = {k: rec.get(k) for k in (
                "tx_per_s", "p50_ms", "p95_ms", "latency_samples",
                "settle_s", "common_block", "sweeps", "contended",
                "rebuilds", "block_commits", "window_tx_by_node",
                "per_node")
                if k in rec}
            log(f"[nodes-ab] {os.path.abspath(tree)} {rec['arm']}: "
                f"{json.dumps(keep)}")
        log(f"[nodes-ab] {os.path.abspath(tree)}: {wall:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="only time phase 2's kernels and K3 in each of "
                    "these checkouts in turn (e.g. old new new old) and "
                    "exit")
    ap.add_argument("--nodes-ab", nargs="+", metavar="TREE",
                    help="only run phase 8's node cluster in each of these "
                    "checkouts in turn (e.g. old new new old) and exit")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from babble_tpu_torch import native_crypto
    from babble_tpu_torch.ops import dag, kernels
    from babble_tpu_torch.ops.device import describe

    # Phase 1: device and build
    dev = describe("cuda")
    log(f"device: {dev['kind']} x{dev['count']}; nvidia-smi: "
        f"{dev['name_power']}")
    if args.ab:
        kernel_ab(args.ab)
        return 0
    if args.nodes_ab:
        nodes_ab(args.nodes_ab)
        return 0
    t0 = time.perf_counter()
    so = kernels.build()
    log(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, {so}\n"
        f"{kernels.ptxas_report}")
    t0 = time.perf_counter()
    path = native_crypto.host_crypto_path()
    log(f"host crypto path: {path} (resolved in "
        f"{time.perf_counter() - t0:.2f} s)")

    # Phase 2: kernels against their plain versions on the card
    floor_ms = launch_floor_ms()
    log(f"launch floor: {floor_ms:.5f} ms (an empty kernel, timed as the "
        "kernels are)")
    for i, shape in enumerate(K1_SHAPES):
        row = check_k1(shape, seed=args.seed + i)
        log(f"K1 {shape}: equal to plain on random and edge values; kernel "
            f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, bound "
            f"{row['bound_ms']:.3g} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.1%} of bound, tile "
            f"{kernels.member_ss_tile(shape[0], shape[2])}")
    for i, shape in enumerate(K1_BATCH_SHAPES):
        row = check_k1(shape, seed=args.seed + 30 + i)
        B, W, P, S = shape
        log(f"K1 (B, W, P, S) {shape}: one launch, equal to plain on random "
            f"and edge values; kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.3g} ms "
            f"({row['bound_by']}, {B} x one window's), "
            f"{row['bound_ms'] / row['ms']:.1%} of bound, tile "
            f"{kernels.member_ss_tile(W, S, B)}")
    k2_checked = {}
    for i, shape in enumerate(K2_SHAPES):
        row = check_k2(shape, seed=args.seed + 50 + i)
        k2_checked[shape] = row
        log(f"K2 (B, E, P) {shape}: equal to plain on random and edge "
            f"values; kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} "
            f"ms, bound {row['bound_ms']:.3g} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.1%} of bound, tile "
            f"{kernels.strongly_see_tile(shape[1], shape[0])}")

    # Phase 3: 16 validators
    t0 = time.perf_counter()
    events, _keys, peers = gossip_stream(16, EVENTS_16, args.seed)
    log(f"[16] stream: {len(events)} signed events in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    res16, oracle16 = run_main_path("16", events, peers,
                                    no_resident_arm=True)
    profile_sweep("16", oracle16)
    rows = [k1_row("16 validators", k1_shapes(res16),
                   {r["arm"]: r["launches"] for r in res16}, "defaults",
                   seed=args.seed + 100)]

    # Phase 4: 64 validators, one leaving from CHANGE_ROUND on
    t0 = time.perf_counter()
    events, _keys, peers = gossip_stream(64, EVENTS_64, args.seed + 1)
    smaller = peers.with_removed_peer(peers.peers[-1])
    log(f"[64] stream: {len(events)} signed events in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    res64, oracle64 = run_main_path(
        "64", events, peers, peer_sets=[(CHANGE_ROUND, smaller)], min_slots=2,
        min_blocks_after=(CHANGE_ROUND, MIN_BLOCKS_AFTER_CHANGE),
    )
    profile_sweep("64", oracle64)
    rows.append(k1_row("64 validators", k1_shapes(res64),
                       {r["arm"]: r["launches"] for r in res64}, "defaults",
                       seed=args.seed + 101))
    del oracle64

    # Phases 5 and 6: the DAG pipeline, K2's path; counts from 0 to here
    t0 = time.perf_counter()
    events, _keys, peers = gossip_stream(64, EVENTS_DAG_64, args.seed + 2)
    dag64, dag64_s = replay(events, peers)
    log(f"[dag 64] stream: {len(events)} signed events, oracle replay "
        f"{dag64_s:.2f} s ({time.perf_counter() - t0:.2f} s with the stream; "
        f"set-up)")
    k2_at = Counter()  # K2 launches on the path, by (B, E, P)
    kernels.reset_launch_counts()
    snap16 = dag_against_oracle("16", oracle16, k2_at)
    snap64 = dag_against_oracle("64", dag64, k2_at)
    oracle_launches = kernels.launch_counts()
    syn, batch_arrays, batch_sm = dag_against_cpu(k2_at)
    launches = kernels.launch_counts()
    by_phase = {"vs_oracle": oracle_launches["strongly_see"],
                "vs_cpu": launches["strongly_see"]
                - oracle_launches["strongly_see"]}
    if by_phase != {"vs_oracle": 2, "vs_cpu": 2}:
        raise AssertionError(f"K2 launches {by_phase} != pipeline runs on "
                             "the card (2 and 2)")
    if dict(k2_at) != {shape: 1 for shape in K2_ROWS}:
        raise AssertionError(f"K2 launches by shape {dict(k2_at)}: want one "
                             f"at each of {K2_ROWS}")
    if launches["member_ss_counts"] != 0:
        raise AssertionError("the DAG pipeline launched K1")
    log(f"[dag] K2 launches = pipeline runs on the card: {by_phase}; by "
        f"(B, E, P): {dict(k2_at)}")

    # Phase 7: the pipeline's times
    syn64 = dag.synthetic_snapshot(64, 4096)
    dag_times([("synthetic", syn, 10), ("16-validator stream", snap16, 5),
               ("64-validator stream", snap64, 5), ("synthetic", syn64, 5)],
              (batch_arrays, batch_sm))
    stage_breakdown(syn64)
    profile_dag_fresh()
    rows += [k2_row(k2_checked[shape], k2_at[shape], by_phase)
             for shape in K2_ROWS]

    # Phase 8: 16 nodes on the card in one (fresh) process; counts from 0
    # to the end of each arm, in that process
    t0 = time.perf_counter()
    arms = node_cluster_fresh()
    log(f"[nodes] phase 8: {time.perf_counter() - t0:.1f} s")
    card = {r["arm"]: r for r in arms if "sweeps" in r}
    launches = {arm: r["launches"] for arm, r in card.items()}
    waves = Counter()
    for r in card.values():
        if r["batcher"]:
            waves += Counter({k: n for k, n in r["sweep_shapes"].items()
                              if k[0] >= 2})
    rows.append(k1_row(f"{NODES}-node cluster, batched waves", waves,
                       launches, "defaults", seed=args.seed + 102))
    per_node = NO_BATCHER_ARM
    rows.append(k1_row(f"{NODES}-node cluster, per node",
                       k1_shapes([card[per_node]]), launches, per_node,
                       seed=args.seed + 103))

    # Phase 9: the command line, four node processes on the card
    t0 = time.perf_counter()
    cli_cluster()
    log(f"[cli] phase 9: {time.perf_counter() - t0:.1f} s")

    # Phase 10: device signature verification, K3; counts from 0 for the
    # node path once its nodes are up
    t0 = time.perf_counter()
    rows += device_verification(args.seed + 10)
    log(f"[verify] phase 10: {time.perf_counter() - t0:.1f} s")

    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(dev["name_power"] or "nvidia-smi: not available")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
