#!/usr/bin/env python3
"""Chip smoke for babble_tpu_torch, the PyTorch/CUDA port: the quickest proof
that the port builds and runs its consensus paths on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and g++;
imports only babble_tpu_torch, torch, numpy and the standard library.
Phases, each of which fails the run (non-zero exit) on any error:

1. device and build: the card, its power limit, the kernel library (K1 and
   K2, built from csrc/) and native crypto builds, the host-crypto path;
2. the launch floor (an empty kernel's device time), then every kernel
   against its plain PyTorch version on the card, bit for bit, on random
   coordinates and on coordinates at the edges of int32 (per-peer bases up
   to 2^31 - 2^12, INT32_MIN and INT32_MAX, ties, both sentinels), with its
   time, its plain version's time, its bound and its share of the bound:
   K1 at the live sweep's shapes, K2 at the DAG pipeline's, single and
   batched;
3. the live offload at 16 validators: a seeded signed gossip stream
   replayed through the port's Hashgraph in syncs of 64 events with a flush
   after each — host oracle, TensorConsensus at its defaults, and with
   min_window=0 — committing byte-identical blocks, with no fallback and
   one K1 launch per device sweep;
4. the same at 64 validators, one of which leaves from round 3 on, so
   sweeps carry two peer-set slots through K1; the stream is long enough
   that several blocks commit after the change;
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
   at (64, 4096), and a profile of one run there (in a fresh process).

For each live path, K1 is also held against its plain version, and timed,
at the shape that path's sweeps gave it most often. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab dist/old dist/new dist/new dist/old

runs phase 2's timings only, in each given checkout of the repo in turn
(each builds its own kernels in a fresh process), and exits: two commits
compared on one card.
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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the 32-bit rate of
# the CUDA cores outside the tensor cores; K1's compare-adds run there.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# (W, P, S): the smallest witness bucket, a ragged shape, and the live
# buckets of 16-validator (P = 16) and 64-validator (P = 64, S = 1 or 2)
# windows.
K1_SHAPES = [(16, 4, 1), (37, 13, 3), (128, 16, 1), (256, 16, 1),
             (256, 64, 1), (256, 64, 2), (512, 64, 2), (1024, 64, 2)]
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


def k1_inputs(W: int, P: int, S: int, seed: int):
    """Random coordinates with both sentinels mixed in."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    la = rng.randint(-1, 50, size=(W, P)).astype(np.int32)
    fd = rng.randint(0, 50, size=(W, P)).astype(np.int32)
    fd[rng.rand(W, P) < 0.3] = np.int32(2**31 - 1)
    la[rng.rand(W, P) < 0.1] = -1
    member = rng.rand(S, P) < 0.7
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


def k1_edge_inputs(W: int, P: int, S: int, seed: int):
    """numpy la, fd and member for K1 on edge-value coordinates, la below
    INT32_MAX."""
    import numpy as np

    la, fd = edge_coordinates((W, P), seed, la_below_max=True)
    member = np.random.RandomState(seed + 1).rand(S, P) < 0.7
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
    """K1 equal to its plain version on edge-value coordinates."""
    import torch

    from babble_tpu_torch.ops import kernels

    la, fd, member = (torch.from_numpy(a).cuda()
                      for a in k1_edge_inputs(*shape, seed))
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
    coordinates, and timed on the random ones."""
    import torch

    from babble_tpu_torch.ops import kernels

    W, P, S = shape
    la, fd, member = k1_inputs(W, P, S, seed)
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
    return {"shape": [W, P, S], "max_abs_err": err, "ms": ms,
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
    drain any in-flight sweep. Returns (hashgraph, wall seconds)."""
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
        for _ in range(100):
            if not accel.busy():
                break
            h.flush_consensus()
        if accel.busy():
            raise AssertionError("pipelined sweep never drained")
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
                  min_blocks_after=(-1, 1)):
    """Oracle, accel at defaults, accel with min_window=0: identical
    consensus, no fallback, one K1 launch per device sweep. The oracle must
    commit at least ``min_blocks_after[1]`` blocks received in rounds after
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
    for arm, kw in (("defaults", {}), ("min_window=0", {"min_window": 0})):
        accel = TensorConsensus(device="cuda", **kw)
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


def k1_row(label, res, seed: int) -> dict:
    """K1 held against its plain version, and timed, at the (W, P, S) this
    path's device sweeps gave it most often; its launches are those of the
    path's run at the accelerator's defaults, counted from 0 for that run."""
    shapes = Counter()
    for r in res:
        for (W, _E, P, S, _R), n in r["buckets"].items():
            shapes[(W, P, S)] += n
    shape = max(shapes, key=shapes.get)
    row = check_k1(shape, seed)
    launches = {r["arm"]: r["launches"] for r in res}
    log(f"K1 at the {label} path's most frequent shape {shape}: equal to "
        f"plain; kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
        f"bound {row['bound_ms']:.3g} ms ({row['bound_by']}); launches per "
        f"arm {launches}; shapes over both arms "
        f"{json.dumps({'x'.join(map(str, k)): n for k, n in shapes.items()})}")
    return {
        "name": f"member_ss_counts[{label}]",
        "route": "cuda",
        "source": "babble_tpu_torch/csrc/member_ss.cu",
        "replaces": "babble_tpu/ops/pallas_kernels.py:104",
        "launches": launches["defaults"],
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


# Run in a tree of the repo (this one or an earlier commit's) by
# ``kernel_ab``: phase 2's times there, through functions every version of
# this script has.
_AB_CHILD = """
import json, sys, torch
import chip_smoke as c
from babble_tpu_torch.ops import kernels
kernels.build()
k1, k2 = json.loads(sys.argv[1])
print("AB " + json.dumps({
    "floor_ms": c.time_on_device(lambda: torch.cuda._sleep(0)),
    "k1": [c.check_k1(tuple(s), seed=1 + i)["ms"] for i, s in enumerate(k1)],
    "k2": [c.check_k2(tuple(s), seed=51 + i)["ms"] for i, s in enumerate(k2)],
}))
"""


def kernel_ab(trees) -> None:
    """Phase 2's kernel times in each tree of ``trees`` (checkouts of this
    repo, each with its own build), one fresh process per tree, in the
    order given (old, new, new, old compares two commits on one card);
    prints one line per tree and shape, and a table of the per-tree
    medians."""
    import os
    import subprocess

    shapes = json.dumps([K1_SHAPES, K2_SHAPES])
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="only time phase 2's kernels in each of these "
                    "checkouts in turn (e.g. old new new old) and exit")
    args = ap.parse_args(argv)

    import torch

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
    res16, oracle16 = run_main_path("16", events, peers)
    profile_sweep("16", oracle16)
    rows = [k1_row("16 validators", res16, seed=args.seed + 100)]

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
    rows.append(k1_row("64 validators", res64, seed=args.seed + 101))
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

    log(dev["name_power"] or "nvidia-smi: not available")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
