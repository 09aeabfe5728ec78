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
   stream is long enough that many blocks commit after the change, and its
   host oracle replays in a child process from the start of the run, beside
   phases 1-3 and 5-7, so phase 4 runs after phase 7;
5. the all-at-once DAG pipeline (``ops.dag.run_pipeline``) on the card over
   ``snapshot_from_hashgraph`` of the 16-validator oracle and of a new
   64-validator stream of 4096 signed events (oracle replay only, with
   its snapshot, in a child process from the start of the run), equal to
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
   their submit time, 8 s of warm-up, a 12 s window, then until every
   node has committed block NODES_SETTLE_BLOCK) in four arms —
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
   kernel records; while they run, ``obs.healthview`` over their four
   services must find every node up, with its lag and round and block
   rates, and give a commit-p50 SLO verdict (its summary line is printed),
   and ``obs.traceview`` over their ``/traces`` must merge a transaction
   with hops on two nodes or more; then the client tier in front of them
   (each node with ``--client-listen``): ``python -m
   babble_tpu_torch.client.gateway --processes`` with 4 shard processes,
   forwarding to two nodes and tailing a third's hub, and a
   ``SubscriberSwarm`` of 2000 subscribers (the soft open-files limit
   raised to the hard one, and the count cut to fit if it must be) over
   the four nodes' hubs and the gateway's, 5% of them stalled, under ~1
   KiB transactions through the gateway and straight at the nodes: every
   healthy subscriber's blocks in order with no gap, every stalled one
   shed, every sampled transaction's ``GET /proof`` at the gateway
   verified offline against the validator set alone (a tampered copy
   rejected), a ``ReadReplica`` from a node's checkpoint serving a proof
   itself, and every node still sweeping on the card with no fallback;
   it prints the subscribers attached, healthy and shed, gaps, the proofs
   verified, push latency p50/p95, proof latency p50 and the gateway's
   final ``stats()``;
10. device signature verification (K3, ``ops/verify.py``): the cooperative
   field layer on the card (``kernels.field_ops``) at every group size
   equal to Python integers at the edges, on non-canonical add and sub
   operands and on 4096 random pairs; 4096 signatures from 64 keys, one in
   eight corrupted (CORRUPTIONS) and three that take the ladder's rare
   cases, on whose verdicts K3 (at its group size and at every other), the
   plain ladder on the card, the native verifier, the Python oracle and
   ``batch_verify`` agree (the plain ladder's runs and the oracle's, host
   bound, take place beside phase 8's cluster); at B = 1 to 16384, K3's
   device ms at its group
   size and at the other beside its bound and K3's own count of multiplies
   (``k3_own_ms``), host ``_prepare`` and end-to-end
   ``batch_verify`` µs a signature beside the native verifier's, and the
   first B at which ``batch_verify`` beats it (or "none"); then four port
   Nodes over loopback TCP with ``--accelerator`` to block 3, with the host
   verifier and with ``BABBLE_DEVICE_VERIFY=1``: identical blocks, node 0's
   chain equal to a host replay, no single re-check, no offload fallback,
   and with device verification one K3 launch per batch verification
   (counted from 0 once the nodes are up), with the median time of a batch
   verification in each arm; then the bench ledger (``obs.ledger``): its
   host fingerprint must name the card, torch and CUDA and no jax, a record
   of phase 8's tx/s, p50/p95 and seconds to block 0 and phase 10's K3 ms
   must read back from
   a history in a temporary directory, and ``obs.perfgate`` must pass five
   copies of it and fail an injected regression;
11. the mesh (``babble_tpu_torch/parallel/``) on virtual shards: mesh
   entries that all name the one card, so that every exchange between
   shards and every per-shard kernel launch runs on it (no NVLink is
   measured). Rectangular K1 (V voter rows against W candidates, the
   sharded sweep's shard shapes at N = 4, and a batch) and K2's block form
   at the tile its C entry picks (K2_BLOCK_SHAPES: sharded_strongly_see
   shards and ring steps of (4096, 64) at 2, 4 and 8 shards, a shard of
   (4096, 16), and the sharded pipeline's batched shards) against their
   plain versions on random and edge coordinates, with times, bounds and
   shares; phases 3 and 4's
   streams through TensorConsensus(mesh=...) at N = 1 and 4 (resident, no
   batcher, min_window 0; the 16-validator one in syncs of 32, beside a
   single-device arm, so that the delta path runs), equal to those phases'
   oracles, with no mesh fallback, delta sweeps, K1 launches = N x sweeps,
   the pad rows and the dispatch and device ms per sweep against the
   single device; the batcher's coprocessor lane (two validators on one
   4-shard mesh, one wave serving both); and the collectives on 2, 4 and 8
   shards and sharded_batched_pipeline at (dp 2, sp 2) and (dp 1, sp 4)
   equal to their single-device counterparts, with K2's block-form
   launches counted by shape;
12. the mobile binding, in a fresh process: two ``mobile.MobileNode``s with
   ``accelerator=True`` over loopback TCP (OS-assigned ports, min_window
   0, no batcher) to block 3, with identical block JSON at every index
   both hosts received, node 0's chain equal to a host replay of its own
   events through the same app, device sweeps, no fallback, and K1's
   launches equal to the nodes' device sweeps;
13. static analysis and the lock graph on the card: ``python -m
   babble_tpu_torch.analysis``, its ``--self-proof`` and ``python -m
   babble_tpu_torch.obs.lint docs/observability.md`` from the checkout
   (this machine has no JAX), each exiting 0; then, in a fresh process
   with ``BABBLE_LOCKCHECK=1``, four port Nodes over loopback TCP with the
   offload on the card and the sweep batcher on, to block 3: identical
   blocks, node 0's chain equal to a host replay, no fallback, K1's
   launches equal to the batcher's sweeps, 0 lock-order inversions on
   every node, ``batcher`` among the locks observed, and every observed
   order edge in the static lock pass's set or named in
   LOCK_EDGES_UNSEEN with its reason;
14. membership churn (BASELINE.json config 4), in a fresh process: (a) a
   seeded stream of 64 validators in which two join and two leave at
   consecutive rounds (peer-sets registered by round, so that windows
   carry up to five slots) and the three golden dynamic-membership
   fixtures (r2dyn, usurper, monologue) through TensorConsensus on the
   card in four arms — resident sync, pipelined, the sweep batcher, a
   mesh of four virtual shards — each equal to a host oracle (the
   stream's in a child process), with K1's launches equal to the device
   sweeps; (b) 16 port Nodes over loopback TCP at phase 8's settings, in a
   process of their own started before phase 11 and running beside phases
   11-13 and (a), with the offload at its card defaults and every window on
   the card, under
   closed-loop load, through a join, a polite leave, a join, a leave and a
   join by fast-sync, one requested every 5 s once the last committed:
   identical blocks on every live node (the fast-synced node's from its
   anchor), one peer-set, node 0 equal to a host replay, no fallback, K1's
   launches equal to the batcher's sweeps, a sweep with two peer-set slots
   or more, and the fast-synced node's sweeps grown after its reset; each
   change's seconds from request to commit; (c) ``invalidate()`` while a
   pipelined sweep is still running on the card (its CUDA event not done;
   windows enlarged until one is, else its copy-out queued behind a sleep
   kernel on the offload's stream): dropped, its slot free, consensus
   equal to the oracle; (d) injected launch failures open the breaker, an
   open breaker launches no K1, and a probe after the cooldown closes it;
   last, once (b) has ended, K1 against its plain version, with time,
   bound and share, at every shape of (a) and (b) with two slots or more;
15. the Byzantine fault model (BASELINE.json config 5), two arms at
   once, each in a fresh process, started once phase 14's live cluster
   has ended and run beside its replays: 16 validators over loopback TCP, 11 of
   them port Nodes with the offload at its card defaults and 5
   ``adversary.ByzantineNode``s (three ``wrong_key`` flooders, one
   ``oversize`` pusher, one ``equivocate``, whose fork the harness reveals
   once every honest node holds its first branch), under phase 8's
   closed-loop load until every honest node has committed
   BYZ_TARGET_BLOCK and the attack is caught: (b) with
   ``BABBLE_DEVICE_VERIFY=1``, so K3 verifies every sync chunk; (c) with
   the native host verifier. Each arm, K3 and K1 counted from 0 once its
   nodes are up: identical blocks, node 0 equal to a host replay, no
   offload fallback, K3 launches equal to the honest cores' batch
   verifications with an item (0 in (c)), the single re-checks equal to
   the items K3 rejected and both branches of the fork among K3's items
   (in (b)), no forged event in an honest store, K1 launches equal to
   the sweep batcher's sweeps, every adversary quarantined by every
   honest node that rejected an offence of it that alone crosses the
   sentry's threshold (BYZ_SENTRY), and the equivocator's proof on file
   and verifying. (a) K3 equal to the plain ladder on the card and the
   native verifier on every distinct item (b) gave it (one verdict per
   item), and on a crafted set (``crafted_k3_set``: wrong keys, both fork
   branches, r or s of 0 or n, a high s, R.x in [n, p), a key off the
   curve, Q = -G, hashes of 0 and n, an item twice): no forged item
   accepted. Then K3 against its plain version and timed on (b)'s real
   batches of its most frequent and its largest B, and K1 at the shape
   (b)'s batcher launched most often.

For each live path (the replays of phases 3 and 4, the node cluster of
phase 8: its batched waves and its per-node sweeps, phase 12's mobile
pair, phase 13's lock-checked cluster, and phase 14's replayed stream and
live cluster at each slot count of two or more), K1 is also held
against its plain version, and timed, at the shape that path gave it most
often; K3 likewise at the batch size phase 10's cluster gave it most
often, and at phase 15's. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab dist/old dist/new dist/new dist/old

runs phase 2's timings and K2's block form at K2_BLOCK_SHAPES only, in
each given checkout of the repo in turn (each builds its own kernels in a
fresh process), and exits: two commits compared on one card; K3 at every B
of VERIFY_TIMED_B (1 to 16384) only where every tree has it.
``--nodes-ab`` does the same with phase 8's node cluster.

    python3 chip_smoke.py --k2-tiles

holds every tile of K2's block form against the plain version and times
it at K2_BLOCK_SHAPES and at the square K2 rows, prints which tile is
fastest and which the C entry picks, and the SASS instruction counts of
each K2 kernel, and exits.

    python3 chip_smoke.py --phase 14

runs phase 1 (the device and the build), then phase 14 alone, and ends
with the kernels line (phase 14's rows) and the device line; ``--phase
15`` likewise with phase 15.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import random
import statistics
import sys
import time
from collections import Counter

SYNC_EVENTS = 64
TX_PER_EVENT = 4
TX_BYTES = 100
# events per stream: 256 per validator at 16 validators, and at 64 enough
# for the run to commit many blocks past the peer-set change (16384 commits
# 20 after it; its host oracle takes 98-159 s, so it replays in a child
# process beside phases 1-4's card work: OracleProcess)
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
# events a validator creates in a round of a random gossip stream, about
# (gossip_stream's membership changes are placed by it)
ROUND_EVENTS_PER_PEER = 9

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


def k1_bound_ms(W: int, P: int, S: int, V=None):
    """Least time for K1's work on an H100 SXM: each input read once and
    the output written once at HBM rate, or S·V·W·P compare-adds (two
    32-bit operations each) at the CUDA cores' rate — whichever is larger.
    V voter rows against W candidates (V = W where None)."""
    V = W if V is None else V
    nbytes = 4 * (V + W) * P + S * P + 4 * S * V * W
    ops = 2 * S * V * W * P
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


def k2_bound_ms(B: int, E: int, P: int, Y=None):
    """Least time for K2's work on an H100 SXM: la and fd read once and the
    bool output written once at HBM rate, or B·E·Y·P compare-adds (two
    32-bit operations each) at the CUDA cores' rate — whichever is
    larger. E rows of la against Y of fd (Y = E where None: the square
    form)."""
    Y = E if Y is None else Y
    nbytes = 4 * B * (E + Y) * P + B * E * Y
    ops = 2 * B * E * Y * P
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


def gossip_stream(n_peers: int, n_events: int, seed: int, changes=()):
    """A seeded random-gossip stream of signed events: each event's self-
    parent is its creator's head, its other-parent a random peer's head,
    and it carries TX_PER_EVENT random transactions of TX_BYTES bytes.
    Returns (events, keys, peer_set): the peer-set of the ``n_peers``
    genesis validators.

    ``changes`` holds (kind, round) membership changes, kind "join" or
    "leave" (``churn_peer_sets`` registers their peer-sets). A joiner is a
    key beyond the genesis ones (keys[n_peers + k] for the k-th join),
    which creates events from the stream's position of its round on; a
    leaver (the last genesis validator not yet gone) creates none from
    that position on. A round is about ROUND_EVENTS_PER_PEER events a
    validator into the stream (a 64-validator stream's rounds hold
    596-639 events)."""
    from babble_tpu_torch.crypto.keys import PrivateKey
    from babble_tpu_torch.crypto.secp256k1 import N as CURVE_N
    from babble_tpu_torch.hashgraph.event import Event
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet

    rng = random.Random(seed)
    n_keys = n_peers + sum(kind == "join" for kind, _ in changes)
    keys = [PrivateKey(rng.randrange(1, CURVE_N)) for _ in range(n_keys)]
    peers = PeerSet([
        Peer(f"inmem://p{i}", k.public_key.hex(), f"p{i}")
        for i, k in enumerate(keys[:n_peers])
    ])
    # per key, the stream positions where it creates events: [start, stop)
    span = [[0, n_events] for _ in range(n_keys)]
    joined, left = n_peers, n_peers
    for kind, rnd in changes:
        at = rnd * ROUND_EVENTS_PER_PEER * n_peers
        if kind == "join":
            span[joined][0] = at
            joined += 1
        else:
            left -= 1
            span[left][1] = at
    heads = [""] * n_keys
    seqs = [-1] * n_keys
    events = []
    order = list(range(n_keys))
    while len(events) < n_events:
        rng.shuffle(order)
        for i in order:
            if len(events) >= n_events:
                break
            if not span[i][0] <= len(events) < span[i][1]:
                continue
            op = ""
            if events:
                j = rng.randrange(n_keys - 1)
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


def churn_peer_sets(keys, peers, changes):
    """The peer-sets of ``gossip_stream(len(peers), ..., changes=changes)``
    by round, as ``replay``'s ``peer_sets``: each change's round registers
    the set that adds the next joiner's key or drops the last genesis
    validator not yet gone."""
    from babble_tpu_torch.peers.peer import Peer

    n_peers = len(peers.peers)
    by_key = {p.pub_key_hex: p for p in peers.peers}
    out, ps = [], peers
    joined, left = n_peers, n_peers
    for kind, rnd in changes:
        if kind == "join":
            k = keys[joined]
            ps = ps.with_new_peer(Peer(f"inmem://p{joined}",
                                       k.public_key.hex(), f"p{joined}"))
            joined += 1
        else:
            left -= 1
            ps = ps.with_removed_peer(by_key[keys[left].public_key.hex()])
        out.append((rnd, ps))
    return out


# -- replays -----------------------------------------------------------------


def replay(events, peers, accel=None, peer_sets=(), sync=SYNC_EVENTS):
    """Replay the stream through the port's live pipeline in syncs of
    ``sync`` events with a flush after each (Core.sync's cadence), then
    drain any in-flight sweep (wall time included). Returns (hashgraph,
    wall seconds)."""
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore

    h = Hashgraph(InmemStore(1_000_000))
    h.init(peers)
    for r, ps in peer_sets:
        h.store.set_peer_set(r, ps)
    h.accel = accel
    t0 = time.perf_counter()
    for b in range(0, len(events), sync):
        for ev in events[b:b + sync]:
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


def oracle_summary(events, peers, peer_sets=()) -> dict:
    """The host oracle's replay of a stream (no offload), reduced to what
    the checks read: its consensus_state, its wall seconds, the
    transactions it committed and each block's round received."""
    h, seconds = replay(events, peers, peer_sets=peer_sets)
    state = consensus_state(h)
    blocks = [h.store.get_block(b) for b in range(len(state[2]))]
    return {"state": state, "seconds": seconds,
            "n_tx": sum(len(b.transactions()) for b in blocks),
            "rounds_received": [b.round_received() for b in blocks]}


def _oracle_child(send, events, peers, peer_sets) -> None:
    try:
        send.send(("ok", oracle_summary(events, peers, peer_sets)))
    except BaseException:
        import traceback

        send.send(("error", traceback.format_exc()))


def _dag_oracle_child(send, seed) -> None:
    try:
        from babble_tpu_torch.ops import dag

        t0 = time.perf_counter()
        events, _keys, peers = gossip_stream(64, EVENTS_DAG_64, seed)
        stream_s = time.perf_counter() - t0
        h, replay_s = replay(events, peers)
        t0 = time.perf_counter()
        snap = dag.snapshot_from_hashgraph(h)
        build_s = time.perf_counter() - t0
        send.send(("ok", (snap, oracle_decisions(h, snap.hashes),
                          stream_s, replay_s, build_s)))
    except BaseException:
        import traceback

        send.send(("error", traceback.format_exc()))


class OracleProcess:
    """``oracle_summary`` in a child process, started at once, so that a
    long host oracle replays beside the card phases instead of before the
    replays it is held against. The child is spawned (the parent holds the
    card) and touches no card; it is a daemon, ended with the script. With
    ``dag_seed`` it runs ``_dag_oracle_child`` instead: phase 6's
    64-validator stream, its oracle replay, the replay's snapshot and the
    oracle's decisions on it."""

    def __init__(self, events=None, peers=None, peer_sets=(), dag_seed=None):
        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        target, args = ((_oracle_child, (send, events, peers, peer_sets))
                        if dag_seed is None
                        else (_dag_oracle_child, (send, dag_seed)))
        self._proc = ctx.Process(target=target, daemon=True, args=args)
        self._proc.start()
        send.close()

    def result(self) -> dict:
        try:
            status, out = self._recv.recv()
        except EOFError:
            self._proc.join()
            raise AssertionError("the oracle process ended with code "
                                 f"{self._proc.exitcode} and no result")
        self._proc.join()
        if status != "ok":
            raise AssertionError(f"the oracle process failed:\n{out}")
        return out

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else 0.0


def run_main_path(label, events, peers, peer_sets=(), min_slots=1,
                  min_blocks_after=(-1, 1), no_resident_arm=False,
                  oracle=None):
    """Oracle, accel at defaults, accel with min_window=0 (both on resident
    windows), and with ``no_resident_arm`` min_window=0 without them (a
    full window build and upload every sweep): identical consensus, no
    fallback, one K1 launch per device sweep. The oracle replays here, or
    in ``oracle``, an OracleProcess of the same stream, while the arms
    replay. It must commit at least ``min_blocks_after[1]`` blocks received
    in rounds after ``min_blocks_after[0]``. Returns (one record per arm,
    the oracle's consensus_state, a hashgraph holding it: the oracle's, or
    with ``oracle`` the last arm's)."""
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.ops import kernels

    results = []
    arms = [("defaults", {}), ("min_window=0", {"min_window": 0})]
    if no_resident_arm:
        arms.append(("min_window=0, no resident",
                     {"min_window": 0, "resident": False}))
    replayed = []
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
        replayed.append((arm, kw, accel, samples, h, wall, launches,
                         consensus_state(h)))

    if oracle is None:
        oracle_h, oracle_s = replay(events, peers, peer_sets=peer_sets)
        want = consensus_state(oracle_h)
        blocks = [oracle_h.store.get_block(b) for b in range(len(want[2]))]
        n_tx = sum(len(b.transactions()) for b in blocks)
        rounds_received = [b.round_received() for b in blocks]
    else:
        t0 = time.perf_counter()
        summary = oracle.result()
        log(f"[{label}] waited {time.perf_counter() - t0:.2f} s for the "
            "oracle process after the arms")
        oracle_h = replayed[-1][4]
        want, oracle_s = summary["state"], summary["seconds"]
        n_tx, rounds_received = summary["n_tx"], summary["rounds_received"]
    n_blocks = len(want[2])
    log(f"[{label}] oracle: {len(events)} events in {oracle_s:.3f} s "
        f"({len(events) / oracle_s:.1f} events/s), {n_blocks} blocks, "
        f"{n_tx} tx committed, {len(want[3])} undetermined"
        + (" (in a child process)" if oracle is not None else ""))
    after_round, min_after = min_blocks_after
    n_after = sum(r > after_round for r in rounds_received)
    log(f"[{label}] blocks by round received: {rounds_received}")
    if n_after < min_after:
        raise AssertionError(f"[{label}] the oracle committed {n_after} blocks "
                             f"after round {after_round}, fewer than "
                             f"{min_after}")
    for arm, kw, accel, samples, h, wall, launches, got in replayed:
        st = accel.stats()
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
        rec = {"arm": arm, "launches": launches, "buckets": accel.buckets,
               "per_sweep_ms": per_sweep_stages(accel)}
        if not accel.resident:
            log(f"[{label}/{arm}] no resident windows: ms per sweep: build "
                f"{1e3 * accel.stage_s['build'] / n:.3f}")
            results.append(rec)
            continue
        log(f"[{label}/{arm}] resident windows: rows_delta "
            f"{accel.rows_delta_total}, rows_reused {accel.rows_reused_total},"
            f" rebuilds {accel.window_state.rebuilds}, delta sweeps "
            f"{accel.delta_sweeps} of {accel.sweeps}; ms per sweep: build "
            f"{1e3 * accel.stage_s['build'] / n:.3f}, delta_scan + pack "
            f"{1e3 * (accel.stage_s['delta_scan'] + accel.stage_s['pack']) / n:.3f}")
        results.append(rec)
    return results, want, oracle_h


def per_sweep_stages(accel) -> dict:
    """An offload's dispatch (host: upload and enqueue) and kernel (device
    span) ms per applied sweep."""
    n = max(1, accel.sweeps)
    return {k: 1e3 * accel.stage_s[k] / n for k in ("dispatch", "kernel")}


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


def oracle_snapshot(h) -> tuple:
    """(the snapshot of the oracle ``h``, the oracle's decisions on its
    rows, seconds to build the snapshot)."""
    from babble_tpu_torch.ops import dag

    t0 = time.perf_counter()
    snap = dag.snapshot_from_hashgraph(h)
    build_s = time.perf_counter() - t0
    return snap, oracle_decisions(h, snap.hashes), build_s


def dag_against_oracle(label, snap, want, build_s, k2_at: Counter):
    """run_pipeline on the card over an oracle's snapshot ``snap`` must
    equal what the oracle decided (``want``), event for event, and its
    strongly-see matrix (K2's output on the path) must equal K2's plain
    version on the snapshot's own coordinates. Returns the snapshot."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import dag, kernels

    stats = {}
    got = k2_launched(
        (1, snap.n_events, snap.n_peers), k2_at,
        lambda: dag.run_pipeline(snap, return_matrices=True, device="cuda",
                                 stats=stats))
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
# Undetermined events a node may gain per validator before it suspends
# itself (Config's default is 100). A suspended node ingests nothing more,
# so it never commits again. With 16 nodes sharing one interpreter the
# nodes of a phase 8 arm come within a block's worth of events of the
# default's 1600 (each arm prints its peak beside the limit), so a node
# that lags the others by a block suspends and holds the cluster's common
# block where it was. Ten times the default keeps the valve for a runaway
# node and out of the way of a lag.
SUSPEND_LIMIT = 1000
# the profiled window after the measured one (defaults arm)
PROFILE_S = 2.0
# after the windows, the load going on: the block every node must reach
# before the checks, and how long it may take (16 nodes in one process
# reached block 1 from 0 to 31 s after the window, on the H100's host). A
# block needs transactions: with the load stopped, phase 13's four nodes,
# which had committed all they were given in blocks 0-2, never reached
# block 3 (NVIDIA H100 80GB HBM3 at 700 W)
SETTLE_BLOCK = 1
SETTLE_S = 90.0
# phase 8's arms settle to block 0: the window's load is the same, and on a
# slow host block 1 came up to 77 s after the window (NVIDIA H100
# 80GB HBM3 at 700 W), which put the whole script over its time limit
NODES_SETTLE_BLOCK = 0
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


def tcp_cluster(n: int, accelerator: bool, join_timeout=None):
    """``n`` port Nodes over loopback TCP in this process, each with the
    dummy app behind an InmemProxy (bench.py's _make_tcp_cluster), the
    offload on the card when ``accelerator``; ``join_timeout`` (seconds a
    join or leave may wait for consensus, node and transport) where given.
    Returns (nodes, proxies, states), the nodes initialised and not yet
    running."""
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
        extra = {} if join_timeout is None else {"join_timeout": join_timeout}
        conf = Config(heartbeat_timeout=HEARTBEAT_S,
                      slow_heartbeat_timeout=SLOW_HEARTBEAT_S,
                      log_level="error", moniker=f"t{i}",
                      accelerator=accelerator, cache_size=NODE_CACHE,
                      suspend_limit=SUSPEND_LIMIT, **extra)
        st = DummyState()
        pr = InmemProxy(st)
        node = Node(conf, Validator(k, f"t{i}"), peers, peers,
                    InmemStore(conf.cache_size),
                    TCPTransport(addr[k.public_key.hex()], timeout=2.0,
                                 **extra), pr)
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


def node_states(nodes) -> list:
    """Per node: its state, last block, last consensus round and the
    undetermined events it gained since start beside the count at which
    it suspends itself."""
    return [
        [str(n.get_state()), n.get_last_block_index(),
         n.get_last_consensus_round_index(),
         len(n.core.get_undetermined_events())
         - n.initial_undetermined_events,
         n.conf.suspend_limit * len(n.core.validators)]
        for n in nodes]


class UndeterminedPeaks:
    """Samples every node's undetermined events (gained since its start)
    every 0.5 s on a thread of its own: the peak per node, and the nodes
    seen suspended, to read beside the suspend limit."""

    def __init__(self, nodes):
        import threading

        self.nodes = nodes
        self.peak = [0] * len(nodes)
        self.suspended = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(0.5):
            for i, st in enumerate(node_states(self.nodes)):
                self.peak[i] = max(self.peak[i], st[3])
                if st[0] == "Suspended":
                    self.suspended.add(i)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)


def check_cluster_blocks(label, nodes, least: int = SETTLE_BLOCK) -> int:
    """Every node's chain up to the common block, which must be at least
    ``least``: byte-identical bodies (tests/test_node.py::check_gossip) and
    monotonic timestamps. Returns the common block index."""
    common = min(n.get_last_block_index() for n in nodes)
    if common < least:
        raise AssertionError(f"[{label}] common block {common}: the cluster "
                             "did not commit; per node (state, last block, "
                             "last consensus round, undetermined events "
                             "since start / suspend limit): "
                             f"{node_states(nodes)}")
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


def membership_hashgraph(genesis, app=None, cache: int = NODE_CACHE):
    """A fresh port Hashgraph on ``genesis`` with no offload whose commit
    runs the app (``app``, a proxy handler; the dummy app by default) and
    applies membership changes as a node's core does: each accepted
    PEER_ADD or PEER_REMOVE of a committed block takes effect
    PEER_SET_EFFECTIVE_DELAY rounds after the block's round received."""
    from babble_tpu_torch.dummy.state import State as DummyState
    from babble_tpu_torch.hashgraph import Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph.internal_transaction import (
        TransactionType,
    )
    from babble_tpu_torch.node.core import PEER_SET_EFFECTIVE_DELAY

    app = app or DummyState()
    validators = [genesis]

    def commit(block):
        resp = app.commit_handler(block)
        block.body.state_hash = resp.state_hash
        block.body.internal_transaction_receipts = resp.receipts
        ps, changed = validators[0], False
        for r in resp.receipts:
            body = r.internal_transaction.body
            if not r.accepted:
                continue
            if body.type == TransactionType.PEER_ADD:
                ps, changed = ps.with_new_peer(body.peer), True
            elif body.type == TransactionType.PEER_REMOVE:
                ps, changed = ps.with_removed_peer(body.peer), True
        if changed:
            validators[0] = ps
            h.store.set_peer_set(
                block.round_received() + PEER_SET_EFFECTIVE_DELAY, ps)

    h = Hashgraph(InmemStore(cache), commit)
    h.init(genesis)
    return h


def replay_own_events(label, node, app=None) -> int:
    """Node ``node``'s chain against a host-oracle replay of its own events
    in its topological order, through ``membership_hashgraph`` on the
    node's genesis peer-set with the node's app (``app``; the dummy app by
    default): every block body hash equal. Returns the number of events
    replayed."""
    from babble_tpu_torch.hashgraph import Event

    store = node.core.hg.store
    events = sorted(
        (store.get_event(eh)
         for pk in store.repertoire_by_pub_key()
         for eh in store.participant_events(pk, -1)),
        key=lambda e: e.topological_index,
    )
    h = membership_hashgraph(node.core.genesis_peers, app)
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
                profile: bool = False, require_batched: bool = False,
                settle_block: int = SETTLE_BLOCK) -> dict:
    """One arm: an ``n``-node cluster under closed-loop load, ``warmup_s``
    then a ``window_s`` measured window (and with ``profile`` a profiled
    window after it), then, the load going on, until every node has
    committed ``settle_block`` (at most SETTLE_S), then the checks. K1's
    launches are counted from 0
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
    peaks = UndeterminedPeaks(nodes)
    try:
        for node in nodes:
            node.run_async()
        t_up = time.monotonic()
        peaks.start()
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
        stop = threading.Event()
        loader = threading.Thread(
            target=pump.until, args=(t_settle + SETTLE_S, stop), daemon=True)
        loader.start()
        try:
            while (min(node.get_last_block_index() for node in nodes)
                   < settle_block and time.monotonic() - t_settle < SETTLE_S):
                time.sleep(0.25)
        finally:
            stop.set()
            loader.join(timeout=10)
        rec["settle_s"] = time.monotonic() - t_settle
        stats = [node.get_stats_snapshot() for node in nodes]
        # the BABBLE_LOCKCHECK recorder's count as each node reports it
        # (0 while the recorder is disarmed)
        rec["lock_order_inversions"] = [s["lock_order_inversions"]
                                        for s in stats]
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
        peaks.stop()
        rec["peak_undetermined"] = max(peaks.peak)
        rec["suspend_at"] = SUSPEND_LIMIT * n
        rec["suspended_nodes"] = len(peaks.suspended)
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
    rec["common_block"] = check_cluster_blocks(f"nodes/{label}", nodes,
                                               settle_block)
    # seconds from the nodes' start to the last node's commit of block 0:
    # a number every arm has (node 0 may commit nothing inside the window)
    rec["block0_s"] = max(t for mine in node_commits for t, bi in mine
                          if bi == 0) - t_up
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
        f"(reached {rec['settle_s']:.1f} s after the window; nodes "
        f"stopped in {rec['shutdown_s']:.1f} s); peak undetermined events "
        f"{rec['peak_undetermined']} of the {rec['suspend_at']} at which a "
        f"node suspends ({rec['suspended_nodes']} suspended); {name_power}")
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
                          require_batched=acc and "BABBLE_ACCEL_BATCH" not in env,
                          settle_block=NODES_SETTLE_BLOCK)
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


def node_cluster_fresh(beside=None) -> tuple:
    """``node_cluster_child`` in a fresh interpreter (a young process keeps
    every device record in its profile, see ``profile_dag_fresh``, and the
    cluster's threads start from a clean process), and ``beside()``, if
    given, here meanwhile. Returns (its arms, what ``beside`` returned)."""
    child = FreshChild("node_cluster_child()", "NODES", {}, 600)
    try:
        extra = beside() if beside is not None else None
        arms = child.result()
    finally:
        child.stop()
    for rec in arms:
        for key in ("buckets", "sweep_shapes"):
            if key in rec:
                rec[key] = Counter({tuple(k): v for k, v in rec[key]})
    return arms, extra


# -- phase 9: the command line, as processes ---------------------------------

CLI_NODES = 4
# the first CLI_BATCHED node processes run the batcher, the others share
# admission slots
CLI_BATCHED = 2
CLI_TARGET_BLOCK = 4
CLI_PROFILE_S = 1.0
CLI_TIMEOUT_S = 180.0
# healthview's two scrapes, this far apart; traceview's records per node
CLI_HEALTH_WINDOW_S = 2.0
CLI_TRACE_LIMIT = 64


def cli_health(endpoints) -> None:
    """healthview over the CLI nodes' services, while they run under load:
    two scrapes CLI_HEALTH_WINDOW_S apart of every node's /metrics, /stats
    and /suspects. Every node must be up, with its lag behind the cluster's
    highest round and its round and block rates, and the cluster must have
    a commit-p50 SLO verdict. Prints the summary line on its own line."""
    from babble_tpu_torch.obs import healthview

    t0 = time.perf_counter()
    view = healthview.collect(endpoints, window_s=CLI_HEALTH_WINDOW_S)
    c = view["cluster"]
    if c["n_up"] != len(endpoints) or c["n_nodes"] != len(endpoints):
        raise AssertionError(f"[cli/health] {c['n_up']}/{c['n_nodes']} "
                             f"nodes up:\n{healthview.render(view)}")
    for n in view["nodes"]:
        if (n["lag_rounds"] is None or n["round_rate_per_s"] is None
                or n["block_rate_per_s"] is None):
            raise AssertionError(f"[cli/health] node {n['index']} has no "
                                 f"lag or rates: {n}")
    if c["slo_verdict"] not in ("ok", "breach"):
        raise AssertionError(f"[cli/health] no SLO verdict: "
                             f"{c['slo_verdict']}")
    log(f"[cli/health] healthview over the {len(endpoints)} node processes "
        f"({CLI_HEALTH_WINDOW_S} s window, answered in "
        f"{time.perf_counter() - t0:.1f} s):\n{healthview.render(view)}")
    print(healthview.summary_line(view), flush=True)


def cli_traces(endpoints) -> None:
    """traceview over the CLI nodes' provenance exports: each node's newest
    CLI_TRACE_LIMIT records (/traces), merged across nodes; at least one
    transaction must have reached at least two nodes besides its origin
    (two hops), with monotone stamps. Prints one such timeline and the
    per-hop attribution summary."""
    from babble_tpu_torch.obs import traceview

    exports = [traceview.fetch_node(ep, limit=CLI_TRACE_LIMIT)
               for ep in endpoints]
    merged = traceview.merge_all(exports)
    multi = [m for m in merged if len(m["hops"]) >= 2 and m["monotone"]]
    if not multi:
        raise AssertionError(
            f"[cli/trace] none of {len(merged)} merged transactions reached "
            f"two nodes besides its origin (records per node: "
            f"{[len(e['records']) for e in exports]})")
    best = max(multi, key=lambda m: (m["committed_on"], len(m["hops"])))
    summary = traceview.attribution_summary(merged)
    log(f"[cli/trace] traceview over the {len(endpoints)} node processes: "
        f"{len(merged)} transactions merged from "
        f"{[len(e['records']) for e in exports]} records, {len(multi)} with "
        f"two hops or more; one of them:\n{traceview.render(best)}\n"
        f"[cli/trace] per-hop attribution: {json.dumps(summary)}")


# phase 9's client tier: a gateway process, a subscriber swarm over the
# nodes' hubs and the gateway's, proofs, a replica from a checkpoint
CLIENT_SUBS = 2000  # bench.py --clients' default
# the reference clientsmoke stalls 5 of its 100 subscribers
CLIENT_STALL_FRAC = 0.05
# a fifth of the swarm rides the gateway's hub, the rest the nodes'; the
# stalled ones ride the nodes' hubs only: the gateway's command line has
# no send-buffer flag, so its hub keeps the OS's loopback buffer (MBs),
# and a stalled socket there fills only after more stream than a run sends
CLIENT_GW_SHARE = 0.2
CLIENT_GW_TXS = 60
CLIENT_DIRECT_TXS = 40
CLIENT_TX_FILL = 1000  # about 1 KiB a payload
CLIENT_SAMPLE = 12
CLIENT_DEADLINE_S = 60.0
# sockets this process holds besides the swarm's
CLIENT_FD_MARGIN = 256
# the nodes' hub settings (the reference clientsmoke's): a small kernel send
# buffer and frame queue, so that a stalled subscriber backs up into the
# hub's own queue and is shed within the run
CLIENT_HUB_FLAGS = ["--sub-queue", "32", "--sub-stall-timeout", "3",
                    "--sub-sndbuf", "8192"]
# the healthy subscribers a hub may shed: the swarm's one reader thread can
# fall behind a hub's stall timer on a loaded host (the reference's bound)
CLIENT_HEALTHY_SHED_MAX = 0.1


def raise_nofile(want: int) -> int:
    """Raise this process's soft RLIMIT_NOFILE to its hard limit (nothing
    outside the process changes) and print both. Returns how many of
    ``want`` subscriber sockets fit, printing the cut when fewer do."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    new = hard if hard != resource.RLIM_INFINITY else max(
        soft, want + CLIENT_FD_MARGIN)
    if new != soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (new, hard))
    fits = min(want, new - CLIENT_FD_MARGIN)
    log(f"[cli/client] RLIMIT_NOFILE soft {soft} -> {new}, hard "
        f"{'unlimited' if hard == resource.RLIM_INFINITY else hard}"
        + (f"; CUT: {fits} subscribers, not {want}" if fits < want else ""))
    return fits


def _closed_by_hub(sock) -> bool:
    """Whether the hub closed a stalled subscriber's socket: its buffered
    frames, then end of stream or a reset, within 5 s."""
    import socket

    sock.setblocking(True)
    sock.settimeout(5.0)
    try:
        while sock.recv(1 << 16):
            pass
        return True
    except ConnectionResetError:
        return True
    except (socket.timeout, TimeoutError):
        return False


def client_tier(tmp: str, peers_path: str, hubs, proxies, services,
                node_stats, check_alive) -> dict:
    """Phase 9's client tier in front of the CLI nodes (docs/clients.md):
    ``python -m babble_tpu_torch.client.gateway --processes`` with 4 shard
    processes, forwarding to nodes 0-1 and tailing node 2's hub; a
    SubscriberSwarm of CLIENT_SUBS over the four nodes' hubs and the
    gateway's (CLIENT_STALL_FRAC of them stalled); ~1 KiB transactions
    through the gateway's SubmitTx and directly at nodes 2-3. Checks: every
    healthy subscriber's blocks in order with no gap, every stalled one
    shed, every sampled transaction's GET /proof at the gateway verified
    offline against the validator set alone (a tampered copy rejected), a
    ReadReplica spun up from a node's checkpoint serving a proof itself,
    the gateway's final stats(), and every node still sweeping on the card
    with no fallback."""
    import base64
    import os
    import signal
    import subprocess
    import urllib.error

    from babble_tpu_torch.client.proofs import txid_hex
    from babble_tpu_torch.client.replica import ReadReplica
    from babble_tpu_torch.client.swarm import SubscriberSwarm
    from babble_tpu_torch.client.verifier import (
        ProofError,
        verify_checkpoint,
        verify_proof,
    )
    from babble_tpu_torch.proxy.socket_proxy import JsonRpcClient

    t_start = time.perf_counter()
    n_subs = raise_nofile(CLIENT_SUBS)
    n_gw = int(n_subs * CLIENT_GW_SHARE)
    n_node = n_subs - n_gw
    n_stalled = int(round(n_subs * CLIENT_STALL_FRAC))
    with open(peers_path) as f:
        validators = json.load(f)
    before = [node_stats(i) for i in range(len(hubs))]
    gw_listen, gw_sub, gw_http = (f"127.0.0.1:{p}" for p in free_ports(3))
    here = os.path.dirname(os.path.abspath(__file__))
    gw_err = open(os.path.join(tmp, "gateway.err"), "w")
    # its own session: its spawned shard processes die with it on a failure
    gw = subprocess.Popen(
        [sys.executable, "-m", "babble_tpu_torch.client.gateway",
         "--forward", ",".join(proxies[:2]), "--upstream", hubs[2],
         "--peers", peers_path, "--listen", gw_listen,
         "--sub-listen", gw_sub, "--http", gw_http, "--shards", "4",
         "--processes"],
        stdout=subprocess.PIPE, stderr=gw_err, text=True, cwd=here,
        start_new_session=True)
    swarms, replica, rpcs = [], None, []

    def gw_alive() -> None:
        check_alive()
        if gw.poll() is not None:
            gw_err.flush()
            with open(gw_err.name) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"[cli/client] the gateway exited with "
                                 f"{gw.returncode}:\n{tail}")

    try:
        # the gateway's replica tails node 2 from block 0: the swarm
        # subscribes at the live tail once it has caught up (sealing trails
        # the commits by a block or two)
        head = int(before[2]["last_block_index"]) - 2
        deadline = time.monotonic() + CLIENT_DEADLINE_S
        while True:
            gw_alive()
            try:
                gw_replica = json.loads(http_get(f"http://{gw_http}/stats",
                                                 timeout=5))
                if gw_replica["last_verified"] >= max(0, head):
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"[cli/client] the gateway's replica "
                                     f"did not reach block {head}")
            time.sleep(0.2)
        t_gw = time.perf_counter() - t_start

        node_swarm = SubscriberSwarm(hubs, n_node, start=-1,
                                     stall_frac=n_stalled / n_node)
        gw_swarm = SubscriberSwarm([gw_sub], n_gw, start=-1)
        for sw in (node_swarm, gw_swarm):
            swarms.append(sw)
            sw.start_all()
            if sw.connect_errors:
                raise AssertionError(f"[cli/client] {sw.connect_errors} "
                                     "subscribers could not connect")
        # every node hub holds its share of the swarm, node 2's the
        # gateway's upstream subscription too
        while (sum(int(node_stats(i)["client_subscribers"])
                   for i in range(len(hubs))) != n_node + 1
               or not all(m.subscribed for sw in swarms
                          for m in sw.healthy())):
            gw_alive()
            if time.monotonic() > deadline:
                raise AssertionError("[cli/client] the swarm did not attach")
            time.sleep(0.2)
        t_attach = time.perf_counter() - t_start

        gw_rpc = JsonRpcClient(gw_listen, timeout=30.0)
        direct = [JsonRpcClient(a, timeout=30.0) for a in proxies[2:4]]
        rpcs += [gw_rpc] + direct
        submitted = {}  # tx -> submit time
        for i in range(CLIENT_GW_TXS + CLIENT_DIRECT_TXS):
            via_gw = i < CLIENT_GW_TXS
            tx = (f"{'gateway' if via_gw else 'direct'} tx {i} ".encode()
                  + b"x" * CLIENT_TX_FILL)
            t = time.monotonic()
            rpc = gw_rpc if via_gw else direct[i % 2]
            v = rpc.call("Babble.SubmitTx", base64.b64encode(tx).decode())
            if v not in ("accepted", True):
                raise AssertionError(f"[cli/client] tx {i} "
                                     f"({'gateway' if via_gw else 'direct'})"
                                     f": verdict {v!r}")
            submitted[tx] = t
        txs = list(submitted)
        dup = gw_rpc.call("Babble.SubmitTx",
                          base64.b64encode(txs[0]).decode())
        if dup not in ("duplicate", "already_committed"):
            raise AssertionError(f"[cli/client] a duplicate through the "
                                 f"gateway got {dup!r}")
        t_load = time.monotonic()
        deadline = t_load + CLIENT_DEADLINE_S

        # every sampled transaction's proof from the gateway, verified
        # offline against the validator set alone
        sample = txs[::max(1, len(txs) // CLIENT_SAMPLE)][:CLIENT_SAMPLE]
        pending = {txid_hex(tx): tx for tx in sample}
        proof_s, get_ms = [], []
        while pending:
            gw_alive()
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[cli/client] {len(pending)} of {len(sample)} sampled "
                    f"transactions have no proof at the gateway "
                    f"{CLIENT_DEADLINE_S} s after the load")
            for tid, tx in list(pending.items()):
                t0 = time.perf_counter()
                try:
                    proof = json.loads(http_get(
                        f"http://{gw_http}/proof/{tid}", timeout=5))
                except urllib.error.HTTPError as err:
                    if err.code != 404:
                        raise
                    continue
                get_ms.append(1e3 * (time.perf_counter() - t0))
                if verify_proof(proof, validators)["tx"] != tx:
                    raise AssertionError("[cli/client] a proof names "
                                         "another transaction")
                evil = b"not the committed tx"
                try:
                    verify_proof({**proof, "txid": txid_hex(evil),
                                  "tx": base64.b64encode(evil).decode()},
                                 validators)
                except ProofError:
                    pass
                else:
                    raise AssertionError("[cli/client] a tampered proof "
                                         "verified")
                proof_s.append(time.monotonic() - submitted[tx])
                del pending[tid]
            time.sleep(0.1)

        # every stalled subscriber shed by its hub
        while sum(int(node_stats(i)["client_shed_subscribers"])
                  for i in range(len(hubs))) < n_stalled:
            gw_alive()
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[cli/client] the hubs shed "
                    f"{[node_stats(i)['client_shed_subscribers'] for i in range(len(hubs))]}"
                    f" subscribers, not the {n_stalled} stalled")
            time.sleep(0.2)
        time.sleep(1.0)  # the stream's tail reaches the swarm
        stalled = [m for m in node_swarm.members if m.stalled]
        not_shed = [m.idx for m in stalled if not _closed_by_hub(m.sock)]
        if len(stalled) != n_stalled or not_shed:
            raise AssertionError(f"[cli/client] stalled subscribers not "
                                 f"shed: {not_shed} of {len(stalled)}")
        sw_stats = [sw.stats() for sw in swarms]
        healthy = [m for sw in swarms for m in sw.healthy()]
        shed_healthy = [m for m in healthy if m.closed]
        gaps = sum(st["gaps"] for st in sw_stats)
        starved = [m.idx for m in healthy if not m.closed and m.blocks == 0]
        if (gaps or starved or len(shed_healthy)
                > CLIENT_HEALTHY_SHED_MAX * len(healthy)):
            raise AssertionError(
                f"[cli/client] gaps {gaps}, healthy subscribers with no "
                f"block {len(starved)}, healthy shed {len(shed_healthy)} of "
                f"{len(healthy)}: {sw_stats}")

        # a checkpoint spins up a verifying read replica serving a proof
        cp = json.loads(http_get(f"http://{services[0]}/checkpoint"))
        anchor, _frame = verify_checkpoint(cp, validators)
        replica = ReadReplica(hubs[3], validators, checkpoint=cp,
                              http_addr="127.0.0.1:0")
        replica.start()
        probe = b"replica probe " + b"z" * CLIENT_TX_FILL
        direct[1].call("Babble.SubmitTx", base64.b64encode(probe).decode())
        t_probe = time.monotonic()
        while True:
            gw_alive()
            try:
                proof = json.loads(http_get(
                    f"http://{replica.http_addr}/proof/{txid_hex(probe)}",
                    timeout=5))
                break
            except urllib.error.HTTPError as err:
                if err.code != 404:
                    raise
            if time.monotonic() > deadline:
                raise AssertionError("[cli/client] the replica from the "
                                     "checkpoint served no proof")
            time.sleep(0.1)
        replica_s = time.monotonic() - t_probe
        if (verify_proof(proof, validators)["tx"] != probe
                or replica.rejected_blocks):
            raise AssertionError(f"[cli/client] replica: {replica.stats()}")
        replica_stats = replica.stats()

        gw.send_signal(signal.SIGTERM)
        out, _ = gw.communicate(timeout=30)
        if gw.returncode != 0:
            raise AssertionError(f"[cli/client] the gateway exited with "
                                 f"{gw.returncode} on SIGTERM")
        gw_stats = json.loads(out.strip().splitlines()[-1])
        if (gw_stats["submitted"] != CLIENT_GW_TXS + 1
                or gw_stats["forward_unavailable"]
                or gw_stats["replica"]["rejected_blocks"]
                or len(gw_stats["workers"]) != 4):
            raise AssertionError(f"[cli/client] gateway stats {gw_stats}")

        after = [node_stats(i) for i in range(len(hubs))]
        for i, (b, a) in enumerate(zip(before, after)):
            if (a["consensus_engine"] != "device" or a["accel_kernel"] != "cuda"
                    or int(a["accel_sweeps"]) <= int(b["accel_sweeps"])
                    or int(a["accel_fallbacks"]) != 0):
                raise AssertionError(
                    f"[cli/client] node {i} after the client tier: engine "
                    f"{a['consensus_engine']}, kernel {a['accel_kernel']}, "
                    f"sweeps {b['accel_sweeps']} -> {a['accel_sweeps']}, "
                    f"fallbacks {a['accel_fallbacks']}")
        check_alive()
        lat_ms = {name: sorted(1e3 * x for m in sw.healthy()
                               for x in m.latencies)
                  for name, sw in (("nodes", node_swarm),
                                   ("gateway", gw_swarm))}
        if not all(lat_ms.values()):
            raise AssertionError(f"[cli/client] no push latency sample: "
                                 f"{ {k: len(v) for k, v in lat_ms.items()} }")
        rec = {
            "subscribers": n_subs, "attached": sum(
                st["subscribers"] for st in sw_stats),
            "healthy": len(healthy) - len(shed_healthy),
            "healthy_shed": len(shed_healthy), "stalled_shed": len(stalled),
            "gaps": gaps,
            "blocks_received": sum(st["blocks_received"] for st in sw_stats),
            "proofs_verified": len(sample), "sampled": len(sample),
            "push_ms": {k: [_pct(v, 0.5), _pct(v, 0.95), len(v)]
                        for k, v in lat_ms.items()},
            "proof_s_p50": _pct(sorted(proof_s), 0.5),
            "proof_get_ms_p50": _pct(sorted(get_ms), 0.5),
            "replica_s": replica_s, "anchor": anchor.index(),
            "sweeps": [int(a["accel_sweeps"]) - int(b["accel_sweeps"])
                       for b, a in zip(before, after)],
            "seconds": time.perf_counter() - t_start,
        }
        log(f"[cli/client] gateway process (4 shard processes) up, its "
            f"replica verifying, {t_gw:.1f} s in; {rec['attached']} of "
            f"{n_subs} subscribers attached ({n_node} over the 4 nodes' "
            f"hubs, {n_stalled} of them stalled; {n_gw} on the gateway's "
            f"hub) {t_attach:.1f} s in; {len(txs)} transactions of "
            f"{len(txs[0])} bytes ({CLIENT_GW_TXS} through the gateway, "
            f"{CLIENT_DIRECT_TXS} direct), a duplicate answered {dup!r}")
        log(f"[cli/client] subscribers: healthy {rec['healthy']}, healthy "
            f"shed {rec['healthy_shed']}, stalled shed {len(stalled)} of "
            f"{n_stalled}; gaps {gaps}; blocks received "
            f"{rec['blocks_received']}; proofs verified offline "
            f"{len(sample)} of {len(sample)} sampled (tampered copies "
            f"rejected); push latency (hub stamp to receipt) p50 / p95 ms: "
            + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} ({v[2]} samples)"
                        for k, v in rec["push_ms"].items() if v[2])
            + f"; proof latency (submit to verified proof at the gateway) "
            f"p50 {rec['proof_s_p50']:.3f} s, GET /proof p50 "
            f"{rec['proof_get_ms_p50']:.2f} ms; replica from the checkpoint "
            f"(anchor block {rec['anchor']}) served a fresh proof "
            f"{replica_s:.2f} s after its submit, rejected blocks 0; node "
            f"sweeps during the tier {rec['sweeps']}, fallbacks 0")
        log(f"[cli/client] replica stats: {json.dumps(replica_stats)}")
        log(f"[cli/client] gateway stats(): {json.dumps(gw_stats)}")
        log(f"[cli/client] client tier: {rec['seconds']:.1f} s")
        return rec
    finally:
        for sw in swarms:
            sw.stop()
        if replica is not None:
            replica.close()
        for rpc in rpcs:
            rpc.close()
        try:
            os.killpg(gw.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        gw.wait(timeout=30)
        gw_err.close()


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
    ports = free_ports(5 * n)
    gossip, service, proxy, client, hub = (ports[i * n:(i + 1) * n]
                                           for i in range(5))
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
                 "--client-listen", f"127.0.0.1:{hub[i]}",
                 *CLIENT_HUB_FLAGS,
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
            eps = [f"127.0.0.1:{port}" for port in service]
            cli_health(eps)
            cli_traces(eps)
            check_alive()
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
        rec["client"] = client_tier(
            tmp, os.path.join(tmp, "c0", "peers.json"),
            [f"127.0.0.1:{p}" for p in hub], [f"127.0.0.1:{p}" for p in proxy],
            [f"127.0.0.1:{p}" for p in service], stats, check_alive)
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


def plain_on_card(items) -> tuple:
    """(``items``' prepared inputs on the card, the plain ladder's output
    on them, its ms: timed once, host clock)."""
    import torch

    from babble_tpu_torch.ops import verify

    inputs = verify._prepare(items, torch.device("cuda"))
    t0 = time.perf_counter()
    plain = verify.shamir_plain(*inputs[1:])
    torch.cuda.synchronize()
    return inputs, plain, (time.perf_counter() - t0) * 1e3


def k3_against_plain(items, clock_mhz: float, ahead=None) -> dict:
    """K3 on ``items``' prepared inputs equal to its plain version on the
    card, bool for bool; K3 timed (CUDA events, median of 30), the plain
    version timed once (host clock), and K3's bound on these inputs.
    ``ahead`` is ``plain_on_card(items)`` if it ran before."""
    from babble_tpu_torch.ops import kernels, verify

    inputs, plain, plain_ms = ahead or plain_on_card(items)
    k3 = verify.shamir(*inputs[1:])
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


def check_verdicts(items, clock_mhz: float, ahead) -> dict:
    """K3 (on its own and through ``batch_verify``), the plain ladder on the
    card, the native verifier and the Python oracle agree on every item's
    verdict; returns ``k3_against_plain``'s record with the verdicts'
    counts. ``ahead`` is ``verify_ahead``'s record for ``items``."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import verify

    rec = k3_against_plain(items, clock_mhz, ahead["plain"][len(items)])
    k3 = (rec["k3"] & rec["inputs"].pre_ok).cpu().numpy()
    e2e = verify.batch_verify(items, torch.device("cuda"))
    native = np.array(native_verify_items(items))
    oracle = np.array(ahead["oracle"])
    rec["oracle_s"] = ahead["oracle_s"]
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


def verify_ahead(seed: int) -> dict:
    """Phase 10's host-bound half, run while phase 8's cluster runs in its
    own process: the verdict batch (VERIFY_N signatures, the ladder's rare
    cases among them) and the timing batch that repeats it, the plain
    ladder on the card at each B of VERIFY_TIMED_B (``plain_on_card``), and
    the Python oracle's verdicts on the verdict batch, over two spawned
    workers. Returns them for ``device_verification``."""
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    items = (signature_batch(VERIFY_N - 3, VERIFY_KEYS, seed)
             + ladder_edge_items())
    many = items * (VERIFY_TIMED_B[-1] // len(items))
    items_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        t1 = time.perf_counter()
        parts = [pool.submit(_oracle_chunk, items[i:i + 64])
                 for i in range(0, len(items), 64)]
        plain = {B: plain_on_card(many[:B]) for B in VERIFY_TIMED_B}
        oracle = [v for part in parts for v in part.result()]
        oracle_s = time.perf_counter() - t1
    log(f"[verify] beside phase 8: {len(items)} signatures from "
        f"{VERIFY_KEYS} keys in {items_s:.2f} s (set-up), the plain ladder "
        "on the card at B " + ", ".join(
            f"{B} {plain[B][2]:.1f} ms" for B in VERIFY_TIMED_B)
        + f" (one run each), the Python oracle in {oracle_s:.1f} s; "
        f"{time.perf_counter() - t0:.1f} s in all")
    return {"items": items, "many": many, "plain": plain, "oracle": oracle,
            "oracle_s": oracle_s}


def device_verification(seed: int, ahead: dict) -> list:
    """Phase 10, on ``verify_ahead``'s record; returns K3's rows of the
    kernels line."""
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

    items, many = ahead["items"], ahead["many"]
    ver = check_verdicts(items, clock, ahead)
    log(f"[verify] B {ver['B']}: K3 = plain on the card = native = Python "
        f"oracle = batch_verify on every verdict ({ver['valid']} valid, "
        f"{ver['invalid']} invalid; oracle {ver['oracle_s']:.1f} s); K3 "
        f"{ver['ms']:.4f} ms, plain {ver['plain_ms']:.1f} ms")
    timed = {}
    for B in VERIFY_TIMED_B:
        timed[B] = ver if B == ver["B"] else k3_against_plain(
            many[:B], clock, ahead["plain"][B])
        log(f"[verify] B {B}: K3 = plain on the card; K3 "
            f"{timed[B]['ms']:.4f} ms, shamir_plain "
            f"{timed[B]['plain_ms']:.1f} ms (one run)")

    rows = verify_times(many, clock)
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
    at_path = timed.get(path_b) or k3_against_plain(items[:path_b], clock)
    log(f"[verify] B {path_b}, the node path's most frequent: K3 = plain on "
        f"the card; K3 {at_path['ms']:.4f} ms, plain "
        f"{at_path['plain_ms']:.1f} ms")
    labelled = [("node path, most frequent", at_path)] + [
        ("verdicts" if rec is ver else "timed", rec)
        for B, rec in timed.items() if B != path_b]
    return [k3_row(label, rec, by_b.get(rec["B"], 0), card["launches"])
            for label, rec in labelled]


# -- after phase 10: the bench ledger and its regression gate ----------------


def _slug(label: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in label).strip("_")


def ledger_gate(arms, k3_rows, name_power: str) -> None:
    """The port's bench ledger and regression gate on the card's machine:
    ``host_info()`` must name the card (as torch and nvidia-smi do), torch
    and its CUDA build, and no jax; one record of phase 8's arms (tx/s,
    p50/p95, seconds to block 0) and phase 10's K3 ms is appended five times to a history in a
    temporary directory (never the repo's), read back with the same
    results, and gated: the gate passes on the five copies, and fails on
    ``inject_regression(..., 2.0)`` of them, through ``gate`` and through
    the command line (``--inject-regression``)."""
    import os
    import shutil
    import tempfile

    import torch

    from babble_tpu_torch.obs import ledger, perfgate

    info = ledger.host_info()
    card = torch.cuda.get_device_name(0)
    if ("jax" in info or info["card"] != card
            or info["torch"] != torch.__version__
            or info["cuda"] != torch.version.cuda
            or (name_power and not name_power.startswith(card))):
        raise AssertionError(f"[ledger] host_info {info} does not name the "
                             f"card {card!r} (nvidia-smi: {name_power!r}), "
                             f"torch {torch.__version__} and CUDA "
                             f"{torch.version.cuda}, or names jax")
    fields = {
        "nodes": {_slug(r["arm"]): {"tx_per_s": r["tx_per_s"],
                                    "p50_ms": r["p50_ms"],
                                    "p95_ms": r["p95_ms"],
                                    "block0_s": r["block0_s"]}
                  for r in arms},
        "k3": {_slug(r["name"]): {"k3_ms": r["ms"], "batch": r["shape"][0]}
               for r in k3_rows},
    }
    rec = ledger.make_record("chip_smoke", fields,
                             config={"nodes": NODES, "window_s": WINDOW_S})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ledger_")
    try:
        path = os.path.join(tmp, ledger.HISTORY_BASENAME)
        for _ in range(5):
            if ledger.append(rec, path) != path:
                raise AssertionError("[ledger] the ledger is disabled "
                                     "(BABBLE_BENCH_LEDGER=0)")
        recs = ledger.read(path)
        if (len(recs) != 5 or any(ledger.results_map(r)
                                  != ledger.results_map(rec) for r in recs)):
            raise AssertionError(f"[ledger] read back {len(recs)} records, "
                                 "not the five appended")
        current = recs[-1]
        base = perfgate.baseline_for(recs, current, perfgate.DEFAULT_WINDOW)
        verdict = perfgate.gate(current, base)
        bad = perfgate.inject_regression(current, 2.0, base)
        bad_verdict = perfgate.gate(bad, base)
        cli_ok = perfgate.main(["--history", path])
        cli_bad = perfgate.main(["--history", path, "--inject-regression",
                                 "--inject-factor", "2.0"])
        if not verdict["ok"] or verdict["checked"] == 0 or cli_ok != 0:
            raise AssertionError(f"[ledger] the gate fails five copies of "
                                 f"one record: {verdict}, exit {cli_ok}")
        if bad_verdict["ok"] or cli_bad != 1:
            raise AssertionError(f"[ledger] the gate passes an injected "
                                 f"regression: {bad_verdict}, exit {cli_bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[ledger] host: {json.dumps(info)}")
    log(f"[ledger] record ({len(rec['results'])} metrics, results_map "
        f"round-trips through the history): "
        f"{json.dumps(ledger.results_map(rec))}")
    log(f"[ledger] perfgate over five copies: ok, {verdict['checked']} "
        f"gated metrics, {verdict['baseline_runs']} baseline runs, exit "
        f"{cli_ok}; inject_regression(2.0): "
        f"{len(bad_verdict['regressions'])} regressions "
        f"({sum(r['severity'] == 'hard' for r in bad_verdict['regressions'])}"
        f" hard), exit {cli_bad}")


# Run in a tree of the repo (this one or an earlier commit's) by
# -- phase 11: the mesh --------------------------------------------------------

# shards of the virtual mesh: N entries that all name the one card
MESH_N = 4
# rectangular K1 (V, W, P, S) at the sharded sweep's shapes at N = 4: a
# 128-witness bucket of 16 validators and a 256 one of 64 with two slots;
# and one batched launch (B, V, W, P, S)
K1_RECT_SHAPES = [(32, 128, 16, 1), (64, 256, 64, 2), (4, 64, 256, 64, 2)]
# K2's block form (B, X, Y, P, ldo, col0) at the shapes the collectives
# launch it at on a mesh of n = 2, 4 and 8 shards: a sharded_strongly_see
# shard of the (4096, 64) window, and of (4096, 16) at n 4; one ring step's
# block, written at a column offset of a 4096-wide row; a shard of
# sharded_batched_pipeline on phase 6's batch of 8 (512, 16) windows at
# (dp 2, sp 2) and (dp 1, sp 4). Each with the path and n that launch it.
K2_BLOCK_SHAPES = [
    ((1, 2048, 4096, 64, 4096, 0), "sharded_strongly_see shard, n 2"),
    ((1, 1024, 4096, 64, 4096, 0), "sharded_strongly_see shard, n 4"),
    ((1, 512, 4096, 64, 4096, 0), "sharded_strongly_see shard, n 8"),
    ((1, 1024, 4096, 16, 4096, 0),
     "sharded_strongly_see shard of (4096, 16), n 4"),
    ((1, 2048, 2048, 64, 4096, 2048), "ring step, n 2"),
    ((1, 1024, 1024, 64, 4096, 2048), "ring step, n 4"),
    ((1, 512, 512, 64, 4096, 3584), "ring step, n 8"),
    ((4, 256, 512, 16, 512, 0), "sharded_batched_pipeline shard, dp 2 sp 2"),
    ((8, 128, 512, 16, 512, 0), "sharded_batched_pipeline shard, dp 1 sp 4"),
]
# the 16-validator mesh replays sync 32 events at a time: a 64-event sync
# outgrows the resident delta bucket (max(32, E/8) rows) and uploads the
# whole window, so that phase 3 never takes the delta path
MESH_SYNC_16 = 32
# the second validator of the coprocessor lane: its own stream and peers
COPRO_PEERS = 12
COPRO_EVENTS = 2048


def mesh_devices(n: int) -> list:
    """``n`` shard entries that all name the card: virtual shards."""
    import torch

    return [torch.device("cuda", 0)] * n


def virtual_mesh(n: int, dp=None):
    """A (dp, sp) mesh of ``n`` virtual shards."""
    from babble_tpu_torch.parallel import consensus_mesh

    return consensus_mesh(n, dp=dp, devices=mesh_devices(n))


def check_k1_rect(shape, seed: int) -> dict:
    """Rectangular K1, V voter rows against W candidates, equal to its
    plain version on random and on edge-value coordinates, and timed;
    ``shape`` is (V, W, P, S) or (B, V, W, P, S)."""
    import torch

    from babble_tpu_torch.ops import kernels

    *batch, V, W, P, S = shape
    random_in = k1_inputs(W, P, S, seed, *batch)
    edge_in = tuple(torch.from_numpy(a).cuda()
                    for a in k1_edge_inputs(W, P, S, seed, *batch))
    for la, fd, member in (random_in, edge_in):
        la = la[..., :V, :].contiguous()
        got = kernels.member_ss_counts(la, fd, member)
        want = kernels.member_ss_counts_plain(la, fd, member)
        torch.cuda.synchronize()
        if tuple(got.shape) != (*batch, S, V, W) or not torch.equal(got,
                                                                    want):
            raise AssertionError(f"K1 rectangular {shape}: "
                                 f"{int((got != want).sum())} counts differ "
                                 "from plain")
    la, fd, member = random_in
    la = la[..., :V, :].contiguous()
    ms = time_on_device(lambda: kernels.member_ss_counts(la, fd, member))
    plain_ms = time_on_device(
        lambda: kernels.member_ss_counts_plain(la, fd, member), reps=20)
    bound_ms, bound_by = k1_bound_ms(W, P, S, V)
    bound_ms *= batch[0] if batch else 1
    return {"shape": list(shape), "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def k2_block_inputs(shape, seed: int) -> list:
    """K2's block form at ``shape`` (B, X, Y, P, ldo, col0): (la, fd, sm,
    out) on random coordinates and on edge-value coordinates (la [X, P]
    against fd [Y, P], or a batch of B), with ``out`` a random bool [X,
    ldo] (or [B, X, ldo]) whose columns outside the block must survive."""
    import numpy as np
    import torch

    B, X, Y, P, ldo, col0 = shape
    n = max(X, Y)
    lead = (B,) if B > 1 else ()
    la, fd = k2_inputs(B, n, P, seed)
    la_e, fd_e = (torch.from_numpy(a).cuda()
                  for a in edge_coordinates((*lead, n, P), seed))
    sm_e = edge_super_majority(la_e.cpu().numpy(), fd_e.cpu().numpy())
    out = torch.from_numpy(
        np.random.RandomState(seed).rand(*lead, X, ldo) < 0.5).cuda()
    return [(a[..., :X, :].contiguous(), f[..., n - Y:, :].contiguous(), t,
             out)
            for a, f, t in ((la, fd, 2 * P // 3 + 1), (la_e, fd_e, sm_e))]


def check_k2_block(shape, seed: int, tile=None, inputs=None,
                   plain: bool = True) -> dict:
    """K2's block form at ``shape`` (B, X, Y, P, ldo, col0) and at ``tile``
    (one of ``kernels.K2_TILES``; the tile the C entry picks where None)
    equal to its plain version (the whole output, the columns it must not
    touch included) on random and on edge-value coordinates, and timed on
    the random ones (its plain version too, with ``plain``)."""
    import torch

    from babble_tpu_torch.ops import kernels

    B, X, Y, P, ldo, col0 = shape
    inputs = inputs or k2_block_inputs(shape, seed)
    for a, f, t, before in inputs:
        got = kernels._strongly_see_block_at(tile, a, f, t, before.clone(),
                                             col0)
        want = kernels.strongly_see_block_plain(a, f, t, before.clone(), col0)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 block {shape} tile {tile}: "
                                 f"{int((got != want).sum())} entries differ "
                                 "from plain")
    a, f, sm, before = inputs[0]
    out = before.clone()
    ms = time_on_device(lambda: kernels._strongly_see_block_at(
        tile, a, f, sm, out, col0))
    plain_ms = time_on_device(
        lambda: kernels.strongly_see_block_plain(a, f, sm, out, col0),
        reps=20) if plain else None
    bound_ms, bound_by = k2_bound_ms(B, X, P, Y)
    return {"shape": list(shape), "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tile": tile or kernels.strongly_see_block_tile(X, Y, B)}


def mesh_replay(label, events, peers, want, n: int, peer_sets=(),
                sync=SYNC_EVENTS) -> dict:
    """The stream through TensorConsensus on the card (resident windows,
    no batcher, min_window 0), on a virtual mesh of ``n`` shards, or on one
    device where ``n`` is 0: consensus equal to the oracle's ``want``, no
    fallback, and on a mesh no mesh fallback, delta sweeps, and K1 launches
    equal to n x sweeps (counted from 0 for this run)."""
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.ops import kernels

    arm = f"N {n}" if n else "single device"
    accel = TensorConsensus(device="cuda", batcher=False, resident=True,
                            min_window=0,
                            mesh=virtual_mesh(n) if n else None)
    kernels.reset_launch_counts()
    h, wall = replay(events, peers, accel=accel, peer_sets=peer_sets,
                     sync=sync)
    launches = kernels.launch_counts()["member_ss_counts"]
    got = consensus_state(h)
    for i, what in enumerate(("events", "rounds/fame", "blocks",
                              "undetermined")):
        if got[i] != want[i]:
            raise AssertionError(f"[mesh {label}/{arm}] {what} differ from "
                                 "the host oracle")
    st = accel.stats()
    if accel.fallbacks or accel.sweeps <= 0:
        raise AssertionError(f"[mesh {label}/{arm}] fallbacks "
                             f"{accel.fallbacks}, sweeps {accel.sweeps}")
    if launches != max(n, 1) * accel.sweeps:
        raise AssertionError(f"[mesh {label}/{arm}] K1 launches {launches} "
                             f"!= {max(n, 1)} x sweeps {accel.sweeps}")
    if n and (accel.mesh_fallbacks or accel.delta_sweeps <= 0):
        raise AssertionError(f"[mesh {label}/{arm}] mesh fallbacks "
                             f"{accel.mesh_fallbacks}, delta sweeps "
                             f"{accel.delta_sweeps}")
    per = per_sweep_stages(accel)
    log(f"[mesh {label}/{arm}] blocks identical to the oracle "
        f"({len(want[2])}); accel_mesh {st['accel_mesh']}, sweeps "
        f"{accel.sweeps}, delta sweeps {accel.delta_sweeps}, K1 launches "
        f"{launches}, mesh_fallbacks {accel.mesh_fallbacks}, mesh_pad_rows "
        f"{accel.mesh_pad_rows}; ms per sweep: dispatch "
        f"{per['dispatch']:.3f}, kernel (device span) {per['kernel']:.3f}; "
        f"{len(events) / wall:.1f} events/s ({wall:.3f} s, syncs of {sync})")
    shapes = Counter()
    for (W, _E, P, S, _R), k in accel.buckets.items():
        shapes[(W // max(n, 1), W, P, S)] += k
    return {"arm": arm, "launches": launches, "per_sweep_ms": per,
            "shapes": shapes}


def copro_lane(events_a, peers_a, want_a, seed: int) -> dict:
    """The coprocessor lane on the card: two TensorConsensus with the
    batcher on (pipelined, resident snapshots, min_window 0) on one virtual
    mesh of MESH_N shards, replaying two streams at once (the 16-validator
    one and a COPRO_PEERS-validator one), one sync of each, then both
    flushes while the batcher's dispatcher is held, so that both windows
    land in one wave. Each equals its oracle; the lane ran waves, at least
    one serving two windows; K1 launched MESH_N times a window served."""
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.ops import kernels

    events_b, _keys, peers_b = gossip_stream(COPRO_PEERS, COPRO_EVENTS, seed)
    oracle_b, oracle_s = replay(events_b, peers_b)
    want_b = consensus_state(oracle_b)
    log(f"[copro] second stream: {len(events_b)} events at {COPRO_PEERS} "
        f"validators, oracle {oracle_s:.2f} s (set-up)")
    mesh = virtual_mesh(MESH_N)
    svc = SweepBatcher.instance()
    base = svc.stats()
    runs = []
    for name, events, peers in (("a", events_a, peers_a),
                                ("b", events_b, peers_b)):
        h = Hashgraph(InmemStore(1_000_000))
        h.init(peers)
        h.accel = TensorConsensus(device="cuda", batcher=True, min_window=0,
                                  pipeline=True, mesh=mesh,
                                  owner=f"copro-{name}")
        runs.append((h, events))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps = max(len(e) for _h, e in runs)
    for b in range(0, steps, SYNC_EVENTS):
        for h, events in runs:
            for ev in events[b:b + SYNC_EVENTS]:
                h.insert_event_and_run_consensus(
                    Event(ev.body, ev.signature), set_wire_info=True)
        with svc._lock:  # both submissions queue before the wave is taken
            for h, _events in runs:
                h.flush_consensus()
    deadline = time.monotonic() + DRAIN_S
    while any(h.accel.busy() for h, _e in runs):
        if time.monotonic() > deadline:
            raise AssertionError("[copro] pipelined sweeps never drained")
        time.sleep(0.001)
        for h, _events in runs:
            h.flush_consensus()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["member_ss_counts"]
    for (h, _e), want, name in zip(runs, (want_a, want_b), "ab"):
        got = consensus_state(h)
        for i, what in enumerate(("events", "rounds/fame", "blocks",
                                  "undetermined")):
            if got[i] != want[i]:
                raise AssertionError(f"[copro/{name}] {what} differ from its "
                                     "oracle")
        if h.accel.fallbacks or h.accel.sweeps <= 0:
            raise AssertionError(f"[copro/{name}] fallbacks "
                                 f"{h.accel.fallbacks}, sweeps "
                                 f"{h.accel.sweeps}")
    s = svc.stats()
    waves = s["copro_waves"] - base["copro_waves"]
    windows = s["copro_windows"] - base["copro_windows"]
    if waves < 1 or s["copro_max"] < 2 or s["copro_validators"] < 2:
        raise AssertionError(f"[copro] waves {waves}, most windows a wave "
                             f"{s['copro_max']}, validators "
                             f"{s['copro_validators']}")
    if launches != MESH_N * windows:
        raise AssertionError(f"[copro] K1 launches {launches} != {MESH_N} x "
                             f"windows {windows}")
    log(f"[copro] two validators on one {MESH_N}-shard mesh: each equals its "
        f"oracle; {waves} waves served {windows} windows (at most "
        f"{s['copro_max']} a wave), validators {s['copro_validators']}, K1 "
        f"launches {launches}; sweeps {[h.accel.sweeps for h, _e in runs]}, "
        f"{wall:.2f} s")
    return {"waves": waves, "windows": windows, "launches": launches}


def mesh_collectives(batch_arrays, batch_sm, seed: int) -> Counter:
    """On virtual meshes of 2, 4 and 8 shards: sharded_strongly_see and
    ring_strongly_see equal to K2 at (4096, 64), sharded_strongly_see at 4
    shards to K2 at (4096, 16), sharded_vote_counts to the plain tally, and
    sharded_batched_pipeline at (dp 2, sp 2) and (dp 1, sp 4) to
    batched_pipeline on phase 6's batch of 8. Returns K2's block-form
    launches by the shape of K2_BLOCK_SHAPES they were made at (counted
    from 0 here)."""
    import torch

    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.parallel import (
        batched_pipeline,
        ring_mesh,
        ring_strongly_see,
        sharded_batched_pipeline,
        sharded_strongly_see,
        sharded_vote_counts,
    )

    import numpy as np

    at = Counter()  # block-form launches by (B, X, Y, P)

    def launched(key, fn):
        before = kernels.launch_counts()["strongly_see_block"]
        out = fn()
        at[key] += kernels.launch_counts()["strongly_see_block"] - before
        return out

    kernels.reset_launch_counts()
    E = 4096
    wants = {}
    for P, shards in ((64, (2, MESH_N, 8)), (16, (MESH_N,))):
        sm = 2 * P // 3 + 1
        la, fd = k2_inputs(1, E, P, seed + P)
        want = wants[P] = kernels.strongly_see(la, fd, sm)
        for n in shards:
            got = launched((1, E // n, E, P), lambda: sharded_strongly_see(
                virtual_mesh(n), sm)(la, fd))
            if not torch.equal(got, want):
                raise AssertionError(f"[mesh] sharded strongly-see at n {n} "
                                     f"differs from K2 at ({E}, {P})")
            if P != 64:
                continue
            ring = ring_mesh(n, devices=mesh_devices(n))
            got = launched((1, E // n, E // n, P),
                           lambda: ring_strongly_see(ring, sm)(la, fd))
            if not torch.equal(got, want):
                raise AssertionError(f"[mesh] ring strongly-see at n {n} "
                                     f"differs from K2 at ({E}, {P})")
    votes = wants[64][:, :E // 2]
    eligible = torch.from_numpy(
        np.random.RandomState(seed).rand(E) < 0.7).cuda()
    counts = sharded_vote_counts(virtual_mesh(MESH_N))(votes, eligible)
    if not torch.equal(counts, (votes & eligible[:, None]).sum(
            0, dtype=torch.int32)):
        raise AssertionError("[mesh] sharded vote counts differ")
    B, n_ev = batch_arrays[4].shape[:2]
    round_bound = n_ev // batch_sm + 2
    want_p = batched_pipeline(batch_sm, round_bound, device="cuda")(
        *batch_arrays)
    for dp in (2, 1):
        sp = MESH_N // dp
        grid = virtual_mesh(MESH_N, dp=dp)
        got_p = launched((B // dp, n_ev // sp, n_ev, batch_arrays[4].shape[2]),
                         lambda: sharded_batched_pipeline(
                             grid, batch_sm, round_bound)(*batch_arrays))
        for name, g, w in zip(("see", "ss", "packed"), got_p, want_p):
            if not torch.equal(g, w):
                raise AssertionError(f"[mesh] sharded pipeline at (dp {dp}, "
                                     f"sp {sp}) {name} differs")
    want_at = Counter()
    for n in (2, MESH_N, 8):
        want_at[(1, E // n, E, 64)] += n
        want_at[(1, E // n, E // n, 64)] += n * n
    want_at[(1, E // MESH_N, E, 16)] += MESH_N
    for dp in (2, 1):
        want_at[(B // dp, n_ev * dp // MESH_N, n_ev,
                 batch_arrays[4].shape[2])] += MESH_N
    if at != want_at:
        raise AssertionError(f"[mesh] K2 block launches {dict(at)}, want "
                             f"{dict(want_at)}")
    log(f"[mesh] on 2, 4 and 8 virtual shards: sharded_strongly_see and "
        f"ring_strongly_see equal K2 at ({E}, 64), and at ({E}, 16) on 4; "
        f"sharded_vote_counts equals the plain tally; "
        f"sharded_batched_pipeline at (dp 2, sp 2) and (dp 1, sp 4) equals "
        f"batched_pipeline on phase 6's batch of {B}; block launches by "
        f"(B, X, Y, P): {dict(at)}")
    return at


def k1_rect_tile(shape) -> int:
    """The tile side K1 takes at a rectangular (B,) V, W, P, S shape."""
    from babble_tpu_torch.ops import kernels

    *batch, V, W, _P, S = shape
    return kernels.member_ss_tile(W, S, batch[0] if batch else 1, V=V)


def mesh_phase(seed, streams, single_64, batch_arrays, batch_sm) -> list:
    """Phase 11. ``streams`` holds phases 3 and 4's (events, peers,
    peer_sets, oracle state); ``single_64`` phase 4's min_window 0 arm
    record (the same replay on one device). Returns the kernels-line rows
    of the rectangular K1 and of K2's block form."""
    from babble_tpu_torch.ops import kernels

    for i, shape in enumerate(K1_RECT_SHAPES):
        row = check_k1_rect(shape, seed + i)
        log(f"K1 rectangular (B,) V, W, P, S {shape}: equal to plain on "
            f"random and edge values; kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.3g} ms "
            f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of "
            f"bound, tile {k1_rect_tile(shape)}")
    k2_rows = []
    for i, (shape, what) in enumerate(K2_BLOCK_SHAPES):
        row = check_k2_block(shape, seed + 10 + i)
        k2_rows.append((row, what))
        log(f"K2 block B, X, Y, P, ldo, col0 {shape} ({what}): equal to "
            f"plain on random and edge values; kernel {row['ms']:.5f} ms, "
            f"plain {row['plain_ms']:.5f} ms, bound {row['bound_ms']:.3g} ms "
            f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of "
            f"bound, tile {row['tile']}")

    rows = []
    (ev16, peers16, _ps16, want16), (ev64, peers64, ps64, want64) = streams
    arms16 = [mesh_replay("16", ev16, peers16, want16, n, sync=MESH_SYNC_16)
              for n in (0, 1, MESH_N)]
    arms64 = [mesh_replay("64", ev64, peers64, want64, n, peer_sets=ps64)
              for n in (1, MESH_N)]
    for label, single, arms in (("16", arms16[0], arms16[1:]),
                                ("64", single_64, arms64)):
        log(f"[mesh {label}] ms per sweep, dispatch / kernel: single device "
            f"{single['per_sweep_ms']['dispatch']:.3f} / "
            f"{single['per_sweep_ms']['kernel']:.3f}; "
            + "; ".join(f"{a['arm']} {a['per_sweep_ms']['dispatch']:.3f} / "
                        f"{a['per_sweep_ms']['kernel']:.3f}" for a in arms)
            + " (virtual shards on one card: the host cost of the shard "
            "loop, not NVLink)")
        main = arms[-1]
        shape = max(main["shapes"], key=main["shapes"].get)
        row = check_k1_rect(shape, seed + 20 + len(rows))
        log(f"K1 rectangular at the {label}-validator N {MESH_N} path's most "
            f"frequent shard shape (V, W, P, S) {shape}: equal to plain; "
            f"kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
            f"bound {row['bound_ms']:.3g} ms ({row['bound_by']}); launches "
            f"{main['launches']}; shapes {dict(main['shapes'])}")
        rows.append({
            "name": f"member_ss_counts[rectangular, {label} validators, N "
                    f"{MESH_N} mesh sweep]",
            "route": "cuda",
            "source": "babble_tpu_torch/csrc/member_ss.cu",
            "replaces": "babble_tpu/parallel/voting_shard.py:84-86",
            "launches": main["launches"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": row["shape"],
            "launches_by_arm": {a["arm"]: a["launches"] for a in arms},
        })

    copro_lane(ev16, peers16, want16, seed + 30)
    blocks = mesh_collectives(batch_arrays, batch_sm, seed + 40)
    for row, what in k2_rows:
        B, X, Y, P, _ldo, col0 = row["shape"]
        rows.append({
            "name": f"strongly_see_block[{what}, B {B}, X {X}, Y {Y}, P {P}, "
                    f"col0 {col0}]",
            "route": "cuda",
            "source": "babble_tpu_torch/csrc/strongly_see.cu",
            "replaces": ("babble_tpu/parallel/pipeline.py:33" if B > 1 else
                         "babble_tpu/parallel/collectives.py:36-109"),
            "launches": blocks[(B, X, Y, P)],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": row["shape"],
            "tile": row["tile"],
            "launches_by_path": {" ".join(map(str, k)): v
                                 for k, v in sorted(blocks.items())},
        })
    return rows


# the square K2 rows of the kernel table, as block shapes (B, X, Y, P, ldo,
# col0)
K2_SQUARE_BLOCKS = [(B, E, E, P, E, 0) for B, E, P in K2_ROWS]


# the tiles of K2's block form: (rows, columns) of output a block and the
# blocks an SM each is compiled for, by the name in kernels.K2_TILES
K2_TILE_SHAPES = {"32x32": (32, 32, 4), "64x64": (64, 64, 4),
                  "64x128": (64, 128, 3), "128x128": (128, 128, 2)}


def k2_tile_rule(X: int, Y: int, B: int = 1) -> str:
    """The rule of ``bt_strongly_see_block_tile`` (csrc/strongly_see.cu) in
    Python, for the tests and the tile table: the tile K2's block form takes
    for B blocks of X rows against Y columns. The first tile, largest
    first, whose grid fills its share of one wave (H100_SMS x the tile's
    blocks an SM): 9/10 for the 128 tile, 1/2 for 64 x 128, 1/5 for 64 x
    64; else the 32 tile."""
    for tile, (num, den) in (("128x128", (9, 10)), ("64x128", (1, 2)),
                             ("64x64", (1, 5))):
        bm, bn, per_sm = K2_TILE_SHAPES[tile]
        blocks = -(-X // bm) * -(-Y // bn) * B
        if blocks * den >= num * H100_SMS * per_sm:
            return tile
    return "32x32"


def sass_counts(so: str) -> dict:
    """The SASS of every K2 kernel in the library ``so`` (``cuobjdump
    -sass``; names demangled where ``cu++filt`` is there): the instructions
    of its compare loop, from its first predicated FADD to its last, by
    opcode with modifiers, and their total."""
    import os
    import re
    import subprocess

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    text = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                           so], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "strongly_see_kernel" not in name:
            continue
        try:
            name = subprocess.run([os.path.join(cuda, "bin", "cu++filt"),
                                   name], capture_output=True, text=True,
                                  check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            pass
        ops = [re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?P[T0-9]\s+)?"
                        r"([A-Z][A-Z0-9_.]*)", line)
               for line in part.splitlines()]
        ops = [(bool(m.group(1)), m.group(2)) for m in ops if m]
        fadds = [i for i, (pred, op) in enumerate(ops)
                 if pred and op == "FADD"]
        loop = Counter(op for _, op in ops[fadds[0]:fadds[-1] + 1]
                       ) if fadds else Counter()
        out[name] = {"instructions": sum(loop.values()),
                     **dict(loop.most_common())}
    return out


def k2_tile_table(seed: int) -> list:
    """Every tile of ``kernels.K2_TILES`` at every block shape of
    K2_BLOCK_SHAPES and at the square K2 rows (K2_SQUARE_BLOCKS): each equal
    to the plain version on random and edge values, and timed. Prints a
    line a shape (each tile's ms, the fastest, the tile the C entry picks
    and its time over the fastest's), then the SASS counts of each K2
    kernel, and returns the records."""
    from babble_tpu_torch.ops import kernels

    recs = []
    shapes = [shape for shape, _ in K2_BLOCK_SHAPES] + K2_SQUARE_BLOCKS
    for i, shape in enumerate(shapes):
        B, X, Y, P, _ldo, _col0 = shape
        inputs = k2_block_inputs(shape, seed + i)
        ms = {tile: check_k2_block(shape, seed + i, tile, inputs,
                                   plain=False)["ms"]
              for tile in kernels.K2_TILES}
        best = min(ms, key=ms.get)
        pick = kernels.strongly_see_block_tile(X, Y, B)
        if pick != k2_tile_rule(X, Y, B):
            raise AssertionError(f"K2 block {shape}: the C entry picks "
                                 f"{pick}, its rule in Python "
                                 f"{k2_tile_rule(X, Y, B)}")
        bound_ms, bound_by = k2_bound_ms(B, X, P, Y)
        recs.append({"shape": list(shape), "ms": ms, "fastest": best,
                     "picked": pick, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        log(f"[k2 tiles] {shape}: "
            + ", ".join(f"{t} {m:.5f}" for t, m in ms.items())
            + f" ms; fastest {best}; picked {pick}, "
            f"{ms[pick] / ms[best]:.3f} x the fastest; bound "
            f"{bound_ms:.3g} ms ({bound_by}), the pick at "
            f"{bound_ms / ms[pick]:.1%} of it")
    for name, ops in sass_counts(kernels.build()).items():
        log(f"[k2 sass] {name}: {json.dumps(ops)}")
    print("K2TILES " + json.dumps(recs), flush=True)
    return recs


# -- phase 12: the mobile binding, in a fresh process ------------------------

MOBILE_TARGET_BLOCK = 3
MOBILE_TIMEOUT_S = 120.0
# two validators' windows stay below the offload's default min_window, and
# without the batcher K1's launches are the nodes' own device sweeps
MOBILE_ENV = {"BABBLE_ACCEL_MIN_WINDOW": "0", "BABBLE_ACCEL_BATCH": "0"}


def mobile_state_hash(block_json: str) -> bytes:
    """The host app's commit: a state hash over the block's index and
    transactions, from the JSON that crossed the binding."""
    import hashlib

    body = json.loads(block_json)["Body"]
    return hashlib.sha256(
        (str(body["Index"]) + str(body["Transactions"])).encode()).digest()


def mobile_child() -> None:
    """Two ``MobileNode``s with ``accelerator=True`` (the card) over
    loopback TCP on OS-assigned ports, fed transactions through
    ``submit_tx`` until both pass MOBILE_TARGET_BLOCK. Checks: identical
    block JSON at every index both hosts received, node 0's chain equal to
    a host replay of its own events through the same app, device sweeps
    and no fallback, and K1's launches (counted from 0 before the nodes
    start) equal to the device sweeps the nodes launched. Prints one
    ``MOBILE`` line of JSON for the parent."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from babble_tpu_torch.crypto.keyfile import SimpleKeyfile
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.mobile import MobileNode, _MobileApp
    from babble_tpu_torch.ops import kernels

    kernels.build()
    torch.cuda.init()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mobile_")
    gossip, service = free_ports(2), free_ports(2)
    keys = [generate_key() for _ in range(2)]
    peers = [{"NetAddr": f"127.0.0.1:{port}",
              "PubKeyHex": k.public_key.hex(), "Moniker": f"m{i}"}
             for i, (k, port) in enumerate(zip(keys, gossip))]
    committed, errors = [{}, {}], []

    def handler(i):
        def commit(block_json: str) -> bytes:
            committed[i][json.loads(block_json)["Body"]["Index"]] = block_json
            return mobile_state_hash(block_json)
        return commit

    kernels.reset_launch_counts()
    nodes = []
    try:
        t0 = time.perf_counter()
        for i, k in enumerate(keys):
            dd = os.path.join(tmp, f"m{i}")
            os.makedirs(dd)
            SimpleKeyfile(os.path.join(dd, "priv_key")).write_key(k)
            for fn in ("peers.json", "peers.genesis.json"):
                with open(os.path.join(dd, fn), "w") as f:
                    json.dump(peers, f)
            nodes.append(MobileNode(
                dd, handler(i), exception_handler=errors.append,
                bind_addr=f"127.0.0.1:{gossip[i]}",
                service_addr=f"127.0.0.1:{service[i]}",
                heartbeat_timeout=HEARTBEAT_S,
                slow_heartbeat_timeout=SLOW_HEARTBEAT_S,
                log_level="error", moniker=f"m{i}", accelerator=True))
        t_up = time.perf_counter() - t0
        for n in nodes:
            n.run()
        t0 = time.perf_counter()
        deadline = time.monotonic() + MOBILE_TIMEOUT_S
        j = 0
        while not all(n.get_last_block_index() >= MOBILE_TARGET_BLOCK
                      for n in nodes):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[mobile] last blocks "
                    f"{[n.get_last_block_index() for n in nodes]} after "
                    f"{MOBILE_TIMEOUT_S} s; errors {errors}")
            nodes[j % 2].submit_tx(f"mobile tx {j}".encode())
            j += 1
            time.sleep(0.01)
        t_blocks = time.perf_counter() - t0
        stats = [json.loads(n.get_stats()) for n in nodes]
    finally:
        stoppers = [threading.Thread(target=n.shutdown) for n in nodes]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=120)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["member_ss_counts"]
    for n in nodes:
        with n._engine.node.core_lock:  # a sync still in flight finishes
            pass
    accels = [n._engine.node.core.hg.accel for n in nodes]
    applied = sum(a.sweeps for a in accels)
    stale = sum(a.stale_drops for a in accels)
    in_flight = sum(a.busy() for a in accels)
    rec = {
        "blocks": [n.get_last_block_index() for n in nodes],
        "txs_submitted": j, "launches": launches, "sweeps": applied,
        "stale_drops": stale, "in_flight": in_flight,
        "fallbacks": sum(a.fallbacks for a in accels),
        "buckets": [[list(k), v] for k, v in
                    sum((a.buckets for a in accels), Counter()).items()],
        "seconds_up": t_up, "seconds_to_block": t_blocks,
    }
    common = sorted(set(committed[0]) & set(committed[1]))
    if len(common) < MOBILE_TARGET_BLOCK + 1 or errors:
        raise AssertionError(f"[mobile] the hosts received blocks "
                             f"{sorted(committed[0])} and "
                             f"{sorted(committed[1])}; errors {errors}")
    differ = [bi for bi in common if committed[0][bi] != committed[1][bi]]
    if differ:
        raise AssertionError(f"[mobile] block JSON differs at {differ}")
    for i, st in enumerate(stats):
        if (st["consensus_engine"] != "device" or st["accel_kernel"] != "cuda"
                or st["accel_sweeps"] <= 0 or st["accel_fallbacks"]):
            raise AssertionError(
                f"[mobile] node {i}: engine {st['consensus_engine']}, kernel "
                f"{st['accel_kernel']}, sweeps {st['accel_sweeps']}, "
                f"fallbacks {st['accel_fallbacks']}")
    if rec["fallbacks"] or launches != applied + stale + in_flight:
        raise AssertionError(
            f"[mobile] K1 launches {launches} != device sweeps launched "
            f"(applied {applied}, stale {stale}, in flight {in_flight}); "
            f"fallbacks {rec['fallbacks']}")
    t0 = time.monotonic()
    rec["replayed_events"] = replay_own_events(
        "mobile", nodes[0]._engine.node,
        app=_MobileApp(mobile_state_hash, None, None))
    rec["replay_s"] = time.monotonic() - t0
    rec["common_blocks"] = len(common)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[mobile] two MobileNodes (accelerator=True, the card) up in "
        f"{t_up:.1f} s, both past block {MOBILE_TARGET_BLOCK} in "
        f"{t_blocks:.1f} s ({j} transactions through submit_tx); identical "
        f"block JSON at all {len(common)} common indexes; node 0's chain "
        f"equal to a host replay of its {rec['replayed_events']} events "
        f"({rec['replay_s']:.2f} s); device sweeps {applied} (+{stale} "
        f"stale, {in_flight} in flight) = K1 launches {launches}; "
        f"fallbacks 0")
    print("MOBILE " + json.dumps(rec), flush=True)


def mobile_fresh() -> dict:
    """``mobile_child`` in a fresh interpreter with MOBILE_ENV. Returns its
    record, the buckets as a Counter of (W, E, P, S, R)."""
    rec = FreshChild("mobile_child()", "MOBILE", MOBILE_ENV, 300).result()
    rec["buckets"] = Counter({tuple(k): v for k, v in rec["buckets"]})
    return rec


# -- phase 13: static analysis and the lock graph on the card ----------------

# babblelint's three commands, each run as a subprocess from the checkout
LINT_COMMANDS = (
    ("babble_tpu_torch.analysis",),
    ("babble_tpu_torch.analysis", "--self-proof"),
    ("babble_tpu_torch.obs.lint", "docs/observability.md"),
)
LOCKCHECK_NODES = 4
LOCKCHECK_BLOCK = 3
# closed-loop load for this long, then until every node commits
# LOCKCHECK_BLOCK (phase 10's four nodes reach block 3 in 1.4-4.8 s)
LOCKCHECK_WARMUP_S = 2.0
LOCKCHECK_WINDOW_S = 4.0
# The recorder armed from the environment, as the reference's chaos soak
# arms it, and the offload on the card with the sweep batcher on. Every
# window goes to the card: at four validators none reaches the default
# min_window (192 events) before block 3, and a cluster that never sweeps
# never takes the batcher's lock.
LOCKCHECK_ENV = {"BABBLE_LOCKCHECK": "1", "BABBLE_ACCEL_BATCH": "1",
                 "BABBLE_ACCEL_MIN_WINDOW": "0"}
# Order edges that threads on the card take and the static lock pass cannot
# see, each with why. The JAX package's pass misses each on the JAX
# package's tree too (tests/test_torch_analysis.py); every other observed
# edge must be in the static set.
LOCK_EDGES_UNSEEN = {
    "core->batcher": (
        "a flush under the core lock reaches SweepBatcher.submit through "
        "hg.accel (Core -> Hashgraph -> TensorConsensus -> SweepBatcher); "
        "the pass resolves a call one hop, through its ATTR_TYPES "
        "convention table, which names no hg or accel attribute "
        "(analysis/lock_pass.py)"),
}


def lint_runs() -> dict:
    """babblelint over the checkout, its self-proof and the metrics lint,
    each in a fresh interpreter (this machine has no JAX): every one must
    exit 0. Returns the files linted, the passes that fired in the
    self-proof and the instruments matched."""
    import os
    import re
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for args in LINT_COMMANDS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=here,
                              capture_output=True, text=True, timeout=120)
        took = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[lint] python -m {' '.join(args)}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-2000:]}")
        text = proc.stdout
        if args[-1] == "--self-proof":
            out["self_proof_fired"] = len(re.findall(r": fired ", text))
        elif args[0].endswith(".lint"):
            out["instruments"] = int(re.search(
                r"metrics lint ok: (\d+) instruments", text).group(1))
        else:
            out["files"] = int(re.search(
                r"babblelint ok: (\d+) files clean", text).group(1))
        log(f"[lint] python -m {' '.join(args)}: exit 0 in {took:.2f} s: "
            f"{text.strip().splitlines()[-1]}")
    log(f"[lint] violations 0 over {out['files']} files; self-proof "
        f"{out['self_proof_fired']} of 5 fired; {out['instruments']} "
        "instruments match docs/observability.md")
    return out


def lockcheck_child() -> None:
    """Phase 13's cluster, in a process of its own whose environment arms
    the recorder: LOCKCHECK_NODES port Nodes over loopback TCP (phase 8's
    ``tcp_cluster`` settings) with the offload on the card and the sweep
    batcher on, under closed-loop load until every node has committed
    LOCKCHECK_BLOCK. ``cluster_arm`` checks identical blocks, node 0 = a
    host replay, no fallback and K1's launches = the batcher's sweeps; here
    the batcher's lock must be the named ``batcher``, every node must
    report 0 inversions, ``batcher`` must be among the locks observed, and
    every observed edge must be in the static lock pass's set or in
    LOCK_EDGES_UNSEEN (and no edge there in the static set). Prints one
    ``LOCKCHECK`` line of JSON for the parent."""
    import torch

    from babble_tpu_torch.analysis.core import load_tree
    from babble_tpu_torch.analysis.lock_pass import static_edges
    from babble_tpu_torch.common import lockcheck
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.ops import kernels

    if not lockcheck.ENABLED:
        raise AssertionError("[lockcheck] BABBLE_LOCKCHECK is not armed")
    kernels.build()
    torch.cuda.init()
    lock = SweepBatcher.instance()._lock
    if getattr(lock, "name", None) != "batcher":
        raise AssertionError(f"[lockcheck] the batcher's lock {lock!r} does "
                             "not report to the recorder as 'batcher'")
    t0 = time.perf_counter()
    static = static_edges(load_tree())
    static_s = time.perf_counter() - t0
    rec = cluster_arm("lockcheck", True, {}, n=LOCKCHECK_NODES,
                      warmup_s=LOCKCHECK_WARMUP_S,
                      window_s=LOCKCHECK_WINDOW_S,
                      require_batched=False, settle_block=LOCKCHECK_BLOCK)
    if rec["common_block"] < LOCKCHECK_BLOCK:
        raise AssertionError(f"[lockcheck] common block "
                             f"{rec['common_block']} < {LOCKCHECK_BLOCK}")
    if rec["sweeps"] <= 0 or not rec["batcher"]:
        raise AssertionError(f"[lockcheck] sweeps {rec['sweeps']}, batcher "
                             f"{rec['batcher']}: the batcher never swept")
    observed = lockcheck.RECORDER.edge_list()
    inversions = lockcheck.RECORDER.inversions()
    locks = sorted({x for e in observed for x in e.split("->")})
    unseen = sorted(set(observed) - set(static))
    if inversions or any(rec["lock_order_inversions"]):
        raise AssertionError(f"[lockcheck] inversions {inversions}; per "
                             f"node {rec['lock_order_inversions']}")
    if "batcher" not in locks:
        raise AssertionError(f"[lockcheck] 'batcher' not among the observed "
                             f"locks {locks} (edges {observed})")
    if set(unseen) - set(LOCK_EDGES_UNSEEN):
        raise AssertionError(f"[lockcheck] observed edges "
                             f"{sorted(set(unseen) - set(LOCK_EDGES_UNSEEN))}"
                             f" are neither in the static set {static} nor "
                             "named in LOCK_EDGES_UNSEEN")
    if set(LOCK_EDGES_UNSEEN) & set(static):
        raise AssertionError(f"[lockcheck] LOCK_EDGES_UNSEEN names edges the "
                             f"static pass sees: "
                             f"{sorted(set(LOCK_EDGES_UNSEEN) & set(static))}")
    out = {k: rec[k] for k in (
        "common_block", "launches", "expected_launches", "sweeps",
        "stale_drops", "in_flight", "fallbacks", "replayed_events",
        "lock_order_inversions", "tx_per_s", "settle_s", "shutdown_s")}
    out.update(
        observed=observed, static=static, unseen=unseen, locks=locks,
        static_s=static_s, wave=rec["wave"],
        sweep_shapes=[[list(k), v] for k, v in rec["sweep_shapes"].items()])
    log(f"[lockcheck] {LOCKCHECK_NODES} nodes (BABBLE_LOCKCHECK=1, the card, "
        f"the batcher) to block {rec['common_block']}: identical blocks, "
        f"node 0 = host replay of {rec['replayed_events']} events, fallbacks "
        f"0; K1 launches {rec['launches']} = the batcher's sweeps "
        f"{rec['expected_launches']} ({rec['wave']['batch_batches']} batched,"
        f" {rec['wave']['batch_singles']} single); inversions per node "
        f"{rec['lock_order_inversions']}; locks observed {locks}")
    log(f"[lockcheck] observed edges {observed}; static edges {static} "
        f"({static_s:.2f} s); observed outside the static set {unseen}, "
        f"each named: " + "; ".join(
            f"{e}: {LOCK_EDGES_UNSEEN[e]}" for e in unseen))
    print("LOCKCHECK " + json.dumps(out), flush=True)


def lockcheck_fresh() -> dict:
    """``lockcheck_child`` in a fresh interpreter with LOCKCHECK_ENV (the
    recorder is armed at import, and named locks are chosen when they are
    built). Returns its record, the batcher's sweep shapes as a Counter of
    (B, W, P, S)."""
    rec = FreshChild("lockcheck_child()", "LOCKCHECK", LOCKCHECK_ENV,
                     300).result()
    rec["sweep_shapes"] = Counter({tuple(k): v
                                   for k, v in rec["sweep_shapes"]})
    return rec


def static_analysis_phase(name_power: str, seed: int) -> dict:
    """Phase 13: the lint runs, then the lock-checked cluster; returns the
    kernels-line row of K1 at the shape the cluster's batcher swept most
    often (a single sweep's (1, W, P, S) as (W, P, S))."""
    t0 = time.perf_counter()
    lint = lint_runs()
    rec = lockcheck_fresh()
    shapes = Counter()
    for (B, W, P, S), n in rec["sweep_shapes"].items():
        shapes[(W, P, S) if B == 1 else (B, W, P, S)] += n
    row = k1_row("lock-checked cluster", shapes,
                 {"lockcheck": rec["launches"]}, "lockcheck", seed=seed)
    log(f"[lockcheck] phase 13: {time.perf_counter() - t0:.1f} s; lint "
        f"{lint}; {name_power or 'nvidia-smi: not available'}")
    return row


# -- phase 14: membership churn (BASELINE config 4) ---------------------------

# (a) the replayed stream: CHURN_VALIDATORS genesis validators, then a join,
# a leave, a join and a leave at consecutive rounds, so that windows across
# them carry three peer-set slots or more (S 4 after the bucket); long
# enough for CHURN_MIN_BLOCKS blocks received after the last change
CHURN_VALIDATORS = 64
CHURN_EVENTS = 7168
CHURN_CHANGES = (("join", 2), ("leave", 3), ("join", 4), ("leave", 5))
CHURN_MIN_BLOCKS = 2
# the four arms of (a): TensorConsensus options on the card beside
# min_window 0 and resident windows; "mesh" is the number of virtual shards
CHURN_ARMS = (
    ("resident sync", {"pipeline": False}),
    ("pipelined", {"pipeline": True}),
    ("batcher", {"pipeline": True, "batcher": True}),
    (f"mesh N {MESH_N}", {"pipeline": True, "mesh": MESH_N}),
)
# The golden dynamic-membership fixtures of the JAX package's
# tests/test_hashgraph_dyn.py (from the reference's hashgraph_dyn_test.go):
# plays are (creator, index, self-parent, other-parent, name, transactions,
# block signatures), as that file has them; R3 names the joiner's empty
# self-parent. Changes are (round, "add" or "remove", key).
DYN_R2_1 = [
    (1, 1, "w01", "w00", "e10", [b"e10"], None),
    (2, 1, "w02", "e10", "e21", [b"e21"], None),
    (0, 1, "w00", "e21", "e12", [b"e12"], None),
    (1, 2, "e10", "e12", "w11", [b"w11"], None),
    (2, 2, "e21", "w11", "w12", [b"w12"], None),
    (0, 2, "e12", "w12", "w10", [b"w10"], None),
    (1, 3, "w11", "w10", "f10", [b"f10"], None),
    (2, 3, "w12", "f10", "w22", [b"w22"], None),
    (0, 3, "w10", "w22", "w20", [b"w20"], None),
    (1, 4, "f10", "w20", "w21", [b"w21"], None),
    (2, 4, "w22", "w21", "g21", [b"g21"], None),
]
DYN_R2_2 = [
    (3, 0, "R3", "g21", "w33", [b"w33"], None),
    (0, 4, "w20", "w33", "w30", [b"w30"], None),
    (1, 5, "w21", "w30", "w31", [b"w31"], None),
    (2, 5, "g21", "w31", "w32", [b"w32"], None),
    (3, 1, "w33", "w32", "w43", [b"w43"], None),
    (0, 5, "w30", "w43", "w40", [b"w40"], None),
    (1, 6, "w31", "w40", "w41", [b"w41"], None),
    (2, 6, "w32", "w41", "w42", [b"w42"], None),
]
DYN_R2_3 = [
    (3, 2, "w43", "w42", "w53", [b"w53"], None),
    (2, 7, "w42", "w53", "w52", [b"w52"], None),
    (1, 7, "w41", "w52", "w51", [b"w51"], None),
    (3, 3, "w53", "w51", "j31", [b"j31"], None),
    (2, 8, "w52", "j31", "w62", [b"w62"], None),
    (1, 8, "w51", "w62", "w61", [b"w61"], None),
    (3, 4, "j31", "w61", "w63", [b"w63"], None),
    (2, 9, "w62", "w63", "h23", [b"h23"], None),
    (1, 9, "w61", "h23", "w71", [b"w71"], None),
]
DYN_USURPER_2 = [
    (0, 4, "w20", "g21", "w30", [b"w30"], None),
    (1, 5, "w21", "w30", "w31", [b"w31"], None),
    (2, 5, "g21", "w31", "w32", [b"w32"], None),
    (3, 0, "R3", "w32", "x32", [b"x32"], None),
    (0, 5, "w30", "x32", "h03", [b"h03"], None),
    (1, 6, "w31", "h03", "w41", [b"w41"], None),
]
DYN_MONOLOGUE = [
    (0, 1, "w00", "", "w10", [b"w10"], None),
    (0, 2, "w10", "", "w20", [b"w20"], None),
    (0, 3, "w20", "", "w30", [b"w30"], None),
    (0, 4, "w30", "", "w40", [b"w40"], None),
    # the reference fixture's own payload: b"w40", not b"w50"
    (0, 5, "w40", "", "w50", [b"w40"], None),
    (0, 6, "w50", "", "w60", [b"w60"], None),
    (0, 7, "w60", "", "w70", [b"w70"], None),
    (0, 8, "w70", "", "w80", [b"w80"], None),
]
# name -> (genesis validators, keys, plays, changes)
DYN_FIXTURES = {
    "r2dyn": (3, 4, DYN_R2_1 + DYN_R2_2 + DYN_R2_3,
              [(2, "add", 3), (5, "remove", 0)]),
    "usurper": (3, 4, DYN_R2_1 + DYN_USURPER_2, [(10, "add", 3)]),
    "monologue": (1, 1, DYN_MONOLOGUE, []),
}
# (b) the live cluster: phase 8's settings, with every window on the card
# (at the default min_window of 192 events a 16-validator window reaches
# the card only when a flush is backed up, and the checks need sweeps
# across the peer-set changes and after the fast-sync's reset)
CHURN_NODES = 16
CHURN_ENV = {"BABBLE_ACCEL_MIN_WINDOW": "0"}
CHURN_CADENCE_S = 5.0  # config 4: a membership change every 5 s
CHURN_LIVE = ("join", "leave", "join", "leave", "fast-sync join")
CHURN_JOIN_TIMEOUT_S = 120.0  # a join's or leave's wait for consensus
CHURN_CHANGE_S = 120.0  # the most one change may take to commit
CHURN_SETTLE_S = 120.0
# the most (b)'s process and the whole of phase 14 may take
CHURN_LIVE_TIMEOUT_S = 900
CHURN_TIMEOUT_S = 600
# (c) windows of the replayed stream tried in turn, smallest first, until
# the sweep over one is still running on the card when invalidate() comes
RESET_WINDOWS = (1792, 7168)
# where no window keeps its sweep running, the sleep kernel queued on the
# offload's stream between a sweep and its copy-out (about 0.1 s at 1.98
# GHz)
RESET_BUSY_CYCLES = 200_000_000
# (d) the breaker on the card: injected failures (its threshold) and its
# cooldown, over a 16-validator stream of BREAKER_EVENTS
BREAKER_N = 3
BREAKER_COOLDOWN_S = 0.5
BREAKER_EVENTS = 512


def dyn_fixture(name: str, seed: int):
    """A golden dynamic-membership fixture (DYN_FIXTURES) built from port
    classes with seeded keys: (events in insert order, the genesis
    peer-set, [(round, peer-set)] of its changes)."""
    from babble_tpu_torch.crypto.keys import PrivateKey
    from babble_tpu_torch.crypto.secp256k1 import N as CURVE_N
    from babble_tpu_torch.hashgraph.event import Event
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet

    n0, n_keys, plays, changes = DYN_FIXTURES[name]
    rng = random.Random(f"{name}-{seed}")
    keys = [PrivateKey(rng.randrange(1, CURVE_N)) for _ in range(n_keys)]
    peer = [Peer("", k.public_key.hex(), "") for k in keys]
    index = {"": "", "R3": ""}
    events = []

    def add(e, k, name_):
        e.sign(keys[k])
        index[name_] = e.hex()
        events.append(e)

    for i in range(n0):
        add(Event.new([f"w0{i}".encode()], [], [], ["", ""],
                      keys[i].public_key.bytes(), 0), i, f"w0{i}")
    for to, idx, sp, op, name_, txs, sigs in plays:
        add(Event.new([bytes(t) for t in txs or []], [], list(sigs or []),
                      [index[sp], index[op]], keys[to].public_key.bytes(),
                      idx), to, name_)
    genesis = PeerSet(peer[:n0])
    ps, peer_sets = genesis, []
    for rnd, kind, k in changes:
        ps = (ps.with_new_peer(peer[k]) if kind == "add"
              else ps.with_removed_peer(peer[k]))
        peer_sets.append((rnd, ps))
    return events, genesis, peer_sets


def churn_replay(label, events, peers, peer_sets, want, sync: int,
                 sweep_events=None) -> dict:
    """One stream through every arm of CHURN_ARMS on the card (resident
    windows, min_window 0): K1's launches counted from 0 for each arm must
    equal its device sweeps (the batcher's sweeps, N x the sweeps on the
    mesh), with no fallback, no mesh fallback and nothing in flight; the
    arms' consensus is held against ``want()`` (an oracle's
    consensus_state) once every arm has run. Returns the arms' records and
    K1's launch shapes: ("square", W, P, S), ("batch", B, W, P, S) or
    ("rect", V, W, P, S)."""
    import torch

    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.ops import kernels

    batcher = SweepBatcher.instance()
    arms, states, shapes = [], [], Counter()
    for arm, opts in CHURN_ARMS:
        opts = dict(opts)
        n = opts.pop("mesh", 0)
        accel = TensorConsensus(device="cuda", min_window=0, resident=True,
                                batcher=opts.pop("batcher", False),
                                mesh=virtual_mesh(n) if n else None, **opts)
        if sweep_events is not None:
            accel.sweep_events = sweep_events
        b0, s0 = batcher.stats(), Counter(batcher.sweep_shapes)
        kernels.reset_launch_counts()
        h, wall = replay(events, peers, accel=accel, peer_sets=peer_sets,
                         sync=sync)
        deadline = time.monotonic() + DRAIN_S
        while not batcher.idle():
            if time.monotonic() > deadline:
                raise AssertionError(f"[churn {label}/{arm}] the sweep "
                                     "batcher never went idle")
            time.sleep(0.01)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["member_ss_counts"]
        states.append(consensus_state(h))
        del h
        launched = accel.sweeps + accel.stale_drops
        if accel.batcher:
            b1 = batcher.stats()
            expected = (b1["batch_batches"] - b0["batch_batches"]
                        + b1["batch_singles"] - b0["batch_singles"])
            for (B, W, P, S), k in (Counter(batcher.sweep_shapes)
                                    - s0).items():
                shapes[("batch", B, W, P, S) if B > 1
                       else ("square", W, P, S)] += k
        else:
            expected = max(n, 1) * launched
            for (W, _E, P, S, _R), k in accel.buckets.items():
                shapes[("rect", W // n, W, P, S) if n
                       else ("square", W, P, S)] += max(n, 1) * k
        if accel.fallbacks or accel.mesh_fallbacks or accel.busy():
            raise AssertionError(f"[churn {label}/{arm}] fallbacks "
                                 f"{accel.fallbacks}, mesh fallbacks "
                                 f"{accel.mesh_fallbacks}, in flight "
                                 f"{accel.busy()}")
        if accel.sweeps <= 0 or launches != expected:
            raise AssertionError(f"[churn {label}/{arm}] K1 launches "
                                 f"{launches} != {expected}, the device "
                                 f"sweeps ({accel.sweeps} applied, "
                                 f"{accel.stale_drops} stale)")
        max_s = max(k[3] for k in accel.buckets)
        arms.append({"arm": arm, "launches": launches, "sweeps": accel.sweeps,
                     "max_s": max_s, "seconds": wall})
        log(f"[churn {label}/{arm}] sweeps {accel.sweeps}, stale drops "
            f"{accel.stale_drops}, K1 launches {launches}, slots up to "
            f"{max_s} (buckets W,E,P,S,R: "
            f"{accel.stats()['accel_buckets']}); {len(events) / wall:.1f} "
            f"events/s ({wall:.3f} s)")
    want_state = want()
    for rec, got in zip(arms, states):
        for i, what in enumerate(("events", "rounds/fame", "blocks",
                                  "undetermined")):
            if got[i] != want_state[i]:
                raise AssertionError(f"[churn {label}/{rec['arm']}] {what} "
                                     "differ from the host oracle")
    log(f"[churn {label}] every arm equal to the host oracle "
        f"({len(want_state[2])} blocks, {len(events)} events, peer-sets at "
        f"rounds {[r for r, _ in peer_sets]})")
    return {"arms": arms, "shapes": shapes}


def churn_replayed(seed: int) -> dict:
    """Phase 14 (a): the three golden fixtures, then a CHURN_VALIDATORS
    stream with CHURN_CHANGES, through every arm; the stream's host oracle
    replays in a child process meanwhile."""
    events, keys, peers = gossip_stream(CHURN_VALIDATORS, CHURN_EVENTS, seed,
                                        changes=CHURN_CHANGES)
    peer_sets = churn_peer_sets(keys, peers, CHURN_CHANGES)
    oracle = OracleProcess(events, peers, peer_sets)
    shapes, out = Counter(), {}
    try:
        for name in DYN_FIXTURES:
            ev, genesis, changes = dyn_fixture(name, seed)
            h, _ = replay(ev, genesis, peer_sets=changes, sync=3)
            want = consensus_state(h)
            res = churn_replay(name, ev, genesis, changes, lambda w=want: w,
                               sync=3, sweep_events=3)
            shapes += res["shapes"]
            out[name] = res["arms"]
        summary = {}

        def stream_oracle():
            t0 = time.perf_counter()
            summary.update(oracle.result())
            log(f"[churn stream] waited {time.perf_counter() - t0:.2f} s for "
                f"the oracle process ({summary['seconds']:.1f} s of replay)")
            return summary["state"]

        res = churn_replay("stream", events, peers, peer_sets, stream_oracle,
                           sync=SYNC_EVENTS)
    finally:
        oracle.stop()
    last = CHURN_CHANGES[-1][1]
    after = sum(r > last for r in summary["rounds_received"])
    log(f"[churn stream] blocks by round received: "
        f"{summary['rounds_received']}")
    if after < CHURN_MIN_BLOCKS:
        raise AssertionError(f"[churn stream] {after} blocks received after "
                             f"round {last}, fewer than {CHURN_MIN_BLOCKS}")
    top = max(a["max_s"] for a in res["arms"])
    if top < 4:
        raise AssertionError(f"[churn stream] no window carried three "
                             f"peer-set slots or more (S {top} at most)")
    out["stream"] = res["arms"]
    return {"arms": out, "fixture_shapes": shapes,
            "stream_shapes": res["shapes"],
            "stream": (events, peers, peer_sets, summary["state"])}


def churn_node(genesis, current, name: str, fast_sync: bool = False):
    """A port Node over loopback TCP with ``tcp_cluster``'s settings whose
    key is not in ``current``, so that it joins (with ``fast_sync``, by a
    fast-forward to a peer's anchor block). Returns (node, proxy, state),
    the node initialised and not yet running."""
    from babble_tpu_torch.config.config import Config
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.dummy.state import State as DummyState
    from babble_tpu_torch.hashgraph.store import InmemStore
    from babble_tpu_torch.net.tcp import TCPTransport
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.proxy.proxy import InmemProxy

    conf = Config(heartbeat_timeout=HEARTBEAT_S,
                  slow_heartbeat_timeout=SLOW_HEARTBEAT_S, log_level="error",
                  moniker=name, accelerator=True, cache_size=NODE_CACHE,
                  suspend_limit=SUSPEND_LIMIT,
                  join_timeout=CHURN_JOIN_TIMEOUT_S,
                  enable_fast_sync=fast_sync)
    st = DummyState()
    pr = InmemProxy(st)
    node = Node(conf, Validator(generate_key(), name), current, genesis,
                InmemStore(conf.cache_size),
                TCPTransport(f"127.0.0.1:{free_ports(1)[0]}", timeout=2.0,
                             join_timeout=CHURN_JOIN_TIMEOUT_S), pr)
    node.init()
    return node, pr, st


def wait_for(pred, timeout: float, what: str) -> float:
    """Poll ``pred`` every 20 ms until it holds; returns the monotonic time
    it did. Raises AssertionError after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout after {timeout:.0f} s: {what}")
        time.sleep(0.02)
    return time.monotonic()


def churn_cluster(n: int = CHURN_NODES) -> dict:
    """Phase 14 (b): ``n`` port Nodes over loopback TCP (``tcp_cluster``)
    with the offload at its defaults on the card (the sweep batcher,
    resident windows, pipelined sweeps; min_window from CHURN_ENV) under
    phase 8's closed-loop load, through CHURN_LIVE: one change requested
    every CHURN_CADENCE_S, each after the last has committed (node 0's
    validator-set holds the joiner, or no longer the leaver). Joiners are
    new keys; leavers leave politely (the last genesis nodes); the last
    joiner fast-syncs. Then, with every live node past a common block:
    identical blocks (the fast-synced node's from its anchor on), equal
    peer-sets, node 0 equal to a host replay, no fallback on any node, K1
    launches (counted from 0 before the nodes are built) equal to the
    batcher's sweeps, a sweep with two peer-set slots or more, and the
    fast-synced node's sweeps grown after its reset."""
    import threading

    import torch

    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.node.state import State
    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.peers.peer_set import PeerSet

    batcher = SweepBatcher.instance()
    b0, s0 = batcher.stats(), Counter(batcher.sweep_shapes)
    kernels.reset_launch_counts()
    t_setup = time.monotonic()
    nodes, proxies, states = tcp_cluster(n, True,
                                         join_timeout=CHURN_JOIN_TIMEOUT_S)
    genesis = nodes[0].core.genesis_peers
    everyone = list(nodes)  # every node built, to shut down and count
    live = list(nodes)
    pump = Pump(list(proxies), [states[0]])
    stop = threading.Event()
    loader = threading.Thread(target=pump.until,
                              args=(time.monotonic() + 3600, stop),
                              daemon=True)
    changes, leave_threads = [], []
    fast = None
    rec = {}
    try:
        for node in nodes:
            node.run_async()
        loader.start()
        t_first = wait_for(lambda: min(x.get_last_block_index()
                                       for x in nodes) >= 1,
                           SETTLE_S, f"[churn live] {n} nodes never all "
                           f"committed block 1: {node_states(nodes)}")
        log(f"[churn live] {n} nodes up, every one past block 1 in "
            f"{t_first - t_setup:.1f} s")
        leavers = [nodes[-1], nodes[-2]]
        t_next = time.monotonic()
        for k, kind in enumerate(CHURN_LIVE):
            time.sleep(max(0.0, t_next - time.monotonic()))
            t_req = time.monotonic()
            if kind == "leave":
                node = leavers.pop(0)
                nid = node.get_id()
                live.remove(node)
                pump.proxies = [proxies[nodes.index(x)] for x in live
                                if x in nodes]
                th = threading.Thread(target=node.leave, daemon=True)
                th.start()
                leave_threads.append(th)
                committed = (lambda nid=nid:
                             nid not in nodes[0].core.validators.by_id)
            else:
                node, _pr, _st = churn_node(
                    genesis, PeerSet(list(nodes[0].core.peers.peers)),
                    f"j{k}", fast_sync=kind == "fast-sync join")
                everyone.append(node)
                live.append(node)
                nid = node.get_id()
                node.run_async()
                if kind == "fast-sync join":
                    fast = node
                committed = (lambda nid=nid:
                             nid in nodes[0].core.validators.by_id)
            t_commit = wait_for(committed, CHURN_CHANGE_S,
                                f"[churn live] {kind} of {node.get_id()} "
                                "never committed")
            changes.append({"change": kind, "seconds": t_commit - t_req,
                            "block": nodes[0].get_last_block_index(),
                            "validators": len(nodes[0].core.validators)})
            log(f"[churn live] {kind} {node.get_id()}: committed "
                f"{t_commit - t_req:.2f} s after the request (node 0 at "
                f"block {changes[-1]['block']}, "
                f"{changes[-1]['validators']} validators)")
            t_next = max(t_req + CHURN_CADENCE_S, t_commit)
        t_ff = wait_for(lambda: fast.fast_forwards >= 1
                        and fast.get_state() == State.BABBLING,
                        CHURN_SETTLE_S, "[churn live] the fast-sync joiner "
                        f"never fast-forwarded: state {fast.get_state()}")
        fast_accel = fast.core.hg.accel
        rec["fast_first_block"] = fast.get_last_block_index()
        rec["fast_sweeps_at_reset"] = fast_accel.sweeps
        rec["fast_stale_drops"] = fast_accel.stale_drops
        log(f"[churn live] the fast-sync joiner fast-forwarded to block "
            f"{rec['fast_first_block']} {t_ff - t_req:.2f} s after its "
            f"request (sweeps {fast_accel.sweeps} at the reset)")
        target = max(x.get_last_block_index() for x in live) + 2
        wait_for(lambda: min(x.get_last_block_index() for x in live)
                 >= target, CHURN_SETTLE_S,
                 f"[churn live] live nodes never all reached block {target}"
                 f": {node_states(live)}")
        # the gossip peers of every node that did not fast-sync (the JAX
        # package's check_peer_sets); the fast-synced node's start from its
        # anchor frame's peer-set, which still holds a validator whose
        # leave committed before the anchor and takes effect after it
        rest = [x for x in live if x is not fast]
        wait_for(lambda: len({x.core.peers.hash() for x in rest}) == 1,
                 CHURN_SETTLE_S, "[churn live] peer-sets never converged: "
                 + ", ".join(f"{x.get_id()}={len(x.core.peers)}"
                             for x in rest))
        rec["fast_peers_extra"] = sorted(
            set(fast.core.peers.by_id) - set(nodes[0].core.peers.by_id))
        rec["fast_sweeps_at_end"] = fast_accel.sweeps
    finally:
        stop.set()
        loader.join(timeout=10)
        t_down = time.monotonic()
        stoppers = [threading.Thread(target=x.shutdown) for x in everyone]
        for t in stoppers:
            t.start()
        for t in stoppers + leave_threads:
            t.join(timeout=120)
        for x in everyone:
            with x.core_lock:  # a sync still in flight finishes first
                pass
        rec["shutdown_s"] = time.monotonic() - t_down
    deadline = time.monotonic() + 60
    while not batcher.idle():
        if time.monotonic() > deadline:
            raise AssertionError("[churn live] the sweep batcher never went "
                                 "idle")
        time.sleep(0.05)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["member_ss_counts"]
    common = min(x.get_last_block_index() for x in live)
    for x in live:
        first = rec["fast_first_block"] if x is fast else 0
        for bi in range(first, common + 1):
            if x.get_block(bi).body.hash() != nodes[0].get_block(
                    bi).body.hash():
                raise AssertionError(f"[churn live] block {bi} differs "
                                     f"between node {x.get_id()} and node 0")
    # the peer-set consensus counts by, at the last round every live node
    # has: one set on every node, the fast-synced one's included
    rnd = min(x.core.hg.store.last_round() for x in live)
    consensus_sets = {x.core.hg.store.get_peer_set(rnd).hash() for x in live}
    if len(consensus_sets) != 1:
        raise AssertionError(f"[churn live] {len(consensus_sets)} different "
                             f"peer-sets at round {rnd} across live nodes")
    accels = [x.core.hg.accel for x in everyone]
    b1 = batcher.stats()
    sweeps_by_shape = Counter(batcher.sweep_shapes) - s0
    expected = (b1["batch_batches"] - b0["batch_batches"]
                + b1["batch_singles"] - b0["batch_singles"])
    rec.update(
        changes=changes, common_block=common, launches=launches,
        expected_launches=expected,
        sweeps=sum(a.sweeps for a in accels),
        stale_drops=sum(a.stale_drops for a in accels),
        rebuilds=sum(a.window_state.rebuilds for a in accels),
        forced_decisions=sum(x.core.hg.forced_decisions for x in everyone),
        fallbacks=sum(a.fallbacks for a in accels),
        live=len(live), built=len(everyone),
        sweep_shapes=sweeps_by_shape,
    )
    if rec["fallbacks"]:
        raise AssertionError(f"[churn live] {rec['fallbacks']} fallbacks")
    if any(not a.batcher or not a.resident or not a.pipeline
           or a.stats()["accel_kernel"] != "cuda" for a in accels):
        raise AssertionError("[churn live] a node's offload is not on K1 at "
                             "its card defaults (batcher, resident windows, "
                             "pipelined sweeps)")
    if launches != expected:
        raise AssertionError(f"[churn live] K1 launches {launches} != the "
                             f"batcher's sweeps {expected}")
    if not any(S >= 2 for (_B, _W, _P, S) in sweeps_by_shape):
        raise AssertionError("[churn live] no sweep carried two peer-set "
                             f"slots: {dict(sweeps_by_shape)}")
    if rec["fast_sweeps_at_end"] <= rec["fast_sweeps_at_reset"]:
        raise AssertionError("[churn live] the fast-synced node's offload "
                             "never swept after its reset")
    rec["replayed_events"] = replay_own_events("churn live", nodes[0])
    log(f"[churn live] {len(live)} live nodes of {len(everyone)} to block "
        f"{common}: identical blocks (the fast-synced node's from block "
        f"{rec['fast_first_block']}), one peer-set at round {rnd} on every "
        f"node, equal gossip peers (the fast-synced node's beyond node 0's: "
        f"{rec['fast_peers_extra']}), node 0 = host replay "
        f"of {rec['replayed_events']} events, fallbacks 0; K1 launches "
        f"{launches} = the batcher's sweeps; the fast-synced node's sweeps "
        f"{rec['fast_sweeps_at_reset']} -> {rec['fast_sweeps_at_end']}; "
        f"stale drops {rec['stale_drops']}, rebuilds {rec['rebuilds']}, "
        f"decisions forced ahead of a membership change "
        f"{rec['forced_decisions']}; "
        f"seconds from request to commit "
        f"{[round(c['seconds'], 2) for c in changes]}; K1 shapes (B, W, P, "
        f"S): {json.dumps({'x'.join(map(str, k)): v for k, v in sorted(sweeps_by_shape.items())})}")
    return rec


def reset_in_flight(stream) -> dict:
    """Phase 14 (c): the replayed stream's first RESET_WINDOWS[i] events
    into a pipelined offload on the card (resident windows, no batcher),
    one flush that launches a sweep over all of them, and — once a window
    is found whose sweep has not landed by the time the flush returns (its
    CUDA event not yet done), or else with the largest window's copy-out
    queued behind RESET_BUSY_CYCLES of a sleep kernel on the offload's
    stream — ``invalidate()`` while it runs: the sweep is dropped
    (``stale_drops`` one more), its admission slot is free, and the rest
    of the stream, in syncs, gives the oracle's consensus, with K1's
    launches equal to the sweeps launched, dropped ones included."""
    import torch

    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph import accel as accel_mod
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.ops import kernels

    events, peers, peer_sets, want = stream
    how = None
    for n_first in sorted({min(n, len(events)) for n in RESET_WINDOWS}):
        accel = TensorConsensus(device="cuda", min_window=0, pipeline=True,
                                batcher=False, resident=True,
                                sweep_events=10**9)
        h = Hashgraph(InmemStore(1_000_000))
        h.init(peers)
        for r, ps in peer_sets:
            h.store.set_peer_set(r, ps)
        h.accel = accel
        for ev in events[:n_first]:
            h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                             set_wire_info=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        h.flush_consensus()
        inf = accel._inflight
        running = inf is not None and not inf.done.query()
        log(f"[churn reset] a window of {n_first} events: the sweep "
            f"{'is still running' if running else 'had landed'} when the "
            "flush returned")
        if running:
            how = f"a window of {n_first} events"
            break
        accel.invalidate()  # drops the landed sweep, frees its slot
    if how is None:
        # Every sweep outran the host's check: its last operations are
        # small. Sweep the largest window again with a sleep kernel queued
        # on the offload's stream between the sweep and its copy-out, as
        # co-located work on the card would hold it, so that the copy and
        # the sweep's event are still queued when invalidate() comes.
        dispatch = accel._dispatch

        def held(win, snap):
            out = dispatch(win, snap)
            torch.cuda._sleep(RESET_BUSY_CYCLES)
            return out

        accel._dispatch = held
        try:
            h._accel_pending = max(h._accel_pending, 1)
            h.flush_consensus()
        finally:
            del accel._dispatch
        inf = accel._inflight
        if inf is None or inf.done.query():
            raise AssertionError("[churn reset] no sweep was in flight behind "
                                 "the sleep kernel")
        how = (f"a window of {n_first} events, its copy-out behind "
               f"{RESET_BUSY_CYCLES} clock cycles of a sleep kernel")
        log(f"[churn reset] {how} on the offload's stream: the sweep is "
            "still in flight when the flush returns")
    stale0 = accel.stale_drops
    accel.invalidate()
    if (accel.stale_drops != stale0 + 1 or accel.busy()
            or inf.slots is not None):
        raise AssertionError(f"[churn reset] after invalidate(): stale drops "
                             f"{stale0} -> {accel.stale_drops}, busy "
                             f"{accel.busy()}, slot held "
                             f"{inf.slots is not None}")
    slots = accel_mod._inflight_slots()
    free = 0
    while slots.acquire(blocking=False):
        free += 1
    for _ in range(free):
        slots.release()
    if free != accel_mod._MAX_INFLIGHT:
        raise AssertionError(f"[churn reset] {free} of "
                             f"{accel_mod._MAX_INFLIGHT} admission slots free")
    for b in range(n_first, len(events), SYNC_EVENTS):
        for ev in events[b:b + SYNC_EVENTS]:
            h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                             set_wire_info=True)
        h.flush_consensus()
    deadline = time.monotonic() + DRAIN_S
    h._accel_pending = max(h._accel_pending, 1)
    h.flush_consensus()
    while accel.busy():
        if time.monotonic() > deadline:
            raise AssertionError("[churn reset] pipelined sweep never drained")
        time.sleep(0.001)
        h.flush_consensus()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["member_ss_counts"]
    got = consensus_state(h)
    for i, what in enumerate(("events", "rounds/fame", "blocks",
                              "undetermined")):
        if got[i] != want[i]:
            raise AssertionError(f"[churn reset] {what} differ from the host "
                                 "oracle after the reset")
    if accel.fallbacks or launches != accel.sweeps + accel.stale_drops:
        raise AssertionError(f"[churn reset] fallbacks {accel.fallbacks}, K1 "
                             f"launches {launches} != sweeps {accel.sweeps} "
                             f"+ stale drops {accel.stale_drops}")
    log(f"[churn reset] invalidate() under a running sweep ({how}): "
        f"dropped (stale drops {accel.stale_drops}), {free} of {free} slots "
        f"free, then {accel.sweeps} sweeps to the oracle's {len(want[2])} "
        f"blocks; K1 launches {launches} = sweeps + the dropped ones")
    return {"how": how, "sweeps": accel.sweeps, "launches": launches,
            "stale_drops": accel.stale_drops}


def breaker_on_card(seed: int) -> dict:
    """Phase 14 (d): an offload on the card (synchronous, no resident
    windows, no batcher) with a breaker of threshold BREAKER_N and a
    BREAKER_COOLDOWN_S cooldown over a 16-validator stream. BREAKER_N
    flushes whose sweep launch raises an injected store error (the one
    failure the port's offload falls back on; a CUDA error raises) open
    it; while it is open flushes are refused before anything is launched
    (K1's count holds still); after the cooldown the probe sweep runs K1
    and closes it; then consensus equals the oracle's."""
    import torch

    from babble_tpu_torch.common.breaker import CLOSED, OPEN, CircuitBreaker
    from babble_tpu_torch.common.errors import StoreError, StoreErrorKind
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph.accel import TensorConsensus
    from babble_tpu_torch.ops import kernels, voting

    events, _keys, peers = gossip_stream(16, BREAKER_EVENTS, seed)
    oracle_h, _ = replay(events, peers)
    want = consensus_state(oracle_h)
    breaker = CircuitBreaker(threshold=BREAKER_N, window_s=60.0,
                             cooldown_s=BREAKER_COOLDOWN_S)
    accel = TensorConsensus(device="cuda", sweep_events=10**9, min_window=0,
                            pipeline=False, resident=False, batcher=False,
                            breaker=breaker)
    h = Hashgraph(InmemStore(1_000_000))
    h.init(peers)
    h.accel = accel
    for ev in events:
        h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                         set_wire_info=True)
    real = voting.launch_sweep
    calls = [0]

    def failing(win, device):
        calls[0] += 1
        raise StoreError("Event", StoreErrorKind.TOO_LATE,
                         "injected launch failure")

    kernels.reset_launch_counts()
    voting.launch_sweep = failing
    try:
        for _ in range(BREAKER_N):
            if accel.flush(h):
                raise AssertionError("[churn breaker] a failed launch was "
                                     "applied")
        opened = breaker.state
        for _ in range(BREAKER_N):
            if accel.flush(h):
                raise AssertionError("[churn breaker] an open breaker let a "
                                     "flush through")
    finally:
        voting.launch_sweep = real
    torch.cuda.synchronize()
    held = kernels.launch_counts()["member_ss_counts"]
    skips = accel.stats()["accel_breaker_skips"]
    if (opened != OPEN or calls[0] != BREAKER_N
            or accel.fallbacks != BREAKER_N or held != 0
            or skips < BREAKER_N):
        raise AssertionError(f"[churn breaker] state {opened}, launch "
                             f"attempts {calls[0]}, fallbacks "
                             f"{accel.fallbacks}, K1 launches {held}, skips "
                             f"{skips}")
    time.sleep(BREAKER_COOLDOWN_S * 1.2)
    if not accel.flush(h) or breaker.state != CLOSED:
        raise AssertionError(f"[churn breaker] the probe sweep did not close "
                             f"the breaker ({breaker.state})")
    torch.cuda.synchronize()
    probe = kernels.launch_counts()["member_ss_counts"]
    h._accel_pending = max(h._accel_pending, 1)
    h.flush_consensus()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["member_ss_counts"]
    got = consensus_state(h)
    if got != want or probe != 1 or launches != accel.sweeps:
        raise AssertionError(f"[churn breaker] consensus equal to the oracle "
                             f"{got == want}; K1 launches {probe} at the "
                             f"probe, {launches} for {accel.sweeps} sweeps")
    st = accel.stats()
    log(f"[churn breaker] {BREAKER_N} injected launch failures opened it "
        f"(fallbacks {accel.fallbacks}); {BREAKER_N} flushes while open were "
        f"refused with K1 held at 0 launches (skips {skips}); after "
        f"{BREAKER_COOLDOWN_S} s the probe swept on K1 (1 launch) and closed "
        f"it (probes {st['accel_breaker_probes']}, opens "
        f"{st['accel_breaker_open']}); consensus equal to the oracle "
        f"({len(want[2])} blocks)")
    return {"fallbacks": accel.fallbacks, "launches": launches,
            "probes": st["accel_breaker_probes"]}


def churn_k1_checks(shapes: Counter, seed: int) -> dict:
    """K1 equal to its plain version on the card, with its time, bound
    and share of the bound, at every shape of ``shapes`` (as
    ``churn_replay`` files them) with two peer-set slots or more. Returns
    shape -> check_k1's record."""
    out = {}
    for i, key in enumerate(sorted(shapes)):
        kind, *dims = key
        if dims[-1] < 2:
            continue
        row = (check_k1_rect(tuple(dims), seed + i) if kind == "rect"
               else check_k1(tuple(dims), seed + i))
        out[key] = row
        log(f"K1 {kind} {tuple(dims)} ({shapes[key]} launches in phase 14): "
            f"equal to plain on random and edge values; kernel "
            f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, bound "
            f"{row['bound_ms']:.3g} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.1%} of bound")
    return out


def churn_rows(label: str, shapes: Counter, checked: dict, launches: dict,
               main: str) -> list:
    """Kernels-line rows of K1 on a phase 14 path: at each peer-set slot
    count S >= 2 its most frequent shape there (of those ``checked``), with
    the path's ``launches`` (the ``main`` arm's)."""
    rows = []
    for S in sorted({k[-1] for k in checked}):
        at = {k: v for k, v in shapes.items() if k in checked and k[-1] == S}
        if not at:
            continue
        key = max(at, key=at.get)
        row = checked[key]
        rows.append({
            "name": f"member_ss_counts[{label}, S {S}]",
            "route": "cuda",
            "source": "babble_tpu_torch/csrc/member_ss.cu",
            "replaces": "babble_tpu/ops/pallas_kernels.py:104",
            "launches": launches[main],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": [key[0], *row["shape"]],
            "launches_at_shape": at[key],
            "launches_by_arm": launches,
        })
    return rows


class FreshChild:
    """``chip_smoke.<call>`` in a fresh interpreter with ``env`` added,
    started at once: its output (standard error merged in) passes through
    as it comes, but for the one line that starts with ``tag``, whose JSON
    ``result()`` returns once the child has exited 0. The child is killed
    after ``timeout`` seconds."""

    def __init__(self, call: str, tag: str, env: dict, timeout: float):
        import os
        import subprocess
        import threading

        here = os.path.dirname(os.path.abspath(__file__))
        self.tag = tag
        self.record = None
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
            cwd=here, env={**os.environ, **env}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._timer = threading.Timer(timeout, self.proc.kill)
        self._timer.start()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith(self.tag + " "):
                self.record = json.loads(line[len(self.tag) + 1:])
            else:
                sys.stdout.write(line)
                sys.stdout.flush()

    def result(self):
        try:
            self.proc.wait()
            self._reader.join()
        finally:
            self._timer.cancel()
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0 or self.record is None:
            raise AssertionError(f"{self.tag} process exit "
                                 f"{self.proc.returncode}")
        return self.record

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._timer.cancel()


def churn_live_child() -> None:
    """Phase 14 (b) in a process of its own (CHURN_ENV): ``churn_cluster``,
    whose record it prints as one ``CHURNLIVE`` line of JSON."""
    import torch

    from babble_tpu_torch.ops import kernels

    kernels.build()
    torch.cuda.init()
    rec = churn_cluster()
    rec["sweep_shapes"] = [[list(k), v] for k, v in
                           sorted(rec["sweep_shapes"].items())]
    print("CHURNLIVE " + json.dumps(rec), flush=True)


def membership_child(seed: int) -> None:
    """Phase 14's replays, in a process of their own (CHURN_ENV): (a) the
    golden fixtures and the churn stream through every arm, (c) the
    in-flight reset and (d) the breaker. Prints one ``MEMBERSHIP`` line of
    JSON for the parent: the arms, K1's launch shapes, (c) and (d)."""
    import torch

    from babble_tpu_torch.ops import kernels

    kernels.build()
    torch.cuda.init()
    t0 = time.perf_counter()
    replayed = churn_replayed(seed)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset = reset_in_flight(replayed["stream"])
    breaker = breaker_on_card(seed + 400)
    t_cd = time.perf_counter() - t0
    log(f"[churn] (a) {t_a:.1f} s, (c) and (d) {t_cd:.1f} s")
    print("MEMBERSHIP " + json.dumps({
        "arms": replayed["arms"],
        "stream_shapes": [[list(k), v] for k, v in
                          sorted(replayed["stream_shapes"].items())],
        "fixture_shapes": [[list(k), v] for k, v in
                           sorted(replayed["fixture_shapes"].items())],
        "reset": reset, "breaker": breaker,
        "seconds": {"replayed": t_a, "reset_and_breaker": t_cd},
    }), flush=True)


def membership_live() -> "FreshChild":
    """Phase 14 (b), started: ``churn_live_child`` in a fresh process. It
    runs beside phases 11-13 and phase 14's replays (none of which times
    the host cost of a node, and whose kernel times are medians over
    bursts far shorter than the cluster's sparse sweeps); its result is
    read, and K1 timed at its shapes, once it has ended."""
    return FreshChild("churn_live_child()", "CHURNLIVE", CHURN_ENV,
                      CHURN_LIVE_TIMEOUT_S)


def membership_phase(name_power: str, seed: int, live: "FreshChild",
                     beside=None) -> list:
    """Phase 14: its replays in a fresh process, and (b)'s result from
    ``live``; ``beside()``, if given, once (b) has ended, while the
    replays go on (it returns a call that waits for what it started);
    then, with the card to itself, K1 against its plain version at every
    shape with two peer-set slots or more that (a) and (b) gave it.
    Returns the kernels-line rows."""
    t0 = time.perf_counter()
    child = FreshChild(f"membership_child({seed})", "MEMBERSHIP", CHURN_ENV,
                       CHURN_TIMEOUT_S)
    try:
        lrec = live.result()
        join = beside() if beside is not None else None
        rec = child.result()
    finally:
        child.stop()
    t_ab = time.perf_counter() - t0
    if join is not None:
        join()
    t0 = time.perf_counter()

    def shapes(pairs):
        return Counter({tuple(k): v for k, v in pairs})

    stream_shapes = shapes(rec["stream_shapes"])
    live_shapes = Counter({
        (("batch", *k) if k[0] > 1 else ("square", *k[1:])): v
        for k, v in shapes(lrec["sweep_shapes"]).items()})
    checked = churn_k1_checks(stream_shapes + shapes(rec["fixture_shapes"])
                              + live_shapes, seed + 300)
    stream_arms = {a["arm"]: a["launches"] for a in rec["arms"]["stream"]}
    rows = churn_rows("membership churn, replayed",
                      Counter({k: v for k, v in stream_shapes.items()
                               if k[0] == "square"}),
                      checked, stream_arms, "resident sync")
    rows += churn_rows("membership churn, live", live_shapes, checked,
                       {"live": lrec["launches"]}, "live")
    log(f"[churn] phase 14: the replays and the live cluster's end "
        f"{t_ab:.1f} s after the replays started (the cluster began before "
        f"phase 11), K1 checks {time.perf_counter() - t0:.1f} s; changes "
        f"(kind, seconds from request to commit): "
        f"{[(c['change'], round(c['seconds'], 2)) for c in lrec['changes']]};"
        f" {name_power or 'nvidia-smi: not available'}")
    return rows


# -- phase 15: config 5, the Byzantine fault model on the accelerated node ---

BYZ_NODES = 16
# 5 = f < 16 / 3 adversaries: three flood forged signatures (the bad-signature
# flood), one pushes 3 x sync_limit + 1 events (K3 at large B), one forks
BYZ_ATTACKS = ("wrong_key", "wrong_key", "wrong_key", "oversize",
               "equivocate")
# Every honest node must commit block BYZ_TARGET_BLOCK in each arm, and
# every adversary be caught, within BYZ_ARM_S. Block 0 keeps phase 15 near
# its 240 s: with K3 under attack, block 1 took 102-179 s on an NVIDIA H100
# 80GB HBM3 at 700 W.
BYZ_TARGET_BLOCK = 0
BYZ_ARM_S = 180.0
BYZ_TIMEOUT_S = 600
# The honest nodes' sentry: one scored offence of weight 2 (invalid_signature,
# oversized_sync, fork) quarantines, for 5 s. At the default threshold of 8
# no flooder was quarantined in 120 s: 16 nodes in one process answer so
# slowly that each flooder reaches an honest node about once in 25 s, and
# the 30 s half-life forgives that (PERF.md section 6). The sentry is the
# JAX package's at either setting (tests/test_torch_adversarial.py and
# tests/test_torch_sim_byzantine.py, the latter at the defaults).
BYZ_SENTRY = {"sentry_threshold": 2.0, "sentry_quarantine_s": 5.0}
# The adversaries wait this long for an answer (the honest nodes, 2 s as in
# tcp_cluster): a busy honest node answers an eager sync only once its
# insert has landed.
BYZ_RPC_TIMEOUT_S = 10.0


def _sign_rs(d: int, h: bytes):
    from babble_tpu_torch import native_crypto
    from babble_tpu_torch.crypto import secp256k1 as ref

    return native_crypto.sign(d.to_bytes(32, "big"), h) or ref.sign(d, h)


def hostile_events(seed: int):
    """Port Events of what a Byzantine validator sends a verifier, each
    signed on the RFC 6979 path from seeded keys: two honest events, one
    claiming an honest creator but signed by another key (``wrong_key``),
    both branches of a fork at one (creator, index), r = 0, s = n, a valid
    signature with s in n's upper half, a creator key off the curve
    (a structural reject), a valid event of the key Q = -G (whose G + Q
    table entry is infinite), an undecodable signature, and the first
    honest event once more. Returns (events, expected verdicts)."""
    from babble_tpu_torch.crypto import secp256k1 as ref
    from babble_tpu_torch.crypto.keys import encode_signature
    from babble_tpu_torch.hashgraph.event import Event

    rng = random.Random(seed)
    ds = [rng.randrange(1, ref.N) for _ in range(3)]

    def event(d_or_pub, tx: bytes, index: int = 0, signer=None):
        pub = (ref.pubkey_from_scalar(d_or_pub)
               if isinstance(d_or_pub, int) else d_or_pub)
        ev = Event.new([tx], [], [], ["", ""], ref.marshal_pubkey(pub),
                       index, timestamp=1700000000 + index)
        d = d_or_pub if signer is None else signer
        if d is not None:
            ev.signature = encode_signature(*_sign_rs(d, ev.hash()))
        return ev

    def resign(ev, r, s):
        ev.signature = encode_signature(r, s)
        return ev

    out = [(event(ds[0], b"honest a"), True),
           (event(ds[1], b"honest b", 1), True),
           (event(ds[0], b"forged", 1, signer=ds[2]), False),
           (event(ds[2], b"branch A", 2), True),
           (event(ds[2], b"branch B", 2), True)]
    ev = event(ds[1], b"r = 0", 2)
    out.append((resign(ev, 0, int(ev.signature.split("|")[1], 36)), False))
    ev = event(ds[1], b"s = n", 3)
    out.append((resign(ev, int(ev.signature.split("|")[0], 36), ref.N),
                False))
    ev = event(ds[0], b"high s", 2)
    r, s = _sign_rs(ds[0], ev.hash())
    out.append((resign(ev, r, s if s > ref.N // 2 else ref.N - s), True))
    off = ref.pubkey_from_scalar(ds[1])
    out.append((event((off[0], (off[1] + 1) % ref.P), b"off the curve",
                      signer=ds[1]), False))
    out.append((event(ref.N - 1, b"Q = -G"), True))
    ev = event(ds[2], b"undecodable", 3)
    ev.signature = "not|a|signature"
    out.append((ev, False))
    out.append((out[0][0], True))
    return [ev for ev, _ in out], [ok for _, ok in out]


def hostile_items(seed: int):
    """Raw (pub, hash, r, s) items no event of a known creator can carry
    but a verifier must get right: a valid signature whose R.x lies in
    [n, p), so it verifies only through r + n (r + n < p), and the same
    with a wrong hash; r = n and s = 0; a hash equal to n and a hash of 0
    (u1 = 0), both valid; Q = -G with a wrong hash; and one of them twice.
    Returns (items, expected verdicts)."""
    from babble_tpu_torch.crypto import secp256k1 as ref

    rng = random.Random(seed)
    n, p = ref.N, ref.P
    t = 1
    while True:  # R = (n + t, y) on the curve
        x = n + t
        a = (pow(x, 3, p) + 7) % p
        y = pow(a, (p + 1) // 4, p)
        if y * y % p == a:
            break
        t += 1
    R, r = (x, y), t
    s = rng.randrange(1, n)
    u1 = rng.randrange(1, n)
    u2 = r * pow(s, -1, n) % n
    e = u1 * s % n
    minus_u1g = ref.point_mul(n - u1, ref.G)
    Q = ref.point_mul(pow(u2, -1, n), ref.point_add(R, minus_u1g))
    h_rn = e.to_bytes(32, "big")
    d = rng.randrange(1, n)
    pub = ref.pubkey_from_scalar(d)
    h_n = n.to_bytes(32, "big")
    h_0 = bytes(32)
    neg_g = (ref.GX, p - ref.GY)
    items = [
        (Q, h_rn, r, s, True),
        (Q, bytes(31) + b"\x01", r, s, False),
        (pub, h_n, ref.N, 5, False),
        (pub, h_n, 5, 0, False),
        (pub, h_n, *_sign_rs(d, h_n), True),
        (pub, h_0, *_sign_rs(d, h_0), True),
        (neg_g, h_0, *_sign_rs(n - 1, bytes(31) + b"\x07"), False),
        ((pub[0], (pub[1] + 1) % p), h_n, *_sign_rs(d, h_n), False),
    ]
    items.append(items[0])
    return [it[:4] for it in items], [it[4] for it in items]


def crafted_k3_set(seed: int):
    """Phase 15 (a)'s crafted set: the items of ``hostile_events`` (as the
    node's collector gathers them) and ``hostile_items``, with the item
    repeated inside the batch; returns (items, expected verdicts)."""
    from babble_tpu_torch.crypto import secp256k1 as ref
    from babble_tpu_torch.crypto.batch import collect_signature_items

    events, _ = hostile_events(seed)
    items, _ = collect_signature_items(events)
    extra, want_extra = hostile_items(seed)
    want = [ref.verify(*it) for it in items]
    return items + extra, want + want_extra


def byz_cluster(attacks):
    """BYZ_NODES validators over loopback TCP in this process: the first
    BYZ_NODES - len(attacks) are port Nodes as ``tcp_cluster`` makes them
    (phase 8's settings, SUSPEND_LIMIT), the rest ``ByzantineNode``s, one
    per attack of ``attacks``, each with its own seeded stream. Returns
    (nodes, proxies, states, byzs), the nodes initialised and nothing
    running."""
    from babble_tpu_torch.adversary import ByzantineNode
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

    keys = [generate_key() for _ in range(BYZ_NODES)]
    peers = PeerSet([
        Peer(f"127.0.0.1:{port}", k.public_key.hex(), f"b{i}")
        for i, (k, port) in enumerate(zip(keys, free_ports(BYZ_NODES)))
    ])
    addr = {p.pub_key_hex: p.net_addr for p in peers.peers}
    n_honest = BYZ_NODES - len(attacks)
    nodes, proxies, states, byzs = [], [], [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=HEARTBEAT_S,
                      slow_heartbeat_timeout=SLOW_HEARTBEAT_S,
                      log_level="error", moniker=f"b{i}",
                      accelerator=i < n_honest,
                      cache_size=NODE_CACHE, suspend_limit=SUSPEND_LIMIT,
                      **BYZ_SENTRY)
        trans = TCPTransport(addr[k.public_key.hex()],
                             timeout=BYZ_RPC_TIMEOUT_S if i >= n_honest
                             else 2.0)
        if i >= n_honest:
            byzs.append(ByzantineNode(
                conf, Validator(k, f"b{i}"), peers, peers,
                InmemStore(conf.cache_size), trans,
                attack=attacks[i - n_honest], seed=i))
            continue
        st = DummyState()
        pr = InmemProxy(st)
        node = Node(conf, Validator(k, f"b{i}"), peers, peers,
                    InmemStore(conf.cache_size), trans, pr)
        node.init()
        nodes.append(node)
        proxies.append(pr)
        states.append(st)
    return nodes, proxies, states, byzs


class K3Log:
    """What K3 saw in an arm, through one wrapper of
    ``ops.verify.batch_verify`` (which the cores' ``prevalidate_events``
    calls; no other caller runs in the arm): K3's verdict on every item
    (which must be the same each time an item recurs), calls by B with one
    batch of each B, calls without an item, and the items rejected."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.verdicts = {}  # item -> K3's verdict
        self.conflicts = 0  # an item whose verdict changed
        self.by_b = Counter()  # calls with an item, by B
        self.batch_at = {}  # B -> one batch of that size
        self.empty = 0  # calls without an item (no launch)
        self.rejected = 0  # items K3 rejected, each time it saw one

    def install(self) -> None:
        from babble_tpu_torch.ops import verify

        self._orig = orig = verify.batch_verify

        def batch_verify(items, device=None):
            out = orig(items, device)
            with self.lock:
                if len(items):
                    self.by_b[len(items)] += 1
                    self.batch_at.setdefault(len(items), list(items))
                else:
                    self.empty += 1
                for it, v in zip(items, out.tolist()):
                    self.rejected += not v
                    old = self.verdicts.setdefault(it, v)
                    self.conflicts += old != v
            return out

        verify.batch_verify = batch_verify

    def remove(self) -> None:
        from babble_tpu_torch.ops import verify

        verify.batch_verify = self._orig


def struck(core, byz):
    """``byz``'s record at ``core``'s sentry when ``core`` rejected one of
    its pushes for an offence that crosses the sentry's threshold on its
    own (with BYZ_SENTRY: a forged signature, an oversized push, a fork),
    else None. A push whose events only failed on an unknown parent (the
    adversary's newest event, not yet gossiped) scores a quarter point and
    is not counted."""
    rec = core.sentry.suspects()["peers"].get(str(byz.core.validator.id()))
    if rec is None:
        return None
    w, t = core.sentry.weights, core.sentry.threshold
    return rec if any(w.get(c, 1.0) >= t for c in rec["causes"]) else None


def caught_adversaries(byzs, cores) -> set:
    """The adversaries of ``byzs`` that are quarantined (now or before) by
    every honest core that ``struck`` them, and by one at least; the
    equivocator once its proof is on file too: the reference soaks'
    predicate (tests/test_byzantine.py), per adversary."""
    out = set()
    for byz in byzs:
        bid = str(byz.core.validator.id())
        pushed = [r for r in (struck(c, byz) for c in cores) if r]
        if not pushed or any(r["quarantines"] < 1 for r in pushed):
            continue
        if byz.attack == "equivocate":
            pub = byz.core.validator.public_key_hex().upper()
            if not any(p.creator.upper() == pub
                       for c in cores for p in c.sentry.proofs()):
                continue
        out.add(f"{byz.attack}:{bid}")
    return out


def forged_in_stores(nodes, byzs) -> tuple:
    """(events of the adversaries in the honest nodes' stores, those whose
    signature the native verifier rejects): the second must be 0, or a
    forged event entered a DAG."""
    from babble_tpu_torch.crypto.batch import collect_signature_items

    held, bad = 0, 0
    for node in nodes:
        store = node.core.hg.store
        with node.core_lock:
            events = [store.get_event(h) for byz in byzs
                      for h in store.participant_events(
                          byz.core.validator.public_key_hex(), -1)]
        items, spans = collect_signature_items(events)
        ok = native_verify_items(items) if items else []
        held += len(events)
        bad += sum(not (good and all(ok[s:s + n]))
                   for _, s, n, good in spans)
    return held, bad


def byz_arm(label: str, device_verify: bool) -> dict:
    """One arm of phase 15: BYZ_NODES validators, BYZ_ATTACKS of them
    Byzantine, each started with ``run_async``, under phase 8's closed-loop
    load until every honest node has committed block BYZ_TARGET_BLOCK and
    every adversary is caught. The honest nodes verify every sync chunk on
    K3 from the start with ``device_verify`` (the caller sets
    ``BABBLE_DEVICE_VERIFY``), on the host without it. The equivocator
    reveals its second branch once every honest node holds its first
    (``ByzantineNode.reveal``): its own wait for every peer's ack came late
    or never among 16 nodes on K3.
    Checks identical blocks, node 0's chain against a host replay of its
    events, no offload fallback; K3 launches (counted from 0 once the nodes
    are up) equal to the honest cores' batch verifications with an item,
    or none on the host; the single re-checks equal to the items K3
    rejected (every event here carries one signature); no forged event in
    an honest store; K1 launches (from 0 likewise) equal to the sweep
    batcher's sweeps; every adversary quarantined by every honest node that
    ``struck`` it, and the equivocator's proof on file and verifying.
    Returns (the arm's record, its K3Log)."""
    import threading

    import torch

    from babble_tpu_torch.crypto.batch import collect_signature_items
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
    from babble_tpu_torch.node.sentry import EquivocationProof
    from babble_tpu_torch.ops import kernels

    nodes, byzs, loader, k3 = [], [], None, K3Log()
    stop = threading.Event()
    times = []  # each honest core's batch verification, seconds
    batcher = SweepBatcher.instance()
    t_setup = time.perf_counter()
    try:
        nodes, proxies, states, byzs = byz_cluster(BYZ_ATTACKS)
        cores = [node.core for node in nodes]
        for core in cores:  # the core's own timing of its batch verification
            def sink(stage, s, orig=core.obs.tracer.stage_sink):
                if stage == "batch_verify":
                    times.append(s)
                if orig is not None:
                    orig(stage, s)
            core.obs.tracer.stage_sink = sink
        k3.install()
        kernels.reset_launch_counts()
        batch0, shapes0 = batcher.stats(), Counter(batcher.sweep_shapes)
        log(f"[byz/{label}] {len(nodes)} honest nodes and {len(byzs)} "
            f"Byzantine up in {time.perf_counter() - t_setup:.2f} s "
            "(set-up)")
        t0 = time.monotonic()
        for x in nodes + byzs:
            x.run_async()
        loader = threading.Thread(
            target=Pump(proxies, states).until,
            args=(t0 + BYZ_ARM_S, stop), daemon=True)
        loader.start()
        eq = next(b for b in byzs if b.attack == "equivocate")
        eq_id = eq.core.validator.id()
        blocks_at, caught_at, caught_s, revealed_s = {}, {}, None, None
        while time.monotonic() - t0 < BYZ_ARM_S:
            at = eq.fork_index()
            if revealed_s is None and at is not None and all(
                    c.known_events().get(eq_id, -1) >= at for c in cores):
                eq.reveal()
                revealed_s = time.monotonic() - t0
            low = min(node.get_last_block_index() for node in nodes)
            blocks_at.setdefault(low, time.monotonic() - t0)
            if caught_s is None:
                for name in caught_adversaries(byzs, cores):
                    caught_at.setdefault(name, time.monotonic() - t0)
                if len(caught_at) == len(byzs):
                    caught_s = time.monotonic() - t0
            if low >= BYZ_TARGET_BLOCK and caught_s is not None:
                break
            time.sleep(0.5)
        run_s = time.monotonic() - t0
    finally:
        stop.set()
        # all at once: each waits up to 2 s for its threads
        stoppers = [threading.Thread(target=x.stop) for x in byzs]
        stoppers += [threading.Thread(target=node.shutdown) for node in nodes]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=120)
        if loader is not None:
            loader.join(timeout=10)
        for node in nodes:
            with node.core_lock:  # a sync still in flight finishes first
                pass
        k3.remove()
    deadline = time.monotonic() + 60
    while not batcher.idle():
        if time.monotonic() > deadline:
            raise AssertionError(f"[byz/{label}] the sweep batcher never "
                                 "went idle")
        time.sleep(0.05)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    b1 = batcher.stats()
    held, forged = forged_in_stores(nodes, byzs)
    times = sorted(times) or [0.0]
    # both branches of the fork: each must have reached K3 in (b)
    at = eq.fork_index()
    pair = ([e for e in eq.core.own_chain() if e.index() == at]
            + [eq.core.forks[at]]) if at is not None else []
    pair_on_k3 = [it in k3.verdicts
                  for it in collect_signature_items(pair)[0]]
    rec = {
        "arm": label, "run_s": run_s, "caught_s": caught_s,
        "revealed_s": revealed_s,
        "caught_at_s": {k: round(v, 2) for k, v in caught_at.items()},
        "target_s": min((t for b, t in blocks_at.items()
                         if b >= BYZ_TARGET_BLOCK), default=None),
        "blocks_at_s": {str(k): round(v, 2) for k, v in blocks_at.items()},
        "launches": launches["ecdsa_shamir"], "launches_by_b": dict(k3.by_b),
        "k1_launches": launches["member_ss_counts"],
        "k1_sweeps": sum(b1[k] - batch0[k]
                         for k in ("batch_batches", "batch_singles")),
        "sweep_shapes": [[list(k), v] for k, v in
                         (Counter(batcher.sweep_shapes) - shapes0).items()],
        "batch_verifies": sum(c.ingest_batch_verifies for c in cores),
        "empty_batches": k3.empty, "k3_rejected": k3.rejected,
        "fallback_singles": sum(c.ingest_fallback_singles for c in cores),
        "fallbacks": sum(c.hg.accel.fallbacks for c in cores),
        "calls": len(times),
        "median_ms": 1e3 * statistics.median(times),
        "p95_ms": 1e3 * _pct(times, 0.95),
        "items": len(k3.verdicts), "item_conflicts": k3.conflicts,
        "adversary_events_held": held, "forged_held": forged,
        "fork_pair_on_k3": pair_on_k3,
        "rejects": dict(sum((Counter(c.sentry.rejects) for c in cores),
                            Counter())),
    }
    caught = {}
    for byz in byzs:
        bid = byz.core.validator.id()
        seen = [c.sentry.suspects()["peers"].get(str(bid)) for c in cores]
        pushed = [r for r in (struck(c, byz) for c in cores) if r]
        pub = byz.core.validator.public_key_hex().upper()
        caught[f"{byz.attack}:{bid}"] = {
            "pushed_to": len(pushed),
            "quarantined_by": sum(r["quarantines"] >= 1 for r in pushed),
            "causes": dict(sum((Counter(r["causes"]) for r in seen if r),
                               Counter())),
            "pushes": byz.pushes, "forks_minted": byz.forks_minted,
            "proofs": [p for c in cores for p in c.sentry.proofs()
                       if p.creator.upper() == pub]}
    honest_ids = {node.get_id() for node in nodes}
    rec["honest_quarantined"] = sum(
        c.sentry.suspects()["peers"].get(str(h), {}).get("quarantines", 0)
        for c in cores for h in honest_ids)
    log(f"[byz/{label}] {len(nodes)} honest + {len(byzs)} Byzantine: "
        f"fork revealed at {revealed_s} s, attack caught at {caught_s} s "
        f"({rec['caught_at_s']}); lowest block at s: {rec['blocks_at_s']} "
        f"(ended after {run_s:.1f} s); K3 launches {rec['launches']}, batch "
        f"verifications {rec['batch_verifies']} ({k3.empty} without an "
        f"item), by B {dict(sorted(k3.by_b.items()))}; batch verification "
        f"median {rec['median_ms']:.3f} ms, p95 {rec['p95_ms']:.3f} ms over "
        f"{rec['calls']} calls; K3 rejected {k3.rejected} items, single "
        f"re-checks {rec['fallback_singles']}; the fork's branches on K3 "
        f"{pair_on_k3}; adversary events in honest "
        f"stores {held}, forged {forged}; K1 launches {rec['k1_launches']}, "
        f"the batcher's sweeps {rec['k1_sweeps']}; rejections by class "
        f"{rec['rejects']}; adversaries (honest nodes that struck / "
        "quarantined it, causes, pushes, proofs): "
        + str({k: (v["pushed_to"], v["quarantined_by"], v["causes"],
                   v["pushes"], len(v["proofs"])) for k, v in caught.items()})
        + f"; honest nodes quarantined by honest nodes "
        f"{rec['honest_quarantined']}")
    common = check_cluster_blocks(f"byz/{label}", nodes, BYZ_TARGET_BLOCK)
    if rec["fallbacks"]:
        raise AssertionError(f"[byz/{label}] {rec['fallbacks']} offload "
                             "fallbacks")
    if k3.conflicts:
        raise AssertionError(f"[byz/{label}] K3 gave one item two verdicts "
                             f"({k3.conflicts} times)")
    if device_verify:
        if not 0 < rec["launches"] == sum(k3.by_b.values()):
            raise AssertionError(f"[byz/{label}] K3 launches "
                                 f"{rec['launches']} != batch verifications "
                                 f"with an item {sum(k3.by_b.values())} "
                                 "(or none)")
        if rec["launches"] != rec["batch_verifies"] - k3.empty:
            raise AssertionError(f"[byz/{label}] K3 launches "
                                 f"{rec['launches']} != the cores' batch "
                                 f"verifications {rec['batch_verifies']} "
                                 f"less {k3.empty} without an item")
        if pair_on_k3 != [True, True]:
            raise AssertionError(f"[byz/{label}] the fork's two branches "
                                 f"on K3: {pair_on_k3}")
        if rec["fallback_singles"] != k3.rejected:
            raise AssertionError(f"[byz/{label}] single re-checks "
                                 f"{rec['fallback_singles']} != items K3 "
                                 f"rejected {k3.rejected}")
    elif rec["launches"] or k3.by_b or k3.empty:
        raise AssertionError(f"[byz/{label}] the host arm launched K3")
    if forged:
        raise AssertionError(f"[byz/{label}] {forged} forged events in the "
                             "honest nodes' stores")
    if not 0 < rec["k1_launches"] == rec["k1_sweeps"]:
        raise AssertionError(f"[byz/{label}] K1 launches "
                             f"{rec['k1_launches']} != the batcher's sweeps "
                             f"{rec['k1_sweeps']} (or none)")
    for name, v in caught.items():
        if not v["pushed_to"] or v["quarantined_by"] != v["pushed_to"]:
            raise AssertionError(f"[byz/{label}] adversary {name}: "
                                 f"quarantined by {v['quarantined_by']} of "
                                 f"the {v['pushed_to']} honest nodes that "
                                 "struck it")
        if name.startswith("equivocate"):
            if v["forks_minted"] < 1 or not v["proofs"]:
                raise AssertionError(f"[byz/{label}] no equivocation proof "
                                     f"for {name}")
            for p in v["proofs"]:
                if not (p.verify()
                        and EquivocationProof.from_dict(p.to_dict())
                        .verify()):
                    raise AssertionError(f"[byz/{label}] a proof for {name} "
                                         "does not verify")
        v["proofs"] = len(v["proofs"])
    rec["adversaries"] = caught
    rec["replayed_events"] = replay_own_events(f"byz/{label}", nodes[0])
    k3_checks = (f"K3 launches {rec['launches']} = batch verifications "
                 "with an item, re-checks = K3's rejects" if device_verify
                 else "no K3 launch")
    log(f"[byz/{label}] checks passed: identical blocks to {common}, no "
        f"fallback, {k3_checks}, no forged event held, K1 launches = the "
        "batcher's sweeps, every adversary quarantined where it struck; "
        f"node 0 = host replay of {rec['replayed_events']} events")
    return rec, k3


def k3_on_items(label: str, verdicts: dict, want: dict) -> dict:
    """Phase 15 (a): the items K3 saw (``verdicts``: item -> K3's verdict)
    against the plain ladder on the card and the native verifier, in
    batches of at most 16384, and against ``want`` (item -> expected
    verdict) on the items it names. Zero forged items may pass: a False of
    the native verifier where K3 said True fails the run like any other
    difference."""
    import numpy as np
    import torch

    from babble_tpu_torch.ops import verify

    items = list(verdicts)
    k3 = np.array([verdicts[it] for it in items], dtype=bool)
    native = np.array(native_verify_items(items), dtype=bool)
    plain = []
    for i in range(0, len(items), 16384):
        inputs = verify._prepare(items[i:i + 16384], torch.device("cuda"))
        plain.append((verify.shamir_plain(*inputs[1:])
                      & inputs.pre_ok).cpu().numpy())
    plain = np.concatenate(plain) if plain else np.zeros(0, dtype=bool)
    checks = [("the plain ladder on the card", k3, plain),
              ("the native verifier", k3, native)]
    if want:  # the items whose verdict is known in advance
        at = [i for i, it in enumerate(items) if it in want]
        checks.append(("the expected verdicts", k3[at],
                       np.array([want[items[i]] for i in at], dtype=bool)))
    for name, mine, got in checks:
        if not np.array_equal(mine, got):
            bad = np.flatnonzero(mine != got)
            raise AssertionError(f"[byz/{label}] K3 differs from {name} at "
                                 f"{len(bad)} of {len(got)} items "
                                 f"(forged accepted: "
                                 f"{int((mine & ~got).sum())})")
    rec = {"items": len(items), "valid": int(k3.sum()),
           "invalid": int((~k3).sum()), "forged_accepted": 0}
    log(f"[byz/{label}] K3 = plain on the card = native on {len(items)} "
        f"distinct items ({rec['valid']} valid, {rec['invalid']} invalid); "
        "forged items accepted: 0")
    return rec


# phase 15's arms: label, BABBLE_DEVICE_VERIFY. The control arm (the same
# validators with no adversary started) ran beside them until the whole
# script came near its time limit (PERF.md section 5 keeps its numbers).
BYZ_ARMS = {
    "b": ("attack, BABBLE_DEVICE_VERIFY=1", True),
    "c": ("attack, host verifier", False),
}


def byz_child(arm: str, seed: int) -> None:
    """One arm of phase 15 (BYZ_ARMS) in a process of its own, its
    ``BABBLE_DEVICE_VERIFY`` set (or not) before anything is built; after
    (b), (a): K3 against the plain ladder on the card and the native
    verifier on every item (b) gave it and on the crafted set. Prints one
    ``BYZANTINE`` line of JSON for the parent: the arm's record, and for
    (b) (a)'s counts and one real batch of its most frequent B and one of
    its largest, for K3's rows."""
    import os

    import torch

    from babble_tpu_torch.ops import kernels, verify

    label, device_verify = BYZ_ARMS[arm]
    if device_verify:
        os.environ["BABBLE_DEVICE_VERIFY"] = "1"
    else:
        os.environ.pop("BABBLE_DEVICE_VERIFY", None)
    kernels.build()
    torch.cuda.init()
    t0 = time.perf_counter()
    rec, k3 = byz_arm(label, device_verify)
    out = {"arm": rec}
    if device_verify:
        items, want = crafted_k3_set(seed)
        got = verify.batch_verify(items, torch.device("cuda"))
        crafted = dict(zip(items, got.tolist()))
        if any(k3.verdicts.get(it, v) != v for it, v in crafted.items()):
            raise AssertionError("[byz] K3 gave a crafted item another "
                                 "verdict than in the attack")
        out["seen"] = k3_on_items("(a) the attack's items and the crafted "
                                  "set", {**k3.verdicts, **crafted},
                                  dict(zip(items, want)))
        out["seen"]["crafted"] = len(crafted)
        picks = {max(k3.by_b, key=lambda b: (k3.by_b[b], -b)), max(k3.by_b)}
        out["batches"] = {b: [[list(pub), h.hex(), r, s]
                              for pub, h, r, s in k3.batch_at[b]]
                          for b in picks}
    out["seconds"] = time.perf_counter() - t0
    print("BYZANTINE " + json.dumps(out), flush=True)


class Byzantine:
    """Phase 15's arms, started at once, each in a fresh process
    (``byz_child``; each cluster is held by its own GIL, on a host of 8
    cores), so that they meet the same load and phase 15 takes its longest
    arm's time. ``wait`` collects their records (and ends them on an
    error), ``stop`` ends any still running."""

    def __init__(self, seed: int):
        # no env: the offload at its card defaults
        self.children = {arm: FreshChild(f"byz_child({arm!r}, {seed})",
                                         "BYZANTINE", {}, BYZ_TIMEOUT_S)
                         for arm in BYZ_ARMS}
        self.t0 = time.perf_counter()
        self.recs, self.t_arms = None, None

    def wait(self) -> None:
        if self.recs is None:
            try:
                self.recs = {arm: child.result()
                             for arm, child in self.children.items()}
            finally:
                self.stop()
            self.t_arms = time.perf_counter() - self.t0

    def stop(self) -> None:
        for child in self.children.values():
            child.stop()


def byzantine_phase(name_power: str, arms: Byzantine, seed: int) -> list:
    """Phase 15's end: the arms' results, then, with the card to itself,
    K3 against its plain version and timed on (b)'s real batches of its
    most frequent and its largest B, and K1 at the shape (b)'s sweep
    batcher launched most often. Returns the rows of the kernels line."""
    arms.wait()
    recs, t0, t_arms = arms.recs, arms.t0, arms.t_arms
    attack, host = recs["b"]["arm"], recs["c"]["arm"]
    by_b = Counter({int(b): n for b, n in attack["launches_by_b"].items()})
    most = max(by_b, key=lambda b: (by_b[b], -b))
    clock = sm_clock_mhz()
    rows = []
    for b, batch in sorted(recs["b"]["batches"].items(),
                           key=lambda kv: int(kv[0])):
        b = int(b)
        items = [(tuple(pub), bytes.fromhex(h), r, s)
                 for pub, h, r, s in batch]
        k3 = k3_against_plain(items, clock)
        name = ("phase 15 attack, most frequent B" if b == most
                else "phase 15 attack, largest B")
        log(f"[byz] K3 at B {b} ({name}, {by_b[b]} launches in (b)): = "
            f"plain on the card; {k3['ms']:.4f} ms at G {k3['group']}, "
            f"plain {k3['plain_ms']:.1f} ms, bound {k3['bound'][0]:.4g} ms "
            f"({k3['bound'][1]}, {k3['bound'][0] / k3['ms']:.2%} of it)")
        rows.append(k3_row(name, k3, by_b[b], attack["launches"]))
    shapes = Counter()
    for (B, W, P, S), n in attack["sweep_shapes"]:
        shapes[(W, P, S) if B == 1 else (B, W, P, S)] += n
    rows.append(k1_row("phase 15 attack", shapes,
                       {"b": attack["k1_launches"],
                        "c": host["k1_launches"]}, "b", seed=seed))
    seen = recs["b"]["seen"]
    log(f"[byz] phase 15: {time.perf_counter() - t0:.1f} s from its start "
        f"(the arms at once, {t_arms:.1f} s: "
        + ", ".join(f"{arm} {r['seconds']:.1f}" for arm, r in recs.items())
        + f" with (a) after (b)); seconds to block {BYZ_TARGET_BLOCK} (to "
        f"the fork's reveal, to the attack caught): with K3 "
        f"{attack['target_s']} ({attack['revealed_s']}, "
        f"{attack['caught_s']}), with the host verifier {host['target_s']} "
        f"({host['revealed_s']}, {host['caught_s']}); batch verification "
        f"median / p95 ms: K3 {attack['median_ms']:.3f} / "
        f"{attack['p95_ms']:.3f}, host {host['median_ms']:.3f} / "
        f"{host['p95_ms']:.3f}; K3 on {seen['items']} distinct items of (b) "
        f"and the crafted set ({seen['crafted']}): forged accepted 0; "
        f"{name_power or 'nvidia-smi: not available'}")
    return rows


# ``kernel_ab``: phase 2's times there, through functions every version of
# this script has.
_AB_CHILD = """
import json, sys, torch
import chip_smoke as c
from babble_tpu_torch.ops import kernels
kernels.build()
k1, k2, k3_b, blocks = json.loads(sys.argv[1])
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
blk = []
for i, (B, X, Y, P, ldo, col0) in enumerate(blocks):
    n = max(X, Y)
    la, fd = c.k2_inputs(B, n, P, 71 + i)
    a, f = la[..., :X, :].contiguous(), fd[..., n - Y:, :].contiguous()
    out = torch.zeros((*la.shape[:-2], X, ldo), dtype=torch.bool,
                      device="cuda")
    sm = 2 * P // 3 + 1
    blk.append(c.time_on_device(
        lambda: kernels.strongly_see_block(a, f, sm, out, col0)))
print("AB " + json.dumps({
    "floor_ms": c.time_on_device(lambda: torch.cuda._sleep(0)),
    "k1": [c.check_k1(tuple(s), seed=1 + i)["ms"] for i, s in enumerate(k1)],
    "k2": [c.check_k2(tuple(s), seed=51 + i)["ms"] for i, s in enumerate(k2)],
    "k3": k3,
    "blocks": blk,
}))
"""


def kernel_ab(trees) -> None:
    """Phase 2's kernel times, K2's block form at every shape of
    K2_BLOCK_SHAPES (at the tile each tree's C entry picks), and K3's at
    every B of VERIFY_TIMED_B, in each tree of ``trees`` (checkouts of this repo, each with its own
    build), one fresh process per tree, in the
    order given (old, new, new, old compares two commits on one card);
    prints one line per tree and shape, and a table of the per-tree
    medians."""
    import os
    import subprocess

    blocks = [shape for shape, _ in K2_BLOCK_SHAPES]
    shapes = json.dumps([K1_SHAPES, K2_SHAPES, VERIFY_TIMED_B, blocks])
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
    names = ([("K1", "k1", i, s) for i, s in enumerate(K1_SHAPES)]
             + [("K2", "k2", i, s) for i, s in enumerate(K2_SHAPES)]
             + [("K2 block", "blocks", i, s) for i, s in enumerate(blocks)])
    for tree, recs in by_tree.items():
        floor = statistics.median(r["floor_ms"] for r in recs)
        log(f"[ab] {tree}: {len(recs)} runs, launch floor {floor:.5f} ms")
        for kind, key, idx, shape in names:
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
    ap.add_argument("--k2-tiles", action="store_true",
                    help="only time every tile of K2's block form at the "
                    "collectives' and the square K2's shapes, against the "
                    "plain version, and exit")
    ap.add_argument("--nodes-ab", nargs="+", metavar="TREE",
                    help="only run phase 8's node cluster in each of these "
                    "checkouts in turn (e.g. old new new old) and exit")
    ap.add_argument("--phase", type=int, choices=[14, 15],
                    help="run phase 1 (the device and the build), then only "
                    "this phase")
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
    if args.k2_tiles:
        kernels.build()
        log(kernels.ptxas_report)
        k2_tile_table(args.seed)
        return 0
    if args.phase == 14:
        t0 = time.perf_counter()
        so = kernels.build()
        log(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, {so}")
        live = membership_live()
        try:
            rows = membership_phase(dev["name_power"], args.seed + 106, live)
        finally:
            live.stop()
        finish(rows, dev, t_start)
        return 0
    if args.phase == 15:
        t0 = time.perf_counter()
        so = kernels.build()
        log(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, {so}")
        finish(byzantine_phase(dev["name_power"], Byzantine(args.seed + 107),
                               args.seed + 108), dev, t_start)
        return 0
    # phase 4's stream; its host oracle replays in a child process from
    # here on, beside the card work of phases 1-3 and 5-7
    t0 = time.perf_counter()
    events64, _keys, peers64 = gossip_stream(64, EVENTS_64, args.seed + 1)
    change64 = [(CHANGE_ROUND, peers64.with_removed_peer(peers64.peers[-1]))]
    oracle64_proc = OracleProcess(events64, peers64, change64)
    log(f"[64] stream: {len(events64)} signed events in "
        f"{time.perf_counter() - t0:.2f} s, its oracle started in a child "
        "process (set-up)")
    # phase 6's 64-validator stream and its oracle, in a child process
    # from here on likewise
    dag64_proc = OracleProcess(dag_seed=args.seed + 2)
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
    res16, want16, oracle16 = run_main_path("16", events, peers,
                                            no_resident_arm=True)
    # phase 11 replays both streams against these oracles' decisions
    mesh_streams = [(events, peers, (), want16)]
    profile_sweep("16", oracle16)
    rows = [k1_row("16 validators", k1_shapes(res16),
                   {r["arm"]: r["launches"] for r in res16}, "defaults",
                   seed=args.seed + 100)]

    # Phases 5 and 6: the DAG pipeline, K2's path; counts from 0 to here
    t0 = time.perf_counter()
    snap64, want64_dag, stream_s, dag64_s, build64_s = dag64_proc.result()
    log(f"[dag 64] stream: {EVENTS_DAG_64} signed events in {stream_s:.2f} "
        f"s, oracle replay {dag64_s:.2f} s, in a child process (waited "
        f"{time.perf_counter() - t0:.2f} s; set-up)")
    k2_at = Counter()  # K2 launches on the path, by (B, E, P)
    kernels.reset_launch_counts()
    snap16 = dag_against_oracle("16", *oracle_snapshot(oracle16), k2_at)
    snap64 = dag_against_oracle("64", snap64, want64_dag, build64_s, k2_at)
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

    # Phase 4: 64 validators, one leaving from CHANGE_ROUND on; it runs
    # after phases 5-7, so that the oracle's replay, started with the
    # script, has finished beside them
    res64, want64, h64 = run_main_path(
        "64", events64, peers64, peer_sets=change64, min_slots=2,
        min_blocks_after=(CHANGE_ROUND, MIN_BLOCKS_AFTER_CHANGE),
        oracle=oracle64_proc,
    )
    profile_sweep("64", h64)
    rows.append(k1_row("64 validators", k1_shapes(res64),
                       {r["arm"]: r["launches"] for r in res64}, "defaults",
                       seed=args.seed + 101))
    mesh_streams.append((events64, peers64, change64, want64))
    single_64 = next(r for r in res64 if r["arm"] == "min_window=0")
    del h64

    # Phase 8: 16 nodes on the card in one (fresh) process; counts from 0
    # to the end of each arm, in that process; here meanwhile, phase 10's
    # plain ladder and Python oracle
    t0 = time.perf_counter()
    arms, ahead = node_cluster_fresh(lambda: verify_ahead(args.seed + 10))
    log(f"[nodes] phase 8: {time.perf_counter() - t0:.1f} s (phase 10's "
        "plain ladder and oracle beside it)")
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
    k3_rows = device_verification(args.seed + 10, ahead)
    rows += k3_rows
    log(f"[verify] phase 10: {time.perf_counter() - t0:.1f} s")

    # the bench ledger and its gate, over phases 8 and 10's numbers
    t0 = time.perf_counter()
    ledger_gate(arms, k3_rows, dev["name_power"])
    log(f"[ledger] {time.perf_counter() - t0:.1f} s")

    # Phase 14's live cluster, in a fresh process, from here on beside
    # phases 11-13 (K1 counted from 0 there before its nodes are built)
    live = membership_live()
    byz = []  # phase 15's arms, once phase 14's live cluster has ended
    try:
        # Phase 11: the mesh, on virtual shards of the card; counts from 0
        # for each run
        t0 = time.perf_counter()
        rows += mesh_phase(args.seed + 200, mesh_streams, single_64,
                           batch_arrays, batch_sm)
        log(f"[mesh] phase 11: {time.perf_counter() - t0:.1f} s")

        # Phase 12: the mobile binding, two MobileNodes on the card in a
        # fresh process; K1 counted from 0 there before the nodes start
        t0 = time.perf_counter()
        mobile = mobile_fresh()
        rows.append(k1_row("mobile pair", k1_shapes([mobile]),
                           {"mobile": mobile["launches"]}, "mobile",
                           seed=args.seed + 104))
        log(f"[mobile] phase 12: {time.perf_counter() - t0:.1f} s")

        # Phase 13: babblelint, then a lock-checked cluster on the card in
        # a fresh process; K1 counted from 0 there before its nodes are
        # built
        rows.append(static_analysis_phase(dev["name_power"],
                                          args.seed + 105))

        # Phase 14: membership churn, its replays in a fresh process (K1
        # counted from 0 before each arm), then the live cluster's result.
        # Phase 15: the Byzantine fault model (config 5), its arms at once
        # in fresh processes (K3 and K1 counted from 0 in each once its
        # nodes are up), started once phase 14's live cluster has ended
        # (beside it, three 16-node clusters would share 8 cores) and run
        # beside phase 14's replays; both end before phase 14's K1 checks
        def start_byz():
            byz.append(Byzantine(args.seed + 107))
            return byz[0].wait

        rows += membership_phase(dev["name_power"], args.seed + 106, live,
                                 start_byz)
        rows += byzantine_phase(dev["name_power"], byz[0], args.seed + 108)
    finally:
        live.stop()
        for arms in byz:
            arms.stop()
    finish(rows, dev, t_start)
    return 0


def finish(rows, dev, t_start: float) -> None:
    """The run's last lines: its time, the card's name and power limit,
    the kernels line and the device line."""
    import torch

    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(dev["name_power"] or "nvidia-smi: not available")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
