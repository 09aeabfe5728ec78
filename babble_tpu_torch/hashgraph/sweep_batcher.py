"""SweepBatcher — one device sweep for all co-located nodes' windows.

The PyTorch counterpart of the JAX package's
``babble_tpu/hashgraph/sweep_batcher.py`` (its single-device lane).
Multi-validator hosts (the 16-node threaded topology, tests, any
in-process cluster) run many consensus engines against one card. Without
the batcher each node enqueues its own sweep of some 530 torch operations,
and among 16 threads each enqueue waits on the GIL (PERF.md §5).

The batcher coalesces them: flush requests arriving within a short window
are grouped, padded to the group's elementwise-max shape bucket, stacked along a leading batch axis
and swept by ONE fused program (``ops.voting.launch_batched``: one K1
launch) with ONE device-to-host copy, from one thread. This is the
architecture BASELINE.md's config 3 calls for — one chip deciding for many
co-located validators.

Semantics: the batch axis never mixes windows, so each window's
``[fame | round_received]`` is bit-identical to its single sweep (pinned by
tests/test_torch_sweep_batcher.py). A lone window is swept singly
(``ops.voting.launch_sweep``); two or more ride one batched sweep. The JAX
package instead pads every batch to a fixed ``MAX_BATCH`` and to a shape
target that only grows (decaying after many smaller waves), and sends a
wave singly until its batched program has compiled: all to stay on
compiled programs. The port compiles nothing per shape, so none of it
applies here.

The dispatcher thread owns one CUDA stream per card. It waits for a wave's
copy on a CUDA event (``synchronize()`` releases the GIL) while holding no
lock, so submissions keep arriving. An error fails every ticket of the
wave; the owning TensorConsensus decides what it means (a stale window is
neutral, a store error falls back to the oracle, anything else — a CUDA
error — raises out of its flush). The mesh lane (the JAX coprocessor mode)
is not ported: a mesh submission raises NotImplementedError.

Enabled per node by ``BABBLE_ACCEL_BATCH=1``, or by default on a card
(TensorConsensus resolves it). The batcher is in-process by design;
separate node processes keep the admission slots instead.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

from babble_tpu_torch.ops import voting
from babble_tpu_torch.ops.device import DeviceLike, resolve_device
from babble_tpu_torch.ops.window_state import StaleWindowError

logger = logging.getLogger("babble_tpu_torch.hashgraph.sweep_batcher")


class Ticket:
    """One node's submitted window; the batcher delivers (fame, rr) or an
    error. ``done`` is set exactly once."""

    __slots__ = ("win", "device", "result", "error", "done", "batch_size",
                 "device_s")

    def __init__(self, win, device: torch.device):
        self.win = win
        self.device = device
        self.result = None  # (fame, rr) numpy arrays
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.batch_size = 0  # how many windows shared the sweep
        # the device seconds of the sweep it rode, the whole batch's: every
        # ticket of a batched sweep carries the same
        self.device_s: Optional[float] = None


class SweepBatcher:
    """Process-wide coalescing dispatcher (one daemon thread)."""

    _instance: Optional["SweepBatcher"] = None
    _instance_lock = threading.Lock()

    #: how long the dispatcher waits after the first submission for
    #: co-located nodes' flushes to land. Gossip heartbeats are >= 10 ms,
    #: so a few ms captures one flush wave without visible decision latency.
    COALESCE_S = 0.004
    #: most windows in one batched sweep; a larger wave is split
    MAX_BATCH = 16
    #: refuse submissions past this backlog: the caller's oracle is cheaper
    #: than queueing behind a convoy (the admission-slot economics, kept).
    MAX_QUEUE = 32

    def __init__(self) -> None:
        # Reentrant, so that a caller holding it (a test) can queue several
        # windows before the dispatcher takes the wave.
        self._lock = threading.RLock()
        self._pending: List[Ticket] = []
        self._work = threading.Event()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._dispatching = False  # a wave taken and not yet delivered
        # stats
        self.batches = 0  # batched sweeps (>= 2 windows)
        self.singles = 0  # lone windows swept singly
        self.windows = 0  # windows served
        self.max_batch_seen = 0
        self.refused = 0  # submissions bounced by backpressure
        # sweeps by (B, W, P, S), B = 1 for a single sweep: on a card, one
        # K1 launch each
        self.sweep_shapes: Counter = Counter()
        # per group swept: the dispatcher's wall and CPU seconds from the
        # repad to the end of the enqueue, and its wall seconds waiting for
        # the output on the host
        self.dispatch_s = 0.0
        self.dispatch_cpu_s = 0.0
        self.readback_s = 0.0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sweep-batcher"
        )
        self._thread.start()

    @classmethod
    def instance(cls) -> "SweepBatcher":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def submit(self, win, device: DeviceLike = None,
               mesh=None) -> Optional[Ticket]:
        """Queue a window for the next coalesced sweep on ``device`` (the
        card by default), or return None when the batcher is backlogged —
        the caller must run its oracle, as when it loses an admission
        slot."""
        if mesh is not None:
            raise NotImplementedError(
                "SweepBatcher: the mesh lane is not ported yet; see the "
                "port's queue in ROADMAP.md"
            )
        dev = resolve_device(device)
        with self._lock:
            if len(self._pending) >= self.MAX_QUEUE:
                self.refused += 1
                return None
            t = Ticket(win, dev)
            self._pending.append(t)
        self._work.set()
        return t

    def idle(self) -> bool:
        """True when no window is queued or being swept."""
        with self._lock:
            return not self._pending and not self._dispatching

    def stats(self) -> dict:
        return {
            "batch_batches": self.batches,
            "batch_singles": self.singles,
            "batch_windows": self.windows,
            "batch_max": self.max_batch_seen,
            "batch_refused": self.refused,
            "batch_dispatch_ms": round(1000.0 * self.dispatch_s, 1),
            "batch_dispatch_cpu_ms": round(1000.0 * self.dispatch_cpu_s, 1),
            "batch_readback_ms": round(1000.0 * self.readback_s, 1),
            # the coprocessor (mesh) lane is not ported: no mesh waves
            "copro_waves": 0,
            "copro_windows": 0,
            "copro_validators": 0,
        }

    # -- dispatcher ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            self._work.wait()
            # Let the rest of the flush wave land before grouping: nodes
            # flush on the same gossip cadence, so the first submission
            # predicts more within a few ms.
            time.sleep(self.COALESCE_S)
            with self._lock:
                batch, self._pending = self._pending, []
                self._work.clear()
                self._dispatching = bool(batch)
            if batch:
                try:
                    self._dispatch(batch)
                except BaseException as err:  # never kill the daemon
                    for t in batch:
                        if not t.done.is_set():
                            t.error = err
                            t.done.set()
                    logger.warning("sweep batch dispatch failed",
                                   exc_info=True)
                finally:
                    with self._lock:
                        self._dispatching = False

    def _dispatch(self, tickets: List[Ticket]) -> None:
        """Split the wave into one lane per device, and a lane into groups
        of at most MAX_BATCH windows."""
        lanes: Dict[torch.device, List[Ticket]] = {}
        for t in tickets:
            lanes.setdefault(t.device, []).append(t)
        for device, lane in lanes.items():
            for i in range(0, len(lane), self.MAX_BATCH):
                self._dispatch_group(device, lane[i:i + self.MAX_BATCH])

    def _gate_stale(self, group: List[Ticket]) -> List[Ticket]:
        # Resident-state generation gate: windows snapshotted from a
        # WindowState carry (state, generation). If the state mutated
        # between submit and dispatch (a rebuild, an invalidate), the
        # window's row maps are stale: fail the ticket now and let that
        # node's oracle carry the flush. Stale generations never ride a
        # sweep, so one validator's reset never touches a neighbour's.
        fresh: List[Ticket] = []
        for t in group:
            state = t.win.state
            if state is not None and state.generation != t.win.generation:
                t.error = StaleWindowError(
                    f"window generation {t.win.generation} != state "
                    f"generation {state.generation}"
                )
                t.done.set()
                continue
            fresh.append(t)
        return fresh

    def _dispatch_group(self, device: torch.device,
                        group: List[Ticket]) -> None:
        group = self._gate_stale(group)
        if not group:
            return
        # Co-located nodes at slightly different DAG progress land in
        # different shape buckets: the group pads to its own elementwise-max
        # bucket (the builder's neutral fills, bit-identical decisions; real
        # rows keep their indexes) and rides one sweep. The JAX package pads
        # to a target that only grows, decaying slowly, to stay on one
        # compiled program; the port compiles nothing per shape, so a wave
        # pays for no larger rows than its own.
        keys = [voting.bucket_key(t.win) for t in group]
        key = tuple(max(k[d] for k in keys) for d in range(5))
        batched = len(group) > 1
        t0, c0 = time.perf_counter(), time.thread_time()
        wins = [t.win for t in group]
        try:
            if batched:
                host, device_s = self._sweep(device, t0, c0, lambda: (
                    voting.launch_batched(wins, device, key)))
            else:
                host, device_s = self._sweep(device, t0, c0, lambda: (
                    voting.launch_sweep(wins[0], device)[None]))
            results = voting.read_batched(host, wins, key)
        except BaseException as err:
            for t in group:
                t.error = err
                t.done.set()
            return
        W, _E, P, S, _R = key
        shape = (len(wins), W, P, S)
        self.sweep_shapes[shape] += 1
        if batched:
            self.batches += 1
        else:
            self.singles += 1
        self.windows += len(group)
        self.max_batch_seen = max(self.max_batch_seen, len(group))
        for t, result in zip(group, results):
            t.batch_size = len(group)
            t.device_s = device_s
            t.result = result
            t.done.set()

    def _sweep(self, device: torch.device, t0: float, c0: float, launch):
        """Run ``launch()`` (a sweep enqueue) and bring its output to the
        host: on a card on this thread's stream, with a copy into pinned
        memory behind a CUDA event that this thread waits on with the GIL
        released; on the CPU directly. The group's dispatch, counted from
        ``t0`` (wall) and ``c0`` (this thread's CPU), ends with the
        enqueue; its readback is the wait. Returns (output as numpy, the
        sweep's device seconds: CUDA events from before the upload to after
        the copy-out on a card, the synchronous compute on the CPU)."""
        if device.type != "cuda":
            host = launch()
            t1 = time.perf_counter()
            self.dispatch_s += t1 - t0
            self.dispatch_cpu_s += time.thread_time() - c0
            return host.numpy(), t1 - t0
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = launch()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done.record(stream)
        t1 = time.perf_counter()
        self.dispatch_s += t1 - t0
        self.dispatch_cpu_s += time.thread_time() - c0
        done.synchronize()
        self.readback_s += time.perf_counter() - t1
        return host.numpy(), start.elapsed_time(done) / 1000.0
