"""TensorConsensus — drives the device voting sweep for a live Hashgraph.

Attached as ``hg.accel``, it makes ``Hashgraph.insert_event_and_run_consensus``
defer DecideFame / DecideRoundReceived to batched device sweeps (the
reference runs them per insert, hashgraph.go:644-668; here one sweep covers
a whole sync). Round and witness assignment stay on the host, per insert.

Two modes:

- **Synchronous** (the default on the CPU): snapshot the undecided window,
  run the fused sweep, read back one buffer, apply.
- **Pipelined** (the default on a CUDA card): each flush first applies the
  PREVIOUS sweep's results, then snapshots and launches the next sweep on a
  side CUDA stream, whose output is copied without blocking into pinned
  host memory behind a recorded CUDA event. A flush polls that event and
  never waits on it: one that finds the sweep still running defers to the
  next flush. Applying a snapshot's decisions after later inserts is the
  hashgraph's incremental == batch property, so consensus output is
  identical; only decision latency shifts by one flush.

Two options, resolved as the JAX package resolves them:

- **Resident windows** (``resident``, on unless ``BABBLE_ACCEL_RESIDENT``
  is ``"0"``): the snapshot is a persistent ``ops.window_state.WindowState``
  updated in O(ΔE) per sweep, and without the batcher the window's rows
  stay on the device between sweeps (only the delta is uploaded). Results
  apply only while the snapshot's generation is the state's; an oracle
  pass, a fallback or ``invalidate`` marks the state dirty.
- **The sweep batcher** (``batcher``, ``BABBLE_ACCEL_BATCH=1/0``, else on
  exactly on a card): the window goes to the process-wide
  ``SweepBatcher``, which sweeps every co-located node's window of a flush
  wave in one batched sweep; a flush polls its ticket.

A ``mesh`` (``parallel/mesh.Mesh``) splits each sweep's witness axis over
its shards (``parallel/voting_shard.py``): a window whose W the mesh size
does not divide is padded to it (``mesh_pad_rows``); only a mesh with an odd
factor, which no power-of-two bucket divides, sends the window to the
single-device sweep, counted in ``mesh_fallbacks``. Resident windows keep
per-shard buffers; with the batcher, windows ride its coprocessor lane,
shared by every validator on the same mesh. The shard devices must be of
the offload device's type.

Admission control (without the batcher): co-located nodes (threads of one
process, or processes sharing ``BABBLE_ACCEL_SLOT_DIR``) share one card,
and at most ``_MAX_INFLIGHT`` pipelined sweeps are in flight on it at once.
A flush that finds every slot taken, or the batcher backlogged, lets the
oracle carry it and counts in ``contended`` — the small-window economics
of ``min_window``, not a fault.

A store eviction (``StoreError``) inside a sweep is consensus semantics:
the oracle carries that flush and it counts in ``fallbacks``, as does an
admission slot file that cannot be opened. A window that went stale before
its results could apply (``StaleWindowError``, or a generation moved on)
is neutral: the oracle carries the flush and it counts in ``stale_drops``.
Every other failure — a kernel launch error, any CUDA error, a device OOM,
a sweep or batcher ticket still not done ``readback_timeout_s`` after it
was enqueued — propagates out of ``flush``: on a card the kernels are the
path, and a broken one is never turned into host consensus. The kernels are built when a CUDA
TensorConsensus is constructed, so a build failure raises at start-up.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import Counter
from typing import Optional

import torch

from babble_tpu_torch.common.breaker import CircuitBreaker
from babble_tpu_torch.common.errors import StoreError
from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
from babble_tpu_torch.ops import kernels, voting, window_state
from babble_tpu_torch.ops.device import DeviceLike, resolve_device
from babble_tpu_torch.ops.window_state import StaleWindowError, WindowState
from babble_tpu_torch.parallel import voting_shard
from babble_tpu_torch.parallel.mesh import aligned_width, check_device_type

logger = logging.getLogger("babble_tpu_torch.hashgraph.accel")


def _breaker_from_env(clock=None) -> CircuitBreaker:
    """Device-path circuit breaker with env-tunable parameters: open after
    BABBLE_ACCEL_BREAKER_N failures within BABBLE_ACCEL_BREAKER_WINDOW_S
    seconds, refuse the device for BABBLE_ACCEL_BREAKER_COOLDOWN_S, then
    probe one sweep to half-open/re-close. ``clock`` (a common.clock.Clock
    or bare monotonic callable) makes the trip window and cooldown run on
    the node's time source — virtual under the sim engine."""
    return CircuitBreaker(
        threshold=max(1, int(os.environ.get("BABBLE_ACCEL_BREAKER_N", "5"))),
        window_s=float(os.environ.get("BABBLE_ACCEL_BREAKER_WINDOW_S", "30")),
        cooldown_s=float(
            os.environ.get("BABBLE_ACCEL_BREAKER_COOLDOWN_S", "15")
        ),
        **({"clock": clock} if clock is not None else {}),
    )


# Sweep admission control. Co-located nodes (multi-validator hosts, a
# threaded cluster, tests) share ONE card; without a cap their sweeps
# convoy on it and per-sweep latency balloons. Flushes that lose the race
# ride the oracle, the economics min_window already encodes.
#
# Two scopes:
# - in-process (default): a plain semaphore covers threads in one
#   interpreter;
# - cross-process (BABBLE_ACCEL_SLOT_DIR): flock-guarded slot files, so
#   independent node PROCESSES on one host coordinate too — per-process
#   semaphores can't see each other, and 4 processes x 2 slots would put
#   8 sweeps in flight on one card.
_MAX_INFLIGHT = 2


class _FlockSlots:
    """Semaphore-shaped admission slots shared ACROSS processes via
    non-blocking flock on a fixed set of slot files. Locks die with the
    process, so a crashed node can never leak a slot."""

    def __init__(self, dir_path: str, n: int):
        os.makedirs(dir_path, exist_ok=True)
        self._paths = [
            os.path.join(dir_path, f"sweep-slot-{i}.lock") for i in range(n)
        ]
        self._lock = threading.Lock()
        self._held: list = []  # (path, fd) LIFO

    def acquire(self, blocking: bool = False) -> bool:
        import fcntl

        if blocking:
            raise ValueError("admission slots are try-acquire only")
        with self._lock:
            held_paths = {p for p, _ in self._held}
            for p in self._paths:
                if p in held_paths:
                    continue
                fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o644)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    os.close(fd)
                    continue
                self._held.append((p, fd))
                return True
            return False

    def release(self) -> None:
        import fcntl

        with self._lock:
            if not self._held:
                return
            _, fd = self._held.pop()
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


_INFLIGHT_SLOTS = None
_slots_lock = threading.Lock()
# The process's sweeps that hold a slot. A slot is freed when its node's
# next flush finds the sweep landed; a node that stops flushing (shut down,
# or out of syncs) must not keep it, so a launch that finds every slot
# taken first frees those of sweeps that have landed.
_HOLDERS: set = set()


def _inflight_slots():
    """The process-wide admission slots, ``_MAX_INFLIGHT`` of them, made
    on first use: flock files in BABBLE_ACCEL_SLOT_DIR when it is set,
    else a semaphore."""
    global _INFLIGHT_SLOTS
    if _INFLIGHT_SLOTS is None:
        with _slots_lock:
            if _INFLIGHT_SLOTS is None:
                slot_dir = os.environ.get("BABBLE_ACCEL_SLOT_DIR")
                if slot_dir:
                    _INFLIGHT_SLOTS = _FlockSlots(slot_dir, _MAX_INFLIGHT)
                else:
                    _INFLIGHT_SLOTS = threading.Semaphore(_MAX_INFLIGHT)
    return _INFLIGHT_SLOTS


def _reap_landed() -> None:
    """Free the slots of sweeps that have landed but whose node has not
    flushed since."""
    with _slots_lock:
        holders = list(_HOLDERS)
    for inf in holders:
        if inf.landed():
            inf.release_slot()


class _Inflight:
    """A launched sweep: its window and resident snapshot, its output (a
    pinned host buffer being filled behind ``done`` on a card; the finished
    output on the CPU; a batcher ticket), the events that time it on the
    device, and the admission slot it holds until the device is done with
    it."""

    __slots__ = ("win", "snap", "host", "done", "start", "ticket",
                 "t_enqueued", "slots", "t_acquired", "t_released", "perf")

    def __init__(self, win, host, done, start, t_enqueued: float, perf,
                 snap=None, ticket=None):
        self.win = win
        self.snap = snap  # the WindowState snapshot, or None
        self.host = host
        self.done = done  # torch.cuda.Event, or None on the CPU
        self.start = start  # torch.cuda.Event recorded before the upload
        self.ticket = ticket  # the SweepBatcher's Ticket, or None
        self.t_enqueued = t_enqueued  # the host has handed the card all of it
        self.perf = perf
        self.slots = None
        self.t_acquired = self.t_released = 0.0

    def hold(self, slots, t_acquired: float) -> None:
        self.slots, self.t_acquired = slots, t_acquired
        with _slots_lock:
            _HOLDERS.add(self)

    def landed(self) -> bool:
        """True once the output is on the host. Never blocks; a CUDA error
        raises here."""
        if self.ticket is not None:
            return self.ticket.done.is_set()
        return self.done is None or self.done.query()

    def release_slot(self) -> None:
        """Free the admission slot, once, whoever calls first."""
        with _slots_lock:
            slots, self.slots = self.slots, None
            if slots is None:
                return
            _HOLDERS.discard(self)
            self.t_released = self.perf()
        slots.release()

    def slot_seconds(self) -> float:
        return max(0.0, self.t_released - self.t_acquired)

    def device_seconds(self) -> Optional[float]:
        """Upload + sweep + copy-out time on the device (once landed); for
        a batcher ticket, that of the sweep it rode, the whole batch's."""
        if self.ticket is not None:
            return self.ticket.device_s
        if self.done is None:
            return None
        return self.start.elapsed_time(self.done) / 1000.0


class TensorConsensus:
    """The port's device offload, attached as ``hg.accel``. The hashgraph
    calls ``should_sweep``, ``busy``, ``flush`` and ``invalidate``; nodes
    read ``stats()`` and the counters the node telemetry scrapes
    (``sweeps``, ``fallbacks``, ``stale_drops`` and the rest below).
    ``device`` defaults to ``cuda`` and raises without a card. ``clock``
    (a common.clock.Clock) times the breaker and the stages; ``owner``
    names the validator in the offload's log lines."""

    def __init__(self, device: DeviceLike = None, sweep_events: int = 256,
                 min_window: int | None = None,
                 pipeline: bool | None = None,
                 mesh=None,
                 batcher: bool | None = None,
                 resident: bool | None = None,
                 clock=None,
                 owner: str | None = None):
        self.device = resolve_device(device)
        self.owner = owner
        self._perf = (clock.perf_counter if clock is not None
                      else time.perf_counter)
        self._stream = None
        if self.device.type == "cuda":
            kernels.build()  # a build failure raises here, at start-up
            self._stream = torch.cuda.Stream(self.device)
        # the sweep's programs, compiled once per process, here
        voting.script_programs()
        on_card = self.device.type == "cuda"
        # Force a sweep mid-batch once this many inserts accumulate, so the
        # window stays inside one shape bucket even under huge syncs. Normal
        # cadence is one sweep per gossip round (core.sync flush).
        self.sweep_events = sweep_events
        # Crossover threshold: below this many undetermined events the
        # incremental oracle beats the sweep's fixed launch + readback cost
        # (the JAX package's accelerator default of 192, its host default
        # of 256). 0 forces the device path (tests).
        if min_window is None:
            env = os.environ.get("BABBLE_ACCEL_MIN_WINDOW")
            if env is not None:
                min_window = int(env)
            else:
                min_window = 192 if on_card else 256
        self.min_window = min_window
        # Pipelined sweeps hide the readback behind the next sync; on by
        # default on a card, BABBLE_ACCEL_PIPELINE=1/0 forces either way.
        if pipeline is None:
            env = os.environ.get("BABBLE_ACCEL_PIPELINE")
            pipeline = on_card if env is None else env == "1"
        self.pipeline = pipeline
        # Co-located batching through the process-wide SweepBatcher: on by
        # default on a card, where one batched sweep for every node of a
        # flush wave replaces one sweep per node; BABBLE_ACCEL_BATCH=1/0
        # forces either way.
        if batcher is None:
            env = os.environ.get("BABBLE_ACCEL_BATCH")
            batcher = on_card if env is None else env == "1"
        self.batcher = batcher
        # Incremental resident windows, on unless BABBLE_ACCEL_RESIDENT=0.
        # With the batcher the host side stays incremental but windows are
        # submitted as copies (a batched sweep stacks them; no per-node
        # device buffers).
        if resident is None:
            resident = os.environ.get("BABBLE_ACCEL_RESIDENT") != "0"
        self.resident = resident
        self.window_state = WindowState() if resident else None
        self._mesh = None
        self.mesh = mesh
        if resident:
            window_state.script_programs()
        # A store eviction falls back to the oracle for its flush; repeated
        # ones open the breaker for a cooldown, then a probe sweep
        # re-enables the path.
        self.breaker = _breaker_from_env(clock)
        # A pipelined sweep still not done this long after the host enqueued
        # it means a wedged card: flush raises TimeoutError.
        self.readback_timeout_s = 30.0
        self.sweeps = 0
        self.fallbacks = 0
        self.small_windows = 0  # flushes routed to the oracle by min_window
        self.stale_drops = 0  # sweeps dropped by invalidate() or as stale
        self.deferred = 0  # flushes that rode behind a running sweep
        self.contended = 0  # launches skipped: card at max in-flight sweeps
        self.rows_delta_total = 0  # window rows packed from the store
        self.rows_reused_total = 0  # window rows kept from the last sweep
        self.delta_sweeps = 0  # sweeps that uploaded only the delta
        # The node telemetry reads this under the JAX package's name: the
        # port compiles nothing while it runs.
        self.compile_waits = 0
        # Witness rows added to align windows to the mesh, and windows that
        # still swept on one device (a mesh with an odd factor).
        self.mesh_pad_rows = 0
        self.mesh_fallbacks = 0
        # applied sweeps per window shape bucket (W, E, P, S, R)
        self.buckets: Counter = Counter()
        self._last_snapshot_topo = -1
        self.last_sweep_s = 0.0
        self.total_sweep_s = 0.0
        self.last_window_events = 0
        # Per-stage rolling sums (seconds): build = a from-scratch window
        # build, delta_scan + pack = the resident window's incremental
        # snapshot, dispatch = upload + enqueue (a batcher submission's
        # hand-off), readback = until the output is on the host (a
        # synchronous sweep waits for it; a pipelined one counts from the
        # end of its enqueue, or its ticket's submission, to the flush that
        # finds it landed), kernel = the sweep on the device (CUDA events on
        # a card, from the upload to the copy-out, gaps in the host's
        # enqueue included; the synchronous compute on the CPU; under the
        # batcher, the batched sweep the window rode, shared by its B
        # windows), apply = host write-back.
        self.stage_s = {
            "build": 0.0, "delta_scan": 0.0, "pack": 0.0, "dispatch": 0.0,
            "readback": 0.0, "kernel": 0.0, "apply": 0.0,
        }
        # Of the pipelined sweeps' dispatch stage, the time the thread ran
        # on a CPU (the rest of its wall time it waited, for the GIL or a
        # core); and the time those sweeps held an admission slot.
        self.dispatch_cpu_s = 0.0
        self.slot_held_s = 0.0
        # Optional per-sample stage observer, called as obs(stage, seconds).
        self.stage_observer = None
        self._inflight: Optional[_Inflight] = None

    @property
    def mesh(self):
        """The device mesh the sweeps are split over, or None."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        """Attach a mesh (or None), as the node does once it knows its
        devices. Raises ValueError when a shard device is not of the
        offload device's type. The resident state follows and rebuilds at
        its next snapshot."""
        if mesh is not None:
            check_device_type(mesh, self.device)
        self._mesh = mesh
        if self.window_state is not None:
            self.window_state.mesh = mesh
            self.window_state.mark_dirty("mesh")

    def _use_mesh(self, win) -> bool:
        """True when the sweep of ``win`` takes the sharded path: a mesh is
        attached and its size divides the witness axis. Windows are padded
        to that (``_mesh_align``) before they get here; one that is not
        (an odd-factor mesh, counted in mesh_fallbacks) sweeps on one
        device."""
        return (self._mesh is not None
                and win.n_witnesses % self._mesh.size == 0)

    def _mesh_align(self, win):
        """Pad the witness axis so that the mesh size divides it
        (``voting.repad_window``: neutral fills, real rows keep their
        indexes, decisions identical), counting the rows added in
        mesh_pad_rows. Where no padding can (``mesh.aligned_width``: a mesh
        with an odd factor), mesh_fallbacks counts one and the window comes
        back unchanged."""
        if win.n_witnesses % self._mesh.size == 0:
            return win
        key = voting.bucket_key(win)
        W_m = aligned_width(key[0], self._mesh.size)
        if W_m is None:
            self.mesh_fallbacks += 1
            return win
        padded = voting.repad_window(win, (W_m,) + key[1:])
        self.mesh_pad_rows += W_m - key[0]
        return padded

    def _copro_owner(self) -> str:
        """This validator's name in the batcher's coprocessor stats."""
        return self.owner if self.owner else f"tc-{id(self):x}"

    def _stage(self, stage: str, seconds: float) -> None:
        self.stage_s[stage] += seconds
        obs = self.stage_observer
        if obs is not None:
            obs(stage, seconds)

    # -- gates --------------------------------------------------------------

    def should_sweep(self, pending_inserts: int) -> bool:
        return pending_inserts >= self.sweep_events

    def use_device(self, undetermined: int) -> bool:
        """Window-size gate: route small windows to the oracle."""
        if undetermined >= self.min_window:
            return True
        self.small_windows += 1
        return False

    def busy(self) -> bool:
        """True while decisions are pending on an in-flight sweep."""
        return self._inflight is not None

    def invalidate(self) -> None:
        """Drop any in-flight sweep (hashgraph reset / fast-sync landing):
        its snapshot no longer describes this store. Its admission slot is
        released now, and the resident state rebuilds at the next
        snapshot."""
        inf = self._inflight
        if inf is not None:
            self.stale_drops += 1
            inf.release_slot()
            self.slot_held_s += inf.slot_seconds()
            # the dropped sweep never reports an outcome; if it was the
            # half-open probe, release the probe slot
            self.breaker.cancel()
        self._inflight = None
        self._last_snapshot_topo = -1
        if self.window_state is not None:
            self.window_state.mark_dirty("invalidate")

    # -- flush entry point ---------------------------------------------------

    def flush(self, hg) -> bool:
        """Handle one consensus flush. Returns False when the caller must
        run the oracle voting stages instead — and then marks the resident
        state dirty, because the oracle pass that follows mutates fame and
        round-received state the mirrors cannot track in O(ΔE)."""
        # the hashgraph's delta channels (new witnesses, first-descendant
        # updates) run exactly when a WindowState consumes them
        hg._accel_track_delta = self.resident
        handled = self._flush(hg)
        if not handled and self.window_state is not None:
            self.window_state.mark_dirty("oracle-pass")
            # Discard the channels too: the rebuild that follows reads the
            # store, and on a node whose windows never pass min_window no
            # snapshot would ever drain them.
            hg.drain_accel_delta()
        return handled

    def _flush(self, hg) -> bool:
        if not self.pipeline:
            if not self.use_device(len(hg.undetermined_events)):
                return False
            if not self.breaker.allow():
                return False  # breaker open: the oracle carries the flush
            return self.sweep(hg)

        handled = False
        inf = self._inflight
        if inf is not None:
            if not inf.landed():
                age = self._perf() - inf.t_enqueued
                if age > self.readback_timeout_s:
                    raise TimeoutError(
                        f"accelerated sweep of {self.owner or 'this node'} "
                        f"not done {age:.1f} s after it was enqueued")
                # still on the card: its decisions land at a later flush
                self.deferred += 1
                return True
            self._inflight = None
            self._stage("readback", self._perf() - inf.t_enqueued)
            inf.release_slot()
            self.slot_held_s += inf.slot_seconds()
            if not self._apply(hg, inf):
                return False  # oracle carries this flush
            handled = True
        # Relaunch only when the DAG grew since the last snapshot: a sweep
        # over an identical window returns identical decisions.
        if hg.topological_index != self._last_snapshot_topo and self.use_device(
            len(hg.undetermined_events)
        ):
            if not self.breaker.allow():
                return handled
            launched = self._launch(hg)
            return handled or launched
        return handled

    # -- snapshots and dispatch ----------------------------------------------

    def _snapshot(self, hg):
        """This sweep's window: a from-scratch build, or — resident — an
        O(ΔE) WindowState snapshot (copied rows for the batcher, whose sweep
        outlives the snapshot). Returns (win, snap); win None when nothing
        is undecided, snap None without resident windows."""
        if self.window_state is None:
            t0 = self._perf()
            win = voting.build_voting_window(hg)
            self._stage("build", self._perf() - t0)
            if win is not None and self._mesh is not None:
                win = self._mesh_align(win)
            return win, None
        timers: dict = {}
        try:
            snap = self.window_state.snapshot(hg, timers,
                                              copy_rows=self.batcher)
        finally:
            for k, v in timers.items():
                self._stage(k, v)
        if snap is None:
            return None, None
        self.rows_delta_total += snap.rows_delta
        self.rows_reused_total += snap.rows_reused
        win = snap.win
        if self._mesh is not None:
            # resident windows are aligned at rebuild (WindowState); this
            # counts the odd-factor mesh that no alignment reaches
            win = self._mesh_align(win)
        return win, snap

    def _dispatch(self, win, snap):
        """Enqueue one sweep on the current stream: through the resident
        buffers with a WindowState snapshot, else a full upload. Returns
        the unread output."""
        if snap is None:
            if self._use_mesh(win):
                return voting_shard.launch_sharded_sweep(self._mesh, win)
            if self._mesh is not None:
                self.mesh_fallbacks += 1
            return voting.launch_sweep(win, self.device)
        out, used_delta = self.window_state.dispatch(snap, self.device)
        self.delta_sweeps += used_delta
        return out

    def _submit(self, win, snap):
        """Hand the window to the process-wide batcher. Returns its ticket,
        or None when the batcher is backlogged (``contended``: the oracle
        carries the flush)."""
        ticket = SweepBatcher.instance().submit(
            win, device=self.device, mesh=self._mesh,
            owner=self._copro_owner())
        if ticket is None:
            self.contended += 1
            if snap is not None:
                # the snapshot's delta never reaches a sweep
                self.window_state.drop_residency()
            self.breaker.cancel()
        return ticket

    def _ticket_result(self, ticket):
        """(fame, rr) of a done ticket, or None when it failed stale
        (counted; the oracle carries the flush). A StoreError propagates as
        a fallback; any other error — a CUDA one — raises."""
        err = ticket.error
        if err is None:
            return ticket.result
        if isinstance(err, StaleWindowError):
            self.stale_drops += 1
            self.breaker.cancel()
            return None
        raise err

    # -- pipelined internals -------------------------------------------------

    def _enqueue(self, win, snap) -> _Inflight:
        """Launch the sweep without waiting for it: on a card, on the side
        stream with a non-blocking copy into pinned host memory behind a
        recorded event; on the CPU the sweep is done when this returns."""
        if self._stream is None:
            out = self._dispatch(win, snap)
            return _Inflight(win, out, None, None, self._perf(), self._perf,
                             snap=snap)
        with torch.cuda.stream(self._stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            out = self._dispatch(win, snap)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done.record(self._stream)
        return _Inflight(win, host, done, start, self._perf(), self._perf,
                         snap=snap)

    def _launch(self, hg) -> bool:
        try:
            win, snap = self._snapshot(hg)
        except StoreError as err:
            self._note_fallback(err)
            return False
        if win is None:
            self.breaker.cancel()  # no device attempt to judge
            return True  # nothing undecided
        if self.batcher:
            # the batcher's backpressure replaces the admission slots
            t_d = self._perf()
            ticket = self._submit(win, snap)
            if ticket is None:
                return False
            self._stage("dispatch", self._perf() - t_d)
            self._inflight = _Inflight(win, None, None, None, self._perf(),
                                       self._perf, snap=snap, ticket=ticket)
            self._last_snapshot_topo = hg.topological_index
            return True
        # Admission covers only device occupancy: the window build above
        # runs slot-free so co-located nodes aren't starved during host
        # work.
        try:
            slots = _inflight_slots()
            acquired = slots.acquire(blocking=False)
            if not acquired:
                _reap_landed()
                acquired = slots.acquire(blocking=False)
        except OSError as err:
            # a vanished slot directory or fd exhaustion degrades to the
            # oracle, never kills the gossip path
            self._note_fallback(err)
            return False
        if not acquired:
            self.contended += 1
            if snap is not None:
                self.window_state.drop_residency()
            self.breaker.cancel()
            return False
        t_d, c_d = self._perf(), time.thread_time()
        try:
            inf = self._enqueue(win, snap)
        except BaseException:
            slots.release()
            raise
        inf.hold(slots, t_d)
        if inf.done is None:
            inf.release_slot()  # on the CPU the sweep is done already
        self._stage("dispatch", self._perf() - t_d)
        self.dispatch_cpu_s += time.thread_time() - c_d
        self._inflight = inf
        self._last_snapshot_topo = hg.topological_index
        return True

    def _apply(self, hg, inf: _Inflight) -> bool:
        if inf.ticket is not None:
            try:
                result = self._ticket_result(inf.ticket)
            except StoreError as err:
                self._note_fallback(err)
                return False
            if result is None:
                return False
            fame, rr = result
        else:
            fame, rr = voting.read_sweep(inf.host, inf.win)
        if not self._current(inf.snap):
            return False
        try:
            t_a = self._perf()
            self._write_back(hg, inf.win, inf.snap, fame, rr)
            t_apply = self._perf() - t_a
            kernel_s = inf.device_seconds()
        except StoreError as err:
            self._note_fallback(err)
            return False
        self._stage("apply", t_apply)
        if kernel_s is not None:
            self._stage("kernel", kernel_s)
        self._success(inf.win, (kernel_s or 0.0) + t_apply)
        return True

    def _current(self, snap) -> bool:
        """False (counted as stale) when the resident state moved on since
        ``snap`` was taken: its row maps no longer describe the results,
        which are discarded; the dirty state rebuilds at the next
        snapshot."""
        if snap is None or snap.generation == self.window_state.generation:
            return True
        self.stale_drops += 1
        self.breaker.cancel()  # not the device's fault: no verdict
        return False

    def _write_back(self, hg, win, snap, fame, rr) -> None:
        _decided, fame_applied = voting.apply_fame(hg, win, fame)
        received = voting.apply_round_received(hg, win, rr)
        if snap is not None:
            self.window_state.note_applied(fame_applied, received)

    # -- synchronous sweep ---------------------------------------------------

    def sweep(self, hg) -> bool:
        """One blocking fused sweep. Returns False when the caller must
        fall back to the oracle pipeline."""
        t0 = self._perf()
        try:
            win, snap = self._snapshot(hg)
            if win is None:
                self.breaker.cancel()  # no device attempt to judge
                return True  # nothing undecided
            t1 = self._perf()
            if self.batcher:
                # co-located threads flushing in the same wave share the
                # batched sweep
                ticket = self._submit(win, snap)
                if ticket is None:
                    return False
                t_r = self._perf()
                self._stage("dispatch", t_r - t1)
                if not ticket.done.wait(self.readback_timeout_s):
                    raise TimeoutError(
                        f"batched sweep of {self.owner or 'this node'} not "
                        f"done {self.readback_timeout_s:.0f} s after it was "
                        "submitted")
                result = self._ticket_result(ticket)
                if result is None:
                    return False
                fame, rr = result
                kernel_s = ticket.device_s
            else:
                out = self._dispatch(win, snap)
                t_r = self._perf()
                self._stage("dispatch", t_r - t1)
                fame, rr = voting.read_sweep(out, win)
                kernel_s = None
            t2 = self._perf()
            self._stage("readback", t2 - t_r)
            self._stage("kernel", t2 - t1 if kernel_s is None else kernel_s)
            self._write_back(hg, win, snap, fame, rr)
            self._stage("apply", self._perf() - t2)
        except StoreError as err:
            self._note_fallback(err)
            return False
        self._success(win, self._perf() - t0)
        return True

    def _success(self, win, seconds: float) -> None:
        self.breaker.record_success()
        self.sweeps += 1
        self.buckets[voting.bucket_key(win)] += 1
        self.last_window_events = len(win.hashes)
        self.last_sweep_s = seconds
        self.total_sweep_s += seconds

    def _note_fallback(self, err: Exception) -> None:
        # A store eviction degrades to the oracle, not a dead sync.
        # Writebacks are ordered so no partial mutation precedes a fallible
        # read (see apply_round_received), making the oracle re-run safe.
        self.fallbacks += 1
        self.breaker.record_failure()
        if self.window_state is not None:
            # the oracle pass that follows mutates state the mirrors cannot
            # track; the next snapshot must rebuild
            self.window_state.mark_dirty("fallback")
        logger.warning("accelerated sweep of %s fell back to oracle: %s",
                       self.owner or "this node", err)

    def stats(self) -> dict:
        avg_ms = (
            1000.0 * self.total_sweep_s / self.sweeps if self.sweeps else 0.0
        )
        out = {
            "consensus_engine": "device",
            "accel_device": str(self.device),
            # which strongly-see path the sweep runs: the CUDA kernel K1 on
            # a card, its plain PyTorch version on the CPU
            "accel_kernel": "cuda" if self.device.type == "cuda" else "plain",
            "accel_batcher": self.batcher,
            "accel_sweeps": self.sweeps,
            "accel_fallbacks": self.fallbacks,
            "accel_small_windows": self.small_windows,
            "accel_deferred": self.deferred,
            "accel_contended": self.contended,
            "accel_stale_drops": self.stale_drops,
            "accel_min_window": self.min_window,
            "accel_pipeline": self.pipeline,
            "accel_mesh": ("x".join(map(str, self._mesh.shape))
                           if self._mesh is not None else None),
            "accel_mesh_pad_rows": self.mesh_pad_rows,
            "accel_mesh_fallbacks": self.mesh_fallbacks,
            "accel_last_sweep_ms": round(1000.0 * self.last_sweep_s, 3),
            "accel_avg_sweep_ms": round(avg_ms, 3),
            "accel_last_window_events": self.last_window_events,
            "accel_buckets": {
                "x".join(map(str, k)): n for k, n in self.buckets.items()
            },
            # Per-stage totals: the snapshot is build (from-scratch
            # builds) + delta_scan + pack (resident snapshots).
            "accel_stage_ms": {
                k: round(1000.0 * v, 1) for k, v in self.stage_s.items()
            },
            "accel_dispatch_cpu_ms": round(1000.0 * self.dispatch_cpu_s, 1),
            "accel_slot_held_ms": round(1000.0 * self.slot_held_s, 1),
            # Resident windows: rows packed from the store against rows
            # kept from the last sweep, from-scratch rebuilds, and sweeps
            # that uploaded only the delta to the resident buffers.
            "accel_resident": self.resident,
            "accel_rows_delta": self.rows_delta_total,
            "accel_rows_reused": self.rows_reused_total,
            "accel_rebuilds": (self.window_state.rebuilds
                               if self.window_state is not None else 0),
            "accel_delta_sweeps": self.delta_sweeps,
        }
        # circuit-breaker surface: accel_breaker_state/open/probes/skips/
        # failures
        out.update(self.breaker.stats(prefix="accel_breaker_"))
        if self.batcher:
            out.update(SweepBatcher.instance().stats())
        return out
