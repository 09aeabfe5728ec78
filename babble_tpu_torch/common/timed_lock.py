"""TimedLock — a threading.Lock that accounts its acquisition wait time.

The node serializes all hashgraph access on one core lock (the reference's
coreLock discipline, node.go:35); a profile of the JAX package put ~70% of
co-located samples inside ``lock.acquire``. Shrinking those critical
sections is only credible if the wait is *measured*, so the node's core
lock is this instrumented wrapper and ``get_stats`` surfaces
``lock_wait_ms_total`` / ``lock_acquisitions`` from it.

Accounting is monotonic-clock wall time summed across every acquiring
thread; under the GIL the float += races are benign for a stats counter
(worst case an update is lost, never corrupted).

A ``name`` makes the lock part of the acquisition-order model: when the
``BABBLE_LOCKCHECK=1`` recorder (common/lockcheck.py) is armed, named
acquires/releases feed the process-wide order graph that validates the
babblelint static lock pass (docs/static_analysis.md §Lock model). The
other consensus-path locks (mempool, sentry, subscription hub) are
named TimedLocks too for exactly this reason. Disabled, the hook costs
one module-attribute truth test on the acquire fast path.
"""

from __future__ import annotations

import threading
import time

from . import lockcheck


class TimedLock:
    """Drop-in ``threading.Lock`` replacement that records total time
    spent *waiting* to acquire (contention, not hold time)."""

    __slots__ = (
        "_lock", "wait_s_total", "acquisitions", "observer", "_clock", "name",
    )

    def __init__(self, observer=None, clock=time.perf_counter,
                 name=None) -> None:
        self._lock = threading.Lock()
        self.wait_s_total: float = 0.0
        self.acquisitions: int = 0
        # Optional per-contended-acquire wait observer (seconds) — the
        # node wires the core_lock_wait_seconds histogram here; only
        # contended acquires are observed (the fast path stays clockless).
        self.observer = observer
        # Injectable so simulated nodes account waits in virtual time.
        self._clock = clock
        # Named locks participate in the BABBLE_LOCKCHECK order recorder.
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Fast path: an uncontended acquire skips the two clock reads —
        # this wrapper must not tax the very path it instruments.
        if self._lock.acquire(False):
            self.acquisitions += 1
            if lockcheck.ENABLED and self.name:
                lockcheck.RECORDER.note_acquired(self.name)
            return True
        if not blocking:
            return False
        t0 = self._clock()
        ok = self._lock.acquire(True, timeout)
        waited = self._clock() - t0
        self.wait_s_total += waited
        if self.observer is not None:
            self.observer(waited)
        if ok:
            self.acquisitions += 1
            if lockcheck.ENABLED and self.name:
                lockcheck.RECORDER.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        if lockcheck.ENABLED and self.name:
            lockcheck.RECORDER.note_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait_ms_total(self) -> float:
        return 1e3 * self.wait_s_total


def named_lock(name: str):
    """A lock that participates in the BABBLE_LOCKCHECK order recorder —
    as a named TimedLock when the recorder is armed, and a raw C
    ``threading.Lock`` otherwise: the mempool/sentry/pipeline/batcher
    hot paths must not pay a Python-level acquire wrapper to feed a
    default-off debug recorder (the core lock stays a TimedLock always:
    its wait accounting IS a production stat). Arming is decided at
    construction, matching the env-var contract — tests that flip
    ``lockcheck.set_enabled`` do so before building their cluster."""
    if lockcheck.ENABLED:
        return TimedLock(name=name)
    return threading.Lock()
