"""Gossip heartbeat timer.

Reference semantics: src/node/control_timer.go:11-80 — a background timer
that fires ticks at random intervals in [min, 2*min), can be reset with a
new interval, stopped, and shut down.

Implemented as a thread waiting on a condition variable with timeout
rather than Go channels.
"""

from __future__ import annotations

import random
import threading


class ControlTimer:
    def __init__(self, rng=None) -> None:
        self.tick = threading.Event()
        self._cond = threading.Condition()
        self._interval: float = 0.0
        self._armed = False
        self._shutdown = False
        self.is_set = False
        self._thread: threading.Thread | None = None
        # Jitter source: the node injects Config.seeded_rng("control_timer")
        # so the gossip cadence is a pure function of the master seed —
        # a global-random draw here made same-seed sim replays diverge
        # on the JOINING path (docs/simulation.md determinism contract).
        # None (production) falls back to the process-global module.
        self._rng = rng if rng is not None else random

    def _jitter(self, interval: float) -> float:
        """Random interval in [min, 2*min) — the reference's jittered
        heartbeat, drawn from the injected stream."""
        return interval + self._rng.random() * interval

    def run(self, init_interval: float) -> None:
        """Start the timer loop in the background
        (reference: control_timer.go:47-70)."""
        self.reset(init_interval)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._armed and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    self.is_set = False
                    return
                interval = self._interval
                wait = self._jitter(interval)
                self._armed = False
                notified = self._cond.wait(timeout=wait)
                if self._shutdown:
                    self.is_set = False
                    return
                if self._armed:
                    # reset arrived while waiting: loop with new interval
                    continue
                if notified:
                    # stop() disarmed the timer: no tick
                    # (reference: control_timer.go:62-64 sets timer = nil)
                    continue
            self.is_set = False
            self.tick.set()

    def reset(self, interval: float) -> None:
        """Arm the timer with a new interval (reference: control_timer.go:62)."""
        with self._cond:
            self._interval = interval
            self._armed = True
            self.is_set = True
            self._cond.notify()

    def poke(self) -> None:
        """Wake a ``tick`` waiter WITHOUT a timer fire. The babble loop
        blocks on ``tick`` (event-driven, no poll quantum); suspend and
        shutdown call this so the loop re-checks its exit flags
        immediately instead of waiting out the current interval."""
        self.tick.set()

    def stop(self) -> None:
        with self._cond:
            self._armed = False
            self.is_set = False
            self._cond.notify()

    def shutdown(self) -> None:
        """reference: control_timer.go:73-80."""
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        self.tick.set()
