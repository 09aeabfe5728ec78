"""The time abstraction every subsystem reads through.

One ``Clock`` object carries the four time primitives the framework
uses — ``monotonic()`` (scheduling, deadlines, backoff), ``time()``
(wall timestamps stamped into event bodies and evidence records),
``perf_counter()`` (duration measurement for telemetry), and
``sleep()`` (every blocking wait). Production code gets ``WALL``, a
process-wide singleton delegating to the ``time`` module; the
deterministic simulation engine (``babble_tpu_torch.sim``) injects a
``SimClock`` whose time is virtual, so a 10-second soak collapses to
milliseconds and every duration the telemetry records is a pure
function of the schedule, not of host load.

Subsystems that predate this class take bare callables
(``clock=time.monotonic`` — breaker, selector, mempool, sentry);
those keep their callable signature and are handed the bound method
(``conf.clock.monotonic``) by their constructors. New code should
take the ``Clock`` object so it can reach all four primitives.
"""

from __future__ import annotations

import time


class Clock:
    """Interface: see module docstring. Subclasses override all four."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def perf_counter(self) -> float:
        # one high-resolution timeline is enough for both scheduling and
        # duration measurement unless a subclass says otherwise
        return self.monotonic()

    def time(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """The real thing. Stateless; use the ``WALL`` singleton."""

    def monotonic(self) -> float:
        return time.monotonic()

    def perf_counter(self) -> float:
        return time.perf_counter()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


WALL = WallClock()
