"""Virtual time for the simulation engine.

A ``SimClock`` is a :class:`~babble_tpu_torch.common.clock.Clock` whose time
only moves when the scheduler (or a sleeper) advances it. Everything
the node stack reads through its injected clock — deadlines, backoff,
event timestamps, telemetry durations — becomes a pure function of the
event schedule: a 10-second soak costs microseconds of wall time and
two runs with the same seed read identical clocks.

``sleep`` advances time in place. Inside a scheduler event this means
the sleeping code blocks *virtually* — events scheduled inside the
slept window run after the current event returns (at their scheduled
time, which is then in the past, so in timestamp order immediately
after). That is a coarser interleaving than real threads produce, but
it is deterministic, which is the property the engine exists for; the
boundary is documented in docs/simulation.md.
"""

from __future__ import annotations

from ..common.clock import Clock

# Fixed wall-clock epoch for ``time()``: event bodies carry absolute
# timestamps, and determinism requires the epoch to be part of the sim,
# not of the host. 2023-11-14T22:13:20Z, for no particular reason.
SIM_EPOCH = 1_700_000_000.0


class SimClock(Clock):
    def __init__(self, start: float = 0.0, epoch: float = SIM_EPOCH):
        self.now = float(start)
        self.epoch = float(epoch)
        self.sleeps = 0
        self.slept_total_s = 0.0

    def monotonic(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now

    def time(self) -> float:
        return self.epoch + self.now

    def sleep(self, seconds: float) -> None:
        if seconds > 0.0:
            self.sleeps += 1
            self.slept_total_s += seconds
            self.now += seconds

    def advance_to(self, t: float) -> None:
        """Move to ``t`` if it is in the future (never rewinds)."""
        if t > self.now:
            self.now = t
