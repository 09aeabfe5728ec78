"""SimScheduler: the deterministic single-threaded event loop.

One heap of ``(time, seq, label, fn)`` entries; events run strictly in
(time, insertion) order on the calling thread, with the
:class:`~babble_tpu_torch.sim.clock.SimClock` advanced to each event's
timestamp before it fires. Because a whole gossip round — pull RPC,
the peer's handler, the insert sweep, the push leg — executes
*synchronously inside one event*, the interleaving of the simulation
is exactly the order of this heap, which is a pure function of the
schedule and of the seeded RNG streams below.

RNG streams: ``rng(name)`` returns a ``random.Random`` seeded from
``f"{seed}|{name}"`` and cached, one per actor (per-node tick jitter,
per-node selector, the tx mix, the scenario generator). An actor's
draws can never be perturbed by another actor running more or fewer
times — the same trick the chaos layer uses per directed link.

The event log is bounded: every executed event (time, seq, label) is
absorbed into a ROLLING sha256 at execution time — the digest is the
canonical "same interleaving" witness over the FULL run that the
determinism property test and the sweep's ``--dump`` output compare —
while ``event_log`` itself keeps only the most recent
``EVENT_LOG_TAIL`` entries for inspection, so a long or high-tick-rate
scenario can't grow memory linearly with virtual time.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import json
import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .clock import SimClock

# Inspection tail kept in memory; the digest covers every event regardless.
EVENT_LOG_TAIL = 65536


class SimScheduler:
    def __init__(self, seed: int, start: float = 0.0):
        self.seed = seed
        self.clock = SimClock(start)
        self._heap: List[Tuple[float, int, str, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._rngs: Dict[str, random.Random] = {}
        self.events_run = 0
        # (time, seq, label) per executed event — bounded inspection tail;
        # the rolling hash below is the complete interleaving record
        self.event_log: Deque[Tuple[float, int, str]] = deque(
            maxlen=EVENT_LOG_TAIL
        )
        self._log_hash = hashlib.sha256()

    # -- rng streams ----------------------------------------------------

    def rng(self, stream: str) -> random.Random:
        r = self._rngs.get(stream)
        if r is None:
            r = random.Random(f"{self.seed}|{stream}")
            self._rngs[stream] = r
        return r

    # -- scheduling -----------------------------------------------------

    @property
    def now(self) -> float:
        return self.clock.now

    def at(self, t: float, fn: Callable[[], None], label: str) -> None:
        """Schedule ``fn`` at virtual time ``t`` (past times fire at the
        next opportunity, in timestamp order)."""
        heapq.heappush(self._heap, (float(t), next(self._seq), label, fn))

    def after(self, dt: float, fn: Callable[[], None], label: str) -> None:
        self.at(self.clock.now + dt, fn, label)

    # -- running --------------------------------------------------------

    def run_until(self, t_end: float) -> int:
        """Execute every event scheduled at or before ``t_end`` (including
        ones those events schedule), then advance the clock to ``t_end``.
        Returns the number of events executed."""
        ran = 0
        while self._heap and self._heap[0][0] <= t_end:
            t, seq, label, fn = heapq.heappop(self._heap)
            # never rewind: an event that overslept (a handler called
            # sleep) pushes later events to fire "late" but in order
            self.clock.advance_to(t)
            entry = (round(t, 9), seq, label)
            self.event_log.append(entry)
            self._log_hash.update(
                json.dumps(entry, separators=(",", ":")).encode() + b"\n"
            )
            self.events_run += 1
            ran += 1
            fn()
        self.clock.advance_to(t_end)
        return ran

    def run_for(self, dt: float) -> int:
        return self.run_until(self.clock.now + dt)

    def pending(self) -> int:
        return len(self._heap)

    # -- determinism witness --------------------------------------------

    def event_log_digest(self) -> str:
        """sha256 over EVERY executed event (rolling, so the full run is
        witnessed even past the bounded inspection tail) — two runs
        interleaved identically iff their digests match."""
        return self._log_hash.hexdigest()
