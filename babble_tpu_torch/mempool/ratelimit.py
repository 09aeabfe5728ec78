"""Token-bucket rate limiter for mempool admission.

Same idiom as ``common/backoff.py``: one small shared primitive with its
nondeterminism injected (there the RNG, here the clock), so tests drive
it with a seeded/fake clock and get byte-identical verdict sequences.
"""

from __future__ import annotations

import time
from typing import Callable


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.

    NOT internally locked — the owning ``Mempool`` already serializes
    admission under its own lock, and a second lock here would only add
    contention on the submit hot path.
    """

    def __init__(
        self,
        rate: float,
        burst: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError("TokenBucket rate must be positive")
        self.rate = float(rate)
        # default burst of one second's worth of tokens (at least 1): a
        # client that paces exactly at the rate never sees `throttled`,
        # only a sustained overshoot does
        self.burst = float(burst) if burst > 0 else max(self.rate, 1.0)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()

    def try_acquire(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; never blocks."""
        now = self._clock()
        if now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False
