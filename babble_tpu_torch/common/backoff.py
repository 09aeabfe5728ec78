"""Jittered exponential backoff, shared by every retry site.

One formula so the selector's per-peer backoff, the joining node's retry
sleep, and the fast-forward poll loop all behave identically:

    delay = min(cap_s, base_s * 2^(attempt-1) * (1 + jitter * u))

with u drawn uniform from [-1, 1]. Jitter multiplies BEFORE the cap, so
``cap_s`` is a hard bound — a configured 2 s cap never sleeps 2.5 s.
"""

from __future__ import annotations

import random
from typing import Optional


def jittered_backoff(
    attempt: int,
    base_s: float,
    cap_s: float,
    jitter: float = 0.25,
    rng: Optional[random.Random] = None,
) -> float:
    """Backoff for the ``attempt``-th consecutive failure (1-based).
    The exponent is clamped: a permanently dead peer accrues failures
    forever, and an unclamped 2**n overflows float after ~1000 of them
    (the cap has long since dominated anyway)."""
    if attempt < 1:
        return 0.0
    u = (rng.uniform(-1.0, 1.0) if rng is not None
         # lint: allow(clock: production fallback; sim callers always inject a seeded rng)
         else random.uniform(-1.0, 1.0))
    nominal = base_s * (2.0 ** min(attempt - 1, 32))
    return min(cap_s, nominal * (1.0 + jitter * u))


def backoff_sleep(
    attempt: int,
    base_s: float,
    cap_s: float,
    jitter: float = 0.25,
    rng: Optional[random.Random] = None,
    sleep=None,
) -> float:
    """Compute the jittered delay AND wait it out through an injectable
    ``sleep`` (default: the process wall clock). Retry sites pass their
    node's ``Clock.sleep`` so a simulated cluster's backoff waits are
    virtual — a joining node's 2 s retry cadence costs the sim engine
    nothing but a clock advance. Returns the delay actually slept."""
    delay = jittered_backoff(attempt, base_s, cap_s, jitter, rng)
    if delay > 0.0:
        if sleep is None:
            import time

            sleep = time.sleep
        sleep(delay)
    return delay
