"""Stall flight recorder: dump everything when progress stops.

FoundationDB-style "when the invariant trips, record the state you wish
you had": a :class:`StallWatchdog` rides every running node and fires
when the node is *busy* (pending transactions, undetermined events, a
target round ahead of consensus) yet its progress signature — last
block index, last consensus round, consensus-event count — has not
moved for ``Config.watchdog_stall_s`` seconds. On a trip it writes one
replay-friendly JSON artifact:

- the stalled-stage diagnosis (``gossip`` / ``consensus`` / ``ingest``
  / ``commit``) from the node's live signals,
- the full typed stats snapshot (ingest counters, mempool, sentry
  ledger, selector health/backoff view, breaker state, commit-latency
  percentiles),
- the recent sync-span ring (the last ~64 gossip rounds with per-stage
  timings),
- the provenance tail (the last transactions the tracer followed),
- gossip-leg latency percentiles and queue depths.

One dump per stall *episode*: after a trip the watchdog re-arms only
when the progress signature moves again, and a per-node dump budget
(``max_dumps``) bounds disk even on a node that stalls forever. The
monitor thread is started by ``Node.run`` (production path only — the
sim harness drives nodes without threads and calls ``check()``
directly if it wants the recorder) and disabled entirely under
``BABBLE_OBS=0`` or ``watchdog_stall_s=0``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import List, Optional

from ..config.config import (
    DEFAULT_WATCHDOG_INTERVAL_S,
    DEFAULT_WATCHDOG_STALL_S,
)


def default_flight_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "babble_tpu_flight")


class StallWatchdog:
    def __init__(self, node, stall_s: float = DEFAULT_WATCHDOG_STALL_S,
                 interval_s: float = DEFAULT_WATCHDOG_INTERVAL_S,
                 out_dir: str = "", max_dumps: int = 5):
        self.node = node
        self.clock = node.clock
        self.stall_s = stall_s
        self.interval_s = max(0.05, interval_s)
        self.out_dir = out_dir or default_flight_dir()
        self.max_dumps = max_dumps
        self.trips = 0
        self.dumps = 0
        self.artifacts: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_sig = None
        self._last_progress_t: Optional[float] = None
        self._tripped = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.stall_s <= 0 or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(
            target=self._loop, name="stall-watchdog", daemon=True
        )
        t.start()
        self._thread = t

    def stop(self) -> None:
        self._stop.set()
        self._thread = None

    def _loop(self) -> None:
        # Event.wait (real time) rather than clock.sleep: the thread is
        # only ever started on wall-clocked production nodes, and wait()
        # makes shutdown immediate.
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the recorder must never
                # take the node down; a diagnostic that crashes is worse
                # than no diagnostic
                self.node.logger.debug(
                    "stall watchdog check failed", exc_info=True
                )

    # -- detection -----------------------------------------------------------

    def _progress_signature(self) -> tuple:
        n = self.node
        return (
            n.get_last_block_index(),
            n.get_last_consensus_round_index(),
            n.core.get_consensus_events_count(),
        )

    def check(self) -> Optional[str]:
        """One watchdog pass; returns the artifact path on a fresh trip.
        Callable directly (tests, sim harness) — the thread above is
        just this on a timer."""
        if self.stall_s <= 0:
            return None
        now = self.clock.monotonic()
        sig = self._progress_signature()
        if sig != self._last_sig:
            self._last_sig = sig
            self._last_progress_t = now
            self._tripped = False  # progress resumed: re-arm
            return None
        from ..node.state import State

        if self.node.get_state() != State.BABBLING or not self.node.core.busy():
            # Suspended / joining / idle: the node owes no progress, so
            # this time must not count toward the stall window — else a
            # node that sat quiet past stall_s would trip the instant it
            # resumed, before it had a single interval to make progress.
            self._last_progress_t = now
            self._tripped = False
            return None
        if self._tripped:
            return None
        stalled_for = now - (self._last_progress_t or now)
        if stalled_for < self.stall_s:
            return None
        self.trips += 1
        self._tripped = True
        return self._dump(stalled_for, now)

    def _stalled_stage(self, now: float) -> str:
        """Which pipeline stage froze first (coarse, from live signals):
        no successful gossip round inside the stall window → ``gossip``;
        gossip flows but events sit undetermined → ``consensus``; rounds
        decided but no block → ``commit``; otherwise the local ingest/
        self-event path (``ingest``)."""
        n = self.node
        lg = n.last_gossip_ok
        if lg is None or now - lg >= self.stall_s:
            return "gossip"
        if n.core.get_undetermined_events():
            return "consensus"
        if n.core.hg.pending_rounds.get_ordered_pending_rounds():
            return "commit"
        return "ingest"

    # -- the dump ------------------------------------------------------------

    def _dump(self, stalled_for: float, now: float) -> Optional[str]:
        if self.dumps >= self.max_dumps:
            return None
        n = self.node
        stage = self._stalled_stage(now)
        artifact = {
            "format": "babble-flight/1",
            "node": n.get_id(),
            "moniker": n.core.validator.moniker,
            "state": str(n.get_state()),
            "stalled_stage": stage,
            "stalled_for_s": round(stalled_for, 3),
            "tripped_at": round(self.clock.time(), 6),
            "thresholds": {
                "stall_s": self.stall_s,
                "interval_s": self.interval_s,
            },
            "progress_signature": {
                "last_block_index": self._last_sig[0],
                "last_consensus_round": self._last_sig[1],
                "consensus_events": self._last_sig[2],
            },
            "last_gossip_ok_age_s": (
                None if n.last_gossip_ok is None
                else round(now - n.last_gossip_ok, 3)
            ),
            "stats": n.get_stats_snapshot(),
            "recent_syncs": n.telemetry.tracer.recent(),
            "provenance_tail": n.telemetry.provenance.export(limit=32),
            "timers": n.timers.snapshot(),
            "queues": {
                "submit_queue": n.submit_q.qsize(),
                "mempool_pending": n.core.mempool.pending_count,
                "undetermined_events": len(
                    n.core.get_undetermined_events()
                ),
                "heads_pending": len(n.core.heads),
                "sig_pool": len(n.core.self_block_signatures),
            },
        }
        n.logger.warning(
            "stall watchdog tripped: no progress for %.1fs "
            "(stalled stage: %s)", stalled_for, stage,
        )
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"flight_{artifact['moniker'] or artifact['node']}"
                f"_{self.dumps}_{int(self.clock.time() * 1e3)}.json",
            )
            with open(path, "w", encoding="utf-8") as f:
                json.dump(artifact, f, default=str, indent=1)
        except OSError:
            n.logger.warning("flight-recorder dump failed", exc_info=True)
            return None
        self.dumps += 1
        self.artifacts.append(path)
        return path
