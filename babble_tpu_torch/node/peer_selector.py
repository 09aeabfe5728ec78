"""Peer selection for gossip, with per-peer health scoring and backoff.

Reference semantics: src/node/peer_selector.go:11-103 — pick the next
gossip partner at random, excluding self and the last-contacted peer, and
track per-peer connected flags.

On top of the reference's uniform pick, the selector keeps a health score
per peer, fed by ``update_last``'s connected flag (the gossip loop calls
it after every round):

- every failure halves the score (floor ``score_floor``) and arms an
  exponential backoff with jitter — while it runs, the peer is skipped,
  so a dead peer stops eating gossip rounds within a few failures;
- when a failing peer's backoff expires it becomes due for a **probe**:
  the next ``next()`` returns it directly (rate-limited to one probe per
  ``probe_interval_s``), so no peer is ever starved and a healed peer is
  rediscovered promptly;
- successes multiply the score back up (full health after ~3 straight
  successes — graded so one lucky round through a flapping peer doesn't
  restore its full selection share);
- healthy peers are drawn with probability proportional to score, so a
  degraded-but-alive peer still gets a trickle of traffic instead of a
  hard cutoff.

If EVERY candidate is inside its backoff, the least-recently-blocked one
is returned anyway: gossip must never fully stop while any peer might
answer (liveness beats politeness under a full partition).

``clock``/``rng`` are injectable for deterministic tests. The selector
carries its OWN narrow lock (see RandomPeerSelector docstring below) and
health state survives peer-set changes via the ``prior`` argument
(core.set_peers passes the outgoing selector).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Protocol

from ..common.backoff import jittered_backoff
from ..peers.peer import Peer
from ..peers.peer_set import PeerSet


class PeerSelector(Protocol):
    def get_peers(self) -> PeerSet: ...

    def update_last(
        self, peer_id: int, connected: bool, penalize: bool = True
    ) -> bool: ...

    def next(self) -> Optional[Peer]: ...


@dataclass
class _Health:
    """Mutable per-peer health record (guarded by the selector lock)."""

    score: float = 1.0
    failures: int = 0  # consecutive failures
    blocked_until: float = 0.0  # backoff deadline (0 = not backed off)
    next_probe: float = 0.0  # earliest time a probe pick may fire
    probes: int = 0


class RandomPeerSelector:
    """reference: peer_selector.go:19-103, plus health scoring (above).

    Carries its OWN narrow lock: the selector is touched from gossip
    worker threads (next / update_last) that deliberately do NOT hold the
    node's core lock — selector state is independent of the hashgraph, so
    serializing it on the core lock only added contention to the insert
    pipeline."""

    def __init__(
        self,
        peer_set: PeerSet,
        self_id: int,
        prior: Optional["RandomPeerSelector"] = None,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        backoff_jitter: float = 0.25,
        score_decay: float = 0.5,
        score_recover: float = 3.0,
        score_floor: float = 0.05,
        probe_interval_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        quarantine_check: Optional[Callable[[int], bool]] = None,
    ):
        self.peers = peer_set
        self.self_id = self_id
        self._lock = threading.Lock()
        self._selectable: Dict[int, Peer] = {
            p.id: p for p in peer_set.peers if p.id != self_id
        }
        self._connected: Dict[int, bool] = {pid: False for pid in self._selectable}
        self.last: Optional[int] = None
        if prior is not None:
            # peer-set change: keep tuning and the surviving peers' health
            backoff_base_s = prior.backoff_base_s
            backoff_cap_s = prior.backoff_cap_s
            backoff_jitter = prior.backoff_jitter
            score_decay = prior.score_decay
            score_recover = prior.score_recover
            score_floor = prior.score_floor
            probe_interval_s = prior.probe_interval_s
            clock = prior._clock
            rng = prior._rng
            if quarantine_check is None:
                quarantine_check = prior._quarantine_check
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.score_decay = score_decay
        self.score_recover = score_recover
        self.score_floor = score_floor
        self.probe_interval_s = probe_interval_s
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        # Sentry hook (node/sentry.py): while a peer is quarantined for
        # misbehavior it is excluded from gossip picks entirely — unlike
        # health backoff there is no probe trickle; the peer is
        # re-admitted only when the sentry's time-box expires.
        self._quarantine_check = quarantine_check
        self._health: Dict[int, _Health] = {}
        for pid in self._selectable:
            carried = prior._health.get(pid) if prior is not None else None
            self._health[pid] = carried if carried is not None else _Health()
        # counters surfaced through stats()
        self.backoff_skips = 0  # picks where ≥1 peer sat out a backoff
        self.probe_picks = 0  # picks that were forced probes
        self.starvation_overrides = 0  # all-backed-off liveness picks
        self.quarantine_skips = 0  # picks where ≥1 peer sat out a quarantine
        self.quarantine_overrides = 0  # all-quarantined liveness picks

    def get_peers(self) -> PeerSet:
        return self.peers

    # -- outcome feedback ----------------------------------------------

    def update_last(
        self, peer_id: int, connected: bool, penalize: bool = True
    ) -> bool:
        """Record the outcome of the last gossip; returns True on a new
        connection (reference: peer_selector.go:62-77). Feeds the health
        score and per-peer backoff. ``penalize=False`` records the
        connected flag without decaying health — for failures that were
        LOCAL (a handler bug, not the network), so a core defect can't
        back off every healthy peer in turn."""
        now = self._clock()
        with self._lock:
            self.last = peer_id
            if peer_id not in self._connected:
                return False
            h = self._health[peer_id]
            if connected:
                h.failures = 0
                h.blocked_until = 0.0
                h.next_probe = 0.0
                h.score = min(1.0, max(h.score, self.score_floor)
                              * self.score_recover)
            elif penalize:
                h.failures += 1
                h.score = max(self.score_floor, h.score * self.score_decay)
                h.blocked_until = now + jittered_backoff(
                    h.failures, self.backoff_base_s, self.backoff_cap_s,
                    self.backoff_jitter, self._rng,
                )
                # a probe becomes due once the backoff expires
                h.next_probe = h.blocked_until
            old = self._connected[peer_id]
            self._connected[peer_id] = connected
            return connected and not old

    # -- pick ------------------------------------------------------------

    def next(self) -> Optional[Peer]:
        """reference: peer_selector.go:80-103, health-weighted."""
        with self._lock:
            exclude = {self.last} if self.last is not None else set()
            return self._pick_locked(self._clock(), exclude)

    def next_many(self, k: int) -> List[Peer]:
        """Up to ``k`` DISTINCT gossip partners for one fan-out tick
        (adaptive scheduler, docs/gossip.md §Adaptive scheduling). Each
        pick runs the same health-weighted law as :meth:`next` with the
        already-chosen peers excluded; the list stops early when no
        further distinct candidate exists, so ``k`` larger than the
        peer set degrades gracefully."""
        picked: List[Peer] = []
        never: set = set()
        with self._lock:
            now = self._clock()
            avoid = {self.last} if self.last is not None else set()
            for _ in range(max(1, k)):
                # snapshot the skip/override counters: a pick the dup
                # check below discards must not inflate the operator
                # alarms (quarantine/starvation overrides) fanout-fold
                before = (
                    self.backoff_skips, self.probe_picks,
                    self.starvation_overrides, self.quarantine_skips,
                    self.quarantine_overrides,
                )
                p = self._pick_locked(now, avoid, never)
                if p is None or any(q.id == p.id for q in picked):
                    # exhausted, or a liveness override re-served a peer
                    # already chosen this tick — fan-out never doubles up
                    (self.backoff_skips, self.probe_picks,
                     self.starvation_overrides, self.quarantine_skips,
                     self.quarantine_overrides) = before
                    break
                picked.append(p)
                never = never | {p.id}
        return picked

    def _pick_locked(
        self, now: float, avoid: set, never: set = frozenset()
    ) -> Optional[Peer]:
        """One health-weighted pick; callers hold the selector lock.
        ``avoid`` peers (the reference's last-contacted exclusion) are
        skipped while alternatives exist but re-admitted when nothing
        else remains; ``never`` peers (fan-out's already-picked set) are
        only re-served on the final everyone-excluded fallback, which
        the caller's duplicate check turns into a stop — so a fan-out
        tick fills from every distinct candidate, including ``last``,
        before giving up."""
        ids = list(self._selectable.keys())
        if not ids:
            return None
        if self._quarantine_check is not None:
            # Quarantined peers are hard-excluded (no probe trickle)
            # while ANY non-quarantined peer exists — but with the
            # same liveness floor as the backoff path: an
            # all-quarantined view means framing (the sentry caps
            # honest quarantines at the BFT f bound) or gross
            # misconfiguration, and gossip must keep trying SOMEONE.
            open_ids = [i for i in ids if not self._quarantine_check(i)]
            if len(open_ids) < len(ids):
                self.quarantine_skips += 1
            if not open_ids:
                self.quarantine_overrides += 1
            else:
                ids = open_ids
        if len(ids) == 1:
            return self._selectable[ids[0]]
        pool = [i for i in ids if i not in never] or ids
        candidates = [i for i in pool if i not in avoid] or pool

        # due probes first: a failing peer whose backoff expired gets
        # deterministically re-tried (never starved, heals promptly).
        # Most-overdue first, so several failing peers share the probe
        # budget round-robin instead of the first-in-map monopolizing.
        due = [
            pid
            for pid in candidates
            if self._health[pid].failures > 0
            and self._health[pid].blocked_until <= now
            and 0.0 < self._health[pid].next_probe <= now
        ]
        if due:
            pid = min(due, key=lambda i: self._health[i].next_probe)
            h = self._health[pid]
            h.next_probe = now + self.probe_interval_s
            h.probes += 1
            self.probe_picks += 1
            return self._selectable[pid]

        open_ids = [
            i for i in candidates if self._health[i].blocked_until <= now
        ]
        if len(open_ids) < len(candidates):
            self.backoff_skips += 1
        if not open_ids:
            # every non-avoided candidate is backed off. Before
            # resurrecting a backed-off (likely dead) peer, re-admit
            # the avoided ones if THEY are healthy — re-gossiping a
            # known-good peer beats burning a round on a known-bad one.
            open_ids = [
                i for i in pool if self._health[i].blocked_until <= now
            ]
        if not open_ids:
            # truly everyone is backed off: pick the one whose backoff
            # expires first — gossip must keep trying SOMEONE
            self.starvation_overrides += 1
            return self._selectable[
                min(pool, key=lambda i: self._health[i].blocked_until)
            ]
        weights = [self._health[i].score for i in open_ids]
        total = sum(weights)
        if total <= 0.0:
            return self._selectable[self._rng.choice(open_ids)]
        roll = self._rng.random() * total
        acc = 0.0
        for pid, w in zip(open_ids, weights):
            acc += w
            if roll <= acc:
                return self._selectable[pid]
        return self._selectable[open_ids[-1]]

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._lock:
            unhealthy = sum(1 for h in self._health.values() if h.failures > 0)
            backed_off = sum(
                1
                for h in self._health.values()
                if h.blocked_until > self._clock()
            )
            return {
                "selector_unhealthy_peers": unhealthy,
                "selector_backed_off_peers": backed_off,
                "selector_backoff_skips": self.backoff_skips,
                "selector_probe_picks": self.probe_picks,
                "selector_starvation_overrides": self.starvation_overrides,
                "selector_quarantine_skips": self.quarantine_skips,
                "selector_quarantine_overrides": self.quarantine_overrides,
            }

    def health_of(self, peer_id: int) -> Optional[_Health]:
        """Test/debug hook: the live health record for one peer."""
        return self._health.get(peer_id)
