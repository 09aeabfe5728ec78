"""Deterministic fault injection for any Transport: the nemesis layer.

Chaos-engineering practice (Basiri et al., IEEE Software 2016) says the
failures a distributed system must survive — partitions, packet loss,
flaky and slow peers — should be *injected on purpose, under a seed*, so
liveness and fork-safety can be asserted in tests instead of hoped for in
production. This module provides that layer for babble_tpu_torch:

- ``ChaosController`` — shared fault state for one simulated network:
  per-link fault rules (drop / duplicate / corrupt / delay / reorder),
  one-way and symmetric partitions, per-peer slowdowns, and a seeded RNG
  (one stream per directed link, so multi-threaded gossip does not
  perturb other links' draws).
- ``ChaosTransport`` — wraps any concrete ``Transport`` (inmem, TCP,
  signal) and applies the controller's rules to every outbound RPC.
  Faults are injected on the CLIENT side of the RPC, which lets one-way
  partitions behave asymmetrically: a blocked forward link means the
  request never arrives (the caller eats a timeout), a blocked reverse
  link means the server processed the request but the response was lost.
- ``Nemesis`` — runs a scripted schedule of fault transitions
  (partition/heal cycles, slow-peer windows, flappers) against the
  controller on its own thread, so soak tests read as data, not sleeps.

Fault semantics per outbound RPC, in order:

1. reorder: with P(reorder), hold the request ``reorder_hold_s`` so a
   concurrently-issued later RPC overtakes it on the wire.
2. delay: sleep a uniform draw from the link's latency window (plus the
   slow-peer window when either endpoint is marked slow).
3. forward partition / drop: the request never reaches the target — the
   caller sleeps ``drop_hold_s`` (a miniature RPC timeout) and gets a
   ``TransportError``.
4. corrupt: the frame is damaged in flight; the receiver rejects it and
   the caller fails fast with a ``TransportError`` (no delivery).
5. duplicate: the request is delivered twice (second delivery on a side
   thread, its response discarded) — exercising handler idempotency.
6. reverse partition: the request IS delivered and processed, but the
   response is lost; the caller eats the hold and a ``TransportError``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .transport import TransportError

DEFAULT_SEED = 42


def seed_from_env(default: int = DEFAULT_SEED) -> int:
    """The chaos seed tests run under: BABBLE_CHAOS_SEED, else ``default``.
    One env var so CI reruns and local repros draw the same schedule."""
    import os

    try:
        return int(os.environ.get("BABBLE_CHAOS_SEED", ""))
    except ValueError:
        return default


@dataclass
class LinkFaults:
    """Fault probabilities and latency for one directed link."""

    drop: float = 0.0  # P(request lost; caller times out)
    duplicate: float = 0.0  # P(request delivered twice)
    corrupt: float = 0.0  # P(frame damaged; receiver rejects, caller errors)
    reorder: float = 0.0  # P(request held so a later one overtakes it)
    delay_min_s: float = 0.0  # uniform per-RPC latency window
    delay_max_s: float = 0.0

    def merged_delay(self, extra: Optional[Tuple[float, float]]) -> Tuple[float, float]:
        if extra is None:
            return self.delay_min_s, self.delay_max_s
        return self.delay_min_s + extra[0], self.delay_max_s + extra[1]


@dataclass
class _Plan:
    """One RPC's fate, decided under the controller lock."""

    blocked_forward: bool = False
    blocked_reverse: bool = False
    drop: bool = False
    corrupt: bool = False
    duplicate: bool = False
    delay_s: float = 0.0
    reorder_hold_s: float = 0.0


class ChaosController:
    """Shared, seeded fault state for one simulated network.

    All mutators are safe to call from a `Nemesis` thread (or a test)
    while gossip threads are mid-RPC; rules apply from the next RPC on.
    """

    def __init__(
        self,
        seed: Optional[int] = None,
        default_faults: Optional[LinkFaults] = None,
        drop_hold_s: float = 0.05,
        reorder_hold_s: float = 0.05,
        sleep=None,
        spawn=None,
    ):
        self.seed = seed_from_env() if seed is None else seed
        self.default_faults = default_faults or LinkFaults()
        # Injectable concurrency primitives: latency faults, drop holds,
        # and duplicate deliveries go through these, so the sim engine
        # (docs/simulation.md) can run a whole nemesis storm in virtual
        # time on one thread. Defaults are the real thing. ``spawn(fn)``
        # runs a side task (duplicate delivery) — default a daemon
        # thread, inline under the sim.
        self.sleep = sleep if sleep is not None else time.sleep
        self.spawn = spawn
        # How long a caller waits on a dropped/partitioned request before
        # the TransportError lands — a miniature RPC timeout, kept small so
        # chaos soaks fail links fast instead of serializing on the real
        # transport deadline.
        self.drop_hold_s = drop_hold_s
        self.reorder_hold_s = reorder_hold_s
        self._lock = threading.Lock()
        self._link_faults: Dict[Tuple[str, str], LinkFaults] = {}
        self._blocked: Set[Tuple[str, str]] = set()
        # one-way blocks tracked separately so a partition() replacement
        # doesn't implicitly heal them
        self._oneway: Set[Tuple[str, str]] = set()
        self._slow_peers: Dict[str, Tuple[float, float]] = {}
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        # observability: soak tests assert on these to separate "nemesis
        # dropped it" from "handler crashed"
        self.stats_lock = threading.Lock()
        self.drops = 0
        self.duplicates = 0
        self.corrupts = 0
        self.reorders = 0
        self.blocked_requests = 0
        self.blocked_responses = 0
        self.delay_total_s = 0.0

    # -- rule mutation (nemesis ops) ------------------------------------

    def set_default_faults(self, faults: LinkFaults) -> None:
        with self._lock:
            self.default_faults = faults

    def set_link_faults(
        self, a: str, b: str, faults: LinkFaults, symmetric: bool = True
    ) -> None:
        with self._lock:
            self._link_faults[(a, b)] = faults
            if symmetric:
                self._link_faults[(b, a)] = faults

    def clear_link_faults(self, a: str, b: str) -> None:
        with self._lock:
            self._link_faults.pop((a, b), None)
            self._link_faults.pop((b, a), None)

    def partition(self, groups: Sequence[Iterable[str]]) -> None:
        """Split the network into groups; links BETWEEN groups are blocked
        both ways, links inside a group stay up. Replaces any previous
        group partition (blocks set via partition_oneway/isolate stay)."""
        sets = [set(g) for g in groups]
        blocked = set()
        for i, gi in enumerate(sets):
            for j, gj in enumerate(sets):
                if i == j:
                    continue
                for a in gi:
                    for b in gj:
                        blocked.add((a, b))
        with self._lock:
            # keep explicit one-way blocks; swap the group-derived ones
            self._blocked = {
                p for p in self._blocked if p in self._oneway
            } | blocked

    def partition_oneway(self, src: str, dst: str) -> None:
        """Block src → dst only (asymmetric failure: src's requests and
        responses toward dst vanish, dst can still reach src)."""
        with self._lock:
            self._blocked.add((src, dst))
            self._oneway.add((src, dst))

    def heal_link(self, a: str, b: str) -> None:
        with self._lock:
            for p in ((a, b), (b, a)):
                self._blocked.discard(p)
                self._oneway.discard(p)

    def isolate(self, addr: str, others: Iterable[str]) -> None:
        """Cut every link touching ``addr`` (both directions). Tracked
        like one-way blocks so a concurrent ``partition()`` (which
        replaces the group-derived block set) doesn't silently heal a
        flapped-down peer mid-flap; ``heal()``/``heal_link`` clear it."""
        with self._lock:
            for o in others:
                if o != addr:
                    for pair in ((addr, o), (o, addr)):
                        self._blocked.add(pair)
                        self._oneway.add(pair)

    def heal_peer(self, addr: str, others: Iterable[str]) -> None:
        """Undo isolate(): restore every link touching ``addr`` without
        disturbing unrelated partitions (flapper up-transitions use this;
        a global heal() would erase a concurrent group partition)."""
        with self._lock:
            for o in others:
                for pair in ((addr, o), (o, addr)):
                    self._blocked.discard(pair)
                    self._oneway.discard(pair)

    def heal(self) -> None:
        """Clear every partition (group, one-way, and isolates)."""
        with self._lock:
            self._blocked.clear()
            self._oneway.clear()

    def slow_peer(self, addr: str, delay_min_s: float, delay_max_s: float) -> None:
        """Add latency to every link touching ``addr`` (either endpoint)."""
        with self._lock:
            self._slow_peers[addr] = (delay_min_s, delay_max_s)

    def clear_slow(self, addr: Optional[str] = None) -> None:
        with self._lock:
            if addr is None:
                self._slow_peers.clear()
            else:
                self._slow_peers.pop(addr, None)

    # -- per-RPC decision ----------------------------------------------

    def _rng(self, link: Tuple[str, str]) -> random.Random:
        rng = self._rngs.get(link)
        if rng is None:
            # per-link streams: concurrent RPCs on other links never
            # perturb this link's draws, so a fixed seed yields the same
            # per-link fault sequence regardless of thread interleaving
            rng = random.Random(f"{self.seed}|{link[0]}->{link[1]}")
            self._rngs[link] = rng
        return rng

    def plan(self, src: str, dst: str) -> _Plan:
        """Decide one outbound RPC's fate. Called by ChaosTransport."""
        with self._lock:
            faults = self._link_faults.get((src, dst), self.default_faults)
            extra = self._slow_peers.get(src) or self._slow_peers.get(dst)
            rng = self._rng((src, dst))
            p = _Plan(
                blocked_forward=(src, dst) in self._blocked,
                blocked_reverse=(dst, src) in self._blocked,
            )
            lo, hi = faults.merged_delay(extra)
            if hi > 0.0:
                p.delay_s = rng.uniform(lo, hi)
            if faults.reorder and rng.random() < faults.reorder:
                p.reorder_hold_s = self.reorder_hold_s
            if faults.drop and rng.random() < faults.drop:
                p.drop = True
            if faults.corrupt and rng.random() < faults.corrupt:
                p.corrupt = True
            if faults.duplicate and rng.random() < faults.duplicate:
                p.duplicate = True
        return p

    def stats(self) -> Dict[str, float]:
        with self.stats_lock:
            return {
                "chaos_drops": self.drops,
                "chaos_duplicates": self.duplicates,
                "chaos_corrupts": self.corrupts,
                "chaos_reorders": self.reorders,
                "chaos_blocked_requests": self.blocked_requests,
                "chaos_blocked_responses": self.blocked_responses,
                "chaos_delay_total_ms": round(1000.0 * self.delay_total_s, 1),
            }

    def _count(self, attr: str) -> None:
        with self.stats_lock:
            setattr(self, attr, getattr(self, attr) + 1)

    def _add_delay(self, dt: float) -> None:
        with self.stats_lock:
            self.delay_total_s += dt


class ChaosTransport:
    """A Transport that subjects every outbound RPC to a ChaosController.

    Wraps any concrete transport; the server side (consumer queue) is
    untouched, so a node under chaos still answers whatever requests make
    it through — exactly the asymmetry real networks have.
    """

    def __init__(self, inner, controller: ChaosController):
        self.inner = inner
        self.controller = controller

    # -- passthrough ----------------------------------------------------

    def consumer(self):
        return self.inner.consumer()

    def local_addr(self) -> str:
        return self.inner.local_addr()

    def advertise_addr(self) -> str:
        return self.inner.advertise_addr()

    def listen(self) -> None:
        self.inner.listen()

    def close(self) -> None:
        self.inner.close()

    # -- chaos-wrapped client calls ------------------------------------

    def _call(self, target: str, req, send: Callable):
        ctl = self.controller
        src = self.inner.advertise_addr()
        plan = ctl.plan(src, target)
        hold = plan.delay_s + plan.reorder_hold_s
        if plan.reorder_hold_s:
            ctl._count("reorders")
        if hold > 0.0:
            ctl._add_delay(hold)
            ctl.sleep(hold)
        if plan.blocked_forward or plan.drop:
            ctl._count(
                "blocked_requests" if plan.blocked_forward else "drops"
            )
            ctl.sleep(ctl.drop_hold_s)
            raise TransportError(
                f"chaos: request {src} -> {target} "
                + ("blocked by partition" if plan.blocked_forward else "dropped")
            )
        if plan.corrupt:
            ctl._count("corrupts")
            raise TransportError(
                f"chaos: frame {src} -> {target} corrupted in flight"
            )
        if plan.duplicate:
            ctl._count("duplicates")

            def dup() -> None:
                try:
                    send(target, req)
                except Exception:
                    pass  # the duplicate's outcome is invisible to the caller

            if ctl.spawn is not None:
                ctl.spawn(dup)
            else:
                threading.Thread(target=dup, daemon=True,
                                 name="chaos-duplicate").start()
        result = send(target, req)
        if plan.blocked_reverse:
            # the server processed the request; only the response vanished
            ctl._count("blocked_responses")
            ctl.sleep(ctl.drop_hold_s)
            raise TransportError(
                f"chaos: response {target} -> {src} blocked by partition"
            )
        return result

    def sync(self, target: str, req):
        return self._call(target, req, self.inner.sync)

    def eager_sync(self, target: str, req):
        return self._call(target, req, self.inner.eager_sync)

    def fast_forward(self, target: str, req):
        return self._call(target, req, self.inner.fast_forward)

    def join(self, target: str, req):
        return self._call(target, req, self.inner.join)


# -- nemesis schedules ---------------------------------------------------


@dataclass
class NemesisStep:
    """One scheduled fault transition: at ``at`` seconds after start, call
    ``op`` (a ChaosController method name) with ``kwargs``."""

    at: float
    op: str
    kwargs: dict = field(default_factory=dict)


class Nemesis:
    """Executes a NemesisStep schedule against a controller on a thread.

    Steps run in ``at`` order relative to ``start()``; ``stop()`` aborts
    between steps; ``done`` is set after the last step. Deterministic in
    the sense that matters: the *sequence* of fault states is fixed, and
    each link's fault draws come from its own seeded stream.

    This runner is WALL-CLOCK (its own thread): it drives live threaded
    clusters. The sim engine does not use it — it applies the same
    NemesisStep schedules as virtual-time scheduler events instead
    (babble_tpu_torch.sim.scenario, docs/simulation.md).
    """

    def __init__(self, controller: ChaosController, steps: Sequence[NemesisStep]):
        self.controller = controller
        self.steps = sorted(steps, key=lambda s: s.at)
        # ops are stringly-typed method names — reject typos at build
        # time, not silently mid-storm
        for step in self.steps:
            if not callable(getattr(controller, step.op, None)):
                raise ValueError(f"unknown nemesis op: {step.op!r}")
        self.done = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.executed: List[str] = []
        self.errors: List[str] = []  # steps that raised (schedule continues)

    def start(self) -> "Nemesis":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="nemesis"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        # The Nemesis thread is live-soak-only wall time: the sim engine
        # never calls start() — it schedules the same steps as virtual-
        # time scheduler events (sim/harness.py), so these reads can't
        # perturb replay determinism.
        t0 = time.monotonic()  # lint: allow(clock: live-soak nemesis thread; sim schedules steps as events)
        try:
            for step in self.steps:
                while not self._stop.is_set():
                    remaining = t0 + step.at - time.monotonic()  # lint: allow(clock: live-soak nemesis thread)
                    if remaining <= 0:
                        break
                    time.sleep(min(remaining, 0.05))  # lint: allow(clock: live-soak nemesis thread)
                if self._stop.is_set():
                    return
                try:
                    getattr(self.controller, step.op)(**step.kwargs)
                except Exception as err:
                    # keep going: skipping the remaining steps (often the
                    # heals) would leave the cluster in a different fault
                    # state than scripted, and the soak would fail on a
                    # misleading liveness assertion
                    self.errors.append(f"{step.at:.2f}:{step.op}: {err!r}")
                    continue
                self.executed.append(f"{step.at:.2f}:{step.op}")
        finally:
            self.done.set()

    def wait(self, timeout: float) -> bool:
        return self.done.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


def partition_heal_cycle(
    groups: Sequence[Iterable[str]],
    first_at: float,
    partition_for: float,
    heal_for: float,
    rounds: int,
) -> List[NemesisStep]:
    """``rounds`` cycles of partition(groups) → heal()."""
    steps: List[NemesisStep] = []
    t = first_at
    for _ in range(rounds):
        steps.append(NemesisStep(t, "partition", {"groups": [list(g) for g in groups]}))
        t += partition_for
        steps.append(NemesisStep(t, "heal", {}))
        t += heal_for
    return steps


def flapper(
    addr: str,
    others: Iterable[str],
    first_at: float,
    down_for: float,
    up_for: float,
    rounds: int,
) -> List[NemesisStep]:
    """A peer that keeps dying and coming back: isolate/heal_peer cycles.
    Heals only ITS OWN links, so a flapper composed with an overlapping
    partition schedule can't accidentally lift the group partition."""
    steps: List[NemesisStep] = []
    others = list(others)
    t = first_at
    for _ in range(rounds):
        steps.append(NemesisStep(t, "isolate", {"addr": addr, "others": others}))
        t += down_for
        steps.append(
            NemesisStep(t, "heal_peer", {"addr": addr, "others": others})
        )
        t += up_for
    return steps


def slow_peer_window(
    addr: str, at: float, duration: float, delay_min_s: float, delay_max_s: float
) -> List[NemesisStep]:
    """One slow-peer episode: added latency on every link touching addr."""
    return [
        NemesisStep(at, "slow_peer", {
            "addr": addr,
            "delay_min_s": delay_min_s,
            "delay_max_s": delay_max_s,
        }),
        NemesisStep(at + duration, "clear_slow", {"addr": addr}),
    ]
