"""Span tracer: follow one sync (or one self-originating gossip round)
through the pipeline.

A ``SyncTrace`` is opened by the node around a gossip leg; pipeline
stages timed anywhere below it (core decode/verify, hashgraph insert/
voting/commit — they call the telemetry's ``observe_stage``) attach to
the ACTIVE trace through a thread-local, so the deep consensus code
needs no span plumbing. Finishing a trace:

- feeds every stage duration into ``sync_stage_seconds{stage=...}``
  (already done eagerly at observe time), and
- appends a compact record to a bounded ring served at ``/telemetry``
  (``recent_syncs``): trace id, peer, total wall time, ordered stage
  list.

Overhead: two ``perf_counter`` calls per stage plus one list append —
and with ``BABBLE_OBS=0`` the node skips opening traces entirely (the
null trace below costs one attribute read per stage).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

def staged(stage: str):
    """Method decorator timing one pipeline stage against the owning
    object's ``stage_observer`` attribute. When the observer is None
    (telemetry disabled, or a bare object outside a node) the original
    method runs with no clock reads — only one attribute check."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            obs = self.stage_observer
            if obs is None:
                return fn(self, *args, **kwargs)
            # the owner's injected stage clock, if any (Core wires the
            # node Clock here so simulated stages record virtual time)
            clk = getattr(self, "stage_clock", None) or time.perf_counter
            t0 = clk()
            try:
                return fn(self, *args, **kwargs)
            finally:
                obs(stage, clk() - t0)

        return wrapper

    return deco


class _NullStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_STAGE = _NullStage()


class NullTrace:
    """Stand-in when tracing is disabled; safe to call everywhere."""

    __slots__ = ()
    trace_id = 0

    def stage(self, name: str):
        return _NULL_STAGE

    def add(self, stage: str, seconds: float) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_TRACE = NullTrace()


class SyncTrace:
    """One gossip round's span. Not thread-safe by design: a trace is
    owned by the gossip thread that opened it (stages recorded from
    other threads attach to THEIR active trace, or none).

    Stage recordings are AGGREGATED per stage name (first-seen order,
    count + total seconds): a 1000-event sync observes ``insert`` once
    per event, and appending raw tuples would balloon each ring record
    to sync_limit entries and every /telemetry response to multi-MB."""

    __slots__ = ("trace_id", "kind", "peer_id", "t0", "_agg", "_tracer")

    def __init__(self, tracer: "Tracer", kind: str, peer_id: int):
        # ids and the clock come from the OWNING tracer (not process
        # globals) so two identical simulated runs in one process produce
        # identical trace records (docs/simulation.md determinism).
        self.trace_id = next(tracer._ids)
        self.kind = kind
        self.peer_id = peer_id
        self.t0 = tracer.clock()
        # stage -> [count, total_seconds]; dicts preserve insertion order
        self._agg: dict = {}
        self._tracer = tracer

    def stage(self, name: str):
        return _Stage(self, name)

    def add(self, stage: str, seconds: float) -> None:
        agg = self._agg.get(stage)
        if agg is None:
            self._agg[stage] = [1, seconds]
        else:
            agg[0] += 1
            agg[1] += seconds

    @property
    def stages(self) -> List[Tuple[str, float]]:
        """(stage, total_seconds) in first-observation order."""
        return [(name, agg[1]) for name, agg in self._agg.items()]

    def stage_counts(self) -> List[Tuple[str, int]]:
        return [(name, agg[0]) for name, agg in self._agg.items()]

    def finish(self) -> None:
        self._tracer._finish(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class _Stage:
    __slots__ = ("_trace", "_name", "_t0")

    def __init__(self, trace: SyncTrace, name: str):
        self._trace = trace
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._trace._tracer.observe(
            self._name, time.perf_counter() - self._t0, trace=self._trace
        )
        return False


class Tracer:
    """Owns the thread-local active trace and the recent-trace ring.
    ``stage_sink`` is the telemetry callback feeding the
    ``sync_stage_seconds`` histogram children."""

    def __init__(self, stage_sink=None, ring: int = 64,
                 clock=time.perf_counter):
        self._local = threading.local()
        self._ring: Deque[dict] = deque(maxlen=ring)
        self.stage_sink = stage_sink
        # per-tracer id stream + clock: deterministic under the sim
        # engine's virtual time (module-global state would leak between
        # runs in one process)
        self._ids = itertools.count(1)
        self.clock = clock
        self.traces_started = 0
        self.traces_finished = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self, kind: str, peer_id: int) -> SyncTrace:
        tr = SyncTrace(self, kind, peer_id)
        self._local.trace = tr
        self.traces_started += 1
        return tr

    def active(self) -> Optional[SyncTrace]:
        return getattr(self._local, "trace", None)

    def _finish(self, tr: SyncTrace) -> None:
        if getattr(self._local, "trace", None) is tr:
            self._local.trace = None
        self.traces_finished += 1
        self._ring.append(
            {
                "id": tr.trace_id,
                "kind": tr.kind,
                "peer": tr.peer_id,
                "total_ms": round(
                    1e3 * (self.clock() - tr.t0), 3
                ),
                "stages": [
                    [name, round(1e3 * s, 3)] for name, s in tr.stages
                ],
            }
        )

    # -- stage recording ----------------------------------------------------

    def observe(self, stage: str, seconds: float, trace=None) -> None:
        """Record one stage duration: histogram always, active trace
        when one is open on this thread."""
        sink = self.stage_sink
        if sink is not None:
            sink(stage, seconds)
        tr = trace if trace is not None else getattr(
            self._local, "trace", None
        )
        if tr is not None:
            tr.add(stage, seconds)

    def recent(self) -> List[dict]:
        return list(self._ring)
