"""Metrics registry: counters, gauges, fixed-bucket histograms, and
function-backed instruments, with Prometheus text exposition.

Design constraints (docs/observability.md):

- **Hot-path increments are lock-free.** ``Counter.inc`` /
  ``Histogram.observe`` are plain attribute/list-element arithmetic;
  under the GIL a racing update can be *lost* (bounded under-count,
  monotone) but never corrupted. Locks are only taken for child
  creation (``labels``) and never on the increment path.
- **Function-backed instruments cost nothing until scraped.** Most of
  the codebase already maintains plain integer counters on its objects;
  those register as ``func_counter``/``func_gauge`` closures evaluated
  at collect time, so converting them to "registry instruments" adds
  zero hot-path work.
- **Kill switch.** ``BABBLE_OBS=0`` makes ``counter()``/``gauge()``/
  ``histogram()`` return shared no-op instruments (and registries skip
  them at render time); function-backed instruments keep working, so
  the compatibility ``get_stats`` view and ``/metrics`` stay truthful
  with the overhead disabled. The flag is read once at import
  (``set_enabled`` is the test hook).
"""

from __future__ import annotations

import math
import os
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_ENABLED = os.environ.get("BABBLE_OBS", "1") != "0"


def enabled() -> bool:
    """Whether hot-path instruments are live (BABBLE_OBS kill switch)."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test hook: flips the default for registries created AFTER the
    call (existing registries keep their resolved instruments)."""
    global _ENABLED
    _ENABLED = bool(on)


# Default buckets, in seconds. LATENCY covers submit→commit on a
# gossiping cluster (5 ms .. 60 s); STAGE covers individual pipeline
# stages (100 µs .. 2.5 s, the sub-millisecond end matters for decode/
# verify/insert on small syncs).
LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0,
)
STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)


def _fmt(v) -> str:
    """Prometheus float formatting: integers render without the dot."""
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in labels.items()
    )
    return "{" + inner + "}"


class Counter:
    """Monotone counter. ``inc`` is a single add — lock-free."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Settable instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram. ``observe`` is a bisect + two adds —
    lock-free. Quantiles are estimated by linear interpolation inside
    the matched bucket (standard Prometheus ``histogram_quantile``
    semantics), so accuracy is bounded by bucket width."""

    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
        self.uppers: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.uppers:
            raise ValueError("histogram needs at least one bucket")
        # one slot per finite bucket + the +Inf overflow slot
        self.counts = [0] * (len(self.uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # bisect_left: Prometheus `le` bounds are INCLUSIVE — a value
        # exactly on a bucket boundary belongs in that bucket
        self.counts[bisect_left(self.uppers, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        total = self.count
        if total <= 0:
            return None
        target = q * total
        cum = 0
        lo = 0.0
        for i, n in enumerate(self.counts):
            hi = self.uppers[i] if i < len(self.uppers) else self.uppers[-1]
            if cum + n >= target:
                if n <= 0 or i >= len(self.uppers):
                    return hi
                frac = (target - cum) / n
                return lo + frac * (hi - lo)
            cum += n
            lo = hi
        return self.uppers[-1]

    def summary(self) -> Dict[str, Optional[float]]:
        """count/sum plus interpolated p50/p90/p99 (seconds)."""
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class _NullInstrument:
    """Shared no-op stand-in when the kill switch is on."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def labels(self, **kv):
        return self

    value = 0
    count = 0
    sum = 0.0

    def quantile(self, q):
        return None

    def summary(self):
        return {"count": 0, "sum": 0.0, "p50": None, "p90": None, "p99": None}


NULL = _NullInstrument()


class _Labeled:
    """Parent holding per-label-value children; creation takes the
    registry lock, lookups are a dict get."""

    __slots__ = ("labelnames", "children", "_make", "_lock")

    def __init__(self, labelnames, make, lock):
        self.labelnames = tuple(labelnames)
        self.children: Dict[Tuple[str, ...], object] = {}
        self._make = make
        self._lock = lock

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self.children.get(key)
        if child is None:
            with self._lock:
                child = self.children.setdefault(key, self._make())
        return child

    def items_snapshot(self):
        """Sorted (key, child) pairs copied under the lock — a render
        racing a first-time labels() insert must not hit 'dict changed
        size during iteration'."""
        with self._lock:
            return sorted(self.children.items())


class _Registered:
    """One registry entry: instrument (or reader fn) + metadata."""

    __slots__ = ("name", "kind", "help", "labelnames", "inst", "fn")

    def __init__(self, name, kind, help_, labelnames=(), inst=None, fn=None):
        self.name = name
        self.kind = kind  # counter | gauge | histogram
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.inst = inst
        self.fn = fn


class Registry:
    """Named collection of instruments with Prometheus rendering.

    Two registration families:

    - ``counter``/``gauge``/``histogram``: real hot-path instruments
      (no-ops when disabled);
    - ``func_counter``/``func_gauge``: zero-overhead readers over
      existing attributes, evaluated at collect time. A labeled func
      instrument's reader returns ``{label_value: number}``.
    """

    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.enabled = _ENABLED if enabled is None else enabled
        self._lock = threading.Lock()
        self._entries: Dict[str, _Registered] = {}

    # -- registration -------------------------------------------------------

    def _add(self, entry: _Registered):
        with self._lock:
            existing = self._entries.get(entry.name)
            if existing is not None:
                return existing
            self._entries[entry.name] = entry
            return entry

    def counter(self, name: str, help_: str, labelnames=()):
        if not self.enabled:
            return NULL
        e = self._add(
            _Registered(
                name, "counter", help_, labelnames,
                inst=_Labeled(labelnames, Counter, self._lock)
                if labelnames else Counter(),
            )
        )
        return e.inst

    def gauge(self, name: str, help_: str, labelnames=()):
        if not self.enabled:
            return NULL
        e = self._add(
            _Registered(
                name, "gauge", help_, labelnames,
                inst=_Labeled(labelnames, Gauge, self._lock)
                if labelnames else Gauge(),
            )
        )
        return e.inst

    def histogram(self, name: str, help_: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS, labelnames=()):
        if not self.enabled:
            return NULL
        e = self._add(
            _Registered(
                name, "histogram", help_, labelnames,
                inst=_Labeled(
                    labelnames, lambda b=tuple(buckets): Histogram(b),
                    self._lock,
                )
                if labelnames else Histogram(buckets),
            )
        )
        return e.inst

    def func_counter(self, name: str, help_: str,
                     fn: Callable[[], object], labelnames=()) -> None:
        self._add(_Registered(name, "counter", help_, labelnames, fn=fn))

    def func_gauge(self, name: str, help_: str,
                   fn: Callable[[], object], labelnames=()) -> None:
        self._add(_Registered(name, "gauge", help_, labelnames, fn=fn))

    # -- reads --------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def describe(self) -> List[Tuple[str, str, Tuple[str, ...], str]]:
        """(name, kind, labelnames, help) for every registered entry."""
        with self._lock:
            return [
                (e.name, e.kind, e.labelnames, e.help)
                for e in self._entries.values()
            ]

    def get(self, name: str, **labels):
        """Current value of a counter/gauge (test/assertion helper);
        labeled funcs take the single label value as a kwarg."""
        e = self._entries.get(name)
        if e is None:
            raise KeyError(name)
        if e.fn is not None:
            v = _safe(e.fn)
            if e.labelnames:
                v = (v or {}).get(labels[e.labelnames[0]], 0)
            return v
        inst = e.inst
        if e.labelnames:
            inst = inst.labels(**labels)
        return inst.value if not isinstance(inst, Histogram) else inst.count

    def histogram_summary(self, name: str, **labels):
        e = self._entries.get(name)
        if e is None or e.kind != "histogram" or e.inst is None:
            return None
        inst = e.inst
        if e.labelnames:
            inst = inst.labels(**labels)
        return inst.summary()

    # -- exposition ---------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            entries = list(self._entries.values())
        for e in sorted(entries, key=lambda x: x.name):
            lines.append(f"# HELP {e.name} {e.help}")
            lines.append(f"# TYPE {e.name} {e.kind}")
            if e.fn is not None:
                self._render_func(e, lines)
            elif isinstance(e.inst, _Labeled):
                for key, child in e.inst.items_snapshot():
                    labels = dict(zip(e.labelnames, key))
                    self._render_inst(e.name, child, labels, lines)
            else:
                self._render_inst(e.name, e.inst, {}, lines)
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _render_func(e: _Registered, lines: List[str]) -> None:
        v = _safe(e.fn)
        if e.labelnames:
            for lv, n in sorted(((v or {})).items()):
                n = _numeric(n)
                if n is not None:
                    lines.append(
                        f"{e.name}{_label_str({e.labelnames[0]: lv})} "
                        f"{_fmt(n)}"
                    )
        else:
            n = _numeric(v)
            if n is not None:
                lines.append(f"{e.name} {_fmt(n)}")

    @staticmethod
    def _render_inst(name, inst, labels, lines) -> None:
        if isinstance(inst, Histogram):
            # +Inf and _count are derived from the SAME bucket-counts
            # snapshot as the finite buckets, never from inst.count: a
            # concurrent observe() (or a GIL-race-lost count update)
            # must not produce a non-monotone cumulative series, which
            # would break histogram_quantile downstream.
            counts = list(inst.counts)
            cum = 0
            for i, upper in enumerate(inst.uppers):
                cum += counts[i]
                lines.append(
                    f"{name}_bucket"
                    f"{_label_str({**labels, 'le': _fmt(upper)})} {cum}"
                )
            cum += counts[-1]
            lines.append(
                f"{name}_bucket{_label_str({**labels, 'le': '+Inf'})} "
                f"{cum}"
            )
            lines.append(f"{name}_sum{_label_str(labels)} {_fmt(inst.sum)}")
            lines.append(f"{name}_count{_label_str(labels)} {cum}")
        else:
            lines.append(f"{name}{_label_str(labels)} {_fmt(inst.value)}")

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view: scalars for counters/gauges, summary
        dicts (count/sum/p50/p90/p99) for histograms; labeled
        instruments nest by label value."""
        out: Dict[str, object] = {}
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e.fn is not None:
                v = _safe(e.fn)
                if e.labelnames and isinstance(v, dict):
                    out[e.name] = {
                        str(k): _numeric(n) for k, n in sorted(v.items())
                    }
                else:
                    out[e.name] = _numeric(v)
            elif isinstance(e.inst, _Labeled):
                out[e.name] = {
                    "|".join(key): (
                        child.summary()
                        if isinstance(child, Histogram)
                        else child.value
                    )
                    for key, child in e.inst.items_snapshot()
                }
            elif isinstance(e.inst, Histogram):
                out[e.name] = e.inst.summary()
            else:
                out[e.name] = e.inst.value
        return out


def _safe(fn):
    try:
        return fn()
    except Exception:
        return None


def _numeric(v):
    """Coerce collector outputs to numbers; non-numeric (strings, None)
    are skipped from exposition."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    return None


# Process-global registry: instruments shared by every co-located node
# (serialization caches). Node-scoped registries render alongside it.
GLOBAL = Registry(enabled=True)
_global_wired = False
_global_lock = threading.Lock()


def wire_global() -> None:
    """Register the process-wide cache counters exactly once."""
    global _global_wired
    with _global_lock:
        if _global_wired:
            return
        from ..crypto.canonical import NORM_CACHE
        from ..hashgraph.event import WIRE_CACHE

        GLOBAL.func_counter(
            "wire_cache_hits_total",
            "Process-wide wire-event serialization cache hits.",
            lambda: WIRE_CACHE.hits,
        )
        GLOBAL.func_counter(
            "wire_cache_misses_total",
            "Process-wide wire-event serialization cache misses.",
            lambda: WIRE_CACHE.misses,
        )
        GLOBAL.func_counter(
            "norm_cache_hits_total",
            "Process-wide canonical-JSON normalization cache hits.",
            lambda: NORM_CACHE.hits,
        )
        GLOBAL.func_counter(
            "norm_cache_misses_total",
            "Process-wide canonical-JSON normalization cache misses.",
            lambda: NORM_CACHE.misses,
        )
        from ..crypto.batch import VERIFY_CACHE

        GLOBAL.func_counter(
            "verify_cache_hits_total",
            "Process-wide signature-verdict cache hits.",
            lambda: VERIFY_CACHE.hits,
        )
        GLOBAL.func_counter(
            "verify_cache_misses_total",
            "Process-wide signature-verdict cache misses.",
            lambda: VERIFY_CACHE.misses,
        )
        from ..net.codec import CODEC_STATS

        GLOBAL.func_counter(
            "wire_bytes_sent_total",
            "Process-wide bytes written to gossip sockets.",
            lambda: CODEC_STATS.bytes_sent,
        )
        GLOBAL.func_counter(
            "wire_bytes_received_total",
            "Process-wide bytes read from gossip sockets.",
            lambda: CODEC_STATS.bytes_received,
        )
        GLOBAL.func_counter(
            "codec_events_encoded_total",
            "Process-wide wire events encoded into binary blobs.",
            lambda: CODEC_STATS.events_encoded,
        )
        GLOBAL.func_counter(
            "codec_event_cache_hits_total",
            "Process-wide event sends served from the binary blob memo.",
            lambda: CODEC_STATS.event_cache_hits,
        )
        GLOBAL.func_counter(
            "codec_events_decoded_total",
            "Process-wide binary event blobs decoded at ingest.",
            lambda: CODEC_STATS.events_decoded,
        )
        GLOBAL.func_counter(
            "codec_conns_binary_total",
            "Process-wide inbound connections negotiated binary.",
            lambda: CODEC_STATS.conns_binary,
        )
        GLOBAL.func_counter(
            "codec_conns_json_total",
            "Process-wide inbound connections on the legacy JSON framing.",
            lambda: CODEC_STATS.conns_json,
        )
        # Sampling profiler (obs/profile.py): registered here — not at
        # sampler start — so the instrument exists whether or not the
        # profiler ever runs (the catalog's global-scope contract);
        # it reads {} until a sampler ticks.
        from . import profile as _profile

        GLOBAL.func_counter(
            "profile_stage_samples",
            "Sampling-profiler thread-stack samples per stage bucket.",
            _profile.stage_counts,
            ("stage",),
        )
        _global_wired = True
