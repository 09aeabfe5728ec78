"""Latency recorder for the gossip hot path.

The reference logs nanosecond durations around requestSync / Diff / Sync /
ProcessSigPool on every gossip round (src/node/node.go:511-514,543-548,
593-608) and exposes profiling via pprof on the service mux
(cmd/babble/main.go:4). Here the same measurements are aggregated into
bounded per-name reservoirs and served at /debug/timers.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict


class LatencyRecorder:
    def __init__(self, window: int = 512):
        self._window = window
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}
        self._counts: Dict[str, int] = {}
        self._totals: Dict[str, float] = {}

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            d = self._samples.get(name)
            if d is None:
                d = self._samples[name] = deque(maxlen=self._window)
                self._counts[name] = 0
                self._totals[name] = 0.0
            d.append(seconds)
            self._counts[name] += 1
            self._totals[name] += seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, d in self._samples.items():
                vals = sorted(d)
                n = len(vals)
                if n == 0:
                    continue
                out[name] = {
                    "count": self._counts[name],
                    "total_ms": round(self._totals[name] * 1e3, 3),
                    "mean_ms": round(sum(vals) / n * 1e3, 3),
                    "p50_ms": round(vals[n // 2] * 1e3, 3),
                    "p95_ms": round(vals[min(n - 1, int(n * 0.95))] * 1e3, 3),
                    "max_ms": round(vals[-1] * 1e3, 3),
                }
        return out
