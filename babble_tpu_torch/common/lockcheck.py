"""Runtime lock-order recorder — the empirical half of the babblelint
lock-discipline pass (docs/static_analysis.md §Lock model).

The static pass (``analysis/lock_pass.py``) derives the acquisition-
order graph from ``with`` statements and a name-based call graph; this
recorder observes the REAL graph: every named :class:`TimedLock`
acquire/release reports here when ``BABBLE_LOCKCHECK=1``, and acquiring
lock B while holding lock A records the directed edge A→B with the
held-stack witness. An *inversion* — both A→B and B→A observed — is a
latent deadlock the static model either missed (callback, dynamic
dispatch) or proved; either way CI fails on it: the chaos soak and the
sim sweep both run with the recorder armed and assert zero inversions.

Disabled (the default), the hook is one module-attribute truth test per
acquire — nothing is allocated, no thread-local is touched. The
recorder is process-wide: co-located nodes share it, which is exactly
right — their threads share the actual locks' deadlock potential too.

Surfaced as ``lock_order_edges`` / ``lock_order_inversions`` in
``get_stats`` (node/node.py) and in the sim sweep summary line.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

#: armed at import from the environment; tests flip it via set_enabled()
ENABLED: bool = os.environ.get("BABBLE_LOCKCHECK", "") not in (
    "", "0", "false", "off", "no",
)


def set_enabled(on: bool) -> None:
    """Test hook — production arming is the BABBLE_LOCKCHECK env var."""
    global ENABLED
    ENABLED = bool(on)


class LockOrderRecorder:
    """Per-thread held-lock stacks + the process-wide edge set."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._lock = threading.Lock()
        # (held, acquired) -> times observed; first-witness stack kept
        self.edges: Dict[Tuple[str, str], int] = {}
        self.witness: Dict[Tuple[str, str], str] = {}

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquired(self, name: str) -> None:
        st = self._stack()
        if st:
            with self._lock:
                for held in st:
                    if held != name:
                        key = (held, name)
                        self.edges[key] = self.edges.get(key, 0) + 1
                        self.witness.setdefault(key, "<".join(st))
        st.append(name)

    def note_released(self, name: str) -> None:
        st = self._stack()
        # release order may not mirror acquire order; drop the latest
        # matching entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break

    def edge_list(self) -> List[str]:
        with self._lock:
            return sorted(f"{a}->{b}" for (a, b) in self.edges)

    def inversions(self) -> List[str]:
        """Lock pairs observed in BOTH orders — each is a latent
        deadlock between the two acquisition sites."""
        with self._lock:
            out = []
            for (a, b) in self.edges:
                if (b, a) in self.edges and a < b:
                    out.append(
                        f"{a}<->{b} (held {self.witness[(a, b)]} then "
                        f"{b}; held {self.witness[(b, a)]} then {a})"
                    )
            return sorted(out)

    def stats(self) -> dict:
        return {
            "lock_order_edges": self.edge_list(),
            "lock_order_inversions": len(self.inversions()),
        }

    def reset(self) -> None:
        with self._lock:
            self.edges.clear()
            self.witness.clear()


#: the process-wide recorder every named TimedLock reports to
RECORDER = LockOrderRecorder()
