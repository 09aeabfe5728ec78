"""clock — the clock/RNG discipline pass.

The determinism contract (docs/simulation.md): every subsystem reads
time through ``Config.clock`` and derives randomness through
``Config.seeded_rng``, so a sim run is a pure function of the master
seed. A single bare ``time.time()`` or global-``random`` draw anywhere
in a node-side code path silently breaks byte-identical replay — the
exact class of bug this pass existed to catch (``control_timer.py``'s
gossip jitter and ``sentry.py``'s proof timestamps had both regressed
to the global sources before this pass landed).

What is flagged — *calls only*, never references:

- ``time.time/monotonic/sleep/perf_counter[_ns]/process_time(...)``
- module-level ``random.<draw>(...)`` (``random.Random(seed)`` and
  ``random.SystemRandom()`` construct *instances* and stay legal —
  seeded instances are exactly what the discipline asks for)
- ``datetime.now/utcnow/today(...)``

Injectable defaults like ``clock: Callable = time.monotonic`` are
references, not calls, and are the sanctioned shape for production
fallbacks — they stay clean by construction.

Deliberate wall-clock sites are declared, not tolerated: whole modules
whose business IS wall time are allowlisted below with a reason
(observability timestamps, device-stage timing, the wall-clock
abstraction itself), and scattered single sites carry
``# lint: allow(clock: <reason>)`` — which rots loudly (stale allows
are errors). The policy table lives in docs/static_analysis.md.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .core import SourceFile, Violation, register

#: wall-time reads/sleeps on the ``time`` module
TIME_FNS = {
    "time",
    "monotonic",
    "sleep",
    "perf_counter",
    "time_ns",
    "monotonic_ns",
    "perf_counter_ns",
    "process_time",
}

#: ``random`` module attributes that are NOT global draws (constructing
#: a seeded instance is the sanctioned pattern)
RANDOM_CONSTRUCTORS = {"Random", "SystemRandom"}

DATETIME_FNS = {"now", "utcnow", "today"}

#: path prefix -> why the whole module is a sanctioned wall-clock site.
#: Kept small and each entry justified — the table is reproduced in
#: docs/static_analysis.md (wall-clock site policy).
MODULE_ALLOW: Dict[str, str] = {
    "babble_tpu_torch/common/clock.py": "the wall-clock abstraction itself",
    "babble_tpu_torch/obs/": (
        "observability timestamps are wall-clock by design (ledger/log/"
        "profiler/healthview stamps; stage clocks are injectable and "
        "telemetry wires them to the node clock)"
    ),
    "babble_tpu_torch/sim/": (
        "the harness measures its own wall runtime; virtual time lives "
        "in SimClock"
    ),
    "babble_tpu_torch/ops/": (
        "device-stage wall timing and device retry backoff; the "
        "accelerator path never runs under sim"
    ),
    "babble_tpu_torch/hashgraph/accel.py": "device-stage wall timing (as ops/)",
    "babble_tpu_torch/hashgraph/sweep_batcher.py": (
        "process-wide device dispatcher; COALESCE_S coalescing is real "
        "device-batching time and the accelerator is never enabled "
        "under sim (audited, docs/static_analysis.md)"
    ),
    "babble_tpu_torch/net/signal.py": (
        "the relay transport is real-socket only; sim swaps in "
        "SimTransport"
    ),
    "babble_tpu_torch/analysis/": "the lint suite is tooling, not node code",
}


def _module_allowed(path: str) -> bool:
    return any(path.startswith(p) for p in MODULE_ALLOW)


class _Imports(ast.NodeVisitor):
    """Local-name -> canonical module/function mapping for one file."""

    def __init__(self) -> None:
        self.module_alias: Dict[str, str] = {}  # local -> "time"/"random"/…
        self.from_names: Dict[str, Tuple[str, str]] = {}  # local -> (mod, fn)

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name in ("time", "random", "datetime"):
                self.module_alias[a.asname or a.name] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module in ("time", "random", "datetime"):
            for a in node.names:
                self.from_names[a.asname or a.name] = (node.module, a.name)


def _check_call(node: ast.Call, imp: _Imports) -> str:
    """Return a violation message for this call, or ''."""
    f = node.func
    # <alias>.<fn>(...)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        mod = imp.module_alias.get(f.value.id)
        if mod == "time" and f.attr in TIME_FNS:
            return (
                f"bare time.{f.attr}() — route through the node clock "
                "(Config.clock / common/clock.py WALL)"
            )
        if mod == "random" and f.attr not in RANDOM_CONSTRUCTORS:
            return (
                f"global random.{f.attr}() — draw from Config.seeded_rng "
                "(or an injected random.Random instance)"
            )
        if mod == "datetime" and f.attr in DATETIME_FNS:
            return (
                f"datetime.{f.attr}() — route through the node clock"
            )
        # datetime.datetime.now(...) via the module alias
        fn = imp.from_names.get(f.value.id)
        if fn == ("datetime", "datetime") and f.attr in DATETIME_FNS:
            return (
                f"datetime.{f.attr}() — route through the node clock"
            )
    # datetime.datetime.now(...) — two-level attribute off the module
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Attribute)
        and isinstance(f.value.value, ast.Name)
        and imp.module_alias.get(f.value.value.id) == "datetime"
        and f.attr in DATETIME_FNS
    ):
        return f"datetime.{f.attr}() — route through the node clock"
    # from time import sleep; sleep(...)
    if isinstance(f, ast.Name):
        origin = imp.from_names.get(f.id)
        if origin:
            mod, fn = origin
            if mod == "time" and fn in TIME_FNS:
                return (
                    f"bare {fn}() (from time import) — route through "
                    "the node clock"
                )
            if mod == "random" and fn not in RANDOM_CONSTRUCTORS:
                return (
                    f"global {fn}() (from random import) — draw from "
                    "Config.seeded_rng"
                )
            if mod == "datetime" and fn == "datetime":
                pass  # constructor itself is fine
    return ""


@register("clock")
def run(files: List[SourceFile], root: str) -> List[Violation]:
    out: List[Violation] = []
    for sf in files:
        if sf.tree is None or _module_allowed(sf.path):
            continue
        imp = _Imports()
        imp.visit(sf.tree)
        if not imp.module_alias and not imp.from_names:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                msg = _check_call(node, imp)
                if msg:
                    out.append(
                        Violation(sf.path, node.lineno, "clock", msg)
                    )
    return out
