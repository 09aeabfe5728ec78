"""locks — the static lock-discipline pass.

The core lock was shrunk to the insert tail: decode + batch-verify
run lock-free and only ``insert + DivideRounds`` (and the commit tail)
hold ``core_lock``. Nothing enforced that — one blocking call (a socket
op, a sleep, an RPC send, a native batch-verify) slipped under the lock
in a later PR would silently re-serialize the whole node. This pass
builds the static lock graph and flags:

1. **blocking-while-core-locked** — a blocking primitive reachable
   (through the intra-project call graph) from a ``with <core lock>:``
   region;
2. **acquisition-order cycles** — ``with`` nesting (direct or through
   called functions) that produces both an A→B and a B→A edge between
   named locks.

The model is deliberately modest and its limits are documented
(docs/static_analysis.md §Lock model): only ``with``-statement regions
are analyzed (bare ``.acquire()``/``.release()`` pairs are invisible);
calls resolve by *name* — ``self.<m>()`` to the same class,
``self.<attr>.<m>()`` through the ATTR_TYPES convention table,
bare-name calls to same-module functions; everything else (callbacks,
dynamic dispatch, cross-process) is out of scope. The runtime
lock-order recorder (``common/lockcheck.py``, ``BABBLE_LOCKCHECK=1``)
validates the same edge set empirically under the chaos and sim soaks,
closing the gap from the other side.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import SourceFile, Violation, register

#: attribute name (last path segment) -> lock name, matched anywhere —
#: the core lock travels as ``self.core_lock`` / ``node.core_lock``.
GLOBAL_LOCK_ATTRS: Dict[str, str] = {"core_lock": "core"}

#: (path suffix, class name, attr) -> lock name, for the ``self._lock``
#: convention inside known lock-owning classes.
CLASS_LOCKS: Dict[Tuple[str, str, str], str] = {
    ("mempool/mempool.py", "Mempool", "_lock"): "mempool",
    ("node/sentry.py", "Sentry", "_lock"): "sentry",
    # NOTE: the subscription hub (client/subhub.py) is deliberately
    # absent — it is single-selector-threaded with a non-blocking wake
    # pipe, so there is no hub lock to model (docs/static_analysis.md).
    ("node/pipeline.py", "SyncPipeline", "_lock"): "pipeline",
    ("hashgraph/sweep_batcher.py", "SweepBatcher", "_lock"): "batcher",
}

#: ``self.<attr>`` -> class the attribute conventionally holds, for
#: one-hop cross-object call resolution. A convention table, not type
#: inference — docs/static_analysis.md spells out the limits.
ATTR_TYPES: Dict[str, Tuple[str, str]] = {
    "core": ("node/core.py", "Core"),
    "mempool": ("mempool/mempool.py", "Mempool"),
    "sentry": ("node/sentry.py", "Sentry"),
    "pipeline": ("node/pipeline.py", "SyncPipeline"),
}

#: locks whose held regions must stay free of blocking calls. Order
#: edges are recorded for EVERY named lock; the blocking check applies
#: to the core lock (the consensus hot path) only.
BLOCK_CHECK_LOCKS = {"core"}

#: callee attribute names treated as blocking primitives
SLEEP_FNS = {"sleep"}
SOCKET_FNS = {
    "recv",
    "recv_into",
    "send",
    "sendall",
    "connect",
    "accept",
    "makefile",
    "create_connection",
    "dial",
}
RPC_FNS = {
    "sync",
    "eager_sync",
    "fast_forward",
    "join",
    "request_sync",
    "request_eager_sync",
    "request_fast_forward",
}
NATIVE_VERIFY_FNS = {"verify_batch", "batch_verify_events"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'self.core.sync' for an attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lock_name(path: str, cls: Optional[str], expr: ast.AST) -> Optional[str]:
    dotted = _dotted(expr)
    if not dotted:
        return None
    last = dotted.rsplit(".", 1)[-1]
    if last in GLOBAL_LOCK_ATTRS:
        return GLOBAL_LOCK_ATTRS[last]
    if cls and dotted == f"self.{last}":
        for (suffix, kcls, attr), name in CLASS_LOCKS.items():
            if path.endswith(suffix) and cls == kcls and last == attr:
                return name
    return None


def _blocking_desc(callee: str, dotted: Optional[str]) -> Optional[str]:
    """Classify a call as a blocking primitive, or None."""
    if callee in SLEEP_FNS:
        return f"sleep ({dotted or callee})"
    if callee in SOCKET_FNS:
        return f"socket op {dotted or callee}()"
    if callee in NATIVE_VERIFY_FNS:
        return f"native batch-verify {dotted or callee}()"
    if dotted and callee in RPC_FNS:
        recv = dotted.rsplit(".", 2)
        # RPC names only count on a transport-ish receiver: Core.sync()
        # is the local ingest, self.trans.sync() is a network round-trip
        if len(recv) >= 2 and recv[-2] in ("trans", "transport", "network"):
            return f"RPC send {dotted}()"
    return None


FuncKey = Tuple[str, Optional[str], str]  # (path, class, func)


def _resolve_callee(
    dotted: Optional[str], path: str, cls: Optional[str]
) -> Optional[FuncKey]:
    """Name-based callee resolution, shared by both sweeps: ``self.<m>``
    to the same class, ``self.<attr>.<m>`` to the ATTR_TYPES hint (as a
    path-SUFFIX key — ``canon()`` in the closure resolves it against the
    real file set), bare names to same-module functions."""
    if not dotted:
        return None
    parts = dotted.split(".")
    if parts[0] == "self" and len(parts) == 2 and cls:
        return (path, cls, parts[1])
    if parts[0] == "self" and len(parts) == 3:
        hint = ATTR_TYPES.get(parts[1])
        if hint:
            return (hint[0], hint[1], parts[2])
    if len(parts) == 1:
        return (path, None, parts[0])
    return None



@dataclass
class _FuncFacts:
    key: FuncKey
    line: int = 0
    #: blocking primitives called directly: (line, desc)
    blocking: List[Tuple[int, str]] = field(default_factory=list)
    #: locks acquired directly via ``with``
    acquires: Set[str] = field(default_factory=set)
    #: resolved intra-project callees
    callees: Set[FuncKey] = field(default_factory=set)


class _Collector(ast.NodeVisitor):
    """First sweep: per-function facts for the whole file set."""

    def __init__(self, sf: SourceFile, funcs: Dict[FuncKey, _FuncFacts]):
        self.sf = sf
        self.funcs = funcs
        self.cls: Optional[str] = None
        self.fn: Optional[_FuncFacts] = None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def _visit_func(self, node) -> None:
        prev = self.fn
        key = (self.sf.path, self.cls, node.name)
        self.fn = self.funcs.setdefault(key, _FuncFacts(key, node.lineno))
        self.generic_visit(node)
        self.fn = prev

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        if self.fn is not None:
            for item in node.items:
                ln = _lock_name(self.sf.path, self.cls, item.context_expr)
                if ln:
                    self.fn.acquires.add(ln)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.fn is not None:
            dotted = _dotted(node.func)
            callee = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else (node.func.id if isinstance(node.func, ast.Name) else "")
            )
            desc = _blocking_desc(callee, dotted)
            if desc:
                self.fn.blocking.append((node.lineno, desc))
            resolved = self._resolve(dotted)
            if resolved:
                self.fn.callees.add(resolved)
        self.generic_visit(node)

    def _resolve(self, dotted: Optional[str]) -> Optional[FuncKey]:
        return _resolve_callee(dotted, self.sf.path, self.cls)


def _closure(funcs: Dict[FuncKey, _FuncFacts]):
    """Fixpoint: transitive blocking witness + transitive lock set."""
    blocks: Dict[FuncKey, Optional[str]] = {}
    locks: Dict[FuncKey, Set[str]] = {}

    def canon(key: FuncKey) -> Optional[FuncKey]:
        if key in funcs:
            return key
        # ATTR_TYPES stores a suffix until resolved against real paths
        path, cls, name = key
        for k in funcs:
            if k[1] == cls and k[2] == name and k[0].endswith(path):
                return k
        return None

    for k, f in funcs.items():
        blocks[k] = f.blocking[0][1] if f.blocking else None
        locks[k] = set(f.acquires)
    changed = True
    while changed:
        changed = False
        for k, f in funcs.items():
            for c in f.callees:
                ck = canon(c)
                if ck is None:
                    continue
                if blocks[k] is None and blocks.get(ck):
                    blocks[k] = (
                        f"{ck[1] or ck[0]}.{ck[2]} → {blocks[ck]}"
                    )
                    changed = True
                add = locks.get(ck, set()) - locks[k]
                if add:
                    locks[k] |= add
                    changed = True
    return blocks, locks, canon


class _RegionChecker(ast.NodeVisitor):
    """Second sweep: walk each ``with <lock>`` region with the held-lock
    stack, emitting blocking violations and order edges."""

    def __init__(self, sf, funcs, blocks, locks, canon, edges, out):
        self.sf = sf
        self.funcs = funcs
        self.blocks = blocks
        self.locks = locks
        self.canon = canon
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = edges
        self.out: List[Violation] = out
        self.cls: Optional[str] = None
        self.held: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def _visit_func(self, node) -> None:
        # a nested function body does not run under the enclosing lock
        prev, self.held = self.held, []
        self.generic_visit(node)
        self.held = prev

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            ln = _lock_name(self.sf.path, self.cls, item.context_expr)
            if ln:
                for h in self.held:
                    if h != ln:
                        self.edges.setdefault(
                            (h, ln), (self.sf.path, node.lineno)
                        )
                entered.append(ln)
        self.held.extend(entered)
        self.generic_visit(node)
        del self.held[len(self.held) - len(entered):]

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            dotted = _dotted(node.func)
            callee = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else (node.func.id if isinstance(node.func, ast.Name) else "")
            )
            desc = _blocking_desc(callee, dotted)
            checked = [h for h in self.held if h in BLOCK_CHECK_LOCKS]
            if desc and checked:
                self.out.append(
                    Violation(
                        self.sf.path,
                        node.lineno,
                        "locks",
                        f"blocking call under the {checked[-1]} lock: "
                        f"{desc}",
                    )
                )
            resolved = self._resolve(dotted)
            ck = self.canon(resolved) if resolved else None
            if ck is not None:
                witness = self.blocks.get(ck)
                if witness and checked:
                    self.out.append(
                        Violation(
                            self.sf.path,
                            node.lineno,
                            "locks",
                            f"call under the {checked[-1]} lock reaches a "
                            f"blocking primitive: {dotted}() → {witness}",
                        )
                    )
                for lk in self.locks.get(ck, ()):
                    for h in self.held:
                        if h != lk:
                            self.edges.setdefault(
                                (h, lk), (self.sf.path, node.lineno)
                            )
        self.generic_visit(node)

    def _resolve(self, dotted: Optional[str]) -> Optional[FuncKey]:
        return _resolve_callee(dotted, self.sf.path, self.cls)


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]):
    """Every elementary 2-cycle and longer cycle via DFS; 2-cycles are
    the common inversion and reported pairwise."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen_pairs = set()
    for (a, b) in sorted(edges):
        if (b, a) in edges and (b, a) not in seen_pairs:
            cycles.append([a, b, a])
            seen_pairs.add((a, b))
    # longer cycles: DFS with path tracking
    def dfs(start: str, node: str, path: List[str], visited: Set[str]):
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 2:
                cyc = path + [start]
                if set(cyc) not in [set(c) for c in cycles]:
                    cycles.append(cyc)
            elif nxt not in visited:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return cycles


@register("locks")
def run(files: List[SourceFile], root: str) -> List[Violation]:
    funcs: Dict[FuncKey, _FuncFacts] = {}
    for sf in files:
        if sf.tree is not None:
            _Collector(sf, funcs).visit(sf.tree)
    blocks, locks, canon = _closure(funcs)
    out: List[Violation] = []
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for sf in files:
        if sf.tree is not None:
            _RegionChecker(
                sf, funcs, blocks, locks, canon, edges, out
            ).visit(sf.tree)
    for cyc in _find_cycles(edges):
        first = edges.get((cyc[0], cyc[1])) or next(iter(edges.values()))
        out.append(
            Violation(
                first[0],
                first[1],
                "locks",
                "lock acquisition-order cycle: " + " → ".join(cyc)
                + " (each edge = a site acquiring the later lock while "
                "holding the earlier)",
            )
        )
    return out


def static_edges(files: List[SourceFile]) -> List[str]:
    """The static order-edge set ("a->b" strings) — compared against the
    runtime recorder's observed edges in tests."""
    funcs: Dict[FuncKey, _FuncFacts] = {}
    for sf in files:
        if sf.tree is not None:
            _Collector(sf, funcs).visit(sf.tree)
    blocks, locks, canon = _closure(funcs)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    sink: List[Violation] = []
    for sf in files:
        if sf.tree is not None:
            _RegionChecker(
                sf, funcs, blocks, locks, canon, edges, sink
            ).visit(sf.tree)
    return sorted(f"{a}->{b}" for (a, b) in edges)
