"""Shared file-walker / report / suppression core for babblelint.

Every pass consumes the same pre-parsed :class:`SourceFile` objects (one
``ast`` parse per file per run, shared by all passes) and emits
:class:`Violation` records. The runner then applies the inline
suppression contract:

- ``# lint: allow(<pass>: <reason>)`` suppresses violations of ``<pass>``
  on the SAME line, or — when the comment stands alone — on the next
  line that carries code.
- an allow that suppressed nothing when its pass ran is itself a
  violation (``stale-allow``): the allowlist cannot rot silently.
- an allow naming an unknown pass is a violation (``unknown-pass``).

A reason is mandatory — an allow is a documented decision, not an
escape hatch.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

# ``# lint: allow(clock: recv_ts is a real arrival stamp)``
_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*([a-z_]+)\s*:\s*([^)]+?)\s*\)"
)


@dataclass
class Violation:
    """One finding: ``path:line: [pass] message``."""

    path: str
    line: int
    passname: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.passname}] {self.message}"


@dataclass
class Allow:
    """One parsed inline suppression."""

    path: str
    line: int  # line the comment sits on
    passname: str
    reason: str
    #: lines this allow covers: its own line, plus — for a comment-only
    #: line — the next line carrying code
    covers: tuple = ()
    consumed: bool = False


@dataclass
class SourceFile:
    """One parsed source file, shared by every pass in a run."""

    path: str  # repo-relative, forward slashes
    text: str
    lines: List[str] = field(default_factory=list)
    tree: Optional[ast.AST] = None
    parse_error: Optional[str] = None
    allows: List[Allow] = field(default_factory=list)

    @staticmethod
    def from_text(relpath: str, text: str) -> "SourceFile":
        """Build from a string — fixture snippets and the self-proof."""
        sf = SourceFile(path=relpath.replace(os.sep, "/"), text=text)
        sf.lines = text.splitlines()
        try:
            sf.tree = ast.parse(text)
        except SyntaxError as err:
            sf.parse_error = f"syntax error: {err}"
        sf.allows = parse_allows(sf)
        return sf

    @staticmethod
    def load(abspath: str, relpath: str) -> "SourceFile":
        with open(abspath, encoding="utf-8") as f:
            text = f.read()
        sf = SourceFile(path=relpath.replace(os.sep, "/"), text=text)
        sf.lines = text.splitlines()
        try:
            sf.tree = ast.parse(text)
        except SyntaxError as err:  # surfaced as a violation by the runner
            sf.parse_error = f"syntax error: {err}"
        sf.allows = parse_allows(sf)
        return sf


def parse_allows(sf: SourceFile) -> List[Allow]:
    """Extract ``# lint: allow(pass: reason)`` comments and compute the
    lines each one covers."""
    allows: List[Allow] = []
    for i, raw in enumerate(sf.lines, start=1):
        m = _ALLOW_RE.search(raw)
        if not m:
            continue
        covers = [i]
        code_before = raw[: m.start()].strip()
        if not code_before:
            # comment-only line: cover the next line that carries code
            j = i + 1
            while j <= len(sf.lines) and not sf.lines[j - 1].strip():
                j += 1
            if j <= len(sf.lines):
                covers.append(j)
        allows.append(
            Allow(
                path=sf.path,
                line=i,
                passname=m.group(1),
                reason=m.group(2),
                covers=tuple(covers),
            )
        )
    return allows


# -- tree loading -----------------------------------------------------------

#: directories never scanned (generated, caches, vendored) — plus the
#: lint suite itself: its docstrings and self-proof fixtures quote the
#: allow syntax and violation shapes verbatim, which must not parse as
#: live suppressions or findings.
SKIP_DIRS = {"__pycache__", ".git", "dist", "build", "node_modules",
             "analysis"}


def repo_root() -> str:
    """The repository root: the directory holding the ``babble_tpu_torch``
    package this module was imported from."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg_dir)


def load_tree(
    root: Optional[str] = None, paths: Optional[Sequence[str]] = None
) -> List[SourceFile]:
    """Load every ``.py`` under ``babble_tpu_torch/`` (plus ``cli``'s siblings)
    relative to ``root``, or exactly ``paths`` when given. Tests pass
    explicit fixture paths; CI runs the default walk."""
    root = root or repo_root()
    files: List[SourceFile] = []
    if paths:
        for p in paths:
            ab = p if os.path.isabs(p) else os.path.join(root, p)
            files.append(SourceFile.load(ab, os.path.relpath(ab, root)))
        return files
    pkg = os.path.join(root, "babble_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ab = os.path.join(dirpath, fn)
                files.append(SourceFile.load(ab, os.path.relpath(ab, root)))
    return files


# -- pass registry ----------------------------------------------------------

#: name -> callable(files, root) -> list[Violation]; populated by
#: register() at import time in __main__ (passes stay import-light so
#: fixtures can run one pass without loading the rest).
PassFn = Callable[[List[SourceFile], str], List[Violation]]
REGISTRY: Dict[str, PassFn] = {}


def register(name: str) -> Callable[[PassFn], PassFn]:
    def deco(fn: PassFn) -> PassFn:
        REGISTRY[name] = fn
        return fn

    return deco


def apply_allows(
    passname: str, files: List[SourceFile], violations: List[Violation]
) -> List[Violation]:
    """Suppress violations covered by a matching allow; emit stale-allow
    violations for allows of ``passname`` that suppressed nothing."""
    by_file: Dict[str, List[Allow]] = {}
    for sf in files:
        for a in sf.allows:
            if a.passname == passname:
                by_file.setdefault(sf.path, []).append(a)
    kept: List[Violation] = []
    for v in violations:
        suppressed = False
        for a in by_file.get(v.path, ()):
            if v.line in a.covers:
                a.consumed = True
                suppressed = True
        if not suppressed:
            kept.append(v)
    for allows in by_file.values():
        for a in allows:
            if not a.consumed:
                kept.append(
                    Violation(
                        a.path,
                        a.line,
                        passname,
                        f"stale allow: no {passname} violation on "
                        f"line(s) {'/'.join(map(str, a.covers))} to "
                        f"suppress (reason was: {a.reason!r}) — remove "
                        "the comment or restore the site it documented",
                    )
                )
    return kept


def check_unknown_allows(files: List[SourceFile]) -> List[Violation]:
    """An allow naming a pass that doesn't exist is always an error."""
    out: List[Violation] = []
    for sf in files:
        for a in sf.allows:
            if a.passname not in REGISTRY:
                out.append(
                    Violation(
                        sf.path,
                        a.line,
                        "allow",
                        f"unknown pass {a.passname!r} in allow comment "
                        f"(known: {', '.join(sorted(REGISTRY))})",
                    )
                )
    return out


def run_passes(
    names: Optional[Iterable[str]] = None,
    root: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    files: Optional[List[SourceFile]] = None,
) -> List[Violation]:
    """Run the named passes (default: all registered) over one shared
    parse of the tree, applying the suppression contract per pass."""
    # importing the pass modules populates REGISTRY
    from . import clock_pass, knob_pass, lock_pass, metrics_pass  # noqa: F401

    root = root or repo_root()
    if files is None:
        files = load_tree(root, paths)
    selected = list(names) if names else sorted(REGISTRY)
    out: List[Violation] = []
    for sf in files:
        if sf.parse_error:
            out.append(Violation(sf.path, 1, "parse", sf.parse_error))
    out.extend(check_unknown_allows(files))
    for name in selected:
        if name not in REGISTRY:
            raise SystemExit(
                f"babblelint: unknown pass {name!r} "
                f"(known: {', '.join(sorted(REGISTRY))})"
            )
        vs = REGISTRY[name](files, root)
        out.extend(apply_allows(name, files, vs))
    out.sort(key=lambda v: (v.path, v.line, v.passname))
    return out


def report(violations: List[Violation], stream=None) -> int:
    stream = stream or sys.stderr
    for v in violations:
        print(v.render(), file=stream)
    return 1 if violations else 0
