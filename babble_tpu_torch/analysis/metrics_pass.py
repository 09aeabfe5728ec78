"""metrics — instrument catalog ↔ docs table parity.

The absorbed metricslint (formerly the whole of ``obs/lint.py``, which
remains as a compat shim): the instrument catalog
(``obs.catalog.CATALOG``) and the table between
``<!-- metrics-table-start/end -->`` in docs/observability.md must match
exactly, in both directions — a new instrument cannot ship undocumented,
and a stale docs row cannot outlive its instrument.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Set

from .core import SourceFile, Violation, register

DOCS_PATH = "docs/observability.md"
START = "<!-- metrics-table-start -->"
END = "<!-- metrics-table-end -->"
_ROW = re.compile(r"^\|\s*`([a-zA-Z_][a-zA-Z0-9_]*)`")


def documented_names(text: str) -> Set[str]:
    try:
        body = text.split(START, 1)[1].split(END, 1)[0]
    except IndexError:
        raise SystemExit(
            f"metrics lint: marker comments {START!r}/{END!r} not found "
            "in the docs file"
        )
    names = set()
    for line in body.splitlines():
        m = _ROW.match(line.strip())
        if m:
            names.add(m.group(1))
    return names


def check(path: str) -> List[Violation]:
    from ..obs.catalog import CATALOG

    with open(path, encoding="utf-8") as f:
        text = f.read()
    if START not in text:
        return [
            Violation(
                path, 1, "metrics",
                f"marker comments {START!r}/{END!r} not found",
            )
        ]
    marker_line = text[: text.index(START)].count("\n") + 1
    docs = documented_names(text)
    cataloged = {i.name for i in CATALOG}
    out: List[Violation] = []
    for n in sorted(cataloged - docs):
        out.append(
            Violation(
                path, marker_line, "metrics",
                f"registered instrument `{n}` missing from the docs table",
            )
        )
    for n in sorted(docs - cataloged):
        out.append(
            Violation(
                path, marker_line, "metrics",
                f"documented name `{n}` missing from "
                "babble_tpu_torch/obs/catalog.py",
            )
        )
    return out


@register("metrics")
def run_pass(files: List[SourceFile], root: str) -> List[Violation]:
    path = os.path.join(root, DOCS_PATH)
    if not os.path.exists(path):
        # fixture runs without a docs tree skip the contract
        return []
    vs = check(path)
    # report repo-relative like every other pass
    for v in vs:
        v.path = DOCS_PATH
    return vs


# -- obs/lint.py compat surface ---------------------------------------------

def run(path: str) -> int:
    """The original ``obs.lint.run`` contract: print mismatches to
    stderr, return 1 on drift, 0 (with a summary line) when clean —
    and raise SystemExit when the marker comments are missing
    entirely (callers and tests rely on that distinction)."""
    from ..obs.catalog import CATALOG

    with open(path, encoding="utf-8") as f:
        documented_names(f.read())  # raises SystemExit on no markers
    vs = check(path)
    for v in vs:
        print(f"metrics lint: {v.message} ({path})", file=sys.stderr)
    if vs:
        return 1
    print(
        f"metrics lint ok: {len(CATALOG)} instruments match "
        f"between catalog and {path}"
    )
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "docs/observability.md"
    return run(path)
