"""knobs — the Config ↔ CLI ↔ toml ↔ docs knob-parity pass.

``watchdog_interval_s`` once shipped with a ``_RUN_FLAGS`` entry but no
``add_argument`` — ``--watchdog-interval`` silently didn't exist until a
review caught it. This pass makes that whole drift class mechanical:

1. every ``Config`` field is reachable from operators: it has a
   ``_RUN_FLAGS`` entry (which IS the toml key — the toml layer iterates
   ``_RUN_FLAGS``). Runtime injection points (``clock``, ``sim_seed``)
   carry ``# lint: allow(knobs: …)`` where they are defined;
2. every ``_RUN_FLAGS`` entry maps to a real ``Config`` field (no
   dangling attrs);
3. every ``_RUN_FLAGS`` key has a matching run-subparser
   ``add_argument`` dest (toml-only knobs — negative-polarity booleans
   like ``adaptive_gossip`` — carry an allow on the dict line);
4. every run-subparser ``add_argument`` dest feeds ``_RUN_FLAGS`` or is
   a declared CLI-only argument (proxy endpoints, ``--no-*`` toggles);
5. every ``DEFAULT_*`` constant in config.py is read somewhere in the
   package (an orphaned default is drift waiting to happen);
6. the port's knob table, ``analysis/knobs.md`` (between
   ``<!-- knob-table-start/end -->``), lists every run flag and every
   toml-only key, and nothing else — two-way, the metricslint contract
   applied to knobs. The port owns its table: its CLI has a flag the JAX
   package's has not (``--accelerator-device``), and its accelerator
   rows describe the CUDA kernels, so ``docs/design.md`` stays the JAX
   package's.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import SourceFile, Violation, register

CONFIG_PATH = "babble_tpu_torch/config/config.py"
CLI_PATH = "babble_tpu_torch/cli/main.py"
DOCS_PATH = "babble_tpu_torch/analysis/knobs.md"

#: run-subparser arguments that are deliberately CLI-only (not Config
#: knobs): proxy wiring consumed before Config is built, and
#: negative-polarity toggles whose positive knob is toml-routed.
CLI_ONLY_DESTS = {
    "datadir",  # consumed as the _RUN_FLAGS "datadir" key
    "proxy_listen",
    "client_connect",
    "inmem_dummy",
    "no_adaptive",
    "no_gossip_pipeline",
    "no_prune_vacuum",
}

KNOB_START = "<!-- knob-table-start -->"
KNOB_END = "<!-- knob-table-end -->"
_KNOB_ROW = re.compile(r"^\|\s*`(--[a-z0-9-]+|[a-z_]+ \(toml\))`")


def _config_fields(sf: SourceFile) -> Dict[str, int]:
    """Config dataclass field name -> line."""
    fields: Dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    fields[stmt.target.id] = stmt.lineno
    return fields


def _default_constants(sf: SourceFile) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.startswith("DEFAULT_"):
                    out[t.id] = node.lineno
    return out


def _run_flags(sf: SourceFile) -> Dict[str, Tuple[str, int]]:
    """_RUN_FLAGS flag key -> (Config attr, line of the dict entry)."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "_RUN_FLAGS"
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            for k, v in zip(node.value.keys, node.value.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(v, ast.Tuple)
                    and v.elts
                    and isinstance(v.elts[0], ast.Constant)
                ):
                    out[k.value] = (v.elts[0].value, k.lineno)
    return out


def _run_arguments(sf: SourceFile) -> Dict[str, Tuple[str, int]]:
    """run-subparser dest -> (first long option string, line)."""
    run_vars: Set[str] = set()
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "add_parser"
            and node.value.args
            and isinstance(node.value.args[0], ast.Constant)
            and node.value.args[0].value == "run"
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    run_vars.add(t.id)
    dests: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in run_vars
        ):
            opts = [
                a.value
                for a in node.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)
            ]
            long_opts = [o for o in opts if o.startswith("--")]
            if not long_opts:
                continue
            dest: Optional[str] = None
            for kw in node.keywords:
                if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                    dest = kw.value.value
            if dest is None:
                dest = long_opts[0].lstrip("-").replace("-", "_")
            dests[dest] = (long_opts[0], node.lineno)
    return dests


def _documented_knobs(root: str) -> Tuple[Set[str], int, Optional[str]]:
    """Backticked first-column entries of the knob table, the marker
    line, and an error when the table is missing."""
    path = os.path.join(root, DOCS_PATH)
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as err:
        return set(), 1, f"knob table source unreadable: {err}"
    if KNOB_START not in text or KNOB_END not in text:
        return (
            set(),
            1,
            f"marker comments {KNOB_START!r}/{KNOB_END!r} not found in "
            f"{DOCS_PATH}",
        )
    start_line = text[: text.index(KNOB_START)].count("\n") + 1
    body = text.split(KNOB_START, 1)[1].split(KNOB_END, 1)[0]
    rows: Set[str] = set()
    for line in body.splitlines():
        m = _KNOB_ROW.match(line.strip())
        if m:
            rows.add(m.group(1))
    return rows, start_line, None


@register("knobs")
def run(files: List[SourceFile], root: str) -> List[Violation]:
    cfg = next((f for f in files if f.path == CONFIG_PATH), None)
    cli = next((f for f in files if f.path == CLI_PATH), None)
    out: List[Violation] = []
    if cfg is None or cfg.tree is None or cli is None or cli.tree is None:
        # fixture runs that scan only snippets skip the knob contract
        return out
    fields = _config_fields(cfg)
    flags = _run_flags(cli)
    dests = _run_arguments(cli)
    flag_attrs = {attr for attr, _ in flags.values()}

    # (1) every Config field has a CLI/toml route
    for name, line in sorted(fields.items()):
        if name not in flag_attrs:
            out.append(
                Violation(
                    cfg.path,
                    line,
                    "knobs",
                    f"Config field {name!r} has no _RUN_FLAGS entry — "
                    "operators can't reach it from the CLI or babble.toml "
                    "(add the flag, or allow() a runtime injection point)",
                )
            )
    # (2) no dangling _RUN_FLAGS attrs
    for flag, (attr, line) in sorted(flags.items()):
        if attr not in fields:
            out.append(
                Violation(
                    cli.path,
                    line,
                    "knobs",
                    f"_RUN_FLAGS maps {flag!r} to Config.{attr}, which "
                    "does not exist",
                )
            )
    # (3) every _RUN_FLAGS key is parseable from the CLI
    for flag, (_attr, line) in sorted(flags.items()):
        if flag not in dests:
            out.append(
                Violation(
                    cli.path,
                    line,
                    "knobs",
                    f"_RUN_FLAGS key {flag!r} has no run-subparser "
                    f"add_argument dest — '--{flag.replace('_', '-')}' "
                    "silently doesn't exist (the --watchdog-interval "
                    "drift class); add the flag or allow() a toml-only "
                    "knob",
                )
            )
    # (4) every run argument feeds Config or is declared CLI-only
    for dest, (opt, line) in sorted(dests.items()):
        if dest not in flags and dest not in CLI_ONLY_DESTS:
            out.append(
                Violation(
                    cli.path,
                    line,
                    "knobs",
                    f"run argument {opt} (dest {dest!r}) feeds neither "
                    "_RUN_FLAGS nor the CLI-only list — its value is "
                    "dropped on the floor",
                )
            )
    # (5) orphaned DEFAULT_* constants
    consts = _default_constants(cfg)
    used: Set[str] = set()
    for sf in files:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Load
            ):
                if node.id.startswith("DEFAULT_"):
                    used.add(node.id)
    for name, line in sorted(consts.items()):
        if name not in used:
            out.append(
                Violation(
                    cfg.path,
                    line,
                    "knobs",
                    f"orphaned constant {name}: assigned in config.py but "
                    "read nowhere in the package",
                )
            )
    # (6) docs knob table, two-way
    documented, marker_line, err = _documented_knobs(root)
    if err:
        out.append(Violation(DOCS_PATH, marker_line, "knobs", err))
        return out
    expected: Set[str] = set()
    for dest, (opt, _line) in dests.items():
        expected.add(opt)
    for flag in flags:
        if flag not in dests:
            expected.add(f"{flag} (toml)")  # toml-only knob
    for name in sorted(expected - documented):
        out.append(
            Violation(
                DOCS_PATH,
                marker_line,
                "knobs",
                f"knob `{name}` missing from the docs table",
            )
        )
    for name in sorted(documented - expected):
        out.append(
            Violation(
                DOCS_PATH,
                marker_line,
                "knobs",
                f"documented knob `{name}` does not exist in "
                f"{CLI_PATH}",
            )
        )
    return out
