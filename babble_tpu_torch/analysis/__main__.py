"""babblelint entry point.

Usage::

    python -m babble_tpu_torch.analysis                 # all passes, tree
    python -m babble_tpu_torch.analysis --pass clock    # one pass
    python -m babble_tpu_torch.analysis path/to/file.py # explicit files
    python -m babble_tpu_torch.analysis --self-proof    # prove the teeth

Exit codes: 0 clean, 1 violations, 2 usage error. ``--self-proof``
injects one violation per pass (plus a stale allow) into synthetic
sources and exits nonzero unless EVERY pass catches its injection — the
perfgate ``--inject-regression`` pattern: a toothless linter fails the
build, not the code it was supposed to guard.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .core import REGISTRY, SourceFile, load_tree, report, run_passes

# -- self-proof fixtures -----------------------------------------------------

_CLOCK_BAD = """\
import time
import random


def jitter(interval):
    time.sleep(0.1)
    return interval + random.random() * interval
"""

_LOCKS_BAD = """\
import time


class Node:
    def gossip(self):
        with self.core_lock:
            time.sleep(0.5)
"""

_KNOBS_CONFIG_BAD = """\
from dataclasses import dataclass

DEFAULT_ORPHANED_KNOB = 42


@dataclass
class Config:
    ghost_knob: int = 0
"""

_KNOBS_CLI_BAD = """\
_RUN_FLAGS = {
    "dangling": ("not_a_field", str),
}
"""

_METRICS_DOCS_BAD = """\
<!-- metrics-table-start -->
| `this_instrument_does_not_exist` | counter | - | node | bogus |
<!-- metrics-table-end -->
"""

_STALE_ALLOW = """\
import os

# lint: allow(clock: this allow matches nothing and must be flagged)
x = os.getcwd()
"""


#: where the self-proof's synthetic node-side sources claim to live
_INJECT = "babble_tpu_torch/node/_inject.py"


def self_proof() -> int:
    """Each pass must catch its injected violation; the allow layer must
    catch a stale allow. Prints one line per pass; exit 0 = all fired."""
    from . import clock_pass, knob_pass, lock_pass, metrics_pass
    from .core import apply_allows

    failures = []

    def fired(name: str, violations, want: str = "") -> None:
        hit = [v for v in violations if want in v.message]
        status = "fired" if hit else "TOOTHLESS"
        print(f"self-proof [{name}]: {status} "
              f"({len(violations)} violation(s))")
        if not hit:
            failures.append(name)

    files = [SourceFile.from_text(_INJECT, _CLOCK_BAD)]
    fired("clock", clock_pass.run(files, "."))

    files = [SourceFile.from_text(_INJECT, _LOCKS_BAD)]
    fired("locks", lock_pass.run(files, "."), "blocking call")

    with tempfile.TemporaryDirectory() as td:
        os.makedirs(os.path.join(td, "docs"))
        knobs_md = os.path.join(td, knob_pass.DOCS_PATH)
        os.makedirs(os.path.dirname(knobs_md))
        with open(knobs_md, "w") as f:
            f.write("<!-- knob-table-start -->\n<!-- knob-table-end -->\n")
        files = [
            SourceFile.from_text(knob_pass.CONFIG_PATH, _KNOBS_CONFIG_BAD),
            SourceFile.from_text(knob_pass.CLI_PATH, _KNOBS_CLI_BAD),
        ]
        fired("knobs", knob_pass.run(files, td), "ghost_knob")

        with open(os.path.join(td, "docs", "observability.md"), "w") as f:
            f.write(_METRICS_DOCS_BAD)
        fired(
            "metrics",
            metrics_pass.check(
                os.path.join(td, "docs", "observability.md")
            ),
            "this_instrument_does_not_exist",
        )

    files = [SourceFile.from_text(_INJECT, _STALE_ALLOW)]
    fired(
        "stale-allow",
        apply_allows("clock", files, clock_pass.run(files, ".")),
        "stale allow",
    )

    if failures:
        print(
            f"self-proof FAILED: pass(es) did not fire: "
            f"{', '.join(failures)}",
            file=sys.stderr,
        )
        return 1
    print("self-proof ok: every pass caught its injected violation")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.analysis",
        description="babblelint — project-wide static analysis "
        "(docs/static_analysis.md)",
    )
    p.add_argument(
        "--pass",
        dest="passes",
        default=None,
        help="comma-separated pass names (default: all)",
    )
    p.add_argument("--root", default=None, help="repository root")
    p.add_argument("--list", action="store_true", help="list passes")
    p.add_argument(
        "--self-proof",
        action="store_true",
        help="inject one violation per pass; exit nonzero unless every "
        "pass fires",
    )
    p.add_argument("paths", nargs="*", help="explicit files (default: tree)")
    args = p.parse_args(argv)

    if args.self_proof:
        return self_proof()
    # populate the registry before --list
    from . import clock_pass, knob_pass, lock_pass, metrics_pass  # noqa: F401

    if args.list:
        for name in sorted(REGISTRY):
            print(name)
        return 0
    names = args.passes.split(",") if args.passes else None
    root = args.root
    files = load_tree(root, args.paths or None)
    violations = run_passes(names=names, root=root, files=files)
    rc = report(violations)
    if rc == 0:
        ran = ",".join(sorted(names or REGISTRY))
        print(f"babblelint ok: {len(files)} files clean ({ran})")
    else:
        print(
            f"babblelint: {len(violations)} violation(s) — fix the site, "
            "or document it with '# lint: allow(<pass>: <reason>)'",
            file=sys.stderr,
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
