"""babblelint — the project-wide static-analysis suite.

The paper's determinism and liveness claims rest on invariants the code
historically enforced only by convention: every subsystem must route
time and randomness through ``Config.clock`` / ``Config.seeded_rng`` so
sim runs replay byte-identically (docs/simulation.md), the core lock
must cover only the insert tail and never a blocking call
(docs/gossip.md), and every ``Config`` knob must stay reachable from the
CLI, the toml layer, and the docs (the ``--watchdog-interval`` drift
class). ``python -m babble_tpu_torch.analysis`` checks all of it mechanically
— the way production consensus systems back their TLA+-adjacent
invariants with lint layers (docs/static_analysis.md).

Passes (each importable standalone):

- ``clock``   — clock/RNG discipline (analysis/clock_pass.py)
- ``locks``   — static lock graph + blocking-while-locked
  (analysis/lock_pass.py), validated at runtime by the BABBLE_LOCKCHECK
  recorder in common/lockcheck.py
- ``knobs``   — Config ↔ CLI ↔ toml ↔ docs knob parity
  (analysis/knob_pass.py)
- ``metrics`` — instrument catalog ↔ docs table (analysis/metrics_pass.py,
  the absorbed obs/lint.py, which remains as a compat shim)

Inline suppressions: ``# lint: allow(<pass>: <reason>)`` on the
violating line or the line directly above. Allows are themselves linted
— one that matches no violation is an error, so the allowlist can't rot.
"""

from .core import (  # noqa: F401
    Allow,
    SourceFile,
    Violation,
    load_tree,
    parse_allows,
    run_passes,
)
