"""Deterministic simulation engine (docs/simulation.md).

FoundationDB-style testing for the consensus stack: a virtual-time
clock (:mod:`.clock`), a single-threaded event scheduler
(:mod:`.scheduler`), a synchronous in-memory transport
(:mod:`.transport`), a harness that drives REAL ``Node`` /
``ByzantineNode`` objects as scheduled events (:mod:`.harness`), a
declarative scenario layer composing chaos, Byzantine attacks, churn
and mempool floods (:mod:`.scenario`), failure shrinking with
replayable artifacts (:mod:`.shrink`), and the seeded sweep driver
(``python -m babble_tpu_torch.sim.sweep``).
"""

from .clock import SimClock
from .scheduler import SimScheduler
from .scenario import ScenarioSpec, ScenarioResult, run_scenario
from .shrink import shrink, write_artifact, load_artifact, replay_artifact

__all__ = [
    "SimClock",
    "SimScheduler",
    "ScenarioSpec",
    "ScenarioResult",
    "run_scenario",
    "shrink",
    "write_artifact",
    "load_artifact",
    "replay_artifact",
]
