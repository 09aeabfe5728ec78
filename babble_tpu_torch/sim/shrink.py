"""Failure shrinking + replayable reproducer artifacts.

When a swept scenario violates an invariant, rerunning the full spec is
a bad starting point for debugging: it may carry five fault dimensions
when one suffices. ``shrink`` performs greedy delta-debugging over the
spec, in a deterministic candidate order:

1. drop nemesis steps (first halves, then single steps);
2. drop churn windows, the flood burst, and adversaries;
3. zero ambient fault rates (drop / duplicate / corrupt / delay);
4. remove a node; halve the fault-window duration.

A candidate replaces the current best only if it STILL fails (any
violation); the loop restarts from the smallest reductions until no
candidate fails or the run budget is exhausted. The result is a
strictly smaller (``ScenarioSpec.size()``) spec with a failing run —
never a guess.

The artifact is a self-contained JSON file: the shrunk spec, the
violations, and the run's determinism digests (commit sequences, event
log). ``replay_artifact`` re-executes the spec and reports whether the
digests still match — byte-level reproduction, not vibes.
"""

from __future__ import annotations

import json
from typing import Callable, Iterator, Optional, Tuple

from .scenario import ScenarioResult, ScenarioSpec, run_scenario

ARTIFACT_FORMAT = "babble-sim-repro/1"


def _candidates(spec: ScenarioSpec) -> Iterator[ScenarioSpec]:
    """Reductions in the order tried; every yield is strictly smaller."""
    n = spec.nemesis
    if len(n) > 1:
        half = len(n) // 2
        yield spec.with_(nemesis=n[:half])
        yield spec.with_(nemesis=n[half:])
    for i in range(len(n)):
        yield spec.with_(nemesis=n[:i] + n[i + 1:])
    c = spec.churn
    for i in range(len(c)):
        yield spec.with_(churn=c[:i] + c[i + 1:])
    if spec.flood is not None:
        yield spec.with_(flood=None)
    if spec.byzantine > 0:
        # churn indexes address the combined honest+byzantine range, so
        # dropping an adversary slot must drop churn that referenced it
        top = spec.nodes + spec.byzantine - 1
        yield spec.with_(
            byzantine=spec.byzantine - 1,
            churn=[x for x in c if x["node"] < top],
        )
    for dim in ("drop", "duplicate", "corrupt"):
        if getattr(spec, dim) > 0.0:
            yield spec.with_(**{dim: 0.0})
    if spec.delay_max_s > 0.0:
        yield spec.with_(delay_min_s=0.0, delay_max_s=0.0)
    if spec.nodes > 3:
        # churn/flood node indexes must stay in range after the removal
        nn = spec.nodes - 1
        churn = [x for x in spec.churn if x["node"] < nn + spec.byzantine]
        flood = spec.flood
        if flood is not None and flood.get("node", 0) >= nn:
            flood = dict(flood, node=0)
        yield spec.with_(nodes=nn, churn=churn, flood=flood)
    if spec.duration_s > 1.0:
        d = round(spec.duration_s / 2.0, 3)
        yield spec.with_(
            duration_s=d,
            nemesis=[s for s in spec.nemesis if s["at"] < d],
            churn=[s for s in spec.churn if s["at"] < d],
            flood=(spec.flood if spec.flood and spec.flood["at"] < d
                   else None),
        )


def shrink(
    spec: ScenarioSpec,
    runner: Callable[[ScenarioSpec], ScenarioResult] = run_scenario,
    max_runs: int = 40,
) -> Tuple[ScenarioSpec, ScenarioResult, int]:
    """Greedy reduction of a FAILING spec. Returns (smallest failing
    spec, its result, number of shrink runs). Raises ValueError if the
    input spec does not fail."""
    best_res = runner(spec)
    if best_res.ok:
        raise ValueError("shrink() needs a failing scenario")
    best = spec
    runs = 0
    improved = True
    while improved and runs < max_runs:
        improved = False
        for cand in _candidates(best):
            if runs >= max_runs:
                break
            runs += 1
            try:
                res = runner(cand)
            except Exception:
                # a reduction can compose into a spec the runner rejects
                # (e.g. cross-field validation); skip it — aborting the
                # sweep would lose the reproducer for the real failure
                continue
            if not res.ok:
                assert cand.size() < best.size(), "candidate must shrink"
                best, best_res = cand, res
                improved = True
                break
    return best, best_res, runs


# -- replay artifacts -----------------------------------------------------


def artifact_dict(
    spec: ScenarioSpec, result: ScenarioResult, shrink_runs: int = 0,
    original: Optional[ScenarioSpec] = None,
) -> dict:
    return {
        "format": ARTIFACT_FORMAT,
        "spec": spec.to_dict(),
        "original_spec": original.to_dict() if original else None,
        "shrink_runs": shrink_runs,
        "violations": result.violations,
        "commit_digests": result.commit_digests,
        "event_log_digest": result.event_log_digest,
        "telemetry_digest": result.telemetry_digest,
        "commits": result.commits,
        "virtual_s": result.virtual_s,
    }


def write_artifact(path: str, spec: ScenarioSpec, result: ScenarioResult,
                   shrink_runs: int = 0,
                   original: Optional[ScenarioSpec] = None) -> str:
    with open(path, "w") as f:
        json.dump(artifact_dict(spec, result, shrink_runs, original), f,
                  indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_artifact(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"not a sim reproducer artifact: {path}")
    return art


def replay_artifact(path: str) -> Tuple[ScenarioResult, bool]:
    """Re-run a reproducer. Returns (fresh result, digests_match) —
    ``digests_match`` is the byte-identical-replay check (commit
    sequences AND event interleaving)."""
    art = load_artifact(path)
    spec = ScenarioSpec.from_dict(art["spec"])
    result = run_scenario(spec)
    match = (
        result.commit_digests == art["commit_digests"]
        and result.event_log_digest == art["event_log_digest"]
    )
    return result, match
