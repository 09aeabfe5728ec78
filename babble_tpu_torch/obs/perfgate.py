"""Perf regression gate over the bench-history ledger.

``python -m babble_tpu_torch.obs.perfgate`` compares the most recent ledger
record (the run the CI job just appended) against a **rolling baseline**
of earlier records with the same host fingerprint and the same run kind
— cross-host or cross-kind comparisons are never made, because "slower
on different hardware" is not a regression.

Noise handling (the single shared-core CI host swings individual runs
hard, see docs/observability.md §overhead):

- the baseline is the **median** of the last ``--window`` matching
  records (median-of-N, not last-run-vs-this-run);
- each metric's tolerance band is ``max(--tolerance, 3 * MAD/median)``
  — a metric whose own history is noisy earns a wider band;
- only metrics with an inferable direction are gated (``*_per_s`` and
  ``*speedup``/``*ratio`` are higher-better, ``*_ms``/``*_s`` are
  lower-better; counts are informational);
- the gate **hard-fails only on corroborated regressions**: at least
  two gated metrics out of band, or one metric beyond twice its band
  (``--strict`` fails on any single band violation).

Self-proof: ``--inject-regression`` clones the latest record, degrades
every gated metric by ``--inject-factor`` (default 35%) in its bad
direction, and runs the gate on the synthetic record — CI asserts the
nonzero exit, so a silently-toothless gate cannot ship (the same
prove-the-detector pattern as ``sim.sweep --inject-failure``).

Exit codes: 0 pass / no baseline yet; 1 corroborated regression;
2 usage or empty ledger.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

from . import ledger

DEFAULT_WINDOW = 5
DEFAULT_TOLERANCE = 0.15
DEFAULT_INJECT_FACTOR = 0.35
NOISE_MULT = 3.0  # tolerance widens to 3x the metric's own MAD ratio
# Metrics whose |median| sits below these floors gate as absolute
# deltas instead of ratios (a 0.2ms p50 doubling to 0.4ms is noise).
ABS_FLOOR = {"ms": 5.0, "s": 0.005, "/s": 1.0, "x": 0.05, "count": 1.0}


def direction(name: str, unit: str) -> Optional[str]:
    """'higher' / 'lower' when better is inferable, else None
    (ungated)."""
    leaf = name.rsplit(".", 1)[-1]
    if unit == "/s" or "per_s" in leaf:
        return "higher"
    if leaf.endswith(("speedup", "ratio")) or leaf == "vs_baseline":
        return "higher"
    if unit in ("ms", "s") or leaf.endswith(("_ms", "_s")):
        return "lower"
    return None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _mad(vals: List[float], med: float) -> float:
    return _median([abs(v - med) for v in vals]) if vals else 0.0


def baseline_for(records: List[dict], current: dict,
                 window: int) -> List[dict]:
    """The rolling same-substrate baseline: earlier records with the
    current record's host fingerprint and run kind, newest ``window``."""
    fp = current.get("host", {}).get("fingerprint")
    kind = current.get("run")
    matches = [
        r for r in records
        if r is not current
        and r.get("host", {}).get("fingerprint") == fp
        and r.get("run") == kind
    ]
    return matches[-window:]


def gate(current: dict, baseline: List[dict],
         tolerance: float = DEFAULT_TOLERANCE,
         strict: bool = False) -> dict:
    """Compare one record against its baseline window. Returns the
    verdict dict (``ok``, ``regressions``, ``improvements``,
    ``checked``); ``ok`` is False only on a corroborated regression."""
    cur = ledger.results_map(current)
    history: Dict[str, List[float]] = {}
    for rec in baseline:
        for name, (value, _unit) in ledger.results_map(rec).items():
            history.setdefault(name, []).append(value)

    regressions, improvements, checked = [], [], 0
    for name, (value, unit) in sorted(cur.items()):
        vals = history.get(name)
        if not vals:
            continue
        direc = direction(name, unit)
        if direc is None:
            continue
        med = _median(vals)
        floor = ABS_FLOOR.get(unit, 0.0)
        if abs(med) < floor and abs(value) < floor:
            continue  # both sides under the absolute noise floor
        rel_noise = _mad(vals, med) / abs(med) if med else 0.0
        band = max(tolerance, NOISE_MULT * rel_noise)
        delta = (value - med) / abs(med) if med else 0.0
        worse = -delta if direc == "higher" else delta
        checked += 1
        row = {
            "metric": name,
            "unit": unit,
            "current": value,
            "baseline_median": round(med, 4),
            "baseline_n": len(vals),
            "delta_pct": round(100.0 * delta, 1),
            "band_pct": round(100.0 * band, 1),
            "direction": direc,
        }
        if worse > band:
            row["severity"] = "hard" if worse > 2 * band else "soft"
            regressions.append(row)
        elif -worse > band:
            improvements.append(row)

    corroborated = (
        len(regressions) >= 2
        or any(r["severity"] == "hard" for r in regressions)
        or (strict and bool(regressions))
    )
    return {
        "ok": not corroborated,
        "checked": checked,
        "baseline_runs": len(baseline),
        "regressions": regressions,
        "improvements": improvements,
        "tolerance": tolerance,
        "strict": strict,
    }


def inject_regression(current: dict, factor: float,
                      baseline: Optional[List[dict]] = None,
                      tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """A synthetic regressed clone of ``current``: every gated metric
    degraded by ``factor`` in its bad direction (the gate self-proof).

    The degradation anchors on the metric's BASELINE MEDIAN when a
    baseline is given, not on the current value: after a genuine
    bigger-than-``factor`` improvement, degrading the current run alone
    still beats the old median and the proof would falsely report a
    toothless gate. And it degrades by at least 2.2x the metric's OWN
    noise band (the gate's hard-regression threshold is 2x): right
    after a perf jump the window is bimodal and the MAD-widened band
    legitimately exceeds any fixed factor — the proof's claim is "the
    gate fires on a beyond-band regression", so the injection must be
    beyond the band the gate will actually apply. Metrics with no
    history fall back to the current value (they are ungated anyway)."""
    history: Dict[str, List[float]] = {}
    for rec in baseline or ():
        for name, (value, _unit) in ledger.results_map(rec).items():
            history.setdefault(name, []).append(value)
    bad = json.loads(json.dumps(current))
    bad["source"] = f"inject-regression:{factor}"
    for row in bad.get("results", ()):
        try:
            name, unit, value = row["name"], row.get("unit", ""), float(row["value"])
        except (KeyError, TypeError, ValueError):
            continue
        direc = direction(str(name), str(unit))
        vals = history.get(str(name))
        if vals:
            anchor = _median(vals)
            noise = _mad(vals, anchor) / abs(anchor) if anchor else 0.0
            # the SAME band formula gate() will apply — including the
            # caller's --tolerance, or a widened band makes the proof
            # falsely report a toothless gate
            band = max(tolerance, NOISE_MULT * noise)
            degrade = max(factor, 2.2 * band)
        else:
            anchor, degrade = value, factor
        if direc == "higher":
            row["value"] = round(anchor * (1.0 - degrade), 6)
        elif direc == "lower":
            row["value"] = round(anchor * (1.0 + degrade), 6)
    return bad


def _render(verdict: dict, current: dict) -> str:
    lines = []
    fp = current.get("host", {}).get("fingerprint")
    lines.append(
        f"perfgate: run={current.get('run')} rev={current.get('git_rev')} "
        f"host={fp} vs {verdict['baseline_runs']} baseline run(s), "
        f"{verdict['checked']} gated metric(s)"
    )
    for row in verdict["regressions"]:
        lines.append(
            f"  REGRESSION [{row['severity']}] {row['metric']}: "
            f"{row['current']}{row['unit']} vs median "
            f"{row['baseline_median']}{row['unit']} "
            f"({row['delta_pct']:+.1f}%, band ±{row['band_pct']:.1f}%, "
            f"n={row['baseline_n']})"
        )
    for row in verdict["improvements"]:
        lines.append(
            f"  improvement {row['metric']}: {row['current']}{row['unit']} "
            f"vs median {row['baseline_median']}{row['unit']} "
            f"({row['delta_pct']:+.1f}%)"
        )
    if verdict["baseline_runs"] == 0:
        lines.append(
            "  no same-host same-kind baseline yet — pass (the ledger "
            "grows one run per bench; the gate arms itself)"
        )
    lines.append(
        "perfgate: "
        + ("OK" if verdict["ok"] else "FAIL (corroborated regression)")
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.obs.perfgate",
        description="compare the latest bench run against its rolling "
        "same-host baseline; nonzero exit on corroborated regression",
    )
    p.add_argument("--history", default="",
                   help="ledger path (default: repo BENCH_HISTORY_TORCH.jsonl)")
    p.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                   help="baseline depth (median of the last N matching "
                   "runs)")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                   help="minimum per-metric tolerance band (fraction)")
    p.add_argument("--strict", action="store_true",
                   help="fail on ANY band violation (default: require "
                   "corroboration)")
    p.add_argument("--inject-regression", action="store_true",
                   help="self-proof: gate a synthetically regressed "
                   "clone of the latest run — MUST exit nonzero")
    p.add_argument("--inject-factor", type=float,
                   default=DEFAULT_INJECT_FACTOR)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the verdict as one JSON line")
    p.add_argument("--max-age-s", type=float, default=3600.0,
                   help="reject a stale latest record (guards against a "
                   "silently failed ledger append re-gating old history "
                   "as a pass; 0 disables)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    history = args.history or ledger.default_history_path()
    records = ledger.read(history)
    if not records:
        print(f"perfgate: no records in {history} — run a bench first",
              file=sys.stderr)
        return 2
    current = records[-1]
    # Freshness guard: bench._ledger_append swallows failures by design
    # (history must not kill a bench), so the gate — whose whole job is
    # teeth — must not quietly re-gate an OLD record as today's pass.
    import time as _time

    age = _time.time() - float(current.get("ts") or 0)
    if args.max_age_s > 0 and age > args.max_age_s:
        print(
            f"perfgate: latest record is {age / 3600:.1f}h old "
            f"(> {args.max_age_s / 3600:.1f}h) — the bench's ledger "
            "append likely failed; refusing to gate stale history "
            "(--max-age-s 0 to override)",
            file=sys.stderr,
        )
        return 2

    if args.inject_regression:
        # Baseline for the synthetic record includes the REAL latest run
        # (that is the history the regression would land on); a window
        # of one genuine run is enough for the proof. Built BEFORE the
        # injection so the clone can degrade from the baseline medians.
        probe = {"host": current.get("host", {}), "run": current.get("run")}
        baseline = baseline_for(records, probe, args.window)
        # the real latest run always corroborates its own clone's gate
        baseline = baseline or [current]
        bad = inject_regression(current, args.inject_factor, baseline,
                                tolerance=args.tolerance)
        verdict = gate(bad, baseline, args.tolerance, args.strict)
        current = bad
        _emit(verdict, current, args.as_json)
        # The injected run gates EXACTLY like a real one: regression →
        # exit 1. A toothless gate exits 0 here, and the make target's
        # inversion check (`if perfgate --inject-regression; then fail`)
        # turns that 0 into the build failure — the self-proof.
        if verdict["ok"]:
            print(
                "perfgate: INJECTED regression was NOT detected — the "
                "gate is toothless", file=sys.stderr,
            )
            return 0
        print(
            f"perfgate: injected regression correctly detected "
            f"({len(verdict['regressions'])} metric(s)) — exiting nonzero",
            file=sys.stderr,
        )
        return 1

    baseline = baseline_for(records, current, args.window)
    verdict = gate(current, baseline, args.tolerance, args.strict)
    _emit(verdict, current, args.as_json)
    return 0 if verdict["ok"] else 1


def _emit(verdict: dict, current: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(
            {
                "perfgate": verdict,
                "run": current.get("run"),
                "git_rev": current.get("git_rev"),
                "source": current.get("source"),
            },
            separators=(",", ":"),
        ))
    else:
        print(_render(verdict, current))


if __name__ == "__main__":
    sys.exit(main())
