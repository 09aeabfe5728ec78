"""Seeded scenario sweep: ``python -m babble_tpu_torch.sim.sweep``.

Generates N scenario combinations — chaos profile x Byzantine attack x
crash churn x mempool flood, each dimension drawn from a seeded stream
— runs them all in virtual time, and on any invariant violation shrinks
the failing spec to a minimal reproducer written as a replayable JSON
artifact (babble_tpu_torch.sim.shrink).

The last stdout line is a compact JSON summary (same tail-capture
contract as bench.py); everything else goes to stderr. Determinism
contract: the same ``--seed``/``--seeds`` invocation produces
byte-identical commit sequences and event logs — verify with
``--dump FILE`` twice and compare the files.

Typical invocations:

    python -m babble_tpu_torch.sim.sweep --seeds 200            # make simsmoke
    python -m babble_tpu_torch.sim.sweep --seeds 2000           # make simsweep
    python -m babble_tpu_torch.sim.sweep --seeds 1 --seed 7 --dump a.json
    python -m babble_tpu_torch.sim.sweep --replay artifact.json
    python -m babble_tpu_torch.sim.sweep --seeds 5 --inject-failure --out d/
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from typing import List, Optional

from .harness import sim_addr
from .scenario import ScenarioSpec, run_scenario
from .shrink import replay_artifact, shrink, write_artifact

CHAOS_PROFILES = (
    "none", "drop", "drop", "partition", "partition_drop", "flap", "slow",
)
BYZ_ATTACKS = (
    "none", "none", "none",
    "equivocate", "equivocate", "wrong_key", "oversize", "replay",
    "lying_known", "garbage",
)


def generate_scenario(master_seed: int, i: int) -> ScenarioSpec:
    """Deterministic combination #i for a master seed. Budgets are sized
    for sweep throughput: ~1 virtual second of faults on 3-5 nodes; the
    settle phase extends itself when convergence needs longer."""
    rng = random.Random(f"{master_seed}|scenario|{i}")
    seed = int(rng.getrandbits(32))
    nodes = rng.choice((3, 3, 4, 4, 5))
    chaos = rng.choice(CHAOS_PROFILES)
    attack = rng.choice(BYZ_ATTACKS)
    byz = 0
    if attack != "none":
        # stay inside the BFT bound: f >= 1 needs >= 4 validators
        if nodes < 4:
            nodes = 4
        byz = 1
        nodes -= 1  # keep total validators modest: n_honest + 1 adversary
    duration = round(rng.uniform(0.7, 1.1), 3)
    spec = ScenarioSpec(
        seed=seed,
        name=f"s{i}:{chaos}+{attack}",
        nodes=nodes,
        byzantine=byz,
        attack=attack if attack != "none" else "equivocate",
        duration_s=duration,
        heartbeat_s=0.08,
        tx_rate=5.0,
        settle_s=0.8,
        settle_rounds=6,
        mempool_max_txs=256,
    )
    n_total = nodes + byz
    addrs = [sim_addr(k) for k in range(n_total)]
    if chaos == "drop":
        spec = spec.with_(drop=round(rng.uniform(0.05, 0.2), 3),
                          duplicate=0.05)
    elif chaos == "slow":
        spec = spec.with_(delay_min_s=0.001, delay_max_s=0.01)
    elif chaos in ("partition", "partition_drop"):
        cut = rng.randrange(1, n_total)
        t0 = round(rng.uniform(0.1, 0.3), 3)
        heal = round(t0 + rng.uniform(0.3, duration - t0), 3)
        spec = spec.with_(
            nemesis=[
                {"at": t0, "op": "partition",
                 "kwargs": {"groups": [addrs[:cut], addrs[cut:]]}},
                {"at": heal, "op": "heal", "kwargs": {}},
            ],
            drop=(0.1 if chaos == "partition_drop" else 0.0),
        )
    elif chaos == "flap":
        victim = rng.randrange(n_total)
        spec = spec.with_(nemesis=[
            {"at": 0.2, "op": "isolate",
             "kwargs": {"addr": addrs[victim], "others": addrs}},
            {"at": 0.6, "op": "heal_peer",
             "kwargs": {"addr": addrs[victim], "others": addrs}},
        ])
    if rng.random() < 0.25:
        victim = rng.randrange(nodes)  # churn an HONEST node
        down = round(rng.uniform(0.1, 0.4), 3)
        up = round(down + rng.uniform(0.2, 0.5), 3)
        spec = spec.with_(churn=[
            {"at": down, "node": victim, "action": "down"},
            {"at": up, "node": victim, "action": "up"},
        ])
    if rng.random() < 0.25:
        spec = spec.with_(flood={
            "at": round(rng.uniform(0.1, 0.5), 3),
            "count": 400,
            "node": rng.randrange(nodes),
        })
    return spec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.sim.sweep",
        description="seeded virtual-time scenario sweep with shrinking",
    )
    ap.add_argument("--seeds", type=int, default=100,
                    help="number of scenario combinations to run")
    ap.add_argument("--seed", type=int, default=42, help="master seed")
    ap.add_argument("--out", default="sim_artifacts",
                    help="directory for failure reproducer artifacts")
    ap.add_argument("--dump", default="",
                    help="write per-scenario determinism digests here")
    ap.add_argument("--no-shrink", action="store_true",
                    help="record failures without shrinking them")
    ap.add_argument("--max-shrink-runs", type=int, default=40)
    ap.add_argument("--inject-failure", action="store_true",
                    help="force scenario #0 to violate a pseudo-invariant "
                         "(CI proof that shrinking + artifacts work)")
    ap.add_argument("--replay", default="",
                    help="re-run a reproducer artifact and exit")
    args = ap.parse_args(argv)

    if args.replay:
        result, match = replay_artifact(args.replay)
        print(json.dumps({
            "replay": args.replay,
            "violations": result.violations,
            "digests_match": match,
            "commits": result.commits,
        }, sort_keys=True))
        return 0 if (result.violations and match) else 1

    wall0 = time.perf_counter()
    passed = failed = shrunk = 0
    commits_total = 0
    events_total = 0
    virtual_total = 0.0
    artifacts: List[str] = []
    violations_by_invariant: dict = {}
    dump_rows = []

    for i in range(args.seeds):
        spec = generate_scenario(args.seed, i)
        if args.inject_failure and i == 0:
            if not spec.nemesis:
                spec = spec.with_(nemesis=[
                    {"at": 0.2, "op": "partition", "kwargs": {"groups": [
                        [sim_addr(0)],
                        [sim_addr(k)
                         for k in range(1, spec.nodes + spec.byzantine)],
                    ]}},
                    {"at": 0.5, "op": "heal", "kwargs": {}},
                ])
            spec = spec.with_(inject_failure=True)
        result = run_scenario(spec)
        commits_total += max(result.commits) + 1 if result.commits else 0
        events_total += result.events_run
        virtual_total += result.virtual_s
        if result.ok:
            passed += 1
        else:
            failed += 1
            for v in result.violations:
                violations_by_invariant[v["invariant"]] = (
                    violations_by_invariant.get(v["invariant"], 0) + 1
                )
            print(
                f"FAIL {spec.name} seed={spec.seed}: {result.violations}",
                file=sys.stderr,
            )
            small, small_res, runs = spec, result, 0
            if not args.no_shrink:
                small, small_res, runs = shrink(
                    spec, max_runs=args.max_shrink_runs
                )
                shrunk += 1
                print(
                    f"  shrunk {spec.size()} -> {small.size()} "
                    f"in {runs} runs",
                    file=sys.stderr,
                )
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(
                args.out, f"repro_{i}_{small.digest()}.json"
            )
            write_artifact(path, small, small_res, runs, original=spec)
            artifacts.append(path)
        if args.dump:
            dump_rows.append({
                "i": i,
                "name": spec.name,
                "spec_digest": spec.digest(),
                "commit_digests": result.commit_digests,
                "event_log_digest": result.event_log_digest,
                "telemetry_digest": result.telemetry_digest,
                "violations": result.violations,
            })

    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(dump_rows, f, indent=1, sort_keys=True)
            f.write("\n")

    wall = time.perf_counter() - wall0
    summary = {
        "sim_scenarios": args.seeds,
        "passed": passed,
        "failed": failed,
        "shrunk": shrunk,
        "violations": violations_by_invariant,
        "artifacts": artifacts[:5],
        "blocks_committed": commits_total,
        "sim_events": events_total,
        "virtual_s": round(virtual_total, 1),
        "wall_s": round(wall, 1),
        "scenarios_per_s": round(args.seeds / wall, 2) if wall else None,
        "speedup_virtual": round(virtual_total / wall, 1) if wall else None,
        "seed": args.seed,
    }
    # Runtime lock-order audit (docs/static_analysis.md §Lock model):
    # with BABBLE_LOCKCHECK=1 the whole sweep doubles as an empirical
    # check of the static lock graph — simsmoke asserts zero inversions.
    from ..common import lockcheck

    if lockcheck.ENABLED:
        summary["lock_order_edges"] = len(lockcheck.RECORDER.edge_list())
        summary["lock_inversions"] = len(lockcheck.RECORDER.inversions())
    line = json.dumps(summary, sort_keys=True)
    assert len(line) < 2000, "summary line contract: keep it compact"
    print(line)
    # exit nonzero on violations so a bare `make simsweep` (no assertion
    # pipe) still fails CI; artifacts are on disk either way
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
