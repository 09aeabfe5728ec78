"""Declarative seeded scenarios + the invariant checker.

A :class:`ScenarioSpec` is a JSON-serializable description of one
simulated run: cluster shape (honest + Byzantine validators), ambient
link faults, a nemesis schedule (the same ``NemesisStep`` ops the
wall-clock chaos layer runs), crash/restart churn windows, a mempool
flood burst, and a background transaction mix. ``run_scenario``
executes it entirely in virtual time and checks four invariants:

- **no_fork** — every block in the honest nodes' common prefix is
  byte-identical (block-body hash);
- **liveness** — after every fault heals, all honest nodes commit at
  least one NEW block (the settle phase extends a bounded number of
  times before declaring a violation, so slow convergence isn't
  misread as a stall);
- **bounded_queues** — mempool pending never exceeds its cap and the
  undetermined-event set is bounded at the end;
- **exactly_once** — no transaction commits twice on any honest node,
  and every transaction a node's mempool ACCEPTED is committed on that
  node by the end (no loss).

``inject_failure=True`` adds a deliberately-failing pseudo-invariant
(it trips whenever the nemesis schedule is non-empty); the sweep uses
it to prove, in CI, that a failure actually shrinks to a minimal
replayable artifact.

Determinism boundary (docs/simulation.md): everything inside the
scheduler is seeded; signing is forced onto RFC 6979 for the run
because the consensus order breaks ties on signature ``r``.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional

from ..crypto.keys import set_deterministic_signing
from ..net.chaos import LinkFaults
from .harness import SimCluster, sim_addr
from .scheduler import SimScheduler

SPEC_FORMAT = "babble-sim-scenario/1"


@dataclass
class ScenarioSpec:
    seed: int = 42
    name: str = ""
    nodes: int = 4  # honest validators
    byzantine: int = 0  # adversarial validators (keep <= (n-1)//3)
    attack: str = "equivocate"
    split: bool = False
    duration_s: float = 2.0  # fault window (virtual seconds)
    heartbeat_s: float = 0.05
    # ambient link faults (every directed link, whole run until heal)
    drop: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    delay_min_s: float = 0.0
    delay_max_s: float = 0.0
    # scheduled fault transitions: [{"at": s, "op": name, "kwargs": {}}]
    # — ops are ChaosController methods, exactly like NemesisStep
    nemesis: List[dict] = field(default_factory=list)
    # crash churn: [{"at": s, "node": i, "action": "down"|"up"}]
    churn: List[dict] = field(default_factory=list)
    # mempool overload burst: {"at": s, "count": n, "node": i}
    flood: Optional[dict] = None
    tx_rate: float = 15.0  # background submissions/s across the cluster
    sync_limit: int = 256
    mempool_max_txs: int = 512
    settle_s: float = 2.0  # post-heal liveness window (extended, bounded)
    settle_rounds: int = 4
    max_undetermined: int = 600
    inject_failure: bool = False  # deliberate violation (shrink/CI proof)

    # -- codec ----------------------------------------------------------

    def to_dict(self) -> dict:
        d = asdict(self)
        d["format"] = SPEC_FORMAT
        return d

    @staticmethod
    def from_dict(d: dict) -> "ScenarioSpec":
        d = dict(d)
        fmt = d.pop("format", SPEC_FORMAT)
        if fmt != SPEC_FORMAT:
            raise ValueError(f"unknown scenario format {fmt!r}")
        return ScenarioSpec(**d)

    def digest(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True,
                             separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def with_(self, **kw) -> "ScenarioSpec":
        return replace(self, **kw)

    def size(self) -> tuple:
        """Shrink ordering: a spec is strictly smaller when this tuple
        is (nodes+adversaries, scheduled fault count, ambient fault mass,
        duration) — lexicographically — smaller."""
        return (
            self.nodes + self.byzantine,
            len(self.nemesis) + len(self.churn)
            + (1 if self.flood else 0) + self.byzantine,
            round(self.drop + self.duplicate + self.corrupt
                  + self.delay_max_s, 6),
            round(self.duration_s, 6),
        )

    def validate(self) -> None:
        if self.nodes < 1:
            raise ValueError("need at least one honest node")
        if self.byzantine and self.nodes + self.byzantine < 4:
            raise ValueError(
                "byzantine scenarios need >= 4 validators (f >= 1)"
            )
        for step in self.nemesis:
            if "at" not in step or "op" not in step:
                raise ValueError(f"malformed nemesis step: {step}")
        for c in self.churn:
            if c.get("action") not in ("down", "up"):
                raise ValueError(f"malformed churn entry: {c}")
            if not 0 <= c.get("node", -1) < self.nodes + self.byzantine:
                raise ValueError(f"churn node out of range: {c}")


@dataclass
class ScenarioResult:
    spec_digest: str
    violations: List[dict]
    commit_digests: Dict[str, str]
    event_log_digest: str
    telemetry_digest: str
    events_run: int
    commits: List[int]  # last block index per honest node
    committed_txs: int  # node 0's committed tx count
    accepted_txs: int
    virtual_s: float
    wall_s: float
    liveness_ok: bool
    heal_base: int
    stats: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return asdict(self)

    def determinism_view(self) -> dict:
        """The byte-comparable subset: everything except wall time."""
        d = self.to_dict()
        d.pop("wall_s", None)
        return d


def _partition_groups(spec: ScenarioSpec, cut: int) -> List[List[str]]:
    """Addresses split into [0..cut) | [cut..n) — helper for generators."""
    n = spec.nodes + spec.byzantine
    return [[sim_addr(i) for i in range(cut)],
            [sim_addr(i) for i in range(cut, n)]]


def run_scenario(spec: ScenarioSpec) -> ScenarioResult:
    """Execute one spec under virtual time and evaluate the invariants."""
    spec.validate()
    wall0 = time.perf_counter()
    # The signing flip is process-wide state: restore it even when cluster
    # construction raises (bad spec knobs) or shutdown() itself fails —
    # a leaked True would silently put every later signature in this
    # process on the RFC 6979 path.
    prev_sig = set_deterministic_signing(True)
    cluster = None
    try:
        sch = SimScheduler(spec.seed)
        cluster = SimCluster(
            sch,
            spec.nodes,
            spec.byzantine,
            attack=spec.attack,
            split=spec.split,
            heartbeat_s=spec.heartbeat_s,
            faults=LinkFaults(
                drop=spec.drop,
                duplicate=spec.duplicate,
                corrupt=spec.corrupt,
                delay_min_s=spec.delay_min_s,
                delay_max_s=spec.delay_max_s,
            ),
            sync_limit=spec.sync_limit,
            mempool_max_txs=spec.mempool_max_txs,
        )
        cluster.start()
        txrng = sch.rng("txmix")

        # background transaction mix over the fault window
        if spec.tx_rate > 0:
            interval = 1.0 / spec.tx_rate
            t = interval
            while t < spec.duration_s:
                sch.at(t, lambda: cluster.submit_auto(txrng), "tx")
                t += interval

        # nemesis schedule as virtual-time events
        nemesis_fired: List[str] = []
        for step in spec.nemesis:
            op = step["op"]
            kwargs = step.get("kwargs", {})
            if not callable(getattr(cluster.controller, op, None)):
                raise ValueError(f"unknown nemesis op: {op!r}")

            def fire(op=op, kwargs=kwargs) -> None:
                getattr(cluster.controller, op)(**kwargs)
                nemesis_fired.append(op)

            sch.at(step["at"], fire, f"nemesis|{op}")

        # crash churn
        for c in spec.churn:
            fn = (cluster.set_node_down if c["action"] == "down"
                  else cluster.set_node_up)
            sch.at(
                c["at"],
                lambda fn=fn, i=c["node"]: fn(i),
                f"churn|{c['action']}|n{c['node']}",
            )

        # mempool flood burst
        if spec.flood:
            fl = dict(spec.flood)

            def do_flood(fl=fl) -> None:
                node = fl.get("node", 0) % spec.nodes
                for k in range(int(fl["count"])):
                    cluster.submit(node, f"flood tx {k}".encode())

            sch.at(fl["at"], do_flood, "flood")

        # phase 1: the fault window
        sch.run_until(spec.duration_s)

        # phase 2: heal everything, then drive until liveness (bounded)
        cluster.heal()
        heal_base = max(cluster.honest_last_blocks())
        liveness_ok = False
        for _ in range(spec.settle_rounds):
            for k in range(3):
                sch.after(
                    0.01 * (k + 1),
                    lambda: cluster.submit_auto(txrng),
                    "tx|settle",
                )
            sch.run_for(spec.settle_s)
            if min(cluster.honest_last_blocks()) >= heal_base + 1:
                liveness_ok = True
                break

        # phase 3: convergence drain — no new txs; keep ticking until
        # every accepted tx committed on its accepting node, mempools
        # drained, and all honest chains level. Bounded: a cluster that
        # cannot drain in the budget is a bounded/exactly-once violation,
        # not an excuse to run forever.
        committed_sets: List[set] = []
        for attempt in range(9):
            lbs = cluster.honest_last_blocks()
            committed_sets = [set(cluster.committed_txs(i))
                              for i in range(spec.nodes)]
            undrained = any(
                payload not in committed_sets[acceptor]
                for payload, acceptor in cluster.accepted.items()
            ) or any(
                n.core.mempool.pending_count > 0 for n in cluster.nodes
            )
            # the final pass only refreshes committed_sets (handed to
            # _evaluate below so it never rebuilds them) — no extra tick
            if (min(lbs) == max(lbs) and not undrained) or attempt == 8:
                break
            sch.run_for(1.0)

        violations = _evaluate(spec, cluster, liveness_ok, heal_base,
                               nemesis_fired, committed_sets)
        tele = hashlib.sha256(
            json.dumps(
                [cluster.nodes[i].telemetry.registry.snapshot()
                 for i in range(spec.nodes)],
                sort_keys=True, separators=(",", ":"), default=str,
            ).encode()
        ).hexdigest()
        stats: Dict[str, object] = dict(cluster.controller.stats())
        stats["sim_requests"] = cluster.network.requests
        sentry_stats = [n.core.sentry.stats() for n in cluster.nodes]
        stats["sentry_quarantined"] = [
            s["sentry_quarantined_peers"] for s in sentry_stats
        ]
        stats["sentry_proofs"] = [
            s["sentry_proofs"] for s in sentry_stats
        ]
        if cluster.byzantine:
            stats["byz"] = [b.stats() for b in cluster.byzantine]
        return ScenarioResult(
            spec_digest=spec.digest(),
            violations=violations,
            commit_digests=cluster.commit_digests(),
            event_log_digest=sch.event_log_digest(),
            telemetry_digest=tele,
            events_run=sch.events_run,
            commits=cluster.honest_last_blocks(),
            committed_txs=len(cluster.committed_txs(0)),
            accepted_txs=len(cluster.accepted),
            virtual_s=round(sch.now, 6),
            wall_s=round(time.perf_counter() - wall0, 3),
            liveness_ok=liveness_ok,
            heal_base=heal_base,
            stats=stats,
        )
    finally:
        try:
            if cluster is not None:
                cluster.shutdown()
        finally:
            set_deterministic_signing(prev_sig)


def _evaluate(
    spec: ScenarioSpec,
    cluster: SimCluster,
    liveness_ok: bool,
    heal_base: int,
    nemesis_fired: List[str],
    committed_sets: List[set],
) -> List[dict]:
    violations: List[dict] = []
    lbs = cluster.honest_last_blocks()

    # no_fork: the honest common prefix must be byte-identical
    common = min(lbs)
    if common >= 0:
        ref_node = cluster.nodes[0]
        for bi in range(common + 1):
            ref = ref_node.get_block(bi).body.hash()
            for i in range(1, spec.nodes):
                if cluster.nodes[i].get_block(bi).body.hash() != ref:
                    violations.append({
                        "invariant": "no_fork",
                        "detail": f"block {bi} differs on node{i}",
                    })
                    break
            else:
                continue
            break

    # liveness: new commits on every honest node after heal
    if not liveness_ok:
        violations.append({
            "invariant": "liveness",
            "detail": f"post-heal blocks {lbs} (heal base {heal_base})",
        })

    # bounded queues
    for i in range(spec.nodes):
        pending = cluster.nodes[i].core.mempool.pending_count
        if pending > spec.mempool_max_txs:
            violations.append({
                "invariant": "bounded_queues",
                "detail": f"node{i} mempool pending {pending} "
                          f"> cap {spec.mempool_max_txs}",
            })
        undet = len(cluster.nodes[i].core.get_undetermined_events())
        if undet > spec.max_undetermined:
            violations.append({
                "invariant": "bounded_queues",
                "detail": f"node{i} undetermined events {undet} "
                          f"> {spec.max_undetermined}",
            })

    # exactly-once commit: no duplicates anywhere; every accepted tx
    # lands on its accepting node's chain
    for i in range(spec.nodes):
        committed = cluster.committed_txs(i)
        seen = set()
        for tx in committed:
            if tx in seen:
                violations.append({
                    "invariant": "exactly_once",
                    "detail": f"node{i} committed {tx!r} twice",
                })
                break
            seen.add(tx)
    lost = 0
    for payload, acceptor in cluster.accepted.items():
        if payload not in committed_sets[acceptor]:
            lost += 1
    if lost:
        violations.append({
            "invariant": "exactly_once",
            "detail": f"{lost}/{len(cluster.accepted)} accepted txs "
                      "never committed on their accepting node",
        })

    # the deliberate failure used to exercise shrinking end-to-end
    if spec.inject_failure and nemesis_fired:
        violations.append({
            "invariant": "injected_failure",
            "detail": f"nemesis ops fired: {sorted(set(nemesis_fired))}",
        })
    return violations
