"""Cluster healthview: every node's /metrics + /stats + /suspects
merged into one "is the cluster healthy and where is it hurting"
snapshot.

Usage (live cluster — each node's service address):

    python -m babble_tpu_torch.obs.healthview --nodes 127.0.0.1:8000,127.0.0.1:8001
    python -m babble_tpu_torch.obs.healthview --nodes ... --window 5 [--json]
    python -m babble_tpu_torch.obs.healthview --from-json dump.json

The live mode scrapes every endpoint twice, ``--window`` seconds
apart, and derives per node:

- **progress**: last consensus round / block index plus their advance
  rates over the window (a node with zero advance while the cluster
  moves is stalled, whatever its counters say);
- **lag**: round delta vs the cluster max round — the "peer lag
  matrix" collapsed to the number that matters per node;
- **queue depths**: submit queue, inbound-sync pipeline occupancy and
  its bounded insert queue (``gossip_pipeline_queue_depth``), mempool
  pending — live backpressure at a glance;
- **quarantine state**: the sentry's view (count + who, from
  ``/suspects``);
- **SLO**: commit-latency p50 vs the 500 ms north-star target, scored
  two ways — cumulative (the histogram since boot) and **windowed burn
  rate**: the share of commits inside the scrape window that exceeded
  500 ms divided by the 50% error budget the p50 target implies (burn
  > 1.0 means the window is eating budget faster than the SLO allows).

``--from-json`` consumes saved exports so deterministic-sim runs and
bench harnesses merge through the identical code path: either a list
of per-node entries ``{"node":…, "moniker":…, "stats": {…typed stats
snapshot…}}`` (single sample — rates/burn unavailable) or
``{"window_s": W, "samples": [[entry…], [entry…]]}`` for two-sample
exports with rates.

Output: a terminal table plus (``--json``) one machine-readable object
(the shape ``demo/bombard.py`` prints at exit and ``make healthsmoke``
asserts on).
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

SLO_COMMIT_P50_S = 0.5  # the north-star target (ROADMAP)
DEFAULT_WINDOW_S = 5.0
DEFAULT_MAX_LAG = 3  # rounds behind cluster max before a node is lagging


# -- Prometheus text parsing -------------------------------------------------


def parse_prom(text: str) -> Dict[str, float]:
    """{'name{labels}': value} for every sample line; malformed lines
    are skipped (a scrape mid-write must not kill the whole view)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out


def prom_histogram(samples: Dict[str, float],
                   name: str) -> Optional[Dict[str, object]]:
    """Cumulative buckets / sum / count of one (unlabeled) histogram."""
    buckets: List[Tuple[float, float]] = []
    for key, v in samples.items():
        if key.startswith(f'{name}_bucket{{le="'):
            le = key[len(f'{name}_bucket{{le="'):-2]
            buckets.append(
                (float("inf") if le == "+Inf" else float(le), v)
            )
    if not buckets:
        return None
    buckets.sort()
    return {
        "buckets": buckets,
        "sum": samples.get(f"{name}_sum", 0.0),
        "count": samples.get(f"{name}_count", 0.0),
    }


def hist_quantile(hist: Dict[str, object], q: float) -> Optional[float]:
    buckets = hist["buckets"]
    total = hist["count"]
    if not total:
        return None
    target = q * total
    lo = 0.0
    prev = 0.0
    for le, cum in buckets:
        if cum >= target:
            if le == float("inf"):
                return lo
            frac = (target - prev) / (cum - prev) if cum > prev else 1.0
            return lo + frac * (le - lo)
        lo = le if le != float("inf") else lo
        prev = cum
    return lo


def _share_over(hist_after: Dict[str, object],
                hist_before: Optional[Dict[str, object]],
                threshold: float) -> Tuple[Optional[float], float]:
    """(share of observations above ``threshold``, observation count)
    for the delta window between two cumulative histograms (or since
    boot when ``hist_before`` is None)."""

    def under(h):
        best = 0.0
        for le, cum in h["buckets"]:
            if le <= threshold:
                best = cum
            else:
                break
        return best

    count_b = hist_before["count"] if hist_before else 0.0
    under_b = under(hist_before) if hist_before else 0.0
    n = hist_after["count"] - count_b
    if n <= 0:
        return None, 0.0
    over = n - (under(hist_after) - under_b)
    return max(0.0, over) / n, n


# -- scraping ----------------------------------------------------------------


def _get_json(ep: str, path: str, timeout: float) -> Optional[dict]:
    try:
        with urllib.request.urlopen(
            f"http://{ep}{path}", timeout=timeout
        ) as r:
            return json.loads(r.read().decode())
    except Exception:
        return None


def scrape_node(ep: str, timeout: float = 5.0) -> Optional[dict]:
    """One node's raw health sample over HTTP; None when the node is
    unreachable (the merge reports it as down rather than crashing)."""
    try:
        with urllib.request.urlopen(
            f"http://{ep}/metrics", timeout=timeout
        ) as r:
            metrics = parse_prom(r.read().decode())
    except Exception:
        return None
    stats = _get_json(ep, "/stats", timeout) or {}
    suspects = _get_json(ep, "/suspects", timeout) or {}
    return {
        "endpoint": ep,
        "ts": time.time(),
        "metrics": metrics,
        "clat": prom_histogram(metrics, "commit_latency_seconds"),
        "stats": stats,
        "suspects": suspects,
    }


def _metric(sample: dict, name: str, default: float = 0.0) -> float:
    return sample["metrics"].get(name, default)


def sample_from_stats(entry: dict) -> dict:
    """Normalize one saved-export entry (typed stats snapshot, the
    ``get_stats_snapshot()`` shape sim harnesses dump) into the scrape
    sample shape. No histogram buckets — the windowed burn rate is
    unavailable, the stats percentiles stand in for cumulative SLO."""
    stats = entry.get("stats", {})

    def num(key, default=0.0):
        v = stats.get(key)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    metrics = {
        "node_last_consensus_round": num("last_consensus_round", -1.0),
        "node_last_block_index": num("last_block_index", -1.0),
        "submit_queue_depth": 0.0,
        "gossip_inflight_syncs": num("gossip_inflight_syncs"),
        "gossip_pipeline_queue_depth": num("gossip_pipeline_queue_depth"),
        "mempool_pending": num("mempool_pending_count",
                               num("transaction_pool")),
        "sentry_quarantined_peers": num("sentry_quarantined_peers"),
        "client_subscribers": num("client_subscribers"),
        "client_shed_subscribers_total": num("client_shed_subscribers"),
        "client_proofs_served_total": num("client_proofs_served"),
        # lifecycle tier (docs/lifecycle.md): retained store footprint
        "lifecycle_events_retained": num("lifecycle_events_retained"),
        "lifecycle_rounds_retained": num("lifecycle_rounds_retained"),
        "lifecycle_store_bytes": num("lifecycle_store_bytes"),
        "lifecycle_prune_floor_round": num("lifecycle_prune_floor", -1.0),
        "lifecycle_prune_lag_rounds": num("lifecycle_prune_lag_rounds"),
    }
    clat_p50_ms = stats.get("commit_latency_p50_ms")
    return {
        "endpoint": entry.get("endpoint"),
        "node": entry.get("node", stats.get("id")),
        "moniker": entry.get("moniker", stats.get("moniker")),
        "ts": entry.get("ts", 0.0),
        "metrics": metrics,
        "clat": None,
        "clat_p50_s": (
            None if clat_p50_ms is None else float(clat_p50_ms) / 1e3
        ),
        "clat_count": num("commit_latency_samples"),
        "stats": stats,
        "suspects": {},
    }


# -- the merge ---------------------------------------------------------------


def merge(samples0: List[Optional[dict]], samples1: List[Optional[dict]],
          window_s: Optional[float],
          max_lag: int = DEFAULT_MAX_LAG) -> dict:
    """Two rounds of per-node samples → the cluster health snapshot.
    ``samples0`` may be empty/None-padded (single-sample exports):
    rates and burn become None, liveness falls back to cumulative
    signals."""
    nodes = []
    rounds = []
    for i, s1 in enumerate(samples1):
        if s1 is None:
            nodes.append({"index": i, "down": True})
            continue
        s0 = samples0[i] if i < len(samples0) else None
        rnd = _metric(s1, "node_last_consensus_round", -1.0)
        blk = _metric(s1, "node_last_block_index", -1.0)
        rounds.append(rnd)
        round_rate = block_rate = None
        if s0 is not None and window_s:
            round_rate = (
                rnd - _metric(s0, "node_last_consensus_round", -1.0)
            ) / window_s
            block_rate = (
                blk - _metric(s0, "node_last_block_index", -1.0)
            ) / window_s
        # SLO: cumulative p50 + the windowed burn rate when buckets
        # (live scrape) are available, stats percentiles otherwise.
        p50 = burn = None
        window_n = 0.0
        if s1.get("clat") is not None:
            p50 = hist_quantile(s1["clat"], 0.5)
            share, window_n = _share_over(
                s1["clat"], s0.get("clat") if s0 else None,
                SLO_COMMIT_P50_S,
            )
            if share is not None:
                # p50 < target ⇔ at most 50% of commits over target:
                # the error budget is 0.5, burn = share / budget.
                burn = share / 0.5
        elif s1.get("clat_p50_s") is not None:
            p50 = s1["clat_p50_s"]
        stats = s1.get("stats", {})
        suspects = s1.get("suspects") or {}
        quarantined = suspects.get("quarantined") or []
        nodes.append({
            "index": i,
            "endpoint": s1.get("endpoint"),
            "node": s1.get("node", stats.get("id")),
            "moniker": s1.get("moniker", stats.get("moniker")),
            "state": stats.get("state"),
            "down": False,
            "round": rnd,
            "block": blk,
            "round_rate_per_s": (
                None if round_rate is None else round(round_rate, 3)
            ),
            "block_rate_per_s": (
                None if block_rate is None else round(block_rate, 3)
            ),
            "queues": {
                "submit": _metric(s1, "submit_queue_depth"),
                "pipeline_inflight": _metric(s1, "gossip_inflight_syncs"),
                "pipeline_queue": _metric(
                    s1, "gossip_pipeline_queue_depth"
                ),
                "mempool_pending": _metric(s1, "mempool_pending"),
            },
            # light-client read tier (docs/clients.md): live
            # subscription fan-out + slow-consumer shedding per node
            "subscribers": int(_metric(s1, "client_subscribers")),
            "shed_subscribers": int(
                _metric(s1, "client_shed_subscribers_total")
            ),
            "proofs_served": int(
                _metric(s1, "client_proofs_served_total")
            ),
            # lifecycle tier (docs/lifecycle.md): what each node still
            # holds after checkpoint-prune compaction — a node whose
            # retained set grows while its peers plateau has pruning
            # off or stalled (watch prune_lag_rounds climb).
            "store": {
                "events_retained": int(
                    _metric(s1, "lifecycle_events_retained")
                ),
                "rounds_retained": int(
                    _metric(s1, "lifecycle_rounds_retained")
                ),
                "store_bytes": int(_metric(s1, "lifecycle_store_bytes")),
                "prune_floor": int(
                    _metric(s1, "lifecycle_prune_floor_round", -1.0)
                ),
                "prune_lag_rounds": int(
                    _metric(s1, "lifecycle_prune_lag_rounds")
                ),
            },
            "quarantined_peers": int(
                _metric(s1, "sentry_quarantined_peers")
            ),
            "quarantined": quarantined,
            "commit_p50_ms": (
                None if p50 is None else round(1e3 * p50, 1)
            ),
            "slo_burn_rate": None if burn is None else round(burn, 3),
            "slo_window_commits": int(window_n),
        })

    max_round = max(rounds) if rounds else -1.0
    worst_lag = None
    for n in nodes:
        if n.get("down"):
            continue
        n["lag_rounds"] = int(max_round - n["round"])
        if worst_lag is None or n["lag_rounds"] > worst_lag["lag_rounds"]:
            worst_lag = n
        stalled = (
            n["round_rate_per_s"] is not None
            and n["round_rate_per_s"] <= 0
            and n["lag_rounds"] > 0
        )
        n["healthy"] = (
            not stalled
            and n["lag_rounds"] <= max_lag
            and n["quarantined_peers"] == 0
        )

    up = [n for n in nodes if not n.get("down")]
    p50s = [n["commit_p50_ms"] for n in up if n["commit_p50_ms"] is not None]
    cluster_p50 = max(p50s) if p50s else None  # worst node carries the SLO
    slo_ok = cluster_p50 is not None and cluster_p50 < 1e3 * SLO_COMMIT_P50_S
    return {
        "format": "babble-healthview/1",
        "ts": round(time.time(), 3),
        "window_s": window_s,
        "nodes": nodes,
        "cluster": {
            "n_nodes": len(nodes),
            "n_up": len(up),
            "n_healthy": sum(1 for n in up if n.get("healthy")),
            "max_round": max_round,
            "worst_lag_node": (
                None if worst_lag is None else {
                    "moniker": worst_lag.get("moniker"),
                    "endpoint": worst_lag.get("endpoint"),
                    "lag_rounds": worst_lag["lag_rounds"],
                }
            ),
            "commit_p50_ms_worst": cluster_p50,
            "slo_target_ms": 1e3 * SLO_COMMIT_P50_S,
            "slo_verdict": (
                "no-data" if cluster_p50 is None
                else ("ok" if slo_ok else "breach")
            ),
            "slo_burn_rate_max": max(
                (n["slo_burn_rate"] for n in up
                 if n["slo_burn_rate"] is not None),
                default=None,
            ),
            "all_healthy": bool(up) and all(
                n.get("healthy") for n in up
            ) and len(up) == len(nodes),
        },
    }


def _scrape_all(endpoints: List[str],
                timeout: float) -> List[Optional[dict]]:
    """One scrape round, all endpoints CONCURRENTLY — sequential
    scrapes of a fast cluster would read node N rounds later than node
    0 and fabricate lag."""
    import threading

    out: List[Optional[dict]] = [None] * len(endpoints)

    def one(i: int, ep: str) -> None:
        out[i] = scrape_node(ep, timeout)

    threads = [
        threading.Thread(target=one, args=(i, ep), daemon=True)
        for i, ep in enumerate(endpoints)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 1.0)
    return out


def collect(endpoints: List[str], window_s: float = DEFAULT_WINDOW_S,
            max_lag: int = DEFAULT_MAX_LAG,
            timeout: float = 5.0) -> dict:
    """Live two-sample scrape + merge over HTTP."""
    s0 = _scrape_all(endpoints, timeout)
    if window_s > 0:
        time.sleep(window_s)
    s1 = _scrape_all(endpoints, timeout)
    return merge(s0, s1, window_s or None, max_lag)


def from_export(payload, max_lag: int = DEFAULT_MAX_LAG) -> dict:
    """Saved-export merge (sim/bench JSON; see module docstring)."""
    if isinstance(payload, dict) and "samples" in payload:
        sample_sets = payload["samples"]
        window_s = payload.get("window_s")
        if len(sample_sets) == 1:
            s0: List[Optional[dict]] = []
            s1 = [sample_from_stats(e) for e in sample_sets[0]]
        else:
            s0 = [sample_from_stats(e) for e in sample_sets[-2]]
            s1 = [sample_from_stats(e) for e in sample_sets[-1]]
        return merge(s0, s1, window_s, max_lag)
    if isinstance(payload, list):
        return merge([], [sample_from_stats(e) for e in payload],
                     None, max_lag)
    raise ValueError(
        "export must be a list of node entries or "
        "{'window_s':…, 'samples': [[…], […]]}"
    )


# -- rendering ---------------------------------------------------------------


def render(view: dict) -> str:
    c = view["cluster"]
    lines = [
        f"cluster: {c['n_up']}/{c['n_nodes']} up, "
        f"{c['n_healthy']} healthy; max round {c['max_round']:.0f}; "
        f"SLO commit p50 {c['commit_p50_ms_worst']}ms vs "
        f"{c['slo_target_ms']:.0f}ms → {c['slo_verdict'].upper()}"
        + (
            f" (burn {c['slo_burn_rate_max']})"
            if c.get("slo_burn_rate_max") is not None else ""
        ),
        f"{'node':<10} {'state':<10} {'round':>7} {'lag':>4} "
        f"{'rnd/s':>7} {'blk/s':>7} {'p50ms':>8} {'burn':>6} "
        f"{'queues s/p/q/m':>16} {'subs':>5} {'shed':>4} "
        f"{'ev':>6} {'rnds':>5} {'storKB':>7} {'plag':>5} {'quar':>4}"
        "  health",
    ]
    for n in view["nodes"]:
        if n.get("down"):
            lines.append(f"{('#' + str(n['index'])):<10} DOWN")
            continue
        q = n["queues"]
        fmt_rate = (
            lambda v: "-" if v is None else f"{v:.2f}"
        )
        lines.append(
            f"{str(n.get('moniker') or n.get('node') or n['index']):<10} "
            f"{str(n.get('state') or '?'):<10} "
            f"{n['round']:>7.0f} {n['lag_rounds']:>4} "
            f"{fmt_rate(n['round_rate_per_s']):>7} "
            f"{fmt_rate(n['block_rate_per_s']):>7} "
            f"{('-' if n['commit_p50_ms'] is None else n['commit_p50_ms']):>8} "
            f"{('-' if n['slo_burn_rate'] is None else n['slo_burn_rate']):>6} "
            f"{q['submit']:.0f}/{q['pipeline_inflight']:.0f}"
            f"/{q['pipeline_queue']:.0f}/{q['mempool_pending']:>.0f}"
            f"{'':>4}{n.get('subscribers', 0):>5} "
            f"{n.get('shed_subscribers', 0):>4} "
            f"{n.get('store', {}).get('events_retained', 0):>6} "
            f"{n.get('store', {}).get('rounds_retained', 0):>5} "
            f"{n.get('store', {}).get('store_bytes', 0) // 1024:>7} "
            f"{n.get('store', {}).get('prune_lag_rounds', 0):>5} "
            f"{n['quarantined_peers']:>4}  "
            + ("ok" if n.get("healthy") else "UNHEALTHY")
        )
    return "\n".join(lines)


def summary_line(view: dict) -> str:
    """The one-liner bombard.py prints at exit."""
    c = view["cluster"]
    wl = c.get("worst_lag_node") or {}
    return (
        f"healthview: {c['n_healthy']}/{c['n_up']} healthy "
        f"(of {c['n_nodes']}), SLO {c['slo_verdict']} "
        f"(p50 {c['commit_p50_ms_worst']}ms vs {c['slo_target_ms']:.0f}ms"
        + (
            f", burn {c['slo_burn_rate_max']}"
            if c.get("slo_burn_rate_max") is not None else ""
        )
        + f"), worst lag {wl.get('moniker')}={wl.get('lag_rounds')} round(s)"
    )


# -- CLI ---------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.obs.healthview",
        description="merge every node's /metrics + /stats + /suspects "
        "into one cluster health snapshot",
    )
    p.add_argument("--nodes", default="",
                   help="comma-separated service host:port list")
    p.add_argument("--from-json", dest="from_json", default="",
                   help="merge a saved export instead of scraping")
    p.add_argument("--window", type=float, default=DEFAULT_WINDOW_S,
                   help="seconds between the two scrape rounds (rates + "
                   "SLO burn window)")
    p.add_argument("--max-lag", type=int, default=DEFAULT_MAX_LAG,
                   help="rounds behind cluster max before unhealthy")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable snapshot")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    if args.from_json:
        with open(args.from_json, encoding="utf-8") as f:
            view = from_export(json.load(f), args.max_lag)
    elif args.nodes:
        eps = [e.strip() for e in args.nodes.split(",") if e.strip()]
        view = collect(eps, args.window, args.max_lag)
    else:
        p.error("one of --nodes or --from-json is required")
        return 2

    if args.as_json:
        print(json.dumps(view, separators=(",", ":")))
    else:
        print(render(view))
    return 0 if view["cluster"]["n_up"] == view["cluster"]["n_nodes"] else 1


if __name__ == "__main__":
    sys.exit(main())
