"""traceview: merge several nodes' provenance exports into one
cross-node transaction timeline.

Usage (live cluster — point it at each node's service address):

    python -m babble_tpu_torch.obs.traceview --nodes 127.0.0.1:8000,127.0.0.1:8001
    python -m babble_tpu_torch.obs.traceview --nodes ... --txid <sha256 hex>
    python -m babble_tpu_torch.obs.traceview --from-json dump.json [--json]

``--from-json`` takes a file of ``[{"node":…, "moniker":…, "records":
[…]}, …]`` — exactly what ``GET /traces`` returns per node — so sim
harness runs (or saved scrapes) merge identically to live clusters:
dump each node's ``node.get_traces()`` to one JSON list and point the
tool at the file.

The merge joins per-node records by txid and derives the cross-node
view: the origin (the node holding the ``admit`` stamp), hop order
(nodes ranked by their ``first_seen`` time — gossip is epidemic, so hop
N is "the Nth node the transaction reached", not a path through a fixed
topology), per-hop latency attribution (``wire`` from the carried trace
context's send stamp, ``queue`` transport-arrival → handler start,
``insert`` handler start → post-insert, ``consensus`` first-seen →
commit), and commit spread (first/last node commit). Timestamps are
each node's ``Config.clock.time()``; merging hosts with skewed clocks
skews the *cross-node* deltas (per-node attribution is immune).
"""

from __future__ import annotations

import json
import math
import sys
import urllib.error
import urllib.request
from typing import Dict, List, Optional


def fetch_node(endpoint: str, txid: Optional[str] = None,
               limit: int = 256, timeout: float = 5.0) -> Optional[dict]:
    """One node's provenance export over HTTP: ``/trace/<txid>`` (None
    on 404 — the node never saw the tx) or bulk ``/traces``."""
    path = f"/trace/{txid}" if txid else f"/traces?limit={limit}"
    try:
        with urllib.request.urlopen(
            f"http://{endpoint}{path}", timeout=timeout
        ) as r:
            body = json.loads(r.read().decode())
    except urllib.error.HTTPError as err:
        if err.code == 404:
            return None
        raise
    if txid:
        # normalize the single-record shape to the bulk export shape
        return {
            "node": body.get("node"),
            "moniker": body.get("moniker"),
            "records": [body],
        }
    return body


def merge_tx(txid: str, node_exports: List[dict]) -> Optional[dict]:
    """Join one transaction's records across nodes. ``node_exports`` is
    a list of ``/traces``-shaped dicts; returns None when no node holds
    the txid."""
    per_node = []
    for exp in node_exports:
        for rec in exp.get("records", ()):
            if rec.get("txid") == txid:
                per_node.append(
                    {
                        "node": exp.get("node"),
                        "moniker": exp.get("moniker"),
                        **rec,
                    }
                )
    if not per_node:
        return None

    origin = next((r for r in per_node if "admit" in r), None)
    hops = sorted(
        (r for r in per_node if "first_seen" in r),
        key=lambda r: r["first_seen"],
    )
    commits = [r for r in per_node if "commit" in r]
    timeline: List[list] = []
    if origin is not None:
        if "admit" in origin:
            timeline.append([origin["admit"], origin["node"], "admit"])
        if "drain" in origin:
            timeline.append([origin["drain"], origin["node"], "self_event"])
    merged_hops = []
    for i, r in enumerate(hops):
        timeline.append([r["first_seen"], r["node"], f"hop{i + 1}"])
        consensus_s = (
            round(r["commit"] - r["first_seen"], 6)
            if "commit" in r else None
        )
        merged_hops.append(
            {
                "hop": i + 1,
                "node": r["node"],
                "moniker": r.get("moniker"),
                "from": r.get("from"),
                "ctx": r.get("ctx"),
                "first_seen": r["first_seen"],
                "wire_s": r.get("wire_s"),
                "queue_s": r.get("queue_s"),
                "insert_s": r.get("insert_s"),
                "consensus_s": consensus_s,
            }
        )
    for r in commits:
        timeline.append([r["commit"], r["node"], "commit"])
    timeline.sort(key=lambda e: (e[0], str(e[1])))

    out: Dict[str, object] = {
        "txid": txid,
        "origin": None if origin is None else origin["node"],
        "admit": None if origin is None else origin.get("admit"),
        "drain": None if origin is None else origin.get("drain"),
        "hops": merged_hops,
        "nodes_seen": len(per_node),
        "committed_on": len(commits),
        "block": commits[0].get("block") if commits else None,
        "round_received": (
            commits[0].get("round_received") if commits else None
        ),
        "commit_first": (
            min(r["commit"] for r in commits) if commits else None
        ),
        "commit_last": (
            max(r["commit"] for r in commits) if commits else None
        ),
        "timeline": timeline,
    }
    if origin is not None and "admit" in origin and commits:
        out["e2e_s"] = round(out["commit_last"] - origin["admit"], 6)
    out["monotone"] = _monotone(out, per_node)
    return out


def _monotone(merged: dict, per_node: List[dict]) -> bool:
    """Sanity invariant asserted by ``make tracesmoke``: admit ≤ drain ≤
    every remote first-seen, and each node's first-seen ≤ its commit."""
    admit = merged.get("admit")
    drain = merged.get("drain")
    if admit is not None and drain is not None and drain < admit:
        return False
    floor = drain if drain is not None else admit
    for r in per_node:
        fs = r.get("first_seen")
        if fs is not None:
            if floor is not None and fs < floor:
                return False
            if "commit" in r and r["commit"] < fs:
                return False
    return True


def merge_all(node_exports: List[dict]) -> List[dict]:
    """Merge every txid appearing in any export (admit-time order where
    known, then first-seen)."""
    txids = []
    seen = set()
    for exp in node_exports:
        for rec in exp.get("records", ()):
            t = rec.get("txid")
            if t and t not in seen:
                seen.add(t)
                txids.append(t)
    merged = [merge_tx(t, node_exports) for t in txids]
    merged = [m for m in merged if m is not None]
    merged.sort(
        key=lambda m: (
            m["admit"] if m["admit"] is not None
            else (m["hops"][0]["first_seen"] if m["hops"] else 0.0)
        )
    )
    return merged


# -- attribution summary (bombard --trace) ---------------------------------


def _pct(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: ceil(q*n)-1 (int(q*n) would bias small
    samples high — p50 of two values must be the lower one)."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    idx = max(0, math.ceil(q * len(vals)) - 1)
    return vals[min(len(vals) - 1, idx)]


def attribution_summary(merged: List[dict]) -> Dict[str, dict]:
    """p50/p99 per attribution stage over every hop of every merged tx,
    plus the end-to-end and origin-side splits."""
    stages: Dict[str, List[float]] = {
        "wire": [], "queue": [], "insert": [], "consensus": [],
        "mempool_wait": [], "e2e": [],
    }
    for m in merged:
        if m.get("admit") is not None and m.get("drain") is not None:
            stages["mempool_wait"].append(m["drain"] - m["admit"])
        if m.get("e2e_s") is not None:
            stages["e2e"].append(m["e2e_s"])
        for h in m["hops"]:
            for key, field in (
                ("wire", "wire_s"), ("queue", "queue_s"),
                ("insert", "insert_s"), ("consensus", "consensus_s"),
            ):
                if h.get(field) is not None:
                    stages[key].append(h[field])
    return {
        name: {
            "n": len(vals),
            "p50_ms": None if _pct(vals, 0.50) is None
            else round(1e3 * _pct(vals, 0.50), 3),
            "p99_ms": None if _pct(vals, 0.99) is None
            else round(1e3 * _pct(vals, 0.99), 3),
        }
        for name, vals in stages.items()
    }


# -- rendering --------------------------------------------------------------


def render(merged: dict) -> str:
    """Human timeline for one merged transaction."""
    lines = [
        f"tx {merged['txid'][:16]}…  "
        + (
            f"committed block {merged['block']} "
            f"round {merged['round_received']} "
            f"on {merged['committed_on']} node(s)"
            if merged["committed_on"]
            else "NOT committed"
        )
        + ("" if merged["monotone"] else "  [non-monotone stamps]")
    ]
    base = merged["timeline"][0][0] if merged["timeline"] else 0.0
    for t, node, stage in merged["timeline"]:
        lines.append(f"  +{1e3 * (t - base):9.3f} ms  {stage:<11} node {node}")
    for h in merged["hops"]:
        parts = [
            f"{k}={1e3 * h[f]:.3f}ms"
            for k, f in (
                ("wire", "wire_s"), ("queue", "queue_s"),
                ("insert", "insert_s"), ("consensus", "consensus_s"),
            )
            if h.get(f) is not None
        ]
        if parts:
            lines.append(
                f"    hop{h['hop']} (node {h['node']}"
                + (f" ← {h['from']}" if h.get("from") is not None else "")
                + "): " + " ".join(parts)
            )
    if merged.get("e2e_s") is not None:
        lines.append(f"  end-to-end: {1e3 * merged['e2e_s']:.3f} ms")
    return "\n".join(lines)


# -- CLI --------------------------------------------------------------------


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.obs.traceview",
        description="merge per-node /traces exports into cross-node "
        "transaction timelines",
    )
    p.add_argument("--nodes", default="",
                   help="comma-separated service host:port list to scrape")
    p.add_argument("--from-json", dest="from_json", default="",
                   help="read a saved list of /traces exports instead")
    p.add_argument("--txid", default="", help="merge one transaction only")
    p.add_argument("--limit", type=int, default=256,
                   help="records per node for bulk scrapes")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit merged JSON instead of the timeline view")
    args = p.parse_args(argv)

    exports: List[dict] = []
    if args.from_json:
        with open(args.from_json, encoding="utf-8") as f:
            exports = json.load(f)
    elif args.nodes:
        for ep in args.nodes.split(","):
            ep = ep.strip()
            if not ep:
                continue
            try:
                exp = fetch_node(
                    ep, txid=args.txid or None, limit=args.limit
                )
            except Exception as err:  # noqa: BLE001 — report + continue
                print(f"{ep}: scrape failed ({err})", file=sys.stderr)
                continue
            if exp is not None:
                exports.append(exp)
    else:
        p.error("one of --nodes or --from-json is required")

    if args.txid:
        merged = merge_tx(args.txid, exports)
        if merged is None:
            print(f"txid {args.txid} not found on any node", file=sys.stderr)
            return 1
        merged_list = [merged]
    else:
        merged_list = merge_all(exports)

    if args.as_json:
        print(json.dumps(
            {
                "traces": merged_list,
                "attribution": attribution_summary(merged_list),
            },
            indent=1,
        ))
        return 0
    for m in merged_list:
        print(render(m))
        print()
    summary = attribution_summary(merged_list)
    print(f"merged {len(merged_list)} transaction(s); per-hop attribution:")
    for stage, s in summary.items():
        if s["n"]:
            print(
                f"  {stage:<12} n={s['n']:<5} p50={s['p50_ms']}ms "
                f"p99={s['p99_ms']}ms"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
