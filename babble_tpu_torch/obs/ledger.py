"""Bench-history ledger: the repo's memory of its own performance.

Every bench run of the port appends ONE schema-versioned record to
``BENCH_HISTORY_TORCH.jsonl`` (one JSON object per line, append-only — the
format Git merges cleanly and ``jq`` streams), a history of its own: the
JAX package's ``BENCH_HISTORY.jsonl`` never gets a port record. A record
carries enough context to make a number comparable later:

- ``git_rev``   — the commit the numbers were measured at;
- ``host``      — a **fingerprint** of the measurement substrate
  (cpu count + model, python, torch and CUDA versions, the card's
  name): the regression gate (``obs/perfgate.py``) only ever compares
  runs with the SAME fingerprint, because "got slower" on a different host is not a
  regression;
- ``run``       — the bench kind (``bench`` / ``smoke`` / ``obs`` /
  ``gossip`` / …): kinds are compared only against themselves;
- ``config``    — the knobs that shaped the run (node counts, windows);
- ``results``   — a flat list of ``{name, value, unit}`` metrics, the
  dotted names produced by flattening the bench's compact summary.

The backfill tool normalizes the pre-ledger ``BENCH_r*.json`` bench
artifacts (schema-less ``{n, cmd, rc, tail, parsed}`` captures, tails
often truncated mid-JSON) into the same schema, best-effort: a full
``parsed`` payload flattens exactly like a live run; a truncated tail
degrades to a whitelist regex scan and the record says so
(``degraded: true``).

Usage::

    python -m babble_tpu_torch.obs.ledger --backfill BENCH_r01.json ...
    python -m babble_tpu_torch.obs.ledger --show [--history PATH]

Env: ``BABBLE_BENCH_LEDGER`` overrides the ledger path; ``0`` disables
appending entirely (tests and one-off runs that must not write history).
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

SCHEMA = "babble-bench/1"
HISTORY_BASENAME = "BENCH_HISTORY_TORCH.jsonl"
# Flattening caps: a record must stay a readable line, not a dump.
MAX_RESULTS = 160
MAX_DEPTH = 4

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_history_path() -> str:
    """Ledger location: env override, else ``BENCH_HISTORY_TORCH.jsonl``
    at the repo root (NOT the cwd — a bench launched from anywhere
    appends to the same history)."""
    env = os.environ.get("BABBLE_BENCH_LEDGER", "")
    if env and env != "0":
        return env
    return os.path.join(_REPO_ROOT, HISTORY_BASENAME)


def ledger_enabled() -> bool:
    return os.environ.get("BABBLE_BENCH_LEDGER", "") != "0"


# -- host fingerprint --------------------------------------------------------


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine() or "unknown"


def _torch_version() -> Optional[str]:
    # importlib.metadata, not `import torch`: a ledger append must not pay
    # (or fail on) a full torch import just to record a version string.
    try:
        from importlib.metadata import version

        return version("torch")
    except Exception:
        return None


def _torch_cuda() -> Optional[str]:
    # torch.version.cuda, read from torch/version.py without importing
    # torch: the fingerprint must not depend on what the caller imported.
    try:
        import importlib.util

        pkg = importlib.util.find_spec("torch").submodule_search_locations
        with open(os.path.join(pkg[0], "version.py"), encoding="utf-8") as f:
            m = re.search(r"^cuda\b[^=\n]*=\s*['\"]([^'\"]+)['\"]",
                          f.read(), re.M)
    except (AttributeError, ImportError, OSError, TypeError, ValueError):
        return None
    return m.group(1) if m else None


def _card() -> Optional[str]:
    # card 0's name as nvidia-smi reports it (torch.cuda.get_device_name
    # gives the same string), with no CUDA context and no torch import.
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def host_info() -> Dict[str, object]:
    """The measurement substrate + its stable fingerprint. The
    fingerprint hashes exactly the fields that make perf numbers
    comparable; hostname is informational only (containers from one
    image are the same substrate under different names)."""
    cpu_count = os.cpu_count() or 0
    cpu_model = _cpu_model()
    py = platform.python_version()
    torchv = _torch_version()
    cuda, card = _torch_cuda(), _card()
    basis = (f"{cpu_count}|{cpu_model}|{py}|{torchv}|{cuda}|{card}|"
             f"{platform.system()}")
    return {
        "fingerprint": hashlib.sha256(basis.encode()).hexdigest()[:12],
        "cpu_count": cpu_count,
        "cpu_model": cpu_model,
        "python": py,
        "torch": torchv,
        "cuda": cuda,
        "card": card,
        "platform": platform.system(),
    }


def git_rev() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10.0, cwd=_REPO_ROOT,
        )
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:
        return None


# -- metric flattening -------------------------------------------------------


def infer_unit(name: str) -> str:
    """Unit from the metric's (dotted) name, by the repo's own naming
    conventions — the summaries already encode units in suffixes."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("_ms") or leaf in ("p50", "p90", "p95", "p99"):
        return "ms"
    # NOT *_rate: shed_rate/burn_rate are fractions, not per-second
    # rates — mislabeling them "/s" would hand the gate a wrong
    # better-direction. Checked before "_s": txs_per_s is a rate.
    if "per_s" in leaf:
        return "/s"
    if leaf.endswith("_s"):
        return "s"
    if (
        leaf.endswith("ratio")
        or leaf.endswith("speedup")
        or leaf in ("vs_baseline", "obs_overhead")
        or leaf.startswith("speedup")
    ):
        return "x"
    return "count"


def flatten_results(fields: Dict[str, object]) -> List[Dict[str, object]]:
    """Numeric leaves of a (possibly nested) summary dict as
    ``{name, value, unit}`` rows, dotted path names, bounded."""
    rows: List[Dict[str, object]] = []

    def walk(prefix: str, obj, depth: int) -> None:
        if len(rows) >= MAX_RESULTS:
            return
        if isinstance(obj, bool):
            return  # flags are context, not metrics
        if isinstance(obj, (int, float)):
            rows.append(
                {"name": prefix, "value": obj, "unit": infer_unit(prefix)}
            )
            return
        if isinstance(obj, dict) and depth < MAX_DEPTH:
            for k, v in obj.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v, depth + 1)

    walk("", fields, 0)
    return rows


# -- records -----------------------------------------------------------------


def make_record(run: str, fields: Dict[str, object],
                config: Optional[Dict[str, object]] = None,
                source: str = "live",
                ts: Optional[float] = None,
                degraded: bool = False) -> Dict[str, object]:
    rec: Dict[str, object] = {
        "schema": SCHEMA,
        "ts": round(time.time() if ts is None else ts, 3),
        "run": run,
        "git_rev": git_rev(),
        "host": host_info(),
        "config": config or {},
        "results": flatten_results(fields),
        "source": source,
    }
    if degraded:
        rec["degraded"] = True
    return rec


def append(record: Dict[str, object],
           path: Optional[str] = None) -> Optional[str]:
    """Append one record; returns the path written, or None when the
    ledger is disabled (``BABBLE_BENCH_LEDGER=0``)."""
    if not ledger_enabled():
        return None
    path = path or default_history_path()
    line = json.dumps(record, separators=(",", ":"), default=str)
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
    return path


def read(path: Optional[str] = None) -> List[Dict[str, object]]:
    """Every parseable record, oldest first. Malformed lines are skipped
    (an append interrupted mid-line must not poison the whole history)."""
    path = path or default_history_path()
    out: List[Dict[str, object]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("schema") == SCHEMA:
                    out.append(rec)
    except OSError:
        return []
    return out


def results_map(record: Dict[str, object]) -> Dict[str, Tuple[float, str]]:
    out: Dict[str, Tuple[float, str]] = {}
    for row in record.get("results", ()):
        try:
            out[str(row["name"])] = (float(row["value"]), str(row.get("unit", "")))
        except (KeyError, TypeError, ValueError):
            continue
    return out


# -- backfill of the pre-ledger BENCH_r*.json artifacts ----------------------

# Whitelist for truncated tails: metric names whose FIRST occurrence in
# the (mid-JSON) text is the top-level bench meaning of that name.
_TAIL_WHITELIST = (
    "committed_txs_per_s_4node",
    "vs_baseline",
    "latency_p50_ms",
    "latency_p95_ms",
    "dag_pipeline_events_per_s",
    "dag_pipeline_ms_per_sweep",
    "native_sigs_per_s",
    "device_sigs_per_s",
    "device_vs_native",
)


def _last_json_line(text: str) -> Optional[dict]:
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def _scan_tail(tail: str) -> Dict[str, float]:
    found: Dict[str, float] = {}
    for name in _TAIL_WHITELIST:
        m = re.search(
            r'"' + re.escape(name) + r'"\s*:\s*(-?\d+(?:\.\d+)?)', tail
        )
        if m:
            found[name] = float(m.group(1))
    return found


def backfill_record(path: str) -> Dict[str, object]:
    """One pre-ledger bench artifact → one ledger record. The host
    block records the CURRENT container (the artifacts come from the
    same CI image lineage and carry no host data of their own); the
    ``source`` field names the artifact so provenance stays explicit."""
    with open(path, encoding="utf-8") as f:
        art = json.load(f)
    base = os.path.basename(path)
    ts = os.path.getmtime(path)
    parsed = art.get("parsed")
    tail = art.get("tail") or ""
    degraded = False
    if isinstance(parsed, dict) and "metric" in parsed:
        fields: Dict[str, object] = {
            str(parsed["metric"]): parsed.get("value"),
            "vs_baseline": parsed.get("vs_baseline"),
        }
        extra = parsed.get("extra")
        if isinstance(extra, dict):
            fields.update(extra)
    else:
        obj = _last_json_line(tail)
        if obj is not None and ("metric" in obj or "bench_summary" in obj):
            fields = dict(obj)
            if "metric" in fields:
                fields[str(fields.pop("metric"))] = fields.pop("value", None)
        else:
            fields = dict(_scan_tail(tail))
            degraded = True  # truncated capture: regex whitelist only
    rec = make_record(
        run="bench", fields=fields,
        config={"cmd": art.get("cmd"), "rc": art.get("rc")},
        source=f"backfill:{base}", ts=ts, degraded=degraded,
    )
    rec["round"] = art.get("n")
    return rec


def backfill(paths: List[str],
             history: Optional[str] = None) -> List[Dict[str, object]]:
    """Normalize artifacts into the ledger, oldest round first,
    skipping artifacts already backfilled (idempotent re-runs)."""
    history = history or default_history_path()
    existing = {
        r.get("source") for r in read(history)
        if str(r.get("source", "")).startswith("backfill:")
    }
    recs = []
    for p in paths:
        rec = backfill_record(p)
        if rec["source"] in existing:
            continue
        recs.append(rec)
    recs.sort(key=lambda r: (r.get("round") or 0, r["ts"]))
    for rec in recs:
        append(rec, history)
    return recs


# -- CLI ---------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.obs.ledger",
        description="bench-history ledger: backfill and inspection",
    )
    p.add_argument("--history", default="", help="ledger path "
                   f"(default: {HISTORY_BASENAME} at the repo root)")
    p.add_argument("--backfill", nargs="+", metavar="ARTIFACT",
                   help="normalize these pre-ledger BENCH_r*.json "
                   "artifacts into the ledger")
    p.add_argument("--show", action="store_true",
                   help="print one summary line per record (the default "
                   "action when --backfill is not given)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    history = args.history or default_history_path()

    if args.backfill is not None:
        recs = backfill(args.backfill, history)
        print(
            f"backfilled {len(recs)} record(s) into {history} "
            f"({len(read(history))} total)"
        )
        return 0

    records = read(history)
    if not records:
        print(f"no records in {history}", file=sys.stderr)
        return 1
    for i, r in enumerate(records):
        n_res = len(r.get("results", ()))
        head = next(
            (
                f"{row['name']}={row['value']}{row['unit']}"
                for row in r.get("results", ())
                if row.get("name") == "committed_txs_per_s_4node"
            ),
            f"{n_res} metrics",
        )
        print(
            f"[{i}] {time.strftime('%Y-%m-%d %H:%M', time.localtime(r['ts']))} "
            f"run={r.get('run')} rev={r.get('git_rev')} "
            f"host={r.get('host', {}).get('fingerprint')} "
            f"src={r.get('source')} {head}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
