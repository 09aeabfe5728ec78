"""The port's perf observatory against the JAX package's: the bench
ledger's schema and backfill, the regression gate's noise-aware verdicts
and --inject-regression self-proof (twins of tests/test_perf_observatory.py
on babble_tpu_torch.obs), the gate's verdicts equal to the reference's on
one record list, the ledger's torch/CUDA/card fingerprint and its own
history file, and the sampling profiler's stage map over the port's
offload frames."""

import os
import time

import pytest

from babble_tpu.obs import ledger as ref_ledger
from babble_tpu.obs import perfgate as ref_perfgate
from babble_tpu.obs import profile as ref_prof
from babble_tpu_torch.obs import ledger, perfgate
from babble_tpu_torch.obs import profile as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- ledger ------------------------------------------------------------------


def test_record_schema_and_unit_inference():
    fields = {
        "txs_per_s": 900.0,
        "latency_p50_ms": 210.0,
        "clat": {"p50": 250.0, "n": 400},
        "speedup": 1.4,
        "duration_s": 9.5,
        "ok": True,  # bools are flags, never metrics
    }
    rec = ledger.make_record("smoke", fields, config={"nodes": 4})
    assert rec["schema"] == ledger.SCHEMA == ref_ledger.SCHEMA
    assert rec["host"]["fingerprint"] and rec["host"]["cpu_count"] >= 1
    assert rec["config"] == {"nodes": 4}
    m = ledger.results_map(rec)
    assert m["txs_per_s"] == (900.0, "/s")
    assert m["latency_p50_ms"] == (210.0, "ms")
    assert m["clat.p50"] == (250.0, "ms")  # nested dotted names
    assert m["speedup"] == (1.4, "x")
    assert m["duration_s"] == (9.5, "s")
    assert m["clat.n"] == (400.0, "count")
    assert "ok" not in m
    # the flattening is the reference's, row for row
    assert rec["results"] == ref_ledger.flatten_results(fields)


def test_append_read_roundtrip_and_malformed_line_skip(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    r1 = ledger.make_record("smoke", {"txs_per_s": 100.0})
    r2 = ledger.make_record("smoke", {"txs_per_s": 110.0})
    ledger.append(r1, path)
    with open(path, "a") as f:
        f.write("{truncated garbage\n")  # interrupted append
    ledger.append(r2, path)
    recs = ledger.read(path)
    assert len(recs) == 2
    assert ledger.results_map(recs[1])["txs_per_s"][0] == 110.0
    assert ref_ledger.read(path) == recs


def test_ledger_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("BABBLE_BENCH_LEDGER", "0")
    assert not ledger.ledger_enabled()
    assert ledger.append(ledger.make_record("smoke", {"x_per_s": 1})) is None


def test_backfill_normalizes_real_artifacts(tmp_path):
    """The five pre-ledger BENCH_r*.json bench artifacts, named one by
    one, all land as schema-versioned records: full `parsed` payloads
    flatten like live runs, truncated tails degrade to the whitelist scan
    and say so; the results equal the reference's backfill."""
    arts = sorted(
        os.path.join(ROOT, f) for f in os.listdir(ROOT)
        if f.startswith("BENCH_r0") and f.endswith(".json")
    )
    assert len(arts) >= 5
    path = str(tmp_path / "hist.jsonl")
    recs = ledger.backfill(arts, path)
    assert len(recs) == len(arts)
    by_round = {r["round"]: r for r in recs}
    # r02/r03 carried parsed {metric,value,...}: the headline survives
    m2 = ledger.results_map(by_round[2])
    assert m2["committed_txs_per_s_4node"][0] > 0
    # r04/r05 tails are truncated mid-JSON: degraded, whitelist-only
    assert by_round[5].get("degraded") is True
    # idempotent: a second backfill adds nothing
    assert ledger.backfill(arts, path) == []
    assert len(ledger.read(path)) == len(arts)
    for art, rec in zip(arts, sorted(recs, key=lambda r: r["source"])):
        want = ref_ledger.backfill_record(art)
        assert rec["source"] == want["source"]
        assert rec["results"] == want["results"]
        assert rec.get("degraded") == want.get("degraded")


def test_backfill_cli_takes_explicit_paths_only(tmp_path, capsys):
    """No default glob over the JAX package's artifacts: --backfill with
    no path is a usage error, and with paths it writes only where told."""
    with pytest.raises(SystemExit):
        ledger.main(["--history", str(tmp_path / "h.jsonl"), "--backfill"])
    art = os.path.join(ROOT, "BENCH_r02.json")
    hist = str(tmp_path / "h.jsonl")
    assert ledger.main(["--history", hist, "--backfill", art]) == 0
    assert len(ledger.read(hist)) == 1
    assert ledger.main(["--history", hist]) == 0  # --show
    assert "committed_txs_per_s_4node" in capsys.readouterr().out


def test_history_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("BABBLE_BENCH_LEDGER", raising=False)
    path = ledger.default_history_path()
    assert os.path.basename(path) == "BENCH_HISTORY_TORCH.jsonl"
    assert os.path.dirname(path) == ROOT
    assert path != ref_ledger.default_history_path()
    monkeypatch.setenv("BABBLE_BENCH_LEDGER", "/elsewhere/h.jsonl")
    assert ledger.default_history_path() == "/elsewhere/h.jsonl"


def test_host_info_names_torch_not_jax():
    """The fingerprint takes torch, CUDA and the card in place of jax (the
    card's machine has no jax); without a card both read None here."""
    import torch

    info = ledger.host_info()
    assert "jax" not in info
    assert info["torch"] == torch.__version__
    assert info["cuda"] == torch.version.cuda
    assert info["card"] == (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else None)
    assert len(info["fingerprint"]) == 12
    assert info["fingerprint"] != ref_ledger.host_info()["fingerprint"]
    assert ledger.host_info() == info  # stable within a process


def test_host_info_does_not_depend_on_the_torch_import():
    """Two fresh interpreters, one that imports torch first and one that
    never does, give one fingerprint and one host record, so that a
    backfill and a live bench on one machine gate against each other."""
    import json
    import subprocess
    import sys

    probe = ("import json, sys\n{}"
             "from babble_tpu_torch.obs import ledger\n"
             "print(json.dumps([ledger.host_info(), 'torch' in sys.modules]))")
    out = []
    for pre in ("import torch\n", ""):
        res = subprocess.run([sys.executable, "-c", probe.format(pre)],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120, check=True)
        out.append(json.loads(res.stdout.strip().splitlines()[-1]))
    (with_torch, imported), (without, not_imported) = out
    assert imported and not not_imported
    assert with_torch == without
    assert with_torch == ledger.host_info()


# -- perfgate ----------------------------------------------------------------


def _rec(txs, p50, run="smoke"):
    return ledger.make_record(
        run, {"txs_per_s": txs, "latency_p50_ms": p50}
    )


def test_gate_passes_on_stable_metrics():
    base = [_rec(1000, 200), _rec(1050, 190), _rec(980, 210)]
    v = perfgate.gate(_rec(1010, 205), base)
    assert v["ok"] and not v["regressions"]
    assert v["checked"] == 2


def test_gate_fails_on_corroborated_regression():
    base = [_rec(1000, 200), _rec(1050, 190), _rec(980, 210)]
    v = perfgate.gate(_rec(500, 420), base)  # both metrics blown
    assert not v["ok"]
    assert {r["metric"] for r in v["regressions"]} == {
        "txs_per_s", "latency_p50_ms",
    }


def test_single_soft_regression_is_not_corroborated():
    base = [_rec(1000, 200), _rec(1050, 190), _rec(980, 210)]
    # one metric ~18% worse: outside the 15% band, inside 2x the band
    v = perfgate.gate(_rec(820, 200), base)
    assert v["regressions"] and v["regressions"][0]["severity"] == "soft"
    assert v["ok"]  # requires corroboration
    assert not perfgate.gate(_rec(820, 200), base, strict=True)["ok"]


def test_single_hard_regression_is_corroborated():
    base = [_rec(1000, 200), _rec(1050, 190), _rec(980, 210)]
    v = perfgate.gate(_rec(400, 200), base)  # -60%: beyond 2x band
    assert not v["ok"]
    assert v["regressions"][0]["severity"] == "hard"


def test_noisy_metric_earns_wider_band():
    # history swinging ±40%: MAD widens the band past the default 15%
    base = [_rec(600, 200), _rec(1400, 200), _rec(1000, 200)]
    v = perfgate.gate(_rec(700, 200), base)  # -30% vs median 1000
    assert v["ok"], v


def test_baseline_filters_host_and_kind():
    cur = _rec(1000, 200)
    other_kind = _rec(1, 9999, run="gossip_smoke")
    other_host = _rec(1, 9999)
    other_host["host"] = dict(other_host["host"], fingerprint="ffff")
    base = perfgate.baseline_for(
        [other_kind, other_host, _rec(990, 205), cur], cur, window=5
    )
    assert len(base) == 1


def test_inject_regression_fails_gate_end_to_end(tmp_path):
    """The CLI self-proof: a clean gate run exits 0, the injected
    regression exits nonzero — through main()."""
    path = str(tmp_path / "hist.jsonl")
    for txs, p50 in ((1000, 200), (1010, 195), (990, 205)):
        ledger.append(_rec(txs, p50), path)
    assert perfgate.main(["--history", path]) == 0
    assert perfgate.main(["--history", path, "--inject-regression"]) == 1


def test_gate_refuses_stale_latest_record(tmp_path):
    """A silently failed ledger append must not let the gate re-gate
    old history as today's pass: a latest record older than
    --max-age-s exits 2; 0 disables the guard."""
    path = str(tmp_path / "hist.jsonl")
    old = ledger.make_record(
        "smoke", {"txs_per_s": 100.0}, ts=time.time() - 7200
    )
    ledger.append(old, path)
    assert perfgate.main(["--history", path]) == 2
    assert perfgate.main(["--history", path, "--max-age-s", "0"]) == 0


def test_gate_with_empty_and_baselineless_ledger(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    assert perfgate.main(["--history", path]) == 2  # no records: usage
    ledger.append(_rec(1000, 200), path)
    # a single record has no baseline — pass, the gate arms itself
    assert perfgate.main(["--history", path]) == 0


# the same record lists through both gates: (baseline, current, strict)
GATE_CASES = {
    "stable": ([(1000, 200), (1050, 190), (980, 210)], (1010, 205), False),
    "corroborated": ([(1000, 200), (1050, 190), (980, 210)], (500, 420),
                     False),
    "soft": ([(1000, 200), (1050, 190), (980, 210)], (820, 200), False),
    "soft strict": ([(1000, 200), (1050, 190), (980, 210)], (820, 200),
                    True),
    "hard": ([(1000, 200), (1050, 190), (980, 210)], (400, 200), False),
    "noisy": ([(600, 200), (1400, 200), (1000, 200)], (700, 200), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_verdict_equals_reference(case):
    base, cur, strict = GATE_CASES[case]
    base = [_rec(*b) for b in base]
    cur = _rec(*cur)
    got = perfgate.gate(cur, base, strict=strict)
    assert got == ref_perfgate.gate(cur, base, strict=strict)
    bad = perfgate.inject_regression(cur, 2.0, base)
    assert bad == ref_perfgate.inject_regression(cur, 2.0, base)
    assert not perfgate.gate(bad, base)["ok"]


# -- sampling profiler -------------------------------------------------------

PKG = "/x/babble_tpu_torch"
ACCEL = f"{PKG}/hashgraph/accel.py"
BATCHER = f"{PKG}/hashgraph/sweep_batcher.py"
VOTING = f"{PKG}/ops/voting.py"
FLUSH_CALLERS = [("flush", ACCEL),
                 ("flush_consensus", f"{PKG}/hashgraph/hashgraph.py")]


def test_classify_stage_taxonomy():
    assert prof.classify(
        [("insert_event", f"{PKG}/hashgraph/hashgraph.py"),
         ("_finish_eager_sync", f"{PKG}/node/node.py")]
    ) == "insert"
    assert prof.classify(
        [("acquire", f"{PKG}/common/timed_lock.py"),
         ("commit", f"{PKG}/node/core.py")]
    ) == "lock_wait"
    # idle only counts at the innermost frame
    assert prof.classify([("wait", "/usr/lib/python3.10/threading.py")]) == "idle"
    assert prof.classify(
        [("divide_rounds", f"{PKG}/hashgraph/hashgraph.py"),
         ("wait", "/usr/lib/python3.10/threading.py")]
    ) == "divide_rounds"
    # "commit" means proxy_deliver only in core.py; elsewhere unmatched
    assert prof.classify([("commit", f"{PKG}/node/core.py")]) == (
        "proxy_deliver"
    )
    assert prof.classify([("commit", "/somewhere/else.py")]) == "other"
    assert prof.classify([]) == "other"
    for frames in ([("x", "y.py")],):
        assert prof.classify(frames) == "other"


# (innermost frames, the port's stage): the offload's methods under a
# flush, as the sampler sees them on a node thread, and the sweep
# batcher's thread
OFFLOAD_FRAMES = {
    "snapshot": ([("_snapshot", ACCEL), ("_launch", ACCEL),
                  ("_flush", ACCEL)], "pack"),
    "build": ([("build_voting_window", VOTING), ("_snapshot", ACCEL),
               ("_flush", ACCEL)], "build"),
    "flush": ([("_flush", ACCEL)], "kernel"),
    "launch": ([("_launch", ACCEL), ("_flush", ACCEL)], "kernel"),
    "apply": ([("_apply", ACCEL), ("_flush", ACCEL)], "kernel"),
    "dispatch": ([("_dispatch", ACCEL), ("_enqueue", ACCEL),
                  ("_launch", ACCEL), ("_flush", ACCEL)], "dispatch"),
    "enqueue": ([("_enqueue", ACCEL), ("_launch", ACCEL),
                 ("_flush", ACCEL)], "dispatch"),
    "submit": ([("_submit", ACCEL), ("_launch", ACCEL),
                ("_flush", ACCEL)], "dispatch"),
    "write_back": ([("_write_back", ACCEL), ("_apply", ACCEL),
                    ("_flush", ACCEL)], "apply"),
    "sync sweep": ([("_write_back", ACCEL), ("sweep", ACCEL),
                    ("_flush", ACCEL)], "apply"),
    "batcher dispatch": ([("_dispatch", BATCHER), ("_loop", BATCHER)],
                         "dispatch"),
    "batcher group": ([("_dispatch_group", BATCHER), ("_dispatch", BATCHER),
                       ("_loop", BATCHER)], "dispatch"),
    "batcher mesh group": ([("_dispatch_mesh_group", BATCHER),
                            ("_dispatch", BATCHER)], "dispatch"),
    "launch_batched": ([("launch_batched", VOTING), ("_sweep", BATCHER),
                        ("_dispatch_group", BATCHER)], "dispatch"),
    "batcher loop": ([("_loop", BATCHER)], "other"),
    "no _build": ([("_build", ACCEL)], "other"),
    "_dispatch elsewhere": ([("_dispatch", f"{PKG}/net/atcp.py")], "other"),
}
# the port's methods that the JAX package's TensorConsensus names otherwise
REF_COUNTERPART = {"_submit": "_dispatch_snap", "_enqueue": "_dispatch_snap",
                   "_write_back": "apply_sweep_result"}
# the port files the batcher's thread as dispatch, where the JAX package
# files it as other: the one departure of the map
BATCHER_DEPARTURES = {"batcher dispatch", "batcher group",
                      "batcher mesh group", "launch_batched"}


@pytest.mark.parametrize("case", sorted(OFFLOAD_FRAMES))
def test_classify_offload_frames(case):
    """Each offload frame files under the JAX package's stage for the
    same frame, or for its counterpart there, except the batcher's."""
    frames, stage = OFFLOAD_FRAMES[case]
    frames = frames + FLUSH_CALLERS if frames[-1][1] == ACCEL else frames
    assert prof.classify(frames) == stage
    ref_frames = [(REF_COUNTERPART.get(fn, fn), path) for fn, path in frames]
    want_ref = "other" if case in BATCHER_DEPARTURES else stage
    assert ref_prof.classify(ref_frames) == want_ref
