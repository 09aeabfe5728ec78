"""The port's babblelint (``babble_tpu_torch/analysis/``, ``obs/lint.py``)
against the JAX package's (docs/static_analysis.md).

Tolerance: exact. Everything compared is a violation (path, line, pass,
message) or an edge name.

- Every pass, the allow parser, ``stale-allow`` and ``unknown-pass``: the
  same fixture texts go through both packages' passes and give the same
  violations, the package prefix (and each knob pass's own table path)
  mapped to one placeholder. Each twin keeps the reference test's name
  and its assertions (tests/test_analysis.py).
- The port's own tree: green, ``--self-proof`` fires every pass, the CLI
  exits 1 on a violation, the three commands run without JAX, and the
  static lock graph equals the JAX package's over its tree.
- Knob drift against the port's own table (``analysis/knobs.md``): a
  fabricated row and a missing one are both caught.
- The metrics lint (tests/test_obs.py's three) through the port's shim.
- The runtime lock-order recorder: its unit twins, the sim run that
  observes ``core->mempool``, and the sweep batcher's lock: named
  ``batcher`` when the recorder is armed, still reentrant, and an
  accelerated sim run records ``core->batcher`` with no inversion; every
  edge it observes is in the static set or is one the static pass cannot
  see in the JAX package either (``chip_smoke.LOCK_EDGES_UNSEEN``).
- The clock fixes babblelint forced, pinned across packages (control-timer
  jitter stream, sentry proof digests).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import random
import subprocess
import sys
import threading
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "babble_tpu", "babble_tpu_torch"
DOCS = os.path.join(ROOT, "docs", "observability.md")


def _lint(pkg: str) -> types.SimpleNamespace:
    """Package ``pkg``'s lint modules."""
    names = {
        "core": "analysis.core", "clock": "analysis.clock_pass",
        "locks": "analysis.lock_pass", "knobs": "analysis.knob_pass",
        "metrics": "analysis.metrics_pass", "main": "analysis.__main__",
        "shim": "obs.lint",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _norm(pkg: str, vs) -> list:
    """Violations with the package prefix and the knob table's path mapped
    to placeholders, in a form that compares across packages."""
    table = _lint(pkg).knobs.DOCS_PATH

    def m(text: str) -> str:
        return text.replace(table, "<knobs>").replace(f"{pkg}/", "<pkg>/")

    return [(m(v.path), v.line, v.passname, m(v.message)) for v in vs]


def _both(run):
    """``run(pkg, lint)`` through both packages: equal violations once
    mapped. Returns the port's."""
    got = {pkg: run(pkg, _lint(pkg)) for pkg in (REF, PORT)}
    assert _norm(PORT, got[PORT]) == _norm(REF, got[REF])
    return got[PORT]


# ---------------------------------------------------------------------------
# clock pass


def _clock(rel: str, text: str):
    """``rel`` is the path below the package directory."""
    def run(pkg, lt):
        files = [lt.core.SourceFile.from_text(f"{pkg}/{rel}", text)]
        return lt.core.apply_allows("clock", files,
                                    lt.clock.run(files, "."))
    return _both(run)


def test_clock_flags_bare_time_and_global_random():
    vs = _clock(
        "node/snippet.py",
        "import time\nimport random\n\n"
        "def f():\n"
        "    time.sleep(1)\n"
        "    return time.time() + random.random()\n",
    )
    msgs = " | ".join(v.message for v in vs)
    assert len(vs) == 3
    assert "time.sleep" in msgs and "time.time" in msgs
    assert "random.random" in msgs


def test_clock_flags_aliased_and_from_imports():
    vs = _clock(
        "node/snippet.py",
        "import time as _time\nfrom time import sleep\n\n"
        "def f():\n    sleep(1)\n    return _time.monotonic()\n",
    )
    assert len(vs) == 2


def test_clock_ignores_references_and_seeded_constructors():
    vs = _clock(
        "node/snippet.py",
        "import time\nimport random\n\n"
        "def f(clock=time.monotonic, rng=None):\n"
        "    rng = rng or random.Random(42)\n"
        "    return clock(), rng.random()\n",
    )
    assert vs == []


@pytest.mark.parametrize("rel", [
    "obs/snippet.py", "sim/snippet.py", "ops/snippet.py",
    "common/clock.py", "hashgraph/accel.py", "hashgraph/sweep_batcher.py",
    "net/signal.py", "analysis/snippet.py",
])
def test_clock_module_allowlist_skips_obs(rel):
    """Every module allowed whole in the reference is allowed in the port
    under the port's prefix (the reference's test takes obs/)."""
    vs = _clock(rel, "import time\n\ndef stamp():\n    return time.time()\n")
    assert vs == []


def test_clock_module_allowlist_names_the_port_paths():
    ref = _lint(REF).clock.MODULE_ALLOW
    port = _lint(PORT).clock.MODULE_ALLOW
    assert sorted(port) == sorted(
        PORT + k[len(REF):] for k in ref)
    assert all(k.startswith(f"{PORT}/") for k in port)


def test_clock_allow_honored_same_line_and_line_above():
    vs = _clock(
        "node/snippet.py",
        "import time\n\n"
        "def f():\n"
        "    a = time.time()  # lint: allow(clock: wall stamp on purpose)\n"
        "    # lint: allow(clock: and this one too)\n"
        "    b = time.time()\n"
        "    return a + b\n",
    )
    assert vs == []


def test_stale_allow_is_rejected():
    vs = _clock(
        "node/snippet.py",
        "import os\n\n"
        "# lint: allow(clock: nothing here violates)\n"
        "x = os.getcwd()\n",
    )
    assert len(vs) == 1
    assert "stale allow" in vs[0].message


def test_unknown_pass_in_allow_is_an_error():
    def run(pkg, lt):
        files = [lt.core.SourceFile.from_text(
            f"{pkg}/node/snippet.py",
            "# lint: allow(nonsense: what pass is this)\nx = 1\n")]
        return lt.core.run_passes(names=["clock"], files=files)

    vs = _both(run)
    assert any("unknown pass 'nonsense'" in v.message for v in vs)


def test_allow_parser_equal_across_packages():
    text = ("import time\n"
            "x = 1  # lint: allow(clock: trailing, same line)\n"
            "# lint: allow(locks: stands alone)\n\n\n"
            "y = 2\n"
            "#lint:allow( knobs :  spaced  )\n"
            "# lint: allow(clock: last line, nothing after)\n")
    parsed = {}
    for pkg in (REF, PORT):
        sf = _lint(pkg).core.SourceFile.from_text("p/x.py", text)
        parsed[pkg] = [(a.line, a.passname, a.reason, a.covers)
                       for a in sf.allows]
    assert parsed[PORT] == parsed[REF]
    assert [a[:2] for a in parsed[PORT]] == [
        (2, "clock"), (3, "locks"), (7, "knobs"), (8, "clock")]


# ---------------------------------------------------------------------------
# lock pass


def _locks(text: str, rel: str = "node/snippet.py"):
    def run(pkg, lt):
        files = [lt.core.SourceFile.from_text(f"{pkg}/{rel}", text)]
        return lt.core.apply_allows("locks", files,
                                    lt.locks.run(files, "."))
    return _both(run)


def test_locks_flags_sleep_under_core_lock():
    vs = _locks(
        "import time\n\n"
        "class Node:\n"
        "    def gossip(self):\n"
        "        with self.core_lock:\n"
        "            time.sleep(0.1)\n"
    )
    assert len(vs) == 1
    assert "blocking call under the core lock" in vs[0].message


def test_locks_flags_transitive_blocking_via_self_call():
    vs = _locks(
        "import time\n\n"
        "class Node:\n"
        "    def slow(self):\n"
        "        self.sock.sendall(b'x')\n"
        "    def gossip(self):\n"
        "        with self.core_lock:\n"
        "            self.slow()\n"
    )
    assert any("reaches a blocking primitive" in v.message for v in vs)


def test_locks_rpc_send_only_on_transport_receivers():
    clean = _locks(
        "class Node:\n"
        "    def g(self):\n"
        "        with self.core_lock:\n"
        "            self.core.sync(events)\n"
    )
    assert clean == []
    dirty = _locks(
        "class Node:\n"
        "    def g(self):\n"
        "        with self.core_lock:\n"
        "            self.trans.sync(peer, req)\n"
    )
    assert len(dirty) == 1 and "RPC send" in dirty[0].message


def test_locks_detects_order_cycle():
    def run(pkg, lt):
        files = [
            lt.core.SourceFile.from_text(
                "x/mempool/mempool.py",
                "class Mempool:\n"
                "    def a(self):\n"
                "        with self._lock:\n"
                "            with self.core_lock:\n"
                "                pass\n",
            ),
            lt.core.SourceFile.from_text(
                f"{pkg}/node/snippet.py",
                "class Node:\n"
                "    def b(self):\n"
                "        with self.core_lock:\n"
                "            self.mempool.a()\n",
            ),
        ]
        return lt.locks.run(files, ".")

    vs = _both(run)
    assert any("acquisition-order cycle" in v.message for v in vs), vs


def test_locks_allow_honored():
    vs = _locks(
        "import time\n\n"
        "class Node:\n"
        "    def gossip(self):\n"
        "        with self.core_lock:\n"
        "            time.sleep(0.1)  # lint: allow(locks: measured, bounded, documented)\n"
    )
    assert vs == []


def test_locks_tables_equal_across_packages():
    ref, port = _lint(REF).locks, _lint(PORT).locks
    for name in ("GLOBAL_LOCK_ATTRS", "CLASS_LOCKS", "ATTR_TYPES",
                 "BLOCK_CHECK_LOCKS", "SLEEP_FNS", "SOCKET_FNS", "RPC_FNS",
                 "NATIVE_VERIFY_FNS"):
        assert getattr(port, name) == getattr(ref, name), name


# ---------------------------------------------------------------------------
# knob pass (fixture config/cli/table triple)


def _knob_fixture(tmp_path, config_src: str, cli_src: str,
                  docs_rows: str = ""):
    def run(pkg, lt):
        root = tmp_path / pkg
        table = root / lt.knobs.DOCS_PATH
        table.parent.mkdir(parents=True, exist_ok=True)
        table.write_text(
            "<!-- knob-table-start -->\n| flag | field | meaning |\n"
            "|---|---|---|\n" + docs_rows + "<!-- knob-table-end -->\n"
        )
        files = [
            lt.core.SourceFile.from_text(lt.knobs.CONFIG_PATH, config_src),
            lt.core.SourceFile.from_text(lt.knobs.CLI_PATH, cli_src),
        ]
        return lt.core.apply_allows("knobs", files,
                                    lt.knobs.run(files, str(root)))
    return _both(run)


_GOOD_CLI = """\
_RUN_FLAGS = {
    "heartbeat": ("heartbeat_timeout", float),
}


def build_parser():
    run = sub.add_parser("run")
    run.add_argument("--heartbeat", type=float, default=None)
"""


def test_knobs_green_fixture(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n",
        _GOOD_CLI,
        "| `--heartbeat` | `heartbeat_timeout` | gossip cadence |\n",
    )
    assert vs == []


def test_knobs_catches_orphaned_config_field(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n"
        "    ghost_knob: int = 7\n",
        _GOOD_CLI,
        "| `--heartbeat` | `heartbeat_timeout` | gossip cadence |\n",
    )
    assert len(vs) == 1 and "ghost_knob" in vs[0].message


def test_knobs_allow_marks_runtime_injection_point(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n"
        "    # lint: allow(knobs: runtime injection point)\n"
        "    clock: object = None\n",
        _GOOD_CLI,
        "| `--heartbeat` | `heartbeat_timeout` | gossip cadence |\n",
    )
    assert vs == []


def test_knobs_catches_missing_argparse_dest(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n"
        "    watchdog_interval_s: float = 1.0\n",
        '_RUN_FLAGS = {\n'
        '    "heartbeat": ("heartbeat_timeout", float),\n'
        '    "watchdog_interval": ("watchdog_interval_s", float),\n'
        '}\n\n\n'
        'def build_parser():\n'
        '    run = sub.add_parser("run")\n'
        '    run.add_argument("--heartbeat", type=float, default=None)\n',
        "| `--heartbeat` | `heartbeat_timeout` | gossip cadence |\n"
        "| `watchdog_interval (toml)` | `watchdog_interval_s` | x |\n",
    )
    assert any(
        "no run-subparser add_argument" in v.message for v in vs
    ), vs


def test_knobs_catches_dangling_flag_and_orphan_default(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n"
        "DEFAULT_UNUSED = 3\n\n\n"
        "@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n",
        '_RUN_FLAGS = {\n'
        '    "heartbeat": ("heartbeat_timeout", float),\n'
        '    "dangling": ("no_such_field", int),\n'
        '}\n\n\n'
        'def build_parser():\n'
        '    run = sub.add_parser("run")\n'
        '    run.add_argument("--heartbeat", type=float, default=None)\n'
        '    run.add_argument("--dangling", type=int, default=None)\n',
        "| `--heartbeat` | `heartbeat_timeout` | gossip cadence |\n"
        "| `--dangling` | `no_such_field` | x |\n",
    )
    msgs = " | ".join(v.message for v in vs)
    assert "does not exist" in msgs
    assert "orphaned constant DEFAULT_UNUSED" in msgs


def test_knobs_docs_table_two_way(tmp_path):
    vs = _knob_fixture(
        tmp_path,
        "from dataclasses import dataclass\n\n@dataclass\nclass Config:\n"
        "    heartbeat_timeout: float = 0.01\n",
        _GOOD_CLI,
        "| `--fabricated-flag` | `nope` | not a real knob |\n",
    )
    msgs = " | ".join(v.message for v in vs)
    assert "`--heartbeat` missing from the docs table" in msgs
    assert "documented knob `--fabricated-flag` does not exist" in msgs


def test_knobs_table_missing_is_an_error(tmp_path):
    def run(pkg, lt):
        files = [lt.core.SourceFile.from_text(lt.knobs.CONFIG_PATH,
                                              "class Config:\n    pass\n"),
                 lt.core.SourceFile.from_text(lt.knobs.CLI_PATH, _GOOD_CLI)]
        return lt.knobs.run(files, str(tmp_path / "none"))

    vs = _both(run)
    assert any("knob table source unreadable" in v.message for v in vs)
    assert all(v.path == _lint(PORT).knobs.DOCS_PATH for v in vs
               if "unreadable" in v.message)


def _port_tree_knobs(tmp_path, edit):
    """The knob pass over the port's real config and CLI, against a copy of
    its table that ``edit`` rewrote."""
    lt = _lint(PORT)
    src = os.path.join(ROOT, lt.knobs.DOCS_PATH)
    with open(src, encoding="utf-8") as f:
        text = edit(f.read())
    table = tmp_path / lt.knobs.DOCS_PATH
    table.parent.mkdir(parents=True)
    table.write_text(text)
    files = lt.core.load_tree(ROOT, [lt.knobs.CONFIG_PATH, lt.knobs.CLI_PATH])
    return lt.core.apply_allows("knobs", files,
                                lt.knobs.run(files, str(tmp_path)))


def test_port_knob_table_catches_a_fabricated_row(tmp_path):
    vs = _port_tree_knobs(tmp_path, lambda t: t.replace(
        "<!-- knob-table-end -->",
        "| `--fabricated-flag` | `nope` | not a real knob |\n"
        "<!-- knob-table-end -->"))
    assert [v.message for v in vs] == [
        "documented knob `--fabricated-flag` does not exist in "
        "babble_tpu_torch/cli/main.py"]
    assert vs[0].path == "babble_tpu_torch/analysis/knobs.md"


def test_port_knob_table_catches_a_missing_knob(tmp_path):
    def drop(text):
        rows = [ln for ln in text.splitlines(keepends=True)
                if not ln.startswith("| `--accelerator-device`")]
        assert len(rows) == len(text.splitlines()) - 1
        return "".join(rows)

    vs = _port_tree_knobs(tmp_path, drop)
    assert [v.message for v in vs] == [
        "knob `--accelerator-device` missing from the docs table"]


def test_port_knob_table_differs_from_the_reference_only_where_named():
    """The port's table has the reference's rows, with ``--accelerator``
    and ``--accelerator-mesh`` reworded and ``--accelerator-device``
    added."""
    def rows(path):
        with open(os.path.join(ROOT, path), encoding="utf-8") as f:
            text = f.read()
        body = text.split("<!-- knob-table-start -->", 1)[1]
        body = body.split("<!-- knob-table-end -->", 1)[0]
        return {ln.split("|")[1].strip(): ln for ln in body.splitlines()
                if ln.startswith("| `")}

    ref = rows(_lint(REF).knobs.DOCS_PATH)
    port = rows(_lint(PORT).knobs.DOCS_PATH)
    changed = {"`--accelerator`", "`--accelerator-mesh`"}
    assert set(port) == set(ref) | {"`--accelerator-device`"}
    assert {k for k in ref if port[k] != ref[k]} == changed
    assert "CUDA" in port["`--accelerator`"]
    assert "JAX" not in port["`--accelerator`"]
    assert "CUDA cards" in port["`--accelerator-mesh`"]
    assert "virtual shards" in port["`--accelerator-mesh`"].lower()


# ---------------------------------------------------------------------------
# the port's tree must be green, and the self-proof must have teeth


def test_self_run_tree_is_green():
    vs = _lint(PORT).core.run_passes()
    assert vs == [], "babblelint violations on the tree:\n" + "\n".join(
        v.render() for v in vs
    )


def test_load_tree_walks_the_port_only():
    files = _lint(PORT).core.load_tree()
    assert files and all(f.path.startswith(f"{PORT}/") for f in files)
    assert not any(f.path.startswith(f"{PORT}/analysis/") for f in files)
    assert _lint(PORT).core.repo_root() == ROOT


def test_self_proof_all_passes_fire(capsys):
    assert _lint(PORT).main.self_proof() == 0
    out = capsys.readouterr().out
    for name in ("clock", "locks", "knobs", "metrics", "stale-allow"):
        assert f"self-proof [{name}]: fired" in out


def test_cli_entrypoint_nonzero_on_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "babble_tpu_torch.analysis", "--pass",
         "clock", str(bad)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "bare time.time()" in proc.stderr


def test_lint_commands_exit_zero_without_jax():
    """The three commands the card's machine runs, each in a fresh
    interpreter that never loads JAX or the JAX package."""
    probe = (
        "import runpy, sys\n"
        "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
        "try:\n"
        "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "else:\n"
        "    rc = 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'babble_tpu', 'torch'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc)\n"
    )
    for args in (["babble_tpu_torch.analysis"],
                 ["babble_tpu_torch.analysis", "--self-proof"],
                 ["babble_tpu_torch.obs.lint", "docs/observability.md"]):
        proc = subprocess.run([sys.executable, "-c", probe, *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (args, proc.stderr)
        assert "LOADED []" in proc.stdout, (args, proc.stdout)


def test_obs_lint_shim_still_works():
    shim = _lint(PORT).shim
    assert shim.run(DOCS) == 0
    assert shim.documented_names(
        "<!-- metrics-table-start -->\n| `x_total` | c |\n"
        "<!-- metrics-table-end -->"
    ) == {"x_total"}


def test_static_edges_include_core_mempool():
    lt = _lint(PORT)
    edges = lt.locks.static_edges(lt.core.load_tree())
    assert "core->mempool" in edges
    ref = _lint(REF)
    assert edges == ref.locks.static_edges(ref.core.load_tree())


# ---------------------------------------------------------------------------
# metrics lint (tests/test_obs.py's three, through the port's shim)


def test_metrics_lint_passes_on_shipped_docs():
    assert _lint(PORT).shim.run(DOCS) == 0


def test_metrics_lint_catches_drift(tmp_path):
    from babble_tpu_torch.obs import catalog

    rows = "\n".join(
        f"| `{c.name}` | {c.kind} | | {c.scope} | x |"
        for c in catalog.CATALOG
        if c.name != "commit_latency_seconds"
    )
    doc = tmp_path / "obs.md"
    doc.write_text(
        "<!-- metrics-table-start -->\n"
        f"{rows}\n| `made_up_metric` | counter | | node | x |\n"
        "<!-- metrics-table-end -->\n"
    )
    assert _lint(PORT).shim.run(str(doc)) == 1
    vs = _both(lambda pkg, lt: lt.metrics.check(str(doc)))
    assert [v.message for v in vs] == [
        "registered instrument `commit_latency_seconds` missing from the "
        "docs table",
        "documented name `made_up_metric` missing from "
        "babble_tpu_torch/obs/catalog.py"]


def test_lint_rejects_docs_without_markers(tmp_path):
    doc = tmp_path / "no_markers.md"
    doc.write_text("# nothing here\n")
    with pytest.raises(SystemExit):
        _lint(PORT).shim.run(str(doc))


def test_metrics_catalog_equals_the_reference():
    from babble_tpu.obs import catalog as ref
    from babble_tpu_torch.obs import catalog as port

    assert [(c.name, c.kind, c.scope) for c in port.CATALOG] == [
        (c.name, c.kind, c.scope) for c in ref.CATALOG]


# ---------------------------------------------------------------------------
# runtime lock-order recorder (BABBLE_LOCKCHECK)


@pytest.fixture
def recorder():
    """A fresh port recorder, armed; the old one and the flag restored."""
    from babble_tpu_torch.common import lockcheck

    rec = lockcheck.LockOrderRecorder()
    old, was = lockcheck.RECORDER, lockcheck.ENABLED
    lockcheck.RECORDER = rec
    lockcheck.set_enabled(True)
    try:
        yield rec
    finally:
        lockcheck.set_enabled(was)
        lockcheck.RECORDER = old


def test_lockcheck_recorder_edges_and_inversions(recorder):
    from babble_tpu_torch.common.timed_lock import TimedLock

    a, b = TimedLock(name="a"), TimedLock(name="b")
    with a:
        with b:
            pass
    assert recorder.edge_list() == ["a->b"]
    assert recorder.inversions() == []
    with b:
        with a:
            pass
    assert recorder.edge_list() == ["a->b", "b->a"]
    assert len(recorder.inversions()) == 1
    assert "a<->b" in recorder.inversions()[0]


def test_lockcheck_disabled_records_nothing():
    from babble_tpu_torch.common import lockcheck
    from babble_tpu_torch.common.timed_lock import TimedLock

    rec = lockcheck.LockOrderRecorder()
    old, was = lockcheck.RECORDER, lockcheck.ENABLED
    lockcheck.RECORDER = rec
    lockcheck.set_enabled(False)
    try:
        a, b = TimedLock(name="a"), TimedLock(name="b")
        with a:
            with b:
                pass
        assert rec.edge_list() == []
    finally:
        lockcheck.set_enabled(was)
        lockcheck.RECORDER = old


def _sim_edges(pkg: str, conf_extra=None, seed: int = 1234):
    """A 3-node sim run of ``pkg`` with a fresh recorder armed: its edges,
    inversions and node 0's stats."""
    lockcheck = importlib.import_module(f"{pkg}.common.lockcheck")
    keys = importlib.import_module(f"{pkg}.crypto.keys")
    harness = importlib.import_module(f"{pkg}.sim.harness")
    scheduler = importlib.import_module(f"{pkg}.sim.scheduler")
    rec = lockcheck.LockOrderRecorder()
    old, was = lockcheck.RECORDER, lockcheck.ENABLED
    lockcheck.RECORDER = rec
    lockcheck.set_enabled(True)
    prev = keys.set_deterministic_signing(True)
    cluster = None
    try:
        sch = scheduler.SimScheduler(seed)
        cluster = harness.SimCluster(sch, 3, heartbeat_s=0.05,
                                     conf_extra=conf_extra)
        cluster.start()
        txrng = sch.rng("txmix")
        for k in range(8):
            sch.at(0.05 + 0.05 * k,
                   lambda: cluster.submit_auto(txrng), "tx")
        sch.run_until(3.0)
        node = cluster.nodes[0]
        return (rec.edge_list(), rec.inversions(),
                node.get_stats_snapshot(), node.get_stats())
    finally:
        lockcheck.set_enabled(was)
        lockcheck.RECORDER = old
        keys.set_deterministic_signing(prev)
        if cluster is not None:
            cluster.shutdown()


@pytest.mark.sim
def test_lockcheck_sim_run_validates_static_model_and_get_stats():
    edges, inversions, snap, legacy = _sim_edges(PORT)
    assert "core->mempool" in edges, edges
    assert inversions == []
    assert snap["lock_order_edges"] == edges
    assert snap["lock_order_inversions"] == 0
    assert "lock_order_edges" in legacy
    assert edges == _sim_edges(REF)[0]


@pytest.fixture
def fresh_batcher():
    """A new process-wide SweepBatcher for the test (built by whoever asks
    for ``instance()`` first); the old one restored after."""
    from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher

    with SweepBatcher._instance_lock:
        old, SweepBatcher._instance = SweepBatcher._instance, None
    try:
        yield SweepBatcher
    finally:
        with SweepBatcher._instance_lock:
            SweepBatcher._instance = old


def test_batcher_lock_is_named_and_reentrant(recorder, fresh_batcher):
    from babble_tpu_torch.common import lockcheck
    from babble_tpu_torch.common.timed_lock import TimedLock

    svc = fresh_batcher.instance()
    assert isinstance(svc._lock, TimedLock) and svc._lock.name == "batcher"
    core = TimedLock(name="core")
    with core:
        with svc._lock:
            with svc._lock:  # reentrant: the holder takes it again
                assert svc.idle()
    assert recorder.edge_list() == ["core->batcher"]
    assert recorder.inversions() == []
    # held by one thread, the lock refuses another
    got = []
    with svc._lock:
        t = threading.Thread(target=lambda: got.append(
            svc._lock.acquire(blocking=False)))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert got == [False]
    # unarmed at construction: a bare C RLock, as named_lock's are bare
    lockcheck.set_enabled(False)
    with fresh_batcher._instance_lock:
        fresh_batcher._instance = None
    bare = fresh_batcher.instance()._lock
    assert type(bare) is type(threading.RLock())
    with bare:
        with bare:
            pass


@pytest.mark.sim
def test_accelerated_sim_records_core_batcher_without_inversion(
        monkeypatch, fresh_batcher):
    """The CPU twin of chip_smoke's phase 13: an accelerated sim run with
    the batcher on (every window through it) records ``core->batcher``,
    no inversion, and nothing outside the static set but the edges named
    as unseen by the static pass, which the JAX package's pass misses on
    the JAX package's tree too."""
    from chip_smoke import LOCK_EDGES_UNSEEN

    for name, val in (("BABBLE_ACCEL_MIN_WINDOW", "0"),
                      ("BABBLE_ACCEL_PIPELINE", "0"),
                      ("BABBLE_ACCEL_BATCH", "1")):
        monkeypatch.setenv(name, val)
    edges, inversions, snap, _ = _sim_edges(
        PORT, {"accelerator": True, "accelerator_device": "cpu"})
    assert snap["accel_batcher"] is True and snap["accel_sweeps"] > 0
    assert snap["accel_fallbacks"] == 0
    assert "core->batcher" in edges and "core->mempool" in edges, edges
    assert inversions == [] and snap["lock_order_inversions"] == 0
    lt, ref = _lint(PORT), _lint(REF)
    static = set(lt.locks.static_edges(lt.core.load_tree()))
    ref_static = set(ref.locks.static_edges(ref.core.load_tree()))
    assert set(edges) - static <= set(LOCK_EDGES_UNSEEN), edges
    assert not set(LOCK_EDGES_UNSEEN) & (static | ref_static)


# ---------------------------------------------------------------------------
# the clock fixes, pinned by same-seed digests across packages


def test_control_timer_jitter_stream_is_seeded():
    def stream(pkg, seed):
        timer = importlib.import_module(f"{pkg}.node.control_timer")
        t = timer.ControlTimer(rng=random.Random(seed))
        return [t._jitter(0.05) for _ in range(16)]

    seq1 = stream(PORT, "seed|control_timer|1")
    assert seq1 == stream(PORT, "seed|control_timer|1")
    assert seq1 == stream(REF, "seed|control_timer|1")
    assert all(0.05 <= w < 0.10 for w in seq1)
    assert stream(PORT, "seed|control_timer|2") != seq1


def _byz_sim_run(pkg: str, seed: int):
    """One equivocation sim run of ``pkg``: (commit digests, sentry-proof
    digest over observed_at too, proof count)."""
    keys = importlib.import_module(f"{pkg}.crypto.keys")
    harness = importlib.import_module(f"{pkg}.sim.harness")
    scheduler = importlib.import_module(f"{pkg}.sim.scheduler")
    prev = keys.set_deterministic_signing(True)
    cluster = None
    try:
        sch = scheduler.SimScheduler(seed)
        cluster = harness.SimCluster(sch, 4, n_byzantine=1,
                                     attack="equivocate", heartbeat_s=0.05)
        cluster.start()
        txrng = sch.rng("txmix")
        for k in range(10):
            sch.at(0.05 + 0.06 * k,
                   lambda: cluster.submit_auto(txrng), "tx")
        sch.run_until(4.0)
        proofs = sorted(
            json.dumps(p.to_dict(), sort_keys=True)
            for n in cluster.nodes
            for p in n.core.sentry.proofs()
        )
        digest = hashlib.sha256("\n".join(proofs).encode()).hexdigest()
        return cluster.commit_digests(), digest, len(proofs)
    finally:
        keys.set_deterministic_signing(prev)
        if cluster is not None:
            cluster.shutdown()


@pytest.mark.sim
def test_same_seed_sentry_proof_digests_byte_identical():
    port1 = _byz_sim_run(PORT, 777)
    assert port1[2] >= 1, "equivocation scenario must mint at least one proof"
    assert port1 == _byz_sim_run(PORT, 777)
    assert port1 == _byz_sim_run(REF, 777)
