"""The PyTorch port stands alone: no JAX, no JAX package, and no silent CPU
run when the card is asked for.

- an AST scan: no file under babble_tpu_torch/ and not chip_smoke.py
  imports ``jax``, ``jaxlib`` or ``babble_tpu[.…]``;
- a fresh interpreter imports every port module and finds no ``jax*`` or
  ``babble_tpu.*`` module loaded;
- without a GPU, ``resolve_device()``, ``TensorConsensus()``,
  ``run_pipeline()``, ``batched_pipeline()`` and ``ops.verify``'s
  ``batch_verify()`` at their defaults raise instead of running on the
  CPU.

Both scans walk the whole package, so every module (``ops/dag.py``,
``parallel/``, the node, net, CLI, service and sim stacks, the operator
tools under ``obs/``, the light-client tier under ``client/``, the
embedding binding under ``mobile/`` and the lint suite under
``analysis/`` with its ``obs/lint.py`` shim included) is covered without
a list to keep.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.ops.device import describe, on_accelerator, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "babble_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "babble_tpu")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _port_modules():
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if not rel.startswith("babble_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_imports_in_sources():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", None) == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _forbidden(n)]
    assert bad == []
    mods = set(_port_modules())
    assert len(mods) > 100
    # the entry point's stack is walked too
    for sub in ("node", "net", "cli", "service", "sim"):
        assert any(m.startswith(f"babble_tpu_torch.{sub}.") for m in mods), sub
    assert {"babble_tpu_torch.__main__", "babble_tpu_torch.cli.__main__",
            "babble_tpu_torch.node.core", "babble_tpu_torch.node.node",
            "babble_tpu_torch.service.service"} <= mods
    # the operator tools, which the fresh-interpreter test imports too
    assert {f"babble_tpu_torch.obs.{m}" for m in
            ("ledger", "perfgate", "traceview", "healthview", "lint")} <= mods
    # the lint suite, every pass and its entry point
    assert {f"babble_tpu_torch.analysis{m}" for m in
            ("", ".__main__", ".core", ".clock_pass", ".lock_pass",
             ".knob_pass", ".metrics_pass")} <= mods


def test_importing_every_port_module_loads_no_jax():
    """Modules loaded by importing the port, beyond what the interpreter
    had at start-up, include nothing of JAX or the JAX package."""
    mods = sorted(_port_modules())
    code = textwrap.dedent(f"""
        import importlib, sys
        before = set(sys.modules)
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in set(sys.modules) - before
                     if m.split(".")[0] in ("jax", "jaxlib", "babble_tpu"))
        print(len({mods!r}), bad)
    """)
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) == len(mods)
    assert bad == "[]", bad


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TensorConsensus()
    with pytest.raises(RuntimeError, match="CUDA"):
        on_accelerator()


def test_dag_pipeline_default_device_raises_without_gpu(monkeypatch):
    from babble_tpu_torch.ops.dag import run_pipeline, synthetic_snapshot
    from babble_tpu_torch.parallel import batched_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(synthetic_snapshot(4, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_pipeline(3, 8)
    assert {"babble_tpu_torch.ops.dag", "babble_tpu_torch.parallel",
            "babble_tpu_torch.parallel.pipeline"} <= set(_port_modules())


def test_batch_verify_default_device_raises_without_gpu(monkeypatch):
    from babble_tpu_torch.crypto import secp256k1 as ref
    from babble_tpu_torch.ops.verify import BatchVerifier, batch_verify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = [((ref.GX, ref.GY), b"\x00" * 32, 1, 1)]
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_verify(items)
    bv = BatchVerifier()
    bv.add(*items[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        bv.flush()
    assert {"babble_tpu_torch.ops.verify",
            "babble_tpu_torch.ops.limbs"} <= set(_port_modules())


def test_explicit_cpu_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert not on_accelerator("cpu")
    assert describe("cpu")["platform"] == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    tc = TensorConsensus(device="cpu")
    assert tc.device.type == "cpu"


def test_own_native_crypto_loader():
    """The port's loader builds native/secp256k1.cc into build/native/ and
    never loads the shared object committed beside the source; signatures
    cross between the two packages in both directions."""
    from babble_tpu.crypto.keys import PrivateKey as JPrivateKey
    from babble_tpu.crypto.keys import PublicKey as JPublicKey
    from babble_tpu_torch import native_crypto
    from babble_tpu_torch.crypto.keys import PrivateKey, PublicKey

    assert native_crypto._SO == os.path.join(
        ROOT, "build", "native", "libbabble_crypto.so"
    )
    assert native_crypto.host_crypto_path() in ("native", "openssl", "python")
    if native_crypto.available():
        assert native_crypto.host_crypto_path() == "native"
        assert os.path.exists(native_crypto._SO)
    msg = bytes(range(32))
    key, jkey = PrivateKey(0xA11CE), JPrivateKey(0xA11CE)
    assert key.public_key.bytes() == jkey.public_key.bytes()
    sig = key.sign(msg)
    assert JPublicKey.from_bytes(key.public_key.bytes()).verify(msg, sig)
    jsig = jkey.sign(msg)
    assert PublicKey.from_bytes(jkey.public_key.bytes()).verify(msg, jsig)
    assert not PublicKey.from_bytes(jkey.public_key.bytes()).verify(
        bytes(32), jsig
    )


def test_native_crypto_search_order(tmp_path, monkeypatch):
    """The loader searches in the JAX package's order: the checkout's
    native/ (built into build/native/), then the installed package's
    _native/ (source and library shipped beside each other), then a
    user-cache build where the package directory is read-only."""
    from babble_tpu_torch import native_crypto as nc

    assert [c[0] for c in nc._CANDIDATES] == [
        os.path.join(ROOT, "native", "secp256k1.cc"),
        os.path.join(PKG, "_native", "secp256k1.cc"),
    ]
    assert nc._CANDIDATES[0][2] is None  # a checkout builds only in itself
    repo_src, pkg_src = tmp_path / "native.cc", tmp_path / "_native.cc"
    cands = [(str(repo_src), str(tmp_path / "build" / "lib.so"), None),
             (str(pkg_src), str(tmp_path / "_native" / "lib.so"),
              str(tmp_path / "cache" / "lib.so"))]
    assert nc._locate(cands) == cands[0]  # no source: the checkout's pair
    pkg_src.write_text("//")
    assert nc._locate(cands) == cands[1]
    repo_src.write_text("//")
    assert nc._locate(cands) == cands[0]

    # an installed package whose directory is read-only: the build at the
    # package's path fails, the user cache's succeeds and is loaded
    built, loaded = [], []

    def fake_build_at(path):
        built.append(path)
        if path == cands[1][1]:
            return False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "w").close()
        return True

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            self.bt_verify_batch = self.bt_sign = self.bt_pubkey = (
                lambda *a: 0)

    monkeypatch.setattr(nc, "_build_at", fake_build_at)
    monkeypatch.setattr(nc.ctypes, "CDLL", FakeLib)
    for attr, value in zip(("_SRC", "_SO", "_SO_FALLBACK"), cands[1]):
        monkeypatch.setattr(nc, attr, value)
    monkeypatch.setattr(nc, "_tried", False)
    monkeypatch.setattr(nc, "_lib", None)
    assert nc._load() is not None
    assert built == [cands[1][1], cands[1][2]]
    assert loaded == [cands[1][2]] and nc._SO == cands[1][2]

    # the next process finds the user-cache build fresh and loads it
    # without building
    built.clear()
    loaded.clear()
    monkeypatch.setattr(nc, "_SO", cands[1][1])
    monkeypatch.setattr(nc, "_tried", False)
    monkeypatch.setattr(nc, "_lib", None)
    assert nc._load() is not None
    assert built == [] and loaded == [cands[1][2]]

    # a checkout never falls back to the user cache
    for attr, value in zip(("_SRC", "_SO", "_SO_FALLBACK"), cands[0]):
        monkeypatch.setattr(nc, attr, value)
    monkeypatch.setattr(nc, "_build_at", lambda path: built.append(path)
                        or False)
    monkeypatch.setattr(nc, "_tried", False)
    monkeypatch.setattr(nc, "_lib", None)
    assert nc._load() is None
    assert built == [cands[0][1]]
