"""The port's node stack on the CPU: in-process nodes over the inmem
transport, the consensus offload on the host (``accelerator_device="cpu"``,
K1's plain version), the start-up refusals (a mesh; device verification
asked for on the CPU starts on the host verifier), and the command line.

The checks follow tests/test_node.py: every node reaches a target block and
block bodies are byte-identical across nodes (checkGossip). The card runs
of the same cluster are in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import pytest
import torch

from babble_tpu_torch.config.config import Config
from babble_tpu_torch.crypto.keys import generate_key
from babble_tpu_torch.dummy.state import State as DummyState
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.hashgraph.store import InmemStore
from babble_tpu_torch.net.inmem import InmemNetwork
from babble_tpu_torch.node.node import Node
from babble_tpu_torch.node.state import State
from babble_tpu_torch.node.validator import Validator
from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet
from babble_tpu_torch.proxy.proxy import InmemProxy
from babble_tpu_torch.service.service import Service

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_nodes(n: int, network: InmemNetwork, init: bool = True, **conf_kw):
    """n wired-up port nodes over one inmem network; ``conf_kw`` goes into
    every node's Config."""
    keys = [generate_key() for _ in range(n)]
    peers = PeerSet([
        Peer(f"inmem://node{i}", k.public_key.hex(), f"node{i}")
        for i, k in enumerate(keys)
    ])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}
    nodes, proxies = [], []
    for i, k in enumerate(keys):
        conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                      moniker=f"node{i}", log_level="warning", **conf_kw)
        proxy = InmemProxy(DummyState())
        node = Node(conf, Validator(k, f"node{i}"), peers, peers,
                    InmemStore(conf.cache_size),
                    network.new_transport(addr_of[k.public_key.hex()]),
                    proxy)
        if init:
            node.init()
        nodes.append(node)
        proxies.append(proxy)
    return nodes, proxies


def bombard_and_wait(nodes, proxies, target_block: int,
                     timeout: float = 60.0) -> None:
    """Submit transactions until every node reaches ``target_block``."""
    deadline = time.monotonic() + timeout
    i = 0
    while not all(n.get_last_block_index() >= target_block for n in nodes):
        if time.monotonic() > deadline:
            pytest.fail(f"timeout: block indexes "
                        f"{[n.get_last_block_index() for n in nodes]} < "
                        f"{target_block}")
        proxies[i % len(proxies)].submit_tx(f"tx {i}".encode())
        i += 1
        time.sleep(0.01)


def check_gossip(nodes, to_block: int) -> None:
    """Byte-identical block bodies across nodes, and monotonic block
    timestamps (tests/test_node.py::check_gossip, check_timestamps)."""
    for bi in range(to_block + 1):
        ref = nodes[0].get_block(bi).body.hash()
        for n in nodes[1:]:
            assert n.get_block(bi).body.hash() == ref, f"block {bi} differs"
    for n in nodes:
        stamps = [n.get_block(bi).timestamp() for bi in range(to_block + 1)]
        assert stamps == sorted(stamps)


def run_cluster(nodes, proxies, target_block: int) -> None:
    try:
        for n in nodes:
            assert n.get_state() == State.BABBLING
            n.run_async()
        bombard_and_wait(nodes, proxies, target_block)
        check_gossip(nodes, target_block)
    finally:
        for n in nodes:
            n.shutdown()


@pytest.fixture
def cpu_offload_env(monkeypatch):
    """Every flush on the device path, synchronously."""
    monkeypatch.setenv("BABBLE_ACCEL_MIN_WINDOW", "0")
    monkeypatch.setenv("BABBLE_ACCEL_PIPELINE", "0")


def test_cluster_with_cpu_offload_and_metrics(cpu_offload_env):
    """Four port nodes with the offload on the host agree on every block,
    decide on the device path with no fallback, and serve /metrics."""
    nodes, proxies = make_nodes(4, InmemNetwork(), accelerator=True,
                                accelerator_device="cpu")
    for n in nodes:
        accel = n.core.hg.accel
        assert isinstance(accel, TensorConsensus)
        assert accel.device.type == "cpu"
        assert (accel.min_window, accel.pipeline) == (0, False)
    svc = Service("127.0.0.1:0", nodes[0])
    svc.serve_async()
    try:
        run_cluster(nodes, proxies, target_block=2)
        with urllib.request.urlopen(
            f"http://{svc.bind_addr}/metrics", timeout=10
        ) as resp:
            assert resp.status == 200
            text = resp.read().decode()
        with urllib.request.urlopen(
            f"http://{svc.bind_addr}/stats", timeout=10
        ) as resp:
            web_stats = json.loads(resp.read())
    finally:
        svc.shutdown()
    for metric in ("accel_sweeps_total", "accel_compile_waits_total",
                   "accel_rows_delta_total", "accel_mesh_fallbacks_total",
                   "copro_validators", "accel_breaker_state"):
        assert metric in text
    assert web_stats["consensus_engine"] == "device"
    for n in nodes:
        st = n.get_stats_snapshot()
        assert st["consensus_engine"] == "device"
        assert st["accel_kernel"] == "plain"
        assert st["accel_sweeps"] > 0
        assert st["accel_fallbacks"] == 0


def test_profile_hook_torch_and_jax_formats(tmp_path, monkeypatch):
    """GET /profile?format=torch captures a torch.profiler trace (on the
    CPU here: CPU activities only) and answers with its path; format=jax
    answers with an error naming format=torch."""
    import urllib.error

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    nodes, _ = make_nodes(1, InmemNetwork())
    svc = Service("127.0.0.1:0", nodes[0])
    svc.serve_async()
    try:
        with urllib.request.urlopen(
            f"http://{svc.bind_addr}/profile?format=torch&seconds=0.2",
            timeout=60,
        ) as resp:
            body = json.loads(resp.read())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://{svc.bind_addr}/profile?format=jax", timeout=10)
        assert err.value.code == 400
        assert "format=torch" in json.loads(err.value.read())["error"]
    finally:
        svc.shutdown()
        nodes[0].shutdown()
    assert body["seconds"] == 0.2 and body["window_s"] >= 0.2
    assert body["accel_sweeps"] == [0, 0]  # no offload on this node
    assert body["activities"] == ["CPU"]
    assert body["trace_file"].startswith(
        str(tmp_path / "babble_tpu_torch_profile"))
    with open(body["trace_file"]) as f:
        assert "traceEvents" in json.load(f)


def test_profile_window_reports_the_node_sweeps(cpu_offload_env):
    """GET /profile?format=torch on a node whose offload sweeps (on the CPU
    here) answers with the node's accel_sweeps at the window's start and
    end: within a few short captures under load the count advances, and
    never goes back."""
    nodes, proxies = make_nodes(3, InmemNetwork(), accelerator=True,
                                accelerator_device="cpu")
    svc = Service("127.0.0.1:0", nodes[0])
    svc.serve_async()
    stop = threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            proxies[i % 3].submit_tx(f"tx {i}".encode())
            i += 1
            time.sleep(0.01)

    loader = threading.Thread(target=load, daemon=True)
    windows = []
    try:
        for n in nodes:
            n.run_async()
        loader.start()
        for _ in range(20):
            with urllib.request.urlopen(
                f"http://{svc.bind_addr}/profile?format=torch&seconds=0.5",
                timeout=60,
            ) as resp:
                body = json.loads(resp.read())
            os.remove(body["trace_file"])
            windows.append((body["accel_sweeps"], body["window_s"]))
            if body["accel_sweeps"][1] > body["accel_sweeps"][0]:
                break
    finally:
        stop.set()
        loader.join(timeout=10)
        svc.shutdown()
        for n in nodes:
            n.shutdown()
    assert windows[-1][0][1] > windows[-1][0][0], windows
    for (first, last), window_s in windows:
        assert 0 <= first <= last and window_s >= 0.5, windows
    for ((_, last), _), ((first, _), _) in zip(windows, windows[1:]):
        assert first >= last, windows


def test_mixed_cluster_offload_and_oracle_agree(cpu_offload_env):
    """One port node with the offload among oracle nodes: the device path
    changes where decisions are computed, never their values."""
    nodes, proxies = make_nodes(3, InmemNetwork())
    nodes[0].core.hg.accel = TensorConsensus(device="cpu")
    run_cluster(nodes, proxies, target_block=2)
    assert nodes[0].get_stats_snapshot()["accel_sweeps"] > 0
    assert nodes[0].get_stats_snapshot()["accel_fallbacks"] == 0
    assert nodes[1].get_stats_snapshot()["consensus_engine"] == "oracle"


def test_accelerator_without_card_refuses_to_start(monkeypatch):
    """--accelerator at the default device needs a card: without one the
    node does not start, and never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Config(accelerator=True).accelerator_device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        nodes, _ = make_nodes(1, InmemNetwork(), init=False,
                              accelerator=True)
        nodes[0].init()


def test_unported_modes_refuse_to_start(monkeypatch, caplog):
    """--accelerator-mesh follows the JAX node's rule: a size that is not a
    power of two, an offload on the CPU, or more cards than there are, logs
    a warning and the node starts with its sweeps on one device."""
    for size, why in ((2, "unavailable"), (3, "not a power of two")):
        nodes, _ = make_nodes(1, InmemNetwork(), init=False,
                              accelerator=True, accelerator_device="cpu",
                              accelerator_mesh=size)
        caplog.clear()
        with caplog.at_level("WARNING"):
            nodes[0].init()
        assert nodes[0].core.hg.accel.mesh is None
        assert any(why in r.getMessage() for r in caplog.records), size
    # device signature verification is ported: asked for on the CPU, the
    # node starts and its sync chunks take the host batch verifier
    monkeypatch.setenv("BABBLE_DEVICE_VERIFY", "1")
    nodes, _ = make_nodes(1, InmemNetwork(), accelerator=True,
                          accelerator_device="cpu")
    assert not nodes[0].core._device_verify()


def test_cli_mesh_help_says_the_mesh_is_ported():
    """--accelerator-mesh takes the cards (Node._attach_mesh): its help
    text, and the Config field's comment, no longer call it unported."""
    import inspect

    from babble_tpu_torch.cli import main as cli_main
    from babble_tpu_torch.config import config as config_mod

    run = next(a for a in cli_main.build_parser()._subparsers._group_actions
               if a.dest == "cmd").choices["run"]
    (mesh,) = [a for a in run._actions if a.dest == "accelerator_mesh"]
    assert "not ported" not in mesh.help and "refused" not in mesh.help
    assert "CUDA cards" in mesh.help
    assert "not ported" not in inspect.getsource(config_mod)


def _cli(*args, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "babble_tpu_torch", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **(env or {})},
    )


def test_cli_version_and_keygen(tmp_path):
    from babble_tpu_torch.version import __version__

    out = _cli("version")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == __version__
    out = _cli("keygen", "--datadir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "priv_key").exists()
    assert "Public key:" in out.stdout
    # keygen refuses to overwrite
    assert _cli("keygen", "--datadir", str(tmp_path)).returncode == 1


def test_cli_run_accelerator_without_card_exits_with_error(tmp_path):
    """``run --accelerator`` on a host whose torch sees no card exits with
    an error instead of running the offload on the CPU."""
    assert _cli("keygen", "--datadir", str(tmp_path)).returncode == 0
    pub = (_cli("keygen", "--pem", str(tmp_path / "k2"))
           .stdout.split("Public key:")[1].strip())
    from babble_tpu_torch.crypto.keyfile import SimpleKeyfile

    me = SimpleKeyfile(str(tmp_path / "priv_key")).read_key()
    (tmp_path / "peers.json").write_text(json.dumps([
        {"NetAddr": "127.0.0.1:1", "PubKeyHex": me.public_key.hex(),
         "Moniker": "a"},
        {"NetAddr": "127.0.0.1:2", "PubKeyHex": pub, "Moniker": "b"},
    ]))
    out = _cli("run", "--accelerator", "--datadir", str(tmp_path),
               "--listen", "127.0.0.1:0", "--no-service", "--inmem-dummy",
               env={"CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
