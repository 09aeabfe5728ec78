"""Phase 16 of chip_smoke.py (BASELINE config 2, the socket-proxy firehose)
rehearsed on the CPU at a small size, through the phase's own harness:
``chip_smoke.firehose_run`` with its ``SenderLoad`` (the port's
``DummySocketClient`` apps in a sender process, each under its
``OpenLoopPacer``) and ``exactly_once`` accounting, the code the card runs.

Four in-process nodes over the inmem transport, each behind a
``SocketAppProxy`` on port 0 whose app is one of the sender process's
``DummySocketClient``s (the apps speak the same JSON-RPC to either
package's proxy), the offload on (the port's with ``accelerator_device="cpu"``, the JAX
package's on its CPU path), take an open-loop load of 200 tx/s for about 3
s, then drain. The same checks hold for both packages: identical block
bodies at every index all nodes committed, every admitted transaction in
every app's state exactly once, nothing shed committed, no submission
neither admitted nor shed, and no offload fallback. Blocks of live runs
depend on timing, so the packages are held to the same invariants, not to
equal bytes."""

from __future__ import annotations

import importlib
import random

import pytest

import chip_smoke

PKGS = ("babble_tpu", "babble_tpu_torch")
NODES = 4
RATE = 200.0
WARMUP_S = 1.0
WINDOW_S = 2.0
DRAIN_S = 60.0


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _socket_cluster(pkg: str, tmp: str):
    """NODES nodes of ``pkg`` with the offload on the CPU, each with a
    socket-proxy app in one ``SenderLoad`` process at RATE; returns (nodes,
    load, proxies), the nodes running."""
    keys = _m(pkg, "crypto.keys")
    Peer = _m(pkg, "peers.peer").Peer
    rng = random.Random(16)
    privs = [keys.PrivateKey(rng.randrange(1, 2**255)) for _ in range(NODES)]
    peers = _m(pkg, "peers.peer_set").PeerSet(
        [Peer(f"inmem://f{i}", k.public_key.hex(), f"f{i}")
         for i, k in enumerate(privs)])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}
    network = _m(pkg, "net.inmem").InmemNetwork()
    sp = _m(pkg, "proxy.socket_proxy")
    extra = {"accelerator_device": "cpu"} if pkg == PKGS[1] else {}
    proxies = [sp.SocketAppProxy("127.0.0.1:0", client_addr="")
               for _ in privs]
    load = chip_smoke.SenderLoad([p.addr for p in proxies], RATE, 1, tmp)
    nodes = []
    try:
        for i, (k, proxy) in enumerate(zip(privs, proxies)):
            proxy.set_client_addr(load.addrs[i])
            conf = _m(pkg, "config.config").Config(
                heartbeat_timeout=chip_smoke.HEARTBEAT_S,
                slow_heartbeat_timeout=chip_smoke.SLOW_HEARTBEAT_S,
                moniker=f"f{i}", log_level="error", accelerator=True,
                **extra)
            node = _m(pkg, "node.node").Node(
                conf, _m(pkg, "node.validator").Validator(k, f"f{i}"), peers,
                peers, _m(pkg, "hashgraph.store").InmemStore(conf.cache_size),
                network.new_transport(addr_of[k.public_key.hex()]), proxy)
            node.init()
            nodes.append(node)
    except BaseException:
        load.close()
        raise
    for node in nodes:
        node.run_async()
    return nodes, load, proxies


@pytest.mark.parametrize("pkg", PKGS)
def test_firehose_exactly_once_identical_blocks(pkg, tmp_path):
    nodes, load, proxies = _socket_cluster(pkg, str(tmp_path))
    try:
        rec = chip_smoke.firehose_run(
            pkg, load,
            lambda: [n.get_last_block_index() for n in nodes],
            lambda bi: [n.get_block(bi).body.hash() for n in nodes],
            warmup_s=WARMUP_S, blocks=None, window_s=WINDOW_S,
            drain_s=DRAIN_S)
        fallbacks = [n.core.hg.accel.fallbacks for n in nodes]
    finally:
        load.close()
        for n in nodes:
            n.shutdown()
        for proxy in proxies:
            proxy.close()
    # firehose_run raised on a failed check; what it measured is sane
    assert fallbacks == [0] * NODES
    assert rec["offered"] >= RATE * (WARMUP_S + WINDOW_S) * 0.5
    assert rec["admitted"] + rec["shed"] == rec["offered"]
    assert rec["admitted"] > 0 and rec["common_block"] >= 0
    assert [r["committed"] for r in rec["exactly_once"]] == (
        [rec["admitted"]] * NODES)
    assert chip_smoke.exactly_once_held(rec["exactly_once"])


def test_exactly_once_names_each_fault():
    """The accounting counts, per app, an admitted transaction it lacks, one
    it committed twice, a shed one it committed and one no node admitted."""
    accepted, shed = [b"a", b"b", b"c"], [b"s"]
    report = chip_smoke.exactly_once(
        accepted, shed,
        [[b"a", b"b", b"c"], [b"a", b"b"], [b"a", b"a", b"b", b"c"],
         [b"a", b"b", b"c", b"s"], [b"a", b"b", b"c", b"x"]])
    assert [(r["missing"], r["repeated"], r["shed_committed"], r["unknown"])
            for r in report] == [(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0),
                                 (0, 0, 1, 0), (0, 0, 0, 1)]
    assert chip_smoke.exactly_once_held(report[:1])
    assert not any(chip_smoke.exactly_once_held([r]) for r in report[1:])


def test_pacer_is_open_loop_and_never_skips():
    """Transaction i goes to sender i mod n at t0 + i / rate. A sender that
    stalls sends its backlog when it can, skipping none, and records how
    far behind it fell; a shed verdict is kept apart from an admitted one,
    and a verdict that is neither is kept for the checks to refuse."""
    import struct
    import threading
    import time

    gate = threading.Event()
    got = [[] for _ in range(3)]
    verdicts = {0: "accepted", 1: "full", 2: "accepted"}

    def sender(k):
        def send(tx):
            serial = struct.unpack(">dQ", tx[:16])[1]
            if k == 0:
                gate.wait(5)  # sender 0 stalls until the gate opens
            got[k].append(serial)
            return "duplicate" if serial == 5 else verdicts[k]
        return send

    pacer = chip_smoke.OpenLoopPacer([sender(k) for k in range(3)], 100.0)
    pacer.start()
    time.sleep(0.3)
    gate.set()
    time.sleep(0.3)
    pacer.stop()
    counts = pacer.counts()
    for k, serials in enumerate(got):
        assert serials == list(range(k, 3 * len(serials), 3))
    assert abs(len(got[0]) - len(got[1])) <= 1  # the backlog went out
    assert counts["offered"] == sum(map(len, got))
    assert counts["other"] == [(5, "duplicate")]
    assert counts["shed"] == len(got[1])
    assert counts["admitted"] == len(got[0]) + len(got[2]) - 1
    assert counts["lag_ms"][2] >= 200.0  # sender 0's stall
