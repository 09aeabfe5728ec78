"""The port's checkpoint pruner (lifecycle/pruner.py) in the port's
deterministic simulator, with RFC 6979 signing on so that a run is a pure
function of its seed: a pruned cluster commits the same blocks as the
same-seed unpruned control and keeps a small fraction of its events, two
same-seed pruned runs are identical, prune counters included, and the
port's pruned run equals the JAX package's on the same seed (commit
digests, every block body hash and the four prune counters, on every
node; tolerance: exact). Plus a smoke test of the port's TCP transport: a
sync between two transports over loopback, port to port and across the
two packages."""

from __future__ import annotations

import functools
import importlib
import threading

import pytest

PRUNE_COUNTERS = ("lifecycle_prunes", "lifecycle_prune_floor",
                  "lifecycle_pruned_events", "lifecycle_events_retained")
PORT, REF = "babble_tpu_torch", "babble_tpu"


@functools.lru_cache(maxsize=None)
def _run_sim_arm(pkg: str, seed: int, horizon_s: float, prune: bool,
                 n_honest: int = 4, tx_every_s: float = 0.05,
                 n_txs: int = 200):
    """One simulated cluster of package ``pkg`` (the setup of
    tests/test_lifecycle.py's arm), signing deterministically: its commit
    digests, every node's block body hashes and every node's stats."""
    harness = importlib.import_module(f"{pkg}.sim.harness")
    scheduler = importlib.import_module(f"{pkg}.sim.scheduler")
    keys = importlib.import_module(f"{pkg}.crypto.keys")
    prev = keys.set_deterministic_signing(True)
    cl = None
    try:
        sch = scheduler.SimScheduler(seed=seed)
        extra = (
            {"prune_every_rounds": 4, "prune_keep_rounds": 2} if prune
            else {}
        )
        cl = harness.SimCluster(sch, n_honest=n_honest, conf_extra=extra)
        cl.start()
        rng = sch.rng("txgen")
        t = 0.0
        for _ in range(n_txs):
            t += tx_every_s
            sch.at(t, lambda: cl.submit_auto(rng), "tx")
        sch.run_until(horizon_s)
        chains = tuple(
            tuple(n.get_block(b).body.hash()
                  for b in range(n.get_last_block_index() + 1))
            for n in cl.nodes
        )
        return cl.commit_digests(), chains, [n.get_stats() for n in cl.nodes]
    finally:
        try:
            if cl is not None:
                cl.shutdown()
        finally:
            keys.set_deterministic_signing(prev)


def test_pruned_run_equals_unpruned_control():
    """Seed 42: the pruned cluster commits the control's blocks, block for
    block, while it retains under a quarter of the control's events."""
    dp, chains_p, stats_p = _run_sim_arm(PORT, 42, 30.0, True)
    dc, chains_c, stats_c = _run_sim_arm(PORT, 42, 30.0, False)
    assert len(set(dp.values())) == 1, f"pruned arm forked: {dp}"
    assert dp == dc, "pruning changed consensus output"
    assert min(len(c) for c in chains_p) >= 2
    assert chains_p == chains_c
    for sp, sc in zip(stats_p, stats_c):
        assert int(sp["lifecycle_prunes"]) > 0
        assert int(sc["lifecycle_prunes"]) == 0
        retained = int(sp["lifecycle_events_retained"])
        assert retained < int(sc["lifecycle_events_retained"]) / 4
        assert int(sp["lifecycle_prune_floor"]) > 0
        assert int(sp["lifecycle_prune_lag_rounds"]) >= 0


def test_pruned_runs_are_deterministic():
    """Seed 7, twice: the same commit digests and the same prune
    counters on every node."""
    a = _run_sim_arm.__wrapped__(PORT, 7, 20.0, True)
    b = _run_sim_arm.__wrapped__(PORT, 7, 20.0, True)
    assert a[0] == b[0] and a[1] == b[1]
    for sa, sb in zip(a[2], b[2]):
        assert int(sa["lifecycle_prunes"]) > 0
        for k in PRUNE_COUNTERS:
            assert sa[k] == sb[k], (k, sa[k], sb[k])


def test_port_pruner_equals_the_jax_package_pruner():
    """Seed 42, pruned, through both packages: equal commit digests, equal
    block body hashes and equal prune counters on every node, so the port
    prunes at the reference's floors and keeps the reference's events."""
    dp, chains_p, stats_p = _run_sim_arm(PORT, 42, 30.0, True)
    dr, chains_r, stats_r = _run_sim_arm(REF, 42, 30.0, True)
    assert dp == dr
    assert chains_p == chains_r
    assert len(stats_p) == len(stats_r) == 4
    for sp, sr in zip(stats_p, stats_r):
        assert int(sp["lifecycle_prunes"]) > 0
        for k in PRUNE_COUNTERS:
            assert sp[k] == sr[k], (k, sp[k], sr[k])


def _sync_round_trip(client_pkg: str, server_pkg: str) -> None:
    """A SyncRequest from a ``client_pkg`` TCP transport to a
    ``server_pkg`` one over loopback, answered by the server's consumer:
    what each side decodes must be what the other sent."""
    srv_tcp = importlib.import_module(f"{server_pkg}.net.tcp")
    srv_rpc = importlib.import_module(f"{server_pkg}.net.rpc")
    srv_ev = importlib.import_module(f"{server_pkg}.hashgraph.event")
    cli_tcp = importlib.import_module(f"{client_pkg}.net.tcp")
    cli_rpc = importlib.import_module(f"{client_pkg}.net.rpc")
    srv = srv_tcp.TCPTransport("127.0.0.1:0")
    cli = cli_tcp.TCPTransport("127.0.0.1:0")
    srv.listen()
    cli.listen()
    stop = threading.Event()
    seen = []
    want = srv_rpc.SyncResponse(from_id=2, known={1: 5, 2: 9}, events=[
        srv_ev.WireEvent(
            body=srv_ev.WireBody(transactions=[b"t1", b"t2"], creator_id=7,
                                 other_parent_creator_id=3, index=4,
                                 self_parent_index=3, other_parent_index=2,
                                 timestamp=99),
            signature="abc|def")])

    def respond():
        while not stop.is_set():
            try:
                rpc = srv.consumer().get(timeout=0.1)
            except Exception:
                continue
            seen.append(rpc.command)
            rpc.respond(want, None)

    t = threading.Thread(target=respond, daemon=True)
    t.start()
    try:
        got = cli.sync(srv.advertise_addr(),
                       cli_rpc.SyncRequest(from_id=1, known={1: 2},
                                           sync_limit=500))
        assert isinstance(seen[0], srv_rpc.SyncRequest)
        assert seen[0].from_id == 1 and seen[0].known == {1: 2}
        assert seen[0].sync_limit == 500
        assert isinstance(got, cli_rpc.SyncResponse)
        assert got.from_id == 2 and got.known == {1: 5, 2: 9}
        assert len(got.events) == 1
        body = got.events[0].body
        assert body.transactions == [b"t1", b"t2"]
        assert (body.creator_id, body.other_parent_creator_id, body.index,
                body.self_parent_index, body.other_parent_index,
                body.timestamp) == (7, 3, 4, 3, 2, 99)
        assert got.events[0].signature == "abc|def"
    finally:
        stop.set()
        t.join(timeout=5)
        cli.close()
        srv.close()
    assert not t.is_alive()


def test_tcp_transports_exchange_a_sync():
    """Two of the port's TCP transports on loopback: a SyncRequest from
    one reaches the other's consumer, and its SyncResponse comes back
    whole."""
    _sync_round_trip(PORT, PORT)


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_tcp_sync_across_packages(client_pkg, server_pkg):
    """The port's TCP transport speaks the JAX package's wire format: a
    sync from a port client to a JAX package server, and the reverse."""
    _sync_round_trip(client_pkg, server_pkg)
