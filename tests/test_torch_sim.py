"""The port's deterministic simulation against the JAX package's, at one seed.

Each test runs the same scenario — 4 honest validators gossiping under the
sim engine's virtual time (``SimCluster``), with a seeded transaction mix —
through ``babble_tpu`` and through ``babble_tpu_torch``, and compares every
committed block body hash of every node. Tolerance: exact. Block bodies
are bytes, and everything consensus feeds into them (rounds, fame,
round-received, strongly-see counts) is an integer or a bool.

- oracle on both sides: the port's host copies (node, net, mempool, sim,
  hashgraph) reproduce the JAX package's host stack byte for byte;
- the consensus offload on both sides, configured identically (pipeline
  off, ``min_window`` 0, no resident windows, no batcher, through the same
  ``BABBLE_ACCEL_*`` knobs): the port's TensorConsensus on the CPU (K1's
  plain version) against the JAX package's on CPU XLA, with the JAX
  package's compiles made inline so that both sweep on every flush.

The two offload runs need not equal the oracle runs: a node signs each
block it commits into its next event, so where a flush decides changes
the DAG the node builds. Within one configuration, both packages must
agree.
"""

from __future__ import annotations

import pytest

SEED = 5
N_NODES = 4
N_TXS = 40
HORIZON_S = 3.0


def _run(pkg: str, conf_extra=None, inline_compile: bool = False):
    """One scenario through package ``pkg``: every node's block body
    hashes, and node 0's stats."""
    import importlib

    harness = importlib.import_module(f"{pkg}.sim.harness")
    scheduler = importlib.import_module(f"{pkg}.sim.scheduler")
    keys = importlib.import_module(f"{pkg}.crypto.keys")
    # consensus breaks ties on signature r: sign on the RFC 6979 path
    prev = keys.set_deterministic_signing(True)
    cluster = None
    try:
        sch = scheduler.SimScheduler(SEED)
        cluster = harness.SimCluster(sch, N_NODES, heartbeat_s=0.05,
                                     conf_extra=conf_extra)
        if inline_compile:
            for node in cluster.nodes:
                node.core.hg.accel.async_compile = False
        cluster.start()
        txrng = sch.rng("txmix")
        for k in range(N_TXS):
            sch.at(0.05 + 0.06 * k, lambda: cluster.submit_auto(txrng), "tx")
        sch.run_until(HORIZON_S)
        chains = [
            [n.get_block(b).body.hash()
             for b in range(n.get_last_block_index() + 1)]
            for n in cluster.nodes
        ]
        return chains, cluster.nodes[0].get_stats_snapshot()
    finally:
        try:
            if cluster is not None:
                cluster.shutdown()
        finally:
            keys.set_deterministic_signing(prev)


def _assert_agree(chains) -> None:
    """Every node of one run commits the same chain (over the common
    prefix, since a node may trail by a block at the horizon)."""
    n = min(len(c) for c in chains)
    assert n > 0, "nothing committed"
    for c in chains[1:]:
        assert c[:n] == chains[0][:n]


def test_port_oracle_sim_equals_jax_oracle_sim():
    jax_chains, jax_stats = _run("babble_tpu")
    port_chains, port_stats = _run("babble_tpu_torch")
    _assert_agree(port_chains)
    assert jax_stats["consensus_engine"] == "oracle"
    assert port_stats["consensus_engine"] == "oracle"
    assert port_chains == jax_chains


@pytest.fixture
def same_offload(monkeypatch):
    """The offload configuration both packages read: synchronous sweeps,
    every window on the device, no resident windows, no batcher."""
    for name, val in (("BABBLE_ACCEL_MIN_WINDOW", "0"),
                      ("BABBLE_ACCEL_PIPELINE", "0"),
                      ("BABBLE_ACCEL_RESIDENT", "0"),
                      ("BABBLE_ACCEL_BATCH", "0")):
        monkeypatch.setenv(name, val)


def test_port_cpu_offload_sim_equals_jax_offload_sim(same_offload):
    jax_chains, jax_stats = _run("babble_tpu", {"accelerator": True},
                                 inline_compile=True)
    port_chains, port_stats = _run(
        "babble_tpu_torch",
        {"accelerator": True, "accelerator_device": "cpu"},
    )
    _assert_agree(port_chains)
    assert port_stats["consensus_engine"] == "device"
    assert port_stats["accel_kernel"] == "plain"
    assert port_stats["accel_pipeline"] is False
    assert port_stats["accel_min_window"] == 0
    assert port_stats["accel_sweeps"] > 0
    assert port_stats["accel_fallbacks"] == 0
    assert jax_stats["accel_resident"] is False
    assert jax_stats["accel_batcher"] is False
    assert jax_stats["accel_fallbacks"] == 0
    # both sweep on every flush of the same schedule
    assert port_stats["accel_sweeps"] == jax_stats["accel_sweeps"]
    assert port_chains == jax_chains


@pytest.mark.parametrize("batch", ["0", "1"])
def test_port_resident_offload_sim_equals_jax(monkeypatch, batch):
    """The offload with resident windows on (the JAX package's default)
    in both packages, synchronous, every window on the device; with
    ``BABBLE_ACCEL_BATCH=1`` every sweep also goes through each package's
    sweep batcher. Block bytes equal."""
    for name, val in (("BABBLE_ACCEL_MIN_WINDOW", "0"),
                      ("BABBLE_ACCEL_PIPELINE", "0"),
                      ("BABBLE_ACCEL_BATCH", batch)):
        monkeypatch.setenv(name, val)
    monkeypatch.delenv("BABBLE_ACCEL_RESIDENT", raising=False)
    jax_chains, jax_stats = _run("babble_tpu", {"accelerator": True},
                                 inline_compile=True)
    port_chains, port_stats = _run(
        "babble_tpu_torch",
        {"accelerator": True, "accelerator_device": "cpu"},
    )
    _assert_agree(port_chains)
    for stats in (port_stats, jax_stats):
        assert stats["accel_resident"] is True
        assert stats["accel_batcher"] is (batch == "1")
        assert stats["accel_fallbacks"] == 0
        assert stats["accel_rows_reused"] > 0
    if batch == "1":
        assert port_stats["batch_windows"] > 0
    assert port_stats["accel_sweeps"] == jax_stats["accel_sweeps"]
    assert port_stats["accel_rebuilds"] == jax_stats["accel_rebuilds"]
    assert port_chains == jax_chains
