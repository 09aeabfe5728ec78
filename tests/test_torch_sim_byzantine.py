"""The port's deterministic simulation under attack, against the JAX
package's, at one seed.

4 honest validators and 1 Byzantine one (``SimCluster(n_byzantine=1)``)
run under virtual time with a seeded transaction mix, once for every
attack of ``adversary.ATTACKS`` and once for split-brain equivocation,
through ``babble_tpu`` and through ``babble_tpu_torch``. Each case runs
twice: on the host oracle, and with the consensus offload configured
identically on both sides (``same_offload``: synchronous sweeps,
``min_window`` 0, no resident windows, no batcher; the port's offload on
the CPU, so K1's plain version, against the JAX package's on CPU XLA with
its compiles inline).

Tolerance: exact. Every honest node's committed block body hashes, its
sentry counters (rejections by cause, quarantines, proofs, refused RPCs)
and its per-peer quarantine record must be equal across the packages,
and the Byzantine node's counters too. Signing is RFC 6979 on both
sides. ``wrong_key`` forges with a key drawn from ``secrets``, so its
forged events differ from run to run; they are rejected, so the blocks
and the sentry outcome still compare, but nothing that hashes them does
(the sim's event-log digest is not compared at all).
"""

from __future__ import annotations

import importlib

import pytest

from babble_tpu.adversary import ATTACKS as JAX_ATTACKS
from babble_tpu_torch.adversary import ATTACKS

SEED = 11
N_HONEST = 4
N_TXS = 40
HORIZON_S = 3.0

CASES = [(a, False) for a in ATTACKS] + [("equivocate", True)]


def _sentry_view(node) -> dict:
    """A node's sentry outcome: its counters and, per peer, the causes it
    recorded and how often it quarantined it (scores decay with the
    virtual clock and are compared through these)."""
    s = node.core.sentry
    peers = {pid: (dict(rec["causes"]), rec["quarantines"])
             for pid, rec in s.suspects()["peers"].items()}
    return {"stats": s.stats(), "peers": peers,
            "proofs": sorted(p.key() for p in s.proofs())}


def _run(pkg: str, attack: str, split: bool, conf_extra=None,
         inline_compile: bool = False) -> dict:
    harness = importlib.import_module(f"{pkg}.sim.harness")
    scheduler = importlib.import_module(f"{pkg}.sim.scheduler")
    keys = importlib.import_module(f"{pkg}.crypto.keys")
    prev = keys.set_deterministic_signing(True)
    cluster = None
    try:
        sch = scheduler.SimScheduler(SEED)
        cluster = harness.SimCluster(sch, N_HONEST, n_byzantine=1,
                                     attack=attack, split=split,
                                     heartbeat_s=0.05, conf_extra=conf_extra)
        if inline_compile:
            for node in cluster.nodes:
                node.core.hg.accel.async_compile = False
        cluster.start()
        txrng = sch.rng("txmix")
        for k in range(N_TXS):
            sch.at(0.05 + 0.06 * k, lambda: cluster.submit_auto(txrng), "tx")
        sch.run_until(HORIZON_S)
        return {
            "chains": [[n.get_block(b).body.hash()
                        for b in range(n.get_last_block_index() + 1)]
                       for n in cluster.nodes],
            "sentries": [_sentry_view(n) for n in cluster.nodes],
            "byz": cluster.byzantine[0].stats(),
            "stats": [n.get_stats_snapshot() for n in cluster.nodes],
        }
    finally:
        try:
            if cluster is not None:
                cluster.shutdown()
        finally:
            keys.set_deterministic_signing(prev)


@pytest.fixture
def same_offload(monkeypatch):
    for name, val in (("BABBLE_ACCEL_MIN_WINDOW", "0"),
                      ("BABBLE_ACCEL_PIPELINE", "0"),
                      ("BABBLE_ACCEL_RESIDENT", "0"),
                      ("BABBLE_ACCEL_BATCH", "0")):
        monkeypatch.setenv(name, val)


def test_the_attacks_are_the_jax_packages():
    assert ATTACKS == JAX_ATTACKS


@pytest.mark.parametrize("offload", [False, True], ids=["oracle", "offload"])
@pytest.mark.parametrize("attack,split", CASES,
                         ids=[a + ("-split" if s else "") for a, s in CASES])
def test_port_sim_under_attack_equals_jax_sim(same_offload, attack, split,
                                              offload):
    if offload:
        jax = _run("babble_tpu", attack, split, {"accelerator": True},
                   inline_compile=True)
        port = _run("babble_tpu_torch", attack, split,
                    {"accelerator": True, "accelerator_device": "cpu"})
        for stats in port["stats"]:
            assert stats["consensus_engine"] == "device"
            assert stats["accel_kernel"] == "plain"
            assert stats["accel_fallbacks"] == 0
            assert stats["accel_sweeps"] > 0
        # A sync whose insert fails (a forged, junk or duplicate event)
        # flushes the port's offload before the error propagates (ROADMAP
        # Queue C: a failed insert must still flush); the JAX package's
        # waits for the next sync. So the port may sweep more often, at no
        # other difference.
        for p, j in zip(port["stats"], jax["stats"]):
            assert p["accel_sweeps"] >= j["accel_sweeps"]
    else:
        jax = _run("babble_tpu", attack, split)
        port = _run("babble_tpu_torch", attack, split)
    chains = port["chains"]
    common = min(len(c) for c in chains)
    assert common > 0, "nothing committed"
    for c in chains[1:]:
        assert c[:common] == chains[0][:common]
    assert port["chains"] == jax["chains"]
    assert port["sentries"] == jax["sentries"]
    assert port["byz"] == jax["byz"]
    if attack not in ("replay", "lying_known"):
        # an attack that sends what insert refuses is seen and scored (a
        # replay sends valid events; lying_known only asks)
        assert any(s["stats"]["sentry_rejects_total"]
                   for s in port["sentries"]), port["sentries"]
