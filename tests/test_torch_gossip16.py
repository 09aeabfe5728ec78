"""Phase 17 of chip_smoke.py (BASELINE config 3 as one ``run --accelerator
--transport async`` process a validator) rehearsed on the CPU at a small
size, through the phase's own harness: ``chip_smoke.firehose_arm`` with
the phase's arguments (the async engine, its suspend limit, one shared
admission-slot directory, the apps in sender processes), over four real
port CLI processes with ``--accelerator-device cpu``, at 400 tx/s for ten
blocks a node. The arm raises on any failed check of the phase (every
process Babbling and none gone, identical bodies, exactly once at every
app, no offload fallback, K1's launches equal to the sweeps, every process
exiting 0 after SIGTERM with its record); here, on top, the async engine's
pipeline must have carried syncs, the senders must have held the schedule,
and no process carrying the run's token may be left. K1 launching at all
is the card's part of the phase: at four validators no flush reaches the
CPU offload's ``min_window``."""

from __future__ import annotations

import uuid

import chip_smoke

NODES = 4
SENDERS = 2
RATE = 400.0
WINDOW_S = 40.0


def test_phase17_harness_over_four_cli_processes(monkeypatch):
    token = uuid.uuid4().hex
    monkeypatch.setenv(chip_smoke.RUN_TOKEN, token)
    try:
        rec = chip_smoke.firehose_arm(
            "config 3 rehearsal", False, n=NODES, rate=RATE,
            argv=("--accelerator-device", "cpu", *chip_smoke.G16_ARGV),
            shared_slots=True, senders=SENDERS, window_s=WINDOW_S)
    finally:
        left = chip_smoke.reap(token)
    assert left == [], f"processes outlived the arm: {left}"
    assert rec["window_reached"]
    assert all(e >= s + chip_smoke.FH_BLOCKS
               for s, e in zip(rec["start_blocks"], rec["end_blocks"]))
    assert chip_smoke.exactly_once_held(rec["exactly_once"])
    assert [r["committed"] for r in rec["exactly_once"]] == (
        [rec["admitted"]] * NODES)
    assert rec["admitted"] + rec["shed"] == rec["offered"] > 0
    # the senders held the open-loop schedule
    assert rec["offered"] >= 0.9 * RATE * rec["load_s"]
    assert rec["lag_ms"][1] < 50.0
    assert all(x is not None for x in rec["exit_s"])
    for r, st in zip(rec["nodes"], rec["stats"]):
        assert r["fallbacks"] == r["fallback_singles"] == 0
        assert r["k1_launches"] == r["k1_want"]
        assert int(st["gossip_pipelined_syncs"]) > 0  # the async engine
        assert int(st["gossip_inflight_syncs"]) >= 0
