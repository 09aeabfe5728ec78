"""The port's SweepBatcher (babble_tpu_torch/hashgraph/sweep_batcher.py):
co-located nodes' windows swept as one batch.

Twins of tests/test_sweep_batcher.py, on the CPU (K1's plain version):

- the batched sweep is bit-identical per window to the single sweep, with
  an all-invalid dummy window in the batch too, and after repadding;
- windows queued together share one sweep, mixed buckets included;
- the port's own rule replaces the JAX package's compile warm-up: a lone
  window is swept singly, two or more ride one batched sweep;
- backpressure, failure of a whole wave (the daemon survives);
- each wave pads to its own bucket (the JAX package's growing, decaying
  target keeps its compiled programs warm; the port compiles none), and
  its tickets carry the sweep's device time;
- a replay with the batcher on produces the JAX oracle's exact consensus.

The tests that need several windows in one wave hold the dispatcher —
by queueing under its lock (which is reentrant), or by keeping it inside
an earlier wave while other threads submit — so that they do not depend
on the coalescing window's timing.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from babble_tpu.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
from babble_tpu_torch.ops import voting

from tests.test_accel import BUILDERS, _ordered_events
from tests.test_torch_accel import _assert_same, _jax_replay
from tests.test_torch_voting import (
    port_events,
    port_hashgraph_like,
    replay_inserts,
)

CPU = torch.device("cpu")


def _two_windows():
    """Two same-bucket port windows from two replays of one golden DAG, the
    second without its last event so that the windows differ."""
    h0, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h0)
    like = Hashgraph(InmemStore(1000))
    like.init(peer_set)
    wins = []
    for drop in (0, 1):
        h = port_hashgraph_like(like, 1000)
        replay_inserts(h, port_events(ordered[: len(ordered) - drop]))
        wins.append(voting.build_voting_window(h))
    assert wins[0] is not None and wins[1] is not None
    return wins


def _submit_together(svc, wins):
    """Queue ``wins`` while holding the dispatcher off, so that they form
    one wave; wait for every ticket."""
    with svc._lock:
        tickets = [svc.submit(w, device="cpu") for w in wins]
    for t in tickets:
        assert t.done.wait(60)
    return tickets


def _bare_batcher():
    """A batcher without its dispatcher thread."""
    b = SweepBatcher.__new__(SweepBatcher)
    b._lock = threading.RLock()
    b._pending = []
    b._work = threading.Event()
    b.refused = 0
    return b


def test_batched_sweep_matches_single():
    """Each window of a batched sweep equals its single sweep; an
    all-invalid dummy window in the batch changes nothing (the padding a
    fixed batch size would add)."""
    wins = _two_windows()
    key = voting.bucket_key(wins[0])
    assert key == voting.bucket_key(wins[1])
    singles = [voting.run_sweep(w, CPU) for w in wins]
    for batch in (wins, wins + [voting.dummy_window(*key)] * 2):
        got = voting.read_batched(voting.launch_batched(batch, CPU), batch)
        for (f1, r1), (f2, r2) in zip(singles, got):
            np.testing.assert_array_equal(f1, f2)
            np.testing.assert_array_equal(r1, r2)
    fame, rr = voting.run_sweep(voting.dummy_window(*key), CPU)
    assert not fame.any() and (rr == -1).all()


def test_repad_window_preserves_decisions():
    """A window grown to a larger bucket (every axis) sweeps to the exact
    decisions of the original — what the batcher's wave repadding rests
    on."""
    for win in _two_windows():
        W, E, P, S, R = voting.bucket_key(win)
        grown = voting.repad_window(win, (W * 2, E * 2, P + 8, S * 2, R * 2))
        f1, r1 = voting.run_sweep(win, CPU)
        f2, r2 = voting.run_sweep(grown, CPU)
        np.testing.assert_array_equal(f1, f2[: len(f1)])
        np.testing.assert_array_equal(r1, r2[: len(r1)])


def test_batcher_coalesces_mixed_buckets():
    """Windows of different shape buckets still share one sweep: the wave
    repads to its elementwise-max bucket."""
    wins = _two_windows()
    key = voting.bucket_key(wins[0])
    big = voting.repad_window(wins[1], (key[0] * 2,) + key[1:])
    singles = [voting.run_sweep(wins[0], CPU), voting.run_sweep(big, CPU)]
    svc = SweepBatcher()
    t1, t2 = _submit_together(svc, [wins[0], big])
    assert t1.error is None and t2.error is None, (t1.error, t2.error)
    assert t1.batch_size == 2 and t2.batch_size == 2
    assert svc.batches == 1 and svc.singles == 0
    assert dict(svc.sweep_shapes) == {(2, key[0] * 2, key[2], key[3]): 1}
    for t, (f_want, r_want) in zip((t1, t2), singles):
        f_got, r_got = t.result
        np.testing.assert_array_equal(f_got, f_want[: len(f_got)])
        np.testing.assert_array_equal(r_got, r_want[: len(r_got)])


def test_batcher_backpressure_refuses_past_cap():
    win = _two_windows()[0]
    svc = _bare_batcher()
    tickets = [svc.submit(win, device="cpu")
               for _ in range(SweepBatcher.MAX_QUEUE + 3)]
    assert sum(1 for t in tickets if t is None) == 3
    assert svc.refused == 3


def test_batcher_coalesces_concurrent_submissions(monkeypatch):
    """Two nodes' threads submit while the dispatcher is busy with an
    earlier wave: both windows ride the next sweep together, each with its
    single sweep's result."""
    wins = _two_windows()
    singles = [voting.run_sweep(w, CPU) for w in wins]
    blocker = dataclasses.replace(wins[0])  # another window object
    entered, release = threading.Event(), threading.Event()
    real = voting.launch_sweep

    def held(win, device):
        if win is blocker:  # hold the dispatcher inside the first wave
            entered.set()
            assert release.wait(60)
        return real(win, device)

    monkeypatch.setattr(voting, "launch_sweep", held)
    svc = SweepBatcher()
    tb = svc.submit(blocker, device="cpu")
    assert entered.wait(60)
    tickets = []
    threads = [threading.Thread(
        target=lambda w=w: tickets.append(svc.submit(w, device="cpu")))
        for w in wins]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(svc._pending) == 2
    release.set()
    for t in [tb, *tickets]:
        assert t.done.wait(60)
        assert t.error is None, t.error
    assert tb.batch_size == 1
    assert [t.batch_size for t in tickets] == [2, 2]
    got = {id(t.win): t.result for t in tickets}
    for w, (f_want, r_want) in zip(wins, singles):
        f_got, r_got = got[id(w)]
        np.testing.assert_array_equal(f_got, f_want)
        np.testing.assert_array_equal(r_got, r_want)


def test_batcher_lone_window_single_groups_batched():
    """The port's rule: a lone window is swept singly (no repad, no
    batch), and a wave of two or more rides one batched sweep."""
    wins = _two_windows()
    svc = SweepBatcher()
    t0 = svc.submit(wins[0], device="cpu")
    assert t0.done.wait(60) and t0.error is None
    assert t0.batch_size == 1
    assert (svc.singles, svc.batches) == (1, 0)
    t1, t2 = _submit_together(svc, wins)
    assert t1.batch_size == 2 and t2.batch_size == 2
    assert (svc.singles, svc.batches, svc.windows) == (1, 1, 3)
    assert svc.max_batch_seen == 2
    np.testing.assert_array_equal(t0.result[0], t1.result[0])
    np.testing.assert_array_equal(t0.result[1], t1.result[1])


def test_batcher_dispatch_failure_fails_tickets_not_daemon(monkeypatch):
    """A device failure mid-wave fails every ticket of the wave and leaves
    the dispatcher alive for the next one."""
    wins = _two_windows()
    svc = SweepBatcher()

    def boom(*a, **k):
        raise RuntimeError("device fell off the bus")

    monkeypatch.setattr(voting, "launch_batched", boom)
    monkeypatch.setattr(voting, "launch_sweep", boom)
    t1, t2 = _submit_together(svc, wins)
    assert isinstance(t1.error, RuntimeError)
    assert isinstance(t2.error, RuntimeError)
    assert svc.windows == 0

    monkeypatch.undo()
    t3 = svc.submit(wins[0], device="cpu")
    assert t3.done.wait(30)
    assert t3.error is None
    f_want, r_want = voting.run_sweep(wins[0], CPU)
    np.testing.assert_array_equal(t3.result[0], f_want)
    np.testing.assert_array_equal(t3.result[1], r_want)


@pytest.mark.parametrize("graph", ["consensus", "funky_full"])
def test_accel_with_batcher_matches_oracle(graph):
    """A replay whose sweeps all go through the batcher commits the JAX
    oracle's exact consensus."""
    h0, _index, _nodes, peer_set = BUILDERS[graph]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)
    h = port_hashgraph_like(oracle)
    h.accel = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                              batcher=True)
    assert h.accel.resident and not h.accel.pipeline
    for ev in port_events(ordered):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    h.flush_consensus()
    assert h.accel.sweeps > 0
    assert h.accel.fallbacks == 0
    assert h.accel.stats()["batch_windows"] > 0
    _assert_same(h, oracle)


def test_wave_pads_to_its_own_bucket_not_an_earlier_larger_one():
    """A wave after an oversized one pads to its own elementwise max: no
    later batch pays for an earlier spike's rows, and the decisions stay
    those of the single sweeps."""
    wins = _two_windows()
    key = voting.bucket_key(wins[0])
    spike = (key[0] * 2, key[1] * 2) + key[2:]
    big = [voting.repad_window(w, spike) for w in wins]
    singles = [voting.run_sweep(w, CPU) for w in wins]
    svc = SweepBatcher()
    for group in (big, wins):
        tickets = _submit_together(svc, group)
        for t, (f_want, r_want) in zip(tickets, singles):
            assert t.error is None, t.error
            f_got, r_got = t.result
            np.testing.assert_array_equal(f_got[: len(f_want)], f_want)
            np.testing.assert_array_equal(r_got[: len(r_want)], r_want)
    assert dict(svc.sweep_shapes) == {(2, spike[0], key[2], key[3]): 1,
                                      (2, key[0], key[2], key[3]): 1}


@pytest.mark.parametrize("pipeline", [False, True])
def test_batcher_sweep_time_is_the_kernel_stage(pipeline):
    """Every ticket of a wave carries the device time of the sweep it
    rode (the whole batch's), and a node under the batcher records it as
    its kernel stage, synchronous or pipelined."""
    wins = _two_windows()
    tickets = _submit_together(SweepBatcher(), wins)
    assert tickets[0].device_s > 0
    assert tickets[0].device_s == tickets[1].device_s

    h0, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)
    h = port_hashgraph_like(oracle)
    h.accel = TensorConsensus(device="cpu", sweep_events=8, min_window=0,
                              pipeline=pipeline, batcher=True)
    for ev in port_events(ordered):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    acc = h.accel
    h._accel_pending = max(h._accel_pending, 1)
    h.flush_consensus()
    while acc.busy():  # pipelined: apply each landed ticket
        assert acc._inflight.ticket.done.wait(60)
        h._accel_pending = 1
        h.flush_consensus()
    assert acc.sweeps > 0 and acc.fallbacks == 0
    assert acc.stage_s["kernel"] > 0
    assert acc.total_sweep_s >= acc.stage_s["kernel"]
    _assert_same(h, oracle)


def test_batcher_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _bare_batcher().submit(_two_windows()[0], device="cpu",
                               mesh=object())
