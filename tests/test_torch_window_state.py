"""The port's resident voting windows (babble_tpu_torch/ops/window_state.py)
against a from-scratch rebuild and against the JAX package's WindowState.

Twins of tests/test_incremental_window.py, on the port: the incremental
mirrors equal a fresh ``build_voting_window`` after every mutation step and
sweep to the same decisions; stale generations are discarded, never
applied; repertoire changes and evictions rebuild; a skipped dispatch
reseeds residency; the resident paths converge to the oracle. Beyond the
twins, step by step on one event stream the port's WindowState and the JAX
package's hold equal mirrors, row maps and free-lists and pack equal deltas,
and the port's resident program (the scatter into buffers with a scratch
row, then the sweep) equals the JAX package's ``_resident_jit``. Every
comparison is exact: all of it is integers and bools.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu.ops import voting as jvoting
from babble_tpu.ops import window_state as jws
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.hashgraph.sweep_batcher import SweepBatcher
from babble_tpu_torch.ops import kernels, voting
from babble_tpu_torch.ops import window_state as ws

from tests.test_accel import BUILDERS, _ordered_events
from tests.test_incremental_window import _stream
from tests.test_torch_accel import _assert_same, _jax_replay, drain_pipelined
from tests.test_torch_voting import port_events, port_hashgraph_like

CPU = torch.device("cpu")


def _oracle(events, peers, peer_sets=()):
    """The JAX package's oracle over a stream (voting per insert)."""
    return _jax_replay(events, peers, peer_sets=peer_sets)


def _port_like(oracle):
    return port_hashgraph_like(oracle)


def _insert(h, events) -> None:
    for e in events:
        e.prevalidate(True)
        h.insert_event(e, set_wire_info=True)
        h.divide_rounds()


def _assert_equiv(state: ws.WindowState, snap_win, hg) -> None:
    """The incremental mirrors against a fresh build_voting_window:
    field-by-field equality per hash, inertness of the extra rows the
    frozen floor keeps, round and peer-set metadata over the fresh span,
    and identical sweep decisions."""
    fresh = voting.build_voting_window(hg)
    assert fresh is not None
    m = state.mirror
    P_real = len(state.pub_keys)
    assert tuple(sorted(hg.store.repertoire_by_pub_key())) == state.pub_keys
    assert fresh.base >= state.base  # the floor only rises between rebuilds

    for h, fi in fresh.row.items():
        i = state.row.get(h)
        assert i is not None, f"missing E row {h}"
        assert int(m["creator"][i]) == int(fresh.creator[fi])
        assert int(m["index"][i]) == int(fresh.index[fi])
        assert (int(m["rounds"][i]) + state.base
                == int(fresh.rounds[fi]) + fresh.base)
        assert bool(m["undet"][i]) == bool(fresh.undet[fi]), h

    for h, fw in fresh.wit_row.items():
        w = state.wit_row.get(h)
        assert w is not None, f"missing W row {h}"
        assert bool(m["valid_w"][w]) and bool(fresh.valid_w[fw])
        assert (int(m["rounds_w"][w]) + state.base
                == int(fresh.rounds_w[fw]) + fresh.base)
        assert int(m["fame0_w"][w]) == int(fresh.fame0_w[fw]), h
        assert bool(m["mid_w"][w]) == bool(fresh.mid_w[fw])
        np.testing.assert_array_equal(
            m["la_w"][w][:P_real], fresh.la_w[fw][:P_real].numpy())
        np.testing.assert_array_equal(
            m["fd_w"][w][:P_real], fresh.fd_w[fw][:P_real].numpy())
        assert int(m["wit_idx"][w]) == state.row[h]
        assert int(fresh.wit_idx[fw]) == fresh.row[h]

    # extras the frozen floor keeps must be inert: settled witnesses of
    # rounds below the fresh floor, never receivable
    for h in set(state.row) - set(fresh.row):
        w = state.wit_row.get(h)
        assert w is not None, f"extra non-witness row {h}"
        assert int(m["rounds_w"][w]) + state.base < fresh.base
        assert int(m["fame0_w"][w]) != 0, f"undecided extra witness {h}"
        assert not bool(m["undet"][state.row[h]])

    for a in range(fresh.base, hg.store.last_round() + 2):
        rf, rs = a - fresh.base, a - snap_win.base
        assert bool(fresh.exists_r[rf]) == bool(snap_win.exists_r[rs]), a
        assert bool(fresh.prior_dec_r[rf]) == bool(snap_win.prior_dec_r[rs])
        assert bool(fresh.lb_gate_r[rf]) == bool(snap_win.lb_gate_r[rs])
        assert int(fresh.sm_r[rf]) == int(snap_win.sm_r[rs]), a
        assert torch.equal(
            fresh.member[int(fresh.psi[rf])][:P_real],
            snap_win.member[int(snap_win.psi[rs])][:P_real],
        )

    fame_f, rr_f = voting.run_sweep(fresh, CPU)
    fame_s, rr_s = voting.run_sweep(snap_win, CPU)
    _assert_same_decisions(fresh, fame_f, rr_f, state, snap_win, fame_s,
                           rr_s)


def _assert_same_decisions(fresh, fame_f, rr_f, state, snap_win, fame_s,
                           rr_s) -> None:
    for h, fw in fresh.wit_row.items():
        assert int(fame_f[fw]) == int(fame_s[state.wit_row[h]]), h
    for h, fi in fresh.row.items():
        af = int(rr_f[fi])
        ai = int(rr_s[state.row[h]])
        af = af + fresh.base if af >= 0 else -1
        ai = ai + snap_win.base if ai >= 0 else -1
        assert af == ai, h


def _checked_snapshots(monkeypatch):
    """Make every WindowState snapshot assert incremental == rebuild;
    returns the count of checked snapshots (a dict)."""
    checked = {"count": 0, "slots": 0}
    orig = ws.WindowState.snapshot

    def snapshot_checked(self, hg, timers, copy_rows=False):
        snap = orig(self, hg, timers, copy_rows)
        if snap is not None:
            _assert_equiv(self, snap.win, hg)
            checked["count"] += 1
            checked["slots"] = max(checked["slots"],
                                   len(set(snap.win.psi.tolist())))
        return snap

    monkeypatch.setattr(ws.WindowState, "snapshot", snapshot_checked)
    return checked


def _resident_accel(**kw):
    return TensorConsensus(device="cpu", min_window=0, pipeline=False,
                           batcher=False, resident=True, **kw)


def _port_replay(oracle, events, accel):
    h = _port_like(oracle)
    h.accel = accel
    for ev in port_events(events):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    return h


# -- twins of tests/test_incremental_window.py --------------------------------


def test_incremental_equals_rebuild_under_churn(monkeypatch):
    """Random DAG with churn (events deciding, witnesses settling, rows
    releasing and recycling): the incremental snapshot equals a fresh
    rebuild after every mutation step, and the final consensus equals the
    JAX package's oracle."""
    events, peers, _keys = _stream(n_peers=6, n_events=160, seed=11)
    oracle = _oracle(events, peers)
    checked = _checked_snapshots(monkeypatch)
    acc = _resident_accel(sweep_events=8)
    h = _port_replay(oracle, events, acc)
    h.flush_consensus()
    assert acc.fallbacks == 0
    assert checked["count"] >= 10, "property was barely exercised"
    assert acc.rows_reused_total > acc.rows_delta_total, (
        "incremental path never amortized rows"
    )
    assert acc.window_state.rebuilds < acc.sweeps, "every sweep rebuilt"
    assert acc.delta_sweeps > 0, "no sweep ran on the resident buffers"
    _assert_same(h, oracle)


def test_incremental_equals_rebuild_with_peer_set_change(monkeypatch):
    """A peer-set change recorded at round 3 exercises the multi-slot
    psi/member machinery through the incremental path."""
    events, peers, _keys = _stream(n_peers=6, n_events=140, seed=12)
    later = [(3, peers.with_removed_peer(peers.peers[-1]))]
    oracle = _oracle(events, peers, peer_sets=later)
    checked = _checked_snapshots(monkeypatch)
    acc = _resident_accel(sweep_events=7)
    h = _port_replay(oracle, events, acc)
    h.flush_consensus()
    assert acc.fallbacks == 0
    assert checked["slots"] >= 2, "peer-set change never reached a window"
    _assert_same(h, oracle)


def test_repertoire_change_triggers_rebuild_without_divergence():
    """A peer added to the repertoire renumbers the peer columns: the next
    snapshot must rebuild (not delta) and still equal the fresh build."""
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.peers import Peer

    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=13)
    acc = _resident_accel(sweep_events=10)
    h = _port_replay(_oracle(events, peers), events, acc)
    state = acc.window_state
    assert state.mirror is not None
    r0 = state.rebuilds

    joiner = Peer("inmem://joiner", generate_key().public_key.hex(), "j")
    ps = h.store.get_peer_set(0)
    h.store.set_peer_set(h.store.last_round() + 1, ps.with_new_peer(joiner))
    snap = state.snapshot(h, {})
    assert snap is not None and snap.rebuilt
    assert state.rebuilds == r0 + 1
    assert joiner.pub_key_hex in state.pub_keys
    _assert_equiv(state, snap.win, h)


def test_round_eviction_triggers_rebuild():
    """A round readable at the last snapshot vanishing from the store (LRU
    eviction) forces a rebuild: a fresh build would have dropped its
    witnesses, so the delta mirrors no longer match."""
    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=14)
    acc = _resident_accel(sweep_events=10)
    h = _port_replay(_oracle(events, peers), events, acc)
    state = acc.window_state
    assert state.mirror is not None
    evict = state.base + 1
    assert h.store._round_cache.remove(evict)
    r0 = state.rebuilds
    snap = state.snapshot(h, {})
    assert state.rebuilds == r0 + 1
    assert snap is None or snap.rebuilt


def test_stale_generation_readback_discarded():
    """A pipelined sweep launched from generation N whose results are
    applied after generation N + 1 mutated the resident state is discarded
    by the generation check (stale_drops), the oracle carries the flush,
    and consensus converges to the oracle's exact state."""
    h0, _index, _nodes, peer_set = BUILDERS["consensus"]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)

    h = _port_like(oracle)
    h.accel = TensorConsensus(device="cpu", sweep_events=3, min_window=0,
                              pipeline=True, batcher=False, resident=True)
    for ev in port_events(ordered):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    if h.accel._inflight is None:
        h.accel._last_snapshot_topo = -1
        h._accel_pending = 1
        h.run_consensus_sweep()
    inf = h.accel._inflight
    assert inf is not None, "no sweep in flight"
    assert inf.landed()
    h.accel.window_state.mark_dirty("test-mutation")
    h._accel_pending = 1
    h.run_consensus_sweep()
    assert h.accel.stale_drops >= 1, "stale readback was not detected"

    drain_pipelined(h)
    _assert_same(h, oracle)


def test_batcher_refuses_stale_generation():
    """The batcher keys a sweep on the resident-state generation: a window
    whose state moved on is failed with StaleWindowError instead of being
    swept and applied through moved row maps."""
    events, peers, _keys = _stream(n_peers=6, n_events=100, seed=15)
    h = _port_like(_oracle(events, peers))
    _insert(h, port_events(events))
    state = ws.WindowState()
    snap = state.snapshot(h, {}, copy_rows=True)
    assert snap is not None
    state.mark_dirty("test-mutation")  # the generation moves on

    svc = SweepBatcher()
    t = svc.submit(snap.win, device="cpu")
    assert t is not None and t.done.wait(30.0)
    assert isinstance(t.error, ws.StaleWindowError)
    assert svc.windows == 0


def test_skipped_dispatch_reseeds_residency():
    """A snapshot whose delta reached the mirrors but was never dispatched
    leaves the device buffers trailing: drop_residency() must put the next
    dispatch on the full-upload path, whose decisions equal a fresh
    window's."""
    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=18)
    h = _port_like(_oracle(events, peers))
    h._accel_track_delta = True
    state = ws.WindowState()
    pev = port_events(events)

    # a big first chunk and small increments, which fit the first
    # snapshot's bucket headroom (a rebuild would bypass the path)
    cuts = (90, 100, 110)
    _insert(h, pev[:cuts[0]])
    snap = state.snapshot(h, {})
    assert snap is not None
    out, used_delta = state.dispatch(snap, CPU)
    assert used_delta is False and state.device is not None

    _insert(h, pev[cuts[0]:cuts[1]])
    snap2 = state.snapshot(h, {})
    assert snap2 is not None and not snap2.rebuilt
    assert snap2.delta is not None
    state.drop_residency()
    assert state.device is None

    _insert(h, pev[cuts[1]:cuts[2]])
    snap3 = state.snapshot(h, {})
    assert snap3 is not None
    out3, used_delta3 = state.dispatch(snap3, CPU)
    assert used_delta3 is False, "stale residency was not reseeded"
    fame_s, rr_s = voting.read_sweep(out3, snap3.win)
    fresh = voting.build_voting_window(h)
    fame_f, rr_f = voting.run_sweep(fresh, CPU)
    _assert_same_decisions(fresh, fame_f, rr_f, state, snap3.win, fame_s,
                           rr_s)


def test_resident_pipelined_matches_oracle():
    """The pipelined resident path (deltas into the resident buffers,
    deferred applies) converges to the oracle's exact consensus."""
    h0, _index, _nodes, peer_set = BUILDERS["funky_full"]()
    ordered = _ordered_events(h0)
    oracle = _jax_replay(ordered, peer_set)

    hp = _port_like(oracle)
    hp.accel = TensorConsensus(device="cpu", sweep_events=3, min_window=0,
                               pipeline=True, batcher=False, resident=True)
    for ev in port_events(ordered):
        hp.insert_event_and_run_consensus(ev, set_wire_info=True)
    drain_pipelined(hp)
    assert hp.accel.sweeps > 0
    assert hp.accel.delta_sweeps > 0
    _assert_same(hp, oracle)


def test_resident_stats_surface():
    """The resident counters ride TensorConsensus.stats() (and so the
    node's stats): rows_delta/rows_reused/rebuilds, the stale-drop counter,
    and the per-stage breakdown with the snapshot's stages."""
    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=16)
    acc = _resident_accel(sweep_events=8)
    _port_replay(_oracle(events, peers), events, acc)
    s = acc.stats()
    assert s["accel_resident"] is True
    assert s["accel_batcher"] is False
    assert s["accel_rebuilds"] >= 1
    assert s["accel_rows_delta"] > 0
    assert s["accel_rows_reused"] > 0
    assert s["accel_delta_sweeps"] > 0
    assert s["accel_stale_drops"] == 0
    for stage in ("build", "delta_scan", "pack", "dispatch", "readback",
                  "apply"):
        assert stage in s["accel_stage_ms"], stage
    assert acc.stage_s["build"] + acc.stage_s["delta_scan"] + (
        acc.stage_s["pack"]) > 0


def test_oracle_pass_marks_state_dirty():
    """A flush the oracle carries (here: the min_window gate) marks the
    resident state dirty, and the hashgraph's delta channels are drained
    per flush instead of accumulating."""
    events, peers, _keys = _stream(n_peers=6, n_events=100, seed=17)
    head, tail = events[:60], events[60:]
    acc = _resident_accel(sweep_events=10)
    h = _port_replay(_oracle(events, peers), head, acc)
    state = acc.window_state
    assert not state.dirty
    acc.min_window = 10**9  # every later flush rides the oracle
    h._accel_pending = 1
    h.run_consensus_sweep()
    assert state.dirty, "oracle pass did not invalidate the mirrors"

    for ev in port_events(tail):
        h.insert_event_and_run_consensus(ev, set_wire_info=True)
    h.flush_consensus()
    assert h._accel_new_witnesses == []
    assert h._accel_fd_dirty == set()


# -- the port's WindowState against the JAX package's --------------------------


def _jax_window_fields(win) -> dict:
    return {f: np.asarray(getattr(win, f)) for f in jvoting._WIN_FIELDS}


def _step_both(jh, ph, jstate, pstate):
    """One snapshot in both packages, compared; then each sweeps its own
    window and applies it, recording the feedback. Returns whether a
    window was taken."""
    jsnap = jstate.snapshot(jh, {})
    psnap = pstate.snapshot(ph, {})
    assert (jsnap is None) == (psnap is None)
    if jsnap is None:
        return False
    assert psnap.rebuilt == jsnap.rebuilt
    assert (psnap.rows_delta, psnap.rows_reused) == (jsnap.rows_delta,
                                                      jsnap.rows_reused)
    assert pstate.generation == jstate.generation
    assert pstate.rebuilds == jstate.rebuilds
    assert pstate.key == jstate.key and pstate.base == jstate.base
    assert pstate.row == jstate.row and pstate.wit_row == jstate.wit_row
    assert pstate.free_e == jstate.free_e and pstate.free_w == jstate.free_w
    assert pstate.undet_set == jstate.undet_set
    for f in ws.RESIDENT_FIELDS:
        np.testing.assert_array_equal(pstate.mirror[f], jstate.mirror[f],
                                      err_msg=f)
    jw = _jax_window_fields(jsnap.win)
    for f in jvoting._WIN_FIELDS:
        np.testing.assert_array_equal(getattr(psnap.win, f).numpy(), jw[f],
                                      err_msg=f)
    assert (psnap.delta is None) == (jsnap.delta is None)
    if jsnap.delta is not None:
        assert ws.delta_shape(pstate.key) == jws.delta_shape(jstate.key)
        for k, (a, b) in enumerate(zip(psnap.delta, jsnap.delta)):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=str(k))

    jfame, jrr = jvoting.run_sweep(jsnap.win)
    pfame, prr = voting.run_sweep(psnap.win, CPU)
    np.testing.assert_array_equal(pfame, jfame)
    np.testing.assert_array_equal(prr, jrr)
    _d, jf = jvoting.apply_fame(jh, jsnap.win, jfame)
    jrec = jvoting.apply_round_received(jh, jsnap.win, jrr)
    jstate.note_applied(jf, jrec)
    _d, pf = voting.apply_fame(ph, psnap.win, pfame)
    prec = voting.apply_round_received(ph, psnap.win, prr)
    pstate.note_applied(pf, prec)
    assert pf == jf and prec == jrec
    return True


def test_window_state_steps_equal_jax():
    """One stream with a peer-set change, inserted in chunks into a JAX and
    a port hashgraph: after every chunk both WindowStates take a snapshot
    (rebuild or delta alike), with equal mirrors, row maps, free-lists,
    generations, windows and delta packs, and apply equal decisions."""
    events, peers, _keys = _stream(n_peers=6, n_events=180, seed=21)
    later = peers.with_removed_peer(peers.peers[-1])
    jh = Hashgraph(InmemStore(100000))
    jh.init(peers)
    jh.store.set_peer_set(3, later)
    ph = port_hashgraph_like(jh)
    jh._accel_track_delta = ph._accel_track_delta = True
    jstate, pstate = jws.WindowState(), ws.WindowState()
    pev = port_events(events)
    steps = 0
    for lo in range(0, len(events), 9):
        for e in events[lo:lo + 9]:
            e = Event(e.body, e.signature)
            e.prevalidate(True)
            jh.insert_event(e, set_wire_info=True)
            jh.divide_rounds()
        _insert(ph, pev[lo:lo + 9])
        steps += _step_both(jh, ph, jstate, pstate)
    assert steps >= 15
    assert pstate.rebuilds < steps, "every step rebuilt"
    assert pstate.mirror["la_w"].shape[0] >= 16


def _resident_inputs(seed=22):
    """A JAX WindowState's first (full) and second (delta) snapshot of one
    stream, as numpy: (buffers, delta, fresh, key)."""
    events, peers, _keys = _stream(n_peers=6, n_events=120, seed=seed)
    jh = Hashgraph(InmemStore(100000))
    jh.init(peers)
    jh._accel_track_delta = True
    state = jws.WindowState()
    for e in events[:90]:
        e = Event(e.body, e.signature)
        e.prevalidate(True)
        jh.insert_event(e, set_wire_info=True)
        jh.divide_rounds()
    first = state.snapshot(jh, {})
    bufs = [np.array(getattr(first.win, f)) for f in jws.RESIDENT_FIELDS]
    for e in events[90:104]:
        e = Event(e.body, e.signature)
        e.prevalidate(True)
        jh.insert_event(e, set_wire_info=True)
        jh.divide_rounds()
    snap = state.snapshot(jh, {})
    assert snap is not None and snap.delta is not None
    fresh = [np.asarray(getattr(snap.win, f)) for f in jws.FRESH_FIELDS]
    return bufs, list(snap.delta), fresh, state.key


def test_resident_program_equals_jax():
    """The port's resident program on the CPU — the delta scattered into
    buffers with one scratch row each, then the sweep over their window
    rows — equals the JAX package's _resident_jit: the new buffers and the
    [fame | rr] output. The delta's padding rows land in the scratch rows
    only."""
    bufs, delta, fresh, key = _resident_inputs()
    want_bufs, want_out = jws._resident_jit(
        *(jnp.asarray(a) for a in bufs), *(jnp.asarray(a) for a in delta),
        *(jnp.asarray(a) for a in fresh))
    assert (delta[0] == key[1]).any() and (delta[5] == key[0]).any(), (
        "the delta has no padding rows")
    pbufs = [
        torch.from_numpy(np.concatenate([a, np.full(
            (1, *a.shape[1:]), ws.PAD_FILL[f], dtype=a.dtype)]))
        for f, a in zip(ws.RESIDENT_FIELDS, bufs)
    ]
    got = ws._run_resident(pbufs, [torch.from_numpy(a) for a in delta],
                           [torch.from_numpy(a) for a in fresh], True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_out))
    for f, buf, want in zip(ws.RESIDENT_FIELDS, pbufs, want_bufs):
        np.testing.assert_array_equal(buf[:-1].numpy(), np.asarray(want),
                                      err_msg=f)
        pad = np.full(buf.shape[1:], ws.PAD_FILL[f])
        np.testing.assert_array_equal(buf[-1].numpy(), pad, err_msg=f)


@pytest.mark.parametrize("pipeline", [False, True])
def test_resident_dispatch_error_marks_state_dirty(monkeypatch, pipeline):
    """Ownership of the resident buffers: a sweep that fails on them drops
    them (the state is dirty, its generation moves on) and the error
    propagates; the next snapshot rebuilds."""
    events, peers, _keys = _stream(n_peers=6, n_events=100, seed=19)
    acc = TensorConsensus(device="cpu", sweep_events=10**6, min_window=0,
                          pipeline=pipeline, batcher=False, resident=True)
    h = _port_replay(_oracle(events, peers), events, acc)

    def broken(*args):
        raise RuntimeError("cudaError_t 700")

    monkeypatch.setattr(kernels, "member_ss_counts", broken)
    gen = acc.window_state.generation
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        h.flush_consensus()
    assert acc.window_state.dirty
    assert acc.window_state.device is None
    assert acc.window_state.generation > gen
    assert acc.fallbacks == 0
