"""The PyTorch port's voting window and fused sweep against the JAX
package's, bit for bit.

The same signed events (carried over as ``EventBody.to_dict()`` pairs) go
into a JAX Hashgraph and a port Hashgraph with voting deferred; both build
their voting window, which must agree array for array (dtypes, padding,
``base`` and row maps), and the port's ``[fame | round_received]`` sweep on
the CPU must equal ``babble_tpu.ops.voting._sweep_jit`` over the whole
padded vector. Graphs: the golden DAGs of tests/test_hashgraph.py and the
random stream of ``synthetic_voting_window`` with a peer-set change (S = 2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.ops import voting as jvoting
from babble_tpu.parallel.voting_shard import synthetic_voting_window
from babble_tpu_torch import interop
from babble_tpu_torch.hashgraph import Hashgraph as PHashgraph
from babble_tpu_torch.hashgraph import InmemStore as PInmemStore
from babble_tpu_torch.ops import voting as pvoting
from babble_tpu_torch.peers import Peer as PPeer
from babble_tpu_torch.peers import PeerSet as PPeerSet

from tests.test_accel import BUILDERS, _ordered_events

CPU = torch.device("cpu")


# -- carrying state from the JAX package into the port ------------------------


def port_peer_set(ps) -> PPeerSet:
    return PPeerSet([PPeer(p.net_addr, p.pub_key_hex, p.moniker)
                     for p in ps.peers])


def port_events(events):
    """Port copies of JAX-package events, through plain dictionaries."""
    return interop.events_from_dicts(
        (e.body.to_dict(), e.signature) for e in events
    )


def port_hashgraph_like(h, cache_size: int = 100000) -> PHashgraph:
    """An empty port Hashgraph with every peer-set of ``h``'s store."""
    ph = PHashgraph(PInmemStore(cache_size))
    for r, peers in sorted(h.store.get_all_peer_sets().items()):
        ps = PPeerSet([PPeer(p.net_addr, p.pub_key_hex, p.moniker)
                       for p in peers])
        if r == 0:
            ph.init(ps)
        else:
            ph.store.set_peer_set(r, ps)
    return ph


def replay_inserts(h, events) -> None:
    """Insert + divide_rounds only (voting deferred), signatures
    pre-passed, so the window holds the whole undecided DAG."""
    for e in events:
        e.prevalidate(True)
        h.insert_event(e, set_wire_info=True)
        h.divide_rounds()


def jax_window_arrays(win) -> dict:
    return {f: np.asarray(getattr(win, f)) for f in jvoting._WIN_FIELDS}


def jax_sweep(win) -> np.ndarray:
    return np.asarray(jvoting._sweep_jit(
        *(jnp.asarray(getattr(win, f)) for f in jvoting._WIN_FIELDS)
    ))


def port_sweep(win) -> np.ndarray:
    return pvoting.launch_sweep(win, CPU).numpy()


def assert_windows_equal(pwin, jwin) -> None:
    assert pvoting.WIN_FIELDS == jvoting._WIN_FIELDS
    for f in jvoting._WIN_FIELDS:
        want = np.asarray(getattr(jwin, f))
        got = getattr(pwin, f).cpu().numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert pwin.base == jwin.base
    assert pwin.hashes == jwin.hashes
    assert pwin.row == jwin.row
    assert pwin.wit_hashes == jwin.wit_hashes
    assert pwin.wit_row == jwin.wit_row
    assert pvoting.bucket_key(pwin) == jvoting.bucket_key(jwin)


def golden_windows(name):
    """(JAX window, port window) over one golden DAG, voting deferred."""
    from babble_tpu.hashgraph import Event, Hashgraph, InmemStore

    h0, _index, _nodes, peer_set = BUILDERS[name]()
    ordered = _ordered_events(h0)
    hj = Hashgraph(InmemStore(1000))
    hj.init(peer_set)
    replay_inserts(hj, [Event(e.body, e.signature) for e in ordered])
    hp = port_hashgraph_like(hj, 1000)
    replay_inserts(hp, port_events(ordered))
    return jvoting.build_voting_window(hj), pvoting.build_voting_window(hp)


def synthetic_windows(**kw):
    h, jwin = synthetic_voting_window(**kw)
    hp = port_hashgraph_like(h)
    replay_inserts(hp, port_events(_ordered_events(h)))
    return jwin, pvoting.build_voting_window(hp)


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BUILDERS))
def test_window_and_sweep_match_jax_golden(name):
    jwin, pwin = golden_windows(name)
    assert jwin is not None and pwin is not None
    assert_windows_equal(pwin, jwin)
    np.testing.assert_array_equal(port_sweep(pwin), jax_sweep(jwin))


def test_window_and_sweep_match_jax_peer_change():
    """A random stream whose peer-set changes at round 3: two slots
    (S = 2) through K1's plain version and the psi/member machinery."""
    jwin, pwin = synthetic_windows(n_peers=6, n_events=160, seed=3,
                                   peer_change=True)
    assert pwin.member.shape[0] == 2
    assert len(set(pwin.psi.tolist())) == 2
    assert_windows_equal(pwin, jwin)
    np.testing.assert_array_equal(port_sweep(pwin), jax_sweep(jwin))


def test_window_from_arrays_sweeps_like_jax():
    """interop.window_from_arrays carries a JAX window's arrays into the
    port; the port's sweep over it equals the JAX sweep."""
    jwin, _ = synthetic_windows(n_peers=5, n_events=120, seed=5,
                                peer_change=True)
    meta = {"base": jwin.base, "hashes": jwin.hashes,
            "wit_hashes": jwin.wit_hashes}
    pwin = interop.window_from_arrays(jax_window_arrays(jwin), meta,
                                      device="cpu")
    assert pwin.row == jwin.row and pwin.wit_row == jwin.wit_row
    np.testing.assert_array_equal(port_sweep(pwin), jax_sweep(jwin))
    bad = jax_window_arrays(jwin)
    bad["la_w"] = bad["la_w"].astype(np.int64)
    with pytest.raises(TypeError):
        interop.window_from_arrays(bad, meta, device="cpu")


def test_repad_window_matches_jax():
    """Growing a window to a larger bucket pads exactly as the JAX package
    does, and leaves the real rows' decisions unchanged."""
    jwin, pwin = golden_windows("consensus")
    W, E, P, S, R = jvoting.bucket_key(jwin)
    key = (2 * W, 2 * E, P + 8, 2 * S, 2 * R)
    jbig = jvoting.repad_window(jwin, key)
    pbig = pvoting.repad_window(pwin, key)
    assert_windows_equal(pbig, jbig)
    got = port_sweep(pbig)
    np.testing.assert_array_equal(got, jax_sweep(jbig))
    fame, rr = pvoting.read_sweep(got, pbig)
    fame0, rr0 = pvoting.read_sweep(port_sweep(pwin), pwin)
    np.testing.assert_array_equal(fame[:W], fame0)
    np.testing.assert_array_equal(rr[:E], rr0)


def test_batched_sweep_matches_single_and_jax_vmap():
    """Windows of three different shape buckets (golden DAGs and a
    peer-set change, so S = 2), repadded to their elementwise-max bucket as
    the sweep batcher does and swept as one batch: each row equals the
    port's single sweep of that window (and of the unpadded window on its
    real rows), and the whole [B, W + E] output equals the JAX package's
    vmapped sweep (``_batched_sweep_jit``) over the same stacked windows."""
    pairs = [golden_windows("consensus"), golden_windows("funky_full"),
             synthetic_windows(n_peers=6, n_events=160, seed=3,
                               peer_change=True)]
    keys = [jvoting.bucket_key(j) for j, _ in pairs]
    assert len(set(keys)) == 3
    target = tuple(max(k[d] for k in keys) for d in range(5))
    jwins = [jvoting.repad_window(j, target) for j, _ in pairs]
    pwins = [pvoting.repad_window(p, target) for _, p in pairs]
    for pw, jw in zip(pwins, jwins):
        assert_windows_equal(pw, jw)

    # both orders: a window must take its own round's peer-set slot, not
    # its neighbour's
    rev = pvoting.launch_batched(pwins[::-1], CPU).numpy()
    got = pvoting.launch_batched(pwins, CPU).numpy()
    np.testing.assert_array_equal(rev, got[::-1])
    # the batcher's path: unpadded windows, padded to the target as stacked
    raw = [p for _, p in pairs]
    np.testing.assert_array_equal(
        pvoting.launch_batched(raw, CPU, target).numpy(), got)
    for (fame, rr), p, pw in zip(
            pvoting.read_batched(got, raw, target), raw, pwins):
        f1, r1 = pvoting.read_sweep(port_sweep(pw), pw)
        np.testing.assert_array_equal(fame, f1[:p.n_witnesses])
        np.testing.assert_array_equal(rr, r1[:p.n_events])
    want = np.asarray(jvoting._batched_sweep_jit(*(
        jnp.asarray(np.stack([np.asarray(getattr(w, f)) for w in jwins]))
        for f in jvoting._WIN_FIELDS
    )))
    np.testing.assert_array_equal(got, want)
    for row, pw, (_j, p) in zip(got, pwins, pairs):
        np.testing.assert_array_equal(row, port_sweep(pw))
        fame, rr = pvoting.read_sweep(row, pw)
        fame0, rr0 = pvoting.read_sweep(port_sweep(p), p)
        np.testing.assert_array_equal(fame[:p.n_witnesses], fame0)
        np.testing.assert_array_equal(rr[:p.n_events], rr0)
    for (fame, rr), pw in zip(pvoting.read_batched(got, pwins), pwins):
        f1, r1 = pvoting.read_sweep(port_sweep(pw), pw)
        np.testing.assert_array_equal(fame, f1)
        np.testing.assert_array_equal(rr, r1)
