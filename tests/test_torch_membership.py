"""The port's offload under dynamic membership and fast-sync, against the
JAX package.

Twins of the JAX package's accelerated membership tests:

- tests/test_hashgraph_dyn.py (``SCRIPTS``, ``_preregister``, the
  ``test_dyn_accel_*`` cases): the golden r2dyn, usurper and monologue
  fixtures, whose windows span up to three peer-set slots, through the
  port's TensorConsensus on the CPU synchronously, pipelined (drained
  through its in-flight sweeps), through the sweep batcher and on meshes of
  2, 4 and 8 virtual CPU shards. The fixtures are built here from port
  classes; the same signed events and peer-sets then go, as plain data,
  through the JAX package's oracle and its offload in the same form, and
  everything consensus decides must be equal bit for bit.
- tests/test_node_churn.py::test_churn_with_accelerator: three port nodes
  with the pipelined offload, a joiner, then a polite leave mid-pipeline.
- tests/test_node_fastsync.py::test_catch_up with the offload on every
  node: the late node fast-forwards, its offload decides again after the
  reset, and its blocks from the anchor on equal its peers'.
"""

from __future__ import annotations

import functools
import time

import pytest

import chip_smoke
from babble_tpu.crypto.canonical import canonical_dumps as j_dumps
from babble_tpu.hashgraph import Event as JEvent
from babble_tpu.hashgraph.accel import TensorConsensus as JTensorConsensus
from babble_tpu.hashgraph.event import EventBody as JEventBody
from babble_tpu.parallel.mesh import consensus_mesh as jax_mesh
from babble_tpu.peers.peer import Peer as JPeer
from babble_tpu.peers.peer_set import PeerSet as JPeerSet
from babble_tpu_torch.config.config import Config
from babble_tpu_torch.crypto.canonical import canonical_dumps as p_dumps
from babble_tpu_torch.dummy.state import State as DummyState
from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore
from babble_tpu_torch.hashgraph.accel import TensorConsensus
from babble_tpu_torch.net.inmem import InmemNetwork
from babble_tpu_torch.node.node import Node
from babble_tpu_torch.node.state import State
from babble_tpu_torch.node.validator import Validator
from babble_tpu_torch.parallel import consensus_mesh
from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet
from babble_tpu_torch.proxy.proxy import InmemProxy

from tests.test_accel import drain_pipelined as jax_drain_pipelined
from tests.test_hashgraph_dyn import (
    MONOLOGUE_PLAYS,
    R2DYN_PLAYS_1,
    R2DYN_PLAYS_2,
    R2DYN_PLAYS_3,
    USURPER_PLAYS_2,
)
from tests.test_hashgraph_dyn import _build as jax_build
from tests.test_torch_accel import consensus_state, drain_pipelined
from tests.test_torch_node import bombard_and_wait, make_nodes

CACHE_SIZE = 100  # tests/test_hashgraph.py's, which the JAX fixtures use


# -- the golden dynamic-membership fixtures, built from port classes --------


SCRIPTS = list(chip_smoke.DYN_FIXTURES)


@functools.lru_cache(maxsize=None)
def _script(name: str):
    """The fixture's steps, built by ``chip_smoke.dyn_fixture`` from port
    classes, peer-set registrations first (the JAX package's
    ``_preregister``: live nodes register peer-sets through the consensus
    order itself, so a frame's peer-set snapshot must not depend on when a
    sweep builds it)."""
    events, genesis, peer_sets = chip_smoke.dyn_fixture(name, seed=0)
    return ([("peerset", 0, genesis)]
            + [("peerset", r, ps) for r, ps in peer_sets]
            + [("insert", e) for e in events])


def test_dyn_plays_are_the_jax_fixtures():
    """chip_smoke's copies of the fixtures' plays are the JAX test's."""
    assert chip_smoke.DYN_R2_1 == R2DYN_PLAYS_1
    assert chip_smoke.DYN_R2_2 == R2DYN_PLAYS_2
    assert chip_smoke.DYN_R2_3 == R2DYN_PLAYS_3
    assert chip_smoke.DYN_USURPER_2 == USURPER_PLAYS_2
    assert chip_smoke.DYN_MONOLOGUE == MONOLOGUE_PLAYS


def _jax_steps(steps):
    """The same steps as JAX-package objects, through plain data."""
    out = []
    for step in steps:
        if step[0] == "peerset":
            _, rnd, ps = step
            out.append(("peerset", rnd, JPeerSet(
                [JPeer(p.net_addr, p.pub_key_hex, p.moniker)
                 for p in ps.peers])))
        else:
            ev = step[1]
            out.append(("insert", JEvent(
                JEventBody.from_dict(ev.body.to_dict()), ev.signature)))
    return out


def _port_build(steps, accel=None) -> Hashgraph:
    """tests/test_hashgraph_dyn.py::_build(run_consensus=True) through the
    port: fresh events per replay, voting per insert or by ``accel``."""
    h = Hashgraph(InmemStore(CACHE_SIZE))
    first = True
    for step in steps:
        if step[0] == "peerset":
            _, rnd, ps = step
            if first:
                h.init(ps)
                first = False
            else:
                h.store.set_peer_set(rnd, ps)
            if accel is not None:
                h.accel = accel
        else:
            h.insert_event_and_run_consensus(
                Event(step[1].body, step[1].signature), set_wire_info=True)
    h.flush_consensus()
    return h


# the four forms, as TensorConsensus options of both packages
FORMS = {
    "sync": {"pipeline": False},
    "pipelined": {"pipeline": True},
    "batcher": {"pipeline": False, "batcher": True},
    "mesh2": {"pipeline": False, "mesh": 2},
    "mesh4": {"pipeline": False, "mesh": 4},
    "mesh8": {"pipeline": False, "mesh": 8},
}


@functools.lru_cache(maxsize=None)
def _jax_state(name: str, form: str | None):
    """The JAX package's oracle (``form`` None) or its offload in ``form``
    on the fixture, as consensus_state."""
    steps = _jax_steps(_script(name))
    if form is None:
        return consensus_state(jax_build(steps, run_consensus=True), j_dumps)
    kw = dict(FORMS[form])
    if "mesh" in kw:
        kw["mesh"] = jax_mesh(kw["mesh"])
    accel = JTensorConsensus(sweep_events=3, async_compile=False,
                             min_window=0, **kw)
    h = jax_build(steps, accel=accel, run_consensus=True)
    if kw["pipeline"]:
        jax_drain_pipelined(h)
    assert accel.sweeps > 0 and accel.fallbacks == 0
    return consensus_state(h, j_dumps)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("script", SCRIPTS)
def test_dyn_fixture_offload_matches_oracle_and_jax(script, form):
    """The port's offload in each form decides every event, round and
    block of the fixture as its own host oracle does, and as the JAX
    package's oracle and offload in the same form do."""
    steps = _script(script)
    kw = dict(FORMS[form])
    if "mesh" in kw:
        kw["mesh"] = consensus_mesh(kw["mesh"], devices=["cpu"] * kw["mesh"])
    accel = TensorConsensus(device="cpu", sweep_events=3, min_window=0,
                            **kw)
    port = _port_build(steps, accel=accel)
    if accel.pipeline:
        drain_pipelined(port)
    assert accel.sweeps > 0, "device sweep never ran"
    assert accel.fallbacks == 0 and accel.mesh_fallbacks == 0
    assert not accel.busy()
    if "mesh" in kw:
        assert accel.stats()["accel_mesh"] is not None
    got = consensus_state(port, p_dumps)
    assert got == consensus_state(_port_build(steps), p_dumps), "port oracle"
    assert got == _jax_state(script, None), "JAX package's oracle"
    assert got == _jax_state(script, form), "JAX package's offload"


@pytest.mark.parametrize("script", ["r2dyn", "usurper"])
def test_dyn_fixture_full_window_builds_match(script):
    """Without resident windows (a from-scratch window build and upload each
    sweep) the offload decides the same, synchronous and pipelined."""
    steps = _script(script)
    for pipeline in (False, True):
        accel = TensorConsensus(device="cpu", sweep_events=3, min_window=0,
                                resident=False, pipeline=pipeline)
        port = _port_build(steps, accel=accel)
        if pipeline:
            drain_pipelined(port)
        assert accel.sweeps > 0 and accel.fallbacks == 0
        assert consensus_state(port, p_dumps) == _jax_state(script, None)


def test_dyn_fixtures_span_three_peer_set_slots():
    """The r2dyn fixture's windows carry the three peer-sets at once (S 3,
    padded to the bucket's 4), which is what makes it the twin of the
    kernel's multi-slot path."""
    from babble_tpu_torch.ops import voting

    steps = _script("r2dyn")
    h = Hashgraph(InmemStore(CACHE_SIZE))
    for step in steps:
        if step[0] == "peerset":
            if step[1] == 0:
                h.init(step[2])
            else:
                h.store.set_peer_set(step[1], step[2])
        else:
            ev = Event(step[1].body, step[1].signature)
            ev.prevalidate(True)
            h.insert_event(ev, set_wire_info=True)
            h.divide_rounds()
    win = voting.build_voting_window(h)
    W, E, P, S, R = voting.bucket_key(win)
    assert S == 4 and len(h.store.get_all_peer_sets()) == 3


# -- live clusters with the offload ------------------------------------------


def wait_until(pred, timeout: float, msg: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"timeout: {msg}")
        time.sleep(0.05)


def check_gossip(nodes, from_block: int, to_block: int) -> None:
    """Byte-identical block bodies (tests/test_node.py::check_gossip)."""
    for bi in range(from_block, to_block + 1):
        ref = nodes[0].get_block(bi).body.hash()
        for n in nodes[1:]:
            assert n.get_block(bi).body.hash() == ref, f"block {bi} differs"


def check_peer_sets(nodes, timeout: float = 30.0) -> None:
    """tests/test_node_churn.py::check_peer_sets."""
    wait_until(lambda: len({n.core.peers.hash() for n in nodes}) == 1,
               timeout, "peer sets never converged: " + ", ".join(
                   f"{n.get_id()}={len(n.core.peers.peers)}" for n in nodes))


class Bombardier:
    """Background load (tests/test_node_dyn.py::Bombardier)."""

    def __init__(self, proxies, interval: float = 0.005):
        import threading

        self.proxies = proxies
        self.interval = interval
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._i = 0

    def start(self):
        self._t.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.proxies[self._i % len(self.proxies)].submit_tx(
                f"dyn tx {self._i}".encode())
            self._i += 1
            time.sleep(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._t.is_alive():
            self._t.join(timeout=2.0)


def make_extra_node(network, current_peers, genesis_peers, name: str,
                    **conf_kw):
    """A port node whose key is not in ``current_peers``: it must join
    (tests/test_node_dyn.py::make_extra_node)."""
    from babble_tpu_torch.crypto.keys import generate_key

    conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                  moniker=name, log_level="warning", join_timeout=30.0,
                  **conf_kw)
    proxy = InmemProxy(DummyState())
    node = Node(conf, Validator(generate_key(), name), current_peers,
                genesis_peers, InmemStore(conf.cache_size),
                network.new_transport(f"inmem://{name}"), proxy)
    node.init()
    return node, proxy


def _pipelined_offload(node) -> TensorConsensus:
    """The offload the JAX test forces on every node: pipelined, every
    window on the device."""
    node.core.hg.accel = TensorConsensus(device="cpu", min_window=0,
                                         pipeline=True)
    return node.core.hg.accel


def test_churn_storm_with_offload():
    """tests/test_node_churn.py::test_churn_with_accelerator on the port:
    three nodes with the pipelined offload on the CPU, a joiner with it,
    then a polite leave mid-pipeline; blocks identical, peer sets equal,
    node 0 equal to a host replay, sweeps on every live node and no
    fallback."""
    network = InmemNetwork()
    nodes, proxies = make_nodes(3, network, accelerator=True,
                                accelerator_device="cpu")
    genesis = nodes[0].core.genesis_peers
    accels = [_pipelined_offload(n) for n in nodes]
    joiner = None
    bomb = Bombardier(proxies).start()
    try:
        for n in nodes:
            n.run_async()
        bombard_and_wait(nodes, proxies, 2, timeout=90.0)
        check_gossip(nodes, 0, 2)

        joiner, _jp = make_extra_node(
            network, PeerSet(list(nodes[0].core.peers.peers)), genesis,
            "accel-joiner", accelerator=True, accelerator_device="cpu")
        accels.append(_pipelined_offload(joiner))
        joiner.run_async()
        wait_until(lambda: joiner.get_state() == State.BABBLING, 90.0,
                   "joiner never reached BABBLING")
        live = nodes + [joiner]
        target = nodes[0].get_last_block_index() + 3
        bombard_and_wait(live, proxies, target, timeout=90.0)
        check_gossip(live, 0, target)
        check_peer_sets(live)
        assert joiner.get_id() in nodes[0].core.validators.by_id

        nodes[2].conf.join_timeout = 120.0
        nodes[2].leave()
        live = [nodes[0], nodes[1], joiner]
        target = live[0].get_last_block_index() + 3
        bombard_and_wait(live, proxies[:2], target, timeout=90.0)
        check_gossip(live, 0, target)
        check_peer_sets(live)
        assert nodes[2].get_id() not in nodes[0].core.validators.by_id
        assert len(nodes[0].core.validators.peers) == 3
    finally:
        bomb.stop()
        for n in nodes:
            n.shutdown()
        if joiner is not None:
            joiner.shutdown()
    assert chip_smoke.replay_own_events("churn", nodes[0]) > 0
    assert all(a.sweeps > 0 for a in accels[:2] + accels[3:]), (
        "a live node's offload never swept")
    assert sum(a.fallbacks for a in accels) == 0


def _membership_history(seed: int, join_after: int, n: int = 4,
                        n_events: int = 400, add_at: int = 8):
    """A seeded gossip history of ``n`` genesis validators in which event
    ``add_at`` carries a signed PEER_ADD for one more key, which starts to
    create events once the host oracle that replays the history as it is
    made (``chip_smoke.membership_hashgraph``: the node core's membership
    rule) has registered it and its DAG has gone ``join_after`` rounds past
    the join's effective round. Returns (events, genesis, the oracle's
    hashgraph, the effective round)."""
    import random

    from babble_tpu_torch.crypto.keys import PrivateKey
    from babble_tpu_torch.crypto.secp256k1 import N as CURVE_N
    from babble_tpu_torch.hashgraph.internal_transaction import (
        InternalTransaction,
    )

    rng = random.Random(seed)
    keys = [PrivateKey(rng.randrange(1, CURVE_N)) for _ in range(n + 1)]
    genesis = PeerSet([Peer(f"inmem://m{i}", k.public_key.hex(), f"m{i}")
                       for i, k in enumerate(keys[:n])])
    newcomer = keys[n].public_key.hex()
    itx = InternalTransaction.join(Peer(f"inmem://m{n}", newcomer, f"m{n}"))
    itx.sign(keys[n])
    oracle = chip_smoke.membership_hashgraph(genesis)
    heads, seqs, events = [""] * (n + 1), [-1] * (n + 1), []

    def effective():
        for r, ps in oracle.store.get_all_peer_sets().items():
            if any(p.pub_key_hex == newcomer for p in ps):
                return r
        return None

    while len(events) < n_events:
        r = effective()
        active = list(range(n)) + (
            [n] if r is not None
            and oracle.store.last_round() >= r + join_after else [])
        i = rng.choice(active)
        others = [j for j in active if j != i and heads[j]]
        if events and not others:
            continue
        op = heads[rng.choice(others)] if events else ""
        e = Event.new([rng.randbytes(16)],
                      [itx] if len(events) == add_at else [], [],
                      [heads[i], op], keys[i].public_key.bytes(),
                      seqs[i] + 1, timestamp=len(events))
        e.sign(keys[i])
        heads[i], seqs[i] = e.hex(), seqs[i] + 1
        events.append(e)
        oracle.insert_event_and_run_consensus(Event(e.body, e.signature),
                                              set_wire_info=True)
    assert effective() is not None and seqs[n] >= 10, "the join never landed"
    return events, genesis, oracle, effective()


def _same_chain(h, oracle) -> None:
    last = oracle.store.last_block_index()
    assert last >= 4 and h.store.last_block_index() >= last
    for bi in range(last + 1):
        assert (h.store.get_block(bi).body.hash()
                == oracle.store.get_block(bi).body.hash()), f"block {bi}"


def test_offload_decides_before_a_membership_change_takes_effect():
    """A history with a join, inserted in one batch into a hashgraph whose
    pipelined offload never sweeps on its own (``sweep_events`` out of
    reach): the offload must decide, and the join register, before the DAG
    reaches the join's effective round, as the reference's per-insert
    voting does. The newcomer's first event, which comes well after that
    round, then inserts, and the chain equals the oracle's."""
    events, genesis, oracle, _r = _membership_history(21, join_after=4)
    h = chip_smoke.membership_hashgraph(genesis)
    h.accel = TensorConsensus(device="cpu", min_window=0, pipeline=True,
                              sweep_events=10**9)
    for ev in events:
        h.insert_event_and_run_consensus(Event(ev.body, ev.signature),
                                         set_wire_info=True)
    drain_pipelined(h)
    assert h.accel.sweeps > 0 and h.accel.fallbacks == 0
    _same_chain(h, oracle)


# events a gossip sync carries in the replays below: small, so that the
# observer's decisions keep close to its DAG between syncs
SYNC_BATCH = 16


def test_sync_flushes_the_offload_when_an_insert_fails(monkeypatch):
    """Core.sync over a history whose newcomer's first event comes right
    after its join is registered, with the membership rule above out of
    the way: the observer's pipelined offload has not decided that join
    when the newcomer's event arrives, so the sync stops there. It flushes
    the offload before the error propagates, and so the gossip that
    retries (the peer resends what the node lacks, SYNC_BATCH events a
    sync) gets past it; the observer's chain equals the oracle's."""
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.node.core import Core

    events, genesis, oracle, _r = _membership_history(22, join_after=0)
    core = Core(Validator(generate_key(), "observer"), genesis, genesis,
                InmemStore(100_000), DummyState().commit_handler)
    core.accepted_round = 10**9  # an observer: no self-events
    core.hg.accel = TensorConsensus(device="cpu", min_window=0,
                                    pipeline=True, sweep_events=10**9)
    monkeypatch.setattr(core.hg, "_membership_change_due", lambda: False)
    flushes = []
    real_flush = core.hg.flush_consensus

    def flush():
        flushes.append(core.hg.topological_index)
        real_flush()

    monkeypatch.setattr(core.hg, "flush_consensus", flush)
    wire = [oracle.store.get_event(ev.hex()).to_wire() for ev in events]
    first = next(i for i, ev in enumerate(events)
                 if ev.creator() not in genesis.by_pub_key)
    from_id = genesis.peers[1].id
    with pytest.raises(Exception, match="not found"):
        core.sync(from_id, wire[:first + 1])
    assert flushes == [first], "no flush before the error propagated"
    for _attempt in range(50):
        known = core.known_events()
        lacking = [w for w in wire
                   if w.body.index > known.get(w.body.creator_id, -1)]
        if not lacking:
            break
        try:
            core.sync(from_id, lacking[:SYNC_BATCH])
        except Exception as err:
            assert "not found" in str(err)
    else:
        pytest.fail("the observer never got past the newcomer's event")
    drain_pipelined(core.hg)
    assert core.hg.accel.fallbacks == 0
    _same_chain(core.hg, oracle)


def test_fast_forward_starts_from_the_latest_registered_peer_set(
        monkeypatch):
    """A fast-forward whose anchor frame is at round 5 while a leave
    committed earlier is registered for round 9: the core's validators and
    gossip peers are the registered set of round 9, the set the anchor
    block's committers held (the anchor block's own membership receipts
    then apply to it, as on every other node), not the set in effect at
    round 5."""
    from babble_tpu_torch.crypto.keys import generate_key
    from babble_tpu_torch.hashgraph.block import Block
    from babble_tpu_torch.hashgraph.frame import Frame
    from babble_tpu_torch.node.core import Core

    keys = [generate_key() for _ in range(4)]
    genesis = PeerSet([Peer(f"inmem://f{i}", k.public_key.hex(), f"f{i}")
                       for i, k in enumerate(keys)])
    later = genesis.with_removed_peer(genesis.peers[3])
    core = Core(Validator(keys[0], "f0"), genesis, genesis, InmemStore(1000),
                DummyState().commit_handler)
    frame = Frame(round=5, peers=genesis, roots={}, events=[],
                  peer_sets={0: genesis.peers, 9: later.peers}, timestamp=0)
    block = Block.new(3, 5, frame.hash(), genesis, [], [], 0)
    monkeypatch.setattr(core.hg, "check_block", lambda b, ps: None)
    monkeypatch.setattr(core.hg, "reset", lambda b, f: None)
    core.fast_forward(block, frame)
    assert core.validators.hash() == later.hash()
    assert core.peers.hash() == later.hash()


def test_successive_joins_with_offload():
    """Two joins in turn with the pipelined offload on every node: the
    second joiner replays from genesis a history that holds the first
    join, whose events it can insert only once it has committed the block
    that registers that joiner. Every node ends with the same blocks, the
    joiners' from block 0, equal to node 0's host replay, with no
    fallback. (Without a flush when a sync's insert fails, the second
    joiner stalls on the first joiner's events; without deciding before a
    membership change takes effect, it divides rounds under a peer-set
    not yet registered and forks.)"""
    network = InmemNetwork()
    nodes, proxies = make_nodes(3, network, accelerator=True,
                                accelerator_device="cpu")
    genesis = nodes[0].core.genesis_peers
    for n in nodes:
        _pipelined_offload(n)
    joiners = []
    bomb = Bombardier(proxies).start()
    try:
        for n in nodes:
            n.run_async()
        bombard_and_wait(nodes, proxies, 2, timeout=90.0)
        for k in range(2):
            joiner, _jp = make_extra_node(
                network, PeerSet(list(nodes[0].core.peers.peers)), genesis,
                f"joiner{k}", accelerator=True, accelerator_device="cpu")
            _pipelined_offload(joiner)
            joiners.append(joiner)
            joiner.run_async()
            wait_until(lambda j=joiner: j.get_state() == State.BABBLING,
                       90.0, f"joiner {k} never reached BABBLING")
            live = nodes + joiners
            target = nodes[0].get_last_block_index() + 3
            bombard_and_wait(live, proxies, target, timeout=90.0)
            check_gossip(live, 0, target)
        check_peer_sets(live)
    finally:
        bomb.stop()
        for n in nodes + joiners:
            n.shutdown()
    assert chip_smoke.replay_own_events("joins", nodes[0]) > 0
    assert all(n.core.hg.accel.sweeps > 0 for n in nodes + joiners)
    assert sum(n.core.hg.accel.fallbacks for n in nodes + joiners) == 0


def _lazy_cluster(n: int, network: InmemNetwork):
    """n keys and peers, nodes built on demand with their own Config
    (tests/test_node_fastsync.py::make_lazy_cluster), each with the
    offload on the CPU."""
    from babble_tpu_torch.crypto.keys import generate_key

    keys = [generate_key() for _ in range(n)]
    peers = PeerSet([Peer(f"inmem://fs{i}", k.public_key.hex(), f"fs{i}")
                     for i, k in enumerate(keys)])
    addr_of = {p.pub_key_hex: p.net_addr for p in peers.peers}

    def build(i: int, **conf_kw):
        k = keys[i]
        conf = Config(heartbeat_timeout=0.02, slow_heartbeat_timeout=0.2,
                      moniker=f"fs{i}", log_level="warning",
                      accelerator=True, accelerator_device="cpu", **conf_kw)
        proxy = InmemProxy(DummyState())
        node = Node(conf, Validator(k, f"fs{i}"), peers, peers,
                    InmemStore(conf.cache_size),
                    network.new_transport(addr_of[k.public_key.hex()]), proxy)
        node.init()
        _pipelined_offload(node)
        return node, proxy

    return build


def test_fast_sync_catch_up_with_offload():
    """tests/test_node_fastsync.py::test_catch_up with the offload on every
    node: the late node fast-forwards (its ``fast_forwards`` stat moves),
    the reset drops its offload's state, its offload then sweeps again
    with no fallback, and its blocks from the anchor on are its peers'."""
    network = InmemNetwork()
    build = _lazy_cluster(4, network)
    trio = [build(i) for i in range(3)]
    nodes = [n for n, _ in trio]
    proxies = [p for _, p in trio]
    bomb = Bombardier(proxies).start()
    late = None
    try:
        for n in nodes:
            n.run_async()
        wait_until(lambda: any(
            n.core.hg.anchor_block is not None and n.core.hg.anchor_block >= 1
            for n in nodes) and min(n.get_last_block_index()
                                    for n in nodes) >= 2,
            60.0, "cluster never formed an anchor")

        late, lproxy = build(3, enable_fast_sync=True)
        assert late.get_state() == State.CATCHING_UP
        late_accel = late.core.hg.accel
        assert late.get_stats_snapshot()["fast_forwards"] == 0
        late.run_async()
        wait_until(lambda: late.get_state() == State.BABBLING
                   and late.get_last_block_index() >= 0, 60.0,
                   "late node never caught up")
        assert late.get_stats_snapshot()["fast_forwards"] == 1
        snapshot_block = late.get_last_block_index()
        assert snapshot_block >= 1, "the late node did not land on an anchor"
        with pytest.raises(Exception):
            late.get_block(0)  # its store starts at the anchor frame
        sweeps_at_reset = late_accel.sweeps
        bomb.stop()

        everyone = nodes + [late]
        target = max(n.get_last_block_index() for n in everyone) + 2
        bombard_and_wait(everyone, proxies + [lproxy], target, timeout=90.0)
        check_gossip(everyone, snapshot_block, target)
        assert late_accel is late.core.hg.accel
        assert late_accel.sweeps > sweeps_at_reset, (
            "the late node's offload never decided after the reset")
    finally:
        bomb.stop()
        for n in nodes:
            n.shutdown()
        if late is not None:
            late.shutdown()
    for n in nodes + [late]:
        assert n.core.hg.accel.fallbacks == 0
    assert all(n.core.hg.accel.sweeps > 0 for n in nodes)
