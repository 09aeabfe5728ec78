"""Twins of tests/test_core.py: several Cores wired by calling each other's
sync directly, with no transport (reference: src/node/core_test.go):
EventDiff, Sync, Consensus, ConsensusFF, CoreFastForward, and the R2Dyn
live join (the peer-set change at round 8 and a fast-forward after the
join). Each case runs through both packages (``pkg``) on keys from a fixed
seed and asserts the reference's values.

The port's Core departs from the reference in device verification (off
here: no ``--accelerator``) and in four repairs (ROADMAP Queue C): R1 keeps
fork evidence on a later error in a sync batch, R3 flushes the offload when
an insert fails, R4 decides deferred voting before a membership change
takes effect, and R5 starts a fast-forward from the frame's last
registered peer-set. None of these cases reaches R1, R3 or R4 (no fork, no
failed insert, no offload); the two fast-forward cases pass through R5's
code with the reference's outcome.

The helpers (``init_cores``, ``sync_and_run_consensus``,
``CONSENSUS_PLAYBOOK``) are this file's own, and tests/test_torch_ingest.py
uses them."""

from __future__ import annotations

import importlib
import random
import types

import pytest

PKGS = ("babble_tpu", "babble_tpu_torch")


def _mods(pkg: str) -> types.SimpleNamespace:
    """The core's collaborators in package ``pkg``."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    hg = m("hashgraph")
    return types.SimpleNamespace(
        PrivateKey=m("crypto.keys").PrivateKey, Block=hg.Block,
        Event=hg.Event, Frame=hg.Frame, InmemStore=hg.InmemStore,
        InternalTransaction=m(
            "hashgraph.internal_transaction").InternalTransaction,
        Core=m("node.core").Core, Validator=m("node.validator").Validator,
        Peer=m("peers.peer").Peer, PeerSet=m("peers.peer_set").PeerSet,
        dummy_commit_response=m("proxy.proxy").dummy_commit_response)


CACHE_SIZE = 1000


def init_cores(pkg: str, n: int, seed: int = 0):
    """``n`` cores of package ``pkg`` on keys from ``seed`` (reference:
    core_test.go:18-67)."""
    m = _mods(pkg)
    rng = random.Random(1000 + seed)
    keys = [m.PrivateKey(rng.randrange(1, 2**255)) for _ in range(n)]
    pirs = [
        m.Peer(net_addr="", pub_key_hex=k.public_key.hex(), moniker="")
        for k in keys
    ]
    peer_set = m.PeerSet(pirs)
    genesis_peer_set = m.PeerSet(list(pirs))
    key_of = {k.public_key.id(): k for k in keys}

    cores: List[Core] = []
    index: Dict[str, str] = {}
    # cores are aligned with the peer-set's sorted order so "core i" and
    # "peer i" mean the same thing, like the reference's loop over
    # peerSet.Peers (core_test.go:36)
    for i, peer in enumerate(peer_set.peers):
        key = key_of[peer.id]
        core = m.Core(
            m.Validator(key, peer.moniker),
            peer_set,
            genesis_peer_set,
            m.InmemStore(CACHE_SIZE),
            m.dummy_commit_response,
        )
        initial = m.Event.new(
            [], [], [], ["", ""], core.validator.key.public_key.bytes(), 0
        )
        core.sign_and_insert_self_event(initial)
        cores.append(core)
        index[f"e{i}"] = core.head
    return cores, key_of, index


def synchronize_cores(cores, from_i: int, to_i: int, payload=(),
                      internal_txs=()):
    """reference: core_test.go:992-1011."""
    known_by_to = cores[to_i].known_events()
    unknown_by_to = cores[from_i].event_diff(known_by_to)
    unknown_wire = cores[from_i].to_wire(unknown_by_to)
    cores[to_i].add_transactions(list(payload))
    for itx in internal_txs:
        cores[to_i].add_internal_transaction(itx)
    cores[to_i].sync(cores[from_i].validator.id(), unknown_wire)


def sync_and_run_consensus(cores, from_i, to_i, payload=(), internal_txs=()):
    """reference: core_test.go:1013-1019."""
    synchronize_cores(cores, from_i, to_i, payload, internal_txs)
    cores[to_i].process_sig_pool()


def name_of(index, h):
    for name, v in index.items():
        if v == h:
            return name
    return h[:12]


@pytest.mark.parametrize("pkg", PKGS)
def test_event_diff(pkg):
    """reference: core_test.go:138-173."""
    m = _mods(pkg)
    cores, keys, index = init_cores(pkg, 3)

    # build P0's view: e01, e20, e12 on top of the three initial events
    for i in (1, 2):
        ev = cores[i].get_event(index[f"e{i}"])
        cores[0].insert_event_and_run_consensus(
            m.Event(ev.body, ev.signature), set_wire_info=True
        )
    e01 = m.Event.new([], [], [], [index["e0"], index["e1"]],
                    cores[0].validator.key.public_key.bytes(), 1)
    cores[0].sign_and_insert_self_event(e01)
    index["e01"] = cores[0].head

    key2 = cores[2].validator.key
    e20 = m.Event.new([], [], [], [index["e2"], index["e01"]],
                    key2.public_key.bytes(), 1)
    e20.sign(key2)
    cores[0].insert_event_and_run_consensus(e20, set_wire_info=True)
    index["e20"] = e20.hex()

    key1 = cores[1].validator.key
    e12 = m.Event.new([], [], [], [index["e1"], index["e20"]],
                    key1.public_key.bytes(), 1)
    e12.sign(key1)
    cores[0].insert_event_and_run_consensus(e12, set_wire_info=True)
    index["e12"] = e12.hex()

    known_by_1 = cores[1].known_events()
    unknown_by_1 = cores[0].event_diff(known_by_1)
    assert len(unknown_by_1) == 5
    expected_order = ["e0", "e2", "e01", "e20", "e12"]
    got = [name_of(index, e.hex()) for e in unknown_by_1]
    assert got == expected_order


@pytest.mark.parametrize("pkg", PKGS)
def test_sync(pkg):
    """reference: core_test.go:174-296 — three pairwise syncs with exact
    known-map and head-parent assertions after each."""
    cores, keys, index = init_cores(pkg, 3)
    ids = [c.validator.id() for c in cores]

    # core 1 tells core 0 everything it knows
    synchronize_cores(cores, 1, 0)
    known_by_0 = cores[0].known_events()
    assert known_by_0[ids[0]] == 1
    assert known_by_0[ids[1]] == 0
    assert known_by_0[ids[2]] == -1
    head0 = cores[0].get_head()
    assert head0.self_parent() == index["e0"]
    assert head0.other_parent() == index["e1"]
    index["e01"] = head0.hex()

    # core 0 tells core 2 everything it knows
    synchronize_cores(cores, 0, 2)
    known_by_2 = cores[2].known_events()
    assert known_by_2[ids[0]] == 1
    assert known_by_2[ids[1]] == 0
    assert known_by_2[ids[2]] == 1
    head2 = cores[2].get_head()
    assert head2.self_parent() == index["e2"]
    assert head2.other_parent() == index["e01"]
    index["e20"] = head2.hex()

    # core 2 tells core 1 everything it knows
    synchronize_cores(cores, 2, 1)
    known_by_1 = cores[1].known_events()
    assert known_by_1[ids[0]] == 1
    assert known_by_1[ids[1]] == 1
    assert known_by_1[ids[2]] == 1
    head1 = cores[1].get_head()
    assert head1.self_parent() == index["e1"]
    assert head1.other_parent() == index["e20"]
    index["e12"] = head1.hex()


CONSENSUS_PLAYBOOK = [
    # (from, to, payload)   reference: core_test.go:379-431
    (0, 1, b"e10"), (1, 2, b"e21"), (2, 0, b"e02"),
    (0, 1, b"f1"), (1, 0, b"f0"), (1, 2, b"f2"),
    (0, 1, b"f10"), (1, 2, b"f21"), (2, 0, b"f02"),
    (0, 1, b"g1"), (1, 0, b"g0"), (1, 2, b"g2"),
    (0, 1, b"g10"), (1, 2, b"g21"), (2, 0, b"g02"),
    (0, 1, b"h1"), (1, 0, b"h0"), (1, 2, b"h2"),
]


@pytest.mark.parametrize("pkg", PKGS)
def test_consensus(pkg):
    """reference: core_test.go:433-461 — 18 syncs drive round 0 to
    consensus; all three cores agree on the same 6 consensus events."""
    cores, _, _ = init_cores(pkg, 3)
    for from_i, to_i, payload in CONSENSUS_PLAYBOOK:
        sync_and_run_consensus(cores, from_i, to_i, [payload])

    c0 = cores[0].hg.store.consensus_events()
    assert len(c0) == 6
    assert cores[1].hg.store.consensus_events() == c0
    assert cores[2].hg.store.consensus_events() == c0


FF_PLAYBOOK = [
    # reference: core_test.go:437-456 (4 cores)
    (1, 2, b"e21"), (2, 3, b"e32"), (3, 1, b"e13"),
    (1, 2, b"w12"), (2, 3, b"w13"), (3, 1, b"w11"),
    (1, 2, b"f21"), (2, 3, b"w23"), (3, 2, b"w22"), (2, 1, b"w21"),
    (1, 2, b"g21"), (2, 3, b"w33"), (3, 2, b"w32"), (2, 1, b"w31"),
]


def init_ff_cores(pkg: str):
    cores, _, _ = init_cores(pkg, 4)
    for from_i, to_i, payload in FF_PLAYBOOK:
        sync_and_run_consensus(cores, from_i, to_i, [payload])
    return cores


@pytest.mark.parametrize("pkg", PKGS)
def test_consensus_ff(pkg):
    """reference: core_test.go:463-490."""
    cores = init_ff_cores(pkg)
    assert cores[1].get_last_consensus_round_index() == 1
    c1 = cores[1].hg.store.consensus_events()
    assert len(c1) == 6
    assert cores[2].hg.store.consensus_events() == c1
    assert cores[3].hg.store.consensus_events() == c1


@pytest.mark.parametrize("pkg", PKGS)
def test_core_fast_forward(pkg):
    """reference: core_test.go:492-656 — anchor-block selection and the
    signature threshold gate on fastForward, then a positive reset."""
    m = _mods(pkg)
    cores = init_ff_cores(pkg)

    # no anchor block yet
    with pytest.raises(Exception):
        cores[1].get_anchor_block_with_frame()

    block0 = cores[1].hg.store.get_block(0)

    # collect signatures of block 0 from cores 1..3
    signatures = []
    for c in cores[1:]:
        b = c.hg.store.get_block(0)
        signatures.append(c.sign_block(b))

    # only one signature: not enough for the >1/3 threshold at 4 peers
    block0.set_signature(signatures[0])
    cores[1].hg.store.set_block(block0)
    cores[1].hg.anchor_block = 0
    block, frame = cores[1].get_anchor_block_with_frame()
    with pytest.raises(Exception):
        cores[0].fast_forward(block, frame)

    # append the 2nd and 3rd signatures
    for sig in signatures[1:]:
        block0.set_signature(sig)
    cores[1].hg.store.set_block(block0)
    block, frame = cores[1].get_anchor_block_with_frame()

    # wire round-trip clears computed fields, like the reference's
    # marshal/unmarshal (core_test.go:570-573)
    frame = m.Frame.from_dict(frame.to_dict())
    block = m.Block.from_dict(block.to_dict())

    cores[0].fast_forward(block, frame)

    known_by_0 = cores[0].known_events()
    ids = [c.validator.id() for c in cores]
    assert known_by_0 == {ids[0]: -1, ids[1]: 1, ids[2]: 1, ids[3]: 1}
    assert cores[0].get_last_consensus_round_index() == 1
    assert cores[0].hg.store.last_block_index() == 0
    s_block = cores[0].hg.store.get_block(block.index())
    assert s_block.body.hash() == block.body.hash()


R2DYN_CORE_PLAYBOOK = [
    # reference: core_test.go:710-749; the itx rides play 4 (w12)
    (0, 1, b"e10", False), (1, 2, b"e21", False), (2, 0, b"e12", False),
    (0, 1, b"w11", False), (1, 2, b"w12", True), (2, 0, b"w10", False),
    (0, 1, b"f10", False), (1, 2, b"w22", False), (2, 0, b"w20", False),
    (0, 1, b"w21", False), (1, 2, b"g21", False), (2, 0, b"w30", False),
    (0, 1, b"w31", False), (1, 2, b"w32", False), (2, 1, b"h12", False),
    (1, 0, b"w40", False), (0, 1, b"w41", False), (1, 2, b"w42", False),
    (2, 1, b"i12", False), (1, 0, b"w50", False), (0, 1, b"w51", False),
    (1, 2, b"w52", False), (2, 1, b"j12", False), (1, 0, b"w60", False),
    (0, 1, b"w61", False), (1, 2, b"w62", False), (2, 1, b"k12", False),
    (1, 0, b"w70", False), (0, 1, b"w71", False), (1, 2, b"w72", False),
    (2, 1, b"l12", False), (1, 0, b"w80", False), (0, 1, b"w81", False),
    (1, 2, b"w82", False),
]


def init_r2dyn_cores(pkg: str):
    """A JoinRequest submitted at round 1, received at round 2, updating
    the peer-set at round 8 (2+6) — reference: core_test.go:697-756."""
    cores, _, _ = init_cores(pkg, 3)
    m = _mods(pkg)
    bob_key = m.PrivateKey(random.Random(2024).randrange(1, 2**255))
    bob_peer = m.Peer(net_addr="", pub_key_hex=bob_key.public_key.hex(),
                    moniker="")
    itx = m.InternalTransaction.join(bob_peer)
    itx.sign(bob_key)

    for from_i, to_i, payload, with_itx in R2DYN_CORE_PLAYBOOK:
        sync_and_run_consensus(
            cores, from_i, to_i, [payload], [itx] if with_itx else []
        )
    return cores, bob_peer, bob_key


@pytest.mark.parametrize("pkg", PKGS)
def test_r2dyn_consensus(pkg):
    """reference: core_test.go:758-786."""
    cores, _, _ = init_r2dyn_cores(pkg)
    for i, c in enumerate(cores):
        block1 = c.hg.store.get_block(1)
        assert len(block1.internal_transactions()) == 1, f"core {i}"
        receipts = block1.body.internal_transaction_receipts
        assert len(receipts) == 1, f"core {i}"
        assert receipts[0].accepted, f"core {i}"
        assert c.get_last_consensus_round_index() == 6, f"core {i}"
        ps8 = c.hg.store.get_peer_set(8)
        assert len(ps8.peers) == 4, f"core {i}"


@pytest.mark.parametrize("pkg", PKGS)
def test_core_fast_forward_after_join(pkg):
    """reference: core_test.go:788-981 — bob fast-forwards from block 0
    (below the peer-set change) and from the anchor block; both land him
    in sync with the cluster."""
    m = _mods(pkg)
    cores, bob_peer, bob_key = init_r2dyn_cores(pkg)
    init_peer_set = cores[0].hg.store.get_peer_set(0)
    genesis = m.PeerSet(list(init_peer_set.peers))

    ids = [c.validator.id() for c in cores]

    plays = []
    block0 = cores[2].hg.store.get_block(0)
    frame0 = cores[2].hg.store.get_frame(block0.round_received())
    plays.append((block0, frame0))
    anchor_block, anchor_frame = cores[2].get_anchor_block_with_frame()
    plays.append((anchor_block, anchor_frame))

    for block, frame in plays:
        bob = m.Core(
            m.Validator(bob_key, bob_peer.moniker),
            init_peer_set,
            genesis,
            m.InmemStore(CACHE_SIZE),
            m.dummy_commit_response,
        )
        bob.set_head_and_seq()
        test_cores = cores + [bob]

        # wire round-trip clears computed fields (core_test.go:860-880)
        block_w = m.Block.from_dict(block.to_dict())
        frame_w = m.Frame.from_dict(frame.to_dict())
        bob.fast_forward(block_w, frame_w)
        sync_and_run_consensus(test_cores, 2, 3)

        known_by_bob = bob.known_events()
        expected = {ids[0]: 9, ids[1]: 15, ids[2]: 10,
                    bob.validator.id(): 0}
        assert known_by_bob == expected

        # peer-sets match the donor from the frame's round upward
        for r in range(block.round_received(), 9):
            assert (
                bob.hg.store.get_peer_set(r).hash()
                == cores[2].hg.store.get_peer_set(r).hash()
            ), f"peer-set {r}"

        assert bob.get_last_consensus_round_index() == 6
        assert bob.hg.store.last_block_index() == 5
