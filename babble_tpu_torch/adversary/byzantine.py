"""ByzantineCore / ByzantineNode — a validator that lies.

Every fault the chaos layer (net/chaos.py) injects is crash/omission
shaped: links drop, duplicate, reorder. Hashgraph's BFT claim, though,
is about *malicious* validators — nodes that sign conflicting events,
forge signatures, and abuse the sync protocol. This module is that
attacker, built honestly: a real ``Core`` tracks the DAG (a Byzantine
node is just a validator running modified software), and the attack
layer on top crafts hostile payloads that ride the genuine RPC surface
(``SyncRequest``/``EagerSyncRequest``) over any transport — compose with
``ChaosTransport`` to put the adversary behind a lossy network too.

Named attacks (the ``ATTACKS`` registry; ``--byzantine <attack>`` in
demo/bombard.py picks one):

- ``equivocate`` — fork the own-creator chain at a height: two signed
  events at the same (creator, index) with different payloads. In the
  default broadcast mode both branches are eagerly pushed to every peer
  (each honest node keeps the branch it saw first, rejects the other,
  and records an :class:`~babble_tpu_torch.node.sentry.EquivocationProof`),
  branch B once every peer has acked branch A, or once a harness that
  sees every honest node hold A calls ``reveal()``;
  ``split=True`` sends branch A to one half of the peers and branch B to
  the other, alternating thereafter — the split-brain variant.
- ``replay`` — re-push stale events (own and others') over and over;
  honest nodes must shrug off the duplicates without stalling.
- ``wrong_key`` — flood events claiming this validator's identity but
  signed by a throwaway key; drives the receiver's
  ``invalid_signature`` score → quarantine.
- ``oversize`` — EagerSync batches far beyond the negotiated
  ``sync_limit``; exercises the receiving-side cap + truncation counter.
- ``lying_known`` — SyncRequests whose known-map claims total ignorance
  (provoking maximal diffs) while our own sync *responses* claim the
  same, withholding everything.
- ``garbage`` — wire events with fabricated creator ids, wild indexes
  and unparseable signatures.

The node keeps itself current by pulling from honest peers between
attack rounds (its events must decode and verify, or the attacks reduce
to noise the first junk filter eats).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from typing import Dict, List, Optional, Tuple

from ..config.config import Config
from ..crypto.keys import generate_key
from ..hashgraph.event import Event, WireBody, WireEvent
from ..hashgraph.store import Store
from ..net.rpc import (
    EagerSyncRequest,
    EagerSyncResponse,
    RPC,
    SyncRequest,
    SyncResponse,
)
from ..net.transport import Transport, TransportError
from ..node.core import Core
from ..node.validator import Validator
from ..peers.peer import Peer
from ..peers.peer_set import PeerSet
from ..proxy.proxy import dummy_commit_response

logger = logging.getLogger(__name__)


class ByzantineCore(Core):
    """A real Core plus the primitives honest software refuses to have:
    signing two events at the same height, minting wrong-key events, and
    serializing the own-creator chain with a branch substituted."""

    def __init__(
        self,
        validator: Validator,
        peers: PeerSet,
        genesis_peers: PeerSet,
        store: Store,
        clock=None,
        selector_rng=None,
    ):
        super().__init__(
            validator, peers, genesis_peers, store, dummy_commit_response,
            clock=clock, selector_rng=selector_rng,
        )
        # the second branch of a minted fork, by chain position (index)
        self.forks: Dict[int, Event] = {}

    # -- equivocation ------------------------------------------------------

    def craft_fork(
        self,
        txs_a: List[bytes],
        txs_b: List[bytes],
        other_head: str = "",
    ) -> Tuple[Event, Event]:
        """Create two signed, conflicting self-events at the next height.
        Branch A is inserted locally (our chain continues on A); branch B
        is fully wired but never inserted — our own hashgraph would
        (correctly) refuse it."""
        parents = [self.head, other_head]
        index = self.seq + 1
        ts = int(self.clock.time())
        a = Event.new(
            txs_a, [], [], parents, self.validator.public_key_bytes(), index,
            timestamp=ts,
        )
        b = Event.new(
            txs_b, [], [], parents, self.validator.public_key_bytes(), index,
            timestamp=ts,
        )
        a.sign(self.validator.key)
        b.sign(self.validator.key)
        self.insert_event_and_run_consensus(a, set_wire_info=True)
        self.hg.set_wire_info(b)
        self.forks[index] = b
        return a, b

    # -- forgeries ---------------------------------------------------------

    def craft_wrong_key(self, n: int = 3) -> List[WireEvent]:
        """Events claiming OUR identity at the next height, signed with a
        throwaway key: they decode fine (valid parents, known creator)
        and die exactly at signature verification."""
        out: List[WireEvent] = []
        mallory = generate_key()
        for i in range(n):
            ev = Event.new(
                [f"forged {i}".encode()],
                [], [],
                [self.head, ""],
                self.validator.public_key_bytes(),
                self.seq + 1,
                timestamp=int(self.clock.time()),
            )
            ev.sign(mallory)
            try:
                self.hg.set_wire_info(ev)
            except Exception:  # pragma: no cover - head race
                continue
            out.append(ev.to_wire())
        return out

    # -- chain serialization ----------------------------------------------

    def own_chain(self) -> List[Event]:
        """All of our own events in index order."""
        pub = self.validator.public_key_hex()
        try:
            hashes = self.hg.store.participant_events(pub, -1)
        except Exception:
            return []
        out = []
        for h in hashes:
            try:
                out.append(self.hg.store.get_event(h))
            except Exception:
                break
        return out

    def chain_wire(self, branch_of: Optional[int] = None) -> List[WireEvent]:
        """Our chain as wire events. With ``branch_of=i`` the chain is cut
        at height i and the stored fork's branch B substituted — the
        payload that makes an honest receiver, already holding branch A,
        raise ForkError and mint the proof."""
        chain = self.own_chain()
        if branch_of is None or branch_of not in self.forks:
            return [e.to_wire() for e in chain]
        wire = [e.to_wire() for e in chain if e.index() < branch_of]
        wire.append(self.forks[branch_of].to_wire())
        return wire


ATTACKS = (
    "equivocate",
    "replay",
    "wrong_key",
    "oversize",
    "lying_known",
    "garbage",
)


class ByzantineNode:
    """Drives a :class:`ByzantineCore` against a live cluster: an honest
    pull keeps it current, then one attack round per tick pushes hostile
    payloads. Inbound RPCs are answered adversarially (lying known-maps;
    pull responses carry the fork's second branch). Scriptable and
    seeded; counters in :meth:`stats`."""

    def __init__(
        self,
        conf: Config,
        validator: Validator,
        peers: PeerSet,
        genesis_peers: PeerSet,
        store: Store,
        trans: Transport,
        attack: str = "equivocate",
        fork_height: int = 1,
        split: bool = False,
        interval: float = 0.05,
        oversize_factor: int = 3,
        seed: int = 42,
    ):
        if attack not in ATTACKS:
            raise ValueError(f"unknown attack {attack!r}; pick from {ATTACKS}")
        self.conf = conf
        self.core = ByzantineCore(
            validator, peers, genesis_peers, store,
            clock=conf.clock,
            selector_rng=conf.seeded_rng("selector", validator.id()),
        )
        self.trans = trans
        self.attack = attack
        self.fork_height = fork_height
        self.split = split
        self.interval = interval
        self.oversize_factor = max(2, oversize_factor)
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()  # core access: attack loop vs server
        self._forked = False
        self._fork_index: Optional[int] = None  # actual forked height
        self._flip = 0  # branch alternation counter
        # broadcast-mode equivocation is two-phase: seed branch A to
        # every peer (acked eager-syncs) BEFORE revealing branch B, so
        # the honest side agrees on A and every node observes the
        # conflicting pair (split=True skips the seeding and goes
        # straight to split-brain).
        self._acked_a: set = set()
        self._revealed = False
        # counters
        self.pushes = 0
        self.push_errors = 0
        self.pulls = 0
        self.pull_errors = 0
        self.forks_minted = 0
        self.served = 0

    # -- lifecycle ---------------------------------------------------------

    def run_async(self) -> None:
        try:
            self.trans.listen()
        except Exception:  # pragma: no cover - inmem listen never fails
            pass
        for fn in (self._attack_loop, self._serve_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        try:
            self.trans.close()
        except Exception:  # pragma: no cover
            pass

    def reveal(self) -> bool:
        """Broadcast mode: reveal branch B now, without waiting for every
        peer's ack of branch A. A harness that sees every honest node hold
        branch A calls it: the acks stand in for that sight, and a peer that
        cannot ack (say, one that quarantines us for pushes whose parents it
        lacks) would hold the reveal back. Returns whether a fork was
        minted, and so revealed."""
        with self._lock:
            if self._forked:
                self._revealed = True
            return self._forked

    def fork_index(self) -> Optional[int]:
        """The height of the minted fork, None before it."""
        return self._fork_index

    def stats(self) -> Dict[str, int]:
        return {
            "byz_pushes": self.pushes,
            "byz_push_errors": self.push_errors,
            "byz_pulls": self.pulls,
            "byz_pull_errors": self.pull_errors,
            "byz_forks_minted": self.forks_minted,
            "byz_served": self.served,
        }

    # -- honest substrate --------------------------------------------------

    def _targets(self) -> List[Peer]:
        own = self.core.validator.id()
        return [p for p in self.core.peers.peers if p.id != own]

    def _pull(self, peer: Peer) -> None:
        """Stay current: an honest pull + self-event, exactly what a
        well-behaved node does — the adversary's events must keep
        decoding and verifying for its lies to reach the fork check."""
        with self._lock:
            known = self.core.known_events()
        resp = self.trans.sync(
            peer.net_addr,
            SyncRequest(self.core.validator.id(), known, self.conf.sync_limit),
        )
        with self._lock:
            try:
                self.core.sync(peer.id, resp.events)
            finally:
                self.core.record_heads()

    def _push(self, peer: Peer, events: List[WireEvent]) -> None:
        self.trans.eager_sync(
            peer.net_addr,
            EagerSyncRequest(self.core.validator.id(), events),
        )
        self.pushes += 1

    # -- attack rounds -----------------------------------------------------

    def _attack_loop(self) -> None:
        step = getattr(self, f"_step_{self.attack}")
        while not self._stop.is_set():
            targets = self._targets()
            if targets:
                peer = self._rng.choice(targets)
                try:
                    self._pull(peer)
                    self.pulls += 1
                except Exception:
                    self.pull_errors += 1
                try:
                    step(targets)
                except Exception:  # noqa: BLE001 — attacks never crash us
                    self.push_errors += 1
            self._stop.wait(self.interval)

    def _step_equivocate(self, targets: List[Peer]) -> None:
        with self._lock:
            if not self._forked and self.core.seq >= self.fork_height:
                a, _ = self.core.craft_fork(
                    [b"byz branch A"], [b"byz branch B"]
                )
                self._forked = True
                self._fork_index = a.index()
                self.forks_minted += 1
            fork_at = self._fork_index
            wire_a = self.core.chain_wire()
            wire_b = (
                self.core.chain_wire(branch_of=fork_at)
                if fork_at is not None
                else wire_a
            )
        if not self._forked:
            return  # keep gossiping honestly until the fork height
        if self.split:
            # split-brain: branch A to the first half, B to the second,
            # flipped every round so each peer eventually sees both
            half = max(1, len(targets) // 2)
            groups = (targets[:half], targets[half:])
            if self._flip % 2:
                groups = (groups[1], groups[0])
            self._flip += 1
            for group, payload in zip(groups, (wire_a, wire_b)):
                for peer in group:
                    try:
                        self._push(peer, payload)
                    except TransportError:
                        self.push_errors += 1
            return
        # broadcast mode, phase 1: seed branch A until EVERY peer acked a
        # push containing it — lossy links (chaos) or not-yet-decodable
        # parents mean a push can fail; revealing B before a peer holds A
        # would hand that peer branch B as its truth and split the honest
        # side (the wedge split=True produces on purpose).
        if not self._revealed:
            for peer in targets:
                if peer.id in self._acked_a:
                    continue
                try:
                    self._push(peer, wire_a)
                    self._acked_a.add(peer.id)
                except TransportError:
                    self.push_errors += 1
            if all(p.id in self._acked_a for p in targets):
                self._revealed = True
            return
        # phase 2: everyone holds A — reveal the conflicting branch (and
        # keep re-pushing both; receivers treat A as a duplicate and B as
        # the fork it is)
        payload = wire_b if self._flip % 2 else wire_a
        self._flip += 1
        for peer in targets:
            try:
                self._push(peer, payload)
            except TransportError:
                self.push_errors += 1

    def _step_replay(self, targets: List[Peer]) -> None:
        with self._lock:
            stale = [e.to_wire() for e in self.core.own_chain()[:5]]
        if not stale:
            return
        for peer in targets:
            try:
                self._push(peer, stale * 2)
            except TransportError:
                self.push_errors += 1

    def _step_wrong_key(self, targets: List[Peer]) -> None:
        with self._lock:
            forged = self.core.craft_wrong_key(3)
        if not forged:
            return
        for peer in targets:
            try:
                self._push(peer, forged)
            except TransportError:
                self.push_errors += 1

    def _step_oversize(self, targets: List[Peer]) -> None:
        limit = self.conf.sync_limit
        with self._lock:
            chain = self.core.chain_wire()
        if not chain:
            return
        want = limit * self.oversize_factor + 1
        batch = (chain * (want // len(chain) + 1))[:want]
        for peer in targets:
            try:
                self._push(peer, batch)
            except TransportError:
                self.push_errors += 1

    def _step_lying_known(self, targets: List[Peer]) -> None:
        lie = {p.id: -1 for p in self.core.peers.peers}
        for peer in targets:
            try:
                self.trans.sync(
                    peer.net_addr,
                    SyncRequest(
                        self.core.validator.id(), lie, self.conf.sync_limit
                    ),
                )
                self.pushes += 1
            except TransportError:
                self.push_errors += 1

    def _step_garbage(self, targets: List[Peer]) -> None:
        i = self._rng.randrange(1 << 16)
        junk = [
            WireEvent(
                body=WireBody(
                    transactions=[f"garbage {i + j}".encode()],
                    creator_id=0xBAD000 + ((i + j) % 13),
                    index=i + j,
                    self_parent_index=i + j - 1,
                    other_parent_index=-1,
                ),
                signature="3|7",
            )
            for j in range(4)
        ]
        for peer in targets:
            try:
                self._push(peer, junk)
            except TransportError:
                self.push_errors += 1

    # -- adversarial RPC service ------------------------------------------

    def _serve_loop(self) -> None:
        """Answer inbound RPCs so honest gossip at us doesn't just time
        out: pulls get the fork's second branch (when one exists) under a
        lying known-map; pushes are absorbed with a cheerful success."""
        net_q = self.trans.consumer()
        while not self._stop.is_set():
            try:
                rpc: RPC = net_q.get(timeout=0.05)
            except queue.Empty:
                continue
            self.served += 1
            try:
                self._serve_one(rpc)
            except Exception:  # noqa: BLE001
                try:
                    rpc.respond(None, "byzantine")
                except Exception:  # pragma: no cover
                    pass

    def _serve_one(self, rpc: RPC) -> None:
        cmd = rpc.command
        own_id = self.core.validator.id()
        if isinstance(cmd, SyncRequest):
            with self._lock:
                # pulls serve the second branch only once it is revealed
                # (broadcast mode seeds A first); split mode serves it
                # immediately
                serve_b = (
                    self.attack == "equivocate"
                    and self._forked
                    and (self.split or self._revealed)
                )
                events = self.core.chain_wire(
                    branch_of=self._fork_index if serve_b else None
                )
            if self.attack == "lying_known":
                events = []
            # known-map lie: claim total ignorance so the peer wastes a
            # maximal push on us (the receiving-side caps bound the harm)
            lie = {p.id: -1 for p in self.core.peers.peers}
            rpc.respond(SyncResponse(own_id, events, lie), None)
        elif isinstance(cmd, EagerSyncRequest):
            # absorb the push (ingesting what we can keeps us current)
            try:
                with self._lock:
                    self.core.sync(cmd.from_id, cmd.events)
            except Exception:  # noqa: BLE001
                pass
            rpc.respond(EagerSyncResponse(own_id, True), None)
        else:
            rpc.respond(None, "byzantine node does not serve this")
