"""Sim harness: REAL nodes driven as scheduler events.

This is the layer that makes the simulation honest: the objects under
test are the production :class:`~babble_tpu_torch.node.node.Node` and
:class:`~babble_tpu_torch.adversary.byzantine.ByzantineNode` — same gossip
legs, same RPC handlers, same mempool/sentry/selector/telemetry — with
exactly three substitutions:

1. the node ``Clock`` is the scheduler's :class:`SimClock`;
2. the transport is a :class:`SimTransport` (synchronous delivery)
   wrapped in the production ``ChaosTransport`` whose controller sleeps
   on virtual time;
3. the thread-shaped drivers (``run()``'s state loop, the control
   timer, the background worker, the adversary's attack/serve loops)
   are replaced by scheduler events that call the same internal methods
   those threads call: ``_gossip`` / ``_monologue`` on a jittered
   heartbeat for honest nodes, one pull+attack round per tick for the
   adversary, and ``_process_rpc`` / ``_serve_one`` as the inbound
   handler.

Determinism inputs: node keys are derived from the master seed, the
selector/tick RNGs are scheduler streams, event timestamps come off
the virtual clock, and signing is forced onto the RFC 6979 path (the
scenario layer flips that switch) because the consensus order breaks
ties on signature ``r``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional

from ..adversary.byzantine import ByzantineNode
from ..config.config import Config
from ..crypto import secp256k1 as _curve
from ..crypto.keys import PrivateKey
from ..dummy.state import State as DummyState
from ..hashgraph.store import InmemStore
from ..net.chaos import ChaosController, ChaosTransport, LinkFaults
from ..node.node import Node
from ..node.state import State
from ..node.validator import Validator
from ..peers.peer import Peer
from ..peers.peer_set import PeerSet
from .scheduler import SimScheduler
from .transport import SimNetwork, SimTransport


def sim_key(seed: int, i: int) -> PrivateKey:
    """Deterministic validator key #i for master seed ``seed``."""
    h = hashlib.sha256(f"babble-sim|{seed}|key|{i}".encode()).digest()
    d = (int.from_bytes(h, "big") % (_curve.N - 1)) + 1
    return PrivateKey(d)


def sim_addr(i: int) -> str:
    return f"sim://node{i}"


class _HonestDriver:
    """One node's gossip heartbeat as a self-rescheduling event.

    With the adaptive scheduler on (``node.adaptive``), each tick asks
    the node for its plan — the SAME control law the threaded
    ControlTimer path runs, fed by the same virtual-time signals, so
    adaptation is simulated honestly and deterministically (the law is
    pure arithmetic; the only randomness is this driver's seeded
    jitter stream). With it off, the seed's fixed cadence."""

    def __init__(self, node: Node, sch: SimScheduler, idx: int,
                 heartbeat_s: float):
        self.node = node
        self.sch = sch
        self.idx = idx
        self.heartbeat_s = heartbeat_s
        self.rng = sch.rng(f"tick|{idx}")
        self.down = False

    def start(self) -> None:
        # staggered first tick, mirroring ControlTimer's [hb, 2hb) jitter
        self.sch.at(
            self.rng.uniform(0.0, self.heartbeat_s),
            self._tick,
            f"tick|n{self.idx}",
        )

    def _tick(self) -> None:
        node = self.node
        interval = self.heartbeat_s
        if not self.down and node.get_state() == State.BABBLING:
            fanout = 1
            if node.adaptive is not None:
                plan_interval, fanout = node.gossip_plan()
                # the plan's rails are the node Config's heartbeat
                # pair, which SimCluster derives from heartbeat_s — so
                # the adaptive interval replaces the fixed cadence
                interval = plan_interval
            peers = node.core.peer_selector.next_many(fanout)
            if peers:
                for peer in peers:
                    node._gossip(peer)
            else:
                node._monologue()
        # jittered cadence in [iv, 2*iv) — same law as the control timer
        self.sch.after(
            interval * (1.0 + self.rng.random()),
            self._tick,
            f"tick|n{self.idx}",
        )


class _ByzantineDriver:
    """One attack round per tick: the body of ByzantineNode._attack_loop
    as a scheduler event (pull to stay current, then the named attack)."""

    def __init__(self, byz: ByzantineNode, sch: SimScheduler, idx: int,
                 heartbeat_s: float):
        self.byz = byz
        self.sch = sch
        self.idx = idx
        self.heartbeat_s = heartbeat_s
        self.rng = sch.rng(f"tick|{idx}")
        self.attacking = True
        self._step = getattr(byz, f"_step_{byz.attack}")

    def start(self) -> None:
        self.sch.at(
            self.rng.uniform(0.0, self.heartbeat_s),
            self._tick,
            f"tick|byz{self.idx}",
        )

    def _tick(self) -> None:
        byz = self.byz
        if self.attacking:
            targets = byz._targets()
            if targets:
                peer = byz._rng.choice(targets)
                try:
                    byz._pull(peer)
                    byz.pulls += 1
                except Exception:  # noqa: BLE001 — faults are expected
                    byz.pull_errors += 1
                try:
                    self._step(targets)
                except Exception:  # noqa: BLE001 — attacks never crash us
                    byz.push_errors += 1
        self.sch.after(
            self.heartbeat_s * (1.0 + self.rng.random()),
            self._tick,
            f"tick|byz{self.idx}",
        )


class SimCluster:
    """n honest nodes (+ optional adversaries) on one SimNetwork under
    one seeded ChaosController, all clocked by the scheduler."""

    def __init__(
        self,
        sch: SimScheduler,
        n_honest: int,
        n_byzantine: int = 0,
        attack: str = "equivocate",
        heartbeat_s: float = 0.05,
        faults: Optional[LinkFaults] = None,
        sync_limit: int = 256,
        mempool_max_txs: int = 512,
        split: bool = False,
        trace_sample: Optional[float] = None,
        adaptive: bool = True,
        store_factory: Optional[Callable[[int], object]] = None,
        conf_extra: Optional[dict] = None,
    ):
        self.sch = sch
        self.network = SimNetwork()
        # virtual-time chaos: delay faults advance the SimClock, drop
        # holds cost virtual (not wall) time, duplicates deliver inline
        self.controller = ChaosController(
            seed=sch.seed,
            default_faults=faults or LinkFaults(),
            drop_hold_s=0.005,
            sleep=sch.clock.sleep,
            spawn=lambda fn: fn(),
        )
        n = n_honest + n_byzantine
        keys = [sim_key(sch.seed, i) for i in range(n)]
        self.peers = PeerSet(
            [
                Peer(sim_addr(i), k.public_key.hex(), f"node{i}")
                for i, k in enumerate(keys)
            ]
        )
        self.addrs = [sim_addr(i) for i in range(n)]
        self.n_honest = n_honest

        # Per-node store override (the lifecycle plateau sims swap in a
        # PersistentStore so prune/vacuum byte accounting is real).
        if store_factory is None:
            store_factory = lambda i: InmemStore(10000)  # noqa: E731

        def conf(i: int) -> Config:
            kw = dict(conf_extra or {})
            if trace_sample is not None:
                # provenance sampling override (the determinism tests
                # trace every tx; stamps ride the SimClock, so same-seed
                # runs export byte-identical provenance)
                kw["trace_sample"] = trace_sample
            c = Config(
                heartbeat_timeout=heartbeat_s,
                slow_heartbeat_timeout=4 * heartbeat_s,
                moniker=f"node{i}",
                log_level="error",
                no_service=True,
                sync_limit=sync_limit,
                mempool_max_txs=mempool_max_txs,
                clock=sch.clock,
                sim_seed=sch.seed,
                **kw,
            )
            # Pinned AFTER construction: the BABBLE_ADAPT env override
            # (an operator switch for live clusters) must not silently
            # flip a sim A/B arm — adaptive=False IS the control arm of
            # the adaptive-vs-fixed recovery tests.
            c.adaptive_gossip = adaptive
            return c

        self.nodes: List[Node] = []
        self.proxies = []
        self.states: List[DummyState] = []
        self.drivers: List[_HonestDriver] = []
        from ..proxy.proxy import InmemProxy

        for i in range(n_honest):
            trans = ChaosTransport(
                SimTransport(self.network, self.addrs[i]), self.controller
            )
            state = DummyState()
            proxy = InmemProxy(state)
            node = Node(
                conf(i), Validator(keys[i], f"node{i}"), self.peers,
                self.peers, store_factory(i), trans, proxy,
            )
            node.init()
            self.network.register(
                self.addrs[i], node._process_rpc
            )
            self.nodes.append(node)
            self.proxies.append(proxy)
            self.states.append(state)
            self.drivers.append(_HonestDriver(node, sch, i, heartbeat_s))

        self.byzantine: List[ByzantineNode] = []
        self.byz_drivers: List[_ByzantineDriver] = []
        for j in range(n_byzantine):
            i = n_honest + j
            trans = ChaosTransport(
                SimTransport(self.network, self.addrs[i]), self.controller
            )
            byz = ByzantineNode(
                conf(i), Validator(keys[i], f"node{i}"), self.peers,
                self.peers, InmemStore(10000), trans,
                attack=attack, split=split,
                seed=int(
                    hashlib.sha256(
                        f"babble-sim|{sch.seed}|byz|{j}".encode()
                    ).hexdigest()[:8],
                    16,
                ),
            )
            self.network.register(self.addrs[i], self._byz_handler(byz))
            self.byzantine.append(byz)
            self.byz_drivers.append(_ByzantineDriver(byz, sch, i, heartbeat_s))

        # tx accounting for the exactly-once invariant: payload -> node
        # index whose mempool ACCEPTED it
        self.accepted: Dict[bytes, int] = {}
        self._tx_seq = 0

    @staticmethod
    def _byz_handler(byz: ByzantineNode) -> Callable:
        def handler(rpc) -> None:
            byz.served += 1
            try:
                byz._serve_one(rpc)
            except Exception:  # noqa: BLE001
                try:
                    rpc.respond(None, "byzantine")
                except Exception:
                    pass

        return handler

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        for d in self.drivers:
            d.start()
        for d in self.byz_drivers:
            d.start()

    def shutdown(self) -> None:
        for node in self.nodes:
            node.shutdown()
        for byz in self.byzantine:
            byz.core.hg.store.close()

    # -- scenario hooks -------------------------------------------------

    def submit(self, node_idx: int, payload: bytes) -> str:
        verdict = self.nodes[node_idx]._admit_transaction(payload)
        if verdict == "accepted":
            self.accepted[payload] = node_idx
        return verdict

    def submit_auto(self, rng) -> str:
        """One unique background transaction to an rng-chosen honest node."""
        self._tx_seq += 1
        payload = f"sim tx {self._tx_seq}".encode()
        return self.submit(rng.randrange(self.n_honest), payload)

    def set_node_down(self, i: int) -> None:
        """Crash-style churn: the node vanishes from the network and
        stops gossiping; its state (store, mempool) survives for the
        restart — the model is a machine reboot, not a disk loss."""
        self.network.set_down(self.addrs[i])
        if i < self.n_honest:
            self.drivers[i].down = True

    def set_node_up(self, i: int) -> None:
        self.network.set_up(self.addrs[i])
        if i < self.n_honest:
            self.drivers[i].down = False

    def heal(self) -> None:
        """Lift every fault: partitions, link faults, slow peers, downed
        nodes, and adversary attack rounds (it keeps serving)."""
        self.controller.heal()
        self.controller.clear_slow()
        self.controller.set_default_faults(LinkFaults())
        for i in range(len(self.addrs)):
            self.set_node_up(i)
        for d in self.byz_drivers:
            d.attacking = False

    # -- observations ---------------------------------------------------

    def honest_last_blocks(self) -> List[int]:
        return [n.get_last_block_index() for n in self.nodes]

    def committed_txs(self, i: int) -> List[bytes]:
        return self.states[i].committed_txs

    def commit_digest(self, i: int) -> str:
        """sha256 over the node's committed block-BODY hashes in order.
        Body hashes (not signatures) so the digest witnesses the decided
        contents + order, which is what must be identical across nodes
        and across same-seed runs."""
        node = self.nodes[i]
        h = hashlib.sha256()
        for bi in range(node.get_last_block_index() + 1):
            h.update(node.get_block(bi).body.hash())
        return h.hexdigest()

    def commit_digests(self) -> Dict[str, str]:
        return {f"node{i}": self.commit_digest(i)
                for i in range(self.n_honest)}

    def provenance_exports(self) -> List[dict]:
        """Every honest node's /traces-shaped provenance export — the
        input obs.traceview.merge_all consumes, identical to what a live
        cluster serves over HTTP."""
        return [n.get_traces(limit=-1) for n in self.nodes]

    def provenance_digest(self) -> str:
        """sha256 over every honest node's provenance export (stamps are
        SimClock time, ids are per-node tracer counters — byte-identical
        across same-seed runs; docs/simulation.md)."""
        import json as _json

        payload = _json.dumps(
            self.provenance_exports(), sort_keys=True,
            separators=(",", ":"), default=str,
        )
        return hashlib.sha256(payload.encode()).hexdigest()
