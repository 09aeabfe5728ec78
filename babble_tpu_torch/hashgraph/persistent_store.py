"""PersistentStore — write-through durable store over SQLite.

The tpu-native equivalent of the reference's BadgerStore
(src/hashgraph/badger_store.go:28-100): an InmemStore
LRU cache in front, with every event/round/block/frame/peer-set written
through to an embedded KV (SQLite, stdlib — this image ships no badger).
Reads fall back to the DB on cache miss or rolling-index eviction
(TooLate), mirroring badger_store.go:293-310.

Bootstrap (`--bootstrap`) replays the whole DB topologically through
consensus to rebuild in-memory state — "WE CAN ONLY BOOTSTRAP FROM 0"
(reference: hashgraph.go:1481-1536); Hashgraph.bootstrap drives it via
``topological_events`` and flips ``set_maintenance_mode`` so the replay
doesn't rewrite the DB.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional

from babble_tpu_torch.common.errors import StoreError, StoreErrorKind
from babble_tpu_torch.crypto.canonical import canonical_dumps, canonical_loads
from babble_tpu_torch.hashgraph.block import Block
from babble_tpu_torch.hashgraph.event import Event, EventBody
from babble_tpu_torch.hashgraph.frame import Frame, Root
from babble_tpu_torch.hashgraph.round_info import RoundInfo
from babble_tpu_torch.hashgraph.store import InmemStore
from babble_tpu_torch.peers.peer import Peer
from babble_tpu_torch.peers.peer_set import PeerSet

_SCHEMA = """
CREATE TABLE IF NOT EXISTS events (
    key TEXT PRIMARY KEY, topo INTEGER NOT NULL, data TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS events_topo ON events(topo);
CREATE TABLE IF NOT EXISTS participant_events (
    participant TEXT NOT NULL, idx INTEGER NOT NULL, hash TEXT NOT NULL,
    PRIMARY KEY (participant, idx));
CREATE TABLE IF NOT EXISTS rounds (idx INTEGER PRIMARY KEY, data TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS blocks (idx INTEGER PRIMARY KEY, data TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS frames (round INTEGER PRIMARY KEY, data TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS peer_sets (round INTEGER PRIMARY KEY, data TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS roots (participant TEXT PRIMARY KEY, data TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS evidence (key TEXT PRIMARY KEY, data TEXT NOT NULL);
"""


class PersistentStore:
    """Write-through store: InmemStore cache + SQLite persistence."""

    def __init__(self, cache_size: int = 10000, path: str = "babble.db"):
        self._path = path
        self._inmem = InmemStore(cache_size)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            # Declared BEFORE the first table exists so a fresh DB gets
            # incremental vacuum (checkpoint-prune frees pages back to the
            # OS without a full rebuild). On a pre-existing DB this is a
            # no-op until a full VACUUM — vacuum(incremental=False) covers
            # that upgrade path.
            self._db.execute("PRAGMA auto_vacuum=INCREMENTAL")
            self._db.executescript(_SCHEMA)
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            row = self._db.execute("SELECT MAX(topo) FROM events").fetchone()
        self._next_topo = (row[0] + 1) if row and row[0] is not None else 0
        # maintenanceMode disables DB writes during bootstrap replay
        # (reference: badger_store.go:848-855)
        self._maintenance = False
        # NOTE: persisted peer-sets are deliberately NOT preloaded into the
        # interval cache. The reference's design comment
        # (badger_store.go:109-118) applies verbatim: membership state must
        # be reconstructed by replaying events through consensus
        # (Bootstrap), which re-registers each peer-set at its effective
        # round — preloading would make that replay collide with
        # KEY_ALREADY_EXISTS. db_peer_set() exposes the raw rows.

    # -- maintenance --------------------------------------------------------

    def set_maintenance_mode(self, on: bool) -> None:
        self._maintenance = on

    # -- passthroughs to the cache -----------------------------------------

    def cache_size(self) -> int:
        return self._inmem.cache_size()

    def get_all_peer_sets(self) -> Dict[int, List[Peer]]:
        return self._inmem.get_all_peer_sets()

    def first_round(self, participant_id: int):
        return self._inmem.first_round(participant_id)

    def repertoire_by_pub_key(self) -> Dict[str, Peer]:
        return self._inmem.repertoire_by_pub_key()

    def repertoire_by_id(self) -> Dict[int, Peer]:
        return self._inmem.repertoire_by_id()

    def known_events(self) -> Dict[int, int]:
        return self._inmem.known_events()

    def consensus_events(self) -> List[str]:
        return self._inmem.consensus_events()

    def consensus_events_count(self) -> int:
        return self._inmem.consensus_events_count()

    def add_consensus_event(self, event: Event) -> None:
        self._inmem.add_consensus_event(event)

    def last_event_from(self, participant: str) -> str:
        return self._inmem.last_event_from(participant)

    def last_consensus_event_from(self, participant: str) -> str:
        return self._inmem.last_consensus_event_from(participant)

    def last_round(self) -> int:
        return self._inmem.last_round()

    def last_block_index(self) -> int:
        return self._inmem.last_block_index()

    def round_witnesses(self, round_index: int) -> List[str]:
        try:
            return self.get_round(round_index).witnesses()
        except StoreError:
            return []

    def round_events(self, round_index: int) -> int:
        try:
            return len(self.get_round(round_index).created_events)
        except StoreError:
            return 0

    def get_root(self, participant: str) -> Root:
        try:
            return self._inmem.get_root(participant)
        except StoreError:
            row = self._fetch(
                "SELECT data FROM roots WHERE participant = ?", (participant,)
            )
            if row is None:
                raise
            return Root.from_dict(json.loads(row[0]))

    # -- peer sets (write-through) -----------------------------------------

    def get_peer_set(self, round: int) -> PeerSet:
        return self._inmem.get_peer_set(round)

    def set_peer_set(self, round: int, peer_set: PeerSet) -> None:
        self._inmem.set_peer_set(round, peer_set)
        self._write(
            "INSERT OR REPLACE INTO peer_sets (round, data) VALUES (?, ?)",
            (round, canonical_dumps([p.to_dict() for p in peer_set.peers]).decode()),
        )

    # -- events -------------------------------------------------------------

    def get_event(self, hash_: str) -> Event:
        try:
            return self._inmem.get_event(hash_)
        except StoreError:
            row = self._fetch("SELECT data FROM events WHERE key = ?", (hash_,))
            if row is None:
                raise
            return _event_from_json(row[0])

    def set_event(self, event: Event) -> None:
        # DB first, memory second: an event must be DURABLE before it can
        # become visible to gossip. A silently dropped disk write during the
        # shutdown race let a node gossip an event, lose it at close, then
        # re-sign a different event at the same index after bootstrap — a
        # cross-incarnation self-fork that wedges every peer still holding
        # the first incarnation's event (observed as the recycle tests'
        # "invalid event signature" livelock). Failing the insert instead
        # keeps the event out of this node's head chain entirely.
        if self._maintenance:
            self._inmem.set_event(event)
            return
        fresh = self._persist_event(event)
        try:
            self._inmem.set_event(event)
        except BaseException:
            if fresh:
                # the cache rejected an event the DB just gained (e.g. a
                # trusted frame-event insert hitting an index gap): roll
                # the fresh rows back so the next incarnation's bootstrap
                # never replays an event this one refused. Pre-existing
                # rows (annotation re-sets) are left untouched.
                self._unpersist_event(event)
            raise

    def _persist_event(self, event: Event) -> bool:
        """Write through to the DB; returns True when the rows are new
        (vs. a re-set of an already-durable event)."""
        key = event.hex()
        from babble_tpu_torch.crypto.canonical import PreNormalized

        # memoized body form: byte-identical stored JSON, reusing the
        # normalization the insert-path hash already paid for
        d = {
            "Body": PreNormalized(event.body.normalized()),
            "Signature": event.signature,
        }
        # Consensus annotations (write-once once assigned) ride along so a
        # cache-evicted event reloads with its round/lamport intact —
        # after compaction the recursive recomputation may no longer have
        # the parents to rebuild them from. Bootstrap replay strips them
        # (topological_events) so the from-zero recompute stays pristine.
        if event.round is not None:
            d["Round"] = event.round
        if event.lamport_timestamp is not None:
            d["Lamport"] = event.lamport_timestamp
        if event.round_received is not None:
            d["RoundReceived"] = event.round_received
        with self._db_lock:
            if self._db is None:
                raise StoreError(
                    "PersistentStore", StoreErrorKind.CLOSED, key
                )
            cur = self._db.execute("SELECT topo FROM events WHERE key = ?", (key,))
            row = cur.fetchone()
            topo = row[0] if row else self._next_topo
            if row is None:
                self._next_topo += 1
                self._db.execute(
                    "INSERT OR REPLACE INTO participant_events "
                    "(participant, idx, hash) VALUES (?, ?, ?)",
                    (event.creator(), event.index(), key),
                )
            self._db.execute(
                "INSERT OR REPLACE INTO events (key, topo, data) VALUES (?, ?, ?)",
                (key, topo, canonical_dumps(d).decode()),
            )
            self._db.commit()
            return row is None

    def _unpersist_event(self, event: Event) -> None:
        key = event.hex()
        with self._db_lock:
            if self._db is None:
                return
            self._db.execute("DELETE FROM events WHERE key = ?", (key,))
            self._db.execute(
                "DELETE FROM participant_events WHERE participant = ? "
                "AND idx = ? AND hash = ?",
                (event.creator(), event.index(), key),
            )
            self._db.commit()

    def participant_events(self, participant: str, skip: int) -> List[str]:
        try:
            return self._inmem.participant_events(participant, skip)
        except StoreError as err:
            if err.kind != StoreErrorKind.TOO_LATE:
                raise
            with self._db_lock:
                if self._db is None:
                    raise err  # shutdown race: surface the original miss
                rows = self._db.execute(
                    "SELECT hash FROM participant_events "
                    "WHERE participant = ? AND idx > ? ORDER BY idx",
                    (participant, skip),
                ).fetchall()
            return [r[0] for r in rows]

    def participant_event(self, participant: str, index: int) -> str:
        """Cache first; DB fallback on eviction (badger_store.go:293-310)."""
        try:
            return self._inmem.participant_event(participant, index)
        except StoreError:
            row = self._fetch(
                "SELECT hash FROM participant_events "
                "WHERE participant = ? AND idx = ?",
                (participant, index),
            )
            if row is None:
                raise
            return row[0]

    # -- rounds -------------------------------------------------------------

    def get_round(self, round_index: int) -> RoundInfo:
        try:
            return self._inmem.get_round(round_index)
        except StoreError:
            row = self._fetch(
                "SELECT data FROM rounds WHERE idx = ?", (round_index,)
            )
            if row is None:
                raise
            return RoundInfo.from_dict(json.loads(row[0]))

    def set_round(self, round_index: int, round_info: RoundInfo) -> None:
        self._inmem.set_round(round_index, round_info)
        self._write(
            "INSERT OR REPLACE INTO rounds (idx, data) VALUES (?, ?)",
            (round_index, canonical_dumps(round_info.to_dict()).decode()),
        )

    # -- blocks -------------------------------------------------------------

    def get_block(self, index: int) -> Block:
        try:
            return self._inmem.get_block(index)
        except StoreError:
            row = self._fetch("SELECT data FROM blocks WHERE idx = ?", (index,))
            if row is None:
                raise
            return Block.from_dict(json.loads(row[0]))

    def set_block(self, block: Block) -> None:
        self._inmem.set_block(block)
        self._write(
            "INSERT OR REPLACE INTO blocks (idx, data) VALUES (?, ?)",
            (block.index(), canonical_dumps(block.to_dict()).decode()),
        )

    # -- frames -------------------------------------------------------------

    def get_frame(self, round_received: int) -> Frame:
        try:
            return self._inmem.get_frame(round_received)
        except StoreError:
            row = self._fetch(
                "SELECT data FROM frames WHERE round = ?", (round_received,)
            )
            if row is None:
                raise
            return Frame.from_dict(json.loads(row[0]))

    def set_frame(self, frame: Frame) -> None:
        self._inmem.set_frame(frame)
        self._write(
            "INSERT OR REPLACE INTO frames (round, data) VALUES (?, ?)",
            (frame.round, canonical_dumps(frame.to_dict()).decode()),
        )

    # -- bootstrap support ---------------------------------------------------

    def topological_events(self, skip: int, count: int) -> List[Event]:
        """Events in insert order, for bootstrap replay
        (reference: badger_store.go dbTopologicalEvents / hashgraph.go:1481)."""
        with self._db_lock:
            if self._db is None:
                return []  # shutdown race: nothing left to replay
            rows = self._db.execute(
                "SELECT data FROM events ORDER BY topo LIMIT ? OFFSET ?",
                (count, skip),
            ).fetchall()
        return [_event_from_json(r[0], annotated=False) for r in rows]

    def db_peer_set(self, round: int) -> PeerSet:
        """The persisted peer-set registered at EXACTLY this round (raw DB
        row, no interval semantics — reference: badger_store.go
        dbGetPeerSet). Bootstrap replay, not this accessor, rebuilds the
        live interval cache."""
        row = self._fetch(
            "SELECT data FROM peer_sets WHERE round = ?", (round,)
        )
        if row is None:
            raise StoreError(
                "PeerSetDB", StoreErrorKind.KEY_NOT_FOUND, str(round)
            )
        return PeerSet(
            [Peer.from_dict(d) for d in canonical_loads(row[0].encode())]
        )

    def db_last_block_index(self) -> int:
        row = self._fetch("SELECT MAX(idx) FROM blocks", ())
        return row[0] if row and row[0] is not None else -1

    # -- evidence ------------------------------------------------------------

    def set_evidence(self, key: str, data: dict) -> None:
        """Durable misbehavior evidence (equivocation proofs): written
        through even in maintenance mode — evidence is NOT derived state
        that a bootstrap replay rebuilds, so the replay's write gate
        (which protects events/rounds/blocks from being re-written) must
        not silently drop a proof recorded while it is open."""
        self._inmem.set_evidence(key, data)
        with self._db_lock:
            if self._db is None:
                raise StoreError(
                    "PersistentStore", StoreErrorKind.CLOSED, "evidence"
                )
            self._db.execute(
                "INSERT OR REPLACE INTO evidence (key, data) VALUES (?, ?)",
                (key, canonical_dumps(data).decode()),
            )
            self._db.commit()

    def all_evidence(self) -> Dict[str, dict]:
        with self._db_lock:
            if self._db is None:
                return self._inmem.all_evidence()
            rows = self._db.execute("SELECT key, data FROM evidence").fetchall()
        out = dict(self._inmem.all_evidence())
        for key, data in rows:
            out[key] = json.loads(data)
        return out

    # -- lifecycle -----------------------------------------------------------

    def reset(self, frame: Frame) -> None:
        """Reset the cache from a frame; the DB keeps accumulating (the
        reference's badger Reset also only clears the in-memory half)."""
        self._inmem.reset(frame)
        for participant, root in frame.roots.items():
            self._write(
                "INSERT OR REPLACE INTO roots (participant, data) VALUES (?, ?)",
                (participant, canonical_dumps(root.to_dict()).decode()),
            )
        self.set_frame(frame)

    # -- compaction ----------------------------------------------------------

    def prune_below(
        self,
        floor_round: int,
        drop_events: List[str],
        drop_rounds: List[int],
        participant_floors: Dict[str, int],
    ) -> None:
        """Durable half of checkpoint-prune: delete the compacted rows.
        Blocks, peer-sets, roots and evidence are never touched — evidence
        in particular is NOT replay-derived state (see set_evidence) and
        must survive compaction."""
        self._inmem.prune_below(
            floor_round, drop_events, drop_rounds, participant_floors
        )
        with self._db_lock:
            if self._db is None:
                raise StoreError(
                    "PersistentStore", StoreErrorKind.CLOSED, "prune"
                )
            self._db.executemany(
                "DELETE FROM events WHERE key = ?",
                [(h,) for h in drop_events],
            )
            self._db.executemany(
                "DELETE FROM rounds WHERE idx = ?",
                [(r,) for r in drop_rounds],
            )
            self._db.execute(
                "DELETE FROM frames WHERE round < ?", (floor_round,)
            )
            for participant, floor in participant_floors.items():
                self._db.execute(
                    "DELETE FROM participant_events "
                    "WHERE participant = ? AND idx < ?",
                    (participant, floor),
                )
            self._db.commit()

    def vacuum(self, incremental: bool = True) -> None:
        """Hand freed pages back to the OS. Incremental is cheap and the
        default (the DB is created with auto_vacuum=INCREMENTAL); a full
        VACUUM rebuild also upgrades DBs that predate that pragma."""
        with self._db_lock:
            if self._db is None:
                return
            if incremental:
                self._db.execute("PRAGMA incremental_vacuum")
            else:
                self._db.execute("VACUUM")
            self._db.commit()

    def size_stats(self) -> Dict[str, int]:
        stats = dict(self._inmem.size_stats())
        with self._db_lock:
            if self._db is None:
                return stats
            ev = self._db.execute("SELECT COUNT(*) FROM events").fetchone()[0]
            rd = self._db.execute("SELECT COUNT(*) FROM rounds").fetchone()[0]
            bl = self._db.execute("SELECT COUNT(*) FROM blocks").fetchone()[0]
            fr = self._db.execute("SELECT COUNT(*) FROM frames").fetchone()[0]
            page_count = self._db.execute("PRAGMA page_count").fetchone()[0]
            page_size = self._db.execute("PRAGMA page_size").fetchone()[0]
            freelist = self._db.execute("PRAGMA freelist_count").fetchone()[0]
        stats["events"] = ev
        stats["rounds"] = rd
        stats["blocks"] = bl
        stats["frames"] = fr
        stats["store_bytes"] = page_count * page_size
        stats["free_bytes"] = freelist * page_size
        return stats

    def close(self) -> None:
        with self._db_lock:
            if self._db is None:
                return
            self._db.commit()
            self._db.close()
            self._db = None

    def store_path(self) -> str:
        return self._path

    # -- helpers -------------------------------------------------------------

    def _fetch(self, sql: str, args: tuple) -> Optional[tuple]:
        with self._db_lock:
            if self._db is None:
                # a gossip thread outliving shutdown's bounded wait must
                # get a typed miss, not an AttributeError
                raise StoreError(
                    "PersistentStore", StoreErrorKind.KEY_NOT_FOUND, "closed"
                )
            return self._db.execute(sql, args).fetchone()

    def _write(self, sql: str, args: tuple) -> None:
        if self._maintenance:
            return
        with self._db_lock:
            if self._db is None:
                # Same fail-closed policy as events: a silently dropped
                # write leaves the durable history behind what this
                # incarnation advertised to the network. Derived objects
                # (rounds/blocks/frames) replay from events, but a loud
                # failure is strictly safer than a silent gap — the dying
                # caller handles it like any other store error.
                raise StoreError(
                    "PersistentStore", StoreErrorKind.CLOSED, sql.split()[2]
                )
            self._db.execute(sql, args)
            self._db.commit()


def _event_from_json(data: str, annotated: bool = True) -> Event:
    d = json.loads(data)
    ev = Event(EventBody.from_dict(d["Body"]), signature=d["Signature"])
    if annotated:
        if d.get("Round") is not None:
            ev.set_round(d["Round"])
        if d.get("Lamport") is not None:
            ev.set_lamport_timestamp(d["Lamport"])
        if d.get("RoundReceived") is not None:
            ev.set_round_received(d["RoundReceived"])
    return ev
