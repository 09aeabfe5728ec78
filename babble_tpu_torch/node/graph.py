"""Read-only extraction of the whole hashgraph for visualization /
debugging (reference: src/node/graph.go:8-127)."""

from __future__ import annotations

from typing import Dict, List

from ..crypto.canonical import jsonable


class Graph:
    """Wraps a Node and dumps participant events, rounds, and blocks."""

    def __init__(self, node) -> None:
        self.node = node

    def participant_events(self) -> Dict[str, Dict[str, dict]]:
        """participant -> event hex -> event dict (graph.go:18-55)."""
        store = self.node.core.hg.store
        out: Dict[str, Dict[str, dict]] = {}
        for pub in store.repertoire_by_pub_key():
            evs: Dict[str, dict] = {}
            try:
                hashes = store.participant_events(pub, -1)
            except Exception:
                hashes = []
            for h in hashes:
                try:
                    ev = store.get_event(h)
                except Exception:
                    continue
                evs[h] = {
                    "Body": jsonable(ev.body.to_dict()),
                    "Signature": ev.signature,
                    "Round": ev.round,
                    "LamportTimestamp": ev.lamport_timestamp,
                }
            out[pub] = evs
        return out

    def rounds(self) -> List[dict]:
        """All round infos in order (graph.go:57-77)."""
        store = self.node.core.hg.store
        out = []
        for i in range(store.last_round() + 1):
            try:
                out.append(
                    jsonable(store.get_round(i).to_dict())
                )
            except Exception:
                out.append(None)
        return out

    def blocks(self) -> List[dict]:
        """All blocks in order (graph.go:79-99)."""
        store = self.node.core.hg.store
        out = []
        for i in range(store.last_block_index() + 1):
            try:
                out.append(
                    jsonable(store.get_block(i).to_dict())
                )
            except Exception:
                out.append(None)
        return out

    def to_dict(self) -> dict:
        """The /graph payload (graph.go:110-127)."""
        return {
            "ParticipantEvents": self.participant_events(),
            "Rounds": self.rounds(),
            "Blocks": self.blocks(),
        }
