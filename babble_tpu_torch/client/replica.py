"""Checkpointed read replica (docs/clients.md §Read replicas).

A ``ReadReplica`` is an UNTRUSTED-side process that serves reads
without ever joining consensus:

1. **Spin-up**: import a signed checkpoint (client.checkpoint) — after
   ``verify_checkpoint`` against the validator set the operator trusts,
   the replica can answer proofs for everything after the anchor in
   seconds, no DAG replay.
2. **Tail**: subscribe to a validator's SubscriptionHub and VERIFY
   every pushed block (client.verifier.verify_block): >1/3 valid
   signatures from a validator set reachable from the trust root.
   Blocks that fail verification are counted and dropped, never served.
3. **Validator-set ratchet**: a verified block's accepted
   PEER_ADD/PEER_REMOVE receipts derive the successor set; the replica
   keeps every set reachable from its trust root keyed by peers-hash,
   so blocks signed under a post-churn set verify without any
   out-of-band refresh.
4. **Serve**: ``GET /proof/<txid>`` / ``/block/<i>`` / ``/checkpoint``
   / ``/stats`` over its own HTTP endpoint, and optionally re-fan the
   verified stream to downstream subscribers through an embedded hub
   (the gateway does exactly that).
"""

from __future__ import annotations

import json
import socket
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..hashgraph.block import Block
from ..hashgraph.internal_transaction import TransactionType
from ..peers.peer_set import PeerSet
from .proofs import TxIndex, build_proof
from .swarm import SubscriberClient
from .verifier import ProofError, as_peer_set, verify_block, verify_checkpoint

DEFAULT_RETENTION = 4096


class ReadReplica:
    """``validators`` is the operator's trust root (PeerSet / peer
    dicts). ``checkpoint`` (optional) fast-syncs the starting point;
    without one the replica tails from block 0 (fine for young
    clusters, the checkpoint is what makes old ones instant)."""

    def __init__(
        self,
        upstream: str,
        validators,
        checkpoint: Optional[dict] = None,
        retention: int = DEFAULT_RETENTION,
        http_addr: str = "",
    ):
        self.upstream = upstream
        root = as_peer_set(validators)
        self.known_sets: Dict[bytes, PeerSet] = {root.hash(): root}
        self.current_set: PeerSet = root
        self.retention = max(16, int(retention))
        self.blocks: "OrderedDict[int, Block]" = OrderedDict()
        self.txindex = TxIndex()
        self.checkpoint: Optional[dict] = None
        self.last_verified = -1
        self.start_index = 0
        self.verified_blocks = 0
        self.rejected_blocks = 0
        self.reject_reasons: Dict[str, int] = {}
        self.proofs_served = 0
        self.proof_misses = 0
        self.stream_resets = 0
        #: set when the upstream repeatedly sheds us without any block
        #: landing — our next index fell out of the validator's
        #: retention and only a FRESH checkpoint can move us forward
        #: (docs/clients.md §Read replicas); reconnects then back off
        self.resync_required = False
        self._sheds_without_progress = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.http_addr = http_addr
        #: commit listeners for re-fanout (the gateway's hub publish)
        self.listeners: List = []
        if checkpoint is not None:
            block, _frame = verify_checkpoint(checkpoint, root)
            self.checkpoint = checkpoint
            self._ingest(block)
            # the anchor block may itself carry accepted membership
            # receipts — derive the successor set NOW, exactly like the
            # streaming path, or every post-churn pushed block would be
            # rejected as an unknown validator set
            self._ratchet(block, root)
            self.start_index = block.index() + 1

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.http_addr:
            self._serve_http()
        self._thread = threading.Thread(
            target=self._tail_loop, daemon=True, name="replica-tail"
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        t = self._thread
        if t is not None:
            t.join(timeout=3.0)

    # -- the verifying tail --------------------------------------------------

    def _tail_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client = SubscriberClient(
                    self.upstream, start=self.last_verified + 1
                )
            except (OSError, ValueError, ConnectionError):
                self.stream_resets += 1
                if self._stop.wait(0.5):
                    return
                continue
            before = self.last_verified
            shed_reason = None
            try:
                while not self._stop.is_set():
                    try:
                        frame = client.recv(timeout=1.0)
                    except (TimeoutError, socket.timeout):
                        continue  # silence — KEEP the stream, poll _stop
                    kind = frame.get("type")
                    if kind == "block":
                        self._on_block_frame(frame)
                    elif kind == "shed":
                        shed_reason = frame.get("reason")
                        raise ConnectionError("shed by upstream")
            except (ConnectionError, OSError, ValueError):
                self.stream_resets += 1
            finally:
                client.close()
            # Repeatedly shed with zero progress means our next index
            # fell out of the upstream's retention ("behind_retention",
            # or legacy hubs' lagging shed): reconnecting at the same
            # index would livelock. Flag for an operator/gateway
            # checkpoint resync and back the reconnects off hard.
            if self.last_verified > before:
                self._sheds_without_progress = 0
            elif shed_reason is not None:
                self._sheds_without_progress += 1
                if (
                    shed_reason == "behind_retention"
                    or self._sheds_without_progress >= 3
                ):
                    self.resync_required = True
            if self._stop.wait(10.0 if self.resync_required else 0.5):
                return

    def _on_block_frame(self, frame: dict) -> None:
        try:
            block = Block.from_dict(frame["block"])
        except Exception:  # noqa: BLE001 — hostile upstream
            self._reject("bad_frame")
            return
        if block.index() <= self.last_verified:
            return  # duplicate/old push
        peer_set = self.known_sets.get(block.peers_hash())
        if peer_set is None:
            self._reject("unknown_validator_set")
            return
        try:
            verify_block(block, peer_set)
        except ProofError as err:
            self._reject(err.reason)
            return
        self._ingest(block)
        self._ratchet(block, peer_set)
        for fn in self.listeners:
            try:
                fn(block)
            except Exception:  # noqa: BLE001 — downstream faults stay local
                pass

    def _reject(self, reason: str) -> None:
        self.rejected_blocks += 1
        self.reject_reasons[reason] = self.reject_reasons.get(reason, 0) + 1

    def _ingest(self, block: Block) -> None:
        self.blocks[block.index()] = block
        while len(self.blocks) > self.retention:
            self.blocks.popitem(last=False)
        self.txindex.index_block(block)
        self.last_verified = max(self.last_verified, block.index())
        self.verified_blocks += 1

    def _ratchet(self, block: Block, peer_set: PeerSet) -> None:
        """Derive the successor validator set from the verified block's
        accepted membership receipts (the signed block carries them, so
        no extra trust is involved — mirrors
        Core.process_accepted_internal_transactions)."""
        nxt = peer_set
        for r in block.internal_transaction_receipts():
            if not r.accepted:
                continue
            body = r.internal_transaction.body
            if body.type == TransactionType.PEER_ADD:
                nxt = nxt.with_new_peer(body.peer)
            elif body.type == TransactionType.PEER_REMOVE:
                nxt = nxt.with_removed_peer(body.peer)
        if nxt is not peer_set:
            self.known_sets[nxt.hash()] = nxt
            self.current_set = nxt

    # -- reads ---------------------------------------------------------------

    def get_block(self, index: int) -> Optional[Block]:
        return self.blocks.get(index)

    def get_proof(self, txid: str) -> Optional[dict]:
        loc = self.txindex.lookup(txid)
        if loc is None:
            self.proof_misses += 1
            return None
        block = self.blocks.get(loc[0])
        if block is None:  # aged past retention
            self.proof_misses += 1
            return None
        self.proofs_served += 1
        return build_proof(block, loc[1])

    def stats(self) -> dict:
        return {
            "upstream": self.upstream,
            "last_verified": self.last_verified,
            "start_index": self.start_index,
            "verified_blocks": self.verified_blocks,
            "rejected_blocks": self.rejected_blocks,
            "reject_reasons": dict(self.reject_reasons),
            "blocks_held": len(self.blocks),
            "txindex": self.txindex.stats(),
            "proofs_served": self.proofs_served,
            "proof_misses": self.proof_misses,
            "stream_resets": self.stream_resets,
            "resync_required": self.resync_required,
            "validator_sets_known": len(self.known_sets),
            "validators": len(self.current_set),
            "from_checkpoint": self.checkpoint is not None,
        }

    # -- HTTP ----------------------------------------------------------------

    def _serve_http(self) -> None:
        replica = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                try:
                    self._route()
                except Exception as err:  # noqa: BLE001
                    _send(self, 500, {"error": str(err)})

            def _route(self):
                path = self.path.split("?", 1)[0]
                if path.startswith("/proof/"):
                    proof = replica.get_proof(path[len("/proof/"):])
                    if proof is None:
                        _send(self, 404, {"error": "unknown txid"})
                    else:
                        _send(self, 200, proof)
                elif path.startswith("/block/"):
                    block = replica.get_block(int(path[len("/block/"):]))
                    if block is None:
                        _send(self, 404, {"error": "unknown block"})
                    else:
                        from ..crypto.canonical import jsonable

                        _send(self, 200, jsonable(block.to_dict()))
                elif path == "/checkpoint":
                    if replica.checkpoint is None:
                        _send(self, 404, {"error": "no checkpoint"})
                    else:
                        _send(self, 200, replica.checkpoint)
                elif path == "/stats":
                    _send(self, 200, replica.stats())
                else:
                    _send(self, 404, {"error": f"no route {path}"})

        host, port_s = self.http_addr.rsplit(":", 1)
        self._httpd = ThreadingHTTPServer(
            (host or "0.0.0.0", int(port_s)), Handler
        )
        self.http_addr = f"{host}:{self._httpd.server_address[1]}"
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="replica-http",
        ).start()


def _send(req: BaseHTTPRequestHandler, code: int, body) -> None:
    payload = json.dumps(body).encode()
    req.send_response(code)
    req.send_header("Content-Type", "application/json")
    req.send_header("Content-Length", str(len(payload)))
    req.end_headers()
    req.wfile.write(payload)
