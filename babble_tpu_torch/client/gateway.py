"""Sharded admission gateway (docs/clients.md §Gateway).

The write-side front end of the client tier: clients speak the exact
``Babble.SubmitTx`` JSON-RPC the validator proxies speak (so
demo/bombard.py points at a gateway unchanged), but the gateway

1. **shards admission** across worker shards (threads, or separate OS
   processes with ``processes=True``) each running the real mempool
   verdict pipeline (docs/mempool.md): dedup, caps, token-bucket rate
   limiting and the committed-LRU — a flood is shed at the edge before
   it ever reaches a validator;
2. **forwards** accepted transactions to the validator proxies
   (sticky per shard, failover across the list);
3. **subscribes on behalf of its clients**: an embedded
   :class:`~babble_tpu_torch.client.replica.ReadReplica` tails and VERIFIES
   the upstream commit stream, feeds committed payloads back into the
   worker mempools (so retries of committed transactions answer
   ``already_committed`` from the edge), serves ``GET /proof/<txid>``
   over HTTP, and re-fans the verified stream to downstream subscribers
   through its own SubscriptionHub — validators see ONE subscriber per
   gateway, not one per client.

Sharding is ``crc32(tx) % shards`` so every retry of a payload lands on
the shard that holds its dedup state.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional

from .replica import ReadReplica
from .subhub import SubscriptionHub

#: worker-side verdict when no validator accepted the forward
UNAVAILABLE = "unavailable"


def _shard_of(tx: bytes, shards: int) -> int:
    return zlib.crc32(tx) % shards


def _worker_loop(worker_id, forward_addrs, mempool_kwargs, task_q, resp_q):
    """One admission shard: mempool verdicts + sticky-with-failover
    forwarding. Runs as a thread or a child process — only stdlib +
    picklable args. Exits on a ``None`` task."""
    from ..mempool.mempool import Mempool
    from ..proxy.socket_proxy import JsonRpcClient

    mp = Mempool(**mempool_kwargs)
    clients: Dict[str, JsonRpcClient] = {}
    n_fwd = len(forward_addrs)

    def forward(tx: bytes) -> str:
        """Push one accepted tx to a validator; the shard's sticky
        choice first, then failover around the ring."""
        import base64

        for i in range(n_fwd):
            addr = forward_addrs[(worker_id + i) % n_fwd]
            cli = clients.get(addr)
            if cli is None:
                cli = clients[addr] = JsonRpcClient(addr, timeout=5.0)
            try:
                result = cli.call(
                    "Babble.SubmitTx",
                    base64.b64encode(tx).decode("ascii"),
                )
                return "accepted" if result is True else str(result)
            except Exception:  # noqa: BLE001 — failover
                continue
        return UNAVAILABLE

    while True:
        item = task_q.get()
        if item is None:
            break
        kind = item[0]
        if kind == "tx":
            _, req_id, tx = item
            verdict = mp.submit(tx)
            # Drain whenever anything is pending — the shard mempool is
            # an admission filter + dedup ledger, not a holding pool.
            # Pending can be nonzero on a non-accepted verdict when an
            # earlier forward failed and the batch was requeued below;
            # any new task is the retry trigger.
            batch = mp.drain() if mp.pending_count else []
            for i, drained in enumerate(batch):
                fwd = forward(drained)
                if fwd in ("throttled", "full", UNAVAILABLE):
                    # The validator shed the tx (or none was reachable):
                    # put THIS tx and the rest of the batch back so a
                    # later task retries them — dropping here would
                    # leave the hash in the in-flight dedup set and
                    # every client retry would bounce off 'duplicate'
                    # while the payload never reached consensus
                    # (blackhole). Terminal verdicts (accepted /
                    # duplicate / already_committed) stay dropped; an
                    # 'oversized' at the validator but not here is a
                    # cap misconfiguration — size the gateway's
                    # event_max_bytes at or below the validators'.
                    mp.requeue(batch[i:])
                    if verdict == "accepted":
                        verdict = fwd
                    break
                if drained == tx and verdict == "accepted":
                    verdict = fwd
            resp_q.put(("verdict", req_id, verdict))
        elif kind == "commit":
            # committed payloads observed by the verifying replica:
            # feeds the committed-LRU so client retries shed at the edge
            mp.mark_committed(item[1])
        elif kind == "stats":
            resp_q.put(
                ("stats", item[1], {
                    "submitted": mp.submitted,
                    "accepted": mp.accepted,
                    "rejected_dup": mp.rejected_dup,
                    "rejected_full": mp.rejected_full,
                    "rejected_throttled": mp.rejected_throttled,
                    "already_committed": mp.committed_dedup_hits,
                })
            )
    for cli in clients.values():
        cli.close()


class Gateway:
    """``forward_addrs`` are validator proxy addrs (Babble.SubmitTx);
    ``upstream`` is a validator's SubscriptionHub addr. ``listen`` /
    ``sub_listen`` / ``http_addr`` bind the gateway's own submit,
    re-fanout, and proof endpoints (empty = feature off; ":0" picks an
    ephemeral port). ``processes=True`` runs each shard as an OS
    process — the production shape; threads are the in-test default."""

    def __init__(
        self,
        forward_addrs: List[str],
        upstream: str,
        validators,
        listen: str = "",
        sub_listen: str = "",
        http_addr: str = "",
        checkpoint: Optional[dict] = None,
        shards: int = 2,
        processes: bool = False,
        mempool_kwargs: Optional[dict] = None,
        submit_timeout: float = 10.0,
        queue_frames: int = 256,
        stall_timeout_s: float = 10.0,
        shed_lag: int = 1024,
    ):
        if not forward_addrs:
            raise ValueError("gateway needs at least one validator addr")
        self.shards = max(1, int(shards))
        self.processes = bool(processes)
        self.submit_timeout = submit_timeout
        mp_kwargs = dict(
            max_txs=20000, max_bytes=32 * 1024 * 1024,
            committed_lru=65536,
        )
        mp_kwargs.update(mempool_kwargs or {})

        if self.processes:
            import multiprocessing as mp_mod

            ctx = mp_mod.get_context("spawn")
            self._task_qs = [ctx.Queue() for _ in range(self.shards)]
            self._resp_q = ctx.Queue()
            self._workers = [
                ctx.Process(
                    target=_worker_loop,
                    args=(i, list(forward_addrs), mp_kwargs,
                          self._task_qs[i], self._resp_q),
                    daemon=True, name=f"gw-shard-{i}",
                )
                for i in range(self.shards)
            ]
        else:
            import queue as q_mod

            self._task_qs = [q_mod.Queue() for _ in range(self.shards)]
            self._resp_q = q_mod.Queue()
            self._workers = [
                threading.Thread(
                    target=_worker_loop,
                    args=(i, list(forward_addrs), mp_kwargs,
                          self._task_qs[i], self._resp_q),
                    daemon=True, name=f"gw-shard-{i}",
                )
                for i in range(self.shards)
            ]

        # verdict routing: req_id -> (event, slot)
        self._pending: Dict[int, tuple] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._worker_stats: Dict[int, dict] = {}

        # the verifying read side
        self.replica = ReadReplica(
            upstream, validators, checkpoint=checkpoint,
            http_addr=http_addr,
        )
        self.replica.listeners.append(self._on_verified_block)

        # re-fanout hub over VERIFIED blocks only
        self.hub: Optional[SubscriptionHub] = None
        if sub_listen:
            self.hub = SubscriptionHub(
                sub_listen,
                block_source=self._sealed_source,
                moniker="gateway",
                queue_frames=queue_frames,
                stall_timeout_s=stall_timeout_s,
                shed_lag=shed_lag,
            )

        # the submit front end (same wire as a validator proxy)
        self._server = None
        if listen:
            from ..proxy.socket_proxy import JsonRpcServer

            self._server = JsonRpcServer(
                listen, {"Babble.SubmitTx": self._rpc_submit}
            )
            self.listen_addr = self._server.addr
        self.submitted = 0
        self.forward_unavailable = 0
        self._stop = threading.Event()
        self._resp_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for w in self._workers:
            w.start()
        self._resp_thread = threading.Thread(
            target=self._resp_loop, daemon=True, name="gw-resp"
        )
        self._resp_thread.start()
        self.replica.start()
        if self.hub is not None:
            self.hub.listen()

    def close(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.close()
        if self.hub is not None:
            self.hub.close()
        self.replica.close()
        for q in self._task_qs:
            try:
                q.put(None)
            except Exception:  # noqa: BLE001 — closed mp queue
                pass
        for w in self._workers:
            w.join(timeout=3.0)
            if self.processes and w.is_alive():
                w.terminate()
        # unblock any submitter still parked on a verdict
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for event, slot in pending:
            slot.append(UNAVAILABLE)
            event.set()

    # -- submit path ---------------------------------------------------------

    def _rpc_submit(self, tx_b64: str) -> str:
        from ..crypto.canonical import unb64

        return self.submit(unb64(tx_b64))

    def submit(self, tx: bytes) -> str:
        """Admission verdict for one transaction, end to end: shard
        mempool verdict, forward to a validator when accepted."""
        tx = bytes(tx)
        event = threading.Event()
        slot: list = []
        with self._pending_lock:
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = (event, slot)
        self._task_qs[_shard_of(tx, self.shards)].put(("tx", req_id, tx))
        self.submitted += 1
        if not event.wait(timeout=self.submit_timeout):
            with self._pending_lock:
                self._pending.pop(req_id, None)
            return UNAVAILABLE
        verdict = slot[0]
        if verdict == UNAVAILABLE:
            self.forward_unavailable += 1
        return verdict

    def _resp_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._resp_q.get(timeout=0.2)
            except Exception:  # noqa: BLE001 — queue.Empty / closed mp queue
                continue
            if item[0] == "verdict":
                _, req_id, verdict = item
                with self._pending_lock:
                    waiter = self._pending.pop(req_id, None)
                if waiter is not None:
                    event, slot = waiter
                    slot.append(verdict)
                    event.set()
            elif item[0] == "stats":
                self._worker_stats[item[1]] = item[2]

    # -- read path -----------------------------------------------------------

    def _sealed_source(self, index: int):
        """Block source for the re-fanout hub: only blocks the replica
        has VERIFIED are ever pushed downstream."""
        if index > self.replica.last_verified:
            return None
        return self.replica.get_block(index)

    def _on_verified_block(self, block) -> None:
        # committed-LRU feedback, sharded like admissions
        txs = block.transactions()
        if txs:
            by_shard: Dict[int, list] = {}
            for tx in txs:
                by_shard.setdefault(_shard_of(tx, self.shards), []).append(tx)
            for shard, batch in by_shard.items():
                self._task_qs[shard].put(("commit", batch))
        if self.hub is not None:
            self.hub.publish(block.index())

    def get_proof(self, txid: str) -> Optional[dict]:
        return self.replica.get_proof(txid)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        # refresh worker-side counters (best effort, async)
        for i, q in enumerate(self._task_qs):
            try:
                q.put(("stats", i))
            except Exception:  # noqa: BLE001
                pass
        out = {
            "shards": self.shards,
            "processes": self.processes,
            "submitted": self.submitted,
            "forward_unavailable": self.forward_unavailable,
            "replica": self.replica.stats(),
            "workers": dict(self._worker_stats),
        }
        if self.hub is not None:
            out["hub"] = self.hub.stats()
        return out


def main(argv=None) -> int:
    """Standalone gateway: ``python -m babble_tpu_torch.client.gateway
    --forward addr,addr --upstream addr --peers peers.json --listen
    host:port [--sub-listen ...] [--http ...] [--checkpoint file]
    [--shards N] [--processes]``."""
    import argparse
    import json
    import signal as _signal
    import sys
    import time as _time

    p = argparse.ArgumentParser(prog="babble_tpu_torch.client.gateway")
    p.add_argument("--forward", required=True,
                   help="comma-separated validator proxy addrs")
    p.add_argument("--upstream", required=True,
                   help="a validator's --client-listen addr")
    p.add_argument("--peers", required=True,
                   help="peers.json with the trusted validator set")
    p.add_argument("--listen", default="127.0.0.1:0")
    p.add_argument("--sub-listen", dest="sub_listen", default="")
    p.add_argument("--http", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--processes", action="store_true")
    args = p.parse_args(argv)

    with open(args.peers, encoding="utf-8") as f:
        validators = json.load(f)
    checkpoint = None
    if args.checkpoint:
        from .checkpoint import load_checkpoint

        checkpoint = load_checkpoint(args.checkpoint)
    gw = Gateway(
        [a.strip() for a in args.forward.split(",") if a.strip()],
        args.upstream, validators,
        listen=args.listen, sub_listen=args.sub_listen,
        http_addr=args.http, checkpoint=checkpoint,
        shards=args.shards, processes=args.processes,
    )
    gw.start()
    print(
        f"gateway up: submit {getattr(gw, 'listen_addr', '-')}, "
        f"subscribe {gw.hub.bind_addr if gw.hub else '-'}, "
        f"http {gw.replica.http_addr or '-'}",
        file=sys.stderr,
    )
    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True

    _signal.signal(_signal.SIGINT, _stop)
    _signal.signal(_signal.SIGTERM, _stop)
    while not stop["flag"]:
        _time.sleep(0.2)  # lint: allow(clock: gateway daemon wait loop; operator tool, never under sim)
    print(json.dumps(final_stats(gw)), flush=True)
    gw.close()
    return 0


def final_stats(gw: Gateway, timeout: float = 10.0) -> dict:
    """The gateway's ``stats()`` once every shard has answered a fresh
    stats request, or ``timeout`` seconds have passed. Each shard answers
    after the tasks queued before the request, through the response loop;
    a shard still busy (a forward waiting on its validator) answers late.
    ``workers_missing`` lists the shards that had not answered by the
    deadline, so that a short line never reads as a complete one."""
    import time as _time

    # main() asks for no stats before this, so no older answer is in flight
    gw._worker_stats.clear()
    gw.stats()
    deadline = _time.monotonic() + timeout  # lint: allow(clock: shard stats round trip at shutdown; operator tool, never under sim)
    while (len(gw._worker_stats) < gw.shards
           and _time.monotonic() < deadline):  # lint: allow(clock: shard stats round trip at shutdown; operator tool, never under sim)
        _time.sleep(0.05)  # lint: allow(clock: shard stats round trip at shutdown; operator tool, never under sim)
    out = gw.stats()
    out["workers_missing"] = [i for i in range(gw.shards)
                              if i not in out["workers"]]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
