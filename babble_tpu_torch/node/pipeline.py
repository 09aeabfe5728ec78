"""SyncPipeline: bounded decode → batch-verify → insert staging for
inbound eager syncs AND the gossip pull leg.

The seed shape ran each inbound sync's whole life on one routine
thread: decode + batch-verify (lock-free since the batched-ingest fast
path) and then the insert tail under the core lock. Under 16-node load
that parks a pile of handler threads on the core lock, each holding its
decoded batch, convoying on the GIL (the `lock_wait_ms` counters
localize exactly this).

This pipeline splits the stages explicitly:

- **Stage 1 (caller thread, lock-free, concurrent):** decode + one
  native batch signature verification per sync (``Core.prepare_sync``)
  — many inbound syncs overlap here.
- **Stage 2 (one inserter thread, serialized):** the ordered insert +
  DivideRounds tail under the core lock — the only part that MUST be
  serial, drained by a single thread so handler threads never queue on
  the lock itself.

Two kinds of work ride the same bounded queue (one FIFO, one inserter,
so per-peer arrival order is preserved across both):

- **eager syncs** (``submit``): a remote push with an RPC to answer —
  the response fires after the insert lands;
- **pulled syncs** (``submit_pull``): the events OUR gossip round
  pulled from a peer. Pre-pipeline, ``Node._pull`` ran the insert on
  the gossip thread under the core lock, so one slow insert stalled
  the next pull round-trip; staged, the gossip thread is free the
  moment stage 1 finishes and the pull leg's latency is the wire
  round-trip, not the insert.

The hand-off queue is **bounded**: when inserts fall behind, submitters
block (briefly) and then run the insert inline — so the transport's
read loop (or the pull gossip loop) ultimately slows down instead of
the node buffering unbounded decoded batches (backpressure). The
``inflight`` gauge (and its high-water mark) is the
`gossip_inflight_syncs` instrument. On top of the hard queue bound, the
adaptive scheduler (node/adaptive.py) publishes a **soft depth cap**:
under ingest congestion the pipeline treats a shallower queue as
"full", so backpressure reaches senders before the hard bound does.

The pipeline is wall-clock only: the deterministic sim engine drives
``_process_rpc`` single-threaded under virtual time, where a background
inserter thread would break replay determinism — Node only constructs
the pipeline when its clock is the process wall clock (which also keeps
the pull leg inline, and deterministic, under sim).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ..common.timed_lock import named_lock


class _PullSync:
    """Stand-in for the RPC command on a pulled batch: just the fields
    the insert tail needs. ``rpc is None`` marks a pull job in the
    queue — there is no remote caller to answer."""

    __slots__ = ("from_id", "events")

    def __init__(self, from_id: int, events: list):
        self.from_id = from_id
        self.events = events


class SyncPipeline:
    def __init__(self, node, queue_cap: int = 64, submit_timeout: float = 5.0):
        self.node = node
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=max(1, queue_cap))
        self._submit_timeout = submit_timeout
        # Named for the BABBLE_LOCKCHECK order recorder (lockcheck.py).
        self._lock = named_lock("pipeline")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Signaled by the inserter after each drained item: soft-capped
        # submitters wait on it instead of polling (or queue-jumping).
        self._drained = threading.Condition()
        # -- instruments (obs/catalog.py: gossip_*) --
        self.inflight = 0            # syncs between submit and respond
        self.inflight_peak = 0       # high-water mark
        self.pipelined_syncs = 0     # syncs that went through the queue
        self.pull_pipelined = 0      # of which: gossip pull legs
        self.backpressure_stalls = 0  # submits that found the queue full
        # Soft depth cap (adaptive scheduler): submits treat the queue
        # as full at this depth; the hard Queue bound stays the ceiling.
        self.soft_depth = max(1, queue_cap)

    # -- lifecycle -----------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                if self._thread is None or not self._thread.is_alive():
                    if self._stop.is_set():
                        return
                    self._thread = threading.Thread(
                        target=self._insert_loop, daemon=True,
                        name="sync-inserter",
                    )
                    self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._drain_stopped()

    def set_soft_depth(self, depth: int) -> None:
        """Adaptive backpressure threshold (clamped to the hard bound)."""
        self.soft_depth = max(1, min(self._q.maxsize, int(depth)))

    def _drain_stopped(self) -> None:
        """Politely fail anything still queued so clients see an error
        instead of a silent timeout. Called by stop() and by any
        submit() that raced past the stop check — either way every
        queued RPC gets an answer and the inflight gauge balances.
        Pull jobs (rpc None) have no caller to answer; their events
        simply don't land, which a shutting-down node is allowed."""
        while True:
            try:
                rpc, _cmd, _prepared, _hop = self._q.get_nowait()
            except queue.Empty:
                break
            self._dec_inflight()
            if rpc is None:
                continue
            try:
                rpc.respond(None, "node shutting down")
            except Exception:
                pass

    # -- stages --------------------------------------------------------------

    def submit(self, rpc, cmd, hop) -> bool:
        """Stage 1 in the caller's thread, then enqueue the insert tail.
        Returns False when the pipeline is stopped (caller handles the
        sync inline, the pre-pipeline shape)."""
        if self._stop.is_set():
            return False
        self._ensure_thread()
        if self._thread is None:
            return False
        self._inc_inflight()
        try:
            prepared = self.node.core.prepare_sync(cmd.events)
        except Exception as e:
            # answer here rather than returning False: the inline
            # fallback would re-run the whole decode + native batch
            # verify, doubling the CPU a hostile malformed batch costs.
            # _fail_eager_sync keeps the sentry attribution (peer-fault
            # rejections score the sender, crashes count rpc_errors).
            self._dec_inflight()
            try:
                self.node._fail_eager_sync(rpc, cmd, e)
            except Exception:
                pass
            return True
        self._enqueue(rpc, cmd, prepared, hop)
        return True

    def submit_pull(self, from_id: int, events: list, hop) -> bool:
        """The pull leg's staging: decode + batch-verify in the calling
        gossip thread (stage 1), insert tail through the shared bounded
        queue. Returns False when the pipeline is stopped — the caller
        runs the pre-pipeline inline shape. A stage-1 failure PROPAGATES
        to the caller: `_gossip` must see it exactly like the inline
        pull path's (skip the push leg, score the serving peer through
        the sentry, record the contact as failed) — swallowing it here
        would keep pushing to, and health-boosting, a peer whose every
        batch fails verification."""
        if self._stop.is_set():
            return False
        self._ensure_thread()
        if self._thread is None:
            return False
        self._inc_inflight()
        cmd = _PullSync(from_id, events)
        try:
            prepared = self.node.core.prepare_sync(events)
        except Exception:
            self._dec_inflight()
            raise
        if self._enqueue(None, cmd, prepared, hop):
            # counted only when the insert tail actually left this
            # thread — a backpressure-degraded inline insert must not
            # read as "pipelined" (the acceptance metric's contract)
            self.pull_pipelined += 1
        return True

    def _enqueue(self, rpc, cmd, prepared, hop) -> bool:
        """Shared insert-tail hand-off: bounded put with the soft-depth
        early-full check; sustained pressure degrades to an inline
        insert on the submitter's thread (the backpressure contract).
        Returns True when the job was handed to the inserter, False
        when it degraded to an inline insert."""
        if self._q.qsize() >= self.soft_depth:
            # adaptive soft cap hit: BLOCK this submitter until the
            # inserter drains below the cap (or the timeout passes) —
            # early backpressure that still goes through the FIFO.
            # Running the insert inline here instead would jump the
            # queue and reorder a peer's batches against its earlier
            # ones still waiting (insert failures the sentry would then
            # score against an honest peer); ordering is the pipeline's
            # contract, so the only inline path left is the wedged-
            # inserter timeout fallback below, same as pre-soft-cap.
            self.backpressure_stalls += 1
            deadline = self.node.clock.monotonic() + self._submit_timeout
            with self._drained:
                while (
                    self._q.qsize() >= self.soft_depth
                    and not self._stop.is_set()
                    and self.node.clock.monotonic() < deadline
                ):
                    self._drained.wait(timeout=0.05)
            # the put below spends what is LEFT of the same budget — a
            # wedged inserter must degrade to the inline fallback after
            # one submit_timeout total, not two back to back
            budget = max(0.05, deadline - self.node.clock.monotonic())
        else:
            budget = self._submit_timeout
        try:
            self._q.put((rpc, cmd, prepared, hop), timeout=budget)
        except queue.Full:
            if rpc is None:
                # wedged-inserter fallback, pull flavor: DROP the batch
                # rather than insert it out of order ahead of the same
                # peer's queued earlier batches (the resulting unknown-
                # parent rejections would sentry-score an honest peer).
                # Pulls are idempotent — the next round re-fetches —
                # and the timeout above already was the backpressure.
                self._dec_inflight()
                return False
            self._finish_inline(rpc, cmd, prepared, hop)
            return False
        if self._stop.is_set():
            # raced with stop(): the inserter may already be gone and
            # stop()'s drain may have run before our put landed —
            # drain again so this RPC cannot hang unanswered
            self._drain_stopped()
        self.pipelined_syncs += 1
        return True

    def _finish_inline(self, rpc, cmd, prepared, hop) -> None:
        try:
            if rpc is None:
                self.node._finish_pulled_sync(
                    cmd.from_id, cmd.events, prepared, hop
                )
            else:
                self.node._finish_eager_sync(rpc, cmd, prepared, hop)
        finally:
            self._dec_inflight()

    def _insert_loop(self) -> None:
        while not self._stop.is_set():
            try:
                rpc, cmd, prepared, hop = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                # same dispatch as the inline-degrade path (one place)
                self._finish_inline(rpc, cmd, prepared, hop)
            except Exception:
                # the finishers answer/attribute internally; a crash
                # here must not kill the inserter for every later sync
                pass
            finally:
                with self._drained:
                    self._drained.notify_all()

    def _inc_inflight(self) -> None:
        with self._lock:
            self.inflight += 1
            if self.inflight > self.inflight_peak:
                self.inflight_peak = self.inflight

    def _dec_inflight(self) -> None:
        with self._lock:
            self.inflight -= 1

    def queue_depth(self) -> int:
        """Prepared syncs waiting in the bounded insert queue right now
        (the gossip_pipeline_queue_depth gauge — live backpressure,
        where the stall counters only show history)."""
        return self._q.qsize()

    def stats(self) -> dict:
        return {
            "gossip_inflight_syncs": self.inflight,
            "gossip_inflight_syncs_peak": self.inflight_peak,
            "gossip_pipelined_syncs": self.pipelined_syncs,
            "gossip_pull_pipelined_syncs": self.pull_pipelined,
            "gossip_backpressure_stalls": self.backpressure_stalls,
            "gossip_pipeline_queue_depth": self.queue_depth(),
            "gossip_pipeline_soft_depth": self.soft_depth,
        }

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Test/shutdown helper: block until nothing is in flight.
        Deliberately WALL time: the pipeline is auto-disabled under an
        injected sim clock, and its workers are real threads — a virtual
        deadline would never advance while polling them."""
        from ..common.clock import WALL

        deadline = WALL.monotonic() + timeout
        while WALL.monotonic() < deadline:
            with self._lock:
                if self.inflight == 0:
                    return True
            WALL.sleep(0.005)
        return False
