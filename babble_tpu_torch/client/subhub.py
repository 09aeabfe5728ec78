"""Streaming commit subscriptions (docs/clients.md §Subscriptions).

``SubscriptionHub`` is a one-thread selector-loop push server (the
net/atcp.py pattern applied to the read path): N long-lived subscriber
connections are multiplexed on a single selector, so serving 10k
subscribers costs one thread and no per-client polling of ``/history``.

Wire protocol (every frame: 4-byte big-endian length + canonical JSON):

    client -> hub   {"type": "subscribe", "from": <index|-1>}
    hub -> client   {"type": "hello", "last": <sealed head>, "next":
                     <first index this stream will push>, "moniker": m}
                    {"type": "block", "ts": <hub send stamp, s>,
                     "block": <Block.to_dict()>}   # strictly in order
                    {"type": "shed", "reason": <slug>}   # then close

``from`` = first block index wanted (backfilled from the store);
``-1``/omitted = live tail only. Blocks are pushed only once SEALED —
carrying MORE than 1/3 validator signatures — so every pushed block
verifies offline (client.verifier.verify_block) and doubles as its own
inclusion proof substrate.

Flow control: each subscriber owns a bounded frame queue
(``queue_frames``); the hub never buffers beyond it — a lagging
subscriber simply reads older blocks out of the store at its own pace.
A subscriber is SHED (counter + shed frame + close) when it stalls
(no socket progress with queued data for ``stall_timeout_s``) or trails
the sealed head by more than ``shed_lag`` blocks — one stuck consumer
can never hold memory or delay the others, because per-subscriber
queues are independent and writes are non-blocking.

Block frames are encoded ONCE per block (bounded cache) and the same
bytes object is queued to every subscriber.
"""

from __future__ import annotations

import json
import selectors
import socket
import struct
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..crypto.canonical import jsonable

_U32 = struct.Struct(">I")
_CHUNK = 1 << 16
#: inbound frames are a single small subscribe request
MAX_REQUEST = 4096
#: largest pushed frame a CLIENT accepts (client.swarm imports this —
#: both halves of the protocol live in this module so they cannot drift)
MAX_FRAME = 64 << 20
#: encoded block frames kept for re-push to lagging subscribers
FRAME_CACHE = 1024


def pack_frame(obj: dict) -> bytes:
    """Envelope framing: sorted-key compact JSON (NOT canonical_dumps —
    the envelope legitimately carries a float send stamp, which the
    consensus codec rejects by design; the block payload inside is
    already canonical-normalized)."""
    body = json.dumps(
        obj, sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode("utf-8")
    return _U32.pack(len(body)) + body


def subscribe_frame(start: int) -> bytes:
    """The one client→hub request."""
    return pack_frame({"type": "subscribe", "from": int(start)})


def parse_frames(buf: bytearray, max_frame: int = MAX_FRAME) -> List[dict]:
    """Consume every complete frame in ``buf`` (mutates it) — the
    client-side decoder twin of pack_frame. Every frame must be a JSON
    OBJECT: a valid-JSON-but-not-a-dict body (``[1,2]``, ``42``) from a
    hostile peer must fail HERE as a protocol error, not later as an
    AttributeError inside whatever loop called ``frame.get(...)``."""
    out: List[dict] = []
    while len(buf) >= 4:
        (length,) = _U32.unpack_from(buf, 0)
        if length > max_frame:
            raise ValueError("oversized frame")
        if len(buf) < 4 + length:
            break
        frame = json.loads(bytes(buf[4:4 + length]))
        if not isinstance(frame, dict):
            raise ValueError(f"frame is not an object: {type(frame).__name__}")
        out.append(frame)
        del buf[:4 + length]
    return out


def encode_block_frame(block, ts: Optional[float] = None) -> bytes:
    """The pushed block frame. ``ts`` (hub wall clock at encode) lets a
    same-host subscriber measure push latency; it is omitted when None
    so deterministic-sim digests stay stable across runs."""
    obj: dict = {"type": "block", "block": jsonable(block.to_dict())}
    if ts is not None:
        obj["ts"] = ts
    return pack_frame(obj)


class _Sub:
    """One subscriber connection owned by the hub loop thread."""

    __slots__ = (
        "sock", "rbuf", "wq", "wq_frames", "wview", "subscribed", "next",
        "next0", "last0", "stalled_since", "wait_since", "closed",
    )

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wq: List[bytes] = []
        self.wq_frames = 0          # queued frames (the bound)
        self.wview: Optional[memoryview] = None
        self.subscribed = False
        self.next = 0               # next block index to push
        self.next0 = 0              # first index at subscribe time
        self.last0 = -1             # committed head at subscribe time
        self.stalled_since: Optional[float] = None
        self.wait_since: Optional[float] = None  # next unfetchable since
        self.closed = False


class SubscriptionHub:
    """``block_source(i)`` must return a SEALED block (> 1/3 validator
    signatures) or None (not committed / not sealed yet / evicted) — the
    hub re-polls Nones on its tick. ``publish(index)`` is the commit
    hook: O(1), safe from any thread, never blocks consensus."""

    def __init__(
        self,
        bind_addr: str,
        block_source: Callable[[int], Optional[object]],
        moniker: str = "",
        queue_frames: int = 256,
        stall_timeout_s: float = 10.0,
        shed_lag: int = 1024,
        sndbuf: int = 0,
        clock=None,
    ):
        from ..common.clock import WALL

        self._bind_addr = bind_addr
        self._source = block_source
        self._moniker = moniker
        self.queue_frames = max(1, int(queue_frames))
        self.stall_timeout_s = float(stall_timeout_s)
        self.shed_lag = max(1, int(shed_lag))
        # Cap the kernel send buffer per subscriber socket (0 = OS
        # default): a stalled consumer then backs up into the hub's
        # OWN bounded queue quickly, making the stall timer (and the
        # shed) deterministic instead of hiding behind megabytes of
        # kernel buffering.
        self.sndbuf = int(sndbuf)
        self._clock = clock or WALL
        self._sel = selectors.DefaultSelector()
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        # the write end must be non-blocking too: publish() runs on the
        # CONSENSUS commit path, and a full socketpair buffer (hub loop
        # busy while commits keep arriving) must drop the redundant wake
        # byte (BlockingIOError ⊂ OSError, swallowed below), never block
        # Core.commit
        self._wake_w.setblocking(False)
        self._subs: List[_Sub] = []
        self._frames: "OrderedDict[int, bytes]" = OrderedDict()
        #: highest COMMITTED block index published to us (sealing may
        #: trail it; -1 before the first commit)
        self.last_published = -1
        # -- counters (obs catalog client_* instruments read these) ----
        self.subscribers_total = 0
        self.pushed_blocks = 0
        self.shed_total = 0
        self.shed_reasons: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    def listen(self) -> str:
        host, port_s = self._bind_addr.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", int(port_s)))
        srv.listen(512)
        srv.setblocking(False)
        self._listener = srv
        self._bind_addr = f"{host}:{srv.getsockname()[1]}"
        self._sel.register(srv, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="subhub-loop"
        )
        self._thread.start()
        return self._bind_addr

    @property
    def bind_addr(self) -> str:
        return self._bind_addr

    def close(self) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self._wakeup()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        else:
            self._teardown()

    # -- the commit hook -----------------------------------------------------

    def publish(self, index: int) -> None:
        """Called from the consensus commit path: advance the head
        watermark and wake the loop. Never blocks, never raises."""
        if index > self.last_published:
            self.last_published = index
        self._wakeup()

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        subs = self._subs
        return {
            "subscribers": sum(1 for s in subs if not s.closed),
            "subscribers_total": self.subscribers_total,
            "queue_frames_max": max(
                (s.wq_frames for s in subs if not s.closed), default=0
            ),
            "pushed_blocks": self.pushed_blocks,
            "shed": self.shed_total,
            "shed_reasons": dict(self.shed_reasons),
            "last_published": self.last_published,
        }

    # -- loop ----------------------------------------------------------------

    def _loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                for key, events in self._sel.select(timeout=0.1):
                    data = key.data
                    if data == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    elif data == "accept":
                        self._accept()
                    elif isinstance(data, _Sub):
                        if events & selectors.EVENT_READ:
                            self._readable(data)
                        if events & selectors.EVENT_WRITE and not data.closed:
                            self._flush(data)
                self._pump()
        finally:
            self._teardown()

    def _teardown(self) -> None:
        for sub in list(self._subs):
            self._drop(sub)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except Exception:  # noqa: BLE001 — double-teardown is benign
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _accept(self) -> None:
        assert self._listener is not None
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self.sndbuf > 0:
                    sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDBUF, self.sndbuf
                    )
            except OSError:
                pass
            sub = _Sub(sock)
            try:
                self._sel.register(sock, selectors.EVENT_READ, sub)
            except (ValueError, OSError):
                try:
                    sock.close()
                except OSError:
                    continue
                continue
            self._subs.append(sub)

    def _readable(self, sub: _Sub) -> None:
        try:
            chunk = sub.sock.recv(_CHUNK)
            if not chunk:
                self._drop(sub)
                return
            sub.rbuf += chunk
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(sub)
            return
        if sub.subscribed:
            # subscribers only read; anything further is protocol abuse
            if len(sub.rbuf) > MAX_REQUEST:
                self._shed(sub, "protocol")
            return
        if len(sub.rbuf) < 4:
            return
        (length,) = _U32.unpack_from(sub.rbuf, 0)
        if length > MAX_REQUEST:
            self._shed(sub, "protocol")
            return
        if len(sub.rbuf) < 4 + length:
            return
        try:
            req = json.loads(bytes(sub.rbuf[4:4 + length]))
            del sub.rbuf[:4 + length]
            # hostile input: the body must be an OBJECT before any
            # .get() — a bare list/number here must shed THIS client,
            # never escape into the loop and tear the hub down
            if not isinstance(req, dict) or req.get("type") != "subscribe":
                raise ValueError("not a subscribe request")
            start = int(req.get("from", -1))
        except (ValueError, TypeError, KeyError):
            self._shed(sub, "protocol")
            return
        sealed = self._sealed_head()
        sub.next = sealed + 1 if start < 0 else start
        sub.next0 = sub.next
        sub.last0 = self.last_published
        sub.subscribed = True
        self.subscribers_total += 1
        self._enqueue(
            sub,
            pack_frame(
                {
                    "type": "hello",
                    "last": sealed,
                    "next": sub.next,
                    "moniker": self._moniker,
                }
            ),
            count_block=False,
        )

    def _sealed_head(self) -> int:
        """Highest index known sealed RIGHT NOW (walks back from the
        committed head; bounded by the frame the cache covers)."""
        i = self.last_published
        floor = max(-1, i - 4)  # sealing trails commits by a round or two
        while i > floor:
            if i in self._frames or self._fetch(i) is not None:
                return i
            i -= 1
        return i

    # -- pushing -------------------------------------------------------------

    def _fetch(self, index: int) -> Optional[bytes]:
        """Encoded frame for one sealed block; None while unsealed."""
        frame = self._frames.get(index)
        if frame is not None:
            self._frames.move_to_end(index)
            return frame
        try:
            block = self._source(index)
        except Exception:  # noqa: BLE001 — store faults must not kill the loop
            return None
        if block is None:
            return None
        frame = encode_block_frame(block, ts=self._clock.time())
        self._frames[index] = frame
        while len(self._frames) > FRAME_CACHE:
            self._frames.popitem(last=False)
        return frame

    def _pump(self) -> None:
        """Advance every subscriber: queue sealed blocks up to the
        per-subscriber bound, then enforce the shed policies."""
        now = self._clock.monotonic()
        for sub in list(self._subs):
            if sub.closed or not sub.subscribed:
                continue
            blocked_unfetchable = False
            while (
                sub.wq_frames < self.queue_frames
                and sub.next <= self.last_published
            ):
                frame = self._fetch(sub.next)
                if frame is None:
                    # not sealed yet (or evicted) — re-poll next tick
                    blocked_unfetchable = True
                    break
                sub.wait_since = None
                self._enqueue(sub, frame)
                sub.next += 1
            if sub.closed:
                continue
            # A block that stays unfetchable while LATER blocks are
            # servable fell out of the store's retention — re-polling
            # would spin forever. Shed with a distinct reason so the
            # client knows to resync from a checkpoint instead of
            # reconnecting at the same index. (Plain sealing lag clears
            # in a round or two and never has a later index cached.)
            if blocked_unfetchable:
                if sub.wait_since is None:
                    sub.wait_since = now
                elif now - sub.wait_since > max(
                    2 * self.stall_timeout_s, 10.0
                ) and any(i > sub.next for i in self._frames):
                    self._shed(sub, "behind_retention")
                    continue
            else:
                sub.wait_since = None
            # stall detection: queued data but zero socket progress
            if sub.wq or sub.wview is not None:
                if sub.stalled_since is None:
                    sub.stalled_since = now
                elif (
                    self.stall_timeout_s > 0
                    and now - sub.stalled_since > self.stall_timeout_s
                ):
                    self._shed(sub, "stalled")
                    continue
            else:
                sub.stalled_since = None
            # deficit shed: blocks committed since subscribe minus blocks
            # delivered since subscribe — a consumer chronically slower
            # than production. Instantaneous lag would wrongly shed a
            # healthy backfiller that subscribed from old history.
            deficit = (self.last_published - sub.last0) - (
                sub.next - sub.next0
            )
            if deficit > self.shed_lag:
                self._shed(sub, "lagging")

    def _enqueue(self, sub: _Sub, frame: bytes, count_block: bool = True) -> None:
        sub.wq.append(frame)
        sub.wq_frames += 1
        if count_block:
            self.pushed_blocks += 1
        self._flush(sub)

    def _flush(self, sub: _Sub) -> None:
        try:
            while sub.wview is not None or sub.wq:
                if sub.wview is None:
                    sub.wview = memoryview(sub.wq.pop(0))
                    sub.wq_frames -= 1
                n = sub.sock.send(sub.wview)
                sub.stalled_since = None
                if n < len(sub.wview):
                    sub.wview = sub.wview[n:]
                    break
                sub.wview = None
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(sub)
            return
        self._interest(sub)

    def _interest(self, sub: _Sub) -> None:
        mask = selectors.EVENT_READ
        if sub.wq or sub.wview is not None:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(sub.sock, mask, sub)
        except (KeyError, ValueError, OSError):
            pass

    # -- shedding ------------------------------------------------------------

    def _shed(self, sub: _Sub, reason: str) -> None:
        self.shed_total += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        try:  # best-effort goodbye; a truly stalled socket just drops it
            sub.sock.send(pack_frame({"type": "shed", "reason": reason}))
        except OSError:
            pass
        self._drop(sub)

    def _drop(self, sub: _Sub) -> None:
        if sub.closed:
            return
        sub.closed = True
        try:
            self._sel.unregister(sub.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            sub.sock.close()
        except OSError:
            pass
        sub.wq.clear()
        sub.wview = None
        try:
            self._subs.remove(sub)
        except ValueError:
            pass
