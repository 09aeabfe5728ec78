"""SubscriberSwarm — thousands of subscriber connections on one thread.

The load side of the gateway bench (docs/clients.md §Benching): a
single selector loop owns M sockets subscribed to one or more hubs,
parses the pushed frames, and tracks per-subscriber ordering (gaps /
out-of-order), push latency (hub send stamp → local receive, same
host), and shed notices. A configurable fraction of subscribers can be
deliberately STALLED (connected + subscribed, never reading) to prove
the hub sheds them without hurting the healthy ones.

Also exports :class:`SubscriberClient`, a tiny blocking single-stream
client for tools and tests that just want one subscription.
"""

from __future__ import annotations

import random
import selectors
import socket
import threading
import time
from typing import Dict, List, Optional

# one implementation of the wire protocol, shared with the server side
from .subhub import _CHUNK, parse_frames, subscribe_frame


class SubscriberClient:
    """One blocking subscription stream (tools, tests, the replica)."""

    def __init__(self, addr: str, start: int = -1, timeout: float = 10.0):
        host, port_s = addr.rsplit(":", 1)
        self._sock = socket.create_connection(
            (host, int(port_s)), timeout=timeout
        )
        self._buf = bytearray()
        self._pending: List[dict] = []
        self._sock.sendall(subscribe_frame(start))
        self.hello = self.recv()
        if self.hello.get("type") != "hello":
            raise ValueError(f"bad hello: {self.hello!r}")

    def recv(self, timeout: Optional[float] = None) -> dict:
        """Next frame, in stream order (blocking; socket.timeout on
        silence)."""
        if timeout is not None:
            self._sock.settimeout(timeout)
        while not self._pending:
            chunk = self._sock.recv(_CHUNK)
            if not chunk:
                raise ConnectionError("stream closed")
            self._buf += chunk
            self._pending.extend(parse_frames(self._buf))
        return self._pending.pop(0)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _Member:
    __slots__ = (
        "sock", "buf", "idx", "stalled", "subscribed", "expected",
        "blocks", "gaps", "shed", "closed", "latencies",
    )

    def __init__(self, sock: socket.socket, idx: int, stalled: bool):
        self.sock = sock
        self.buf = bytearray()
        self.idx = idx
        self.stalled = stalled
        self.subscribed = False
        self.expected: Optional[int] = None  # next block index expected
        self.blocks = 0
        self.gaps = 0
        self.shed: Optional[str] = None
        self.closed = False
        self.latencies: List[float] = []


class SubscriberSwarm:
    """``addrs`` round-robins subscribers across hubs. ``stall_frac``
    of members never read after subscribing (slow-consumer bait).
    ``latency_sample`` bounds stored latency samples per member."""

    def __init__(
        self,
        addrs: List[str],
        n: int,
        start: int = -1,
        stall_frac: float = 0.0,
        latency_sample: int = 64,
        connect_timeout: float = 10.0,
    ):
        self.addrs = list(addrs)
        self.n = int(n)
        self.start = start
        self.stall_count = int(round(self.n * stall_frac))
        self.latency_sample = latency_sample
        self.connect_timeout = connect_timeout
        self._sel = selectors.DefaultSelector()
        self._members: List[_Member] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.connect_errors = 0

    # -- lifecycle -----------------------------------------------------------

    def start_all(self) -> None:
        """Connect + subscribe everyone (blocking), then run the read
        loop in the background. Stalled members are chosen as the FIRST
        ``stall_count`` indexes so tests can name them."""
        for i in range(self.n):
            addr = self.addrs[i % len(self.addrs)]
            host, port_s = addr.rsplit(":", 1)
            stalled = i < self.stall_count
            try:
                if stalled:
                    # a tiny receive buffer keeps the kernel from hiding
                    # the stall: the hub sees backpressure after a few
                    # KB instead of after megabytes of OS buffering
                    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
                    sock.settimeout(self.connect_timeout)
                    sock.connect((host, int(port_s)))
                else:
                    sock = socket.create_connection(
                        (host, int(port_s)), timeout=self.connect_timeout
                    )
            except OSError:
                self.connect_errors += 1
                continue
            sock.setblocking(False)
            m = _Member(sock, i, stalled=stalled)
            try:
                sock.sendall(subscribe_frame(self.start))
            except OSError:
                self.connect_errors += 1
                continue
            # stalled members subscribe but never register for reads —
            # the socket buffer fills and the hub must shed them
            if not m.stalled:
                self._sel.register(sock, selectors.EVENT_READ, m)
            self._members.append(m)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="swarm-loop"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        for m in self._members:
            try:
                m.sock.close()
            except OSError:
                pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            for key, _ in self._sel.select(timeout=0.1):
                self._readable(key.data)

    def _readable(self, m: _Member) -> None:
        try:
            while True:
                chunk = m.sock.recv(_CHUNK)
                if not chunk:
                    self._close(m)
                    return
                m.buf += chunk
                if len(chunk) < _CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(m)
            return
        now = time.time()  # lint: allow(clock: client-side latency measurement tool; never runs under sim)
        try:
            frames = parse_frames(m.buf)
        except ValueError:
            self._close(m)
            return
        for fr in frames:
            kind = fr.get("type")
            if kind == "hello":
                m.subscribed = True
                m.expected = fr.get("next")
            elif kind == "block":
                idx = fr.get("block", {}).get("Body", {}).get("Index")
                if m.expected is not None and idx != m.expected:
                    m.gaps += 1
                m.expected = (idx + 1) if isinstance(idx, int) else None
                m.blocks += 1
                ts = fr.get("ts")
                if isinstance(ts, (int, float)):
                    if len(m.latencies) >= self.latency_sample:
                        m.latencies[
                            random.randrange(self.latency_sample)  # lint: allow(clock: reservoir sampling in a client-side tool)
                        ] = now - ts
                    else:
                        m.latencies.append(now - ts)
            elif kind == "shed":
                m.shed = fr.get("reason", "?")

    def _close(self, m: _Member) -> None:
        if m.closed:
            return
        m.closed = True
        try:
            self._sel.unregister(m.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            m.sock.close()
        except OSError:
            pass

    # -- observations --------------------------------------------------------

    @property
    def members(self) -> List[_Member]:
        return self._members

    def healthy(self) -> List[_Member]:
        return [m for m in self._members if not m.stalled]

    def stats(self) -> Dict[str, object]:
        healthy = self.healthy()
        lats = sorted(
            lat for m in healthy for lat in m.latencies
        )

        def pct(q: float):
            if not lats:
                return None
            import math

            return lats[min(len(lats) - 1, math.ceil(q * len(lats)) - 1)]

        return {
            "subscribers": len(self._members),
            "stalled": self.stall_count,
            "connect_errors": self.connect_errors,
            "blocks_received": sum(m.blocks for m in healthy),
            "min_blocks": min((m.blocks for m in healthy), default=0),
            "gaps": sum(m.gaps for m in healthy),
            "shed_notices": sum(
                1 for m in self._members if m.shed is not None
            ),
            "closed": sum(1 for m in healthy if m.closed),
            "push_latency_p50_s": pct(0.50),
            "push_latency_p99_s": pct(0.99),
            "latency_samples": len(lats),
        }
