"""TCP transport: typed RPC framing over pooled sockets.

Wire format mirrors the reference's (adapted-from-raft) framing
(src/net/net_transport.go:39-50,274-441): one RPC type
byte, then the JSON request; the response is an error string + JSON
payload. Here both directions are length-prefixed (4-byte big-endian)
JSON — same shape, explicit frame boundaries — with bytes fields base64
encoded by the canonical codec.

Server side: an accept loop; each connection gets a handler thread that
decodes requests, parks them on the node's consumer queue as RPC
envelopes, and relays the node's response (net_transport.go:321-441).
Client side: a per-target connection pool capped at ``max_pool``
(net_transport.go:161-219).
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..crypto.canonical import canonical_dumps
from .codec import CODEC_STATS
from .rpc import (
    JoinRequest,
    REQUEST_TYPES,
    RESPONSE_TYPES,
    RPC,
    TYPE_OF_REQUEST,
)
from .transport import RemoteError, TransportError


# Upper bound on any frame (request or response). A hostile peer could
# otherwise send a 4 GB length prefix and make the receiver allocate it.
MAX_FRAME = 64 * 1024 * 1024


class _ConnError(TransportError):
    """Connection-level failure (socket died mid-RPC) — retryable on a
    fresh dial, unlike a remote handler error, which means the peer
    received, processed, and answered the request."""


class _RecvBuffer:
    """One reusable receive buffer per connection: ``recv_into`` a
    pre-allocated bytearray instead of building each frame through
    per-call ``bytes`` concatenation (which allocated and copied
    O(chunks) intermediates per frame on the ingest hot path). The
    buffer grows to the largest frame the connection has seen and is
    reused for every subsequent read."""

    __slots__ = ("_buf",)

    def __init__(self, initial: int = 1 << 16):
        self._buf = bytearray(initial)

    def recv_exact(self, sock: socket.socket, n: int) -> bytes:
        if n > MAX_FRAME:
            raise ConnectionError(f"frame of {n} bytes exceeds limit")
        if len(self._buf) < n:
            self._buf = bytearray(n)
        view = memoryview(self._buf)
        got = 0
        while got < n:
            r = sock.recv_into(view[got:n])
            if not r:
                raise ConnectionError("connection closed")
            got += r
        CODEC_STATS.bytes_received += n
        return bytes(view[:n])


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """One-shot exact read (no connection to hang a buffer on)."""
    return _RecvBuffer(min(n, 1 << 16)).recv_exact(sock, n)


def _send_frame(sock: socket.socket, type_byte: Optional[int], payload: bytes) -> None:
    head = bytes([type_byte]) if type_byte is not None else b""
    data = head + struct.pack(">I", len(payload)) + payload
    sock.sendall(data)
    CODEC_STATS.bytes_sent += len(data)


class TCPTransport:
    """reference: net/tcp_transport.go:18-77 + net_transport.go."""

    def __init__(
        self,
        bind_addr: str,
        advertise_addr: Optional[str] = None,
        max_pool: int = 3,
        timeout: float = 10.0,
        join_timeout: Optional[float] = None,
        dial_timeout: Optional[float] = None,
    ):
        self._bind_addr = bind_addr
        self._advertise = advertise_addr or bind_addr
        self._timeout = timeout
        # Dial (connect) deadline, separate from the RPC deadline: a dead
        # host should fail the dial in seconds, not hold a gossip round
        # for the full RPC timeout.
        self._dial_timeout = (
            dial_timeout if dial_timeout is not None else min(timeout, 3.0)
        )
        # Join/leave RPCs block on consensus server-side, so they get their
        # own, much longer deadline (reference keeps these separate:
        # node_rpc.go join waits JoinTimeout while syncs use TCPTimeout).
        self._join_timeout = join_timeout if join_timeout is not None else max(
            timeout, 10.0
        )
        self._max_pool = max_pool
        self._consumer: "queue.Queue[RPC]" = queue.Queue()
        self._listener: Optional[socket.socket] = None
        self._pool: Dict[str, List[socket.socket]] = {}
        self._pool_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        # Pool-hardening counters: stale pooled sockets evicted mid-RPC,
        # and RPCs salvaged by the one fresh-dial retry.
        self.pool_evictions = 0
        self.retries = 0

    # -- Transport interface -------------------------------------------------

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._bind_addr

    def advertise_addr(self) -> str:
        return self._advertise

    def listen(self) -> None:
        if self._listener is not None:  # idempotent (Node.init also calls it)
            return
        host, port_s = self._bind_addr.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", int(port_s)))
        srv.listen(64)
        self._listener = srv
        # rewrite port 0 to the assigned one so tests can bind ephemeral
        if int(port_s) == 0:
            port = srv.getsockname()[1]
            self._bind_addr = f"{host}:{port}"
            if self._advertise.endswith(":0"):
                self._advertise = f"{self._advertise.rsplit(':', 1)[0]}:{port}"
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        self._shutdown.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._pool_lock:
            for conns in self._pool.values():
                for c in conns:
                    try:
                        c.close()
                    except OSError:
                        pass
            self._pool.clear()

    # -- server side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        """One request/response at a time per connection
        (reference: net_transport.go:355-441)."""
        rbuf = _RecvBuffer()  # reused across every frame on this conn
        try:
            while not self._shutdown.is_set():
                type_byte = rbuf.recv_exact(conn, 1)[0]
                (length,) = struct.unpack(">I", rbuf.recv_exact(conn, 4))
                payload = rbuf.recv_exact(conn, length)
                req_cls = REQUEST_TYPES.get(type_byte)
                if req_cls is None:
                    _send_frame(
                        conn,
                        None,
                        canonical_dumps(
                            {"error": f"unknown rpc type {type_byte}", "payload": None}
                        ),
                    )
                    continue
                command = req_cls.from_dict(json.loads(payload))
                rpc = RPC(command)
                rpc.recv_ts = time.time()  # lint: allow(clock: recv_ts is a real-wire arrival stamp; sim uses SimTransport)
                self._consumer.put(rpc)
                # Joins park on a consensus promise in the handler; give the
                # node's own join deadline room to fire first (+2 s margin).
                wait_timeout = (
                    self._join_timeout + 2.0
                    if isinstance(command, JoinRequest)
                    else self._timeout
                )
                try:
                    result, error = rpc.wait(timeout=wait_timeout)
                except queue.Empty:
                    result, error = None, "rpc handler timeout"
                body = {
                    "error": error,
                    "payload": result.to_dict() if result is not None else None,
                }
                _send_frame(conn, None, canonical_dumps(body))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- client side ---------------------------------------------------------

    def _checkout(self, target: str) -> Tuple[socket.socket, bool]:
        """A connection to ``target``: (socket, came_from_pool)."""
        with self._pool_lock:
            conns = self._pool.get(target)
            if conns:
                return conns.pop(), True
        return self._dial(target), False

    def _dial(self, target: str) -> socket.socket:
        host, port_s = target.rsplit(":", 1)
        try:
            sock = socket.create_connection(
                (host, int(port_s)), timeout=self._dial_timeout
            )
        except OSError as err:
            raise TransportError(f"dial {target}: {err}") from err
        sock.settimeout(self._timeout)
        return sock

    def _evict_pool(self, target: str) -> None:
        """A pooled socket to ``target`` just failed mid-RPC; its pool
        siblings were checked in around the same time and are almost
        certainly stale too (peer restarted) — close them all rather than
        paying one failed RPC per corpse."""
        with self._pool_lock:
            conns = self._pool.pop(target, [])
            self.pool_evictions += 1 + len(conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _checkin(self, target: str, sock: socket.socket) -> None:
        sock.settimeout(self._timeout)  # undo any per-request deadline
        with self._pool_lock:
            conns = self._pool.setdefault(target, [])
            if len(conns) < self._max_pool:
                conns.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _request(self, target: str, req, timeout: Optional[float] = None):
        """One RPC. A failure on a POOLED socket is most often a stale
        connection (the peer restarted between RPCs), not a dead peer:
        evict the target's pool and retry ONCE on a fresh dial before
        surfacing TransportError. Handlers are idempotent (hashgraph
        inserts dedupe), so the at-most-one duplicate delivery a retry
        can cause is safe. Fresh-dial failures surface immediately."""
        type_byte = TYPE_OF_REQUEST[type(req)]
        sock, pooled = self._checkout(target)
        try:
            return self._roundtrip(target, sock, type_byte, req, timeout)
        except _ConnError:
            if not pooled:
                raise
            self._evict_pool(target)
            self.retries += 1
            sock = self._dial(target)
            return self._roundtrip(target, sock, type_byte, req, timeout)

    def _roundtrip(
        self,
        target: str,
        sock: socket.socket,
        type_byte: int,
        req,
        timeout: Optional[float],
    ):
        rbuf = _RecvBuffer()  # reused for both reads of this round trip
        try:
            if timeout is not None:
                sock.settimeout(timeout)
            _send_frame(sock, type_byte, canonical_dumps(req.to_dict()))
            (length,) = struct.unpack(">I", rbuf.recv_exact(sock, 4))
            body = json.loads(rbuf.recv_exact(sock, length))
        except socket.timeout as err:
            # A timeout means the peer is slow or gone, NOT that the pooled
            # socket was stale — retrying would double the worst-case RPC
            # latency and deliver the request twice to a slow-but-alive
            # peer. Surface it as non-retryable.
            try:
                sock.close()
            except OSError:
                pass
            raise TransportError(f"rpc to {target}: {err}") from err
        except (OSError, ConnectionError, struct.error, ValueError) as err:
            try:
                sock.close()
            except OSError:
                pass
            raise _ConnError(f"rpc to {target}: {err}") from err
        self._checkin(target, sock)
        if body.get("error"):
            raise RemoteError(f"remote error from {target}: {body['error']}")
        resp_cls = RESPONSE_TYPES[type_byte]
        return resp_cls.from_dict(body["payload"])

    def sync(self, target: str, req):
        return self._request(target, req)

    def eager_sync(self, target: str, req):
        return self._request(target, req)

    def fast_forward(self, target: str, req):
        return self._request(target, req)

    def join(self, target: str, req):
        return self._request(target, req, timeout=self._join_timeout + 4.0)
