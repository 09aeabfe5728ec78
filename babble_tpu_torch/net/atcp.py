"""Event-driven async TCP transport: one selector loop, multiplexed
binary connections, per-peer outbound write queues.

The seed transport (net/tcp.py) is thread-per-connection with one
blocking request/response in flight per socket — at 16 nodes that is
hundreds of parked threads convoying on the GIL, and the JSON codec on
top of it is the measured wall (BENCH_r05, ROADMAP item 1). This
transport replaces the hot path:

- **One loop thread** (``selectors``-based) owns every socket:
  non-blocking accept, read, and write; outbound frames go through
  per-connection write queues drained as the socket becomes writable.
- **Connection multiplexing**: binary frames carry a ``req_id``, so a
  node keeps ONE connection per peer with many RPCs in flight instead
  of a pool of one-at-a-time sockets.
- **Version negotiation per connection** (net/codec.py HELLO): a binary
  client probes with a 9-byte hello (a well-formed legacy frame:
  type 0xBB, length 4, "BLG"+version). A binary peer acks it; a legacy
  JSON peer answers the probe with its normal "unknown rpc type" error
  frame, which the client detects and falls back to the legacy JSON
  framing on that same socket — old and new nodes interoperate in both
  directions with zero configuration. The server side speaks both: the
  first byte of a connection selects binary (0xBB) or legacy JSON
  (type byte 0-3).
- **Zero-copy-ish event path**: Sync/EagerSync payloads carry events as
  length-prefixed opaque blobs (encoded once per process, decoded once
  at ingest) — no per-peer JSON/base64 round-trips.

The blocking client API (sync/eager_sync/fast_forward/join) is
unchanged, so chaos/trace/sim layers compose exactly as with
TCPTransport, which remains available as the fallback transport.
"""

from __future__ import annotations

import json
import queue
import selectors
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..crypto.canonical import canonical_dumps
from . import codec
from .codec import CODEC_STATS, FLAG_ERROR, HELLO, MAX_FRAME, RESP_BIT
from .rpc import JoinRequest, REQUEST_TYPES, RESPONSE_TYPES, RPC, TYPE_OF_REQUEST
from .transport import RemoteError, TransportError

_U32 = struct.Struct(">I")
_CHUNK = 1 << 16


class _ConnError(TransportError):
    """Connection-level failure — retryable on a fresh dial (the peer
    may simply have restarted), unlike a RemoteError."""


class _Waiter:
    """One in-flight multiplexed RPC: the caller thread parks on the
    event; the loop thread delivers (flags, payload) or a conn error."""

    __slots__ = ("event", "flags", "payload", "conn_error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.flags: Optional[int] = None
        self.payload: Optional[bytes] = None
        self.conn_error: Optional[str] = None


#: Cap on bytes queued toward one connection. A peer that stops reading
#: (partition with the socket held open, SIGSTOP — the chaos-suite
#: scenarios) would otherwise grow conn.wq without bound, one eager-sync
#: frame per gossip round, for the fault's whole duration; the blocking
#: sendall of the threaded transport gave natural backpressure here.
#: Overflow drops the connection: pending RPCs fail fast, queued frames
#: are freed, and the next RPC redials (by then the peer either reads
#: again or the dial fails promptly).
MAX_CONN_BACKLOG = 16 * 1024 * 1024


class _Conn:
    """One registered socket: parse state + outbound write queue."""

    __slots__ = (
        "sock", "mode", "rbuf", "wq", "wq_bytes", "wview", "pending",
        "next_id", "lock", "closed",
    )

    # modes
    SRV_NEW, SRV_BIN, SRV_JSON, CLI_BIN = range(4)

    def __init__(self, sock: socket.socket, mode: int):
        self.sock = sock
        self.mode = mode
        self.rbuf = bytearray()
        self.wq: List[bytes] = []        # queued outbound frames
        self.wq_bytes = 0                # bytes across wq + wview
        self.wview: Optional[memoryview] = None  # partial write in progress
        self.pending: Dict[int, _Waiter] = {}    # client conns only
        self.next_id = 0
        self.lock = threading.Lock()     # guards pending/next_id
        self.closed = False


class AsyncTCPTransport:
    """Drop-in Transport (net/transport.py protocol) over the selector
    loop. Constructor mirrors TCPTransport so call sites can switch on a
    config flag; ``max_pool`` only bounds the legacy-JSON fallback pool."""

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
        self._dial_timeout = (
            dial_timeout if dial_timeout is not None else min(timeout, 3.0)
        )
        self._join_timeout = join_timeout if join_timeout is not None else max(
            timeout, 10.0
        )
        self._max_pool = max_pool
        self._consumer: "queue.Queue[RPC]" = queue.Queue()
        self._listener: Optional[socket.socket] = None
        self._shutdown = threading.Event()

        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._ops_lock = threading.Lock()
        self._ops: List = []           # thunks for the loop thread
        self._loop_thread: Optional[threading.Thread] = None
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)

        self._cli_lock = threading.Lock()
        self._bin_conns: Dict[str, _Conn] = {}   # one multiplexed conn/peer
        self._json_pool: Dict[str, List[socket.socket]] = {}  # legacy peers
        # One dial/negotiation at a time per target: without this a
        # thundering herd of first RPCs to a peer races N probe dials
        # and throws away N-1 negotiated connections.
        self._dial_locks: Dict[str, threading.Lock] = {}
        # Interop counters (surfaced via stats()): how this transport's
        # outbound connections negotiated.
        self.peers_binary = 0
        self.peers_json = 0

    # -- Transport interface -------------------------------------------------

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._bind_addr

    def advertise_addr(self) -> str:
        return self._advertise

    def listen(self) -> None:
        if self._listener is not None:
            return
        host, port_s = self._bind_addr.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", int(port_s)))
        srv.listen(256)
        srv.setblocking(False)
        self._listener = srv
        if int(port_s) == 0:
            port = srv.getsockname()[1]
            self._bind_addr = f"{host}:{port}"
            if self._advertise.endswith(":0"):
                self._advertise = f"{self._advertise.rsplit(':', 1)[0]}:{port}"
        self._sel.register(srv, selectors.EVENT_READ, "accept")
        self._ensure_loop()

    def close(self) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self._wakeup()
        t = self._loop_thread
        if t is not None:
            t.join(timeout=2.0)
        # the loop thread owns the teardown; if it never ran, clean here
        if t is None:
            self._teardown()
        with self._cli_lock:
            pools = list(self._json_pool.values())
            self._json_pool.clear()
        for conns in pools:
            for s in conns:
                try:
                    s.close()
                except OSError:
                    pass

    def stats(self) -> dict:
        return {
            "peers_binary": self.peers_binary,
            "peers_json": self.peers_json,
        }

    # -- loop plumbing -------------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._shutdown.is_set():
            return  # a late client call must not resurrect a closed loop
        if self._loop_thread is None or not self._loop_thread.is_alive():
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="atcp-loop"
            )
            self._loop_thread.start()

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def _run_in_loop(self, fn) -> None:
        with self._ops_lock:
            self._ops.append(fn)
        self._wakeup()

    def _loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                for key, events in self._sel.select(timeout=0.5):
                    data = key.data
                    if key.fileobj is self._wake_r:
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    elif data == "accept":
                        self._accept()
                    elif isinstance(data, _Conn):
                        if events & selectors.EVENT_READ:
                            self._readable(data)
                        if events & selectors.EVENT_WRITE and not data.closed:
                            self._writable(data)
                with self._ops_lock:
                    ops, self._ops = self._ops, []
                for fn in ops:
                    try:
                        fn()
                    except Exception:
                        pass
        finally:
            self._teardown()

    def _teardown(self) -> None:
        try:
            conns = [
                key.data
                for key in list(self._sel.get_map().values())
                if isinstance(key.data, _Conn)
            ]
        except (RuntimeError, AttributeError, KeyError):
            conns = []  # selector already closed by an earlier teardown
        for conn in conns:
            self._drop_conn(conn, "transport closed")
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except Exception:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _interest(self, conn: _Conn) -> None:
        """(Re)register the conn for read, plus write when data is queued."""
        mask = selectors.EVENT_READ
        if conn.wq or conn.wview is not None:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, conn)
        except KeyError:
            try:
                self._sel.register(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _enqueue(self, conn: _Conn, frame: bytes) -> None:
        """Loop-thread only: queue an outbound frame and try to flush
        immediately (most frames fit the socket buffer — no extra
        select round-trip on the common path). A connection whose peer
        has stopped reading is dropped at MAX_CONN_BACKLOG queued bytes
        instead of buffering for the fault's whole duration."""
        if conn.closed:
            return
        if conn.wq_bytes + len(frame) > MAX_CONN_BACKLOG:
            self._drop_conn(conn, "outbound queue overflow (stalled peer)")
            return
        conn.wq.append(frame)
        conn.wq_bytes += len(frame)
        self._writable(conn)

    def _send(self, conn: _Conn, frame: bytes) -> None:
        """Any-thread entry: hand the frame to the loop."""
        self._run_in_loop(lambda: self._enqueue(conn, frame))

    # -- server side ---------------------------------------------------------

    def _accept(self) -> None:
        assert self._listener is not None
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, _Conn.SRV_NEW)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass

    def _readable(self, conn: _Conn) -> None:
        try:
            while True:
                chunk = conn.sock.recv(_CHUNK)
                if not chunk:
                    self._drop_conn(conn, "connection closed by peer")
                    return
                CODEC_STATS.bytes_received += len(chunk)
                conn.rbuf += chunk
                if len(chunk) < _CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as err:
            self._drop_conn(conn, f"read error: {err}")
            return
        try:
            self._parse(conn)
        except (ValueError, struct.error, json.JSONDecodeError) as err:
            self._drop_conn(conn, f"protocol error: {err}")

    def _writable(self, conn: _Conn) -> None:
        try:
            while conn.wview is not None or conn.wq:
                if conn.wview is None:
                    conn.wview = memoryview(conn.wq.pop(0))
                n = conn.sock.send(conn.wview)
                CODEC_STATS.bytes_sent += n
                conn.wq_bytes -= n
                if n < len(conn.wview):
                    conn.wview = conn.wview[n:]
                    break
                conn.wview = None
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as err:
            self._drop_conn(conn, f"write error: {err}")
            return
        self._interest(conn)

    def _parse(self, conn: _Conn) -> None:
        """Consume every complete frame in the conn's read buffer."""
        buf = conn.rbuf
        while True:
            if conn.mode == _Conn.SRV_NEW:
                if not buf:
                    return
                first = buf[0]
                if first == HELLO[0]:
                    if len(buf) < len(HELLO):
                        return
                    if bytes(buf[: len(HELLO) - 1]) != HELLO[:-1]:
                        raise ValueError("bad hello magic")
                    del buf[: len(HELLO)]
                    conn.mode = _Conn.SRV_BIN
                    CODEC_STATS.conns_binary += 1
                    self._enqueue(conn, HELLO)  # ack (version echo)
                    continue
                if first in REQUEST_TYPES:
                    conn.mode = _Conn.SRV_JSON
                    CODEC_STATS.conns_json += 1
                    continue
                raise ValueError(f"unknown protocol byte {first}")

            if conn.mode == _Conn.SRV_JSON:
                if len(buf) < 5:
                    return
                (length,) = _U32.unpack_from(buf, 1)
                if length > MAX_FRAME:
                    raise ValueError("oversized frame")
                if len(buf) < 5 + length:
                    return
                type_byte = buf[0]
                payload = bytes(buf[5:5 + length])
                del buf[:5 + length]
                self._dispatch_json(conn, type_byte, payload)
                continue

            # binary framing (server or client side of a negotiated conn)
            if conn.mode == _Conn.CLI_BIN or conn.mode == _Conn.SRV_BIN:
                if len(buf) < codec.FRAME_HEADER.size:
                    return
                kind, flags, req_id, length = codec.unpack_header(buf)
                total = codec.FRAME_HEADER.size + length
                if len(buf) < total:
                    return
                payload = bytes(buf[codec.FRAME_HEADER.size:total])
                del buf[:total]
                if kind & RESP_BIT:
                    self._deliver_response(conn, kind, flags, req_id, payload)
                else:
                    self._dispatch_bin(conn, kind, req_id, payload)
                continue
            return

    def _dispatch_bin(
        self, conn: _Conn, type_byte: int, req_id: int, payload: bytes
    ) -> None:
        try:
            command = codec.decode_request(type_byte, payload)
        except Exception as err:
            self._enqueue(
                conn,
                codec.pack_frame(
                    RESP_BIT | (type_byte & 0x7F), FLAG_ERROR, req_id,
                    f"bad request: {err}".encode("utf-8"),
                ),
            )
            return
        rpc = RPC(command)
        rpc.recv_ts = time.time()  # lint: allow(clock: recv_ts is a real-wire arrival stamp; sim uses SimTransport)

        def on_respond(result, error) -> None:
            if error is None and result is None:
                error = "empty response"
            if error is not None:
                frame = codec.pack_frame(
                    RESP_BIT | type_byte, FLAG_ERROR, req_id,
                    str(error).encode("utf-8"),
                )
            else:
                # encoded in the responder's thread, off the loop
                frame = codec.pack_frame(
                    RESP_BIT | type_byte, 0, req_id,
                    codec.encode_response(type_byte, result),
                )
            self._send(conn, frame)

        rpc.on_respond = on_respond
        self._consumer.put(rpc)

    def _dispatch_json(
        self, conn: _Conn, type_byte: int, payload: bytes
    ) -> None:
        req_cls = REQUEST_TYPES.get(type_byte)
        if req_cls is None:
            body = canonical_dumps(
                {"error": f"unknown rpc type {type_byte}", "payload": None}
            )
            self._enqueue(conn, _U32.pack(len(body)) + body)
            return
        command = req_cls.from_dict(json.loads(payload))
        rpc = RPC(command)
        rpc.recv_ts = time.time()  # lint: allow(clock: recv_ts is a real-wire arrival stamp; sim uses SimTransport)

        def on_respond(result, error) -> None:
            body = canonical_dumps(
                {
                    "error": error,
                    "payload": result.to_dict() if result is not None else None,
                }
            )
            self._send(conn, _U32.pack(len(body)) + body)

        rpc.on_respond = on_respond
        self._consumer.put(rpc)

    # -- client side ---------------------------------------------------------

    def _deliver_response(
        self, conn: _Conn, kind: int, flags: int, req_id: int, payload: bytes
    ) -> None:
        with conn.lock:
            waiter = conn.pending.pop(req_id, None)
        if waiter is None:  # late reply after caller timeout — drop
            return
        waiter.flags = flags
        waiter.payload = payload
        waiter.event.set()

    def _drop_conn(self, conn: _Conn, reason: str) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        with conn.lock:
            waiters = list(conn.pending.values())
            conn.pending.clear()
        for w in waiters:
            w.conn_error = reason
            w.event.set()
        with self._cli_lock:
            for target, c in list(self._bin_conns.items()):
                if c is conn:
                    del self._bin_conns[target]

    def _dial(self, target: str) -> socket.socket:
        host, port_s = target.rsplit(":", 1)
        try:
            sock = socket.create_connection(
                (host, int(port_s)), timeout=self._dial_timeout
            )
        except OSError as err:
            raise TransportError(f"dial {target}: {err}") from err
        sock.settimeout(self._timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return sock

    def _negotiate(self, target: str) -> Tuple[Optional[_Conn], Optional[socket.socket]]:
        """Dial + HELLO probe. Returns (binary conn, None) for a binary
        peer or (None, legacy socket) for a JSON peer — the same probe
        that lets mixed-version clusters interoperate."""
        sock = self._dial(target)
        try:
            sock.sendall(HELLO)
            CODEC_STATS.bytes_sent += len(HELLO)
            first = _recv_exact_blocking(sock, 1)
            if first[0] == HELLO[0]:
                rest = _recv_exact_blocking(sock, len(HELLO) - 1)
                if first + rest != HELLO:
                    raise _ConnError(f"bad hello ack from {target}")
                sock.setblocking(False)
                conn = _Conn(sock, _Conn.CLI_BIN)
                self.peers_binary += 1
                self._ensure_loop()
                self._run_in_loop(lambda: self._interest(conn))
                return conn, None
            # Legacy JSON peer: it read our probe byte (0xBB) as an RPC
            # type and answered with a length-prefixed error frame —
            # drain it and keep the socket for JSON framing.
            rest = _recv_exact_blocking(sock, 3)
            (length,) = _U32.unpack(first + rest)
            if length > MAX_FRAME:
                raise _ConnError(f"bad probe reply from {target}")
            _recv_exact_blocking(sock, length)
            self.peers_json += 1
            return None, sock
        except (OSError, ConnectionError, struct.error) as err:
            try:
                sock.close()
            except OSError:
                pass
            raise _ConnError(f"negotiate {target}: {err}") from err

    def _request(self, target: str, req, timeout: Optional[float] = None):
        """One RPC: multiplexed binary when the peer negotiated it, the
        legacy pooled-JSON framing otherwise. A failure on a REUSED
        binary conn or pooled JSON socket retries ONCE on a fresh dial
        (the peer may have restarted; handlers are idempotent)."""
        if timeout is None:
            timeout = (
                self._join_timeout + 4.0
                if isinstance(req, JoinRequest)
                else self._timeout
            )
        conn, sock, fresh = self._checkout(target)
        try:
            if conn is not None:
                return self._bin_roundtrip(target, conn, req, timeout)
            return self._json_roundtrip(target, sock, req, timeout)
        except _ConnError:
            if fresh:
                raise
            # A REUSED conn/pooled socket died mid-RPC — most often the
            # peer restarted between RPCs. Evict and retry ONCE on a
            # fresh dial (handlers are idempotent, tcp.py contract).
            with self._cli_lock:
                stale = self._json_pool.pop(target, [])
            for s in stale:
                try:
                    s.close()
                except OSError:
                    pass
            conn, sock, _ = self._checkout(target)
            if conn is not None:
                return self._bin_roundtrip(target, conn, req, timeout)
            return self._json_roundtrip(target, sock, req, timeout)

    def _checkout(self, target: str):
        """(binary conn, legacy socket, came_fresh): an existing
        multiplexed conn or pooled socket when available, else ONE
        negotiation dial per target at a time (herd waiters reuse the
        winner's connection)."""
        with self._cli_lock:
            conn = self._bin_conns.get(target)
            if conn is not None and not conn.closed:
                return conn, None, False
            pool = self._json_pool.get(target)
            if pool:
                return None, pool.pop(), False
            dial_lock = self._dial_locks.setdefault(target, threading.Lock())
        with dial_lock:
            with self._cli_lock:
                conn = self._bin_conns.get(target)
                if conn is not None and not conn.closed:
                    return conn, None, False
                pool = self._json_pool.get(target)
                if pool:
                    return None, pool.pop(), False
            conn, sock = self._negotiate(target)
            if conn is not None:
                with self._cli_lock:
                    self._bin_conns[target] = conn
                return conn, None, True
            return None, sock, True

    def _bin_roundtrip(self, target: str, conn: _Conn, req, timeout: float):
        type_byte = TYPE_OF_REQUEST[type(req)]
        waiter = _Waiter()
        with conn.lock:
            conn.next_id = (conn.next_id + 1) & 0xFFFFFFFF
            req_id = conn.next_id
            conn.pending[req_id] = waiter
        if conn.closed:
            # raced with _drop_conn: closed is set BEFORE the pending
            # drain, so a waiter registered after the drain sees it here
            # (one registered before the drain gets error-signaled) —
            # either way we fail fast on the retry-eligible path instead
            # of burning the full RPC timeout
            with conn.lock:
                conn.pending.pop(req_id, None)
            raise _ConnError(f"rpc to {target}: connection closed")
        frame = codec.pack_frame(
            type_byte, 0, req_id, codec.encode_request(req)[1]
        )
        self._send(conn, frame)
        if not waiter.event.wait(timeout=timeout):
            with conn.lock:
                conn.pending.pop(req_id, None)
            raise TransportError(f"rpc to {target}: timeout")
        if waiter.conn_error is not None:
            raise _ConnError(f"rpc to {target}: {waiter.conn_error}")
        if waiter.flags & FLAG_ERROR:
            raise RemoteError(
                f"remote error from {target}: "
                f"{waiter.payload.decode('utf-8', 'replace')}"
            )
        return codec.decode_response(type_byte, waiter.payload)

    def _json_roundtrip(self, target: str, sock: socket.socket, req, timeout: float):
        """Legacy framing to an old JSON peer, one RPC per socket at a
        time (tcp.py semantics, including the error-frame contract)."""
        type_byte = TYPE_OF_REQUEST[type(req)]
        try:
            sock.settimeout(timeout)
            payload = canonical_dumps(req.to_dict())
            data = bytes([type_byte]) + _U32.pack(len(payload)) + payload
            sock.sendall(data)
            CODEC_STATS.bytes_sent += len(data)
            (length,) = _U32.unpack(_recv_exact_blocking(sock, 4))
            if length > MAX_FRAME:
                raise ValueError("oversized frame")
            body = json.loads(_recv_exact_blocking(sock, length))
        except socket.timeout as err:
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
        sock.settimeout(self._timeout)
        with self._cli_lock:
            pool = self._json_pool.setdefault(target, [])
            if len(pool) < self._max_pool:
                pool.append(sock)
                sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if body.get("error"):
            raise RemoteError(f"remote error from {target}: {body['error']}")
        return RESPONSE_TYPES[type_byte].from_dict(body["payload"])

    def sync(self, target: str, req):
        return self._request(target, req)

    def eager_sync(self, target: str, req):
        return self._request(target, req)

    def fast_forward(self, target: str, req):
        return self._request(target, req)

    def join(self, target: str, req):
        return self._request(target, req, timeout=self._join_timeout + 4.0)


def _recv_exact_blocking(sock: socket.socket, n: int) -> bytes:
    """Blocking exact read for the client-side negotiation/JSON path —
    one implementation shared with the threaded transport (net/tcp.py
    ``_RecvBuffer``: recv_into, MAX_FRAME guard, byte accounting)."""
    from .tcp import _recv_exact

    return _recv_exact(sock, n)
