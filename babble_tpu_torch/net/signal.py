"""Signal/relay transport: gossip for NAT-ed nodes via a rendezvous server.

This is the framework's analogue of the reference's WebRTC stack
(src/net/webrtc_stream_layer.go + src/net/signal/ + signal/wamp/): there,
nodes register with a WAMP signaling router under their public key, exchange
SDP offers through it, and then speak over pion data channels. Here the same
topology is collapsed into one component: every node keeps a single
OUTBOUND TCP connection to a relay server, registers under its public key,
and all four consensus RPCs (Sync/EagerSync/FastForward/Join,
src/net/transport.go:5-35) are routed server-side by target public key.
Like TURN-relayed WebRTC, no node ever accepts an inbound connection, so
nodes behind NAT/firewalls can participate symmetrically.

Wire format: 4-byte big-endian length + JSON (canonical codec, bytes as
base64). Client -> server first frame registers; after that frames carry
{"to", "ch", "kind": "req"|"resp", "t": <rpc type byte>, "body", "error"}
and the server stamps "from" before forwarding.

Security: registration is challenge-response (the server only routes a
public key to a client that signs the server's nonce with it), and the
relay link itself can run over TLS — pass ``cert_file``/``key_file`` to
SignalServer and ``ca_file`` (or ``tls=True`` for system roots) to
SignalTransport. This matches the reference's WAMP signaling posture
(WSS + TLS with self-signed certs distributed out of band,
src/net/signal/wamp/client.go:24-120, wamp/wamp.go:1-19).

**Direct-connection upgrade** (``direct_listen=...``): the relay is then
only the SIGNALING plane, like the reference's WAMP router — nodes
exchange direct endpoints through it (the SDP offer/answer analogue,
src/net/webrtc_stream_layer.go:181-236) and upgrade to an authenticated
peer-to-peer TCP link; all subsequent gossip RPCs ride that link and the
relay is reduced to a fallback path (it keeps carrying traffic for pairs
whose direct connect fails, e.g. symmetric NATs — the TURN posture). A
direct link is mutually authenticated by a two-nonce challenge-response
(each side signs the other's nonce), so neither endpoint trusts an
unproven claim to a public key. Once upgraded, gossip keeps committing
even if the relay dies (tests/test_signal_direct.py pins this).

Threading note (TLS): each socket has exactly ONE reader thread, and all
writers serialize on the per-socket lock — i.e. at most one SSL_read and
one SSL_write run concurrently on an SSL object, the classic
reader+writer split OpenSSL >= 1.1.0 supports with its per-SSL locking.
A rare mid-read KeyUpdate colliding with a write can still surface as an
SSLError; both sides already treat any socket error as a dropped relay
link (client reconnects with backoff, server unregisters the client), so
the failure mode is a clean reconnect, not corruption.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import ssl
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from ..crypto.canonical import canonical_dumps
from ..crypto.hashing import sha256
from .rpc import (
    JoinRequest,
    REQUEST_TYPES,
    RESPONSE_TYPES,
    RPC,
    TYPE_OF_REQUEST,
)
from .tcp import _recv_exact
from .transport import TransportError

logger = logging.getLogger(__name__)


def _recv_frame(sock: socket.socket) -> dict:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    frame = json.loads(_recv_exact(sock, length))
    if not isinstance(frame, dict):
        raise ValueError("frame is not an object")
    return frame


def _send_frame(sock: socket.socket, obj: dict, lock: threading.Lock,
                timeout: Optional[float] = None) -> None:
    """Framed send; with ``timeout`` the whole write is bounded (the
    timeout is set inside the per-socket lock so concurrent writers never
    race the setting — used by the relay to drop jammed destinations)."""
    payload = canonical_dumps(obj)
    with lock:
        if timeout is not None:
            sock.settimeout(timeout)
            try:
                sock.sendall(struct.pack(">I", len(payload)) + payload)
            finally:
                sock.settimeout(None)
        else:
            sock.sendall(struct.pack(">I", len(payload)) + payload)


class SignalServer:
    """Rendezvous/relay router keyed by public key
    (reference: src/net/signal/wamp/server.go:18-98)."""

    def __init__(self, bind_addr: str, cert_file: Optional[str] = None,
                 key_file: Optional[str] = None,
                 send_timeout: float = 10.0):
        """``cert_file``/``key_file``: optional PEM pair; when given, every
        client connection is wrapped in TLS (reference posture:
        wamp/server.go serves WSS with a provided cert).

        ``send_timeout``: forwarding to a destination that has stopped
        draining its socket times out and DROPS that destination instead
        of wedging the sender's relay thread — without it one dead reader
        head-of-line-blocks every peer that gossips to it."""
        self._bind_addr = bind_addr
        self._send_timeout = send_timeout
        self._listener: Optional[socket.socket] = None
        self._clients: Dict[str, Tuple[socket.socket, threading.Lock]] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if cert_file:
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(cert_file, key_file)

    def listen(self) -> str:
        host, port_s = self._bind_addr.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", int(port_s)))
        srv.listen(64)
        self._listener = srv
        if int(port_s) == 0:
            self._bind_addr = f"{host}:{srv.getsockname()[1]}"
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self._bind_addr

    def addr(self) -> str:
        return self._bind_addr

    def close(self) -> None:
        self._shutdown.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            for sock, _ in self._clients.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._clients.clear()

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handshake_and_serve, args=(conn,), daemon=True
            ).start()

    def _handshake_and_serve(self, conn: socket.socket) -> None:
        if self._ssl_ctx is not None:
            try:
                conn.settimeout(10.0)
                conn = self._ssl_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (ssl.SSLError, OSError, ConnectionError):
                try:
                    conn.close()
                except OSError:
                    pass
                return
        self._serve_client(conn)

    def _serve_client(self, conn: socket.socket) -> None:
        pub: Optional[str] = None
        wlock = threading.Lock()
        try:
            # Challenge-response registration: a client only gets routed
            # under a public key it can sign for, so identities cannot be
            # hijacked by merely claiming a key (the reference's WAMP
            # signaling authenticates with TLS + tickets the same way).
            nonce = os.urandom(32)
            _send_frame(conn, {"challenge": nonce.hex()}, wlock)
            hello = _recv_frame(conn)
            pub = hello.get("register")
            if not pub or not self._check_registration(
                pub, nonce, hello.get("sig", "")
            ):
                conn.close()
                return
            with self._lock:
                old = self._clients.get(pub)
                self._clients[pub] = (conn, wlock)
            if old is not None:
                # tell the displaced client it was replaced (not a server
                # crash) so it backs off instead of kicking back instantly
                try:
                    _send_frame(old[0], {"kind": "displaced"}, old[1])
                except (OSError, ConnectionError):
                    pass
                try:
                    old[0].close()
                except OSError:
                    pass
            while not self._shutdown.is_set():
                frame = _recv_frame(conn)
                frame["from"] = pub
                target = frame.pop("to", None)
                with self._lock:
                    dest = self._clients.get(target)
                delivered = False
                if dest is not None:
                    try:
                        # bounded send: a full kernel buffer (dest stopped
                        # reading) must drop the dest, not wedge this
                        # sender's relay thread
                        _send_frame(dest[0], frame, dest[1],
                                    timeout=self._send_timeout)
                        delivered = True
                    except (OSError, ConnectionError):
                        # the DESTINATION is dead or jammed — drop it, not
                        # the sender
                        with self._lock:
                            if self._clients.get(target, (None,))[0] is dest[0]:
                                del self._clients[target]
                        try:
                            dest[0].close()
                        except OSError:
                            pass
                if not delivered and frame.get("kind") == "req":
                    _send_frame(
                        conn,
                        {
                            "from": target or "",
                            "ch": frame.get("ch"),
                            "kind": "resp",
                            "error": f"unreachable peer {target}",
                            "body": None,
                            "t": frame.get("t"),
                        },
                        wlock,
                    )
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                if pub is not None and self._clients.get(pub, (None,))[0] is conn:
                    del self._clients[pub]
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _check_registration(pub: str, nonce: bytes, sig: str) -> bool:
        try:
            from ..crypto.keys import PublicKey

            return PublicKey.from_hex(pub).verify(sha256(nonce), sig)
        except Exception:
            return False


def _direct_transcript(role: bytes, nonce_l: bytes, nonce_c: bytes,
                       signer_pub: str, counterparty_pub: str) -> bytes:
    """Channel-binding transcript for the direct-link handshake: the
    signature covers both nonces, the signer's key, AND the counterparty
    the signer believes it is talking to. Without the counterparty
    binding, a registered attacker could relay challenge/response pairs
    between a victim listener and an honest connector and have the victim
    adopt a link under the honest peer's identity (signature-relay MITM);
    with it, a relayed signature names the wrong counterparty and fails
    verification."""
    return sha256(
        b"babble-direct|" + role + b"|" + nonce_l + b"|" + nonce_c
        + b"|" + signer_pub.encode() + b"|" + counterparty_pub.encode()
    )


class _DirectLink:
    """One mutually-authenticated framed TCP connection to a peer — the
    data plane after a relay-signaled upgrade (the pion data-channel
    analogue, webrtc_stream_layer.go:181-236)."""

    __slots__ = ("sock", "wlock", "peer")

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.wlock = threading.Lock()
        self.peer = peer

    def send(self, frame: dict) -> None:
        _send_frame(self.sock, frame, self.wlock)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SignalTransport:
    """Transport over a relay server; the local address IS the public key
    (the reference keys WebRTC connections by pubkey the same way,
    webrtc_stream_layer.go:16-30)."""

    @staticmethod
    def _norm(pub: str) -> str:
        """Normalize a pubkey address ('0X...' or bare hex) to lowercase
        hex so registration and routing always agree."""
        return (pub[2:] if pub[:2].upper() == "0X" else pub).lower()

    def __init__(
        self,
        server_addr: str,
        key,
        timeout: float = 5.0,
        join_timeout: float = 30.0,
        tls: bool = False,
        ca_file: Optional[str] = None,
        direct_listen: Optional[str] = None,
    ):
        """``key`` is the node's PrivateKey: registration must answer the
        server's challenge with a signature over it. ``ca_file`` (or
        ``tls=True`` for system roots) wraps the relay link in TLS —
        self-signed relay certs are distributed out of band, like the
        reference's WAMP cert notes (wamp/wamp.go:1-19)."""
        self._server_addr = server_addr
        self._key = key
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if tls or ca_file:
            self._ssl_ctx = ssl.create_default_context(cafile=ca_file)
            if ca_file:
                # self-signed relay cert: trust the pinned cert, match by
                # key not hostname
                self._ssl_ctx.check_hostname = False
        self._pub = self._norm(key.public_key.hex())
        self._timeout = timeout
        self._join_timeout = max(join_timeout, timeout)
        self._consumer: "queue.Queue[RPC]" = queue.Queue()
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        # ch -> (expected responder pubkey, response queue)
        self._pending: Dict[int, Tuple[str, "queue.Queue[dict]"]] = {}
        self._plock = threading.Lock()
        self._next_ch = 0
        self._shutdown = threading.Event()
        # Direct-connection upgrade (``direct_listen`` e.g. "0.0.0.0:0"):
        # relay becomes signaling-only once a pair upgrades.
        self._direct_listen = direct_listen
        self._direct_listener: Optional[socket.socket] = None
        self._direct_addr: Optional[str] = None
        self._direct: Dict[str, _DirectLink] = {}  # peer pub -> link
        self._dlock = threading.Lock()
        self._offered: set = set()  # peers we already offered to
        self._dialing: set = set()  # peers with a dial in flight
        self._fallback_waiting: set = set()  # larger-side grace timers

    # -- Transport interface -------------------------------------------------

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._pub

    def advertise_addr(self) -> str:
        return self._pub

    def _connect(self) -> socket.socket:
        host, port_s = self._server_addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port_s)), timeout=5.0)
        if self._ssl_ctx is not None:
            sock = self._ssl_ctx.wrap_socket(sock, server_hostname=host)
        sock.settimeout(10.0)
        challenge = _recv_frame(sock)
        nonce = bytes.fromhex(challenge.get("challenge", ""))
        sig = self._key.sign(sha256(nonce))
        _send_frame(sock, {"register": self._pub, "sig": sig}, self._wlock)
        sock.settimeout(None)
        return sock

    def listen(self) -> None:
        if self._sock is not None:
            return
        try:
            self._sock = self._connect()
        except (OSError, ValueError, ConnectionError) as err:
            raise TransportError(
                f"cannot reach signal server {self._server_addr}: {err}"
            ) from err
        threading.Thread(target=self._read_loop, daemon=True).start()
        if self._direct_listen:
            host, port_s = self._direct_listen.rsplit(":", 1)
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host or "0.0.0.0", int(port_s)))
            srv.listen(16)
            self._direct_listener = srv
            self._direct_addr = f"{host or '127.0.0.1'}:{srv.getsockname()[1]}"
            threading.Thread(
                target=self._direct_accept_loop, daemon=True
            ).start()

    def close(self) -> None:
        self._shutdown.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._direct_listener is not None:
            try:
                self._direct_listener.close()
            except OSError:
                pass
            self._direct_listener = None
        with self._dlock:
            links, self._direct = list(self._direct.values()), {}
        for link in links:
            link.close()

    # -- direct upgrade ------------------------------------------------------

    def _direct_accept_loop(self) -> None:
        assert self._direct_listener is not None
        while not self._shutdown.is_set():
            try:
                conn, _ = self._direct_listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._direct_handshake_in, args=(conn,), daemon=True
            ).start()

    def _direct_handshake_in(self, conn: socket.socket) -> None:
        """Accepting side of the two-nonce mutual auth: challenge the
        connector, verify its channel-bound signature (it must name US as
        the counterparty), then prove our own key over the full
        transcript."""
        from ..crypto.keys import PublicKey

        wlock = threading.Lock()
        try:
            conn.settimeout(10.0)
            nonce = os.urandom(32)
            _send_frame(conn, {"challenge": nonce.hex()}, wlock)
            hello = _recv_frame(conn)
            peer = self._norm(hello.get("register") or "")
            their_nonce = bytes.fromhex(hello.get("nonce", ""))
            ok = False
            if peer and len(their_nonce) == 32:
                try:
                    ok = PublicKey.from_hex(peer).verify(
                        _direct_transcript(
                            b"connect", nonce, their_nonce, peer, self._pub
                        ),
                        hello.get("sig", ""),
                    )
                except Exception:
                    ok = False
            if not ok:
                conn.close()
                return
            _send_frame(
                conn,
                {
                    "register": self._pub,
                    "sig": self._key.sign(
                        _direct_transcript(
                            b"accept", nonce, their_nonce, self._pub, peer
                        )
                    ),
                },
                wlock,
            )
            conn.settimeout(None)
        except (OSError, ConnectionError, ValueError):
            try:
                conn.close()
            except OSError:
                pass
            return
        self._adopt_link(_DirectLink(conn, peer))

    def _direct_connect(self, peer: str, addr: str) -> None:
        """Connecting side: authenticate ourselves against the listener's
        challenge — the signature names ``peer`` as the counterparty, so
        it is useless to anyone else — and verify the listener proves
        ``peer``'s key over the same transcript (an endpoint learned
        through the relay is a claim, not a proof)."""
        from ..crypto.keys import PublicKey

        conn = None
        try:
            host, port_s = addr.rsplit(":", 1)
            conn = socket.create_connection((host, int(port_s)), timeout=5.0)
            conn.settimeout(10.0)
            wlock = threading.Lock()
            challenge = _recv_frame(conn)
            nonce = bytes.fromhex(challenge.get("challenge", ""))
            my_nonce = os.urandom(32)
            _send_frame(
                conn,
                {
                    "register": self._pub,
                    "sig": self._key.sign(
                        _direct_transcript(
                            b"connect", nonce, my_nonce, self._pub, peer
                        )
                    ),
                    "nonce": my_nonce.hex(),
                },
                wlock,
            )
            proof = _recv_frame(conn)
            ok = self._norm(proof.get("register") or "") == peer
            if ok:
                try:
                    ok = PublicKey.from_hex(peer).verify(
                        _direct_transcript(
                            b"accept", nonce, my_nonce, peer, self._pub
                        ),
                        proof.get("sig", ""),
                    )
                except Exception:
                    ok = False
            if not ok:
                conn.close()
                self._rearm_offer(peer)
                return
            conn.settimeout(None)
        except (OSError, ConnectionError, ValueError):
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            self._rearm_offer(peer)
            return
        self._adopt_link(_DirectLink(conn, peer))

    def _should_dial(self, peer: str) -> bool:
        """Deterministic cross-dial tie-break: of any pair, only the
        lexicographically SMALLER pubkey dials; the larger side answers
        with its endpoint (so the smaller learns where to dial) and waits
        for the inbound handshake. Without this both sides dial on a
        simultaneous offer/answer exchange, each end adopts a DIFFERENT
        crossing socket, and latest-wins replacement can close the link
        the other side is still using (~1/3 flake in
        test_rpc_upgrades_to_direct_link). Both strings are _norm()ed
        lowercase hex, so the comparison agrees on both ends."""
        return self._pub < peer

    def _dial_direct(self, peer: str, addr: str) -> None:
        """_direct_connect with the in-flight bookkeeping the offer
        handler uses to avoid concurrent duplicate dials to one peer."""
        try:
            self._direct_connect(peer, addr)
        finally:
            with self._dlock:
                self._dialing.discard(peer)

    #: how long the larger pubkey waits for the deterministic (smaller)
    #: dialer before trying the reverse direction itself. This must sit
    #: well above worst-case handshake latency — on a loaded single-core
    #: host a HEALTHY smaller-side dial can stall for seconds (GIL
    #: starvation), and a premature fallback resurrects exactly the
    #: crossing-socket churn the tie-break removed. One-sided
    #: reachability recovery is an escape hatch, not a hot path; paying
    #: ten seconds once per affected pair is fine.
    FALLBACK_DIAL_GRACE_S = 10.0

    #: Retry budget after the grace window: a SINGLE fallback dial was
    #: the test_signal_direct flake — under full-suite load one dial (or
    #: its handshake frames) can fail transiently, and with the one shot
    #: spent the pair could only re-upgrade on the NEXT offer, which a
    #: single-RPC test never sends. A few spaced attempts make the
    #: escape hatch robust to scheduler noise without resurrecting the
    #: crossing-socket churn (each attempt still checks for a live link
    #: first).
    FALLBACK_DIAL_ATTEMPTS = 3
    FALLBACK_DIAL_RETRY_S = 1.0

    def _fallback_dial(self, peer: str, addr: str) -> None:
        """One-sided-reachability escape hatch for the non-dialing
        (larger) side: if no link materializes within the grace window —
        i.e. the smaller peer's deterministic dial is failing, e.g.
        against our NAT'd endpoint — dial the peer's advertised address
        ourselves, retrying a bounded number of times. Crossing sockets
        are only possible when the smaller dial is genuinely
        slow/failing, and latest-wins adoption resolves that rare
        overlap."""
        deadline = time.monotonic() + self.FALLBACK_DIAL_GRACE_S
        try:
            while time.monotonic() < deadline:
                if self._shutdown.is_set():
                    return
                with self._dlock:
                    if peer in self._direct:
                        return
                time.sleep(0.1)
            for attempt in range(self.FALLBACK_DIAL_ATTEMPTS):
                if self._shutdown.is_set():
                    return
                with self._dlock:
                    if peer in self._direct:
                        return
                    if peer in self._dialing:
                        # the deterministic dialer finally reached us —
                        # let its handshake finish rather than racing it
                        return
                    self._dialing.add(peer)
                self._dial_direct(peer, addr)
                with self._dlock:
                    if peer in self._direct:
                        return
                time.sleep(self.FALLBACK_DIAL_RETRY_S)
        finally:
            with self._dlock:
                self._fallback_waiting.discard(peer)

    def _rearm_offer(self, peer: str) -> None:
        """A failed connect must not leave ``peer`` stuck in the offered
        set: with no link AND no pending offer the pair could never
        upgrade again until some other event cleared it."""
        with self._dlock:
            self._offered.discard(peer)

    def _adopt_link(self, link: _DirectLink) -> None:
        """Register an authenticated link for outbound routing and start
        its reader. Latest link wins: after an asymmetric failure (the
        peer saw the error and redialed, we did not) a first-wins policy
        would let the stale registered link shadow the fresh one forever;
        replacing closes the old link (any reply in flight on it fails
        and the requester retries via the relay)."""
        if self._shutdown.is_set():
            # a dial (e.g. the larger side's grace-period fallback) can
            # complete its handshake just as close() sweeps _direct;
            # adopting now would leak the socket + a blocked reader
            link.close()
            return
        with self._dlock:
            old = self._direct.get(link.peer)
            self._direct[link.peer] = link
        if old is not None and old is not link:
            old.close()
        threading.Thread(
            target=self._direct_read_loop, args=(link,), daemon=True
        ).start()
        logger.info("direct link established with %s", link.peer[:16])

    def _drop_link(self, link: _DirectLink) -> None:
        with self._dlock:
            if self._direct.get(link.peer) is link:
                del self._direct[link.peer]
            # allow a fresh offer round for this peer
            self._offered.discard(link.peer)
        link.close()

    def _direct_read_loop(self, link: _DirectLink) -> None:
        try:
            while not self._shutdown.is_set():
                frame = _recv_frame(link.sock)
                frame["from"] = link.peer  # identity proven at handshake
                kind = frame.get("kind")
                if kind == "resp":
                    with self._plock:
                        entry = self._pending.get(frame.get("ch"))
                    if entry is not None and entry[0] == link.peer:
                        entry[1].put(frame)
                elif kind == "req":
                    threading.Thread(
                        target=self._serve_request,
                        args=(frame, link),
                        daemon=True,
                    ).start()
        except (ConnectionError, OSError, ValueError):
            pass
        self._drop_link(link)

    def _maybe_offer_direct(self, target: str) -> None:
        """Send our direct endpoint to ``target`` through the relay (the
        SDP-offer analogue). One offer per peer per link generation."""
        if self._direct_addr is None or self._sock is None:
            return
        with self._dlock:
            if target in self._direct or target in self._offered:
                return
            self._offered.add(target)
        try:
            _send_frame(
                self._sock,
                {
                    "to": target,
                    "kind": "direct",
                    "addr": self._direct_addr,
                },
                self._wlock,
            )
        except (OSError, ConnectionError):
            with self._dlock:
                self._offered.discard(target)

    # -- inbound -------------------------------------------------------------

    def _read_loop(self) -> None:
        backoff = 0.2
        while not self._shutdown.is_set():
            sock = self._sock
            if sock is None:
                return
            displaced = False
            try:
                while not self._shutdown.is_set():
                    frame = _recv_frame(sock)
                    kind = frame.get("kind")
                    if kind == "displaced":
                        # another live client took over this key; back off
                        # hard so two same-key processes don't livelock
                        # kicking each other
                        displaced = True
                        continue
                    backoff = 0.2
                    if kind == "resp":
                        with self._plock:
                            entry = self._pending.get(frame.get("ch"))
                        # deliver only if the (server-stamped, authenticated)
                        # sender matches who we asked — a third party cannot
                        # forge a response by guessing channel ids
                        if entry is not None and frame.get("from") in (
                            entry[0],
                            "",  # server-originated error replies
                        ):
                            entry[1].put(frame)
                    elif kind == "req":
                        threading.Thread(
                            target=self._serve_request,
                            args=(frame,),
                            daemon=True,
                        ).start()
                    elif kind == "direct":
                        # relay-signaled endpoint exchange (SDP-offer
                        # analogue): the lexicographically smaller pubkey
                        # dials (deterministic tie-break — see
                        # _should_dial); the larger side answers with its
                        # own endpoint so the smaller learns where to
                        # dial, and arms a grace-period fallback dial for
                        # one-sided reachability (_fallback_dial).
                        # Answers are not re-answered — no offer loops.
                        # Nodes WITHOUT direct_listen ignore offers
                        # entirely: "empty = gossip stays relayed" is an
                        # operator promise (egress policy), and honoring
                        # a peer's offer would let any registered key
                        # make this node dial an arbitrary address.
                        peer = self._norm(frame.get("from") or "")
                        addr = frame.get("addr")
                        if self._direct_listen and peer and addr:
                            is_answer = bool(frame.get("answer"))
                            dial = fallback = False
                            with self._dlock:
                                have = peer in self._direct
                                dialing = peer in self._dialing
                                if self._should_dial(peer):
                                    # An OFFER means the peer has no
                                    # usable link to us (it only offers
                                    # when unlinked): a link registered
                                    # here is stale-or-dying knowledge,
                                    # so the dialer side redials and
                                    # latest-wins replaces it. Answers
                                    # only follow our own offer (no link
                                    # on our side at offer time).
                                    dial = not dialing and (
                                        not have or not is_answer
                                    )
                                    if dial:
                                        self._dialing.add(peer)
                                elif (
                                    not have
                                    and peer not in self._fallback_waiting
                                ):
                                    # Larger side: normally only answers,
                                    # but arms a grace-period reverse dial
                                    # for one-sided reachability (the
                                    # smaller peer's dial may target an
                                    # unreachable NAT'd endpoint while
                                    # ours would succeed).
                                    fallback = True
                                    self._fallback_waiting.add(peer)
                            if dial:
                                threading.Thread(
                                    target=self._dial_direct,
                                    args=(peer, addr),
                                    daemon=True,
                                ).start()
                            elif fallback:
                                threading.Thread(
                                    target=self._fallback_dial,
                                    args=(peer, addr),
                                    daemon=True,
                                ).start()
                            if not frame.get("answer") and (
                                self._direct_addr is not None
                            ):
                                try:
                                    _send_frame(
                                        sock,
                                        {
                                            "to": peer,
                                            "kind": "direct",
                                            "addr": self._direct_addr,
                                            "answer": True,
                                        },
                                        self._wlock,
                                    )
                                except (OSError, ConnectionError):
                                    pass
            except (ConnectionError, OSError, ValueError):
                pass
            # relay connection dropped: reconnect with backoff so a signal
            # server restart does not permanently silence the node
            if displaced:
                time.sleep(5.0)
            while not self._shutdown.is_set():
                try:
                    self._sock = self._connect()
                    logger.info("signal relay reconnected")
                    break
                except (OSError, ValueError, ConnectionError):
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)

    def _serve_request(self, frame: dict,
                       link: Optional[_DirectLink] = None) -> None:
        """Serve one inbound RPC; the reply rides the path the request
        arrived on — the direct ``link`` when given, else the relay."""
        origin = frame.get("from")
        ch = frame.get("ch")
        t = frame.get("t")

        def reply(body, error) -> None:
            resp = {"ch": ch, "kind": "resp", "t": t, "body": body,
                    "error": error}
            try:
                if link is not None:
                    link.send(resp)
                    return
                sock = self._sock
                if sock is not None:
                    _send_frame(sock, {**resp, "to": origin}, self._wlock)
            except (OSError, ConnectionError):
                pass

        req_cls = REQUEST_TYPES.get(t)
        if req_cls is None:
            reply(None, f"unknown rpc type {t}")
            return
        try:
            command = req_cls.from_dict(frame.get("body"))
        except Exception as err:
            reply(None, f"malformed request body: {err}")
            return
        rpc = RPC(command)
        rpc.recv_ts = time.time()  # arrival stamp (trace attribution)
        self._consumer.put(rpc)
        wait = (
            self._join_timeout + 2.0
            if isinstance(command, JoinRequest)
            else self._timeout
        )
        try:
            result, error = rpc.wait(timeout=wait)
        except queue.Empty:
            result, error = None, "rpc handler timeout"
        reply(result.to_dict() if result is not None else None, error)

    # -- outbound ------------------------------------------------------------

    def _request(self, target: str, req, timeout: Optional[float] = None):
        if self._sock is None:
            raise TransportError("signal transport not listening")
        type_byte = TYPE_OF_REQUEST[type(req)]
        norm_target = self._norm(target)
        with self._plock:
            self._next_ch += 1
            ch = self._next_ch
            q: "queue.Queue[dict]" = queue.Queue()
            self._pending[ch] = (norm_target, q)
        msg = {
            "ch": ch,
            "kind": "req",
            "t": type_byte,
            "body": req.to_dict(),
        }
        try:
            # Prefer the direct link once a pair has upgraded; a dead link
            # drops back to the relay (which also re-arms the offer).
            with self._dlock:
                link = self._direct.get(norm_target)
            sent_direct = False
            if link is not None:
                try:
                    link.send(msg)
                    sent_direct = True
                except (OSError, ConnectionError):
                    self._drop_link(link)
            if not sent_direct:
                if self._direct_listen:
                    self._maybe_offer_direct(norm_target)
                _send_frame(
                    self._sock, {**msg, "to": norm_target}, self._wlock
                )
            try:
                frame = q.get(timeout=timeout or self._timeout)
            except queue.Empty:
                raise TransportError(f"rpc to {target} timed out")
        except (OSError, ConnectionError) as err:
            raise TransportError(f"rpc to {target}: {err}") from err
        finally:
            with self._plock:
                self._pending.pop(ch, None)
        if frame.get("error"):
            raise TransportError(f"remote error from {target}: {frame['error']}")
        return RESPONSE_TYPES[type_byte].from_dict(frame["body"])

    def sync(self, target: str, req):
        return self._request(target, req)

    def eager_sync(self, target: str, req):
        return self._request(target, req)

    def fast_forward(self, target: str, req):
        return self._request(target, req)

    def join(self, target: str, req):
        return self._request(target, req, timeout=self._join_timeout + 4.0)
