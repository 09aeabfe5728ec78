"""Socket proxy pair: Babble and the application in separate processes.

Reference semantics: two JSON-RPC/TCP servers facing each other
(src/proxy/socket/app/socket_app_proxy.go:16 — Babble
side exposes ``Babble.SubmitTx`` and calls the app;
src/proxy/socket/babble/socket_babble_proxy.go:17 — app
side exposes ``State.CommitBlock/GetSnapshot/Restore/OnStateChanged`` and
calls Babble). The wire here is length-prefixed JSON-RPC-style frames
(4-byte big-endian length + {"method", "params", "id"} /
{"result", "error", "id"}), with bytes carried base64 by the canonical
codec.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional

from ..crypto.canonical import canonical_dumps, jsonable, unb64
from ..hashgraph.block import Block
from ..hashgraph.internal_transaction import InternalTransactionReceipt
from .proxy import CommitResponse, ProxyHandler


# Shared length-prefixed framing, including the hostile-length-prefix cap.
from ..net.tcp import _recv_exact  # noqa: E402


def _send_msg(sock: socket.socket, obj) -> None:
    payload = canonical_dumps(obj)
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, length))


class JsonRpcServer:
    """Accept loop + per-connection request dispatcher."""

    def __init__(self, bind_addr: str, handlers: Dict[str, Callable]):
        self._handlers = handlers
        host, port_s = bind_addr.rsplit(":", 1)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host or "0.0.0.0", int(port_s)))
        self._srv.listen(16)
        self.addr = f"{host}:{self._srv.getsockname()[1]}"
        self._shutdown = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                msg = _recv_msg(conn)
                if not isinstance(msg, dict):
                    break  # protocol violation: drop this client
                mid = msg.get("id")
                fn = self._handlers.get(msg.get("method", ""))
                if fn is None:
                    _send_msg(
                        conn,
                        {"result": None, "error": f"no method {msg.get('method')}", "id": mid},
                    )
                    continue
                try:
                    result = fn(*(msg.get("params") or []))
                    _send_msg(conn, {"result": result, "error": None, "id": mid})
                except Exception as err:  # handler error crosses the wire as a string
                    _send_msg(conn, {"result": None, "error": str(err), "id": mid})
        except (ConnectionError, OSError, ValueError, struct.error):
            # garbage framing or undecodable JSON from a client drops THAT
            # client; the accept loop (and every other client) lives on
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


    def close(self) -> None:
        self._shutdown.set()
        try:
            self._srv.close()
        except OSError:
            pass


class JsonRpcClient:
    """Single pooled connection, connect-on-demand with one reconnect retry
    (reference: socket_app_proxy_client.go getConnection)."""

    def __init__(self, target: str, timeout: float = 10.0):
        self._target = target
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._next_id = 0

    def _connect(self) -> socket.socket:
        host, port_s = self._target.rsplit(":", 1)
        sock = socket.create_connection((host, int(port_s)), timeout=self._timeout)
        sock.settimeout(self._timeout)
        return sock

    def call(self, method: str, *params):
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._sock = self._connect()
                self._next_id += 1
                try:
                    _send_msg(
                        self._sock,
                        {"method": method, "params": list(params), "id": self._next_id},
                    )
                    resp = _recv_msg(self._sock)
                    break
                except (ConnectionError, OSError):
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    if attempt == 1:
                        raise
        if resp.get("error"):
            raise RuntimeError(f"{method}: {resp['error']}")
        return resp.get("result")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class SocketAppProxy:
    """Babble-side proxy: exposes Babble.SubmitTx to the app, forwards
    commits/snapshots/restores to the app's server
    (reference: socket/app/socket_app_proxy.go:16-74)."""

    def __init__(self, bind_addr: str, client_addr: str, timeout: float = 10.0):
        self._submit: "queue.Queue[bytes]" = queue.Queue()
        self._submit_handler: Optional[Callable[[bytes], str]] = None
        self._client = JsonRpcClient(client_addr, timeout)
        self._server = JsonRpcServer(
            bind_addr, {"Babble.SubmitTx": self._submit_tx}
        )
        self.addr = self._server.addr

    def set_submit_handler(self, fn: Callable[[bytes], str]) -> None:
        """Node-side admission callback; SubmitTx then answers with the
        mempool verdict string instead of the reference's bare ``true``
        (wire divergence recorded in docs/parity.md)."""
        self._submit_handler = fn

    def _submit_tx(self, tx_b64: str):
        fn = self._submit_handler
        if fn is not None:
            return fn(unb64(tx_b64))
        # No node attached yet: queue, and keep the reference's bool reply
        # so bare proxies stay wire-compatible.
        self._submit.put(unb64(tx_b64))
        return True

    def set_client_addr(self, addr: str) -> None:
        """Point at the app server once it is bound (lets both sides bind
        ephemeral ports before cross-wiring)."""
        self._client._target = addr

    # -- AppProxy interface -------------------------------------------------

    def submit_queue(self) -> "queue.Queue[bytes]":
        return self._submit

    def commit_block(self, block: Block) -> CommitResponse:
        result = self._client.call(
            "State.CommitBlock", jsonable(block.to_dict())
        )
        return CommitResponse(
            state_hash=unb64(result["StateHash"]) if result["StateHash"] else b"",
            receipts=[
                InternalTransactionReceipt.from_dict(r)
                for r in result.get("Receipts") or []
            ],
        )

    def get_snapshot(self, block_index: int) -> bytes:
        result = self._client.call("State.GetSnapshot", block_index)
        return unb64(result) if result else b""

    def restore(self, snapshot: bytes) -> None:
        self._client.call(
            "State.Restore", jsonable(snapshot)
        )

    def on_state_changed(self, state) -> None:
        # Best-effort: the app may not be connected yet
        # (reference logs and continues).
        try:
            self._client.call("State.OnStateChanged", str(state))
        except Exception:
            pass

    def close(self) -> None:
        self._server.close()
        self._client.close()


class SocketBabbleProxy:
    """App-side proxy: wraps a ProxyHandler behind a State.* server and
    submits transactions to Babble's server
    (reference: socket/babble/socket_babble_proxy.go:17-122)."""

    def __init__(
        self,
        bind_addr: str,
        babble_addr: str,
        handler: ProxyHandler,
        timeout: float = 10.0,
    ):
        self._handler = handler
        self._client = JsonRpcClient(babble_addr, timeout)
        self._server = JsonRpcServer(
            bind_addr,
            {
                "State.CommitBlock": self._commit_block,
                "State.GetSnapshot": self._get_snapshot,
                "State.Restore": self._restore,
                "State.OnStateChanged": self._on_state_changed,
            },
        )
        self.addr = self._server.addr

    def _commit_block(self, block_dict: dict):
        block = Block.from_dict(block_dict)
        resp = self._handler.commit_handler(block)
        return json.loads(
            canonical_dumps(
                {
                    "StateHash": resp.state_hash,
                    "Receipts": [r.to_dict() for r in resp.receipts],
                }
            )
        )

    def _get_snapshot(self, block_index: int):
        snap = self._handler.snapshot_handler(block_index)
        return jsonable(snap)

    def _restore(self, snapshot_b64: str):
        self._handler.restore_handler(unb64(snapshot_b64) if snapshot_b64 else b"")
        return True

    def _on_state_changed(self, state: str) -> bool:
        self._handler.state_change_handler(state)
        return True

    # -- app-facing ---------------------------------------------------------

    def submit_tx(self, tx: bytes) -> str:
        """Submit to Babble; returns the admission verdict. A reference-
        shaped peer (or a proxy with no node attached) answers ``true`` —
        mapped to "accepted" so callers see one vocabulary."""
        result = self._client.call(
            "Babble.SubmitTx", jsonable(tx)
        )
        return "accepted" if result is True else str(result)

    def close(self) -> None:
        self._server.close()
        self._client.close()
