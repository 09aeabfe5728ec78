"""Embedding bindings — the analogue of the reference's gomobile wrapper
(src/mobile/node.go:21-86, mobile/handlers.go:10-24, mobile/mobile_app.go:14).

The reference crosses the Go<->Java/ObjC boundary with only scalar types,
byte slices, and tiny callback interfaces, marshalling whole blocks as JSON
(mobile/mobile_app.go:39-61). This module keeps exactly that contract for
foreign hosts embedding the framework through any Python bridge (Chaquopy,
BeeWare, PyObjC, an embedded CPython, ...):

- handlers receive the block as a canonical-JSON string and return the new
  state hash as bytes;
- the node is driven through ``MobileNode``: run / submit_tx / get_stats /
  leave / shutdown;
- exceptions and state changes surface through dedicated callbacks instead
  of raising across the language boundary.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from ..config.config import Config
from ..crypto.canonical import canonical_dumps
from ..engine import Babble
from ..hashgraph.block import Block
from ..proxy.proxy import CommitResponse, InmemProxy

CommitHandler = Callable[[str], bytes]  # block JSON -> new state hash
ExceptionHandler = Callable[[str], None]
StateChangeHandler = Callable[[str], None]


class _MobileApp:
    """ProxyHandler adapter marshalling blocks to JSON strings
    (reference: mobile/mobile_app.go:14-61)."""

    def __init__(
        self,
        commit: CommitHandler,
        on_exception: Optional[ExceptionHandler],
        on_state_change: Optional[StateChangeHandler],
    ):
        self._commit = commit
        self._exception = on_exception
        self._state_change = on_state_change

    def commit_handler(self, block: Block) -> CommitResponse:
        try:
            # canonical codec base64-encodes bytes fields, mirroring the
            # reference's JSON block marshalling across the boundary
            block_json = canonical_dumps(block.to_dict()).decode("utf-8")
            state_hash = self._commit(block_json)
        except Exception as err:  # never raise across the boundary
            if self._exception is not None:
                self._exception(str(err))
            state_hash = b""
        return CommitResponse(
            state_hash=bytes(state_hash or b""),
            receipts=[it.as_accepted() for it in block.internal_transactions()],
        )

    def snapshot_handler(self, block_index: int) -> bytes:
        return b""

    def restore_handler(self, snapshot: bytes) -> bytes:
        return b""

    def state_change_handler(self, state) -> None:
        if self._state_change is not None:
            self._state_change(str(state))


class MobileNode:
    """Foreign-host-facing node handle (reference: mobile/node.go:21-120).

    ``config_dir`` follows the engine's datadir conventions (priv_key,
    peers.json, peers.genesis.json, optional babble.toml)."""

    def __init__(
        self,
        config_dir: str,
        commit_handler: CommitHandler,
        exception_handler: Optional[ExceptionHandler] = None,
        state_change_handler: Optional[StateChangeHandler] = None,
        **config_overrides,
    ):
        self._exception = exception_handler
        conf = Config(data_dir=config_dir, **config_overrides)
        handler = _MobileApp(
            commit_handler, exception_handler, state_change_handler
        )
        self._proxy = InmemProxy(handler)
        self._engine = Babble(conf, proxy=self._proxy)
        try:
            self._engine.init()
        except Exception as err:
            if exception_handler is not None:
                exception_handler(f"init: {err}")
            raise

    # -- lifecycle (reference: mobile/node.go:88-120) ------------------------

    def run(self) -> None:
        self._engine.run_async()

    def leave(self) -> None:
        try:
            self._engine.node.leave()
        except Exception as err:
            self._report(f"leave: {err}")

    def shutdown(self) -> None:
        try:
            self._engine.shutdown()
        except Exception as err:
            self._report(f"shutdown: {err}")

    # -- app surface ---------------------------------------------------------

    def submit_tx(self, tx: bytes) -> None:
        self._proxy.submit_tx(bytes(tx))

    def get_stats(self) -> str:
        """JSON stats string (reference: mobile/node.go:122-128).

        Serialized from the TYPED snapshot — numbers cross the bridge
        as JSON numbers, not strings (the stringly map is the
        reference-parity `Node.get_stats` view; embedders should not
        have to re-parse it)."""
        return json.dumps(self._engine.node.get_stats_snapshot())

    def get_id(self) -> int:
        return self._engine.node.get_id()

    def get_pub_key(self) -> str:
        return self._engine.node.get_pub_key()

    def get_last_block_index(self) -> int:
        return self._engine.node.get_last_block_index()

    # -- internal ------------------------------------------------------------

    def _report(self, msg: str) -> None:
        if self._exception is not None:
            self._exception(msg)
