"""Engine assembly: wire key → peers → store → transport → node → service.

Reference semantics: src/babble/babble.go:20-362 —
``Babble`` owns the whole stack; ``Init`` validates config (option
forcing maintenance⇒bootstrap⇒store happens in Config.__post_init__),
loads the key and peer files, opens the store (backing up a stale DB
when not bootstrapping, babble.go:246-287,345-362), builds the transport
and node, and attaches the HTTP service. ``Run`` serves and babbles.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

from .config.config import Config
from .crypto.keyfile import SimpleKeyfile
from .crypto.keys import PrivateKey
from .dummy.state import State as DummyState
from .hashgraph.persistent_store import PersistentStore
from .hashgraph.store import InmemStore
from .net.tcp import TCPTransport
from .node.node import Node
from .node.validator import Validator
from .peers.json_peer_set import JSONPeerSet
from .peers.peer_set import PeerSet
from .proxy.proxy import AppProxy, InmemProxy
from .service.service import Service


class Babble:
    """reference: babble/babble.go:20-95."""

    def __init__(self, config: Config, proxy: Optional[AppProxy] = None):
        self.config = config
        self.proxy = proxy
        self.key: Optional[PrivateKey] = None
        self.peers: Optional[PeerSet] = None
        self.genesis_peers: Optional[PeerSet] = None
        self.store = None
        self.transport: Optional[TCPTransport] = None
        self.node: Optional[Node] = None
        self.service: Optional[Service] = None
        self.logger = config.logger("babble")

    # -- init steps ---------------------------------------------------------

    def init_key(self) -> None:
        """reference: babble.go:289-301."""
        self.key = SimpleKeyfile(self.config.keyfile_path()).read_key()

    def init_peers(self) -> None:
        """Load peers.json and peers.genesis.json (falling back to
        peers.json, like the reference when no genesis file exists)
        (reference: babble.go:220-244)."""
        self.peers = JSONPeerSet(self.config.data_dir).peer_set()
        try:
            self.genesis_peers = JSONPeerSet(
                self.config.data_dir, genesis=True
            ).peer_set()
        except FileNotFoundError:
            self.genesis_peers = self.peers

    def init_store(self) -> None:
        """In-memory by default; SQLite-backed with --store. An existing DB
        is moved to a timestamped backup unless bootstrapping from it
        (reference: babble.go:246-287,345-362)."""
        if not self.config.store:
            self.store = InmemStore(self.config.cache_size)
            return
        db_path = os.path.join(self.config.database_dir, "babble.db")
        if os.path.exists(db_path) and not self.config.bootstrap:
            backup = f"{db_path}.{time.strftime('%Y%m%d%H%M%S')}.bak"
            shutil.move(db_path, backup)
            # Take the WAL/SHM sidecars along, or SQLite would replay the
            # stale WAL frames into the brand-new database.
            for ext in ("-wal", "-shm"):
                side = db_path + ext
                if os.path.exists(side):
                    shutil.move(side, backup + ext)
            self.logger.info("backed up existing database to %s", backup)
        self.store = PersistentStore(self.config.cache_size, db_path)

    def init_transport(self) -> None:
        """reference: babble.go:165-218. TCP by default; with --signal the
        node instead keeps one outbound connection to a relay server and is
        addressed by its public key (the WebRTC+WAMP analogue — in signal
        mode peers.json NetAddr entries carry pubkeys, not host:port)."""
        if self.config.signal:
            from .net.signal import SignalTransport

            assert self.key is not None
            ca = self.config.signal_ca
            if not ca and self.config.data_dir:
                candidate = os.path.join(self.config.data_dir, "cert.pem")
                if os.path.exists(candidate):
                    ca = candidate
            self.transport = SignalTransport(
                self.config.signal_addr,
                self.key,
                timeout=self.config.tcp_timeout,
                join_timeout=self.config.join_timeout,
                ca_file=ca or None,
                direct_listen=self.config.signal_direct or None,
            )
        elif self.config.transport == "async":
            # Event-driven engine (docs/gossip.md): selector loop,
            # multiplexed connections, binary framed codec with per-
            # connection version negotiation (JSON peers interoperate).
            from .net.atcp import AsyncTCPTransport

            self.transport = AsyncTCPTransport(
                self.config.bind_addr,
                advertise_addr=self.config.advertise_addr or None,
                max_pool=self.config.max_pool,
                timeout=self.config.tcp_timeout,
                join_timeout=self.config.join_timeout,
            )
        else:
            self.transport = TCPTransport(
                self.config.bind_addr,
                advertise_addr=self.config.advertise_addr or None,
                max_pool=self.config.max_pool,
                timeout=self.config.tcp_timeout,
                join_timeout=self.config.join_timeout,
            )
        self.transport.listen()

    def init_node(self) -> None:
        """reference: babble.go:303-336."""
        assert self.key is not None and self.peers is not None
        if self.proxy is None:
            self.proxy = InmemProxy(DummyState())
        validator = Validator(self.key, self.config.moniker)
        self.node = Node(
            self.config,
            validator,
            self.peers,
            self.genesis_peers or self.peers,
            self.store,
            self.transport,
            self.proxy,
        )
        self.node.init()

    def init_service(self) -> None:
        """reference: babble.go:338-343."""
        if self.config.no_service:
            return
        self.service = Service(
            self.config.service_addr, self.node, self.logger
        )

    def init(self) -> None:
        """reference: babble.go:42-87."""
        self.init_key()
        self.init_peers()
        self.init_store()
        self.init_transport()
        self.init_node()
        self.init_service()

    # -- run ----------------------------------------------------------------

    def run(self) -> None:
        """Serve the HTTP service and babble until shutdown
        (reference: babble.go:89-95)."""
        if self.service is not None:
            self.service.serve_async()
        assert self.node is not None
        self.node.run(True)

    def run_async(self) -> None:
        if self.service is not None:
            self.service.serve_async()
        assert self.node is not None
        self.node.run_async()

    def shutdown(self) -> None:
        if self.node is not None:
            self.node.shutdown()
        if self.service is not None:
            self.service.shutdown()
        if self.transport is not None:
            self.transport.close()
        if self.store is not None:
            self.store.close()
