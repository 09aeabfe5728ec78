"""babble_tpu_torch CLI: keygen | run | version | dummy | signal.

Reference semantics: cmd/babble/main.go:10,
commands/keygen.go:21-60, commands/run.go:14-141 — config resolution is
layered: built-in defaults < ``babble.toml`` in the datadir < CLI flags
(run.go:112-141). The reference uses cobra+viper; here argparse +
stdlib tomllib.

Usage (``python -m babble_tpu_torch`` is the same entry point):
    python -m babble_tpu_torch.cli keygen [--pem FILE]
    python -m babble_tpu_torch.cli run [--datadir D] [--listen H:P] ...
    python -m babble_tpu_torch.cli run --accelerator ...   # offload on the card
    python -m babble_tpu_torch.cli version

``--accelerator`` runs the consensus offload on the CUDA card; without a
card the node refuses to start. ``--accelerator-device cpu`` runs the
offload's plain PyTorch path on the host instead (tests).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from ..config.config import Config, default_data_dir
from ..crypto.keyfile import SimpleKeyfile
from ..crypto.keys import generate_key
from ..version import __version__ as VERSION

# flag name -> (Config attr, type)
_RUN_FLAGS = {
    "datadir": ("data_dir", str),
    "log": ("log_level", str),
    "log_json": ("log_json", bool),
    "listen": ("bind_addr", str),
    "advertise": ("advertise_addr", str),
    "service_listen": ("service_addr", str),
    "no_service": ("no_service", bool),
    "heartbeat": ("heartbeat_timeout", float),
    "slow_heartbeat": ("slow_heartbeat_timeout", float),
    "timeout": ("tcp_timeout", float),
    "join_timeout": ("join_timeout", float),
    "max_pool": ("max_pool", int),
    "cache_size": ("cache_size", int),
    "sync_limit": ("sync_limit", int),
    "suspend_limit": ("suspend_limit", int),
    "fast_sync": ("enable_fast_sync", bool),
    "store": ("store", bool),
    "db": ("database_dir", str),
    "bootstrap": ("bootstrap", bool),
    "maintenance_mode": ("maintenance_mode", bool),
    "moniker": ("moniker", str),
    "accelerator": ("accelerator", bool),
    "accelerator_mesh": ("accelerator_mesh", int),
    "accelerator_device": ("accelerator_device", str),
    "transport": ("transport", str),
    # lint: allow(knobs: toml-only; the CLI route is the negative-polarity --no-gossip-pipeline)
    "gossip_pipeline": ("gossip_pipeline", bool),
    "gossip_pipeline_depth": ("gossip_pipeline_depth", int),
    # lint: allow(knobs: toml-only; the CLI route is the negative-polarity --no-adaptive)
    "adaptive_gossip": ("adaptive_gossip", bool),
    "gossip_max_fanout": ("gossip_max_fanout", int),
    "selfevent_burst": ("selfevent_burst", int),
    "fast_forward_deadline": ("fast_forward_deadline", float),
    "join_backoff_cap": ("join_backoff_cap", float),
    "mempool_max_txs": ("mempool_max_txs", int),
    "mempool_max_bytes": ("mempool_max_bytes", int),
    "mempool_overflow": ("mempool_overflow", str),
    "mempool_event_max_txs": ("mempool_event_max_txs", int),
    "mempool_event_max_bytes": ("mempool_event_max_bytes", int),
    "mempool_committed_lru": ("mempool_committed_lru", int),
    "mempool_rate": ("mempool_rate", float),
    "mempool_burst": ("mempool_burst", float),
    "submit_batch": ("submit_batch", int),
    "sentry_threshold": ("sentry_threshold", float),
    "sentry_quarantine": ("sentry_quarantine_s", float),
    "sentry_decay_halflife": ("sentry_decay_halflife_s", float),
    "client_listen": ("client_listen", str),
    "sub_queue": ("sub_queue_frames", int),
    "sub_stall_timeout": ("sub_stall_timeout_s", float),
    "sub_shed_lag": ("sub_shed_lag", int),
    "sub_sndbuf": ("sub_sndbuf", int),
    "txindex_cap": ("txindex_cap", int),
    "trace_sample": ("trace_sample", float),
    "trace_table_cap": ("trace_table_cap", int),
    "watchdog_stall": ("watchdog_stall_s", float),
    "watchdog_interval": ("watchdog_interval_s", float),
    "flight_dir": ("flight_dir", str),
    "profile_hz": ("profile_hz", float),
    "signal": ("signal", bool),
    "signal_addr": ("signal_addr", str),
    "signal_ca": ("signal_ca", str),
    "signal_direct": ("signal_direct", str),
    "prune_every_rounds": ("prune_every_rounds", int),
    "prune_keep_rounds": ("prune_keep_rounds", int),
    # lint: allow(knobs: toml-only; the CLI route is the negative-polarity --no-prune-vacuum)
    "prune_vacuum": ("prune_vacuum", bool),
}


def _load_toml(path: str) -> dict:
    """babble.toml layer (reference: run.go:112-141)."""
    try:
        import tomllib
    except ImportError:  # pragma: no cover - py<3.11
        return {}
    try:
        with open(path, "rb") as f:
            return tomllib.load(f)
    except FileNotFoundError:
        return {}


def _build_config(args: argparse.Namespace) -> Config:
    datadir = args.datadir or default_data_dir()
    layered: dict = {"data_dir": datadir}
    # layer 2: babble.toml
    toml_conf = _load_toml(os.path.join(datadir, "babble.toml"))
    for flag, (attr, typ) in _RUN_FLAGS.items():
        if flag in toml_conf:
            layered[attr] = typ(toml_conf[flag])
    # layer 3: explicit CLI flags beat the file
    for flag, (attr, _) in _RUN_FLAGS.items():
        v = getattr(args, flag, None)
        if v is not None and v is not False:
            layered[attr] = v
    # negative-polarity flags (the store_true pattern above can only turn
    # booleans ON): --no-adaptive pins the fixed two-speed timer,
    # --no-gossip-pipeline keeps inbound syncs inline on handler threads
    if getattr(args, "no_adaptive", False):
        layered["adaptive_gossip"] = False
    if getattr(args, "no_gossip_pipeline", False):
        layered["gossip_pipeline"] = False
    if getattr(args, "no_prune_vacuum", False):
        layered["prune_vacuum"] = False
    return Config(**layered)


def cmd_keygen(args: argparse.Namespace) -> int:
    """Generate a key pair; refuses to overwrite (keygen.go:33-52)."""
    datadir = args.datadir or default_data_dir()
    path = args.pem or os.path.join(datadir, "priv_key")
    if os.path.exists(path):
        print(
            f"A key already lives under: {path}\n"
            "Remove it first if you really want to overwrite.",
            file=sys.stderr,
        )
        return 1
    key = generate_key()
    SimpleKeyfile(path).write_key(key)
    print(f"Your private key has been saved to: {path}")
    print(f"Public key: {key.public_key.hex()}")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    """Assemble and run the engine with a socket app proxy, or the dummy
    in-memory app with --inmem-dummy (run.go:29-60)."""
    from ..engine import Babble
    from ..obs import log as obs_log

    conf = _build_config(args)
    # One logging entry point for the whole process (obs/log.py):
    # level/JSON toggle from config+flags, node correlation stamped.
    obs_log.configure_from(conf)
    proxy = None
    if not args.inmem_dummy:
        from ..proxy.socket_proxy import SocketAppProxy

        proxy = SocketAppProxy(args.proxy_listen, args.client_connect)
    engine = Babble(conf, proxy=proxy)
    engine.init()

    # The engine runs on a thread of its own; the handler only records the
    # signal, and the main thread shuts the engine down. A handler runs on
    # the main thread between two bytecodes, and shutdown takes locks that
    # the code it interrupts may hold (the babble loop holds the node's
    # routine lock while it starts a gossip thread), so it must not run
    # shutdown, nor babble on the thread that handles signals. An error
    # that ends the engine (a service address already taken, a fault in
    # the babble loop) shuts it down and is raised here, as if it had
    # been raised on this thread.
    stop, failed = [], []

    def _stop(signum, frame):
        stop.append(signum)

    def _run():
        try:
            engine.run()
        except BaseException as err:
            failed.append(err)

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    runner = threading.Thread(target=_run, daemon=True, name="engine-run")
    runner.start()
    while not stop and runner.is_alive():
        runner.join(timeout=0.1)
    if stop or failed:
        try:
            engine.shutdown()
        finally:
            if failed:
                raise failed[0]
    return 0


def cmd_signal(args: argparse.Namespace) -> int:
    """Standalone signal/relay server daemon (reference: cmd/signal)."""
    import time as _time

    from ..net.signal import SignalServer
    from ..obs import log as obs_log

    obs_log.configure()
    if bool(args.cert) != bool(args.key):
        print("--cert and --key must be given together", file=sys.stderr)
        return 2
    server = SignalServer(args.listen, cert_file=args.cert,
                          key_file=args.key)
    addr = server.listen()
    mode = "TLS" if args.cert else "plaintext"
    print(f"signal server listening on {addr} ({mode})")

    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True
        server.close()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    while not stop["flag"]:
        _time.sleep(0.2)  # lint: allow(clock: signal-server daemon wait loop; CLI entry point, never under sim)
    return 0


def cmd_dummy(args: argparse.Namespace) -> int:
    """Interactive dummy chat-app client over the socket proxy pair
    (reference: cmd/dummy/commands/root.go:33-60). Lines typed on stdin
    are submitted as transactions; committed blocks print as they land.
    With --no-repl it serves commits silently (for scripted testnets)."""
    import time as _time

    from ..dummy.socket_client import DummySocketClient

    client = DummySocketClient(args.listen, args.connect)
    print(f"dummy app serving on {args.listen}, submitting to {args.connect}")

    orig_commit = client.state.commit_handler

    def loud_commit(block):
        resp = orig_commit(block)
        for tx in block.transactions():
            print(f"[block {block.index()}] {tx.decode(errors='replace')}")
        return resp

    if not args.no_repl:
        client.state.commit_handler = loud_commit

    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True
        if signum == signal.SIGINT:
            # let the blocking readline() in the REPL unwind via
            # KeyboardInterrupt instead of resuming on EINTR (PEP 475)
            raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)

    try:
        if args.no_repl:
            while not stop["flag"]:
                _time.sleep(0.2)  # lint: allow(clock: dummy-app daemon wait loop; CLI entry point, never under sim)
        else:
            while not stop["flag"]:
                line = sys.stdin.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    verdict = client.submit_tx(line.encode())
                    if verdict != "accepted":
                        # shed/duplicate verdicts (docs/mempool.md) must
                        # reach the user — the message will NOT commit
                        print(f"submit verdict: {verdict}", file=sys.stderr)
                except Exception as err:
                    # a dropped tx is recoverable; keep the chat alive
                    print(f"submit failed ({err}); is the node up?",
                          file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
    return 0


def cmd_version(_: argparse.Namespace) -> int:
    print(VERSION)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="babble_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    kg = sub.add_parser("keygen", help="generate a new key pair")
    kg.add_argument("--datadir", default=None)
    kg.add_argument("--pem", default=None, help="explicit key file path")
    kg.set_defaults(fn=cmd_keygen)

    run = sub.add_parser("run", help="run a node")
    run.add_argument("--datadir", default=None)
    run.add_argument("--log", default=None)
    run.add_argument(
        "--log-json", dest="log_json", action="store_true",
        help="structured JSON log lines (one object per line, node "
        "correlation fields included)",
    )
    run.add_argument("--listen", default=None, help="bind host:port")
    run.add_argument("--advertise", default=None)
    run.add_argument("--service-listen", dest="service_listen", default=None)
    run.add_argument("--no-service", dest="no_service", action="store_true")
    run.add_argument("--heartbeat", type=float, default=None)
    run.add_argument("--slow-heartbeat", dest="slow_heartbeat", type=float, default=None)
    run.add_argument("--timeout", type=float, default=None)
    run.add_argument("--join-timeout", dest="join_timeout", type=float, default=None)
    run.add_argument("--max-pool", dest="max_pool", type=int, default=None)
    run.add_argument("--cache-size", dest="cache_size", type=int, default=None)
    run.add_argument("--sync-limit", dest="sync_limit", type=int, default=None)
    run.add_argument("--suspend-limit", dest="suspend_limit", type=int, default=None)
    run.add_argument("--fast-sync", dest="fast_sync", action="store_true")
    run.add_argument("--store", action="store_true")
    run.add_argument("--db", default=None)
    run.add_argument("--bootstrap", action="store_true")
    run.add_argument("--maintenance-mode", dest="maintenance_mode", action="store_true")
    run.add_argument("--moniker", default=None)
    run.add_argument("--accelerator", action="store_true")
    run.add_argument(
        "--accelerator-mesh", dest="accelerator_mesh", type=int, default=None,
        help="shard voting sweeps over this many CUDA cards (a value "
        "that is not a power of two, more cards than the host has, or a "
        "CPU offload logs a warning and sweeps on one device)",
    )
    run.add_argument(
        "--accelerator-device", dest="accelerator_device", default=None,
        choices=("cuda", "cpu"),
        help="device of the consensus offload (default cuda; no card is "
        "an error, never a silent CPU run)",
    )
    run.add_argument(
        "--transport", default=None, choices=("tcp", "async"),
        help="gossip transport: 'async' = event-driven selector engine "
        "with the binary framed codec (docs/gossip.md); 'tcp' = "
        "thread-per-connection JSON fallback (default)",
    )
    run.add_argument(
        "--gossip-pipeline-depth", dest="gossip_pipeline_depth", type=int,
        default=None,
        help="bounded insert-queue depth of the inbound-sync pipeline",
    )
    run.add_argument(
        "--no-gossip-pipeline", dest="no_gossip_pipeline",
        action="store_true",
        help="disable the staged inbound-sync pipeline: decode, verify "
        "and insert run inline on handler threads (the pre-pipeline "
        "shape; docs/gossip.md)",
    )
    run.add_argument(
        "--no-adaptive", dest="no_adaptive", action="store_true",
        help="disable the adaptive gossip scheduler: fixed two-speed "
        "heartbeat, one partner per tick (same as BABBLE_ADAPT=0)",
    )
    run.add_argument(
        "--fast-forward-deadline", dest="fast_forward_deadline",
        type=float, default=None,
        help="total budget in seconds for the catching-up node's "
        "fast-forward poll loop (docs/robustness.md)",
    )
    run.add_argument(
        "--join-backoff-cap", dest="join_backoff_cap", type=float,
        default=None,
        help="cap in seconds on the joining node's retry backoff",
    )
    run.add_argument(
        "--gossip-max-fanout", dest="gossip_max_fanout", type=int,
        default=None,
        help="adaptive scheduler's fan-out ceiling: max distinct gossip "
        "partners per tick (docs/gossip.md §Adaptive scheduling)",
    )
    run.add_argument(
        "--selfevent-burst", dest="selfevent_burst", type=int, default=None,
        help="max extra self-events coalesced per tick while the mempool "
        "holds a full event's worth of pending txs (0 disables)",
    )
    run.add_argument(
        "--mempool-max-txs", dest="mempool_max_txs", type=int, default=None,
        help="mempool capacity in transactions (admission cap)",
    )
    run.add_argument(
        "--mempool-max-bytes", dest="mempool_max_bytes", type=int,
        default=None, help="mempool capacity in bytes",
    )
    run.add_argument(
        "--mempool-overflow", dest="mempool_overflow", default=None,
        choices=("reject", "evict-oldest"),
        help="behavior at capacity: reject new txs (default) or evict oldest",
    )
    run.add_argument(
        "--mempool-event-max-txs", dest="mempool_event_max_txs", type=int,
        default=None, help="max client txs packaged per self-event",
    )
    run.add_argument(
        "--mempool-event-max-bytes", dest="mempool_event_max_bytes",
        type=int, default=None, help="max client tx bytes per self-event",
    )
    run.add_argument(
        "--mempool-committed-lru", dest="mempool_committed_lru", type=int,
        default=None,
        help="committed-transaction-hash LRU size (turns retries of "
        "committed txs into `already_committed`)",
    )
    run.add_argument(
        "--mempool-rate", dest="mempool_rate", type=float, default=None,
        help="token-bucket admission rate in tx/s (0 = unlimited)",
    )
    run.add_argument(
        "--mempool-burst", dest="mempool_burst", type=float, default=None,
        help="token-bucket burst size in txs (0 = one second's worth)",
    )
    run.add_argument(
        "--submit-batch", dest="submit_batch", type=int, default=None,
        help="submit-queue transactions drained per background pass",
    )
    run.add_argument(
        "--sentry-threshold", dest="sentry_threshold", type=float,
        default=None,
        help="misbehavior score at which a peer is quarantined",
    )
    run.add_argument(
        "--sentry-quarantine", dest="sentry_quarantine", type=float,
        default=None, help="quarantine duration in seconds",
    )
    run.add_argument(
        "--sentry-decay-halflife", dest="sentry_decay_halflife", type=float,
        default=None, help="misbehavior score decay half-life in seconds",
    )
    run.add_argument(
        "--client-listen", dest="client_listen", default=None,
        help="bind the light-client SubscriptionHub here (streaming "
        "commit subscriptions, docs/clients.md); empty = off",
    )
    run.add_argument(
        "--sub-queue", dest="sub_queue", type=int, default=None,
        help="bounded per-subscriber frame queue (docs/clients.md)",
    )
    run.add_argument(
        "--sub-stall-timeout", dest="sub_stall_timeout", type=float,
        default=None,
        help="seconds a subscriber may stall with queued frames before "
        "being shed",
    )
    run.add_argument(
        "--sub-shed-lag", dest="sub_shed_lag", type=int, default=None,
        help="delivery deficit in blocks beyond which a chronically "
        "slow subscriber is shed",
    )
    run.add_argument(
        "--sub-sndbuf", dest="sub_sndbuf", type=int, default=None,
        help="kernel send-buffer cap per subscriber socket (0 = OS "
        "default); small values make slow-consumer shedding prompt",
    )
    run.add_argument(
        "--txindex-cap", dest="txindex_cap", type=int, default=None,
        help="max transactions indexed for GET /proof/<txid>",
    )
    run.add_argument(
        "--trace-sample", dest="trace_sample", type=float, default=None,
        help="commit-provenance sampling rate (deterministic across "
        "nodes; 1.0 traces every tx, 0 disables)",
    )
    run.add_argument(
        "--trace-table-cap", dest="trace_table_cap", type=int,
        default=None, help="max provenance records kept per node",
    )
    run.add_argument(
        "--watchdog-stall", dest="watchdog_stall", type=float,
        default=None,
        help="stall seconds before the flight recorder trips (0 = off)",
    )
    run.add_argument(
        "--watchdog-interval", dest="watchdog_interval", type=float,
        default=None, help="stall-watchdog poll interval in seconds",
    )
    run.add_argument(
        "--flight-dir", dest="flight_dir", default=None,
        help="directory for flight-recorder artifacts",
    )
    run.add_argument(
        "--profile-hz", dest="profile_hz", type=float, default=None,
        help="always-on sampling-profiler rate (thread-stack samples/s "
        "served at GET /profile; 0 disables; default 50)",
    )
    run.add_argument(
        "--signal", action="store_true",
        help="relay mode: route gossip via a signal server, addressed by pubkey",
    )
    run.add_argument(
        "--signal-addr", dest="signal_addr", default=None,
        help="signal/relay server host:port (default 127.0.0.1:2443)",
    )
    run.add_argument(
        "--signal-ca", dest="signal_ca", default=None,
        help="pinned relay TLS cert (PEM); default datadir/cert.pem if present",
    )
    run.add_argument(
        "--signal-direct", dest="signal_direct", default=None,
        help="direct p2p upgrade listen addr for signal mode (e.g. "
        "0.0.0.0:0); gossip then leaves the relay after the handshake",
    )
    run.add_argument(
        "--prune-every-rounds", dest="prune_every_rounds", type=int,
        default=None,
        help="checkpoint-prune cadence: compact the store every N "
        "committed rounds past the last prune floor (0 disables; "
        "docs/lifecycle.md)",
    )
    run.add_argument(
        "--prune-keep-rounds", dest="prune_keep_rounds", type=int,
        default=None,
        help="straggler margin: retain this many rounds below the "
        "anchor when pruning",
    )
    run.add_argument(
        "--no-prune-vacuum", dest="no_prune_vacuum", action="store_true",
        help="skip the incremental SQLite vacuum after each prune "
        "(pages are still reused, just not returned to the OS)",
    )
    run.add_argument(
        "--proxy-listen", dest="proxy_listen", default="127.0.0.1:1338",
        help="where Babble serves SubmitTx for the app",
    )
    run.add_argument(
        "--client-connect", dest="client_connect", default="127.0.0.1:1339",
        help="where the app serves State.*",
    )
    run.add_argument(
        "--inmem-dummy", dest="inmem_dummy", action="store_true",
        help="run the built-in dummy app in-process instead of the socket proxy",
    )
    run.set_defaults(fn=cmd_run)

    dmy = sub.add_parser(
        "dummy", help="interactive dummy chat app over the socket proxy"
    )
    dmy.add_argument(
        "--listen", default="127.0.0.1:1339", help="app-side bind host:port"
    )
    dmy.add_argument(
        "--connect", default="127.0.0.1:1338",
        help="babble-side proxy host:port",
    )
    dmy.add_argument(
        "--no-repl", dest="no_repl", action="store_true",
        help="serve commits without the stdin chat loop",
    )
    dmy.set_defaults(fn=cmd_dummy)

    sig = sub.add_parser(
        "signal", help="run a standalone signal/relay server"
    )
    sig.add_argument(
        "--listen", default="0.0.0.0:2443", help="bind host:port"
    )
    sig.add_argument(
        "--cert", default=None, help="TLS certificate (PEM); enables TLS"
    )
    sig.add_argument(
        "--key", default=None, help="TLS private key (PEM)"
    )
    sig.set_defaults(fn=cmd_signal)

    ver = sub.add_parser("version", help="print the version")
    ver.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
