"""HTTP observability service.

Reference semantics: src/service/service.go:20-272 —
endpoints /stats, /block/{index}, /blocks/{start}?count=, /graph, /peers,
/genesispeers, /validators/{round}, /history. Extended here with the
telemetry surface (docs/observability.md): /metrics (Prometheus text
exposition), /telemetry (structured JSON with computed percentiles and
recent sync traces), /mempool, /suspects, /profile (the sampling
profiler's stage-attributed collapsed stacks; /debug/profile aliases
it), the /debug/* routes (timers, thread stacks), and the light-client
read surface (docs/clients.md): /proof/{txid} (signed Merkle inclusion
proof) and /checkpoint (fast-sync snapshot for read replicas). Built on the stdlib
ThreadingHTTPServer (the reference rides http.DefaultServeMux so an
in-process app can share the port; here an app can mount extra handlers
via ``extra_routes``)."""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..crypto.canonical import jsonable as _jsonable
from ..node.graph import Graph

GET_BLOCKS_LIMIT = 50  # max blocks per /blocks/ page (service.go:126)


class Service:
    """reference: service/service.go:20-86."""

    def __init__(self, bind_addr: str, node, logger=None,
                 extra_routes: Optional[Dict[str, Callable]] = None):
        self.bind_addr = bind_addr
        self.node = node
        self.logger = logger
        self.extra_routes = extra_routes or {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def serve_async(self) -> None:
        host, port_s = self.bind_addr.rsplit(":", 1)
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                if service.logger:
                    service.logger.debug("service: " + fmt % args)

            def do_GET(self):
                service._handle(self)

        self._httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port_s)), Handler)
        self.bind_addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- routing ------------------------------------------------------------

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        path = parsed.path
        try:
            if path in self.extra_routes:
                self.extra_routes[path](req)
                return
            if path == "/metrics":
                # Prometheus text exposition (docs/observability.md):
                # the node registry + the process-global registry.
                self._send_text(req, 200, self.node.get_metrics_text())
                return
            if path == "/stats":
                body = self.node.get_stats()
            elif path == "/telemetry":
                # structured JSON twin of /metrics: instruments with
                # computed p50/p90/p99 + the recent sync-trace ring
                body = self.node.get_telemetry()
            elif path == "/mempool":
                # admission knobs + live counters (docs/mempool.md)
                body = self.node.get_mempool()
            elif path == "/suspects":
                # sentry misbehavior ledger + equivocation proofs
                # (docs/robustness.md §Byzantine fault model)
                body = self.node.get_suspects()
            elif path.startswith("/trace/"):
                # one transaction's local provenance record (cross-node
                # merge: python -m babble_tpu_torch.obs.traceview)
                body = self.node.get_trace(path[len("/trace/"):])
                if body is None:
                    self._send(req, 404, {"error": "unknown txid"})
                    return
            elif path == "/traces":
                # bulk provenance export (?limit=N, newest-last)
                qs = parse_qs(parsed.query)
                body = self.node.get_traces(
                    limit=int(qs.get("limit", ["256"])[0])
                )
            elif path.startswith("/proof/"):
                # signed Merkle inclusion proof for one committed tx
                # (docs/clients.md §Proofs); verified offline by
                # client.verifier from the validator set alone
                body = self.node.get_proof(path[len("/proof/"):])
                if body is None:
                    self._send(req, 404, {"error": "unknown txid"})
                    return
            elif path == "/checkpoint":
                # signed fast-sync snapshot for read-replica spin-up
                # (docs/clients.md §Checkpoints). ?round=N asks for the
                # earliest sealed anchor at-or-after round N; below the
                # prune floor the answer is the distinct behind_retention
                # slug + the floor (410, not a generic 404), so clients
                # ratchet forward instead of retrying (docs/lifecycle.md).
                from ..lifecycle.pruner import BehindRetentionError

                qs = parse_qs(parsed.query)
                at_round = None
                if "round" in qs:
                    at_round = int(qs["round"][0])
                try:
                    # ?snapshot=1 embeds the app snapshot at the anchor
                    # — a rejoining validator's one-request bootstrap
                    body = self.node.get_checkpoint(
                        at_round, with_snapshot="snapshot" in qs
                    )
                except BehindRetentionError as err:
                    self._send(req, 410, {
                        "error": "behind_retention",
                        "requested": err.requested,
                        "floor": err.floor,
                    })
                    return
                except ValueError as err:
                    self._send(req, 404, {"error": str(err)})
                    return
            elif path.startswith("/block/"):
                body = _jsonable(
                    self.node.get_block(int(path[len("/block/"):])).to_dict()
                )
            elif path.startswith("/blocks/"):
                body = self._blocks(path, parsed.query)
            elif path == "/graph":
                body = Graph(self.node).to_dict()
            elif path == "/peers":
                body = _jsonable([p.to_dict() for p in self.node.get_peers()])
            elif path == "/genesispeers":
                body = _jsonable(
                    [p.to_dict() for p in self.node.get_validator_set(0)]
                )
            elif path.startswith("/validators/"):
                rnd = int(path[len("/validators/"):])
                body = _jsonable(
                    [p.to_dict() for p in self.node.get_validator_set(rnd)]
                )
            elif path == "/history":
                body = _jsonable(
                    {
                        str(r): [p.to_dict() for p in ps]
                        for r, ps in self.node.get_all_validator_sets().items()
                    }
                )
            elif path == "/debug/timers":
                # gossip-leg latency percentiles (the pprof analogue of the
                # reference's ad-hoc ns duration logs, node.go:511-514)
                body = self.node.timers.snapshot()
            elif path == "/debug/stacks":
                body = self._thread_stacks()
            elif path in ("/profile", "/debug/profile"):
                # ONE profiler implementation (obs/profile.py — the
                # always-on stage-attributed sampler); /debug/profile is
                # the legacy alias. format=collapsed (flamegraph text,
                # default) | cprofile (pstats-style table) | json |
                # torch (a torch.profiler trace of the CPU and the card).
                self._profile(req, parse_qs(parsed.query))
                return
            else:
                self._send(req, 404, {"error": f"no route {path}"})
                return
        except Exception as err:
            self._send(req, 500, {"error": str(err)})
            return
        self._send(req, 200, body)

    def _blocks(self, path: str, query: str):
        """/blocks/{startIndex}?count=N, newest-last, capped at 50
        (service.go:126-190)."""
        start = int(path[len("/blocks/"):])
        qs = parse_qs(query)
        count = min(
            int(qs.get("count", [GET_BLOCKS_LIMIT])[0]), GET_BLOCKS_LIMIT
        )
        last = self.node.get_last_block_index()
        if start > last:
            raise ValueError(f"requested starting index {start} > last block {last}")
        out = []
        for i in range(start, min(start + count, last + 1)):
            out.append(_jsonable(self.node.get_block(i).to_dict()))
        return out

    @staticmethod
    def _thread_stacks():
        """All live thread stacks — the /debug/pprof/goroutine analogue."""
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        return {
            f"{names.get(tid, '?')} ({tid})": traceback.format_stack(frame)
            for tid, frame in sys._current_frames().items()
        }

    def _profile(self, req: BaseHTTPRequestHandler, qs) -> None:
        """GET /profile?seconds=N[&format=collapsed|cprofile|json|torch]:
        a profiling window from the process sampler (docs/observability.md
        §Sampling profiler), or with format=torch a device trace. Bad
        ``seconds`` clamp to the default 3."""
        import math

        from ..obs import profile as obs_profile

        fmt = qs.get("format", ["collapsed"])[0]
        if fmt == "torch":
            body = self._torch_profile(qs)
            self._send(req, 503 if "error" in body else 200, body)
            return
        if fmt == "jax":
            self._send(req, 400, {
                "error": "format=jax is the JAX package's device trace; "
                         "this node runs on PyTorch: use format=torch",
            })
            return
        try:
            seconds = float(qs.get("seconds", ["3"])[0])
        except ValueError:
            seconds = 3.0
        if not math.isfinite(seconds) or seconds <= 0:
            seconds = 3.0
        cap = obs_profile.capture(seconds)
        if "error" in cap:
            self._send(req, 503, cap)
            return
        if fmt == "json":
            self._send(req, 200, cap)
        elif fmt == "cprofile":
            self._send_text(
                req, 200,
                obs_profile.cprofile_text(cap["stacks"], 1.0 / cap["hz"]),
            )
        else:
            self._send_text(
                req, 200, obs_profile.collapsed_text(cap["stacks"])
            )

    _profile_lock = threading.Lock()

    def _torch_profile(self, qs) -> dict:
        """Capture a torch.profiler trace of the process (CPU ops and, on
        a card, its kernels and copies) for ?seconds=N (default 3, at most
        30) and export it as a chrome trace under
        <tmpdir>/babble_tpu_torch_profile; answers with the file's path, the
        window's length and this node's ``accel_sweeps`` at its start and
        end (two more applied sweeps mean the window held a whole one). One
        capture at a time."""
        import math
        import tempfile
        import time as _time

        import torch
        from torch.profiler import ProfilerActivity, profile

        try:
            seconds = float(qs.get("seconds", ["3"])[0])
        except ValueError:
            seconds = 3.0
        if not math.isfinite(seconds) or seconds <= 0:
            seconds = 3.0
        seconds = min(seconds, 30.0)
        accel = getattr(self.node.core.hg, "accel", None)

        def applied() -> int:
            return accel.sweeps if accel is not None else 0

        if not self._profile_lock.acquire(blocking=False):
            return {"error": "a profile capture is already running"}
        try:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            out_dir = os.path.join(tempfile.gettempdir(),
                                   "babble_tpu_torch_profile")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir,
                f"trace-{os.getpid()}-{_time.time_ns()}.json",  # lint: allow(clock: a unique trace file name, not a consensus time)
            )
            with profile(activities=activities) as prof:
                t0, first = _time.monotonic(), applied()  # lint: allow(clock: wall length of the live device trace's window)
                _time.sleep(seconds)  # lint: allow(clock: wall capture window for the live device trace)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                last = applied()
                window = _time.monotonic() - t0  # lint: allow(clock: wall length of the live device trace's window)
            prof.export_chrome_trace(path)
        finally:
            self._profile_lock.release()
        return {"trace_file": path, "seconds": seconds, "window_s": window,
                "activities": [a.name for a in activities],
                "accel_sweeps": [first, last]}

    @staticmethod
    def _send(req: BaseHTTPRequestHandler, code: int, body) -> None:
        payload = json.dumps(body).encode()
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)

    @staticmethod
    def _send_text(req: BaseHTTPRequestHandler, code: int, text: str) -> None:
        payload = text.encode()
        req.send_response(code)
        req.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)
