"""Telemetry layer: metrics registry, span tracer, structured logging, and
the Prometheus exposition the service serves at /metrics.

- ``obs.metrics``    — Counter/Gauge/Histogram instruments + Registry +
  Prometheus text rendering. ``BABBLE_OBS=0`` is the kill switch.
- ``obs.trace``      — the span tracer following one sync (and one
  transaction) through the pipeline, and the ``staged`` decorator the
  hashgraph core times its stages with.
- ``obs.telemetry``  — NodeTelemetry: the per-node registry wiring every
  subsystem's counters into instruments, the ``get_stats`` snapshot, and
  the /metrics and /telemetry renderers.
- ``obs.catalog``    — the instrument catalog (name, type, labels,
  meaning).
- ``obs.log``        — one logging entry point (level, JSON toggle,
  node-id correlation).
- ``obs.profile``    — the always-on thread-stack sampler behind
  ``GET /profile``.
- ``obs.flight`` and ``obs.provenance`` — the stall watchdog's flight
  recorder and the per-transaction provenance table.
- ``obs.ledger``     — the bench-history ledger (BENCH_HISTORY_TORCH.jsonl):
  schema-versioned perf records whose host fingerprint names torch, CUDA
  and the card.
- ``obs.perfgate``   — ``python -m babble_tpu_torch.obs.perfgate``:
  regression gate over the ledger (rolling same-host baseline,
  noise-aware bands, ``--inject-regression`` self-proof).
- ``obs.healthview`` — ``python -m babble_tpu_torch.obs.healthview``: every
  node's /metrics + /stats + /suspects merged into per-node lag, queue
  depths, quarantine and a commit-p50 SLO verdict.
- ``obs.traceview``  — ``python -m babble_tpu_torch.obs.traceview``: every
  node's provenance export merged into cross-node transaction timelines.
"""

from .metrics import Registry, enabled, set_enabled  # noqa: F401
