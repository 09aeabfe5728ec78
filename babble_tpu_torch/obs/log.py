"""One logging entry point for the whole framework.

Every process (CLI node, signal server, dummy app, demos, benches)
configures logging through ``configure()`` instead of ad-hoc per-module
setup: one handler on the ``babble_tpu_torch`` root logger, plain or JSON
format, level from ``Config.log_level`` / ``--log``, JSON via
``Config.log_json`` / ``--log-json``.

The JSON formatter emits one object per line with stable keys —
``ts``, ``level``, ``logger``, ``msg`` — plus correlation fields when
present on the record or configured process-wide: ``node`` (moniker),
``node_id``, ``peer``, ``sync_id``. Handlers are installed
idempotently (reconfiguring replaces the previous obs handler, never
stacks a second one), and propagation to the root logger is disabled
so embedding applications keep their own logging untouched.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

ROOT = "babble_tpu_torch"
_HANDLER_TAG = "_babble_obs_handler"

# Correlation fields copied from log-record attributes when set (via
# ``logger.info(..., extra={"peer": id, "sync_id": n})``).
_EXTRA_FIELDS = ("node", "node_id", "peer", "sync_id")


class JsonFormatter(logging.Formatter):
    """One JSON object per line; correlation fields ride along."""

    def __init__(self, node: Optional[str] = None,
                 node_id: Optional[int] = None):
        super().__init__()
        self._node = node
        self._node_id = node_id

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if self._node is not None:
            out["node"] = self._node
        if self._node_id is not None:
            out["node_id"] = self._node_id
        for f in _EXTRA_FIELDS:
            v = getattr(record, f, None)
            if v is not None and f not in out:
                out[f] = v
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"), default=str)


def configure(
    level: str = "info",
    json_mode: bool = False,
    node: Optional[str] = None,
    node_id: Optional[int] = None,
    stream=None,
) -> logging.Logger:
    """Install (or replace) the framework's single log handler.

    ``level`` is a name (debug/info/warning/error); ``json_mode``
    switches the structured formatter on; ``node``/``node_id`` stamp
    every line for multi-node log aggregation."""
    root = logging.getLogger(ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    handler = logging.StreamHandler(stream)
    if json_mode:
        handler.setFormatter(JsonFormatter(node=node, node_id=node_id))
    else:
        fmt = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
    setattr(handler, _HANDLER_TAG, True)
    for h in list(root.handlers):
        if getattr(h, _HANDLER_TAG, False):
            root.removeHandler(h)
    root.addHandler(handler)
    return root


def configure_from(conf, node: Optional[str] = None,
                   node_id: Optional[int] = None) -> logging.Logger:
    """Configure from a ``Config`` (log_level + log_json)."""
    return configure(
        level=conf.log_level,
        json_mode=bool(getattr(conf, "log_json", False)),
        node=node if node is not None else (conf.moniker or None),
        node_id=node_id,
    )
