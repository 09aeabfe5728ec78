"""Metrics-docs lint — compat shim.

The metricslint implementation moved into the babblelint suite as its
``metrics`` pass (``babble_tpu_torch/analysis/metrics_pass.py``,
docs/static_analysis.md); this module keeps the historical surface —
``python -m babble_tpu_torch.obs.lint [docs/observability.md]``, plus the
``documented_names``/``run``/``main`` functions and the table markers —
so ``make metricslint`` and existing imports keep working unchanged.
"""

from __future__ import annotations

import sys

from ..analysis.metrics_pass import (  # noqa: F401
    END,
    START,
    documented_names,
    main,
    run,
)

if __name__ == "__main__":
    sys.exit(main())
