"""Unified observability: metrics registry + round-loop span tracer.

``mythril_tpu_torch.obs`` is the one telemetry surface for the whole stack
(docs/OBSERVABILITY.md):

* :mod:`mythril_tpu_torch.obs.metrics` — thread-safe counters / gauges /
  histograms behind one snapshot/reset API (``REGISTRY``), plus the
  Prometheus text exposition served by the service ``metrics`` op;
* :mod:`mythril_tpu_torch.obs.trace` — begin/end spans over every round-loop
  seam with Chrome trace-event JSON export (``TRACER``);
* :mod:`mythril_tpu_torch.obs.catalog` — the single module where metric
  names are registered (enforced by the ``metric_names`` lint rule).

:func:`phase` is the instrumentation helper the round loop uses: one
context manager that both records a tracer span (when tracing is on)
and observes the duration into the ``myth_round_phase_s`` histogram
(when metrics are on) — each layer stays independently switchable.
"""

import time
from contextlib import contextmanager

from mythril_tpu_torch.obs import metrics
from mythril_tpu_torch.obs import trace
from mythril_tpu_torch.obs import catalog
from mythril_tpu_torch.obs.metrics import REGISTRY
from mythril_tpu_torch.obs.trace import TRACER

__all__ = [
    "REGISTRY",
    "TRACER",
    "catalog",
    "metrics",
    "phase",
    "trace",
]


@contextmanager
def phase(name: str, pid: int = 0, **args):
    """Span + per-phase histogram observation around one seam."""
    tracing = TRACER.enabled
    metering = metrics.enabled()
    if not tracing and not metering:
        yield
        return
    token = TRACER.begin(name, tid=name, pid=pid, **args) if tracing else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if metering:
            catalog.ROUND_PHASE_S.observe(time.perf_counter() - t0, name)
        TRACER.end(token)
