"""repro_torch.obs — metrics + tracing for the serve loop.

The port of ``repro.obs`` (pure Python and numpy), with the same
instrument names, snapshots, Prometheus text and trace format:

* :class:`MetricsRegistry` / :class:`Counter` / :class:`Gauge` /
  :class:`Histogram`: the namespaced instrument registry (``tick.*``,
  ``coalescer.*``, ``share.*``, ``ckpt.*``);
* :class:`Tracer`: host-side JSONL span timers with per-tick
  correlation ids;
* :func:`to_prometheus`: text exposition snapshot;
* :func:`summarize_trace`: ``python -m repro_torch.obs summarize``.
"""

from .export import to_prometheus
from .metrics import (
    DEFAULT_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from .summarize import format_summary, summarize_trace
from .trace import Span, Tracer, memory_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "Tracer",
    "Span",
    "memory_tracer",
    "to_prometheus",
    "summarize_trace",
    "format_summary",
]
