"""Exporters: Prometheus-style text snapshot of a MetricsRegistry.

Metric names keep the reference's ``repro_`` prefix, so a dashboard
reads either package's exposition unchanged.
"""

from __future__ import annotations

from .metrics import MetricsRegistry

__all__ = ["to_prometheus"]


def _sanitize(name: str) -> str:
    """``ingest.n_late_dropped`` -> ``repro_ingest_n_late_dropped``."""
    return "repro_" + name.replace(".", "_").replace("-", "_")


def to_prometheus(reg: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format.

    Counters/gauges become single samples; histograms become the
    standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` triple plus
    exact-quantile gauges (``quantile="0.5"|"0.99"``) while the sample
    ring still holds every observation.
    """
    lines: list[str] = []
    snap_hists = reg.histograms()
    for name, c in sorted(reg.counters().items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {c.value}")
    flat = reg.snapshot()
    hist_derived = {f"{n}{suffix}" for n in snap_hists
                    for suffix in (".count", ".mean", ".p50", ".p99")}
    for name in sorted(flat):
        if name in reg.counters() or name in hist_derived:
            continue
        m = _sanitize(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {flat[name]}")
    for name, h in sorted(snap_hists.items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for ub, n in zip(h.buckets, h.counts):
            cum += int(n)
            lines.append(f'{m}_bucket{{le="{ub}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{m}_sum {round(h.total, 6)}")
        lines.append(f"{m}_count {h.count}")
        for q in (0.5, 0.99):
            lines.append(f'{m}{{quantile="{q}"}} {round(h.quantile(q), 6)}')
    return "\n".join(lines) + "\n"
