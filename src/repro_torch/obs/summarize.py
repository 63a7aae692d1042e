"""Trace-summary CLI: ``python -m repro_torch.obs summarize trace.jsonl``.

Reads a span-JSONL trace written by :class:`repro_torch.obs.Tracer` and
prints a per-span-name table (count, total ms, mean, exact p50/p99 via
the shared nearest-rank helper) plus per-tick aggregates (ticks seen,
mean spans per tick, worst tick by total ms).  Returns the summary as a
dict so tests can round-trip it.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

from .metrics import percentile

__all__ = ["summarize_trace", "format_summary", "main"]


def summarize_trace(path_or_lines) -> dict:
    """Aggregate a JSONL trace. Accepts a path or an iterable of lines."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as fh:
            lines = fh.readlines()
    else:
        lines = list(path_or_lines)

    by_span: dict[str, list[float]] = defaultdict(list)
    by_tick: dict[int, float] = defaultdict(float)
    n_bad = 0
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
            name, ms = rec["span"], float(rec["ms"])
        except (ValueError, KeyError):
            n_bad += 1
            continue
        by_span[name].append(ms)
        by_tick[int(rec.get("tick", 0))] += ms

    spans = {
        name: {
            "count": len(ms),
            "total_ms": round(sum(ms), 4),
            "mean_ms": round(sum(ms) / len(ms), 4),
            "p50_ms": round(percentile(ms, 0.50), 4),
            "p99_ms": round(percentile(ms, 0.99), 4),
        }
        for name, ms in sorted(by_span.items())
    }
    worst = max(by_tick.items(), key=lambda kv: kv[1], default=(0, 0.0))
    return {
        "n_spans": sum(s["count"] for s in spans.values()),
        "n_ticks": len(by_tick),
        "n_bad_lines": n_bad,
        "spans": spans,
        "worst_tick": {"tick": worst[0], "total_ms": round(worst[1], 4)},
    }


def format_summary(summary: dict) -> str:
    w = max([len(n) for n in summary["spans"]] + [4])
    out = [f"{'span':<{w}}  {'count':>7} {'total_ms':>10} "
           f"{'mean_ms':>9} {'p50_ms':>8} {'p99_ms':>8}"]
    for name, s in summary["spans"].items():
        out.append(f"{name:<{w}}  {s['count']:>7} {s['total_ms']:>10.3f} "
                   f"{s['mean_ms']:>9.4f} {s['p50_ms']:>8.4f} "
                   f"{s['p99_ms']:>8.4f}")
    out.append(f"-- {summary['n_spans']} spans over {summary['n_ticks']} "
               f"ticks; worst tick #{summary['worst_tick']['tick']} "
               f"({summary['worst_tick']['total_ms']}ms)")
    if summary["n_bad_lines"]:
        out.append(f"-- WARNING: {summary['n_bad_lines']} unparseable lines")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] != "summarize":
        print("usage: python -m repro_torch.obs summarize <trace.jsonl>",
              file=sys.stderr)
        return 2
    summary = summarize_trace(argv[1])
    print(format_summary(summary))
    return 0
