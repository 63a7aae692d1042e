"""Low-overhead metrics registry: counters, gauges, latency histograms.

The port of ``repro.obs.metrics`` (pure Python and numpy; the same
names, snapshots and checkpoint manifests).

One process-local :class:`MetricsRegistry` unifies every stat surface in
the repo (``ServeInfo``, ``EngineStats``, ``SessionStatus``,
``forest_stats()``, ``MeshTickStats``) under a namespaced scheme::

    ingest.*     frontier counters, watermark lag
    coalescer.*  AIMD batch decisions
    tick.*       slot-tick latency (dispatch + barrier), matches, overflow
    share.*      prefix-forest shape
    ckpt.*       checkpoint publish latency, async stall
    mesh.*       per-replica load / pressure

Design constraints (the tentpole's "provably free" bar):

* Instruments are plain Python attribute bumps — ``Counter.inc`` is one
  int add, ``Gauge.set`` one float store.  Nothing here touches torch.
* :class:`Histogram` pre-allocates a fixed numpy sample ring at
  construction, so ``observe()`` never allocates on the hot path.  It
  keeps BOTH fixed log-scale bucket counts (Prometheus export) and the
  raw ring: percentiles are EXACT (nearest-rank over the retained
  samples) while fewer than ``ring_size`` observations have been made —
  the regime every test and benchmark here runs in — and fall back to
  bucket upper bounds beyond that.
* Expensive surfaces (forest stats, replica load) register *callback
  gauges*: a zero-cost function pointer evaluated only at snapshot
  time, never on the serve loop.

Counters and histograms survive checkpoint/restore via
``to_manifest``/``load_manifest`` (bucket counts and total counts ride
along; the raw ring does not — percentiles after a restore re-fill from
live traffic, which is the honest reading anyway).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "DEFAULT_LATENCY_BUCKETS_MS",
]


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, the repo-wide formula.

    This is byte-for-byte the math the benches used inline before the
    obs layer existed (``sorted(x)[min(len-1, int(q*len))]``), kept as
    THE shared helper so every surface reports identical numbers.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    n = len(samples)
    if n == 0:
        return 0.0
    srt = sorted(samples)
    return float(srt[min(n - 1, int(q * n))])


# log-spaced upper bounds, 10us .. ~100s — fine enough that a bucket
# fallback is within ~2x of truth anywhere on the serve loop
DEFAULT_LATENCY_BUCKETS_MS: tuple[float, ...] = tuple(
    round(10 ** (e / 4), 4) for e in range(-8, 21)
)


class Counter:
    """Monotonic counter.  ``inc`` is one int add — safe on the serve
    loop at any frequency."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = int(value)

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set_total(self, total: int) -> None:
        """Jump to an absolute total (mirroring an external counter).

        Monotone by construction: regressions (e.g. a source object
        replaced mid-run) are ignored rather than double-counted.
        """
        if total > self.value:
            self.value = total


class Gauge:
    """Point-in-time value; last write wins."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = float(value)

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram with an exact-percentile ring.

    ``observe`` cost: one searchsorted over a small fixed array plus two
    stores — no allocation (the ring and bucket counts are pre-allocated
    at construction).
    """

    __slots__ = ("name", "buckets", "counts", "count", "total",
                 "_ring", "_ring_n")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 ring_size: int = 4096):
        self.name = name
        self.buckets = np.asarray(buckets, dtype=np.float64)
        if not np.all(np.diff(self.buckets) > 0):
            raise ValueError(f"{name}: bucket bounds must be increasing")
        # counts[i] = observations <= buckets[i]; counts[-1] = +Inf bucket
        self.counts = np.zeros(len(self.buckets) + 1, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self._ring = np.zeros(ring_size, dtype=np.float64)
        self._ring_n = 0

    def observe(self, v: float) -> None:
        i = int(np.searchsorted(self.buckets, v, side="left"))
        self.counts[i] += 1
        self.count += 1
        self.total += v
        ring = self._ring
        ring[self._ring_n % len(ring)] = v
        self._ring_n += 1

    # ----------------------------------------------------------- #
    def samples(self) -> np.ndarray:
        """Raw retained samples (ring order is irrelevant for ranks)."""
        n = min(self._ring_n, len(self._ring))
        return self._ring[:n]

    def quantile(self, q: float) -> float:
        """Exact nearest-rank percentile while the ring holds every
        observation; bucket-upper-bound estimate once samples have been
        evicted (``count > ring_size``)."""
        if self.count == 0:
            return 0.0
        if self.exact:
            return percentile(self.samples().tolist(), q)
        # bucket fallback: smallest upper bound covering rank
        rank = min(self.count - 1, int(q * self.count))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank + 1, side="left"))
        if i >= len(self.buckets):
            return float(self.buckets[-1])
        return float(self.buckets[i])

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def exact(self) -> bool:
        """True while the ring still holds EVERY observation — no
        eviction, no restored bucket-only history."""
        return self._ring_n == self.count and self._ring_n <= len(self._ring)


class MetricsRegistry:
    """Create-or-get instrument registry with callback gauges.

    Thread-safe for instrument *creation* (benches and the async
    checkpointer may race); instrument *updates* are GIL-atomic plain
    stores by design.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._callbacks: dict[str, Callable[[], float]] = {}

    # ------------------------------------------------ instruments -- #
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  ring_size: int = 4096) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    name, Histogram(name, buckets, ring_size))
        return h

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Collect-time callback gauge: ``fn`` runs only at snapshot,
        never on the serve loop.  Re-registration replaces (restore)."""
        with self._lock:
            self._callbacks[name] = fn

    # -------------------------------------------------- snapshot -- #
    def snapshot(self) -> dict[str, float]:
        """Flat name -> value view: counters, gauges (incl. callbacks),
        and per-histogram count/mean/p50/p99 derived series."""
        out: dict[str, float] = {}
        for n, c in sorted(self._counters.items()):
            out[n] = c.value
        for n, g in sorted(self._gauges.items()):
            out[n] = g.value
        for n, fn in sorted(self._callbacks.items()):
            try:
                out[n] = float(fn())
            except Exception:
                out[n] = math.nan
        for n, h in sorted(self._hists.items()):
            out[f"{n}.count"] = h.count
            out[f"{n}.mean"] = h.mean
            out[f"{n}.p50"] = h.quantile(0.50)
            out[f"{n}.p99"] = h.quantile(0.99)
        return out

    def counters(self) -> Mapping[str, Counter]:
        return self._counters

    def histograms(self) -> Mapping[str, Histogram]:
        return self._hists

    # ------------------------------------------ checkpoint support -- #
    def to_manifest(self) -> dict:
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "hists": {
                n: {
                    "buckets": h.buckets.tolist(),
                    "counts": h.counts.tolist(),
                    "count": h.count,
                    "total": h.total,
                }
                for n, h in self._hists.items()
            },
        }

    def load_manifest(self, man: Mapping) -> None:
        for n, v in man.get("counters", {}).items():
            self.counter(n).set_total(int(v))
        for n, hm in man.get("hists", {}).items():
            h = self.histogram(n, buckets=hm["buckets"])
            if h.count == 0:          # fresh instrument: adopt history
                h.counts = np.asarray(hm["counts"], dtype=np.int64)
                h.count = int(hm["count"])
                h.total = float(hm["total"])
                # bucket history arrives without raw samples, so the
                # ring no longer holds every observation: quantiles
                # fall back to bucket bounds (h.exact stays False)
