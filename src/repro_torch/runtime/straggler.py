"""Straggler mitigation for the streaming engine: adaptive tick coalescing.

On a pod, the tick latency is (join compute + delta all-gathers); a slow
shard (straggler) delays the barrier.  The paper's single-node answer is
more threads; the distributed answer is *backpressure-aware batching*:
if arrival rate exceeds tick throughput (queue depth grows), coalesce
more edges per tick — per-edge cost falls roughly linearly in batch
size until table-join compute dominates (see benchmarks/bench_concurrency).

``TickCoalescer`` is a tiny AIMD controller over the tick batch size,
mirroring how production stream processors (Flink/Dataflow) adapt bundle
sizes.  Host-side logic: deterministic given its input trace, unit- and
property-tested (tests/test_straggler_props.py).  The serving loop
(``ContinuousSearchService.serve_stream``) feeds it the per-tick
barrier latency — slot groups dispatch asynchronously and meet at one
barrier, so the slowest group inherently sets the pace — with
``quantize_pow2`` bounding how many distinct padded batch shapes the
adaptive sizes can produce.  It also
feeds the tick's engine overflow count (``ServeInfo.n_overflow``): a
tick that dropped appends gets the batch halved regardless of latency,
closing the capacity-backpressure loop at the serve-loop level.
"""

from __future__ import annotations

import dataclasses


def quantize_pow2(n: int, lo: int = 8) -> int:
    """Round a chunk length up to the next power of two, at least ``lo``.

    Adaptive coalescing produces arbitrary chunk lengths; padding each to
    the next power of two keeps the set of batch shapes logarithmic in
    the batch range.
    """
    n = max(int(n), 1)
    return max(lo, 1 << (n - 1).bit_length())


@dataclasses.dataclass
class TickCoalescer:
    min_batch: int = 32
    max_batch: int = 4096
    target_latency_ms: float = 50.0
    batch: int = 256
    _ema_latency: float = 0.0
    # last decision taken by record()/record_idle(), for observability
    # ("overflow_md" | "queue_mi" | "latency_ad" | "hold" | "idle");
    # the serve loop mirrors it into the obs registry — the coalescer
    # itself stays dependency-free
    last_action: str = "hold"

    def __post_init__(self):
        if not (0 < self.min_batch <= self.max_batch):
            raise ValueError(
                f"need 0 < min_batch <= max_batch, got "
                f"{self.min_batch}..{self.max_batch}")
        self.batch = min(max(self.batch, self.min_batch), self.max_batch)

    @classmethod
    def seeded(cls, batch: int, min_batch: int | None = None,
               max_batch: int | None = None,
               target_latency_ms: float = 50.0) -> "TickCoalescer":
        """Coalescer that honors ``batch`` as the starting size: unset
        bounds are widened around it instead of clamping it to the
        dataclass defaults (so a small requested batch is served as
        requested, and a lone ``max_batch`` below the default
        ``min_batch`` cannot conflict)."""
        if max_batch is None:
            max_batch = max(cls.max_batch, batch)
        if min_batch is None:
            min_batch = min(cls.min_batch, batch, max_batch)
        return cls(batch=batch, min_batch=min_batch, max_batch=max_batch,
                   target_latency_ms=target_latency_ms)

    def record(self, tick_latency_ms: float, queue_depth: int,
               n_overflow: int = 0) -> int:
        """Report the last tick; returns the batch size for the next one.

        ``n_overflow`` is the tick's dropped-append count (``ServeInfo.
        n_overflow``): a non-zero value means the chunk produced more
        candidate partial matches than the fixed tables could absorb, so
        the controller halves the batch immediately — a capacity signal
        stronger than the latency AD step, and one that fires even when
        the tick is FAST (small tables overflow quickly and cheaply).
        Latency-based MI never overrides it within the same tick.
        """
        a = 0.3
        self._ema_latency = (1 - a) * self._ema_latency + a * tick_latency_ms
        if n_overflow > 0:
            self.batch = max(self.min_batch, self.batch // 2)  # capacity MD
            self.last_action = "overflow_md"
        elif queue_depth > 2 * self.batch and \
                self._ema_latency < self.target_latency_ms:
            self.batch = min(self.max_batch, self.batch * 2)   # MI
            self.last_action = "queue_mi"
        elif self._ema_latency > self.target_latency_ms:
            self.batch = max(self.min_batch, int(self.batch * 0.8))  # AD
            self.last_action = "latency_ad"
        else:
            self.last_action = "hold"
        return self.batch

    def record_idle(self) -> int:
        """Report an EMPTY serving round (watermark-driven serving:
        sources stalled or the reorder buffer is holding everything
        back, so there was no tick).  The batch must not move — idle
        rounds carry no latency or queue signal, and growing on them
        would let a stalled stream inflate the batch unboundedly — but
        the latency EMA decays toward zero so a long stall does not
        leave a stale overload reading that would shrink the batch on
        the first real tick afterwards.
        """
        self._ema_latency *= 0.7
        self.last_action = "idle"
        return self.batch
