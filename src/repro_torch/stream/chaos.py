"""Fault injection for the ingestion frontier: wrap any ``Source`` in
scripted chaos.

The port of ``repro.stream.chaos``: the same seed injects the same
faults (the same draws from one ``np.random.default_rng``).

``ChaosSource`` sits between a real transport and its ``SourceAdapter``
and injects, from one seeded rng (fully reproducible):

* **disconnects** — ``poll`` raises ``ChaosDisconnect`` (a
  ``SourceDisconnected`` that is also a ``runtime.fault.
  SimulatedFailure``, so the same except-clauses the crash/restore
  harnesses use catch it); reconnects optionally **rewind** the resume
  cursor to replay already-delivered events (at-least-once transport);
* **duplicate delivery** — a recently delivered event is delivered
  again with its original seq;
* **reordering** — deliveries detour through a bounded shuffle pool, so
  events leave up to ``reorder_span`` positions late;
* **stalls** — ``poll`` returns nothing for a few rounds;
* **torn batches** — a batch is cut short and the connection dies, the
  tail redelivered only after reconnect-with-resume.

The differential harness (tests/test_torch_ingest.py) proves the whole
point: a chaos-wrapped multi-source run produces the exact oracle match
multiset of the equivalent pre-ordered single-stream run, minus nothing
— every excluded delivery shows up in the dedup/late-drop counters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.runtime.fault import SimulatedFailure
from repro_torch.stream.ingest import Source, SourceDisconnected, SourceEvent


class ChaosDisconnect(SourceDisconnected, SimulatedFailure):
    """An injected transport failure (retryable, simulated)."""


@dataclass(frozen=True)
class ChaosConfig:
    """Scripted-fault probabilities, all drawn from ``seed``.

    Defaults are all-zero: a ``ChaosSource`` with the default config is
    a transparent pass-through (tested), so wrapping is always safe.
    """

    seed: int = 0
    p_disconnect: float = 0.0    # per poll: raise before delivering
    rewind: int = 4              # resume cursor rewind on reconnect
    p_duplicate: float = 0.0     # per delivery: re-deliver a recent event
    reorder_span: int = 0        # max shuffle-pool detour, in deliveries
    p_reorder: float = 0.0       # per delivery: detour through the pool
    p_stall: float = 0.0         # per poll: start a stall
    stall_len: int = 3           # empty polls per stall
    p_torn: float = 0.0          # per poll: cut the batch + die next poll


class ChaosSource(Source):
    """Wrap ``inner`` with scripted faults (``ChaosConfig``).

    Keeps the inner source's name (resume manifests key on it).  The
    shuffle pool and duplicate history are chaos-internal: a disconnect
    drops the pool on the floor (torn delivery), which is safe because
    the downstream adapter reconnects from its tracker floor — nothing
    undelivered can be sequenced below that floor.
    """

    HISTORY = 64      # recent deliveries eligible for duplicate delivery

    def __init__(self, inner: Source, cfg: ChaosConfig = ChaosConfig()):
        self.inner = inner
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.name = inner.name
        self._pool: list[SourceEvent] = []      # reorder detours
        self._history: list[SourceEvent] = []   # duplicate candidates
        self._stall_left = 0
        self._die_next_poll = False
        self.n_injected_disconnects = 0
        self.n_injected_duplicates = 0
        self.n_injected_stalls = 0
        self.n_injected_torn = 0

    def connect(self, resume_from: int = 0) -> None:
        self._pool.clear()
        self._die_next_poll = False
        self.inner.connect(
            resume_from=max(0, resume_from - self.cfg.rewind))

    def close(self) -> None:
        self.inner.close()

    @property
    def exhausted(self) -> bool:
        return self.inner.exhausted and not self._pool \
            and not self._die_next_poll

    def _disconnect(self, kind: str) -> None:
        self.n_injected_disconnects += 1
        raise ChaosDisconnect(f"chaos[{self.name}]: injected {kind}")

    def poll(self, max_events: int = 64) -> list[SourceEvent]:
        cfg, rng = self.cfg, self.rng
        if self._die_next_poll:
            self._die_next_poll = False
            self._disconnect("torn-batch disconnect")
        if self._stall_left > 0:
            self._stall_left -= 1
            return []
        if rng.random() < cfg.p_stall:
            self.n_injected_stalls += 1
            self._stall_left = cfg.stall_len
            return []
        if rng.random() < cfg.p_disconnect:
            self._disconnect("disconnect")
        incoming = self.inner.poll(max_events)
        out: list[SourceEvent] = []
        for ev in incoming:
            if cfg.reorder_span > 0 and rng.random() < cfg.p_reorder:
                self._pool.append(ev)       # detour: leaves late
            else:
                out.append(ev)
        # release detoured events, oldest-biased, bounding the detour
        while self._pool and (
                len(self._pool) > cfg.reorder_span or rng.random() < 0.5):
            out.append(self._pool.pop(0))
        dup_out: list[SourceEvent] = []
        for ev in out:
            dup_out.append(ev)
            self._history.append(ev)
            if rng.random() < cfg.p_duplicate and self._history:
                pick = self._history[rng.integers(len(self._history))]
                dup_out.append(pick)
                self.n_injected_duplicates += 1
        self._history = self._history[-self.HISTORY:]
        if dup_out and rng.random() < cfg.p_torn:
            cut = int(rng.integers(0, len(dup_out)))
            self.n_injected_torn += 1
            self._die_next_poll = True
            dup_out = dup_out[:cut]
        return dup_out
