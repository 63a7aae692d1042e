"""Fault-tolerant training/streaming loop + the shared retry policy.

The port of ``repro.runtime.fault``.  The loop owns periodic async
checkpoints, restart-from-latest recovery and a bounded retry budget.
Failures surface as exceptions from the step function (here:
``SimulatedFailure`` injected by tests and by the chaos harness).
Recovery = restore the latest usable checkpoint and replay — steps are
deterministic functions of (state, step_index), so the recovered run is
identical to an uninterrupted one.

``RetryPolicy`` is the one place retry budgets and exponential backoff
live: ``FaultTolerantLoop`` restarts and the ingestion frontier's source
reconnects (``repro_torch.stream.ingest``) consume the same policy.
Delays are deterministic given an ``rng`` (jitter draws from it), and
``sleep`` is injectable, so tests can pin schedules.

``mesh``/``specs`` (a sharded restore) raise ``NotImplementedError``
until the mesh slice of the port.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    CheckpointError,
    checkpoint_steps,
    restore_checkpoint,
    validate_checkpoint,
)

log = logging.getLogger(__name__)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + jitter.

    ``max_attempts`` counts RETRIES (recoveries), not first tries: a
    policy with ``max_attempts=3`` allows an operation to fail and be
    retried three times before the caller gives up.  ``delay(attempt)``
    is the backoff before retry number ``attempt`` (1-based):
    ``base_delay_s * multiplier**(attempt-1)`` capped at ``max_delay_s``,
    plus up to ``jitter_frac`` of itself drawn from ``rng`` (no rng:
    no jitter — fully deterministic).
    """

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter_frac: float = 0.1

    def __post_init__(self):
        if self.max_attempts < 0 or self.base_delay_s < 0:
            raise ValueError("max_attempts and base_delay_s must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1 (backoff, not decay)")

    def delay(self, attempt: int, rng: np.random.Generator | None = None
              ) -> float:
        """Backoff in seconds before retry ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.multiplier ** max(0, attempt - 1),
                self.max_delay_s)
        if rng is not None and self.jitter_frac > 0 and d > 0:
            d += float(rng.uniform(0, self.jitter_frac * d))
        return d

    def exhausted(self, attempt: int) -> bool:
        return attempt > self.max_attempts


class FaultTolerantLoop:
    def __init__(
        self,
        ckpt_dir: str,
        step_fn: Callable,            # (state, step_idx) -> state
        make_init_state: Callable,    # () -> state
        ckpt_every: int = 50,
        max_restarts: int = 5,
        retry: RetryPolicy | None = None,
        sleep: Callable[[float], None] = time.sleep,
        mesh=None,
        specs=None,
    ):
        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "a sharded restore (mesh=/specs=) belongs to the mesh "
                "slice of the port")
        self.ckpt_dir = ckpt_dir
        self.step_fn = step_fn
        self.make_init_state = make_init_state
        self.ckpt_every = ckpt_every
        # restart budget and backoff share one policy with ingest
        # reconnects; ``max_restarts`` maps onto it (zero base delay:
        # restarts are immediate)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=max_restarts, base_delay_s=0.0)
        self.sleep = sleep
        self.mesh = mesh
        self.specs = specs
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.restarts = 0

    @property
    def max_restarts(self) -> int:
        return self.retry.max_attempts

    def _resume(self):
        """Restore the newest USABLE checkpoint: torn/partial files (a
        crash mid-write, a bad disk) are skipped, falling back to the
        previous step rather than wedging recovery."""
        state = self.make_init_state()
        for step in reversed(checkpoint_steps(self.ckpt_dir)):
            try:
                validate_checkpoint(self.ckpt_dir, step)
                restored = restore_checkpoint(
                    self.ckpt_dir, step, state, self.mesh, self.specs)
            except CheckpointError as e:
                log.warning("skipping torn checkpoint step %d: %s", step, e)
                continue
            log.info("restored checkpoint at step %d", step)
            return restored, step
        return state, 0

    def run(self, n_steps: int):
        while True:
            state, start = self._resume()
            try:
                for i in range(start, n_steps):
                    state = self.step_fn(state, i)
                    done = i + 1
                    if done % self.ckpt_every == 0 or done == n_steps:
                        self.ckpt.save(done, state)
                self.ckpt.wait()
                return state
            except SimulatedFailure as e:
                self.ckpt.wait()
                self.restarts += 1
                if self.retry.exhausted(self.restarts):
                    raise RuntimeError("restart budget exhausted") from e
                log.warning("failure at restart=%d: %s — recovering",
                            self.restarts, e)
                self.sleep(self.retry.delay(self.restarts))
