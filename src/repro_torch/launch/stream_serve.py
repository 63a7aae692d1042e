"""Single-query serving — a thin wrapper over the unified path.

There is ONE serving loop in the port:
``repro_torch.runtime.service.ContinuousSearchService``, fronted by the
public ``repro_torch.api.StreamSession`` facade.  ``StreamServer`` keeps the
historical single-query API (construct from an ExecutionPlan, feed
DataEdge lists, get an array-level ``on_match`` callback) but builds no
ticks and owns no loop of its own: it registers its one query as a
tenant of a one-slot service *through the api session*
(``StreamSession.adopt`` + ``register_query``, which also rides the
session's vocab/pattern state inside every checkpoint manifest) and
delegates ingest — adaptive tick coalescing, periodic async
checkpoints, power-of-two batch padding — to ``serve_stream``.  The
typed per-match surface is one call away: ``server.subscription``.

Fault tolerance comes from the service layer too: with ``ckpt_dir`` set,
a restarted ``StreamServer`` restores the full service (expansion lists,
tick/edge counters) from the newest usable checkpoint — torn files are
skipped — and misses nothing that is still inside the window.

The port of ``repro.launch.stream_serve``; the server runs on the card
(``device=None`` means CUDA) unless it is given ``device="cpu"``.
"""

from __future__ import annotations

from repro_torch.api import StreamSession, Subscription
from repro_torch.checkpoint import (
    CheckpointError,
    checkpoint_steps,
    latest_step,
    load_manifest,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.registry import plan_decomposition
from repro_torch.runtime.service import ContinuousSearchService
from repro_torch.runtime.straggler import TickCoalescer


class StreamServer:
    """One standing query served through the ``repro_torch.api`` session
    path."""

    def __init__(self, plan: ExecutionPlan, ckpt_dir: str | None = None,
                 extract_matches: bool | None = None,
                 backend: str | None = None,
                 tick_cache=None, *, device=None):
        """``backend`` / ``extract_matches`` left unset mean: use the
        checkpointed values when restoring (the device's default join
        backend / True when starting fresh) — passing them explicitly
        overrides either way."""
        lv = plan.subqueries[0].levels[0]
        l0_cap = plan.l0_joins[0].capacity if plan.l0_joins else lv.capacity
        self._coalescer = None       # AIMD state, persistent across ingests
        if ckpt_dir and checkpoint_steps(ckpt_dir):
            try:
                # restore validates (hashes) the chosen step exactly once
                service = ContinuousSearchService.restore(
                    ckpt_dir, tick_cache=tick_cache, backend=backend,
                    extract_matches=extract_matches, device=device)
            except CheckpointError as e:
                # fail loudly rather than silently starting fresh: a
                # fresh start here would break the miss-nothing guarantee
                last = latest_step(ckpt_dir)
                if last is not None and \
                        "service" not in load_manifest(ckpt_dir, last):
                    raise ValueError(
                        f"ckpt_dir {ckpt_dir!r} holds checkpoints without "
                        "a service manifest (legacy StreamServer or "
                        "foreign writer); clear the directory or restore "
                        "it manually") from e
                raise CheckpointError(
                    f"ckpt_dir {ckpt_dir!r} contains checkpoints but none "
                    "are usable (all torn/partial)") from e
            self.session = StreamSession.adopt(service)
            qids = service.registry.qids()
            if len(qids) != 1:
                raise ValueError(
                    f"checkpoint under {ckpt_dir!r} holds {len(qids)} "
                    "queries; restore it as a ContinuousSearchService")
            self.qid = qids[0]
            rq = service.registry.get(self.qid)
            if rq.query != plan.query or rq.window != plan.window:
                raise ValueError(
                    f"checkpoint under {ckpt_dir!r} holds a different "
                    f"query/window (checkpointed window={rq.window}, "
                    f"requested {plan.window})")
            # capacity / decomposition drift must be loud too: restore
            # always serves the checkpointed plan, so a caller who
            # recompiled (e.g. grew capacities after overflow) must not
            # silently keep the old tables
            r_lv = rq.plan.subqueries[0].levels[0]
            r_l0 = (rq.plan.l0_joins[0].capacity if rq.plan.l0_joins
                    else r_lv.capacity)
            if (r_lv.capacity, r_lv.max_new, r_l0) != \
                    (lv.capacity, lv.max_new, l0_cap) or \
                    plan_decomposition(rq.plan) != plan_decomposition(plan):
                raise ValueError(
                    f"checkpoint under {ckpt_dir!r} was written with "
                    "different plan capacities or decomposition; clear "
                    "the directory to serve the new plan from scratch")
        else:
            service = ContinuousSearchService(
                slots_per_group=1,
                level_capacity=lv.capacity,
                l0_capacity=l0_cap,
                max_new=lv.max_new,
                backend=backend,
                extract_matches=(True if extract_matches is None
                                 else extract_matches),
                ckpt_dir=ckpt_dir,
                tick_cache=tick_cache,
                device=device,
            )
            self.session = StreamSession.adopt(service)
            # register the EXACT plan (a caller's custom decomposition
            # must be served, not re-derived; register_query skips
            # canonicalization for exactly that reason)
            self.qid = self.session.register_query(
                plan.query, plan.window, plan=plan).qid
        self.plan = self.service.registry.get(self.qid).plan

    # ------------------------------------------------------------------ #
    @property
    def service(self) -> ContinuousSearchService:
        return self.session.service

    @property
    def subscription(self) -> Subscription:
        """The typed api handle for this server's one query (named
        bindings, ``matches()``/``drain()``, overflow status)."""
        return self.session._subs[self.qid]

    @property
    def state(self):
        return self.service.state(self.qid)

    @property
    def ticks(self) -> int:
        return self.service.n_ticks

    @property
    def resume_offset(self) -> int:
        """Edges already consumed (slice your replay stream here after a
        restore)."""
        return self.service.n_edges_ingested

    def matches(self):
        return self.service.matches(self.qid)

    # ------------------------------------------------------------------ #
    def ingest(self, edges: list, on_match=None, ckpt_every: int = 0,
               batch_size: int = 64):
        """Feed DataEdges; returns total new matches reported.

        ``on_match(bindings, ets)`` receives raw engine arrays (the
        historical surface) and, when given, is the sole consumer of the
        matches.  Without it, matches route to the typed
        ``self.subscription`` surface instead — its ``on_match(Match)``
        callback if attached, else its ``drain()`` queue (bounded at
        ``Subscription.MAX_PENDING`` — drain regularly on long streams
        or the oldest matches are dropped and counted).  The
        adaptive batch-size (AIMD) state persists across ``ingest``
        calls, so a consumer feeding the server in repeated chunks keeps
        the batch size it converged to (``batch_size`` only seeds the
        first call)."""
        if self._coalescer is None:
            self._coalescer = TickCoalescer.seeded(batch_size)
        if on_match is not None:
            cb = lambda qid, bindings, ets: on_match(bindings, ets)
        elif self.service.extract_matches:
            sub = self.subscription
            cb = lambda qid, bindings, ets: sub._deliver_rows(bindings, ets)
        else:
            cb = None
        totals = self.service.serve_stream(
            edges, on_match=cb, ckpt_every=ckpt_every,
            coalescer=self._coalescer)
        return totals.get(self.qid, 0)
