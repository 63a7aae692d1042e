"""Multi-query continuous search: one stream, many standing queries.

The port of ``repro.core.multi``.

``build_multi_tick(plans)``
    Heterogeneous fusion: one label scan over all queries' concatenated
    query-edge tables, then each query's body (at S = 1) on its slice.
    Results equal N independent ``build_tick`` runs.

``build_slot_tick(template_plan)``
    Homogeneous padded slots.  Everything the tick body closes over is
    structural (``repro_torch.core.registry.plan_signature``); the
    per-slot labels and windows are runtime tensors stacked ``[S, ...]``.
    The reference ``jax.vmap``s its body over the slots; here the body
    itself runs over the slot axis, so every join of a slot group's tick
    is one kernel launch for all its slots, with the stream-edge side of
    the level joins shared (read once) across slots.  Registering or
    unregistering a query of an already-built structure is a pure data
    write — no rebuild — which is what lets the service serve a
    changing query population at a fixed build count.

Slot writes (``write_slot`` / ``clear_slot``) update the slot group's
tensors in place: the service owns its ``SlotState``, and a churn event
then costs one slot's tables, not a copy of the group.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import join as J
from repro_torch.core.engine import (
    TickResult,
    build_tick_body,
    edge_match_mask,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.state import (
    PORT_TYPES,
    EdgeBatch,
    EngineState,
    init_state,
    map_state,
    resolve_device,
)

I32 = torch.int32


def _labels(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


# --------------------------------------------------------------------- #
# Heterogeneous fusion: build_multi_tick
# --------------------------------------------------------------------- #
class MultiEngineState(NamedTuple):
    """State for N fused queries: one EngineState per plan and a bool
    ``active`` flag per query (off: the query's tables stop growing)."""

    queries: tuple          # tuple[EngineState, ...], parallel to plans
    active: torch.Tensor    # bool [n_queries]


def init_multi_state(plans: Sequence[ExecutionPlan], active=None, *,
                     device=None) -> MultiEngineState:
    device = resolve_device(device)
    if active is None:
        active = np.ones((len(plans),), bool)
    return MultiEngineState(
        queries=tuple(init_state(p, device=device) for p in plans),
        active=torch.as_tensor(np.asarray(active, bool), device=device),
    )


def set_active(mstate: MultiEngineState, qi: int,
               value: bool) -> MultiEngineState:
    """A copy of ``mstate`` with query ``qi``'s ``active`` flag set
    (the input is left as it was, as the reference's functional update
    leaves it)."""
    active = mstate.active.clone()
    active[qi] = value
    return mstate._replace(active=active)


def reset_query(mstate: MultiEngineState, plans: Sequence[ExecutionPlan],
                qi: int) -> MultiEngineState:
    """Replace query ``qi``'s tables with empty ones (e.g. on re-arm)."""
    qs = list(mstate.queries)
    qs[qi] = init_state(plans[qi], device=mstate.active.device)
    return mstate._replace(queries=tuple(qs))


def build_multi_tick(
    plans: Sequence[ExecutionPlan],
    backend: str | None = None,
    extract_matches: bool = True,
    max_out: int | None = None,
    *,
    device=None,
):
    """Fuse ``plans`` into one ``tick(mstate, batch) -> (mstate, results)``.

    ``results`` is a tuple of per-query ``TickResult``s, index-parallel
    to ``plans``.  The label-match phase runs ONCE over the concatenated
    query-edge tables; each query's body consumes its slice, gated by
    its ``active`` flag.
    """
    plans = list(plans)
    if not plans:
        raise ValueError("build_multi_tick needs at least one plan")
    device = resolve_device(device)
    backend = J.resolve_backend(backend, device)
    bodies = [
        build_tick_body(p, backend=backend, extract_matches=extract_matches,
                        max_out=max_out)
        for p in plans
    ]
    esl = _labels(np.concatenate([p.edge_src_label for p in plans]), device)
    edl = _labels(np.concatenate([p.edge_dst_label for p in plans]), device)
    eel = _labels(np.concatenate([p.edge_edge_label for p in plans]), device)
    offsets = np.cumsum([0] + [p.query.n_edges for p in plans])
    windows = [torch.tensor([p.window], dtype=I32, device=device)
               for p in plans]

    def tick(mstate: MultiEngineState, batch: EdgeBatch, watermark=None):
        em_all = edge_match_mask(batch, esl, edl, eel)
        states, results = [], []
        for qi, body in enumerate(bodies):
            # an inactive query sees an all-invalid batch: no appends, no
            # stats drift, frozen t_now
            act = mstate.active[qi]
            valid = (batch.valid & act)[None, :]
            em = (em_all[offsets[qi]:offsets[qi + 1]] & act)[None]
            s, r = body(map_state(lambda x: x.unsqueeze(0),
                                  mstate.queries[qi]),
                        batch, em, windows[qi], watermark=watermark,
                        valid=valid)
            states.append(map_state(lambda x: x.squeeze(0), s))
            results.append(map_state(lambda x: x.squeeze(0), r))
        return mstate._replace(queries=tuple(states)), tuple(results)

    return tick


# --------------------------------------------------------------------- #
# Homogeneous padded slots: build_slot_tick
# --------------------------------------------------------------------- #
class SlotParams(NamedTuple):
    """Runtime per-slot query data (everything non-structural)."""

    esl: torch.Tensor     # int32 [S, n_qedges] query-edge src-vertex labels
    edl: torch.Tensor     # int32 [S, n_qedges] dst-vertex labels
    eel: torch.Tensor     # int32 [S, n_qedges] edge labels (-1 wildcard)
    window: torch.Tensor  # int32 [S] sliding-window span per slot
    active: torch.Tensor  # bool  [S]


class SlotState(NamedTuple):
    """State of one padded slot group: stacked engines + slot params."""

    engines: EngineState  # every leaf has a leading [S] slot axis
    params: SlotParams


PORT_TYPES.update({t.__name__: t for t in (SlotParams, SlotState)})


def stack_states(states: Sequence[EngineState]) -> EngineState:
    """Stack homogeneous EngineStates along a new leading slot axis."""
    return map_state(lambda *xs: torch.stack(xs), *states)


def init_slot_state(template_plan: ExecutionPlan, n_slots: int,
                    prefix_depth: int = 0, *, device=None) -> SlotState:
    """Empty slot group of ``n_slots`` unarmed slots on ``device``
    (``None``: the card); with ``prefix_depth``, subquery 0 keeps only
    its suffix levels."""
    device = resolve_device(device)
    nq = template_plan.query.n_edges
    return SlotState(
        engines=stack_states(
            [init_state(template_plan, prefix_depth,
                        device=device)] * n_slots),
        params=SlotParams(
            esl=torch.zeros((n_slots, nq), dtype=I32, device=device),
            edl=torch.zeros((n_slots, nq), dtype=I32, device=device),
            eel=torch.full((n_slots, nq), -1, dtype=I32, device=device),
            window=torch.full((n_slots,), template_plan.window, dtype=I32,
                              device=device),
            active=torch.zeros((n_slots,), dtype=torch.bool, device=device),
        ),
    )


def _reset_engine(sstate: SlotState, k: int, empty: EngineState) -> None:
    def put(full, e):
        full[k] = e

    map_state(put, sstate.engines, empty)


def write_slot(sstate: SlotState, template_plan: ExecutionPlan, k: int,
               plan: ExecutionPlan,
               empty: EngineState | None = None) -> SlotState:
    """Arm slot ``k`` with ``plan``'s labels/window and reset its tables,
    in place; returns ``sstate``.

    ``plan`` must share ``template_plan``'s structural signature — the
    service guarantees this by construction.  Pass a cached ``empty =
    init_state(template_plan, device=device)`` to avoid rebuilding the empty
    tables per churn event.
    """
    dev = sstate.params.active.device
    if empty is None:
        empty = init_state(template_plan, device=dev)
    _reset_engine(sstate, k, empty)
    p = sstate.params
    p.esl[k] = _labels(plan.edge_src_label, dev)
    p.edl[k] = _labels(plan.edge_dst_label, dev)
    p.eel[k] = _labels(plan.edge_edge_label, dev)
    p.window[k] = int(plan.window)
    p.active[k] = True
    return sstate


def clear_slot(sstate: SlotState, template_plan: ExecutionPlan, k: int,
               empty: EngineState | None = None) -> SlotState:
    """Disarm slot ``k`` (unregister): deactivate + drop its tables, in
    place; returns ``sstate``."""
    if empty is None:
        empty = init_state(template_plan,
                           device=sstate.params.active.device)
    _reset_engine(sstate, k, empty)
    sstate.params.active[k] = False
    return sstate


def read_slot(sstate: SlotState, k: int) -> EngineState:
    """Slot ``k``'s engine state (views into the group's tensors)."""
    return map_state(lambda x: x[k], sstate.engines)


def build_slot_tick(
    template_plan: ExecutionPlan,
    backend: str = J.JoinBackend.REF,
    extract_matches: bool = True,
    max_out: int | None = None,
    prefix_depth: int = 0,
):
    """Build a padded-slot tick for one structural template.

    Returns ``tick(sstate, batch, watermark=None) -> (sstate, results)``
    where ``results`` is a ``TickResult`` whose leaves carry a leading
    slot axis.  The label-match phase evaluates all slots' masks in one
    shot from the stacked ``[S, n_qedges]`` label tensors; unarmed slots
    see an all-invalid batch (no stats drift, frozen clock — the
    watermark clock keeps the freeze too, since an all-invalid batch's
    max ts is INT32_MIN).  ``watermark`` None keeps the max-ts clock, an
    int32 scalar switches every slot to event-time admission/expiry.

    With ``prefix_depth > 0`` (cross-tenant prefix sharing) the tick is
    ``tick(sstate, batch, prefix_view, watermark=None)``: every slot
    consumes the SAME shared prefix view — the reference broadcasts it
    through ``vmap``; here it goes to the body without a slot axis and
    the joins read it as a shared operand — and the slots run only the
    suffix joins.  Results and stats of unarmed slots are masked: the
    shared view is input even to slots that hold no tenant.
    """
    body = build_tick_body(template_plan, backend=backend,
                           extract_matches=extract_matches, max_out=max_out,
                           prefix_depth=prefix_depth)

    def run(sstate, batch, prefix_view, watermark):
        p = sstate.params
        valid = batch.valid[None, :] & p.active[:, None]
        em = edge_match_mask(batch, p.esl, p.edl, p.eel, valid=valid)
        engines, results = body(sstate.engines, batch, em, p.window,
                                watermark=watermark, valid=valid,
                                prefix_view=prefix_view)
        return engines, results

    if prefix_depth == 0:
        def tick(sstate: SlotState, batch: EdgeBatch, watermark=None):
            engines, results = run(sstate, batch, None, watermark)
            return sstate._replace(engines=engines), results

        return tick

    def tick(sstate: SlotState, batch: EdgeBatch, prefix_view,
             watermark=None):
        engines, r = run(sstate, batch, prefix_view, watermark)
        act = sstate.params.active
        engines = engines._replace(stats=map_state(
            lambda new, old: torch.where(act, new, old),
            engines.stats, sstate.engines.stats))
        zero = torch.zeros((), dtype=I32, device=act.device)
        r = r._replace(
            n_new_matches=torch.where(act, r.n_new_matches, zero),
            n_overflow=torch.where(act, r.n_overflow, zero),
            match_valid=r.match_valid & act[:, None])
        return sstate._replace(engines=engines), r

    return tick


# --------------------------------------------------------------------- #
# Built-tick cache: one build per structural signature
# --------------------------------------------------------------------- #
class SlotTickCache:
    """Process-wide cache of built slot ticks, keyed by structure.

    ``build_slot_tick`` closes over only structural plan data, so ONE
    built tick serves every slot group — in every service — whose
    template shares a signature.  ``n_builds`` counts cache misses.
    LRU-bounded (``max_entries``); eviction is safe because live groups
    hold their own reference to their tick.
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._ticks: dict[tuple, object] = {}   # insertion-ordered (LRU)
        self.n_builds = 0        # build_slot_tick invocations (cache misses)

    def __len__(self) -> int:
        return len(self._ticks)

    def ticks(self) -> list:
        """The cached tick callables, least recently used first."""
        return list(self._ticks.values())

    def clear(self) -> None:
        self._ticks.clear()

    def _get(self, key, builder):
        tick = self._ticks.pop(key, None)
        if tick is None:
            tick = builder()
            self.n_builds += 1
        self._ticks[key] = tick                 # (re)insert at LRU tail
        while len(self._ticks) > self.max_entries:
            self._ticks.pop(next(iter(self._ticks)))
        return tick

    def get(
        self,
        template_plan: ExecutionPlan,
        backend: str = J.JoinBackend.REF,
        extract_matches: bool = True,
        max_out: int | None = None,
        *,
        prefix_depth: int = 0,
    ):
        from repro_torch.core.registry import plan_signature

        key = (plan_signature(template_plan), backend, extract_matches,
               max_out, prefix_depth)
        return self._get(
            key,
            lambda: build_slot_tick(
                template_plan, backend=backend,
                extract_matches=extract_matches, max_out=max_out,
                prefix_depth=prefix_depth))

    def get_node(self, spec, backend: str = J.JoinBackend.REF):
        """Built prefix-node tick for one structural ``NodeSpec``
        (``repro_torch.core.share``).  Labels and window are runtime
        inputs, so one entry serves every node of that structure, and a
        restore re-arms a forest with cache hits."""
        from repro_torch.core.share import build_node_tick

        key = ("prefix_node", spec, backend)
        return self._get(key, lambda: build_node_tick(spec, backend=backend))


GLOBAL_SLOT_TICK_CACHE = SlotTickCache()
