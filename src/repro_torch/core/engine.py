"""The streaming match engine: the tick, over a slot axis.

The port of ``repro.core.engine``.  One tick ingests a batch of stream
edges and advances every expansion list, with semantics exactly equal to
processing the edges one by one in timestamp order (streaming
consistency, Definition 13): level-ordered batched inserts within each
TC-subquery, delta joins ``ΔA⋈B ∪ A_old⋈ΔB`` into the global lists, emit,
then end-of-tick expiry (see the reference module for the derivation).

The body is written over an explicit leading slot axis from the start:
every table leaf is ``[S, C, ...]``, every scalar ``[S]``.  The reference
gets its slot groups from ``jax.vmap``; here a slot group of S tenants
and a single query (S = 1, ``build_tick``) run the same code, and every
join of a tick is ONE ``join_pairs`` call over all S slots.  The stream
batch is shared by the slots; each slot has its own validity (an unarmed
slot sees an all-invalid batch).

Static-size idioms of the reference and their torch form:
  * ``.at[s].set(..., mode="drop")`` -> ``_scatter_rows``: the table gets
    one dump row at index C, refused writes go there, and the dump row
    is cut off again (a -1 index would wrap and an index of C would
    raise in torch — the hazards ``_safe_slots`` guards in the
    reference);
  * ``jnp.take(..., mode="clip")`` -> a clamp, then an int64 gather;
  * ``jnp.nonzero(size=, fill_value=-1)`` -> ``join.first_true``;
  * the int32 clock algebra (``t_now - window``, ``NO_WATERMARK``) stays
    in int32 and wraps as the reference does.
Nothing in the tick reads a value back to the host.

Shared prefixes (``prefix_depth > 0``, ``repro_torch.core.share``): the
prefix table's per-tick view is ONE table for every slot, passed without
a slot axis; the joins take it as a shared operand (slot stride 0 in the
CUDA kernel) and the gathers index it directly, so it is never copied
per slot.

Left out (the mesh slice; it raises ``NotImplementedError``): capacity
sharding (``axis_name``/``n_shards``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import join as J
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.state import (
    EdgeBatch,
    EngineState,
    EngineStats,
    L0Table,
    LevelTable,
    map_state,
    resolve_device,
)

I32 = torch.int32

# "Watermark unknown" sentinel for event-time ticks: composes as the
# identity through ``max(t_now, min(watermark, max_batch_ts))``.
NO_WATERMARK = int(np.iinfo(np.int32).min)


class TickResult(NamedTuple):
    n_new_matches: torch.Tensor   # int32 [S] (scalar from build_tick)
    n_overflow: torch.Tensor      # int32 [S] (this tick)
    match_bindings: torch.Tensor  # int32 [S, max_out, nv_total]
    match_ets: torch.Tensor       # int32 [S, max_out, ne_total]
    match_valid: torch.Tensor     # bool  [S, max_out]


class _View(NamedTuple):
    """Denormalized view of a table: what joins consume.  ``shared``: one
    table for every slot (the shared prefix view), its leaves without the
    slot axis."""

    bind: torch.Tensor   # int32 [S, C, nv]  (shared: [C, nv])
    ets: torch.Tensor    # int32 [S, C, ne]  (shared: [C, ne])
    valid: torch.Tensor  # bool [S, C]       (shared: [C])
    fresh: torch.Tensor  # bool [S, C]       (shared: [C])
    shared: bool = False


def _rows(x: torch.Tensor, idx: torch.Tensor,
          shared: bool = False) -> torch.Tensor:
    """Per slot, gather rows ``idx`` (int64 [S, M], clamped into range
    like ``take(mode="clip")``) of ``x`` [S, C, ...] -> [S, M, ...].  A
    ``shared`` ``x`` [C, ...] is one table for every slot."""
    if shared:
        return x[idx.clamp(0, max(x.shape[0] - 1, 0))]
    idx = idx.clamp(0, max(x.shape[1] - 1, 0))
    ar = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[ar, idx]


def _scatter_rows(dst: torch.Tensor, slots: torch.Tensor, ok: torch.Tensor,
                  vals) -> torch.Tensor:
    """``dst.at[slots].set(vals, mode="drop")`` per slot: rows of ``dst``
    [S, C, ...] at ``slots`` [S, R] where ``ok``; refused writes land on a
    dump row at index C that is cut off again."""
    s, c = dst.shape[:2]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    idx = torch.where(ok, slots, torch.full_like(slots, c))
    ar = torch.arange(s, device=dst.device)[:, None]
    if torch.is_tensor(vals):
        vals = vals.to(dst.dtype)
    else:           # a constant: filled on the device, never copied over
        vals = torch.full((), vals, dtype=dst.dtype, device=dst.device)
    ext[ar, idx] = vals.expand(idx.shape + dst.shape[2:])
    return ext[:, :c]


def _append_level(table: LevelTable, parent_idx, src, dst, ts, req_valid):
    """Scatter new MS-tree nodes into free slots; returns (table, n_drop)."""
    slots, ok, n_drop = J.alloc_slots(table.valid, req_valid,
                                      req_valid.shape[1])

    def put(t, v):
        return _scatter_rows(t, slots, ok, v)

    return (
        LevelTable(
            src=put(table.src, src),
            dst=put(table.dst, dst),
            ts=put(table.ts, ts),
            parent=put(table.parent, parent_idx),
            valid=put(table.valid, True),
            fresh=put(table.fresh, True),
        ),
        n_drop,
    )


def _append_l0(table: L0Table, bindings, ets, req_valid):
    slots, ok, n_drop = J.alloc_slots(table.valid, req_valid,
                                      req_valid.shape[1])

    def put(t, v):
        return _scatter_rows(t, slots, ok, v)

    return (
        L0Table(
            bindings=put(table.bindings, bindings),
            ets=put(table.ets, ets),
            valid=put(table.valid, True),
            fresh=put(table.fresh, True),
        ),
        n_drop,
    )


def _compact(view: _View, mask, size: int):
    """Gather up to ``size`` rows of ``view`` where ``mask`` [S, C], per
    slot; returns a _View of static size plus the overflow count [S].  A
    shared view (mask [C]) compacts once, into a shared view (count
    [1])."""
    if view.shared:
        out, safe, n_drop = _compact(
            _View(view.bind[None], view.ets[None], view.valid[None],
                  view.fresh[None]), mask[None], size)
        return (_View(out.bind[0], out.ets[0], out.valid[0], out.fresh[0],
                      shared=True), safe[0], n_drop)
    idx = J.first_true(mask, size)
    ok = idx >= 0
    safe = idx.clamp(min=0)
    n_drop = (mask.sum(dim=1, dtype=I32) - size).clamp(min=0)
    return (
        _View(bind=_rows(view.bind, safe), ets=_rows(view.ets, safe),
              valid=ok, fresh=ok),
        safe,
        n_drop,
    )


def edge_match_mask(batch: EdgeBatch, esl, edl, eel, *,
                    valid=None) -> torch.Tensor:
    """Per-query-edge label match mask ``[..., n_qedges, B]``.

    ``esl`` / ``edl`` / ``eel`` are the per-edge src-vertex, dst-vertex
    and edge labels (``eel < 0`` = wildcard), ``[n_qedges]`` for one
    query or ``[S, n_qedges]`` for a slot group; ``valid`` (default
    ``batch.valid``) is the batch validity, ``[B]`` or ``[S, B]``.
    """
    valid = batch.valid if valid is None else valid
    no_selfloop = batch.src != batch.dst
    esl, edl, eel = esl[..., :, None], edl[..., :, None], eel[..., :, None]
    return (
        valid[..., None, :]
        & no_selfloop
        & (batch.src_label == esl)
        & (batch.dst_label == edl)
        & ((eel < 0) | (batch.edge_label == eel))
    )


def build_tick_body(
    plan: ExecutionPlan,
    backend: str = J.JoinBackend.REF,
    extract_matches: bool = True,
    max_out: int | None = None,
    axis_name: str | None = None,
    n_shards: int = 1,
    prefix_depth: int = 0,
):
    """Compile the *structural* part of ``plan`` into a tick body.

    Returns ``body(state, batch, ematch, window, watermark=None,
    valid=None, prefix_view=None) -> (state, TickResult)`` over S slots:
    ``state`` leaves carry a leading ``[S]`` axis, ``batch`` is the shared
    stream batch ``[B]``, ``ematch`` the ``[S, n_qedges, B]`` label-match
    mask (see ``edge_match_mask``), ``window`` int32 ``[S]``, ``valid``
    the per-slot batch validity ``[S, B]`` (default: ``batch.valid`` for
    every slot) and ``watermark`` None (processing-time clock) or an
    int32 scalar (event-time clock).  Everything the body closes over —
    layouts, REL/TREL, capacities — depends only on the query's
    structure.

    With ``prefix_depth > 0`` the first ``prefix_depth`` levels of
    subquery 0 live in a shared prefix table advanced by the forest
    (``repro_torch.core.share``): ``state`` holds only subquery 0's
    suffix levels (``init_state(plan, prefix_depth=...)``) and
    ``prefix_view`` is the table's post-append ``NodeView`` for this tick
    (bind/ets/valid/fresh/valid_after, no slot axis).  It seeds subquery
    0's reconstruction chain exactly where the local level
    ``prefix_depth - 1`` view would have, and end-of-tick expiry
    cascades from its ``valid_after``.
    """
    if axis_name is not None or n_shards != 1:
        raise NotImplementedError(
            "capacity sharding (axis_name / n_shards) is the mesh slice "
            "of the port")
    if prefix_depth:
        if not (0 < prefix_depth <= len(plan.subqueries[0].levels)):
            raise ValueError(
                f"prefix_depth {prefix_depth} out of range for subquery 0 "
                f"({len(plan.subqueries[0].levels)} levels)")
    max_out = max_out or max(js.max_new for js in plan.l0_joins) \
        if plan.l0_joins \
        else (max_out or plan.subqueries[0].levels[-1].max_new)

    # per-(subquery, level>=1) REL for the edge join
    level_rel: dict[tuple[int, int], np.ndarray] = {}
    for si, s in enumerate(plan.subqueries):
        for li in range(1, len(s.levels)):
            lv = s.levels[li]
            nv_prev = len(s.levels[li - 1].vertex_layout)
            rel = np.zeros((nv_prev, 2), dtype=bool)
            if lv.src_slot >= 0:
                rel[lv.src_slot, 0] = True
            if lv.dst_slot >= 0:
                rel[lv.dst_slot, 1] = True
            level_rel[(si, li)] = rel

    def _trel_chain(nea: int) -> np.ndarray:
        """Chain timing spec: only A's last edge must precede the new edge —
        the ≺-chain of a TC timing sequence makes the rest transitive."""
        t = np.zeros((nea, 1), dtype=np.int8)
        t[nea - 1, 0] = -1
        return t

    nv_final = len(plan.final_vertex_layout)
    ne_final = len(plan.final_edge_layout)

    def _expire(levels, l0, lo, prefix_valid_after=None):
        """End-of-tick deletion (paper §4.2): level-ordered top-down
        cascade over MS-tree parent pointers; L0 rows checked directly
        on their per-edge timestamps.  ``lo`` is int32 [S].  With a
        shared prefix, subquery 0's first kept level cascades from the
        prefix table's post-expiry validity (shared, [C])."""
        new_levels = []
        for si, sub in enumerate(levels):
            out = []
            prev_valid = prefix_valid_after if si == 0 else None
            prev_shared = prev_valid is not None
            for t in sub:
                v = t.valid & (t.ts > lo[:, None])
                if prev_valid is not None:
                    v = v & _rows(prev_valid, t.parent.clamp(min=0).long(),
                                  prev_shared)
                out.append(t._replace(valid=v))
                prev_valid, prev_shared = v, False
            new_levels.append(tuple(out))
        new_l0 = tuple(
            t._replace(valid=t.valid & (t.ets > lo[:, None, None]).all(dim=2))
            for t in l0
        )
        return tuple(new_levels), new_l0

    def body(state: EngineState, batch: EdgeBatch, ematch, window,
             watermark=None, valid=None, prefix_view=None):
        # -- 0. advance time; clear last tick's fresh marks ------------ #
        # Expiry is deferred to the END of the tick; mid-tick, the window
        # predicate inside every join plays the role of the paper's
        # two-phase partial removal (§5.3).  ``watermark`` None is the
        # processing-time clock; an int32 scalar rejects-and-counts edges
        # at or below the released floor and bounds the clock by it.
        dev = state.t_now.device
        n_slots = state.t_now.shape[0]
        window = torch.as_tensor(window, dtype=I32, device=dev) \
            .reshape(-1).expand(n_slots)
        bvalid = batch.valid.expand(n_slots, -1) if valid is None else valid
        rejected = torch.zeros((n_slots,), dtype=I32, device=dev)
        if watermark is not None:
            wm = torch.as_tensor(watermark, dtype=I32, device=dev)
            late = bvalid & (batch.ts[None, :]
                             <= (state.t_now - window)[:, None])
            rejected = late.sum(dim=1, dtype=I32)
            bvalid = bvalid & ~late
            ematch = ematch & bvalid[:, None, :]
        bt = torch.where(bvalid, batch.ts[None, :],
                         torch.full_like(bvalid, NO_WATERMARK, dtype=I32))
        bt_max = bt.amax(dim=1)
        if watermark is None:
            t_now = torch.maximum(state.t_now, bt_max)
        else:
            t_now = torch.maximum(state.t_now, torch.minimum(wm, bt_max))
        levels = tuple(
            tuple(t._replace(fresh=torch.zeros_like(t.fresh)) for t in sub)
            for sub in state.levels
        )
        l0 = tuple(t._replace(fresh=torch.zeros_like(t.fresh))
                   for t in state.l0)

        n_overflow = torch.zeros((n_slots,), dtype=I32, device=dev)

        # -- 1. per-query-edge label match mask [S, n_qedges, B] ------- #
        edge_used = ematch.any(dim=1)
        n_discard = (bvalid & ~edge_used).sum(dim=1, dtype=I32)

        bbind = torch.stack([batch.src, batch.dst], dim=1)  # [B, 2] shared
        bets = batch.ts[:, None]                            # [B, 1] shared
        n_b = batch.src.shape[0]

        # -- 2. subquery phase: level-ordered batched inserts ---------- #
        recons: list[list[_View]] = []
        new_levels = []
        for si, s in enumerate(plan.subqueries):
            sub = list(levels[si])
            sub_recons: list[_View] = []
            start = prefix_depth if si == 0 else 0
            if start:
                # the shared prefix table's post-append view seeds the
                # chain where the local level start-1 view would have
                sub_recons.append(_View(prefix_view.bind, prefix_view.ets,
                                        prefix_view.valid,
                                        prefix_view.fresh, shared=True))
            for li in range(start, len(s.levels)):
                lv = s.levels[li]
                ti = li - start          # index into the (suffix) tables
                em = ematch[:, lv.qedge]                    # [S, B]
                if li == 0:
                    t, nd = _append_level(
                        sub[0], torch.full_like(em, -1, dtype=I32),
                        batch.src, batch.dst, batch.ts, em)
                    sub[0] = t
                    n_overflow += nd
                else:
                    prev = sub_recons[-1]
                    a_idx, b_idx, pv, nd1 = J.join_pairs(
                        prev.bind, prev.ets, prev.valid,
                        bbind, bets, em,
                        level_rel[(si, li)], _trel_chain(prev.ets.shape[-1]),
                        lv.max_new, window, backend)
                    n_overflow += nd1
                    b_idx = b_idx.clamp(0, n_b - 1)
                    t, nd2 = _append_level(
                        sub[ti], a_idx, batch.src[b_idx], batch.dst[b_idx],
                        batch.ts[b_idx], pv)
                    sub[ti] = t
                    n_overflow += nd2
                # reconstruct this level's denormalized view (post-append)
                t = sub[ti]
                if li == 0:
                    bind = torch.stack([t.src, t.dst], dim=2)
                    ets = t.ts[:, :, None]
                else:
                    p = t.parent.clamp(min=0).long()
                    prevv = sub_recons[-1]
                    cols = [_rows(prevv.bind, p, prevv.shared)]
                    if lv.src_slot < 0:
                        cols.append(t.src[:, :, None])
                    if lv.dst_slot < 0:
                        cols.append(t.dst[:, :, None])
                    bind = torch.cat(cols, dim=2)
                    ets = torch.cat([_rows(prevv.ets, p, prevv.shared),
                                     t.ts[:, :, None]], dim=2)
                sub_recons.append(_View(bind, ets, t.valid, t.fresh))
            recons.append(sub_recons)
            new_levels.append(tuple(sub))
        levels = tuple(new_levels)

        # -- 3. L_0 phase: delta joins across TC-subqueries ------------ #
        new_l0 = []
        a_view = recons[0][-1]  # L_0^1 ≡ P_1's final item (paper Fig. 8)
        for gi, js in enumerate(plan.l0_joins):
            b_view = recons[gi + 1][-1]
            tbl = l0[gi]
            d = js.max_new
            new_b = list(js.b_new_vertex_slots)

            # J1: ΔA ⋈ B (old ∪ Δ)
            da, _, nd0 = _compact(a_view, a_view.fresh & a_view.valid, d)
            n_overflow += nd0
            a1, b1, pv1, nd1 = J.join_pairs(
                da.bind, da.ets, da.valid,
                b_view.bind, b_view.ets, b_view.valid,
                js.rel, js.trel, d, window, backend)
            nb = _rows(b_view.bind, b1)
            out_bind1 = torch.cat(
                [_rows(da.bind, a1, da.shared)]
                + ([nb[:, :, new_b]] if new_b else []),
                dim=2)
            out_ets1 = torch.cat(
                [_rows(da.ets, a1, da.shared), _rows(b_view.ets, b1)], dim=2)
            tbl, nd2 = _append_l0(tbl, out_bind1, out_ets1, pv1)

            # J2: A_old ⋈ ΔB
            db, _, nd3 = _compact(b_view, b_view.fresh & b_view.valid, d)
            a2, b2, pv2, nd4 = J.join_pairs(
                a_view.bind, a_view.ets, a_view.valid & ~a_view.fresh,
                db.bind, db.ets, db.valid,
                js.rel, js.trel, d, window, backend)
            n_overflow += nd4
            nb2 = _rows(db.bind, b2)
            out_bind2 = torch.cat(
                [_rows(a_view.bind, a2, a_view.shared)]
                + ([nb2[:, :, new_b]] if new_b else []),
                dim=2)
            out_ets2 = torch.cat(
                [_rows(a_view.ets, a2, a_view.shared), _rows(db.ets, b2)],
                dim=2)
            tbl, nd5 = _append_l0(tbl, out_bind2, out_ets2, pv2)

            n_overflow += nd1 + nd2 + nd3 + nd5
            new_l0.append(tbl)
            a_view = _View(tbl.bindings, tbl.ets, tbl.valid, tbl.fresh)
        l0 = tuple(new_l0)

        # -- 4. emit (before end-of-tick expiry: a match created mid-tick
        #       is reported even if it expires within the same tick) --- #
        final = a_view
        new_mask = final.fresh & final.valid
        n_new = new_mask.sum(dim=-1, dtype=I32).expand(n_slots)
        if extract_matches:
            out, _, nd = _compact(final, new_mask, max_out)
            mb, me, mv = out.bind, out.ets, out.valid
            if out.shared:
                # a fully shared subquery 0 without L0 joins: every slot
                # reports the shared table's new rows (the slot tick masks
                # the unarmed ones)
                mb, me, mv = (x.expand(n_slots, *x.shape).contiguous()
                              for x in (mb, me, mv))
            n_overflow += nd
        else:
            mb = torch.zeros((n_slots, max_out, nv_final), dtype=I32,
                             device=dev)
            me = torch.zeros((n_slots, max_out, ne_final), dtype=I32,
                             device=dev)
            mv = torch.zeros((n_slots, max_out), dtype=torch.bool,
                             device=dev)

        # -- 5. end-of-tick expiry ------------------------------------- #
        levels, l0 = _expire(
            levels, l0, t_now - window,
            prefix_view.valid_after if prefix_depth else None)

        stats = EngineStats(
            n_matches_total=state.stats.n_matches_total + n_new,
            n_overflow=state.stats.n_overflow + n_overflow,
            n_edges_processed=state.stats.n_edges_processed
            + bvalid.sum(dim=1, dtype=I32),
            n_edges_discarded=state.stats.n_edges_discarded + n_discard,
            n_edges_rejected=state.stats.n_edges_rejected + rejected,
        )
        new_state = EngineState(levels=levels, l0=l0, t_now=t_now,
                                stats=stats)
        return new_state, TickResult(n_new, n_overflow, mb, me, mv)

    return body


def build_tick(
    plan: ExecutionPlan,
    backend: str | None = None,
    extract_matches: bool = True,
    max_out: int | None = None,
    axis_name: str | None = None,
    n_shards: int = 1,
    prefix_depth: int = 0,
    *,
    device=None,
):
    """Compile ``plan`` into ``tick(state, batch, watermark=None) ->
    (state, res)`` for one query (the body at S = 1); with
    ``prefix_depth > 0``, ``tick(state, batch, prefix_view,
    watermark=None)``.

    ``device`` None means the card.  ``backend`` None picks the device's
    default (``JoinBackend.CUDA`` on a CUDA device, ``REF`` on the CPU);
    ``JoinBackend.CUDA`` on a CPU device raises.  ``extract_matches=False``
    skips materializing result bindings (throughput mode).
    """
    device = resolve_device(device)
    backend = J.resolve_backend(backend, device)
    body = build_tick_body(
        plan,
        backend=backend,
        extract_matches=extract_matches,
        max_out=max_out,
        axis_name=axis_name,
        n_shards=n_shards,
        prefix_depth=prefix_depth,
    )

    def lab(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    esl, edl, eel = (lab(plan.edge_src_label), lab(plan.edge_dst_label),
                     lab(plan.edge_edge_label))
    window = torch.tensor([plan.window], dtype=I32, device=device)

    def run(state, batch, prefix_view, watermark):
        stacked = map_state(lambda x: x.unsqueeze(0), state)
        em = edge_match_mask(batch, esl, edl, eel).unsqueeze(0)
        new, res = body(stacked, batch, em, window, watermark=watermark,
                        prefix_view=prefix_view)
        return (map_state(lambda x: x.squeeze(0), new),
                map_state(lambda x: x.squeeze(0), res))

    if prefix_depth:
        def tick(state: EngineState, batch: EdgeBatch, prefix_view,
                 watermark=None):
            return run(state, batch, prefix_view, watermark)
    else:
        def tick(state: EngineState, batch: EdgeBatch, watermark=None):
            return run(state, batch, None, watermark)

    return tick


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def fold_level_host(acc, table, src_slot: int, dst_slot: int):
    """One step of the host-side MS-tree denormalization: fold a level
    table's (src, dst, ts, parent) onto its parent level's accumulated
    ``(bind, ets)`` (``acc=None`` for a root level).  Own columns are
    appended only for NEGATIVE slots, src before dst."""
    src = _host(table.src)[:, None]
    dst = _host(table.dst)[:, None]
    ts = _host(table.ts)[:, None]
    if acc is None:
        return np.concatenate([src, dst], axis=1), ts
    bind, ets = acc
    p = np.maximum(_host(table.parent), 0)
    own = []
    if src_slot < 0:
        own.append(src)
    if dst_slot < 0:
        own.append(dst)
    return (np.concatenate([bind[p]] + own, axis=1),
            np.concatenate([ets[p], ts], axis=1))


def current_matches(plan: ExecutionPlan, state: EngineState):
    """All complete matches in the current window of one (unstacked)
    engine state (host-side; for tests and ``matches()``).

    Returns a set of frozensets of ``(query_edge_id, (src, dst, ts))``.
    """
    if plan.l0_joins:
        tbl = state.l0[-1]
        bind = _host(tbl.bindings)
        ets = _host(tbl.ets)
        valid = _host(tbl.valid)
    else:
        s = plan.subqueries[0]
        sub = state.levels[0]
        acc = None
        for li, lv in enumerate(s.levels):
            acc = fold_level_host(acc, sub[li], lv.src_slot, lv.dst_slot)
        bind, ets = acc
        valid = _host(sub[-1].valid)

    return matches_from_rows(plan, bind, ets, valid)


def matches_from_rows(plan: ExecutionPlan, bind, ets, valid):
    """Convert final-layout match rows to the canonical frozenset form
    shared with the oracle."""
    q = plan.query
    vlayout = plan.final_vertex_layout
    elayout = plan.final_edge_layout
    out = set()
    for r in np.nonzero(valid)[0]:
        v_of = {vl: int(bind[r, i]) for i, vl in enumerate(vlayout)}
        t_of = {el: int(ets[r, i]) for i, el in enumerate(elayout)}
        match = frozenset(
            (e, (v_of[q.edges[e][0]], v_of[q.edges[e][1]], t_of[e]))
            for e in range(q.n_edges)
        )
        out.add(match)
    return out
