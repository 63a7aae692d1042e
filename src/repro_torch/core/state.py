"""Device-side state: fixed-capacity partial-match tables, as torch tensors.

The port of ``repro.core.state``.  The tables keep the reference's
NamedTuple layout and leaf names, so a state moves between the two
packages leaf by leaf (``state_from_numpy`` / ``state_to_numpy``):

* ``LevelTable`` — MS-tree storage for one expansion-list item
  ``L_i^j`` (paper Section 4): the matched edge (src, dst, ts) plus a
  parent pointer into ``L_i^{j-1}``;
* ``L0Table`` — denormalized rows of a global expansion-list item.

Integer leaves are int32 (their arithmetic wraps exactly as the
reference's does), ``valid``/``fresh`` are bool.  ``init_state`` builds
one engine's unbatched tables; a slot group (``repro_torch.core.multi``)
holds the same leaves with a leading ``[S]`` slot axis, which is also
the form the tick body works on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan

I32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller
    asks for the CPU, and there is no silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


class LevelTable(NamedTuple):
    """MS-tree node storage for one expansion-list item ``L_i^j``."""

    src: torch.Tensor      # int32 [C]  data vertex matched to the level edge's src
    dst: torch.Tensor      # int32 [C]
    ts: torch.Tensor       # int32 [C]  timestamp of the matched data edge
    parent: torch.Tensor   # int32 [C]  row in L_i^{j-1}; -1 at level 1
    valid: torch.Tensor    # bool  [C]
    fresh: torch.Tensor    # bool  [C]  appended during the current tick


class L0Table(NamedTuple):
    """Denormalized row storage for a global expansion-list item ``L_0^i``."""

    bindings: torch.Tensor  # int32 [C, nv]
    ets: torch.Tensor       # int32 [C, ne]  per-query-edge timestamps
    valid: torch.Tensor     # bool  [C]
    fresh: torch.Tensor     # bool  [C]


class EngineStats(NamedTuple):
    n_matches_total: torch.Tensor    # int32 scalar
    n_overflow: torch.Tensor         # int32 scalar: dropped appends (capacity)
    n_edges_processed: torch.Tensor  # int32 scalar
    n_edges_discarded: torch.Tensor  # int32 scalar: matched no query edge
    n_edges_rejected: torch.Tensor   # int32 scalar: at-or-below the released
    #                                  event-time floor (watermark mode only)


class EngineState(NamedTuple):
    levels: tuple          # tuple[tuple[LevelTable, ...], ...]  per subquery
    l0: tuple              # tuple[L0Table, ...]  for join sites 2..k
    t_now: torch.Tensor    # int32 scalar, current stream time
    stats: EngineStats


def _empty_level(capacity: int, device) -> LevelTable:
    c = capacity
    return LevelTable(
        src=torch.zeros((c,), dtype=I32, device=device),
        dst=torch.zeros((c,), dtype=I32, device=device),
        ts=torch.zeros((c,), dtype=I32, device=device),
        parent=torch.full((c,), -1, dtype=I32, device=device),
        valid=torch.zeros((c,), dtype=torch.bool, device=device),
        fresh=torch.zeros((c,), dtype=torch.bool, device=device),
    )


def _empty_l0(capacity: int, nv: int, ne: int, device) -> L0Table:
    return L0Table(
        bindings=torch.zeros((capacity, nv), dtype=I32, device=device),
        ets=torch.zeros((capacity, ne), dtype=I32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        fresh=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def init_state(plan: ExecutionPlan, prefix_depth: int = 0,
               watermark: int | None = None, *,
               device=None) -> EngineState:
    """Empty tables for ``plan`` on ``device`` (``None``: the card).

    With ``prefix_depth > 0`` (cross-tenant prefix sharing,
    ``repro_torch.core.share``), subquery 0's first that-many levels live
    in a shared prefix table owned by the forest, so the per-tenant state
    holds only the suffix levels (the reference's layout, leaf for leaf).

    ``watermark`` seeds the engine clock ``t_now``: a tenant registered
    mid-stream under event-time serving starts at the already-released
    floor instead of 0.
    """
    device = resolve_device(device)
    levels = tuple(
        tuple(_empty_level(lv.capacity, device)
              for lv in s.levels[(prefix_depth if si == 0 else 0):])
        for si, s in enumerate(plan.subqueries)
    )
    l0 = tuple(
        _empty_l0(js.capacity, len(js.vertex_layout), len(js.edge_layout),
                  device)
        for js in plan.l0_joins
    )

    def zero():
        return torch.zeros((), dtype=I32, device=device)

    t0 = zero() if watermark is None \
        else torch.tensor(watermark, dtype=I32, device=device)
    return EngineState(
        levels=levels,
        l0=l0,
        t_now=t0,
        stats=EngineStats(zero(), zero(), zero(), zero(), zero()),
    )


class EdgeBatch(NamedTuple):
    """A tick's worth of stream edges (padded; ``valid`` marks real rows).

    Timestamps must be non-decreasing across consecutive ticks; within a
    tick they may interleave arbitrarily.
    """

    src: torch.Tensor        # int32 [B] data vertex id
    dst: torch.Tensor        # int32 [B]
    ts: torch.Tensor         # int32 [B]
    src_label: torch.Tensor  # int32 [B]
    dst_label: torch.Tensor  # int32 [B]
    edge_label: torch.Tensor  # int32 [B]
    valid: torch.Tensor      # bool  [B]


def make_batch(src, dst, ts, src_label, dst_label, edge_label, valid=None,
               *, device=None) -> EdgeBatch:
    """An ``EdgeBatch`` on ``device`` (``None``: the card) from arrays."""
    device = resolve_device(device)

    def a(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    src = a(src)
    if valid is None:
        valid = np.ones(src.shape, bool)
    return EdgeBatch(
        src, a(dst), a(ts), a(src_label), a(dst_label), a(edge_label),
        torch.as_tensor(np.asarray(valid, bool), device=device),
    )


# --------------------------------------------------------------------- #
# Leaf-for-leaf exchange with the reference package (numpy in between).
# --------------------------------------------------------------------- #
# NamedTuple types by name, so a reference tree maps onto the port's own
# classes (``repro_torch.core.multi`` adds SlotState / SlotParams).
PORT_TYPES: dict[str, type] = {
    t.__name__: t
    for t in (LevelTable, L0Table, EngineStats, EngineState, EdgeBatch)
}


def state_from_numpy(tree, device=None):
    """Map a state whose leaves are numpy arrays (a reference
    ``EngineState``/``SlotState`` passed through ``np.asarray``) to the
    port's tensors and NamedTuple classes.  Integer leaves become int32,
    bool leaves stay bool."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, tuple):
            items = [conv(v) for v in x]
            if not hasattr(x, "_fields"):
                return tuple(items)
            return PORT_TYPES[type(x).__name__](*items)
        arr = np.array(x, dtype=None if np.asarray(x).dtype == np.bool_
                       else np.int32)      # an owned, writable copy
        return torch.as_tensor(arr, device=device)

    return conv(tree)


def state_to_numpy(tree):
    """Inverse of ``state_from_numpy``: every tensor leaf to numpy."""
    if isinstance(tree, tuple):
        items = [state_to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree.detach().cpu().numpy()


def map_state(fn, *trees):
    """Apply ``fn`` leaf-wise over parallel state trees (NamedTuples and
    tuples of tensors)."""
    first = trees[0]
    if isinstance(first, tuple):
        items = [map_state(fn, *parts) for parts in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") \
            else tuple(items)
    return fn(*trees)
