"""Capacity-sharded execution of the streaming engine over a mesh.

The port of ``repro.core.distributed``.  Every partial-match table's
capacity axis is split over the mesh's engine axes; the edge batch and a
shared-prefix ``NodeView`` are replicated.  The per-tick collectives of
the reference — the tiled all-gathers of the L0 joins' compacted deltas
and the psums of the scalar stats — are tensor operations over the shard
axis inside the tick body (``repro_torch.core.engine``).  Everything
else (label matching, level joins, MS-tree reconstruction, expiry) is
shard-local by construction: level-0 appends are dealt round robin and a
row lands on its parent's shard, so ``parent`` pointers are shard-local
indices.

One controller: the mesh is an array of torch devices with named axes,
and every entry is the same device — n logical shards on one card, or on
the CPU in the tests (the counterpart of the reference's forced host
device count).  The state keeps the reference's global shapes: every
table leaf is ``[C, ...]`` on the mesh's device, shard k's rows at
``[k*C/n, (k+1)*C/n)``, and every scalar is ``[]`` — what
``jax.device_get`` of the reference's sharded state gives.  The tick
views each leaf as ``[n, C/n, ...]`` and runs the tick body once over
the shard axis, so n shards cost one body's host dispatch, not n.  A
mesh of distinct devices raises ``NotImplementedError``: nothing here
has run on more than one card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.engine import build_tick, current_matches
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.state import (
    EngineState,
    init_state,
    map_state,
    resolve_device,
)

_DISTINCT = ("a mesh of distinct devices is not supported yet: every entry "
             "must be the same device (n logical shards on one card); "
             "distinct cards are ROADMAP Queue A item 4c")


class PartitionSpec:
    """How a leaf's axes map onto mesh axes, as ``jax.sharding.
    PartitionSpec``: one entry per leading axis of the leaf, each None
    (replicated), a mesh axis name, or a tuple of names (split over their
    product).  ``P()`` replicates the whole leaf.  Not a tuple, so that a
    tree of specs walks like the tree it describes."""

    def __init__(self, *parts):
        self.parts = tuple(
            None if p is None else ((p,) if isinstance(p, str)
                                    else tuple(p))
            for p in parts)

    def shards(self, mesh, dim: int = 0) -> int:
        """The number of blocks axis ``dim`` is split into on ``mesh``."""
        if dim >= len(self.parts) or self.parts[dim] is None:
            return 1
        return math.prod(mesh.shape[a] for a in self.parts[dim])

    def __repr__(self):
        return f"P{self.parts!r}"


P = PartitionSpec


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class Mesh:
    """An array of torch devices with named axes: ``devices`` (numpy
    object array of ``torch.device``), ``axis_names``, ``shape`` (axis
    name -> size, in axis order, as ``jax.sharding.Mesh.shape``) and
    ``device`` (the one device every entry names)."""

    def __init__(self, devices, axis_names):
        devs = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"a {devs.ndim}-d device array for axes {names}")
        flat = [torch.device(d) for d in devs.reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if any(not _same_device(d, flat[0]) for d in flat):
            raise NotImplementedError(_DISTINCT)
        self.devices = np.empty(devs.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = names
        self.shape = dict(zip(names, devs.shape))
        self.device = flat[0]


def make_mesh(shape, axis_names, *, devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axis_names``.  ``devices`` lists
    exactly ``prod(shape)`` entries (a device may repeat: n logical
    shards on one device); None means the card, repeated."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if devices is None:
        devices = (resolve_device(None),) * size
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f"mesh shape {shape} needs {size} devices, got "
                         f"{len(devices)}")
    arr = np.empty(size, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _state_specs(state: EngineState, axes) -> EngineState:
    """PartitionSpec tree: shard every capacity axis, replicate scalars."""
    shard = P(_axes(axes))
    return map_state(lambda x: shard if x.ndim >= 1 else P(), state)


def build_sharded_tick(
    plan: ExecutionPlan,
    mesh: Mesh,
    axes=("data",),
    backend: str | None = None,
    extract_matches: bool = False,
    prefix_depth: int = 0,
):
    """Returns ``(tick, state)``: ``tick(state, batch[, prefix_view],
    watermark=None) -> (state, TickResult)`` capacity-sharded over the
    product of ``mesh``'s ``axes`` (e.g. ``("pod", "data")``), and
    ``state`` the empty tables on the mesh's device.

    ``state`` and the result keep the reference's global shapes (see
    ``repro_torch.core.engine.build_tick``).  ``backend`` None is the
    device's default: the CUDA pair kernel on a card (over the shard
    axis, S = n), REF on the CPU.  With ``prefix_depth > 0`` the tick
    takes a shared-prefix ``NodeView`` (``repro_torch.core.share``) as a
    third argument, replicated to every shard; the forest node advances
    once, outside the tick.
    """
    axes = _axes(axes)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    tick = build_tick(
        plan,
        backend=backend,
        extract_matches=extract_matches,
        axis_name=axes if len(axes) > 1 else axes[0],
        n_shards=n_shards,
        prefix_depth=prefix_depth,
        device=mesh.device,
    )
    return tick, init_state(plan, prefix_depth, device=mesh.device)


def _sharded_current_matches(plan: ExecutionPlan, state: EngineState,
                             n_shards: int):
    """``current_matches`` of a capacity-sharded state: each shard's
    ``C/n`` block is folded on its own, since its ``parent`` pointers
    are shard-local (reading them through the concatenated arrays
    misreads every shard after the first).  L0 rows are denormalized, so
    their blocks fold the same either way."""
    out = set()
    for k in range(n_shards):
        def block(x, k=k):
            if x.ndim == 0:
                return x
            c = x.shape[0] // n_shards
            return x[k * c:(k + 1) * c]
        out |= current_matches(plan, map_state(block, state))
    return out
