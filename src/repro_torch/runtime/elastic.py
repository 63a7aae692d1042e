"""Elastic scaling: re-fit a running job onto a different mesh.

The port of ``repro.runtime.elastic``.  State trees carry explicit
``PartitionSpec`` trees that name logical axes, so one spec tree serves
any mesh shape; ``checkpoint.reshard`` does the placement.

A capacity-sharded ``EngineState`` needs more than a placement: its
``parent`` pointers are shard-local indices, and a level-j row must sit
on its parent's shard.  Re-splitting the global capacity axis blindly
(what the reference's ``scale_to_mesh`` does) puts an old shard's rows
into a new shard with other offsets, and their pointers then name
another shard's rows.  So ``scale_to_mesh`` re-homes an engine state so
that every MS-tree chain stays on one shard, with its pointers
rewritten:

* scaling down by an integer factor f keeps every row where it is (new
  shard j is old shards ``j*f .. j*f+f-1``) and rebases the pointers by
  the old shard's offset inside the new one;
* any other change repacks the chains: the rows of each subquery's first
  table are dealt round robin over the new shards, every descendant
  follows its parent, and L0 rows (denormalized) are dealt round robin.

The first table of each subquery holds chain roots: its ``parent`` is
-1, or, under a shared prefix, a row of the replicated prefix table, so
it is never rewritten.  This is a deliberate difference from the
reference, whose rescaled engine reports other matches.
"""

from __future__ import annotations

import numpy as np

from repro_torch.checkpoint import reshard
from repro_torch.core.distributed import Mesh, make_mesh
from repro_torch.core.state import EngineState, state_to_numpy


def _engine_shards(mesh: Mesh, specs: EngineState) -> int:
    """The shard count of an engine state's tables under ``specs``."""
    counts = {spec.shards(mesh)
              for sub in specs.levels for t in sub for spec in t}
    counts |= {spec.shards(mesh) for t in specs.l0 for spec in t}
    if len(counts) > 1:
        raise ValueError(f"the tables of one engine state are split "
                         f"{sorted(counts)} ways")
    return counts.pop() if counts else 1


def _fill(table: tuple, capacity: int) -> tuple:
    """Empty rows as ``init_state`` makes them (``parent`` -1)."""
    out = []
    for name, x in zip(table._fields, table):
        v = -1 if name == "parent" else 0
        out.append(np.full((capacity,) + x.shape[1:], v, dtype=x.dtype))
    return type(table)(*out)


def _place(table: tuple, rows: np.ndarray, shard: np.ndarray, n_new: int,
           c_new: int):
    """Pack ``rows`` of ``table`` into ``n_new`` blocks of ``c_new``, each
    row into block ``shard[i]`` in row order; returns (table, new global
    index of each row)."""
    count = np.bincount(shard, minlength=n_new)
    if count.max(initial=0) > c_new:
        raise ValueError(
            f"a shard would hold {int(count.max())} rows, more than its "
            f"capacity {c_new}: the state does not fit {n_new} shards")
    local = np.zeros(len(rows), dtype=np.int64)
    for j in range(n_new):
        sel = shard == j
        local[sel] = np.arange(int(sel.sum()))
    dest = shard.astype(np.int64) * c_new + local
    out = _fill(table, table.valid.shape[0])
    for dst_leaf, src_leaf in zip(out, table):
        dst_leaf[dest] = src_leaf[rows]
    return out, dest


def _rehome(state: EngineState, n_old: int, n_new: int) -> EngineState:
    """The host copy of ``state`` with its chains re-homed from ``n_old``
    onto ``n_new`` shards (see the module docstring)."""
    st = state_to_numpy(state)
    levels = []
    if n_old % n_new == 0:              # scale down: rebase the pointers
        f = n_old // n_new
        for sub in st.levels:
            out = [sub[0]]
            for t in sub[1:]:
                c_old = t.parent.shape[0] // n_old
                k = np.arange(t.parent.shape[0]) // c_old
                off = ((k % f) * c_old).astype(t.parent.dtype)
                out.append(t._replace(parent=np.where(
                    t.parent >= 0, t.parent + off, t.parent)))
            levels.append(tuple(out))
        return st._replace(levels=tuple(levels))

    for sub in st.levels:
        out = []
        prev = None          # (old c, new c, new shard, new index) by row
        for ti, t in enumerate(sub):
            cap = t.valid.shape[0]
            if cap % n_new:
                raise ValueError(f"capacity {cap} is not divisible by "
                                 f"{n_new} shards")
            c_old, c_new = cap // n_old, cap // n_new
            rows = np.flatnonzero(t.valid)
            if prev is None:
                shard = np.arange(len(rows)) % n_new
            else:
                p_old, p_new, p_shard, p_dest = prev
                par = (rows // c_old) * p_old + t.parent[rows]
                shard = p_shard[par]
                if (shard < 0).any():
                    raise ValueError("a valid row's parent is not valid")
            new, dest = _place(t, rows, shard, n_new, c_new)
            if prev is not None:
                new.parent[dest] = (p_dest[par] % p_new).astype(
                    t.parent.dtype)
            out.append(new)
            by_row = np.full((2, cap), -1, dtype=np.int64)
            by_row[0, rows], by_row[1, rows] = shard, dest
            prev = (c_old, c_new, by_row[0], by_row[1])
        levels.append(tuple(out))
    l0 = []
    for t in st.l0:
        cap = t.valid.shape[0]
        if cap % n_new:
            raise ValueError(f"capacity {cap} is not divisible by {n_new} "
                             "shards")
        rows = np.flatnonzero(t.valid)
        l0.append(_place(t, rows, np.arange(len(rows)) % n_new, n_new,
                         cap // n_new)[0])
    return st._replace(levels=tuple(levels), l0=tuple(l0))


def scale_to_mesh(state, old_mesh, new_mesh, specs):
    """Move ``state`` (a tree on ``old_mesh``) onto ``new_mesh`` under
    ``specs``.  A capacity-sharded ``EngineState`` is re-homed first, so
    that every MS-tree chain stays on one shard of the new mesh (a shard
    that cannot hold its rows raises ``ValueError``); any other tree goes
    through ``reshard`` unchanged."""
    if isinstance(state, EngineState):
        n_old = _engine_shards(old_mesh, specs)
        n_new = _engine_shards(new_mesh, specs)
        if n_old != n_new:
            state = _rehome(state, n_old, n_new)
    return reshard(state, new_mesh, specs)


def degraded_mesh(devices, shape, axis_names, drop: int = 0) -> Mesh:
    """Build a mesh from the surviving device list (node-failure path):
    drops ``drop`` devices and re-folds the rest into the largest
    fitting mesh of the same axis structure."""
    devs = list(devices)[: len(devices) - drop]
    total = len(devs)
    trailing = 1
    for s in shape[1:]:
        trailing *= s
    first = total // trailing
    if first < 1:
        raise ValueError("not enough devices for the requested mesh shape")
    new_shape = (first,) + tuple(shape[1:])
    return make_mesh(new_shape, axis_names, devices=devs[:first * trailing])

