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
import torch
import torch.distributed as dist

from repro_torch.checkpoint import reshard
from repro_torch.core.distributed import Mesh, make_mesh
from repro_torch.core.state import EngineState, map_state, state_to_numpy


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


def _tables(st: EngineState) -> list:
    """Every table of ``st`` in one order: each subquery's levels, then
    the L0 tables."""
    return [t for sub in st.levels for t in sub] + list(st.l0)


def _roots(st: EngineState) -> list[bool]:
    """Per table of ``_tables``: does it hold roots (a subquery's first
    table, or an L0 table), dealt round robin when chains are repacked?"""
    out = []
    for sub in st.levels:
        out += [True] + [False] * (len(sub) - 1)
    return out + [True] * len(st.l0)


def _root_counts(blk: EngineState) -> list[int]:
    """Per table: its valid rows if it holds roots, else 0."""
    return [int(t.valid.sum()) if r else 0
            for t, r in zip(_tables(blk), _roots(blk))]


def _with_tables(st: EngineState, tables: list) -> EngineState:
    it = iter(tables)
    levels = tuple(tuple(next(it) for _ in sub) for sub in st.levels)
    return st._replace(levels=levels, l0=tuple(next(it) for _ in st.l0))


class _Moves:
    """Where every row of old block k goes when ``n_old`` shards become
    ``n_new`` (see the module docstring), table by table: the rows that
    move, their new shard, and their parent row in the previous table of
    the same block (None for roots, and when scaling down).  Scaling down by an integer factor
    moves every row, valid or not, into the same place of its old
    shard's slice of the new shard; any other change moves the valid
    rows, roots dealt round robin from ``root_before`` (the valid roots
    of each root table in blocks before k) and every descendant on its
    parent's shard."""

    def __init__(self, blk: EngineState, k: int, n_old: int, n_new: int,
                 root_before: list):
        self.down = n_old % n_new == 0
        self.rows, self.shard, self.par = [], [], []
        prev_shard = None
        for t, (tbl, root) in enumerate(zip(_tables(blk), _roots(blk))):
            c_old = tbl.valid.shape[0]
            if self.down:
                rows = np.arange(c_old)
                shard = np.full(c_old, k // (n_old // n_new))
                par = None
            else:
                rows = np.flatnonzero(tbl.valid)
                if root:
                    shard = (root_before[t] + np.arange(len(rows))) % n_new
                    par = None
                else:
                    par = tbl.parent[rows].astype(np.int64)
                    shard = prev_shard[par] if len(rows) else par
                    if (shard < 0).any():
                        raise ValueError("a valid row's parent is not valid")
            by_row = np.full(c_old, -1, dtype=np.int64)
            by_row[rows] = shard
            prev_shard = by_row
            self.rows.append(rows)
            self.shard.append(shard.astype(np.int64))
            self.par.append(par)

    def counts(self, n_new: int) -> np.ndarray:
        """[tables, n_new]: rows this block sends to each new shard."""
        return np.stack([np.bincount(s, minlength=n_new)
                         for s in self.shard])


def _dest(moves: _Moves, blk: EngineState, k: int, f: int,
          before: np.ndarray) -> list:
    """Each moving row's index in its new shard, table by table:
    scaling down, its old shard's offset ``(k % f) * c_old`` plus its
    row; repacking, the rows that blocks before k send to its shard
    (``before`` [tables, n_new]) plus its rank among this block's rows
    to that shard."""
    out = []
    for t, (tbl, rows, shard) in enumerate(zip(_tables(blk), moves.rows,
                                               moves.shard)):
        if moves.down:
            out.append((k % f) * tbl.valid.shape[0] + rows)
            continue
        local = np.zeros(len(rows), dtype=np.int64)
        for j in np.unique(shard):
            sel = shard == j
            local[sel] = before[t, j] + np.arange(int(sel.sum()))
        out.append(local)
    return out


def _pack(tbl, rows, dest, new_parent) -> np.ndarray:
    """int32 [rows, 1 + columns]: the destination index, then every
    leaf of ``tbl`` (``parent`` rewritten) as columns."""
    cols = [dest[:, None]]
    for name, x in zip(tbl._fields, tbl):
        x = new_parent if name == "parent" else x[rows]
        cols.append(x.reshape(len(rows), -1))
    return np.concatenate(cols, axis=1).astype(np.int32) if len(rows) \
        else np.zeros((0, sum(c.shape[1] for c in cols)), np.int32)


def _unpack(packed: np.ndarray, like, capacity: int):
    """Scatter packed rows into an empty table of ``capacity`` rows."""
    out = _fill(like, capacity)
    dest = packed[:, 0].astype(np.int64)
    col = 1
    for leaf in out:
        w = int(np.prod(leaf.shape[1:], dtype=np.int64))
        leaf[dest] = packed[:, col:col + w].reshape(
            (len(dest),) + leaf.shape[1:]).astype(leaf.dtype)
        col += w
    return out


def _outgoing(blk: EngineState, k: int, n_old: int, n_new: int,
              moves: _Moves, before: np.ndarray) -> list:
    """Per table, per new shard: the packed rows block k sends there,
    each ``parent`` rewritten to its parent's index in the new shard."""
    f = max(n_old // n_new, 1)
    out, prev_dest = [], None
    for tbl, root, rows, shard, par, dest in zip(
            _tables(blk), _roots(blk), moves.rows, moves.shard, moves.par,
            _dest(moves, blk, k, f, before)):
        new_parent = None
        if "parent" in tbl._fields:
            if root:
                new_parent = tbl.parent[rows]
            elif moves.down:
                off = (k % f) * tbl.valid.shape[0]
                new_parent = np.where(tbl.parent >= 0, tbl.parent + off,
                                      tbl.parent)
            else:
                new_parent = prev_dest[par]
        packed = _pack(tbl, rows, dest, new_parent)
        out.append([packed[shard == j] for j in range(n_new)])
        prev_dest = np.full(tbl.valid.shape[0], -1, dtype=np.int64)
        prev_dest[rows] = dest
    return out


def _check_fit(total: np.ndarray, caps: list, n_new: int) -> None:
    """Every new shard holds the rows sent to it (``total`` [tables,
    n_new]) within its capacity (``caps`` per table)."""
    for t, c_new in enumerate(caps):
        if total[t].max(initial=0) > c_new:
            raise ValueError(
                f"a shard would hold {int(total[t].max())} rows, more than "
                f"its capacity {c_new}: the state does not fit {n_new} "
                "shards")


def _rehome(state: EngineState, n_old: int, n_new: int) -> EngineState:
    """The host copy of ``state`` with its chains re-homed from ``n_old``
    onto ``n_new`` shards (see the module docstring)."""
    st = state_to_numpy(state)
    for t in _tables(st):
        if t.valid.shape[0] % n_new:
            raise ValueError(f"capacity {t.valid.shape[0]} is not divisible "
                             f"by {n_new} shards")
    blocks = [_block(st, k, n_old) for k in range(n_old)]
    moves, out = _moves_all(blocks, n_old, n_new)
    if n_old % n_new:
        _check_fit(sum(m.counts(n_new) for m in moves),
                   [t.valid.shape[0] // n_new for t in _tables(st)], n_new)
    sent = [_outgoing(b, k, n_old, n_new, m, before)
            for k, (b, m, before) in enumerate(zip(blocks, moves, out))]
    tables = []
    for t, tbl in enumerate(_tables(st)):
        c_new = tbl.valid.shape[0] // n_new
        parts = [_unpack(np.concatenate([s[t][j] for s in sent]), tbl,
                         c_new) for j in range(n_new)]
        tables.append(type(tbl)(*(np.concatenate(xs) for xs in
                                  zip(*parts))))
    return _with_tables(st, tables)


def _block(st: EngineState, k: int, n: int) -> EngineState:
    """Block k of n of a global host state (scalars as they are)."""
    def cut(x):
        if np.ndim(x) == 0:
            return x
        c = x.shape[0] // n
        return x[k * c:(k + 1) * c]
    return map_state(cut, st)


def _moves_all(blocks: list, n_old: int, n_new: int):
    """``_Moves`` of every old block, and per block the rows that the
    blocks before it send to each new shard ([tables, n_new])."""
    valid = np.array([_root_counts(b) for b in blocks])
    root_before = np.cumsum(valid, axis=0) - valid
    moves = [_Moves(b, k, n_old, n_new, list(root_before[k]))
             for k, b in enumerate(blocks)]
    counts = np.stack([m.counts(n_new) for m in moves])
    before = np.cumsum(counts, axis=0) - counts
    return moves, list(before)


def _scale_ranks(state, old_mesh, new_mesh, n_old: int, n_new: int):
    """``scale_to_mesh`` between process-group meshes, called on every
    rank of the default group: each rank of ``old_mesh`` plans the moves
    of its own block (two small exchanges: the valid roots, then the
    rows each block sends to each new shard), the rows that change rank
    go in one ``all_to_all_single`` a table over the default group (on
    the card under NCCL, on the host under any other backend), and each
    rank of ``new_mesh`` builds its block.  Returns None on a rank
    outside ``new_mesh``."""
    held = None if old_mesh.rank is None else state_to_numpy(state)
    mine = None
    if held is not None:
        mine = {"k": old_mesh.rank, "valid": _root_counts(held),
                "caps": [t.valid.shape[0] for t in _tables(held)],
                "like": map_state(lambda x: x[:0] if np.ndim(x) else x,
                                  held)}
    world = dist.get_world_size()
    info = [None] * world
    dist.all_gather_object(info, (mine, new_mesh.rank))
    old_at = {m["k"]: g for g, (m, _) in enumerate(info) if m is not None}
    new_at = {j: g for g, (_, j) in enumerate(info) if j is not None}
    if sorted(old_at) != list(range(n_old)) \
            or sorted(new_at) != list(range(n_new)):
        raise ValueError("every shard of both meshes needs one rank of the "
                         "default group")
    first = info[old_at[0]][0]
    caps = []
    for c in first["caps"]:
        if (c * n_old) % n_new:
            raise ValueError(f"capacity {c * n_old} is not divisible by "
                             f"{n_new} shards")
        caps.append(c * n_old // n_new)
    valid = np.array([info[old_at[k]][0]["valid"] for k in range(n_old)])
    root_before = np.cumsum(valid, axis=0) - valid
    moves = None
    if held is not None:
        moves = _Moves(held, old_mesh.rank, n_old, n_new,
                       list(root_before[old_mesh.rank]))
    counts = [None] * world
    dist.all_gather_object(counts,
                           None if moves is None else moves.counts(n_new))
    counts = np.stack([counts[old_at[k]] for k in range(n_old)])
    before = np.cumsum(counts, axis=0) - counts
    if n_old % n_new:
        _check_fit(counts.sum(axis=0), caps, n_new)
    sent = None if held is None else _outgoing(
        held, old_mesh.rank, n_old, n_new, moves, before[old_mesh.rank])
    j_me = new_mesh.rank
    crossing = any(counts[k, :, j].any() and old_at[k] != new_at[j]
                   for k in range(n_old) for j in range(n_new))
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    tables = []
    for t, like in enumerate(_tables(first["like"])):
        width = 1 + sum(int(np.prod(x.shape[1:], dtype=np.int64))
                        for x in like)
        none = np.zeros((0, width), np.int32)
        if not crossing:
            got = none if sent is None or j_me is None else sent[t][j_me]
        else:
            send = [none] * world
            for j in range(n_new if sent is not None else 0):
                send[new_at[j]] = sent[t][j]
            recv = [0] * world
            for k in range(n_old if j_me is not None else 0):
                recv[old_at[k]] = int(counts[k, t, j_me])
            out = torch.empty((sum(recv), width), dtype=torch.int32,
                              device=dev)
            dist.all_to_all_single(
                out, torch.from_numpy(np.concatenate(send)).to(dev),
                output_split_sizes=recv,
                input_split_sizes=[len(x) for x in send])
            got = out.cpu().numpy()
        if j_me is not None:
            tables.append(_unpack(got, like, caps[t]))
    if j_me is None:
        return None
    return map_state(lambda x: torch.as_tensor(np.asarray(x)).to(
        new_mesh.device), _with_tables(first["like"], tables))


def scale_to_mesh(state, old_mesh, new_mesh, specs):
    """Move ``state`` (a tree on ``old_mesh``) onto ``new_mesh`` under
    ``specs``.  A capacity-sharded ``EngineState`` is re-homed first, so
    that every MS-tree chain stays on one shard of the new mesh (a shard
    that cannot hold its rows raises ``ValueError``); any other tree goes
    through ``reshard`` unchanged.

    Process-group meshes: from a one-process mesh (the global state, on
    every rank) onto a process-group mesh each rank keeps its block of
    the re-homed state.  Between two process-group meshes every rank of
    the default group calls this, ``state`` being its shard (or None on
    a rank outside ``old_mesh``); each rank sends only the rows that
    change rank, and a rank outside ``new_mesh`` gets None.
    """
    if isinstance(state, EngineState) or state is None:
        n_old = _engine_shards(old_mesh, specs)
        n_new = _engine_shards(new_mesh, specs)
        if old_mesh.group is not None:
            if new_mesh.group is None:
                raise ValueError("a process group's state goes onto "
                                 "another process-group mesh, or through "
                                 "a checkpoint")
            return _scale_ranks(state, old_mesh, new_mesh, n_old, n_new)
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

