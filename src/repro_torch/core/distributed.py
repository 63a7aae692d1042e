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

Two meshes.  A one-process mesh is an array of torch devices with named
axes whose entries are all the same device: n logical shards on one
card, or on the CPU in the tests (the counterpart of the reference's
forced host device count).  Its state keeps the reference's global
shapes: every table leaf is ``[C, ...]`` on the mesh's device, shard k's
rows at ``[k*C/n, (k+1)*C/n)``, and every scalar is ``[]`` — what
``jax.device_get`` of the reference's sharded state gives.  The tick
views each leaf as ``[n, C/n, ...]`` and runs the tick body once over
the shard axis, so n shards cost one body's host dispatch, not n.

A process-group mesh (``group=``, PyTorch's one process per device) has
one rank per entry: rank r runs on ``devices[r]`` and holds only shard
r — every table leaf ``[C/n, ...]``, bit for bit rows ``[r*C/n,
(r+1)*C/n)`` of the global state the one-process mesh holds — and the
reference's collectives are the group's (``engine.GroupAxis``).  Entries
may repeat, for ranks that share a card.  A one-process mesh of distinct
devices raises ``NotImplementedError``: a distinct device is another
process's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import build_tick, current_matches
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.state import (
    EngineState,
    init_state,
    map_state,
    resolve_device,
)

_DISTINCT = ("a one-process mesh names one device (n logical shards on "
             "it); for distinct devices run one process a device and pass "
             "the torch.distributed group as group=")


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

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


P = PartitionSpec


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class Mesh:
    """An array of torch devices with named axes: ``devices`` (numpy
    object array of ``torch.device``), ``axis_names``, ``shape`` (axis
    name -> size, in axis order, as ``jax.sharding.Mesh.shape``),
    ``device`` (the device this process runs on), ``group`` and
    ``rank``.

    ``group`` None is the one-process mesh: every entry the same device.
    A ``torch.distributed`` process group (or ``torch.distributed.
    group.WORLD``) is a process-group mesh: its size is the mesh's,
    ``rank`` is this process's rank in it and ``device`` its entry.  On
    a process outside the group ``rank`` and ``device`` are None: it
    holds nothing of the mesh's state (``runtime.elastic.scale_to_mesh``
    onto a subgroup)."""

    def __init__(self, devices, axis_names, *, group=None):
        devs = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"a {devs.ndim}-d device array for axes {names}")
        flat = [torch.device(d) for d in devs.reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = None
        if group is None:
            if any(not _same_device(d, flat[0]) for d in flat):
                raise NotImplementedError(_DISTINCT)
            self.device = flat[0]
        else:
            rank = dist.get_rank(group)
            if rank >= 0:
                size = dist.get_world_size(group)
                if size != len(flat):
                    raise ValueError(f"a mesh of {len(flat)} devices over a "
                                     f"group of {size} ranks")
                self.rank = rank
            self.device = None if self.rank is None else flat[self.rank]
        self.devices = np.empty(devs.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = names
        self.shape = dict(zip(names, devs.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    # ---- a process-group mesh's coordinates, axis groups and DTensor mesh
    def coords(self) -> dict:
        """Axis name -> this rank's index along it (ranks are laid out
        row-major over the axes; 0 on a one-process mesh)."""
        if self.rank is None:
            return {a: 0 for a in self.axis_names}
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's block along the product of ``axes``, major to
        minor (a spec entry such as ``("pod", "data")``)."""
        c = self.coords()
        out = 0
        for a in _axes(axes):
            out = out * self.shape[a] + c[a]
        return out

    def axis_group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (in mesh order), its group ranks in block order;
        None on a one-process mesh.  Every rank of the mesh creates every
        group of an axis set at its first use (a collective: the ranks run
        one program)."""
        if self.group is None:
            return None
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if not hasattr(self, "_groups"):
            self._groups = {}
        if axes not in self._groups:
            if axes == self.axis_names:
                self._groups[axes] = self.group
            else:
                ranks = np.arange(self.size).reshape(
                    tuple(self.shape.values()))
                keep = [i for i, a in enumerate(self.axis_names)
                        if a in axes]
                rest = [i for i in range(len(self.axis_names))
                        if i not in keep]
                blocks = ranks.transpose(rest + keep).reshape(
                    -1, self.axis_size(axes))
                glob = [[self._global_rank(int(r)) for r in b]
                        for b in blocks]
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    glob)
        return self._groups[axes]

    def _global_rank(self, r: int) -> int:
        if self.group is dist.group.WORLD or self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    @property
    def device_mesh(self):
        """The ``torch.distributed.device_mesh.DeviceMesh`` of a
        process-group mesh, with the same axis names (specs become
        placements on it: ``placements``); None on a one-process mesh."""
        if self.group is None:
            return None
        if getattr(self, "_device_mesh", None) is None:
            from torch.distributed.device_mesh import DeviceMesh

            glob = torch.tensor([self._global_rank(r)
                                 for r in range(self.size)]).view(
                tuple(self.shape.values()))
            dev = "cpu" if self.device is None else self.device.type
            self._device_mesh = DeviceMesh(dev, glob,
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh


def make_mesh(shape, axis_names, *, devices=None, group=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axis_names``.  ``devices`` lists
    exactly ``prod(shape)`` entries (a device may repeat: n logical
    shards on one device, or ranks that share one); None means the card,
    repeated.  ``group`` (a ``torch.distributed`` process group of
    ``prod(shape)`` ranks) makes a process-group mesh, rank r on
    ``devices[r]``; see ``Mesh``."""
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
    return Mesh(arr.reshape(shape), axis_names, group=group)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def placements(spec: PartitionSpec, device_mesh) -> tuple:
    """A ``PartitionSpec`` as DTensor placements on ``device_mesh`` (whose
    dims carry the spec's axis names): ``Shard(d)`` on every mesh dim
    that entry d names, ``Replicate()`` elsewhere.  An entry naming two
    mesh dims (``("pod", "data")``) shards its tensor dim over both, the
    first named the major one, as JAX's block order is: DTensor splits a
    dim sharded on two mesh dims in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * device_mesh.ndim
    names = list(device_mesh.mesh_dim_names)
    for d, entry in enumerate(spec.parts):
        for a in entry or ():
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_block(x: torch.Tensor, spec: PartitionSpec,
                mesh: Mesh) -> torch.Tensor:
    """The block of the global ``x`` that ``spec`` gives this rank of
    ``mesh``: the block JAX's ``NamedSharding`` gives the device at the
    same mesh coordinates.  A view."""
    for d, entry in enumerate(spec.parts):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{n} ways ({spec})")
        c = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(entry) * c, c)
    return x


def global_shape(shape, spec: PartitionSpec, mesh: Mesh) -> tuple:
    """The global shape of a leaf whose block under ``spec`` is
    ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec.parts):
        if entry is not None:
            out[d] *= mesh.axis_size(entry)
    return tuple(out)


def replicated_axes(spec: PartitionSpec, mesh: Mesh) -> tuple:
    """The mesh axes a leaf under ``spec`` is replicated over."""
    named = {a for entry in spec.parts for a in (entry or ())}
    return tuple(a for a in mesh.axis_names if a not in named)


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

    On a one-process mesh ``state`` and the result keep the reference's
    global shapes (see ``repro_torch.core.engine.build_tick``).  On a
    process-group mesh they are this rank's: every table leaf ``[C/n,
    ...]`` on the rank's device, the rank's match rows, and the
    ``TickResult`` scalars summed over the group; the axes must span
    every rank.  ``backend`` None is the device's default: the CUDA pair
    kernel on a card (over the shard axis, S = n, or S = 1 a rank), REF
    on the CPU.  With ``prefix_depth > 0`` the tick takes a
    shared-prefix ``NodeView`` (``repro_torch.core.share``) as a third
    argument, replicated to every shard; the forest node advances once
    (on every rank), outside the tick.
    """
    axes = _axes(axes)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    if mesh.group is not None:
        if n_shards != mesh.size:
            raise ValueError(f"axes {axes} split {n_shards} ways over a "
                             f"process group of {mesh.size} ranks: the "
                             "capacity axis must span every rank")
        if mesh.rank is None:
            raise ValueError("this process is not a rank of the mesh's "
                             "group")
    tick = build_tick(
        plan,
        backend=backend,
        extract_matches=extract_matches,
        axis_name=axes if len(axes) > 1 else axes[0],
        n_shards=n_shards,
        prefix_depth=prefix_depth,
        device=mesh.device,
        group=mesh.group,
    )
    rank_shards = 1 if mesh.group is None else n_shards
    return tick, init_state(plan, prefix_depth, device=mesh.device,
                            n_shards=rank_shards)


def _sharded_current_matches(plan: ExecutionPlan, state: EngineState,
                             n_shards: int, *, group=None):
    """``current_matches`` of a capacity-sharded state: each shard's
    ``C/n`` block is folded on its own, since its ``parent`` pointers
    are shard-local (reading them through the concatenated arrays
    misreads every shard after the first).  L0 rows are denormalized, so
    their blocks fold the same either way.  With ``group`` ``state`` is
    this rank's shard: each rank folds its own, and the union is
    gathered to every rank (a collective: every rank calls it)."""
    if group is not None:
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, current_matches(plan, state),
                               group=group)
        return set().union(*parts)
    out = set()
    for k in range(n_shards):
        def block(x, k=k):
            if x.ndim == 0:
                return x
            c = x.shape[0] // n_shards
            return x[k * c:(k + 1) * c]
        out |= current_matches(plan, map_state(block, state))
    return out
