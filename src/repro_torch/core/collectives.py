"""The collectives of the sharded cells, with their gradients.

A sharded cell's rank runs its own block of the program on its own
shards; where the reference's GSPMD partitioner inserts a collective,
the rank calls one of these.  Each is a ``torch.autograd.Function``
whose backward is the collective's true transpose over the ranks:

  all_gather      forward: the blocks of ``dim`` from every rank of the
                  group, in group-rank (block) order;
                  backward: reduce-scatter (sum) of the gradients
  reduce_scatter  forward: the sum over the group, this rank's block of
                  ``dim``; backward: all-gather
  all_reduce      forward: the sum (or max / min) over the group;
                  backward: the sum of the gradients over the group (a
                  max or min sends it to the ranks that hold the result)

So a rank's gradients are those of the sum of every rank's objective: a
sharded train step gives each rank the global loss / the number of ranks
as its objective, and a leaf's gradient is complete once it is summed
over the mesh axes the leaf is replicated on (``launch.cells``).

A group of one rank, or None, is the identity.  Every call is recorded,
while ``recording()`` is active, as ``(kind, result_bytes, group_size)``
for ``launch.roofline.collective_bytes``: the dry run traces one rank's
program under the "fake" backend and reckons its wire bytes from these.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_RECORDS: list | None = None


@contextlib.contextmanager
def recording():
    """Collect every collective issued inside the block: yields the list
    of ``(kind, result_bytes, group_size)`` records."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _record(kind: str, out: torch.Tensor, group) -> None:
    if _RECORDS is not None:
        _RECORDS.append((kind, out.numel() * out.element_size(),
                         _size(group)))


def _gather(x, dim: int, group):
    n = _size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    _record("all-gather", out, group)
    return out.movedim(0, dim)


def _scatter(x, dim: int, group):
    n = _size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    _record("reduce-scatter", out, group)
    return out.movedim(0, dim)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _reduce(x, group, op: str = "sum"):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    _record("all-reduce", out, group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _AllReduceExtreme(torch.autograd.Function):
    """A max or min: the gradient goes to the ranks that hold the
    result."""

    @staticmethod
    def forward(ctx, x, group, op):
        out = _reduce(x, group, op)
        ctx.group = group
        ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (held,) = ctx.saved_tensors
        return torch.where(held, _reduce(g, ctx.group), 0), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's blocks along ``dim`` (differentiable)."""
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group, keep this rank's block of ``dim``."""
    if _size(group) == 1:
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or "max" / "min") over the group (differentiable)."""
    if _size(group) == 1:
        return x
    if op == "sum":
        return _AllReduce.apply(x, group)
    return _AllReduceExtreme.apply(x, group, op)


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over the group in place, no
    gradient: optimiser statistics and gradients after the backward."""
    if _size(group) > 1:
        dist.all_reduce(x, op=_OPS[op], group=group)
        _record("all-reduce", x, group)
    return x
