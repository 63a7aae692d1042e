"""Message-passing primitives over (edge_src, edge_dst) index arrays: the
port of ``repro.models.gnn.message``.

Edges with src or dst < 0 are padding and contribute nothing.  Sum and
mean go through the segment_sum kernel, and so does the gradient of the
gather ``x[src]`` (``gather_rows``); max/min (``segment_extreme``),
``segment_softmax``, ``degrees`` and the per-graph pooling
(``pool_graphs``) are plain torch, as the reference's are plain JAX.

Sharded edges (``group``, a process group over which the edge arrays
are split, node arrays replicated): each rank reduces its own edges
into all N nodes and the partial results are combined over the group
(``core.collectives``: sum, max, min), so every rank holds the same
node result; a max's gradient is shared by the messages equal to it, on
whichever ranks they are.  With the
node-dim tensors sharded too (``NodeBlocks``, the cells' ``mesh_axes``
on the full-batch-large shapes) a sum is reduce-scattered to the rank's
block of nodes instead, and a gather of node rows reads them from an
all-gather of the blocks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import (
    all_gather,
    all_reduce,
    all_reduce_,
    reduce_scatter,
)
from repro_torch.kernels.segment_reduce import ops as sr


class _GatherRows(torch.autograd.Function):
    """``x[max(idx, 0)]``, whose gradient in ``x`` is the transpose: a
    segment sum of the rows' gradients over ``idx``, padding dropped."""

    @staticmethod
    def forward(ctx, x, idx, backend):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.backend = x.shape[0], backend
        return x[idx.clamp(min=0)]

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return sr.segment_sum(idx, grad, ctx.n_rows, ctx.backend), None, None


def gather_rows(x, idx, backend: str | None = None):
    """``x[idx]`` for ``x`` [N, D]: [E, D]; a padding index (< 0) reads
    row 0, as the reference's clamped gather does, and its caller drops
    that row (every sum and every weight of a padding edge ignores it).
    The gradient ``grad_x[i] = sum of grad[e] over idx[e] == i`` runs on
    the segment_sum kernel (``backend``) with the padding dropped: it
    sums in float32 where the gather's own backward (``index_put_`` with
    accumulate) sums in the rows' dtype, so a node of out-degree in the
    millions keeps a bf16 gradient's small terms; and that backward
    walks every duplicate of one row in turn (a padded minibatch's edges
    all on row 0)."""
    return _GatherRows.apply(x, idx, backend)


def edge_sum(dst, msg, n_nodes: int, backend: str | None = None, *,
             group=None):
    """``segment_sum`` of this rank's edges on the kernel, summed over
    ``group`` (None: every edge is here)."""
    return all_reduce(sr.segment_sum(dst, msg, n_nodes, backend), group)


def gather_scatter(x, edge_src, edge_dst, n_nodes: int,
                   transform=None, reduce: str = "sum",
                   backend: str | None = None, *, group=None):
    """out[dst] = reduce over edges of transform(x[src])."""
    src_ok = edge_src >= 0
    msg = gather_rows(x, edge_src, backend)   # padding dropped by dst below
    if transform is not None:
        msg = transform(msg)
    dst = torch.where(src_ok & (edge_dst >= 0), edge_dst, -1)
    if reduce == "sum":
        return edge_sum(dst, msg, n_nodes, backend, group=group)
    if reduce == "mean":
        if group is None:
            return sr.segment_mean(dst, msg, n_nodes, backend)
        cnt = edge_sum(dst, msg.new_ones((msg.shape[0], 1)), n_nodes,
                       backend, group=group)
        return edge_sum(dst, msg, n_nodes, backend,
                        group=group) / cnt.clamp(min=1e-9)
    if reduce in ("max", "min"):
        return segment_extreme(dst, msg, n_nodes, reduce, group=group)
    raise ValueError(reduce)


def segment_extreme(dst, msg, n_nodes: int, reduce: str, *, group=None):
    """The reference's ``jax.ops.segment_max``/``segment_min`` (``reduce``
    "max"/"min") over dst (< 0 = padding), plain ``scatter_reduce_``;
    a segment with no edge gives 0.  The gradient is shared evenly by
    the messages equal to their segment's extreme, as on one device;
    with ``group`` by those of every rank's edges."""
    seg = torch.where(dst < 0, n_nodes, dst).long()
    fill = float("-inf") if reduce == "max" else float("inf")
    out = torch.full((n_nodes + 1, msg.shape[1]), fill, dtype=msg.dtype,
                     device=msg.device)
    idx = seg[:, None].expand_as(msg)
    op = "amax" if reduce == "max" else "amin"
    if group is None or dist.get_world_size(group) == 1:
        out.scatter_reduce_(0, idx, msg, op)
    else:
        with torch.no_grad():
            all_reduce_(out.scatter_reduce_(0, idx, msg, op), group, reduce)
            hit = (msg == out.gather(0, idx)).to(msg.dtype)
            ties = all_reduce_(torch.zeros_like(out).scatter_add_(
                0, idx, hit), group)
            share = hit / ties.gather(0, idx)
        # the extreme itself, with the tied messages' mean share of it as
        # its gradient (a sum over the group: an edge's tie may be on
        # another rank)
        s = all_reduce(torch.zeros_like(out).scatter_add(0, idx,
                                                         msg * share), group)
        out = out + (s - s.detach())
    out = out[:n_nodes]
    return torch.where(torch.isfinite(out), out, 0)


def segment_softmax(scores, seg, n_segments: int, *, group=None):
    """Numerically-stable softmax of ``scores`` grouped by ``seg``.

    scores [E, H]; seg int [E] (-1 = padding -> weight 0).  With
    ``group`` the segments' maxima and denominators span the group's
    edges (the maxima only shift: no gradient flows through them).
    """
    seg_safe = torch.where(seg < 0, n_segments, seg).long()
    mx = torch.full((n_segments + 1, scores.shape[1]), float("-inf"),
                    dtype=scores.dtype, device=scores.device)
    mx.scatter_reduce_(0, seg_safe[:, None].expand_as(scores),
                       scores if group is None else scores.detach(), "amax")
    if group is not None:
        mx = all_reduce_(mx, group, "max")
    mx = torch.where(torch.isfinite(mx), mx, 0)
    ex = torch.exp(scores - mx[seg_safe])
    ex = torch.where((seg >= 0)[:, None], ex, 0)
    den = all_reduce(torch.zeros_like(mx).index_add_(0, seg_safe, ex), group)
    return ex / torch.clamp(den[seg_safe], min=1e-16)


def pool_graphs(x, graph_ids, n_graphs: int):
    """Sum of the rows of ``x`` [N, ...] per graph (graph_ids -1 =
    padding) -> [n_graphs, ...]: plain ``index_add_``, as the
    reference's ``jax.ops.segment_sum`` there is plain XLA."""
    seg = torch.where(graph_ids < 0, n_graphs, graph_ids).long()
    ok = (graph_ids >= 0).view((-1,) + (1,) * (x.dim() - 1))
    pooled = torch.zeros((n_graphs + 1,) + tuple(x.shape[1:]),
                         dtype=x.dtype, device=x.device)
    pooled.index_add_(0, seg, torch.where(ok, x, 0))
    return pooled[:n_graphs]


def degrees(edge_dst, n_nodes: int, *, group=None):
    """In-degree per node (float32 [n_nodes]); dst < 0 is padding."""
    dst = torch.where(edge_dst >= 0, edge_dst, n_nodes).long()
    deg = torch.zeros((n_nodes + 1,), dtype=torch.float32,
                      device=edge_dst.device)
    deg.index_add_(0, dst, torch.ones_like(dst, dtype=torch.float32))
    return all_reduce_(deg[:n_nodes].contiguous(), group)


class NodeBlocks:
    """Node-dim tensors split over a process group: the N nodes padded to
    a multiple of the group's size W, rank r holding rows ``[r nb, (r +
    1) nb)``, ``nb = ceil(N / W)`` (padding rows are zero and count in no
    loss).  ``block`` takes the rank's rows of a whole (replicated)
    tensor, ``whole`` gathers the blocks back (differentiable: its
    gradient a reduce-scatter), ``scatter`` sums every rank's partial
    whole-graph result and keeps the rank's block (its gradient an
    all-gather)."""

    def __init__(self, n: int, group):
        self.n, self.group = n, group
        w = dist.get_world_size(group)
        self.nb = -(-n // w)
        self.lo = dist.get_rank(group) * self.nb

    def _pad(self, x):
        extra = self.nb * dist.get_world_size(self.group) - x.shape[0]
        if not extra:
            return x
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    def block(self, x):
        return self._pad(x)[self.lo:self.lo + self.nb]

    def valid(self, device) -> torch.Tensor:
        """Which of the block's rows are nodes (not padding)."""
        return self.lo + torch.arange(self.nb, device=device) < self.n

    def whole(self, xb):
        return all_gather(xb.contiguous(), 0, self.group)[:self.n]

    def scatter(self, x):
        return reduce_scatter(self._pad(x).contiguous(), 0, self.group)
