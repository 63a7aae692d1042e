"""Message-passing primitives over (edge_src, edge_dst) index arrays: the
port of ``repro.models.gnn.message``.

Edges with src or dst < 0 are padding and contribute nothing.  Sum and
mean go through the segment_sum kernel, and so does the gradient of the
gather ``x[src]`` (``gather_rows``); max/min (``segment_extreme``),
``segment_softmax``, ``degrees`` and the per-graph pooling
(``pool_graphs``) are plain torch, as the reference's are plain JAX.
"""

from __future__ import annotations

import torch

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


def gather_scatter(x, edge_src, edge_dst, n_nodes: int,
                   transform=None, reduce: str = "sum",
                   backend: str | None = None):
    """out[dst] = reduce over edges of transform(x[src])."""
    src_ok = edge_src >= 0
    msg = gather_rows(x, edge_src, backend)   # padding dropped by dst below
    if transform is not None:
        msg = transform(msg)
    dst = torch.where(src_ok & (edge_dst >= 0), edge_dst, -1)
    if reduce == "sum":
        return sr.segment_sum(dst, msg, n_nodes, backend)
    if reduce == "mean":
        return sr.segment_mean(dst, msg, n_nodes, backend)
    if reduce in ("max", "min"):
        return segment_extreme(dst, msg, n_nodes, reduce)
    raise ValueError(reduce)


def segment_extreme(dst, msg, n_nodes: int, reduce: str):
    """The reference's ``jax.ops.segment_max``/``segment_min`` (``reduce``
    "max"/"min") over dst (< 0 = padding), plain ``scatter_reduce_``;
    a segment with no edge gives 0."""
    seg = torch.where(dst < 0, n_nodes, dst).long()
    fill = float("-inf") if reduce == "max" else float("inf")
    out = torch.full((n_nodes + 1, msg.shape[1]), fill, dtype=msg.dtype,
                     device=msg.device)
    out.scatter_reduce_(0, seg[:, None].expand_as(msg), msg,
                        "amax" if reduce == "max" else "amin")
    out = out[:n_nodes]
    return torch.where(torch.isfinite(out), out, 0)


def segment_softmax(scores, seg, n_segments: int):
    """Numerically-stable softmax of ``scores`` grouped by ``seg``.

    scores [E, H]; seg int [E] (-1 = padding -> weight 0).
    """
    seg_safe = torch.where(seg < 0, n_segments, seg).long()
    mx = torch.full((n_segments + 1, scores.shape[1]), float("-inf"),
                    dtype=scores.dtype, device=scores.device)
    mx.scatter_reduce_(0, seg_safe[:, None].expand_as(scores), scores,
                       "amax")
    mx = torch.where(torch.isfinite(mx), mx, 0)
    ex = torch.exp(scores - mx[seg_safe])
    ex = torch.where((seg >= 0)[:, None], ex, 0)
    den = torch.zeros_like(mx).index_add_(0, seg_safe, ex)
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


def degrees(edge_dst, n_nodes: int):
    """In-degree per node (float32 [n_nodes]); dst < 0 is padding."""
    dst = torch.where(edge_dst >= 0, edge_dst, n_nodes).long()
    deg = torch.zeros((n_nodes + 1,), dtype=torch.float32,
                      device=edge_dst.device)
    deg.index_add_(0, dst, torch.ones_like(dst, dtype=torch.float32))
    return deg[:n_nodes]
