"""Message-passing primitives over (edge_src, edge_dst) index arrays: the
port of ``repro.models.gnn.message``.

Edges with src or dst < 0 are padding and contribute nothing.  Sum and
mean go through the segment_sum kernel; max/min, ``segment_softmax`` and
``degrees`` are plain torch, as the reference's are plain JAX.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import ops as sr


def gather_scatter(x, edge_src, edge_dst, n_nodes: int,
                   transform=None, reduce: str = "sum",
                   backend: str | None = None):
    """out[dst] = reduce over edges of transform(x[src])."""
    src_ok = edge_src >= 0
    msg = x[edge_src.clamp(min=0).long()]
    msg.masked_fill_(~src_ok[:, None], 0)       # msg is a fresh gather
    if transform is not None:
        msg = transform(msg)
    dst = torch.where(src_ok & (edge_dst >= 0), edge_dst, -1)
    if reduce == "sum":
        return sr.segment_sum(dst, msg, n_nodes, backend)
    if reduce == "mean":
        return sr.segment_mean(dst, msg, n_nodes, backend)
    if reduce in ("max", "min"):
        seg = torch.where(dst < 0, n_nodes, dst).long()
        fill = float("-inf") if reduce == "max" else float("inf")
        out = torch.full((n_nodes + 1, msg.shape[1]), fill, dtype=msg.dtype,
                         device=msg.device)
        out.scatter_reduce_(0, seg[:, None].expand_as(msg), msg,
                            "amax" if reduce == "max" else "amin")
        out = out[:n_nodes]
        return torch.where(torch.isfinite(out), out, 0)
    raise ValueError(reduce)


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


def degrees(edge_dst, n_nodes: int):
    """In-degree per node (float32 [n_nodes]); dst < 0 is padding."""
    dst = torch.where(edge_dst >= 0, edge_dst, n_nodes).long()
    deg = torch.zeros((n_nodes + 1,), dtype=torch.float32,
                      device=edge_dst.device)
    deg.index_add_(0, dst, torch.ones_like(dst, dtype=torch.float32))
    return deg[:n_nodes]
