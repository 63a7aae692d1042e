"""The plain torch version of the segment_sum kernel.

The wrapper in ``ops`` takes it for CPU tensors and for the REF backend;
on the card only the tests and ``chip_smoke.py`` call it.  Semantics of
``repro.kernels.segment_reduce``: ``out[n] = sum of msg[e] over dst[e]
== n``, cast back to the message dtype; ids outside [0, N) are dropped.
``segment_mean`` divides by the segment's count, as the reference's
plain version does.

It accumulates in float64, so that it can hold the kernel's float32 sums
to account: ``index_add_``'s float32 atomics add a hub's terms one by one
into one running sum, and once that sum is large they lose its small
terms (at the ogbn-products shape's 3.58 M-edge hub a bf16 sum came out
a whole bf16 ulp off, where the kernel's tiled float32 sums round to the
float64 sum's value).
"""

from __future__ import annotations

import torch

# messages converted to float64 at a time: a float64 copy of a whole
# [E, D] bf16 message would be four times its bytes (GAT's second layer
# at the ogbn-products shape: 46 GB of bf16)
CHUNK_ELEMS = 1 << 27


def segment_sum(dst, msg, n_nodes: int):
    """dst int [E], msg [E, D] -> [n_nodes, D] in msg's dtype."""
    seg = torch.where((dst >= 0) & (dst < n_nodes), dst, n_nodes).long()
    out = torch.zeros((n_nodes + 1, msg.shape[1]), dtype=torch.float64,
                      device=msg.device)
    rows = max(1, CHUNK_ELEMS // max(1, msg.shape[1]))
    for lo in range(0, msg.shape[0], rows):
        out.index_add_(0, seg[lo:lo + rows], msg[lo:lo + rows].double())
    return out[:n_nodes].to(msg.dtype)


def segment_mean(dst, msg, n_nodes: int, eps: float = 1e-9):
    """The segment sum over each segment's message count (at least
    ``eps``) -> [n_nodes, D] in msg's dtype."""
    s = segment_sum(dst, msg, n_nodes)
    cnt = segment_sum(dst, msg.new_ones((msg.shape[0], 1)), n_nodes)
    return s / cnt.clamp(min=eps)
