"""The plain torch versions of the segment_sum kernel.

The wrapper in ``ops`` takes ``segment_sum`` for CPU tensors and for the
REF backend; on the card only the tests and ``chip_smoke.py`` call this
module.  Semantics of ``repro.kernels.segment_reduce``: ``out[n] = sum of
msg[e] over dst[e] == n``, cast back to the message dtype; ids outside
[0, N) are dropped.  ``segment_mean`` divides by the segment's count, as
the reference's plain version does.

``segment_sum`` accumulates in float64, so that it can hold the kernel's
float32 sums to account: float32 atomics (``index_add_``) add a hub's
terms one by one into one running sum, and once that sum is large they
lose its small terms (at the ogbn-products shape's 3.58 M-edge hub a
bf16 sum came out a whole bf16 ulp off).

``segment_sum_ordered`` is the kernel's own order in plain torch, so
that the kernel's bits can be held to it: node n's edges (dst[e] == n)
are taken in ascending e and cut into runs of ``RUN`` consecutive edges
(the last run may be shorter).  Each run is summed left to right in
float32 from +0; the node's sum is its run sums added left to right in
float32 from +0, rounded once to the message dtype.  The same words
stand in the CUDA source's header (``csrc/segment_reduce.cu``).
"""

from __future__ import annotations

import torch

# messages converted to float64 at a time: a float64 copy of a whole
# [E, D] bf16 message would be four times its bytes (GAT's second layer
# at the ogbn-products shape: 46 GB of bf16)
CHUNK_ELEMS = 1 << 27
RUN = 1024      # edges a run of the kernel's order (SR_RUN in the source)


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


def segment_sum_ordered(dst, msg, n_nodes: int, run: int = RUN):
    """dst int [E], msg [E, D] -> [n_nodes, D] in msg's dtype, summed in
    float32 in the kernel's order (the module docstring).

    The runs are summed all at once, position by position: the edges are
    stably sorted by node, each run numbered (its runs ordered by length,
    longest first, so that position k of every run that reaches it is a
    prefix of the run sums) and step k adds the k-th edge of each run
    that long.  The run sums are then added per node in run order, node
    by node the same way.  Memory: two float32 arrays of [runs, D] and
    [n_nodes, D] beside msg, and gathers of at most ``CHUNK_ELEMS``
    values."""
    dev, d = msg.device, msg.shape[1]
    out = torch.zeros((n_nodes, d), dtype=torch.float32, device=dev)
    dst = dst.long()
    kept = torch.nonzero((dst >= 0) & (dst < n_nodes)).squeeze(1)
    if kept.numel() == 0:
        return out.to(msg.dtype)
    key, perm = torch.sort(dst[kept], stable=True)
    edges = kept[perm]                   # each node's edges, ascending
    cnt = torch.bincount(key, minlength=n_nodes)
    rank = torch.arange(key.numel(), device=dev) - (cnt.cumsum(0) - cnt)[key]
    n_runs = (cnt + run - 1) // run
    first_run = n_runs.cumsum(0) - n_runs
    run_of = first_run[key] + rank // run     # each edge's run
    pos = rank % run                          # and its place in it
    n_total = int(n_runs.sum())
    run_len = torch.bincount(run_of, minlength=n_total)
    by_len = torch.argsort(run_len, descending=True, stable=True)
    slot = torch.empty_like(by_len)
    slot[by_len] = torch.arange(n_total, device=dev)
    # the edges by (position in the run, the run's slot): step k's edges
    # are one block, their runs' slots 0, 1, ... in order
    order = torch.argsort(pos * n_total + slot[run_of], stable=True)
    edges, at = edges[order], torch.bincount(pos, minlength=run).tolist()
    sums = torch.zeros((n_total, d), dtype=torch.float32, device=dev)
    rows = max(1, CHUNK_ELEMS // max(1, d))
    lo = 0
    for k_count in at:
        for c in range(0, k_count, rows):
            step = edges[lo + c:lo + min(k_count, c + rows)]
            sums[c:c + step.numel()] += msg[step].float()
        lo += k_count
    # the run sums, node by node in run order
    nodes = torch.argsort(n_runs, descending=True, stable=True)
    # reach[v]: the nodes of at least v runs
    reach = torch.bincount(n_runs).flip(0).cumsum(0).flip(0).tolist()
    for j in range(len(reach) - 1):
        these = nodes[:reach[j + 1]]
        for c in range(0, these.numel(), rows):
            part = these[c:c + rows]
            out[part] += sums[slot[first_run[part] + j]]
    return out.to(msg.dtype)
