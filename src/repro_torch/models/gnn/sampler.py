"""Uniform neighbor sampler (GraphSAGE-style) for minibatch GNN
inference and training: the port of ``repro.models.gnn.sampler``, the
same numpy code (the port imports nothing of ``repro``).

Host-side numpy over a CSR adjacency; produces fixed-shape padded
subgraph arrays, so every minibatch has one shape.  This is the data
path for the ``minibatch_lg`` shape (232k nodes / 114M edges with
batch=1024, fanout 15-10).  For the same ``np.random.Generator`` state
the output is the reference's, bit for bit.
"""

from __future__ import annotations

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, edge_src, edge_dst):
        order = np.argsort(edge_dst, kind="stable")
        self.dst_sorted_src = np.asarray(edge_src)[order]
        counts = np.bincount(np.asarray(edge_dst), minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def in_neighbors(self, v: int):
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.dst_sorted_src[lo:hi]


def sample_subgraph(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
):
    """k-hop uniform sampling.  Returns a padded merged subgraph:

    nodes      int32 [N_max]  original ids (-1 padding); seeds first
    edge_src   int32 [E_max]  indices into `nodes` (-1 padding)
    edge_dst   int32 [E_max]
    n_seeds    int
    with N_max = sum of frontier sizes, E_max = sum of seeds*fanout terms.
    """
    node_index: dict[int, int] = {}
    nodes: list[int] = []

    def local(v: int) -> int:
        if v not in node_index:
            node_index[v] = len(nodes)
            nodes.append(v)
        return node_index[v]

    for sd in seeds:
        local(int(sd))

    e_src: list[int] = []
    e_dst: list[int] = []
    frontier = [int(s) for s in seeds]
    n_max, e_max = subgraph_shapes(len(seeds), tuple(fanouts))

    for f in fanouts:
        nxt: list[int] = []
        for v in frontier:
            nbrs = g.in_neighbors(v)
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(f, len(nbrs)), replace=False)
            for u in take:
                e_src.append(local(int(u)))
                e_dst.append(node_index[v])
                nxt.append(int(u))
        frontier = nxt

    def pad(a, n, fill=-1):
        out = np.full((n,), fill, np.int32)
        out[: len(a)] = a
        return out

    return {
        "nodes": pad(nodes, n_max),
        "edge_src": pad(e_src, e_max),
        "edge_dst": pad(e_dst, e_max),
        "n_seeds": len(seeds),
    }


def subgraph_shapes(batch_nodes: int, fanouts: tuple[int, ...]):
    """Static (N_max, E_max) for a given sampling config."""
    n_max = batch_nodes
    e_max = 0
    level = batch_nodes
    for f in fanouts:
        e_max += level * f
        level *= f
        n_max += level
    return n_max, e_max
