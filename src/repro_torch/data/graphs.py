"""Synthetic graph datasets shaped like the assigned GNN cells (the port
of ``repro.data.graphs``; numpy, bit-equal to the reference)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device


def synth_cora_like(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7,
                    seed=0):
    """Citation-style graph: homophilous labels, sparse binary features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # homophilous edges: 70% same-class endpoints
    src = rng.integers(0, n_nodes, n_edges)
    dst = np.empty(n_edges, np.int64)
    same = rng.random(n_edges) < 0.7
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    for i in range(n_edges):
        if same[i] and len(by_class[labels[src[i]]]) > 0:
            dst[i] = rng.choice(by_class[labels[src[i]]])
        else:
            dst[i] = rng.integers(0, n_nodes)
    x = (rng.random((n_nodes, d_feat)) < 0.015).astype(np.float32)
    # class-correlated feature block
    for c in range(n_classes):
        cols = slice(c * 10, c * 10 + 10)
        x[labels == c, cols] += (
            rng.random((int((labels == c).sum()), 10)) < 0.3)
    return {
        "x": x, "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32), "labels": labels,
    }


def synth_products_like(n_nodes=100_000, avg_degree=25, d_feat=100,
                        n_classes=47, seed=0):
    """Power-law co-purchase-style graph (scaled-down ogbn-products)."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    pop = (rng.pareto(1.2, n_nodes) + 1)
    p = pop / pop.sum()
    src = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    dst = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    x = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    x += np.eye(n_classes, d_feat, dtype=np.float32)[labels] * 2.0
    return {"x": x, "edge_src": src, "edge_dst": dst, "labels": labels}


def graph_to_device(g: dict, device=None) -> dict:
    """A graph dict as tensors on ``device`` (None means the card); plain
    Python numbers (``n_graphs``) stay as they are."""
    device = resolve_device(device)
    return {k: v if isinstance(v, int) else torch.as_tensor(v, device=device)
            for k, v in g.items()}
