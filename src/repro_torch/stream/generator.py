"""Synthetic streaming-graph generators + query generation (paper §6.1-6.2).

A copy of ``repro.stream.generator``'s generators (the same seeds give the
same streams); the disorder / multi-source delivery models belong to the
ingest slice of the port.

Two stream families mirror the paper's datasets:

* ``synth_traffic_stream``  — CAIDA-like network traffic: a single vertex
  label ("IP"), heavy-tailed vertex popularity, edge labels drawn from a
  skewed "destination port" distribution (the paper's top-6 ports cover
  >50% of records).
* ``synth_social_stream``   — LSBench-like social stream: several vertex
  types (user, post, photo, gps) and predicate edge labels.

Query generation follows §6.2: a random walk over a prefix of the stream
induces the structure; the timing order is the *inherent* chronological
order of the walked edges restricted to walk order (``ε_i ≺ ε_j ⇔ i < j ∧
T(ε_i) < T(ε_j)``), which guarantees at least one embedding exists that
satisfies both structure and timing constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.oracle import DataEdge
from repro_torch.core.query import QueryGraph


@dataclass
class StreamConfig:
    n_edges: int = 10_000
    n_vertices: int = 500
    n_vertex_labels: int = 1
    n_edge_labels: int = 8
    zipf_a: float = 1.3          # vertex-popularity skew
    ts_step_max: int = 3         # timestamps advance by U{0..step_max}
    seed: int = 0


def _zipf_choice(rng: np.random.Generator, n: int, size: int, a: float):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def synth_traffic_stream(cfg: StreamConfig) -> list[DataEdge]:
    """CAIDA-like: one vertex label, skewed ports as edge labels."""
    rng = np.random.default_rng(cfg.seed)
    src = _zipf_choice(rng, cfg.n_vertices, cfg.n_edges, cfg.zipf_a)
    dst = _zipf_choice(rng, cfg.n_vertices, cfg.n_edges, cfg.zipf_a)
    # skewed destination-port labels (top ports dominate, cf. §6.1)
    el = _zipf_choice(rng, cfg.n_edge_labels, cfg.n_edges, 1.8)
    ts = np.cumsum(rng.integers(0, cfg.ts_step_max + 1, cfg.n_edges))
    vl = rng.integers(0, cfg.n_vertex_labels, cfg.n_vertices)
    out = []
    for i in range(cfg.n_edges):
        if src[i] == dst[i]:
            dst[i] = (dst[i] + 1) % cfg.n_vertices
        out.append(
            DataEdge(
                int(src[i]), int(dst[i]), int(ts[i]),
                int(vl[src[i]]), int(vl[dst[i]]), int(el[i]),
            )
        )
    return out


def synth_social_stream(cfg: StreamConfig) -> list[DataEdge]:
    """LSBench-like: typed vertices (user/post/photo/gps), predicate labels."""
    cfg2 = StreamConfig(**{**cfg.__dict__, "n_vertex_labels": max(4, cfg.n_vertex_labels)})
    return synth_traffic_stream(cfg2)


# --------------------------------------------------------------------- #
def random_walk_query(
    stream: list[DataEdge],
    n_query_edges: int,
    seed: int = 0,
    window: int | None = None,
) -> QueryGraph | None:
    """§6.2 query generation: random walk + inherent-timestamp timing order.

    Walks edge-adjacent edges within (optionally) one window span, then
    relabels walked data vertices as query vertices.  Returns None when
    the walk cannot reach the requested length from the sampled start.
    """
    rng = np.random.default_rng(seed)
    if window is not None:
        t0 = stream[rng.integers(0, max(1, len(stream) - 1))].ts
        pool = [e for e in stream if t0 <= e.ts < t0 + window]
    else:
        pool = list(stream)
    if not pool:
        return None
    # adjacency over pool edges (shared endpoint)
    start = pool[rng.integers(0, len(pool))]
    walked: list[DataEdge] = [start]
    touched = {start.src, start.dst}
    used = {(start.src, start.dst, start.ts)}
    for _ in range(n_query_edges - 1):
        cands = [
            e for e in pool
            if (e.src in touched or e.dst in touched)
            and (e.src, e.dst, e.ts) not in used
            and (e.src, e.dst) not in {(w.src, w.dst) for w in walked}
            and e.src != e.dst
        ]
        if not cands:
            return None
        e = cands[rng.integers(0, len(cands))]
        walked.append(e)
        touched |= {e.src, e.dst}
        used.add((e.src, e.dst, e.ts))
    # relabel data vertices -> query vertices
    vmap: dict[int, int] = {}
    vlabels: list[int] = []
    qedges: list[tuple[int, int]] = []
    elabels: list[int] = []
    for e in walked:
        for dv, lbl in ((e.src, e.src_label), (e.dst, e.dst_label)):
            if dv not in vmap:
                vmap[dv] = len(vlabels)
                vlabels.append(lbl)
        qedges.append((vmap[e.src], vmap[e.dst]))
        elabels.append(e.edge_label)
    prec = frozenset(
        (i, j)
        for i in range(len(walked))
        for j in range(len(walked))
        if i < j and walked[i].ts < walked[j].ts
    )
    return QueryGraph(
        n_vertices=len(vlabels),
        vertex_labels=tuple(vlabels),
        edges=tuple(qedges),
        edge_labels=tuple(elabels),
        prec=prec,
    )


# --------------------------------------------------------------------- #
def to_batches(stream: list[DataEdge], batch_size: int):
    """Chop a DataEdge list into padded EdgeBatch-ready dicts."""
    out = []
    for i in range(0, len(stream), batch_size):
        chunk = stream[i : i + batch_size]
        pad = batch_size - len(chunk)
        get = lambda f: np.array(
            [getattr(e, f) for e in chunk] + [0] * pad, np.int32)
        out.append(
            dict(
                src=get("src"), dst=get("dst"), ts=get("ts"),
                src_label=get("src_label"), dst_label=get("dst_label"),
                edge_label=get("edge_label"),
                valid=np.array([True] * len(chunk) + [False] * pad),
            )
        )
    return out
