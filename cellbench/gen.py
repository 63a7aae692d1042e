"""The benchmark's stream generator: a vectorised copy of the port's
``synth_traffic_stream`` / ``synth_social_stream``.

It draws the same distributions from one ``numpy`` generator in the
same order as ``repro_torch.stream.generator`` (source and destination
ranks by zipf popularity, zipf(1.8) edge labels, timestamp steps
U{0..ts_step_max}, uniform vertex labels, a self-loop moved one vertex
on), so a seed gives the port's stream edge for edge, without the
per-edge Python loop.  The stream is kept as int32 columns; ``edges``
turns a slice of it into the ``DataEdge`` records that
``StreamSession.serve`` takes.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ("src", "dst", "ts", "src_label", "dst_label", "edge_label")


def _zipf_choice(rng: np.random.Generator, n: int, size: int, a: float):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def stream_columns(n_edges: int, seed: int, *, n_vertices: int,
                   n_vertex_labels: int, n_edge_labels: int,
                   zipf_a: float = 1.3, ts_step_max: int = 3,
                   social: bool = False, label_seed: int | None = None
                   ) -> dict:
    """The stream of ``synth_traffic_stream`` (``social``:
    ``synth_social_stream``, at least 4 vertex types) for these settings,
    as int32 columns keyed by ``COLUMNS``.

    ``label_seed`` set draws the vertex labels, uniformly as the port's
    generator does, from a generator of their own with that seed, so
    that every ``seed`` replays its own stream over one population of
    labelled vertices; the other columns are the port's for ``seed``."""
    if social:
        n_vertex_labels = max(4, n_vertex_labels)
    rng = np.random.default_rng(seed)
    src = _zipf_choice(rng, n_vertices, n_edges, zipf_a)
    dst = _zipf_choice(rng, n_vertices, n_edges, zipf_a)
    el = _zipf_choice(rng, n_edge_labels, n_edges, 1.8)
    ts = np.cumsum(rng.integers(0, ts_step_max + 1, n_edges))
    vl = (rng if label_seed is None else np.random.default_rng(label_seed)
          ).integers(0, n_vertex_labels, n_vertices)
    loop = src == dst
    dst[loop] = (dst[loop] + 1) % n_vertices
    if ts.size and ts[-1] >= 2**31 - 1:
        raise ValueError(f"{n_edges} edges run the int32 timestamps over")
    cols = dict(src=src, dst=dst, ts=ts, src_label=vl[src],
                dst_label=vl[dst], edge_label=el)
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in cols.items()}


def edges(cols: dict, lo: int = 0, hi: int | None = None) -> list:
    """``DataEdge`` records of stream positions ``[lo, hi)``."""
    from repro_torch.core.oracle import DataEdge

    new = object.__new__

    def edge(*values):
        # the frozen dataclass's fields, without its __init__'s checks
        e = new(DataEdge)
        e.__dict__.update(zip(COLUMNS, values))
        return e

    return list(map(edge, *(cols[k][lo:hi].tolist() for k in COLUMNS)))
