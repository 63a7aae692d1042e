"""The plain reference: every match of a timing-constrained pattern over
a stream, with the tick that reports it.

A match (Definitions 4 and 13 of Li, Zou, Özsu, Zhao, ICDE 2019) binds
each pattern vertex to a distinct data vertex and each pattern edge to a
stream edge with the same endpoints, vertex labels and edge label (a
pattern edge label of None takes any label); an edge ``i`` before ``j``
has a strictly smaller timestamp; and the newest and oldest of its edges
lie less than the window apart.  A service fed the stream in ticks of
``batch`` edges reports a match in the tick of its last stream position.

The search is a chain of sort-merge joins in numpy: the edges that
match the first pattern edge, then, one pattern edge at a time, the
stream edges on an already bound vertex whose timestamp lies in the
range that the timing order and the window leave, then the endpoint and
injectivity tests.  It reads only the stream's columns and the
patterns' labels, order and windows.
"""

from __future__ import annotations

import numpy as np


def _order(edges: list) -> list:
    """Pattern edges in an order in which each one after the first
    shares a vertex with those before it."""
    order, bound = [0], set(edges[0][:2])
    while len(order) < len(edges):
        for j, (u, v, _) in enumerate(edges):
            if j not in order and (u in bound or v in bound):
                order.append(j)
                bound |= {u, v}
                break
        else:
            raise ValueError("the pattern is not connected")
    return order


def _candidates(cols: dict, n: int, lab: dict, edge) -> np.ndarray:
    u, v, el = edge
    ok = (cols["src_label"][:n] == lab[u]) & (cols["dst_label"][:n] == lab[v])
    if el is not None:
        ok &= cols["edge_label"][:n] == el
    ok &= cols["src"][:n] != cols["dst"][:n]
    return np.flatnonzero(ok)


def pattern_matches(cols: dict, n: int, batch: int, spec: dict,
                    ticks=None) -> np.ndarray:
    """Every match of ``spec`` over stream positions ``[0, n)``, as int64
    rows ``[tick, vertex ids in authoring order..., edge timestamps in
    authoring order...]``, sorted.  ``ticks`` (a set) keeps only the
    matches reported in those ticks.

    ``spec``: ``vertices`` [[name, label], ...], ``edges`` [[src name,
    dst name, label or None], ...], ``before`` [[i, j], ...] (edge i
    strictly before edge j), ``window``."""
    lab = {name: int(label) for name, label in spec["vertices"]}
    edges = [tuple(e) for e in spec["edges"]]
    before = {tuple(p) for p in spec["before"]}
    window = int(spec["window"])
    ts_all = cols["ts"][:n].astype(np.int64)
    t_mod = int(ts_all[-1]) + 2 if n else 2

    order = _order(edges)
    j0 = order[0]
    rows = _candidates(cols, n, lab, edges[j0])
    pos = {j0: rows}                           # pattern edge -> positions
    u0, v0, _ = edges[j0]
    bind = {u0: cols["src"][rows].astype(np.int64),
            v0: cols["dst"][rows].astype(np.int64)}
    mn = ts_all[rows]
    mx = mn.copy()
    for j in order[1:]:
        u, v, _ = edges[j]
        cand = _candidates(cols, n, lab, edges[j])
        key_end = "src" if u in bind else "dst"
        key_v = u if u in bind else v
        ckey = cols[key_end][cand].astype(np.int64) * t_mod + ts_all[cand]
        srt = np.argsort(ckey, kind="stable")
        cand, ckey = cand[srt], ckey[srt]
        # the timestamps this edge may take: the window, then the order
        lo = mx - window + 1
        hi = mn + window - 1
        for i, prev in pos.items():
            if (i, j) in before:
                lo = np.maximum(lo, ts_all[prev] + 1)
            if (j, i) in before:
                hi = np.minimum(hi, ts_all[prev] - 1)
        base = bind[key_v] * t_mod
        a = np.searchsorted(ckey, base + np.maximum(lo, 0), "left")
        b = np.searchsorted(ckey, base + np.minimum(hi, t_mod - 1), "right")
        cnt = np.where(hi >= lo, np.maximum(b - a, 0), 0)
        parent = np.repeat(np.arange(cnt.size), cnt)
        start = np.repeat(a - np.cumsum(cnt) + cnt, cnt)
        new = cand[start + np.arange(parent.size)]
        keep = np.ones(parent.size, bool)
        for end, name in ((cols["src"], u), (cols["dst"], v)):
            got = end[new].astype(np.int64)
            if name in bind:
                keep &= bind[name][parent] == got
            else:
                for other in bind.values():
                    keep &= other[parent] != got
        parent, new = parent[keep], new[keep]
        pos = {i: p[parent] for i, p in pos.items()}
        pos[j] = new
        bind = {k: x[parent] for k, x in bind.items()}
        for name, end in ((u, "src"), (v, "dst")):
            if name not in bind:
                bind[name] = cols[end][new].astype(np.int64)
        mn = np.minimum(mn[parent], ts_all[new])
        mx = np.maximum(mx[parent], ts_all[new])

    tick = np.max(np.stack([pos[j] for j in range(len(edges))]), axis=0) \
        // batch
    out = np.stack([tick]
                   + [bind[name] for name, _ in spec["vertices"]]
                   + [ts_all[pos[j]] for j in range(len(edges))], axis=1)
    if ticks is not None:
        out = out[np.isin(out[:, 0], np.fromiter(ticks, np.int64))]
    return out[np.lexsort(out.T[::-1])] if len(out) else out
