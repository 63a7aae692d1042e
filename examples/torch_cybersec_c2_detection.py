"""The paper's Figure-1 scenario: detect an information-exfiltration
attack pattern (victim -> compromised site -> malware download -> C&C
registration -> command -> exfiltration) in network traffic, where the
five steps must occur in strict timing order t1 < ... < t5.

We synthesize background traffic, plant attack instances, and serve the
pattern as a continuous query through the StreamServer (with adaptive
tick coalescing + checkpointing). Every planted attack must be found.

The twin of ``examples/cybersec_c2_detection.py`` on ``repro_torch``:
the same traffic, planted attacks, query and server; the joins run on
the card's compat-join kernel (the plain version with ``--device cpu``).

    PYTHONPATH=src python examples/torch_cybersec_c2_detection.py
    PYTHONPATH=src python examples/torch_cybersec_c2_detection.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core.oracle import DataEdge
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.launch.stream_serve import StreamServer
from repro_torch.stream.generator import StreamConfig, synth_traffic_stream

# vertex labels: 0=victim IP, 1=web server, 2=malware host, 3=C&C server
VICTIM, WEB, MAL, CC = 0, 1, 2, 3
# edge labels (ports/protocols): 0=http, 1=download, 2=register, 3=cmd, 4=exfil
HTTP, DL, REG, CMD, EXFIL = 0, 1, 2, 3, 4


def attack_query() -> QueryGraph:
    """v -(http)-> w; m -(dl)-> v; v -(reg)-> c; c -(cmd)-> v;
    v -(exfil)-> c2, with timing chain e0 ≺ e1 ≺ e2 ≺ e3 ≺ e4 (Figure 1).

    Exfiltration targets a separate collector vertex carrying the C&C
    label (C&C infra uses distinct ingest hosts; also keeps the query a
    simple graph — no duplicate (v, c) edge)."""
    return QueryGraph(
        n_vertices=5,
        vertex_labels=(VICTIM, WEB, MAL, CC, CC),
        edges=((0, 1), (2, 0), (0, 3), (3, 0), (0, 4)),
        edge_labels=(HTTP, DL, REG, CMD, EXFIL),
        prec=frozenset({(0, 1), (1, 2), (2, 3), (3, 4)}),
    )


def plant_attacks(stream, n_attacks, n_vertices, rng):
    """Insert attack chains with correct timing into background traffic."""
    out = list(stream)
    span = out[-1].ts
    planted = []
    for a in range(n_attacks):
        v, w, m, c, c2 = rng.choice(n_vertices, 5, replace=False) + n_vertices
        t0 = int(rng.integers(10, span - 40))
        steps = [
            DataEdge(int(v), int(w), t0, VICTIM, WEB, HTTP),
            DataEdge(int(m), int(v), t0 + 3, MAL, VICTIM, DL),
            DataEdge(int(v), int(c), t0 + 7, VICTIM, CC, REG),
            DataEdge(int(c), int(v), t0 + 11, CC, VICTIM, CMD),
            DataEdge(int(v), int(c2), t0 + 15, VICTIM, CC, EXFIL),
        ]
        out.extend(steps)
        planted.append(steps)
    out.sort(key=lambda e: e.ts)
    return out, planted


def main(argv=None):
    """Runs the example; returns the reported total and every reported
    match as (bindings, edge timestamps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    background = synth_traffic_stream(StreamConfig(
        n_edges=8000, n_vertices=200, n_vertex_labels=4, n_edge_labels=5,
        seed=3, ts_step_max=1))
    stream, planted = plant_attacks(background, n_attacks=12,
                                    n_vertices=200, rng=rng)

    q = attack_query()
    plan = compile_plan(q, window=60, level_capacity=16384,
                        l0_capacity=16384, max_new=4096)
    print(f"attack pattern: {q.n_edges} edges, "
          f"{len(plan.subqueries)} TC-subquery(ies) "
          f"(a pure ≺-chain compiles to a single expansion list)")

    hits = []
    server = StreamServer(plan, device=args.device)
    total = server.ingest(
        stream, on_match=lambda b, t: hits.append((b.copy(), t.copy())))
    # StreamServer routes through repro_torch.api: the typed handle is one
    # property away (overflow status, named bindings via .matches())
    sub = server.subscription
    print(f"{len(stream)} packets scanned, {total} attack instances found "
          f"(subscription {sub.status}, overflow={sub.n_overflow})")
    assert total >= 12, "planted attacks missed!"
    # verify a reported match is a real planted chain
    found_ts = {tuple(int(x) for x in t) for _, ts in hits for t in ts}
    planted_ts = {tuple(e.ts for e in steps) for steps in planted}
    assert planted_ts <= found_ts, "planted timing chains not all reported"
    print("all planted C&C chains detected, timing order verified")
    return {"total": total,
            "rows": [(tuple(b), tuple(t)) for bind, ts in hits
                     for b, t in zip(np.asarray(bind).tolist(),
                                     np.asarray(ts).tolist())]}


if __name__ == "__main__":
    main()
