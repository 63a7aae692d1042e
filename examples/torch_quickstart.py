"""Quickstart of the PyTorch/CUDA port: register a timing-constrained
continuous query and stream edges through the engine.

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same
query, window, stream and batches; each tick's join runs on the card's
compat-join kernel (the plain version with ``--device cpu``).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

from repro_torch.core.engine import build_tick, current_matches
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.state import init_state, make_batch
from repro_torch.stream.generator import StreamConfig, synth_traffic_stream, \
    to_batches


def main(argv=None):
    """Runs the example; returns the reported total, every reported
    match row as (bindings, edge timestamps) and the live count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # Query: a -> b -> c where the first hop must precede the second
    # (vertex labels 0, 1, 2; timing order e0 ≺ e1).
    q = QueryGraph(
        n_vertices=3,
        vertex_labels=(0, 1, 2),
        edges=((0, 1), (1, 2)),
        prec=frozenset({(0, 1)}),
    )
    window = 30
    plan = compile_plan(q, window)
    print(f"query compiled: {len(plan.subqueries)} TC-subquery(ies), "
          f"decomposition sizes {plan.decomposition_sizes}")

    tick = build_tick(plan, device=args.device)
    state = init_state(plan, device=args.device)

    stream = synth_traffic_stream(StreamConfig(
        n_edges=2000, n_vertices=30, n_vertex_labels=3, n_edge_labels=2,
        seed=1))
    total, rows = 0, []
    for b in to_batches(stream, 64):
        state, res = tick(state, make_batch(**b, device=args.device))
        total += int(res.n_new_matches)
        valid = res.match_valid.cpu().numpy()
        rows += [(tuple(bind), tuple(ets)) for bind, ets in zip(
            res.match_bindings.cpu().numpy()[valid].tolist(),
            res.match_ets.cpu().numpy()[valid].tolist())]
    live = len(current_matches(plan, state))
    print(f"processed {len(stream)} edges, "
          f"reported {total} timing-constrained matches")
    print(f"matches live in the current window: {live}")
    assert total > 0
    return {"total": total, "rows": rows, "live": live}


if __name__ == "__main__":
    main()
