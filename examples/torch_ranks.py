"""Capacity-sharded continuous search across processes, one rank a device.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        examples/torch_ranks.py [--device cpu] [--edges 480]

Every rank holds ``C/N`` rows of each table of one engine (a timed
two-chain over a seeded traffic stream) and ticks its own shard; the L0
joins' deltas and the tick's scalar stats cross the ranks through the
process group's collectives.  On the card the group is NCCL, each rank on
``cuda:LOCAL_RANK``; ``--device cpu`` runs gloo on the CPU.  Rank 0 also
runs the unsharded engine and checks, tick by tick, that the ranks'
matches are its matches; it prints ``RANKS-OK`` and the totals.
"""

import argparse
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core.distributed import (  # noqa: E402
    build_sharded_tick,
    make_mesh,
)
from repro_torch.core.engine import build_tick  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.query import QueryGraph  # noqa: E402
from repro_torch.core.state import init_state, make_batch  # noqa: E402
from repro_torch.stream.generator import (  # noqa: E402
    StreamConfig,
    synth_traffic_stream,
    to_batches,
)


def rows(res) -> Counter:
    bind, ets, valid = (x.cpu() for x in (
        res.match_bindings, res.match_ets, res.match_valid))
    return Counter(tuple(b.tolist()) + tuple(e.tolist())
                   for b, e in zip(bind[valid], ets[valid]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--edges", type=int, default=480)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()

    local = int(os.environ.get("LOCAL_RANK", 0))
    if args.device == "cuda":
        torch.cuda.set_device(local)
        device, backend = torch.device("cuda", local), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend)
    rank, world = dist.get_rank(), dist.get_world_size()

    # a timed two-chain from one vertex: two TC-subqueries joined in L0
    query = QueryGraph(5, (0, 0, 1, 0, 1), ((0, 1), (1, 2), (0, 3), (3, 4)),
                       prec=frozenset({(0, 1), (2, 3)}))
    plan = compile_plan(query, 35, level_capacity=1024 * world,
                        l0_capacity=1024 * world, max_new=256)
    stream = synth_traffic_stream(StreamConfig(
        n_edges=args.edges, n_vertices=12, n_vertex_labels=3,
        n_edge_labels=2, seed=5, ts_step_max=2))
    batches = [make_batch(**b, device=device)
               for b in to_batches(stream, args.batch)]

    devices = [torch.device("cuda", i) if args.device == "cuda" else device
               for i in range(world)]
    mesh = make_mesh((world,), ("data",), devices=devices,
                     group=dist.group.WORLD)
    tick, state = build_sharded_tick(plan, mesh, extract_matches=True)
    if rank == 0:
        one = build_tick(plan, extract_matches=True, device=device)
        whole = init_state(plan, device=device)
    total = 0
    for t, batch in enumerate(batches):
        state, res = tick(state, batch)
        parts = [None] * world
        dist.all_gather_object(parts, rows(res))
        if rank == 0:
            whole, want = one(whole, batch)
            got = sum(parts, Counter())
            if int(res.n_new_matches) != int(want.n_new_matches) \
                    or got != rows(want):
                print(f"tick {t}: the ranks' matches differ from the "
                      "unsharded engine's", flush=True)
                return 1
            total += int(res.n_new_matches)
    overflow = int(state.stats.n_overflow)
    dist.destroy_process_group()
    if rank == 0:
        if overflow or not total:
            print(f"overflow {overflow}, matches {total}", flush=True)
            return 1
        print(f"RANKS-OK world={world} backend={backend} ticks="
              f"{len(batches)} matches={total} rows_a_rank="
              f"{plan.subqueries[0].levels[0].capacity // world}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
