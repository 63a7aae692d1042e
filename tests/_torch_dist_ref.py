"""Subprocess helper of tests/test_torch_distributed.py: the reference's
capacity-sharded engine (``repro.core.distributed.build_sharded_tick``)
on 4 virtual CPU devices, recorded tick by tick for the port to be held
against.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_dist_ref.py OUT_DIR

Writes ``OUT_DIR/ref.npz``: for every case of ``CASES`` and shard count
n, every global state leaf and ``TickResult`` leaf after every tick
(``{case}|n{n}|t{tick}|s{leaf}`` / ``|r{leaf}``).  ``CKPT_CASE`` at
n = 4 also saves the reference's checkpoint of its 4-shard state after tick
``CKPT_TICK`` into ``OUT_DIR/jax_ckpt`` and restores the port's
checkpoint from ``OUT_DIR/port_ckpt`` (written by the test before this
runs) onto the 4-device mesh, recording that run as ``rev|n4|t..``.
The case definitions are shared with the test (this module imports no
JAX state until ``main``).
"""

import os
import sys

import numpy as np

from repro.core.query import QueryGraph
from repro.stream.generator import StreamConfig, synth_traffic_stream, \
    to_batches

CKPT_TICK = 6


def q_chain2():
    """``tests/_dist_engine_check.py``'s first query: a timed 2-edge
    chain (one subquery, level joins only)."""
    return QueryGraph(3, (0, 1, 0), ((0, 1), (1, 2)),
                      prec=frozenset({(0, 1)}))


def q_triangle():
    """Its second query: a triangle of two subqueries joined in L0."""
    return QueryGraph(3, (0, 0, 1), ((0, 1), (1, 2), (2, 0)),
                      prec=frozenset({(0, 2)}))


def q_chain3():
    """The serve phase's chain structure: a timed 3-edge chain."""
    return QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                      prec=frozenset({(0, 1), (1, 2)}))


def q_two_chain():
    """The serve phase's two-chain structure: two timed 2-edge chains
    from one vertex, joined in L0."""
    return QueryGraph(5, (0, 0, 1, 0, 1), ((0, 1), (1, 2), (0, 3), (3, 4)),
                      prec=frozenset({(0, 1), (2, 3)}))


DIST_STREAM = dict(n_edges=200, n_vertices=10, n_vertex_labels=2,
                   n_edge_labels=2, seed=11, ts_step_max=2)
SERVE_STREAM = dict(n_edges=480, n_vertices=12, n_vertex_labels=3,
                    n_edge_labels=2, seed=5, ts_step_max=2)
PREFIX_STREAM = dict(n_edges=160, n_vertices=8, n_vertex_labels=3,
                     n_edge_labels=2, seed=5, ts_step_max=2)
DIST_CAP = dict(level_capacity=2048, l0_capacity=2048, max_new=512)
SERVE_CAP = dict(level_capacity=1024, l0_capacity=1024, max_new=256)
PREFIX_CAP = dict(level_capacity=512, l0_capacity=512, max_new=256)

# name -> (query, window, capacities, stream, batch, shard counts,
#          prefix: None | "full" | "partial")
CASES = {
    "dist_chain2": (q_chain2, 20, DIST_CAP, DIST_STREAM, 16, (1, 2, 4),
                    None),
    "dist_triangle": (q_triangle, 20, DIST_CAP, DIST_STREAM, 16, (1, 2, 4),
                      None),
    "serve_chain3": (q_chain3, 35, SERVE_CAP, SERVE_STREAM, 32, (1, 2, 4),
                     None),
    "serve_two_chain": (q_two_chain, 35, SERVE_CAP, SERVE_STREAM, 32,
                        (1, 2, 4), None),
    # small tables: appends, joins and the match extraction overflow
    "overflow_two_chain": (q_two_chain, 35, dict(
        level_capacity=64, l0_capacity=64, max_new=16), SERVE_STREAM, 32,
        (2, 4), None),
    # _mesh_check.py's prefix lift: chain3 over a shared prefix view
    "prefix_full": (q_chain3, 50, PREFIX_CAP, PREFIX_STREAM, 16, (2, 4),
                    "full"),
    "prefix_partial": (q_chain3, 50, PREFIX_CAP, PREFIX_STREAM, 16, (2, 4),
                       "partial"),
    # a fully prefixed subquery 0 that feeds L0 joins (``a_repl``), with
    # small tables so that the replicated drops are counted
    "prefix_two_chain": (q_two_chain, 35, dict(
        level_capacity=128, l0_capacity=128, max_new=16), SERVE_STREAM, 32,
        (2, 4), "full"),
}
CKPT_CASE = "serve_chain3"      # the checkpoint round trips run it at n = 4


def batches(stream_cfg: dict, batch: int) -> list:
    return list(to_batches(synth_traffic_stream(StreamConfig(**stream_cfg)),
                           batch))


def key(case: str, n: int, tick: int, kind: str, i: int) -> str:
    return f"{case}|n{n}|t{tick}|{kind}{i}"


def main(out_dir: str) -> None:
    import jax

    from repro.checkpoint import restore_checkpoint, save_checkpoint
    from repro.core import compile_plan
    from repro.core.distributed import _state_specs, build_sharded_tick
    from repro.core.join import JoinBackend
    from repro.core.multi import SlotTickCache
    from repro.core.share import SharedPrefixForest
    from repro.core.state import make_batch

    assert len(jax.devices()) == 4, jax.devices()
    out = {}

    def record(case, n, tick, state, res):
        for kind, tree in (("s", state), ("r", res)):
            for i, x in enumerate(jax.tree.leaves(jax.device_get(tree))):
                out[key(case, n, tick, kind, i)] = np.asarray(x)

    for case, (query, window, cap, scfg, bsz, shards, prefix) in \
            CASES.items():
        plan = compile_plan(query(), window, **cap)
        bs = batches(scfg, bsz)
        for n in shards:
            mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
            forest = node = None
            depth = 0
            if prefix:
                forest = SharedPrefixForest(SlotTickCache(),
                                            backend=JoinBackend.REF,
                                            jit=True, donate=False)
                leaf = forest.acquire(plan, epoch=0)
                node = leaf if prefix == "full" else leaf.parent
                depth = node.depth
            tick, state = build_sharded_tick(
                plan, mesh, axes=("data",), extract_matches=True,
                prefix_depth=depth)
            for t, b in enumerate(bs):
                batch = make_batch(**b)
                if forest is None:
                    state, res = tick(state, batch)
                else:
                    views, _ = forest.advance(batch)
                    state, res = tick(state, batch, views[node.pid])
                record(case, n, t, state, res)
                if case == CKPT_CASE and n == 4 and t + 1 == CKPT_TICK:
                    save_checkpoint(os.path.join(out_dir, "jax_ckpt"),
                                    CKPT_TICK, jax.device_get(state))

    # the port's checkpoint of its 4-shard state, restored onto the mesh
    query, window, cap, scfg, bsz, _, _ = CASES[CKPT_CASE]
    plan = compile_plan(query(), window, **cap)
    mesh = jax.make_mesh((4,), ("data",))
    tick, state0 = build_sharded_tick(plan, mesh, axes=("data",),
                                      extract_matches=True)
    specs = _state_specs(state0, ("data",))
    state = restore_checkpoint(os.path.join(out_dir, "port_ckpt"),
                               CKPT_TICK, state0, mesh, specs)
    for t, b in enumerate(batches(scfg, bsz)):
        if t < CKPT_TICK:
            continue
        state, res = tick(state, make_batch(**b))
        record("rev", 4, t, state, res)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    print("TORCH-DIST-REF-OK")


if __name__ == "__main__":
    main(sys.argv[1])
