"""The port's SJ-tree baseline (``repro_torch.core.sjtree``) against
``repro.core.sjtree``.

* ``compile_sjtree_plan`` gives the reference's plan (decomposition,
  signature, every L0 join's REL/TREL and layouts, the final layouts)
  and its post-filter TREL, for the engine tests' queries and the serve
  phase's two structures.
* ``timing_postfilter`` equals the reference's on random rows.
* The SJ-tree engine (the port's ``build_tick`` over the SJ-tree plan,
  REF backend, CPU) is bit-identical to the JAX one, tick by tick.
* Its post-filtered matches equal the timing-aware engine's: the port of
  ``tests/test_engine_props.py::test_sjtree_postfilter_equals_engine``
  (current matches at the end), and also tick by tick for the matches
  each tick emits, as multisets (what ``chip_smoke.py``'s ``sjtree``
  phase holds on the card).
"""

from collections import Counter

import jax
import numpy as np
import pytest

from repro.core.plan import compile_plan as ref_compile_plan
from repro.core.engine import build_tick as ref_build_tick
from repro.core.query import QueryGraph, example_paper_query
from repro.core.registry import plan_decomposition as ref_decomposition
from repro.core.registry import plan_signature as ref_signature
from repro.core.sjtree import compile_sjtree_plan as ref_compile_sjtree
from repro.core.sjtree import timing_postfilter as ref_postfilter
from repro.core.state import init_state as ref_init_state
from repro.core.state import make_batch as ref_make_batch
from repro.stream.generator import StreamConfig, synth_traffic_stream, \
    to_batches

from _torch_util import assert_same_tree, port_query
from repro_torch.core.engine import build_tick, current_matches, \
    matches_from_rows
from repro_torch.core.plan import compile_plan
from repro_torch.core.registry import plan_decomposition, plan_signature
from repro_torch.core.sjtree import compile_sjtree_plan, strip_timing, \
    timing_postfilter
from repro_torch.core.state import init_state, make_batch
from test_engine_oracle import star_query, tri_query, two_chain_query

CPU = "cpu"
CAP = dict(level_capacity=2048, l0_capacity=2048, max_new=1024)

# tests/test_engine_props.py's catalog, the engine tests' queries and
# the serve phase's two structures (chip_smoke.py tenants())
QUERIES = {
    "tc_chain": QueryGraph(3, (0, 1, 0), ((0, 1), (1, 2)),
                           prec=frozenset({(0, 1)})),
    "untimed_chain": QueryGraph(3, (0, 1, 0), ((0, 1), (1, 2))),
    "fork": QueryGraph(3, (0, 1, 1), ((0, 1), (0, 2)),
                       prec=frozenset({(1, 0)})),
    "triangle_partial": QueryGraph(3, (0, 0, 1), ((0, 1), (1, 2), (2, 0)),
                                   prec=frozenset({(0, 2)})),
    "triangle": tri_query(),
    "star": star_query(),
    "two_chain": two_chain_query(),
    "paper_fig2": example_paper_query(),
    "serve_chain": QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                              prec=frozenset({(0, 1), (1, 2)})),
    "serve_two_chain": QueryGraph(5, (0, 0, 1, 0, 1),
                                  ((0, 1), (1, 2), (0, 3), (3, 4)),
                                  prec=frozenset({(0, 1), (2, 3)})),
}


def _stream(seed, n_edges=60, n_vertices=6, n_vertex_labels=2):
    """``test_engine_props.py``'s small streams, at fixed seeds."""
    return synth_traffic_stream(StreamConfig(
        n_edges=n_edges, n_vertices=n_vertices,
        n_vertex_labels=n_vertex_labels, n_edge_labels=2, seed=seed,
        ts_step_max=2))


@pytest.mark.parametrize("name", list(QUERIES))
def test_compile_sjtree_plan_matches_reference(name):
    q = QUERIES[name]
    rp, rtrel = ref_compile_sjtree(q, 30, **CAP)
    tp, ttrel = compile_sjtree_plan(port_query(q), 30, **CAP)
    assert strip_timing(port_query(q)).to_spec() == rp.query.to_spec()
    assert tp.query.to_spec() == rp.query.to_spec()
    assert plan_signature(tp) == ref_signature(rp)
    assert plan_decomposition(tp) == ref_decomposition(rp)
    assert tp.decomposition_sizes == rp.decomposition_sizes == \
        (1,) * q.n_edges
    assert tp.edge_site == rp.edge_site
    assert len(tp.l0_joins) == len(rp.l0_joins) == q.n_edges - 1
    for tj, rj in zip(tp.l0_joins, rp.l0_joins):
        for a, b in ((tj.rel, rj.rel), (tj.trel, rj.trel)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (tj.vertex_layout, tj.edge_layout, tj.b_new_vertex_slots,
                tj.capacity, tj.max_new) == \
            (rj.vertex_layout, rj.edge_layout, rj.b_new_vertex_slots,
             rj.capacity, rj.max_new)
    assert tp.final_vertex_layout == rp.final_vertex_layout
    assert tp.final_edge_layout == rp.final_edge_layout
    assert ttrel.dtype == rtrel.dtype == np.int8
    assert np.array_equal(ttrel, rtrel)


def test_timing_postfilter_equals_reference():
    rng = np.random.default_rng(2)
    for name in ("serve_chain", "serve_two_chain", "paper_fig2"):
        q = QUERIES[name]
        _, trel = ref_compile_sjtree(q, 30, **CAP)
        ne = trel.shape[0]
        ets = rng.integers(0, 6, (500, ne)).astype(np.int32)
        valid = rng.random(500) < 0.8
        before = valid.copy()
        want = ref_postfilter(ets, valid, trel)
        got = timing_postfilter(ets, valid, trel)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert 0 < got.sum() < valid.sum()
        assert np.array_equal(valid, before)        # not written


def _emitted(plan, res, trel=None) -> Counter:
    """One tick's emitted matches in the canonical form (frozensets of
    ``(query edge, (src, dst, ts))``), post-filtered by ``trel``."""
    bind, ets, valid = (x.cpu().numpy() for x in (
        res.match_bindings, res.match_ets, res.match_valid))
    if trel is not None:
        valid = timing_postfilter(ets, valid, trel)
    out = Counter()
    for r in np.nonzero(valid)[0]:
        out.update(matches_from_rows(plan, bind[r:r + 1], ets[r:r + 1],
                                     np.ones(1, bool)))
    return out


@pytest.mark.parametrize("name", ["tc_chain", "triangle_partial",
                                  "serve_chain", "serve_two_chain"])
def test_sjtree_engine_bit_identical_to_reference(name):
    q = QUERIES[name]
    stream = _stream(4, n_edges=120, n_vertices=8,
                     n_vertex_labels=max(q.vertex_labels) + 1)
    rp, _ = ref_compile_sjtree(q, 20, **CAP)
    tp, _ = compile_sjtree_plan(port_query(q), 20, **CAP)
    jtick = jax.jit(ref_build_tick(rp))
    ttick = build_tick(tp, device=CPU)
    js, ts = ref_init_state(rp), init_state(tp, device=CPU)
    rows = 0
    for bi, b in enumerate(to_batches(stream, 8)):
        js, jr = jtick(js, ref_make_batch(**b))
        ts, tr = ttick(ts, make_batch(**b, device=CPU))
        assert_same_tree(js, ts, f"{name} tick {bi} state")
        assert_same_tree(jr, tr, f"{name} tick {bi} result")
        rows += int(ts.l0[-1].valid.sum())
    assert int(ts.stats.n_overflow) == 0
    assert rows > 0, "the SJ-tree's final table must fill"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_sjtree_postfilter_equals_engine(seed):
    """The port of the reference's property test at fixed seeds; also
    each tick's emitted matches, post-filtered, equal the timing-aware
    engine's."""
    for name in ("tc_chain", "serve_two_chain"):
        q = port_query(QUERIES[name])
        window = 15
        plan = compile_plan(q, window, **CAP)
        sj_plan, trel = compile_sjtree_plan(q, window, **CAP)
        tick = build_tick(plan, device=CPU)
        sj_tick = build_tick(sj_plan, device=CPU)
        state = init_state(plan, device=CPU)
        sj_state = init_state(sj_plan, device=CPU)
        for b in to_batches(_stream(seed), 8):
            state, res = tick(state, make_batch(**b, device=CPU))
            sj_state, sj_res = sj_tick(sj_state, make_batch(**b, device=CPU))
            assert _emitted(sj_plan, sj_res, trel) == _emitted(plan, res)
        assert int(state.stats.n_overflow) == 0
        assert int(sj_state.stats.n_overflow) == 0
        want = current_matches(plan, state)
        tbl = sj_state.l0[-1]
        ok = timing_postfilter(tbl.ets.numpy(), tbl.valid.numpy(), trel)
        got = matches_from_rows(sj_plan, tbl.bindings.numpy(),
                                tbl.ets.numpy(), ok)
        assert got == want
