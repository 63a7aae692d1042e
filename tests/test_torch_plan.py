"""The port's host-side plan layer against the reference.

For every query of the reference's plan-verifier corpus and the engine
test fixtures, both packages must decompose and compile alike: equal
TC-subqueries, REL/TREL matrices, layouts, capacities, label tables,
``plan_signature``, ``plan_decomposition``, canonical forms and plan
findings.
"""

import numpy as np
import pytest

from repro.analysis.plan_check import _corpus_queries
from repro.analysis.plan_check import check_plan as ref_check_plan
from repro.core.canon import canonical_form as ref_canonical_form
from repro.core.decompose import tc_subqueries as ref_tc_subqueries
from repro.core.plan import compile_plan as ref_compile_plan
from repro.core.registry import plan_decomposition as ref_decomposition
from repro.core.registry import plan_signature as ref_signature
from repro.core.share import prefix_chain as ref_prefix_chain

from _torch_util import port_query
from repro_torch.analysis.plan_check import (
    PlanInvariantError,
    check_plan,
    verify_corpus,
)
from repro_torch.core.canon import canonical_form
from repro_torch.core.decompose import tc_subqueries
from repro_torch.core.plan import compile_plan
from repro_torch.core.registry import (
    QueryRegistry,
    plan_decomposition,
    plan_signature,
)
from repro_torch.core.share import prefix_chain
from test_engine_oracle import star_query, tri_query, two_chain_query
from test_multi_query import chain_query, chain_query_relabeled


def _queries():
    out = dict(_corpus_queries())
    out.update({
        "fixture_chain": chain_query(),
        "fixture_chain_relabeled": chain_query_relabeled(),
        "fixture_triangle": tri_query(),
        "fixture_star": star_query(),
        "fixture_two_chain": two_chain_query(),
    })
    return out


QUERIES = _queries()
CAPS = [dict(level_capacity=512, l0_capacity=256, max_new=64),
        dict(level_capacity=65536, l0_capacity=65536, max_new=8192)]


@pytest.mark.parametrize("cap", CAPS, ids=["small", "serving"])
@pytest.mark.parametrize("window", [25, 1000])
@pytest.mark.parametrize("name", list(QUERIES))
def test_compile_plan_matches_reference(name, window, cap):
    q = QUERIES[name]
    rp = ref_compile_plan(q, window, **cap)
    tp = compile_plan(port_query(q), window, **cap)
    assert tp.query.to_spec() == rp.query.to_spec()
    assert plan_signature(tp) == ref_signature(rp)
    assert plan_decomposition(tp) == ref_decomposition(rp)
    assert tp.decomposition_sizes == rp.decomposition_sizes
    assert tp.edge_site == rp.edge_site
    for a, b in ((tp.edge_src_label, rp.edge_src_label),
                 (tp.edge_dst_label, rp.edge_dst_label),
                 (tp.edge_edge_label, rp.edge_edge_label)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(tp.l0_joins) == len(rp.l0_joins)
    for tj, rj in zip(tp.l0_joins, rp.l0_joins):
        assert np.array_equal(tj.rel, rj.rel) and tj.rel.dtype == rj.rel.dtype
        assert np.array_equal(tj.trel, rj.trel) \
            and tj.trel.dtype == rj.trel.dtype
        assert (tj.vertex_layout, tj.edge_layout, tj.b_new_vertex_slots,
                tj.capacity, tj.max_new) == \
            (rj.vertex_layout, rj.edge_layout, rj.b_new_vertex_slots,
             rj.capacity, rj.max_new)
    assert tp.final_vertex_layout == rp.final_vertex_layout
    assert tp.final_edge_layout == rp.final_edge_layout
    assert [(f.rule, f.severity) for f in check_plan(tp)] == \
        [(f.rule, f.severity) for f in ref_check_plan(rp)]


@pytest.mark.parametrize("name", list(QUERIES))
def test_enumeration_canon_and_prefixes_match_reference(name):
    q = QUERIES[name]
    tq = port_query(q)
    assert [(t.edge_ids, t.timing_sequence) for t in tc_subqueries(tq)] == \
        [(t.edge_ids, t.timing_sequence) for t in ref_tc_subqueries(q)]
    tc, rc = canonical_form(tq), ref_canonical_form(q)
    assert tc.query.to_spec() == rc.query.to_spec()
    assert (tc.vertex_map, tc.edge_map) == (rc.vertex_map, rc.edge_map)
    rp, tp = ref_compile_plan(q, 30), compile_plan(tq, 30)
    assert prefix_chain(tp).sigs == ref_prefix_chain(rp).sigs


def test_corpus_verifies_clean():
    findings, stats = verify_corpus()
    assert not [f for f in findings if f.severity == "error"]
    assert stats["n_plans_verified"] == 2 * len(list(_corpus_queries()))


def test_registry_rejects_a_broken_plan():
    """``register`` verifies the plan before allocating a qid."""
    reg = QueryRegistry(level_capacity=64, l0_capacity=64, max_new=16)
    q = port_query(two_chain_query())
    plan = reg.compile(q, 20)
    plan.subqueries[0].levels[0].src_slot = 5        # drifted layout
    with pytest.raises(PlanInvariantError):
        reg.register(q, 20, plan=plan)
    assert len(reg) == 0 and reg.next_qid == 0
    assert reg.register(q, 20) == 0
