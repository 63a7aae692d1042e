"""The port's tick (REF backend, CPU) against the JAX reference tick.

Tick by tick, every table leaf, clock, stat and result leaf must be
bit-identical; the port's ``current_matches`` must equal the exact
oracle.  Covers the chain, triangle, star and two-chain queries, with
and without a watermark, a state handed over mid-stream with
``state_from_numpy``, and slot groups against the JAX (vmapped) slot
tick.
"""

import jax
import numpy as np
import pytest

from repro.core import compile_plan as ref_compile_plan
from repro.core.engine import NO_WATERMARK as REF_NO_WATERMARK
from repro.core.engine import build_tick as ref_build_tick
from repro.core.multi import build_multi_tick as ref_build_multi_tick
from repro.core.multi import build_slot_tick as ref_build_slot_tick
from repro.core.multi import init_multi_state as ref_init_multi_state
from repro.core.multi import set_active as ref_set_active
from repro.core.multi import init_slot_state as ref_init_slot_state
from repro.core.multi import write_slot as ref_write_slot
from repro.core.state import init_state as ref_init_state
from repro.core.state import make_batch as ref_make_batch
from repro.stream.generator import to_batches

from _torch_util import assert_same_tree, port_edges, port_query
from repro_torch.core.engine import NO_WATERMARK, build_tick, current_matches
from repro_torch.core.multi import (
    build_multi_tick,
    build_slot_tick,
    init_multi_state,
    init_slot_state,
    read_slot,
    write_slot,
)
from repro_torch.core.oracle import OracleEngine
from repro_torch.core.plan import compile_plan
from repro_torch.core.state import (
    init_state,
    make_batch,
    state_from_numpy,
    state_to_numpy,
)
from repro.core.query import example_paper_query
from test_engine_oracle import small_stream, star_query, tri_query, \
    two_chain_query
from test_multi_query import chain_query, chain_query_relabeled

CPU = "cpu"
CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)

QUERIES = {
    "chain": (chain_query, 20, dict(n_vertices=10, seed=1)),
    "triangle": (tri_query, 25, dict(n_vertices=8, seed=5)),
    "star": (star_query, 15, dict(n_vertices=7, n_vertex_labels=2, seed=4)),
    "two_chain": (two_chain_query, 20, dict(n_vertices=10, seed=4)),
    # three TC-subqueries: two chained L0 joins
    "paper_fig2": (example_paper_query, 60,
                   dict(n_vertices=6, n_vertex_labels=5, seed=6)),
}


def _plans(q, window, cap=CAP):
    return (ref_compile_plan(q, window, **cap),
            compile_plan(port_query(q), window, **cap))


def _watermark(b, lag=3):
    """A watermark a little behind the batch's newest edge (NO_WATERMARK
    for the first batch): exercises admission, rejection and the clock."""
    ts = b["ts"][b["valid"]]
    return None if ts.size == 0 else int(ts.max()) - lag


@pytest.mark.parametrize("use_watermark", [False, True],
                         ids=["max_ts_clock", "watermark"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_tick_bit_identical_to_reference(name, use_watermark):
    ctor, window, skw = QUERIES[name]
    q = ctor()
    stream = small_stream(150, **skw)
    jplan, tplan = _plans(q, window)
    jtick = jax.jit(ref_build_tick(jplan))
    ttick = build_tick(tplan, device=CPU)
    js, ts = ref_init_state(jplan), init_state(tplan, device=CPU)
    oracle = OracleEngine(port_query(q), window)
    port_stream = port_edges(stream)
    total = 0
    for bi, b in enumerate(to_batches(stream, 8)):
        if use_watermark:
            wm = _watermark(b) if bi else None
            jwm = REF_NO_WATERMARK if wm is None else wm
            twm = NO_WATERMARK if wm is None else wm
            js, jr = jtick(js, ref_make_batch(**b), np.int32(jwm))
            ts, tr = ttick(ts, make_batch(**b, device=CPU), twm)
        else:
            js, jr = jtick(js, ref_make_batch(**b))
            ts, tr = ttick(ts, make_batch(**b, device=CPU))
        assert_same_tree(js, ts, f"{name} tick {bi} state")
        assert_same_tree(jr, tr, f"{name} tick {bi} result")
        total += int(tr.n_new_matches)
        if not use_watermark:
            for e in port_stream[bi * 8:(bi + 1) * 8]:
                oracle.insert(e)
            assert current_matches(tplan, ts) == oracle.matches(), \
                f"{name} tick {bi}: port != oracle"
    assert int(ts.stats.n_overflow) == 0
    assert total > 0, "the stream must produce matches"


@pytest.mark.parametrize("name", ["chain", "two_chain"])
def test_state_handed_over_mid_stream(name):
    """The JAX state after k ticks, moved into the port with
    ``state_from_numpy``, continues bit-identically; and the port's state
    moves back with ``state_to_numpy``."""
    ctor, window, skw = QUERIES[name]
    stream = small_stream(160, **skw)
    jplan, tplan = _plans(ctor(), window)
    jtick = jax.jit(ref_build_tick(jplan))
    ttick = build_tick(tplan, device=CPU)
    js = ref_init_state(jplan)
    batches = to_batches(stream, 8)
    for b in batches[:10]:
        js, _ = jtick(js, ref_make_batch(**b))
    ts = state_from_numpy(jax.tree.map(np.asarray, js), device=CPU)
    assert_same_tree(js, ts, "handover")
    for bi, b in enumerate(batches[10:]):
        js, jr = jtick(js, ref_make_batch(**b))
        ts, tr = ttick(ts, make_batch(**b, device=CPU))
        assert_same_tree(js, ts, f"after handover, tick {bi}")
        assert_same_tree(jr, tr, f"after handover, tick {bi} result")
    assert_same_tree(js, state_to_numpy(ts), "state_to_numpy")


@pytest.mark.parametrize("use_watermark", [False, True],
                         ids=["max_ts_clock", "watermark"])
def test_slot_tick_bit_identical_to_reference(use_watermark):
    """A slot group with per-slot labels and windows, one slot unarmed,
    against the JAX vmapped slot tick."""
    cap = dict(level_capacity=256, l0_capacity=256, max_new=128)
    windows = {0: 20, 1: 14, 3: 30}
    queries = {0: chain_query(), 1: chain_query_relabeled(),
               3: chain_query()}
    jtpl, ttpl = _plans(chain_query(), 20, cap)
    jtick = jax.jit(ref_build_slot_tick(jtpl))
    ttick = build_slot_tick(ttpl)
    jss = ref_init_slot_state(jtpl, 4)
    tss = init_slot_state(ttpl, 4, device=CPU)
    for k, q in queries.items():
        jp, tp = _plans(q, windows[k], cap)
        jss = ref_write_slot(jss, jtpl, k, jp)
        tss = write_slot(tss, ttpl, k, tp)
    assert_same_tree(jss, tss, "armed")
    stream = small_stream(150, n_vertices=9, seed=21)
    for bi, b in enumerate(to_batches(stream, 16)):
        wm = _watermark(b) if use_watermark and bi else None
        if use_watermark:
            jwm = np.int32(REF_NO_WATERMARK if wm is None else wm)
            jss, jr = jtick(jss, ref_make_batch(**b), jwm)
            tss, tr = ttick(tss, make_batch(**b, device=CPU),
                            NO_WATERMARK if wm is None else wm)
        else:
            jss, jr = jtick(jss, ref_make_batch(**b))
            tss, tr = ttick(tss, make_batch(**b, device=CPU))
        assert_same_tree(jss, tss, f"slot tick {bi}")
        assert_same_tree(jr, tr, f"slot tick {bi} result")
    assert int(read_slot(tss, 2).stats.n_edges_processed) == 0
    assert int(tss.engines.stats.n_matches_total.sum()) > 0


def test_multi_tick_bit_identical_to_reference():
    """Four heterogeneous queries fused behind one label scan, one of
    them switched off mid-stream."""
    names = ["chain", "triangle", "star", "two_chain"]
    jplans, tplans = zip(*(_plans(QUERIES[n][0](), QUERIES[n][1])
                           for n in names))
    jtick = jax.jit(ref_build_multi_tick(jplans))
    ttick = build_multi_tick(tplans, device=CPU)
    jm, tm = ref_init_multi_state(jplans), init_multi_state(tplans,
                                                            device=CPU)
    stream = small_stream(150, n_vertices=9, seed=21)
    for bi, b in enumerate(to_batches(stream, 8)):
        if bi == 8:
            jm = ref_set_active(jm, 1, False)
            tm.active[1] = False
        jm, jr = jtick(jm, ref_make_batch(**b))
        tm, tr = ttick(tm, make_batch(**b, device=CPU))
        assert_same_tree(jm, tm, f"multi tick {bi}")
        assert_same_tree(jr, tr, f"multi tick {bi} result")
    assert sum(int(q.stats.n_matches_total) for q in tm.queries) > 0
