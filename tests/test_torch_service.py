"""The port's ContinuousSearchService against the reference service.

Both serve the same stream (CPU; REF joins) with tenant churn between
calls; per-qid match multisets and totals must be equal, ``ingest``
results bit-identical, and a registration of an already-seen structure
must build nothing.
"""

from collections import Counter

import pytest

from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.runtime.service import ContinuousSearchService as RefService
from repro.stream.generator import to_batches

from _torch_util import assert_same_tree, port_edges, port_query
from repro_torch.core.multi import SlotTickCache
from repro_torch.runtime.service import ContinuousSearchService
from test_engine_oracle import small_stream, tri_query, two_chain_query
from test_multi_query import chain_query, chain_query_relabeled

CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)


def _services():
    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     **CAP)
    port = ContinuousSearchService(slots_per_group=2, device="cpu",
                                   tick_cache=SlotTickCache(), **CAP)
    return ref, port


def _collector():
    got = {}

    def on_match(qid, bind, ets):
        got.setdefault(qid, Counter()).update(
            tuple(map(int, b)) + tuple(map(int, e))
            for b, e in zip(bind, ets))
    return got, on_match


def test_served_matches_equal_reference_under_churn():
    stream = small_stream(240, n_vertices=9, seed=31)
    pstream = port_edges(stream)
    ref, port = _services()
    ref_m, ref_cb = _collector()
    port_m, port_cb = _collector()
    kw = dict(batch_size=16, min_batch=16, max_batch=16)

    def register(q, w):
        a, b = ref.register(q, w), port.register(port_query(q), w)
        assert a == b
        return a

    for q, w in ((chain_query(), 20), (two_chain_query(), 20),
                 (chain_query_relabeled(), 14), (tri_query(), 25)):
        register(q, w)
    builds = port.n_compiles
    assert builds == ref.n_compiles == 3
    totals_ref = ref.serve_stream(stream[:96], on_match=ref_cb, **kw)
    totals_port = port.serve_stream(pstream[:96], on_match=port_cb, **kw)
    assert totals_port == totals_ref
    # churn: drop a chain, add a relabeled chain (seen structure: no
    # build) and a second two-chain
    ref.unregister(0)
    port.unregister(0)
    register(chain_query_relabeled(), 30)
    register(two_chain_query(), 12)
    assert port.n_compiles == builds
    totals_ref = ref.serve_stream(stream[96:], on_match=ref_cb, **kw)
    totals_port = port.serve_stream(pstream[96:], on_match=port_cb, **kw)
    assert totals_port == totals_ref
    assert port_m == ref_m
    assert sum(sum(c.values()) for c in port_m.values()) > 0
    for qid in ref.registry.qids():
        assert port.matches(qid) == ref.matches(qid)
        assert_same_tree(ref.state(qid), port.state(qid), f"qid {qid}")
    assert port.overflow_pressure() == ref.overflow_pressure() == 0
    assert port.n_active == ref.n_active == 5


def test_ingest_results_equal_reference():
    stream = small_stream(120, n_vertices=9, seed=32)
    ref, port = _services()
    for q, w in ((chain_query(), 20), (chain_query_relabeled(), 16),
                 (two_chain_query(), 22)):
        ref.register(q, w)
        port.register(port_query(q), w)
    for b in to_batches(stream, 8):
        r, p = ref.ingest(b), port.ingest(b)
        assert sorted(r) == sorted(p)
        for qid in r:
            assert_same_tree(r[qid], p[qid], f"ingest qid {qid}")
    assert port.n_ticks == ref.n_ticks
    assert port.n_edges_ingested == ref.n_edges_ingested


def test_seen_structure_registers_without_build_and_idle_groups():
    _, port = _services()
    cache = port.tick_cache
    a = port.register(port_query(chain_query()), 20)
    b = port.register(port_query(chain_query_relabeled()), 25)
    c = port.register(port_query(chain_query()), 30)      # second group
    assert cache.n_builds == 1 and port.n_compiles == 1
    assert len(port._iter_groups()) == 2
    for q in (a, b, c):
        port.unregister(q)
    # one idle group per structure stays warm until dropped
    assert port.drop_idle_groups() == 1
    port.register(port_query(chain_query()), 20)
    assert cache.n_builds == 1


def test_service_rejects_unknown_backend():
    with pytest.raises(ValueError):
        ContinuousSearchService(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousSearchService(device="cpu", backend="cuda")
    svc = ContinuousSearchService(device="cpu")
    assert svc.backend == "ref"
    with pytest.raises(ValueError, match="extract_matches"):
        ContinuousSearchService(device="cpu", extract_matches=False) \
            .serve_stream([], on_match=print)
