"""The port's cross-tenant prefix sharing against the JAX package.

The scenarios of tests/test_share.py, each run on the port (CPU, REF
joins) AND on the reference service with the same seeded stream:

* per-tenant report multisets with sharing on equal sharing off, the
  oracle, and the reference's shared run;
* the forest (every node table, refcounts, epochs, ``forest_stats``) is
  bit-identical to the reference's after every tick;
* overflow is attributed to tenants tick by tick as in the unshared run;
* K tenants on one chain, churn epochs, a failed registration's
  rollback, a register/unregister storm, crash/restore with sharing
  (exactly-once, zero warm builds), a cold-cache restore, the api
  session with ``share_prefixes``, and relabeling invariance of the
  prefix signatures.
"""

from collections import Counter

import pytest

from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.core.registry import QueryRegistry as RefRegistry
from repro.core.share import prefix_chain as ref_prefix_chain
from repro.runtime.fault import SimulatedFailure
from repro.runtime.service import ContinuousSearchService as RefService
from repro.stream.generator import to_batches

from _torch_util import (
    assert_same_forest,
    assert_same_tree,
    forest_leaves,
    port_edges,
    port_query,
    served_reports,
)
from repro_torch.api import Pattern, StreamSession
from repro_torch.core.multi import SlotTickCache
from repro_torch.core.registry import QueryRegistry
from repro_torch.core.share import prefix_chain
from repro_torch.runtime.service import ContinuousSearchService
from test_service_restore import EventLog, oracle_reported
from test_share import (
    W,
    chain2,
    chain2_other_labels,
    chain3,
    fork,
    stream160,
    tri,
)

CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)
SERVE = dict(batch_size=16, min_batch=16, max_batch=16)


def port_svc(tc=None, share=True, **kw):
    kw = {**CAP, **kw}
    return ContinuousSearchService(
        slots_per_group=kw.pop("slots_per_group", 4),
        tick_cache=SlotTickCache() if tc is None else tc,
        enable_sharing=share, device="cpu", **kw)


def ref_svc(tc=None, share=True, **kw):
    kw = {**CAP, **kw}
    return RefService(
        slots_per_group=kw.pop("slots_per_group", 4),
        tick_cache=RefSlotTickCache() if tc is None else tc,
        enable_sharing=share, **kw)


def serve_twins(ref, port, stream, **serve):
    """Serve both; every tick, the forests must be bit-identical.
    Returns (ref reports, port reports, ref infos, port infos)."""
    count_r, infos_r, snaps_r = served_reports(
        ref, stream, record=forest_leaves, **SERVE, **serve)
    count_p, infos_p, snaps_p = served_reports(
        port, port_edges(stream), record=forest_leaves, **SERVE, **serve)
    assert len(snaps_r) == len(snaps_p)
    assert_same_forest(ref, port, "after serve")
    for t, (a, b) in enumerate(zip(snaps_r, snaps_p)):
        assert [k for k, _ in a] == [k for k, _ in b], f"tick {t}"
        for (key, xs), (_, ys) in zip(a, b):
            for x, y in zip(xs, ys):
                assert (x == y).all(), f"tick {t}: node {key} differs"
    fields = ("tick", "n_edges_ingested", "chunk", "n_overflow",
              "n_shared_prefix_ticks")
    assert [tuple(getattr(i, f) for f in fields) for i in infos_p] == \
        [tuple(getattr(i, f) for f in fields) for i in infos_r]
    return count_r, count_p, infos_r, infos_p


def register_all(svcs, queries):
    qids = [[s.register(port_query(q) if isinstance(s, ContinuousSearchService)
                        else q, W) for q in queries] for s in svcs]
    assert all(q == qids[0] for q in qids)
    return qids[0]


# --------------------------------------------------------------------- #
# differential: shared == unshared == oracle == reference
# --------------------------------------------------------------------- #
def test_sharing_differential_oracle_and_reference():
    stream = stream160()
    queries = [chain3(), chain2(), chain2(), chain2_other_labels(), fork(),
               tri()]
    ref, shared, plain = ref_svc(), port_svc(), port_svc(share=False)
    qs = register_all((ref, shared, plain), queries)

    fs = shared.forest_stats()
    assert tuple(fs) == tuple(ref.forest_stats())
    assert fs.n_tenants == 6
    assert shared.shared_prefix(qs[1]) == ref.shared_prefix(qs[1])
    assert shared.shared_prefix(qs[1]).depth == 2
    assert shared.shared_prefix(qs[1]).n_tenants == 4
    assert shared.shared_prefix(qs[0]).depth == 3
    assert plain.forest_stats() is None and plain.shared_prefix(qs[0]) is None

    count_r, count_s, _, infos_s = serve_twins(ref, shared, stream)
    count_p, infos_p, _ = served_reports(plain, port_edges(stream), **SERVE)
    assert count_s and count_s == count_p == count_r
    assert all(i.n_shared_prefix_ticks == len(shared.forest)
               for i in infos_s)
    assert all(i.n_shared_prefix_ticks == 0 for i in infos_p)
    for qid, q in zip(qs, queries):
        want_reported, want_window = oracle_reported(q, W, stream)
        assert {k for (qq, k) in count_s if qq == qid} == want_reported
        assert shared.matches(qid) == want_window == plain.matches(qid)
        assert shared.tenant_overflow(qid) == 0
        assert_same_tree(ref.state(qid), shared.state(qid), f"qid {qid}")
    assert sum(count_s.values()) > 50


def test_sharing_differential_under_overflow():
    """Saturated tables drop appends deterministically; a shared node
    drops exactly what each aliasing tenant's own table would have, and
    the per-tick overflow trace equals the unshared run's and the
    reference's."""
    tiny = dict(level_capacity=16, l0_capacity=16, max_new=4)
    queries = [chain3(), chain2(), chain2()]
    ref, shared, plain = (ref_svc(**tiny), port_svc(**tiny),
                          port_svc(share=False, **tiny))
    qs = register_all((ref, shared, plain), queries)
    stream = stream160()
    count_r, count_s, _, infos_s = serve_twins(ref, shared, stream)
    count_p, infos_p, _ = served_reports(plain, port_edges(stream), **SERVE)
    assert count_s == count_p == count_r
    for q in qs:
        assert shared.matches(q) == plain.matches(q)
        assert shared.tenant_overflow(q) == plain.tenant_overflow(q) \
            == ref.tenant_overflow(q) > 0
    assert [i.n_overflow for i in infos_s] == [i.n_overflow for i in infos_p]
    assert any(i.n_overflow > 0 for i in infos_s)
    assert shared.overflow_pressure() == ref.overflow_pressure() > 0


# --------------------------------------------------------------------- #
# scale: K tenants sharing one prefix build its tables once
# --------------------------------------------------------------------- #
def test_k_tenants_one_prefix_chain():
    K = 12
    tc = SlotTickCache()
    svc = port_svc(tc, slots_per_group=16)
    ref = ref_svc(slots_per_group=16)
    qids = register_all((ref, svc), [chain2()] * K)
    fs = svc.forest_stats()
    assert (fs.n_nodes, fs.n_shared_nodes, fs.n_tenants) == (2, 2, K)
    assert tuple(fs) == tuple(ref.forest_stats())
    leaves = {svc.shared_prefix(q) for q in qids}
    assert len(leaves) == 1 and leaves.pop().n_tenants == K
    # one slot group, one suffix tick build, two node-tick builds
    assert len(svc._iter_groups()) == 1
    assert svc.n_compiles == 1
    assert tc.n_builds == 3

    q3 = register_all((ref, svc), [chain3()])[0]
    assert svc.forest_stats().n_nodes == 3
    assert svc.shared_prefix(q3).depth == 3
    assert svc.shared_prefix(qids[0]).n_tenants == K + 1

    for b in to_batches(stream160(), 16):
        out, rout = svc.ingest(b), ref.ingest(b)
        assert len({int(out[q].n_new_matches) for q in qids}) == 1
        for q in out:
            assert_same_tree(rout[q], out[q], f"ingest qid {q}")
        assert_same_forest(ref, svc, "ingest")


# --------------------------------------------------------------------- #
# churn: epochs isolate history; storms leave no orphans
# --------------------------------------------------------------------- #
def test_churn_epochs_match_unshared_oracle_and_reference():
    stream = stream160(seed=5)
    half = 80
    ref, shared, plain = ref_svc(), port_svc(), port_svc(share=False)
    a = register_all((ref, shared, plain), [chain3()])[0]
    b = register_all((ref, shared, plain), [chain2()])[0]

    count1_r, count1_s, _, _ = serve_twins(ref, shared, stream[:half])
    count1_p, _, _ = served_reports(plain, port_edges(stream[:half]), **SERVE)
    assert count1_s == count1_p == count1_r

    for s in (ref, shared, plain):
        s.unregister(b)
    c = register_all((ref, shared, plain), [chain2()])[0]
    assert shared.shared_prefix(c).epoch == half
    assert shared.shared_prefix(c).n_tenants == 1
    assert shared.forest_stats().n_nodes == 5      # A's 3 + C's fresh 2
    assert_same_forest(ref, shared, "after churn")

    count2_r, count2_s, _, _ = serve_twins(ref, shared, stream[half:])
    count2_p, _, _ = served_reports(plain, port_edges(stream[half:]), **SERVE)
    assert count2_s == count2_p == count2_r
    assert shared.matches(a) == plain.matches(a)
    want_reported, want_window = oracle_reported(chain2(), W, stream[half:])
    assert {k for (q, k) in count2_s if q == c} == want_reported
    assert shared.matches(c) == want_window

    shared.unregister(a)
    shared.unregister(c)
    assert len(shared.forest) == 0
    assert shared.forest_stats() == (0, 0, 0, 0)
    assert not shared._groups


def test_failed_registration_rolls_back_chain_and_qid():
    svc = port_svc(slots_per_group=2)
    q0 = svc.register(port_query(chain2()), W)
    orig = svc._new_group
    svc._new_group = lambda template, leaf=None: (_ for _ in ()).throw(
        RuntimeError("injected build failure"))
    with pytest.raises(RuntimeError, match="injected"):
        svc.register(port_query(tri()), W)
    svc._new_group = orig
    assert svc.n_active == 1 and len(svc.registry) == 1
    assert svc.forest_stats().n_tenants == 1
    assert len(svc.forest) == 2
    assert len(svc._groups) == 1
    qt = svc.register(port_query(tri()), W)
    assert svc.n_active == 2
    svc.unregister(q0)
    svc.unregister(qt)
    assert len(svc.forest) == 0 and not svc._groups


def test_register_unregister_storm_no_orphans_matches_reference():
    svc, ref = port_svc(slots_per_group=2), ref_svc(slots_per_group=2)
    queries = [chain3(), chain2(), chain2_other_labels(), fork()]
    live = {}
    batches = list(to_batches(stream160(seed=9), 16))
    for i in range(30):
        q = queries[i % len(queries)]
        qid = register_all((ref, svc), [q])[0]
        live[qid] = q
        if i % 3 == 2:                      # drop the oldest two
            for drop in sorted(live)[:2]:
                svc.unregister(drop)
                ref.unregister(drop)
                del live[drop]
        if i % 5 == 4:
            b = batches[(i // 5) % len(batches)]
            out, rout = svc.ingest(b), ref.ingest(b)
            assert sorted(out) == sorted(rout)
            assert_same_forest(ref, svc, f"storm step {i}")
    assert svc.forest_stats().n_tenants == len(live)
    for qid in live:
        assert 1 <= svc.shared_prefix(qid).n_tenants <= len(live)
        assert svc.shared_prefix(qid) == ref.shared_prefix(qid)
    for qid in list(live):
        svc.unregister(qid)
    assert len(svc.forest) == 0 and not svc._groups
    assert svc.forest_stats().n_tenants == 0


# --------------------------------------------------------------------- #
# crash/restore with sharing
# --------------------------------------------------------------------- #
def test_crash_restore_differential_with_sharing(tmp_path):
    tc = SlotTickCache()
    stream = port_edges(stream160(seed=5))
    queries = [chain3(), chain2(), fork()]

    def fresh(d):
        svc = port_svc(tc, slots_per_group=2, ckpt_dir=str(d))
        return svc, [svc.register(port_query(q), W) for q in queries]

    svc_a, qids = fresh(tmp_path / "a")
    log_a = EventLog(svc_a)
    svc_a.serve_stream(stream, on_match=log_a.on_match,
                       on_tick=log_a.on_tick, ckpt_every=3, **SERVE)
    count_a = Counter((qid, k) for qid, k, _ in log_a.events)
    assert count_a
    ref = ref_svc(slots_per_group=2)
    assert register_all((ref,), queries) == qids
    count_ref, _, _ = served_reports(ref, stream160(seed=5), **SERVE)
    assert count_ref == count_a
    assert_same_forest(ref, svc_a, "uninterrupted vs reference")
    for qid, q in zip(qids, queries):
        want_reported, want_window = oracle_reported(q, W, stream160(seed=5))
        assert {k for qq, k, _ in log_a.events if qq == qid} == want_reported
        assert svc_a.matches(qid) == want_window
    builds_a = tc.n_builds

    svc_b, qids_b = fresh(tmp_path / "b")
    assert qids_b == qids and svc_b.n_compiles == 0
    log_b = EventLog(svc_b, crash_at_tick=5)
    with pytest.raises(SimulatedFailure):
        svc_b.serve_stream(stream, on_match=log_b.on_match,
                           on_tick=log_b.on_tick, ckpt_every=3, **SERVE)
    svc_b.ckpt.wait()

    svc_r = ContinuousSearchService.restore(str(tmp_path / "b"),
                                            tick_cache=tc, device="cpu")
    assert tc.n_builds == builds_a and svc_r.n_compiles == 0
    assert svc_r.forest_stats() == svc_b.forest_stats()
    assert [(n.pid, n.depth, n.epoch, n.refcount)
            for n in svc_r.forest.nodes()] == \
        [(n.pid, n.depth, n.epoch, n.refcount)
         for n in svc_b.forest.nodes()]
    assert svc_r.n_ticks == 3

    kept = [(qid, k, off) for qid, k, off in log_b.events
            if off <= svc_r.n_edges_ingested]
    log_r = EventLog(svc_r)
    svc_r.serve_stream(stream[svc_r.n_edges_ingested:],
                       on_match=log_r.on_match, on_tick=log_r.on_tick,
                       ckpt_every=3, **SERVE)
    assert tc.n_builds == builds_a
    count_b = Counter((qid, k) for qid, k, _ in kept + log_r.events)
    assert count_b == count_a             # exactly-once, nothing missed
    for qid in qids:
        assert svc_r.matches(qid) == svc_a.matches(qid)
    assert_same_forest(svc_a, svc_r, "restored vs uninterrupted")


def test_restore_into_cold_cache_rebuilds_forest(tmp_path):
    svc = port_svc(slots_per_group=2, ckpt_dir=str(tmp_path))
    ref = ref_svc(slots_per_group=2)
    qids = register_all((ref, svc), [chain3(), chain2()])
    svc.serve_stream(port_edges(stream160()), ckpt_every=4, **SERVE)
    ref.serve_stream(stream160(), **SERVE)
    cold = SlotTickCache()
    svc2 = ContinuousSearchService.restore(str(tmp_path), tick_cache=cold,
                                           device="cpu")
    # a suffix tick per group, a node tick per node structure
    assert cold.n_builds == svc2.n_compiles + 3 > 3
    assert svc2.forest_stats() == svc.forest_stats()
    assert_same_forest(ref, svc2, "cold restore vs reference")
    for qid in qids:
        assert svc2.matches(qid) == svc.matches(qid) == ref.matches(qid)


# --------------------------------------------------------------------- #
# api surface and signatures
# --------------------------------------------------------------------- #
def overlapping_patterns():
    p3 = (Pattern("exfil")
          .vertex("a", label=0).vertex("b", label=1)
          .vertex("c", label=2).vertex("d", label=0)
          .edge("a", "b").edge("b", "c").edge("c", "d")
          .before(0, 1).before(1, 2).window(W))
    p2 = (Pattern("staging")
          .vertex("x", label=0).vertex("y", label=1).vertex("z", label=2)
          .edge("y", "z", name="hop2").edge("x", "y", name="hop1")
          .before("hop1", "hop2").window(W))
    return p3, p2


def test_api_session_shares_prefixes_and_reports_stats(tmp_path):
    from repro.api import StreamSession as RefSession
    from test_share import overlapping_patterns as ref_patterns

    tc = SlotTickCache()
    sess = StreamSession(tick_cache=tc, share_prefixes=True,
                         ckpt_dir=str(tmp_path), device="cpu", **CAP)
    plain = StreamSession(tick_cache=tc, device="cpu", **CAP)
    ref = RefSession(tick_cache=RefSlotTickCache(), share_prefixes=True,
                     **CAP)
    p3, p2 = overlapping_patterns()
    s3, s2 = sess.register(p3), sess.register(p2)
    u3, u2 = plain.register(p3), plain.register(p2)
    r3, r2 = (ref.register(p) for p in ref_patterns())
    assert s2.shared_prefix.depth == 2
    assert s2.shared_prefix.n_tenants == 2
    assert s3.shared_prefix.depth == 3
    assert u3.shared_prefix is None

    stream = stream160()
    infos = []
    sess.serve(port_edges(stream), on_tick=infos.append, **SERVE)
    plain.serve(port_edges(stream), **SERVE)
    ref.serve(stream, **SERVE)
    assert infos and all(i.n_shared_prefix_ticks == 3 for i in infos)
    for shared_sub, plain_sub, ref_sub in ((s3, u3, r3), (s2, u2, r2)):
        got = Counter(shared_sub.drain())
        want = Counter(plain_sub.drain())
        assert got == want and want
        assert got == Counter(tuple(m) for m in ref_sub.drain())
        assert shared_sub.matches() == plain_sub.matches()
    assert_same_forest(ref.service, sess.service, "session")

    sess.checkpoint()
    sess.close()
    sess2 = StreamSession.restore(str(tmp_path), tick_cache=tc,
                                  device="cpu")
    assert sess2.service.forest is not None
    subs = {s.name: s for s in sess2.subscriptions()}
    assert subs["staging"].shared_prefix.n_tenants == 2
    assert subs["exfil"].matches() == s3.matches()


def test_prefix_chain_is_relabeling_invariant_and_reference_equal():
    from repro.core.query import QueryGraph as RefQuery

    reg, rreg = QueryRegistry(**CAP), RefRegistry(**CAP)
    # chain2 authored with permuted vertex ids and reversed edges
    b_query = RefQuery(3, (2, 0, 1), ((1, 2), (2, 0)),
                       prec=frozenset({(0, 1)}))
    cases = {"a": (chain2(), W), "b": (b_query, W),
             "c": (chain2_other_labels(), W), "d": (chain2(), W + 1),
             "e": (chain3(), W), "f": (tri(), W), "g": (fork(), W)}
    sigs = {}
    for name, (q, w) in cases.items():
        sigs[name] = prefix_chain(reg.compile(port_query(q), w)).sigs
        assert sigs[name] == ref_prefix_chain(rreg.compile(q, w)).sigs
    assert sigs["a"] == sigs["b"]
    assert sigs["a"][0] != sigs["c"][0]
    assert sigs["a"] != sigs["d"]
    assert sigs["e"][:2] == sigs["f"][:2] == sigs["a"]


@pytest.mark.parametrize("query", ["chain3", "fork"])
def test_single_query_tick_over_a_prefix_view_equals_reference(query):
    """``build_tick(prefix_depth=1)`` fed the depth-1 node's view: for
    the 3-chain the first suffix join takes the view as its shared A
    operand, for the fork subquery 0 is all prefix and the L0 joins read
    it.  Results and suffix states bit-identical to the reference's."""
    from repro.core.engine import build_tick as ref_build_tick
    from repro.core.plan import compile_plan as ref_compile_plan
    from repro.core.share import SharedPrefixForest as RefForest
    from repro.core.state import init_state as ref_init_state
    from repro.core.state import make_batch as ref_make_batch
    from repro_torch.core.engine import build_tick
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.share import SharedPrefixForest
    from repro_torch.core.state import init_state, make_batch

    q = {"chain3": chain3, "fork": fork}[query]()
    rplan = ref_compile_plan(q, W, **CAP)
    plan = compile_plan(port_query(q), W, **CAP)
    rforest = RefForest(RefSlotTickCache(), jit=False)
    forest = SharedPrefixForest(SlotTickCache(), device="cpu")
    rroot, root = rforest.acquire(rplan, 0), forest.acquire(plan, 0)
    while rroot.depth > 1:
        rroot, root = rroot.parent, root.parent
    rtick = ref_build_tick(rplan, prefix_depth=1)
    tick = build_tick(plan, prefix_depth=1, device="cpu")
    rstate = ref_init_state(rplan, prefix_depth=1)
    state = init_state(plan, prefix_depth=1, device="cpu")
    n_new = 0
    for b in to_batches(stream160(seed=7), 16):
        rviews, _ = rforest.advance(ref_make_batch(**b))
        views, _ = forest.advance(make_batch(**b, device="cpu"))
        rstate, rres = rtick(rstate, ref_make_batch(**b),
                             rviews[rroot.pid])
        state, res = tick(state, make_batch(**b, device="cpu"),
                          views[root.pid])
        assert_same_tree(rres, res, "tick result")
        assert_same_tree(rstate, state, "suffix state")
        n_new += int(res.n_new_matches)
    assert n_new > 0


def test_event_time_watermark_with_sharing_equals_reference():
    """Under a watermark (event-time ticks) the node ticks reject edges
    at or below the released floor and bound their clock by the
    watermark, in lockstep with the suffix slots: every result, suffix
    state and node table equals the reference's, stragglers included."""
    import jax.numpy as jnp
    import numpy as np

    from repro.core.oracle import DataEdge as RefEdge

    stream = [RefEdge(e.src, e.dst,
                      max(e.ts - 80, 0) if i % 9 == 8 else e.ts,  # late
                      e.src_label, e.dst_label, e.edge_label)
              for i, e in enumerate(stream160(seed=11))]
    queries = [chain3(), chain2(), fork()]
    ref, svc = ref_svc(slots_per_group=2), port_svc(slots_per_group=2)
    register_all((ref, svc), queries)
    rejected = 0
    for b in to_batches(stream, 16):
        wm = int(np.max(np.where(b["valid"], b["ts"], 0))) - 6
        rout = ref.ingest(b, watermark=jnp.asarray(wm, jnp.int32))
        out = svc.ingest(b, watermark=wm)
        for qid in rout:
            assert_same_tree(rout[qid], out[qid], f"qid {qid}")
        assert_same_forest(ref, svc, "event-time tick")
    for qid in ref.registry.qids():
        assert_same_tree(ref.state(qid), svc.state(qid), f"qid {qid}")
        assert svc.matches(qid) == ref.matches(qid)
        rejected += int(svc.stats(qid).n_edges_rejected)
    assert rejected > 0
