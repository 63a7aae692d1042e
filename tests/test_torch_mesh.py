"""The port's replica-sharded serving (``repro_torch.runtime.mesh``)
against the JAX package.

The JAX ``ShardedSearchService`` cannot serve under the installed JAX
(its slot writes raise on the replica-sharded state), so the port is
held to the reference's own contract — sharded == single-device ==
oracle — with the JAX *single-device* ``ContinuousSearchService`` as the
reference, every comparison an equality:

* the differential of tests/_mesh_check.py on (R, spr) in {(1, 8),
  (2, 4), (8, 1)} with ``devices=("cpu",) * R``, prefix sharing on and
  tenant churn mid-stream: reported multisets, per-tenant ``matches()``
  and the oracle's window; tick by tick, at R = 1 every group state is
  bit-identical to the JAX service's (``slots_per_group = spr``) and at
  every R each tenant's engine row and the forest equal the JAX ones;
* ``build_mesh_slot_tick`` over replica blocks equals the JAX slot tick
  over the whole slot axis, and ``MeshTickStats`` equals the sums and
  the clock of the per-slot results;
* placement (round-robin, load-balanced), bad configurations with the
  reference's words, the manifest's config key for key,
  ``replica_refcounts`` against the JAX forest's;
* crash + restore through sharded checkpoints, onto the same replica
  count with zero warm builds and onto another (8 -> 2), exactly once;
* ``StreamSession(mesh=2)`` against a plain JAX session.
"""

import functools
import os
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import compile_plan as ref_compile_plan
from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.core.multi import build_slot_tick as ref_build_slot_tick
from repro.core.multi import init_slot_state as ref_init_slot_state
from repro.core.multi import write_slot as ref_write_slot
from repro.core.share import SharedPrefixForest as RefForest
from repro.core.state import make_batch as ref_make_batch
from repro.runtime.mesh import ShardedSearchService as RefSharded
from repro.runtime.service import ContinuousSearchService as RefService
from repro.stream.generator import to_batches

from _torch_util import (
    assert_same_tree,
    forest_leaves,
    leaves,
    port_edges,
    port_query,
    served_reports,
)
from repro_torch.core.multi import (
    SlotTickCache,
    build_slot_tick,
    init_slot_state,
    write_slot,
)
from repro_torch.core.plan import compile_plan
from repro_torch.core.share import SharedPrefixForest
from repro_torch.core.state import make_batch, map_state
from repro_torch.runtime import (
    ContinuousSearchService,
    LoadBalancedPlacement,
    MeshTickStats,
    RoundRobinPlacement,
    ShardedSearchService,
    build_mesh_slot_tick,
)
from test_service_restore import oracle_reported
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
QUERIES = [chain3(), chain2(), chain2(), chain2_other_labels(), fork(),
           tri()]
MESHES = [(1, 8), (2, 4), (8, 1)]
HALF = 80


def sharded(n_replicas, spr, tick_cache=None, **kw):
    return ShardedSearchService(
        n_replicas, spr, devices=("cpu",) * n_replicas,
        tick_cache=SlotTickCache() if tick_cache is None else tick_cache,
        **{**CAP, **kw})


def snapshot(svc):
    """Per tick: every live tenant's engine row, the forest, and every
    group's whole state (a mesh group's blocks concatenated)."""
    def group_state(g):
        if isinstance(svc, ContinuousSearchService) and g.spr is not None:
            return map_state(lambda *xs: torch.cat(xs), *g.sstate)
        return g.sstate

    def owned(tree):            # the port updates its tables in place
        return [x.copy() for x in leaves(tree)]
    return {
        "tenants": {q: owned(svc.state(q)) for q in svc.registry.qids()},
        "forest": [(k, [x.copy() for x in xs])
                   for k, xs in forest_leaves(svc)],
        "groups": [(g.gid, list(g.qids), owned(group_state(g)))
                   for g in svc._iter_groups()],
    }


def drive_with_churn(svc, stream, make_query=lambda q: q):
    """Register all queries, serve half, churn (two leave, one arrives),
    serve the rest.  Returns (reports, per-tick snapshots, live qids)."""
    qids = [svc.register(make_query(q), W) for q in QUERIES]
    count, _, snaps = served_reports(svc, stream[:HALF], record=snapshot,
                                     **SERVE)
    svc.unregister(qids[1])
    svc.unregister(qids[4])
    late = svc.register(make_query(chain2()), W)
    more, _, snaps2 = served_reports(svc, stream[HALF:], record=snapshot,
                                     **SERVE)
    return count + more, snaps + snaps2, \
        [qids[0], qids[2], qids[3], qids[5], late]


@functools.lru_cache(maxsize=None)
def reference_run(slots_per_group):
    """The JAX single-device service over the churn scenario."""
    ref = RefService(slots_per_group=slots_per_group,
                     tick_cache=RefSlotTickCache(), enable_sharing=True,
                     **CAP)
    count, snaps, live = drive_with_churn(ref, stream160())
    return ref, count, snaps, live


def _same_leaves(a, b, where):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, f"{where} leaf {i}"
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
            f"{where} leaf {i} differs"


# --------------------------------------------------------------------- #
# the differential: sharded == JAX single-device == oracle
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_replicas,spr", MESHES,
                         ids=[f"R{r}x{s}" for r, s in MESHES])
def test_mesh_differential_against_single_device_reference(n_replicas, spr):
    ref, count_ref, snaps_ref, live_ref = reference_run(8)
    svc = sharded(n_replicas, spr, enable_sharing=True)
    stream = stream160()
    count, snaps, live = drive_with_churn(svc, port_edges(stream),
                                          port_query)
    assert live == live_ref
    assert count and count == count_ref, (len(count), len(count_ref))
    for q in live:
        assert svc.matches(q) == ref.matches(q), q
    want_reported, want_window = oracle_reported(chain2(), W, stream[HALF:])
    assert {k for (q, k) in count if q == live[-1]} == want_reported
    assert svc.matches(live[-1]) == want_window
    # tick by tick: tenant rows and the forest; at R = 1 whole groups
    assert len(snaps) == len(snaps_ref)
    for t, (got, want) in enumerate(zip(snaps, snaps_ref)):
        assert sorted(got["tenants"]) == sorted(want["tenants"]), t
        for q in want["tenants"]:
            _same_leaves(want["tenants"][q], got["tenants"][q],
                         f"tick {t} qid {q}")
        assert [k for k, _ in got["forest"]] == \
            [k for k, _ in want["forest"]], t
        for (key, xs), (_, ys) in zip(want["forest"], got["forest"]):
            _same_leaves(xs, ys, f"tick {t} node {key}")
        if n_replicas == 1:
            assert [(g, q) for g, q, _ in got["groups"]] == \
                [(g, q) for g, q, _ in want["groups"]], t
            for (gid, _, xs), (_, _, ys) in zip(want["groups"],
                                                got["groups"]):
                _same_leaves(xs, ys, f"tick {t} group {gid}")
    # every group's replicas advanced one clock, and its per-replica
    # blocks sit on the replicas' devices
    stats = svc.last_mesh_stats()
    assert stats and all(s["t_clock"] > 0 for s in stats.values())
    for g in svc._iter_groups():
        assert len(g.sstate) == n_replicas
        assert all(b.params.active.shape == (spr,) for b in g.sstate)


def test_mesh_slot_tick_equals_reference_slot_tick():
    """``build_mesh_slot_tick`` over 2 replica blocks of 2 slots equals
    the JAX slot tick over the whole 4-slot axis, bit for bit, and its
    ``MeshTickStats`` are the sums and the clock of the slot results."""
    from test_engine_oracle import small_stream
    from test_service_restore import chain_query

    cap = dict(level_capacity=32, l0_capacity=32, max_new=16)
    rplan = ref_compile_plan(chain_query(), 20, **cap)
    plan = compile_plan(port_query(chain_query()), 20, **cap)
    rtick = ref_build_slot_tick(rplan)
    tick = build_mesh_slot_tick(plan, ("cpu", "cpu"))
    plain = build_slot_tick(plan)
    rs = ref_init_slot_state(rplan, 4)
    blocks = tuple(init_slot_state(plan, 2, device="cpu") for _ in range(2))
    whole = init_slot_state(plan, 4, device="cpu")
    for k in (0, 1, 3):                       # slot 2 stays unarmed
        rs = ref_write_slot(rs, rplan, k, rplan)
        write_slot(blocks[k // 2], plan, k % 2, plan)
        write_slot(whole, plan, k, plan)
    n_seen = 0
    for i, b in enumerate(to_batches(small_stream(96, n_vertices=6,
                                                  seed=61), 16)):
        rs, rres = rtick(rs, ref_make_batch(**b))
        blocks, res, stats = tick(blocks, make_batch(**b, device="cpu"))
        whole, pres = plain(whole, make_batch(**b, device="cpu"))
        assert isinstance(stats, MeshTickStats)
        cat = map_state(lambda *xs: torch.cat(xs), *blocks)
        assert_same_tree(rs, cat, f"tick {i} state")
        assert_same_tree(rres, res, f"tick {i} results")
        assert_same_tree(whole, cat, f"tick {i} plain slot tick")
        assert int(stats.n_matches) == int(np.asarray(rres.n_new_matches)
                                           .sum())
        assert int(stats.n_overflow) == int(np.asarray(rres.n_overflow)
                                            .sum())
        assert int(stats.t_clock) == int(np.asarray(rs.engines.t_now).max())
        assert all(x.dtype == torch.int32 and x.dim() == 0 for x in stats)
        n_seen += int(stats.n_matches)
    assert n_seen > 0


def test_last_mesh_stats_sum_to_the_reported_matches():
    """Per tick, the groups' ``MeshTickStats.n_matches`` sum to the
    matches reported that tick, ``n_overflow`` to the slot tables'
    drops, and ``t_clock`` is the engines' largest clock; overflowing
    capacities make the overflow count non-zero."""
    from test_engine_oracle import small_stream, tri_query
    from test_service_restore import chain_query

    cap = dict(level_capacity=4, l0_capacity=4, max_new=4)   # overflows
    from repro.core.query import QueryGraph

    hot = QueryGraph(3, (2, 2, 2), ((0, 1), (1, 2)),
                     prec=frozenset({(0, 1)}))     # the stream's hot labels
    svc = ShardedSearchService(2, 2, devices=("cpu", "cpu"),
                               tick_cache=SlotTickCache(), **cap)
    for q, w in [(hot, 200), (chain_query(), 200), (tri_query(), 250),
                 (hot, 90)]:
        svc.register(port_query(q), w)
    per_tick = []

    def on_tick(info):
        s = svc.last_mesh_stats()
        clock = max(int(b.engines.t_now.max())
                    for g in svc._iter_groups() for b in g.blocks())
        per_tick.append((info, s, clock))

    totals = svc.serve_stream(port_edges(small_stream(96, n_vertices=6,
                                                      seed=61)),
                              on_tick=on_tick, **SERVE)
    n_match = 0
    for info, s, clock in per_tick:
        assert set(s) == {g.gid for g in svc._iter_groups()}
        assert sum(v["n_overflow"] for v in s.values()) == info.n_overflow
        assert max(v["t_clock"] for v in s.values()) == clock
        n_match += sum(v["n_matches"] for v in s.values())
    assert n_match == sum(totals.values()) > 0
    assert sum(i.n_overflow for i, _, _ in per_tick) > 0
    assert sum(svc.replica_pressure()) == svc.overflow_pressure() > 0


def test_mesh_gauges_and_trace_events():
    """The ``mesh.*`` gauges have the reference's names; with a tracer
    each tick records one ``mesh.collectives`` event a group, after the
    barrier, carrying that group's ``MeshTickStats``."""
    import json

    from repro.obs import MetricsRegistry as RefRegistry
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.trace import memory_tracer
    from test_engine_oracle import small_stream
    from test_service_restore import chain_query

    tracer, buf = memory_tracer()
    obs = MetricsRegistry()
    svc = ShardedSearchService(2, 2, devices=("cpu", "cpu"), obs=obs,
                               tracer=tracer, tick_cache=SlotTickCache(),
                               **CAP)
    ref = RefSharded(n_replicas=1, slots_per_replica=2, obs=RefRegistry(),
                     tick_cache=RefSlotTickCache(), **CAP)
    assert {k for k in obs.snapshot() if k.startswith("mesh.")} == \
        {k for k in ref.obs.snapshot() if k.startswith("mesh.")} == {
            "mesh.n_replicas", "mesh.replica_load_max",
            "mesh.replica_pressure_max"}
    for w in (20, 30, 40):
        svc.register(port_query(chain_query()), w)
    totals = svc.serve_stream(port_edges(small_stream(96, n_vertices=6,
                                                      seed=61)), **SERVE)
    snap = obs.snapshot()
    assert snap["mesh.n_replicas"] == 2 and snap["mesh.replica_load_max"] == 2
    assert snap["mesh.replica_pressure_max"] == 0
    tracer.flush()
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    ev = [r for r in recs if r["span"] == "mesh.collectives"]
    assert len(ev) == svc.n_ticks * len(svc._iter_groups())
    assert sum(r["n_matches"] for r in ev) == sum(totals.values()) > 0
    for r in ev:                      # after the tick's barrier span
        spans = [x["span"] for x in recs if x["tick"] == r["tick"]]
        assert spans.index("tick.barrier") < spans.index("mesh.collectives")


# --------------------------------------------------------------------- #
# placement, configuration, manifest, refcounts
# --------------------------------------------------------------------- #
def test_placement_policies():
    svc = sharded(8, 2)
    assert isinstance(svc.placement, RoundRobinPlacement)
    for _ in range(8):
        svc.register(port_query(chain2()), W)
    assert svc.replica_load() == [1] * 8          # round-robin spread
    svc.register(port_query(chain2()), W)
    assert sorted(svc.replica_load()) == [1] * 7 + [2]
    # each tenant sits in its replica's block
    for qid, (g, k) in svc._location.items():
        assert g.qids[k] == qid and g.slot(k)[1] == k % 2

    lb = sharded(4, 4, placement="load_balanced")
    assert isinstance(lb.placement, LoadBalancedPlacement)
    for _ in range(6):
        lb.register(port_query(chain2()), W)
    # zero pressure everywhere -> pure tenant-count balancing
    assert sorted(lb.replica_load()) == [1, 1, 2, 2]
    assert lb.replica_pressure() == [0] * 4


def test_bad_configurations_raise_with_the_reference_words():
    with pytest.raises(ValueError, match="n_replicas") as got:
        ShardedSearchService(n_replicas=99, devices=("cpu",),
                             tick_cache=SlotTickCache())
    with pytest.raises(ValueError, match="n_replicas") as want:
        RefSharded(n_replicas=99, tick_cache=RefSlotTickCache())
    head = "n_replicas=99 needs that many devices (have 1"
    assert str(got.value).startswith(head)
    assert str(want.value).startswith(head)
    with pytest.raises(ValueError, match="placement") as got:
        ShardedSearchService(n_replicas=1, placement="nope", device="cpu",
                             tick_cache=SlotTickCache())
    with pytest.raises(ValueError, match="placement") as want:
        RefSharded(n_replicas=1, placement="nope",
                   tick_cache=RefSlotTickCache())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not both"):
        ShardedSearchService(1, devices=("cpu",), device="cpu")


def test_manifest_config_key_for_key_with_the_reference():
    """An empty service's config equals the JAX mesh service's (``mesh``
    in place of ``slots_per_group``; ``jit``/``donate`` are the port's
    False); with tenants, the whole manifest equals the JAX single-device
    service's but for that config and ``replica_refcounts``."""
    port = sharded(1, 2)
    ref = RefSharded(n_replicas=1, slots_per_replica=2,
                     tick_cache=RefSlotTickCache(), **CAP)
    got, want = port._manifest()["config"], ref._manifest()["config"]
    assert "slots_per_group" not in got
    assert sorted(got) == sorted(want)
    assert got["mesh"] == want["mesh"] == {
        "n_replicas": 1, "slots_per_replica": 2, "placement": "round_robin"}
    assert {k: v for k, v in got.items() if k not in ("jit", "donate")} == \
        {k: v for k, v in want.items() if k not in ("jit", "donate")}

    port = sharded(1, 4, enable_sharing=True)
    single = RefService(slots_per_group=4, tick_cache=RefSlotTickCache(),
                        enable_sharing=True, **CAP)
    for q in QUERIES:
        assert port.register(port_query(q), W) == single.register(q, W)
    mp, ms = port._manifest(), single._manifest()
    refcounts = mp.pop("replica_refcounts")
    assert {pid: sum(c) for pid, c in refcounts.items()} == \
        {str(e["pid"]): e["refcount"] for e in ms["forest"]["nodes"]}
    cfg_p, cfg_s = mp.pop("config"), ms.pop("config")
    assert mp == ms
    assert cfg_p.pop("mesh")["slots_per_replica"] == \
        cfg_s.pop("slots_per_group")
    for k in ("jit", "donate"):
        cfg_p.pop(k), cfg_s.pop(k)
    assert cfg_p == cfg_s


def test_replica_refcounts_equal_the_reference_forest():
    tc, rtc = SlotTickCache(), RefSlotTickCache()
    forest = SharedPrefixForest(tc, device="cpu")
    ref = RefForest(rtc, jit=False, donate=False)
    p3, p2 = (compile_plan(port_query(q), W, **CAP)
              for q in (chain3(), chain2()))
    r3, r2 = (ref_compile_plan(q, W, **CAP) for q in (chain3(), chain2()))
    a, b, c = (forest.acquire(p, epoch=0) for p in (p3, p2, p2))
    ra, rb, rc = (ref.acquire(p, epoch=0) for p in (r3, r2, r2))
    assert b is c and rb is rc
    for assign in ([0, 1, 1], [1, 0, 1], [2, 2, 0]):
        got = forest.replica_refcounts(zip((a, b, c), assign), 3)
        want = ref.replica_refcounts(zip((ra, rb, rc), assign), 3)
        assert got == want
        for node in forest.nodes():
            assert sum(got[node.pid]) == node.refcount
    got = forest.replica_refcounts([(a, 0), (b, 1), (c, 1)], 2)
    assert got[a.pid] == [1, 0] and got[b.pid] == [1, 2]


# --------------------------------------------------------------------- #
# crash + restore through sharded checkpoints
# --------------------------------------------------------------------- #
def test_crash_restore_same_size_and_reshard_exactly_once(tmp_path):
    ref_stream = stream160(seed=7)
    stream = port_edges(ref_stream)
    tc = SlotTickCache()
    # the reference's answer: the JAX single-device service
    single = RefService(slots_per_group=8, tick_cache=RefSlotTickCache(),
                        enable_sharing=True, **CAP)
    for q in QUERIES:
        single.register(q, W)
    want, _, _ = served_reports(single, ref_stream, **SERVE)
    full = sharded(8, 1, tick_cache=tc, enable_sharing=True,
                   compact_every=4)
    qids = [full.register(port_query(q), W) for q in QUERIES]
    count_full, _, _ = served_reports(full, stream, **SERVE)
    assert count_full == want and want

    def interrupted(sub, **restore_kwargs):
        ckpt = str(tmp_path / sub)
        svc = sharded(8, 1, tick_cache=tc, enable_sharing=True,
                      ckpt_dir=ckpt, compact_every=4)
        for q in QUERIES:
            svc.register(port_query(q), W)
        count, _, _ = served_reports(svc, stream[:96], ckpt_every=2,
                                     **SERVE)
        assert any(f.startswith("step_6.shard0of8") for f in
                   os.listdir(ckpt))
        del svc                                      # the crash
        before = tc.n_builds
        back = ShardedSearchService.restore(ckpt, tick_cache=tc,
                                            device="cpu", **restore_kwargs)
        rebuilds = tc.n_builds - before
        more, _, _ = served_reports(back, stream[back.n_edges_ingested:],
                                    **SERVE)
        return count + more, back, rebuilds

    count_same, same, rebuilds = interrupted("same")
    assert rebuilds == 0 and same.n_compiles == 0
    assert same.n_replicas == 8 and same.n_edges_ingested == 160
    assert count_same == want

    count_re, re, _ = interrupted("reshard", n_replicas=2)
    assert re.n_replicas == 2 and re.slots_per_replica == 1
    assert count_re == want
    for qid in qids:
        assert re.matches(qid) == full.matches(qid) == single.matches(qid)
        _same_leaves(leaves(single.state(qid)), leaves(re.state(qid)),
                     f"qid {qid} after reshard")
    assert all(k < 2 * re.slots_per_replica for _, k in
               re._location.values())
    # the base class hands a mesh checkpoint to the mesh service
    back = ContinuousSearchService.restore(str(tmp_path / "same"),
                                           tick_cache=tc, device="cpu")
    assert isinstance(back, ShardedSearchService) and back.n_replicas == 8


def test_restore_verifies_the_replica_refcount_partition(tmp_path):
    from repro_torch.checkpoint import CheckpointError, load_manifest

    svc = sharded(2, 4, enable_sharing=True, ckpt_dir=str(tmp_path))
    for q in QUERIES:
        svc.register(port_query(q), W)
    svc.checkpoint()
    svc.ckpt.wait()
    man = load_manifest(str(tmp_path), 1)
    parts = man["service"]["replica_refcounts"]
    assert parts and all(len(c) == 2 for c in parts.values())
    pid = next(iter(parts))
    parts[pid] = parts[pid][::-1] if parts[pid][0] != parts[pid][1] \
        else [parts[pid][0] + 1, parts[pid][1] - 1]
    back = ShardedSearchService.restore(str(tmp_path), device="cpu")
    assert back.n_replicas == 2
    with pytest.raises(CheckpointError, match="refcount partition"):
        back._verify_replica_refcounts(man["service"], 1)


# --------------------------------------------------------------------- #
# the api session
# --------------------------------------------------------------------- #
def test_mesh_session_matches_plain_reference_session(tmp_path):
    """``StreamSession(mesh=2)`` serves through the sharded service:
    the same delivered multiset as a plain JAX session, and a sharded
    checkpoint restores as a mesh session with the typed surface
    intact."""
    from repro.api import StreamSession as RefSession
    from repro_torch.api import StreamSession
    from test_api_session import chain_pattern as ref_chain_pattern
    from test_api_session import match_key
    from test_api_session import traffic as ref_traffic
    from test_torch_api_session import chain_pattern, traffic

    serve = dict(batch_size=16)
    plain = RefSession(slots_per_group=4, tick_cache=RefSlotTickCache(),
                       **CAP)
    sub_p = plain.register(ref_chain_pattern())
    plain.ingest(ref_traffic(160, seed=21), **serve)
    want = Counter(match_key(sub_p, m) for m in sub_p.drain())

    tc = SlotTickCache()
    sess = StreamSession(mesh={"n_replicas": 2, "slots_per_replica": 2},
                         ckpt_dir=str(tmp_path), tick_cache=tc,
                         devices=("cpu", "cpu"), **CAP)
    assert isinstance(sess.service, ShardedSearchService)
    sub = sess.register(chain_pattern())
    sess.ingest(traffic(160, seed=21), **serve)
    got = Counter(match_key(sub, m) for m in sub.drain())
    assert got == want and want
    sess.checkpoint()
    sess.close()
    del sess                                       # the crash

    builds = tc.n_builds
    back = StreamSession.restore(str(tmp_path), tick_cache=tc,
                                 devices=("cpu", "cpu"))
    assert isinstance(back.service, ShardedSearchService)
    assert back.service.n_replicas == 2 and tc.n_builds == builds
    (sub_r,) = back.subscriptions()
    assert sub_r.plan == sub.plan
    assert [tuple(m) for m in sub_r.matches()] == \
        [tuple(m) for m in sub_p.matches()]
    again = StreamSession.restore(str(tmp_path), tick_cache=tc,
                                  device="cpu")
    assert again.service.mesh == (torch.device("cpu"),) * 2

    # the shorthand: an int is the replica count, ``device`` places all
    sess_i = StreamSession(mesh=2, device="cpu", tick_cache=SlotTickCache(),
                           **CAP)
    assert isinstance(sess_i.service, ShardedSearchService)
    assert sess_i.service.n_replicas == 2
    with pytest.raises(ValueError, match="mesh"):
        StreamSession(devices=("cpu",), **CAP)
