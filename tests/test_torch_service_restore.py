"""Crash/restore of the port's service, held to the JAX package.

The scenarios of tests/test_service_restore.py on the port (CPU, REF
joins):

* run A serves a seeded stream uninterrupted, checkpointing as it goes;
  its reports equal the reference service's on the same stream and the
  oracle's, each exactly once;
* run B crashes at tick 5, is restored from the newest usable step
  (tick 3) and replays the rest: a consumer that drops reports newer
  than the checkpoint sees run A's multiset exactly once, with sharing
  off and on, and the warm ``SlotTickCache`` builds nothing
  (``n_builds`` unchanged across the restore);
* a cold-cache restore, a torn newest step, ``StreamServer`` as a
  one-tenant wrapper (foreign, all-torn and capacity-drifted checkpoint
  directories refused), custom decompositions surviving restore,
  capacity drift refused at registration, restore overriding the
  serving knobs, and small batch bounds served as asked.
"""

from collections import Counter

import numpy as np
import pytest

from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.runtime.fault import SimulatedFailure
from repro.runtime.service import ContinuousSearchService as RefService

from _torch_util import assert_same_tree, port_edges, port_query
from repro_torch.checkpoint import CheckpointError, checkpoint_steps
from repro_torch.core.multi import SlotTickCache
from repro_torch.core.plan import compile_plan
from repro_torch.launch.stream_serve import StreamServer
from repro_torch.runtime.service import ContinuousSearchService
from test_engine_oracle import small_stream, star_query, tri_query
from test_service_restore import (
    QUERIES,
    EventLog,
    chain_query,
    oracle_reported,
)

CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)
SERVE = dict(batch_size=16, min_batch=16, max_batch=16)


def _fresh(ckpt_dir, tc, share=False, **kw):
    svc = ContinuousSearchService(
        slots_per_group=2, tick_cache=tc, ckpt_dir=str(ckpt_dir),
        enable_sharing=share, device="cpu", **{**CAP, **kw})
    qids = [svc.register(port_query(q), w) for q, w in QUERIES]
    return svc, qids


@pytest.mark.parametrize("share", [False, True])
def test_crash_restore_differential(tmp_path, share):
    tc = SlotTickCache()
    ref_stream = small_stream(160, n_vertices=9, seed=41)
    stream = port_edges(ref_stream)

    # ---- run A: uninterrupted, held to the reference and the oracle ---
    svc_a, qids = _fresh(tmp_path / "a", tc, share)
    log_a = EventLog(svc_a)
    svc_a.serve_stream(stream, on_match=log_a.on_match,
                       on_tick=log_a.on_tick, ckpt_every=3, **SERVE)
    builds_a = tc.n_builds
    count_a = Counter((qid, k) for qid, k, _ in log_a.events)
    assert count_a and max(count_a.values()) == 1

    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     enable_sharing=share, **CAP)
    assert [ref.register(q, w) for q, w in QUERIES] == qids
    log_ref = EventLog(ref)
    ref.serve_stream(ref_stream, on_match=log_ref.on_match,
                     on_tick=log_ref.on_tick, **SERVE)
    assert Counter((q, k) for q, k, _ in log_ref.events) == count_a
    for qid, (q, w) in zip(qids, QUERIES):
        want_reported, want_window = oracle_reported(q, w, ref_stream)
        assert {k for (qq, k, _) in log_a.events if qq == qid} == \
            want_reported
        assert svc_a.matches(qid) == want_window == ref.matches(qid)

    # ---- run B: crash at tick 5, past the tick-3 checkpoint ------------
    svc_b, qids_b = _fresh(tmp_path / "b", tc, share)
    assert qids_b == qids and svc_b.n_compiles == 0
    log_b = EventLog(svc_b, crash_at_tick=5)
    with pytest.raises(SimulatedFailure):
        svc_b.serve_stream(stream, on_match=log_b.on_match,
                           on_tick=log_b.on_tick, ckpt_every=3, **SERVE)
    svc_b.ckpt.wait()

    # ---- restore: same tenants, same slots, zero builds ----------------
    svc_r = ContinuousSearchService.restore(str(tmp_path / "b"),
                                            tick_cache=tc, device="cpu")
    assert svc_r.n_compiles == 0 and tc.n_builds == builds_a
    assert svc_r.registry.qids() == qids
    assert svc_r.n_ticks == 3 and svc_r.n_edges_ingested == 3 * 16
    for qid, (q, w) in zip(qids, QUERIES):
        assert svc_r.registry.get(qid).query == port_query(q)
        assert svc_r.registry.get(qid).window == w

    kept = [(qid, k, off) for qid, k, off in log_b.events
            if off <= svc_r.n_edges_ingested]
    log_r = EventLog(svc_r)
    svc_r.serve_stream(stream[svc_r.n_edges_ingested:],
                       on_match=log_r.on_match, on_tick=log_r.on_tick,
                       ckpt_every=3, **SERVE)
    assert svc_r.n_edges_ingested == len(stream)
    assert tc.n_builds == builds_a               # nothing built end to end

    count_b = Counter((qid, k) for qid, k, _ in kept + log_r.events)
    assert count_b == count_a                    # exactly once
    for qid in qids:
        assert svc_r.matches(qid) == svc_a.matches(qid)
        assert int(svc_r.stats(qid).n_matches_total) == \
            int(svc_a.stats(qid).n_matches_total)
        assert_same_tree(svc_a.state(qid), svc_r.state(qid), f"qid {qid}")


def test_restore_with_cold_tick_cache(tmp_path):
    tc = SlotTickCache()
    stream = port_edges(small_stream(160, n_vertices=9, seed=42))
    svc, qids = _fresh(tmp_path, tc)
    svc.serve_stream(stream, ckpt_every=4, **SERVE)
    cold = SlotTickCache()
    svc2 = ContinuousSearchService.restore(str(tmp_path), tick_cache=cold,
                                           device="cpu")
    assert svc2.n_compiles == cold.n_builds == 2
    for qid in qids:
        assert svc2.matches(qid) == svc.matches(qid)


def test_restore_skips_torn_checkpoint(tmp_path):
    tc = SlotTickCache()
    stream = port_edges(small_stream(160, n_vertices=9, seed=43))
    svc, qids = _fresh(tmp_path, tc)
    svc.serve_stream(stream, ckpt_every=2, **SERVE)
    steps = checkpoint_steps(str(tmp_path))
    assert steps[-1] == 10
    npz = tmp_path / f"step_{steps[-1]}.npz"
    npz.write_bytes(npz.read_bytes()[:128])
    svc2 = ContinuousSearchService.restore(str(tmp_path), tick_cache=tc,
                                           device="cpu")
    assert svc2.n_ticks == 8 and svc2.n_edges_ingested == 8 * 16
    svc2.serve_stream(stream[svc2.n_edges_ingested:], **SERVE)
    for qid in qids:
        assert svc2.matches(qid) == svc.matches(qid)
        assert int(svc2.stats(qid).n_matches_total) == \
            int(svc.stats(qid).n_matches_total)


def test_stream_server_is_a_service_wrapper(tmp_path):
    tc = SlotTickCache()
    stream = port_edges(small_stream(160, n_vertices=9, seed=44))
    plan = compile_plan(port_query(chain_query()), 20, **CAP)
    hits = []
    s1 = StreamServer(plan, ckpt_dir=str(tmp_path), tick_cache=tc,
                      device="cpu")
    assert isinstance(s1.service, ContinuousSearchService)
    assert s1.service.backend == "ref"
    for attr in ("tick", "state_"):
        assert not hasattr(s1, attr)
    total = s1.ingest(stream[:80], on_match=lambda b, t: hits.append(len(b)),
                      ckpt_every=2, batch_size=16)
    aimd = s1._coalescer
    total += s1.ingest(stream[80:], on_match=lambda b, t: hits.append(len(b)),
                       ckpt_every=2, batch_size=16)
    assert s1._coalescer is aimd
    assert total == sum(hits) > 0
    assert s1.resume_offset == len(stream)

    s2 = StreamServer(plan, ckpt_dir=str(tmp_path), tick_cache=tc,
                      device="cpu")
    assert s2.ticks == s1.ticks and s2.resume_offset == len(stream)
    assert s2.matches() == s1.matches()
    assert s2.service.n_compiles == 0
    assert s2.subscription.matches() == s1.subscription.matches()

    other = compile_plan(port_query(tri_query()), 25, **CAP)
    with pytest.raises(ValueError, match="different query"):
        StreamServer(other, ckpt_dir=str(tmp_path), tick_cache=tc,
                     device="cpu")


def test_custom_decomposition_plan_round_trips(tmp_path):
    from repro_torch.core.decompose import TCSubquery
    from repro_torch.core.registry import plan_decomposition

    q = port_query(tri_query())
    custom = [TCSubquery(frozenset({e}), (e,)) for e in range(3)]
    plan = compile_plan(q, 25, decomposition=custom, **CAP)
    assert plan_decomposition(plan) == [(0,), (1,), (2,)]
    stream = port_edges(small_stream(160, n_vertices=9, seed=45))
    svc = ContinuousSearchService(slots_per_group=2, ckpt_dir=str(tmp_path),
                                  device="cpu", **CAP)
    qid = svc.register(q, 25, plan=plan)
    svc.serve_stream(stream[:96], ckpt_every=2, **SERVE)
    svc2 = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert plan_decomposition(svc2.registry.get(qid).plan) == \
        [(0,), (1,), (2,)]
    svc2.serve_stream(stream[96:], **SERVE)
    svc.serve_stream(stream[96:], **SERVE)
    assert svc2.matches(qid) == svc.matches(qid)


def test_plan_with_divergent_capacities_rejected():
    q = port_query(star_query())
    plan = compile_plan(q, 15, level_capacity=128, l0_capacity=128,
                        max_new=64)
    svc = ContinuousSearchService(level_capacity=128, l0_capacity=256,
                                  max_new=64, device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        svc.register(q, 15, plan=plan)
    ok = ContinuousSearchService(level_capacity=128, l0_capacity=128,
                                 max_new=64, device="cpu")
    ok.register(q, 15, plan=plan)


def test_restore_overrides_serving_knobs(tmp_path):
    stream = port_edges(small_stream(96, n_vertices=9, seed=46))
    svc = ContinuousSearchService(slots_per_group=2, extract_matches=False,
                                  ckpt_dir=str(tmp_path), device="cpu",
                                  **CAP)
    qid = svc.register(port_query(chain_query()), 20)
    svc.serve_stream(stream, ckpt_every=2, **SERVE)
    svc2 = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert svc2.extract_matches is False
    svc3 = ContinuousSearchService.restore(
        str(tmp_path), extract_matches=True, backend="ref", device="cpu")
    assert svc3.extract_matches is True and svc3.backend == "ref"
    assert svc3.registry.qids() == [qid]
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousSearchService.restore(str(tmp_path), backend="cuda",
                                        device="cpu")


def test_serve_stream_honors_small_batch_bounds():
    stream = port_edges(small_stream(64, n_vertices=9, seed=47))
    svc = ContinuousSearchService(slots_per_group=2, device="cpu", **CAP)
    svc.register(port_query(chain_query()), 20)
    chunks = []
    svc.serve_stream(stream[:32], on_tick=lambda i: chunks.append(i.chunk),
                     batch_size=8)
    assert chunks[0] == 8
    chunks.clear()
    svc.serve_stream(stream[32:], on_tick=lambda i: chunks.append(i.chunk),
                     batch_size=64, max_batch=16)
    assert chunks[0] == 16
    svc_nx = ContinuousSearchService(extract_matches=False, device="cpu",
                                     **CAP)
    svc_nx.register(port_query(chain_query()), 20)
    with pytest.raises(ValueError, match="extract_matches"):
        svc_nx.serve_stream(stream, on_match=lambda q, b, t: None)


@pytest.mark.parametrize("case", ["capacity_drift", "foreign", "all_torn"])
def test_stream_server_refuses_unusable_directories(tmp_path, case):
    """A restart over a checkpoint it cannot honour fails loudly: a plan
    recompiled with other capacities, a directory of non-service
    checkpoints, a directory whose every step is torn."""
    from repro_torch.checkpoint import save_checkpoint

    plan = compile_plan(port_query(chain_query()), 20, **CAP)
    if case == "foreign":
        save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)})
        with pytest.raises(ValueError, match="service manifest"):
            StreamServer(plan, ckpt_dir=str(tmp_path), device="cpu")
        return
    s1 = StreamServer(plan, ckpt_dir=str(tmp_path), device="cpu")
    s1.ingest(port_edges(small_stream(64, n_vertices=9, seed=50)),
              ckpt_every=1, batch_size=16)
    if case == "capacity_drift":
        bigger = compile_plan(port_query(chain_query()), 20,
                              level_capacity=512, l0_capacity=512,
                              max_new=256)
        with pytest.raises(ValueError, match="capacities or decomposition"):
            StreamServer(bigger, ckpt_dir=str(tmp_path), device="cpu")
        return
    for s in checkpoint_steps(str(tmp_path)):
        p = tmp_path / f"step_{s}.npz"
        p.write_bytes(p.read_bytes()[:16])
    with pytest.raises(CheckpointError, match="none are usable"):
        StreamServer(plan, ckpt_dir=str(tmp_path), device="cpu")
