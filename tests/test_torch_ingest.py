"""The port's ingest frontier (sources, chaos, retry, merge, watermark)
held to the JAX package's, on the same seeded inputs.

The scenarios of tests/test_ingest_merge.py, test_ingest_props.py,
test_ingest_chaos.py and the frontier cases of test_api_session.py, run
through both packages.  Every tolerance here is equality:

* the frontier — round by round, the merged sequence, the watermark,
  ``stats()``, ``to_manifest()`` and every callback equal the
  reference's, under chaos, tight lateness and forced eviction;
* ``ChaosSource`` deliveries and injected faults, ``merge_event_streams``,
  ``SeqTracker``, ``RetryPolicy`` delays and the generator's disorder
  model (``split_stream``, ``disordered_sources``) equal the reference's;
* the service — the port's ``serve_frontier`` on REF leaves tables
  (slot groups and forest nodes) bit-identical to the JAX
  ``serve_frontier`` on REF after every tick, with the same ServeInfo;
  under chaos its match multiset equals its own ``serve_stream``'s;
  crash/restore through the frontier reports every match exactly once;
  a frontier manifest written by either package's service resumes in
  the other;
* the session — ``sources``/``serve_frontier``/``restored_ingest`` and a
  live frontier's ``status()`` as the reference's session reports them.
"""

import dataclasses
import importlib
import types
from collections import Counter

import numpy as np
import pytest

from repro.runtime.fault import SimulatedFailure

from _torch_util import port_edges, port_query
from test_engine_oracle import small_stream, tri_query
from test_service_restore import EventLog, chain_query

CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)
SERVE = dict(batch_size=16, min_batch=16, max_batch=16)
QUERIES = [(chain_query(), 20), (tri_query(), 25)]
NO_SLEEP = dict(sleep=lambda d: None)
KINDS = ("event", "drop_late", "drop_forced_gap", "duplicate", "reconnect",
         "stall", "watermark")


def _package(name: str):
    """The ingest-related names of ``repro`` or ``repro_torch`` in one
    namespace, so one scenario drives either package."""
    ns = types.SimpleNamespace(name=name)
    for mod in ("core.oracle", "runtime.fault", "stream.generator",
                "stream.ingest", "stream.chaos"):
        m = importlib.import_module(f"{name}.{mod}")
        for k, v in vars(m).items():
            if not k.startswith("__"):
                setattr(ns, k, v)
    return ns


REF = _package("repro")
PORT = _package("repro_torch")


def et(e) -> tuple:
    """A DataEdge of either package as a plain tuple."""
    return dataclasses.astuple(e)


def in_pkg(P, stream):
    return [P.DataEdge(*et(e)) for e in stream]


def retry(P):
    return P.RetryPolicy(max_attempts=8, base_delay_s=0.0, jitter_frac=0.0)


def chaos_sources(P, stream, seed=0):
    """The reference harness's traffic: 3 disordered, duplicated delivery
    scripts, each behind a fault-injecting transport (disconnects with
    rewind, duplicates, reordering, stalls, torn batches)."""
    scripts = P.disordered_sources(in_pkg(P, stream), P.DisorderConfig(
        n_sources=3, disorder_frac=0.3, max_delay=6, duplicate_rate=0.1,
        seed=seed + 1))
    cfg = dict(p_disconnect=0.08, rewind=4, p_duplicate=0.05,
               reorder_span=3, p_reorder=0.2, p_stall=0.05, stall_len=2,
               p_torn=0.05)
    return [P.ChaosSource(P.ScriptedSource(f"s{i}", sc),
                          P.ChaosConfig(seed=seed + 2 + i, **cfg))
            for i, sc in enumerate(scripts)]


def _norm(x):
    if dataclasses.is_dataclass(x):
        return et(x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


# --------------------------------------------------------------------- #
# the frontier, round by round
# --------------------------------------------------------------------- #
def frontier_trace(P, stream, chaos, seed, pump, limit, **kw):
    """Drive a frontier to exhaustion; every round's (entered, released
    edges, watermark, stats, manifest), every callback, and each chaos
    source's injected-fault counters."""
    if chaos:
        srcs = chaos_sources(P, stream, seed)
    else:
        scripts = P.disordered_sources(in_pkg(P, stream), P.DisorderConfig(
            n_sources=3, disorder_frac=0.5, max_delay=10, seed=seed))
        srcs = [P.ScriptedSource(f"s{i}", sc)
                for i, sc in enumerate(scripts)]
    fr = P.IngestFrontier(srcs, stall_patience=4, retry=retry(P),
                          **NO_SLEEP, **kw)
    calls = []
    for kind in KINDS:
        fr.on(kind, lambda *a, k=kind: calls.append((k, _norm(a))))
    rounds = []
    while not fr.exhausted:
        n_in = fr.pump(pump)
        out = fr.take_ready(limit)
        rounds.append((n_in, [et(e) for e in out], fr.watermark(),
                       _norm(dict(fr.stats())), fr.to_manifest()))
    injected = [(s.n_injected_disconnects, s.n_injected_duplicates,
                 s.n_injected_stalls, s.n_injected_torn)
                for s in srcs if hasattr(s, "n_injected_torn")]
    return rounds, calls, injected


@pytest.mark.parametrize("chaos, seed, pump, limit, kw", [
    (True, 7, 64, None, dict(allowed_lateness=80)),
    (True, 31, 5, 16, dict(allowed_lateness=80)),
    (True, 3, 8, 16, dict(allowed_lateness=0)),
    (True, 5, 8, None, dict(allowed_lateness=10, reorder_capacity=8)),
    (False, 17, 64, None, dict(allowed_lateness=0)),
    (False, 19, 7, 8, dict(allowed_lateness=100)),
], ids=["chaos", "chaos_small_rounds", "chaos_tight_lateness",
        "chaos_forced_eviction", "tight_lateness", "generous_lateness"])
def test_frontier_equals_reference_round_by_round(chaos, seed, pump, limit,
                                                  kw):
    stream = small_stream(200, n_vertices=9, seed=60 + seed)
    want = frontier_trace(REF, stream, chaos, seed, pump, limit, **kw)
    got = frontier_trace(PORT, stream, chaos, seed, pump, limit, **kw)
    assert got[0] == want[0]          # rounds: merge, watermark, stats
    assert got[1] == want[1]          # callbacks, in order
    assert got[2] == want[2]          # injected faults
    released = [e for r in got[0] for e in r[1]]
    s = got[0][-1][3]
    assert len(released) == s["n_emitted"]
    assert s["n_emitted"] + s["n_late_dropped"] \
        + s["n_dropped_forced_gap"] == len(stream)


def test_chaos_deliveries_equal_reference():
    """Poll by poll, with reconnects after injected disconnects: the same
    deliveries, the same faults at the same polls."""
    stream = small_stream(120, seed=62)

    def deliveries(P):
        out = []
        for src in chaos_sources(P, stream, seed=11):
            src.connect()
            polls = 0
            while not src.exhausted and polls < 500:
                polls += 1
                try:
                    out.append([(ev.seq, et(ev.edge))
                                for ev in src.poll(7)])
                except P.ChaosDisconnect as e:
                    assert isinstance(e, P.SimulatedFailure)
                    out.append(("disconnect", str(e)))
                    src.connect(resume_from=max(0, polls - 3))
            out.append((src.n_injected_disconnects,
                        src.n_injected_duplicates, src.n_injected_stalls,
                        src.n_injected_torn))
        return out

    got = deliveries(PORT)
    assert got == deliveries(REF)
    assert any(d[0] == "disconnect" for d in got if isinstance(d, tuple))


def test_chaos_default_config_is_passthrough():
    stream = in_pkg(PORT, small_stream(50, seed=62))
    plain = PORT.ListSource("s", stream)
    plain.connect()
    want = []
    while not plain.exhausted:
        want.extend(plain.poll(7))
    wrapped = PORT.ChaosSource(PORT.ListSource("s", stream))
    wrapped.connect()
    got = []
    while not wrapped.exhausted:
        got.extend(wrapped.poll(7))
    assert got == want and wrapped.name == "s"
    assert wrapped.n_injected_disconnects == wrapped.n_injected_duplicates \
        == 0


@pytest.mark.parametrize("seed", range(4))
def test_merge_event_streams_equals_reference(seed):
    """Seeded streams with equal-ts plateaus and duplicate payloads: the
    same merged order, invariant to the order the streams are listed in;
    strict mode raises on the same inputs."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(int(rng.integers(1, 5))):
        ts = np.sort(rng.integers(0, 12, int(rng.integers(0, 9))))
        streams.append([(int(t), int(rng.integers(0, 3)),
                         int(rng.integers(0, 3)), int(rng.integers(0, 2)))
                        for t in ts])

    def merged(P, order, strict=False):
        s = [[P.DataEdge(src=a, dst=b, ts=t, src_label=0, dst_label=0,
                         edge_label=lab) for t, a, b, lab in streams[i]]
             for i in order]
        return [et(e) for e in P.merge_event_streams(s, strict)]

    order = list(range(len(streams)))
    want = merged(REF, order)
    assert merged(PORT, order) == want
    assert merged(PORT, list(rng.permutation(order))) == want
    assert merged(PORT, order, strict=True) == want
    streams.append([(5, 0, 1, 0), (2, 0, 1, 0)])       # a regression
    order.append(len(order))
    assert merged(PORT, order) == merged(REF, order)
    for P in (REF, PORT):
        with pytest.raises(P.MonotonicityError, match="regressed"):
            merged(P, order, strict=True)


def test_seq_tracker_and_retry_policy_equal_reference():
    ops = [3, 0, 1, 1, 5, 2, 4, 4, 9, 6]
    tr = {P.name: P.SeqTracker() for P in (REF, PORT)}
    for s in ops:
        assert tr["repro"].add(s) == tr["repro_torch"].add(s)
        assert tr["repro"].to_manifest() == tr["repro_torch"].to_manifest()
    back = PORT.SeqTracker.from_manifest(tr["repro"].to_manifest())
    assert (back.floor, back.extras) == (tr["repro"].floor,
                                         tr["repro"].extras)
    for kw in (dict(), dict(base_delay_s=0.1, max_delay_s=0.5),
               dict(jitter_frac=0.0, multiplier=3.0)):
        pr, pp = REF.RetryPolicy(**kw), PORT.RetryPolicy(**kw)
        r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
        assert [pr.delay(a, r1) for a in range(1, 9)] == \
            [pp.delay(a, r2) for a in range(1, 9)]
        assert [pr.exhausted(a) for a in range(8)] == \
            [pp.exhausted(a) for a in range(8)]
    for bad in (dict(max_attempts=-1), dict(multiplier=0.5)):
        with pytest.raises(ValueError):
            PORT.RetryPolicy(**bad)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(n_sources=3, disorder_frac=0.4, max_delay=5, duplicate_rate=0.2,
         seed=11),
    dict(n_sources=4, disorder_frac=0.05, max_delay=64,
         duplicate_rate=0.01, seed=0),
], ids=["identity", "disordered", "chip_smoke_mix"])
def test_disorder_model_equals_reference(cfg):
    stream = small_stream(300, seed=6)

    def scripts(P):
        s = P.disordered_sources(in_pkg(P, stream), P.DisorderConfig(**cfg))
        return [[(seq, et(e)) for seq, e in sc] for sc in s]

    assert scripts(PORT) == scripts(REF)
    n = cfg.get("n_sources", 1)
    assert [[et(e) for e in p] for p in PORT.split_stream(
        in_pkg(PORT, stream), n, seed=9)] == \
        [[et(e) for e in p] for p in REF.split_stream(stream, n, seed=9)]


def test_adapter_retry_budget_and_failed_source():
    class Dead(PORT.Source):
        name = "dead"

        def connect(self, resume_from=0):
            pass

        def poll(self, max_events=64):
            raise PORT.SourceDisconnected("dead")

    a = PORT.SourceAdapter(Dead(), retry=PORT.RetryPolicy(
        max_attempts=2, base_delay_s=0.0), **NO_SLEEP)
    with pytest.raises(PORT.IngestError, match="retry budget exhausted"):
        a.pull()
    with pytest.raises(PORT.IngestError, match="failed"):
        a.pull()
    assert a.exhausted and a.n_retries == 3


def test_frontier_rejects_unknown_sources_callbacks_and_names():
    DE = PORT.DataEdge
    fr = PORT.IngestFrontier([PORT.ListSource("a", [DE(0, 1, 1, 0, 0, 0)])],
                             **NO_SLEEP)
    with pytest.raises(ValueError, match="unknown callback kind"):
        fr.on("typo", lambda *a: None)
    while not fr.exhausted:
        fr.drain()
    with pytest.raises(PORT.IngestError, match="not provided"):
        PORT.IngestFrontier.resume(fr.to_manifest(),
                                   [PORT.ListSource("b", [])], **NO_SLEEP)
    with pytest.raises(PORT.IngestError, match="unique"):
        PORT.IngestFrontier([PORT.ListSource("x", []),
                             PORT.ListSource("x", [])], **NO_SLEEP)


def test_fault_tolerant_loop_recovers_and_shares_retry_policy(tmp_path):
    """The port's loop: ``max_restarts`` maps onto a zero-delay
    ``RetryPolicy``; an injected failure restores the newest checkpoint
    and replays to the uninterrupted result; with ``mesh=``/``specs=``
    the restored state is placed onto the mesh (one of the two alone
    raises)."""
    import torch

    loop = PORT.FaultTolerantLoop(str(tmp_path / "a"), lambda s, i: s,
                                  lambda: 0, max_restarts=7)
    assert loop.retry.max_attempts == loop.max_restarts == 7
    assert loop.retry.base_delay_s == 0.0
    pol = PORT.RetryPolicy(max_attempts=2, base_delay_s=0.25)
    assert PORT.FaultTolerantLoop(str(tmp_path / "b"), lambda s, i: s,
                                  lambda: 0, retry=pol).retry is pol

    failed = []

    def step(state, i):
        if i == 7 and not failed:
            failed.append(i)
            raise PORT.SimulatedFailure("injected")
        return {"x": state["x"] + i}

    slept = []
    loop = PORT.FaultTolerantLoop(
        str(tmp_path / "c"), step, lambda: {"x": torch.zeros(3)},
        ckpt_every=3, sleep=slept.append)
    out = loop.run(10)
    assert torch.equal(out["x"], torch.full((3,), float(sum(range(10)))))
    assert loop.restarts == 1 and slept == [0.0]
    from repro_torch.core.distributed import P, make_mesh

    mesh = make_mesh((3,), ("data",), devices=("cpu",) * 3)
    failed.clear()
    loop = PORT.FaultTolerantLoop(
        str(tmp_path / "d"), step, lambda: {"x": torch.zeros(3)},
        ckpt_every=3, sleep=slept.append, mesh=mesh,
        specs={"x": P("data")})
    out = loop.run(10)
    assert torch.equal(out["x"], torch.full((3,), float(sum(range(10)))))
    assert loop.restarts == 1
    with pytest.raises(ValueError, match="mesh"):
        PORT.FaultTolerantLoop(str(tmp_path / "e"), step, lambda: 0,
                               mesh=mesh)


# --------------------------------------------------------------------- #
# the service: serve_frontier against the JAX service
# --------------------------------------------------------------------- #
def _ref_service(share=False, ckpt_dir=None):
    from repro.core.multi import SlotTickCache
    from repro.runtime.service import ContinuousSearchService

    svc = ContinuousSearchService(
        slots_per_group=2, tick_cache=SlotTickCache(), enable_sharing=share,
        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir), **CAP)
    return svc, [svc.register(q, w) for q, w in QUERIES]


def _port_service(share=False, ckpt_dir=None, tc=None):
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.service import ContinuousSearchService

    svc = ContinuousSearchService(
        slots_per_group=2, tick_cache=tc or SlotTickCache(),
        enable_sharing=share,
        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir), device="cpu",
        **CAP)
    return svc, [svc.register(port_query(q), w) for q, w in QUERIES]


def _frontier(P, stream, seed, **kw):
    return P.IngestFrontier(chaos_sources(P, stream, seed),
                            allowed_lateness=80, stall_patience=4,
                            retry=retry(P), **NO_SLEEP, **kw)


def _copy_leaves(tree) -> list:
    """Host copies of every leaf (the port updates tables in place, the
    JAX service donates its buffers)."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in _copy_leaves(v)]
    if hasattr(tree, "detach"):
        return [tree.detach().cpu().numpy().copy()]
    return [np.array(tree, copy=True)]


def _tables(svc) -> list:
    out = [_copy_leaves(g.sstate) for g in svc._iter_groups()]
    if svc.forest is not None:
        out += [((n.pid, n.depth, n.epoch, n.refcount),
                 _copy_leaves(n.state)) for n in svc.forest.nodes()]
    return out


def _same(a, b, where) -> None:
    if isinstance(a, tuple) and not isinstance(a, np.ndarray):
        assert a[0] == b[0], where
        a, b = a[1], b[1]
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and (x.dtype == np.bool_) == \
            (y.dtype == np.bool_), f"{where} leaf {i}"
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
            f"{where} leaf {i} differs"


def _serve(svc, fr, log=None, **kw):
    log = EventLog(svc) if log is None else log
    infos, snaps = [], []

    def on_tick(info):
        infos.append(info)
        snaps.append(_tables(svc))
        log.on_tick(info)

    svc.serve_frontier(fr, on_match=log.on_match, on_tick=on_tick,
                       **SERVE, **kw)
    return log, infos, snaps


@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_serve_frontier_tables_equal_reference_tick_by_tick(share):
    stream = small_stream(160, n_vertices=9, seed=61)
    ref, qids = _ref_service(share)
    port, pqids = _port_service(share)
    assert pqids == qids
    rfr, pfr = _frontier(REF, stream, 7), _frontier(PORT, stream, 7)
    rlog, rinfos, rsnaps = _serve(ref, rfr)
    plog, pinfos, psnaps = _serve(port, pfr)
    assert len(pinfos) == len(rinfos) > 3
    for t, (ri, pi, rs, ps) in enumerate(zip(rinfos, pinfos, rsnaps,
                                             psnaps)):
        assert pi._replace(latency_ms=0) == ri._replace(latency_ms=0), t
        assert len(ps) == len(rs)
        for k, (a, b) in enumerate(zip(rs, ps)):
            _same(a, b, f"tick {t} table {k}")
    assert Counter((q, k) for q, k, _ in plog.events) == \
        Counter((q, k) for q, k, _ in rlog.events)
    assert port._manifest()["ingest"] == ref._manifest()["ingest"]
    assert _norm(dict(pfr.stats())) == _norm(dict(rfr.stats()))
    if share:
        assert port.forest.total_overflow() == ref.forest.total_overflow()


@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_chaos_frontier_equals_serve_stream(share):
    """Transport faults never perturb the match stream: the chaos
    frontier's reports and window contents equal the port's own
    uninterrupted ``serve_stream`` over the canonical stream, and every
    delivery is emitted once, counted as a duplicate or counted as a
    drop."""
    stream = small_stream(160, n_vertices=9, seed=61)
    svc_a, qids = _port_service(share)
    log_a = EventLog(svc_a)
    svc_a.serve_stream(port_edges(stream), on_match=log_a.on_match,
                       on_tick=log_a.on_tick, **SERVE)
    count_a = Counter((q, k) for q, k, _ in log_a.events)
    assert count_a and max(count_a.values()) == 1

    fr = _frontier(PORT, stream, 7)
    svc_b, _ = _port_service(share)
    log_b, infos, _ = _serve(svc_b, fr)
    assert Counter((q, k) for q, k, _ in log_b.events) == count_a
    for qid in qids:
        assert svc_b.matches(qid) == svc_a.matches(qid)
    s = fr.stats()
    assert s.n_emitted == len(stream) and s.n_late_dropped == 0
    assert s.n_duplicates > 0 and s.n_reconnects > 0
    assert sum(i.n_duplicates for i in infos) == s.n_duplicates
    assert sum(i.n_reconnects for i in infos) == s.n_reconnects
    assert all(i.n_late_dropped == 0 for i in infos)
    assert svc_b.n_edges_ingested == len(stream)


@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_crash_restore_through_frontier_is_exactly_once(tmp_path, share):
    from repro_torch.runtime.service import ContinuousSearchService

    stream = small_stream(160, n_vertices=9, seed=64)
    svc_a, qids = _port_service(share)
    log_a = EventLog(svc_a)
    svc_a.serve_stream(port_edges(stream), on_match=log_a.on_match,
                       on_tick=log_a.on_tick, **SERVE)
    count_a = Counter((q, k) for q, k, _ in log_a.events)

    svc_b, _ = _port_service(share, ckpt_dir=tmp_path)
    tc = svc_b.tick_cache
    log_b = EventLog(svc_b, crash_at_tick=5)
    with pytest.raises(SimulatedFailure):
        _serve(svc_b, _frontier(PORT, stream, 31), log_b, ckpt_every=3)
    svc_b.ckpt.wait()

    builds = tc.n_builds
    svc_r = ContinuousSearchService.restore(str(tmp_path), tick_cache=tc,
                                            device="cpu")
    assert tc.n_builds == builds                    # warm: no rebuild
    man = svc_r.restored_ingest
    assert {s["name"] for s in man["sources"]} == {"s0", "s1", "s2"}
    assert svc_r.n_edges_ingested == man["counters"]["n_emitted"]
    assert svc_r.n_ticks == 3
    # an exactly-once consumer drops reports newer than the checkpoint
    kept = [(q, k) for q, k, off in log_b.events
            if off <= svc_r.n_edges_ingested]
    fr_r = PORT.IngestFrontier.resume(
        man, chaos_sources(PORT, stream, 31), allowed_lateness=80,
        stall_patience=4, retry=retry(PORT), **NO_SLEEP)
    log_r, _, _ = _serve(svc_r, fr_r)
    assert Counter(kept) + Counter((q, k) for q, k, _ in log_r.events) \
        == count_a
    for qid in qids:
        assert svc_r.matches(qid) == svc_a.matches(qid)
    s = fr_r.stats()
    assert s.n_emitted == len(stream) and s.n_late_dropped == 0
    assert svc_r.n_edges_ingested == len(stream)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frontier_manifest_resumes_across_packages(tmp_path, direction):
    """One package's service serves a chaos frontier with checkpoints and
    crashes; the other package restores the checkpoint, resumes the
    frontier from ``restored_ingest`` over fresh sources and finishes:
    every match reported exactly once."""
    from repro.core.multi import SlotTickCache as RefSlotTickCache
    from repro.runtime.service import ContinuousSearchService as RefService
    from repro_torch.runtime.service import ContinuousSearchService

    stream = small_stream(160, n_vertices=9, seed=64)
    svc_a, qids = _port_service()
    log_a = EventLog(svc_a)
    svc_a.serve_stream(port_edges(stream), on_match=log_a.on_match,
                       on_tick=log_a.on_tick, **SERVE)
    count_a = Counter((q, k) for q, k, _ in log_a.events)

    W, R = (REF, PORT) if direction == "jax_to_port" else (PORT, REF)
    if W is REF:
        svc_w, _ = _ref_service(ckpt_dir=tmp_path)
    else:
        svc_w, _ = _port_service(ckpt_dir=tmp_path)
    log_w = EventLog(svc_w, crash_at_tick=5)
    with pytest.raises(SimulatedFailure):
        _serve(svc_w, _frontier(W, stream, 31), log_w, ckpt_every=3)
    svc_w.ckpt.wait()

    if R is PORT:
        svc_r = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    else:
        svc_r = RefService.restore(str(tmp_path),
                                   tick_cache=RefSlotTickCache())
    man = svc_r.restored_ingest
    assert man == svc_w._manifest()["ingest"] or \
        man["counters"]["n_emitted"] == svc_r.n_edges_ingested
    assert svc_r.n_edges_ingested == man["counters"]["n_emitted"]
    kept = [(q, k) for q, k, off in log_w.events
            if off <= svc_r.n_edges_ingested]
    fr_r = R.IngestFrontier.resume(
        man, chaos_sources(R, stream, 31), allowed_lateness=80,
        stall_patience=4, retry=retry(R), **NO_SLEEP)
    log_r, _, _ = _serve(svc_r, fr_r)
    assert Counter(kept) + Counter((q, k) for q, k, _ in log_r.events) \
        == count_a
    assert fr_r.stats().n_emitted == len(stream)
    assert svc_r.n_edges_ingested == len(stream)


# --------------------------------------------------------------------- #
# the session: sources, serve_frontier, restored_ingest, status
# --------------------------------------------------------------------- #
def _session(P, **kw):
    if P is REF:
        from repro.api import StreamSession
        from repro.core.multi import SlotTickCache
        return StreamSession(slots_per_group=2, tick_cache=SlotTickCache(),
                             **CAP, **kw)
    from repro_torch.api import StreamSession
    from repro_torch.core.multi import SlotTickCache
    return StreamSession(slots_per_group=2, tick_cache=SlotTickCache(),
                         device="cpu", **CAP, **kw)


def _status(st) -> dict:
    d = st._asdict()
    d["ingest"] = None if d["ingest"] is None else _norm(dict(d["ingest"]))
    return d


@pytest.mark.parametrize("case", ["late_drop", "generous_lateness"])
def test_session_frontier_status_equals_reference(case):
    """``sources``/``serve_frontier`` through the api: the same typed
    matches per subscription and the same ``status()`` (health, frontier
    counters, watermark, the live frontier's stats) as the reference's
    session."""
    def run(P):
        sess = _session(P, late_drop_threshold=0.01)
        subs = [sess.register_query(q if P is REF else port_query(q), w)
                for q, w in QUERIES]
        E = P.DataEdge
        if case == "late_drop":
            # source "b" delivers an ancient event on its second pump
            # round, after the merged floor passed it: a late drop
            def edge(ts):
                return E(src=0, dst=1, ts=ts, src_label=0, dst_label=0,
                         edge_label=0)
            named = {"a": P.ListSource("a", [edge(t)
                                             for t in range(50, 56)]),
                     "b": P.ScriptedSource(
                         "b", [(i, edge(50 + i)) for i in range(64)]
                         + [(64, edge(1))])}
            lateness = 0
        else:
            stream = small_stream(200, n_vertices=9, seed=61)
            scripts = P.disordered_sources(in_pkg(P, stream),
                                           P.DisorderConfig(
                n_sources=3, disorder_frac=0.5, max_delay=10, seed=19))
            named = {f"s{i}": P.ScriptedSource(f"s{i}", sc)
                     for i, sc in enumerate(scripts)}
            lateness = 100
        fr = sess.sources(named, allowed_lateness=lateness,
                          retry=retry(P), **NO_SLEEP)
        sess.serve_frontier(fr, **SERVE)
        return _status(sess.status()), [sorted(s.drain()) for s in subs]

    want, got = run(REF), run(PORT)
    assert got[0] == want[0]
    assert got[1] == want[1]
    if case == "late_drop":
        assert got[0]["n_late_dropped"] == 1
        assert got[0]["health"] == "degraded"
    else:
        assert got[0]["health"] == "active" and any(got[1])


def test_session_frontier_crash_restore_is_exactly_once(tmp_path):
    """The api path of the exactly-once resume: crash a session's
    frontier loop, ``StreamSession.restore``, then ``sources(...,
    resume=session.restored_ingest)`` over fresh chaos sources; health
    attribution (the registry's ``ingest.*`` counters) survives."""
    from repro_torch.api import StreamSession

    stream = small_stream(160, n_vertices=9, seed=66)

    def run(sess, fr, crash=None):
        subs = sess.subscriptions()
        got = []

        def on_tick(info):
            for sub in subs:
                got.extend((sub.qid, m, info.n_edges_ingested)
                           for m in sub.drain())
            if crash is not None and info.tick == crash:
                raise SimulatedFailure("crash")

        try:
            sess.serve_frontier(fr, batch_size=16, min_batch=16,
                                max_batch=16, on_tick=on_tick,
                                ckpt_every=3 if crash else 0)
        except SimulatedFailure:
            pass
        return got

    sess_a = _session(PORT)
    for q, w in QUERIES:
        sess_a.register_query(port_query(q), w)
    want = Counter((q, m) for q, m, _ in run(
        sess_a, sess_a.sources(
            {s.name: s for s in chaos_sources(PORT, stream, 5)},
            allowed_lateness=80, retry=retry(PORT), **NO_SLEEP)))
    assert want and max(want.values()) == 1

    sess_b = _session(PORT, ckpt_dir=str(tmp_path))
    for q, w in QUERIES:
        sess_b.register_query(port_query(q), w)
    before = run(sess_b, sess_b.sources(
        {s.name: s for s in chaos_sources(PORT, stream, 5)},
        allowed_lateness=80, retry=retry(PORT), **NO_SLEEP), crash=5)
    sess_b.service.ckpt.wait()
    assert sess_b.status().watermark is not None

    restored = StreamSession.restore(str(tmp_path), device="cpu")
    man = restored.restored_ingest
    assert man is not None and man == restored.service.restored_ingest
    done = restored.service.n_edges_ingested
    assert done == man["counters"]["n_emitted"]
    kept = Counter((q, m) for q, m, off in before if off <= done)
    fr = restored.sources(
        {s.name: s for s in chaos_sources(PORT, stream, 5)},
        resume=man, allowed_lateness=80, retry=retry(PORT), **NO_SLEEP)
    after = Counter((q, m) for q, m, _ in run(restored, fr))
    assert kept + after == want
    st = restored.status()
    assert st.ingest["n_emitted"] == len(stream)
    assert st.n_late_dropped == 0 and st.health == "active"
    assert restored.metrics()["ingest.n_emitted"] == len(stream)


def test_ingest_chaos_example_runs_on_cpu(capsys):
    """``examples/torch_ingest_chaos.py --device cpu`` end to end: chaos
    sources, a crash, restore with ``restored_ingest``, exactly once."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_ingest_chaos.py"
    spec = importlib.util.spec_from_file_location("torch_ingest_chaos", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "window state == fault-free reference: True" in out
    assert "ingest chaos OK" in out and "late drops: 0" in out
