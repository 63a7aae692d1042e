"""Event-time serving in the port: the frontier's watermark as the
engines' clock, held to the JAX package and to the event-time oracle.

The scenarios of tests/test_event_time.py on the port (CPU, REF joins);
every tolerance is equality:

* the watermark reaches every slot group and forest node of a tick as
  ONE int32 device scalar filled on the device: a frontier tick builds
  no more tensors from host data than a processing-time tick, however
  many groups and prefix nodes it advances (counted with patched
  ``torch.tensor``/``torch.as_tensor``; a Python-int watermark handed to
  ``ingest`` is counted once per group and node, the control);
* under forced eviction (the watermark unknown, ``NO_WATERMARK`` on the
  card) and under chaos, the port's ``serve_frontier`` tables equal the
  JAX ``serve_frontier``'s tick by tick;
* ``serve_frontier`` under chaos equals the event-time oracle replay of
  the emitted stream, expiry decisions included; the engine under any
  frontier release order mirrors the oracle edge for edge and matches
  the reference engine's windows and rejection counts;
* the satellite regressions: a FAILED source is terminal for
  exhaustion, the drain sentinel never surfaces, forced-gap drops are
  capacity pressure (not lateness) and degrade session health, and the
  watermark survives a manifest round trip.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from _torch_util import port_edges, port_query
from test_engine_oracle import small_stream
from test_service_restore import EventLog, chain_query
from test_torch_ingest import (
    CAP,
    NO_SLEEP,
    PORT,
    QUERIES,
    REF,
    SERVE,
    _frontier,
    _port_service,
    _ref_service,
    _same,
    _serve,
    chaos_sources,
    et,
    in_pkg,
    retry,
)


def edge(ts, src=0, dst=1, lab=0, P=PORT):
    return P.DataEdge(src=src, dst=dst, ts=ts, src_label=0, dst_label=0,
                      edge_label=lab)


# --------------------------------------------------------------------- #
# the watermark: one device scalar per tick
# --------------------------------------------------------------------- #
class _HostBuilds:
    """Counts tensors built from host data — each one a host-to-device
    copy on the card (``torch.full`` fills on the device and is not
    counted)."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("tensor", "as_tensor"):
            orig = getattr(torch, name)

            def wrap(data, *a, _o=orig, **k):
                if not torch.is_tensor(data):
                    self.n += 1
                return _o(data, *a, **k)

            monkeypatch.setattr(torch, name, wrap)


def _per_tick_builds(counter, serve) -> list:
    marks = []
    serve(lambda info: marks.append(counter.n))
    return [b - a for a, b in zip(marks, marks[1:])]


@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_frontier_tick_adds_no_host_copy(monkeypatch, share):
    stream = small_stream(160, n_vertices=9, seed=61)
    many, _ = _port_service(share)               # 2 groups (+ forest)
    for q, w in QUERIES:                          # a second tenant each
        many.register(port_query(q), w + 3)
    n_groups = len(many._iter_groups())
    n_nodes = 0 if many.forest is None else len(many.forest)
    assert n_groups >= 2 and (n_nodes > 1) == share
    one, _ = _port_service(share)
    one.unregister(1)
    counter = _HostBuilds(monkeypatch)

    frontier_many = _per_tick_builds(counter, lambda cb: many.serve_frontier(
        _frontier(PORT, stream, 7), on_tick=cb, **SERVE))
    frontier_one = _per_tick_builds(counter, lambda cb: one.serve_frontier(
        _frontier(PORT, stream, 7), on_tick=cb, **SERVE))
    stream_ticks = _per_tick_builds(counter, lambda cb: many.serve_stream(
        port_edges(stream), on_tick=cb, **SERVE))
    assert len(frontier_many) > 3
    per_tick = set(frontier_many) | set(frontier_one)
    assert per_tick == set(stream_ticks) and len(per_tick) == 1

    # the control: a Python-int watermark is one host copy per group and
    # per forest node
    from repro_torch.core.state import make_batch
    from repro_torch.stream.generator import to_batches

    batch = make_batch(**to_batches(port_edges(stream[:16]), 16)[0],
                       device="cpu")
    before = counter.n
    many.ingest(batch)
    none_wm = counter.n - before
    before = counter.n
    many.ingest(batch, watermark=10_000)
    assert counter.n - before - none_wm == n_groups + n_nodes
    before = counter.n
    many.ingest(batch, watermark=many._watermark_scalar(10_000))
    assert counter.n - before == none_wm


def test_watermark_scalar_is_int32_on_the_service_device():
    from repro_torch.core.engine import NO_WATERMARK

    svc, _ = _port_service()
    wm = svc._watermark_scalar(None)
    assert wm.dtype == torch.int32 and wm.shape == () \
        and wm.device.type == "cpu" and int(wm) == NO_WATERMARK
    assert int(svc._watermark_scalar(41)) == 41


# --------------------------------------------------------------------- #
# the service against the JAX service and the event-time oracle
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_forced_eviction_serving_equals_reference(share):
    """A reorder buffer far too small for the disorder: releases are
    forced past an unknown watermark (``NO_WATERMARK`` reaches the
    engines), stragglers are dropped as forced-gap.  Tables, ServeInfo
    and the frontier's accounting equal the reference's tick by tick."""
    stream = small_stream(160, n_vertices=9, seed=67)
    ref, _ = _ref_service(share)
    port, _ = _port_service(share)
    rfr = _frontier(REF, stream, 13, reorder_capacity=6)
    pfr = _frontier(PORT, stream, 13, reorder_capacity=6)
    _, rinfos, rsnaps = _serve(ref, rfr)
    plog, pinfos, psnaps = _serve(port, pfr)
    assert [i._replace(latency_ms=0) for i in pinfos] == \
        [i._replace(latency_ms=0) for i in rinfos]
    for t, (rs, ps) in enumerate(zip(rsnaps, psnaps)):
        for k, (a, b) in enumerate(zip(rs, ps)):
            _same(a, b, f"tick {t} table {k}")
    s = pfr.stats()
    assert s.n_forced > 0
    assert s.n_emitted + s.n_late_dropped + s.n_dropped_forced_gap \
        == len(stream)
    assert port._manifest()["ingest"] == ref._manifest()["ingest"]


def test_serve_frontier_equals_event_time_oracle_replay():
    """Under chaos, ``serve_frontier`` leaves each tenant's window equal
    to the event-time oracle replay of the emitted stream, with each
    edge inserted under the watermark of the tick that consumed it."""
    from repro_torch.core.oracle import OracleEngine

    stream = small_stream(120, n_vertices=9, seed=71)
    fr = _frontier(PORT, stream, 23)
    emitted, dropped = [], []
    fr.on("event", lambda e: emitted.append(e))
    fr.on("drop_late", lambda name, e, seq: dropped.append(e))
    fr.on("drop_forced_gap", lambda name, e, seq: dropped.append(e))
    svc, qids = _port_service()
    _, infos, _ = _serve(svc, fr)
    assert Counter(map(et, emitted)) + Counter(map(et, dropped)) == \
        Counter(map(et, stream))
    assert fr.stats().n_late_dropped == 0
    wm_per_edge, prev = [], 0
    for i in infos:
        wm_per_edge.extend([i.watermark] * (i.n_edges_ingested - prev))
        prev = i.n_edges_ingested
    assert len(wm_per_edge) == len(emitted)
    for (q, window), qid in zip(QUERIES, qids):
        oracle = OracleEngine(port_query(q), window)
        for e, wm in zip(emitted, wm_per_edge):
            oracle.insert(e, watermark=wm)
        assert svc.matches(qid) == oracle.matches()
        assert oracle.n_rejected == 0


def _chunks(P, raw, frac, delay, seed):
    """A frontier's (released edges, watermark) chunks over a sorted
    stream of chain edges, and its dropped edges."""
    stream = sorted((P.DataEdge(src=s, dst=d + 4, ts=ts, src_label=eid,
                                dst_label=eid + 1, edge_label=0)
                     for eid, s, d, ts in raw),
                    key=lambda e: (e.ts, e.src, e.dst, e.src_label))
    scripts = P.disordered_sources(stream, P.DisorderConfig(
        n_sources=2, disorder_frac=frac, max_delay=delay, seed=seed))
    fr = P.IngestFrontier(
        [P.ScriptedSource(f"s{i}", sc) for i, sc in enumerate(scripts)],
        allowed_lateness=12, **NO_SLEEP)
    dropped = []
    fr.on("drop_late", lambda name, e, seq: dropped.append(e))
    fr.on("drop_forced_gap", lambda name, e, seq: dropped.append(e))
    chunks = []
    while not fr.exhausted:
        fr.pump()
        got = fr.take_ready(limit=8)
        while got:
            chunks.append((got, fr.watermark()))
            got = fr.take_ready(limit=8)
    return stream, chunks, dropped


@pytest.mark.parametrize("seed", range(6))
def test_engine_under_frontier_release_order_equals_oracle_and_reference(
        seed):
    """The reorder-invariance sweep of the reference: for a frontier's
    release order, the port's engine under the per-chunk watermark
    mirrors the event-time oracle (window and rejection count), equals
    the reference engine's tables, and when nothing is dropped equals
    the canonically ordered run."""
    import jax.numpy as jnp

    from repro.core import compile_plan as ref_compile_plan
    from repro.core.engine import NO_WATERMARK as REF_NO_WATERMARK
    from repro.core.engine import build_tick as ref_build_tick
    from repro.core.state import init_state as ref_init_state
    from repro.core.state import make_batch as ref_make_batch
    from repro.stream.generator import to_batches as ref_to_batches
    from repro_torch.core.engine import build_tick, current_matches
    from repro_torch.core.oracle import OracleEngine
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.state import init_state, make_batch
    from repro_torch.stream.generator import to_batches
    from _torch_util import assert_same_tree

    rng = np.random.default_rng(5 + seed)
    raw = [(int(rng.integers(0, 2)), int(rng.integers(0, 4)),
            int(rng.integers(0, 4)), int(rng.integers(0, 61)))
           for _ in range(int(rng.integers(4, 13)))]
    frac, delay = float(rng.random()), int(rng.integers(0, 11))
    stream, chunks, dropped = _chunks(PORT, raw, frac, delay, seed)
    rstream, rchunks, rdropped = _chunks(REF, raw, frac, delay, seed)
    assert [([et(e) for e in es], wm) for es, wm in chunks] == \
        [([et(e) for e in es], wm) for es, wm in rchunks]
    assert Counter(map(et, [e for es, _ in chunks for e in es])) \
        + Counter(map(et, dropped)) == Counter(map(et, stream))

    q = chain_query()
    cap = dict(level_capacity=128, l0_capacity=128, max_new=128)
    plan = compile_plan(port_query(q), 20, **cap)
    rplan = ref_compile_plan(q, 20, **cap)
    tick = build_tick(plan, device="cpu")
    rtick = ref_build_tick(rplan)
    state, rstate = init_state(plan, device="cpu"), ref_init_state(rplan)
    for (edges, wm), (redges, _) in zip(chunks, rchunks):
        for b, rb in zip(to_batches(edges, 8), ref_to_batches(redges, 8)):
            state, _ = tick(state, make_batch(**b, device="cpu"),
                            torch.full((), -2**31 if wm is None else wm,
                                       dtype=torch.int32))
            rstate, _ = rtick(rstate, ref_make_batch(**rb), jnp.asarray(
                REF_NO_WATERMARK if wm is None else wm, jnp.int32))
    assert_same_tree(rstate, state, "engine state")
    assert int(state.stats.n_overflow) == 0

    oracle = OracleEngine(port_query(q), 20)
    for edges, wm in chunks:
        for e in edges:
            oracle.insert(e, watermark=wm)
    assert current_matches(plan, state) == oracle.matches()
    assert int(state.stats.n_edges_rejected) == oracle.n_rejected
    if not dropped:
        canon = init_state(plan, device="cpu")
        for b in to_batches(stream, 8):
            canon, _ = tick(canon, make_batch(**b, device="cpu"))
        assert current_matches(plan, state) == current_matches(plan, canon)


# --------------------------------------------------------------------- #
# satellite regressions
# --------------------------------------------------------------------- #
def test_failed_source_is_terminal_for_exhaustion():
    class DeadSource(PORT.Source):
        name = "dead"

        def connect(self, resume_from=0):
            pass

        def poll(self, max_events=64):
            raise PORT.SourceDisconnected("dead")

    fr = PORT.IngestFrontier(
        [PORT.ListSource("ok", [edge(1), edge(2), edge(3)]), DeadSource()],
        retry=PORT.RetryPolicy(max_attempts=2, base_delay_s=0.0),
        **NO_SLEEP)
    with pytest.raises(PORT.IngestError, match="retry budget exhausted"):
        fr.drain()
    out = []
    for _ in range(50):
        if fr.exhausted:
            break
        out.extend(fr.drain())
    assert fr.exhausted
    assert [e.ts for e in out] == [1, 2, 3]
    s = fr.stats()
    assert s.n_failed_sources == 1
    assert s.by_source["dead"]["state"] == "failed"
    assert s.watermark == 3


def test_watermark_never_surfaces_drain_sentinel():
    fr = PORT.IngestFrontier([PORT.ListSource("a", [edge(3), edge(7)])],
                             **NO_SLEEP)
    assert fr.watermark() is None
    while not fr.exhausted:
        fr.drain()
    wm = fr.watermark()
    assert wm == 7 != 2 ** 63 - 1
    assert np.iinfo(np.int32).min <= wm <= np.iinfo(np.int32).max
    assert fr.stats().watermark == fr.to_manifest()["watermark"] == 7
    fr2 = PORT.IngestFrontier([PORT.ListSource("a", [])], **NO_SLEEP)
    assert fr2.exhausted and fr2.watermark() is None


def _open_source(P):
    class OpenSource(P.Source):
        """A connected source that never produces and never exhausts."""

        name = "open"

        def connect(self, resume_from=0):
            pass

        def poll(self, max_events=64):
            return []

    return OpenSource()


def _forced_gap(P, fr):
    gap, late = [], []
    fr.on("drop_forced_gap", lambda name, e, seq: gap.append(e))
    fr.on("drop_late", lambda name, e, seq: late.append(e))
    for _ in range(3):
        fr.pump(max_per_source=4)
    released = fr.take_ready()
    fr.pump(max_per_source=4)
    return gap, late, released


def _gap_script(P):
    return [(i, edge(t, P=P)) for i, t in enumerate(range(12))] \
        + [(12, edge(0, P=P))]


def test_forced_gap_drops_attributed_to_capacity_not_lateness():
    def run(P):
        fr = P.IngestFrontier([P.ScriptedSource("full", _gap_script(P)),
                               _open_source(P)],
                              reorder_capacity=4, stall_patience=10 ** 9,
                              **NO_SLEEP)
        gap, late, released = _forced_gap(P, fr)
        return ([et(e) for e in gap], late, [et(e) for e in released],
                dict(fr.stats()), fr.to_manifest())

    got = run(PORT)
    assert got == run(REF)
    gap, late, released, s, man = got
    assert len(released) == 8 and s["n_forced"] == 8
    assert [e[2] for e in gap] == [0] and late == []
    assert s["n_dropped_forced_gap"] == 1 and s["n_late_dropped"] == 0
    assert s["watermark"] is None
    assert s["n_emitted"] + s["n_dropped_forced_gap"] + s["buffered"] == 13
    assert man["counters"]["n_dropped_forced_gap"] == 1


def test_session_health_degrades_on_forced_gap_drops():
    from repro_torch.api import DEGRADED, StreamSession

    sess = StreamSession(slots_per_group=2, device="cpu", **CAP)
    sess.register_query(port_query(chain_query()), 20)
    fr = sess.sources(
        {"full": PORT.ScriptedSource("full", _gap_script(PORT)),
         "open": _open_source(PORT)},
        reorder_capacity=4, stall_patience=10 ** 9, **NO_SLEEP)
    _forced_gap(PORT, fr)
    sess.serve_frontier(fr, batch_size=16, max_idle_rounds=2)
    st = sess.status()
    assert st.n_dropped_forced_gap == 1 and st.n_late_dropped == 0
    assert st.health == DEGRADED


def test_watermark_survives_manifest_roundtrip():
    stream = [edge(t) for t in range(8)]
    fr = PORT.IngestFrontier([PORT.ListSource("a", stream)],
                             allowed_lateness=2, **NO_SLEEP)
    fr.pump(max_per_source=4)
    got = fr.take_ready()
    assert got and not fr.exhausted
    man = fr.to_manifest()
    assert man["watermark"] == fr.watermark() is not None
    # the reference's frontier resumes the port's manifest and the other
    # way round: the same clock before any source produces
    ref_fr = REF.IngestFrontier.resume(
        man, [REF.ListSource("a", in_pkg(REF, stream))], allowed_lateness=2,
        **NO_SLEEP)
    fr2 = PORT.IngestFrontier.resume(man, [PORT.ListSource("a", stream)],
                                     allowed_lateness=2, **NO_SLEEP)
    assert fr2.watermark() == ref_fr.watermark() == man["watermark"]
    rest = []
    while not fr2.exhausted:
        rest.extend(fr2.drain())
    assert Counter(got) + Counter(rest) == Counter(stream)
    assert fr2.watermark() == 7 >= man["watermark"]


def test_restored_service_resumes_the_event_time_clock(tmp_path):
    """The watermark rides in the service checkpoint: after a restore the
    resumed frontier's clock is the checkpoint's before any source
    produces, and serving goes on from there with no late drop."""
    from repro_torch.runtime.service import ContinuousSearchService

    stream = small_stream(160, n_vertices=9, seed=68)
    svc, _ = _port_service(ckpt_dir=tmp_path)
    log = EventLog(svc, crash_at_tick=4)
    with pytest.raises(Exception, match="injected"):
        _serve(svc, _frontier(PORT, stream, 3), log, ckpt_every=2)
    svc.ckpt.wait()
    r = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    man = r.restored_ingest
    fr = PORT.IngestFrontier.resume(
        man, chaos_sources(PORT, stream, 3), allowed_lateness=80,
        stall_patience=4, retry=retry(PORT), **NO_SLEEP)
    assert fr.watermark() == man["watermark"] is not None
    _, infos, _ = _serve(r, fr)
    assert all(i.watermark >= man["watermark"] for i in infos)
    assert fr.stats().n_late_dropped == 0
    assert r.n_edges_ingested == len(stream)
