"""The port's observability layer against the JAX package's.

* The same calls on ``repro_torch.obs`` and ``repro.obs`` give equal
  ``snapshot()``s, equal Prometheus text, equal manifests, equal trace
  records (the wall-clock ``t0`` aside) and equal trace summaries.
* Free when off: serving with ``obs=None, tracer=None`` makes no
  ``torch.cuda.synchronize``, ``Tensor.item`` or ``Tensor.cpu`` call
  and reads no clock beyond the bare service loop's, and turning
  instrumentation on adds no device read either — counted with patched
  functions on the CPU tick path.
* On vs off: the same matches, no extra tick builds; the histogram sees
  every tick; the trace holds the serve loop's spans per tick and
  renders through ``python -m repro_torch.obs summarize``.
* One clock: every span's ``start_ns`` is on ``torch.profiler``'s time
  axis, so the profiler's ranges recorded inside a stage lie inside its
  span; a ``StreamSession.serve`` tick is covered by its spans from the
  batch build to the end of delivery, the result copy and the match
  records nested in ``tick.deliver``.
* Session health attribution (the ``ingest.*`` counters) survives
  checkpoint/restore.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import Counter as MultiSet
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as R
import repro_torch.obs as P
from _torch_util import port_edges, port_query
from repro_torch.core.multi import SlotTickCache
from repro_torch.runtime import service as service_mod
from repro_torch.runtime.service import ContinuousSearchService
from test_obs import _chain, _stream

CAP = dict(level_capacity=128, l0_capacity=128, max_new=64)
ROOT = Path(__file__).resolve().parents[1]


def _drive(obs_pkg):
    """One fixed script of registry and tracer calls."""
    reg = obs_pkg.MetricsRegistry()
    reg.counter("tick.n_ticks").inc(4)
    reg.counter("ingest.n_late_dropped").set_total(7)
    reg.counter("ingest.n_late_dropped").set_total(3)     # ignored
    reg.gauge("ingest.watermark").set(17)
    reg.register_gauge("share.n_nodes", lambda: 3)
    reg.register_gauge("share.broken", lambda: 1 / 0)
    h = reg.histogram("tick.latency_ms")
    rng = np.random.default_rng(5)
    for v in rng.exponential(8.0, 300).tolist() + [0.0, 1e6]:
        h.observe(v)
    small = reg.histogram("ckpt.publish_ms", ring_size=8)
    for v in range(20):
        small.observe(v + 0.5)
    tr, sink = obs_pkg.memory_tracer()
    for _ in range(3):
        tr.next_tick()
        tr.record("tick.forest", 1.25, n_nodes=2)
        tr.record("tick.barrier", 2.5)
        tr.event("coalescer.decision", action="hold", batch=64)
    with tr.span("ckpt.publish", step=3):
        pass
    tr.flush()
    return reg, sink.getvalue()


def _no_t0(trace: str) -> list:
    """Records without their wall-clock stamps (``t0``, ``start_ns``)."""
    out = []
    for ln in trace.splitlines():
        d = json.loads(ln)
        d.pop("t0")
        d.pop("start_ns", None)              # the port writes it alone
        if d["span"] == "ckpt.publish":
            d.pop("ms")                      # a measured wall time
        out.append(d)
    return out


def _snap(reg):
    # nan != nan: compare the failing callback gauge by repr
    return {k: repr(v) for k, v in reg.snapshot().items()}


def test_registry_tracer_exporter_equal_reference():
    preg, ptrace = _drive(P)
    rreg, rtrace = _drive(R)
    assert _snap(preg) == _snap(rreg)
    assert P.to_prometheus(preg) == R.to_prometheus(rreg)
    assert preg.to_manifest() == rreg.to_manifest()
    assert _no_t0(ptrace) == _no_t0(rtrace)
    assert all("start_ns" in json.loads(ln) for ln in ptrace.splitlines())
    lines = [ln for ln in ptrace.splitlines()
             if '"ckpt.publish"' not in ln]
    assert P.summarize_trace(lines) == R.summarize_trace(lines)
    assert P.format_summary(P.summarize_trace(lines)) == \
        R.format_summary(R.summarize_trace(lines))
    for q in (0.0, 0.5, 0.99, 1.0):
        xs = np.random.default_rng(1).exponential(3.0, 101).tolist()
        assert P.percentile(xs, q) == R.percentile(xs, q)
    assert P.DEFAULT_LATENCY_BUCKETS_MS == R.DEFAULT_LATENCY_BUCKETS_MS


def test_manifest_restore_equal_reference():
    preg, _ = _drive(P)
    rreg, _ = _drive(R)
    p2, r2 = P.MetricsRegistry(), R.MetricsRegistry()
    p2.load_manifest(preg.to_manifest())
    r2.load_manifest(rreg.to_manifest())
    p2.load_manifest(preg.to_manifest())      # set_total: no double count
    assert _snap(p2) == _snap(r2)
    assert P.to_prometheus(p2) == R.to_prometheus(r2)
    assert not p2.histogram("tick.latency_ms").exact


# --------------------------------------------------------------------- #
class _Counts:
    """Counts device reads, syncs and the service module's clock reads."""

    def __init__(self, monkeypatch):
        self.n = MultiSet()
        for name in ("item", "cpu"):
            orig = getattr(torch.Tensor, name)

            def wrap(*a, _o=orig, _n=name, **k):
                self.n[_n] += 1
                return _o(*a, **k)
            monkeypatch.setattr(torch.Tensor, name, wrap)
        orig_sync = torch.cuda.synchronize

        def sync(*a, **k):
            self.n["synchronize"] += 1
            return orig_sync(*a, **k) if torch.cuda.is_available() else None
        monkeypatch.setattr(torch.cuda, "synchronize", sync)
        clock = service_mod.time

        class _Time:
            @staticmethod
            def perf_counter():
                self.n["perf_counter"] += 1
                return clock.perf_counter()
        monkeypatch.setattr(service_mod, "time", _Time)


def _serve(tc, obs=None, tracer=None, share=False):
    svc = ContinuousSearchService(
        slots_per_group=2, tick_cache=tc, obs=obs, tracer=tracer,
        enable_sharing=share, device="cpu", **CAP)
    svc.register(port_query(_chain()), 20)
    svc.register(port_query(_chain()), 20)
    matches = MultiSet()

    def on_match(qid, bindings, ets):
        for row, et in zip(bindings, ets):
            matches[(qid, tuple(map(int, row)), tuple(map(int, et)))] += 1

    svc.serve_stream(port_edges(_stream()), on_match=on_match,
                     batch_size=32, min_batch=32, max_batch=32)
    return svc, matches


@pytest.mark.parametrize("share", [False, True])
def test_free_when_off(monkeypatch, share):
    tc = SlotTickCache()
    _serve(tc, share=share)                      # build + warm
    c = _Counts(monkeypatch)
    svc, off = _serve(tc, share=share)
    n_off = dict(c.n)
    c.n.clear()
    obs = P.MetricsRegistry()
    tracer, _ = P.memory_tracer()
    svc_on, on = _serve(tc, obs=obs, tracer=tracer, share=share)
    n_on = dict(c.n)
    ticks = svc.n_ticks
    assert off == on and sum(off.values()) > 0
    # off: no device sync, no scalar read; one host copy per result leaf
    # of each group a tick; two clock reads a tick (the barrier latency)
    assert n_off.get("synchronize", 0) == 0 and n_off.get("item", 0) == 0
    assert n_off["perf_counter"] == 2 * ticks
    assert n_off["cpu"] == 5 * len(svc._iter_groups()) * ticks
    # on: spans and histograms read clocks, never the device
    for k in ("synchronize", "item", "cpu"):
        assert n_on.get(k, 0) == n_off.get(k, 0), k
    assert obs.histogram("tick.latency_ms").count == ticks


def test_instrumentation_on_vs_off_and_summarize_cli(tmp_path):
    tc = SlotTickCache()
    _serve(tc)
    builds = tc.n_builds
    _, off = _serve(tc)
    obs = P.MetricsRegistry()
    path = tmp_path / "trace.jsonl"
    with P.Tracer(str(path)) as tracer:
        svc_on, on = _serve(tc, obs=obs, tracer=tracer)
    assert on == off and tc.n_builds == builds
    snap = obs.snapshot()
    assert snap["tick.n_ticks"] == svc_on.n_ticks
    assert snap["tick.n_edges"] == svc_on.n_edges_ingested
    assert snap["tick.n_matches"] == sum(on.values())
    h = obs.histogram("tick.latency_ms")
    assert h.exact and h.quantile(0.5) == P.percentile(
        h.samples().tolist(), 0.5)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert {ln["span"] for ln in lines} >= {
        "tick.forest", "tick.slot_dispatch", "tick.barrier",
        "tick.deliver", "coalescer.decision"}
    assert max(ln["tick"] for ln in lines) == svc_on.n_ticks
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", str(path)],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    s = P.summarize_trace(str(path))
    assert f"{s['n_spans']} spans over {s['n_ticks']} ticks" in proc.stdout
    assert P.summarize.main([]) == 2


def test_checkpoint_publish_metrics_and_health_survive_restore(tmp_path):
    from repro_torch.api import ACTIVE, DEGRADED, StreamSession

    sess = StreamSession(tick_cache=SlotTickCache(), ckpt_dir=str(tmp_path),
                         share_prefixes=True, device="cpu", **CAP)
    sess.register_query(port_query(_chain()), window=20)
    sess.serve(port_edges(_stream(200)), batch_size=32, min_batch=32,
               max_batch=32)
    assert sess.status().health == ACTIVE
    # drops recorded by an ingest front end into the registry
    sess.obs.counter("ingest.n_late_dropped").inc(5)
    sess.obs.counter("ingest.n_emitted").inc(100)
    st = sess.status()
    assert st.n_late_dropped == 5 and st.health == DEGRADED
    sess.checkpoint()
    sess.close()
    m = sess.metrics()
    assert m["ckpt.n_checkpoints"] == 1 and m["ckpt.publish_ms.count"] == 1
    assert m["share.n_nodes"] == 2 and m["tick.n_ticks"] > 0

    restored = StreamSession.restore(str(tmp_path), device="cpu")
    st2 = restored.status()
    assert st2.n_late_dropped == 5 and st2.health == DEGRADED
    assert restored.metrics()["tick.n_ticks"] == m["tick.n_ticks"]
    assert "repro_ingest_n_late_dropped 5" in restored.prometheus()


# --------------------------------------------------------------------- #
# the tick's spans on the profiler's clock
SPAN_NAMES = ("api.convert", "tick.batch", "tick.forest",
              "tick.slot_dispatch", "tick.barrier", "tick.deliver",
              "deliver.copy", "deliver.matches")


def _session_trace(batch=32, n=320, share=True, during=None):
    """Serve ``n`` REF edges through ``StreamSession.serve``, one call a
    tick of ``batch`` edges, two tenants in one slot group, with a
    memory tracer; ``during(sess)`` wraps the serving (a context
    manager factory).  Returns the trace's records."""
    import contextlib
    import gc

    from repro_torch.api import StreamSession

    tracer, buf = P.memory_tracer()
    sess = StreamSession(slots_per_group=2, tick_cache=SlotTickCache(),
                         share_prefixes=share, tracer=tracer, device="cpu",
                         **CAP)
    for _ in range(2):
        sess.register_query(port_query(_chain()), window=20)
    edges = port_edges(_stream(n))
    gc.collect()
    gc.disable()            # no collection inside a tick's span gaps
    try:
        with (during or contextlib.nullcontext)():
            for i in range(0, n, batch):
                sess.serve(edges[i:i + batch], batch_size=batch,
                           min_batch=batch, max_batch=batch,
                           final_checkpoint=False)
    finally:
        gc.enable()
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


def _end_ns(r) -> float:
    return r["start_ns"] + r["ms"] * 1e6


def test_spans_start_on_the_profilers_clock(monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.api.session as session_mod
    from repro_torch.api.session import Subscription

    def probe(owner, attr, span):
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with record_function("probe:" + span):
                return orig(*a, **k)
        monkeypatch.setattr(owner, attr, wrapped)

    # a function each stage calls, and only that stage
    probe(session_mod, "to_data_edge", "api.convert")
    probe(service_mod, "to_batches", "tick.batch")
    probe(service_mod, "make_batch", "tick.batch")
    probe(ContinuousSearchService, "_advance_forest", "tick.forest")
    probe(ContinuousSearchService, "_advance_group", "tick.slot_dispatch")
    probe(ContinuousSearchService, "_barrier", "tick.barrier")
    probe(service_mod, "map_state", "deliver.copy")
    probe(Subscription, "_deliver_rows", "deliver.matches")
    holder = {}

    def during():
        holder["prof"] = profile(activities=[ProfilerActivity.CPU])
        return holder["prof"]

    recs = _session_trace(during=during)
    prof = holder["prof"]
    base = prof.profiler.kineto_results.trace_start_ns()
    probes = MultiSet()
    for e in prof.events():
        if not e.name.startswith("probe:"):
            continue
        span = e.name.split(":", 1)[1]
        lo = base + round(e.time_range.start * 1e3)
        hi = base + round(e.time_range.end * 1e3)
        # inside a span of its stage, within 0.1 ms
        assert any(r["start_ns"] - 1e5 <= lo and hi <= _end_ns(r) + 1e5
                   for r in recs if r["span"] == span), (span, lo, hi)
        probes[span] += 1
    assert set(probes) == {"api.convert", "tick.batch", "tick.forest",
                           "tick.slot_dispatch", "tick.barrier",
                           "deliver.copy", "deliver.matches"}
    # spans of one stage in different ticks are disjoint: containment
    # above placed each probe in one tick
    for span in probes:
        own = sorted((r["start_ns"], _end_ns(r)) for r in recs
                     if r["span"] == span)
        assert all(a[1] <= b[0] for a, b in zip(own, own[1:])), span


def test_serve_tick_spans_cover_the_tick(monkeypatch):
    sizes = []
    orig = ContinuousSearchService._advance_group

    def advance(self, g, *a, **k):
        res = orig(self, g, *a, **k)
        sizes.append((g.gid, sum(x.numel() * x.element_size()
                                 for x in res)))
        return res
    monkeypatch.setattr(ContinuousSearchService, "_advance_group", advance)

    recs = _session_trace()
    assert {r["span"] for r in recs} >= set(SPAN_NAMES)
    # t0, the reference's stamp, is each span's end on the same clock
    assert all(abs(r["t0"] - _end_ns(r) / 1e9) <= 1e-3 for r in recs)
    ticks = sorted({r["tick"] for r in recs})
    assert ticks == list(range(1, 11))
    copies = [r for r in recs if r["span"] == "deliver.copy"]
    assert [(r["gid"], r["bytes"]) for r in copies] == sizes
    n_matches = 0
    for t in ticks:
        tick = [r for r in recs if r["tick"] == t]
        one = {r["span"]: r for r in tick}
        conv, bat, dlv = one["api.convert"], one["tick.batch"], \
            one["tick.deliver"]
        assert conv["n_events"] == bat["n_edges"] == 32
        assert bat["width"] == 32
        assert _end_ns(conv) <= bat["start_ns"] + 1e3
        # the copy and the match records lie inside delivery
        nested = [r for r in tick
                  if r["span"] in ("deliver.copy", "deliver.matches")]
        assert len(nested) == 2
        for r in nested:
            assert dlv["start_ns"] - 1e3 <= r["start_ns"]
            assert _end_ns(r) <= _end_ns(dlv) + 1e3
        assert one["deliver.matches"]["n_matches"] == dlv["n_matches"]
        n_matches += dlv["n_matches"]
        # the spans cover 95% of the tick from the batch build's start
        # to delivery's end
        lo, hi = bat["start_ns"], _end_ns(dlv)
        covered, last = 0.0, lo
        for s, e in sorted((r["start_ns"], _end_ns(r)) for r in tick
                           if r["ms"] > 0):
            s, e = max(s, last), min(e, hi)
            if e > s:
                covered += e - s
                last = e
        assert covered >= 0.95 * (hi - lo), (t, covered / (hi - lo))
    assert n_matches > 0
