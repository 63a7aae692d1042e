"""The port's public ``repro_torch.api`` surface against the JAX package.

The scenarios of tests/test_api_session.py (the mesh one is in
tests/test_torch_mesh.py, held to a plain JAX session), each
run on a port session (CPU, REF joins) and a reference session over the
same events: delivered ``Match`` multisets equal the reference's and the
oracle's, isomorphic authorings share one group and build, overflow
degrades status and gates admission, checkpoints carry the api state,
and the DSL, event buffer and vocabulary behave as the reference's.
"""

from collections import Counter, deque

import pytest

from repro.api import StreamSession as RefSession
from repro.core.multi import SlotTickCache as RefSlotTickCache

from _torch_util import port_edges
from repro_torch.api import (
    ACTIVE,
    DEGRADED,
    AdmissionError,
    Event,
    EventBuffer,
    LabelVocab,
    Pattern,
    PatternError,
    StreamSession,
    to_data_edge,
)
from repro_torch.api.events import STR_BASE
from repro_torch.checkpoint import CheckpointError
from repro_torch.core.multi import SlotTickCache
from test_api_session import (
    chain_pattern as ref_chain_pattern,
    chain_pattern_reauthored as ref_chain_reauthored,
    match_key,
    oracle_run,
    traffic as ref_traffic,
    triangle_pattern as ref_triangle_pattern,
)

CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)


def chain_pattern(name="lateral"):
    return (Pattern(name)
            .edge("a", "b", label="login")
            .edge("b", "c", label="xfer")
            .before(0, 1)
            .window(24))


def chain_pattern_reauthored():
    return (Pattern("lateral-b")
            .edge("y", "z", label="xfer", name="second")
            .edge("x", "y", label="login", name="first")
            .before("first", "second")
            .window(24))


def triangle_pattern():
    return (Pattern("beacon")
            .edge("u", "v")
            .edge("v", "w")
            .edge("w", "u")
            .before(0, 1).before(1, 2)
            .window(30))


def traffic(n_events, seed, **kw):
    """The reference's seeded traffic as the port's ``Event`` records."""
    return [Event(*e) for e in ref_traffic(n_events, seed, **kw)]


def session(**kw):
    return StreamSession(device="cpu", **{**CAP, **kw})


def ref_session(**kw):
    return RefSession(tick_cache=RefSlotTickCache(), **{**CAP, **kw})


def as_tuples(matches):
    return Counter(tuple(m) for m in matches)


# --------------------------------------------------------------------- #
def test_dsl_session_matches_oracle_and_reference():
    tc = SlotTickCache()
    sess = session(slots_per_group=4, tick_cache=tc)
    ref = ref_session(slots_per_group=4)
    subs = [sess.register(p) for p in
            (chain_pattern(), chain_pattern_reauthored(), triangle_pattern())]
    rsubs = [ref.register(p) for p in
             (ref_chain_pattern(), ref_chain_reauthored(),
              ref_triangle_pattern())]
    assert tc.n_builds == 2 and sess.service.n_compiles == 2
    assert [s.plan.to_json() for s in subs] == \
        [s.plan.to_json() for s in rsubs]

    events = traffic(240, seed=3)
    delivered = sess.ingest(events, batch_size=16)
    assert delivered == ref.ingest(ref_traffic(240, seed=3), batch_size=16)
    assert delivered > 0
    stream = [to_data_edge(e, sess.vocab) for e in events]
    for sub, rsub in zip(subs, rsubs):
        got = sub.drain()
        assert as_tuples(got) == as_tuples(rsub.drain())
        want_reported, want_window = oracle_run(sub.query, sub.window,
                                                stream)
        keys = Counter(match_key(sub, m) for m in got)
        assert keys and max(keys.values()) == 1
        assert set(keys) == want_reported
        assert {match_key(sub, m) for m in sub.matches()} == want_window
        assert [tuple(m) for m in sub.matches()] == \
            [tuple(m) for m in rsub.matches()]
        assert sub.status == ACTIVE and sub.n_overflow == 0


def test_isomorphic_patterns_share_one_group_and_build():
    tc = SlotTickCache()
    sess = session(slots_per_group=4, tick_cache=tc)
    s1 = sess.register(chain_pattern())
    sess.ingest(traffic(64, seed=5), batch_size=16)
    assert tc.n_builds == 1
    s2 = sess.register(chain_pattern_reauthored())
    sess.ingest(traffic(64, seed=6), batch_size=16)
    assert tc.n_builds == 1
    assert len(sess.service._iter_groups()) == 1
    assert sess.service._location[s1.qid][0] is \
        sess.service._location[s2.qid][0]


def test_match_translation_names_and_times():
    sess = session()
    sub = sess.register(chain_pattern())
    sess.ingest([Event(src=7, dst=3, ts=10, label="login"),
                 Event(src=3, dst=5, ts=12, label="xfer")])
    (m,) = sub.drain()
    assert m.bindings == {"a": 7, "b": 3, "c": 5}
    assert m.times == {"e0": 10, "e1": 12} and m.ts == 12
    assert [n for n, _ in m.vertices] == ["a", "b", "c"]
    sub2 = sess.register(chain_pattern_reauthored())
    sess.ingest([Event(src=1, dst=2, ts=40, label="xfer"),
                 Event(src=0, dst=1, ts=44, label="login")])
    assert sub2.drain() == []


def test_callbacks_and_serve_loop_match_reference():
    sess, ref = session(), ref_session()
    hits, rhits = [], []
    sub = sess.register(chain_pattern(), on_match=hits.append)
    ref.register(ref_chain_pattern(), on_match=rhits.append)
    serve = dict(batch_size=16, min_batch=16, max_batch=16)
    totals = sess.serve(traffic(200, seed=9), **serve)
    ref.serve(ref_traffic(200, seed=9), **serve)
    assert totals.get(sub, 0) == len(hits) == sub.n_delivered
    assert hits and sub.drain() == []
    assert as_tuples(hits) == as_tuples(rhits)
    assert all(set(m.bindings) == {"a", "b", "c"} for m in hits)


def test_overflow_degrades_status_and_gates_admission():
    tiny = dict(slots_per_group=4, level_capacity=8, l0_capacity=8,
                max_new=4)
    sess, ref = session(**tiny), ref_session(**tiny)
    wild = (Pattern("wild").edge("a", "b").edge("b", "c").before(0, 1)
            .window(60))
    sub = sess.register(wild)
    from repro.api import Pattern as RefPattern
    ref.register(RefPattern("wild").edge("a", "b").edge("b", "c")
                 .before(0, 1).window(60))
    ticks, rticks = [], []
    serve = dict(batch_size=32, min_batch=32, max_batch=32)
    sess.serve(traffic(256, seed=11, n_hosts=5),
               on_tick=lambda i: ticks.append(i.n_overflow), **serve)
    ref.serve(ref_traffic(256, seed=11, n_hosts=5),
              on_tick=lambda i: rticks.append(i.n_overflow), **serve)
    assert ticks == rticks and sum(ticks) > 0
    assert sub.n_overflow > 0 and sub.status == DEGRADED
    assert sess.status().degraded == (sub.qid,)
    assert sess.status().health == DEGRADED
    with pytest.raises(AdmissionError, match="capacity pressure"):
        sess.register(chain_pattern())
    assert sess.register(chain_pattern(), force=True).status == ACTIVE
    assert sess.register(triangle_pattern()).status == ACTIVE


@pytest.mark.parametrize("share", [False, True])
def test_session_checkpoint_restore_roundtrip(tmp_path, share):
    tc = SlotTickCache()
    events = traffic(192, seed=13)
    serve = dict(batch_size=16, min_batch=16, max_batch=16)
    sess_a = session(ckpt_dir=str(tmp_path / "a"), tick_cache=tc,
                     share_prefixes=share)
    subs_a = [sess_a.register(p) for p in
              (chain_pattern(), chain_pattern_reauthored())]
    sess_a.serve(events, ckpt_every=3, **serve)
    sess_a.close()

    sess_b = session(ckpt_dir=str(tmp_path / "b"), tick_cache=tc,
                     share_prefixes=share)
    subs_b = [sess_b.register(p) for p in
              (chain_pattern(), chain_pattern_reauthored())]
    sess_b.serve(events[:96], ckpt_every=3, **serve)
    sess_b.checkpoint()
    sess_b.close()
    del sess_b

    builds = tc.n_builds
    sess_r = StreamSession.restore(str(tmp_path / "b"), tick_cache=tc,
                                   device="cpu")
    assert sess_r.service.n_compiles == 0 and tc.n_builds == builds
    assert [s.qid for s in sess_r.subscriptions()] == \
        [s.qid for s in subs_b]
    assert sess_r.vocab.to_json() == sess_a.vocab.to_json()
    sess_r.serve(events[sess_r.resume_offset:], **serve)
    for sa, sr in zip(subs_a, sess_r.subscriptions()):
        assert sa.plan == sr.plan
        assert sr.matches() == sa.matches()
    assert (sess_r.service.forest is not None) == share


def test_mesh_is_the_mesh_slice():
    """``mesh=`` serves through the replica-sharded service (held to
    the JAX package in tests/test_torch_mesh.py): an int is the replica
    count, a dict the service's knobs; ``device`` places every
    replica."""
    from repro_torch.runtime.mesh import ShardedSearchService

    s1 = session(mesh=1)
    assert isinstance(s1.service, ShardedSearchService)
    assert (s1.service.n_replicas, s1.service.slots_per_replica) == (1, 4)
    s2 = session(mesh={"n_replicas": 2, "slots_per_replica": 3})
    assert (s2.service.n_replicas, s2.service.slots_per_group) == (2, 6)
    assert s2.service.mesh == (s2.service.device,) * 2


def test_restore_refuses_non_session_checkpoints(tmp_path):
    from repro_torch.core.query import QueryGraph
    from repro_torch.runtime.service import ContinuousSearchService

    svc = ContinuousSearchService(ckpt_dir=str(tmp_path), device="cpu",
                                  **CAP)
    svc.register(QueryGraph(3, (0, 1, 2), ((0, 1), (1, 2)),
                            prec=frozenset({(0, 1)})), 20)
    svc.checkpoint()
    svc.ckpt.wait()
    with pytest.raises(CheckpointError, match="StreamSession"):
        StreamSession.restore(str(tmp_path), device="cpu")


def test_reference_session_checkpoint_restores_into_port(tmp_path):
    """A JAX session's checkpoint (vocab, pattern plans, tables) comes
    back as a port session that continues to the reference's matches."""
    events = ref_traffic(192, seed=17)
    serve = dict(batch_size=16, min_batch=16, max_batch=16)
    ref = RefSession(ckpt_dir=str(tmp_path), tick_cache=RefSlotTickCache(),
                     **CAP)
    rsub = ref.register(ref_chain_pattern())
    ref.serve(events[:96], **serve)
    ref.checkpoint()
    ref.close()
    sess = StreamSession.restore(str(tmp_path), device="cpu")
    (sub,) = sess.subscriptions()
    assert sub.qid == rsub.qid and sub.plan.to_json() == rsub.plan.to_json()
    assert sess.vocab.to_json() == ref.vocab.to_json()
    rsub.drain()
    ref.serve(events[96:], **serve)
    sess.serve([Event(*e) for e in events[96:]], **serve)
    assert as_tuples(sub.drain()) == as_tuples(rsub.drain())
    assert [tuple(m) for m in sub.matches()] == \
        [tuple(m) for m in rsub.matches()]


# --------------------------------------------------------------------- #
# DSL validation, event buffer, vocabulary
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("build,match", [
    (lambda: Pattern().edge("a", "a"), "self-loop"),
    (lambda: Pattern().edge("a", "b").edge("a", "b"), "duplicate parallel"),
    (lambda: Pattern().edge("a", "b").before("nope", 0), "unknown edge name"),
    (lambda: Pattern().edge("a", "b").before(0, 3), "out of range"),
    (lambda: Pattern().vertex("a", label="x").vertex("a", label="y"),
     "relabelled"),
    (lambda: Pattern().edge("a", "b").build(), "no window"),
    (lambda: Pattern().window(10).build(), "no edges"),
    (lambda: (Pattern().edge("a", "b").edge("b", "c").before(0, 1)
              .before(1, 0).window(10).build()), "strict partial order"),
])
def test_pattern_validation_is_loud(build, match):
    with pytest.raises(PatternError, match=match):
        build()


def test_event_buffer_pads_pow2():
    vocab = LabelVocab()
    buf = EventBuffer(vocab, batch_size=6)
    out = [b for i in range(8)
           if (b := buf.push(Event(i, i + 1, i, label="x"))) is not None]
    tail = buf.flush()
    assert len(out) == 1 and tail is not None
    assert out[0]["src"].shape == (8,) and out[0]["valid"].sum() == 6
    assert tail["src"].shape == (8,) and tail["valid"].sum() == 2
    assert buf.flush() is None
    assert out[0]["edge_label"][0] == vocab.intern("x")


def test_label_vocab_roundtrip_and_type_guard():
    v = LabelVocab()
    assert v.intern("login") == v.intern("login") == STR_BASE
    assert v.intern("xfer") == STR_BASE + 1
    assert v.intern(7) == 7 and v.intern(0) == 0
    assert v.token(7) == 7 and v.token(STR_BASE) == "login"
    assert LabelVocab.from_json(v.to_json()).to_json() == v.to_json()
    with pytest.raises(TypeError, match="str or int"):
        v.intern(("tuple",))
    with pytest.raises(TypeError, match="str or int"):
        v.intern(True)
    with pytest.raises(ValueError, match="int label tokens"):
        v.intern(-1)


def test_int_labels_align_with_raw_data_edges():
    from repro.core.oracle import DataEdge as RefEdge

    sess = session()
    p = (Pattern("desc-order")
         .vertex("a", label=2).vertex("b", label=0).vertex("c", label=1)
         .edge("a", "b").edge("b", "c").before(0, 1).window(20))
    sub = sess.register(p)
    sess.ingest(port_edges([
        RefEdge(src=5, dst=6, ts=1, src_label=2, dst_label=0, edge_label=0),
        RefEdge(src=6, dst=7, ts=2, src_label=0, dst_label=1, edge_label=0),
    ]))
    (m,) = sub.drain()
    assert m.bindings == {"a": 5, "b": 6, "c": 7}


def test_subscription_queue_is_bounded():
    sess = session()
    sub = sess.register(chain_pattern())
    sub.MAX_PENDING = 4
    sub._pending = deque(maxlen=4)
    for k in range(7):
        sess.ingest([Event(src=10 + k, dst=50, ts=100 * k, label="login"),
                     Event(src=50, dst=20 + k, ts=100 * k + 1,
                           label="xfer")])
    assert sub.n_delivered == 7 and sub.n_dropped == 3
    kept = sub.drain()
    assert len(kept) == 4
    assert kept[-1].bindings == {"a": 16, "b": 50, "c": 26}


def test_quickstart_example_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_api_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "quickstart OK" in out and "repro_share_n_nodes 2" in out
