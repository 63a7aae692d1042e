"""Fault-tolerant ingestion through the public API of the PyTorch/CUDA
port: flaky multi-source traffic in, exactly-once ordered matches out.

The twin of ``examples/ingest_chaos.py`` on ``repro_torch``.  Production
streams come from several capture points, over transports that
disconnect, redeliver, reorder and stall.  This example runs the full
ingress stack under deliberately hostile conditions and shows that none
of it reaches the match stream:

  1. one seeded traffic stream is split into three per-source delivery
     scripts, 30% of deliveries displaced late and 10% redelivered
     (``disordered_sources``);
  2. each source is wrapped in ``ChaosSource``, injecting disconnects
     (with cursor rewind on reconnect), duplicate deliveries, extra
     reordering, stalls and torn batches — all from one seed;
  3. the session's ``IngestFrontier`` reconnects with backoff, dedups by
     sequence cursor, k-way merges by event time and releases events in
     watermark order into the engine, whose window clock is the
     watermark — every suppressed or dropped delivery counted;
  4. mid-stream the process "crashes"; ``StreamSession.restore`` brings
     the tenants back AND hands over the checkpointed ingest cursors
     (``restored_ingest``), so fresh chaos-wrapped sources resume
     exactly once: the final window equals a run that never crashed.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_ingest_chaos.py
    PYTHONPATH=src python examples/torch_ingest_chaos.py --device cpu
"""

import argparse
import tempfile
from collections import Counter

from repro_torch.api import Pattern, StreamSession
from repro_torch.runtime.fault import RetryPolicy, SimulatedFailure
from repro_torch.stream.chaos import ChaosConfig, ChaosSource
from repro_torch.stream.generator import (
    DisorderConfig,
    StreamConfig,
    disordered_sources,
    synth_traffic_stream,
)
from repro_torch.stream.ingest import ScriptedSource

CAP = dict(level_capacity=2048, l0_capacity=2048, max_new=512)
RETRY = RetryPolicy(max_attempts=8, base_delay_s=0.0, jitter_frac=0.0)
NO_SLEEP = dict(sleep=lambda d: None)   # deterministic, instant backoff


def lateral_pattern():
    return (Pattern("lateral")
            .vertex("entry", label=0).vertex("pivot", label=1)
            .vertex("target", label=2)
            .edge("entry", "pivot").edge("pivot", "target")
            .before(0, 1)
            .window(40))


def chaos_sources(stream, seed):
    """The stream as three disordered delivery scripts, each behind a
    fault-injecting transport (same seed -> same faults, reproducible)."""
    scripts = disordered_sources(stream, DisorderConfig(
        n_sources=3, disorder_frac=0.3, max_delay=6, duplicate_rate=0.1,
        seed=seed))
    return {
        f"tap{i}": ChaosSource(ScriptedSource(f"tap{i}", sc), ChaosConfig(
            seed=seed + i, p_disconnect=0.08, rewind=4, p_duplicate=0.05,
            reorder_span=3, p_reorder=0.2, p_stall=0.05, stall_len=2,
            p_torn=0.05))
        for i, sc in enumerate(scripts)
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    stream = synth_traffic_stream(StreamConfig(
        n_edges=1200, n_vertices=60, n_vertex_labels=3, n_edge_labels=4,
        seed=7, ts_step_max=2))
    ckpt_dir = tempfile.mkdtemp(prefix="tcss_torch_ingest_")

    # ---- reference: the same traffic served pre-ordered, no faults ----
    ref = StreamSession(slots_per_group=4, device=args.device, **CAP)
    ref_matches = []
    ref.register(lateral_pattern(), on_match=ref_matches.append)
    ref.serve(stream, batch_size=64)

    # ---- chaos run, crashing mid-stream ------------------------------
    sess = StreamSession(slots_per_group=4, ckpt_dir=ckpt_dir,
                         device=args.device, **CAP)
    got = []
    sess.register(lateral_pattern(), on_match=got.append)
    frontier = sess.sources(chaos_sources(stream, seed=13),
                            allowed_lateness=80, stall_patience=16,
                            retry=RETRY, **NO_SLEEP)

    def crash_at(info, tick=8):
        if info.tick == tick:
            raise SimulatedFailure(f"injected crash at tick {tick}")

    try:
        sess.serve_frontier(frontier, ckpt_every=3, batch_size=64,
                            on_tick=crash_at)
    except SimulatedFailure as e:
        print(f"crashed: {e}")
    sess.service.ckpt.wait()        # flush in-flight checkpoint writes
    n_before = len(got)

    # ---- restore: tenants + ingest cursors come back ------------------
    sess2 = StreamSession.restore(ckpt_dir, device=args.device)
    (sub,) = sess2.subscriptions()
    sub.on_match = got.append
    # match reports roll back to the durable checkpoint; so do we
    del got[:]
    resumed = sess2.sources(chaos_sources(stream, seed=13),
                            resume=sess2.restored_ingest,
                            allowed_lateness=80, stall_patience=16,
                            retry=RETRY, **NO_SLEEP)
    sess2.serve_frontier(resumed, batch_size=64)

    st = sess2.status()
    ing = resumed.stats()
    print(f"backend {sess2.service.backend} on {sess2.service.device}")
    print(f"delivered {ing.n_emitted} edges exactly-once "
          f"({n_before} matches reported pre-crash, rest after restore)")
    print(f"suppressed duplicates: {ing.n_duplicates}, "
          f"reconnects survived: {ing.n_reconnects}, "
          f"late drops: {ing.n_late_dropped}")
    print(f"session health: {st.health}, watermark {st.watermark}")

    # the proof: window contents identical to the never-crashed run
    same = sess2.service.matches(sub.qid) == ref.service.matches(
        ref.subscriptions()[0].qid)
    print(f"window state == fault-free reference: {same}")
    assert same
    assert ing.n_emitted == len(stream) and ing.n_late_dropped == 0
    assert ing.n_duplicates > 0 and ing.n_reconnects > 0

    # every match the restored run reported is a fault-free-run match
    ref_keys = Counter((m.vertices, m.edges) for m in ref_matches)
    got_keys = Counter((m.vertices, m.edges) for m in got)
    assert all(ref_keys[k] >= v for k, v in got_keys.items())
    print(f"post-restore match reports: {len(got)}, all present in the "
          f"reference run")
    print("ingest chaos OK")


if __name__ == "__main__":
    main()
