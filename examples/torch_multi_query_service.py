"""Multi-tenant continuous search through the public API: many standing
patterns, one stream, crash-safe serving.

The twin of ``examples/multi_query_service.py`` on ``repro_torch``: the
same stream, tenants, churn, crash / restore and prefix sharing.
Demonstrates the ``repro_torch.api`` surface end-to-end (the session drives
``ContinuousSearchService`` underneath):

  1. declare timing-constrained patterns with the fluent DSL and
     register them as separate tenants — ``Subscription`` handles give
     typed matches keyed by each pattern's own vertex/edge names;
  2. serve a live edge stream with adaptive tick coalescing while the
     session checkpoints itself asynchronously every few ticks;
  3. register a NEW pattern mid-stream that states the same structure in
     a completely different authoring — the canonicalizing planner maps
     it onto the existing compiled slot tick (watch ``n_compiles``);
  4. "crash" the process, then ``StreamSession.restore``: every tenant
     comes back under its original subscription with the same label
     vocabulary, the compiled ticks come from the process-wide
     SlotTickCache (zero recompiles), and replaying the unserved tail
     of the stream misses nothing still inside the window;
  5. cross-tenant prefix sharing (``share_prefixes=True``): two tenants
     whose patterns share a timing-chain prefix alias ONE set of device
     tables for it (a refcounted SharedPrefixForest node chain advanced
     once per tick) — the forest stats show the dedup.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_multi_query_service.py
    PYTHONPATH=src python examples/torch_multi_query_service.py --device cpu
"""

import argparse
import tempfile

from repro_torch.api import Pattern, StreamSession
from repro_torch.stream.generator import StreamConfig, synth_traffic_stream


def _typed(matches) -> list:
    return [(tuple(sorted(m.bindings.items())), m.ts) for m in matches]


def main(argv=None):
    """Runs the example; returns each serve's counts by tenant name, the
    live matches of the restored tenants and of the sharing session, and
    the compile counts."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = args.device
    # A traffic-like stream: 3 vertex labels (host classes), 4 edge labels
    # (ports).  Think intrusion patterns over flow records.  Raw DataEdges
    # feed straight into the session (they are already in label space).
    stream = synth_traffic_stream(StreamConfig(
        n_edges=2000, n_vertices=60, n_vertex_labels=3, n_edge_labels=4,
        seed=7, ts_step_max=2))
    ckpt_dir = tempfile.mkdtemp(prefix="tcss_ckpt_")

    sess = StreamSession(
        slots_per_group=4, level_capacity=4096, l0_capacity=4096,
        max_new=1024, ckpt_dir=ckpt_dir, device=dev)

    # Tenant A: lateral movement — a timing-ordered 2-hop chain.
    chain = (Pattern("lateral")
             .vertex("entry", label=0).vertex("pivot", label=1)
             .vertex("target", label=2)
             .edge("entry", "pivot").edge("pivot", "target")
             .before(0, 1)
             .window(60))
    # Tenant B: beaconing triangle with a full timing order.
    tri = (Pattern("beacon")
           .vertex("a", label=0).vertex("b", label=1).vertex("c", label=2)
           .edge("a", "b").edge("b", "c").edge("c", "a")
           .before(0, 1).before(1, 2)
           .window(80))
    sub_a = sess.register(chain)
    sub_b = sess.register(tri)
    print(f"registered {sub_a.name!r} and {sub_b.name!r}; "
          f"compiles so far: {sess.service.n_compiles}")

    # serve the first half with periodic async checkpoints
    half = len(stream) // 2
    counts = sess.serve(stream[:half], ckpt_every=5, batch_size=64)
    st = sess.status()
    print(f"mid-stream: lateral={counts.get(sub_a, 0)} "
          f"beacon={counts.get(sub_b, 0)} new matches "
          f"(served {st.n_edges_ingested} edges in {st.n_ticks} ticks)")

    # Tenant C arrives mid-stream stating the SAME chain structure in a
    # different authoring: reversed edge order, different names, labels
    # permuted onto the hosts.  The planner canonicalizes it onto tenant
    # A's slot group: registration is a pure slot write, no recompile.
    before = sess.service.n_compiles
    chain_c = (Pattern("lateral-reauthored")
               .vertex("x", label=2).vertex("y", label=0)
               .vertex("z", label=1)
               .edge("z", "x", name="hop2")
               .edge("y", "z", name="hop1")
               .before("hop1", "hop2")
               .window(60))
    sub_c = sess.register(chain_c)
    assert sess.service.n_compiles == before, \
        "same-structure registration recompiled!"
    print(f"registered {sub_c.name!r} mid-stream with NO recompile "
          f"(compiles: {sess.service.n_compiles})")
    sub_b.close()       # tenant B leaves; its slot is reusable
    sess.checkpoint()   # make the new tenant layout durable
    sess.close()

    # ---- simulated crash: the session object is gone --------------------
    del sess
    sess = StreamSession.restore(ckpt_dir, device=dev)
    subs = {s.name: s for s in sess.subscriptions()}
    print(f"restored from {ckpt_dir}: {sorted(subs)} "
          f"at resume offset {sess.resume_offset}, "
          f"recompiles on restore: {sess.service.n_compiles} (ticks cached)")

    # replay the unserved tail; a restored session misses nothing in-window
    counts2 = sess.serve(stream[sess.resume_offset:], ckpt_every=5)
    sub_a2, sub_c2 = subs["lateral"], subs["lateral-reauthored"]
    print(f"end of stream: lateral={counts.get(sub_a, 0) + counts2.get(sub_a2, 0)} "
          f"reauthored-lateral={counts2.get(sub_c2, 0)} new matches over "
          f"{sess.resume_offset} edges")
    for m in sub_a2.matches()[:3]:
        print(f"  live window match: entry={m.bindings['entry']} "
              f"pivot={m.bindings['pivot']} target={m.bindings['target']} "
              f"completed@{m.ts}")
    print(f"windowed matches live right now: "
          f"lateral={len(sub_a2.matches())} "
          f"reauthored={len(sub_c2.matches())}")
    print(f"total slot-group compiles for 3 tenants + churn + crash/"
          f"restore: {sess.service.n_compiles}")

    # ---- cross-tenant prefix sharing ------------------------------------
    # Two intrusion patterns that agree on their first two hops: a full
    # exfil chain (recon -> staging -> exfil) and the shorter staging
    # detector.  With share_prefixes=True the engine CSEs the common
    # 2-edge prefix: ONE shared expansion-list chain serves both tenants,
    # advanced once per tick; the exfil tenant runs only its third hop.
    shared = StreamSession(share_prefixes=True, level_capacity=4096,
                           l0_capacity=4096, max_new=1024, device=dev)
    exfil = (Pattern("exfil-chain")
             .vertex("recon", label=0).vertex("staging", label=1)
             .vertex("relay", label=2).vertex("drop", label=0)
             .edge("recon", "staging").edge("staging", "relay")
             .edge("relay", "drop")
             .before(0, 1).before(1, 2)
             .window(60))
    staging = (Pattern("staging-only")
               .vertex("a", label=0).vertex("b", label=1)
               .vertex("c", label=2)
               .edge("a", "b").edge("b", "c").before(0, 1)
               .window(60))
    sub_x, sub_s = shared.register(exfil), shared.register(staging)
    fs = shared.service.forest_stats()
    print(f"\nprefix sharing: {fs.n_nodes} shared tables serve "
          f"{fs.n_tenants} tenants ({fs.n_shared_nodes} aliased by both, "
          f"{fs.table_bytes} device bytes)")
    print(f"  {sub_x.name!r}: prefix depth {sub_x.shared_prefix.depth}, "
          f"{sub_x.shared_prefix.n_tenants} tenant(s) on its leaf")
    print(f"  {sub_s.name!r}: prefix depth {sub_s.shared_prefix.depth}, "
          f"{sub_s.shared_prefix.n_tenants} tenants aliasing its chain")
    ticks = []
    counts3 = shared.serve(stream, batch_size=64,
                           on_tick=lambda i: ticks.append(i))
    print(f"  served {len(stream)} edges: "
          f"{counts3.get(sub_x, 0)} exfil + {counts3.get(sub_s, 0)} "
          f"staging matches, {ticks[0].n_shared_prefix_ticks} shared "
          f"prefix ticks per engine tick (vs "
          f"{sub_x.query.n_edges + sub_s.query.n_edges} level advances "
          f"without sharing)")
    return {"first": {s.name: n for s, n in counts.items()},
            "resumed": {s.name: n for s, n in counts2.items()},
            "shared": {s.name: n for s, n in counts3.items()},
            "live": {"lateral": _typed(sub_a2.matches()),
                     "reauthored": _typed(sub_c2.matches()),
                     "exfil": _typed(sub_x.matches()),
                     "staging": _typed(sub_s.matches())},
            "resume_offset": sess.resume_offset,
            "n_compiles": sess.service.n_compiles}


if __name__ == "__main__":
    main()
