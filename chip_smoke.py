#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--ticks N] [--parity-ticks N]

Phases (one JSON line each; any failure ends the run with a non-zero
exit, nothing is caught and skipped):

  device   the card's name and power limit (nvidia-smi) and torch's name;
  build    nvcc builds every kernel of the path from csrc/ (ptxas -v);
  kernels  each kernel against its plain torch version on the card, at
           the shapes the serving path gives it: outputs must be equal
           element for element; CUDA-event times (median of >= 20) beside
           the plain version's and the least time the card could take;
  serve    the port's main path: ContinuousSearchService on the card with
           its default CUDA join backend, 16 tenants of two structures in
           slot groups of 8, level/L0 capacity 65536, max_new 8192, fixed
           batches of 4096 edges of a seeded CAIDA-like stream; the
           kernels' launch counters are zeroed just before and read just
           after;
  parity   the same service on the REF backend over a prefix of the same
           stream: per-tenant match multisets, totals, current matches,
           stats and every table leaf identical to the CUDA run's.
  profile  torch.profiler over the last ticks of a second CUDA serve:
           device time by kernel and the device's idle share.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the repository beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
# The join is int32 compare/select work on the CUDA cores.  The data
# sheet gives 67 TFLOP/s fp32 outside the tensor cores, counting an FMA
# as two operations: 33.5e12 simple operations per second.  That is the
# rate used for the bound (Hopper's int32 units are no faster).
INT_OPS_PER_S = 33.5e12

LEVEL_CAP = 65536
MAX_NEW = 8192
BATCH = 4096
SLOTS = 8
REPS = 20                # timed runs per kernel case (median)
PROFILED_TICKS = 8
DEVICE = "cuda"

# The served stream: CAIDA-like traffic (zipf 1.3 vertex popularity,
# skewed port labels), and the tenants' window base (timestamp units; the
# stream advances ~1.5 per edge, so 200,000 is ~36 ticks of 4096 edges).
# Chosen on the card so that the tables hold thousands to tens of
# thousands of live rows while no join exceeds max_new (overflow 0).
STREAM = dict(n_vertices=100_000, n_vertex_labels=8, n_edge_labels=4)
WINDOW_BASE = 200_000
N_HUBS = 5


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------- #
# device / build
# --------------------------------------------------------------------- #
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from repro_torch.kernels.compat_join import kernel as K

    t0 = time.perf_counter()
    path = K.build()
    secs = time.perf_counter() - t0
    ptxas = [ln for ln in K.build_log.splitlines() if ln.strip()]
    emit({"phase": "build", "kernel": "compat_join",
          "library": os.path.relpath(path, HERE), "seconds": secs,
          "ptxas": ptxas})


# --------------------------------------------------------------------- #
# kernels: each kernel against its plain version at the path's shapes
# --------------------------------------------------------------------- #
def _time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs (after one
    warm-up run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _table(rng, n_slots, rows, nv, ne, fill, n_vertices, t_hi):
    """A random slot-stacked partial-match table: ``fill`` of the rows
    valid, bindings from ``n_vertices`` ids, timestamps below ``t_hi``."""
    import numpy as np

    shape = (n_slots, rows)
    bind = rng.integers(0, n_vertices, shape + (nv,), dtype=np.int32)
    ets = np.sort(rng.integers(0, t_hi, shape + (ne,), dtype=np.int32),
                  axis=-1)
    valid = rng.random(shape) < fill
    return bind, ets, valid


def _join_cases(rng):
    """The serving path's joins at full size (slot group of 8):
    the level join (A 65536 per slot x the shared 4096-edge batch, with a
    per-slot edge mask), L0 J1 (8192 delta rows x 65536) and L0 J2
    (65536 x 8192 delta rows) of the two-chain structure; each with and
    without a window, plus one overflow case."""
    import numpy as np

    s, cap, d = SLOTS, LEVEL_CAP, MAX_NEW
    windows = rng.integers(3000, 9000, s, dtype=np.int32)
    rel_level = np.array([[False, False], [True, False]])      # b == src
    trel_level = np.array([[-1]], np.int8)
    two_rel = np.zeros((3, 3), bool)
    two_rel[0, 0] = True                                        # shared v0
    two_trel = np.zeros((2, 2), np.int8)
    cases = []
    # level join: A = level-1 rows (a, b) per slot, B = the batch, shared
    a = _table(rng, s, cap, 2, 1, 0.3, 2000, 20000)
    eb = np.sort(rng.integers(18000, 24000, (BATCH,), dtype=np.int32))
    bb = rng.integers(0, 2000, (BATCH, 2), dtype=np.int32)
    vb = rng.random((s, BATCH)) < 0.25
    level = (a, (bb, eb[:, None], vb), rel_level, trel_level)
    # L0 J1: ΔA (compacted fresh rows of subquery 0) x B (subquery 1)
    da = _table(rng, s, d, 3, 2, 0.5, 3000, 30000)
    b1 = _table(rng, s, cap, 3, 2, 0.2, 3000, 30000)
    j1 = (da, b1, two_rel, two_trel)
    # L0 J2: A_old x ΔB
    a2 = _table(rng, s, cap, 3, 2, 0.2, 3000, 30000)
    db = _table(rng, s, d, 3, 2, 0.5, 3000, 30000)
    j2 = (a2, db, two_rel, two_trel)
    for name, spec in (("level", level), ("l0_j1", j1), ("l0_j2", j2)):
        for win in (windows, None):
            cases.append((f"{name}{'' if win is None else '_window'}",
                          spec, win, d))
    # overflow: a dense level join keeps only max_new pairs per slot
    dense = _table(rng, s, cap, 2, 1, 0.9, 40, 20000)
    vb_dense = rng.random((s, BATCH)) < 0.9
    bb_dense = rng.integers(0, 40, (BATCH, 2), dtype=np.int32)
    cases.append(("level_overflow",
                  (dense, (bb_dense, eb[:, None], vb_dense), rel_level,
                   trel_level), windows, d))
    return cases


def _work(tensors, rel, trel, window, max_new, n_slots):
    """(bytes, operations) the join needs on these inputs: each input
    read once and each output written once; the predicate on every pair
    of valid rows (the data decides which pairs need it)."""
    ba, ea, va, bb, eb, vb = tensors
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 0 if window is None else window.numel() * 4
    nbytes += n_slots * (2 * max_new + 1) * 4
    nva, nvb = rel.shape
    nea, neb = trel.shape
    per_pair = nva * nvb + int((trel != 0).sum()) + 1       # + valid AND
    if window is not None:
        per_pair += 2 * neb + 4        # B's min/max, span, compare
    va_n = va.reshape(n_slots, -1).sum(dim=1).double() \
        if va.dim() == 2 else va.sum().double().expand(n_slots)
    vb_n = vb.reshape(n_slots, -1).sum(dim=1).double() \
        if vb.dim() == 2 else vb.sum().double().expand(n_slots)
    pairs = float((va_n * vb_n).sum())
    return nbytes, pairs * per_pair


def phase_kernels(torch, seed: int):
    import numpy as np

    from repro_torch.kernels.compat_join import ops, ref

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    results = []
    worst = 0
    for name, (a, b, rel, trel), win, max_new in _join_cases(rng):
        tensors = [torch.as_tensor(x, device=dev) for x in (*a, *b)]
        window = None if win is None else torch.as_tensor(win, device=dev)
        args = (*tensors, rel, trel, max_new, window)
        got = ops.compat_join_pairs(*args)
        want = ref.compat_join_pairs(*args)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"kernel case {name}: shape/dtype {g.shape}/{g.dtype} "
                     f"vs {w.shape}/{w.dtype}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        if err:
            fail(f"kernel case {name}: kernel != plain (max |err| {err})")
        ms = _time_ms(torch, lambda: ops.compat_join_pairs(*args), REPS)
        plain_ms = _time_ms(torch, lambda: ref.compat_join_pairs(*args),
                            REPS)
        nbytes, nops = _work(tensors, rel, trel, window, max_new, SLOTS)
        bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT_OPS_PER_S)
        results.append({
            "case": name, "slots": SLOTS,
            "ca": tensors[0].shape[-2], "cb": tensors[3].shape[-2],
            "pairs_kept": int(got[2].sum()),
            "n_dropped": int(got[3].sum()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / INT_OPS_PER_S else "operations"),
            "bytes": nbytes, "operations": nops, "max_abs_err": err,
        })
        worst = max(worst, err)
        del tensors, got, want
    if not any(r["n_dropped"] for r in results):
        fail("the overflow case dropped no pairs")
    emit({"phase": "kernel_cases", "kernel": "compat_join_pairs",
          "reps": REPS, "cases": results})
    return results, worst


# --------------------------------------------------------------------- #
# serve: the main path
# --------------------------------------------------------------------- #
def hub_labels(stream, n_hubs: int) -> list:
    """Vertex labels of the ``n_hubs`` busiest vertices of ``stream``
    (the zipf head of the traffic), most popular first."""
    deg = Counter()
    label = {}
    for e in stream:
        deg[e.src] += 1
        deg[e.dst] += 1
        label[e.src], label[e.dst] = e.src_label, e.dst_label
    out = []
    for v, _ in deg.most_common(n_hubs):
        if label[v] not in out:
            out.append(label[v])
    return out


def tenants(stream):
    """16 standing queries of two structures, differing in labels and
    windows: 8 timed 3-edge chains a->b->c->d (e0 < e1 < e2; one
    TC-subquery of 3 levels: level joins only) and 8 two-chains (two
    2-edge chains from one vertex; two TC-subqueries joined in L0 with a
    3x3 REL and 2x2 TREL: level joins and L0 delta joins).

    The traffic is zipf-skewed: its busiest vertices carry a large share
    of all edges, so a query vertex that joins two edges (a chain's
    middle vertices, the two-chain's centre) on a hub's label would pair
    every hub edge with every other each tick.  Those vertices take
    labels outside the hubs' labels; the end vertices take any label,
    the hubs' included, which fills the tables."""
    from repro_torch.core.query import QueryGraph

    n_l, n_e = STREAM["n_vertex_labels"], STREAM["n_edge_labels"]
    heavy = hub_labels(stream, N_HUBS)
    light = [lab for lab in range(n_l) if lab not in heavy]
    if len(light) < 2:
        fail(f"{n_l} vertex labels leave < 2 outside the hubs' {heavy}")
    out = []
    for i in range(8):
        vl = (heavy[i % len(heavy)], light[i % len(light)],
              light[(i + 1) % len(light)], (i + 3) % n_l)
        el = tuple((i + k) % n_e for k in range(3))
        q = QueryGraph(4, vl, ((0, 1), (1, 2), (2, 3)), edge_labels=el,
                       prec=frozenset({(0, 1), (1, 2)}))
        out.append(("chain", q, WINDOW_BASE + 500 * i))
    for i in range(8):
        vl = (light[i % len(light)], light[(i + 1) % len(light)],
              heavy[i % len(heavy)], light[(i + 2) % len(light)],
              (i + 4) % n_l)
        el = tuple((i + k) % n_e for k in range(4))
        q = QueryGraph(5, vl, ((0, 1), (1, 2), (0, 3), (3, 4)),
                       edge_labels=el, prec=frozenset({(0, 1), (2, 3)}))
        out.append(("two_chain", q, WINDOW_BASE + 500 * i))
    return out


def make_stream(seed: int, n_edges: int):
    from repro_torch.stream.generator import StreamConfig, \
        synth_traffic_stream

    return synth_traffic_stream(StreamConfig(n_edges=n_edges, seed=seed,
                                             **STREAM))


def run_service(backend, stream, snapshot_tick=None, n_ticks=None):
    """Serve ``stream`` (its first ``n_ticks`` batches, if given) through
    a fresh service with the tenants of ``tenants(stream)``; returns the
    service, the per-tick ServeInfos, per-qid match multisets of the
    first ``snapshot_tick`` ticks, and the per-qid state snapshot after
    it."""
    import torch

    from repro_torch.core.engine import current_matches
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.state import state_to_numpy
    from repro_torch.runtime.service import ContinuousSearchService

    svc = ContinuousSearchService(
        slots_per_group=SLOTS, level_capacity=LEVEL_CAP,
        l0_capacity=LEVEL_CAP, max_new=MAX_NEW, backend=backend,
        tick_cache=SlotTickCache(), device=DEVICE)
    qids = {svc.register(q, w): kind for kind, q, w in tenants(stream)}
    infos = []
    matches = {q: Counter() for q in qids}
    snap = {}

    def on_match(qid, bind, ets):
        if snapshot_tick is None or len(infos) < snapshot_tick:
            matches[qid].update(
                tuple(map(int, b)) + tuple(map(int, e))
                for b, e in zip(bind, ets))

    def on_tick(info):
        infos.append(info)
        if len(infos) == snapshot_tick:
            for q in qids:
                st = svc.state(q)
                snap[q] = (state_to_numpy(st),
                           current_matches(svc.registry.get(q).plan, st))

    _sync(torch)
    t0 = time.perf_counter()
    served = stream if n_ticks is None else stream[:n_ticks * BATCH]
    totals = svc.serve_stream(served, on_match=on_match, on_tick=on_tick,
                              batch_size=BATCH, min_batch=BATCH,
                              max_batch=BATCH)
    _sync(torch)
    wall = time.perf_counter() - t0
    return svc, qids, infos, matches, snap, totals, wall


def phase_serve(torch, args, stream):
    from repro_torch.kernels.compat_join import ops

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.compat_join_pairs.launches = 0          # counts of the main path
    svc, qids, infos, matches, snap, totals, wall = run_service(
        None, stream, snapshot_tick=args.parity_ticks)
    launches = ops.compat_join_pairs.launches
    if svc.backend != "cuda":
        fail(f"the service's default backend is {svc.backend}, not cuda")
    lat = sorted(i.latency_ms for i in infos)
    steady = sorted(i.latency_ms for i in infos[1:])   # after the first tick
    overflow = svc.overflow_pressure()
    total = sum(totals.values())
    occupancy = {}
    for g in svc._iter_groups():
        occupancy[f"group{g.gid}"] = {
            "levels": [[int(t.valid.sum(dim=1).max()) for t in sub]
                       for sub in g.sstate.engines.levels],
            "l0": [int(t.valid.sum(dim=1).max())
                   for t in g.sstate.engines.l0]}
    per_kind = Counter()
    for q, kind in qids.items():
        per_kind[kind] += totals.get(q, 0)
    out = {
        "phase": "serve", "tenants": len(qids), "slots_per_group": SLOTS,
        "level_capacity": LEVEL_CAP, "max_new": MAX_NEW, "batch": BATCH,
        "ticks": len(infos), "edges": len(stream),
        "edges_per_s": len(stream) / wall, "wall_s": wall,
        "tick_ms_p50": lat[len(lat) // 2],
        "tick_ms_p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "tick_ms_first": infos[0].latency_ms,
        "tick_ms_p99_after_first": (
            steady[min(len(steady) - 1, int(0.99 * len(steady)))]
            if steady else None),
        "matches_total": total, "matches_by_structure": dict(per_kind),
        "n_overflow": overflow, "n_compiles": svc.n_compiles,
        "kernel_launches": launches, "backend": svc.backend,
        "max_live_rows": occupancy,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if DEVICE == "cuda" else None),
    }
    emit(out)
    if launches <= 0:
        fail("the serving path launched no kernel")
    if total <= 0:
        fail("the serving path found no matches")
    if overflow != 0:
        fail(f"the serving path overflowed ({overflow} dropped appends)")
    if svc.n_compiles != 2:
        fail(f"{svc.n_compiles} builds for 2 structures")
    return out, qids, matches, snap, launches


def phase_parity(torch, args, stream, qids, matches, snap):
    """The REF backend over the first ``parity_ticks`` ticks must equal
    the CUDA run at that tick, tenant by tenant."""
    import numpy as np

    svc, rqids, infos, rmatches, rsnap, totals, wall = run_service(
        "ref", stream, snapshot_tick=args.parity_ticks,
        n_ticks=args.parity_ticks)
    if list(rqids) != list(qids):
        fail("REF service assigned other qids")

    def leaves(t):
        if isinstance(t, tuple):
            return [x for v in t for x in leaves(v)]
        return [t]

    n_leaves = 0
    for q in qids:
        if rmatches[q] != matches[q]:
            fail(f"qid {q}: match multisets differ (REF "
                 f"{sum(rmatches[q].values())} vs CUDA "
                 f"{sum(matches[q].values())})")
        (rs, rcur), (cs, ccur) = rsnap[q], snap[q]
        if rcur != ccur:
            fail(f"qid {q}: current matches differ")
        for x, y in zip(leaves(rs), leaves(cs)):
            if x.shape != y.shape or not np.array_equal(x, y):
                fail(f"qid {q}: a state leaf differs")
            n_leaves += 1
        if int(rs.stats.n_matches_total) != sum(matches[q].values()):
            fail(f"qid {q}: stats total != delivered matches")
    emit({"phase": "parity", "ticks": len(infos), "tenants": len(qids),
          "matches_compared": sum(sum(m.values()) for m in matches.values()),
          "state_leaves_equal": n_leaves, "ref_wall_s": wall,
          "identical": True})


def phase_profile(torch, args, stream):
    """Where a serving tick's time goes: a fresh CUDA service serves
    ``--ticks`` batches, and ``torch.profiler`` records the last
    ``PROFILED_TICKS`` of them: device time by kernel, and the device's
    idle share of the window's wall time (profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.service import ContinuousSearchService

    n_prof = PROFILED_TICKS
    svc = ContinuousSearchService(
        slots_per_group=SLOTS, level_capacity=LEVEL_CAP,
        l0_capacity=LEVEL_CAP, max_new=MAX_NEW,
        tick_cache=SlotTickCache(), device=DEVICE)
    for _, q, w in tenants(stream):
        svc.register(q, w)
    kw = dict(batch_size=BATCH, min_batch=BATCH, max_batch=BATCH)
    cut = (args.ticks - n_prof) * BATCH
    svc.serve_stream(stream[:cut], **kw)
    _sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        svc.serve_stream(stream[cut:], **kw)
        _sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))

    # device kernels only: an aten op's entry repeats its kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e)),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    ours = sum(dev_us(e) for e in kernels if e.key.startswith("cj_")) / 1e3
    emit({"phase": "profile", "ticks": n_prof, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "compat_join_ms": ours,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "n_kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [
              {"kernel": e.key[:100], "device_ms": dev_us(e) / 1e3,
               "calls": e.count} for e in kernels[:10]]})


# --------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=64,
                    help="ticks of 4096 edges in the serve phase")
    ap.add_argument("--parity-ticks", type=int, default=16,
                    help="ticks served again on the REF backend")
    args = ap.parse_args(argv)
    if not 1 <= args.parity_ticks <= args.ticks \
            or args.ticks <= PROFILED_TICKS:
        fail(f"need 1 <= --parity-ticks <= --ticks and --ticks > "
             f"{PROFILED_TICKS}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")

    dev = phase_device(torch)
    phase_build()
    cases, worst = phase_kernels(torch, args.seed)
    stream = make_stream(args.seed, args.ticks * BATCH)
    serve, qids, matches, snap, launches = phase_serve(torch, args, stream)
    phase_parity(torch, args, stream, qids, matches, snap)
    phase_profile(torch, args, stream)

    level = next(c for c in cases if c["case"] == "level_window")
    emit({"kernels": [{
        "name": "compat_join_pairs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/compat_join/csrc/compat_join.cu",
        "replaces": "src/repro/kernels/compat_join/kernel.py:454",
        "launches": launches,
        "max_abs_err": worst,
        "ms": level["ms"],
        "plain_ms": level["plain_ms"],
        "bound_ms": level["bound_ms"],
        "bound_by": level["bound_by"],
        "library_ms": None,
        "timed_case": "level_window",
        "cases": {c["case"]: {k: c[k] for k in
                              ("ms", "plain_ms", "bound_ms", "bound_by",
                               "max_abs_err")}
                  for c in cases},
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
