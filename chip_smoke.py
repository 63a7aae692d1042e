#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--ticks N] [--parity-ticks N]
    python3 chip_smoke.py --compare PARENT_TREE [--seed N]

Phases (one JSON line each; any failure ends the run with a non-zero
exit, nothing is caught and skipped):

  device        the card's name and power limit (nvidia-smi) and torch's;
  build         nvcc builds every kernel library from its csrc/ source,
                one nvcc per source, all at once (ptxas -v lines);
  kernel_cases  the compat-join pair kernel against its plain version at
                the serving path's join shapes, over a slot group of 8
                and at S = 1: outputs equal element for element;
                CUDA-event times (median of 20) beside the plain
                version's and the least time the card could take; each
                call's device time by kernel (cj_count / cj_scan /
                cj_emit, torch.profiler), the call's device operations
                (a CUDA graph of one call: those three kernels once each
                and nothing else), the host's time per call (loop_ms)
                and the instantiation the plan picked;
  mask_cases    the mask entry point (core.join.compat_mask, the CUDA
                mask kernel) at the same shapes: masks equal the plain
                version's byte for byte, and each slot's first max_new
                set bits are the pair kernel's pairs; device time of
                cj_mask (the call's one device operation, as its CUDA
                graph shows);
  serve         the main path: ContinuousSearchService on the card with
                its default CUDA join backend, 16 tenants of two
                structures in slot groups of 8, level/L0 capacity 65536,
                max_new 8192, fixed batches of 4096 edges of a seeded
                CAIDA-like stream;
  parity        the same service on the REF backend over a prefix of the
                same stream: per-tenant match multisets, totals, current
                matches, stats and every table leaf identical;
  profile       torch.profiler over the last ticks of a second CUDA
                serve: device time by kernel and the device's idle share;
  session       the public api (repro_torch.api.StreamSession) on the
                card with cross-tenant prefix sharing: 16 Pattern-DSL
                tenants in two families of 8 that share a timed 2-edge
                prefix (one depth-1 and one depth-2 forest node per
                family, each aliased by 8 tenants; the prefix nodes'
                joins are the pair kernel at S = 1, the slot groups' L0
                joins read the shared prefix view as a shared operand),
                the serve phase's capacities, batches and stream; checks:
                overflow 0, the same per-tenant matches with sharing on
                and off, equality with a REF session over the parity
                ticks (tables included), a crash after tick 40 restored
                from the newest checkpoint (step 32; checkpoints every
                16 ticks) replaying exactly once, with zero tick builds
                in the warm cache and again from a cold cache, and a
                forest advance's CUDA graph holding cj_count, cj_scan
                and cj_emit once each per child node; prints edges/s
                and tick p50/p99 with sharing on and off, forest_stats,
                prefix-node ticks per tick, the checkpoint's bytes,
                publish ms and write ms, restore seconds, and pair
                launches per tick by slot count;
  frontier      the fault-tolerant ingest path through the public api:
                the session phase's tenants, capacities and stream on
                the card through ``sources(...)`` + ``serve_frontier``:
                four capture points (``disordered_sources``: 5% of
                deliveries up to 64 positions late, 1% redelivered), each
                behind a seeded ``ChaosSource`` (disconnects with rewind,
                duplicates, reordering, stalls, torn batches), retry with
                no sleeps, 1,024 deliveries a source a round, 4,096-edge
                ticks, event-time admission and expiry from the
                watermark, ``allowed_lateness`` the largest event-time
                regression of any source's delivery sequence; checks:
                overflow 0, no late, forced or forced-gap drop, every
                delivery emitted once or counted as a duplicate,
                per-tenant matches equal to an uninterrupted ``serve()``
                of the canonical stream, a crash after tick 40 restored
                from the newest checkpoint with the frontier resumed from
                ``restored_ingest`` exactly once, the pair kernel
                launched at S = 1 and S = 8; prints edges/s and tick
                p50/p99 beside ``serve()`` (serve, frontier, serve,
                frontier), released chunk sizes, the ServeInfo frontier
                fields summed, pump and release ms per tick (the
                tracer's ``ingest.pump``/``ingest.release`` spans in an
                instrumented turn) and the restore seconds;
  embedding_bag_cases  the embedding_bag kernel against its plain
                version (Wide&Deep's wide side at serve_p99/serve_bulk,
                one general case), with F.embedding_bag's time beside it,
                and both calls' device-only time per call
                (torch.profiler) and the kernel's device operations per
                call (its CUDA graph: one eb_bag_sum kernel);
  recsys_serve  Wide&Deep at its published config serving 20 batches
                each of serve_p99 and serve_bulk; logits held against
                the plain version; one top-100 retrieval of 1M;
  segment_sum_cases  the segment_sum kernel against its plain version at
                the GIN path's shapes on an ogbn-products-shaped graph,
                the same later-layer messages with uniform dst (no hubs)
                and segment_mean's D = 1 count column, with index_add_'s
                time beside it and each case's device time by kernel;
  gin_infer     GIN (gin-tu, bf16) inference on that graph; logits held
                against the plain-version forward.

Each path's kernel launch counter is zeroed just before the path is
driven and read just after (serve, session, frontier, each mask case's
entry-point call, recsys_serve, gin_infer).  Then a {"kernels": [...]}
line, and the last line is {"ok": true, "device": {...}}.  Without a
CUDA device, or without the repository beside this script, it exits
non-zero and prints no result.

``--compare PARENT_TREE`` instead holds this tree's kernels against
another checkout's (e.g. ``git archive`` of the parent commit unpacked
under ``build/``) on one card: it makes the products graph once (kept
under ``build/compare_graph/``), then runs each tree's own serve phase
(the main path, 64 ticks), kernel_cases, mask_cases, embedding_bag_cases
and segment_sum_cases in a fresh process, in the order parent, change,
change, parent, and prints each run's edges/s, tick latency and times
side by side, with, for the compat cases, whether both change runs beat
both parent runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
PROFILE_TRIES = 8        # profiler windows a check may take (see _steps)
# Simple float32 operations (an add) per second: 67 TFLOP/s counts an FMA
# as two, so one add per lane-cycle is 33.5e12/s.
FP32_ADDS_PER_S = 33.5e12
# The substrate's paths: Wide&Deep's serving shapes (configs/registry.py
# recsys_shapes) and retrieval; GIN at the ogbn-products shape
# (gnn_shapes: 2,449,029 nodes; avg degree 25 as synth_products_like
# draws it, 61,225,725 edges).
WD_SERVE = (("serve_p99", 512), ("serve_bulk", 262_144))
WD_BATCHES = 20
RETRIEVAL_CANDIDATES, RETRIEVAL_TOPK = 1_000_000, 100
GIN_NODES, GIN_DEGREE = 2_449_029, 25
GIN_FEAT, GIN_CLASSES = 100, 47
GIN_FORWARDS = 3
# A segment_sum case past the kernel's PRIV_TILES x TN = 3,145,728 nodes,
# where the edge walks take their device-atomic side.
SEG_WIDE_NODES = 4_000_000
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


def _reset_peak(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2**30 \
        if DEVICE == "cuda" else None


def _free(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


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


KERNEL_SOURCES = {          # kernel module -> its CUDA source
    "compat_join": "src/repro_torch/kernels/compat_join/csrc/compat_join.cu",
    "embedding_bag":
        "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
    "segment_reduce":
        "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu",
}


def phase_build():
    """Build every kernel library of the port, one nvcc per source, all
    started together."""
    from pathlib import Path

    from repro_torch.kernels import _build

    sources = [Path(HERE, src) for src in KERNEL_SOURCES.values()]
    t0 = time.perf_counter()
    paths = _build.build(*sources)
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs, "libraries": [
        {"kernel": name, "library": os.path.relpath(path, HERE),
         "ptxas": [ln for ln in _build.build_logs.get(src.name, "")
                   .splitlines() if ln.strip()]}
        for name, src, path in zip(KERNEL_SOURCES, sources, paths)]})


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


def _dev_us(ev) -> float:
    """A profiler event's own device time (torch renamed the field)."""
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def _device_profile(torch, fn, reps: int):
    """Device time of one call of ``fn`` from ``torch.profiler`` over
    ``reps`` calls after one warm-up: each device operation's mean time
    per launch, summed over the operations (each launches once a call;
    the mean is taken per recorded launch because the profiler can miss
    some launches of a run), and that mean by operation name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and _dev_us(e)),
                 key=lambda e: _dev_us(e) / e.count, reverse=True)
    by_name = {e.key[:60]: _dev_us(e) / e.count / 1e3 for e in ops}
    return sum(by_name.values()), by_name


def _host_loop_ms(torch, fn, reps: int = 200) -> float:
    """Wall time per call of ``reps`` back-to-back calls, one synchronise
    at the end: the host's cost per call where it exceeds the device's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name without its return type, template
    arguments and parameters: ``void cj_count<Dims<2, 2, 1, 1, true>, 4,
    true>(CJArgs, int*, int*)`` -> ``cj_count``."""
    head = key.split("(")[0].split("<")[0].split()
    return head[-1] if head else key


def _steps(torch, fn, want: set, what: str, reps: int = 3):
    """Device time of one call of ``fn`` by kernel name over ``reps``
    calls; fails if the call launches any device operation other than the
    kernels ``want``.  The profiler can drop launches, a short window's
    all of them included, so a window that misses one of ``want`` is
    taken again after a short pause (at most ``PROFILE_TRIES`` windows;
    each kernel's time is from the last window that caught it); a kernel
    that no window caught has the time None (``_graph_ops`` shows what
    the call launches without the profiler).  Returns the summed time,
    the times by kernel and the number of windows taken."""
    steps = {}
    for tries in range(1, PROFILE_TRIES + 1):
        if tries > 1:
            time.sleep(0.1 * tries)
        _, by_key = _device_profile(torch, fn, reps)
        for key, ms in by_key.items():
            name = _kernel_name(key)
            if name not in want:
                fail(f"{what}: device operation {key} besides the kernels "
                     f"{sorted(want)}")
            steps[name] = ms
        if set(steps) == want:
            break
    steps = {k: steps.get(k) for k in sorted(want)}
    return sum(v for v in steps.values() if v is not None), steps, tries


def _any_profile(torch, fn, reps: int):
    """``_device_profile`` of ``fn``, taken again (at most
    ``PROFILE_TRIES`` windows) while a window catches no device operation
    at all; the last window's result and the number of windows taken."""
    for tries in range(1, PROFILE_TRIES + 1):
        if tries > 1:
            time.sleep(0.1 * tries)
        dev_ms, by_key = _device_profile(torch, fn, reps)
        if by_key:
            break
    return dev_ms, by_key, tries


def _symbol_name(sym: str) -> str:
    """A kernel symbol's name: ``_Z8cj_countI4DimsILi2E...`` -> ``cj_count``
    (Itanium mangling: the length, then the name); a plain name as is."""
    m = re.match(r"_Z(\d+)", sym)
    return sym[m.end():m.end() + int(m.group(1))] if m else sym


def _graph_ops(torch, fn) -> dict:
    """The device operations of one call of ``fn``, read without the
    profiler: the call (after a warm-up call) is captured into a CUDA
    graph, which is never run, and the graph's nodes are listed with the
    driver API.  Returns {kernel name: nodes}, other nodes counted as
    ``graph node type N`` (the driver's ``CUgraphNodeType``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, call):
        if rc != 0:
            fail(f"{call} returned CUDA driver error {rc}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    ops = Counter()
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            ops[f"graph node type {kind.value}"] += 1
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_void_p * 16)()
        check(cu.cuGraphKernelNodeGetParams_v2(node, params),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if params[0]:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params[0])),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params[7])),
                  "cuKernelGetName")
        ops[_symbol_name(name.value.decode())] += 1
    del graph
    return dict(ops)


def _only_kernels(torch, fn, want: dict, what: str) -> dict:
    """Fails unless one call of ``fn`` launches exactly the kernels
    ``want`` ({name: launches}) and no other device operation, as its
    CUDA graph shows (``_graph_ops``)."""
    ops = _graph_ops(torch, fn)
    if ops != want:
        fail(f"{what}: one call launches {ops}, not {want}")
    return ops


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


def _join_cases(rng, s: int):
    """The serving path's joins at full size, over ``s`` slots (a slot
    group of 8, or S = 1 as a single query's tick has it): the level join
    (A 65536 per slot x the shared 4096-edge batch, with a per-slot edge
    mask), L0 J1 (8192 delta rows x 65536) and L0 J2 (65536 x 8192 delta
    rows) of the two-chain structure; each with and without a window,
    plus one overflow case."""
    import numpy as np

    cap, d = LEVEL_CAP, MAX_NEW
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


def _work(tensors, rel, trel, window, out_bytes, n_slots):
    """(bytes, operations) the join needs on these inputs: each input
    read once and ``out_bytes`` of output written once; the predicate on
    every pair of valid rows (the data decides which pairs need it)."""
    ba, ea, va, bb, eb, vb = tensors
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 0 if window is None else window.numel() * 4
    nbytes += out_bytes
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


def _bound(nbytes: float, nops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the compute rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch, seed: int):
    """The pair kernel against its plain version at the serving path's
    join shapes: over a slot group of 8 (row 2 of the kernel table) and
    at S = 1 (row 1, a single query's tick)."""
    import numpy as np

    from repro_torch.kernels.compat_join import kernel, ops, ref

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    results = []
    worst = 0
    cases = [(SLOTS, "", c) for c in _join_cases(rng, SLOTS)]
    cases += [(1, "s1_", c) for c in _join_cases(rng, 1)]
    for n_slots, prefix, (name, (a, b, rel, trel), win, max_new) in cases:
        name = prefix + name
        tensors = [torch.as_tensor(x, device=dev) for x in (*a, *b)]
        window = None if win is None else torch.as_tensor(win, device=dev)
        args = (*tensors, rel, trel, max_new, window)
        got = ops.compat_join_pairs(*args)
        want = ref.compat_join_pairs(*args)
        _sync(torch)
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
        dev_ms, steps, windows = _steps(
            torch, lambda: ops.compat_join_pairs(*args),
            {"cj_count", "cj_scan", "cj_emit"}, f"kernel case {name}")
        graph_ops = _only_kernels(
            torch, lambda: ops.compat_join_pairs(*args),
            {"cj_count": 1, "cj_scan": 1, "cj_emit": 1}, f"kernel case {name}")
        loop_ms = _host_loop_ms(torch, lambda: ops.compat_join_pairs(*args))
        nbytes, nops = _work(tensors, rel, trel, window,
                             n_slots * (2 * max_new + 1) * 4, n_slots)
        bound_ms, bound_by = _bound(nbytes, nops, INT_OPS_PER_S)
        results.append({
            "case": name, "slots": n_slots,
            "ca": tensors[0].shape[-2], "cb": tensors[3].shape[-2],
            "pairs_kept": int(got[2].sum()),
            "n_dropped": int(got[3].sum()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "operations": nops,
            "max_abs_err": err, "device_ms": dev_ms,
            "device_ms_by_kernel": steps, "loop_ms": loop_ms,
            "profile_windows": windows, "graph_ops": graph_ops,
            "instantiation": _instantiation(kernel, rel, trel),
        })
        worst = max(worst, err)
        del tensors, got, want
    for prefix in ("", "s1_"):
        if not any(r["n_dropped"] for r in results
                   if r["case"] == prefix + "level_overflow"):
            fail(f"the {prefix}level_overflow case dropped no pairs")
    emit({"phase": "kernel_cases", "kernel": "compat_join_pairs",
          "reps": REPS, "cases": results})
    return results, worst


def _instantiation(kernel, rel, trel) -> str:
    """The kernel instantiation the plan picks for this join's shape."""
    dims = rel.shape + trel.shape
    return (f"Dims<{', '.join(map(str, dims))}>" if dims in kernel.SHAPES
            else "runtime dims")


def phase_masks(torch, seed: int):
    """The mask entry point ``core.join.compat_mask`` (device default:
    the CUDA mask kernel) at the serving path's join shapes: the level,
    L0 J1 and L0 J2 joins of a slot group of 8, with and without a
    window, and one S = 1 level join (A 65536 x B 4096).  Each case is
    one drive of the path, its launch count zeroed just before and read
    just after.  The kernel's mask must equal the plain version's byte
    for byte, and each slot's first ``max_new`` set bits in row-major
    order must be the pair kernel's pairs, with ``n_dropped`` = (set
    bits - max_new)+."""
    import numpy as np

    from repro_torch.core import join
    from repro_torch.kernels.compat_join import kernel, ops, ref

    rng = np.random.default_rng(seed + 1)
    dev = torch.device(DEVICE)
    cases = [(SLOTS, c) for c in _join_cases(rng, SLOTS)
             if not c[0].endswith("overflow")]
    s1 = next(c for c in _join_cases(rng, 1) if c[0] == "level_window")
    cases.append((1, ("s1_level_window",) + s1[1:]))
    results, launches = [], 0
    for n_slots, (name, (a, b, rel, trel), win, max_new) in cases:
        tensors = [torch.as_tensor(x, device=dev) for x in (*a, *b)]
        window = None if win is None else torch.as_tensor(win, device=dev)
        args = (*tensors, rel, trel, window)
        ops.compat_mask.launches = 0              # one drive of the path
        got = join.compat_mask(*tensors, rel, trel, window=window)
        _sync(torch)
        launches += ops.compat_mask.launches
        if ops.compat_mask.launches != 1:
            fail(f"mask case {name}: {ops.compat_mask.launches} launches")
        want = ref.compat_mask(*args)
        _sync(torch)
        if got.dtype != torch.bool or got.shape != want.shape:
            fail(f"mask case {name}: {got.dtype} {tuple(got.shape)} vs "
                 f"{want.dtype} {tuple(want.shape)}")
        n_diff = int((got != want).sum())
        if n_diff:
            fail(f"mask case {name}: {n_diff} mask bytes differ")
        del want
        pairs = ops.compat_join_pairs(*tensors, rel, trel, max_new, window)
        set_bits = got.reshape(n_slots, -1).sum(dim=1)
        for s in range(n_slots):
            first = join.extract_pairs(got[s:s + 1], max_new)
            for k, (x, y) in enumerate(zip(first, pairs)):
                if not torch.equal(x[0], y[s]):
                    fail(f"mask case {name} slot {s}: output {k} of the "
                         "pair kernel != the mask's first set bits")
        dropped = (set_bits - max_new).clamp(min=0).to(torch.int32)
        if not torch.equal(dropped, pairs[3]):
            fail(f"mask case {name}: n_dropped != (set bits - max_new)+")
        del pairs
        ms = _time_ms(torch, lambda: ops.compat_mask(*args), REPS)
        plain_ms = _time_ms(torch, lambda: ref.compat_mask(*args), REPS)
        dev_ms, steps, windows = _steps(
            torch, lambda: ops.compat_mask(*args), {"cj_mask"},
            f"mask case {name}")
        graph_ops = _only_kernels(torch, lambda: ops.compat_mask(*args),
                                  {"cj_mask": 1}, f"mask case {name}")
        nbytes, nops = _work(tensors, rel, trel, window, got.numel(),
                             n_slots)
        bound_ms, bound_by = _bound(nbytes, nops, INT_OPS_PER_S)
        results.append({
            "case": name, "slots": n_slots,
            "ca": tensors[0].shape[-2], "cb": tensors[3].shape[-2],
            "mask_bytes": got.numel(), "set_bits": int(set_bits.sum()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "operations": nops,
            "max_abs_err": 0, "device_ms": dev_ms,
            "device_ms_by_kernel": steps, "profile_windows": windows,
            "graph_ops": graph_ops,
            "instantiation": _instantiation(kernel, rel, trel),
        })
        del tensors, got
        _free(torch)
    emit({"phase": "mask_cases", "kernel": "compat_mask", "reps": REPS,
          "path_launches": launches, "cases": results})
    return results, launches


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

    # device kernels only: an aten op's entry repeats its kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and _dev_us(e)),
                     key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    cj = Counter()
    for e in kernels:
        if _kernel_name(e.key).startswith("cj_"):
            cj[_kernel_name(e.key)] += _dev_us(e) / 1e3
    emit({"phase": "profile", "ticks": n_prof, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "compat_join_ms": sum(cj.values()),
          "compat_join_ms_by_kernel": dict(cj),
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "n_kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [
              {"kernel": e.key[:100], "device_ms": _dev_us(e) / 1e3,
               "calls": e.count} for e in kernels[:10]]})


# --------------------------------------------------------------------- #
# session: the stateful serving stack through the public api
# --------------------------------------------------------------------- #
SESSION_WINDOWS = (WINDOW_BASE, WINDOW_BASE + 3500)
SESSION_CKPT_EVERY = 16
SESSION_CRASH_TICK = 40


# A family: the hub label index of a, the light label indices of b and c
# (the prefix a -e0-> b -e1-> c); the third edge c -> d varies over edge
# labels 2 and 3 and four light labels of d.  Chosen on the host from the
# seeded stream so that no join keeps more than ~1,200 of its 8,192 pairs
# a tick and no table holds more than ~2,300 of its 65,536 rows: an
# untimed third edge over the common labels multiplies matches past
# max_new (a first chip run of this phase dropped 472,267 appends).
SESSION_FAMILIES = ((0, 1, 2), (1, 0, 1))


def session_patterns(stream):
    """16 ``Pattern`` DSL tenants in two families of 8.  A family's
    patterns share a timed 2-edge prefix a->b->c (e0 before e1) and its
    window, and differ in a third edge c->d (its label and d's label)
    that is not timed against the prefix: the planner makes the prefix
    subquery 0 (shared: one depth-1 and one depth-2 forest node per
    family, each aliased by its 8 tenants) and the third edge a second
    subquery joined in L0 — where the slot groups read the shared prefix
    view as a shared join operand.  Join vertices (b, c) take labels
    outside the busiest vertices' labels, as ``tenants()`` picks them."""
    from repro_torch.api import Pattern

    n_l = STREAM["n_vertex_labels"]
    heavy = hub_labels(stream, N_HUBS)
    light = [lab for lab in range(n_l) if lab not in heavy]
    if len(light) < 4:
        fail(f"{n_l} vertex labels leave < 4 outside the hubs' {heavy}")
    out = []
    for fam, (window, (ia, ib, ic)) in enumerate(
            zip(SESSION_WINDOWS, SESSION_FAMILIES)):
        for k in range(8):
            p = (Pattern(f"fam{fam}-v{k}")
                 .vertex("a", label=heavy[ia % len(heavy)])
                 .vertex("b", label=light[ib])
                 .vertex("c", label=light[ic])
                 .vertex("d", label=light[k % 4])
                 .edge("a", "b", label=1)
                 .edge("b", "c", label=2)
                 .edge("c", "d", label=2 + k // 4)
                 .before(0, 1)
                 .window(window))
            out.append(p)
    return out


def _session(backend, share, tick_cache, ckpt_dir=None):
    from repro_torch.api import StreamSession

    return StreamSession(
        slots_per_group=SLOTS, level_capacity=LEVEL_CAP,
        l0_capacity=LEVEL_CAP, max_new=MAX_NEW, backend=backend,
        ckpt_dir=ckpt_dir, tick_cache=tick_cache, share_prefixes=share,
        device=DEVICE)


class _Reports:
    """Per-tenant typed matches, each tagged with its tick; optionally
    snapshots the session's tables at one tick."""

    def __init__(self, sess, snapshot_tick=None):
        self.sess = sess
        self.rows = []                 # (tick, qid, Match)
        self._pending = []
        self.infos = []
        self.snapshot_tick = snapshot_tick
        self.snap = None

    def on_match_for(self, qid):
        return lambda m: self._pending.append((qid, m))

    def on_tick(self, info):
        self.infos.append(info)
        self.rows += [(info.tick, q, m) for q, m in self._pending]
        self._pending.clear()
        if info.tick == self.snapshot_tick:
            self.snap = _session_tables(self.sess)

    def multiset(self, upto=None):
        return Counter((q, m) for t, q, m in self.rows
                       if upto is None or t <= upto)


def _session_tables(sess):
    """Host copies of every forest node state and tenant state."""
    from repro_torch.core.state import state_to_numpy

    svc = sess.service
    nodes = [] if svc.forest is None else [
        ((n.pid, n.depth, n.epoch, n.refcount), state_to_numpy(n.state))
        for n in svc.forest.nodes()]
    return nodes, {q: state_to_numpy(svc.state(q))
                   for q in svc.registry.qids()}


def _flat(t):
    if isinstance(t, tuple):
        return [x for v in t for x in _flat(v)]
    return [t]


def _same_tables(a, b) -> int:
    """Fails unless two ``_session_tables`` snapshots are identical;
    returns the number of leaves compared."""
    import numpy as np

    (na, qa), (nb, qb) = a, b
    if [k for k, _ in na] != [k for k, _ in nb] or sorted(qa) != sorted(qb):
        fail("session: forest nodes or tenants differ")
    n = 0
    for x, y in [(x, y) for (_, sa), (_, sb) in zip(na, nb)
                 for x, y in zip(_flat(sa), _flat(sb))] + \
            [(x, y) for q in qa for x, y in zip(_flat(qa[q]), _flat(qb[q]))]:
        if x.shape != y.shape or not np.array_equal(x, y):
            fail("session: a table leaf differs")
        n += 1
    return n


def _serve_session(sess, patterns, edges, reports, **serve):
    """Register ``patterns`` (first call) and serve ``edges``; returns
    the wall seconds of the serve."""
    import torch

    if not sess.subscriptions():
        for p in patterns:
            sub = sess.register(p)
            sub.on_match = reports.on_match_for(sub.qid)
    _sync(torch)
    t0 = time.perf_counter()
    sess.serve(edges, on_tick=reports.on_tick, batch_size=BATCH,
               min_batch=BATCH, max_batch=BATCH, **serve)
    _sync(torch)
    return time.perf_counter() - t0


def _timing(sharing, n_edges, wall, infos):
    lat = [i.latency_ms for i in infos]
    return {"sharing": sharing, "edges_per_s": n_edges / wall,
            "wall_s": wall, "tick_ms_p50": _pctl(lat, 0.5),
            "tick_ms_p99": _pctl(lat, 0.99), "tick_ms_first": lat[0],
            "tick_ms_p99_after_first": _pctl(lat[1:], 0.99)}


def _advance_graph_ops(torch, forest, batch):
    """Device operations of one forest advance (every node's tick, as
    ``SharedPrefixForest.advance`` runs them, the results thrown away so
    the captured calls leave the forest as it was): a CUDA graph of one
    call (``_graph_ops``)."""
    order = sorted(forest.nodes(), key=lambda n: (n.depth, n.pid))

    def advance():
        views = {}
        for n in order:
            if n.parent is None:
                _, views[n.pid], _ = n.tick(n.state, batch, n.esl, n.edl,
                                            n.eel, n.window)
            else:
                _, views[n.pid], _ = n.tick(
                    n.state, batch, views[n.parent.pid], n.esl, n.edl,
                    n.eel, n.window)

    return _graph_ops(torch, advance), sum(n.parent is not None
                                           for n in order)


def phase_session(torch, args, stream):
    """The public api on the card: ``StreamSession`` with prefix sharing
    over the CUDA backend, checked against an unshared CUDA session, a
    REF session over the parity prefix, a crash after tick 40 restored
    from the newest checkpoint (warm and cold tick caches), and the
    device operations of a prefix-node tick."""
    import tempfile

    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.state import make_batch
    from repro_torch.kernels.compat_join import ops
    from repro_torch.stream.generator import to_batches

    patterns = session_patterns(stream)
    n_ticks = len(stream) // BATCH
    crash = min(SESSION_CRASH_TICK, n_ticks - 1)
    tc = SlotTickCache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")

    # -- A: shared, CUDA, uninterrupted (the path whose launches count) --
    sess_a = _session(None, True, tc, os.path.join(tmp, "a"))
    rep_a = _Reports(sess_a, snapshot_tick=args.parity_ticks)
    _free(torch)
    _reset_peak(torch)
    ops.compat_join_pairs.launches = 0          # counts of the session path
    ops.compat_join_pairs.launches_by_slots.clear()
    wall_a = _serve_session(sess_a, patterns, stream, rep_a)
    launches = ops.compat_join_pairs.launches
    by_slots = dict(ops.compat_join_pairs.launches_by_slots)
    peak_a = _peak_gib(torch)
    svc_a = sess_a.service
    if svc_a.backend != ("cuda" if DEVICE == "cuda" else "ref"):
        fail(f"the session's default backend is {svc_a.backend}, not cuda")
    fs = svc_a.forest_stats()
    shared_nodes = [n for n in svc_a.forest.nodes() if n.refcount > 1]
    if fs.n_nodes != 4 or len(shared_nodes) != 4 \
            or any(n.refcount != 8 for n in shared_nodes):
        fail(f"session: forest {fs} is not one depth-1 and one depth-2 "
             "node per family, each aliased by 8 tenants")
    if not by_slots.get(1) or not by_slots.get(SLOTS):
        fail(f"session: pair launches by slot count {by_slots}: need "
             f"S = 1 (prefix nodes) and S = {SLOTS} (slot groups)")
    overflow_a = svc_a.overflow_pressure()
    reports_a = rep_a.multiset()
    if overflow_a or any(i.n_overflow for i in rep_a.infos):
        fail(f"session: overflow {overflow_a} with sharing on")
    if not reports_a:
        fail("session: no matches with sharing on")
    node_ticks = [i.n_shared_prefix_ticks for i in rep_a.infos]

    # -- B: unshared, CUDA -------------------------------------------------
    sess_b = _session(None, False, SlotTickCache())
    rep_b = _Reports(sess_b)
    wall_b = _serve_session(sess_b, patterns, stream, rep_b)
    if sess_b.service.overflow_pressure():
        fail("session: overflow with sharing off")
    if rep_b.multiset() != reports_a:
        fail("session: per-tenant matches differ with sharing on and off")
    timing = [_timing(True, len(stream), wall_a, rep_a.infos),
              _timing(False, len(stream), wall_b, rep_b.infos)]
    # a second turn of each, fresh sessions on warm caches: shared,
    # unshared, shared, unshared (host noise between the two)
    cache_b = sess_b.service.tick_cache
    del sess_b
    for share, cache in ((True, tc), (False, cache_b)):
        sess_t = _session(None, share, cache)
        rep_t = _Reports(sess_t)
        wall_t = _serve_session(sess_t, patterns, stream, rep_t)
        if rep_t.multiset() != reports_a:
            fail("session: a second run's matches differ")
        timing.append(_timing(share, len(stream), wall_t, rep_t.infos))
        del sess_t
    _free(torch)

    # -- C: REF over the parity prefix, tables included ---------------------
    sess_c = _session("ref", True, SlotTickCache())
    rep_c = _Reports(sess_c, snapshot_tick=args.parity_ticks)
    wall_c = _serve_session(sess_c, patterns,
                            stream[:args.parity_ticks * BATCH], rep_c)
    if rep_c.multiset() != rep_a.multiset(upto=args.parity_ticks):
        fail("session: REF and CUDA matches differ over the parity ticks")
    n_leaves = _same_tables(rep_a.snap, rep_c.snap)
    del sess_c
    _free(torch)

    # -- the prefix-node tick's device operations ---------------------------
    batch = make_batch(**to_batches(stream[:BATCH], BATCH)[0], device=DEVICE)
    graph, n_child = _advance_graph_ops(torch, svc_a.forest, batch)
    cj = {k: v for k, v in graph.items() if k.startswith("cj_")}
    if cj != {"cj_count": n_child, "cj_scan": n_child, "cj_emit": n_child}:
        fail(f"session: a forest advance launches {cj}, not cj_count, "
             f"cj_scan, cj_emit once each for its {n_child} child nodes")

    # -- checkpoint: bytes, synchronous publish, async write ---------------
    publish_ms, write_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sess_a.checkpoint()
        publish_ms.append((time.perf_counter() - t0) * 1e3)
        sess_a.close()
        write_ms.append(svc_a.ckpt.last_write_s * 1e3)
    step = svc_a._ckpt_step
    ckpt_bytes = os.path.getsize(os.path.join(tmp, "a", f"step_{step}.npz"))

    # -- D: crash after tick 40, restore, replay -----------------------------
    from repro_torch.api import StreamSession

    dir_d = os.path.join(tmp, "d")
    sess_d = _session(None, True, tc, dir_d)
    rep_d = _Reports(sess_d)
    _serve_session(sess_d, patterns, stream[:crash * BATCH], rep_d,
                   ckpt_every=SESSION_CKPT_EVERY, final_checkpoint=False)
    sess_d.close()
    del sess_d                                   # the crash
    _free(torch)
    restored = {}
    for name, cache in (("warm", tc), ("cold", SlotTickCache())):
        builds = cache.n_builds
        _sync(torch)
        t0 = time.perf_counter()
        sess_r = StreamSession.restore(dir_d, tick_cache=cache,
                                       device=DEVICE)
        _sync(torch)
        secs = time.perf_counter() - t0
        svc_r = sess_r.service
        step_r = svc_r.n_ticks
        want_step = (crash // SESSION_CKPT_EVERY) * SESSION_CKPT_EVERY
        if step_r != want_step:
            fail(f"session: restored at tick {step_r}, not {want_step}")
        if name == "warm" and cache.n_builds != builds:
            fail(f"session: a warm restore built "
                 f"{cache.n_builds - builds} ticks")
        rep_r = _Reports(sess_r)
        for sub in sess_r.subscriptions():
            sub.on_match = rep_r.on_match_for(sub.qid)
        _serve_session(sess_r, patterns,
                       stream[sess_r.resume_offset:], rep_r)
        kept = rep_d.multiset(upto=step_r)
        once = kept + Counter({(q, m): c for (q, m), c in
                               rep_r.multiset().items()})
        if once != reports_a:
            fail(f"session: {name} restore + replay is not exactly once "
                 f"({sum(once.values())} reports vs "
                 f"{sum(reports_a.values())})")
        restored[name] = {"seconds": secs, "step": step_r,
                          "tick_builds": cache.n_builds - builds}
        del sess_r, svc_r
        _free(torch)

    out = {
        "phase": "session", "tenants": len(patterns), "ticks": n_ticks,
        "slots_per_group": SLOTS, "level_capacity": LEVEL_CAP,
        "max_new": MAX_NEW, "batch": BATCH, "backend": svc_a.backend,
        "timing": timing,
        "forest_stats": fs._asdict(),
        "prefix_node_ticks_per_tick": sorted(set(node_ticks)),
        "groups": len(svc_a._iter_groups()),
        "matches_total": sum(reports_a.values()), "n_overflow": overflow_a,
        "compat_join_launches": launches,
        "compat_join_launches_per_tick_by_slots": {
            str(s): n / n_ticks for s, n in sorted(by_slots.items())},
        "forest_advance_graph": graph, "child_nodes": n_child,
        "parity": {"ticks": args.parity_ticks, "state_leaves_equal":
                   n_leaves, "ref_wall_s": wall_c},
        "checkpoint": {"step": step, "bytes": ckpt_bytes,
                       "publish_ms": publish_ms, "write_ms": write_ms},
        "restore": restored, "crash_after_tick": crash,
        "peak_mem_gib": peak_a,
    }
    emit(out)
    return out, launches, by_slots


# --------------------------------------------------------------------- #
# frontier: the fault-tolerant ingest path through the public api
# --------------------------------------------------------------------- #
FRONTIER_PUMP = BATCH // 4        # deliveries a source a round: 4 fill a tick
FRONTIER_REORDER_CAP = 1 << 20    # never forces: the watermark releases
FRONTIER_DISORDER = dict(n_sources=4, disorder_frac=0.05, max_delay=64,
                         duplicate_rate=0.01)
# tests/test_ingest_chaos.py:_chaos_sources's fault mix
FRONTIER_CHAOS = dict(p_disconnect=0.08, rewind=4, p_duplicate=0.05,
                      reorder_span=3, p_reorder=0.2, p_stall=0.05,
                      stall_len=2, p_torn=0.05)


def _frontier_sources(stream, seed: int):
    """Four capture points (``disordered_sources``: 5% of deliveries up
    to 64 positions late, 1% redelivered), each behind a seeded
    ``ChaosSource`` and a counter of its raw deliveries."""
    from repro_torch.stream.chaos import ChaosConfig, ChaosSource
    from repro_torch.stream.generator import DisorderConfig, \
        disordered_sources
    from repro_torch.stream.ingest import ScriptedSource, Source

    class Counted(Source):
        def __init__(self, inner):
            self.inner, self.name, self.n_delivered = inner, inner.name, 0

        def connect(self, resume_from=0):
            self.inner.connect(resume_from)

        def poll(self, max_events=64):
            out = self.inner.poll(max_events)
            self.n_delivered += len(out)
            return out

        def close(self):
            self.inner.close()

        @property
        def exhausted(self):
            return self.inner.exhausted

    scripts = disordered_sources(stream, DisorderConfig(
        seed=seed, **FRONTIER_DISORDER))
    return scripts, [
        Counted(ChaosSource(ScriptedSource(f"cap{i}", sc), ChaosConfig(
            seed=seed + 2 + i, **FRONTIER_CHAOS)))
        for i, sc in enumerate(scripts)]


def _regression(ts_seq) -> int:
    """Largest event-time regression of a delivery sequence: how far an
    event's ts lies below the largest ts delivered before it."""
    worst, hi = 0, None
    for t in ts_seq:
        if hi is not None:
            worst = max(worst, hi - t)
        hi = t if hi is None else max(hi, t)
    return worst


def _delivered_lateness(stream, seed: int, manifest=None) -> int:
    """The largest event-time regression within any source's delivery
    script as its chaos transport delivers it: each source replayed on
    the host through a ``SourceAdapter`` with the frontier's seeds, poll
    size and retry policy (and, after a restore, the manifest's
    cursors), duplicates suppressed as the frontier suppresses them.
    With this lateness no delivery is late."""
    from repro_torch.runtime.fault import RetryPolicy
    from repro_torch.stream.ingest import SeqTracker, SourceAdapter

    cursors = {} if manifest is None else {
        s["name"]: SeqTracker.from_manifest(s) for s in manifest["sources"]}
    worst = 0
    for src in _frontier_sources(stream, seed)[1]:
        a = SourceAdapter(src, retry=RetryPolicy(base_delay_s=0.0),
                          sleep=lambda d: None, tracker=cursors.get(src.name))
        seq = []
        while not a.exhausted:
            seq += [ev.ts for ev in a.pull(FRONTIER_PUMP)]
        worst = max(worst, _regression(seq))
    return worst


def _serve_frontier(sess, patterns, stream, seed, lateness, reports,
                    resume=None, on_tick=None, **serve):
    """Register ``patterns`` (first call), build the frontier over fresh
    chaos sources and serve it; returns (wall seconds, frontier, the
    counted sources)."""
    import torch

    from repro_torch.runtime.fault import RetryPolicy

    if not sess.subscriptions():
        for p in patterns:
            sub = sess.register(p)
            sub.on_match = reports.on_match_for(sub.qid)
    _, srcs = _frontier_sources(stream, seed)
    fr = sess.sources({s.name: s for s in srcs}, resume=resume,
                      allowed_lateness=lateness,
                      reorder_capacity=FRONTIER_REORDER_CAP,
                      retry=RetryPolicy(base_delay_s=0.0),
                      sleep=lambda d: None)
    _sync(torch)
    t0 = time.perf_counter()
    sess.serve_frontier(fr, on_tick=on_tick or reports.on_tick,
                        batch_size=BATCH, min_batch=BATCH, max_batch=BATCH,
                        pump_size=FRONTIER_PUMP, **serve)
    _sync(torch)
    return time.perf_counter() - t0, fr, srcs


def _frontier_checks(what, fr, srcs, infos, n_edges, emitted_before=0):
    """The frontier's accounting: every raw delivery emitted once,
    counted as a duplicate or counted as dropped; nothing late, nothing
    forced, nothing left in the buffer.  A resumed frontier's counters
    carry ``emitted_before`` emissions of the run it resumes."""
    s = fr.stats()
    delivered = sum(x.n_delivered for x in srcs)
    accounted = s.n_emitted - emitted_before + s.n_duplicates \
        + s.n_late_dropped + s.n_dropped_forced_gap + s.buffered
    if delivered != accounted:
        counts = {k: v for k, v in s.items() if k != "by_source"}
        fail(f"frontier {what}: {delivered} deliveries, {accounted} "
             f"accounted for ({counts})")
    if s.n_late_dropped or s.n_dropped_forced_gap or s.n_forced \
            or s.buffered:
        fail(f"frontier {what}: late {s.n_late_dropped}, forced gap "
             f"{s.n_dropped_forced_gap}, forced {s.n_forced}, buffered "
             f"{s.buffered}")
    if n_edges is not None and s.n_emitted != n_edges:
        fail(f"frontier {what}: emitted {s.n_emitted} of {n_edges}")
    if any(i.n_overflow for i in infos):
        fail(f"frontier {what}: overflow")
    return s, delivered


def _serve_info_sums(infos) -> dict:
    return {"n_late_dropped": sum(i.n_late_dropped for i in infos),
            "n_duplicates": sum(i.n_duplicates for i in infos),
            "n_reconnects": sum(i.n_reconnects for i in infos),
            "n_dropped_forced_gap": sum(i.n_dropped_forced_gap
                                        for i in infos),
            "watermark_lag_max": max(i.watermark_lag for i in infos),
            "watermark_lag_mean": statistics.fmean(
                i.watermark_lag for i in infos),
            "window_staleness_max": max(i.window_staleness for i in infos),
            "watermark_last": infos[-1].watermark}


def phase_frontier(torch, args, stream):
    """The ingest frontier through the public api on the card:
    ``StreamSession(share_prefixes=True)`` on the CUDA backend fed by
    ``sources(...)`` + ``serve_frontier`` — four disordered capture
    points behind chaos transports (disconnects with rewind, duplicates,
    reordering, stalls, torn batches), retry without sleeps, event-time
    admission and expiry from the watermark — held to an uninterrupted
    ``serve()`` of the canonical stream; a crash restored from the
    newest checkpoint with the frontier resumed from
    ``restored_ingest``."""
    import tempfile

    from repro_torch.api import StreamSession
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.kernels.compat_join import ops
    from repro_torch.obs import Tracer
    from repro_torch.obs.summarize import summarize_trace
    from repro_torch.runtime.fault import SimulatedFailure

    patterns = session_patterns(stream)
    n_ticks = len(stream) // BATCH
    crash = min(SESSION_CRASH_TICK, n_ticks - 1)
    seed = args.seed
    tc = SlotTickCache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_frontier_")
    t0 = time.perf_counter()
    scripts, _ = _frontier_sources(stream, seed)
    script_lateness = max(_regression([e.ts for _, e in sc])
                          for sc in scripts)
    lateness = _delivered_lateness(stream, seed)
    setup_s = time.perf_counter() - t0

    timing, want, launches, by_slots = [], None, None, None
    frontier_runs = []
    # shared serve, frontier, shared serve, frontier: fresh sessions on
    # one warm tick cache (host noise between the turns)
    for turn, kind in enumerate(("serve", "frontier", "serve",
                                 "frontier")):
        sess = _session(None, True, tc)
        rep = _Reports(sess)
        if kind == "serve":
            wall = _serve_session(sess, patterns, stream, rep)
            svc = sess.service
            if svc.overflow_pressure() or any(i.n_overflow
                                               for i in rep.infos):
                fail("frontier: the serve() turn overflowed")
            if want is None:
                want = rep.multiset()
                if not want:
                    fail("frontier: the serve() turn found no matches")
            elif rep.multiset() != want:
                fail("frontier: two serve() turns differ")
        else:
            if launches is None:
                ops.compat_join_pairs.launches = 0     # the frontier path
                ops.compat_join_pairs.launches_by_slots.clear()
            wall, fr, srcs = _serve_frontier(sess, patterns, stream, seed,
                                             lateness, rep)
            if launches is None:
                launches = ops.compat_join_pairs.launches
                by_slots = dict(ops.compat_join_pairs.launches_by_slots)
            svc = sess.service
            if svc.backend != ("cuda" if DEVICE == "cuda" else "ref"):
                fail(f"frontier: backend {svc.backend}, not cuda")
            if svc.overflow_pressure():
                fail(f"frontier: overflow {svc.overflow_pressure()}")
            st, delivered = _frontier_checks(f"turn {turn}", fr, srcs,
                                             rep.infos, len(stream))
            if rep.multiset() != want:
                got = rep.multiset()
                fail(f"frontier: per-tenant matches differ from serve() "
                     f"({sum(got.values())} vs {sum(want.values())})")
            status = sess.status()
            if status.n_late_dropped or status.health != "active":
                fail(f"frontier: session status {status}")
            chunks = sorted(i.chunk for i in rep.infos)
            frontier_runs.append({
                "ticks": len(rep.infos), "delivered": delivered,
                "stats": {k: v for k, v in st.items() if k != "by_source"},
                "serve_info_sums": _serve_info_sums(rep.infos),
                "chunk": {"min": chunks[0], "p50": _pctl(chunks, 0.5),
                          "max": chunks[-1],
                          "n_full": sum(c == BATCH for c in chunks),
                          "n_below_half": sum(c < BATCH // 2
                                              for c in chunks)},
                "forest_stats": svc.forest_stats()._asdict()})
        timing.append({"turn": kind, **_timing(True, len(stream), wall,
                                               rep.infos)})
        del sess, svc
        _free(torch)

    # -- an instrumented turn: the frontier's own host cost, per tick ------
    buf_path = os.path.join(tmp, "trace.jsonl")
    with Tracer(buf_path) as tracer:
        sess = StreamSession(
            slots_per_group=SLOTS, level_capacity=LEVEL_CAP,
            l0_capacity=LEVEL_CAP, max_new=MAX_NEW, tick_cache=tc,
            share_prefixes=True, tracer=tracer, device=DEVICE)
        rep = _Reports(sess)
        wall_i, fr, srcs = _serve_frontier(sess, patterns, stream, seed,
                                           lateness, rep)
        _frontier_checks("instrumented", fr, srcs, rep.infos, len(stream))
        if rep.multiset() != want:
            fail("frontier: the instrumented turn's matches differ")
    spans = summarize_trace(buf_path)["spans"]
    n_tick = len(rep.infos)
    host = {name: {"ms_per_tick": spans[name]["total_ms"] / n_tick,
                   "p50_ms": spans[name]["p50_ms"],
                   "p99_ms": spans[name]["p99_ms"],
                   "count": spans[name]["count"]}
            for name in ("ingest.pump", "ingest.release", "tick.forest",
                         "tick.slot_dispatch", "tick.barrier",
                         "tick.deliver") if name in spans}
    metrics = {k: v for k, v in sess.metrics().items()
               if k.startswith("ingest.")}
    del sess
    _free(torch)

    # -- crash after tick 40, restore, resume the frontier exactly once -----
    dir_d = os.path.join(tmp, "d")
    sess_d = _session(None, True, tc, dir_d)
    rep_d = _Reports(sess_d)

    def crash_at(info):
        rep_d.on_tick(info)
        if info.tick == crash:
            raise SimulatedFailure(f"injected after tick {crash}")

    try:
        _serve_frontier(sess_d, patterns, stream, seed, lateness, rep_d,
                        on_tick=crash_at, ckpt_every=SESSION_CKPT_EVERY,
                        final_checkpoint=False)
        fail("frontier: the injected crash did not happen")
    except SimulatedFailure:
        pass
    sess_d.close()
    del sess_d                                   # the crash
    _free(torch)
    _sync(torch)
    t0 = time.perf_counter()
    sess_r = StreamSession.restore(dir_d, tick_cache=tc, device=DEVICE)
    _sync(torch)
    restore_s = time.perf_counter() - t0
    man = sess_r.restored_ingest
    step_r = sess_r.service.n_ticks
    want_step = (crash // SESSION_CKPT_EVERY) * SESSION_CKPT_EVERY
    if man is None or step_r != want_step:
        fail(f"frontier: restored at tick {step_r} (want {want_step}) "
             f"with ingest manifest {man is not None}")
    if sess_r.service.n_edges_ingested != man["counters"]["n_emitted"]:
        fail("frontier: the restored service and its ingest cursors "
             "disagree")
    lateness_r = max(lateness, _delivered_lateness(stream, seed, man))
    rep_r = _Reports(sess_r)
    for sub in sess_r.subscriptions():
        sub.on_match = rep_r.on_match_for(sub.qid)
    wall_r, fr_r, srcs_r = _serve_frontier(sess_r, patterns, stream, seed,
                                           lateness_r, rep_r, resume=man)
    st_r, _ = _frontier_checks("resumed", fr_r, srcs_r, rep_r.infos,
                               len(stream), man["counters"]["n_emitted"])
    once = rep_d.multiset(upto=step_r) + rep_r.multiset()
    if once != want:
        fail(f"frontier: restore + resume is not exactly once "
             f"({sum(once.values())} reports vs {sum(want.values())})")
    if sess_r.service.n_edges_ingested != len(stream):
        fail("frontier: the resumed run did not ingest the whole stream")
    del sess_r
    _free(torch)

    out = {
        "phase": "frontier", "tenants": len(patterns), "edges": len(stream),
        "slots_per_group": SLOTS, "level_capacity": LEVEL_CAP,
        "max_new": MAX_NEW, "batch": BATCH, "pump_size": FRONTIER_PUMP,
        "reorder_capacity": FRONTIER_REORDER_CAP,
        "disorder": FRONTIER_DISORDER, "chaos": FRONTIER_CHAOS,
        "allowed_lateness": lateness,
        "script_lateness": script_lateness, "setup_s": setup_s,
        "timing": timing, "runs": frontier_runs,
        "matches_total": sum(want.values()),
        "compat_join_launches": launches,
        "compat_join_launches_by_slots": {
            str(k): v for k, v in sorted(by_slots.items())},
        "instrumented": {"wall_s": wall_i, "ticks": n_tick,
                         "host_spans": host, "ingest_metrics": metrics},
        "restore": {"seconds": restore_s, "step": step_r,
                    "crash_after_tick": crash, "lateness": lateness_r,
                    "resumed_ticks": len(rep_r.infos),
                    "resumed_wall_s": wall_r,
                    "resumed_duplicates": st_r.n_duplicates,
                    "exactly_once": True},
    }
    emit(out)
    if not launches or not by_slots.get(1) or not by_slots.get(SLOTS):
        fail(f"frontier: pair launches {launches} by slot count "
             f"{by_slots}: need S = 1 (prefix nodes) and S = {SLOTS}")
    return out, launches, by_slots


# --------------------------------------------------------------------- #
# substrate: Wide&Deep serving (embedding_bag), GIN inference (segment_sum)
# --------------------------------------------------------------------- #
def _pctl(xs, q: float) -> float:
    """Nearest-rank percentile of ``xs``."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def phase_embedding_bag(torch, seed: int):
    """The embedding_bag kernel against its plain version: the Wide&Deep
    wide side at serve_p99 (512 bags x 16 ids) and serve_bulk (262,144 x
    16) over the published wide table (4,000,000 x 1, float32), with
    ``recsys_batch``'s ids (25% -1), and two general cases (D = 32,
    65,536 bags of 0-16 ids, 10% -1) over a table of small integers and
    over an N(0, 1) table.  The wide side's float32 sums in another
    order: rtol 1e-5, atol 1e-6; the integer sums are exact in any
    order, so there the kernel must equal the plain version (whose
    index_add_ order varies from run to run); the N(0, 1) sums are held
    per element to rtol 1e-5 plus the recursive-summation bound of two
    float32 sums of the bag's n rows, 2 n 2^-24 sum|row|, which a sum in
    a lower precision would break.  Library yardstick: ``F.embedding_bag(mode="sum",
    per_sample_weights=(ids >= 0))`` with bag offsets.  Beside the
    per-call times of ``_time_ms`` (host wrapper + device), the
    device-only time per call of the kernel and of the library call, from
    ``torch.profiler``, the kernel's device operations per call from a
    CUDA graph of one call (it must be one eb_bag_sum kernel), and the
    wall time per call
    of 200 back-to-back calls (``loop_ms``: the host's cost where it is
    the larger)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.wide_deep import CONFIG as WD
    from repro_torch.data.recsys import recsys_batch
    from repro_torch.kernels.embedding_bag import ops, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn((WD.wide_vocab, 1), generator=gen,
                       device=dev).mul_(0.01)
    cases = []
    for name, b in WD_SERVE:
        nb = recsys_batch(0, b, WD.n_sparse, WD.vocab_per_field, WD.n_dense,
                          WD.n_wide_crosses, seed=seed)
        ids = torch.as_tensor(nb["wide_ids"].reshape(-1), device=dev)
        bags = torch.arange(b, dtype=torch.int32, device=dev) \
            .repeat_interleave(WD.n_wide_crosses)
        cases.append(("wide_" + name, ids, bags, wide, b))
    rng = np.random.default_rng(seed)
    n_bags = 65536
    sizes = rng.integers(0, 17, n_bags)                # 0 = an empty bag
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), sizes)
    ids = rng.integers(0, WD.vocab_per_field, bags.size).astype(np.int32)
    ids[rng.random(bags.size) < 0.1] = -1
    ids, bags = (torch.as_tensor(a, device=dev) for a in (ids, bags))
    ints = torch.randint(-4, 5, (WD.vocab_per_field, 32), generator=gen,
                         device=dev, dtype=torch.float32)
    normal = torch.randn((WD.vocab_per_field, 32), generator=gen, device=dev)
    cases += [("general_d32", ids, bags, ints, n_bags),
              ("general_d32_randn", ids, bags, normal, n_bags)]
    results = []
    for name, ids, bags, table, n_bags in cases:
        args = (ids, bags, table, n_bags)
        got = ops.embedding_bag(*args)
        want = ref.embedding_bag(*args)
        _sync(torch)
        err = _max_err(torch, got, want)
        if name == "general_d32":
            tolerance, ok = "equal", err == 0
        elif name == "general_d32_randn":
            tolerance = "rtol 1e-5 + 2 n 2^-24 sum|row|"
            n_ids = torch.bincount(bags[ids >= 0].long(),
                                   minlength=n_bags)[:, None]
            tol = 1e-5 * want.abs() + 2 * n_ids * 2.0**-24 \
                * ref.embedding_bag(ids, bags, table.abs(), n_bags)
            ok = bool(((got - want).abs() <= tol).all())
        else:
            tolerance = "rtol 1e-5, atol 1e-6"
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        if got.shape != want.shape or got.dtype != want.dtype or not ok:
            fail(f"embedding_bag case {name}: kernel != plain (max |err| "
                 f"{err}, tolerance {tolerance})")
        offsets = torch.searchsorted(
            bags, torch.arange(n_bags, dtype=torch.int32, device=dev))
        lib_ids = ids.clamp(min=0).long()
        weights = (ids >= 0).to(table.dtype)

        def library():
            return F.embedding_bag(lib_ids, table, offsets, mode="sum",
                                   per_sample_weights=weights)

        lib_err = _max_err(torch, library(), want)
        ms = _time_ms(torch, lambda: ops.embedding_bag(*args), REPS)
        plain_ms = _time_ms(torch, lambda: ref.embedding_bag(*args), REPS)
        library_ms = _time_ms(torch, library, REPS)
        dev_ms, dev_ops, windows = _steps(
            torch, lambda: ops.embedding_bag(*args), {"eb_bag_sum"},
            f"embedding_bag case {name}", reps=REPS)
        graph_ops = _only_kernels(torch, lambda: ops.embedding_bag(*args),
                                  {"eb_bag_sum": 1},
                                  f"embedding_bag case {name}")
        lib_dev_ms, lib_ops, _ = _any_profile(torch, library, REPS)
        host_ms = _host_loop_ms(torch, lambda: ops.embedding_bag(*args))
        lib_host_ms = _host_loop_ms(torch, library)
        valid = ids[ids >= 0]
        row = table.shape[1] * table.element_size()
        nbytes = 8 * ids.numel() + torch.unique(valid).numel() * row \
            + n_bags * row
        nops = valid.numel() * table.shape[1]
        bound_ms, bound_by = _bound(nbytes, nops, FP32_ADDS_PER_S)
        results.append({
            "case": name, "n_bags": n_bags, "ids": ids.numel(),
            "valid_ids": valid.numel(), "dim": table.shape[1],
            "table_rows": table.shape[0], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "operations": nops,
            "device_ms": dev_ms, "device_kernels_per_call": sum(
                graph_ops.values()),
            "profile_windows": windows, "graph_ops": graph_ops,
            "library_device_ms": lib_dev_ms,
            "library_device_kernels_per_call": len(lib_ops),
            "library_device_ops": list(lib_ops),
            "loop_ms": host_ms, "library_loop_ms": lib_host_ms,
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "tolerance": tolerance})
    emit({"phase": "embedding_bag_cases", "kernel": "embedding_bag",
          "reps": REPS, "cases": results})
    return results


def phase_recsys_serve(torch, seed: int):
    """Wide&Deep serving at the published config (40 fields x 1,000,000
    x 32 float32 tables, wide table 4,000,000, MLP 1024-512-256), random
    weights from a seeded generator on the card: ``WD_BATCHES`` batches
    each of serve_p99 and serve_bulk from ``recsys_batch``, host batch to
    logits on the card per request.  The embedding_bag launch count is
    zeroed just before and read just after.  The same batches through
    the plain version must give the same logits (rtol 1e-5, atol 1e-6:
    only the wide side's float32 sums differ).  Then one retrieval of the
    top 100 of 1,000,000 candidates."""
    from repro_torch.configs.wide_deep import CONFIG
    from repro_torch.data.recsys import batch_to_device, recsys_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models.recsys.wide_deep import WideDeep, retrieval_score

    _reset_peak(torch)
    t0 = time.perf_counter()
    model = WideDeep(CONFIG, device=DEVICE, seed=seed)
    _sync(torch)
    init_s = time.perf_counter() - t0
    if model.backend != "cuda":
        fail(f"Wide&Deep's default backend is {model.backend}, not cuda")
    host = {name: [recsys_batch(step, b, CONFIG.n_sparse,
                                CONFIG.vocab_per_field, CONFIG.n_dense,
                                CONFIG.n_wide_crosses, seed=seed)
                   for step in range(WD_BATCHES)]
            for name, b in WD_SERVE}
    out = {"phase": "recsys_serve", "config": CONFIG.name,
           "params_gib": sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 2**30,
           "init_s": init_s, "batches_per_shape": WD_BATCHES}
    logits = {}
    with torch.inference_mode():
        for name, _ in WD_SERVE:                    # warm-up, not counted
            model(batch_to_device(host[name][-1], DEVICE))
        _sync(torch)
        ops.embedding_bag.launches = 0
        for name, b in WD_SERVE:
            lat, logits[name] = [], []
            for nb in host[name]:
                t0 = time.perf_counter()
                y = model(batch_to_device(nb, DEVICE))
                _sync(torch)
                lat.append((time.perf_counter() - t0) * 1e3)
                logits[name].append(y)
            out[name] = {"batch": b, "examples_per_s": b * len(lat)
                         / (sum(lat) / 1e3), "latency_ms_p50": _pctl(lat, .5),
                         "latency_ms_p99": _pctl(lat, .99),
                         "latency_ms_max": max(lat)}
        launches = ops.embedding_bag.launches
        out["embedding_bag_launches"] = launches
        if launches != len(WD_SERVE) * WD_BATCHES:
            fail(f"Wide&Deep serving launched embedding_bag {launches} "
                 f"times for {len(WD_SERVE) * WD_BATCHES} batches")
        backend, model.backend = model.backend, "ref"
        err = 0.0
        for name, b in WD_SERVE:
            for nb, y in zip(host[name], logits[name]):
                want = model(batch_to_device(nb, DEVICE))
                if y.shape != (b,) or not bool(torch.isfinite(y).all()):
                    fail(f"Wide&Deep {name}: logits {tuple(y.shape)}, not "
                         "finite or of the wrong shape")
                err = max(err, _max_err(torch, y, want))
                if not torch.allclose(y, want, rtol=1e-5, atol=1e-6):
                    fail(f"Wide&Deep {name}: kernel logits != plain "
                         f"(max |err| {err})")
        model.backend = backend
        out["logits_max_abs_err"] = err
        del logits
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        cands = torch.randn((RETRIEVAL_CANDIDATES, CONFIG.embed_dim),
                            generator=gen, device=DEVICE)
        user = torch.randn((CONFIG.embed_dim,), generator=gen, device=DEVICE)
        vals, idx = retrieval_score(user, cands, RETRIEVAL_TOPK)
        want_idx = torch.argsort(cands @ user, descending=True)[:RETRIEVAL_TOPK]
        if not torch.equal(idx, want_idx):
            fail("retrieval_score's top-k != a full sort's")
        out["retrieval"] = {
            "candidates": RETRIEVAL_CANDIDATES, "top_k": RETRIEVAL_TOPK,
            "ms": _time_ms(torch, lambda: retrieval_score(
                user, cands, RETRIEVAL_TOPK), REPS)}
    out["peak_mem_gib"] = _peak_gib(torch)
    emit(out)
    del model, cands
    _free(torch)
    return out, launches


def make_products_graph(torch, seed: int):
    """The ogbn-products-shaped graph (``synth_products_like``: Pareto
    1.2 popularity, ``GIN_NODES`` nodes, ``GIN_DEGREE`` edges per node,
    100 features, 47 classes), made on the host and moved to the card."""
    from repro_torch.data.graphs import graph_to_device, synth_products_like

    t0 = time.perf_counter()
    g = synth_products_like(n_nodes=GIN_NODES, avg_degree=GIN_DEGREE,
                            d_feat=GIN_FEAT, n_classes=GIN_CLASSES,
                            seed=seed)
    make_s = time.perf_counter() - t0
    g = graph_to_device({k: g[k] for k in ("x", "edge_src", "edge_dst")},
                        DEVICE)
    deg = torch.bincount(g["edge_dst"].long(), minlength=GIN_NODES)
    info = {"nodes": GIN_NODES, "edges": g["edge_src"].numel(),
            "host_make_s": make_s, "max_in_degree": int(deg.max())}
    return g, info


def _abs_sums(torch, dst, msg, n_nodes, chunk: int = 1 << 23):
    """Per node, the float32 sum of |msg| over its edges (chunked over
    edges to bound the float32 copy)."""
    seg = torch.where((dst >= 0) & (dst < n_nodes), dst, n_nodes).long()
    acc = torch.zeros((n_nodes + 1, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    for lo in range(0, msg.shape[0], chunk):
        acc.index_add_(0, seg[lo:lo + chunk],
                       msg[lo:lo + chunk].float().abs())
    return acc[:n_nodes]


def phase_segment_sum(torch, seed: int, g, max_in_degree: int):
    """The segment_sum kernel against its plain version at the GIN path's
    shapes on the products graph: layer 1's messages (E x 100, bf16), a
    later layer's (E x 64, bf16), E x 64 float32 messages of small
    integers, the later layer's messages with ``dst`` drawn uniformly
    from [0, N) instead (the same work without the Pareto hubs), the
    same messages with ``dst`` uniform over ``SEG_WIDE_NODES`` nodes
    (more tiles than ``PRIV_TILES``: the edge walks count with device
    atomics instead of shared-memory tile counters, the plan's other
    side), and ``segment_mean``'s count column (E x 1 float32 ones).

    Both versions sum in float32 in an order that the data decides (the
    kernel's bucket order, index_add_'s atomics), and a hub row sums
    ~10^6 messages, so two correct sums of real values differ by up to
    the recursive-summation bound, 2 x deg x 2^-24 x (sum of |msg| into
    the row), plus one bf16 rounding (rtol 1e-2): the bf16 cases are
    held to that bound per element.  Integer messages (|m| <= 4, 4 x max
    in-degree < 2^24) sum exactly in any order, so the float32 cases
    must equal the plain version element for element.  Library
    yardstick: ``index_add_`` into a float32 accumulator, on float32
    messages.  Each case's device time is also broken down by kernel
    (``torch.profiler``)."""
    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    n_graph = g["x"].shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"]
    e = dst.numel()
    if 4 * max_in_degree >= 2**24:
        fail(f"in-degree {max_in_degree} too large for exact float32 sums")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h64 = torch.randn((n_graph, 64), generator=gen, device=DEVICE)
    ints = torch.randint(-4, 5, (n_graph, 64), generator=gen, device=DEVICE,
                         dtype=torch.float32)
    uniform = torch.randint(0, n_graph, (e,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    uniform_wide = torch.randint(0, SEG_WIDE_NODES, (e,), generator=gen,
                                 device=DEVICE, dtype=torch.int32)
    specs = [
        ("gin_l1_bf16", n_graph, dst, lambda: g["x"].bfloat16()[src], 1e-2),
        ("gin_l2_bf16", n_graph, dst, lambda: h64.bfloat16()[src], 1e-2),
        ("f32_d64_exact", n_graph, dst, lambda: ints[src], None),
        ("uniform_d64_bf16", n_graph, uniform,
         lambda: h64.bfloat16()[src], 1e-2),
        ("uniform_4m_nodes_d64_bf16", SEG_WIDE_NODES, uniform_wide,
         lambda: h64.bfloat16()[src], 1e-2),
        ("d1_counts", n_graph, dst,
         lambda: torch.ones((e, 1), device=DEVICE), None)]
    results = []
    for name, n, dst, make, rtol in specs:
        msg = make()
        walk = "shared" if kernel.plan(
            e, n, msg.shape[1], msg.element_size(),
            msg.data_ptr() % 16).priv else "device"
        if walk != ("device" if n == SEG_WIDE_NODES else "shared"):
            fail(f"segment_sum case {name}: the edge walks count in {walk} "
                 f"memory at {n} nodes")
        got = ops.segment_sum(dst, msg, n)
        want = ref.segment_sum(dst, msg, n)
        _sync(torch)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if rtol is None:
            bad = int((diff > 0).sum())
        else:
            deg = torch.bincount(dst[dst >= 0].long(), minlength=n)[:n, None]
            tol = rtol * want.float().abs() \
                + 2 * deg * 2.0**-24 * _abs_sums(torch, dst, msg, n)
            bad = int((diff > tol).sum())
            del tol, deg
        if got.dtype != msg.dtype or got.shape != want.shape or bad:
            fail(f"segment_sum case {name}: kernel != plain (max |err| "
                 f"{err}, {bad} elements out of tolerance)")
        del diff
        ms = _time_ms(torch, lambda: ops.segment_sum(dst, msg, n), REPS)
        plain_ms = _time_ms(torch, lambda: ref.segment_sum(dst, msg, n),
                            REPS)
        seg = torch.where((dst >= 0) & (dst < n), dst, n).long()
        msg32 = msg.float()

        def library():
            return torch.zeros((n + 1, msg.shape[1]), device=DEVICE) \
                .index_add_(0, seg, msg32)

        library_ms = _time_ms(torch, library, REPS)
        d = msg.shape[1]
        nbytes = 4 * e + e * d * msg.element_size() \
            + n * d * msg.element_size()
        bound_ms, bound_by = _bound(nbytes, e * d, FP32_ADDS_PER_S)
        row = {
            "case": name, "edges": e, "nodes": n, "dim": d,
            "dtype": str(msg.dtype).replace("torch.", ""), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "operations": e * d, "max_abs_err": err,
            "tile_counters": walk,
            "tolerance": ("equal" if rtol is None else
                          f"rtol {rtol} + 2 deg 2^-24 sum|msg|")}
        dev_ms, by_kernel, _ = _any_profile(
            torch, lambda: ops.segment_sum(dst, msg, n), 3)
        row.update(device_ms=dev_ms, device_ms_by_kernel=by_kernel)
        results.append(row)
        del msg, msg32, seg, got, want
        _free(torch)
    emit({"phase": "segment_sum_cases", "kernel": "segment_sum",
          "reps": REPS, "cases": results})
    return results


def phase_gin_infer(torch, seed: int, g, graph_info):
    """GIN inference at the gin-tu config (5 layers, 64 hidden) with the
    products graph's widths (100 features, 47 classes), bf16 activations
    as the reference's cell for that shape has them; random weights from
    a seeded generator.  ``GIN_FORWARDS`` timed forwards after one
    warm-up, the segment_sum launch count zeroed just before and read
    just after.  The logits are held against the plain-version forward:
    relative Frobenius error <= 1e-2 (bf16 activations, one rounding
    per op; the kernel's float32 sums round to bf16 at other places)."""
    import dataclasses

    from repro_torch.configs.gin_tu import CONFIG
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.models.gnn.models import GIN

    cfg = dataclasses.replace(CONFIG, d_in=GIN_FEAT, n_classes=GIN_CLASSES,
                              dtype=torch.bfloat16)
    model = GIN(cfg, device=DEVICE, seed=seed)
    if model.backend != "cuda":
        fail(f"GIN's default backend is {model.backend}, not cuda")
    _reset_peak(torch)
    with torch.inference_mode():
        model(g)                                     # warm-up, not counted
        _sync(torch)
        ops.segment_sum.launches = 0
        times = []
        for _ in range(GIN_FORWARDS):
            t0 = time.perf_counter()
            logits = model(g)
            _sync(torch)
            times.append(time.perf_counter() - t0)
        launches = ops.segment_sum.launches
        peak = _peak_gib(torch)
        backend, model.backend = model.backend, "ref"
        t0 = time.perf_counter()
        want = model(g)
        _sync(torch)
        plain_s = time.perf_counter() - t0
        model.backend = backend
    n = g["x"].shape[0]
    if logits.shape != (n, GIN_CLASSES) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"GIN logits {tuple(logits.shape)} not finite or of the wrong "
             "shape")
    rel = float((logits - want).norm() / want.norm())
    out = {"phase": "gin_infer", "config": cfg.name, "layers": cfg.n_layers,
           "hidden": cfg.d_hidden, "dtype": "bfloat16", **graph_info,
           "forwards": GIN_FORWARDS, "forward_s": sorted(times),
           "forward_s_median": _pctl(times, .5),
           "nodes_per_s": n / _pctl(times, .5),
           "edges_per_s": graph_info["edges"] / _pctl(times, .5),
           "plain_forward_s": plain_s, "segment_sum_launches": launches,
           "logits_rel_err": rel,
           "logits_max_abs_err": _max_err(torch, logits, want),
           "argmax_agreement": float((logits.argmax(1) == want.argmax(1))
                                     .float().mean()),
           "peak_mem_gib": peak}
    emit(out)
    if launches != cfg.n_layers * GIN_FORWARDS:
        fail(f"GIN launched segment_sum {launches} times in "
             f"{GIN_FORWARDS} forwards of {cfg.n_layers} layers")
    if rel > 1e-2:
        fail(f"GIN logits differ from the plain forward (rel err {rel})")
    return out, launches


_COMPARE_CHILD = """
import argparse, json, os, sys
import numpy as np
import torch
tree, cache, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path[:0] = [tree, os.path.join(tree, "src")]
import chip_smoke as cs
cs.fail = lambda msg: print(json.dumps({"phase": "check_failed", "msg": msg}),
                            flush=True)
cs.phase_device(torch)
cs.phase_build()
args = argparse.Namespace(ticks=64, parity_ticks=16)
cs.phase_serve(torch, args, cs.make_stream(seed, args.ticks * cs.BATCH))
cs.phase_kernels(torch, seed)
cs.phase_masks(torch, seed)
cs.phase_embedding_bag(torch, seed)
g = {k: torch.as_tensor(np.load(os.path.join(cache, k + ".npy")),
                        device="cuda") for k in ("x", "edge_src", "edge_dst")}
deg = torch.bincount(g["edge_dst"].long(), minlength=g["x"].shape[0])
cs.phase_segment_sum(torch, seed, g, int(deg.max()))
"""


def compare(parent: str, seed: int) -> int:
    """This tree's serving path, its compat-join pair and mask cases and
    its embedding_bag and segment_sum cases against ``parent``'s, on one
    card: parent, change, change, parent, each in a fresh process
    running its own tree's phases (and kernels) on the same stream and
    products graph.  A failed check is recorded with its run and
    the run goes on (the parent's times stay a yardstick); one in this
    tree's runs fails the comparison."""
    import numpy as np

    from repro_torch.data.graphs import synth_products_like

    parent = os.path.abspath(parent)
    if not os.path.exists(os.path.join(parent, "chip_smoke.py")):
        fail(f"--compare: no chip_smoke.py in {parent}")
    cache = os.path.join(HERE, "build", "compare_graph")
    os.makedirs(cache, exist_ok=True)
    g = synth_products_like(n_nodes=GIN_NODES, avg_degree=GIN_DEGREE,
                            d_feat=GIN_FEAT, n_classes=GIN_CLASSES, seed=seed)
    for k in ("x", "edge_src", "edge_dst"):
        np.save(os.path.join(cache, k + ".npy"), g[k])
    del g
    runs = []
    for side, tree in (("parent", parent), ("change", HERE),
                       ("change", HERE), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", _COMPARE_CHILD, tree, cache, str(seed)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"--compare: the {side} run failed:\n{proc.stderr[-4000:]}")
        run = {"side": side, "tree": tree}
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            ph = json.loads(line)
            if ph.get("phase") == "device":
                run["device"] = ph["nvidia_smi"]
            elif ph.get("phase") == "check_failed":
                run.setdefault("check_failed", []).append(ph["msg"])
            elif ph.get("phase") == "serve":
                run["serve"] = {k: ph[k] for k in (
                    "edges_per_s", "tick_ms_p50", "tick_ms_p99_after_first")}
            elif "cases" in ph:
                run[ph["kernel"]] = {c["case"]: {
                    k: c.get(k) for k in ("ms", "library_ms", "device_ms")}
                    for c in ph["cases"]}
        emit({"phase": "compare_run", **run})
        if side == "change" and "check_failed" in run:
            fail(f"--compare: this tree failed a check: {run['check_failed']}")
        runs.append(run)
    kernels = ("compat_join_pairs", "compat_mask", "embedding_bag",
               "segment_sum")
    ms = {k: {c: [r[k].get(c, {}).get("ms") for r in runs]
              for c in runs[1][k]} for k in kernels}
    faster = {k: {c: None not in t and max(t[1:3]) < min(t[0], t[3])
                  for c, t in ms[k].items()}
              for k in ("compat_join_pairs", "compat_mask")}
    emit({"phase": "compare", "order": [r["side"] for r in runs],
          "serve": [r.get("serve") for r in runs], "ms": ms,
          "device_ms": {k: {c: [r[k].get(c, {}).get("device_ms")
                                for r in runs] for c in runs[1][k]}
                        for k in kernels},
          "library_ms": {k: {c: [r[k].get(c, {}).get("library_ms")
                                 for r in runs] for c in runs[1][k]}
                         for k in ("embedding_bag", "segment_sum")},
          "change_faster_in_both_runs": faster})
    return 0


# --------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=64,
                    help="ticks of 4096 edges in the serve phase")
    ap.add_argument("--parity-ticks", type=int, default=16,
                    help="ticks served again on the REF backend")
    ap.add_argument("--compare", metavar="PARENT_TREE",
                    help="hold the kernel cases against another checkout's "
                         "instead of the smoke run")
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
    if args.compare:
        return compare(args.compare, args.seed)

    dev = phase_device(torch)
    phase_build()
    cases, worst = phase_kernels(torch, args.seed)
    masks, mask_launches = phase_masks(torch, args.seed)
    stream = make_stream(args.seed, args.ticks * BATCH)
    serve, qids, matches, snap, launches = phase_serve(torch, args, stream)
    phase_parity(torch, args, stream, qids, matches, snap)
    phase_profile(torch, args, stream)
    del qids, matches, snap
    _free(torch)
    _, session_launches, session_by_slots = phase_session(torch, args,
                                                          stream)
    _free(torch)
    _, frontier_launches, frontier_by_slots = phase_frontier(torch, args,
                                                             stream)
    del stream
    _free(torch)
    bags = phase_embedding_bag(torch, args.seed)
    _, bag_launches = phase_recsys_serve(torch, args.seed)
    graph, graph_info = make_products_graph(torch, args.seed)
    sums = phase_segment_sum(torch, args.seed, graph,
                             graph_info["max_in_degree"])
    _, sum_launches = phase_gin_infer(torch, args.seed, graph, graph_info)

    def entry(name, source, replaces, launches, rows, timed, **extra):
        row = next(r for r in rows if r["case"] == timed)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: row.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
                "timed_case": timed, **extra,
                "cases": {r["case"]: {k: r.get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")} for r in rows}}

    cj = "src/repro/kernels/compat_join/kernel.py"
    emit({"kernels": [
        entry("compat_join_pairs", KERNEL_SOURCES["compat_join"], f"{cj}:454",
              launches, cases, "level_window", also_replaces=f"{cj}:405",
              launches_path="serve", launches_session=session_launches,
              launches_session_by_slots={
                  str(k): v for k, v in sorted(session_by_slots.items())},
              launches_frontier=frontier_launches,
              launches_frontier_by_slots={
                  str(k): v for k, v in sorted(frontier_by_slots.items())},
              tolerance="equal"),
        entry("compat_mask", KERNEL_SOURCES["compat_join"], f"{cj}:279",
              mask_launches, masks, "l0_j1_window", also_replaces=f"{cj}:210",
              launches_path="core.join.compat_mask over the mask cases",
              tolerance="equal"),
        entry("embedding_bag", KERNEL_SOURCES["embedding_bag"],
              "src/repro/kernels/embedding_bag/kernel.py:59", bag_launches,
              bags, "wide_serve_bulk", launches_path="recsys_serve",
              tolerance="rtol 1e-5, atol 1e-6; N(0,1) D = 32: rtol 1e-5 "
                        "+ 2 n 2^-24 sum|row| per element; integer D = 32: "
                        "equal"),
        entry("segment_sum", KERNEL_SOURCES["segment_reduce"],
              "src/repro/kernels/segment_reduce/kernel.py:59", sum_launches,
              sums, "gin_l1_bf16", launches_path="gin_infer",
              tolerance="bf16: rtol 1e-2 + 2 deg 2^-24 sum|msg| per element; "
                        "float32 integer messages: equal"),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
