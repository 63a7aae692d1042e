#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--ticks N] [--parity-ticks N]
    python3 chip_smoke.py --compare PARENT_TREE [--seed N]

Phases (one JSON line each; any failure ends the run with a non-zero
exit, nothing is caught and skipped):

  device        the card's name and power limit (nvidia-smi) and torch's;
  build         nvcc builds every kernel library from its csrc/ source,
                one nvcc per source, all at once (ptxas -v lines);
  analysis      the static-analysis gate (repro_torch.analysis) on the
                card: the tick-scope lint, the Hopper kernel contracts
                over the full lattice and the plan invariants over
                src/repro_torch, the baseline applied; the limits the
                proofs assume read from the card (the shared memory a
                block may opt into, the SM count) against the kernels'
                constants; KC105's card half (each of the four launch
                wrappers against its plain version, one real call at the
                lattice's small points); any error, any warning the
                baseline does not cover or any limit mismatch fails;
  kernel_cases  the compat-join pair kernel against its plain version at
                the serving path's join shapes, over a slot group of 8,
                at S = 1 and at S = 4 (a mesh replica block), and the
                capacity phase's L0 joins at 4 shards (a gathered delta
                of 32,768 rows shared by the shards against [4, 65,536];
                2^31 pairs a slot): outputs equal element for element;
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
  mesh          replica-sharded serving (``ShardedSearchService``) with R
                logical replicas on the card: the serve phase's tenants,
                capacities, batches and ticks at (n_replicas,
                slots_per_replica) in (1, 8), (2, 4) and (8, 1), so a
                group is 8 slots high; checks: overflow 0, per-tenant
                matches equal to the single-device service's, the summed
                ``MeshTickStats.n_matches`` equal to the reports, the
                clock equal to the engines' largest, at R = 1 every table
                leaf equal to the single-device service's, the pair
                kernel launched at S = slots_per_replica only; a REF
                sharded service at (2, 4) over the parity ticks with
                identical tables; a mesh ``StreamSession`` (2 x 4, prefix
                sharing) checkpointed every 16 ticks into per-replica
                shard files, crashed after tick 40, restored onto 2
                replicas with zero warm builds and onto 8 (the reshard
                path), replaying exactly once each time, the
                ``replica_refcounts`` partition checked; prints edges/s
                and tick p50/p99 for each R and the session;
  capacity      capacity sharding (``build_sharded_tick``) with n logical
                shards on the card: the serve phase's chain and a
                two-chain tenant, each one engine of 262,144 rows a table
                (65,536 a shard at n = 4), ``max_new`` 8,192, the serve
                phase's stream and 64 ticks, at n in 1, 2, 4; checks:
                each tick's match count and rows equal to the unsharded
                CUDA ``build_tick`` at the same capacity, overflow 0, 6
                pair launches a tick at S = n, the shard-aware fold of
                the final state equal to the unsharded current matches,
                every leaf at n = 1 equal to the unsharded state; a REF
                sharded run at n = 4 over the first 16 ticks identical
                leaf for leaf; the chain over a shared prefix view at
                depths 1 and 2 (n = 4, 16 ticks) equal to the unsharded
                prefix tick; ``scale_to_mesh`` 4 -> 2 after tick 32, on to
                tick 64, equal to the unsharded run; a
                ``FaultTolerantLoop(mesh=, specs=)`` at n = 4 with
                checkpoints every 16 ticks and a crash after tick 40
                ending identical to the uninterrupted run; prints edges/s
                and tick p50/p99 for each n and the unsharded engines,
                and a tick's device ms with the pair kernel's by step;
  ranks         both meshes over ``torch.distributed``, one process a
                rank (``torch.multiprocessing``, "spawn"; a FileStore
                rendezvous; the ranks load the libraries the build phase
                made): the capacity phase's two engines, C/n rows a
                rank, over NCCL at world size 1 and over gloo at 2 and 4
                ranks sharing the card (gloo stages CUDA tensors through
                the host); checks: each rank's final state block k of
                the one-process mesh's at the same n, the union of the
                ranks' matches the unsharded engines' tick by tick,
                overflow 0, 6 pair launches a tick at S = 1 on every
                rank; a crash on every one of 4 ranks restored through
                ``FaultTolerantLoop`` identical to the uninterrupted run;
                the 4 ranks' checkpoint (one file a rank) restored on 2
                ranks after tick 32 equal to the unsharded run; the
                replica service at R = 8 on 2 ranks equal to the serve
                phase's matches over its first 16 ticks; prints edges/s
                and p50/p99 per world size beside the one-process mesh's,
                the backend, and the collectives' host and device ms a
                tick;
  sharded_cells the model cells over a mesh of ranks
                (``launch.cells.cell_for(..., mesh=)`` on a process-group
                ``("data", "model")`` mesh; NCCL at world 1 on (1, 1),
                gloo at 4 on (2, 2) sharing the card): Wide&Deep at its
                published width (train 65,536 x 3 steps, serve 512), GIN
                and GAT at Cora, NequIP at molecule, qwen3-14b at full
                width and 2 layers in float32 (a FSDP x TP step on 2 x
                64 tokens, a decode step); each against the one-process
                cell from the same seed (loss, grad_norm, sampled
                parameters within lr sum |dstep| + 16 ulps a step,
                logits); every rank launches the embedding_bag and
                segment_sum kernels where the one-process cell does, the
                same count; per rank: throughput, step s, peak, the
                collectives' calls and host / device ms a step;
  sjtree        the paper's baseline comparison (Figures 14-17): the
                SJ-tree (``core.sjtree``: every edge its own leaf, the
                timing order checked by a host post-filter) against the
                timing-aware engine, both through ``build_tick`` on the
                CUDA backend, for the serve phase's chain and two-chain
                at its capacities on its stream, at three windows each:
                the largest at which every table of both engines stays
                within the capacities by a host reckoning of the stream
                (``sjtree_window``), its half and its quarter; checks:
                overflow 0, each tick's post-filtered matches equal to
                the engine's, the final current matches, the CUDA
                SJ-tree's tables equal to a REF run's over 16 ticks,
                every SJ-tree pair launch at S = 1; prints edges/s and
                the average live bytes a tick (MS-tree and independent
                storage) of both;
  embedding_bag_cases  the embedding_bag kernel against its plain
                version (Wide&Deep's wide side at serve_p99/serve_bulk,
                one general case), with F.embedding_bag's time beside it,
                and both calls' device-only time per call
                (torch.profiler) and the kernel's device operations per
                call (its CUDA graph: one eb_bag_sum kernel);
  recsys_serve  Wide&Deep at its published config serving 20 batches
                each of serve_p99 and serve_bulk; logits held against
                the plain version; one top-100 retrieval of 1M;
  recsys_train  Wide&Deep training at the published config: the wide
                gradient of ``bce_loss`` on the card (the embedding_bag
                kernel's autograd Function, its backward the segment_sum
                kernel) against the plain version's, then
                ``make_recsys_train_step`` (AdamW factored) on batches of
                65,536: one step held to the plain version's step (every
                leaf but the 5 GB tables whole, and of the tables the
                rows the batch reads and some it does not, in three
                fields), timed steps, step time, examples/s and peak
                memory;
  segment_sum_cases  the segment_sum kernel against its plain version at
                the GNN paths' shapes on an ogbn-products-shaped graph
                (GIN's layers, GAT's two layers, PNA's 75 columns, and
                NequIP's l = 0/1/2 sums over the molecule batch), the
                same later-layer messages with uniform dst (no hubs) and
                segment_mean's D = 1 count column, with index_add_'s
                time beside it and each case's device time by kernel;
                each case's bits equal to ``ref.segment_sum_ordered``
                (the kernel's order in plain torch), to a second call
                and to a call on an order-keeping permutation;
  gin_infer     GIN (gin-tu, bf16) inference on that graph; logits held
                against the plain-version forward;
  gat_infer     GAT (gat-cora) at the published Cora shape in float32,
                held per element to the plain forward within the
                summation bound, and on the products graph at the
                reference cell's rule (100 features, 47 classes, bf16):
                forward times, peak memory, logits against the plain
                forward (both in deterministic mode: the bf16 softmax's
                atomics alone move the logits run to run, by an amount
                recorded beside) and the bf16 softmax's weight sums at
                the hubs;
  pna_infer     PNA (pna config, bf16) on the products graph: forward
                times, peak memory, logits against the plain forward,
                one forward's device time by aten op (scatter_reduce_);
  nequip_infer  NequIP (nequip config, float32) energy and forces on the
                molecule shape (128 molecules of 30 atoms and 64 edges,
                made from --seed): the forces' gradient flows back
                through the kernel's autograd.Function; energies and
                forces against the plain version, rotation and
                translation;
  minibatch_infer  the ported neighbour sampler on the products graph
                (1,024 seeds, fanout 15-10: minibatch_lg's sampling; the
                cut is printed), host CSR and sampling times, GAT and PNA
                over the subgraph against the plain forward;
  gnn_train     the GNN zoo's train steps (``make_gnn_train_step``, AdamW
                fp32): GIN at the products shape (bf16, remat), GAT at
                Cora (float32), GAT and PNA on the sampler's subgraph
                (bf16, remat; PNA in float32 too), NequIP ``mse_loss``
                on the molecules; one step of each held to the plain
                version's (loss, grad_norm, gradients, parameters), step
                time, nodes/s (atoms/s), peak memory, segment_sum
                launches a step; the bf16 PNA kernel step repeated 15
                times from its seed, bit for bit;
  examples      examples/torch_{gnn_node_classification,quickstart,
                multi_query_service,cybersec_c2_detection,serve_recsys}.py
                through their ``main`` on the card, their own assertions
                included; the GNN example twice, the same loss bits at
                every printed step;
  lm_serve      qwen3-14b at its full width and depth (40 layers), bf16,
                seeded weights, through ``prefill`` and greedy
                ``serve_step``s (after the GNN tensors are released and
                under 1 GiB is left allocated): the card against the CPU
                in float32 at 2 of the 40 layers (forward over 64 tokens,
                prefill of 56 and 8 steps, within 1e-4 relative); one
                32,768-token prefill (prefill_32k, batch cut to 1):
                seconds, tokens/s, peak, model FLOP/s against the dense
                bf16 peak; decode at a 32,768 cache
                (decode_32k, batch cut to 4; 4 prompts of 2,048 tokens,
                32 steps): ms a step beside its byte bound, tokens/s,
                peak, one more step's device time by op; each step's logits
                against forward's teacher-forced logits (relative
                Frobenius at most 5e-2, the greedy token equal where the
                top-2 margin exceeds twice the difference); every logit
                finite, the cache written in place, ``length`` advancing
                by one a step;
  moe_serve     arctic-480b's layers at full width (128 experts top-2 and
                the dense residual FFN), 2 of its 35 layers, bf16: one
                8,192-token prefill (seconds, tokens/s, each layer's
                dropped share at capacity factor 1.25, lb, z); decode at
                batch 4 for 16 steps (ms a step beside its byte bound),
                each step's layer-0 ``moe_ffn`` output against a per-token
                loop on the card (relative Frobenius at most 1e-2);
  lm_train      qwen3-14b trained at its full width, 2 of its 40 layers,
                bf16 compute on float32 masters, AdamW fp32, remat
                (``make_lm_train_step``, ``train_lm``): (a) one float32
                step on the card against the CPU from the same parameters
                (loss, grad_norm, gradients, every parameter; 1 layer:
                the CPU side's minutes, cut for the script's time); (b) 4
                microbatches
                against 1 over 8 x 512 tokens within 1e-2; (c) a warm-up
                and 5 timed steps of 8 x 4,096 tokens in 4 microbatches
                (train_4k's sequence and microbatches, batch 256 cut):
                seconds, tokens/s, peak, model FLOP/s against the dense
                bf16 peak, one step's device time by op, every loss
                finite; (d) ``train_lm`` at examples/torch_train_lm.py's
                small profile, 300 steps, checkpoints every 100, resumed
                at 200: the loss learnt and the resumed losses equal;
  dryrun        ``launch.dryrun.run_cell`` on the meta device for the
                lm_train step, lm_serve's 32,768-token prefill and one
                lm_serve decode step, each cut as its phase ran it: the
                reckoned peak within 15% of the peak measured around that
                same call alone (the counter reset just before it), the
                reckoned FLOPs beside the model FLOPs, the roofline's
                dominant term and bound; and qwen3-14b's decode_32k
                and train_4k as rank 0 of pod16x16 under the "fake"
                process-group backend (traced in a process of its own
                beside the LM phases), each rank's reckoned peak beside
                the one card's (decode_32k), with its collectives.

Each path's kernel launch counter is zeroed just before the path is
driven and read just after (serve, session, frontier, each mesh run,
each capacity run, each rank of the ranks phase, each case of each
rank (and of the one-process cell) of sharded_cells, each SJ-tree run,
each mask case's entry-point call,
recsys_serve, the wide-gradient check and the steps of recsys_train,
gin_infer, gat_infer at Cora and at products, pna_infer, nequip_infer,
each model of minibatch_infer, each case's timed steps of gnn_train,
each example's run);
lm_serve, moe_serve and lm_train zero all four counters and require 0
launches (the reference's LM path calls no Pallas kernel).  Then a
{"kernels": [...]} line, and the last line is {"ok": true, "device": {...}}.  Without a
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
import contextlib
import json
import math
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
PLAIN_REPS = 5           # timed runs of a compat or segment_sum plain
                         # version (median): 20 took ~70 s of the script
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
GNN_FORWARDS = 3         # timed forwards of each GNN inference phase
NEQUIP_CALLS = 5
MINIBATCH_SEEDS, MINIBATCH_FANOUTS = 1024, (15, 10)   # minibatch_lg
# A segment_sum case over 4,000,000 nodes (the sort's keys past 2^21).
SEG_WIDE_NODES = 4_000_000
# NequIP's molecule shape (gnn_shapes "molecule": 128 molecules of 30
# atoms and 64 directed edges)
MOL_BATCH, MOL_ATOMS, MOL_EDGES = 128, 30, 64
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


_T0 = time.perf_counter()
_PHASE_END = {}     # phase -> seconds since the script started, at its line


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        _PHASE_END[obj["phase"]] = time.perf_counter() - _T0
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------- #
# device / build
# --------------------------------------------------------------------- #
def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch):
    line = _card_line()
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


def phase_analysis():
    """``repro_torch.analysis`` over the port's tree (full lattice, the
    plan pass included), the card's limits and KC105 on the card."""
    from repro_torch.analysis import kernel_check as KC
    from repro_torch.analysis.cli import run_passes
    from repro_torch.analysis.findings import ERROR, WARNING, load_baseline

    t0 = time.perf_counter()
    limits = KC.device_limits(0)
    report = run_passes(os.path.join(HERE, "src", "repro_torch"))
    report = report.split_by_baseline(load_baseline(
        os.path.join(HERE, "analysis_baseline_torch.json")))
    t1 = time.perf_counter()
    on_card = KC.check_kernel_ref_agreement(fast=False, device="cuda")
    mismatched = KC.check_device_limits(limits)
    t2 = time.perf_counter()
    by_sev = report.by_severity()
    emit({"phase": "analysis", "seconds": t2 - t0,
          "passes_seconds": t1 - t0, "card_checks_seconds": t2 - t1,
          "stats": report.stats, "findings_by_severity": by_sev,
          "baselined": [f"{f.rule} {f.symbol}" for f in report.suppressed],
          "device_limits": limits,
          "kc105_on_card": [f.format() for f in on_card],
          "limit_mismatches": [f.format() for f in mismatched]})
    bad = [f for f in report.findings if f.severity in (ERROR, WARNING)]
    for f in bad + on_card + mismatched:
        print(f.format(), file=sys.stderr, flush=True)
    if bad or on_card or mismatched:
        fail(f"analysis: {by_sev[ERROR]} error(s), {by_sev[WARNING]} "
             f"warning(s) outside the baseline, {len(on_card)} KC105 "
             f"finding(s) on the card, {len(mismatched)} limit "
             f"mismatch(es)")


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


def _gathered_cases(rng):
    """The capacity phase's L0 joins at n = 4 shards of 65,536 rows: the
    gathered delta (4 x 8,192 rows, one table shared by the shards, slot
    stride 0) against every shard's table, as A in J1 and as B in J2;
    with the window.  Each slot's A x B is 2^31 pairs."""
    import numpy as np

    s, cap, d = 4, LEVEL_CAP, 4 * MAX_NEW
    windows = rng.integers(3000, 9000, s, dtype=np.int32)
    two_rel = np.zeros((3, 3), bool)
    two_rel[0, 0] = True                                        # shared v0
    two_trel = np.zeros((2, 2), np.int8)

    def shared(rows):
        return tuple(x[0] for x in _table(rng, 1, rows, 3, 2, 0.5, 3000,
                                          30000))

    j1 = (shared(d), _table(rng, s, cap, 3, 2, 0.2, 3000, 30000), two_rel,
          two_trel)
    j2 = (_table(rng, s, cap, 3, 2, 0.2, 3000, 30000), shared(d), two_rel,
          two_trel)
    return [("gathered_l0_j1_window", j1, windows, MAX_NEW),
            ("gathered_l0_j2_window", j2, windows, MAX_NEW)]


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
    join shapes: over a slot group of 8 (row 2 of the kernel table), at
    S = 1 (row 1, a single query's tick) and at S = 4 (a replica block
    of the mesh phase's 2 x 4 layout)."""
    import numpy as np

    from repro_torch.kernels.compat_join import kernel, ops, ref

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    results = []
    worst = 0
    cases = [(SLOTS, "", c) for c in _join_cases(rng, SLOTS)]
    cases += [(1, "s1_", c) for c in _join_cases(rng, 1)]
    # the mesh phase's other width (2 replicas of 4 slots)
    cases += [(4, "s4_", c) for c in _join_cases(rng, 4)]
    # the capacity phase's L0 joins at 4 shards: a gathered delta shared
    cases += [(4, "s4_", c) for c in _gathered_cases(rng)]
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
                            PLAIN_REPS)
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
    for prefix in ("", "s1_", "s4_"):
        if not any(r["n_dropped"] for r in results
                   if r["case"] == prefix + "level_overflow"):
            fail(f"the {prefix}level_overflow case dropped no pairs")
    emit({"phase": "kernel_cases", "kernel": "compat_join_pairs",
          "reps": REPS, "plain_reps": PLAIN_REPS,
          "cases": results})
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
        plain_ms = _time_ms(torch, lambda: ref.compat_mask(*args),
                            PLAIN_REPS)
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
          "plain_reps": PLAIN_REPS, "path_launches": launches,
          "cases": results})
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
# mesh: replica-sharded serving (logical replicas on the one card)
# --------------------------------------------------------------------- #
MESH_SHAPES = ((1, 8), (2, 4), (8, 1))     # (n_replicas, slots_per_replica)
MESH_SESSION = {"n_replicas": 2, "slots_per_replica": 4}
MESH_RESHARD = 8                            # replicas of the reshard restore


def run_mesh(backend, stream, n_replicas, spr, snapshot_tick=None,
             n_ticks=None):
    """Serve ``stream`` (its first ``n_ticks`` batches, if given) through
    a fresh ``ShardedSearchService`` of ``n_replicas`` logical replicas
    on the card, with the serve phase's tenants and capacities; returns
    the service, qids, ServeInfos, per-qid match multisets, the per-tick
    sums of ``MeshTickStats.n_matches``, the per-tenant state snapshot at
    ``snapshot_tick`` and the wall seconds.  Match rows are kept as
    arrays in the loop and counted after it."""
    import torch

    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.state import state_to_numpy
    from repro_torch.runtime.mesh import ShardedSearchService

    svc = ShardedSearchService(
        n_replicas, spr, devices=(DEVICE,) * n_replicas,
        level_capacity=LEVEL_CAP, l0_capacity=LEVEL_CAP, max_new=MAX_NEW,
        backend=backend, tick_cache=SlotTickCache())
    qids = [svc.register(q, w) for _, q, w in tenants(stream)]
    infos, rows, stat_matches, snap = [], [], [], {}

    def on_match(qid, bind, ets):
        rows.append((len(infos), qid, bind.copy(), ets.copy()))

    def on_tick(info):
        infos.append(info)
        stat_matches.append(sum(v["n_matches"] for v in
                                svc.last_mesh_stats().values()))
        if len(infos) == snapshot_tick:
            for q in qids:
                snap[q] = state_to_numpy(svc.state(q))

    _sync(torch)
    t0 = time.perf_counter()
    served = stream if n_ticks is None else stream[:n_ticks * BATCH]
    svc.serve_stream(served, on_match=on_match, on_tick=on_tick,
                     batch_size=BATCH, min_batch=BATCH, max_batch=BATCH)
    _sync(torch)
    wall = time.perf_counter() - t0
    matches = {q: Counter() for q in qids}
    upto = {q: Counter() for q in qids}
    for tick, q, bind, ets in rows:
        got = [tuple(map(int, b)) + tuple(map(int, e))
               for b, e in zip(bind, ets)]
        matches[q].update(got)
        if snapshot_tick is not None and tick < snapshot_tick:
            upto[q].update(got)
    return svc, qids, infos, matches, upto, stat_matches, snap, wall


def _mesh_tables_equal(torch, single, mesh) -> int:
    """R = 1: every group table of the mesh service equals the
    single-device service's, leaf for leaf; returns the leaves
    compared."""
    ga, gb = single._iter_groups(), mesh._iter_groups()
    if [g.qids for g in ga] != [g.qids for g in gb]:
        fail("mesh: the R = 1 slot layout differs from the single-device "
             "service's")
    n = 0
    for a, b in zip(ga, gb):
        for x, y in zip(_flat(a.sstate), _flat(b.sstate[0])):
            if x.shape != y.shape or not torch.equal(x, y):
                fail(f"mesh: R = 1 group {a.gid}: a table leaf differs from "
                     "the single-device service's")
            n += 1
    return n


def phase_mesh(torch, args, stream):
    """Replica-sharded serving on the card: ``ShardedSearchService`` at
    (n_replicas, slots_per_replica) in (1, 8), (2, 4), (8, 1) — R
    logical replicas on ``cuda:0``, a group 8 slots high as in the serve
    phase — against the single-device service; a REF sharded service at
    (2, 4) over the parity ticks; and a mesh ``StreamSession`` with
    prefix sharing through a crash, a same-size restore and an 8-replica
    reshard."""
    import tempfile

    import numpy as np

    from repro_torch.api import StreamSession
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.kernels.compat_join import ops
    from repro_torch.runtime.mesh import ShardedSearchService

    # the single-device service's answer (untimed; the serve phase's path)
    single, sq, _, want, _, _, _ = run_service(None, stream)
    total = sum(sum(c.values()) for c in want.values())
    if total <= 0:
        fail("mesh: the single-device service found no matches")
    runs, by_replicas, by_slots_all = [], {}, Counter()
    cuda24 = None
    for n_rep, spr in MESH_SHAPES:
        _free(torch)
        ops.compat_join_pairs.launches = 0       # counts of this mesh path
        ops.compat_join_pairs.launches_by_slots.clear()
        svc, qids, infos, got, upto, stat_m, snap, wall = run_mesh(
            None, stream, n_rep, spr,
            snapshot_tick=args.parity_ticks if (n_rep, spr) == (2, 4)
            else None)
        launches = ops.compat_join_pairs.launches
        by_slots = dict(ops.compat_join_pairs.launches_by_slots)
        what = f"mesh R = {n_rep} x {spr}"
        if svc.backend != "cuda" and DEVICE == "cuda":
            fail(f"{what}: backend {svc.backend}, not cuda")
        if qids != list(sq):
            fail(f"{what}: other qids than the single-device service")
        overflow = svc.overflow_pressure()
        if overflow or any(i.n_overflow for i in infos):
            fail(f"{what}: overflow {overflow}")
        for q in qids:
            if got[q] != want[q]:
                fail(f"{what}: qid {q}: match multisets differ from the "
                     f"single-device service's ({sum(got[q].values())} vs "
                     f"{sum(want[q].values())})")
        n_got = sum(sum(c.values()) for c in got.values())
        if sum(stat_m) != n_got:
            fail(f"{what}: summed MeshTickStats.n_matches {sum(stat_m)} != "
                 f"{n_got} reported")
        clock = max(int(b.engines.t_now.max()) for g in svc._iter_groups()
                    for b in g.blocks())
        stats = svc.last_mesh_stats()
        if max(s["t_clock"] for s in stats.values()) != clock:
            fail(f"{what}: t_clock {stats} != the engines' largest t_now "
                 f"{clock}")
        if not launches or set(by_slots) != {spr}:
            fail(f"{what}: pair launches {launches} by slot count "
                 f"{by_slots}: need S = {spr} only")
        n_leaves = _mesh_tables_equal(torch, single, svc) if n_rep == 1 \
            else None
        lat = [i.latency_ms for i in infos]
        runs.append({
            "n_replicas": n_rep, "slots_per_replica": spr,
            "edges_per_s": len(stream) / wall, "wall_s": wall,
            "ticks": len(infos), "tick_ms_p50": _pctl(lat, 0.5),
            "tick_ms_p99": _pctl(lat, 0.99), "tick_ms_first": lat[0],
            "tick_ms_p99_after_first": _pctl(lat[1:], 0.99),
            "matches_total": n_got, "n_overflow": overflow,
            "stats_n_matches": sum(stat_m), "t_clock": clock,
            "groups": len(svc._iter_groups()), "n_compiles": svc.n_compiles,
            "compat_join_launches": launches,
            "compat_join_launches_by_slots": {
                str(k): v for k, v in sorted(by_slots.items())},
            "r1_table_leaves_equal": n_leaves})
        by_replicas[str(n_rep)] = launches
        by_slots_all.update(by_slots)
        if (n_rep, spr) == (2, 4):
            cuda24 = (qids, upto, snap)
        del svc, got
    del single
    _free(torch)

    # -- REF parity at (2, 4) over the parity ticks, tables included ------
    qids, upto, snap = cuda24
    ref, rq, rinfos, rgot, _, _, rsnap, rwall = run_mesh(
        "ref", stream, 2, 4, snapshot_tick=args.parity_ticks,
        n_ticks=args.parity_ticks)
    if rq != qids:
        fail("mesh REF: other qids")
    n_ref_leaves = 0
    for q in qids:
        if rgot[q] != upto[q]:
            fail(f"mesh REF: qid {q}: match multisets differ from CUDA's "
                 "over the parity ticks")
        for x, y in zip(_flat(rsnap[q]), _flat(snap[q])):
            if x.shape != y.shape or not np.array_equal(x, y):
                fail(f"mesh REF: qid {q}: a table leaf differs from CUDA's")
            n_ref_leaves += 1
    del ref, snap, rsnap
    _free(torch)

    # -- a mesh session with sharing: crash, restore, reshard --------------
    patterns = session_patterns(stream)
    n_ticks = len(stream) // BATCH
    crash = min(SESSION_CRASH_TICK, n_ticks - 1)
    devices = (DEVICE,) * MESH_SESSION["n_replicas"]
    tc = SlotTickCache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")

    def mesh_session(ckpt_dir=None, cache=tc):
        return StreamSession(
            mesh=MESH_SESSION, level_capacity=LEVEL_CAP,
            l0_capacity=LEVEL_CAP, max_new=MAX_NEW, ckpt_dir=ckpt_dir,
            tick_cache=cache, share_prefixes=True, devices=devices)

    sess_a = mesh_session()
    rep_a = _Reports(sess_a)
    ops.compat_join_pairs.launches = 0           # counts of the session path
    ops.compat_join_pairs.launches_by_slots.clear()
    wall_a = _serve_session(sess_a, patterns, stream, rep_a)
    sess_launches = ops.compat_join_pairs.launches
    sess_by_slots = dict(ops.compat_join_pairs.launches_by_slots)
    svc_a = sess_a.service
    if not isinstance(svc_a, ShardedSearchService):
        fail("mesh session: StreamSession(mesh=) is not a sharded service")
    reports_a = rep_a.multiset()
    if svc_a.overflow_pressure() or not reports_a:
        fail(f"mesh session: overflow {svc_a.overflow_pressure()}, "
             f"{sum(reports_a.values())} matches")
    if not sess_by_slots.get(1) or not sess_by_slots.get(
            MESH_SESSION["slots_per_replica"]):
        fail(f"mesh session: pair launches by slot count {sess_by_slots}")
    fs = svc_a.forest_stats()
    del sess_a, svc_a
    _free(torch)

    dir_d = os.path.join(tmp, "d")
    sess_d = mesh_session(dir_d)
    rep_d = _Reports(sess_d)
    _serve_session(sess_d, patterns, stream[:crash * BATCH], rep_d,
                   ckpt_every=SESSION_CKPT_EVERY, final_checkpoint=False)
    sess_d.close()
    del sess_d                                   # the crash
    _free(torch)
    want_step = (crash // SESSION_CKPT_EVERY) * SESSION_CKPT_EVERY
    n_rep = MESH_SESSION["n_replicas"]
    files = sorted(f for f in os.listdir(dir_d)
                   if f.startswith(f"step_{want_step}."))
    if files != [f"step_{want_step}.json"] + [
            f"step_{want_step}.shard{r}of{n_rep}.npz" for r in range(n_rep)]:
        fail(f"mesh session: step {want_step} is {files}, not {n_rep} "
             "shard files and one manifest")
    restored = {}
    for name in ("same", "reshard"):
        builds = tc.n_builds
        _sync(torch)
        t0 = time.perf_counter()
        if name == "same":
            sess_r = StreamSession.restore(dir_d, tick_cache=tc,
                                           devices=devices)
        else:
            sess_r = StreamSession.adopt(ShardedSearchService.restore(
                dir_d, tick_cache=tc, extract_matches=True,
                n_replicas=MESH_RESHARD, devices=(DEVICE,) * MESH_RESHARD))
        _sync(torch)
        secs = time.perf_counter() - t0
        svc_r = sess_r.service
        want_r = n_rep if name == "same" else MESH_RESHARD
        if svc_r.n_replicas != want_r or svc_r.n_ticks != want_step:
            fail(f"mesh session: {name} restore has {svc_r.n_replicas} "
                 f"replicas at tick {svc_r.n_ticks}")
        if name == "same" and tc.n_builds != builds:
            fail(f"mesh session: a same-size restore built "
                 f"{tc.n_builds - builds} ticks")
        parts = svc_r._manifest().get("replica_refcounts") or {}
        if {int(p): sum(c) for p, c in parts.items()} != \
                {n.pid: n.refcount for n in svc_r.forest.nodes()} or \
                any(len(c) != want_r for c in parts.values()):
            fail(f"mesh session: {name}: replica_refcounts {parts} do not "
                 "partition the forest's refcounts")
        rep_r = _Reports(sess_r)
        for sub in sess_r.subscriptions():
            sub.on_match = rep_r.on_match_for(sub.qid)
        _serve_session(sess_r, patterns, stream[sess_r.resume_offset:],
                       rep_r)
        once = rep_d.multiset(upto=want_step) + rep_r.multiset()
        if once != reports_a:
            fail(f"mesh session: {name} restore + replay is not exactly "
                 f"once ({sum(once.values())} vs "
                 f"{sum(reports_a.values())})")
        restored[name] = {"seconds": secs, "n_replicas": want_r,
                          "step": want_step,
                          "tick_builds": tc.n_builds - builds,
                          "replica_refcounts": parts,
                          "exactly_once": True}
        del sess_r, svc_r
        _free(torch)

    out = {
        "phase": "mesh", "tenants": len(sq), "edges": len(stream),
        "level_capacity": LEVEL_CAP, "max_new": MAX_NEW, "batch": BATCH,
        "device": DEVICE, "single_device_matches": total, "runs": runs,
        "compat_join_launches_by_replicas": by_replicas,
        "ref_parity": {"n_replicas": 2, "slots_per_replica": 4,
                       "ticks": len(rinfos), "state_leaves_equal":
                       n_ref_leaves, "ref_wall_s": rwall, "identical": True},
        "session": {
            "mesh": MESH_SESSION, "tenants": len(patterns),
            "timing": _timing(True, len(stream), wall_a, rep_a.infos),
            "matches_total": sum(reports_a.values()),
            "forest_stats": fs._asdict(),
            "compat_join_launches": sess_launches,
            "compat_join_launches_by_slots": {
                str(k): v for k, v in sorted(sess_by_slots.items())},
            "checkpoint_files": files, "crash_after_tick": crash,
            "restore": restored},
    }
    emit(out)
    by_slots_all.update(sess_by_slots)
    return out, sum(by_replicas.values()) + sess_launches, by_slots_all, \
        by_replicas


# --------------------------------------------------------------------- #
# capacity: capacity-sharded engines (build_sharded_tick) on the card
# --------------------------------------------------------------------- #
CAPACITY_TOTAL = 4 * LEVEL_CAP     # rows a table, over all shards: 262,144
CAPACITY_SHARDS = (1, 2, 4)
CAPACITY_TENANTS = (0, 8)          # tenants(): the 3-edge chain, a two-chain
CAPACITY_SUB_TICKS = 16            # the REF run and the prefix lift
CAPACITY_RESCALE = (4, 2, 32)      # scale_to_mesh 4 -> 2 after tick 32
CAPACITY_CKPT_EVERY = 16
CAPACITY_CRASH_TICK = 40
L0_DIMS = "Dims<3, 3, 2, 2,"       # the two-chain's L0 joins (J1 and J2)


def _cap_plans(stream):
    """The capacity phase's two tenants as plans at the total capacity."""
    from repro_torch.core.plan import compile_plan

    ts = tenants(stream)
    return [(ts[i][0], compile_plan(
        ts[i][1], ts[i][2], level_capacity=CAPACITY_TOTAL,
        l0_capacity=CAPACITY_TOTAL, max_new=MAX_NEW))
        for i in CAPACITY_TENANTS]


def _match_rows(res) -> Counter:
    """A host TickResult's extracted match rows as a multiset."""
    bind, ets, valid = (x.cpu().numpy() for x in (
        res.match_bindings, res.match_ets, res.match_valid))
    return Counter(tuple(map(int, b)) + tuple(map(int, e))
                   for b, e in zip(bind[valid], ets[valid]))


def _drive(torch, ticks, states, batches, views=None, snap_at=()):
    """Tick every engine over ``batches``, one synchronise a tick; returns
    the final states, the states after each tick in ``snap_at``, the
    per-tick results (kept on the card until the loop ends, then as
    (count, overflow, match multiset) per engine) and the per-tick wall
    ms.  ``views(t)`` gives the shared-prefix view of tick t."""
    snaps, results, lat = {}, [], []
    _sync(torch)
    for t, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = []
        for k, tick in enumerate(ticks):
            if views is None:
                states[k], res = tick(states[k], batch)
            else:
                states[k], res = tick(states[k], batch, views(t))
            out.append(res)
        _sync(torch)
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(out)
        if t + 1 in snap_at:
            snaps[t + 1] = list(states)
    host = [[(int(r.n_new_matches), int(r.n_overflow), _match_rows(r))
             for r in out] for out in results]
    return states, snaps, host, lat


def _tick_device_ms(torch, fn, reps: int = 3) -> dict:
    """Device ms of one call of ``fn`` (one tick of every engine) from
    ``torch.profiler``: all device operations, the pair kernels by step,
    and count + emit by join (the two-chain's L0 joins, ``L0_DIMS``, or
    the level joins); a window that catches no pair kernel is taken again
    (at most ``PROFILE_TRIES``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(torch)
    for tries in range(1, PROFILE_TRIES + 1):
        if tries > 1:
            time.sleep(0.1 * tries)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            _sync(torch)
        total, steps, joins, n_ops = 0.0, Counter(), Counter(), 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not _dev_us(e):
                continue
            ms = _dev_us(e) / 1e3 / reps
            total += ms
            n_ops += e.count
            name = _kernel_name(e.key)
            if name.startswith("cj_"):
                steps[name] += ms
                if name != "cj_scan":
                    joins["l0" if L0_DIMS in e.key else "level"] += ms
        if steps:
            break
    return {"device_ms": total, "device_ops": n_ops / reps,
            "pair_ms_by_step": dict(steps),
            "count_emit_ms_by_join": dict(joins), "profile_windows": tries}


def _same_states(torch, a, b, what: str) -> int:
    """Fails unless two lists of engine states are identical, leaf for
    leaf; returns the number of leaves compared."""
    n = 0
    for x, y in zip(_flat(tuple(a)), _flat(tuple(b))):
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            fail(f"capacity: {what}: a state leaf differs")
        n += 1
    return n


def _same_ticks(got, want, what: str, offset: int = 0) -> None:
    """Per tick and engine: the same match count and multiset, and no
    overflow on either side."""
    for t, (g, w) in enumerate(zip(got, want)):
        for k, ((gn, go, gm), (wn, wo, wm)) in enumerate(zip(g, w)):
            if go or wo:
                fail(f"capacity: {what}: tick {t + offset} engine {k} "
                     f"overflowed ({go} vs {wo})")
            if gn != wn or gm != wm:
                fail(f"capacity: {what}: tick {t + offset} engine {k}: "
                     f"{gn} matches ({sum(gm.values())} rows) vs the "
                     f"unsharded {wn} ({sum(wm.values())})")


def _lat_stats(n_edges, lat) -> dict:
    return {"edges_per_s": n_edges / (sum(lat) / 1e3),
            "wall_s": sum(lat) / 1e3, "tick_ms_p50": _pctl(lat, 0.5),
            "tick_ms_p99": _pctl(lat, 0.99), "tick_ms_first": lat[0],
            "tick_ms_p99_after_first": _pctl(lat[1:], 0.99)}


def phase_capacity(torch, args, stream):
    """Capacity sharding on the card: the chain and a two-chain of the
    serve phase, each one engine whose tables (262,144 rows each) are
    split over n shards — ``build_sharded_tick`` on a mesh of
    ``("cuda",) * n``, n logical shards on the one card — against the
    unsharded CUDA ``build_tick`` at the same total capacity; a REF
    sharded run, the prefix lift, a 4 -> 2 rescale and a crash restored
    through ``FaultTolerantLoop(mesh=, specs=)``."""
    import tempfile

    from repro_torch.core.distributed import (
        _sharded_current_matches,
        _state_specs,
        build_sharded_tick,
        make_mesh,
    )
    from repro_torch.core.engine import build_tick, current_matches
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.share import SharedPrefixForest
    from repro_torch.core.state import init_state, make_batch
    from repro_torch.kernels.compat_join import ops
    from repro_torch.runtime.elastic import scale_to_mesh
    from repro_torch.runtime.fault import FaultTolerantLoop, \
        SimulatedFailure
    from repro_torch.stream.generator import to_batches

    plans = _cap_plans(stream)
    batches = [make_batch(**b, device=DEVICE)
               for b in to_batches(stream, BATCH)]
    n_ticks, n_edges = len(batches), len(stream)
    sub = min(CAPACITY_SUB_TICKS, n_ticks)

    def mesh(n):
        return make_mesh((n,), ("data",), devices=(DEVICE,) * n)

    # -- the unsharded engines at the same total capacity -----------------
    _free(torch)
    ticks1 = [build_tick(p, extract_matches=True, device=DEVICE)
              for _, p in plans]
    s1, snaps1, want, lat1 = _drive(
        torch, ticks1, [init_state(p, device=DEVICE) for _, p in plans],
        batches)
    if not any(n for tick in want for n, _, _ in tick):
        fail("capacity: the unsharded engines found no matches")
    unsharded = {**_lat_stats(n_edges, lat1),
                 "matches_total": sum(n for tk in want for n, _, _ in tk),
                 "matches_by_tenant": [sum(tk[k][0] for tk in want)
                                       for k in range(len(plans))],
                 "pair_device": _tick_device_ms(
                     torch, lambda: [tk(s, batches[-1])
                                     for tk, s in zip(ticks1, s1)])}
    cur1 = [current_matches(p, s) for (_, p), s in zip(plans, s1)]

    # -- the sharded engines at n = 1, 2, 4: the main path ---------------
    runs, by_slots_all, launches_all, keep = [], Counter(), 0, {}
    finals = {}             # n -> host leaves of the final states (ranks)
    per_tick = 2 + 4        # chain: 2 level joins; two-chain: 2 + J1 + J2
    for n in CAPACITY_SHARDS:
        _free(torch)
        m = mesh(n)
        built = [build_sharded_tick(p, m, extract_matches=True)
                 for _, p in plans]
        ticks = [tk for tk, _ in built]
        ops.compat_join_pairs.launches = 0      # counts of this path
        ops.compat_join_pairs.launches_by_slots.clear()
        states, snaps, got, lat = _drive(
            torch, ticks, [s for _, s in built], batches,
            snap_at=(sub, CAPACITY_RESCALE[2]))
        launches = ops.compat_join_pairs.launches
        by_slots = dict(ops.compat_join_pairs.launches_by_slots)
        what = f"n = {n}"
        if by_slots != {n: per_tick * n_ticks}:
            fail(f"capacity: {what}: pair launches by slot count {by_slots},"
                 f" not {per_tick} a tick at S = {n}")
        _same_ticks(got, want, what)
        for (_, p), s, c in zip(plans, states, cur1):
            if int(s.stats.n_overflow):
                fail(f"capacity: {what}: overflow {int(s.stats.n_overflow)}")
            if _sharded_current_matches(p, s, n) != c:
                fail(f"capacity: {what}: the shard-aware fold of the final "
                     "state differs from the unsharded current matches")
        n_leaves = _same_states(torch, states, s1, "n = 1 vs unsharded") \
            if n == 1 else None
        runs.append({
            "n_shards": n, "rows_a_shard": CAPACITY_TOTAL // n,
            **_lat_stats(n_edges, lat),
            "matches_total": sum(n_ for tk in got for n_, _, _ in tk),
            "compat_join_launches": launches,
            "compat_join_launches_by_slots": {
                str(k): v for k, v in sorted(by_slots.items())},
            "n1_state_leaves_equal": n_leaves,
            "pair_device": _tick_device_ms(
                torch, lambda: [tk(s, batches[-1])
                                for tk, s in zip(ticks, states)])})
        by_slots_all.update(by_slots)
        launches_all += launches
        finals[n] = [x.cpu().numpy() for x in _flat(tuple(states))]
        if n == 4:
            keep = {"ticks": ticks, "final": states, "snaps": snaps,
                    "mesh": m}
        del built, states, snaps, got

    # -- REF against CUDA: the 4-shard run over the first ticks ------------
    _free(torch)
    m4 = keep["mesh"]
    built = [build_sharded_tick(p, m4, backend="ref", extract_matches=True)
             for _, p in plans]
    t0 = time.perf_counter()
    sref, _, _, _ = _drive(torch, [tk for tk, _ in built],
                           [s for _, s in built], batches[:sub])
    ref_wall = time.perf_counter() - t0
    n_ref_leaves = _same_states(torch, sref, keep["snaps"][sub],
                                "REF vs CUDA at n = 4")
    del built, sref
    _free(torch)

    # -- the prefix lift: the chain over a shared prefix view -------------
    _, chain = plans[0]
    prefix = {}
    for depth in (1, 2):
        forest = SharedPrefixForest(
            SlotTickCache(), "cuda" if DEVICE == "cuda" else "ref",
            device=DEVICE)
        node = forest.acquire(chain, epoch=0)
        while node.depth > depth:
            node = node.parent
        views = []

        def view(t, forest=forest, node=node, views=views):
            if len(views) <= t:          # one advance a tick, shared
                views.append(forest.advance(batches[t])[0][node.pid])
            return views[t]

        tick_u = build_tick(chain, extract_matches=True, prefix_depth=depth,
                            device=DEVICE)
        _, _, want_p, _ = _drive(
            torch, [tick_u], [init_state(chain, depth, device=DEVICE)],
            batches[:sub], views=view)
        tick_s, s0 = build_sharded_tick(chain, m4, extract_matches=True,
                                        prefix_depth=depth)
        _, _, got_p, _ = _drive(torch, [tick_s], [s0], batches[:sub],
                                views=view)
        _same_ticks(got_p, want_p, f"prefix depth {depth}")
        prefix[str(depth)] = {
            "ticks": sub, "matches": sum(tk[0][0] for tk in got_p)}
        if not prefix[str(depth)]["matches"]:
            fail(f"capacity: prefix depth {depth}: no matches")
        del forest, views
    _free(torch)

    # -- rescale 4 -> 2 after tick 32, then on to the end ------------------
    n_old, n_new, at = CAPACITY_RESCALE
    m_new = mesh(n_new)
    _sync(torch)
    t0 = time.perf_counter()
    moved = [scale_to_mesh(s, mesh(n_old), m_new,
                           _state_specs(s, ("data",)))
             for s in keep["snaps"][at]]
    _sync(torch)
    rescale_s = time.perf_counter() - t0
    ticks_new = [build_sharded_tick(p, m_new, extract_matches=True)[0]
                 for _, p in plans]
    _, _, got_r, _ = _drive(torch, ticks_new, moved, batches[at:])
    _same_ticks(got_r, want[at:], f"rescale {n_old} -> {n_new}", at)

    # -- crash after tick 40, restored onto the 4-shard mesh ---------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capacity_")
    crash = min(CAPACITY_CRASH_TICK, n_ticks - 1)
    ticks4 = keep["ticks"]
    crashed = []

    def step(state, i):
        if i == crash and not crashed:
            crashed.append(i)
            raise SimulatedFailure(f"injected after tick {crash}")
        return tuple(tk(s, batches[i])[0] for tk, s in zip(ticks4, state))

    def init():
        return tuple(init_state(p, device=DEVICE) for _, p in plans)

    specs = tuple(_state_specs(s, ("data",)) for s in init())
    loop = FaultTolerantLoop(tmp, step, init,
                             ckpt_every=CAPACITY_CKPT_EVERY, mesh=m4,
                             specs=specs)
    _sync(torch)
    t0 = time.perf_counter()
    final = loop.run(n_ticks)
    _sync(torch)
    loop_s = time.perf_counter() - t0
    if loop.restarts != 1 or crashed != [crash]:
        fail(f"capacity: the loop restarted {loop.restarts} times")
    n_loop_leaves = _same_states(torch, final, keep["final"],
                                 "crash + restore vs uninterrupted")

    out = {
        "phase": "capacity", "device": DEVICE, "edges": n_edges,
        "batch": BATCH, "ticks": n_ticks,
        "tenants": [kind for kind, _ in plans],
        "capacity_total": CAPACITY_TOTAL, "max_new": MAX_NEW,
        "unsharded": unsharded, "runs": runs,
        "ref_parity": {"n_shards": 4, "ticks": sub,
                       "state_leaves_equal": n_ref_leaves,
                       "ref_wall_s": ref_wall, "identical": True},
        "prefix_lift": {"n_shards": 4, "depths": prefix},
        "rescale": {"from": n_old, "to": n_new, "after_tick": at,
                    "seconds": rescale_s, "ticks_after": n_ticks - at,
                    "matches_after": sum(tk[k][0] for tk in got_r
                                         for k in range(len(plans)))},
        "crash_restore": {"n_shards": 4, "ckpt_every": CAPACITY_CKPT_EVERY,
                          "crash_after_tick": crash,
                          "restarts": loop.restarts, "loop_s": loop_s,
                          "state_leaves_equal": n_loop_leaves},
    }
    emit(out)
    return out, launches_all, dict(by_slots_all), {
        "want": want, "finals": finals, "runs": runs}


# --------------------------------------------------------------------- #
# ranks: both meshes over torch.distributed, one process a rank
# --------------------------------------------------------------------- #
RANKS_RUNS = (("nccl", 1), ("gloo", 4), ("gloo", 2))   # 4 before 2: the
RANKS_CKPT_TICK = 32       # 2 ranks restore the 4 ranks' checkpoint here
RANKS_SERVICE = (8, 1)     # the replica service on 2 ranks: R, slots each
RANKS_WAIT_S = 900         # a rank's longest wait for its turn


def _rank_stage(torch, dist):
    """Host ms spent in the tick's tensor collectives, by wrapping them
    in this rank process (the tick calls them through
    ``torch.distributed``): returns the counters."""
    acc = {"calls": 0, "host_ms": 0.0}
    for name in ("all_gather_into_tensor", "all_reduce",
                 "reduce_scatter_tensor"):
        real = getattr(dist, name)

        def timed(*a, real=real, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            acc["host_ms"] += (time.perf_counter() - t0) * 1e3
            acc["calls"] += 1
            return out
        setattr(dist, name, timed)
    return acc


def _collective_device_ms(torch, fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` spends in the collectives' device work
    (NCCL kernels; under gloo, the copies that stage through the host —
    the tick itself copies nothing between host and card), by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync(torch)
    by = _collective_ms_by_name(prof, reps)
    return {"device_ms": sum(by.values()), "by_name": by}


def _collective_ms_by_name(prof, reps: int) -> dict:
    """A profiler window's device ms a rep in the collectives' device
    work (NCCL kernels; gloo's host staging copies), by name."""
    from torch.autograd import DeviceType

    by = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not _dev_us(e):
            continue
        if "nccl" in e.key.lower() or "memcpy" in e.key.lower():
            by[e.key[:60]] = _dev_us(e) / 1e3 / reps
    return by


def _rank_main(rank: int, world: int, backend: str, job: dict) -> None:
    """One rank of the ranks phase: the capacity phase's two engines, a
    ``C/n`` shard each, over the group; with 4 ranks a checkpoint after
    ``RANKS_CKPT_TICK`` and a crash restored through
    ``FaultTolerantLoop``; with 2, that checkpoint restored and the
    replica service.  Writes ``rank{backend}{world}_{rank}.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.checkpoint import (
        mesh_save_kwargs,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.core.distributed import (
        _sharded_current_matches,
        _state_specs,
        build_sharded_tick,
        make_mesh,
    )
    from repro_torch.core.state import init_state, make_batch
    from repro_torch.kernels.compat_join import ops
    from repro_torch.runtime.elastic import scale_to_mesh
    from repro_torch.runtime.fault import FaultTolerantLoop, \
        SimulatedFailure
    from repro_torch.stream.generator import to_batches

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    # every rank of every run starts at once; a run's ranks begin when
    # the parent names their turn, after the previous run has ended
    ready_s = time.perf_counter() - job["t0"]
    go = os.path.join(job["dir"], f"go_{backend}{world}")
    deadline = time.perf_counter() + RANKS_WAIT_S
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            fail(f"ranks: rank {rank} of {backend} x {world} waited "
                 f"{RANKS_WAIT_S} s for its turn")
        time.sleep(0.01)
    t_start = time.perf_counter()
    store = dist.FileStore(os.path.join(job["dir"], f"store_{backend}"
                                                    f"{world}"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    out = {"rank": rank, "backend": dist.get_backend(), "ready_s": ready_s}
    try:
        # the backend's communicator comes up on its first collective:
        # bring it up here, timed, so that tick 0 does not carry it
        t0 = time.perf_counter()
        dist.all_reduce(torch.ones(1, device=DEVICE))
        _sync(torch)
        out["first_collective_ms"] = (time.perf_counter() - t0) * 1e3
        with open(job["stream"], "rb") as f:
            stream = pickle.load(f)
        plans = _cap_plans(stream)
        batches = [make_batch(**b, device=DEVICE)
                   for b in to_batches(stream, BATCH)]
        m = make_mesh((world,), ("data",), devices=(DEVICE,) * world,
                      group=dist.group.WORLD)
        built = [build_sharded_tick(p, m, extract_matches=True)
                 for _, p in plans]
        ticks = [tk for tk, _ in built]
        specs = tuple(_state_specs(s, ("data",)) for _, s in built)
        stage = _rank_stage(torch, dist)
        out["setup_s"] = time.perf_counter() - t_start
        ops.compat_join_pairs.launches = 0        # this path's launches
        ops.compat_join_pairs.launches_by_slots.clear()
        states, snaps, got, lat = _drive(
            torch, ticks, [s for _, s in built], batches,
            snap_at=(RANKS_CKPT_TICK,))
        out["launches"] = ops.compat_join_pairs.launches
        out["launches_by_slots"] = dict(ops.compat_join_pairs
                                        .launches_by_slots)
        out["collective_calls_per_tick"] = stage["calls"] / len(batches)
        out["collective_host_ms_per_tick"] = stage["host_ms"] / len(batches)
        out["ticks"], out["lat"] = got, lat
        out["collective_device"] = _collective_device_ms(
            torch, lambda: [tk(s, batches[-1])
                            for tk, s in zip(ticks, states)])
        out["final"] = [x.cpu().numpy() for x in _flat(tuple(states))]
        out["fold"] = [len(_sharded_current_matches(
            p, s, world, group=dist.group.WORLD))
            for (_, p), s in zip(plans, states)]
        if world == 4:
            snap = tuple(snaps[RANKS_CKPT_TICK])
            save_checkpoint(job["ckpt"], RANKS_CKPT_TICK, snap,
                            **mesh_save_kwargs(snap, m, specs))
            crashed = []

            def step(state, i):
                if i == CAPACITY_CRASH_TICK and not crashed:
                    crashed.append(i)
                    raise SimulatedFailure("injected on every rank")
                return tuple(tk(s, batches[i])[0]
                             for tk, s in zip(ticks, state))

            loop = FaultTolerantLoop(
                os.path.join(job["dir"], f"loop{world}"), step,
                lambda: tuple(build_sharded_tick(p, m)[1]
                              for _, p in plans),
                ckpt_every=CAPACITY_CKPT_EVERY, mesh=m, specs=specs)
            final = loop.run(len(batches))
            same = all(torch.equal(a, b) for a, b in zip(
                _flat(tuple(final)), _flat(tuple(states))))
            out["crash_restore"] = {"restarts": loop.restarts,
                                    "crashed": crashed, "identical": same}
        if world == 2:
            # the 4 ranks' checkpoint: the global state read here,
            # re-homed from 4 shards onto these 2, each rank its block
            m4 = make_mesh((4,), ("data",), devices=(DEVICE,) * 4)
            like = tuple(init_state(p, device=DEVICE) for _, p in plans)
            full = restore_checkpoint(job["ckpt"], RANKS_CKPT_TICK, like)
            moved = [scale_to_mesh(s, m4, m, sp)
                     for s, sp in zip(full, specs)]
            _, _, got_r, _ = _drive(torch, ticks, moved,
                                    batches[RANKS_CKPT_TICK:])
            out["restored_ticks"] = got_r
            out["service"] = _rank_service(torch, dist, job, stream)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(job["dir"], f"rank{backend}{world}_{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


def _rank_service(torch, dist, job, stream) -> dict:
    """The replica service over the group: ``RANKS_SERVICE`` replicas of
    the serve phase's tenants and capacities, the serve phase's first
    ``svc_ticks`` ticks; this rank's tenants' match multisets."""
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.mesh import ShardedSearchService

    n_rep, spr = RANKS_SERVICE
    svc = ShardedSearchService(
        n_rep, spr, devices=(DEVICE,) * n_rep, group=dist.group.WORLD,
        level_capacity=LEVEL_CAP, l0_capacity=LEVEL_CAP, max_new=MAX_NEW,
        tick_cache=SlotTickCache())
    qids = [svc.register(q, w) for _, q, w in tenants(stream)]
    rows, infos = [], []

    def on_match(qid, bind, ets):
        rows.append((qid, bind.copy(), ets.copy()))

    _sync(torch)
    t0 = time.perf_counter()
    svc.serve_stream(stream[:job["svc_ticks"] * BATCH], on_match=on_match,
                     on_tick=infos.append, batch_size=BATCH,
                     min_batch=BATCH, max_batch=BATCH)
    _sync(torch)
    wall = time.perf_counter() - t0
    matches = {q: Counter() for q in qids}
    for q, bind, ets in rows:
        matches[q].update(tuple(map(int, b)) + tuple(map(int, e))
                          for b, e in zip(bind, ets))
    lat = [i.latency_ms for i in infos]
    return {"matches": matches, "local": list(svc.local),
            "backend": svc.backend, "wall_s": wall,
            **_lat_stats(job["svc_ticks"] * BATCH, lat),
            "overflow": sum(i.n_overflow for i in infos),
            "mesh_stats": svc.last_mesh_stats()}


def _block_of(x, k: int, n: int):
    if x.ndim == 0:
        return x
    c = x.shape[0] // n
    return x[k * c:(k + 1) * c]


def phase_ranks(torch, args, stream, cap, serve_matches):
    """Both meshes over ``torch.distributed`` on the card, one process a
    rank (``torch.multiprocessing``, start method "spawn"; the ranks load
    the libraries the build phase made): the capacity phase's chain and
    two-chain at 262,144 rows a table, C/n a rank — NCCL at world size 1,
    gloo at 2 and 4 (ranks share the card; gloo stages a CUDA collective
    through the host, so its times are not NCCL's) — each rank's final
    state block k of the one-process mesh's at the same n, the union of
    the ranks' matches the unsharded engines' tick by tick, overflow 0;
    a crash on 4 ranks restored through ``FaultTolerantLoop``, the 4
    ranks' checkpoint restored on 2; the replica service at R = 8 on 2
    ranks against the serve phase's matches."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    job = {"dir": tmp, "ticks": args.ticks, "svc_ticks": args.parity_ticks,
           "ckpt": os.path.join(tmp, "ck"),
           "stream": os.path.join(tmp, "stream.pkl"), "t0": 0.0}
    with open(job["stream"], "wb") as f:      # the serve stream, as made
        pickle.dump(stream, f)
    want, finals = cap["want"], cap["finals"]
    one_process = {r["n_shards"]: r for r in cap["runs"]}
    runs = []
    t_phase = time.perf_counter()
    # every run's processes start together (imports, the card's context)
    # and wait; each run begins when the one before it has ended
    contexts = []
    try:
        for backend, world in RANKS_RUNS:
            contexts.append(mp.start_processes(
                _rank_main, args=(world, backend, {
                    **job, "t0": time.perf_counter()}),
                nprocs=world, join=False, start_method="spawn"))
        for (backend, world), ctx in zip(RANKS_RUNS, contexts):
            t0 = time.perf_counter()
            open(os.path.join(tmp, f"go_{backend}{world}"), "w").close()
            while not ctx.join():
                pass
            run_s = time.perf_counter() - t0
            runs.append(_ranks_run(tmp, backend, world, run_s, want,
                                   finals, one_process, args,
                                   serve_matches))
    finally:
        for ctx in contexts:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
    service = next((r.pop("service") for r in runs if "service" in r), None)
    launches = sum(r.pop("launches_all") for r in runs)
    by_slots = sum((r.pop("by_slots_all") for r in runs), Counter())
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "ranks", "device": DEVICE,
           "card": _card_line() if DEVICE == "cuda" else None,
           "ticks": len(want),
           "batch": BATCH, "capacity_total": CAPACITY_TOTAL,
           "seconds": time.perf_counter() - t_phase, "runs": runs,
           "service": service,
           "note": "gloo stages CUDA tensors through host memory; its "
                   "times are not NCCL's"}
    emit(out)
    if launches <= 0:
        fail("ranks: no pair kernel launched")
    return out, launches, dict(by_slots)


def _ranks_run(tmp, backend, world, run_s, want, finals, one_process, args,
               serve_matches) -> dict:
    """Read one run's rank files and check them (see ``phase_ranks``)."""
    import pickle

    import numpy as np

    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{backend}{world}_{r}.pkl"),
                  "rb") as f:
            ranks.append(pickle.load(f))
    what = f"{backend} x {world}"
    for k, rk in enumerate(ranks):
        if rk["backend"] != backend:
            fail(f"ranks: {what}: rank {k} ran {rk['backend']}")
        if rk["launches_by_slots"] != {1: 6 * len(want)}:
            fail(f"ranks: {what}: rank {k} pair launches "
                 f"{rk['launches_by_slots']}, not 6 a tick at S = 1")
        for i, (x, y) in enumerate(zip(finals[world], rk["final"])):
            if not np.array_equal(_block_of(x, k, world), y):
                fail(f"ranks: {what}: rank {k}'s final leaf {i} is not "
                     f"block {k} of the one-process mesh's")
    # per tick and engine: the union of the ranks' matches
    for t, w in enumerate(want):
        for e, (wn, wo, wm) in enumerate(w):
            n_new = {rk["ticks"][t][e][0] for rk in ranks}
            over = sum(rk["ticks"][t][e][1] for rk in ranks)
            rows = sum((rk["ticks"][t][e][2] for rk in ranks), Counter())
            if n_new != {wn} or over or wo or rows != wm:
                fail(f"ranks: {what}: tick {t} engine {e}: matches "
                     f"{n_new} ({sum(rows.values())} rows, overflow "
                     f"{over}) vs the unsharded {wn}")
    lat = ranks[0]["lat"]
    run = {"backend": backend, "world": world,
           "rows_a_rank": CAPACITY_TOTAL // world,
           **_lat_stats(len(want) * BATCH, lat),
           "one_process_mesh": {k: one_process[world][k] for k in (
               "edges_per_s", "tick_ms_p50", "tick_ms_p99")},
           "run_s": run_s,
           "rank_ready_s": [rk["ready_s"] for rk in ranks],
           "rank_seconds": [rk["seconds"] for rk in ranks],
           "rank_setup_s": [rk["setup_s"] for rk in ranks],
           "first_collective_ms": [rk["first_collective_ms"]
                                   for rk in ranks],
           "collective_calls_per_tick":
               ranks[0]["collective_calls_per_tick"],
           "collective_host_ms_per_tick": [
               rk["collective_host_ms_per_tick"] for rk in ranks],
           "collective_device_ms_per_tick": [
               rk["collective_device"]["device_ms"] for rk in ranks],
           "collective_device_by_name":
               ranks[0]["collective_device"]["by_name"],
           "fold_sizes": ranks[0]["fold"],
           "pair_launches_a_rank": ranks[0]["launches"]}
    if world == 4:
        cr = [rk["crash_restore"] for rk in ranks]
        if any(c["restarts"] != 1 or not c["identical"] for c in cr):
            fail(f"ranks: {what}: crash + restore {cr}")
        run["crash_restore"] = {
            "crash_after_tick": CAPACITY_CRASH_TICK,
            "ckpt_every": CAPACITY_CKPT_EVERY, "identical": True}
    if world == 2:
        for t, w in enumerate(want[RANKS_CKPT_TICK:]):
            for e, (wn, _, wm) in enumerate(w):
                rows = sum((rk["restored_ticks"][t][e][2]
                            for rk in ranks), Counter())
                if rows != wm or any(rk["restored_ticks"][t][e][1]
                                     for rk in ranks):
                    fail(f"ranks: the 4-rank checkpoint on 2 ranks: "
                         f"tick {t + RANKS_CKPT_TICK} engine {e} "
                         f"differs from the unsharded")
        run["restored_4_on_2"] = {"after_tick": RANKS_CKPT_TICK,
                                  "ticks": len(want) - RANKS_CKPT_TICK}
        svcs = [rk["service"] for rk in ranks]
        union = {}
        for sv in svcs:
            for q, c in sv["matches"].items():
                union[q] = union.get(q, Counter()) + c
        if union != {q: c for q, c in serve_matches.items()}:
            fail("ranks: the replica service on 2 ranks reports other "
                 "matches than the serve phase")
        if any(sv["overflow"] for sv in svcs):
            fail("ranks: the replica service overflowed")
        run["service"] = {
            "n_replicas": RANKS_SERVICE[0],
            "slots_per_replica": RANKS_SERVICE[1], "world": world,
            "backend": backend, "ticks": args.parity_ticks,
            "matches_total": sum(sum(c.values()) for c in union.values()),
            "held": [sv["local"] for sv in svcs],
            **{k: svcs[0][k] for k in ("edges_per_s", "tick_ms_p50",
                                       "tick_ms_p99", "wall_s")},
            "mesh_stats_equal": all(sv["mesh_stats"] == svcs[0]["mesh_stats"]
                                    for sv in svcs)}
    run["launches_all"] = sum(rk["launches"] for rk in ranks)
    run["by_slots_all"] = sum((Counter(rk["launches_by_slots"])
                               for rk in ranks), Counter())
    return run


# --------------------------------------------------------------------- #
# sharded_cells: the model cells over a mesh of ranks
# --------------------------------------------------------------------- #
SC_RUNS = (("nccl", 1, (1, 1)), ("gloo", 4, (2, 2)))   # (backend, world,
# mesh shape over ("data", "model")); NCCL takes one rank a card
SC_NCCL_CASES = ("wd_train",)   # both kernels: the bags, their gradient
SC_WD_STEPS = 3            # W&D steps held to the one-process cell's
SC_WD_SERVE = 512          # serve_p99's batch
# the FSDP x TP step, float32, held to the one-process step: sequences
# x tokens, cut for time (each float32 step gathers its layers through
# the host under gloo)
SC_LM_CHECK = (2, 64)
# the FSDP x TP step in bf16, the production dtype: lm_train's 8 x 4,096
# (train_4k's 256 x 4,096) cut for memory, to the largest batch whose
# four ranks' peaks (12.9 GiB each) and, before them, the one-process
# step's (50.0 GiB) fit the one 80 GB card
SC_LM_RUN = (4, 2048)
SC_LM_RUN_TOL = 1e-2       # bf16: its loss and grad norm, relative
SC_LM_DECODE = (2, 64)     # float32 decode check: batch x cache
# the bf16 decode at lm_serve's serving shape (decode_32k's 128 cut to
# LM_DECODE_BATCH against its whole cache), 2 of the 40 layers
SC_LM_DECODE_BF16 = (4, 32768)
SC_LM_DECODE_BF16_TOL = 1e-2   # bf16 logits: relative Frobenius
# the bf16 decode's two readings beside its bound, at its inputs: the
# witness (both sides float32) and the control (the ranks' partial sums
# rounded to bf16 before they are summed); the control's one-process
# side is the bf16 case's
SC_DECODE_WITNESS, SC_DECODE_CONTROL = "lm_decode_f32", "lm_decode_bf16p"
SC_ROWS = 64               # sampled rows (dim -2) of a large leaf
SC_LEAD = 4                # sampled indices of each dim before those
SC_WHOLE = 1 << 20         # a leaf of at most this many elements: whole
SC_LM_TOL = 1e-4           # lm_train / lm_serve's float32 bound


def _sc_arch(name: str, **cfg):
    import dataclasses

    from repro_torch.configs.registry import get_arch

    arch = get_arch(name)
    if cfg:
        arch = dataclasses.replace(arch, config=dataclasses.replace(
            arch.config, **cfg))
    return arch


def _sc_cells(torch):
    """case -> (arch, shape): the sharded_cells phase's cells, each a
    registry cell cut as its docstring says."""
    import dataclasses as dc

    wd = _sc_arch("wide-deep")
    lm = _sc_arch(LM_ARCH, n_layers=LM_TRAIN_LAYERS)
    lm32 = _sc_arch(LM_ARCH, n_layers=LM_TRAIN_LAYERS, dtype=torch.float32)
    gin, gat, nqa = (_sc_arch(a) for a in ("gin-tu", "gat-cora", "nequip"))
    return {
        "wd_train": (wd, dc.replace(wd.shape("train_batch"),
                                    global_batch=WD_TRAIN_BATCH)),
        "wd_serve": (wd, dc.replace(wd.shape("serve_p99"),
                                    global_batch=SC_WD_SERVE)),
        "gin_cora": (gin, gin.shape("full_graph_sm")),
        "gat_cora": (gat, gat.shape("full_graph_sm")),
        "nequip_molecule": (nqa, nqa.shape("molecule")),
        "lm_check": (lm32, dc.replace(
            lm32.shape("train_4k"), global_batch=SC_LM_CHECK[0],
            seq_len=SC_LM_CHECK[1], microbatches=1)),
        "lm_decode": (lm32, dc.replace(
            lm32.shape("decode_32k"), global_batch=SC_LM_DECODE[0],
            seq_len=SC_LM_DECODE[1])),
        "lm_decode_bf16": (lm, dc.replace(
            lm.shape("decode_32k"), global_batch=SC_LM_DECODE_BF16[0],
            seq_len=SC_LM_DECODE_BF16[1])),
        SC_DECODE_WITNESS: (lm32, dc.replace(
            lm32.shape("decode_32k"), global_batch=SC_LM_DECODE_BF16[0],
            seq_len=SC_LM_DECODE_BF16[1])),
        SC_DECODE_CONTROL: (lm, dc.replace(
            lm.shape("decode_32k"), global_batch=SC_LM_DECODE_BF16[0],
            seq_len=SC_LM_DECODE_BF16[1])),
        "lm_run": (lm, dc.replace(
            lm.shape("train_4k"), global_batch=SC_LM_RUN[0],
            seq_len=SC_LM_RUN[1], microbatches=1)),
    }


def _sc_data(torch, seed: int) -> dict:
    """The phase's inputs as host numpy arrays, made from ``seed``."""
    import numpy as np

    from repro_torch.configs.wide_deep import CONFIG
    from repro_torch.data.graphs import synth_cora_like
    from repro_torch.data.recsys import recsys_batch
    from repro_torch.launch.cells import _pad_up

    def batch(n, step):
        return recsys_batch(step, n, CONFIG.n_sparse, CONFIG.vocab_per_field,
                            CONFIG.n_dense, CONFIG.n_wide_crosses, seed=seed)

    def pad_edges(g):
        e = len(g["edge_src"])
        out = dict(g)
        for k in ("edge_src", "edge_dst"):
            out[k] = np.full(_pad_up(e), -1, np.int32)
            out[k][:e] = g[k]
        return out

    cora = synth_cora_like(seed=seed)
    cora = pad_edges({k: cora[k] for k in ("x", "edge_src", "edge_dst",
                                           "labels")})
    mol = make_molecules(seed)
    mol.pop("n_graphs")
    mol["energy"] = np.random.default_rng(seed + 1).standard_normal(
        MOL_BATCH).astype(np.float32)
    mol = pad_edges(mol)
    rng = np.random.default_rng(seed + 7)
    from repro_torch.configs.qwen3_14b import CONFIG as LM_CFG

    def tokens(b, s):
        return rng.integers(0, LM_CFG.vocab, (b, s)).astype(np.int32)

    b, s = SC_LM_DECODE
    kv = (LM_TRAIN_LAYERS, b, s, LM_CFG.n_kv_heads, LM_CFG.head_dim)
    train = batch(WD_TRAIN_BATCH, 0)
    # the tables' sampled rows: for each sampled field, rows the batch
    # reads (evenly spaced over its ids) and rows it does not
    rows = set()
    for f in WD_SAMPLE_FIELDS:
        used = np.unique(train["sparse_ids"][:, f])
        rows.update(used[np.linspace(0, len(used) - 1,
                                     WD_SAMPLE_TOUCHED).astype(int)].tolist())
        rows.update(np.setdiff1d(rng.integers(
            0, CONFIG.vocab_per_field, 8 * WD_SAMPLE_UNTOUCHED),
            used)[:WD_SAMPLE_UNTOUCHED].tolist())
    decode_bf16 = (tokens(SC_LM_DECODE_BF16[0], 1), seed + 11,
                   rng.integers(SC_LM_DECODE_BF16[1] // 2,
                                SC_LM_DECODE_BF16[1] - 1,
                                SC_LM_DECODE_BF16[0]).astype(np.int32))
    return {
        "wd_train": train, "wd_serve": batch(SC_WD_SERVE, 1),
        "wd_rows": sorted(rows), "gin_cora": cora, "gat_cora": cora,
        "nequip_molecule": mol,
        "lm_check": tokens(*SC_LM_CHECK), "lm_run": tokens(*SC_LM_RUN),
        "lm_decode": (tokens(b, 1),
                      rng.standard_normal(kv).astype(np.float32),
                      rng.standard_normal(kv).astype(np.float32),
                      rng.integers(s // 2, s - 1, b).astype(np.int32)),
        # the 32,768-position caches are drawn on the card from this
        # seed by every process alike (``_sc_cache``), not pickled; the
        # witness and the control read the same
        "lm_decode_bf16": decode_bf16, SC_DECODE_WITNESS: decode_bf16,
        SC_DECODE_CONTROL: decode_bf16,
    }


def _sc_plan(shape, rows=None) -> list:
    """Which indices of a global leaf of ``shape`` the checks read, a
    list per dim (None: all): a small leaf whole; else its last dim
    whole, ``SC_ROWS`` evenly spaced indices of the dim before it and
    ``SC_LEAD`` of each dim before that (``rows``: [lead, rows] given,
    the W&D tables' fields and rows)."""
    import numpy as np

    n = int(np.prod(shape)) if len(shape) else 1
    if n <= SC_WHOLE:
        return [None] * len(shape)
    if rows is not None:
        return [list(WD_SAMPLE_FIELDS), rows, None]

    def spaced(size, k):
        return sorted(set(np.linspace(0, size - 1, min(k, size))
                          .astype(int).tolist()))

    if len(shape) == 1:
        return [spaced(shape[0], SC_ROWS * SC_LEAD)]
    return [spaced(s, SC_LEAD) for s in shape[:-2]] \
        + [spaced(shape[-2], SC_ROWS), None]


def _sc_piece(x, spec, mesh, plan, gshape):
    """This rank's part of the sample ``plan`` of a leaf whose block is
    ``x`` (``spec`` on ``mesh``; None: the whole leaf): (position lists
    into the sample, values as numpy) or None."""
    import numpy as np

    sel, pos = [], []
    for d, idx in enumerate(plan):
        lo, n = 0, gshape[d]
        if mesh is not None and spec is not None and d < len(spec.parts) \
                and spec.parts[d] is not None:
            n = gshape[d] // mesh.axis_size(spec.parts[d])
            lo = mesh.axis_index(spec.parts[d]) * n
        full = range(gshape[d]) if idx is None else idx
        mine = [(k, i - lo) for k, i in enumerate(full) if lo <= i < lo + n]
        if not mine:
            return None
        pos.append([k for k, _ in mine])
        sel.append([i for _, i in mine])
    if not plan:
        return [], x.detach().float().cpu().numpy()
    ix = _torch_ix(x, sel)
    return pos, x.detach()[ix].float().cpu().numpy()


def _torch_ix(x, sel):
    """``np.ix_`` for a tensor: index tensors broadcasting to the grid."""
    import torch

    n = len(sel)
    return tuple(torch.as_tensor(s, device=x.device).view(
        [-1 if d == k else 1 for k in range(n)]) for d, s in enumerate(sel))


def _sc_samples(torch, params, opt, specs, mesh, plans) -> list:
    """The sample of every parameter leaf and its AdamW state on this
    rank: [{"p", "m", "v"} of (positions, values) parts], the second
    moment of a factored leaf reconstructed on the sample (``vr ⊗ vc /
    mean(vr)``, the mean over the whole row: summed over the ranks)."""
    import numpy as np

    from repro_torch.core.collectives import all_reduce_
    from repro_torch.core.distributed import P, global_shape
    from repro_torch.optim.tree import flatten, flatten_up_to

    leaves = flatten(params)
    states = flatten_up_to(params, opt["leaves"])
    specs = [None] * len(leaves) if specs is None else flatten_up_to(
        params, specs)
    out = []
    for x, st, sp, plan in zip(leaves, states, specs, plans):
        sp = sp or P()
        g = tuple(x.shape) if mesh is None else global_shape(
            tuple(x.shape), sp, mesh)
        rec = {"p": _sc_piece(x, sp, mesh, plan, g)}
        if "m_q" in st:
            sc = st["m_scale"].view(st["m_scale"].shape
                                    + (1,) * (x.dim() - st["m_scale"].dim()))
            m = st["m_q"].float() * sc
        else:
            m = st["m"]
        rec["m"] = _sc_piece(m, sp, mesh, plan, g)
        if "vr" in st:
            rsp = P(*sp.parts[:-1]) if len(sp) else P()
            csp = P(*(sp.parts[:-2] + sp.parts[-1:])) if len(sp) else P()
            tot = st["vr"].sum(-1).contiguous()
            if mesh is not None and len(sp) >= 2 and sp.parts[-2]:
                all_reduce_(tot, mesh.axis_group(sp.parts[-2]))
            den = (tot / g[-2]).clamp(min=1e-30)
            rec["vr"] = _sc_piece(st["vr"], rsp, mesh, plan[:-1], g[:-1])
            rec["vc"] = _sc_piece(st["vc"], csp, mesh,
                                  plan[:-2] + plan[-1:], g[:-2] + g[-1:])
            rec["den"] = _sc_piece(den, P(*rsp.parts[:-1]) if len(rsp)
                                   else P(), mesh, plan[:-2], g[:-2])
        else:
            rec["v"] = _sc_piece(st["v"], sp, mesh, plan, g)
        out.append(rec)
        del m
    return out


def _sc_assemble(parts_by_rank: list, plans, shapes) -> list:
    """The ranks' sample parts put together: [{"p", "m", "v"} numpy]."""
    import numpy as np

    def grid(plan, gshape):
        return tuple(gshape[d] if idx is None else len(idx)
                     for d, idx in enumerate(plan))

    out = []
    for i, (plan, gshape) in enumerate(zip(plans, shapes)):
        rec = {}
        for key, pl, gs in (("p", plan, gshape), ("m", plan, gshape),
                            ("v", plan, gshape),
                            ("vr", plan[:-1], gshape[:-1]),
                            ("vc", plan[:-2] + plan[-1:],
                             gshape[:-2] + gshape[-1:]),
                            ("den", plan[:-2], gshape[:-2])):
            pieces = [r[i].get(key) for r in parts_by_rank]
            if not any(p is not None for p in pieces) and \
                    key not in parts_by_rank[0][i]:
                continue
            arr = np.full(grid(pl, gs), np.nan, np.float64)
            for piece in pieces:
                if piece is None:
                    continue
                pos, val = piece
                arr[np.ix_(*pos) if pos else ()] = val
            rec[key] = arr
        if "vr" in rec:
            rec["v"] = rec.pop("vr")[..., :, None] * rec.pop("vc")[
                ..., None, :] / rec.pop("den")[..., None, None]
        out.append(rec)
    return out


def _sc_step_bound(got: list, want: list, lr: float, cfg) -> tuple:
    """Parameters after ``len(got)`` steps (each step's samples, from the
    same start) against the one-process ones: within ``lr Σ_k |step_k -
    step'_k|`` (each step's Adam step from its own samples) plus 16
    float32 ulps of the operands a step; every sample entry filled.
    -> (worst err / bound, first step's gradient max rel err)."""
    import numpy as np

    ratio, grad_rel = 0.0, 0.0
    n = len(got)
    for i in range(len(got[-1])):
        delta = 0.0
        for k in range(n):
            c1, c2 = 1 - cfg.b1 ** (k + 1), 1 - cfg.b2 ** (k + 1)
            sa = (got[k][i]["m"] / c1) / (np.sqrt(got[k][i]["v"] / c2)
                                          + cfg.eps)
            sb = (want[k][i]["m"] / c1) / (np.sqrt(want[k][i]["v"] / c2)
                                           + cfg.eps)
            delta = delta + np.abs(sa - sb)
        p, q = got[-1][i]["p"], want[-1][i]["p"]
        if np.isnan(p).any() or np.isnan(q).any():
            fail(f"sharded_cells: leaf {i}'s sample has unfilled entries")
        tol = lr * delta + n * 16 * 2.0 ** -24 * (np.abs(q) + lr * (
            np.abs(sb) + 1))
        ratio = max(ratio, float((np.abs(p - q) / tol).max()))
        ma, mb = got[0][i]["m"], want[0][i]["m"]
        grad_rel = max(grad_rel, float(np.abs(ma - mb).max())
                       / max(float(np.abs(mb).max()), 1e-30))
    return ratio, grad_rel


def _sc_fill(torch, tree, specs, mesh, data) -> None:
    """Copy the host arrays ``data`` (a dict, or one array) into the
    blocks ``tree`` holds under ``specs``."""
    from repro_torch.core.distributed import local_block
    from repro_torch.optim.tree import flatten, flatten_up_to

    keys = None if not isinstance(tree, dict) else sorted(tree)
    leaves = flatten(tree)
    sps = flatten_up_to(tree, specs) if specs is not None else [None] * len(
        leaves)
    vals = [data[k] for k in keys] if keys else [data]
    with torch.no_grad():
        for x, sp, v in zip(leaves, sps, vals):
            v = torch.as_tensor(v)
            if mesh is not None:
                v = local_block(v, sp, mesh)
            x.copy_(v.to(x.dtype))


def _sc_cache(torch, shape, seed: int):
    """The bf16 decode case's K and V caches, N(0, 1) drawn on the card
    from ``seed`` (the same numbers in every process)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                             device=DEVICE) for _ in range(2))


def _sc_weight_moves(torch, records, params, specs, cfg, mesh,
                     batch) -> list:
    """What in a sharded decode step's collectives (``records``, from
    ``core.collectives.recording``) says it moved weights, as messages:
    a collective other than an all-reduce or all-gather, an all-gather
    larger than the whole logits, or a step total not under a tenth of
    the layers' weights' whole bytes in the compute dtype (what a step
    that gathered them takes in).  ``params`` the rank's blocks under
    ``specs``."""
    from repro_torch.core.distributed import global_shape
    from repro_torch.optim.tree import flatten, flatten_up_to

    size = torch.empty((), dtype=cfg.dtype).element_size()
    layers = params["layers"]
    weights = sum(math.prod(global_shape(x.shape, sp, mesh)) * size
                  for x, sp in zip(flatten(layers),
                                   flatten_up_to(layers, specs["layers"])))
    logits = batch * cfg.vocab * size
    out = [f"a {kind} of {n} bytes over {g} ranks"
           for kind, n, g in records
           if kind not in ("all-reduce", "all-gather")
           or (kind == "all-gather" and n > logits)]
    total = sum(n for _, n, _ in records)
    if total * 10 >= weights:
        out.append(f"{total} recorded bytes: not under a tenth of the "
                   f"layer weights' {weights}")
    return out


@contextlib.contextmanager
def _bf16_partials():
    """The bf16 decode's control: each partial product of the stationary
    step rounded to bf16 before its sum over the ranks, one rounding
    more a product than the float32 partials the step sums."""
    from repro_torch.models import attention, common, moe, transformer

    def rounded(x, w):
        return common.partial_product(x, w).bfloat16().float()

    mods = (attention, moe, transformer)
    for m in mods:
        m.partial_product = rounded
    try:
        yield
    finally:
        for m in mods:
            m.partial_product = common.partial_product


def _sc_kernel_counts(torch, prof) -> dict:
    """Launches by kernel name of a profiler window: the embedding_bag
    kernel's and the segment_sum kernels'."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        name = _kernel_name(e.key)
        if e.device_type == DeviceType.CUDA and (
                name == "eb_bag_sum" or name.startswith("sr_")):
            out[name] = out.get(name, 0) + e.count
    return out


def _sc_case(torch, name: str, mesh, data, cells, stage) -> dict:
    """One case of the phase on ``mesh`` (None: the one-process cell on
    the card): build the cell (``launch.cells.cell_for``), fill its
    inputs from ``data``, run it, and return what the checks read:
    losses, grad norms and parameter samples a step, or the gathered
    outputs; step seconds, peak, kernel launches (the wrappers' counters
    and a profiler window over the steps) and the collectives' host and
    device ms a step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.collectives import all_gather, recording
    from repro_torch.core.distributed import global_shape
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.cells import cell_for
    from repro_torch.optim.tree import flatten

    arch, shape = cells[name]
    _free(torch)
    _reset_peak(torch)
    t0 = time.perf_counter()
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        # one rank at a time makes its global arguments (then keeps its
        # blocks): four ranks' whole tables at once would not fit
        for r in range(mesh.size):
            if r == mesh.rank:
                cell = cell_for(arch, shape, mesh=mesh, device=DEVICE)
                _free(torch)
            dist.barrier()
    else:
        cell = cell_for(arch, shape, mesh=mesh, device=DEVICE)
    build_s = time.perf_counter() - t0
    ins = cell.in_shardings if mesh is not None else (None,) * len(
        cell.args)
    out = {"case": name, "build_s": build_s}
    train = shape.kind == "train"
    if train:
        model, opt, batch = cell.args
        _sc_fill(torch, batch, ins[2], mesh, data[name])
        leaves = flatten(model.params())
        specs = flatten(ins[0]) if mesh is not None else [None] * len(
            leaves)
        shapes = [tuple(x.shape) if sp is None else global_shape(
            tuple(x.shape), sp, mesh) for x, sp in zip(leaves, specs)]
        plans = [_sc_plan(s, data["wd_rows"] if name == "wd_train"
                          and len(s) == 3 else None) for s in shapes]
        steps = SC_WD_STEPS if name == "wd_train" else 1
    else:
        if name.startswith("lm_decode"):
            if name == "lm_decode":
                tok, kc, vc, length = data[name]
            else:
                tok, cache_seed, length = data[name]
                c = arch.config
                kc, vc = _sc_cache(torch, (c.n_layers, shape.global_batch,
                                           shape.seq_len, c.n_kv_heads,
                                           c.head_dim), cache_seed)
            params, t_a, k_a, v_a, l_a = cell.args
            for a, sp, v in zip((t_a, k_a, v_a, l_a), ins[1:],
                                (tok, kc, vc, length)):
                _sc_fill(torch, a, sp, mesh, v)
        else:
            _sc_fill(torch, cell.args[1], ins[1], mesh, data[name])
        # a decode step writes its cache positions again: the same step
        # repeated, its median time after the first
        steps = 3 if name.startswith("lm_decode") else 1
    _sync(torch)
    eb.embedding_bag.launches = sr.segment_sum.launches = 0
    stage["calls"], stage["host_ms"] = 0, 0.0
    losses, norms, samples, times, records = [], [], [], [], []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if DEVICE == "cuda" else [])
    control = name == SC_DECODE_CONTROL and mesh is not None
    with profile(activities=acts) as prof:
        for k in range(steps):
            t1 = time.perf_counter()
            with recording() as rec, (_bf16_partials() if control
                                      else contextlib.nullcontext()):
                res = cell.fn(*cell.args)
            _sync(torch)
            times.append(time.perf_counter() - t1)
            records.append(rec)
            if train:
                _, opt, l, gn = res
                losses.append(float(l))
                norms.append(float(gn))
                if name != "lm_run":       # bf16: its loss and norm alone
                    samples.append(_sc_samples(
                        torch, model.params(), opt, ins[0], mesh, plans))
    out.update(
        step_s=times, peak_gib=_peak_gib(torch),
        launches={"embedding_bag": eb.embedding_bag.launches,
                  "segment_sum": sr.segment_sum.launches},
        profiled_launches=_sc_kernel_counts(torch, prof)
        if DEVICE == "cuda" else {},
        collective_calls_per_step=stage["calls"] / steps,
        recorded_collectives_per_step=len(records[0]),
        wire_bytes_per_step=RL.collective_bytes(records[0])["total"],
        collective_host_ms_per_step=stage["host_ms"] / steps,
        collective_device_ms_per_step=(
            sum(_collective_ms_by_name(prof, steps).values())
            if DEVICE == "cuda" else None))
    if train:
        out.update(losses=losses, grad_norms=norms, samples=samples,
                   plans=plans, shapes=shapes)
    elif name.startswith("lm_decode") and mesh is not None \
            and mesh.size > 1:
        # weight-stationary: the step's collectives carry activations
        out["weight_moves"] = _sc_weight_moves(
            torch, records[0], cell.args[0], ins[0], arch.config, mesh,
            shape.global_batch)
    if not train:
        # the logits (the first output), gathered from their blocks
        x = res[0] if isinstance(res, tuple) else res
        sp = None if mesh is None else flatten(cell.out_shardings)[0]
        for d, e in enumerate(() if sp is None else sp.parts):
            if e is not None:
                x = all_gather(x.contiguous(), d, mesh.axis_group(e))
        out["outputs"] = [x.float().cpu().numpy()]
    # every tensor of the case let go before the cache is emptied
    cell = res = model = opt = batch = x = leaves = params = None
    t_a = k_a = v_a = l_a = kc = vc = records = None
    _free(torch)
    return out


def _sc_rank_main(rank: int, world: int, backend: str, job: dict) -> None:
    """One rank of the sharded_cells phase: every case of its run on the
    ``(data, model)`` mesh; writes ``sc{backend}{world}_{rank}.pkl``
    (rank 0 also the assembled samples)."""
    import pickle

    # four ranks' caches share the card: segments that grow in place
    # leave less reserved and unused
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core.distributed import make_mesh

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    go = os.path.join(job["dir"], f"go_{backend}{world}")
    deadline = time.perf_counter() + RANKS_WAIT_S
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            fail(f"sharded_cells: rank {rank} of {backend} x {world} "
                 f"waited {RANKS_WAIT_S} s for its turn")
        time.sleep(0.01)
    store = dist.FileStore(os.path.join(job["dir"], f"store_{backend}"
                                                    f"{world}"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    out = {"rank": rank, "backend": dist.get_backend(), "cases": {}}
    try:
        dist.all_reduce(torch.ones(1, device=DEVICE))
        with open(job["data"], "rb") as f:
            data = pickle.load(f)
        shape = job["meshes"][f"{backend}{world}"]
        mesh = make_mesh(shape, ("data", "model"),
                         devices=(DEVICE,) * world, group=dist.group.WORLD)
        cells = _sc_cells(torch)
        stage = _rank_stage(torch, dist)
        for name in job["cases"][f"{backend}{world}"]:
            res = _sc_case(torch, name, mesh, data, cells, stage)
            if "samples" in res:
                parts = [None] * world
                dist.all_gather_object(parts, res.pop("samples"))
                if rank == 0:
                    res["samples"] = [_sc_assemble([p[k] for p in parts],
                                                   res["plans"],
                                                   res["shapes"])
                                      for k in range(len(parts[0]))]
            out["cases"][name] = res
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(job["dir"], f"sc{backend}{world}_{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


def _sc_check(name, got, want) -> tuple:
    """One case of a run against the one-process cell: (fields,
    problems)."""
    import numpy as np

    from repro_torch.optim import AdamWConfig

    problems, fields = [], {}
    if "losses" in want:
        tol = SC_LM_RUN_TOL if name == "lm_run" else SC_LM_TOL \
            if name.startswith("lm") else (
                1e-5 if name.startswith("wd") else want["tol"])
        rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in
               zip(got["losses"] + got["grad_norms"],
                   want["losses"] + want["grad_norms"])]
        fields.update(loss=got["losses"], one_process_loss=want["losses"],
                      grad_norm=got["grad_norms"],
                      one_process_grad_norm=want["grad_norms"],
                      loss_grad_norm_max_rel_err=max(rel), tol=tol)
        if max(rel) > tol:
            problems.append(f"{name}: loss / grad_norm rel err {max(rel)} "
                            f"> {tol}")
        if want.get("samples"):
            ratio, grad_rel = _sc_step_bound(got["samples"],
                                             want["samples"], want["lr"],
                                             AdamWConfig())
            fields.update(param_err_over_bound=ratio,
                          grad_max_rel_err=grad_rel)
            if not ratio <= 1.0:
                problems.append(f"{name}: parameters off their bound "
                                f"(x{ratio})")
            if not grad_rel <= tol:
                problems.append(f"{name}: gradient rel err {grad_rel} > "
                                f"{tol}")
    elif name in ("lm_decode_bf16", SC_DECODE_WITNESS, SC_DECODE_CONTROL):
        a, b = (x.astype(np.float64) for x in (got["outputs"][0],
                                               want["outputs"][0]))
        err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        fields.update(output_rel_frobenius_err=err)
        if name == SC_DECODE_CONTROL:
            # a reading, held to nothing: does the bf16 bound tell a
            # lower precision from the configured one?
            fields.update(control="bf16 partial sums",
                          over_bf16_tol=err > SC_LM_DECODE_BF16_TOL)
        else:
            tol = SC_LM_TOL if name == SC_DECODE_WITNESS \
                else SC_LM_DECODE_BF16_TOL
            fields.update(tol=tol)
            if not err <= tol:
                problems.append(f"{name}: logits rel Frobenius err {err} "
                                f"> {tol}")
    else:
        a, b = got["outputs"][0], want["outputs"][0]
        err = float(np.abs(a.astype(np.float64) - b).max()) / max(
            float(np.abs(b).max()), 1e-30)
        tol = SC_LM_TOL if name.startswith("lm") else 1e-5
        fields.update(output_max_err_rel_to_max=err, tol=tol)
        if not err <= tol:
            problems.append(f"{name}: outputs rel err {err} > {tol}")
    if got.get("weight_moves"):
        problems.append(f"{name}: the decode step moved weights: "
                        f"{got['weight_moves'][:3]}")
    return fields, problems


def phase_sharded_cells(torch, seed: int):
    """The model cells over a mesh of ranks (``launch.cells.cell_for(...,
    mesh=)`` on ``core.distributed.make_mesh(..., group=)``): each rank
    holds and computes its block of every cell argument.  NCCL at world
    1 on a (1, 1) ``("data", "model")`` mesh runs the Wide&Deep train
    step (both kernels: the bags and their gradient); gloo at world 4 on
    (2, 2), ranks sharing the card (NCCL takes one rank a card), runs
    them all:

      wd_train        Wide&Deep at the published width (40 x 1,000,000 x
                      32 tables, wide 4,000,000, MLP 1024-512-256),
                      train_batch 65,536, AdamW factored, 3 steps
      wd_serve        serve_p99, 512 examples
      gin_cora,       GIN and GAT at full_graph_sm (Cora, edges padded
      gat_cora        to the cells' 512 with -1), one step
      nequip_molecule NequIP at molecule, one step
      lm_check        qwen3-14b at full width, 2 layers, float32, one
                      FSDP x TP step on 2 x 64 tokens (lm_train's 8 x
                      4,096 cut for time: ``SC_LM_CHECK``)
      lm_decode       its decode step, batch 2 against a 64 cache
                      (float32), weight-stationary: every rank's
                      step must gather no weight (``_sc_weight_moves``)
      lm_decode_bf16  the 2 layers in bf16, lm_serve's decode shape:
                      batch 4 against a 32,768 cache (drawn on the card
                      from the seed), logits within 1e-2 relative
                      Frobenius of the one-process step's; the same rule
      lm_decode_f32   the witness: lm_decode_bf16's inputs with both
                      sides in float32, within 1e-4 relative Frobenius
      lm_decode_bf16p the control: lm_decode_bf16 with each partial
                      product rounded to bf16 before its sum over the
                      ranks (``_bf16_partials``), against the same
                      one-process step; its reading is recorded, not held
      lm_run          the 2 layers in bf16, one FSDP x TP step on 4 x
                      2,048 tokens (lm_train's 8 x 4,096 cut for memory:
                      ``SC_LM_RUN``), loss and grad norm within 1e-2

    Each against the one-process cell from the same seed on the same
    card, made first in this process: losses and grad norms (W&D 1e-5,
    the GNNs ``_f32_tol``, the LM 1e-4 relative), parameters on their
    samples (every leaf of a million entries or fewer whole; a larger
    one on ``SC_ROWS`` rows, the W&D tables on the recsys_train phase's
    sampled rows) within ``lr Σ |Δstep| + 16 ulps`` a step, outputs
    (logits) 1e-5 or 1e-4 of their largest.  Every rank must launch the
    embedding_bag kernel (W&D) and the segment_sum kernels (W&D's
    backward, every GNN step).  Gloo stages CUDA tensors through host
    memory: its collective times are a check of correctness and
    contention, not NCCL's numbers."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sc_")
    data = _sc_data(torch, seed)
    job = {"dir": tmp, "data": os.path.join(tmp, "data.pkl"),
           "meshes": {f"{b}{w}": m for b, w, m in SC_RUNS},
           "cases": {f"{b}{w}": list(SC_NCCL_CASES if b == "nccl"
                                     else _sc_cells(torch))
                     for b, w, _ in SC_RUNS}}
    with open(job["data"], "wb") as f:
        pickle.dump(data, f)
    contexts = []
    try:
        # the rank processes start now (imports, the card's context) and
        # wait while this process runs the one-process cells
        for backend, world, _ in SC_RUNS:
            contexts.append(mp.start_processes(
                _sc_rank_main, args=(world, backend, job), nprocs=world,
                join=False, start_method="spawn"))
        cells = _sc_cells(torch)
        stage = {"calls": 0, "host_ms": 0.0}
        one = {}
        for name in cells:
            if name == SC_DECODE_CONTROL:
                one[name] = one["lm_decode_bf16"]
                continue
            one[name] = _sc_case(torch, name, None, data, cells, stage)
            if "samples" in one[name]:
                one[name]["samples"] = [
                    _sc_assemble([s], one[name]["plans"],
                                 one[name]["shapes"])
                    for s in one[name]["samples"]]
        _free(torch)
        parent_gib = (torch.cuda.memory_allocated() / 2**30,
                      torch.cuda.memory_reserved() / 2**30) \
            if DEVICE == "cuda" else None
        runs = {}
        for (backend, world, shape), ctx in zip(SC_RUNS, contexts):
            t0 = time.perf_counter()
            open(os.path.join(tmp, f"go_{backend}{world}"), "w").close()
            while not ctx.join():
                pass
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"sc{backend}{world}_{r}.pkl"),
                          "rb") as f:
                    ranks.append(pickle.load(f))
            runs[(backend, world)] = (ranks, time.perf_counter() - t0)
    finally:
        for ctx in contexts:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        shutil.rmtree(tmp, ignore_errors=True)

    cora = data["gin_cora"]
    d_cora = int(np.bincount(cora["edge_dst"][cora["edge_dst"] >= 0]).max())
    d_mol = int(np.bincount(data["nequip_molecule"]["edge_dst"][
        data["nequip_molecule"]["edge_dst"] >= 0]).max())
    # the GNN rule: a step's segment sums (its launches) of at most the
    # largest in-degree's terms, each reordered
    tols = {"gin_cora": d_cora, "gat_cora": d_cora, "nequip_molecule": d_mol}
    for name, res in one.items():
        res["lr"] = 1e-4 if name.startswith("lm") else 1e-3
        if name in tols:
            res["tol"] = _f32_tol(res["launches"]["segment_sum"],
                                  tols[name])

    problems, rows, launches = [], [], {"embedding_bag": [],
                                        "segment_sum": []}
    for (backend, world), (ranks, run_s) in runs.items():
        for name in job["cases"][f"{backend}{world}"]:
            per = [rk["cases"][name] for rk in ranks]
            want = one[name]
            row = {"run": f"{backend} x {world}", "case": name,
                   "mesh": list(job["meshes"][f"{backend}{world}"])}
            fields, more = _sc_check(name, per[0], want)
            row.update(fields)
            problems += [f"{backend} x {world}: {p}" for p in more]
            unit, n = {"wd_train": ("examples", WD_TRAIN_BATCH),
                       "wd_serve": ("examples", SC_WD_SERVE),
                       "gin_cora": ("edges", len(cora["edge_src"])),
                       "gat_cora": ("edges", len(cora["edge_src"])),
                       "nequip_molecule": ("edges", len(
                           data["nequip_molecule"]["edge_src"])),
                       "lm_check": ("tokens", np.prod(SC_LM_CHECK)),
                       "lm_decode": ("tokens", SC_LM_DECODE[0]),
                       "lm_decode_bf16": ("tokens", SC_LM_DECODE_BF16[0]),
                       SC_DECODE_WITNESS: ("tokens", SC_LM_DECODE_BF16[0]),
                       SC_DECODE_CONTROL: ("tokens", SC_LM_DECODE_BF16[0]),
                       "lm_run": ("tokens", np.prod(SC_LM_RUN))}[name]
            t_rank = [_pctl(p["step_s"][1:] or p["step_s"], .5) for p in per]
            t_one = _pctl(want["step_s"][1:] or want["step_s"], .5)
            row.update({
                f"{unit}_per_s": float(n / max(t_rank)),
                f"one_process_{unit}_per_s": float(n / t_one),
                "step_s": [p["step_s"] for p in per],
                "one_process_step_s": want["step_s"],
                "peak_gib": [p["peak_gib"] for p in per],
                "one_process_peak_gib": want["peak_gib"],
                "build_s": [p["build_s"] for p in per],
                "launches": [p["launches"] for p in per],
                "profiled_launches": [p["profiled_launches"] for p in per],
                "one_process_launches": want["launches"],
                "collective_calls_per_step":
                    per[0]["collective_calls_per_step"],
                "recorded_collectives_per_step":
                    per[0]["recorded_collectives_per_step"],
                "wire_bytes_per_step": per[0]["wire_bytes_per_step"],
                "first_step_s": [p["step_s"][0] for p in per],
                "collective_host_ms_per_step": [
                    p["collective_host_ms_per_step"] for p in per],
                "collective_device_ms_per_step": [
                    p["collective_device_ms_per_step"] for p in per]})
            if name in ("lm_check", "lm_run"):
                row["tokens_cut"] = {
                    "from": [LM_TRAIN_BATCH, 4096],
                    "to": list(SC_LM_CHECK if name == "lm_check"
                               else SC_LM_RUN),
                    "for": "time: float32 gathers cross the host"
                    if name == "lm_check" else
                    "memory: four ranks' peaks on one 80 GB card"}
            for p in per:
                for k in ("embedding_bag", "segment_sum"):
                    launches[k].append(p["launches"][k])
                if name.startswith("wd_") and p["launches"][
                        "embedding_bag"] < 1:
                    problems.append(f"{backend} x {world}: {name}: a rank "
                                    "launched no embedding_bag kernel")
                if (name == "wd_train" or name in tols) and p["launches"][
                        "segment_sum"] < 1:
                    problems.append(f"{backend} x {world}: {name}: a rank "
                                    "launched no segment_sum kernel")
                if p["launches"] != want["launches"]:
                    problems.append(f"{backend} x {world}: {name}: a rank "
                                    f"launched {p['launches']}, the "
                                    f"one-process cell {want['launches']}")
            rows.append(row)
    out = {"phase": "sharded_cells", "device": DEVICE,
           "card": _card_line() if DEVICE == "cuda" else None,
           "seconds": time.perf_counter() - t_phase,
           "runs": {f"{b} x {w}": {"mesh": list(m), "run_s": runs[(b, w)][1]}
                    for b, w, m in SC_RUNS},
           "parent_gib_allocated_reserved_during_ranks": parent_gib,
           "cases": rows,
           "note": "gloo stages CUDA tensors through host memory and its "
                   "ranks share one card: its times and collective ms are "
                   "a check of correctness and contention, not NCCL's; "
                   "ogb_products on ranks waits for the 4-chip cell (four "
                   "ranks on one card would hold four replicas' node "
                   "arrays)"}
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out, {k: sum(v) for k, v in launches.items()}


# --------------------------------------------------------------------- #
# substrate: Wide&Deep serving (embedding_bag), GIN inference (segment_sum)
# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# sjtree: the paper's baseline against the timing-aware engine
# --------------------------------------------------------------------- #
SJTREE_TENANTS = (0, 8)        # tenants(): the 3-edge chain, a two-chain
SJTREE_SWEEP = (4, 2, 1)       # windows: the reckoned largest / 4, / 2, / 1
SJTREE_REF_TICKS = 16          # the REF run's ticks
_NODE_BYTES_MSTREE = 4 * 4 + 1  # src, dst, ts, parent, valid


def _row_bytes(plan, mode: str) -> list:
    """Bytes of one live row of each table, in state order (each
    subquery's levels, then the L0 tables), under a storage model: the
    formula of ``benchmarks/common.py`` ``state_bytes`` (paper Figures
    16-17).  ``mstree``: an expansion-list node stores (src, dst, ts,
    parent); ``ind``: a partial match stores its full bindings and one ts
    per edge (Timing-IND, the SJ-tree's model)."""
    out = []
    for s in plan.subqueries:
        for li, lv in enumerate(s.levels):
            out.append(_NODE_BYTES_MSTREE if mode == "mstree"
                       else (len(lv.vertex_layout) + li + 1) * 4 + 1)
    for js in plan.l0_joins:
        out.append((len(js.vertex_layout) + len(js.edge_layout)) * 4 + 1)
    return out


def _table_rows(torch, state):
    """Live rows of each table in state order, one int64 tensor on the
    state's device (no host read)."""
    return torch.stack([t.valid.sum() for sub in state.levels for t in sub]
                       + [t.valid.sum() for t in state.l0])


def _table_patterns(plan) -> list:
    """The query edges each table's rows bind, in state order: level li of
    a subquery binds the first li + 1 edges of its timing order, L0 table
    i the edges of subqueries 0..i+1."""
    out = []
    for s in plan.subqueries:
        for li in range(len(s.levels)):
            out.append(frozenset(lv.qedge for lv in s.levels[:li + 1]))
    acc = {lv.qedge for lv in plan.subqueries[0].levels}
    for gi in range(len(plan.l0_joins)):
        acc |= {lv.qedge for lv in plan.subqueries[gi + 1].levels}
        out.append(frozenset(acc))
    return out


def _hom_rows(q, pattern, edges, n_v: int) -> float:
    """Rows a table over the query edges ``pattern`` (a tree) can hold
    when ``edges[e]`` = (src, dst) are the live data edges matching query
    edge e: the homomorphisms of the pattern, counted by a tree sum over
    per-vertex counts (``np.bincount``).  Injectivity, the timing order
    and the join window only remove rows, so this bounds every engine's
    table over that pattern from above."""
    import numpy as np

    def down(v, via):
        w = np.ones(n_v)
        for e in pattern:
            a, b = q.edges[e]
            if e == via or v not in (a, b):
                continue
            src, dst = edges[e]
            if a == v:
                w *= np.bincount(src, weights=down(b, e)[dst], minlength=n_v)
            else:
                w *= np.bincount(dst, weights=down(a, e)[src], minlength=n_v)
        return w

    return float(down(q.edges[min(pattern)][0], None).sum())


def sjtree_reckoning(q, plans, arrays, window: int, batch: int) -> dict:
    """Upper bounds, over the ticks of ``batch`` edges of the stream
    ``arrays`` (src, dst, ts, src_label, dst_label, edge_label; ts
    non-decreasing), of every table of ``plans`` at ``window``: the most
    rows a table holds before a tick's expiry (the edges live after the
    last tick's expiry plus the tick's own) and the most rows it appends
    in a tick (rows that use a new edge).  -> {"rows": [per table],
    "appends": [per table], per plan in order}."""
    import numpy as np

    src, dst, ts, sl, dl, el = arrays
    qe = {}
    for e, (a, b) in enumerate(q.edges):
        # the engine's label match (``edge_match_mask``): no self-loops,
        # an edge label below 0 is a wildcard
        lab = q.edge_labels[e]
        qe[e] = np.flatnonzero((sl == q.vertex_labels[a])
                               & (dl == q.vertex_labels[b])
                               & ((el == lab) | (lab < 0)) & (src != dst))
    pos = np.unique(np.concatenate([src[m] for m in qe.values()]
                                   + [dst[m] for m in qe.values()]))
    n_v = len(pos)
    cs = {e: np.searchsorted(pos, src[m]) for e, m in qe.items()}
    cd = {e: np.searchsorted(pos, dst[m]) for e, m in qe.items()}
    patterns = sorted({p for plan in plans for p in _table_patterns(plan)},
                      key=sorted)
    rows = {p: 0.0 for p in patterns}
    appends = {p: 0.0 for p in patterns}
    t_prev = None
    for lo in range(0, len(ts), batch):
        hi = min(lo + batch, len(ts))
        live, grown = {}, {}
        for e, m in qe.items():
            keep = m < hi
            if t_prev is not None:
                keep &= (m >= lo) | (ts[m] >= t_prev - window)
            else:
                keep &= m >= lo
            old = keep & (m < lo)
            grown[e] = (cs[e][keep], cd[e][keep])
            live[e] = (cs[e][old], cd[e][old])
        for p in patterns:
            after = _hom_rows(q, p, grown, n_v)
            rows[p] = max(rows[p], after)
            appends[p] = max(appends[p], after - _hom_rows(q, p, live, n_v))
        t_prev = int(ts[hi - 1])
    return [{"rows": [rows[p] for p in _table_patterns(plan)],
             "appends": [appends[p] for p in _table_patterns(plan)]}
            for plan in plans]


def _fits(reck, cap: int, max_new: int) -> bool:
    return all(r <= cap for x in reck for r in x["rows"]) \
        and all(a <= max_new for x in reck for a in x["appends"])


def sjtree_window(q, arrays, batch: int, cap: int, max_new: int,
                  hi: int) -> tuple:
    """The largest window (timestamp units, at most ``hi``) at which every
    table of the SJ-tree and of the timing-aware engine over ``q`` stays
    within ``cap`` rows and ``max_new`` appends a tick, by bisection over
    ``sjtree_reckoning``.  -> (window, its reckoning)."""
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.sjtree import compile_sjtree_plan

    kw = dict(level_capacity=cap, l0_capacity=cap, max_new=max_new)

    def reck(w):
        return sjtree_reckoning(q, [compile_plan(q, w, **kw),
                                    compile_sjtree_plan(q, w, **kw)[0]],
                                arrays, w, batch)

    lo, good = 1, reck(1)
    if not _fits(good, cap, max_new):
        fail(f"sjtree: no window keeps {q.edges}'s tables within {cap} "
             f"rows and {max_new} appends")
    while hi - lo > max(1, lo // 64):
        mid = (lo + hi) // 2
        r = reck(mid)
        if _fits(r, cap, max_new):
            lo, good = mid, r
        else:
            hi = mid
    return lo, good


def _canon(plan, res, trel=None):
    """One tick's emitted matches as a multiset of rows in query-edge order
    ((src, dst, ts) per query edge), post-filtered by ``trel`` (the
    SJ-tree's) when given."""
    from repro_torch.core.sjtree import timing_postfilter

    bind, ets, valid = (x.cpu().numpy() for x in (
        res.match_bindings, res.match_ets, res.match_valid))
    if trel is not None:
        valid = timing_postfilter(ets, valid, trel)
    return _canon_rows(plan, bind[valid], ets[valid])


def _canon_rows(plan, bind, ets) -> Counter:
    import numpy as np

    q = plan.query
    vcol = {v: i for i, v in enumerate(plan.final_vertex_layout)}
    ecol = {e: i for i, e in enumerate(plan.final_edge_layout)}
    cols = []
    for e, (a, b) in enumerate(q.edges):
        cols += [bind[:, vcol[a]], bind[:, vcol[b]], ets[:, ecol[e]]]
    rows = np.stack(cols, 1) if len(bind) else np.zeros((0, 3 * q.n_edges))
    return Counter(map(tuple, rows.tolist()))


def _sjtree_run(torch, plan, batches, trel=None, snap_at=None):
    """Drive one engine (CUDA) over ``batches``: wall seconds (host clock,
    one synchronise at the end; the per-tick table counts are device
    reductions read after the run), the per-tick table rows, the
    per-tick emitted multisets (post-filtered by ``trel``), the final
    state, the state after ``snap_at`` ticks and the pair launches by
    slot count."""
    from repro_torch.core.engine import build_tick
    from repro_torch.core.state import init_state, map_state
    from repro_torch.kernels.compat_join import ops

    tick = build_tick(plan, device=DEVICE)
    state = init_state(plan, device=DEVICE)
    state, _ = tick(state, batches[0])           # warm-up, not counted
    state = init_state(plan, device=DEVICE)
    _sync(torch)
    ops.compat_join_pairs.launches_by_slots = Counter()
    counts, results, snap = [], [], None
    t0 = time.perf_counter()
    for t, b in enumerate(batches):
        state, res = tick(state, b)
        counts.append(_table_rows(torch, state))
        results.append(res)
        if snap_at == t + 1:
            snap = map_state(lambda x: x.clone(), state)
    _sync(torch)
    wall = time.perf_counter() - t0
    by_slots = dict(ops.compat_join_pairs.launches_by_slots)
    rows = torch.stack(counts).cpu().numpy()
    emitted = [_canon(plan, r, trel) for r in results]
    return wall, rows, emitted, state, snap, by_slots


def phase_sjtree(torch, args, stream):
    """The paper's headline comparison (Figures 14-17) on the card: the
    SJ-tree baseline (``core.sjtree``: every edge its own leaf, timing
    checked only by a host post-filter) against the timing-aware engine,
    both through ``build_tick``/``init_state`` on the CUDA backend, for
    the serve phase's two structures (``tenants()``'s chain and
    two-chain), its capacities (65,536 rows, ``max_new`` 8,192) and its
    stream, at three windows each: the largest window at which every
    table of both engines stays within the capacities, reckoned on the
    host before the run (``sjtree_window``: per-vertex label counts of the
    stream, an upper bound), and its half and quarter.  Checks: overflow
    0 in both; each tick's post-filtered SJ-tree matches equal the
    timing-aware engine's as multisets, and the final current matches;
    the CUDA SJ-tree's tables equal a REF run's over the first 16 ticks
    at the largest window; every SJ-tree pair launch at S = 1, two per L0
    join a tick.  Prints edges/s and the average live bytes a tick
    (``mstree`` and ``ind`` for the timing-aware engine, ``ind`` for the
    SJ-tree) at each window."""
    import numpy as np

    from repro_torch.core.engine import build_tick, current_matches, \
        matches_from_rows
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.sjtree import compile_sjtree_plan, \
        timing_postfilter
    from repro_torch.core.state import init_state, make_batch
    from repro_torch.stream.generator import to_batches

    batches = [make_batch(**b, device=DEVICE)
               for b in to_batches(stream, BATCH)]
    arrays = tuple(np.array([getattr(e, k) for e in stream], np.int64)
                   for k in ("src", "dst", "ts", "src_label", "dst_label",
                             "edge_label"))
    n_edges = len(stream)
    kw = dict(level_capacity=LEVEL_CAP, l0_capacity=LEVEL_CAP,
              max_new=MAX_NEW)
    out = {"phase": "sjtree", "ticks": len(batches), "edges": n_edges,
           "capacity": LEVEL_CAP, "max_new": MAX_NEW, "queries": []}
    launches_sj, by_slots_sj, problems = 0, Counter(), []
    for ti in SJTREE_TENANTS:
        kind, q, _ = tenants(stream)[ti]
        t0 = time.perf_counter()
        w_max, reck = sjtree_window(q, arrays, BATCH, LEVEL_CAP, MAX_NEW,
                                    int(arrays[2][-1] - arrays[2][0]) + 1)
        qout = {"tenant": ti, "structure": kind,
                "query_edges": [list(e) for e in q.edges],
                "reckoning_s": time.perf_counter() - t0,
                "window_max": w_max,
                "reckoned_at_max": {
                    "timing_rows": reck[0]["rows"],
                    "timing_appends": reck[0]["appends"],
                    "sjtree_rows": reck[1]["rows"],
                    "sjtree_appends": reck[1]["appends"]},
                "windows": []}
        for div in SJTREE_SWEEP:
            w = w_max // div
            plan = compile_plan(q, w, **kw)
            sj_plan, trel = compile_sjtree_plan(q, w, **kw)
            pairs = max([js.capacity * js.max_new
                         for js in sj_plan.l0_joins] or [0])
            if pairs - MAX_NEW >= 2**31:
                fail(f"sjtree: an L0 delta join of {pairs} pairs")
            _free(torch)
            t_wall, t_rows, t_emit, t_state, _, _ = _sjtree_run(
                torch, plan, batches)
            snap_at = SJTREE_REF_TICKS if div == 1 else None
            s_wall, s_rows, s_emit, s_state, s_snap, s_slots = _sjtree_run(
                torch, sj_plan, batches, trel, snap_at)
            per_tick = 2 * len(sj_plan.l0_joins) * len(batches)
            if s_slots != {1: per_tick}:
                problems.append(f"sjtree {kind} w={w}: pair launches by "
                                f"slots {s_slots}, not {{1: {per_tick}}}")
            launches_sj += sum(s_slots.values())
            by_slots_sj.update(s_slots)
            ov = (int(t_state.stats.n_overflow), int(s_state.stats.n_overflow))
            if ov != (0, 0):
                problems.append(f"sjtree {kind} w={w}: overflow {ov}")
            bad = [t for t, (a, b) in enumerate(zip(t_emit, s_emit)) if a != b]
            if bad:
                problems.append(f"sjtree {kind} w={w}: post-filtered matches "
                                f"differ from the engine's at ticks {bad[:8]}")
            tbl = s_state.l0[-1]
            ok = timing_postfilter(tbl.ets.cpu().numpy(),
                                   tbl.valid.cpu().numpy(), trel)
            if matches_from_rows(sj_plan, tbl.bindings.cpu().numpy(),
                                 tbl.ets.cpu().numpy(), ok) \
                    != current_matches(plan, t_state):
                problems.append(f"sjtree {kind} w={w}: current matches "
                                "differ")
            n_match = sum(sum(c.values()) for c in t_emit)
            if div == 1:
                # the REF SJ-tree over the first ticks: identical tables
                ref_tick = build_tick(sj_plan, backend="ref", device=DEVICE)
                rs = init_state(sj_plan, device=DEVICE)
                for b in batches[:SJTREE_REF_TICKS]:
                    rs, _ = ref_tick(rs, b)
                a, b = _flat(s_snap), _flat(rs)
                if len(a) != len(b) or not all(
                        x.shape == y.shape and torch.equal(x, y)
                        for x, y in zip(a, b)):
                    problems.append(f"sjtree {kind}: CUDA tables after "
                                    f"{SJTREE_REF_TICKS} ticks != REF")
                qout["ref_leaves_equal"] = len(a)
                del rs, s_snap
            tb = {m: float((t_rows @ np.array(_row_bytes(plan, m))).mean())
                  for m in ("mstree", "ind")}
            sb = float((s_rows @ np.array(_row_bytes(sj_plan, "ind"))).mean())
            qout["windows"].append({
                "window": w, "matches": n_match,
                "timing": {"edges_per_s": n_edges / t_wall, "wall_s": t_wall,
                           "avg_bytes_mstree": tb["mstree"],
                           "avg_bytes_ind": tb["ind"],
                           "max_rows": t_rows.max(0).tolist()},
                "sjtree": {"edges_per_s": n_edges / s_wall, "wall_s": s_wall,
                           "avg_bytes_ind": sb,
                           "max_rows": s_rows.max(0).tolist(),
                           "pair_launches_by_slots": {
                               str(k): v for k, v in s_slots.items()}},
                "sjtree_over_timing_ind_bytes": sb / max(tb["ind"], 1.0),
                "sjtree_over_timing_mstree_bytes":
                    sb / max(tb["mstree"], 1.0),
                "overflow": list(ov)})
            del t_state, s_state, t_emit, s_emit
        out["queries"].append(qout)
    out["pair_launches_sjtree"] = launches_sj
    emit(out)
    if problems:
        fail("; ".join(problems))
    _free(torch)
    return out, launches_sj, dict(by_slots_sj)


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


def start_products_graph(seed: int):
    """Start making the ogbn-products-shaped graph's host arrays
    (``synth_products_like``: Pareto 1.2 popularity, ``GIN_NODES`` nodes,
    ``GIN_DEGREE`` edges per node, 100 features, 47 classes, the node
    labels) in a thread, so that it runs while nvcc builds the kernels
    (numpy's sampling and sorting release the GIL).  Returns a function
    that waits for it and gives (arrays, seconds the making took)."""
    import threading

    from repro_torch.data.graphs import synth_products_like

    box = {}

    def make():
        t0 = time.perf_counter()
        try:
            box["g"] = synth_products_like(
                n_nodes=GIN_NODES, avg_degree=GIN_DEGREE, d_feat=GIN_FEAT,
                n_classes=GIN_CLASSES, seed=seed)
        except BaseException as e:      # raised again in the caller
            box["error"] = e
        box["make_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=make, name="products-graph",
                              daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["g"], box["make_s"]

    return wait


def make_products_graph(torch, host, make_s: float):
    """The products graph from ``start_products_graph``'s host arrays,
    moved to the card; ``host_make_s`` is the making's own time."""
    from repro_torch.data.graphs import graph_to_device

    g = graph_to_device({k: host[k] for k in ("x", "edge_src", "edge_dst",
                                              "labels")}, DEVICE)
    deg = torch.bincount(g["edge_dst"].long(), minlength=GIN_NODES)
    info = {"nodes": GIN_NODES, "edges": g["edge_src"].numel(),
            "host_make_s": make_s, "max_in_degree": int(deg.max())}
    return g, info


def _abs_sums(torch, dst, msg, n_nodes, chunk_elems: int = 1 << 28):
    """Per node, the float32 sum of |msg| over its edges (chunked over
    edges to bound the float32 copy to 1 GiB)."""
    seg = torch.where((dst >= 0) & (dst < n_nodes), dst, n_nodes).long()
    acc = torch.zeros((n_nodes + 1, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    chunk = max(1, chunk_elems // msg.shape[1])
    for lo in range(0, msg.shape[0], chunk):
        acc.index_add_(0, seg[lo:lo + chunk],
                       msg[lo:lo + chunk].float().abs())
    return acc[:n_nodes]


def make_molecules(seed: int) -> dict:
    """The ``molecule`` shape (configs/registry.py gnn_shapes: 128
    molecules of 30 atoms and 64 directed edges) as numpy arrays, made
    from ``seed``: each molecule a chain of atoms 1.5 A apart in random
    directions, no two atoms closer than 1 A; its 64 edges drawn without
    replacement among the ordered pairs of atoms within the cutoff
    (5 A); species uniform over the config's 16.  Atom and edge blocks
    follow molecule order; ``graph_ids`` names each atom's molecule."""
    import numpy as np

    from repro_torch.configs.nequip import CONFIG

    rng = np.random.default_rng(seed)
    pos = np.zeros((MOL_BATCH, MOL_ATOMS, 3))
    src, dst = [], []
    for m in range(MOL_BATCH):
        for i in range(1, MOL_ATOMS):
            while True:
                step = rng.standard_normal(3)
                p = pos[m, i - 1] + 1.5 * step / np.linalg.norm(step)
                if np.linalg.norm(pos[m, :i] - p, axis=-1).min() >= 1.0:
                    break
            pos[m, i] = p
        d = np.linalg.norm(pos[m][:, None] - pos[m][None], axis=-1)
        a, b = np.nonzero((d < CONFIG.cutoff) & (d > 0))
        take = rng.choice(len(a), MOL_EDGES, replace=False)
        src.append(a[take] + m * MOL_ATOMS)
        dst.append(b[take] + m * MOL_ATOMS)
    return {"species": rng.integers(0, CONFIG.n_species,
                                    MOL_BATCH * MOL_ATOMS).astype(np.int32),
            "pos": pos.reshape(-1, 3).astype(np.float32),
            "edge_src": np.concatenate(src).astype(np.int32),
            "edge_dst": np.concatenate(dst).astype(np.int32),
            "graph_ids": np.repeat(np.arange(MOL_BATCH),
                                   MOL_ATOMS).astype(np.int32),
            "n_graphs": MOL_BATCH}


def phase_segment_sum(torch, seed: int, g, max_in_degree: int):
    """The segment_sum kernel against its plain version at the GNN paths'
    shapes on the products graph: GIN's layer 1 messages (E x 100, bf16)
    and a later layer's (E x 64, bf16), E x 64 float32 messages of small
    integers, the later layer's messages with ``dst`` drawn uniformly
    from [0, N) instead (the same work without the Pareto hubs), the
    same messages with ``dst`` uniform over ``SEG_WIDE_NODES`` nodes,
    ``segment_mean``'s count column (E x 1 float32 ones); GAT's
    layer 1 (E x 8 heads x 8, bf16) and layer 2 (E x 8 heads x 47 =
    376, bf16) and PNA's (E x 75 ReLU'd rows, bf16: 150-byte rows, the
    plan's 2-byte loads); and NequIP's l = 0/1/2 sums (32, 96, 288
    float32 columns of small integers) over the molecule batch's 8,192
    edges into 3,840 atoms.

    The kernel sums in float32 in one fixed order (its source's header:
    each node's edges in index order, in runs of ``ref.RUN``), the plain
    version in float64, and a hub row sums ~10^6 messages, so the two
    differ by up to the recursive-summation bound, 2 x deg x 2^-24 x
    (sum of |msg| into the row), plus one bf16 rounding (rtol 1e-2): the
    bf16 cases are held to that bound per element.  Integer messages
    (|m| <= 4, 4 x max in-degree < 2^24) sum exactly in any order, so
    the float32 cases must equal the plain version element for element.
    Each case also holds the kernel's bits: equal to
    ``ref.segment_sum_ordered`` (the same order in plain torch) where its
    float32 run sums fit beside the case (``_ordered_fits``), equal on a
    second call, and equal after a permutation of the edges that keeps
    each node's edges in their order (``_order_keeping_call``); a case
    with a hub of more than ``ref.RUN`` edges and one of more than one
    column chunk must have held the first.  Library
    yardstick: ``index_add_`` into a float32 accumulator, on float32
    messages; at GAT's layer 2 a float32 copy of the message (92 GB)
    does not fit beside it, so there ``index_add_`` sums the bf16
    message into a bf16 accumulator (``library_call`` says which).  The
    plain version sums in float64, so beside the kernel's error each case
    also gives the library call's (its result in the message dtype
    against the plain version's: what float32 or bf16 atomics lose).
    Each case's device time is also broken down by kernel
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
    mol = make_molecules(seed)
    mol_dst = torch.as_tensor(mol["edge_dst"], device=DEVICE)
    mol_n, mol_e = len(mol["species"]), len(mol["edge_dst"])

    def rows(d, relu=False):           # N(0, 1) node rows [N, d] -> [E, d]
        def make():
            h = torch.randn((n_graph, d), generator=gen, device=DEVICE)
            return (h.relu_() if relu else h).bfloat16()[src]
        return make

    def mol_ints(d):
        return lambda: torch.randint(-4, 5, (mol_e, d), generator=gen,
                                     device=DEVICE, dtype=torch.float32)

    specs = [
        ("gin_l1_bf16", n_graph, dst, lambda: g["x"].bfloat16()[src], 1e-2),
        ("gin_l2_bf16", n_graph, dst, lambda: h64.bfloat16()[src], 1e-2),
        ("f32_d64_exact", n_graph, dst, lambda: ints[src], None),
        ("uniform_d64_bf16", n_graph, uniform,
         lambda: h64.bfloat16()[src], 1e-2),
        ("uniform_4m_nodes_d64_bf16", SEG_WIDE_NODES, uniform_wide,
         lambda: h64.bfloat16()[src], 1e-2),
        ("d1_counts", n_graph, dst,
         lambda: torch.ones((e, 1), device=DEVICE), None),
        ("gat_l1_bf16", n_graph, dst, rows(64), 1e-2),
        ("gat_l2_bf16", n_graph, dst, rows(376), 1e-2),
        ("pna_bf16", n_graph, dst, rows(75, relu=True), 1e-2),
        ("nequip_l0_f32", mol_n, mol_dst, mol_ints(32), None),
        ("nequip_l1_f32", mol_n, mol_dst, mol_ints(96), None),
        ("nequip_l2_f32", mol_n, mol_dst, mol_ints(288), None)]
    results, ordered_held = [], set()
    for name, n, dst, make, rtol in specs:
        msg = make()
        e = msg.shape[0]
        plan = kernel.plan(e, n, msg.shape[1], msg.element_size(),
                           msg.data_ptr() % 16)
        got = ops.segment_sum(dst, msg, n)
        bits = {"repeat_equal": torch.equal(got, ops.segment_sum(dst, msg,
                                                                 n))}
        fits, need = _ordered_fits(torch, dst, msg, n)
        if fits:
            bits["ordered_equal"] = torch.equal(
                got, ref.segment_sum_ordered(dst, msg, n))
            deg_max = int(torch.bincount(dst[(dst >= 0) & (dst < n)].long(),
                                         minlength=n).max())
            if bits["ordered_equal"] and deg_max > ref.RUN:
                ordered_held.add("hub")
            if bits["ordered_equal"] and plan.n_cc > 1:
                ordered_held.add("column chunks")
        else:
            bits["ordered_equal"] = (
                f"skipped: its float32 run sums and node sums need {need} "
                f"bytes beside the case, "
                f"{torch.cuda.mem_get_info()[0]} free")
        _free(torch)
        want = ref.segment_sum(dst, msg, n)
        _sync(torch)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if rtol is None:
            bad = int((diff > 0).sum())
        else:
            deg = torch.bincount(dst[dst >= 0].long(), minlength=n)[:n, None]
            tol = _abs_sums(torch, dst, msg, n).mul_(deg * 2.0**-23)
            tol.add_(want.float().abs(), alpha=rtol)
            bad = int((diff > tol).sum())
            del tol, deg
        if got.dtype != msg.dtype or got.shape != want.shape or bad:
            fail(f"segment_sum case {name}: kernel != plain (max |err| "
                 f"{err}, {bad} elements out of tolerance)")
        if not (bits["repeat_equal"] and bits["ordered_equal"] is not False):
            fail(f"segment_sum case {name}: the kernel's bits differ from "
                 f"its order or from its own second call: {bits}")
        del diff
        seg = torch.where((dst >= 0) & (dst < n), dst, n).long()
        wide = msg.numel() * 4 > 40e9           # no float32 copy beside it
        lib_msg = msg if wide else msg.float()

        def library():
            return torch.zeros((n + 1, msg.shape[1]), dtype=lib_msg.dtype,
                               device=DEVICE).index_add_(0, seg, lib_msg)

        lib_out = library()[:n].to(msg.dtype)
        lib_err = (_max_err(torch, lib_out, want), _rel_err(lib_out, want),
                   _rel_err(got, want))
        del want, lib_out
        ms = _time_ms(torch, lambda: ops.segment_sum(dst, msg, n), REPS)
        plain_ms = _time_ms(torch, lambda: ref.segment_sum(dst, msg, n),
                            PLAIN_REPS)
        library_ms = _time_ms(torch, library, REPS)
        d = msg.shape[1]
        nbytes = 4 * e + e * d * msg.element_size() \
            + n * d * msg.element_size()
        bound_ms, bound_by = _bound(nbytes, e * d, FP32_ADDS_PER_S)
        row = {
            "case": name, "edges": e, "nodes": n, "dim": d,
            "dtype": str(msg.dtype).replace("torch.", ""), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "index_add_ " + (
                "bf16 message into bf16" if wide else "float32 into float32"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "operations": e * d, "max_abs_err": err,
            "rel_err": lib_err[2], "library_max_abs_err": lib_err[0],
            "library_rel_err": lib_err[1],
            "radix_passes": plan.passes, "column_chunks": plan.n_cc,
            "load_bytes": plan.vec, **bits,
            "tolerance": ("equal" if rtol is None else
                          f"rtol {rtol} + 2 deg 2^-24 sum|msg|")}
        dev_ms, by_kernel, _ = _any_profile(
            torch, lambda: ops.segment_sum(dst, msg, n), 3)
        row.update(device_ms=dev_ms, device_ms_by_kernel=by_kernel)
        del lib_msg, seg
        _free(torch)
        row["permutation"], same = _order_keeping_call(torch, gen, dst, msg,
                                                       n, got)
        row["permutation_equal"] = same
        if not same:
            fail(f"segment_sum case {name}: an order-keeping permutation "
                 f"({row['permutation']}) changed the kernel's bits")
        results.append(row)
        del msg, got
        _free(torch)
    if ordered_held != {"hub", "column chunks"}:
        fail(f"segment_sum cases: the kernel was held to its order bit for "
             f"bit only where {sorted(ordered_held)}")
    emit({"phase": "segment_sum_cases", "kernel": "segment_sum",
          "reps": REPS, "plain_reps": PLAIN_REPS, "cases": results})
    return results


def _ordered_fits(torch, dst, msg, n_nodes) -> tuple:
    """Whether ``ref.segment_sum_ordered``'s float32 arrays (a row of D
    for each run and each node, and a gather of at most
    ``ref.CHUNK_ELEMS`` values) fit in the card's free memory with 4 GiB
    to spare: (fits, bytes needed)."""
    from repro_torch.kernels.segment_reduce import ref

    ok = (dst >= 0) & (dst < n_nodes)
    cnt = torch.bincount(dst[ok].long(), minlength=n_nodes)
    runs = int(((cnt + ref.RUN - 1) // ref.RUN).sum())
    d = msg.shape[1]
    need = 4 * d * (runs + 2 * n_nodes) + 8 * ref.CHUNK_ELEMS \
        + 96 * dst.numel()
    return need + (4 << 30) < torch.cuda.mem_get_info()[0], need


def _order_keeping_call(torch, gen, dst, msg, n_nodes, got) -> tuple:
    """The kernel on a permutation of the edges that keeps each node's
    edges in their order; (which permutation, whether its bits equal
    ``got``).  Where a permuted copy of the message fits beside it, the
    edges are grouped by node in a random order of the nodes; otherwise
    (GAT's 46 GB layer 2) the even edges trade places with the next one
    where the two go to different nodes, in place, and back after."""
    from repro_torch.kernels.segment_reduce import ops

    n = dst.numel()
    if 2 * msg.numel() * msg.element_size() + (8 << 30) \
            < torch.cuda.mem_get_info()[0]:
        seg = torch.where((dst >= 0) & (dst < n_nodes), dst,
                          n_nodes).long()
        rank = torch.randperm(n_nodes + 1, generator=gen, device=DEVICE)
        perm = torch.argsort(rank[seg], stable=True)
        out = ops.segment_sum(dst[perm], msg[perm], n_nodes)
        kind = "edges grouped by node, the nodes in a random order"
    else:
        even = torch.arange(0, n - 1, 2, device=DEVICE)
        even = even[dst[even] != dst[even + 1]]
        swapped = dst.clone()
        swapped[even], swapped[even + 1] = dst[even + 1], dst[even]
        rows = max(1, (1 << 28) // msg.shape[1])

        def trade():
            for lo in range(0, even.numel(), rows):
                a = even[lo:lo + rows]
                tmp = msg[a].clone()
                msg[a] = msg[a + 1]
                msg[a + 1] = tmp
        trade()
        out = ops.segment_sum(swapped, msg, n_nodes)
        trade()
        kind = (f"{even.numel()} pairs of neighbouring edges of different "
                f"nodes traded, in place")
    same = torch.equal(out, got)
    del out
    return kind, same


def _infer(torch, model, g, forwards: int):
    """One warm-up forward of ``model`` over ``g``, then ``forwards``
    timed forwards (inference mode; host clock around each, ending in a
    synchronise), the segment_sum launch count zeroed just before them
    and read just after, the peak memory over all of them; then one
    forward on the plain version (``backend = "ref"``) on the card.
    Returns (logits, forward seconds, launches, peak GiB, plain logits,
    plain seconds)."""
    from repro_torch.kernels.segment_reduce import ops

    if model.backend != "cuda":
        fail(f"{type(model).__name__}'s default backend is {model.backend}, "
             "not cuda")
    _reset_peak(torch)
    with torch.inference_mode():
        model(g)                                     # warm-up, not counted
        _sync(torch)
        ops.segment_sum.launches = 0
        times = []
        for _ in range(forwards):
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
    return logits, times, launches, peak, want, plain_s


def _rel_err(logits, want) -> float:
    return float((logits.float() - want.float()).norm()
                 / want.float().norm())


def _infer_checks(torch, what, logits, want, shape, launches, expected):
    """The error fields of ``logits`` against the plain forward's, and
    what is wrong: logits not finite or not of ``shape``, the kernel not
    launched ``expected`` times, a relative Frobenius error past 1e-2
    (bf16 activations, one rounding per op; the kernel's float32 sums
    and the plain version's float64 sums can round to neighbouring bf16
    values, and GAT's bf16 softmax denominators are ``index_add_``
    atomics, whose order changes from run to run)."""
    rel = _rel_err(logits, want)
    problems = []
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits)
                                                .all()):
        problems.append(f"{what} logits {tuple(logits.shape)} not finite "
                        f"or not {shape}")
    if launches != expected:
        problems.append(f"{what} launched segment_sum {launches} times, "
                        f"not {expected}")
    if not rel <= 1e-2:
        problems.append(f"{what} logits differ from the plain forward "
                        f"(rel err {rel})")
    return {"logits_rel_err": rel,
            "logits_max_abs_err": _max_err(torch, logits, want),
            "argmax_agreement": float((logits.argmax(1) == want.argmax(1))
                                      .float().mean())}, problems


def _products_cfg(torch, config):
    """The reference's ogb_products cell rule (src/repro/launch/cells.py
    _gnn_cell): the products widths (100 features, 47 classes) and bf16
    activations on a full-graph-large shape."""
    import dataclasses

    return dataclasses.replace(config, d_in=GIN_FEAT, n_classes=GIN_CLASSES,
                               dtype=torch.bfloat16)


def phase_gin_infer(torch, seed: int, g, graph_info):
    """GIN inference at the gin-tu config (5 layers, 64 hidden) with the
    products graph's widths (100 features, 47 classes), bf16 activations
    as the reference's cell for that shape has them; random weights from
    a seeded generator.  ``GNN_FORWARDS`` timed forwards after one
    warm-up, the segment_sum launch count zeroed just before and read
    just after.  The logits are held against the plain-version forward:
    relative Frobenius error <= 1e-2 (bf16 activations, one rounding
    per op; the kernel's float32 sums round to bf16 at other places)."""
    from repro_torch.configs.gin_tu import CONFIG
    from repro_torch.models.gnn.models import GIN

    cfg = _products_cfg(torch, CONFIG)
    model = GIN(cfg, device=DEVICE, seed=seed)
    logits, times, launches, peak, want, plain_s = _infer(
        torch, model, g, GNN_FORWARDS)
    n = g["x"].shape[0]
    out = {"phase": "gin_infer", "config": cfg.name, "layers": cfg.n_layers,
           "hidden": cfg.d_hidden, "dtype": "bfloat16", **graph_info,
           "forwards": GNN_FORWARDS, "forward_s": sorted(times),
           "forward_s_median": _pctl(times, .5),
           "nodes_per_s": n / _pctl(times, .5),
           "edges_per_s": graph_info["edges"] / _pctl(times, .5),
           "plain_forward_s": plain_s, "segment_sum_launches": launches,
           "peak_mem_gib": peak}
    fields, problems = _infer_checks(torch, "GIN", logits, want,
                                     (n, GIN_CLASSES), launches,
                                     cfg.n_layers * GNN_FORWARDS)
    out.update(fields)
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out, launches


def _deterministic_pair(torch, model, g):
    """GAT's forward through the kernel and on the plain version, both
    under ``torch.use_deterministic_algorithms`` (warnings only): its
    bf16 softmax denominators are ``index_add_`` atomics, whose order,
    and so whose bf16 roundings, change from run to run (the reference's
    semantics); deterministic, ``index_add_`` sums in a sorted order, so
    the two forwards share their attention weights and differ only in
    their segment sums.  Returns (kernel logits, plain logits)."""
    import warnings

    backend = model.backend
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(), torch.inference_mode():
            warnings.simplefilter("ignore", UserWarning)
            got = model(g)
            model.backend = "ref"
            want = model(g)
            _sync(torch)
    finally:
        torch.use_deterministic_algorithms(False)
        model.backend = backend
    return got, want


def _default_mode(torch, model, g, logits, want) -> dict:
    """The timed forward's difference from the plain forward, both in the
    default (atomic) mode, beside a second plain forward's: how far the
    bf16 softmax's atomics alone move GAT's logits."""
    with torch.inference_mode():
        backend, model.backend = model.backend, "ref"
        again = model(g)
        model.backend = backend
    return {"logits_rel_err": _rel_err(logits, want),
            "plain_vs_plain_rel_err": _rel_err(again, want)}


def _softmax_at_hubs(torch, seed: int, g):
    """What the ported ``segment_softmax`` does in bf16 on this graph:
    N(0, 1) scores [E, 8] in bf16 softmaxed over each node's in-edges;
    the weights into a node should sum to 1.  Its denominators are
    ``index_add_`` in bf16 (the reference's semantics too), which stops
    growing once a sum's ulp passes twice the next term: the sums at the
    largest hub and the worst node, beside the float32 softmax's."""
    from repro_torch.models.gnn.message import segment_softmax

    n = g["x"].shape[0]
    dst = g["edge_dst"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    scores = torch.randn((dst.numel(), 8), generator=gen, device=DEVICE)
    hub = int(torch.bincount(dst.long(), minlength=n).argmax())
    out = {"hub": hub}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        alpha = segment_softmax(scores.to(dt), dst, n)
        sums = torch.zeros((n, 8), device=DEVICE).index_add_(
            0, dst.long(), alpha.float())
        has = torch.bincount(dst.long(), minlength=n) > 0
        out[f"{name}_alpha_sum_at_hub"] = [float(v) for v in sums[hub]]
        out[f"{name}_alpha_sum_max"] = float(sums[has].max())
        out[f"{name}_alpha_sum_min"] = float(sums[has].min())
        del alpha, sums
    del scores
    _free(torch)
    return out


def phase_gat_infer(torch, seed: int, g, graph_info):
    """GAT at the gat-cora config (2 layers, 8 hidden, 8 heads), random
    weights from a seeded generator, two ways.

    At the published Cora shape (``synth_cora_like``: 2,708 nodes,
    10,556 edges, 1,433 features, 7 classes, float32), the logits held
    per element against the plain-version forward on the card: its four
    float32 segment sums (two softmax denominators by ``index_add_``'s
    atomics, two message sums) run in other orders in the two forwards,
    each within the recursive-summation bound 2 deg 2^-24 of its terms'
    magnitudes, through unit-scale weights and 1-Lipschitz activations:
    |err| <= 8 d_max 2^-24 max|logit|.

    At the ``ogb_products`` shape with the reference cell's rule (100
    features, 47 classes, bf16; ``_products_cfg``) on the products
    graph: ``GNN_FORWARDS`` timed forwards after a warm-up, the peak
    memory (layer 2's message h[src] * alpha alone is 61.2 M x 8 x 47
    bf16 = 46.0 GB), the logits held to relative Frobenius error <= 1e-2
    of the plain forward's (``_infer_checks``), both computed in
    deterministic mode (``_deterministic_pair``: the bf16 softmax's
    atomics alone move the default mode's logits by about that much,
    ``default_mode`` records how far); and what the bf16 softmax does at
    the graph's hubs (``_softmax_at_hubs``)."""
    import numpy as np

    from repro_torch.configs.gat_cora import CONFIG
    from repro_torch.data.graphs import graph_to_device, synth_cora_like
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.models.gnn.models import GAT

    cora = synth_cora_like(seed=seed)
    d_max = int(np.bincount(cora["edge_dst"]).max())
    cora = graph_to_device({k: cora[k] for k in ("x", "edge_src",
                                                 "edge_dst")}, DEVICE)
    model = GAT(CONFIG, device=DEVICE, seed=seed)
    with torch.inference_mode():
        model(cora)
        _sync(torch)
        ops.segment_sum.launches = 0
        got = model(cora)
        _sync(torch)
        cora_launches = ops.segment_sum.launches
        backend, model.backend = model.backend, "ref"
        want = model(cora)
        model.backend = backend
    tol = 8 * d_max * 2.0**-24 * float(want.abs().max())
    cora_err = _max_err(torch, got, want)
    out = {"phase": "gat_infer", "config": CONFIG.name,
           "layers": CONFIG.n_layers, "hidden": CONFIG.d_hidden,
           "heads": CONFIG.n_heads,
           "cora": {"nodes": cora["x"].shape[0],
                    "edges": cora["edge_src"].numel(), "d_in": CONFIG.d_in,
                    "classes": CONFIG.n_classes, "dtype": "float32",
                    "max_in_degree": d_max,
                    "segment_sum_launches": cora_launches,
                    "logits_max_abs_err": cora_err, "tolerance": tol,
                    "ms": _time_ms(torch, lambda: model(cora), REPS)}}
    problems = []
    if got.shape != (cora["x"].shape[0], CONFIG.n_classes) \
            or not bool(torch.isfinite(got).all()) or cora_err > tol:
        problems.append(f"GAT at Cora: logits {tuple(got.shape)} differ "
                        f"from the plain forward by {cora_err} (tolerance "
                        f"{tol})")
    if cora_launches != CONFIG.n_layers:
        problems.append(f"GAT at Cora launched segment_sum {cora_launches} "
                        "times")
    del model, cora, got, want
    cfg = _products_cfg(torch, CONFIG)
    model = GAT(cfg, device=DEVICE, seed=seed)
    logits, times, launches, peak, want, plain_s = _infer(
        torch, model, g, GNN_FORWARDS)
    n = g["x"].shape[0]
    out["products"] = {
        **graph_info, "d_in": cfg.d_in, "classes": cfg.n_classes,
        "dtype": "bfloat16", "forwards": GNN_FORWARDS,
        "forward_s": sorted(times), "forward_s_median": _pctl(times, .5),
        "nodes_per_s": n / _pctl(times, .5),
        "edges_per_s": graph_info["edges"] / _pctl(times, .5),
        "plain_forward_s": plain_s, "segment_sum_launches": launches,
        "peak_mem_gib": peak}
    out["products"]["default_mode"] = _default_mode(torch, model, g, logits,
                                                    want)
    del logits, want
    got, want = _deterministic_pair(torch, model, g)
    fields, more = _infer_checks(torch, "GAT", got, want,
                                 (n, GIN_CLASSES), launches,
                                 cfg.n_layers * GNN_FORWARDS)
    out["products"].update(fields)
    del model, got, want
    _free(torch)
    out["softmax_at_hubs"] = _softmax_at_hubs(torch, seed, g)
    emit(out)
    if problems + more:
        fail("; ".join(problems + more))
    return out, cora_launches, launches


def _op_device_ms(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (taken again, at most
    ``PROFILE_TRIES`` windows, while a window catches no device time):
    the device time of its kernels, of the segment_sum kernel's (sr_*),
    and under each aten op (children included) for the eight largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
        if sum(_dev_us(e) for e in kernels):
            break
        time.sleep(0.1 * tries)
    ops = sorted(((e.key, getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0)))
                  for e in ev if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda kv: -kv[1])
    return {"device_ms": sum(_dev_us(e) for e in kernels) / 1e3,
            "segment_sum_kernel_ms": sum(
                _dev_us(e) for e in kernels
                if _kernel_name(e.key).startswith("sr_")) / 1e3,
            "by_op_ms": {k: us / 1e3 for k, us in ops[:8]},
            "windows": tries}


def phase_pna_infer(torch, seed: int, g, graph_info):
    """PNA at the pna config (4 layers, 75 hidden, mean/max/min/std x
    identity/amplification/attenuation, delta 2.5), random weights from a
    seeded generator, at the ``ogb_products`` shape with the reference
    cell's rule (100 features, 47 classes, bf16) on the products graph:
    ``GNN_FORWARDS`` timed forwards after a warm-up, peak memory, the
    logits held to relative Frobenius error <= 1e-2 of the plain
    forward's; one forward's device time by aten op from
    ``torch.profiler`` (``scatter_reduce_`` is the max/min aggregators,
    atomics into hubs of up to 3.58 M edges)."""
    from repro_torch.configs.pna import CONFIG
    from repro_torch.models.gnn.models import PNA

    cfg = _products_cfg(torch, CONFIG)
    model = PNA(cfg, device=DEVICE, seed=seed)
    logits, times, launches, peak, want, plain_s = _infer(
        torch, model, g, GNN_FORWARDS)
    n = g["x"].shape[0]
    out = {"phase": "pna_infer", "config": cfg.name, "layers": cfg.n_layers,
           "hidden": cfg.d_hidden, "aggregators": list(cfg.aggregators),
           "scalers": list(cfg.scalers), "delta": cfg.delta,
           "dtype": "bfloat16", **graph_info, "forwards": GNN_FORWARDS,
           "forward_s": sorted(times), "forward_s_median": _pctl(times, .5),
           "nodes_per_s": n / _pctl(times, .5),
           "edges_per_s": graph_info["edges"] / _pctl(times, .5),
           "plain_forward_s": plain_s, "segment_sum_launches": launches,
           "peak_mem_gib": peak}
    fields, problems = _infer_checks(torch, "PNA", logits, want,
                                     (n, GIN_CLASSES), launches,
                                     2 * cfg.n_layers * GNN_FORWARDS)
    out.update(fields)
    del logits, want
    with torch.inference_mode():
        out["profile"] = _op_device_ms(torch, lambda: model(g))
    emit(out)
    if problems:
        fail("; ".join(problems))
    del model
    _free(torch)
    return out, launches


def phase_nequip_infer(torch, seed: int):
    """NequIP at the nequip config (5 layers, 32 channels, l_max 2, 8
    Bessel functions, cutoff 5 A, 16 species), float32 (full float32
    matmuls: TF32 off), random weights from a seeded generator, at the
    ``molecule`` shape (``make_molecules``): ``NEQUIP_CALLS`` timed calls
    of ``energy_and_forces`` (forward, then the gradient back through the
    segment_sum kernel's autograd.Function) after a warm-up, the launch
    count zeroed just before and read just after (3 a layer, forward
    only).  Checks against the plain version on the card: per-molecule
    energies and the total within rtol 1e-5 + 1e-5 max|E|, forces within
    rtol 1e-4 + 1e-5 max|F| (float32 sums in other orders, five layers'
    backward); under a random rotation the total energy within rtol 1e-4
    and the forces rotated within rtol 2e-3 + 2e-4 max(1, max|F|)
    (tests/test_gnn.py's tolerances, the atol scaled to the forces); the
    per-molecule energies unchanged under a translation within rtol 1e-5
    + 1e-5 max|E|."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.nequip import CONFIG
    from repro_torch.data.graphs import graph_to_device
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.models.gnn import nequip as NQ

    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls run in TF32: NequIP's checks assume float32")
    t0 = time.perf_counter()
    g = graph_to_device(make_molecules(seed), DEVICE)
    make_s = time.perf_counter() - t0
    model = NQ.NequIP(CONFIG, device=DEVICE, seed=seed)
    if model.cfg.backend != "cuda":
        fail(f"NequIP's default backend is {model.cfg.backend}, not cuda")
    plain = dataclasses.replace(model.cfg, backend="ref")
    _reset_peak(torch)
    model.energy_and_forces(g)                       # warm-up, not counted
    _sync(torch)
    ops.segment_sum.launches = 0
    times = []
    for _ in range(NEQUIP_CALLS):
        t0 = time.perf_counter()
        e, f = model.energy_and_forces(g)
        _sync(torch)
        times.append(time.perf_counter() - t0)
    launches = ops.segment_sum.launches
    peak = _peak_gib(torch)
    t0 = time.perf_counter()
    e_ref, f_ref = NQ.energy_and_forces(model.params(), g, plain)
    _sync(torch)
    plain_s = time.perf_counter() - t0
    with torch.no_grad():
        eg = model(g)
        eg_ref = NQ.forward(model.params(), g, plain)
        shift = torch.tensor([1.7, -0.3, 2.2], device=DEVICE)
        eg_shift = model({**g, "pos": g["pos"] + shift})
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.as_tensor(q.astype(np.float32), device=DEVICE)
    e_rot, f_rot = model.energy_and_forces({**g, "pos": g["pos"] @ rot.T})

    def off(got, want, rtol, atol):
        """Largest excess of |got - want| over rtol |want| + atol."""
        return float(((got - want).abs() - rtol * want.abs() - atol).max())

    e_max, f_max = float(eg_ref.abs().max()), float(f_ref.abs().max())
    checks = {
        "energy_per_molecule": off(eg, eg_ref, 1e-5, 1e-5 * e_max),
        "energy_total": off(e, e_ref, 1e-5, 1e-5 * e_max),
        "forces": off(f, f_ref, 1e-4, 1e-5 * f_max),
        "rotation_energy": off(e_rot, e, 1e-4, 0.0),
        "rotation_forces": off(f @ rot.T, f_rot, 2e-3,
                               2e-4 * max(1.0, f_max)),
        "translation_energy": off(eg_shift, eg, 1e-5, 1e-5 * e_max)}
    n = g["species"].numel()
    out = {"phase": "nequip_infer", "config": CONFIG.name,
           "layers": CONFIG.n_layers, "channels": CONFIG.channels,
           "l_max": CONFIG.l_max, "n_rbf": CONFIG.n_rbf,
           "cutoff": CONFIG.cutoff, "species": CONFIG.n_species,
           "dtype": "float32", "molecules": MOL_BATCH, "atoms": n,
           "edges": g["edge_src"].numel(), "host_make_s": make_s,
           "calls": NEQUIP_CALLS, "call_s": sorted(times),
           "call_s_median": _pctl(times, .5),
           "atoms_per_s": n / _pctl(times, .5),
           "plain_call_s": plain_s, "segment_sum_launches": launches,
           "peak_mem_gib": peak, "energy_total": float(e),
           "energy_max_abs_err": _max_err(torch, eg, eg_ref),
           "forces_max_abs_err": _max_err(torch, f, f_ref),
           "forces_max_abs": f_max,
           "checks_worst_excess": checks}
    emit(out)
    if eg.shape != (MOL_BATCH,) or f.shape != (n, 3) \
            or not bool(torch.isfinite(f).all()):
        fail(f"NequIP energies {tuple(eg.shape)} / forces {tuple(f.shape)} "
             "not finite or of the wrong shape")
    if launches != 3 * CONFIG.n_layers * NEQUIP_CALLS:
        fail(f"NequIP launched segment_sum {launches} times in "
             f"{NEQUIP_CALLS} calls of {CONFIG.n_layers} layers")
    bad = [k for k, v in checks.items() if v > 0]
    if bad:
        fail(f"NequIP: {bad} out of tolerance ({checks})")
    del model, g
    _free(torch)
    return out, launches


def phase_minibatch_infer(torch, seed: int, g, graph_info):
    """GraphSAGE-style minibatch inference through the ported sampler:
    ``CSRGraph`` of the products graph built once on the host (timed),
    1,024 seeds drawn with ``np.random.default_rng(seed)`` and sampled
    with fanout (15, 10), ``minibatch_lg``'s sampling (at most 169,984
    nodes and 168,960 edges, padded), the subgraph's features gathered on
    the card (padding rows 0), then GAT and PNA at the products cell's
    rule over it: ``GNN_FORWARDS`` timed forwards each, held to the plain
    forward (relative Frobenius error <= 1e-2; GAT's in deterministic
    mode, as in ``phase_gat_infer``), launches counted.
    ``minibatch_lg``'s own graph is Reddit-shaped (232,965 nodes, 114.6 M
    edges, 602 features, 41 classes); this phase samples the products
    graph already on the card instead (100 features, 47 classes), since
    building a second graph of 114.6 M edges on the host would cost
    minutes."""
    import numpy as np

    from repro_torch.configs.gat_cora import CONFIG as GAT_CFG
    from repro_torch.configs.pna import CONFIG as PNA_CFG
    from repro_torch.models.gnn.models import GAT, PNA
    from repro_torch.models.gnn.sampler import (
        CSRGraph,
        sample_subgraph,
        subgraph_shapes,
    )

    n = g["x"].shape[0]
    src = g["edge_src"].cpu().numpy()
    dst = g["edge_dst"].cpu().numpy()
    t0 = time.perf_counter()
    csr = CSRGraph(n, src, dst)
    csr_s = time.perf_counter() - t0
    del src, dst
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, MINIBATCH_SEEDS, replace=False)
    t0 = time.perf_counter()
    sub = sample_subgraph(csr, seeds, MINIBATCH_FANOUTS, rng)
    sample_s = time.perf_counter() - t0
    n_max, e_max = subgraph_shapes(MINIBATCH_SEEDS, MINIBATCH_FANOUTS)
    nodes = torch.as_tensor(sub["nodes"], device=DEVICE).long()
    sg = {"x": torch.where((nodes >= 0)[:, None], g["x"][nodes.clamp(min=0)],
                           0),
          "edge_src": torch.as_tensor(sub["edge_src"], device=DEVICE),
          "edge_dst": torch.as_tensor(sub["edge_dst"], device=DEVICE)}
    out = {"phase": "minibatch_infer", "graph": "products", **graph_info,
           "cut": "samples the ogbn-products-shaped graph (100 features, "
                  "47 classes) instead of minibatch_lg's Reddit-shaped "
                  "graph (232,965 nodes, 114.6 M edges, 602 features, 41 "
                  "classes): a second graph of 114.6 M edges built on the "
                  "host would cost minutes",
           "seeds": MINIBATCH_SEEDS, "fanouts": list(MINIBATCH_FANOUTS),
           "n_max": n_max, "e_max": e_max,
           "nodes_sampled": int((sub["nodes"] >= 0).sum()),
           "edges_sampled": int((sub["edge_src"] >= 0).sum()),
           "host_csr_s": csr_s, "host_sample_s": sample_s}
    if sub["nodes"].shape != (n_max,) or sub["edge_src"].shape != (e_max,) \
            or not np.array_equal(sub["nodes"][:MINIBATCH_SEEDS], seeds):
        fail("the sampler's subgraph is not minibatch_lg's padded shape")
    launches, problems = {}, []
    for name, cls, config, per in (("gat", GAT, GAT_CFG, GAT_CFG.n_layers),
                                   ("pna", PNA, PNA_CFG,
                                    2 * PNA_CFG.n_layers)):
        model = cls(_products_cfg(torch, config), device=DEVICE, seed=seed)
        logits, times, launches[name], peak, want, plain_s = _infer(
            torch, model, sg, GNN_FORWARDS)
        default = None
        if name == "gat":                # checked in deterministic mode
            default = _default_mode(torch, model, sg, logits, want)
            logits, want = _deterministic_pair(torch, model, sg)
        out[name] = {"forward_ms": sorted(t * 1e3 for t in times),
                     "forward_ms_median": _pctl(times, .5) * 1e3,
                     "seeds_per_s": MINIBATCH_SEEDS / _pctl(times, .5),
                     "plain_forward_ms": plain_s * 1e3,
                     "segment_sum_launches": launches[name],
                     "peak_mem_gib": peak}
        fields, more = _infer_checks(
            torch, f"{name} minibatch", logits, want, (n_max, GIN_CLASSES),
            launches[name], per * GNN_FORWARDS)
        out[name].update(fields, default_mode=default)
        problems += more
        del model, logits, want
    emit(out)
    if problems:
        fail("; ".join(problems))
    _free(torch)
    return out, launches


# --------------------------------------------------------------------- #
# recsys_train / gnn_train: the train steps on the card
# --------------------------------------------------------------------- #
TRAIN_LR = 1e-3
PNA_REPEATS = 15                 # the bf16 PNA kernel step, repeated
PNA_BF16_GRADS = True            # its gradients held to 1e-2 (PERF.md §6)
WD_TRAIN_BATCH = 65_536          # recsys_shapes train_batch
WD_TRAIN_STEPS = 4               # timed steps after the compared one
GNN_TRAIN_STEPS = 3


def _adam_step(torch, st, count: int, cfg):
    """A leaf's Adam step ``(m / c1) / (sqrt(v / c2) + eps)`` recomputed in
    float64 from its state dict (fp32 ``v`` or factored ``vr``/``vc``)."""
    c1, c2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
    m = st["m"].double()
    if "vr" in st:
        vr, vc = st["vr"].double(), st["vc"].double()
        den = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        v = vr[..., :, None] * vc[..., None, :] / den[..., None]
    else:
        v = st["v"].double()
    return (m / c1) / (torch.sqrt(v / c2) + cfg.eps)


def _step_checks(torch, what, got, want, rel_tol: float, cfg,
                 grads: bool = True) -> tuple:
    """One train step from the same parameters and a zero AdamW state on
    the kernel path (``got``) and the plain path (``want``), each
    (params tree, opt state, loss, grad_norm): the loss and grad_norm
    within ``rel_tol`` (relative); where ``grads``, each leaf's gradient,
    read from its first moment (``m = (1 - b1) clip(g)`` after one step),
    within ``rel_tol`` of the leaf's largest entry (else its error is
    reported and not held); and each parameter within
    ``lr |step_got - step_want|`` of the plain one plus 16 float32 ulps
    of the update's operands (about 7 roundings a side: the step's five,
    the decay, the product with lr and the difference), the steps
    recomputed from each side's own
    moments (Adam's first step is ``lr g / (|g| + eps)``: an entry whose
    gradient sits within the tolerance of 0 can move by up to 2 lr).
    Returns (fields, problems)."""
    from repro_torch.optim.tree import flatten, flatten_up_to

    (gp, gs, gl, gn), (wp, ws, wl, wn) = got, want
    problems = []
    loss_rel = abs(float(gl) - float(wl)) / max(abs(float(wl)), 1e-30)
    gn_rel = abs(float(gn) - float(wn)) / max(abs(float(wn)), 1e-30)
    if not (loss_rel <= rel_tol and gn_rel <= rel_tol):
        problems.append(f"{what}: loss / grad_norm rel err {loss_rel} / "
                        f"{gn_rel} > {rel_tol}")
    g_leaves, w_leaves = flatten(gp), flatten(wp)
    g_st = flatten_up_to(gp, gs["leaves"])
    w_st = flatten_up_to(wp, ws["leaves"])
    grad_rel, param_ratio = 0.0, 0.0
    for i in range(len(g_leaves)):
        a, b = g_st[i]["m"], w_st[i]["m"]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        grad_rel = max(grad_rel, err / max(scale, 1e-30))
        if grads and not err <= rel_tol * scale:
            problems.append(f"{what}: leaf {i} gradient max |err| {err} > "
                            f"{rel_tol} x {scale}")
        sa = _adam_step(torch, g_st[i], 1, cfg)
        sb = _adam_step(torch, w_st[i], 1, cfg)
        p, q = g_leaves[i].detach().double(), w_leaves[i].detach().double()
        tol = TRAIN_LR * (sa - sb).abs() \
            + 16 * 2.0 ** -24 * (q.abs() + TRAIN_LR * (sb.abs() + 1))
        ratio = float(((p - q).abs() / tol).max())
        param_ratio = max(param_ratio, ratio)
        if not ratio <= 1.0:
            problems.append(f"{what}: leaf {i} parameters off their bound "
                            f"(x{ratio})")
    return {"loss": float(gl), "plain_loss": float(wl),
            "loss_rel_err": loss_rel, "grad_norm": float(gn),
            "plain_grad_norm": float(wn), "grad_norm_rel_err": gn_rel,
            "grad_max_rel_err": grad_rel, "grads_held": grads,
            "param_err_over_bound": param_ratio,
            "tolerance_rel": rel_tol}, problems


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of a parameter tree's leaves, in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _snapshot(torch, params, state, leaves):
    """Copies of the parameters ``leaves`` (flatten order) and their state
    dicts: (params list, [{"leaves": ...}]), enough for ``_step_checks``."""
    from repro_torch.optim.tree import flatten, flatten_up_to

    p = flatten(params)
    st = flatten_up_to(params, state["leaves"])
    return ([p[i].detach().clone() for i in leaves],
            {"leaves": [{k: v.clone() for k, v in st[i].items()}
                        for i in leaves]})


WD_SAMPLE_FIELDS = (0, 19, 39)   # first, middle and last update chunk
WD_SAMPLE_TOUCHED = 256
WD_SAMPLE_UNTOUCHED = 64


def _wd_sample_rows(torch, sparse_ids, vocab: int, seed: int):
    """Rows of the stacked tables to hold against the plain step: for
    each field of ``WD_SAMPLE_FIELDS``, ``WD_SAMPLE_TOUCHED`` rows the
    batch reads (evenly spaced over its sorted ids) and
    ``WD_SAMPLE_UNTOUCHED`` it does not (weight decay and the moments
    still move them).  -> [fields, rows] int64 on the ids' device."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for f in WD_SAMPLE_FIELDS:
        used = torch.unique(sparse_ids[:, f].long()).cpu()
        touched = used[torch.linspace(0, len(used) - 1,
                                      WD_SAMPLE_TOUCHED).long()]
        cand = torch.randint(0, vocab, (8 * WD_SAMPLE_UNTOUCHED,),
                             generator=gen)
        cand = cand[~torch.isin(cand, used)].unique()
        if len(touched.unique()) != WD_SAMPLE_TOUCHED \
                or len(cand) < WD_SAMPLE_UNTOUCHED:
            fail(f"recsys_train: field {f} gives too few sample rows")
        out.append(torch.cat([touched, cand[:WD_SAMPLE_UNTOUCHED]]))
    return torch.stack(out).to(sparse_ids.device)


def _table_sample(torch, params, state, i: int, rows):
    """The rows ``rows`` ([fields, R], ``_wd_sample_rows``) of the stacked
    leaf ``i`` (flatten order) and of its first moment, with its second
    moment reconstructed on those rows in float64 (the factored ``vr ⊗
    vc / mean(vr)`` over the whole field): (param [F, R, D], {"m", "v"}),
    a leaf as ``_snapshot`` gives it, for ``_step_checks``."""
    from repro_torch.optim.tree import flatten, flatten_up_to

    st = flatten_up_to(params, state["leaves"])[i]
    f = torch.tensor(WD_SAMPLE_FIELDS, device=rows.device)[:, None]
    sample = {"m": st["m"][f, rows].clone()}
    if "vr" in st:
        den = torch.clamp(st["vr"][f[:, 0]].double().mean(-1), min=1e-30)
        sample["v"] = (st["vr"][f, rows].double()[..., None]
                       * st["vc"][f].double() / den[:, None, None])
    else:
        sample["v"] = st["v"][f, rows].clone()
    return flatten(params)[i][f, rows].detach().clone(), sample


def phase_recsys_train(torch, seed: int):
    """Wide&Deep training at the published config (40 x 1,000,000 x 32
    float32 tables, wide table 4,000,000, MLP 1024-512-256) on
    ``train_batch`` (65,536 examples of ``recsys_batch``, 25% of wide ids
    -1): ``make_recsys_train_step`` with AdamW in ``factored`` mode (the
    reference's recsys cell; the stacked tables updated field by field).
    First the wide gradient of ``bce_loss`` on the card (the embedding_bag
    kernel's Function, its backward the segment_sum kernel): not None,
    within the summation bound of the plain version's; then one step
    held to the same step on the plain version (a second model from the
    same seed, after the first is freed), and ``WD_TRAIN_STEPS`` timed
    steps; the kernels' launches counted over the steps."""
    import dataclasses

    from repro_torch.configs.wide_deep import CONFIG
    from repro_torch.data.recsys import batch_to_device, recsys_batch
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch.cells import make_recsys_train_step
    from repro_torch.models.recsys.wide_deep import WideDeep, bce_loss
    from repro_torch.optim import AdamWConfig, adamw_init

    ocfg = AdamWConfig(state_mode="factored")
    batch = batch_to_device(recsys_batch(
        0, WD_TRAIN_BATCH, CONFIG.n_sparse, CONFIG.vocab_per_field,
        CONFIG.n_dense, CONFIG.n_wide_crosses, seed=seed), DEVICE)
    problems = []

    def wide_grad(model):
        loss, _ = bce_loss(model, batch)
        loss.backward()
        g = model.wide.grad
        model.zero_grad(set_to_none=True)
        return g

    # -- the kernel path ------------------------------------------------
    _free(torch)
    _reset_peak(torch)
    model = WideDeep(CONFIG, device=DEVICE, seed=seed)
    if model.backend != "cuda":
        fail(f"Wide&Deep's default backend is {model.backend}, not cuda")
    names = _leaf_names(model.params())
    held = [i for i, n in enumerate(names) if n != "tables"]
    i_tables = names.index("tables")
    rows = _wd_sample_rows(torch, batch["sparse_ids"], CONFIG.vocab_per_field,
                           seed)
    sr.segment_sum.launches = 0
    g_wide = wide_grad(model)
    if g_wide is None:
        fail("recsys_train: bce_loss(...).backward() left model.wide.grad "
             "None on the card")
    if sr.segment_sum.launches != 1:
        problems.append(f"recsys_train: the wide gradient launched "
                        f"segment_sum {sr.segment_sum.launches} times, not 1")
    with torch.no_grad():
        logit = model(batch).float()
    step = make_recsys_train_step(CONFIG, ocfg, TRAIN_LR)
    opt = adamw_init(model.params(), ocfg)
    _sync(torch)
    peak_check = _peak_gib(torch)
    _reset_peak(torch)
    eb.embedding_bag.launches = sr.segment_sum.launches = 0
    times = []
    for k in range(1 + WD_TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt, loss, gnorm = step(model, opt, batch)
        _sync(torch)
        times.append(time.perf_counter() - t0)
        if k == 0:
            first = (float(loss), float(gnorm)) + _snapshot(
                torch, model.params(), opt, held)
            tp, tst = _table_sample(torch, model.params(), opt, i_tables,
                                    rows)
            first[2].append(tp)
            first[3]["leaves"].append(tst)
    launches = {"embedding_bag": eb.embedding_bag.launches,
                "segment_sum": sr.segment_sum.launches}
    peak = _peak_gib(torch)
    losses = [first[0]]
    if launches != {"embedding_bag": 1 + WD_TRAIN_STEPS,
                    "segment_sum": 1 + WD_TRAIN_STEPS}:
        problems.append(f"recsys_train: {1 + WD_TRAIN_STEPS} steps launched "
                        f"{launches}, not one of each a step")
    del model, opt
    _free(torch)

    # -- the plain version, from the same seed ---------------------------
    plain = WideDeep(dataclasses.replace(CONFIG, backend="ref"),
                     device=DEVICE, seed=seed)
    g_plain = wide_grad(plain)
    # the summation bound of each row's k terms, plus the logits' own
    # float32 difference (rtol 1e-5, as recsys_serve holds them)
    ids = batch["wide_ids"].reshape(-1).long()
    ok = ids >= 0
    bags = torch.arange(WD_TRAIN_BATCH, device=DEVICE).repeat_interleave(
        batch["wide_ids"].shape[1])
    d_out = ((torch.sigmoid(logit) - batch["labels"].float())
             / WD_TRAIN_BATCH).abs()
    terms = torch.zeros_like(g_plain).index_add_(0, ids[ok], d_out[bags[ok]])
    k = torch.zeros_like(g_plain).index_add_(
        0, ids[ok], torch.ones_like(d_out[bags[ok]]))
    bound = (k + 1) * 2.0 ** -24 * terms + 1e-5 * g_plain.abs()
    wide_err = float((g_wide - g_plain).abs().max())
    if not bool(((g_wide - g_plain).abs() <= bound).all()):
        problems.append(f"recsys_train: the wide gradient differs from the "
                        f"plain one past its bound (max |err| {wide_err})")
    del g_wide, g_plain, terms, k, bound, logit
    opt_p = adamw_init(plain.params(), ocfg)
    _, opt_p, loss_p, gnorm_p = step(plain, opt_p, batch)
    want = (float(loss_p), float(gnorm_p)) + _snapshot(
        torch, plain.params(), opt_p, held)
    tp, tst = _table_sample(torch, plain.params(), opt_p, i_tables, rows)
    want[2].append(tp)
    want[3]["leaves"].append(tst)
    del plain, opt_p
    _free(torch)
    fields, more = _step_checks(
        torch, "recsys_train", (first[2], first[3], first[0], first[1]),
        (want[2], want[3], want[0], want[1]), 1e-5, ocfg)
    problems += more
    t_med = _pctl(times[1:], .5)
    out = {"phase": "recsys_train", "config": CONFIG.name,
           "batch": WD_TRAIN_BATCH, "optimizer": "adamw factored",
           "steps": 1 + WD_TRAIN_STEPS, "step_s": times,
           "step_s_median": t_med, "examples_per_s": WD_TRAIN_BATCH / t_med,
           "peak_mem_gib": peak, "peak_mem_gib_wide_grad_check": peak_check,
           "launches": launches,
           "wide_grad_max_abs_err": wide_err,
           "held_leaves": [names[i] for i in held] + [
               f"tables[fields {list(WD_SAMPLE_FIELDS)}, "
               f"{WD_SAMPLE_TOUCHED} rows read + {WD_SAMPLE_UNTOUCHED} not "
               f"each]"], **fields}
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out, launches


def _f32_tol(n_sums: int, d_max: int) -> float:
    """The float32 step tolerance (relative): the kernel path and the
    plain one differ in a step's ``n_sums`` segment sums (its launches),
    each of at most ``d_max`` terms added in another order, a relative
    error of ``d_max 2^-24`` each; a factor 8 of headroom, as
    gat_infer's forward bound has."""
    return 8 * n_sums * d_max * 2.0 ** -24


def _train_case(torch, what, make, loss, g, rel_tol, steps, launches_per,
                deterministic=False, grads=True):
    """One GNN case: a step on the kernel path and one on the plain path
    (``make("ref")``) from the same seed, held by ``_step_checks`` (each
    leaf's gradient where ``grads``; both under
    ``torch.use_deterministic_algorithms`` where ``deterministic``:
    GAT's bf16 softmax sums are ``index_add_`` atomics), then ``steps``
    timed steps on the kernel path in the default mode, the segment_sum
    launches counted over them (``launches_per`` a step)."""
    import warnings

    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch.cells import make_gnn_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    ocfg = AdamWConfig(state_mode="fp32")
    step = make_gnn_train_step(None, loss, ocfg, TRAIN_LR)
    runs = []
    for backend in (None, "ref"):
        _free(torch)
        model = make(backend)
        opt = adamw_init(model.params(), ocfg)
        if deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                _, opt, l, gn = step(model, opt, g)
        finally:
            torch.use_deterministic_algorithms(False)
        runs.append((model.params(), opt, l, gn))
        if backend is None:
            kernel_model = model
    fields, problems = _step_checks(torch, what, runs[0], runs[1], rel_tol,
                                    ocfg, grads)
    del runs, model
    opt = adamw_init(kernel_model.params(), ocfg)
    step(kernel_model, opt, g)                   # warm-up, not counted
    _sync(torch)
    _reset_peak(torch)
    sr.segment_sum.launches = 0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, opt, l, _ = step(kernel_model, opt, g)
        _sync(torch)
        times.append(time.perf_counter() - t0)
    launches = sr.segment_sum.launches
    if launches != launches_per * steps:
        problems.append(f"{what}: {steps} steps launched segment_sum "
                        f"{launches} times, not {launches_per} a step")
    if not bool(torch.isfinite(l)):
        problems.append(f"{what}: the loss is not finite")
    t_med = _pctl(times, .5)
    fields.update(step_s=times, step_s_median=t_med,
                  peak_mem_gib=_peak_gib(torch),
                  segment_sum_launches=launches,
                  segment_sum_launches_per_step=launches / steps)
    del kernel_model, opt
    _free(torch)
    return fields, t_med, problems


def _repeat_steps(torch, make, loss, g, reps: int) -> dict:
    """The kernel path's step ``reps`` times, each from a fresh model of
    the same seed and a zero AdamW state: every loss, grad_norm, gradient
    (each leaf's first moment after the step) and parameter must equal
    the first repeat's bit for bit.  Returns the repeats, whether all
    were equal and which values differed (flatten order: the moments,
    then the parameters, then the loss and grad_norm)."""
    from repro_torch.launch.cells import make_gnn_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.tree import flatten, flatten_up_to

    ocfg = AdamWConfig(state_mode="fp32")
    step = make_gnn_train_step(None, loss, ocfg, TRAIN_LR)
    first, differ = None, set()
    t0 = time.perf_counter()
    for _ in range(reps):
        model = make(None)
        _, opt, l, gn = step(model, adamw_init(model.params(), ocfg), g)
        params = model.params()
        vals = [st["m"] for st in flatten_up_to(params, opt["leaves"])] \
            + [x.detach() for x in flatten(params)] + [l, gn]
        if first is None:
            first = [v.clone() for v in vals]
        else:
            differ.update(i for i, (a, b) in enumerate(zip(first, vals))
                          if not torch.equal(a, b))
        del model, opt, params, vals
    _free(torch)
    return {"repeats": reps, "bit_equal": not differ,
            "differing": sorted(differ), "values": len(first),
            "seconds": time.perf_counter() - t0}


def _minibatch_graph(torch, g, seed: int):
    """The sampler's subgraph of the products graph ``g`` (minibatch_lg's
    cut, as minibatch_infer's) on the card: (graph dict, real nodes)."""
    import numpy as np

    from repro_torch.models.gnn.sampler import CSRGraph, sample_subgraph

    n = g["x"].shape[0]
    src = g["edge_src"].cpu().numpy()
    dst = g["edge_dst"].cpu().numpy()
    csr = CSRGraph(n, src, dst)
    del src, dst
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, MINIBATCH_SEEDS, replace=False)
    sub = sample_subgraph(csr, seeds, MINIBATCH_FANOUTS, rng)
    del csr
    nodes = torch.as_tensor(sub["nodes"], device=DEVICE).long()
    sg = {"x": torch.where((nodes >= 0)[:, None], g["x"][nodes.clamp(min=0)],
                           0),
          "edge_src": torch.as_tensor(sub["edge_src"], device=DEVICE),
          "edge_dst": torch.as_tensor(sub["edge_dst"], device=DEVICE),
          "labels": torch.where(nodes >= 0, g["labels"][nodes.clamp(min=0)],
                                0),
          "label_mask": nodes >= 0}
    return sg, int((sub["nodes"] >= 0).sum())


def phase_gnn_train(torch, seed: int, g, graph_info):
    """The GNN zoo's train steps on the card (``make_gnn_train_step``,
    AdamW fp32 as the reference's GNN cells, lr 1e-3), each held to the
    same step on the plain version (``backend="ref"``, whose segment sums
    accumulate in float64) by ``_step_checks``:

      gin_products  GIN ``gin-tu`` at ``ogb_products`` by the reference
                    cell's rule (100 features, 47 classes, bf16,
                    ``remat=True``) on the products graph, node cross
                    entropy over every node; tolerance 1e-2 relative:
                    bf16 activations, one rounding per op, where the two
                    paths' sums (float32 tiles, float64) round to
                    neighbouring bf16 values;
      gat_cora      GAT ``gat-cora`` at ``full_graph_sm`` (the Cora shape,
                    float32); tolerance ``_f32_tol``: 8 n_sums d_max
                    2^-24 relative, n_sums the step's segment sums and
                    d_max the largest in-degree (float32 sums of at most
                    d_max terms in another order);
      gat_minibatch / pna_minibatch  GAT and PNA at ``minibatch_lg`` by
                    the cell's rule (bf16, ``remat=True``) on the
                    sampler's subgraph of the products graph (the cut of
                    minibatch_infer); 1e-2 as GIN (GAT's compared steps
                    in deterministic mode, as gat_infer's forwards).
                    A max / min aggregator's gradient goes whole to the
                    messages equal to the extreme, and bf16 messages tie
                    often, so a bf16 rounding that the two paths' sums
                    take differently can break or make a tie and move a
                    gradient entry whole.  The kernel sums in one fixed
                    order, so its step repeats bit for bit
                    (``PNA_REPEATS`` steps from the seed: every loss,
                    gradient and parameter bit-equal, ``_repeat_steps``)
                    and the pair reads one number;
      pna_minibatch_f32  the same PNA step with float32 activations,
                    where such ties are rare: every check, each leaf's
                    gradient included, at the same 1e-2 (on an H100
                    80GB HBM3 at 700 W 3.3e-5 to 1.7e-3 in 15 runs);
      nequip        NequIP ``nequip`` at the molecule shape on
                    ``mse_loss`` against seeded target energies, float32;
                    ``_f32_tol`` as GAT at Cora.

    GAT and PNA are not trained at the products shape: GAT's second
    layer's message alone is 46 GB and its gradient as large, and PNA's
    forward already peaks at 34.86 GiB.  Prints each case's step time,
    nodes/s (atoms/s), peak memory and segment_sum launches a step."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.gat_cora import CONFIG as GAT_CFG
    from repro_torch.configs.gin_tu import CONFIG as GIN_CFG
    from repro_torch.configs.nequip import CONFIG as NQ_CFG
    from repro_torch.configs.pna import CONFIG as PNA_CFG
    from repro_torch.data.graphs import graph_to_device, synth_cora_like
    from repro_torch.models.gnn import nequip as nq
    from repro_torch.models.gnn.models import GAT, GIN, PNA, \
        node_classification_loss

    def gnn(cls, cfg):
        def make(backend):
            model = cls(cfg, device=DEVICE, seed=seed)
            if backend is not None:
                model.backend = backend
            elif model.backend != "cuda":
                fail(f"{cls.__name__}'s default backend is {model.backend}")
            return model
        return make

    def big(config):          # the cell rule of ogb_products/minibatch_lg
        return dataclasses.replace(_products_cfg(torch, config), remat=True)

    out = {"phase": "gnn_train", "lr": TRAIN_LR, "optimizer": "adamw fp32",
           "not_trained": "GAT and PNA at ogb_products: GAT's layer-2 "
                          "message is 46 GB and its gradient as large; PNA's "
                          "forward alone peaks at 34.86 GiB",
           "cases": {}}
    problems, launches = [], {}

    def run(name, make, loss, graph, rel_tol, per_step, n_items, unit,
            deterministic=False, grads=True, **info):
        fields, t_med, more = _train_case(
            torch, f"gnn_train {name}", make, loss, graph, rel_tol,
            GNN_TRAIN_STEPS, per_step, deterministic, grads)
        fields[f"{unit}_per_s"] = n_items / t_med
        out["cases"][name] = {**info, **fields}
        launches[name] = fields["segment_sum_launches"]
        problems.extend(more)

    # GIN at ogb_products: 5 forward sums, 5 recomputed, 4 gather
    # gradients (layer 1's input needs none)
    gin_cfg = big(GIN_CFG)
    n = g["x"].shape[0]
    run("gin_products", gnn(GIN, gin_cfg), node_classification_loss, g,
        1e-2, 3 * gin_cfg.n_layers - 1, n, "nodes", config=gin_cfg.name,
        dtype="bfloat16", remat=True, nodes=n,
        edges=graph_info["edges"])

    # GAT at Cora, float32: 2 forward sums a step and 3 gather gradients
    # a layer (its scores' two and its message's)
    cora = synth_cora_like(seed=seed)
    cg = graph_to_device({k: cora[k] for k in ("x", "edge_src", "edge_dst",
                                               "labels")}, DEVICE)
    d_max = int(np.bincount(cora["edge_dst"][cora["edge_dst"] >= 0]).max())
    run("gat_cora", gnn(GAT, GAT_CFG), node_classification_loss, cg,
        _f32_tol(4 * GAT_CFG.n_layers, d_max), 4 * GAT_CFG.n_layers,
        cora["x"].shape[0],
        "nodes", config=GAT_CFG.name, dtype="float32", d_max=d_max)

    # GAT and PNA at minibatch_lg on the sampler's subgraph (remat: the
    # forward's sums again in the backward)
    sg, n_sub = _minibatch_graph(torch, g, seed)
    # GAT's last layer recomputes no sum: non-reentrant checkpointing
    # stops at the last tensor the backward needs, and the head mean
    # after the last sum saves none; PNA's first layer gathers the input
    # features, which need no gradient
    for name, cls, config, dtype, grads in (
            ("gat_minibatch", GAT, GAT_CFG, torch.bfloat16, True),
            ("pna_minibatch", PNA, PNA_CFG, torch.bfloat16, PNA_BF16_GRADS),
            ("pna_minibatch_f32", PNA, PNA_CFG, torch.float32, True)):
        cfg = dataclasses.replace(big(config), dtype=dtype)
        run(name, gnn(cls, cfg), node_classification_loss, sg, 1e-2,
            5 * cfg.n_layers - 1, n_sub, "nodes",
            deterministic=(cls is GAT), grads=grads, config=cfg.name,
            dtype=str(dtype).removeprefix("torch."), remat=True,
            nodes=n_sub, seeds=MINIBATCH_SEEDS,
            cut="the products graph sampled, as minibatch_infer")
        if name == "pna_minibatch":
            again = _repeat_steps(torch, gnn(cls, cfg),
                                  node_classification_loss, sg, PNA_REPEATS)
            out["cases"][name]["repeat"] = again
            if not again["bit_equal"]:
                problems.append(f"gnn_train {name}: the kernel step did not "
                                f"repeat bit for bit: {again}")

    # NequIP at the molecule shape: 3 sums a layer, forward only
    mol = make_molecules(seed)
    mol["energy"] = np.random.default_rng(seed + 1).standard_normal(
        MOL_BATCH).astype(np.float32)
    mg = graph_to_device(mol, DEVICE)
    d_mol = int(np.bincount(mol["edge_dst"]).max())

    def make_nq(backend):
        model = nq.NequIP(NQ_CFG if backend is None else dataclasses.replace(
            NQ_CFG, backend=backend), device=DEVICE, seed=seed)
        if backend is None and model.cfg.backend != "cuda":
            fail(f"NequIP's default backend is {model.cfg.backend}")
        return model

    run("nequip", make_nq,
        lambda m, gr: nq.mse_loss(m.params(), gr, m.cfg), mg,
        _f32_tol(3 * NQ_CFG.n_layers, d_mol), 3 * NQ_CFG.n_layers,
        MOL_BATCH * MOL_ATOMS,
        "atoms", config=NQ_CFG.name, dtype="float32", d_max=d_mol)
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out, launches


# --------------------------------------------------------------------- #
# The examples: the JAX package's examples' twins on the card
# --------------------------------------------------------------------- #
# each example, the kernels its run must launch
EXAMPLES = (("torch_quickstart", ("compat_join_pairs",)),
            ("torch_multi_query_service", ("compat_join_pairs",)),
            ("torch_cybersec_c2_detection", ("compat_join_pairs",)),
            ("torch_serve_recsys", ("embedding_bag", "segment_sum")))
GNN_EXAMPLE = "torch_gnn_node_classification"


def _example(name: str):
    """``examples/<name>.py`` as a module (examples are no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch):
    """The five examples that are the JAX package's examples' twins, each
    through its ``main`` on the card, its own assertions included.  The
    GNN example (120 GAT steps) runs twice and must give the same loss,
    bit for bit, at every printed step: its segment sums are the
    kernel's fixed order, and its softmax denominators (``index_add_``,
    float atomics) run under ``torch.use_deterministic_algorithms``, as
    gat_infer's pair does.  The other four run once.  Each run's kernel
    launches are counted (zeroed before, read after) and each must have
    launched the kernels ``EXAMPLES`` names; returns (phase line, the
    launches by kernel over the phase)."""
    import warnings

    out = {"phase": "examples", "cases": {}}
    problems, total = [], Counter()
    argv = ["--device", DEVICE]

    def run(name, fn, want):
        _zero_launches()
        t0 = time.perf_counter()
        res = fn()
        _sync(torch)
        counts = _launch_counts()
        total.update(counts)
        missing = [k for k in want if not counts[k]]
        if missing:
            problems.append(f"example {name} launched no {missing}")
        return res, {"s": time.perf_counter() - t0,
                     "launches": {k: v for k, v in counts.items() if v}}

    gnn = _example(GNN_EXAMPLE)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for _ in range(2):
                runs.append(run(GNN_EXAMPLE, lambda: gnn.main(argv),
                                ("segment_sum",)))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, info), (b, _) = runs
    same = a["losses"] == b["losses"] and len(a["losses"]) == 6
    out["cases"][GNN_EXAMPLE] = {
        **info, "runs": 2, "losses": a["losses"],
        "losses_again": b["losses"], "losses_bit_equal": same,
        "accuracy": a["accuracy"], "baseline": a["baseline"]}
    if not same:
        problems.append(f"example {GNN_EXAMPLE}: two runs' losses differ: "
                        f"{a['losses']} / {b['losses']}")
    for name, want in EXAMPLES:
        mod = _example(name)
        res, info = run(name, lambda: mod.main(argv), want)
        out["cases"][name] = {**info, **{k: v for k, v in res.items()
                                         if k not in ("rows", "live")}}
    _free(torch)
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out, dict(total)


# --------------------------------------------------------------------- #
# LM serving (qwen3-14b) and MoE serving (arctic-480b)
# --------------------------------------------------------------------- #
# H100 SXM dense bf16 peak (NVIDIA data sheet, no sparsity, 700 W).
BF16_FLOPS_PER_S = 989e12
LM_ARCH, MOE_ARCH = "qwen3-14b", "arctic-480b"
LM_CHECK_LAYERS = 2        # the card-against-CPU check: 2 of the 40 layers
LM_CHECK_TOKENS, LM_CHECK_PROMPT = 64, 56
LM_CHECK_TOL = 1e-4        # float32, TF32 off: relative Frobenius
LM_WARMUP_TOKENS = 2048
LM_DECODE_BATCH = 4        # decode_32k's batch 128, cut
LM_DECODE_PROMPT = 2048
LM_DECODE_STEPS = 32
LM_DECODE_TOL = 5e-2       # decode against forward, bf16, 40 layers (PERF.md §2)
MOE_LAYERS = 2             # of arctic's 35
MOE_PREFILL = 8192         # prefill_32k's 32,768 tokens, cut
MOE_DECODE_BATCH, MOE_DECODE_STEPS = 4, 16
MOE_DECODE_PROMPT = 2048
MOE_LOOP_TOL = 1e-2        # bf16 dispatch against the per-token loop


def _launch_counts() -> dict:
    """The four kernel wrappers' launch counters."""
    from repro_torch.kernels.compat_join import ops as cj
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.segment_reduce import ops as sr

    return {"compat_join_pairs": cj.compat_join_pairs.launches,
            "compat_mask": cj.compat_mask.launches,
            "embedding_bag": eb.embedding_bag.launches,
            "segment_sum": sr.segment_sum.launches}


def _zero_launches() -> None:
    from repro_torch.kernels.compat_join import ops as cj
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.segment_reduce import ops as sr

    for op in (cj.compat_join_pairs, cj.compat_mask, eb.embedding_bag,
               sr.segment_sum):
        op.launches = 0


def _nbytes(tree) -> int:
    from repro_torch.optim.tree import flatten

    return sum(t.numel() * t.element_size() for t in flatten(tree))


def _timed(torch, fn):
    _sync(torch)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch)
    return out, time.perf_counter() - t0


def _greedy_decode(torch, tfm, params, cfg, prompts, smax: int, steps: int,
                   on_step=None):
    """Prefill ``prompts`` [B, P] into a fresh [L, B, smax, Hkv, hd] cache
    in ``cfg.dtype``, then ``steps`` greedy ``serve_step``s.  Returns
    (step logits, tokens fed [B, steps], step seconds, prefill logits,
    problems, device time of one more step by op, peaks); ``on_step(i)``
    runs after step i, untimed.  ``peaks``: the most allocated over the
    whole section in GiB (``gib``) and around the profiled step alone
    (``step_bytes``: the peak counter reset just before it), both None
    off the card."""
    b, p = prompts.shape
    shape = (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.head_dim)
    kc = torch.zeros(shape, dtype=cfg.dtype, device=DEVICE)
    vc = torch.zeros(shape, dtype=cfg.dtype, device=DEVICE)
    plog, pk, pv = tfm.prefill(params, prompts, cfg)
    kc[:, :, :p], vc[:, :, :p] = pk, pv
    del pk, pv
    length = torch.full((b,), p, dtype=torch.int32, device=DEVICE)
    tok = plog.argmax(-1)
    logits, fed, secs, problems = [], [], [], []
    for i in range(steps):
        fed.append(tok)
        (lg, cache), s = _timed(torch, lambda: tfm.serve_step(
            params, tok[:, None], (kc, vc, length), cfg))
        secs.append(s)
        if cache[0] is not kc or cache[1] is not vc:
            problems.append("serve_step did not write the cache in place")
        if cache[2].tolist() != [p + i + 1] * b:
            problems.append(f"length after step {i} is {cache[2].tolist()}")
        if tuple(lg.shape) != (b, cfg.vocab) or not bool(
                torch.isfinite(lg).all()):
            problems.append(f"step {i} logits {tuple(lg.shape)} not finite "
                            f"or not ({b}, {cfg.vocab})")
        length = cache[2]
        logits.append(lg)
        tok = lg.argmax(-1)
        if on_step is not None:
            on_step(i)
    if DEVICE != "cuda":
        return logits, torch.stack(fed, 1), secs, plog, problems, {}, \
            {"gib": None, "step_bytes": None}
    # the profiler (no profile_memory) allocates nothing through the
    # caching allocator, and a window it takes again reruns the same step,
    # so the counter reset here reads the one step's peak
    section = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    profile = _op_device_ms(torch, lambda: tfm.serve_step(
        params, tok[:, None], (kc, vc, length), cfg))
    step = torch.cuda.max_memory_allocated()
    return logits, torch.stack(fed, 1), secs, plog, problems, profile, \
        {"gib": max(section, step) / 2**30, "step_bytes": step}


def phase_lm_serve(torch, seed: int):
    """qwen3-14b served on the card at its full width and depth (40
    layers), bf16, seeded random weights, through the reference's serving
    entry points (``prefill`` for prompts, then greedy ``serve_step``s
    against a KV cache):

      check     the card against the CPU in float32 at full width, 2 of
                the 40 layers, the same weights on both (TF32 off):
                ``forward`` over 64 tokens, ``prefill`` of 56 plus 8
                ``serve_step``s, each output within 1e-4 relative
                Frobenius;
      prefill   one request at ``prefill_32k``'s 32,768 tokens (batch 32
                cut to 1) after a 2,048-token warm-up: seconds, tokens/s,
                peak, model FLOPs by the reference cell's rule
                (2·active·tokens + 2·L·H·hd·S²) and FLOP/s against the
                dense bf16 peak;
      decode    ``decode_32k``'s cache length (batch 128 cut to 4): a
                [40, 4, 32,768, 8, 128] bf16 cache, 4 prompts of 2,048
                tokens prefilled into it, 32 greedy steps: ms a step,
                tokens/s, peak, the step's byte bound (every weight but
                the embedding table, 4 of its rows, the whole cache, over
                3.35 TB/s), and one more step's device time by op;
      against forward  each step's logits against ``forward``'s
                teacher-forced logits at that position (relative
                Frobenius over the batch at most 5e-2, PERF.md §2), and
                the greedy token equal wherever forward's top-2 margin
                exceeds twice the row's largest difference.

    The parameters are drawn in bf16 (``param_dtype`` bf16): the
    reference casts every parameter to ``cfg.dtype`` before use, so this
    computes what float32 masters compute.  No hand-written kernel runs
    on this path: the four launch counters must read 0."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.cells import lm_param_flops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.tree import tree_map

    t_phase = time.perf_counter()
    _zero_launches()
    arch = get_arch(LM_ARCH)
    full = arch.config
    prefill_len = arch.shape("prefill_32k").seq_len
    cache_len = arch.shape("decode_32k").seq_len
    problems = []
    out = {"phase": "lm_serve", "arch": LM_ARCH,
           "config": {k: getattr(full, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab", "qk_norm", "rope_theta", "attn_chunk")},
           "param_dtype": "bfloat16 (the reference casts each parameter "
                          "to its bf16 dtype before use)",
           "cuts": {"prefill_32k": f"batch {arch.shape('prefill_32k').global_batch}"
                                   " cut to 1",
                    "decode_32k": f"batch {arch.shape('decode_32k').global_batch}"
                                  f" cut to {LM_DECODE_BATCH}"}}

    # -- the card against the CPU: float32, 2 layers, full width --------
    cfg32 = dataclasses.replace(full, n_layers=LM_CHECK_LAYERS,
                                dtype=torch.float32,
                                param_dtype=torch.float32, remat="none")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    card = tfm.init(gen, cfg32, device=DEVICE)
    host = tree_map(lambda t: t.cpu(), card)
    tokens = torch.randint(0, full.vocab, (1, LM_CHECK_TOKENS),
                           generator=torch.Generator().manual_seed(seed + 1))
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm_serve: TF32 is on for float32 matmuls before the check")

    def run(params, where):
        t = tokens.to(where)
        p = LM_CHECK_PROMPT
        with torch.inference_mode():
            logits, _ = tfm.forward(params, t, cfg32)
            plog, pk, pv = tfm.prefill(params, t[:, :p], cfg32)
            shape = (cfg32.n_layers, 1, LM_CHECK_TOKENS, full.n_kv_heads,
                     full.head_dim)
            kc = torch.zeros(shape, device=where)
            vc = torch.zeros(shape, device=where)
            kc[:, :, :p], vc[:, :, :p] = pk, pv
            cache = (kc, vc, torch.full((1,), p, dtype=torch.int32,
                                        device=where))
            steps = []
            for i in range(p, LM_CHECK_TOKENS):
                lg, cache = tfm.serve_step(params, t[:, i:i + 1], cache,
                                           cfg32)
                steps.append(lg)
        return {"forward": logits, "prefill": plog, "prefill_k": pk,
                "prefill_v": pv, "steps": torch.stack(steps),
                "cache_k": cache[0]}

    (got, card_s), (want, host_s) = (_timed(torch, lambda: run(card, DEVICE)),
                                     _timed(torch, lambda: run(host, "cpu")))
    errs = {k: _rel_err(got[k].cpu(), want[k]) for k in want}
    # each side's forward against a float64 forward of the same weights and
    # tokens on the CPU: a disagreement names the side that moved
    cfg64 = dataclasses.replace(cfg32, dtype=torch.float64,
                                param_dtype=torch.float64)
    with torch.inference_mode():
        exact = tfm.forward(tree_map(lambda t: t.double(), host), tokens,
                            cfg64)[0]
    card_fwd = got["forward"].cpu()
    out["check"] = {"layers": LM_CHECK_LAYERS, "dtype": "float32",
                    "tf32": torch.backends.cuda.matmul.allow_tf32,
                    "tokens": LM_CHECK_TOKENS,
                    "prompt": LM_CHECK_PROMPT, "rel_err": errs,
                    "max_rel_err": max(errs.values()), "tol": LM_CHECK_TOL,
                    "forward_vs_float64": {
                        "card": _rel_err(card_fwd, exact),
                        "cpu": _rel_err(want["forward"], exact)},
                    "card_s": card_s, "cpu_s": host_s}
    if not max(errs.values()) <= LM_CHECK_TOL:
        # not a retry: the check has failed; this says whether each side
        # computes its forward again bit for bit, and where they part
        with torch.inference_mode():
            again = {"card": tfm.forward(card, tokens.to(DEVICE),
                                         cfg32)[0].cpu(),
                     "cpu": tfm.forward(host, tokens, cfg32)[0]}
        diff = (card_fwd - want["forward"]).abs()[0]       # [S, V]
        worst = int(diff.argmax())
        pos_err = diff.norm(dim=-1) / want["forward"][0].norm(dim=-1)
        diag = {"forward_vs_float64": out["check"]["forward_vs_float64"],
                "card_repeats": bool(torch.equal(again["card"], card_fwd)),
                "cpu_repeats": bool(torch.equal(again["cpu"],
                                                want["forward"])),
                "worst_position_rel_err": [int(pos_err.argmax()),
                                           float(pos_err.max())],
                "worst_element": [worst // diff.shape[1],
                                  worst % diff.shape[1], float(diff.max())],
                "tf32": torch.backends.cuda.matmul.allow_tf32}
        out["check"]["diagnosis"] = diag
        problems.append(f"lm_serve: the card differs from the CPU {errs} "
                        f"{diag}")
    del card, host, got, want, exact, card_fwd
    _free(torch)

    # -- full depth, bf16 ------------------------------------------------
    cfg = dataclasses.replace(full, param_dtype=torch.bfloat16)
    (model, init_s) = _timed(torch, lambda: tfm.LM(cfg, device=DEVICE,
                                                   seed=seed))
    params = model.params()
    weights = _nbytes(params)
    total, active = lm_param_flops(cfg)
    out["weights"] = {"bytes": weights, "params": total, "active": active,
                      "init_s": init_s}
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)

    # prefill: one request at prefill_32k's length
    with torch.inference_mode():
        warm = torch.randint(0, cfg.vocab, (1, LM_WARMUP_TOKENS),
                             generator=gen, device=DEVICE)
        tfm.prefill(params, warm, cfg)
        prompt = torch.randint(0, cfg.vocab, (1, prefill_len), generator=gen,
                               device=DEVICE)
        _reset_peak(torch)
        (plog, pk, pv), secs = _timed(torch, lambda: tfm.prefill(
            params, prompt, cfg))
        peak = _peak_gib(torch)
        peak_bytes = torch.cuda.max_memory_allocated() \
            if DEVICE == "cuda" else None
        kv = [tuple(pk.shape), tuple(pv.shape)]
        del pk, pv
    flops = 2 * active * prefill_len + 2 * cfg.n_layers * cfg.n_heads \
        * cfg.head_dim * prefill_len * prefill_len
    out["prefill"] = {"tokens": prefill_len, "batch": 1, "s": secs,
                      "tokens_per_s": prefill_len / secs, "peak_gib": peak,
                      "peak_bytes": peak_bytes, "model_flops": flops,
                      "flop_per_s": flops / secs,
                      "share_of_bf16_peak": flops / secs / BF16_FLOPS_PER_S}
    if tuple(plog.shape) != (1, cfg.vocab) or kv != 2 * [(
            cfg.n_layers, 1, prefill_len, cfg.n_kv_heads, cfg.head_dim)] \
            or not bool(torch.isfinite(plog).all()):
        problems.append(f"lm_serve: prefill gave {tuple(plog.shape)}, {kv}: "
                        "not finite or not the shapes")
    del plog, prompt
    _free(torch)

    # decode at decode_32k's cache length
    _reset_peak(torch)
    with torch.inference_mode():
        prompts = torch.randint(0, cfg.vocab,
                                (LM_DECODE_BATCH, LM_DECODE_PROMPT),
                                generator=gen, device=DEVICE)
        logits, fed, step_s, plog, more, profile, peaks = _greedy_decode(
            torch, tfm, params, cfg, prompts, cache_len, LM_DECODE_STEPS)
    peak = peaks["gib"]
    problems.extend(f"lm_serve: {m}" for m in more)
    width = torch.finfo(cfg.dtype).bits // 8
    cache_bytes = 2 * cfg.n_layers * LM_DECODE_BATCH * cache_len \
        * cfg.n_kv_heads * cfg.head_dim * width
    step_bytes = weights - _nbytes(params["embed"]) \
        + LM_DECODE_BATCH * cfg.d_model * width + cache_bytes
    med = statistics.median(step_s)
    out["decode"] = {"batch": LM_DECODE_BATCH, "cache_len": cache_len,
                     "prompt": LM_DECODE_PROMPT, "steps": LM_DECODE_STEPS,
                     "step_ms": [s * 1e3 for s in step_s],
                     "ms_per_step_median": med * 1e3,
                     "tokens_per_s": LM_DECODE_BATCH * len(step_s)
                     / sum(step_s),
                     "bound_bytes": step_bytes,
                     "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
                     "cache_bytes": cache_bytes, "peak_gib": peak,
                     "step_peak_bytes": peaks["step_bytes"],
                     "profiled_step": profile}

    # each step against forward's teacher-forced logits
    with torch.inference_mode():
        seq = torch.cat([prompts, fed], 1)
        fwd, _ = tfm.forward(params, seq, cfg)
        fwd = fwd[:, LM_DECODE_PROMPT - 1:].float()     # [B, 1 + steps, V]
    del seq
    rel, diffs, margins, agree, bad = [], [], [], 0, []
    for i, lg in enumerate(logits):
        want, lg = fwd[:, 1 + i], lg.float()
        rel.append(_rel_err(lg, want))
        diff = (lg - want).abs().amax(-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = lg.argmax(-1) == want.argmax(-1)
        agree += int(same.sum())
        must = margin > 2 * diff
        if bool((must & ~same).any()):
            bad.append(i)
        diffs.append([float(x) for x in diff])
        margins.append([float(x) for x in margin])
    prefill_rel = _rel_err(plog.float(), fwd[:, 0])
    out["decode_vs_forward"] = {
        "rel_err": rel, "max_rel_err": max(rel), "tol": LM_DECODE_TOL,
        "prefill_rel_err": prefill_rel, "max_abs_diff": diffs,
        "top2_margin": margins, "greedy_agree": agree,
        "greedy_of": LM_DECODE_BATCH * len(logits)}
    if not max(rel) <= LM_DECODE_TOL:
        problems.append(f"lm_serve: decode differs from forward by "
                        f"{max(rel)} > {LM_DECODE_TOL}")
    if bad:
        problems.append(f"lm_serve: the greedy token differs where the "
                        f"margin exceeds twice the difference, steps {bad}")
    del fwd, logits, plog, model, params
    _free(torch)
    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        problems.append(f"lm_serve: a hand-written kernel launched "
                        f"{out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out


def _moe_loop(torch, x, p):
    """An explicit per-token loop over the same gates' top-2 experts
    (renormalised): ``silu(x·w1[e]) * (x·w3[e]) · w2[e]``, weighted and
    summed in float32."""
    F = torch.nn.functional
    gates = torch.softmax((x @ p["wg"]).float(), dim=-1)
    topw, topi = torch.topk(gates, 2, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[0]):
        for k in range(2):
            e = int(topi[t, k])
            h = F.silu(x[t] @ p["w1"][e]) * (x[t] @ p["w3"][e])
            out[t] += topw[t, k] * (h @ p["w2"][e]).float()
    return out


def phase_moe_serve(torch, seed: int):
    """arctic-480b's MoE path on the card at full width (128 experts of
    7,168 x 4,864, top-2, the dense residual FFN, 56 query heads), 2 of
    its 35 layers, bf16 (its own ``param_dtype``), seeded random weights:

      prefill   one request of 8,192 tokens (at 32,768 the 56-head score
                blocks beside 55.4 GB of weights pass 80 GB): seconds,
                tokens/s, each layer's share of token-expert assignments
                dropped at ``capacity_factor`` 1.25, ``lb`` and ``z``;
      decode    batch 4, 4 prompts of 2,048 tokens prefilled into a
                ``decode_32k``-length cache, 16 greedy steps (capacity 4
                at T = 4: no token is dropped): ms a step, tokens/s,
                and on every step layer 0's ``moe_ffn`` output against an
                explicit per-token loop on the card (relative Frobenius
                at most 1e-2, bf16).

    No hand-written kernel runs on this path: the four launch counters
    must read 0."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    _zero_launches()
    arch = get_arch(MOE_ARCH)
    full = arch.config
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    cache_len = arch.shape("decode_32k").seq_len
    problems = []
    out = {"phase": "moe_serve", "arch": MOE_ARCH,
           "config": {k: getattr(full, k) for k in (
               "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
               "n_experts", "moe_topk", "capacity_factor", "residual_d_ff",
               "vocab", "attn_chunk")},
           "cuts": {"depth": f"{MOE_LAYERS} of {full.n_layers} layers",
                    "prefill": f"{MOE_PREFILL} tokens of prefill_32k's "
                               f"{arch.shape('prefill_32k').seq_len}, "
                               "batch 1",
                    "decode": f"batch {MOE_DECODE_BATCH} of decode_32k's "
                              f"{arch.shape('decode_32k').global_batch}"}}
    (model, init_s) = _timed(torch, lambda: tfm.LM(cfg, device=DEVICE,
                                                   seed=seed))
    params = model.params()
    out["weights"] = {"bytes": _nbytes(params), "init_s": init_s}

    # record each moe_ffn call's input, weights and output (references
    # only: nothing is computed inside the timed runs)
    calls = []
    real = tfm.moe_ffn

    def recording(x, p, c, axes=None):
        y = real(x, p, c, axes=axes)
        calls.append((x, p, y[0]))
        return y

    tfm.moe_ffn = recording
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
        with torch.inference_mode():
            warm = torch.randint(0, cfg.vocab, (1, LM_WARMUP_TOKENS),
                                 generator=gen, device=DEVICE)
            tfm.prefill(params, warm, cfg)
            prompt = torch.randint(0, cfg.vocab, (1, MOE_PREFILL),
                                   generator=gen, device=DEVICE)
            calls.clear()
            _reset_peak(torch)
            (plog, _, _), secs = _timed(torch, lambda: tfm.prefill(
                params, prompt, cfg))
            peak = _peak_gib(torch)
            layers = []
            for x, p, _ in calls:
                cap = moe._capacity(cfg, x.shape[0])
                _, (slot, _, _), lb, z = moe._dispatch_group(x, p, cfg, cap)
                dropped = int((slot == cfg.n_experts * cap).sum())
                layers.append({"capacity": cap, "dropped": dropped,
                               "dropped_share": dropped / slot.numel(),
                               "lb": float(lb), "z": float(z)})
        out["prefill"] = {"tokens": MOE_PREFILL, "s": secs,
                          "tokens_per_s": MOE_PREFILL / secs,
                          "peak_gib": peak, "layers": layers}
        if len(layers) != MOE_LAYERS or tuple(plog.shape) != (
                1, cfg.vocab) or not bool(torch.isfinite(plog).all()):
            problems.append(f"moe_serve: prefill gave {tuple(plog.shape)} "
                            f"over {len(layers)} MoE calls")
        del plog, prompt
        calls.clear()
        _free(torch)

        loop_err = []

        def check(i):
            x, p, y = calls[-cfg.n_layers]      # layer 0 of this step
            if x.shape[0] != MOE_DECODE_BATCH:
                problems.append(f"moe_serve: step {i} routed {x.shape[0]} "
                                "tokens")
            loop_err.append(_rel_err(y, _moe_loop(torch, x, p)))
            calls.clear()

        _reset_peak(torch)
        with torch.inference_mode():
            prompts = torch.randint(0, cfg.vocab,
                                    (MOE_DECODE_BATCH, MOE_DECODE_PROMPT),
                                    generator=gen, device=DEVICE)

            logits, _, step_s, _, more, profile, peaks = _greedy_decode(
                torch, tfm, params, cfg, prompts, cache_len,
                MOE_DECODE_STEPS, on_step=check)
        peak = peaks["gib"]
    finally:
        tfm.moe_ffn = real
    problems.extend(f"moe_serve: {m}" for m in more)
    # a step reads every expert's weights (each expert's product runs
    # over its capacity rows, empty or not) and the whole cache
    width = torch.finfo(cfg.dtype).bits // 8
    step_bytes = out["weights"]["bytes"] - _nbytes(params["embed"]) \
        + MOE_DECODE_BATCH * cfg.d_model * width + 2 * cfg.n_layers \
        * MOE_DECODE_BATCH * cache_len * cfg.n_kv_heads * cfg.head_dim * width
    out["decode"] = {"batch": MOE_DECODE_BATCH, "cache_len": cache_len,
                     "prompt": MOE_DECODE_PROMPT, "steps": MOE_DECODE_STEPS,
                     "capacity": moe._capacity(cfg, MOE_DECODE_BATCH),
                     "step_ms": [s * 1e3 for s in step_s],
                     "ms_per_step_median": statistics.median(step_s) * 1e3,
                     "tokens_per_s": MOE_DECODE_BATCH * len(step_s)
                     / sum(step_s),
                     "loop_rel_err": loop_err,
                     "max_loop_rel_err": max(loop_err),
                     "loop_tol": MOE_LOOP_TOL, "peak_gib": peak,
                     "step_peak_bytes": peaks["step_bytes"],
                     "bound_bytes": step_bytes,
                     "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
                     "profiled_step": profile}
    if len(loop_err) != MOE_DECODE_STEPS \
            or not max(loop_err) <= MOE_LOOP_TOL:
        problems.append(f"moe_serve: moe_ffn differs from the per-token "
                        f"loop: {loop_err}")
    del logits, model, params
    _free(torch)
    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        problems.append(f"moe_serve: a hand-written kernel launched "
                        f"{out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out


# --------------------------------------------------------------------- #
# LM training (qwen3-14b) and the dry run of its cells
# --------------------------------------------------------------------- #
LM_TRAIN_LAYERS = 2        # of qwen3-14b's 40: the cut is depth only
LM_TRAIN_BATCH = 8         # train_4k's batch 256, cut; its 4 microbatches kept
LM_TRAIN_STEPS = 5         # timed bf16 steps, after one warm-up step
LM_TRAIN_LR = 3e-4         # train_lm's
LM_TRAIN_CHECK = (2, 64, 2)     # (a): sequences, tokens each, microbatches
LM_TRAIN_CHECK_LAYERS = 1  # (a)'s depth, cut from 2 for the script's time
LM_TRAIN_CHECK_TOL = 1e-4  # float32, TF32 off: relative (PERF.md §2)
LM_TRAIN_MB_SEQ = 512      # (b): 8 sequences of 512, 4 microbatches against 1
LM_TRAIN_MB_TOL = 1e-4     # bf16 products, float32 sums: relative; read at
                           # 7.7e-8 (loss), 5.8e-6 (grad_norm): PERF.md §2
LM_TRAIN_RUN = ("small", 300, 100, 200)   # (d): profile, steps, every, resume
LM_TRAIN_RESUME_TOL = 1e-4  # the resumed run's losses: float32 reordering
CHECK_CHUNK = 1 << 26      # elements of a leaf compared at a time
DRYRUN_PEAK_TOL = 0.15     # a reckoned peak against the measured one
# qwen3-14b's cells traced per device on pod16x16 (None: also on one
# card; train_4k's one-card trace takes minutes of host time)
DRYRUN_MESH_SHAPES = {"decode_32k": (None, False), "train_4k": (False,)}
DRYRUN_MESH_WAIT_S = 600   # the traces' process, beside the LM phases


def _mem_available() -> int:
    """The host's MemAvailable in bytes (/proc/meminfo), 0 if unread."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _lm_step_checks(torch, got, want, lr: float, tol: float, ocfg) -> tuple:
    """One LM train step from the same parameters and a zero AdamW state
    on the card (``got``) and on the CPU (``want``), each (params tree,
    opt state, loss, grad_norm): ``_step_checks``' rules at ``lr``, each
    leaf compared ``CHECK_CHUNK`` elements at a time on the card (a
    float64 copy of the 3.1 GB embedding table and its moments would not
    fit beside the CPU's step).  Returns (fields, problems)."""
    from repro_torch.optim.tree import flatten, flatten_up_to

    (gp, gs, gl, gn), (wp, ws, wl, wn) = got, want
    problems = []
    loss_rel = abs(float(gl) - float(wl)) / max(abs(float(wl)), 1e-30)
    gn_rel = abs(float(gn) - float(wn)) / max(abs(float(wn)), 1e-30)
    if not (loss_rel <= tol and gn_rel <= tol):
        problems.append(f"loss / grad_norm rel err {loss_rel} / {gn_rel} "
                        f"> {tol}")
    g_leaves, w_leaves = flatten(gp), flatten(wp)
    g_st = flatten_up_to(gp, gs["leaves"])
    w_st = flatten_up_to(wp, ws["leaves"])
    grad_rel, param_ratio = 0.0, 0.0
    for i in range(len(g_leaves)):
        flat = {"gm": g_st[i]["m"], "gv": g_st[i]["v"], "wm": w_st[i]["m"],
                "wv": w_st[i]["v"], "gp": g_leaves[i], "wp": w_leaves[i]}
        flat = {k: v.detach().reshape(-1) for k, v in flat.items()}
        scale = float(flat["wm"].abs().max())
        err, ratio = 0.0, 0.0
        for lo in range(0, flat["gm"].numel(), CHECK_CHUNK):
            c = {k: v[lo:lo + CHECK_CHUNK].to(DEVICE) for k, v in flat.items()}
            err = max(err, float((c["gm"] - c["wm"]).abs().max()))
            sa = _adam_step(torch, {"m": c["gm"], "v": c["gv"]}, 1, ocfg)
            sb = _adam_step(torch, {"m": c["wm"], "v": c["wv"]}, 1, ocfg)
            p, q = c["gp"].double(), c["wp"].double()
            bound = lr * (sa - sb).abs() \
                + 16 * 2.0 ** -24 * (q.abs() + lr * (sb.abs() + 1))
            ratio = max(ratio, float(((p - q).abs() / bound).max()))
            del c, sa, sb, p, q, bound
        grad_rel = max(grad_rel, err / max(scale, 1e-30))
        param_ratio = max(param_ratio, ratio)
        if not err <= tol * scale:
            problems.append(f"leaf {i} gradient max |err| {err} > {tol} x "
                            f"{scale}")
        if not ratio <= 1.0:
            problems.append(f"leaf {i} parameters off their bound "
                            f"(x{ratio})")
    return {"loss": float(gl), "cpu_loss": float(wl),
            "loss_rel_err": loss_rel, "grad_norm": float(gn),
            "cpu_grad_norm": float(wn), "grad_norm_rel_err": gn_rel,
            "grad_max_rel_err": grad_rel,
            "param_err_over_bound": param_ratio, "tol": tol}, problems


def _lm_train_vs_cpu(torch, cfg, ocfg, seed: int):
    """Check (a): one float32 step (TF32 off) of ``cfg`` at full width on
    the card and on the CPU from the same parameters (drawn on the card,
    copied to the host), ``LM_TRAIN_CHECK``'s tokens in two
    microbatches, at ``LM_TRAIN_CHECK_LAYERS`` layers (the CPU side's
    step takes ~77 s at 2).  The CPU side holds the parameters, AdamW's
    two moments, the accumulator, a microbatch's gradients and the
    update's temporaries: at 2 layers ~51 GB; with less MemAvailable the
    check runs at 1 layer and says why."""
    import dataclasses

    from repro_torch.launch.cells import lm_param_flops, make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import tree_map

    n_seq, n_tok, n_mb = LM_TRAIN_CHECK
    avail = _mem_available()

    def need(layers):
        c = dataclasses.replace(cfg, n_layers=layers)
        p = lm_param_flops(c)[0] * 4
        return 4 * p + 5 * c.vocab * c.d_model * 4 + 4 * 2**30

    layers, why = min(cfg.n_layers, LM_TRAIN_CHECK_LAYERS), None
    if avail < need(layers):
        why = (f"MemAvailable {avail} B < {need(layers)} B reckoned for "
               f"{layers} layers on the CPU")
        layers = 1
    cfg32 = dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm_train: TF32 is on for float32 matmuls before the check")
    card = tfm.LM(cfg32, device=DEVICE, seed=seed)
    host = tfm.LM(cfg32, device="cpu",
                  params=tree_map(lambda t: t.detach().to("cpu", copy=True),
                                  card.params()))
    tokens = torch.randint(0, cfg.vocab, (n_seq, n_tok), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(seed + 5))
    step = make_lm_train_step(cfg32, ocfg, n_mb, lr=TRAIN_LR)
    (got, card_s), (want, host_s) = (
        _timed(torch, lambda: step(card, adamw_init(card.params(), ocfg),
                                   tokens.to(DEVICE))),
        _timed(torch, lambda: step(host, adamw_init(host.params(), ocfg),
                                   tokens)))
    fields, problems = _lm_step_checks(
        torch, (card.params(),) + got[1:], (host.params(),) + want[1:],
        TRAIN_LR, LM_TRAIN_CHECK_TOL, ocfg)
    fields.update({"layers": layers, "layers_cut_because": why,
                   "mem_available_bytes": avail,
                   "cpu_bytes_reckoned": need(layers), "dtype": "float32",
                   "tf32": torch.backends.cuda.matmul.allow_tf32,
                   "tokens": [n_seq, n_tok], "microbatches": n_mb,
                   "lr": TRAIN_LR, "card_s": card_s, "cpu_s": host_s})
    return fields, problems


def _train_lm_profile(torch, seed: int) -> tuple:
    """Check (d): ``train_lm`` at ``examples/torch_train_lm.py``'s profile
    on the card, checkpoints every 100 steps, then a second run resumed
    from a copy of the first run's checkpoints up to step 200.  Returns
    (fields, problems)."""
    import contextlib
    import importlib.util
    import io
    import shutil

    from repro_torch.launch.train import train_lm

    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", os.path.join(HERE, "examples", "torch_train_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    profile, n, every, resume = LM_TRAIN_RUN
    pcfg, batch, seq = example.profile_config(profile)
    root = os.path.join(HERE, "build", "lm_train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    whole, resumed = os.path.join(root, "whole"), os.path.join(root, "resumed")

    def run(ckpt_dir):
        with contextlib.redirect_stdout(io.StringIO()):
            return train_lm(pcfg, n, batch, seq, ckpt_dir, every, 20,
                            seed=seed, device=DEVICE)[1]

    want, whole_s = _timed(torch, lambda: run(whole))
    os.makedirs(resumed)
    for name in os.listdir(whole):
        if re.fullmatch(r"step_(\d+)\.(npz|json)", name) \
                and int(name.split("_")[1].split(".")[0]) <= resume:
            shutil.copy(os.path.join(whole, name), resumed)
    got, resumed_s = _timed(torch, lambda: run(resumed))
    shutil.rmtree(root, ignore_errors=True)
    tail = [(i, l) for i, l in want if i >= resume]
    problems = []
    if [i for i, _ in got] != [i for i, _ in tail]:
        problems.append(f"the resumed run logged steps {[i for i, _ in got]}"
                        f", not {[i for i, _ in tail]}")
    diff = max((abs(a - b) / abs(b) for (_, a), (_, b) in zip(got, tail)),
               default=float("inf"))
    if not diff <= LM_TRAIN_RESUME_TOL:
        problems.append(f"the resumed run's losses differ by {diff} > "
                        f"{LM_TRAIN_RESUME_TOL}")
    first, last = want[0][1], want[-1][1]
    if not last < 0.8 * first:
        problems.append(f"train_lm did not learn: loss {first} -> {last}")
    return {"profile": profile, "steps": n, "ckpt_every": every,
            "resumed_at": resume, "losses": want, "resumed_losses": got,
            "resumed_max_rel_diff": diff, "first_loss": first,
            "last_loss": last, "whole_s": whole_s,
            "resumed_s": resumed_s}, problems


def phase_lm_train(torch, seed: int):
    """qwen3-14b trained on the card at its published width (d 5,120, GQA
    40/8, hd 128, d_ff 17,408, vocab 151,936, qk_norm), bf16 compute on
    float32 masters, AdamW ``fp32`` (its ``opt_state_mode``),
    ``remat="full"``, 2 of its 40 layers (the cut is depth only), through
    ``launch.cells.make_lm_train_step`` and ``launch.train.train_lm``:

      (a) check     the card against the CPU in float32 (TF32 off), 2
                    sequences of 64 tokens in 2 microbatches, one step
                    from the same parameters: loss and grad_norm within
                    1e-4 relative, each gradient (the first moment)
                    within 1e-4 of its leaf's largest entry, every
                    parameter within lr·|Δstep| + 16 ulps;
      (b) microbatches  4 microbatches against 1 over the same 8
                    sequences of 512 tokens, bf16, at lr 0 (the
                    parameters stay): loss and grad_norm within 1e-2;
      (c) steps     ``train_4k``'s sequence of 4,096 and its 4
                    microbatches at a global batch of 8 (256 cut): 32,768
                    tokens a step, one warm-up step and 5 timed: step
                    seconds (median), tokens/s, the peak around each
                    step, model FLOP/s as 6·active·tokens over the step
                    time beside the dense bf16 peak, one more step's
                    device time by op; the loss finite at every step;
      (d) train_lm  ``examples/torch_train_lm.py``'s small profile, 300
                    steps with a checkpoint every 100, and a second run
                    resumed at step 200: the last loss under 0.8 × the
                    first, the resumed run's losses the uninterrupted
                    run's within 1e-4 relative;
      (e)           no hand-written kernel runs on this path: the four
                    launch counters read 0."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.cells import lm_param_flops, make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.tree import flatten

    t_phase = time.perf_counter()
    _zero_launches()
    arch = get_arch(LM_ARCH)
    full, shape = arch.config, arch.shape("train_4k")
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    ocfg = AdamWConfig(state_mode=arch.opt_state_mode)
    n_mb, seq = shape.microbatches, shape.seq_len
    problems = []
    out = {"phase": "lm_train", "arch": LM_ARCH,
           "config": {k: getattr(full, k) for k in (
               "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
               "vocab", "qk_norm", "rope_theta", "attn_chunk", "remat")},
           "dtype": "bfloat16", "param_dtype": "float32",
           "opt_state_mode": arch.opt_state_mode,
           "cuts": {"depth": f"{LM_TRAIN_LAYERS} of {full.n_layers} layers",
                    "batch": f"global batch {shape.global_batch} cut to "
                             f"{LM_TRAIN_BATCH}: {n_mb} microbatches of "
                             f"{LM_TRAIN_BATCH // n_mb} x {seq} tokens"}}
    print(f"lm_train: {out['cuts']['depth']}, {out['cuts']['batch']}",
          flush=True)

    # (a) the card against the CPU, float32
    out["check"], more = _lm_train_vs_cpu(torch, cfg, ocfg, seed)
    problems.extend(f"lm_train check: {m}" for m in more)
    if out["check"]["layers_cut_because"]:
        print(f"lm_train: the check runs at 1 layer: "
              f"{out['check']['layers_cut_because']}", flush=True)
    _free(torch)

    model = tfm.LM(cfg, device=DEVICE, seed=seed)
    opt = adamw_init(model.params(), ocfg)
    total, active = lm_param_flops(cfg)
    out["weights"] = {"params": total, "active": active,
                      "bytes": _nbytes(model.params()),
                      "adamw_bytes": _nbytes(opt)}

    # (b) microbatches: the same 8 sequences in 4 parts and in 1, lr 0.
    # At random weights every part's loss is near the mean, so grad_norm
    # is the number that shows a step that trained on part of the batch
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 6)
    toks = torch.randint(0, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_MB_SEQ),
                         generator=gen, dtype=torch.int32, device=DEVICE)
    by_mb = {}
    for n in (n_mb, 1):
        _, _, loss, gn = make_lm_train_step(cfg, ocfg, n, lr=0.0)(
            model, opt, toks)
        by_mb[n] = (float(loss), float(gn))
    (l4, g4), (l1, g1) = by_mb[n_mb], by_mb[1]
    rel = [abs(l4 - l1) / abs(l1), abs(g4 - g1) / abs(g1)]
    out["microbatches"] = {"tokens": [LM_TRAIN_BATCH, LM_TRAIN_MB_SEQ],
                           "loss": [l4, l1], "grad_norm": [g4, g1],
                           "rel_err": rel, "tol": LM_TRAIN_MB_TOL,
                           "of": [n_mb, 1]}
    if not max(rel) <= LM_TRAIN_MB_TOL:
        problems.append(f"lm_train: {n_mb} microbatches against 1: loss / "
                        f"grad_norm rel err {rel} > {LM_TRAIN_MB_TOL}")
    with torch.no_grad():            # a zero state again for the steps
        for t in flatten(opt):
            t.zero_()
    del toks
    _free(torch)

    # (c) timed bf16 steps at train_4k's sequence and microbatches
    step = make_lm_train_step(cfg, ocfg, n_mb, lr=LM_TRAIN_LR)
    tokens = LM_TRAIN_BATCH * seq
    batches = [torch.as_tensor(lm_batch(i, LM_TRAIN_BATCH, seq, cfg.vocab,
                                        seed), device=DEVICE)
               for i in range(LM_TRAIN_STEPS + 2)]
    losses, gnorms, secs, peaks = [], [], [], []
    for i in range(LM_TRAIN_STEPS + 1):         # step 0 warms up
        _reset_peak(torch)
        res, s = _timed(torch, lambda: step(model, opt, batches[i]))
        peaks.append(torch.cuda.max_memory_allocated()
                     if DEVICE == "cuda" else None)
        losses.append(float(res[2]))
        gnorms.append(float(res[3]))
        secs.append(s)
    warmup_s, secs = secs[0], secs[1:]
    profile = _op_device_ms(torch, lambda: step(model, opt, batches[-1])) \
        if DEVICE == "cuda" else {}
    med = statistics.median(secs)
    flops = 6 * active * tokens
    # the reference's model FLOPs count the embedding's vocab·d as a
    # product, but it runs as a gather (and its gradient as a scatter):
    # the products that run are the rest
    products = 6 * (active - cfg.vocab * cfg.d_model) * tokens
    out["steps"] = {"tokens_per_step": tokens, "warmup_s": warmup_s,
                    "step_s": secs, "step_s_median": med,
                    "tokens_per_s": tokens / med, "model_flops": flops,
                    "flop_per_s": flops / med,
                    "share_of_bf16_peak": flops / med / BF16_FLOPS_PER_S,
                    "product_flops": products,
                    "product_share_of_bf16_peak":
                        products / med / BF16_FLOPS_PER_S,
                    "peak_gib": max(peaks) / 2**30
                    if DEVICE == "cuda" else None,
                    "step_peak_bytes": peaks, "losses": losses,
                    "grad_norms": gnorms, "profiled_step": profile}
    if not all(map(math.isfinite, losses + gnorms)):
        problems.append(f"lm_train: a loss or grad_norm is not finite: "
                        f"{losses} {gnorms}")
    del model, opt, batches, res, step
    _free(torch)

    # (d) train_lm with checkpoints and a resume
    out["train_lm"], more = _train_lm_profile(torch, seed)
    problems.extend(f"lm_train train_lm: {m}" for m in more)

    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        problems.append(f"lm_train: a hand-written kernel launched "
                        f"{out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if problems:
        fail("; ".join(problems))
    return out


_MESH_DRYRUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.dryrun import run_cell
for shape, meshes in json.loads(sys.argv[3]).items():
    for mp in meshes:
        run_cell(sys.argv[4], shape, mp, out_dir=sys.argv[2], force=True)
"""


def start_mesh_dryrun():
    """The dryrun phase's production-mesh traces (``DRYRUN_MESH_SHAPES``,
    ``launch.dryrun.run_cell`` on the meta device, the "fake" backend:
    host work only) started in a process of their own, to run beside the
    card's phases.  -> a function that waits for it and returns the
    records by (shape, multi_pod); the process is stopped if this one
    exits first."""
    import atexit

    out_dir = os.path.join(HERE, "build", "dryrun_mesh")
    proc = subprocess.Popen(
        [sys.executable, "-c", _MESH_DRYRUN, os.path.join(HERE, "src"),
         out_dir, json.dumps(DRYRUN_MESH_SHAPES), LM_ARCH],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def wait() -> dict:
        try:
            _, err = proc.communicate(timeout=DRYRUN_MESH_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"dryrun: the production-mesh traces took over "
                 f"{DRYRUN_MESH_WAIT_S} s")
        if proc.returncode:
            fail(f"dryrun: the production-mesh traces exited "
                 f"{proc.returncode}: {err[-2000:]}")
        names = {None: "h100x1", False: "pod16x16", True: "pod2x16x16"}
        recs = {}
        for shape, meshes in DRYRUN_MESH_SHAPES.items():
            for mp in meshes:
                with open(os.path.join(out_dir, names[mp],
                                       f"{LM_ARCH}__{shape}.json")) as f:
                    recs[(shape, mp)] = json.load(f)
        return recs

    return wait


def phase_dryrun(torch, lm_serve: dict, lm_train: dict, mesh_dryrun):
    """``launch.dryrun.run_cell`` on three cut cells on the meta device,
    each built with the configuration the phase that ran it holds: the
    ``lm_train`` step (2 layers, float32 masters, global batch 8 in 4
    microbatches of 4,096), ``lm_serve``'s prefill of 32,768 tokens at
    batch 1 and one ``lm_serve`` decode step at batch 4 against a 32,768
    cache (40 layers, bf16 parameters).  Each reckoned peak beside the
    peak measured around that same call alone in this run (the counter
    reset just before it), and the reckoned FLOPs beside the model FLOPs;
    a reckoned peak more than 15% from the measured one fails.  Then the
    production-mesh traces (``start_mesh_dryrun``): a pod16x16 rank's
    peak must be at most the one card's and its collectives recorded."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.cells import cell_for
    from repro_torch.launch.dryrun import run_cell

    t_phase = time.perf_counter()
    arch = get_arch(LM_ARCH)
    full = arch.config
    train = dataclasses.replace(arch, config=dataclasses.replace(
        full, n_layers=LM_TRAIN_LAYERS))
    serve = dataclasses.replace(arch, config=dataclasses.replace(
        full, param_dtype=torch.bfloat16))
    cases = [
        ("lm_train step", train, dataclasses.replace(
            arch.shape("train_4k"), global_batch=LM_TRAIN_BATCH),
         lm_train["steps"]["step_peak_bytes"][-1]),
        ("lm_serve prefill", serve, dataclasses.replace(
            arch.shape("prefill_32k"), global_batch=1),
         lm_serve["prefill"]["peak_bytes"]),
        ("lm_serve decode step", serve, dataclasses.replace(
            arch.shape("decode_32k"), global_batch=LM_DECODE_BATCH),
         lm_serve["decode"]["step_peak_bytes"]),
    ]
    out_dir = os.path.join(HERE, "build", "dryrun_smoke")
    rows, problems = [], []
    for what, a, shape, measured in cases:
        rec = run_cell(a.arch_id, shape.name, out_dir=out_dir, force=True,
                       cell=cell_for(a, shape))
        if not rec["ok"]:
            problems.append(f"dryrun: {what} failed: {rec['error']}")
            continue
        reck = rec["memory"]["peak_bytes_per_device"]
        miss = abs(reck - measured) / measured if measured else None
        rows.append({"cell": what, "arch": a.arch_id, "shape": shape.name,
                     "batch": shape.global_batch,
                     "layers": a.config.n_layers,
                     "reckoned_peak_gib": reck / 2**30,
                     "measured_peak_gib": measured / 2**30
                     if measured else None,
                     "peak_miss": miss, "tol": DRYRUN_PEAK_TOL,
                     "reckoned_flops": rec["cost"]["flops"],
                     "model_flops": rec["meta"]["model_flops"],
                     "bytes_accessed": rec["cost"]["bytes accessed"],
                     "dominant": rec["roofline"]["dominant"],
                     "bound_s": rec["roofline"]["bound_s"],
                     "fits": rec["memory"]["fits"],
                     "trace_s": rec["wall_s"]})
        if miss is None or not miss <= DRYRUN_PEAK_TOL:
            problems.append(f"dryrun: {what} reckoned peak {reck} B against "
                            f"{measured} B measured (miss {miss})")
    # the production mesh, per device: rank 0 of pod16x16 under the
    # "fake" backend, beside the one card's reckoning of the same cell
    # (traced in a process of its own while the LM phases ran)
    mesh_rows = []
    recs = mesh_dryrun()
    for shape_name, meshes in DRYRUN_MESH_SHAPES.items():
        got = {}
        for mp in meshes:
            rec = recs[(shape_name, mp)]
            if not rec["ok"]:
                problems.append(f"dryrun: {LM_ARCH} {shape_name} on "
                                f"{rec['mesh']} failed: {rec['error']}")
                continue
            got[rec["mesh"]] = rec
        pod, one = got.get("pod16x16"), got.get("h100x1")
        if pod is None:
            continue
        row = {"arch": LM_ARCH, "shape": shape_name,
               "pod16x16_peak_gib_per_device": pod["memory"][
                   "peak_bytes_per_device"] / 2**30,
               "pod16x16_fits": pod["memory"]["fits"],
               "pod16x16_collectives": pod["collectives"]["n_ops"],
               "pod16x16_wire_bytes_per_device": pod["collectives"][
                   "total"],
               "pod16x16_flops_per_device": pod["cost"]["flops"],
               "pod16x16_dominant": pod["roofline"]["dominant"],
               "pod16x16_bound_s": pod["roofline"]["bound_s"],
               "trace_s": {k: r["wall_s"] for k, r in got.items()}}
        if one is not None:
            row["h100x1_peak_gib"] = one["memory"][
                "peak_bytes_per_device"] / 2**30
            if pod["memory"]["peak_bytes_per_device"] > \
                    one["memory"]["peak_bytes_per_device"]:
                problems.append(f"dryrun: {shape_name}: the pod16x16 "
                                "rank's peak is above the one card's")
        if not pod["collectives"]["n_ops"]:
            problems.append(f"dryrun: {shape_name} on pod16x16 issued no "
                            "collective")
        mesh_rows.append(row)
    emit({"phase": "dryrun", "mesh": "h100x1", "cells": rows,
          "production_mesh": mesh_rows,
          "note": "pod16x16 is the reference's 256-device shape reckoned "
                  "with one H100's constants, rank 0's program traced on "
                  "the meta device; no such machine was run",
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail("; ".join(problems))
    return rows


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
    products_graph = start_products_graph(args.seed)
    phase_build()
    phase_analysis()
    # the host arrays are ready before the timed phases begin
    products_host, products_make_s = products_graph()
    cases, worst = phase_kernels(torch, args.seed)
    masks, mask_launches = phase_masks(torch, args.seed)
    stream = make_stream(args.seed, args.ticks * BATCH)
    serve, qids, matches, snap, launches = phase_serve(torch, args, stream)
    phase_parity(torch, args, stream, qids, matches, snap)
    phase_profile(torch, args, stream)
    del qids, snap
    _free(torch)
    _, session_launches, session_by_slots = phase_session(torch, args,
                                                          stream)
    _free(torch)
    _, frontier_launches, frontier_by_slots = phase_frontier(torch, args,
                                                             stream)
    _free(torch)
    _, mesh_launches, mesh_by_slots, mesh_by_replicas = phase_mesh(
        torch, args, stream)
    _free(torch)
    _, capacity_launches, capacity_by_slots, cap = phase_capacity(
        torch, args, stream)
    _free(torch)
    _, ranks_launches, ranks_by_slots = phase_ranks(torch, args, stream,
                                                    cap, matches)
    del cap, matches
    _free(torch)
    _, sharded_launches = phase_sharded_cells(torch, args.seed)
    _free(torch)
    _, sjtree_launches, sjtree_by_slots = phase_sjtree(torch, args, stream)
    del stream
    _free(torch)
    bags = phase_embedding_bag(torch, args.seed)
    _, bag_launches = phase_recsys_serve(torch, args.seed)
    _, train_launches = phase_recsys_train(torch, args.seed)
    graph, graph_info = make_products_graph(torch, products_host,
                                            products_make_s)
    del products_host
    sums = phase_segment_sum(torch, args.seed, graph,
                             graph_info["max_in_degree"])
    _, sum_launches = phase_gin_infer(torch, args.seed, graph, graph_info)
    _free(torch)
    _, gat_cora_launches, gat_launches = phase_gat_infer(
        torch, args.seed, graph, graph_info)
    _, pna_launches = phase_pna_infer(torch, args.seed, graph, graph_info)
    _, nequip_launches = phase_nequip_infer(torch, args.seed)
    _, minibatch_launches = phase_minibatch_infer(torch, args.seed, graph,
                                                  graph_info)
    _free(torch)
    _, gnn_train_launches = phase_gnn_train(torch, args.seed, graph,
                                            graph_info)
    del graph
    _free(torch)
    _, example_launches = phase_examples(torch)
    if DEVICE == "cuda" and torch.cuda.memory_allocated() >= 2**30:
        fail(f"{torch.cuda.memory_allocated()} bytes still allocated on the "
             "card before the LM phases")
    mesh_dryrun = start_mesh_dryrun()
    lm_serve = phase_lm_serve(torch, args.seed)
    phase_moe_serve(torch, args.seed)
    _free(torch)
    lm_train = phase_lm_train(torch, args.seed)
    phase_dryrun(torch, lm_serve, lm_train, mesh_dryrun)

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

    # where the script's time goes: each phase's line, seconds from the start
    emit({"phase": "timing", "phase_end_s": dict(_PHASE_END),
          "script_s": time.perf_counter() - _T0})
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
              launches_mesh=mesh_launches,
              launches_mesh_by_slots={
                  str(k): v for k, v in sorted(mesh_by_slots.items())},
              launches_mesh_by_replicas=mesh_by_replicas,
              launches_capacity=capacity_launches,
              launches_capacity_by_slots={
                  str(k): v for k, v in sorted(capacity_by_slots.items())},
              launches_ranks=ranks_launches,
              launches_ranks_by_slots={
                  str(k): v for k, v in sorted(ranks_by_slots.items())},
              launches_sjtree=sjtree_launches,
              launches_sjtree_by_slots={
                  str(k): v for k, v in sorted(sjtree_by_slots.items())},
              launches_examples=example_launches["compat_join_pairs"],
              tolerance="equal"),
        entry("compat_mask", KERNEL_SOURCES["compat_join"], f"{cj}:279",
              mask_launches, masks, "l0_j1_window", also_replaces=f"{cj}:210",
              launches_path="core.join.compat_mask over the mask cases",
              tolerance="equal"),
        entry("embedding_bag", KERNEL_SOURCES["embedding_bag"],
              "src/repro/kernels/embedding_bag/kernel.py:59", bag_launches,
              bags, "wide_serve_bulk", launches_path="recsys_serve",
              launches_recsys_train=train_launches["embedding_bag"],
              launches_sharded_cells=sharded_launches["embedding_bag"],
              launches_examples=example_launches["embedding_bag"],
              tolerance="rtol 1e-5, atol 1e-6; N(0,1) D = 32: rtol 1e-5 "
                        "+ 2 n 2^-24 sum|row| per element; integer D = 32: "
                        "equal"),
        entry("segment_sum", KERNEL_SOURCES["segment_reduce"],
              "src/repro/kernels/segment_reduce/kernel.py:59", sum_launches,
              sums, "gin_l1_bf16", launches_path="gin_infer",
              launches_gat_cora=gat_cora_launches,
              launches_gat=gat_launches, launches_pna=pna_launches,
              launches_nequip=nequip_launches,
              launches_minibatch=minibatch_launches,
              launches_gnn_train=gnn_train_launches,
              launches_embedding_bag_backward=train_launches["segment_sum"],
              launches_sharded_cells=sharded_launches["segment_sum"],
              launches_examples=example_launches["segment_sum"],
              tolerance="bf16: rtol 1e-2 + 2 deg 2^-24 sum|msg| per element; "
                        "float32 integer messages: equal; every case's bits "
                        "equal ref.segment_sum_ordered's (where it fits), a "
                        "second call's and an order-keeping permutation's"),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
