"""The port's CUDA kernels on the card (marker ``gpu``; skips without a
CUDA device).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The compat-join kernels must agree with their plain versions element for
element (pairs in row-major order, overflow included, also where
``max_new`` falls on and inside a (row, B tile) cell; masks byte for
byte, ragged rows and tiny tables included), and a CUDA-backend slot
group must tick bit-identically to the REF backend on the card, and a
replica-sharded service (R logical replicas on the card) as the
single-device service.  The embedding_bag and segment_sum kernels sum
in float32 in another order than their plain versions: float32 within
rtol 1e-5 / atol 1e-5, bfloat16 within one bfloat16 rounding (rtol 1e-2
/ atol 1e-2); the segment_sum kernel also equals its own order in plain
torch (``ref.segment_sum_ordered``) bit for bit, twice.  The segment_sum edge cases (a hub node with 40% of the
edges, D from 1 to 65536, unaligned messages, no edges) use
integer-valued float32 messages, which must sum exactly, and bf16
messages held to one bf16 rounding plus the float32 summation bound.
One embedding_bag call must be one device kernel.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.multi import (
    build_slot_tick,
    init_slot_state,
    write_slot,
)
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.state import make_batch
from repro_torch.kernels.compat_join import ops, ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.stream.generator import (
    StreamConfig,
    synth_traffic_stream,
    to_batches,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaves(t):
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("n_slots,ca,cb,max_new,window", [
    (1, 1000, 300, 4096, None),
    (4, 3000, 257, 64, 30),          # overflow, ragged B
    (3, 77, 5000, 2048, 12),
])
@pytest.mark.parametrize("shared_b", [False, True])
def test_kernel_equals_plain_version(cuda, n_slots, ca, cb, max_new, window,
                                     shared_b):
    rng = np.random.default_rng(ca + cb)
    rel = np.array([[True, False, False], [False, False, True]])
    trel = np.array([[-1, 0], [0, 1]], np.int8)
    lead_b = () if shared_b else (n_slots,)

    def t(x):
        return torch.as_tensor(x, device=cuda)

    args = (t(rng.integers(0, 20, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.integers(0, 50, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.random((n_slots, ca)) < 0.8),
            t(rng.integers(0, 20, lead_b + (cb, 3), dtype=np.int32)),
            t(rng.integers(0, 50, lead_b + (cb, 2), dtype=np.int32)),
            t(rng.random((n_slots, cb)) < 0.8))
    win = None if window is None else \
        t(np.full((n_slots,), window, np.int32))
    before = ops.compat_join_pairs.launches
    got = ops.compat_join_pairs(*args, rel, trel, max_new, win)
    assert ops.compat_join_pairs.launches == before + 1
    want = ref.compat_join_pairs(*args, rel, trel, max_new, win)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


def test_cuda_slot_tick_equals_ref_slot_tick(cuda):
    q = QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                   prec=frozenset({(0, 1), (1, 2)}))
    q2 = QueryGraph(5, (0, 1, 2, 1, 2), ((0, 1), (1, 2), (0, 3), (3, 4)),
                    prec=frozenset({(0, 1), (2, 3)}))
    stream = synth_traffic_stream(StreamConfig(
        n_edges=600, n_vertices=12, n_vertex_labels=3, n_edge_labels=2,
        seed=5, ts_step_max=2))
    for query in (q, q2):
        plans = [compile_plan(query, w, level_capacity=1024,
                              l0_capacity=1024, max_new=256)
                 for w in (20, 35, 50)]
        ticks = {b: build_slot_tick(plans[0], backend=b)
                 for b in ("ref", "cuda")}
        states = {}
        for b in ticks:
            st = init_slot_state(plans[0], 4, device=cuda)
            for k, p in enumerate(plans):
                write_slot(st, plans[0], k, p)
            states[b] = st
        for batch in to_batches(stream, 32):
            eb = make_batch(**batch, device=cuda)
            res = {}
            for b in ticks:
                states[b], res[b] = ticks[b](states[b], eb)
            for x, y in zip(_leaves(states["ref"]) + _leaves(res["ref"]),
                            _leaves(states["cuda"]) + _leaves(res["cuda"])):
                assert torch.equal(x, y)
        assert int(states["cuda"].engines.stats.n_matches_total.sum()) > 0


def test_cuda_single_query_tick_equals_ref_tick(cuda):
    """``build_tick`` (one query, S = 1 of the same launch) on the CUDA
    backend against REF, with a watermark."""
    from repro_torch.core.engine import build_tick
    from repro_torch.core.state import init_state

    q = QueryGraph(5, (0, 1, 2, 1, 2), ((0, 1), (1, 2), (0, 3), (3, 4)),
                   prec=frozenset({(0, 1), (2, 3)}))
    plan = compile_plan(q, 30, level_capacity=512, l0_capacity=512,
                        max_new=128)
    stream = synth_traffic_stream(StreamConfig(
        n_edges=400, n_vertices=10, n_vertex_labels=3, n_edge_labels=2,
        seed=9, ts_step_max=2))
    ticks = {b: build_tick(plan, backend=b, device=cuda)
             for b in ("ref", "cuda")}
    states = {b: init_state(plan, device=cuda) for b in ticks}
    for batch in to_batches(stream, 16):
        eb = make_batch(**batch, device=cuda)
        wm = int(batch["ts"][batch["valid"]].max()) - 2
        res = {}
        for b in ticks:
            states[b], res[b] = ticks[b](states[b], eb, wm)
        for x, y in zip(_leaves(states["ref"]) + _leaves(res["ref"]),
                        _leaves(states["cuda"]) + _leaves(res["cuda"])):
            assert torch.equal(x, y)
    assert int(states["cuda"].stats.n_matches_total) > 0


@pytest.mark.parametrize("n_slots,ca,cb,window", [
    (1, 1000, 300, None),
    (4, 3000, 1500, 30),             # several B chunks, ragged
    (3, 77, 5000, 12),
])
@pytest.mark.parametrize("shared_b", [False, True])
def test_mask_kernel_equals_plain_version(cuda, n_slots, ca, cb, window,
                                          shared_b):
    rng = np.random.default_rng(ca * cb)
    rel = np.array([[True, False, False], [False, False, True]])
    trel = np.array([[-1, 0], [0, 1]], np.int8)
    lead_b = () if shared_b else (n_slots,)

    def t(x):
        return torch.as_tensor(x, device=cuda)

    args = (t(rng.integers(0, 20, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.integers(0, 50, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.random((n_slots, ca)) < 0.8),
            t(rng.integers(0, 20, lead_b + (cb, 3), dtype=np.int32)),
            t(rng.integers(0, 50, lead_b + (cb, 2), dtype=np.int32)),
            t(rng.random((n_slots, cb)) < 0.8))
    win = None if window is None else \
        t(np.full((n_slots,), window, np.int32))
    before = ops.compat_mask.launches
    got = ops.compat_mask(*args, rel, trel, win)
    assert ops.compat_mask.launches == before + 1
    want = ref.compat_mask(*args, rel, trel, win)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert bool(got.any())


# (rel, trel) per plan shape for the edge cases: a few "must equal" pairs,
# both timing orders
CJ_SPECS = {
    (2, 2, 1, 1): (np.array([[False, False], [True, False]]),
                   np.array([[-1]], np.int8)),
    (3, 2, 2, 1): (np.array([[False, False], [False, False], [True, False]]),
                   np.array([[0], [-1]], np.int8)),
    (5, 3, 2, 2): (np.eye(5, 3, dtype=bool) * np.array([1, 0, 1], bool),
                   np.array([[-1, 0], [0, 1]], np.int8)),
}

# name, slots, CA, CB, dims, vertex ids
CJ_EDGE_CASES = [
    ("cb_17", 3, 300, 17, (3, 2, 2, 1), 12),     # below 32, 16 and TB
    ("cb_1030_two_a_tiles", 2, 1500, 1030, (2, 2, 1, 1), 20),
    ("ca_1", 4, 1, 3000, (2, 2, 1, 1), 4),
    ("all_a_invalid", 2, 700, 900, (2, 2, 1, 1), 4),
    ("b_tile_without_valid_rows", 2, 600, 2600, (2, 2, 1, 1), 6),
    ("off_list_nva_5", 2, 500, 700, (5, 3, 2, 2), 60),
    ("window_wraps_int32", 3, 400, 600, (2, 2, 1, 1), 4),
]


def _cj_case(cuda, case, n_slots, ca, cb, dims, n_v, shared_b, window):
    rng = np.random.default_rng(ca * 7 + cb)
    nva, nvb, nea, neb = dims
    lead_b = () if shared_b else (n_slots,)
    ea = rng.integers(0, 60, (n_slots, ca, nea))
    eb = rng.integers(20, 80, lead_b + (cb, neb))
    if case == "window_wraps_int32":
        # A just above INT32_MIN, B just below INT32_MAX: a < b holds and
        # the span max - min wraps to a negative int32, below any window
        ea, eb = ea - 2**31, eb + 2**31 - 100
    va = rng.random((n_slots, ca)) < 0.7
    vb = rng.random((n_slots, cb)) < 0.7
    if case == "all_a_invalid":
        va[:] = False
    if case == "b_tile_without_valid_rows":
        vb[:, 1024:2048] = False             # the second tile of 1024
    args = [torch.as_tensor(x, device=cuda) for x in (
        rng.integers(0, n_v, (n_slots, ca, nva), dtype=np.int32),
        ea.astype(np.int32), va,
        rng.integers(0, n_v, lead_b + (cb, nvb), dtype=np.int32),
        eb.astype(np.int32), vb)]
    win = None if window is None else torch.as_tensor(
        np.full((n_slots,), window, np.int32), device=cuda)
    return args, win


def _pairs_equal_plain(args, rel, trel, max_new, win):
    before = ops.compat_join_pairs.launches
    got = ops.compat_join_pairs(*args, rel, trel, max_new, win)
    assert ops.compat_join_pairs.launches == before + 1
    want = ref.compat_join_pairs(*args, rel, trel, max_new, win)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("shared_b", [False, True])
@pytest.mark.parametrize("case,n_slots,ca,cb,dims,n_v", CJ_EDGE_CASES,
                         ids=[c[0] for c in CJ_EDGE_CASES])
def test_compat_kernels_edge_cases(cuda, case, n_slots, ca, cb, dims, n_v,
                                   shared_b, window):
    """The pair kernels element for element and the mask kernel byte for
    byte against their plain versions: ragged and tiny tables (the mask's
    masked tail: rows of 17 and 1030 bytes start off the 16-byte grid),
    CA = 1, no valid A row, a B tile without a valid row, a shape off the
    instantiation list, a window whose span wraps in int32; shared and
    slot-stacked B, with and without a window."""
    rel, trel = CJ_SPECS[dims]
    args, win = _cj_case(cuda, case, n_slots, ca, cb, dims, n_v, shared_b,
                         window)
    got = _pairs_equal_plain(args, rel, trel, 4096, win)
    before = ops.compat_mask.launches
    mask = ops.compat_mask(*args, rel, trel, win)
    assert ops.compat_mask.launches == before + 1
    want = ref.compat_mask(*args, rel, trel, win)
    torch.cuda.synchronize()
    assert mask.dtype == torch.bool and torch.equal(mask, want)
    if case == "all_a_invalid":
        assert not bool(got[2].any()) and not bool(mask.any())
    else:
        assert bool(got[2].any())
    if case == "window_wraps_int32" and window is not None:
        # the spans wrap: without the int32 arithmetic nothing would match
        assert bool(mask.any())


@pytest.mark.parametrize("where", ["on_cell_start", "inside_cell",
                                   "on_cell_end"])
def test_pair_kernel_overflow_at_cell_boundaries(cuda, where):
    """max_new exactly where a (row, B tile) cell's pairs start, inside
    that cell, and where they end: the kept pairs are the row-major
    prefix and n_dropped is exact."""
    from repro_torch.kernels.compat_join import kernel as cj_kernel

    rel, trel = CJ_SPECS[(2, 2, 1, 1)]
    args, _ = _cj_case(cuda, "overflow", 2, 1300, 2100, (2, 2, 1, 1), 3,
                       True, None)
    tb = cj_kernel.plan(cj_kernel.PAIRS, 2, 1300, 2100, 2, 2, 1, 1,
                        (True,) * 3 + (False, False, True), False, 1).tb
    mask = ref.compat_mask(*args, rel, trel)[1].cpu().numpy()
    cells = np.stack([mask[:, i:i + tb].sum(1)
                      for i in range(0, 2100, tb)], 1).reshape(-1)
    start = np.concatenate([[0], np.cumsum(cells)])
    c = np.flatnonzero(cells > 2)[len(cells) // 3 % (cells > 2).sum()]
    max_new = int({"on_cell_start": start[c], "inside_cell": start[c] + 1,
                   "on_cell_end": start[c + 1]}[where])
    got = _pairs_equal_plain(args, rel, trel, max_new, None)
    assert int(got[3][1]) == int(mask.sum()) - max_new > 0


def _graph_ops(fn) -> dict:
    """The device operations of one call of ``fn``, read without the
    profiler (whose window can catch no launch): ``chip_smoke.py``'s
    ``_graph_ops``, which captures the call into a CUDA graph that is
    never run and lists its nodes.  -> {kernel name: nodes}."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_checks", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs._graph_ops(torch, fn)


def test_pair_call_launches_only_its_kernels(cuda):
    """One pair call is count, scan and emit and no other device
    operation (the outputs come straight from the kernels); one mask call
    is one kernel.  Read from a CUDA graph of one call (``_graph_ops``)."""
    rel, trel = CJ_SPECS[(2, 2, 1, 1)]
    args, win = _cj_case(cuda, "profile", 8, 4096, 1024, (2, 2, 1, 1), 20,
                         True, 40)
    ops.compat_join_pairs(*args, rel, trel, 512, win)      # build, warm up
    ops.compat_mask(*args, rel, trel, win)
    torch.cuda.synchronize()
    for fn, names in ((lambda: ops.compat_join_pairs(*args, rel, trel, 512,
                                                     win),
                       {"cj_count", "cj_scan", "cj_emit"}),
                      (lambda: ops.compat_mask(*args, rel, trel, win),
                       {"cj_mask"})):
        keys = _graph_ops(fn)
        assert keys == {n: 1 for n in names}, keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_bags,max_bag,d", [
    (512, 16, 1), (3000, 40, 1), (300, 16, 32), (200, 70, 100)])
def test_embedding_bag_kernel_equals_plain_version(cuda, n_bags, max_bag, d,
                                                   dtype):
    rng = np.random.default_rng(n_bags + d)
    sizes = rng.integers(0, max_bag + 1, n_bags)          # empty bags too
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), sizes)
    ids = rng.integers(0, 5000, bags.size).astype(np.int32)
    ids[rng.random(bags.size) < 0.25] = -1
    table = torch.randn((5000, d), device=cuda).to(dtype)
    args = (torch.as_tensor(ids, device=cuda),
            torch.as_tensor(bags, device=cuda), table, n_bags)
    before = eb_ops.embedding_bag.launches
    got = eb_ops.embedding_bag(*args)
    assert eb_ops.embedding_bag.launches == before + 1
    want = eb_ref.embedding_bag(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n_bags, d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[torch.as_tensor(sizes == 0, device=cuda)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,d", [(100_000, 5000, 1), (200_000, 3000, 64),
                                   (50_000, 20_000, 100)])
def test_segment_sum_kernel_equals_plain_version(cuda, e, n, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(e + d)
    dst = torch.randint(-50, n + 50, (e,), generator=g, device=cuda,
                        dtype=torch.int32)                 # some dropped
    msg = torch.randn((e, d), generator=g, device=cuda).to(dtype)
    before = sr_ops.segment_sum.launches
    got = sr_ops.segment_sum(dst, msg, n)
    assert sr_ops.segment_sum.launches == before + 1
    want = sr_ref.segment_sum(dst, msg, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _eb_check(args, d, dtype, plain_args=None):
    before = eb_ops.embedding_bag.launches
    got = eb_ops.embedding_bag(*args)
    assert eb_ops.embedding_bag.launches == before + 1
    want = eb_ref.embedding_bag(*(plain_args or args))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (args[3], d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 32])
@pytest.mark.parametrize("case", ["empty_ends", "no_ids", "one_bag",
                                  "bag_of_100", "out_of_range"])
def test_embedding_bag_kernel_edge_cases(cuda, case, d, dtype):
    """Empty bags at the front and at the back, T = 0, n_bags = 1, a bag
    of 100 ids, and bags/ids outside their ranges (skipped)."""
    rng = np.random.default_rng(d)
    v = 700
    if case == "empty_ends":        # bags 0-4 and 45-49 get no ids
        n_bags = 50
        bags = np.repeat(np.arange(5, 45, dtype=np.int32),
                         rng.integers(1, 9, 40))
    elif case == "no_ids":
        n_bags, bags = 1, np.zeros(0, np.int32)
    elif case == "one_bag":
        n_bags, bags = 1, np.zeros(37, np.int32)
    elif case == "bag_of_100":
        n_bags = 3
        bags = np.repeat(np.arange(3, dtype=np.int32), [1, 100, 2])
    else:                           # bags -2, -1 and 9, 10 are skipped
        n_bags = 9
        bags = np.sort(rng.integers(-2, 11, 80)).astype(np.int32)
    ids = rng.integers(0, v, bags.size).astype(np.int32)
    ids[rng.random(bags.size) < 0.2] = -1
    if case == "out_of_range":
        ids[::7] = v + 3                            # past the table: skipped
    table = torch.randn((v, d), device=cuda).to(dtype)
    args = (torch.as_tensor(ids, device=cuda),
            torch.as_tensor(bags, device=cuda), table, n_bags)
    # the plain version indexes every id and bag: it gets the same sums
    # with the skipped entries made padding (ids -1 into bag 0)
    kept = (bags >= 0) & (bags < n_bags) & (ids >= 0) & (ids < v)
    plain = (torch.as_tensor(np.where(kept, ids, -1), device=cuda),
             torch.as_tensor(np.where(kept, bags, 0), device=cuda), table,
             n_bags)
    got = _eb_check(args, d, dtype, plain)
    filled = np.zeros(n_bags, bool)
    filled[bags[kept]] = 1
    assert not got[torch.as_tensor(~filled, device=cuda)].any()


@pytest.mark.parametrize("d", [1, 32])
def test_embedding_bag_launches_one_device_kernel(cuda, d):
    """One wrapper call is one device kernel (no scratch pass, no copy),
    read from a CUDA graph of one call (``_graph_ops``)."""
    n_bags = 512
    ids = torch.randint(-1, 1000, (n_bags * 16,), device=cuda,
                        dtype=torch.int32)
    bags = torch.arange(n_bags, dtype=torch.int32,
                        device=cuda).repeat_interleave(16)
    table = torch.randn((1000, d), device=cuda)
    eb_ops.embedding_bag(ids, bags, table, n_bags)         # build, warm up
    torch.cuda.synchronize()
    kernels = _graph_ops(lambda: eb_ops.embedding_bag(ids, bags, table,
                                                      n_bags))
    assert kernels == {"eb_bag_sum": 1}, kernels


def _sr_check(dst, msg, n):
    """The kernel against the plain version.  Integer-valued float32
    messages sum exactly in any order: equal.  bf16: one bf16 rounding
    (rtol 1e-2) plus the float32 summation bound 2 deg 2^-24 sum|msg|."""
    before = sr_ops.segment_sum.launches
    got = sr_ops.segment_sum(dst, msg, n)
    assert sr_ops.segment_sum.launches == before + 1
    want = sr_ref.segment_sum(dst, msg, n)
    torch.cuda.synchronize()
    assert got.dtype == msg.dtype and got.shape == (n, msg.shape[1])
    # the kernel's own order, bit for bit, and the same bits again
    assert torch.equal(got, sr_ref.segment_sum_ordered(dst, msg, n))
    assert torch.equal(got, sr_ops.segment_sum(dst, msg, n))
    if msg.dtype == torch.float32:
        assert torch.equal(got, want)
        return got
    ok = (dst >= 0) & (dst < n)
    seg = torch.where(ok, dst, n).long()
    deg = torch.bincount(seg, minlength=n + 1)[:n, None].float()
    abs_sum = torch.zeros((n + 1, msg.shape[1]), device=msg.device) \
        .index_add_(0, seg, msg.float().abs())[:n]
    tol = 1e-2 * want.float().abs() + 2 * deg * 2.0**-24 * abs_sum + 1e-6
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    return got


def _sr_msg(g, e, d, dtype, cuda, unaligned):
    """Messages [e, d]: small integers as float32 (exact sums), normal
    values as bf16; ``unaligned`` takes rows 1.. of an [e + 1, d] tensor,
    whose data_ptr is then off the 16-byte grid when the row bytes are."""
    rows = e + 1 if unaligned else e
    if dtype == torch.float32:
        msg = torch.randint(-4, 5, (rows, d), generator=g, device=cuda,
                            dtype=torch.float32)
    else:
        msg = torch.randn((rows, d), generator=g, device=cuda).to(dtype)
    return msg[1:] if unaligned else msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,d,hub,unaligned", [
    (200_000, 5000, 1, 0.4, False),       # segment_mean's count column
    (200_000, 5000, 3, 0.4, True),        # 12/6-byte rows: narrow loads
    (200_000, 5000, 64, 0.4, False),
    (100_000, 3000, 100, 0.4, True),      # msg[1:] of a GIN layer-1 width
    (30_000, 300, 300, 0.5, False),       # column chunks of a hub
    (300, 40, 65536, 0.0, False),         # 512 column chunks
    (100_000, 3_200_000, 8, 0.4, False),  # 22-bit keys: three passes
])
def test_segment_sum_kernel_cases(cuda, e, n, d, hub, unaligned, dtype):
    """One node takes ``hub`` of the edges, so it has many runs of RUN
    edges, summed in windows into the float32 scratch and combined in
    run order."""
    from repro_torch.kernels.segment_reduce import kernel as sr_kernel

    g = torch.Generator(device=cuda).manual_seed(e + d)
    dst = torch.randint(-20, n + 20, (e,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst[torch.rand((e,), generator=g, device=cuda) < hub] = n // 3
    msg = _sr_msg(g, e, d, dtype, cuda, unaligned)
    plan = sr_kernel.plan(e, n, d, msg.element_size(), msg.data_ptr() % 16)
    if hub:
        assert int((dst == n // 3).sum()) > plan.run
    if unaligned and d == 3:
        assert plan.vec == msg.element_size()
    assert plan.passes * 8 >= n.bit_length() > (plan.passes - 1) * 8
    got = _sr_check(dst, msg, n)
    if hub:
        assert bool(got[n // 3].float().abs().sum() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["no_edges", "all_dropped"])
def test_segment_sum_kernel_without_edges(cuda, case, dtype):
    """E = 0, and every dst outside [0, N): the output is all zeros."""
    n, d = 1000, 64
    e = 0 if case == "no_edges" else 50_000
    dst = torch.full((e,), -1, dtype=torch.int32, device=cuda)
    dst[::2] = n + 7
    msg = torch.ones((e, d), device=cuda, dtype=dtype)
    got = _sr_check(dst, msg, n)
    assert not got.any()


@pytest.mark.parametrize("d,dtype", [
    (64, torch.bfloat16), (376, torch.bfloat16), (75, torch.bfloat16),
    (32, torch.float32), (96, torch.float32), (288, torch.float32)])
def test_segment_sum_gradient_equals_plain(cuda, d, dtype):
    """At the GAT / PNA / NequIP widths: the kernel's forward inside its
    ``autograd.Function`` (one launch; the backward launches none) and
    its gradient, a gather, equal to the plain version's
    (``index_add_``'s own backward) element for element."""
    e, n = 100_000, 3000
    g = torch.Generator(device=cuda).manual_seed(d)
    dst = torch.randint(-20, n + 20, (e,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst[torch.rand((e,), generator=g, device=cuda) < 0.4] = n // 3
    msg = _sr_msg(g, e, d, dtype, cuda, False).requires_grad_(True)
    w = torch.randn((n, d), generator=g, device=cuda)
    before = sr_ops.segment_sum.launches
    out = sr_ops.segment_sum(dst, msg, n)
    (got,) = torch.autograd.grad((out.float() * w).sum(), msg)
    assert sr_ops.segment_sum.launches == before + 1
    (want,) = torch.autograd.grad(
        (sr_ref.segment_sum(dst, msg, n).float() * w).sum(), msg)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.no_grad():
        _sr_check(dst, msg, n)


def _gnn_graph(cuda, n=3000, e=40_000, d=16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst = torch.randint(0, n - 50, (e,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst[torch.rand((e,), generator=g, device=cuda) < 0.3] = 7     # a hub
    src[:100] = -1                                                # padding
    return {"x": torch.randn((n, d), generator=g, device=cuda),
            "edge_src": src, "edge_dst": dst}


@pytest.mark.parametrize("arch", ["gat", "pna"])
def test_gnn_on_card_equals_plain_version(cuda, arch):
    """GAT and PNA (smoke configs, float32) through the kernel equal the
    same module on the plain version (``backend = "ref"``) within float32
    summation noise (rtol 1e-5 / atol 1e-5), one launch per segment sum."""
    import dataclasses

    from repro_torch.configs import gat_cora, pna
    from repro_torch.models.gnn.models import GAT, PNA

    mod, cls = (gat_cora, GAT) if arch == "gat" else (pna, PNA)
    cfg = dataclasses.replace(mod.smoke_config(), d_in=16)
    model = cls(cfg, device=cuda, seed=1)
    graph = _gnn_graph(cuda)
    with torch.no_grad():
        before = sr_ops.segment_sum.launches
        got = model(graph)
        launches = sr_ops.segment_sum.launches - before
        model.backend = "ref"
        want = model(graph)
    assert launches == cfg.n_layers * (1 if arch == "gat" else 2)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_nequip_on_card_equals_plain_version(cuda):
    """NequIP (smoke config) energy and forces through the kernel and its
    backward equal the plain version's within float32 summation noise
    (energy rtol 1e-5, forces rtol 1e-4 / atol 1e-5 of the largest),
    three launches a layer."""
    import dataclasses

    from repro_torch.configs import nequip
    from repro_torch.models.gnn import nequip as NQ

    cfg = nequip.smoke_config()
    model = NQ.NequIP(cfg, device=cuda, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    n_mol, n_atoms = 16, 12
    pos = torch.rand((n_mol * n_atoms, 3), generator=g, device=cuda) * 6
    mol = torch.arange(n_mol * n_atoms, device=cuda) // n_atoms
    src, dst = torch.nonzero((mol[:, None] == mol[None])
                             & ~torch.eye(n_mol * n_atoms, dtype=torch.bool,
                                          device=cuda), as_tuple=True)
    graph = {"species": torch.randint(0, cfg.n_species, (n_mol * n_atoms,),
                                      generator=g, device=cuda),
             "pos": pos, "edge_src": src.int(), "edge_dst": dst.int(),
             "graph_ids": mol.int(), "n_graphs": n_mol}
    before = sr_ops.segment_sum.launches
    e, f = model.energy_and_forces(graph)
    assert sr_ops.segment_sum.launches - before == 3 * cfg.n_layers
    e_ref, f_ref = NQ.energy_and_forces(
        model.params(), graph, dataclasses.replace(model.cfg, backend="ref"))
    torch.testing.assert_close(e, e_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4,
                               atol=1e-5 * float(f_ref.abs().max()))


# --------------------------------------------------------------------- #
# the stateful serving stack on the card
# --------------------------------------------------------------------- #
def _share_queries():
    """Two 2-chain prefixes (label families), each aliased by three
    tenants that differ in a third edge joined in L0, plus a 3-chain."""
    out = []
    for fam in range(2):
        for k in range(3):
            out.append(QueryGraph(
                4, (fam, 1 + fam, 2, k % 3), ((0, 1), (1, 2), (1, 3)),
                edge_labels=(0, 1, k % 2), prec=frozenset({(0, 1)})))
    out.append(QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                          prec=frozenset({(0, 1), (1, 2)})))
    return out


def _serve_reports(svc, stream):
    from collections import Counter

    got = Counter()

    def on_match(qid, bind, ets):
        got.update((qid,) + tuple(map(int, b)) + tuple(map(int, e))
                   for b, e in zip(bind, ets))
    infos = []
    svc.serve_stream(stream, on_match=on_match, on_tick=infos.append,
                     batch_size=256, min_batch=256, max_batch=256)
    return got, infos


def test_sharing_on_card_equals_sharing_off_and_ref(cuda):
    """Prefix sharing on the CUDA backend: the forest's child ticks
    launch the pair kernel at S = 1, the suffix groups read the prefix
    view as a shared operand; per-tenant reports equal the unshared CUDA
    service's and the shared REF service's, every node table and state
    leaf included."""
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.service import ContinuousSearchService

    stream = synth_traffic_stream(StreamConfig(
        n_edges=4096, n_vertices=3000, n_vertex_labels=3, n_edge_labels=2,
        seed=7, ts_step_max=2))
    cap = dict(level_capacity=4096, l0_capacity=4096, max_new=1024)

    def svc(share, backend):
        s = ContinuousSearchService(
            slots_per_group=4, tick_cache=SlotTickCache(), backend=backend,
            enable_sharing=share, device="cuda", **cap)
        for q in _share_queries():
            s.register(q, 120)
        return s

    shared, plain, ref = svc(True, "cuda"), svc(False, "cuda"), \
        svc(True, "ref")
    assert shared.forest_stats().n_shared_nodes == 4
    before = ops.compat_join_pairs.launches
    got_s, infos = _serve_reports(shared, stream)
    launches = ops.compat_join_pairs.launches - before
    got_p, _ = _serve_reports(plain, stream)
    got_r, _ = _serve_reports(ref, stream)
    assert got_s == got_p == got_r and sum(got_s.values()) > 0
    assert launches > 0 and all(i.n_overflow == 0 for i in infos)
    for n_s, n_r in zip(shared.forest.nodes(), ref.forest.nodes()):
        for x, y in zip(_leaves(n_s.state), _leaves(n_r.state)):
            assert torch.equal(x, y)
    for qid in shared.registry.qids():
        assert shared.matches(qid) == plain.matches(qid)
        for x, y in zip(_leaves(shared.state(qid)), _leaves(ref.state(qid))):
            assert torch.equal(x, y)


def test_cuda_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A checkpoint of CUDA state (sharing on) restores onto the card
    with zero builds in a warm cache and continues exactly as the
    uninterrupted service; restored onto the CPU (REF) it agrees too."""
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.service import ContinuousSearchService

    stream = synth_traffic_stream(StreamConfig(
        n_edges=4096, n_vertices=3000, n_vertex_labels=3, n_edge_labels=2,
        seed=8, ts_step_max=2))
    cap = dict(level_capacity=4096, l0_capacity=4096, max_new=1024)
    tc = SlotTickCache()
    svc = ContinuousSearchService(
        slots_per_group=4, tick_cache=tc, enable_sharing=True,
        ckpt_dir=str(tmp_path), device="cuda", **cap)
    for q in _share_queries():
        svc.register(q, 120)
    kw = dict(batch_size=256, min_batch=256, max_batch=256)
    svc.serve_stream(stream[:2048], ckpt_every=4, **kw)
    builds = tc.n_builds
    back = ContinuousSearchService.restore(str(tmp_path), tick_cache=tc,
                                           device="cuda")
    assert back.backend == "cuda" and tc.n_builds == builds
    cpu = ContinuousSearchService.restore(str(tmp_path), backend="ref",
                                          device="cpu")
    svc.serve_stream(stream[2048:], **kw)
    back.serve_stream(stream[2048:], **kw)
    cpu.serve_stream(stream[2048:], **kw)
    for qid in svc.registry.qids():
        assert back.matches(qid) == svc.matches(qid) == cpu.matches(qid)
        for x, y in zip(_leaves(back.state(qid)), _leaves(svc.state(qid))):
            assert x.is_cuda and torch.equal(x, y)


def test_frontier_on_card_equals_ref_frontier_and_serve_stream(cuda):
    """The ingest frontier on the CUDA backend: a chaos-wrapped,
    disordered multi-source frontier served with prefix sharing gives
    the per-tenant reports of the same frontier on the REF backend (every
    table leaf equal) and of an uninterrupted ``serve_stream``; the
    watermark reaches the engines as an int32 scalar on the card."""
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.fault import RetryPolicy
    from repro_torch.runtime.service import ContinuousSearchService
    from repro_torch.stream.chaos import ChaosConfig, ChaosSource
    from repro_torch.stream.generator import DisorderConfig, \
        disordered_sources
    from repro_torch.stream.ingest import IngestFrontier, ScriptedSource

    stream = synth_traffic_stream(StreamConfig(
        n_edges=4096, n_vertices=3000, n_vertex_labels=3, n_edge_labels=2,
        seed=9, ts_step_max=2))
    cap = dict(level_capacity=8192, l0_capacity=8192, max_new=4096)

    def frontier():
        scripts = disordered_sources(stream, DisorderConfig(
            n_sources=3, disorder_frac=0.3, max_delay=6,
            duplicate_rate=0.1, seed=1))
        return IngestFrontier(
            [ChaosSource(ScriptedSource(f"s{i}", sc), ChaosConfig(
                seed=2 + i, p_disconnect=0.08, p_duplicate=0.05,
                reorder_span=3, p_reorder=0.2, p_stall=0.05, p_torn=0.05))
             for i, sc in enumerate(scripts)],
            allowed_lateness=600, reorder_capacity=1 << 16,
            retry=RetryPolicy(max_attempts=8, base_delay_s=0.0),
            sleep=lambda d: None)

    def svc(backend):
        s = ContinuousSearchService(
            slots_per_group=4, tick_cache=SlotTickCache(), backend=backend,
            enable_sharing=True, device="cuda", **cap)
        for q in _share_queries():
            s.register(q, 120)
        return s

    def serve(s, fr):
        from collections import Counter
        got = Counter()

        def on_match(qid, bind, ets):
            got.update((qid,) + tuple(map(int, b)) + tuple(map(int, e))
                       for b, e in zip(bind, ets))
        infos = []
        s.serve_frontier(fr, on_match=on_match, on_tick=infos.append,
                         batch_size=256, min_batch=256, max_batch=256,
                         pump_size=96)
        return got, infos

    assert svc("cuda")._watermark_scalar(5).device.type == "cuda"
    before = ops.compat_join_pairs.launches
    card = svc("cuda")
    got, infos = serve(card, frontier())
    assert ops.compat_join_pairs.launches > before
    plain = svc("ref")
    want, _ = serve(plain, frontier())
    assert got == want and got
    assert all(i.n_late_dropped == 0 and i.n_overflow == 0 for i in infos)
    for qid in card.registry.qids():
        for x, y in zip(_leaves(card.state(qid)), _leaves(plain.state(qid))):
            assert torch.equal(x, y)
    for a, b in zip(card.forest.nodes(), plain.forest.nodes()):
        for x, y in zip(_leaves(a.state), _leaves(b.state)):
            assert torch.equal(x, y)
    canon = svc("cuda")
    want_stream, _ = _serve_reports(canon, stream)
    assert got == want_stream


@pytest.mark.parametrize("n_replicas,spr", [(1, 8), (2, 4), (8, 1)])
def test_mesh_on_card_equals_single_device_service(cuda, n_replicas, spr,
                                                  tmp_path):
    """Replica-sharded serving on the card (R logical replicas on one
    device, CUDA joins at S = spr, sharing on): per-tenant reports, state
    rows and forest tables equal the single-device CUDA service's; the
    summed ``MeshTickStats.n_matches`` equal the reports; a sharded
    checkpoint restores onto the card with zero warm builds and, onto
    two replicas, exactly once."""
    from collections import Counter

    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.mesh import ShardedSearchService
    from repro_torch.runtime.service import ContinuousSearchService

    stream = synth_traffic_stream(StreamConfig(
        n_edges=4096, n_vertices=3000, n_vertex_labels=3, n_edge_labels=2,
        seed=9, ts_step_max=2))
    cap = dict(level_capacity=4096, l0_capacity=4096, max_new=1024)
    single = ContinuousSearchService(
        slots_per_group=8, tick_cache=SlotTickCache(), enable_sharing=True,
        device="cuda", **cap)
    tc = SlotTickCache()
    ckpt = str(tmp_path)
    mesh = ShardedSearchService(
        n_replicas, spr, devices=("cuda",) * n_replicas, tick_cache=tc,
        enable_sharing=True, ckpt_dir=ckpt, **cap)
    assert mesh.backend == "cuda"
    for q in _share_queries():
        assert single.register(q, 120) == mesh.register(q, 120)
    want, _ = _serve_reports(single, stream[:2048])
    n_stats = []
    before = dict(ops.compat_join_pairs.launches_by_slots)
    got = Counter()

    def on_match(qid, bind, ets):
        got.update((qid,) + tuple(map(int, b)) + tuple(map(int, e))
                   for b, e in zip(bind, ets))
    mesh.serve_stream(stream[:2048], on_match=on_match, ckpt_every=4,
                      on_tick=lambda i: n_stats.append(sum(
                          s["n_matches"]
                          for s in mesh.last_mesh_stats().values())),
                      batch_size=256, min_batch=256, max_batch=256)
    assert got == want and sum(got.values()) > 0
    assert sum(n_stats) == sum(got.values())
    assert ops.compat_join_pairs.launches_by_slots[spr] > before.get(spr, 0)
    for qid in single.registry.qids():
        for x, y in zip(_leaves(mesh.state(qid)), _leaves(single.state(qid))):
            assert x.is_cuda and torch.equal(x, y)
    for a, b in zip(mesh.forest.nodes(), single.forest.nodes()):
        for x, y in zip(_leaves(a.state), _leaves(b.state)):
            assert torch.equal(x, y)
    builds = tc.n_builds
    back = ShardedSearchService.restore(ckpt, tick_cache=tc,
                                        devices=("cuda",) * n_replicas)
    assert tc.n_builds == builds and back.n_replicas == n_replicas
    re = ShardedSearchService.restore(ckpt, n_replicas=2,
                                      devices=("cuda",) * 2)
    kw = dict(batch_size=256, min_batch=256, max_batch=256)
    for s in (single, back, re):
        s.serve_stream(stream[2048:], **kw)
    for qid in single.registry.qids():
        assert back.matches(qid) == single.matches(qid) == re.matches(qid)


def _match_rows(res):
    from collections import Counter

    valid = res.match_valid.cpu().numpy()
    bind = res.match_bindings.cpu().numpy()[valid]
    ets = res.match_ets.cpu().numpy()[valid]
    return Counter(tuple(map(int, b)) + tuple(map(int, e))
                   for b, e in zip(bind, ets))


def test_sharded_tick_on_card_equals_unsharded(cuda):
    """Capacity sharding on the card (2 logical shards on one device, the
    CUDA pair kernel at S = 2): per tick the unsharded CUDA tick's match
    count and rows, no overflow; the shard-aware fold of the final state
    equals the unsharded current matches; a REF sharded run is
    identical, leaf for leaf."""
    from repro_torch.core.distributed import (
        _sharded_current_matches,
        build_sharded_tick,
        make_mesh,
    )
    from repro_torch.core.engine import build_tick, current_matches
    from repro_torch.core.state import init_state

    chain = QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                       prec=frozenset({(0, 1), (1, 2)}))
    two = QueryGraph(5, (0, 0, 1, 0, 1), ((0, 1), (1, 2), (0, 3), (3, 4)),
                     prec=frozenset({(0, 1), (2, 3)}))
    stream = synth_traffic_stream(StreamConfig(
        n_edges=480, n_vertices=12, n_vertex_labels=3, n_edge_labels=2,
        seed=5, ts_step_max=2))
    mesh = make_mesh((2,), ("data",), devices=("cuda",) * 2)
    for query in (chain, two):
        plan = compile_plan(query, 35, level_capacity=1024,
                            l0_capacity=1024, max_new=256)
        t1, s1 = build_tick(plan, device=cuda), init_state(plan,
                                                           device=cuda)
        tc, sc = build_sharded_tick(plan, mesh, extract_matches=True)
        tr, sr = build_sharded_tick(plan, mesh, backend="ref",
                                    extract_matches=True)
        before = dict(ops.compat_join_pairs.launches_by_slots)
        total = 0
        for batch in to_batches(stream, 32):
            eb = make_batch(**batch, device=cuda)
            s1, r1 = t1(s1, eb)
            sc, rc = tc(sc, eb)
            sr, _ = tr(sr, eb)
            assert int(rc.n_new_matches) == int(r1.n_new_matches)
            assert _match_rows(rc) == _match_rows(r1)
            total += int(rc.n_new_matches)
            for x, y in zip(_leaves(sc), _leaves(sr)):
                assert torch.equal(x, y)
        assert total > 0 and int(sc.stats.n_overflow) == 0
        assert _sharded_current_matches(plan, sc, 2) == \
            current_matches(plan, s1)
        after = dict(ops.compat_join_pairs.launches_by_slots)
        assert after.get(2, 0) > before.get(2, 0)


@pytest.mark.parametrize("which", ["j1", "j2"])
def test_gathered_delta_joins_equal_plain_version(cuda, which):
    """The capacity phase's L0 joins at 4 shards of 65,536 rows: a
    gathered delta of 4 x 8,192 rows shared by the shards (slot stride
    0), as A (J1) or B (J2); each slot's A x B is 2^31 pairs."""
    rng = np.random.default_rng(31)
    rel = np.zeros((3, 3), bool)
    rel[0, 0] = True
    trel = np.zeros((2, 2), np.int8)

    def t(x):
        return torch.as_tensor(x, device=cuda)

    def table(lead, rows, fill):
        return (t(rng.integers(0, 3000, lead + (rows, 3), dtype=np.int32)),
                t(np.sort(rng.integers(0, 30000, lead + (rows, 2),
                                       dtype=np.int32), axis=-1)),
                t(rng.random(lead + (rows,)) < fill))

    delta, shards = table((), 4 * 8192, 0.5), table((4,), 65536, 0.2)
    a, b = (delta, shards) if which == "j1" else (shards, delta)
    win = t(rng.integers(3000, 9000, 4, dtype=np.int32))
    got = ops.compat_join_pairs(*a, *b, rel, trel, 8192, win)
    want = ref.compat_join_pairs(*a, *b, rel, trel, 8192, win)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


def test_pair_kernel_counts_2_31_pairs(cuda):
    """Every one of 32,768 x 65,536 = 2^31 pairs matches: the kernel keeps
    the first max_new in row-major order and drops 2^31 - max_new, past
    the int32 range of the total it sums."""
    a = (torch.zeros((32768, 1), dtype=torch.int32, device=cuda),
         torch.zeros((32768, 1), dtype=torch.int32, device=cuda),
         torch.ones(32768, dtype=torch.bool, device=cuda))
    b = (torch.ones((65536, 1), dtype=torch.int32, device=cuda),
         torch.zeros((65536, 1), dtype=torch.int32, device=cuda),
         torch.ones(65536, dtype=torch.bool, device=cuda))
    rel, trel = np.zeros((1, 1), bool), np.zeros((1, 1), np.int8)
    got = ops.compat_join_pairs(*a, *b, rel, trel, 4096)
    torch.cuda.synchronize()
    assert int(got[3][0]) == 2**31 - 4096
    assert got[2].all() and int(got[0].max()) == 0
    assert torch.equal(got[1][0], torch.arange(4096, device=cuda))
    want = ref.compat_join_pairs(*a, *b, rel, trel, 4096)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_analysis_kernel_routes_and_device_limits_on_card(cuda):
    """The card half of the kernel pass's KC105: each launch wrapper
    against its plain version, one real call at the lattice's small
    points (equal trees, equal values); and the limits the contracts
    assume (a block's shared memory, the SM count the grids are sized
    for) equal the card's, as on an H100."""
    from repro_torch.analysis import kernel_check as KC

    assert [f.format() for f in KC.check_kernel_ref_agreement(
        fast=True, device=cuda)] == []
    limits = KC.device_limits(0)
    assert limits["sm_count"] > 0 and limits["smem_per_block_optin"] > 0
    assert [f.format() for f in KC.check_device_limits(limits)] == []


# --------------------------------------------------------------------- #
# training and the SJ-tree on the card
# --------------------------------------------------------------------- #
def test_bce_loss_gradients_on_card_equal_plain(cuda):
    """Wide&Deep's ``bce_loss`` backward on the card: the wide table gets a
    gradient (the embedding_bag kernel's Function, its backward one
    segment_sum launch) equal to the plain version's within the summation
    bound, and every other gradient within float32 noise."""
    import dataclasses

    from repro_torch.configs import wide_deep
    from repro_torch.data.recsys import batch_to_device, recsys_batch
    from repro_torch.models.recsys.wide_deep import WideDeep, bce_loss

    cfg = dataclasses.replace(wide_deep.smoke_config(), wide_vocab=5000,
                              n_wide_crosses=16)
    batch = batch_to_device(recsys_batch(0, 2048, cfg.n_sparse,
                                         cfg.vocab_per_field, cfg.n_dense,
                                         cfg.n_wide_crosses, seed=3), cuda)
    grads = []
    for backend in (None, "ref"):
        model = WideDeep(dataclasses.replace(cfg, backend=backend),
                         device=cuda, seed=4)
        eb0, sr0 = eb_ops.embedding_bag.launches, sr_ops.segment_sum.launches
        bce_loss(model, batch)[0].backward()
        if backend is None:
            assert eb_ops.embedding_bag.launches == eb0 + 1
            assert sr_ops.segment_sum.launches == sr0 + 1
        grads.append({n: p.grad for n, p in model.named_parameters()})
    got, want = grads
    assert got["wide"] is not None and bool(got["wide"].abs().sum() > 0)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-5,
                                   atol=1e-6 * float(want[n].abs().max()))


def test_sjtree_on_card_equals_ref(cuda):
    """A small SJ-tree (the serve phase's two-chain, every edge its own
    leaf) on the CUDA backend ticks bit-identically to the REF backend on
    the card, and its post-filtered matches equal the timing-aware
    engine's, tick by tick."""
    from collections import Counter

    from repro_torch.core.engine import build_tick, matches_from_rows
    from repro_torch.core.sjtree import compile_sjtree_plan, \
        timing_postfilter
    from repro_torch.core.state import init_state

    q = QueryGraph(5, (0, 0, 1, 0, 1), ((0, 1), (1, 2), (0, 3), (3, 4)),
                   prec=frozenset({(0, 1), (2, 3)}))
    cap = dict(level_capacity=4096, l0_capacity=4096, max_new=2048)
    plan = compile_plan(q, 60, **cap)
    sj_plan, trel = compile_sjtree_plan(q, 60, **cap)
    stream = synth_traffic_stream(StreamConfig(
        n_edges=1200, n_vertices=100, n_vertex_labels=2, n_edge_labels=2,
        seed=5, ts_step_max=2))
    ticks = [build_tick(p, backend=b, device=cuda)
             for p, b in ((sj_plan, "cuda"), (sj_plan, "ref"),
                          (plan, "cuda"))]
    states = [init_state(p, device=cuda) for p in (sj_plan, sj_plan, plan)]

    def emitted(p, res, tr=None):
        bind, ets, valid = (x.cpu().numpy() for x in (
            res.match_bindings, res.match_ets, res.match_valid))
        if tr is not None:
            valid = timing_postfilter(ets, valid, tr)
        out = Counter()
        for r in np.nonzero(valid)[0]:
            out.update(matches_from_rows(p, bind[r:r + 1], ets[r:r + 1],
                                         np.ones(1, bool)))
        return out

    total = 0
    for b in to_batches(stream, 64):
        batch = make_batch(**b, device=cuda)
        res = []
        for k, tick in enumerate(ticks):
            states[k], r = tick(states[k], batch)
            res.append(r)
        for x, y in zip(_leaves(states[0]), _leaves(states[1])):
            assert torch.equal(x, y)
        assert int(states[0].stats.n_overflow) == 0
        got = emitted(sj_plan, res[0], trel)
        assert got == emitted(plan, res[2])
        total += sum(got.values())
    assert total > 0
    assert int(states[0].stats.n_overflow) == int(states[2].stats.n_overflow) \
        == 0


@pytest.mark.parametrize("arch", ["gin", "gat", "pna", "nequip", "wide_deep"])
def test_train_step_on_card_equals_plain(cuda, arch):
    """One train step of each model family (smoke configs, float32) on the
    card equals the same step on the plain version: loss and grad_norm
    within rtol 1e-5, the gradient (the first moment after one step)
    within 1e-4 of each leaf's largest entry, the parameters within Adam's
    first-step map of that difference (lr |step_a - step_b|) plus 16
    float32 ulps."""
    import dataclasses

    from repro_torch.configs import gat_cora, gin_tu, nequip, pna, wide_deep
    from repro_torch.data.recsys import batch_to_device, recsys_batch
    from repro_torch.launch.cells import make_gnn_train_step, \
        make_recsys_train_step
    from repro_torch.models.gnn import nequip as NQ
    from repro_torch.models.gnn.models import GAT, GIN, PNA, \
        node_classification_loss
    from repro_torch.models.recsys.wide_deep import WideDeep
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.tree import flatten, flatten_up_to

    lr = 1e-3
    if arch == "wide_deep":
        ocfg = AdamWConfig(state_mode="factored")
        cfg = wide_deep.smoke_config()
        g = batch_to_device(recsys_batch(0, 512, cfg.n_sparse,
                                         cfg.vocab_per_field, cfg.n_dense,
                                         cfg.n_wide_crosses, seed=1), cuda)
        step = make_recsys_train_step(cfg, ocfg, lr)

        def make(backend):
            return WideDeep(dataclasses.replace(cfg, backend=backend),
                            device=cuda, seed=2)
    elif arch == "nequip":
        ocfg = AdamWConfig(state_mode="fp32")
        cfg = nequip.smoke_config()
        gen = torch.Generator(device=cuda).manual_seed(3)
        n = 8 * 10
        mol = torch.arange(n, device=cuda) // 10
        src, dst = torch.nonzero((mol[:, None] == mol[None])
                                 & ~torch.eye(n, dtype=torch.bool,
                                              device=cuda), as_tuple=True)
        g = {"species": torch.randint(0, cfg.n_species, (n,), generator=gen,
                                      device=cuda),
             "pos": torch.rand((n, 3), generator=gen, device=cuda) * 5,
             "edge_src": src.int(), "edge_dst": dst.int(),
             "graph_ids": mol.int(), "n_graphs": 8,
             "energy": torch.randn((8,), generator=gen, device=cuda)}
        step = make_gnn_train_step(
            cfg, lambda m, gr: NQ.mse_loss(m.params(), gr, m.cfg), ocfg, lr)

        def make(backend):
            return NQ.NequIP(dataclasses.replace(cfg, backend=backend),
                             device=cuda, seed=4)
    else:
        ocfg = AdamWConfig(state_mode="fp32")
        mod, cls = {"gin": (gin_tu, GIN), "gat": (gat_cora, GAT),
                    "pna": (pna, PNA)}[arch]
        cfg = dataclasses.replace(mod.smoke_config(), d_in=16)
        g = _gnn_graph(cuda)
        g["labels"] = torch.randint(0, cfg.n_classes, (g["x"].shape[0],),
                                    device=cuda)
        step = make_gnn_train_step(cfg, node_classification_loss, ocfg, lr)

        def make(backend):
            model = cls(cfg, device=cuda, seed=5)
            if backend is not None:
                model.backend = backend
            return model
    runs = []
    for backend in (None, "ref"):
        model = make(backend)
        opt = adamw_init(model.params(), ocfg)
        _, opt, loss, gnorm = step(model, opt, g)
        runs.append((flatten(model.params()),
                     flatten_up_to(model.params(), opt["leaves"]),
                     float(loss), float(gnorm)))
    (gp, gs, gl, gn), (wp, ws, wl, wn) = runs
    assert gl == pytest.approx(wl, rel=1e-5)
    assert gn == pytest.approx(wn, rel=1e-5)

    def adam(st):
        c1, c2 = 1 - ocfg.b1, 1 - ocfg.b2
        m = st["m"].double()
        if "vr" in st:
            vr, vc = st["vr"].double(), st["vc"].double()
            den = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            v = vr[..., :, None] * vc[..., None, :] / den[..., None]
        else:
            v = st["v"].double()
        return (m / c1) / (torch.sqrt(v / c2) + ocfg.eps)

    for p, q, a, b in zip(gp, wp, gs, ws):
        scale = float(b["m"].abs().max())
        assert float((a["m"] - b["m"]).abs().max()) <= 1e-4 * scale
        sa, sb = adam(a), adam(b)
        tol = lr * (sa - sb).abs() \
            + 16 * 2.0 ** -24 * (q.double().abs() + lr * (sb.abs() + 1))
        assert bool(((p.double() - q.double()).abs() <= tol).all())


def _rel_frob(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


LM_SMOKE = ["deepseek_coder_33b", "qwen3_14b", "internlm2_20b",
            "arctic_480b", "grok1_314b"]


@pytest.mark.parametrize("name", LM_SMOKE)
def test_lm_on_card_equals_cpu(cuda, name):
    """Each LM smoke config (float32) on the card against the same
    weights and tokens on the CPU: forward logits, prefill logits and
    K/V, and six serve_steps from the prefilled cache, each within 1e-4
    relative Frobenius (float32 products summed in other orders; no
    TF32 in float32).  The LM path launches none of the port's kernels."""
    import importlib

    from repro_torch.kernels.compat_join import ops as cj
    from repro_torch.models import transformer as TT

    cfg = importlib.import_module(
        f"repro_torch.configs.{name}").smoke_config()
    cpu = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = TT.LM(cfg, device=cuda, params=cpu).params()
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    prompt, smax = 34, 48
    before = (cj.compat_join_pairs.launches, cj.compat_mask.launches,
              eb_ops.embedding_bag.launches, sr_ops.segment_sum.launches)
    out = {}
    for where, params in (("cpu", cpu), ("cuda", card)):
        t = tokens.to(where)
        with torch.inference_mode():
            logits, _ = TT.forward(params, t, cfg)
            plog, pk, pv = TT.prefill(params, t[:, :prompt], cfg)
            shape = (cfg.n_layers, 2, smax, cfg.n_kv_heads, cfg.head_dim)
            kc = torch.zeros(shape, device=where)
            vc = torch.zeros(shape, device=where)
            kc[:, :, :prompt], vc[:, :, :prompt] = pk, pv
            cache = (kc, vc, torch.full((2,), prompt, dtype=torch.int32,
                                        device=where))
            steps = []
            for i in range(prompt, 40):
                lg, cache = TT.serve_step(params, t[:, i:i + 1], cache, cfg)
                steps.append(lg)
        out[where] = [logits, plog, pk, pv, *steps, cache[0]]
        assert cache[2].tolist() == [40, 40]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.device.type == "cuda"
        assert _rel_frob(got, want) <= 1e-4
    assert (cj.compat_join_pairs.launches, cj.compat_mask.launches,
            eb_ops.embedding_bag.launches,
            sr_ops.segment_sum.launches) == before


def test_moe_on_card_equals_token_loop(cuda):
    """Arctic's smoke config: one layer's ``moe_ffn`` on the card against
    an explicit per-token loop on the card over the same gates' top-2
    experts (renormalised), float32 within 1e-5 relative Frobenius, and
    the bfloat16 dispatch within 1e-2."""
    import dataclasses

    from repro_torch.configs import arctic_480b
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(arctic_480b.smoke_config(),
                              capacity_factor=8.0)      # no drops
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v[0] for k, v in TT.init(gen, cfg, device=cuda)["layers"][
        "moe"].items()}
    x = torch.randn((64, cfg.d_model), generator=gen, device=cuda)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xd = x.to(dtype)
        pd = {k: v.to(dtype) for k, v in p.items()}
        with torch.inference_mode():
            got, _ = moe.moe_ffn(xd, pd, cfg)
            gates = torch.softmax((xd @ pd["wg"]).float(), dim=-1)
            topw, topi = torch.topk(gates, 2, dim=-1)
            topw = topw / topw.sum(-1, keepdim=True)
            want = torch.zeros_like(xd, dtype=torch.float32)
            for t in range(x.shape[0]):
                for kk in range(2):
                    e = int(topi[t, kk])
                    h = torch.nn.functional.silu(xd[t] @ pd["w1"][e]) \
                        * (xd[t] @ pd["w3"][e])
                    want[t] += topw[t, kk] * (h @ pd["w2"][e]).float()
        assert got.dtype == dtype
        assert _rel_frob(got, want) <= tol


# --------------------------------------------------------------------- #
# LM training on the card
# --------------------------------------------------------------------- #
def _lm_step_both(cuda, name, microbatches, lr):
    """One float32 train step of ``name``'s smoke config (remat "full")
    on the CPU and on the card from the same parameters: ((cpu, card),
    ocfg), each (params, opt state, loss, grad_norm)."""
    import dataclasses
    import importlib

    from repro_torch.launch.cells import make_lm_train_step
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.tree import tree_map

    cfg = dataclasses.replace(importlib.import_module(
        f"repro_torch.configs.{name}").smoke_config(), remat="full")
    ocfg = AdamWConfig()
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    models = [TT.LM(cfg, device=cuda, params=tree_map(torch.clone, params)),
              TT.LM(cfg, device="cpu", params=params)]
    out = []
    for model in models:
        opt = adamw_init(model.params(), ocfg)
        _, opt, loss, gn = make_lm_train_step(cfg, ocfg, microbatches, lr)(
            model, opt, tokens.to(model.embed.device))
        out.append((model.params(), opt, float(loss), float(gn)))
    return out, ocfg


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["qwen3_14b", "arctic_480b"])
def test_lm_train_step_on_card_equals_cpu(cuda, name, microbatches):
    """One float32 step (TF32 off) on the card against the CPU: loss and
    grad_norm within 1e-5 relative, each first moment within 1e-4 of its
    leaf's largest entry, each parameter within lr·|Δstep| + 16 ulps
    (Adam's first step maps a gradient near 0 to up to ±lr)."""
    from repro_torch.optim.tree import flatten, flatten_up_to

    lr = 1e-3
    ((gp, gs, gl, gn), (wp, ws, wl, wn)), ocfg = _lm_step_both(
        cuda, name, microbatches, lr)
    assert gl == pytest.approx(wl, rel=1e-5)
    assert gn == pytest.approx(wn, rel=1e-5)

    def adam(st):
        m, v = st["m"].cpu().double(), st["v"].cpu().double()
        return (m / (1 - ocfg.b1)) / (torch.sqrt(v / (1 - ocfg.b2))
                                      + ocfg.eps)

    for p, q, a, b in zip(flatten(gp), flatten(wp),
                          flatten_up_to(gp, gs["leaves"]),
                          flatten_up_to(wp, ws["leaves"])):
        assert p.device.type == "cuda"
        scale = float(b["m"].abs().max())
        assert float((a["m"].cpu() - b["m"]).abs().max()) <= 1e-4 * scale
        sa, sb = adam(a), adam(b)
        q = q.detach().double()
        tol = lr * (sa - sb).abs() \
            + 16 * 2.0 ** -24 * (q.abs() + lr * (sb.abs() + 1))
        assert bool(((p.detach().cpu().double() - q).abs() <= tol).all())


def test_lm_train_backward_reduces_in_float32_on_card(cuda, monkeypatch):
    """On the card, with the process flag on, each recomputed layer and
    a product's gradient run with bf16 reduced-precision reductions off
    (the flag is process-wide, read on the autograd engine's device
    thread), and the flag is back on after the step."""
    import dataclasses

    from repro_torch.configs import qwen3_14b
    from repro_torch.launch.cells import make_lm_train_step
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(qwen3_14b.smoke_config(), remat="full",
                              dtype=torch.bfloat16)
    model = TT.LM(cfg, device=cuda, seed=0)
    mm = torch.backends.cuda.matmul
    seen = {"layer": [], "grad": []}
    real_layer = TT._layer

    def layer(*a, **k):
        seen["layer"].append(mm.allow_bf16_reduced_precision_reduction)
        return real_layer(*a, **k)

    def ffn(x, p):
        h = x @ p["w1"]
        if h.requires_grad:
            h.register_hook(lambda g: seen["grad"].append(
                mm.allow_bf16_reduced_precision_reduction))
        return torch.nn.functional.silu(h) * (x @ p["w3"]) @ p["w2"]

    monkeypatch.setattr(TT, "_layer", layer)
    monkeypatch.setattr(TT, "_dense_ffn", ffn)
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        ocfg = AdamWConfig()
        make_lm_train_step(cfg, ocfg, 2, 1e-3)(
            model, adamw_init(model.params(), ocfg),
            torch.randint(0, cfg.vocab, (4, 32), device=cuda))
        after = mm.allow_bf16_reduced_precision_reduction
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    assert seen["layer"] == [False] * (2 * 2 * cfg.n_layers)
    assert seen["grad"] and not any(seen["grad"])
    assert after is True


def test_train_lm_on_card_resumes(cuda, tmp_path):
    """``train_lm`` on the card at a tiny config: 6 steps with a
    checkpoint every 2, and a run stopped at 4 and resumed: the resumed
    losses and final parameters equal the uninterrupted run's within
    float32 reordering (1e-5 relative), and the loss falls."""
    from repro_torch.launch.train import train_lm
    from repro_torch.models.transformer import LMConfig
    from repro_torch.optim.tree import flatten

    cfg = LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                   attn_chunk=16, remat="none", dtype=torch.float32)
    kw = dict(batch=4, seq=16, ckpt_every=2, log_every=1, device=cuda)
    whole, want = train_lm(cfg, 6, ckpt_dir=str(tmp_path / "a"), **kw)
    train_lm(cfg, 4, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed, got = train_lm(cfg, 6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [i for i, _ in got] == [4, 5]
    np.testing.assert_allclose([l for _, l in got],
                               [l for _, l in want[4:]], rtol=1e-5)
    for a, b in zip(flatten(resumed), flatten(whole)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert want[-1][1] < want[0][1]


def _wd_rank_and_one_process(cuda, tmp_path):
    """A Wide&Deep train cell (the smoke configuration at batch 2048) as
    one rank of a 1 x 1 ``("data", "model")`` process-group mesh over
    NCCL, and as the one-process cell, from the same seed and batch."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import wide_deep
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data.recsys import recsys_batch
    from repro_torch.launch.cells import cell_for

    cfg = dataclasses.replace(wide_deep.smoke_config(), wide_vocab=5000,
                              n_wide_crosses=16)
    arch = dataclasses.replace(get_arch("wide-deep"), config=cfg)
    shape = dataclasses.replace(arch.shape("train_batch"), global_batch=2048)
    batch = recsys_batch(0, 2048, cfg.n_sparse, cfg.vocab_per_field,
                         cfg.n_dense, cfg.n_wide_crosses, seed=3)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), devices=("cuda",),
                     group=dist.group.WORLD)
    cells = [cell_for(arch, shape, mesh=mesh, device="cuda"),
             cell_for(arch, shape, device="cuda")]
    for cell in cells:
        with torch.no_grad():
            for k, x in cell.args[2].items():
                x.copy_(torch.as_tensor(batch[k]))
    return cells


def _wd_kernels(prof) -> dict:
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        name = e.key.split("(")[0].split("<")[0].split()[-1]
        if e.device_type == DeviceType.CUDA and (
                name == "eb_bag_sum" or name.startswith("sr_")):
            out[name] = out.get(name, 0) + e.count
    return out


def test_wide_deep_rank_launches_the_one_process_kernels(cuda, tmp_path):
    """One rank's Wide&Deep train step on a 1 x 1 process-group mesh
    (NCCL) launches exactly the kernels the one-process step launches:
    the wrappers' counts and the profiled kernels by name."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    try:
        cells = _wd_rank_and_one_process(cuda, tmp_path)
        counts, kernels = [], []
        for cell in cells:
            eb_ops.embedding_bag.launches = sr_ops.segment_sum.launches = 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cell.fn(*cell.args)
                torch.cuda.synchronize()
            counts.append((eb_ops.embedding_bag.launches,
                           sr_ops.segment_sum.launches))
            kernels.append(_wd_kernels(prof))
    finally:
        dist.destroy_process_group()
    assert counts[0] == counts[1] == (1, 1)
    assert kernels[0] == kernels[1]
    assert kernels[0].get("eb_bag_sum") == 1


def test_wide_deep_rank_gradients_equal_the_one_process(cuda, tmp_path):
    """The same rank's gradients of ``bce_loss`` equal the one-process
    cell's (float32 noise: rtol 1e-5 of each leaf's largest)."""
    import torch.distributed as dist

    from repro_torch.models.recsys.wide_deep import bce_loss
    from repro_torch.optim.tree import flatten

    try:
        grads = []
        for cell in _wd_rank_and_one_process(cuda, tmp_path):
            model, _, batch = cell.args
            leaves = flatten(model.params())
            loss, _ = bce_loss(model, batch)
            grads.append(torch.autograd.grad(loss, leaves))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
