"""The port's CUDA kernels on the card (marker ``gpu``; skips without a
CUDA device).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The compat-join kernels must agree with their plain versions element for
element (pairs in row-major order, overflow included, also where
``max_new`` falls on and inside a (row, B tile) cell; masks byte for
byte, ragged rows and tiny tables included), and a CUDA-backend slot
group must tick bit-identically to the REF backend on the card.  The embedding_bag and segment_sum kernels sum
in float32 in another order than their plain versions: float32 within
rtol 1e-5 / atol 1e-5, bfloat16 within one bfloat16 rounding (rtol 1e-2
/ atol 1e-2).  The segment_sum edge cases (a hub node with 40% of the
edges, D from 1 to 65536, unaligned messages, no edges) use
integer-valued float32 messages, which must sum exactly, and bf16
messages held to one bf16 rounding plus the float32 summation bound.
One embedding_bag call must be one device kernel.
"""

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


def test_pair_call_launches_only_its_kernels(cuda):
    """One pair call is count, scan and emit and no other device
    operation (the outputs come straight from the kernels); one mask call
    is one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        found = {n for n in names if any(n in k for k in keys)}
        assert len(keys) == len(names) and found == names, keys


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
    """One wrapper call is one device kernel (no scratch pass, no copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_bags = 512
    ids = torch.randint(-1, 1000, (n_bags * 16,), device=cuda,
                        dtype=torch.int32)
    bags = torch.arange(n_bags, dtype=torch.int32,
                        device=cuda).repeat_interleave(16)
    table = torch.randn((1000, d), device=cuda)
    eb_ops.embedding_bag(ids, bags, table, n_bags)         # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(5):
            eb_ops.embedding_bag(ids, bags, table, n_bags)
        torch.cuda.synchronize()
    # the profiler may miss a launch, never add one
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "eb_bag_sum" in kernels[0].key, \
        [e.key for e in kernels]
    assert 1 <= kernels[0].count <= 5


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
    (30_000, 300, 300, 0.5, False),       # column chunks of a hub tile
    (300, 40, 65536, 0.0, False),         # past shared memory even at TN=1
    (100_000, 3_200_000, 8, 0.4, False),  # tile counters past shared memory
])
def test_segment_sum_kernel_cases(cuda, e, n, d, hub, unaligned, dtype):
    """One node takes ``hub`` of the edges, so its tile is cut into pieces
    (more than CH edges) and combined through the float32 scratch."""
    from repro_torch.kernels.segment_reduce import kernel as sr_kernel

    g = torch.Generator(device=cuda).manual_seed(e + d)
    dst = torch.randint(-20, n + 20, (e,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst[torch.rand((e,), generator=g, device=cuda) < hub] = n // 3
    msg = _sr_msg(g, e, d, dtype, cuda, unaligned)
    plan = sr_kernel.plan(e, n, d, msg.element_size(), msg.data_ptr() % 16)
    if hub:
        assert int((dst == n // 3).sum()) > plan.ch
    if unaligned and d == 3:
        assert plan.vec == msg.element_size()
    assert plan.priv == (n < 3_000_000)
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
