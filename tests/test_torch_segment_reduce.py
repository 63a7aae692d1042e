"""The port's segment_sum / segment_mean against the reference's.

The same numpy inputs go through the Pallas kernel in interpret mode
(``repro.kernels.segment_reduce.ops.segment_sum(...,
backend="pallas_interpret")``, float32 accumulation) and through the
port's wrappers on the CPU (their plain version), on the grid of
``tests/test_kernels_segment_embed.py``.  Tolerances are the reference's
own: float32 rtol 1e-5 / atol 1e-4, bfloat16 rtol 1e-2 / atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import ops as ref_ops

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.kernels.segment_reduce import kernel, ops, ref

GRID = [
    (64, 16, 8, "float32"),
    (1024, 256, 128, "float32"),
    (700, 100, 32, "float32"),
    (512, 512, 16, "bfloat16"),
    (1, 5, 4, "float32"),
    (2048, 64, 1, "float32"),            # D = 1: segment_mean's counts
    (4096, 300, 8, "float32"),           # hub-heavy (HUB below)
    (2048, 100, 1, "bfloat16"),          # hub-heavy at D = 1
]
# share of the edges that one node (N // 3) takes in these GRID cases
HUB = {(4096, 300, 8, "float32"): 0.4, (2048, 100, 1, "bfloat16"): 0.5}
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=1e-2, atol=2e-2)}


def _inputs(e, n, d, dtype):
    rng = np.random.default_rng(e + n)
    dst = rng.integers(0, n, e).astype(np.int32)
    hub = HUB.get((e, n, d, dtype), 0.0)
    if hub:
        dst[rng.random(e) < hub] = n // 3
    dst[rng.random(e) < 0.1] = -1                 # dropped edges
    msg = rng.standard_normal((e, d)).astype(np.float32)
    jmsg = jnp.asarray(msg, dtype=jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)
    tmsg = torch.as_tensor(msg).to(getattr(torch, dtype))
    return dst, jmsg, tmsg


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("e,n,d,dtype", GRID)
def test_segment_reduce_matches_interpreted_kernel(op, e, n, d, dtype):
    dst, jmsg, tmsg = _inputs(e, n, d, dtype)
    ref_fn = ref_ops.segment_sum if op == "sum" else ref_ops.segment_mean
    port_fn = ops.segment_sum if op == "sum" else ops.segment_mean
    want = ref_fn(jnp.asarray(dst), jmsg, n, backend="pallas_interpret")
    got = port_fn(torch.as_tensor(dst), tmsg, n)
    assert got.shape == (n, d) and got.dtype == tmsg.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_out_of_range_ids_are_dropped():
    dst = torch.tensor([0, 3, -1, 7, 1], dtype=torch.int32)
    msg = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    got = ops.segment_sum(dst, msg, 4)
    want = torch.zeros(4, 2)
    want[0], want[3], want[1] = msg[0], msg[1], msg[4]
    assert torch.equal(got, want)


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_sum(torch.zeros(3, dtype=torch.int32), torch.zeros(3, 2),
                        2, backend="cuda")


# The CUDA launch plan (kernel.plan) over the shapes the GPU tests and
# chip_smoke.py give it: (E, N, D, bytes per value, data_ptr % 16).
PLAN_SHAPES = [
    (61_225_725, 2_449_029, 100, 2, 0),     # GIN layer 1, bf16
    (61_225_725, 2_449_029, 64, 2, 0),      # GIN layers 2-5
    (61_225_725, 2_449_029, 64, 4, 0),      # float32 integer case
    (61_225_725, 2_449_029, 1, 4, 0),       # segment_mean's counts
    (200_000, 5000, 1, 4, 0),
    (200_000, 5000, 3, 4, 12),              # msg[1:] of 12-byte rows
    (200_000, 5000, 3, 2, 6),
    (100_000, 3000, 100, 2, 8),             # msg[1:] of 200-byte rows
    (100_000, 3000, 100, 4, 0),
    (30_000, 300, 300, 4, 0),
    (300, 40, 65536, 4, 0),
    (300, 40, 65536, 2, 0),
    (100_000, 3_200_000, 8, 4, 0),          # 22-bit keys: three passes
    (0, 1000, 64, 4, 0),                    # no edges
    (1, 1, 1, 4, 0),
]


@pytest.mark.parametrize("e,n,d,elem,align", PLAN_SHAPES)
def test_launch_plan(e, n, d, elem, align):
    p = kernel.plan(e, n, d, elem, align)
    # loads: the widest width that divides the pointer and the row bytes
    assert align % p.vec == 0 and (d * elem) % p.vec == 0 and p.vec >= elem
    wider = [v for v in kernel.VEC_BYTES if v > p.vec]
    assert all(align % v or (d * elem) % v for v in wider)
    ve = p.vec // elem
    # column chunks: one pass of lr lanes covers a chunk; chunks cover D
    assert p.dc % ve == 0 and p.dc <= kernel.DC_MAX and p.lr * ve >= p.dc
    assert p.lr & (p.lr - 1) == 0 and 1 <= p.lr <= 32
    assert (p.n_cc - 1) * p.dc < d <= p.n_cc * p.dc
    assert p.dtype == (elem == 2) and p.run == kernel.RUN
    # the sort: a digit for every bit of the keys (dst, or n if dropped),
    # a tile for every edge, about SORT_WAVE blocks
    assert (p.passes - 1) * kernel.BITS < max(1, n.bit_length()) \
        <= p.passes * kernel.BITS
    assert 1 <= p.sub <= kernel.SUB_MAX
    assert (p.nb - 1) * p.sub * kernel.TILE < e <= p.nb * p.sub * kernel.TILE \
        or e == p.nb == 0
    assert p.sub == kernel.SUB_MAX or p.nb <= kernel.SORT_WAVE
    # a lane group for every node and every window of RUN positions
    per = kernel.THREADS // p.lr
    assert (p.grid_nodes - 1) * kernel.THREADS < n <= p.grid_nodes * kernel.THREADS
    assert (p.windows - 1) * p.run < e <= p.windows * p.run or e == 0
    assert p.grid_runs * per >= p.windows
    assert p.piece == (kernel.PIECE if p.lr >= 8
                       else kernel.PIECE_NARROW * p.lr) <= p.run
    assert (p.pieces - 1) * p.piece < max(1, e) <= p.pieces * p.piece
    assert (p.grid_pieces - 1) * per < p.pieces <= p.grid_pieces * per
    assert 1 <= p.grid_starts <= kernel.GRID_EDGES
    # workspace arrays: aligned, in order, without overlap, and as large
    # as the sort's buffers, the node starts and two rows a window
    names = [f for f in kernel.PLAN_FIELDS if f.startswith("ws_")]
    offs = [getattr(p, f) for f in names]
    assert all(o % kernel.ALIGN == 0 for o in offs) and offs == sorted(offs)
    sizes = kernel.workspace_sizes(e, n, d, p.passes, p.nb, p.windows)
    assert all(b - a >= sizes[f] for f, a, b in zip(names, offs, offs[1:]))
    assert sizes["ws_key0"] == sizes["ws_val0"] == 4 * e
    assert sizes["ws_key1"] == (4 * e if p.passes > 1 else 0)
    assert sizes["ws_start"] == 4 * (n + 1)
    assert sizes["ws_scratch"] == 4 * 2 * p.windows * d
    assert list(p.c_args) == [getattr(p, f) for f in kernel.PLAN_FIELDS]


def test_launch_plan_cuts_wide_rows_and_narrow_d1():
    wide = kernel.plan(300, 40, 65536, 4, 0)
    assert wide.n_cc == 512 and wide.dc == 128 and wide.lr == 32
    d1 = kernel.plan(10_000, 500, 1, 4, 0)
    assert (d1.vec, d1.dc, d1.n_cc, d1.lr) == (4, 1, 1, 1)   # a node a lane
    assert d1.grid_nodes == 2 and d1.passes == 2
    assert (d1.piece, d1.pieces, d1.grid_pieces) == (8, 1250, 5)
    l1 = kernel.plan(61_225_725, 2_449_029, 100, 2, 0)
    assert (l1.vec, l1.dc, l1.lr, l1.passes) == (8, 100, 32, 3)
    assert (l1.sub, l1.nb, l1.windows) == (16, 935, 59_791)
    big = kernel.plan(1000, 3_200_000, 64, 2, 0)         # 22-bit keys
    assert big.passes == 3 and big.nb == 1 and big.sub == 1
    assert kernel.plan(100, 255, 8, 4, 0).passes == 1     # keys up to 255
    assert kernel.plan(100, 256, 8, 4, 0).passes == 2
    assert kernel.plan(100, 10, 100, 2, 8).vec == 8          # msg[1:]
    assert kernel.plan(100, 10, 3, 4, 12).vec == 4
    with pytest.raises(ValueError):
        kernel.plan(2**31 - kernel.RUN, 10, 8, 4, 0)


def _hub_runs(dst, n, run):
    """The hub runs the windows find (the source's sr_runs, in numpy):
    {(start, end): scratch row}, and those sr_nodes reads back."""
    key = np.sort(np.where((dst >= 0) & (dst < n), dst, n), kind="stable")
    ev = int((key < n).sum())
    start = np.searchsorted(key, np.arange(n + 1))
    found = {}
    for w in range(-(-ev // run)):
        p0, p1 = w * run, min((w + 1) * run, ev)
        a = key[p0]
        sa, ta = start[a], start[a + 1]
        if ta - sa > run:
            p = sa + -(-(p0 - sa) // run) * run
            if p < p1 and p < ta:
                found[(p, min(p + run, ta))] = 2 * w
        b = key[p1 - 1]
        if b != a and start[b + 1] - start[b] > run:
            found[(start[b], start[b] + run)] = 2 * w + 1
    read = {}
    for v in range(n):
        s, t = start[v], start[v + 1]
        if t - s > run:
            for ps in range(s, t, run):
                read[(ps, min(ps + run, t))] = \
                    2 * (ps // run) + (ps == s and s % run != 0)
    return found, read, start


@pytest.mark.parametrize("hub", [0.0, 0.4, 0.99])
@pytest.mark.parametrize("e,n,run", [(200_000, 5000, kernel.RUN),
                                     (9000, 3, kernel.RUN), (3000, 40, 16),
                                     (500, 7, 4)])
def test_launch_plan_bounds_hold_for_any_counts(e, n, run, hub):
    """The grids and the scratch are sized from E and N alone: for any
    counts the windows find every hub run exactly once, each run gets a
    scratch row of its own below 2 x windows, and sr_nodes reads each
    run from the row it was written to.  The sort's per-block counts
    fit the digit table."""
    p = kernel.plan(e, n, 64, 2, 0)
    rng = np.random.default_rng(e + n + run)
    for _ in range(3):
        dst = rng.integers(0, n, e)
        dst[rng.random(e) < hub] = n // 2
        dst[rng.random(e) < 0.1] = -1                   # dropped edges
        lens = rng.integers(run // 2, 3 * run, 3)        # hubs next to
        for v, k in zip(rng.choice(n, 3), lens):         # hubs
            dst[rng.choice(e, min(e, k), replace=False)] = v
        found, read, start = _hub_runs(dst, n, run)
        assert found == read
        rows = list(found.values())
        assert len(set(rows)) == len(rows)
        assert all(0 <= r < 2 * -(-e // run) for r in rows)
        if run == kernel.RUN:
            assert max(rows, default=0) < 2 * p.windows
        cnt = np.bincount(np.clip(dst, -1, n)[dst >= 0], minlength=n)
        assert (cnt > run).sum() == len({
            int(np.searchsorted(start, a, "right")) - 1 for a, _ in found})
    blocks = -(-e // (p.sub * kernel.TILE))
    assert blocks == p.nb and p.nb * kernel.BINS * 4 <= kernel.workspace_sizes(
        e, n, 64, p.passes, p.nb, p.windows)["ws_hist"]


def test_plan_fields_follow_the_source_enum():
    """The plan goes to the CUDA source as an int64 array indexed by its
    P_* enum: the two orders must agree."""
    import re

    src = kernel.SOURCE.read_text()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "P_COUNT"
    assert [x[2:].lower() for x in names[:-1]] == list(kernel.PLAN_FIELDS)
    # and the constants the plan copies are the source's
    defines = dict(re.findall(r"#define (SR_\w+) (\d+)", src))
    for name, value in (("SR_THREADS", kernel.THREADS),
                        ("SR_RUN", kernel.RUN), ("SR_BITS", kernel.BITS),
                        ("SR_BINS", kernel.BINS), ("SR_TILE", kernel.TILE)):
        assert int(defines[name]) == value, name
    assert kernel.BINS == 1 << kernel.BITS
    assert kernel.RUN == ref.RUN
