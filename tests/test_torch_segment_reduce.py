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
from repro_torch.kernels.segment_reduce import kernel, ops

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
    (100_000, 3_200_000, 8, 4, 0),          # tile counters off chip
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
    # the tile accumulator fits in a block's shared memory
    assert p.tn <= 256 and p.smem == (p.tn * p.dc + p.ch) * 4
    assert p.smem <= kernel.SMEM_LIMIT
    assert p.tiles * p.tn >= n > (p.tiles - 1) * p.tn
    assert p.p_max == p.tiles + e // p.ch and p.dtype == (elem == 2)
    # the edge walks' tile counters: in shared memory when they fit
    assert p.priv == (p.tiles <= kernel.PRIV_TILES)
    assert not p.priv or p.tiles * 4 <= kernel.SMEM_LIMIT
    assert 1 <= p.grid_edges <= (kernel.GRID_PRIV if p.priv
                                 else kernel.GRID_EDGES)
    # workspace arrays: aligned, in order, without overlap
    names = [f for f in kernel.PLAN_FIELDS if f.startswith("ws_")]
    offs = [getattr(p, f) for f in names]
    assert all(o % kernel.ALIGN == 0 for o in offs) and offs == sorted(offs)
    assert p.ws_order - p.ws_meta >= 8 and p.ws_lrow - p.ws_order >= 4 * e
    assert p.ws_scratch - p.ws_lrow >= e
    assert p.ws_bytes - p.ws_scratch >= 4 * p.m_max * p.tn * d
    assert list(p.c_args) == [getattr(p, f) for f in kernel.PLAN_FIELDS]


def test_launch_plan_cuts_wide_rows_and_narrow_d1():
    wide = kernel.plan(300, 40, 65536, 4, 0)
    assert 65536 * 4 > kernel.SMEM_LIMIT            # no TN fits a whole row
    assert wide.n_cc == 512 and wide.dc == 128 and wide.lr == 32
    d1 = kernel.plan(10_000, 500, 1, 4, 0)
    assert (d1.vec, d1.dc, d1.n_cc, d1.lr) == (4, 1, 1, 1)   # 32 edges/warp
    l1 = kernel.plan(61_225_725, 2_449_029, 100, 2, 0)
    assert (l1.vec, l1.dc, l1.lr, l1.smem) == (8, 100, 32, 51_200 + 16_384)
    assert l1.priv and l1.tiles * 4 == 76_536          # 19,134 counters
    big = kernel.plan(1000, 3_200_000, 64, 2, 0)         # 25,000 tiles
    assert not big.priv and big.grid_edges == 4
    assert kernel.plan(100, 10, 100, 2, 8).vec == 8          # msg[1:]
    assert kernel.plan(100, 10, 3, 4, 12).vec == 4


@pytest.mark.parametrize("hub", [0.0, 0.4, 0.99])
@pytest.mark.parametrize("e,n", [(61_225_725, 2_449_029), (200_000, 5000),
                                 (9000, 3)])
def test_launch_plan_bounds_hold_for_any_counts(e, n, hub):
    """The grids are sized from E and N alone: the pieces and hub tiles
    that the scan makes from the actual tile counts never exceed them."""
    p = kernel.plan(e, n, 64, 2, 0)
    rng = np.random.default_rng(e + n)
    for _ in range(3):
        tiles = rng.integers(0, p.tiles, e)
        tiles[rng.random(e) < hub] = 0
        tiles = tiles[rng.random(e) > 0.1]              # dropped edges
        cnt = np.bincount(tiles, minlength=p.tiles)
        pieces = np.maximum(1, -(-cnt // p.ch))
        assert pieces.sum() <= p.p_max
        assert (cnt > p.ch).sum() <= p.m_max


def test_plan_fields_follow_the_source_enum():
    """The plan goes to the CUDA source as an int64 array indexed by its
    P_* enum: the two orders must agree."""
    import re

    src = kernel.SOURCE.read_text()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "P_COUNT"
    assert [x[2:].lower() for x in names[:-1]] == list(kernel.PLAN_FIELDS)
