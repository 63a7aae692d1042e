"""The segment_sum kernel's fixed order, in plain torch
(``ref.segment_sum_ordered``).

The CUDA kernel sums each node's edges in one documented order (the
source's header and ``ref``'s docstring): the node's edges in ascending
index, cut into runs of RUN, each run summed left to right in float32
from +0, the run sums added left to right.  On the card the kernel must
equal ``segment_sum_ordered`` bit for bit (``chip_smoke.py``,
``tests/test_torch_gpu.py``); here the function itself is held:

* to the JAX package's Pallas kernel in interpret mode (its edge blocks
  walked in sequence into a float32 accumulator) within the float32
  summation bound ``2 deg 2^-24 sum|msg|`` plus one bf16 rounding, and
  exactly for small-integer messages;
* to a sequential numpy oracle of the stated order, bit for bit, on the
  order's boundaries: a node of exactly RUN, RUN + 1 and more than two
  runs of edges, two hubs side by side, D wider than ``DC_MAX``;
* to itself, bit for bit, under any permutation of the edges that keeps
  each node's relative order, and, for a node, when other nodes' edges
  are inserted or dropped (hypothesis).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import ops as ref_ops

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.kernels.segment_reduce import kernel, ref

RUN = ref.RUN


def _oracle(dst, msg, n, run):
    """The order, one float32 add at a time (numpy)."""
    m = msg.float().numpy()
    out = np.zeros((n, m.shape[1]), np.float32)
    for v in range(n):
        edges = np.nonzero(dst == v)[0]
        total = np.zeros(m.shape[1], np.float32)
        for r0 in range(0, len(edges), run):
            s = np.zeros(m.shape[1], np.float32)
            for e in edges[r0:r0 + run]:
                s = s + m[e]
            total = total + s
        out[v] = total
    return torch.as_tensor(out).to(msg.dtype)


def _graph(rng, e, n, hubs=(), drop=0.1):
    """dst [e]: each hub (node, k) takes exactly k edges at random
    places, the other edges uniform over the other nodes, a share
    ``drop`` of them outside [0, n)."""
    others = np.setdiff1d(np.arange(n), [v for v, _ in hubs])
    dst = rng.choice(others, e)
    dst[rng.random(e) < drop] = rng.choice([-1, n, n + 5])
    places = rng.permutation(e)
    at = 0
    for v, k in hubs:
        dst[places[at:at + k]] = v
        at += k
    return dst.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,n,d,hubs", [
    (4096, 300, 8, ((7, 2500),)),           # a node of more than 2 runs
    (2048, 64, 16, ((3, RUN), (40, RUN + 1))),
    (1024, 512, 4, ()),
])
def test_ordered_sum_matches_the_interpreted_kernel(e, n, d, hubs, dtype):
    rng = np.random.default_rng(e + n + d)
    dst = _graph(rng, e, n, hubs)
    normal = rng.standard_normal((e, d)).astype(np.float32)
    ints = rng.integers(-4, 5, (e, d)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    for values, exact in ((normal, False), (ints, True)):
        msg = torch.as_tensor(values).to(tdtype)
        got = ref.segment_sum_ordered(torch.as_tensor(dst), msg, n)
        want = np.asarray(ref_ops.segment_sum(
            jnp.asarray(dst), jnp.asarray(msg.float().numpy(),
                                          getattr(jnp, dtype)),
            n, backend="pallas_interpret"), np.float32)
        assert got.dtype == tdtype and got.shape == (n, d)
        got = got.float().numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
            continue
        ok = (dst >= 0) & (dst < n)
        deg = np.bincount(dst[ok], minlength=n)[:, None]
        abs_sum = np.zeros((n, d), np.float64)
        np.add.at(abs_sum, dst[ok], np.abs(msg.float().numpy()[ok]))
        tol = 2 * deg * 2.0**-24 * abs_sum
        if dtype == "bfloat16":          # each side rounds once to bf16
            tol = tol + 2 * 2.0**-8 * np.abs(want)
        assert (np.abs(got - want) <= tol + 1e-30).all()


@pytest.mark.parametrize("case", [
    "run_exact", "run_plus_one", "three_runs", "hubs_side_by_side",
    "wide_rows", "no_edges", "all_dropped", "bf16"])
def test_ordered_sum_on_the_order_boundaries(case):
    rng = np.random.default_rng(len(case))
    n, d, dtype, run = 50, 4, torch.float32, RUN
    e, hubs = 3 * RUN, ()
    if case == "run_exact":
        hubs = ((5, RUN),)
    elif case == "run_plus_one":
        hubs = ((5, RUN + 1),)
    elif case == "three_runs":
        e, hubs = 4 * RUN, ((5, 2 * RUN + 7),)
    elif case == "hubs_side_by_side":        # consecutive in sorted order
        hubs = ((5, RUN + 3), (6, RUN + 900))
    elif case == "wide_rows":
        e, d, hubs = RUN + 300, kernel.DC_MAX + 172, ((2, RUN + 100),)
    elif case == "no_edges":
        e = 0
    elif case == "bf16":
        dtype, hubs = torch.bfloat16, ((5, 2 * RUN + 1),)
    dst = _graph(rng, e, n, hubs, drop=0.05)
    if case == "all_dropped":
        dst[:] = -1
    # magnitudes that make the order visible in the last bits
    msg = torch.as_tensor(rng.standard_normal((e, d)) * 10.0 ** rng.integers(
        -4, 4, (e, 1))).to(dtype)
    got = ref.segment_sum_ordered(torch.as_tensor(dst), msg, n)
    assert torch.equal(got, _oracle(dst, msg, n, run))
    for v, k in hubs:
        assert int((dst == v).sum()) == k
    if case in ("no_edges", "all_dropped"):
        assert not got.any()


def test_the_order_is_the_runs_not_one_running_sum():
    """A hub of 2 RUN edges, 2^24 and then ones: one running sum loses
    every one (2^24 + 1 rounds to 2^24), the runs keep the second run's
    RUN ones (it starts from 0), so the function follows the runs."""
    dst = np.zeros(2 * RUN, np.int32)
    vals = np.ones((2 * RUN, 1), np.float32)
    vals[0] = 2.0**24
    msg = torch.as_tensor(vals)
    got = ref.segment_sum_ordered(torch.as_tensor(dst), msg, 1)
    running = np.float32(0)
    for x in vals[:, 0]:
        running = np.float32(running + x)
    assert float(running) == 2.0**24
    assert float(got[0, 0]) == 2.0**24 + RUN
    assert torch.equal(got, _oracle(dst, msg, 1, RUN))


hyp = pytest.importorskip("hypothesis")
st = hyp.strategies


@hyp.settings(max_examples=40, deadline=None)
@hyp.given(seed=st.integers(0, 2**31 - 1), e=st.integers(0, 300),
           n=st.integers(1, 9), d=st.integers(1, 3), run=st.integers(1, 7),
           bf16=st.booleans())
def test_ordered_sum_keeps_each_nodes_order(seed, e, n, d, run, bf16):
    """Bit for bit: unchanged under a permutation of the edges that keeps
    each node's relative order; a node's sum unchanged when other
    nodes' edges are inserted or dropped; and the oracle's bits."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n + 1, e).astype(np.int32)
    dtype = torch.bfloat16 if bf16 else torch.float32
    msg = torch.as_tensor(rng.standard_normal((e, d)) * 10.0 ** rng.integers(
        -3, 4, (e, 1))).to(dtype)
    base = ref.segment_sum_ordered(torch.as_tensor(dst), msg, n, run=run)
    assert torch.equal(base, _oracle(dst, msg, n, run))
    # an order-keeping permutation: nodes in a random order, each
    # node's edges in their order
    key = rng.permutation(n + 2)[np.clip(dst, -1, n) + 1]
    perm = np.argsort(key, kind="stable")
    got = ref.segment_sum_ordered(torch.as_tensor(dst[perm]), msg[perm], n,
                                  run=run)
    assert torch.equal(got, base)
    # another node's edges inserted and dropped: node v keeps its sum
    v = int(rng.integers(0, n))
    keep = (dst == v) | (rng.random(e) < 0.5)
    extra = rng.integers(0, n, 50).astype(np.int32)
    extra[extra == v] = -1
    at = np.sort(rng.integers(0, keep.sum() + 1, 50))
    dst2 = np.insert(dst[keep], at, extra)
    msg2 = torch.as_tensor(np.insert(msg[torch.as_tensor(keep)].float()
                                     .numpy(), at, rng.standard_normal(
                                         (50, d)), axis=0)).to(dtype)
    got = ref.segment_sum_ordered(torch.as_tensor(dst2), msg2, n, run=run)
    assert torch.equal(got[v], base[v])
