"""The port's embedding_bag against the reference's.

The same numpy inputs go through the Pallas kernel in interpret mode
(``repro.kernels.embedding_bag.ops.embedding_bag(...,
backend="pallas_interpret")``) and through the port's wrapper on the CPU
(its plain version).  Where the two contracts differ, for a bag with no
ids (the TPU kernel leaves its row unwritten, the port writes zeros),
the reference side is its plain version (``backend="xla"``).
Tolerance: float32, rtol 1e-5 / atol 1e-6 (sums of a few table rows in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as ref_ops

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.kernels.embedding_bag import kernel, ops, ref


def _case(rng, n_bags, per_bag, v, d, empty_bag):
    t = n_bags * per_bag
    ids = rng.integers(0, v, t).astype(np.int32)
    ids[rng.random(t) < 0.25] = -1                   # padding ids
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), per_bag)
    if empty_bag:                      # bag 2 gets no ids: they go to bag 3
        bags[bags == 2] = 3
    table = rng.standard_normal((v, d)).astype(np.float32)
    return ids, bags, table


@pytest.mark.parametrize("n_bags,per_bag,v,d,empty_bag", [
    (16, 4, 50, 1, False),       # the wide side's D
    (16, 4, 50, 8, False),
    (12, 5, 80, 1, True),        # an empty bag
    (12, 5, 80, 8, True),
    (32, 1, 1000, 8, False),     # one id per bag
    (32, 1, 1000, 1, False),
    (4, 100, 500, 1, False),     # bags of 100 ids: several loads a lane
    (4, 100, 500, 8, True),
])
def test_embedding_bag_matches_reference(n_bags, per_bag, v, d, empty_bag):
    rng = np.random.default_rng(n_bags * v + d)
    ids, bags, table = _case(rng, n_bags, per_bag, v, d, empty_bag)
    backend = "xla" if empty_bag else "pallas_interpret"
    want = np.asarray(ref_ops.embedding_bag(
        jnp.asarray(ids), jnp.asarray(bags), jnp.asarray(table), n_bags,
        backend=backend))
    got = ops.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bags),
                            torch.as_tensor(table), n_bags)
    assert got.shape == (n_bags, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if empty_bag:
        assert not got[2].any()


def test_bfloat16_table_sums_in_float32():
    rng = np.random.default_rng(4)
    ids, bags, table = _case(rng, 8, 6, 40, 4, False)
    tb = torch.as_tensor(table).bfloat16()
    got = ref.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bags), tb, 8)
    want = ref.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bags),
                             tb.float(), 8).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_cuda_backend_refuses_cpu_tensors():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(ids, ids, torch.zeros(3, 2), 2, backend="cuda")


# The CUDA launch plan (kernel.plan): (T, n_bags, D, bytes per value,
# data_ptr % 16) at Wide&Deep's wide side (serve_p99, serve_bulk), the
# general D = 32 case and the GPU tests' edge cases.
@pytest.mark.parametrize("t,n_bags,d,elem,align", [
    (8192, 512, 1, 4, 0), (4_194_304, 262_144, 1, 4, 0),
    (524_288, 65_536, 32, 4, 0), (524_288, 65_536, 32, 2, 0),
    (0, 1, 1, 4, 0), (37, 1, 32, 4, 0), (103, 3, 1, 2, 0),
    (3000, 100, 1, 4, 0), (5000, 200, 100, 4, 0), (5000, 200, 100, 2, 8),
    (64, 8, 3, 4, 4), (64, 8, 3, 2, 2),
])
def test_launch_plan(t, n_bags, d, elem, align):
    p = kernel.plan(t, n_bags, 1000, d, elem, align)
    assert align % p.vec == 0 and (d * elem) % p.vec == 0 and p.vec >= elem
    wider = [v for v in kernel.VEC_BYTES if v > p.vec]
    assert all(align % v or (d * elem) % v for v in wider)
    ve = p.vec // elem
    if d == 1:          # several bags to a warp: 8 lanes, 16 for long bags
        assert p.lr == 1 and p.gw == (8 if t <= 16 * n_bags else 16)
    else:               # a bag to a warp; lr lanes cover a row's loads
        assert p.gw == 32 and p.lr & (p.lr - 1) == 0
        assert p.lr == min(32, 1 << (-(-d // ve) - 1).bit_length())
    # k_bags bags a group: as many as keep two waves of blocks
    groups = kernel.THREADS // p.gw
    assert 1 <= p.k_bags <= kernel.MAX_K
    assert p.k_bags == 1 or n_bags >= p.k_bags * groups * kernel.WAVE_BLOCKS
    per_block = groups * p.k_bags
    assert per_block <= 256                     # EB_MAX_BAGS in the source
    assert (p.blocks - 1) * per_block < n_bags <= p.blocks * per_block
    assert list(p.c_args) == [getattr(p, f) for f in kernel.PLAN_FIELDS]


def test_launch_plan_groups_at_d1():
    v = 4_000_000
    assert kernel.plan(8192, 512, v, 1, 4, 0).gw == 8          # serve_p99
    bulk = kernel.plan(4_194_304, 262_144, v, 1, 4, 0)        # serve_bulk
    assert (bulk.gw, bulk.k_bags, bulk.blocks) == (8, 3, 2731)
    assert kernel.plan(3000, 100, v, 1, 4, 0).gw == 16         # 30 ids a bag
    assert kernel.plan(524_288, 65_536, v, 32, 4, 0).lr == 8   # 16-byte loads


def test_plan_fields_follow_the_source_enum():
    """The plan goes to the CUDA source as an int64 array indexed by its
    E_* enum: the two orders must agree."""
    import re

    body = re.search(r"enum \{(.*?)\};", kernel.SOURCE.read_text(),
                     re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "E_COUNT"
    assert [x[2:].lower() for x in names[:-1]] == list(kernel.PLAN_FIELDS)
