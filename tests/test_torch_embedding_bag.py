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
from repro_torch.kernels.embedding_bag import ops, ref


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
