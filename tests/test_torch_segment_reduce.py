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
from repro_torch.kernels.segment_reduce import ops

GRID = [
    (64, 16, 8, "float32"),
    (1024, 256, 128, "float32"),
    (700, 100, 32, "float32"),
    (512, 512, 16, "bfloat16"),
    (1, 5, 4, "float32"),
]
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=1e-2, atol=2e-2)}


def _inputs(e, n, d, dtype):
    rng = np.random.default_rng(e + n)
    dst = rng.integers(0, n, e).astype(np.int32)
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
