"""Public wrappers of the segment_sum kernel.

``segment_sum`` and ``segment_mean`` are the ports of
``repro.kernels.segment_reduce.ops``.  On CUDA tensors ``segment_sum``
launches the hand-written kernel (``kernel.segment_sum_cuda``, source
``csrc/segment_reduce.cu``) or raises; on CPU tensors it runs the plain
version (``ref``), because the tensors lie on the CPU.  No ``try`` falls
back from one to the other.

The kernel's launch sits inside ``SegmentSum``, a
``torch.autograd.Function``: its backward is the transpose of the
scatter-add, the gather ``grad_msg[e] = grad_out[dst[e]]`` (0 where
``dst[e]`` is outside [0, N)), plain torch as XLA's transpose of a
scatter is (the TPU kernel has no VJP, so there is no backward kernel to
port).  The plain version is differentiable through ``index_add_``.

``segment_sum.launches`` counts forward kernel launches (``segment_mean``
makes two); ``chip_smoke.py`` zeroes and reads it around each GNN path.
"""

from __future__ import annotations

import torch

from repro_torch.core.join import JoinBackend, resolve_backend
from repro_torch.kernels.segment_reduce import kernel as K
from repro_torch.kernels.segment_reduce import ref as R


class SegmentSum(torch.autograd.Function):
    """``fwd(dst, msg, n_nodes)`` with the scatter-add's gradient.
    ``fwd`` is the kernel's launch on the card; a test hands it the plain
    version to check the backward on the CPU."""

    @staticmethod
    def forward(ctx, dst, msg, n_nodes: int, fwd):
        ctx.save_for_backward(dst)
        ctx.n_nodes = n_nodes
        return fwd(dst, msg, n_nodes)

    @staticmethod
    def backward(ctx, grad_out):
        (dst,) = ctx.saved_tensors
        ok = (dst >= 0) & (dst < ctx.n_nodes)
        grad = grad_out[torch.where(ok, dst, 0).long()]
        grad.masked_fill_(~ok[:, None], 0)        # a fresh gather
        return None, grad, None, None


def segment_sum(dst, msg, n_nodes: int, backend: str | None = None):
    """``out[n] = sum of msg[e] over dst[e] == n`` -> [n_nodes, D] in
    msg's dtype (accumulated in float32 by the kernel, in the one order
    ``ref.segment_sum_ordered`` states, and in float64 by the plain
    version); dst < 0 or >= n_nodes dropped.
    ``backend`` None is the device default (the kernel on the card, the
    plain version on the CPU); "ref" is the plain version anywhere;
    "cuda" with CPU tensors raises.  Differentiable in ``msg`` both
    ways."""
    backend = resolve_backend(backend, msg.device)
    if backend == JoinBackend.REF:
        return R.segment_sum(dst, msg, n_nodes)
    out = SegmentSum.apply(dst.int(), msg, int(n_nodes), K.segment_sum_cuda)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_mean(dst, msg, n_nodes: int, backend: str | None = None,
                 eps: float = 1e-9):
    s = segment_sum(dst, msg, n_nodes, backend)
    cnt = segment_sum(dst, msg.new_ones((msg.shape[0], 1)), n_nodes, backend)
    return s / cnt.clamp(min=eps)
