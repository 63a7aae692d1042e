"""Public wrapper of the embedding_bag kernel.

``embedding_bag`` is the port of ``repro.kernels.embedding_bag.ops.
embedding_bag``: sum-mode EmbeddingBag over a flat (ids, bags) layout.
On CUDA tensors it launches the hand-written kernel
(``kernel.embedding_bag_cuda``, source ``csrc/embedding_bag.cu``) or
raises; on CPU tensors it runs the plain version (``ref``), because the
tensors lie on the CPU.  No ``try`` falls back from one to the other.

The kernel's launch sits inside ``EmbeddingBag``, a
``torch.autograd.Function``: its backward is the transpose of the bag
sum, ``grad_table[ids[t]] += grad_out[bags[t]]`` (nothing for an id of
-1), a segment sum over the table's rows that runs on the ported
``segment_sum`` kernel (float32 accumulation; it drops ``dst < 0``
itself).  The TPU kernel has no VJP, so there is no backward kernel to
port.  The plain version is differentiable through ``index_add_``.

``embedding_bag.launches`` counts forward kernel launches (the backward's
are ``segment_sum.launches``); ``chip_smoke.py`` zeroes and reads it
around each Wide&Deep path.
"""

from __future__ import annotations

import torch

from repro_torch.core.join import JoinBackend, resolve_backend
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag import ref as R
from repro_torch.kernels.segment_reduce import ops as sr


class EmbeddingBag(torch.autograd.Function):
    """``fwd(ids, bags, table, n_bags)`` with the bag sum's gradient in
    ``table``.  ``fwd`` is the kernel's launch on the card; a test hands
    it the plain version to check the backward on the CPU."""

    @staticmethod
    def forward(ctx, ids, bags, table, n_bags: int, fwd):
        ctx.save_for_backward(ids, bags)
        ctx.n_rows = table.shape[0]
        return fwd(ids, bags, table, n_bags)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None, None
        ids, bags = ctx.saved_tensors
        grad = sr.segment_sum(ids, grad_out[bags.long()], ctx.n_rows)
        return None, None, grad, None, None


def embedding_bag(ids, bags, table, n_bags: int, backend: str | None = None):
    """sum-mode EmbeddingBag -> [n_bags, D] in the table's dtype.

    ids  int32 [T]: table rows, -1 = padding (adds nothing)
    bags int32 [T]: destination bag per id, sorted ascending (the
                    kernel relies on it and does not check it)

    A bag with no ids is zeros.  Differentiable in ``table`` both ways.
    ``backend`` None is the device default
    (the kernel on the card, the plain version on the CPU); "ref" is the
    plain version anywhere; "cuda" with CPU tensors raises.
    """
    if backend is not None or not table.is_cuda:   # None on the card: CUDA
        if resolve_backend(backend, table.device) == JoinBackend.REF:
            return R.embedding_bag(ids, bags, table, n_bags)
    if ids.dtype != torch.int32:
        ids = ids.int()
    if bags.dtype != torch.int32:
        bags = bags.int()
    out = EmbeddingBag.apply(ids, bags, table, int(n_bags),
                             K.embedding_bag_cuda)
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
