"""Public wrapper of the embedding_bag kernel.

``embedding_bag`` is the port of ``repro.kernels.embedding_bag.ops.
embedding_bag``: sum-mode EmbeddingBag over a flat (ids, bags) layout.
On CUDA tensors it launches the hand-written kernel
(``kernel.embedding_bag_cuda``, source ``csrc/embedding_bag.cu``) or
raises; on CPU tensors it runs the plain version (``ref``), because the
tensors lie on the CPU.  No ``try`` falls back from one to the other.

``embedding_bag.launches`` counts kernel launches; ``chip_smoke.py``
zeroes and reads it around the Wide&Deep serving path.
"""

from __future__ import annotations

import torch

from repro_torch.core.join import JoinBackend, resolve_backend
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag import ref as R


def embedding_bag(ids, bags, table, n_bags: int, backend: str | None = None):
    """sum-mode EmbeddingBag -> [n_bags, D] in the table's dtype.

    ids  int32 [T]: table rows, -1 = padding (adds nothing)
    bags int32 [T]: destination bag per id, sorted ascending (the
                    kernel relies on it and does not check it)

    A bag with no ids is zeros.  ``backend`` None is the device default
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
    out = K.embedding_bag_cuda(ids, bags, table, int(n_bags))
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
