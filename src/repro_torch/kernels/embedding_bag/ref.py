"""The plain torch version of the embedding_bag kernel.

The wrapper in ``ops`` takes it for CPU tensors and for the REF backend;
on the card only the tests and ``chip_smoke.py`` call it.  Semantics of
``repro.kernels.embedding_bag.ref``, with the kernel's accumulation: a
gather of the ids' table rows, summed per bag in float32, cast back to
the table's dtype (in float64 for a float64 table, which the tests'
``gradcheck`` takes).  Ids of -1 add nothing; a bag with no ids is
zeros.
"""

from __future__ import annotations

import torch


def embedding_bag(ids, bags, table, n_bags: int):
    """sum-mode EmbeddingBag: ids int32 [T] (-1 = padding), bags int32
    [T], table [V, D] -> [n_bags, D] in the table's dtype."""
    acc = torch.float64 if table.dtype == torch.float64 else torch.float32
    ok = ids >= 0
    rows = table[ids.clamp(min=0).long()].to(acc)
    rows.masked_fill_(~ok[:, None], 0)
    seg = torch.where(ok, bags, n_bags).long()
    out = torch.zeros((n_bags + 1, table.shape[1]), dtype=acc,
                      device=table.device)
    out.index_add_(0, seg, rows)
    return out[:n_bags].to(table.dtype)
