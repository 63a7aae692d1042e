"""The plain torch version of the segment_sum kernel.

The wrapper in ``ops`` takes it for CPU tensors and for the REF backend;
on the card only the tests and ``chip_smoke.py`` call it.  Semantics of
``repro.kernels.segment_reduce`` with the kernel's accumulation:
``out[n] = sum of msg[e] over dst[e] == n`` in float32, cast back to the
message dtype; ids outside [0, N) are dropped.
"""

from __future__ import annotations

import torch


def segment_sum(dst, msg, n_nodes: int):
    """dst int [E], msg [E, D] -> [n_nodes, D] in msg's dtype."""
    seg = torch.where((dst >= 0) & (dst < n_nodes), dst, n_nodes).long()
    out = torch.zeros((n_nodes + 1, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, seg, msg.float())
    return out[:n_nodes].to(msg.dtype)

