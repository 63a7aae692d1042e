"""The plain torch versions of the compat_join kernels.

The wrappers in ``ops`` take them for CPU tensors; on the card only the
REF backend, the tests and ``chip_smoke.py`` call them.  They are the
reference semantics: ``compat_mask`` materializes the [S, CA, CB] mask;
``compat_join_pairs`` extracts the first ``max_new`` pairs of each
slot's mask in row-major order.
"""

from __future__ import annotations

import torch

from repro_torch.core.join import (
    as_window,
    compat_mask_ref,
    extract_pairs,
    n_slots_of,
)


# the plain mask is the REF join predicate itself
compat_mask = compat_mask_ref


def _slot(x, s, nd):
    """Slot ``s`` of a slot-stacked operand, as a stack of one (a shared
    operand passes through)."""
    return x[s:s + 1] if x.dim() == nd else x


def compat_join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                      rel, trel, max_new: int, window=None):
    """Plain fused join: ``(a_idx, b_idx, pair_valid, n_dropped)`` per
    slot, pairs in row-major order of the mask.

    One slot at a time, so the transient mask is [CA, CB] and not
    [S, CA, CB] (a full-size slot group's masks would not fit beside
    the tables).
    """
    n = n_slots_of(bind_a, bind_b, window)
    w = as_window(window, n, bind_a.device)
    outs = []
    for s in range(n):
        mask = compat_mask_ref(
            _slot(bind_a, s, 3), _slot(ets_a, s, 3), _slot(valid_a, s, 2),
            _slot(bind_b, s, 3), _slot(ets_b, s, 3), _slot(valid_b, s, 2),
            rel, trel, None if w is None else w[s:s + 1])
        outs.append(extract_pairs(mask, max_new))
        del mask
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
