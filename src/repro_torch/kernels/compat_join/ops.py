"""Public wrappers of the compat_join kernels.

``compat_join_pairs`` is the fused compatibility join + pair extraction
over a slot axis: the port of ``repro.kernels.compat_join.ops.
compat_join_pairs`` and of its batched (custom-vmap) rule in one
function.  On CUDA tensors it launches the hand-written kernel
(``kernel.compat_join_pairs_cuda``, source ``csrc/compat_join.cu``) or
raises; on CPU tensors it runs the plain version (``ref``), because the
tensors lie on the CPU.  No ``try`` falls back from one to the other.

Contract: ``(a_idx, b_idx, pair_valid, n_dropped)`` exactly as
``repro_torch.core.join.extract_pairs`` applied to each slot's join mask:
int64 [S, max_new] ×2 (0 where not valid), bool [S, max_new], int32 [S].
The kernel emits pairs in the mask's row-major order, so it agrees with
the plain version element for element, overflow included.

``compat_mask`` is the join predicate as a dense bool mask [S, CA, CB]:
the port of ``repro.kernels.compat_join.ops.compat_mask`` and of its
batched rule, one launch for S = 1 and for a slot group alike.  It
equals the plain version (``ref.compat_mask``) element for element.

``compat_join_pairs.launches`` and ``compat_mask.launches`` count kernel
launches (one per call that reaches the card); ``chip_smoke.py`` zeroes
and reads them around each path.
"""

from __future__ import annotations

import torch

from repro_torch.core.join import as_window, n_slots_of
from repro_torch.kernels.compat_join import kernel as K
from repro_torch.kernels.compat_join import ref as R


def compat_join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                      rel, trel, max_new: int, window=None):
    """Fused join over a slot axis; every operand may be slot-stacked
    ([S, C, ...]) or shared across slots ([C, ...]).  ``window`` is None,
    an int, or int32 [S]."""
    if not bind_a.is_cuda:
        return R.compat_join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b,
                                   valid_b, rel, trel, max_new, window)
    n = n_slots_of(bind_a, bind_b, window)
    w = as_window(window, n, bind_a.device)
    a_raw, b_raw, n_total = K.compat_join_pairs_cuda(
        bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
        int(max_new), w, n)
    compat_join_pairs.launches += 1
    pair_valid = a_raw >= 0
    a_idx = a_raw.clamp(min=0).long()
    b_idx = b_raw.clamp(min=0).long()
    n_dropped = (n_total - int(max_new)).clamp(min=0)
    return a_idx, b_idx, pair_valid, n_dropped


compat_join_pairs.launches = 0


def compat_mask(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
                window=None):
    """The join mask over a slot axis -> bool [S, CA, CB]; operands and
    ``window`` as for ``compat_join_pairs``."""
    if not bind_a.is_cuda:
        return R.compat_mask(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                             rel, trel, window)
    n = n_slots_of(bind_a, bind_b, window)
    w = as_window(window, n, bind_a.device)
    out = K.compat_mask_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                             rel, trel, w, n)
    compat_mask.launches += 1
    return out


compat_mask.launches = 0
