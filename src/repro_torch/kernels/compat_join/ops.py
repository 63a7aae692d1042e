"""Public wrappers of the compat_join kernels.

``compat_join_pairs`` is the fused compatibility join + pair extraction
over a slot axis: the port of ``repro.kernels.compat_join.ops.
compat_join_pairs`` and of its batched (custom-vmap) rule in one
function.  On CUDA tensors it launches the hand-written kernels
(``kernel.compat_join_pairs_cuda``, source ``csrc/compat_join.cu``:
count per (A row, B tile), scan, emit only where pairs are) or raises;
on CPU tensors it runs the plain version (``ref``), because the tensors
lie on the CPU.  No ``try`` falls back from one to the other.

Contract: ``(a_idx, b_idx, pair_valid, n_dropped)`` exactly as
``repro_torch.core.join.extract_pairs`` applied to each slot's join mask:
int64 [S, max_new] ×2 (0 where not valid), bool [S, max_new], int32 [S].
The kernels write these outputs themselves (no elementwise pass after
them) and emit pairs in the mask's row-major order, so they agree with
the plain version element for element, overflow included.

``compat_mask`` is the join predicate as a dense bool mask [S, CA, CB]:
the port of ``repro.kernels.compat_join.ops.compat_mask`` and of its
batched rule, one launch for S = 1 and for a slot group alike (staged B
tiles, 16-byte stores).  It equals the plain version (``ref.compat_mask``)
element for element.

``compat_join_pairs.launches`` and ``compat_mask.launches`` count kernel
launches (one per call that reaches the card), and
``compat_join_pairs.launches_by_slots`` the same launches by slot count
S; ``chip_smoke.py`` zeroes and reads them around each path.
"""

from __future__ import annotations

from collections import Counter

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
    out = K.compat_join_pairs_cuda(
        bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
        int(max_new), w, n)
    compat_join_pairs.launches += 1
    compat_join_pairs.launches_by_slots[n] += 1
    return out


compat_join_pairs.launches = 0
compat_join_pairs.launches_by_slots = Counter()


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
