"""The yardstick of the join: the least work a call needs, and the
least time the H100 could take for it.

``join_work`` counts what any implementation of
``repro_torch.core.join.join_pairs`` must touch on these inputs: each
valid mask read once, the bindings and timestamps of the live rows read
once, the window read once, and each emitted pair (two int64 indices
and its valid flag) written once with the per-slot drop count; its
operations are the predicate once per emitted pair.  A kernel that reads
only live rows or joins by hashing needs no less, so the share of this
bound cannot pass 100% however the join is redesigned.

``nested_loop_work`` is ``chip_smoke.py``'s older count (every input at
capacity, the predicate on every pair of valid rows); the trace file
keeps it as a diagnostic and no metric reads it.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet; full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
# The predicate is int32 compare and select work on the CUDA cores:
# 67 TFLOP/s fp32 outside the tensor cores counts an FMA as two
# operations, so 33.5e12 simple operations a second.
INT_OPS_PER_S = 33.5e12

PAIR_OUT_BYTES = 8 + 8 + 1       # a_idx, b_idx (int64), pair_valid (bool)


def predicate_ops(nva: int, nvb: int, trel_nonzero: int, nea: int,
                  neb: int, windowed: bool) -> int:
    """Operations of the predicate on one pair: every vertex-slot
    comparison, every ordered edge-slot comparison and the valid AND;
    with a window the min and max of both rows' timestamps, the span and
    its compare."""
    ops = nva * nvb + trel_nonzero + 1
    if windowed:
        ops += 2 * (nea + neb) + 2
    return ops


def join_work(live_a: int, live_b: int, rows_a: int, rows_b: int,
              nva: int, nea: int, nvb: int, neb: int, emitted: int,
              n_slots: int, trel_nonzero: int, windowed: bool):
    """(bytes, operations) the join needs: ``rows_*`` valid-mask entries
    (every slot's, a shared operand's once), ``live_*`` live rows with
    ``nv*`` int32 bindings and ``ne*`` int32 timestamps each,
    ``emitted`` pairs out."""
    nbytes = rows_a + rows_b                         # bool valid masks
    nbytes += 4 * (live_a * (nva + nea) + live_b * (nvb + neb))
    nbytes += 4 * n_slots if windowed else 0         # the window
    nbytes += emitted * PAIR_OUT_BYTES + 4 * n_slots  # pairs, n_dropped
    ops = emitted * predicate_ops(nva, nvb, trel_nonzero, nea, neb,
                                  windowed)
    return nbytes, ops


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    compute rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def nested_loop_work(rows_a: int, rows_b: int, nva: int, nea: int,
                     nvb: int, neb: int, valid_pairs: float, n_slots: int,
                     trel_nonzero: int, windowed: bool, max_new: int):
    """``chip_smoke.py`` ``_work``: every input read at capacity, the
    full output written, the predicate on every pair of valid rows."""
    nbytes = rows_a * (1 + 4 * (nva + nea)) + rows_b * (1 + 4 * (nvb + neb))
    nbytes += 4 * n_slots if windowed else 0
    nbytes += n_slots * max_new * PAIR_OUT_BYTES + 4 * n_slots
    return nbytes, valid_pairs * predicate_ops(nva, nvb, trel_nonzero,
                                               nea, neb, windowed)
