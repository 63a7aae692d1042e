"""The generic compatibility join (Definitions 7/8) and table append helpers.

The port of ``repro.core.join``.  Every function here works over a
leading slot axis: a slot group of ``S`` tenants joins in one call, and a
single query is ``S = 1``.  An operand may also be *shared* across the
slots, given without the slot axis (the stream-edge side of a slot
group's level joins): the plain version broadcasts it, the CUDA kernel
reads it once through a slot stride of 0.

Semantics of one (a, b) pair:
  * vertex slots:  rel[i, j]  => bind_a[a, i] == bind_b[b, j]
                   ~rel[i, j] => bind_a[a, i] != bind_b[b, j]   (injectivity)
  * edge slots:    trel[i, j] == -1 => ets_a[a, i] <  ets_b[b, j]
                   trel[i, j] == +1 => ets_a[a, i] >  ets_b[b, j]
  * both rows valid;
  * with a window: max(all ts) - min(all ts) < window.

The reference's static-size idioms become:
  * ``jnp.nonzero(size=, fill_value=-1)`` -> ``first_true``: a cumsum of
    the mask and a ``searchsorted`` for ranks 1..size, which gives the
    same ascending indices with -1 fill and never synchronises with the
    host (no ``torch.nonzero``, no ``.item()``);
  * ``jnp.take(mode="clip")`` -> a clamp, then a gather with int64
    indices.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


class JoinBackend:
    REF = "ref"      # the plain torch version (any device)
    CUDA = "cuda"    # the hand-written CUDA kernel (CUDA tensors only)

    ALL = (REF, CUDA)

    @staticmethod
    def default(device) -> str:
        """CUDA on a CUDA device, REF on the CPU."""
        return JoinBackend.CUDA if torch.device(device).type == "cuda" \
            else JoinBackend.REF


def resolve_backend(backend: str | None, device) -> str:
    """``None`` -> the device's default; CUDA on a CPU device raises."""
    device = torch.device(device)
    if backend is None:
        return JoinBackend.default(device)
    if backend not in JoinBackend.ALL:
        raise ValueError(f"unknown join backend: {backend!r}")
    if backend == JoinBackend.CUDA and device.type != "cuda":
        raise ValueError(
            f"JoinBackend.CUDA needs a CUDA device, got {device}")
    return backend


# --------------------------------------------------------------------- #
# Static-size index helpers (no host synchronisation).
# --------------------------------------------------------------------- #
def first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Per row of ``mask`` [S, N]: the ascending indices of its first
    ``size`` True entries, -1 filled -> int64 [S, size].  The image of
    ``jnp.nonzero(row, size=size, fill_value=-1)``."""
    s, n = mask.shape
    c = torch.cumsum(mask, dim=1, dtype=I32)
    k = torch.arange(1, size + 1, dtype=I32, device=mask.device)
    pos = torch.searchsorted(c, k.expand(s, size).contiguous())
    return torch.where(pos < n, pos, torch.full_like(pos, -1))


def as_window(window, n_slots: int, device) -> torch.Tensor | None:
    """``None`` (no window predicate), a Python int, or an int32 tensor
    of per-slot spans -> int32 [S] (or None)."""
    if window is None:
        return None
    w = torch.as_tensor(window, dtype=I32, device=device).reshape(-1)
    return w.expand(n_slots) if w.numel() == 1 else w


def n_slots_of(bind_a, bind_b, window=None) -> int:
    """The slot count: the leading axis of any slot-stacked table."""
    for t, nd in ((bind_a, 3), (bind_b, 3)):
        if t.dim() == nd:
            return t.shape[0]
    if window is not None and torch.is_tensor(window) and window.numel() > 1:
        return window.numel()
    return 1


# --------------------------------------------------------------------- #
# The plain join predicate.
# --------------------------------------------------------------------- #
def compat_mask_ref(
    bind_a: torch.Tensor,   # int32 [S, CA, NVA] or shared [CA, NVA]
    ets_a: torch.Tensor,    # int32 [S, CA, NEA] or [CA, NEA]
    valid_a: torch.Tensor,  # bool  [S, CA]      or [CA]
    bind_b: torch.Tensor,   # int32 [S, CB, NVB] or [CB, NVB]
    ets_b: torch.Tensor,    # int32 [S, CB, NEB] or [CB, NEB]
    valid_b: torch.Tensor,  # bool  [S, CB]      or [CB]
    rel: np.ndarray,        # bool  [NVA, NVB]   (host constant)
    trel: np.ndarray,       # int8  [NEA, NEB]   (host constant)
    window=None,            # None | int | int32 [S]
) -> torch.Tensor:          # bool [S, CA, CB]
    """Plain compatibility mask over a slot axis.

    Loops over the (tiny, static) slot-pair dimensions so no
    [S, CA, CB, NV] intermediate exists: each slot pair ANDs one
    [S, CA, CB] comparison into the mask in place.
    """
    s = n_slots_of(bind_a, bind_b, window)

    def st(x, nd):      # shared operand -> a broadcastable slot axis of 1
        return x if x.dim() == nd else x.unsqueeze(0)

    bind_a, ets_a, bind_b, ets_b = (st(bind_a, 3), st(ets_a, 3),
                                    st(bind_b, 3), st(ets_b, 3))
    valid_a, valid_b = st(valid_a, 2), st(valid_b, 2)
    mask = valid_a[:, :, None] & valid_b[:, None, :]
    mask = mask.expand(s, -1, -1).clone()
    w = as_window(window, s, bind_a.device)
    if w is not None:
        min_a = ets_a.amin(dim=2)[:, :, None]
        max_a = ets_a.amax(dim=2)[:, :, None]
        min_b = ets_b.amin(dim=2)[:, None, :]
        max_b = ets_b.amax(dim=2)[:, None, :]
        span = torch.maximum(max_a, max_b) - torch.minimum(min_a, min_b)
        mask &= span < w[:, None, None]
    nva, nvb = rel.shape
    for i in range(nva):
        ai = bind_a[:, :, i][:, :, None]
        for j in range(nvb):
            bj = bind_b[:, :, j][:, None, :]
            if rel[i, j]:
                mask &= ai == bj
            else:
                mask &= ai != bj
    nea, neb = trel.shape
    for i in range(nea):
        ti = ets_a[:, :, i][:, :, None]
        for j in range(neb):
            if trel[i, j] == -1:
                mask &= ti < ets_b[:, :, j][:, None, :]
            elif trel[i, j] == 1:
                mask &= ti > ets_b[:, :, j][:, None, :]
    return mask


def extract_pairs(mask: torch.Tensor, max_new: int):
    """Top-``max_new`` (a, b) index pairs of each slot's join mask
    [S, CA, CB], in row-major order.

    Returns ``(a_idx, b_idx, pair_valid, n_dropped)``: int64 [S, max_new]
    ×2 (0 where not valid), bool [S, max_new], int32 [S].  Pairs beyond
    ``max_new`` are counted as dropped (overflow).
    """
    s, ca, cb = mask.shape
    if ca * cb >= 2**31:
        raise ValueError(f"{ca} x {cb} pairs overflow the int32 counts")
    flat = mask.reshape(s, -1)
    n_true = flat.sum(dim=1, dtype=I32)
    idx = first_true(flat, max_new)
    pair_valid = idx >= 0
    safe = idx.clamp(min=0)
    cb = max(cb, 1)
    n_dropped = (n_true - max_new).clamp(min=0)
    return safe // cb, safe % cb, pair_valid, n_dropped


def _require_cuda(tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"JoinBackend.CUDA needs CUDA tensors, got one on {t.device}")


def compat_mask(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
                window=None, backend: str | None = None) -> torch.Tensor:
    """The join mask, bool [S, CA, CB] (S = 1 when no operand carries a
    slot axis).  ``backend`` None is the tensors' device default: the
    CUDA mask kernel on the card, REF on the CPU; CUDA with CPU tensors
    raises.  Both backends agree element for element."""
    from repro_torch.kernels.compat_join import ops as cj_ops

    tables = (bind_a, ets_a, valid_a, bind_b, ets_b, valid_b)
    if backend is None:
        backend = JoinBackend.default(bind_a.device)
    if backend == JoinBackend.REF:
        return compat_mask_ref(*tables, rel, trel, window)
    if backend == JoinBackend.CUDA:
        _require_cuda(tables)
        return cj_ops.compat_mask(*tables, rel, trel, window)
    raise ValueError(f"unknown join backend: {backend!r}")


def join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
               max_new: int, window=None, backend: str = JoinBackend.REF):
    """Fused compatibility join + pair extraction (the engine's hot path).

    Returns ``(a_idx, b_idx, pair_valid, n_dropped)`` per slot — the
    contract of ``extract_pairs`` applied to the join mask.  Under REF it
    is the plain version; under CUDA the hand-written kernel, which emits
    the pairs in the same row-major order, so both backends agree
    element for element, overflow included.
    """
    from repro_torch.kernels.compat_join import ops as cj_ops
    from repro_torch.kernels.compat_join import ref as cj_ref

    if backend == JoinBackend.REF:
        return cj_ref.compat_join_pairs(
            bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
            max_new, window)
    if backend == JoinBackend.CUDA:
        _require_cuda((bind_a, ets_a, valid_a, bind_b, ets_b, valid_b))
        return cj_ops.compat_join_pairs(
            bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
            max_new, window)
    raise ValueError(f"unknown join backend: {backend!r}")


# --------------------------------------------------------------------- #
# Free-slot allocation.
# --------------------------------------------------------------------- #
def alloc_slots(valid: torch.Tensor, need_valid: torch.Tensor,
                max_new: int):
    """Allocate up to ``max_new`` free slots (``valid == False``) per slot.

    ``valid`` is bool [S, C], ``need_valid`` the bool [S, max_new] mask of
    requested appends.  Returns ``(slot_idx, ok, n_dropped)``: int64
    [S, max_new] (slot for each request, -1 when not granted), bool
    [S, max_new], int32 [S].  The i-th requested append takes the i-th
    free slot; requests beyond the free slots drop.
    """
    free = first_true(~valid, max_new)
    req_rank = torch.cumsum(need_valid, dim=1, dtype=I32) - 1
    take = torch.gather(free, 1, req_rank.clamp(0, max_new - 1).long())
    slot_for_req = torch.where(need_valid, take, torch.full_like(take, -1))
    ok = need_valid & (slot_for_req >= 0)
    n_dropped = (need_valid & (slot_for_req < 0)).sum(dim=1, dtype=I32)
    return slot_for_req, ok, n_dropped
