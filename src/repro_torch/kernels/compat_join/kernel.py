"""Bind and launch the CUDA compat-join kernels (``csrc/compat_join.cu``).

Two launch functions share the join predicate: ``compat_join_pairs``
(count/scan/emit of the matching pairs) and ``compat_mask`` (the
predicate as a dense bool mask).  The library is built by
``repro_torch.kernels._build`` at first use, never at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "compat_join.cu"

MAX_NV = 16          # CJ_MAX_NV in the source
MAX_NE = 16          # CJ_MAX_NE
MAX_SLOTS = 65535    # grid.y (pairs) / grid.z (mask)
MASK_CHUNK = 1024    # CJ_MASK_CHUNK: B columns per warp; grid.y <= 65535


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    head = [p] * 7 + [ll] * 6 + [i] * 7      # tables, window, strides, dims
    lib.compat_join_pairs_launch.argtypes = (head + [i] * 2 + [p] * 2
                                             + [p] * 5 + [p])
    lib.compat_join_pairs_launch.restype = ctypes.c_int
    lib.compat_mask_launch.argtypes = head + [i] + [p] * 2 + [p] + [p]
    lib.compat_mask_launch.restype = ctypes.c_int


def _operand(x: torch.Tensor, nd: int, dtype, name: str):
    """(contiguous tensor, slot stride in elements): a slot-stacked
    operand has ``nd`` dims, a shared one ``nd - 1`` and stride 0."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dim() not in (nd, nd - 1):
        raise ValueError(f"{name}: expected {nd} or {nd - 1} dims, "
                         f"got shape {tuple(x.shape)}")
    x = x.contiguous()
    stride = x[0].numel() if x.dim() == nd else 0
    return x, stride


def _prepare(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel,
             window, n_slots: int, what: str):
    """Check and flatten the join's operands for a launch: returns the
    launch's leading arguments (tables, window, strides, dims) and the
    spec arrays, which must stay alive until the launch returns."""
    ops_in = [
        _operand(bind_a, 3, torch.int32, "bind_a"),
        _operand(ets_a, 3, torch.int32, "ets_a"),
        _operand(valid_a, 2, torch.bool, "valid_a"),
        _operand(bind_b, 3, torch.int32, "bind_b"),
        _operand(ets_b, 3, torch.int32, "ets_b"),
        _operand(valid_b, 2, torch.bool, "valid_b"),
    ]
    (ba, sab), (ea, sae), (va, sav), (bb, sbb), (eb, sbe), (vb, sbv) = ops_in
    ca, nva = ba.shape[-2], ba.shape[-1]
    cb, nvb = bb.shape[-2], bb.shape[-1]
    nea, neb = ea.shape[-1], eb.shape[-1]
    rel = np.ascontiguousarray(np.asarray(rel, dtype=np.int8))
    trel = np.ascontiguousarray(np.asarray(trel, dtype=np.int8))
    if rel.shape != (nva, nvb) or trel.shape != (nea, neb):
        raise ValueError(f"spec shapes {rel.shape}/{trel.shape} do not match "
                         f"tables ({nva},{nvb})/({nea},{neb})")
    if max(nva, nvb) > MAX_NV or max(nea, neb) > MAX_NE:
        raise ValueError(f"plan exceeds the kernel's spec maxima "
                         f"(NV <= {MAX_NV}, NE <= {MAX_NE})")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"n_slots {n_slots} out of range")
    if (ea.shape[-2], va.shape[-1], eb.shape[-2], vb.shape[-1]) \
            != (ca, ca, cb, cb):
        raise ValueError("table row counts disagree: "
                         f"A {ca}/{ea.shape[-2]}/{va.shape[-1]}, "
                         f"B {cb}/{eb.shape[-2]}/{vb.shape[-1]}")
    for t, stride in ops_in:
        if stride and t.shape[0] != n_slots:
            raise ValueError(f"operand with {t.shape[0]} slots, join has "
                             f"{n_slots}")
    if ca == 0 or cb == 0:
        raise ValueError(f"{what} needs non-empty tables")
    if window is not None:
        window = window.to(device=ba.device, dtype=torch.int32).contiguous()
        if window.shape != (n_slots,):
            raise ValueError(f"window: expected [{n_slots}], got "
                             f"{tuple(window.shape)}")
    head = (ba.data_ptr(), ea.data_ptr(), va.data_ptr(),
            bb.data_ptr(), eb.data_ptr(), vb.data_ptr(),
            None if window is None else window.data_ptr(),
            sab, sae, sav, sbb, sbe, sbv,
            n_slots, ca, cb, nva, nvb, nea, neb, int(window is not None))
    # the tensors (contiguous copies included) and the spec arrays must
    # outlive the launch call
    keep = (ops_in, window, rel, trel)
    return head, rel, trel, keep


def compat_join_pairs_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                           rel, trel, max_new: int, window, n_slots: int):
    """Launch the pair kernel: returns ``(a_raw, b_raw, n_total)`` as
    int32 [S, max_new] ×2 (-1 fill) and int32 [S].  ``window`` is None or
    an int32 CUDA tensor [S].  Checks device, type and shape, and raises
    on what the kernel does not take or a launch error."""
    head, rel, trel, _keep = _prepare(
        bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel, window,
        n_slots, "compat_join_pairs_cuda")
    ca, cb = head[14], head[15]
    if ca * cb >= 2**31:
        raise ValueError(f"{ca} x {cb} pairs overflow the int32 counts")
    dev = bind_a.device
    a_raw = torch.full((n_slots, max_new), -1, dtype=torch.int32, device=dev)
    b_raw = torch.full((n_slots, max_new), -1, dtype=torch.int32, device=dev)
    n_total = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    counts = torch.empty((n_slots, ca), dtype=torch.int32, device=dev)
    offsets = torch.empty((n_slots, ca), dtype=torch.int32, device=dev)
    lib = _build.load(SOURCE, _bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.compat_join_pairs_launch(
        *head, int(max_new), rel.ctypes.data, trel.ctypes.data,
        counts.data_ptr(), offsets.data_ptr(), a_raw.data_ptr(),
        b_raw.data_ptr(), n_total.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compat_join_pairs launch failed: CUDA error "
                           f"{err}")
    return a_raw, b_raw, n_total


def compat_mask_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel,
                     trel, window, n_slots: int):
    """Launch the mask kernel: returns the join mask as bool [S, CA, CB]
    (every byte written by the kernel).  ``window`` is None or an int32
    CUDA tensor [S].  Raises on what the kernel does not take or a launch
    error."""
    head, rel, trel, _keep = _prepare(
        bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel, trel, window,
        n_slots, "compat_mask_cuda")
    ca, cb = head[14], head[15]
    if -(-cb // MASK_CHUNK) > 65535:
        raise ValueError(f"CB {cb} exceeds the mask grid "
                         f"({65535 * MASK_CHUNK})")
    dev = bind_a.device
    out = torch.empty((n_slots, ca, cb), dtype=torch.bool, device=dev)
    lib = _build.load(SOURCE, _bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.compat_mask_launch(*head, rel.ctypes.data, trel.ctypes.data,
                                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compat_mask launch failed: CUDA error {err}")
    return out
