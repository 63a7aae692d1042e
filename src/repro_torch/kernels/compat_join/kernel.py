"""Bind and launch the CUDA compat-join kernels (``csrc/compat_join.cu``).

Two launch functions share the staged B tiles and the specialised join
predicate: ``compat_join_pairs_cuda`` (count / scan / emit of the
matching pairs, written straight into the contract's int64 / bool /
int32 outputs) and ``compat_mask_cuda`` (the predicate as a dense bool
mask, 16-byte stores).

``plan`` is the launch plan in plain Python (the CPU tests check it):
the instantiation (``SHAPES``), tile sizes, grids, shared memory, slot
strides and scratch size, as the int64 array the source's ``P_*`` enum
reads.  ``encode_spec`` turns ``(rel, trel)`` into the source's bit
masks, cached by content.  The library is built by
``repro_torch.kernels._build`` at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "compat_join.cu"

MAX_NV = 16            # CJ_MAX_NV in the source
MAX_NE = 16            # CJ_MAX_NE
MAX_SLOTS = 65535      # grid.z
MAX_GRID_Y = 65535     # B tiles (grid.y)
WIN = 512              # CJ_WIN: mask window, 32 lanes x 16 bytes
ROWS_PER_WARP = 4      # CJ_R: A rows a warp holds (specialised shapes)
A_ROWS = (1024, 512, 256)      # A rows per block, most first
A_TILE_BYTES_MAX = 32_768      # staged A rows beyond this take fewer rows
TILE_COLS = (1024, 512)    # B tile widths, widest first
TILE_BYTES_MAX = 65_536    # a staged B tile beyond this takes the narrower
SMEM_LIMIT = 232_448   # dynamic shared memory a block may have on an H100
# the emit's cursor plus one cell's matches (at most a tile's columns)
# must stay an int
MAX_NEW_LIMIT = 2**31 - TILE_COLS[0]
SPEC_WORDS = 35        # CJ_SPEC_WORDS
PAIRS, MASK = 0, 1     # the source's KIND_* enum

# The specialised (NVA, NVB, NEA, NEB), in the order of the source's
# CJ_SHAPES; any other shape takes instantiation len(SHAPES) (runtime dims,
# one A row per warp).  Chain level joins (k, 2, k-1, 1) for k = 2..4; the
# paper example's L0 joins (5, 2, 5, 1) and (4, 3, 3, 2); the serving
# two-chain tenants' L0 joins (3, 3, 2, 2).
SHAPES = ((2, 2, 1, 1), (3, 2, 2, 1), (4, 2, 3, 1), (5, 2, 5, 1),
          (3, 3, 2, 2), (4, 3, 3, 2))
RUNTIME_DIMS = len(SHAPES)

PLAN_FIELDS = (
    "kind", "slots", "ca", "cb", "nva", "nvb", "nea", "neb", "sa_bind",
    "sa_ets", "sa_valid", "sb_bind", "sb_ets", "sb_valid", "window",
    "max_new", "shape", "r", "tb", "at", "nt", "nrt", "smem",
    "scratch")        # the source's P_* enum, in its order


@dataclass(frozen=True)
class Plan:
    """Fields in ``PLAN_FIELDS`` order; ``c_args`` holds them as the
    int64 array the launch takes (built once per shape)."""
    kind: int          # PAIRS or MASK
    slots: int
    ca: int
    cb: int
    nva: int
    nvb: int
    nea: int
    neb: int
    sa_bind: int       # slot strides in elements, 0 = shared across slots
    sa_ets: int
    sa_valid: int
    sb_bind: int
    sb_ets: int
    sb_valid: int
    window: int        # 1 = the window predicate is on
    max_new: int       # 0 for the mask
    shape: int         # index into SHAPES, or RUNTIME_DIMS
    r: int             # A rows per warp of that instantiation
    tb: int            # B columns per tile (a multiple of WIN)
    at: int            # A rows per block
    nt: int            # B tiles: grid.y
    nrt: int           # A tiles: grid.x (grid.z is the slots)
    smem: int          # dynamic shared memory per block, bytes
    scratch: int       # int32 scratch (pairs: counts, offsets, block sums)
    c_args: object = field(compare=False, repr=False)


def tile_bytes(nvb: int, neb: int, tb: int) -> int:
    """A staged B tile: bind [nvb][tb], ets [neb][tb], min, max and the
    column index [tb], int32 (the source's tile_bytes)."""
    return 4 * (nvb + neb + 3) * tb


def atile_bytes(nva: int, nea: int, at: int) -> int:
    """The block's staged A rows: bindings and timestamps [nva + nea][at],
    int32 (the source's atile_bytes)."""
    return 4 * (nva + nea) * at


def smem_bytes(kind: int, nva: int, nvb: int, nea: int, neb: int, tb: int,
               at: int) -> int:
    """Dynamic shared memory of a block (the source's smem_bytes).  Pairs:
    the compacted A row list, the staged A rows and B tile.  Mask: the
    staged B tile, the block's A rows and their validity bytes, and the
    bounds of the tile's windows in the compacted tile."""
    tile = tile_bytes(nvb, neb, tb)
    rows = atile_bytes(nva, nea, at)
    if kind == PAIRS:
        return 4 * at + rows + tile
    return tile + rows + at + 4 * (tb // WIN + 1)


@functools.lru_cache(maxsize=1024)
def plan(kind: int, n_slots: int, ca: int, cb: int, nva: int, nvb: int,
         nea: int, neb: int, stacked: tuple, window: bool,
         max_new: int = 0) -> Plan:
    """The launch of one join over ``n_slots`` slots of A [ca] x B [cb]
    with ``(nva, nvb, nea, neb)`` vertex / edge slots.  ``stacked`` is six
    flags (bind_a, ets_a, valid_a, bind_b, ets_b, valid_b): True where the
    operand has a slot axis, False where it is shared (stride 0).

    B tiles are TILE_COLS[0] columns unless the staged tile would pass
    TILE_BYTES_MAX; a block takes the most A_ROWS A rows whose staged
    bindings and timestamps fit A_TILE_BYTES_MAX.  Raises ValueError on
    what the kernels do not take."""
    dims = (nva, nvb, nea, neb)
    if min(dims) < 1 or max(nva, nvb) > MAX_NV or max(nea, neb) > MAX_NE:
        raise ValueError(f"plan {dims} exceeds the kernel's spec maxima "
                         f"(NV <= {MAX_NV}, NE <= {MAX_NE})")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"n_slots {n_slots} out of range")
    if not (0 < ca < 2**31 and 0 < cb < 2**31):
        raise ValueError(f"tables of {ca} x {cb} rows: need 1 .. 2^31 - 1")
    if not 0 <= max_new <= MAX_NEW_LIMIT:
        raise ValueError(f"max_new {max_new} out of range (0 .. "
                         f"{MAX_NEW_LIMIT})")
    if kind == PAIRS and ca * cb - max_new >= 2**31:
        raise ValueError(f"{ca} x {cb} pairs, less max_new {max_new}, "
                         "overflow the int32 n_dropped")
    shape = SHAPES.index(dims) if dims in SHAPES else RUNTIME_DIMS
    r = ROWS_PER_WARP if shape < RUNTIME_DIMS else 1
    tb = next((t for t in TILE_COLS
               if tile_bytes(nvb, neb, t) <= TILE_BYTES_MAX), TILE_COLS[-1])
    at = next((n for n in A_ROWS
               if atile_bytes(nva, nea, n) <= A_TILE_BYTES_MAX), A_ROWS[-1])
    nt, nrt = -(-cb // tb), -(-ca // at)
    if nt > MAX_GRID_Y:
        raise ValueError(f"CB {cb} exceeds the grid ({MAX_GRID_Y * tb})")
    smem = smem_bytes(kind, nva, nvb, nea, neb, tb, at)
    assert smem <= SMEM_LIMIT
    scratch = (2 * n_slots * ca * nt + n_slots * nrt * nt) \
        if kind == PAIRS else 0
    per_slot = (ca * nva, ca * nea, ca, cb * nvb, cb * neb, cb)
    strides = tuple(n if s else 0 for n, s in zip(per_slot, stacked))
    vals = (kind, n_slots, ca, cb, nva, nvb, nea, neb, *strides,
            int(window), max_new if kind == PAIRS else 0, shape, r, tb, at,
            nt, nrt, smem, scratch)
    return Plan(*vals, (ctypes.c_longlong * len(vals))(*vals))


@dataclass(frozen=True)
class Spec:
    """``(rel, trel)`` as the source's CJSpec: ``words`` holds eq[8],
    ne[8], lt[8], gt[8] (bit ``i * nvb + j`` / ``i * neb + j``), lcol,
    gcol (bit j: trel column j has an lt / gt bit), qcol (bit j: rel
    column j has an eq bit); ``c_words`` the same as a ctypes array."""
    nva: int
    nvb: int
    nea: int
    neb: int
    words: tuple
    c_words: object = field(compare=False, repr=False)


@functools.lru_cache(maxsize=1024)
def _spec_from_bytes(rel_bytes, rel_shape, trel_bytes, trel_shape) -> Spec:
    rel = np.frombuffer(rel_bytes, dtype=np.bool_).reshape(rel_shape)
    trel = np.frombuffer(trel_bytes, dtype=np.int8).reshape(trel_shape)
    nva, nvb = rel_shape
    nea, neb = trel_shape
    words = [0] * SPEC_WORDS

    def put(block: int, k: int) -> None:
        words[8 * block + k // 32] |= 1 << (k % 32)

    for i in range(nva):
        for j in range(nvb):
            put(0 if rel[i, j] else 1, i * nvb + j)
            if rel[i, j]:
                words[34] |= 1 << j
    for i in range(nea):
        for j in range(neb):
            if trel[i, j] == -1:
                put(2, i * neb + j)
                words[32] |= 1 << j
            elif trel[i, j] == 1:
                put(3, i * neb + j)
                words[33] |= 1 << j
    return Spec(nva, nvb, nea, neb, tuple(words),
                (ctypes.c_uint32 * SPEC_WORDS)(*words))


def encode_spec(rel, trel) -> Spec:
    """The encoded spec of bool ``rel`` [NVA, NVB] and int8 ``trel``
    [NEA, NEB], cached by content (the same arrays every tick)."""
    rel = np.ascontiguousarray(np.asarray(rel, dtype=np.bool_))
    trel = np.ascontiguousarray(np.asarray(trel, dtype=np.int8))
    if rel.ndim != 2 or trel.ndim != 2:
        raise ValueError(f"spec shapes {rel.shape}/{trel.shape}: need 2-D")
    if max(rel.shape) > MAX_NV or max(trel.shape) > MAX_NE:
        raise ValueError(f"spec {rel.shape}/{trel.shape} exceeds the "
                         f"kernel's spec maxima (NV <= {MAX_NV}, NE <= "
                         f"{MAX_NE})")
    return _spec_from_bytes(rel.tobytes(), rel.shape, trel.tobytes(),
                            trel.shape)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 7 + [ctypes.POINTER(ctypes.c_longlong), i,
                      ctypes.POINTER(ctypes.c_uint32)]
    lib.compat_join_pairs_launch.argtypes = head + [p] * 5 + [p]
    lib.compat_join_pairs_launch.restype = ctypes.c_int
    lib.compat_mask_launch.argtypes = head + [p, p]
    lib.compat_mask_launch.restype = ctypes.c_int


_OPERANDS = (("bind_a", 3, torch.int32), ("ets_a", 3, torch.int32),
             ("valid_a", 2, torch.bool), ("bind_b", 3, torch.int32),
             ("ets_b", 3, torch.int32), ("valid_b", 2, torch.bool))


def _launch_args(kind, tables, rel, trel, window, n_slots: int,
                 max_new: int = 0):
    """Check the join's operands; returns ``(plan, spec, head)``, where
    ``head`` is the launch's leading arguments (the six table pointers
    and the window's) and the tensors it points into (contiguous copies
    included) that must outlive the launch."""
    tabs = []
    for (name, nd, dtype), x in zip(_OPERANDS, tables):
        if x.dtype != dtype or not x.is_cuda or x.dim() not in (nd, nd - 1):
            raise ValueError(f"{name}: expected a {dtype} CUDA tensor of "
                             f"{nd} or {nd - 1} dims, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if x.dim() == nd and x.shape[0] != n_slots:
            raise ValueError(f"{name} has {x.shape[0]} slots, the join "
                             f"{n_slots}")
        tabs.append(x if x.is_contiguous() else x.contiguous())
    ba, ea, va, bb, eb, vb = tabs
    ca, nva = ba.shape[-2:]
    cb, nvb = bb.shape[-2:]
    nea, neb = ea.shape[-1], eb.shape[-1]
    if (ea.shape[-2], va.shape[-1], eb.shape[-2], vb.shape[-1]) \
            != (ca, ca, cb, cb):
        raise ValueError("table row counts disagree: "
                         f"A {ca}/{ea.shape[-2]}/{va.shape[-1]}, "
                         f"B {cb}/{eb.shape[-2]}/{vb.shape[-1]}")
    if ca == 0 or cb == 0:
        raise ValueError("the join needs non-empty tables")
    spec = encode_spec(rel, trel)
    if (spec.nva, spec.nvb, spec.nea, spec.neb) != (nva, nvb, nea, neb):
        raise ValueError(f"spec shapes ({spec.nva},{spec.nvb})/({spec.nea},"
                         f"{spec.neb}) do not match tables ({nva},{nvb})/"
                         f"({nea},{neb})")
    if window is not None:
        if window.dtype != torch.int32 or window.shape != (n_slots,) \
                or window.device != ba.device:
            raise ValueError(f"window: expected int32 [{n_slots}] on "
                             f"{ba.device}, got {window.dtype} "
                             f"{tuple(window.shape)} on {window.device}")
        if not window.is_contiguous():
            window = window.contiguous()
    stacked = tuple(t.dim() == nd for (_, nd, _), t in zip(_OPERANDS, tabs))
    p = plan(kind, n_slots, ca, cb, nva, nvb, nea, neb, stacked,
             window is not None, max_new)
    head = (*(t.data_ptr() for t in tabs),
            None if window is None else window.data_ptr(),
            p.c_args, len(PLAN_FIELDS), spec.c_words)
    return p, head, (tabs, window)


def pairs_outputs(n_slots: int, max_new: int, device):
    """The pair launch's outputs on ``device`` (any device, the meta
    device included): ``(ab, small, (a_idx, b_idx, pair_valid,
    n_dropped))``.  The kernels write through two buffers: ``ab``, int64
    [2, S, max_new] (``a_idx`` and ``b_idx``), and ``small``, bytes
    holding ``n_dropped`` (int32 [S]) then ``pair_valid`` (bool
    [S, max_new])."""
    ab = torch.empty((2, n_slots, max_new), dtype=torch.int64,
                     device=device)
    small = torch.empty(4 * n_slots + n_slots * max_new, dtype=torch.uint8,
                        device=device)
    a_idx, b_idx = ab.unbind(0)
    n_dropped = small[:4 * n_slots].view(torch.int32)
    pair_valid = small[4 * n_slots:].view(torch.bool).view(n_slots, max_new)
    return ab, small, (a_idx, b_idx, pair_valid, n_dropped)


def mask_output(n_slots: int, ca: int, cb: int, device):
    """The mask launch's output on ``device``: bool [S, CA, CB]."""
    return torch.empty((n_slots, ca, cb), dtype=torch.bool, device=device)


def compat_join_pairs_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                           rel, trel, max_new: int, window, n_slots: int):
    """Launch the pair kernels: returns ``(a_idx, b_idx, pair_valid,
    n_dropped)`` as int64 [S, max_new] ×2 (0 past the kept pairs), bool
    [S, max_new] and int32 [S], all written by the kernels.  ``window``
    is None or an int32 CUDA tensor [S].  Three allocations (the int64
    pairs, the bool and int32 outputs, the int32 scratch) and one call
    into the library, which launches count, scan and emit.  Raises on
    what the kernel does not take or a launch error."""
    p, head, _keep = _launch_args(
        PAIRS, (bind_a, ets_a, valid_a, bind_b, ets_b, valid_b), rel, trel,
        window, n_slots, max_new)
    dev = bind_a.device
    ab, small, outs = pairs_outputs(n_slots, max_new, dev)
    scratch = torch.empty(p.scratch, dtype=torch.int32, device=dev)
    ptr = ab.data_ptr()
    err = _build.load(SOURCE, _bind).compat_join_pairs_launch(
        *head, ptr, ptr + 8 * n_slots * max_new,
        small.data_ptr() + 4 * n_slots, small.data_ptr(), scratch.data_ptr(),
        _build.stream_of(ab))
    if err != 0:
        raise RuntimeError(f"compat_join_pairs launch failed: CUDA error "
                           f"{err}")
    return outs


def compat_mask_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel,
                     trel, window, n_slots: int):
    """Launch the mask kernel: returns the join mask as bool [S, CA, CB]
    (every byte written by the kernel).  ``window`` is None or an int32
    CUDA tensor [S].  Raises on what the kernel does not take or a launch
    error."""
    p, head, _keep = _launch_args(
        MASK, (bind_a, ets_a, valid_a, bind_b, ets_b, valid_b), rel, trel,
        window, n_slots)
    out = mask_output(n_slots, p.ca, p.cb, bind_a.device)
    err = _build.load(SOURCE, _bind).compat_mask_launch(
        *head, out.data_ptr(), _build.stream_of(out))
    if err != 0:
        raise RuntimeError(f"compat_mask launch failed: CUDA error {err}")
    return out
