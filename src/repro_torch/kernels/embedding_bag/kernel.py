"""Bind and launch the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

``plan`` is the launch plan in plain Python (the CPU tests check it);
``embedding_bag_cuda`` is the thin per-call wrapper: checks that raise,
one allocation (the output), one launch.  The library is built by
``repro_torch.kernels._build`` at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "embedding_bag.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256               # EB_THREADS in the source
MAX_K = 8                   # EB_MAX_K: bags per lane group
WAVE_BLOCKS = 132 * 8 * 2   # two waves of 8 blocks on each of 132 SMs
VEC_BYTES = (16, 8, 4, 2)   # table load widths the kernel is built for


PLAN_FIELDS = ("t", "n_bags", "v", "d", "dtype", "vec", "gw", "lr",
               "k_bags", "blocks")     # the source's E_* enum, in its order


@dataclass(frozen=True)
class Plan:
    """Fields in ``PLAN_FIELDS`` order; ``c_args`` holds
    them as the int64 array the launch takes (built once per shape: a
    call with few arguments is most of a small batch's host time)."""
    t: int                # ids
    n_bags: int
    v: int                # table rows
    d: int                # table columns
    dtype: int            # 0 = float32, 1 = bfloat16
    vec: int              # bytes per table load (16/8/4/2)
    gw: int               # lanes per bag: 8 or 16 at D = 1, else 32
    lr: int               # lanes per table row (a power of two <= gw)
    k_bags: int           # bags per lane group, summed one after another
    blocks: int
    c_args: object = field(compare=False, repr=False)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


@functools.lru_cache(maxsize=256)
def plan(t: int, n_bags: int, v: int, d: int, elem: int,
         align: int) -> Plan:
    """The launch of ``t`` ids into ``n_bags`` bags over a [v, d] table of
    ``elem``-byte values (4 = float32, 2 = bfloat16) whose base pointer is
    a multiple of ``align`` bytes (pass ``data_ptr() % 16``; 0 means
    16-aligned).

    Loads are the widest of 16/8/4/2 bytes that divide the base pointer
    and the row bytes.  At D = 1 a bag gets 8 lanes when bags hold 16 ids
    or fewer on average and 16 beyond, so 4 or 2 bags share a warp; at
    D > 1 a bag gets the warp, and ``lr`` lanes (the loads one row needs,
    rounded up to a power of two, at most 32) cover a row while the
    warp's 32 / lr row slots take different ids.  A group sums
    ``k_bags`` bags in turn, as many as keep two waves of blocks (at most
    MAX_K), so that large batches share each block's bag search."""
    row = d * elem
    vec = next(x for x in VEC_BYTES
               if x >= elem and row % x == 0 and align % x == 0)
    ve = vec // elem
    if d == 1:
        gw, lr = (8 if t <= 16 * n_bags else 16), 1
    else:
        gw, lr = 32, min(32, _pow2_at_least(-(-d // ve)))
    groups = THREADS // gw
    k = max(1, min(MAX_K, n_bags // (groups * WAVE_BLOCKS)))
    vals = (t, n_bags, v, d, 0 if elem == 4 else 1, vec, gw, lr, k,
            -(-n_bags // (groups * k)))
    return Plan(*vals, (ctypes.c_longlong * len(vals))(*vals))


def _bind(lib) -> None:
    p = ctypes.c_void_p
    lib.embedding_bag_launch.argtypes = [p] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, p]
    lib.embedding_bag_launch.restype = ctypes.c_int


def _refuse(ids, bags, table, n_bags):
    for name, x in (("ids", ids), ("bags", bags)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_cuda:
            raise ValueError(f"{name}: expected an int32 CUDA [T], got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if table.dtype not in DTYPES or table.dim() != 2 or not table.is_cuda:
        raise ValueError(f"table: expected a float32/bfloat16 CUDA [V, D], "
                         f"got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    if bags.shape[0] != ids.shape[0]:
        raise ValueError(f"ids [{ids.shape[0]}] and bags [{bags.shape[0]}] "
                         "differ")
    raise ValueError(f"{ids.shape[0]} ids / {n_bags} bags / D "
                     f"{table.shape[1]} out of the kernel's int32 range")


def bag_output(table, n_bags: int):
    """The launch's output beside ``table`` [V, D] (on any device, the
    meta device included): [n_bags, D] in the table's dtype."""
    return table.new_empty(n_bags, table.shape[1])


def embedding_bag_cuda(ids, bags, table, n_bags: int):
    """Launch the kernel: ids, bags int32 CUDA [T] (bags sorted
    ascending, not checked), table float32/bfloat16 CUDA [V, D] ->
    [n_bags, D] in the table's dtype.  Raises on what the kernel does not
    take or a launch error.  Every check stays, folded into one test on
    the common path: at serving batches the host wrapper is most of the
    call."""
    i32 = torch.int32
    if (ids.dtype != i32 or bags.dtype != i32 or table.dtype not in DTYPES
            or ids.dim() != 1 or bags.dim() != 1 or table.dim() != 2
            or not (ids.is_cuda and bags.is_cuda and table.is_cuda)
            or bags.shape[0] != ids.shape[0] or ids.shape[0] >= 2**31
            or not 1 <= n_bags < 2**31 - 1 or not 0 < table.shape[1] < 2**31):
        _refuse(ids, bags, table, n_bags)
    if not (ids.is_contiguous() and bags.is_contiguous()
            and table.is_contiguous()):
        ids, bags, table = ids.contiguous(), bags.contiguous(), \
            table.contiguous()
    v, d = table.shape
    ptr = table.data_ptr()
    p = plan(ids.shape[0], n_bags, v, d, table.element_size(), ptr % 16)
    out = bag_output(table, n_bags)
    err = _build.load(SOURCE, _bind).embedding_bag_launch(
        ids.data_ptr(), bags.data_ptr(), ptr, out.data_ptr(), p.c_args,
        len(PLAN_FIELDS), _build.stream_of(table))
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    return out
