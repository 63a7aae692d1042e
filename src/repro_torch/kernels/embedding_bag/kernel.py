"""Bind and launch the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

The library is built by ``repro_torch.kernels._build`` at first use,
never at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "embedding_bag.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.embedding_bag_launch.argtypes = [p] * 5 + [ll, i, ll, i, i, p]
    lib.embedding_bag_launch.restype = ctypes.c_int


def embedding_bag_cuda(ids, bags, table, n_bags: int):
    """Launch the kernel: ids, bags int32 CUDA [T] (bags sorted
    ascending, not checked), table float32/bfloat16 CUDA [V, D] ->
    [n_bags, D] in the table's dtype.  Raises on what the kernel does not
    take or a launch error."""
    for name, x in (("ids", ids), ("bags", bags)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_cuda:
            raise ValueError(f"{name}: expected an int32 CUDA [T], got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if table.dtype not in DTYPES or table.dim() != 2 or not table.is_cuda:
        raise ValueError(f"table: expected a float32/bfloat16 CUDA [V, D], "
                         f"got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    t = ids.shape[0]
    if bags.shape[0] != t:
        raise ValueError(f"ids [{t}] and bags [{bags.shape[0]}] differ")
    if t >= 2**31 or not 1 <= n_bags < 2**31 - 1:
        raise ValueError(f"{t} ids / {n_bags} bags out of the kernel's "
                         "int32 range")
    ids, bags, table = ids.contiguous(), bags.contiguous(), table.contiguous()
    v, d = table.shape
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    start = torch.empty((n_bags + 1,), dtype=torch.int32, device=table.device)
    lib = _build.load(SOURCE, _bind)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.embedding_bag_launch(
        ids.data_ptr(), bags.data_ptr(), table.data_ptr(), start.data_ptr(),
        out.data_ptr(), t, n_bags, v, d, DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    return out
