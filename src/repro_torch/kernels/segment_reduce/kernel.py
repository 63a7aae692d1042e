"""Bind and launch the CUDA segment-sum kernel (``csrc/segment_reduce.cu``).

The library is built by ``repro_torch.kernels._build`` at first use,
never at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "segment_reduce.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.segment_sum_launch.argtypes = [p] * 4 + [ll, i, i, i, p]
    lib.segment_sum_launch.restype = ctypes.c_int


def segment_sum_cuda(dst, msg, n_nodes: int):
    """Launch the kernel: dst int32 CUDA [E], msg float32/bfloat16 CUDA
    [E, D] -> [n_nodes, D] in msg's dtype, summed in float32.  Raises on
    what the kernel does not take or a launch error."""
    if dst.dtype != torch.int32 or dst.dim() != 1 or not dst.is_cuda:
        raise ValueError(f"dst: expected an int32 CUDA [E], got {dst.dtype} "
                         f"{tuple(dst.shape)} on {dst.device}")
    if msg.dtype not in DTYPES or msg.dim() != 2 or not msg.is_cuda:
        raise ValueError(f"msg: expected a float32/bfloat16 CUDA [E, D], got "
                         f"{msg.dtype} {tuple(msg.shape)} on {msg.device}")
    e, d = msg.shape
    if dst.shape[0] != e:
        raise ValueError(f"dst [{dst.shape[0]}] and msg [{e}, {d}] differ")
    if not 1 <= n_nodes < 2**31 or d >= 2**31:
        raise ValueError(f"n_nodes {n_nodes} / D {d} out of the kernel's "
                         "int32 range")
    dst, msg = dst.contiguous(), msg.contiguous()
    acc = torch.zeros((n_nodes, d), dtype=torch.float32, device=msg.device)
    out = acc if msg.dtype == torch.float32 else torch.empty(
        (n_nodes, d), dtype=msg.dtype, device=msg.device)
    lib = _build.load(SOURCE, _bind)
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    err = lib.segment_sum_launch(
        dst.data_ptr(), msg.data_ptr(), acc.data_ptr(),
        None if out is acc else out.data_ptr(), e, d, n_nodes,
        DTYPES[msg.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    return out
