"""Bind and launch the CUDA segment-sum kernels (``csrc/segment_reduce.cu``).

``plan`` is the launch plan in plain Python (the CPU tests check it): node
tile rows, column chunks, load width, piece size, grid bounds and the
workspace layout.  ``segment_sum_cuda`` allocates the output and one
workspace and makes one call into the library, which launches the
bucket, scan and accumulate kernels on the current stream.  The library
is built by ``repro_torch.kernels._build`` at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).parent / "csrc" / "segment_reduce.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256            # SR_THREADS in the source
TN = 128                 # node rows per tile: a power of two <= 256 (a byte)
DC_MAX = 128             # columns per chunk: a 64 KB accumulator at most
CH = 4096                # bucket entries per piece (one block's work)
SMEM_LIMIT = 232_448     # dynamic shared memory a block may have on an H100
PRIV_TILES = 24_576      # most tiles whose counters a block keeps on chip
GRID_EDGES = 132 * 16    # most blocks of the edge walks (grid-stride beyond)
GRID_PRIV = 132          # blocks (of 1024 threads) of the walks counting on chip
VEC_BYTES = (16, 8, 4, 2)
ALIGN = 256              # workspace arrays start on this many bytes


PLAN_FIELDS = (
    "e", "n", "d", "dtype", "vec", "tn", "dc", "n_cc", "lr", "ch", "tiles",
    "p_max", "m_max", "smem", "priv", "grid_edges", "ws_cnt", "ws_off",
    "ws_poff",
    "ws_moff", "ws_ptile", "ws_done", "ws_meta", "ws_order", "ws_lrow",
    "ws_scratch", "ws_bytes")      # the source's P_* enum, in its order


@dataclass(frozen=True)
class Plan:
    """Fields in ``PLAN_FIELDS`` order; ``c_args`` holds them as the
    int64 array the launch takes (built once per shape)."""
    e: int               # edges
    n: int               # nodes
    d: int               # message columns
    dtype: int           # 0 = float32, 1 = bfloat16
    vec: int             # bytes per message load (16/8/4/2)
    tn: int              # node rows per tile
    dc: int              # columns per chunk
    n_cc: int            # column chunks
    lr: int              # lanes per message row (a power of two <= 32)
    ch: int              # edges per piece
    tiles: int
    p_max: int           # most pieces E and N allow: the accumulate grid
    m_max: int           # most tiles with more than ch edges (hub tiles)
    smem: int            # dynamic shared memory of the accumulate, bytes
    priv: int            # 1: the edge walks count in shared memory
    grid_edges: int      # blocks of the edge walks
    ws_cnt: int          # workspace byte offsets, then its size
    ws_off: int
    ws_poff: int
    ws_moff: int
    ws_ptile: int
    ws_done: int
    ws_meta: int
    ws_order: int
    ws_lrow: int
    ws_scratch: int
    ws_bytes: int
    c_args: object = field(compare=False, repr=False)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


@functools.lru_cache(maxsize=256)
def plan(e: int, n: int, d: int, elem: int, align: int) -> Plan:
    """The launch for ``e`` messages of ``d`` ``elem``-byte values (4 =
    float32, 2 = bfloat16) into ``n`` nodes, the messages' base pointer a
    multiple of ``align`` bytes (pass ``data_ptr() % 16``; 0 means
    16-aligned).

    Loads are the widest of 16/8/4/2 bytes that divide the base pointer
    and the row bytes (VE values each).  A column chunk is at most
    min(32 VE, 128) columns, so the lanes of one row (``lr``, rounded up
    to a power of two) cover it in one pass and its TN x DC float32
    accumulator takes at most 64 KB (beside the piece's CH sorted edge
    ids); a wider row is cut into ``n_cc`` chunks.  At D = 1 a lane is a
    row, 32 edges to a warp at a time.  With at most PRIV_TILES tiles the
    edge walks keep their tile counters in shared memory, one chunk of
    the edges per block, with blocks enough that a block's chunk holds
    ~16 edges per tile (at most GRID_PRIV)."""
    if d < 1 or n < 1 or e < 0:
        raise ValueError(f"segment_sum plan: E {e}, N {n}, D {d}")
    vec = next(v for v in VEC_BYTES
               if v >= elem and (d * elem) % v == 0 and align % v == 0)
    ve = vec // elem
    dc = min(d, 32 * ve, DC_MAX)
    n_cc = -(-d // dc)
    lr = _pow2_at_least(-(-dc // ve))
    tiles = -(-n // TN)
    p_max = tiles + e // CH
    m_max = min(tiles, e // (CH + 1))
    smem = (TN * dc + CH) * 4
    priv = tiles <= PRIV_TILES
    grid_edges = max(1, min(e // (16 * tiles), GRID_PRIV)) if priv else \
        max(1, min(-(-e // THREADS), GRID_EDGES))
    sizes = {"ws_cnt": 4 * tiles, "ws_off": 4 * (tiles + 1),
             "ws_poff": 4 * (tiles + 1), "ws_moff": 4 * tiles,
             "ws_ptile": 4 * p_max, "ws_done": 4 * m_max * n_cc,
             "ws_meta": 8, "ws_order": 4 * e, "ws_lrow": e,
             "ws_scratch": 4 * m_max * TN * d}
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += -(-size // ALIGN) * ALIGN
    vals = (e, n, d, 0 if elem == 4 else 1, vec, TN, dc, n_cc, lr, CH,
            tiles, p_max, m_max, smem, int(priv), grid_edges,
            *offsets.values(), at)
    return Plan(*vals, (ctypes.c_longlong * len(vals))(*vals))


def _bind(lib) -> None:
    p = ctypes.c_void_p
    lib.segment_sum_launch.argtypes = [p] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, p]
    lib.segment_sum_launch.restype = ctypes.c_int


def sum_output(msg, n_nodes: int):
    """The launch's output beside ``msg`` [E, D] (on any device, the
    meta device included): [n_nodes, D] in msg's dtype."""
    return msg.new_empty((n_nodes, msg.shape[1]))


def segment_sum_cuda(dst, msg, n_nodes: int):
    """Launch the kernels: dst int32 CUDA [E], msg float32/bfloat16 CUDA
    [E, D] -> [n_nodes, D] in msg's dtype, summed in float32.  Raises on
    what the kernels do not take or a launch error."""
    if dst.dtype != torch.int32 or dst.dim() != 1 or not dst.is_cuda:
        raise ValueError(f"dst: expected an int32 CUDA [E], got {dst.dtype} "
                         f"{tuple(dst.shape)} on {dst.device}")
    if msg.dtype not in DTYPES or msg.dim() != 2 or not msg.is_cuda:
        raise ValueError(f"msg: expected a float32/bfloat16 CUDA [E, D], got "
                         f"{msg.dtype} {tuple(msg.shape)} on {msg.device}")
    e, d = msg.shape
    if dst.shape[0] != e:
        raise ValueError(f"dst [{dst.shape[0]}] and msg [{e}, {d}] differ")
    if not 1 <= n_nodes < 2**31 or not 1 <= d < 2**31 or e >= 2**31:
        raise ValueError(f"E {e} / n_nodes {n_nodes} / D {d} out of the "
                         "kernel's int32 range")
    dst, msg = dst.contiguous(), msg.contiguous()
    p = plan(e, n_nodes, d, msg.element_size(), msg.data_ptr() % 16)
    out = sum_output(msg, n_nodes)
    ws = torch.empty((p.ws_bytes,), dtype=torch.uint8, device=msg.device)
    err = _build.load(SOURCE, _bind).segment_sum_launch(
        dst.data_ptr(), msg.data_ptr(), out.data_ptr(), ws.data_ptr(),
        p.c_args, len(PLAN_FIELDS), _build.stream_of(msg))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    return out
