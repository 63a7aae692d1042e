"""Bind and launch the CUDA segment-sum kernels (``csrc/segment_reduce.cu``).

``plan`` is the launch plan in plain Python (the CPU tests check it):
column chunks, load width, radix passes, sort blocks, grid bounds and
the workspace layout.  ``segment_sum_cuda`` allocates the output and one
workspace and makes one call into the library, which launches the sort
(count, scan and place, once a pass), the node starts, the hub runs and
the node sums on the current stream, in the order the source's header
and ``ref.segment_sum_ordered`` state.  The library
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
RUN = 1024               # SR_RUN in the source: edges a run of the order
PIECE = 256              # sorted positions a node-sum lane group takes
PIECE_NARROW = 8         # ... a lane, for groups of fewer than 8 lanes
BITS = 8                 # SR_BITS in the source: key bits a radix pass
BINS = 256               # SR_BINS in the source: digits a pass
TILE = 4096              # SR_TILE in the source: edges a sort block ranks at once
DC_MAX = 128             # columns per chunk: one pass of a lane group
SUB_MAX = 16             # tiles a sort block takes, at most
SORT_WAVE = 132 * 4      # sort blocks the plan aims for: four on each SM
GRID_EDGES = 132 * 16    # most blocks of sr_starts (grid-stride beyond)
VEC_BYTES = (16, 8, 4, 2)
ALIGN = 256              # workspace arrays start on this many bytes


PLAN_FIELDS = (
    "e", "n", "d", "dtype", "vec", "dc", "n_cc", "lr", "run", "passes",
    "sub", "nb", "windows", "piece", "pieces", "grid_nodes", "grid_pieces",
    "grid_runs", "grid_starts",
    "ws_hist", "ws_key0", "ws_val0", "ws_key1", "ws_val1", "ws_start",
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
    dc: int              # columns per chunk
    n_cc: int            # column chunks
    lr: int              # lanes per message row (a power of two <= 32)
    run: int             # edges a run (RUN)
    passes: int          # radix passes: keys reach n (a dropped id's key)
    sub: int             # tiles of TILE edges a sort block takes
    nb: int              # sort blocks
    windows: int         # windows of RUN sorted positions (hub runs)
    piece: int           # sorted positions a node-sum lane group takes
    pieces: int          # pieces of ``piece`` positions (node sums)
    grid_nodes: int      # blocks of sr_empty (THREADS nodes each)
    grid_pieces: int     # blocks of sr_nodes (THREADS / lr pieces each)
    grid_runs: int       # blocks of sr_runs (THREADS / lr windows each)
    grid_starts: int     # blocks of sr_starts
    ws_hist: int         # workspace byte offsets, then its size
    ws_key0: int
    ws_val0: int
    ws_key1: int
    ws_val1: int
    ws_start: int
    ws_scratch: int
    ws_bytes: int
    c_args: object = field(compare=False, repr=False)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def workspace_sizes(e: int, n: int, d: int, passes: int, nb: int,
                    windows: int) -> dict:
    """Each workspace array's bytes: the sort's digit counts (and each
    digit's total), its two key / edge-id buffers (one pass writes what
    the next reads), the nodes' starts and two float32 scratch rows a
    window (the hub runs that start there)."""
    two = passes > 1
    return {"ws_hist": 4 * BINS * (nb + 1), "ws_key0": 4 * e,
            "ws_val0": 4 * e, "ws_key1": 4 * e * two,
            "ws_val1": 4 * e * two, "ws_start": 4 * (n + 1),
            "ws_scratch": 4 * 2 * windows * d}


@functools.lru_cache(maxsize=256)
def plan(e: int, n: int, d: int, elem: int, align: int) -> Plan:
    """The launch for ``e`` messages of ``d`` ``elem``-byte values (4 =
    float32, 2 = bfloat16) into ``n`` nodes, the messages' base pointer a
    multiple of ``align`` bytes (pass ``data_ptr() % 16``; 0 means
    16-aligned).

    Loads are the widest of 16/8/4/2 bytes that divide the base pointer
    and the row bytes (VE values each).  A column chunk is at most
    min(32 VE, 128) columns, so the lanes of one row (``lr``, rounded up
    to a power of two) cover it in one pass; a wider row is cut into
    ``n_cc`` chunks.  At D = 1 a lane is a node.  The sort takes
    ceil(bits(n) / BITS) passes (keys run to n, a dropped id's), its
    blocks ``sub`` tiles each, so that there are about SORT_WAVE of
    them; two scratch rows of D floats for each window of RUN edges
    (its hub runs).  A lane group sums the nodes whose first edge lies in
    one piece of PIECE sorted positions (PIECE_NARROW a lane for narrow
    groups, which walk each edge with fewer lanes), so that groups get
    about as many edges whatever the degrees."""
    if d < 1 or n < 1 or e < 0 or e >= 2**31 - RUN or n >= 2**31 - 1:
        raise ValueError(f"segment_sum plan: E {e}, N {n}, D {d}")
    vec = next(v for v in VEC_BYTES
               if v >= elem and (d * elem) % v == 0 and align % v == 0)
    ve = vec // elem
    dc = min(d, 32 * ve, DC_MAX)
    n_cc = -(-d // dc)
    lr = _pow2_at_least(-(-dc // ve))
    per = THREADS // lr
    passes = max(1, -(-n.bit_length() // BITS))
    sub = min(SUB_MAX, max(1, -(-e // (TILE * SORT_WAVE))))
    nb = -(-e // (TILE * sub))
    windows = -(-e // RUN)
    piece = PIECE if lr >= 8 else PIECE_NARROW * lr
    pieces = max(1, -(-e // piece))
    head = dict(e=e, n=n, d=d, dtype=0 if elem == 4 else 1, vec=vec, dc=dc,
                n_cc=n_cc, lr=lr, run=RUN, passes=passes, sub=sub, nb=nb,
                windows=windows, piece=piece, pieces=pieces,
                grid_nodes=-(-n // THREADS),
                grid_pieces=-(-pieces // per),
                grid_runs=-(-windows // per),
                grid_starts=max(1, min(-(-(e + 1) // THREADS), GRID_EDGES)))
    offsets, at = {}, 0
    for name, size in workspace_sizes(e, n, d, passes, nb,
                                      windows).items():
        offsets[name] = at
        at += -(-size // ALIGN) * ALIGN
    vals = (*head.values(), *offsets.values(), at)
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
    [E, D] -> [n_nodes, D] in msg's dtype, summed in float32 in the
    order ``ref.segment_sum_ordered`` states.  Raises on
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
    if not 1 <= n_nodes < 2**31 - 1 or not 1 <= d < 2**31 \
            or e >= 2**31 - RUN:
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
