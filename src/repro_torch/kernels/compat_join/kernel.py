"""Build, bind and launch the CUDA compat-join kernel (``csrc/compat_join.cu``).

The source has a plain ``extern "C"`` launch function and includes no
PyTorch headers, so ``nvcc`` builds it in seconds into a shared library
that ``ctypes`` loads.  The build happens at first use (never at import:
the CPU tests import this module), into ``build/`` beside this file,
keyed by a hash of the source, so a changed source rebuilds and an
unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).parent / "csrc" / "compat_join.cu"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_NV = 16          # CJ_MAX_NV in the source
MAX_NE = 16          # CJ_MAX_NE
MAX_SLOTS = 65535    # grid.y

_lock = threading.Lock()
_lib = None
build_log = ""       # nvcc's output (-Xptxas -v) of the build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcompat_join_{digest[:16]}.so"


def build() -> Path:
    """Compile the source if this checkout has no library for it yet;
    returns the library's path.  Raises on a failed build."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.compat_join_pairs_launch
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn.argtypes = ([p] * 7 + [ll] * 6 + [i] * 9 + [p] * 2
                           + [p] * 5 + [p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def compat_join_pairs_cuda(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                           rel, trel, max_new: int, window, n_slots: int):
    """Launch the kernel: returns ``(a_raw, b_raw, n_total)`` as int32
    [S, max_new] ×2 (-1 fill) and int32 [S].  ``window`` is None or an
    int32 CUDA tensor [S].  Checks device, type and shape, and raises on
    what the kernel does not take or a launch error."""
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
        raise ValueError("compat_join_pairs_cuda needs non-empty tables")
    if ca * cb >= 2**31:
        raise ValueError(f"{ca} x {cb} pairs overflow the int32 counts")
    dev = ba.device
    a_raw = torch.full((n_slots, max_new), -1, dtype=torch.int32, device=dev)
    b_raw = torch.full((n_slots, max_new), -1, dtype=torch.int32, device=dev)
    n_total = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    counts = torch.empty((n_slots, ca), dtype=torch.int32, device=dev)
    offsets = torch.empty((n_slots, ca), dtype=torch.int32, device=dev)
    if window is not None:
        window = window.to(device=dev, dtype=torch.int32).contiguous()
        if window.shape != (n_slots,):
            raise ValueError(f"window: expected [{n_slots}], got "
                             f"{tuple(window.shape)}")
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.compat_join_pairs_launch(
        ba.data_ptr(), ea.data_ptr(), va.data_ptr(),
        bb.data_ptr(), eb.data_ptr(), vb.data_ptr(),
        None if window is None else window.data_ptr(),
        sab, sae, sav, sbb, sbe, sbv,
        n_slots, ca, cb, nva, nvb, nea, neb,
        int(window is not None), int(max_new),
        rel.ctypes.data, trel.ctypes.data,
        counts.data_ptr(), offsets.data_ptr(), a_raw.data_ptr(),
        b_raw.data_ptr(), n_total.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compat_join_pairs launch failed: CUDA error "
                           f"{err}")
    return a_raw, b_raw, n_total
