"""Build and load the port's CUDA kernels (``kernels/*/csrc/*.cu``).

Every source has a plain ``extern "C"`` launch function and includes no
PyTorch headers, so ``nvcc`` builds it in seconds into a shared library
that ``ctypes`` loads.  The build happens at first use (never at import:
the CPU tests import every kernel module), into ``kernels/build/``,
keyed by a hash of the source and the flags, so a changed source
rebuilds and an unchanged one is reused within a checkout.  ``build``
takes several sources and runs one ``nvcc`` for each, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}   # source -> its loaded library
build_logs: dict[str, str] = {}   # source name -> nvcc's output (-Xptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source that has no library in this checkout yet,
    one ``nvcc`` per source, all started together; returns the
    libraries' paths.  Raises if any build fails."""
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[src.name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(source: Path, bind) -> ctypes.CDLL:
    """The loaded library of ``source`` (built if needed); ``bind(lib)``
    declares its functions' ``argtypes``/``restype`` once.  After the
    first call this is one dict lookup: launches call it every time."""
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build(source)[0]))
                bind(lib)
                _libs[source] = lib
    return lib
