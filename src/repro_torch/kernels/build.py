"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers).  At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` next to this file (listed in ``.gitignore``) and loaded with
``ctypes``.  The library's file name carries a hash of its source, of every
shared header and of the flags, so an edited source or header builds anew
and an unchanged one is reused.  The flags leave out ``--use_fast_math``:
the int8 wire needs IEEE division, and the attention's and the scan's
exponentials are ``expf``'s, not ``__expf``'s.  :func:`build_all` starts one
``nvcc`` per source, all at once.

Nothing here runs on import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = (
    "slab_combine", "slab_codec", "slab_segment", "drt_dist", "flash_attention", "selective_scan",
    "combine", "quantize",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register/smem report) per kernel


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one kernel into a temp file; returns ``(final path,
    temp path, process)``."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, Path(tmp), proc


def build_all(names=KERNELS) -> float:
    """Compile every kernel that is not built yet, one ``nvcc`` each, all in
    parallel; raise if any fails.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        pending = {}
        nvcc = None
        for name in names:
            if not _lib_path(name).exists():
                nvcc = nvcc or _nvcc()
                pending[name] = _start(name, nvcc)
        failed = []
        for name, (out, tmp, proc) in pending.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
