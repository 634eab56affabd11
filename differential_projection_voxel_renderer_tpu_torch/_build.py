"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, ``build/kernels/libdpvr_kernels.so`` beside the package (the
``build/`` directory is not versioned).  The library is built at first use
and rebuilt when a source is newer; it is loaded with ``ctypes``.  Nothing
here runs when the package is imported, so machines without ``nvcc`` (the
CPU test runs) import every module.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` (no multiply-add contraction:
the frame must round like the reference's separate multiplies and adds),
IEEE division and square root, no flush-to-zero, never fast math.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("geometry.cu", "raster.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libdpvr_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (quads, quad_world[3, gq], view_proj[16], cam_pos[3], n_quads, skip,
    #  gq, width, height, backface, valid, bbx, bby, depth_near, subpixel,
    #  stream)
    "dpvr_project_cull": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P),
    # (records[24, cap], cap, starts, counts, octet_rows, octet_zmin,
    #  tiles_y, tiles_x, height, width, color, depth, stream)
    "dpvr_rasterize_tiles": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P),
}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, s)) > built
               for s in SOURCES)


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile the kernels if missing or stale; returns the seconds spent
    (0.0 when the library was current)."""
    if not force and not _stale():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            so = ctypes.CDLL(LIB_PATH)
            for name, args in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _LIB = so
        return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
