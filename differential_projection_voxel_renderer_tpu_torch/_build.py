"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc``, one process per source, all started
together, and link into one shared library with a plain C interface,
``build/kernels/libdpvr_kernels.so`` beside the package (the ``build/``
directory is not versioned).  The library is built at first use and
rebuilt when a source or header is newer; it is loaded with ``ctypes``.
Nothing here runs when the package is imported, so machines without
``nvcc`` (the CPU test runs) import every module.

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
SOURCES = ("geometry.cu", "raster.cu", "raster_packed.cu", "micro.cu")
HEADERS = ("stage_a.cuh", "tile_raster.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libdpvr_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (quads, quad_world[3, gq], view_proj[16], cam_pos[3], n_quads, skip,
    #  gq, width, height, flags, valid, bbx, bby, depth_near, subpixel,
    #  counts[2], ndc[4, gq] (span mode; else null), stream)
    "dpvr_project_cull": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P),
    # (records[24, cap], cap, starts, counts, octet_zmin, tiles_y,
    #  tiles_x, height, width, color, depth, init_color, init_depth (null
    #  for none), y0_px, then the next stream's stage A -- null pointers
    #  and gq2 0 for K2 -- quads2, quad_world2[3, gq2], view_proj2[16],
    #  cam_pos2[3], n_quads2, gq2, backface, valid, bbx, bby, depth_near,
    #  subpixel, counts[2], and the stream)
    "dpvr_rasterize_tiles": (_P, _I, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P),
    # (records[24, cap], cap, starts[T * 5], counts[T * 5], item_bby[cap],
    #  item_bbx[cap], octet_zmin, tiles_y, tiles_x, height, width, color,
    #  depth, stream)
    "dpvr_rasterize_packed": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P, _P, _P),
    # resident blocks an SM holds of the K2/K3 and the K4 kernel, and K4's
    # dynamic shared memory a block
    "dpvr_rasterize_tiles_blocks_per_sm": (),
    "dpvr_rasterize_packed_blocks_per_sm": (),
    "dpvr_rasterize_packed_smem_bytes": (),
    # M1: (color, depth, x, order, starts, counts, meta_rows, meta_zmin,
    #  recs, bidx, extra0..4, params (host int[16]), stream)
    "dpvr_fill_tiles": (_P,) * 15 + (_P, _P),
    # M2: (in0..7, out0..7, x, params (host int[23]), stream)
    "dpvr_blocked_copy": (_P,) * 16 + (_P, _P, _P),
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
               for s in SOURCES + HEADERS)


def _run_all(cmds) -> list[subprocess.CompletedProcess]:
    """Run the commands at once; raise with their output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    done = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        done.append(subprocess.CompletedProcess(cmd, p.returncode, out))
    for d in done:
        if d.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(d.args) + "\n"
                               + d.stdout)
    return done


def build(force: bool = False, verbose: bool = False) -> tuple[float, str]:
    """Compile the kernels if missing or stale; returns the seconds spent
    (0.0 when the library was current) and, with ``verbose``, ptxas's
    report of each kernel's registers, spills and shared memory (also
    printed; else "")."""
    if not force and not _stale():
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, s + ".o") for s in SOURCES]
        compiled = _run_all([
            [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
             "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)])
        tmp = os.path.join(tmp_dir, "lib.so")
        _run_all([[nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-shared", "-o", tmp, *objs]])
        log = "".join(c.stdout for c in compiled) if verbose else ""
        if verbose:
            print(log)
        os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, log


def _is_float_fma(line: str) -> bool:
    op = line.split()[0] if line.strip() else ""
    return op.startswith("fma.") or (op.startswith("mad.") and ".f" in op)


def ptx_fma_counts() -> dict[str, int]:
    """Compile each source to PTX with the build's flags and count its
    floating-point multiply-add instructions (the rounding contract wants
    none)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        outs = [os.path.join(tmp_dir, s + ".ptx") for s in SOURCES]
        _run_all([[nvcc(), *NVCC_FLAGS, "-ptx", "-o", o,
                   os.path.join(CSRC, s)] for s, o in zip(SOURCES, outs)])
        counts = {}
        for s, o in zip(SOURCES, outs):
            with open(o) as f:
                counts[s] = sum(_is_float_fma(line) for line in f)
    return counts


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed); once loaded it
    is returned without taking the lock."""
    global _LIB
    so = _LIB
    if so is not None:
        return so
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


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel entry (mangled name) in a ptxas -v report: registers,
    spill store and load bytes, static shared memory bytes."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = dict(registers=0, spill_stores=0, spill_loads=0,
                             smem=0)
        elif name and "spill stores" in line:
            w = line.replace(",", " ").split()
            out[name]["spill_stores"] = int(w[w.index("spill") - 2])
            out[name]["spill_loads"] = int(w[w.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            w = line.replace(",", " ").split()
            out[name]["registers"] = int(w[w.index("registers") - 1])
            if "smem" in w:
                out[name]["smem"] = int(w[w.index("smem") - 2])
    return out


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
