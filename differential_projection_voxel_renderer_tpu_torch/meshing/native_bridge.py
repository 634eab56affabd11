"""ctypes bridge to the native C++ runtime helpers.

The port's copy of ``differential_projection_voxel_renderer_tpu/meshing/
native_bridge.py``.  Compiles ``native/src/greedy_mesh.cpp`` (the port's
copy of the source) on first use into ``build/native/`` beside the
package, a directory that is not versioned, and exposes:

- ``greedy_mesh_masks(masks) -> packed quads`` — the hot host-side mesher
- ``horizon_cull(...)`` / ``occlusion_pass(...)`` — sequential culling passes

The library is compiled into a temporary file and renamed into place, so
processes that build at once never load a half-written library.  Every
entry point has a pure-Python/numpy fallback, so the framework works
without a compiler; the native path just makes host streaming fast
(reference meshes a chunk in <1 ms on 6 cores, README.md:33).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "src", "greedy_mesh.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR,
                        f"_dpvr_native_{sys.implementation.cache_tag}.so")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _compile() -> None:
    """g++ into a temporary file in BUILD_DIR, then an atomic rename."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [
            os.environ.get("CXX", "g++"),
            "-O3",
            "-march=native",
            # no silent mul+add fusion: float outputs must be
            # bit-comparable against the numpy references
            "-ffp-contract=off",
            "-shared",
            "-fPIC",
            "-o",
            tmp,
            SRC,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build_and_load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            if (not os.path.exists(LIB_PATH)
                    or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC)):
                _compile()
            lib = ctypes.CDLL(LIB_PATH)
            lib.greedy_mesh_masks.restype = ctypes.c_int64
            lib.greedy_mesh_masks.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.mesh_chunk_full.restype = ctypes.c_int64
            lib.mesh_chunk_full.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.horizon_cull.restype = None
            lib.horizon_cull.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_int32,
                ctypes.c_float,
                ctypes.c_float,
                ctypes.c_float,
                ctypes.c_float,
                ctypes.c_void_p,
            ]
            lib.occlusion_pass.restype = None
            lib.occlusion_pass.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_float,
                ctypes.c_void_p,
            ]
            lib.perlin_table_twin.restype = None
            lib.perlin_table_twin.argtypes = [ctypes.c_uint32,
                                              ctypes.c_void_p]
            lib.perlin_grid_twin.restype = None
            lib.perlin_grid_twin.argtypes = [
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.terrain_heights.restype = None
            lib.terrain_heights.argtypes = [
                ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p,
            ]
            lib.terrain_fill.restype = None
            lib.terrain_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def _greedy_mesh_masks_native(masks: np.ndarray) -> np.ndarray:
    lib = _build_and_load()
    assert lib is not None
    masks = np.ascontiguousarray(masks, dtype=np.uint32)
    cap = 6 * 32 * 512
    while True:
        out = np.empty(cap, dtype=np.uint32)
        n = int(
            lib.greedy_mesh_masks(
                masks.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p),
                cap,
            )
        )
        if n <= cap:
            return out[:n].copy()
        cap = n  # exact size known; one retry suffices


def _available() -> bool:
    return _build_and_load() is not None


class _LazyMesher:
    """Picklable callable that resolves the native lib lazily."""

    def __call__(self, masks: np.ndarray) -> np.ndarray:
        return _greedy_mesh_masks_native(masks)


def _mesh_chunk_full_native(blocks: np.ndarray,
                            nb_planes: np.ndarray) -> np.ndarray:
    lib = _build_and_load()
    assert lib is not None
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    nb_planes = np.ascontiguousarray(nb_planes, dtype=np.uint8)
    cap = 6 * 32 * 512
    while True:
        out = np.empty(cap, dtype=np.uint32)
        n = int(
            lib.mesh_chunk_full(
                blocks.ctypes.data_as(ctypes.c_void_p),
                nb_planes.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p),
                cap,
            )
        )
        if n <= cap:
            return out[:n].copy()
        cap = n  # exact size known; one retry suffices


class _LazyChunkMesher:
    """Picklable callable that resolves the native lib lazily."""

    def __call__(self, blocks: np.ndarray,
                 nb_planes: np.ndarray) -> np.ndarray:
        return _mesh_chunk_full_native(blocks, nb_planes)


# Public handles: None if the native library is unavailable.
greedy_mesh_masks = _LazyMesher() if _available() else None
mesh_chunk_full = _LazyChunkMesher() if _available() else None


def horizon_cull_native(centers, cam, bins, base_margin, margin_dist_factor,
                        min_dist_chunks, chunk_size):
    """Returns keep mask uint8[n] or None if native lib unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    cam = np.ascontiguousarray(cam, dtype=np.float32)
    n = centers.shape[0]
    keep = np.empty(n, dtype=np.uint8)
    lib.horizon_cull(
        centers.ctypes.data_as(ctypes.c_void_p),
        n,
        cam.ctypes.data_as(ctypes.c_void_p),
        np.int32(bins),
        np.float32(base_margin),
        np.float32(margin_dist_factor),
        np.float32(min_dist_chunks),
        np.float32(chunk_size),
        keep.ctypes.data_as(ctypes.c_void_p),
    )
    return keep


def occlusion_pass_native(rects, depths, use_occ, screen_w, screen_h,
                          grid_w, grid_h, epsilon):
    """Returns keep mask uint8[n] or None if native lib unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    rects = np.ascontiguousarray(rects, dtype=np.int32)
    depths = np.ascontiguousarray(depths, dtype=np.float32)
    use_occ = np.ascontiguousarray(use_occ, dtype=np.uint8)
    n = rects.shape[0]
    keep = np.empty(n, dtype=np.uint8)
    lib.occlusion_pass(
        rects.ctypes.data_as(ctypes.c_void_p),
        depths.ctypes.data_as(ctypes.c_void_p),
        use_occ.ctypes.data_as(ctypes.c_void_p),
        n,
        np.int32(screen_w),
        np.int32(screen_h),
        np.int32(grid_w),
        np.int32(grid_h),
        np.float32(epsilon),
        keep.ctypes.data_as(ctypes.c_void_p),
    )
    return keep
