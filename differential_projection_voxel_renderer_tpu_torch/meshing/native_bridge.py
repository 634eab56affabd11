"""ctypes bridge to the native C++ runtime helpers.

The port's copy of ``differential_projection_voxel_renderer_tpu/meshing/
native_bridge.py``.  Compiles ``native/src/greedy_mesh.cpp`` (the port's
copy of the source) on first use into ``build/native/`` beside the
package, a directory that is not versioned, and exposes:

- ``greedy_mesh_masks(masks) -> packed quads`` — the hot host-side mesher
- ``horizon_cull(...)`` / ``occlusion_pass(...)`` — sequential culling passes
- ``funnel_pass`` — the frame funnel from the chunk table to the draw list
  (``FunnelPass``), offered only where its sort keys equal numpy's
- ``pack_frame`` — a draw list's one upload written into a caller's
  buffer (``FramePacker``)

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
            lib.funnel_sort_keys.restype = None
            lib.funnel_sort_keys.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.funnel_pass.restype = None
            lib.funnel_pass.argtypes = (
                [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64]
                + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 3
                + [ctypes.c_int32, ctypes.c_int32] + [ctypes.c_float] * 3
                + [ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p])
            lib.pack_frame.restype = ctypes.c_int64
            lib.pack_frame.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64] + [ctypes.c_void_p] * 3
                + [ctypes.c_int64, ctypes.c_void_p])
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


class FunnelPass:
    """The frame funnel's draw-list stage in one native call
    (``funnel_pass`` in native/src/greedy_mesh.cpp; app/engine.py
    ``Engine._funnel_native``, whose numpy twin is ``_funnel_numpy``):
    the view-sphere and frustum keep over a chunk table, the join to the
    pool's slots, the visible chunks with no slot, the non-empty filter,
    the stable front-to-back order, the horizon cull, the cut at the draw
    list's rows, and the rows of slots, counts, direction masks and
    positions."""

    def __init__(self, lib):
        self._fn = lib.funnel_pass
        # the last array passed in each place that keeps its array from
        # call to call (the pool's tables and lookup, the rows' slots),
        # with its address; the array is held, so its address stays its
        # own
        self._held = [(None, 0)] * 6

    def _addr(self, i: int, a, dtype, shape) -> int:
        held, ptr = self._held[i]
        if a is not held or a.shape != shape:
            ptr = _ptr(a, dtype, shape)
            self._held[i] = (a, ptr)
        return ptr

    def __call__(self, table, dots, off, vd2: int, lookup, join, counts,
                 counts6, positions, cam, horizon, dir_mask: bool,
                 vcap: int):
        """``table`` i64[n, 3]; ``dots`` f32[n, 6] and ``off`` f32[6], or
        None: no frustum test; ``vd2`` the squared view distance around
        the camera's chunk (< 0: no sphere test); ``lookup`` the pool's
        (sorted packed keys i64, slots i32); ``join`` i32[n] or None: each
        row's slot, -1 where it has none, -2 where not yet known, which
        the pass finds and writes (valid while table and pool stand
        still); the pool's ``counts`` i32[S], ``counts6`` i32[S, 6] and
        ``positions`` i32[S, 3]; ``cam`` f32[3]; ``horizon`` a
        HorizonCullingConfig or None (no horizon cull).  Returns (visible
        i64[V, 3], missing i64[M, 3], n_meshed, n, slots i32[vcap],
        counts6 i32[vcap, 6], dir_mask i32[vcap, 6], positions
        i32[vcap, 3]): views of one new buffer (the pass keeps no state
        of its own between calls)."""
        n, s = len(table), len(counts)
        # the outputs, then the four sizes
        out = np.empty(6 * n + 8 * vcap + 4, np.int64)
        p = out.ctypes.data
        keys, key_slots = lookup
        hz = horizon
        self._fn(
            _ptr(table, np.int64, (n, 3)), n,
            None if dots is None else _ptr(dots, np.float32, (n, 6)),
            None if dots is None else _ptr(off, np.float32, (6,)), vd2,
            self._addr(0, keys, np.int64, (len(keys),)),
            self._addr(1, key_slots, np.int32, (len(keys),)), len(keys),
            None if join is None else self._addr(2, join, np.int32, (n,)),
            self._addr(3, counts, np.int32, (s,)),
            self._addr(4, counts6, np.int32, (s, 6)),
            self._addr(5, positions, np.int32, (s, 3)),
            float(cam[0]), float(cam[1]), float(cam[2]),
            hz is not None, hz.bins if hz else 0,
            hz.base_margin if hz else 0.0,
            hz.margin_dist_factor if hz else 0.0,
            hz.min_dist_chunks if hz else 0.0, dir_mask, vcap,
            p, p + 8 * (6 * n + 8 * vcap))
        nv, nm, n_meshed, k = out[-4:].tolist()
        rows = out[6 * n:-4].view(np.int32)
        return (out[:3 * nv].reshape(nv, 3),
                out[3 * n:3 * (n + nm)].reshape(nm, 3), n_meshed, k,
                rows[:vcap], rows[vcap:7 * vcap].reshape(vcap, 6),
                rows[7 * vcap:13 * vcap].reshape(vcap, 6),
                rows[13 * vcap:].reshape(vcap, 3))


def _ptr(a, dtype, shape) -> int:
    """The address of ``a``'s data, which must be a contiguous ``dtype``
    array of ``shape``."""
    if (a.dtype != dtype or a.shape != shape
            or not a.flags.c_contiguous):
        raise ValueError(f"expected a contiguous {np.dtype(dtype)}{shape} "
                         f"array, got {a.dtype}{a.shape}")
    return a.ctypes.data


def _sort_keys_match(lib) -> bool:
    """Whether the pass's front-to-back keys equal numpy's float32
    ``(d * d).sum(-1)`` (ops/culling.py sort_front_to_back) bit for bit,
    on a fixed sample of centres and cameras."""
    rng = np.random.default_rng(12345)
    for n in (1, 3, 8, 100, 4096):
        c = (rng.integers(-40, 40, (n, 3)) * 32 + 16).astype(np.float32)
        cam = rng.uniform(-300.0, 300.0, 3).astype(np.float32)
        got = np.empty(n, np.float32)
        lib.funnel_sort_keys(c.ctypes.data, n, cam.ctypes.data,
                             got.ctypes.data)
        d = c - cam[None, :]
        if not np.array_equal(got.view(np.int32),
                              (d * d).sum(-1).view(np.int32)):
            return False
    return True


def _funnel_pass():
    lib = _build_and_load()
    if lib is None or not _sort_keys_match(lib):
        return None
    return FunnelPass(lib)


# None where the library is not built or its keys differ from numpy's
funnel_pass = _funnel_pass()


# pack_frame's return where a slot or a coordinate lies outside int16
_OUT_OF_RANGE = -(1 << 63)


class FramePacker:
    """A draw list's one host-to-device upload in one native call
    (``pack_frame`` in native/src/greedy_mesh.cpp; rendering/pipeline.py
    ``Renderer._pack_into``, whose numpy twin is ``_pack_frame``), written
    into a buffer the caller gives: the renderer's pinned ring."""

    def __init__(self, lib):
        self._fn = lib.pack_frame

    def __call__(self, out, vcap: int, slots, counts, dir_mask, positions,
                 view_proj=None, cam_pos=None, payload=None) -> int:
        """Writes into ``out`` (a contiguous i32 array) ``_pack_frame``'s
        words: the 11-short meta of ``vcap`` rows from ``slots`` [rows],
        ``counts`` [rows, 6] by face direction or [rows] totals (one
        direction-0 unit a chunk), ``dir_mask`` [rows, 6] or None (every
        direction kept) and ``positions`` [rows, 3] (integers, taken as
        i32); then the camera, ``view_proj`` f32[4, 4] and ``cam_pos``
        f32[3], where given; then ``payload`` (u32), where given.  Returns
        the quads of the kept directions; raises ValueError where a slot
        or a coordinate lies outside int16, as ``Renderer._prep_meta``
        does."""
        slots = np.ascontiguousarray(slots, np.int32)
        counts = np.ascontiguousarray(counts, np.int32)
        positions = np.ascontiguousarray(positions, np.int32)
        rows = len(slots)
        per_dir = counts.ndim == 2
        fits = (slots.ndim == 1 and rows <= vcap
                and counts.shape == ((rows, 6) if per_dir else (rows,))
                and positions.shape == (rows, 3))
        mask_p = vp_p = cp_p = pl_p = None
        if dir_mask is not None:
            dir_mask = np.ascontiguousarray(dir_mask, np.int32)
            fits = fits and dir_mask.shape == (rows, 6)
            mask_p = dir_mask.ctypes.data
        words, n_pl = (11 * vcap + 1) // 2, 0
        if view_proj is not None:
            view_proj, cam_pos = _camera(view_proj, cam_pos)
            vp_p, cp_p = view_proj.ctypes.data, cam_pos.ctypes.data
            words += 19
        if payload is not None:
            payload = np.ascontiguousarray(payload, np.uint32)
            pl_p, n_pl = payload.ctypes.data, payload.size
            words += n_pl
        if not fits:
            raise ValueError(
                f"a draw list of {rows} rows in {vcap}: slots "
                f"{slots.shape}, counts {counts.shape}, positions "
                f"{positions.shape}, mask "
                f"{None if dir_mask is None else dir_mask.shape}")
        total = self._fn(slots.ctypes.data, counts.ctypes.data, per_dir,
                         mask_p, positions.ctypes.data, rows, vcap, vp_p,
                         cp_p, pl_p, n_pl, _out(out, words))
        if total == _OUT_OF_RANGE:
            raise ValueError(
                "draw-list meta exceeds int16 range (pool slot > 32767 "
                "or |chunk grid coord| > 32767)")
        return total


def _camera(view_proj, cam_pos):
    """The camera as contiguous f32[4, 4] and f32[3]."""
    view_proj = np.ascontiguousarray(view_proj, np.float32)
    cam_pos = np.ascontiguousarray(cam_pos, np.float32)
    if view_proj.shape != (4, 4) or cam_pos.shape != (3,):
        raise ValueError(f"a camera of {view_proj.shape} and "
                         f"{cam_pos.shape}")
    return view_proj, cam_pos


def _out(out, words: int) -> int:
    """The address of ``out``, a contiguous i32 array of ``words`` or
    more."""
    if (out.dtype != np.int32 or out.ndim != 1 or out.size < words
            or not out.flags.c_contiguous):
        raise ValueError(f"an upload of {words} i32 words into "
                         f"{out.dtype}{out.shape}")
    return out.ctypes.data


def _frame_packer():
    lib = _build_and_load()
    return None if lib is None else FramePacker(lib)


# None where the library is not built
pack_frame = _frame_packer()
