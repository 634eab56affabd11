"""Scenes shared by the port's CPU tests (tests/test_torch_*.py): the
reference fuzz chunk and the 3x3 terrain patch of ``__graft_entry__``,
flattened to a gather stream with the JAX package's host-side
``build_gather_indices``, and the same inputs as JAX arrays and as torch
tensors."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.meshing.greedy import mesh_chunk
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.ops.shading import (
    build_quad_color_tables,
)
from differential_projection_voxel_renderer_tpu.ops.texture import TextureAtlas
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering.pipeline import (
    build_gather_indices,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)
from differential_projection_voxel_renderer_tpu_torch.rendering.parity import (
    SMALL_SCENES,
    STRADDLE_CAMERAS,
)

# The twins run thousands of small ops; with several test workers on one
# host, torch's intra-op thread pool oversubscribes the cores and every
# parallel region waits on descheduled threads (8x slower at 2 workers).
torch.set_num_threads(1)

TABLES = build_quad_color_tables(TextureAtlas().kernel_tables())

# name -> (width, height, gather cap, camera position, camera target): the
# sizes and cameras of the port's card scenes
SCENES = {"fuzz": SMALL_SCENES["fuzz 128x128"],
          "terrain": SMALL_SCENES["terrain 640x128"]}


def _pool(name):
    if name == "fuzz":
        quads = mesh_chunk(parity.fuzz_chunk())
        pool = np.zeros((1, 4096), np.uint32)
        pool[0, :len(quads)] = quads
        return pool, np.array([len(quads)]), np.zeros((1, 3), np.int32)
    from __graft_entry__ import _example_scene

    pool, counts, positions, n, _cam = _example_scene()
    return pool[:n], counts[:n], positions[:n]




def straddle_scene(cam):
    """``scene("terrain")`` seen from ``STRADDLE_CAMERAS[cam]``."""
    w, h, gc, _, _ = SCENES["terrain"]
    return scene("terrain", (w, h, gc, *STRADDLE_CAMERAS[cam]))


def scene(name, view=None):
    """(stream u32[GC], quad_world f32[3, GC], total, view_proj, cam_pos,
    (width, height, gather_cap)); ``view`` (width, height, gather cap,
    camera position, camera target) replaces the scene's own."""
    w, h, gc, pos, tgt = view or SCENES[name]
    pool, counts, positions = _pool(name)
    slots = np.arange(len(counts), dtype=np.int32)
    slot_of, within, quad_world, total = build_gather_indices(
        counts, slots, positions, gc)
    cam = Camera(np.asarray(pos, np.float32), w / h)
    cam.look_at(np.asarray(tgt, np.float32))
    return (pool[slot_of, within], quad_world, total,
            cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32), (w, h, gc))


def jax_args(sc):
    stream, qw, total, vp, cp, _ = sc
    return (jnp.asarray(stream), jnp.asarray(qw), jnp.asarray(total, jnp.int32),
            jnp.asarray(vp), jnp.asarray(cp))


def torch_args(sc, device="cpu"):
    stream, qw, total, vp, cp, _ = sc
    return tuple(t.to(device) for t in (
        TP.as_quad_words(stream), torch.from_numpy(qw),
        torch.tensor(total, dtype=torch.int32), torch.from_numpy(vp),
        torch.from_numpy(cp)))


def jax_step_kw(sc, render_cap):
    w, h, gc = sc[5]
    return dict(color_tables=TABLES, width=w, height=h, tile_h=16,
                tile_w=128, gather_cap=gc, render_cap=render_cap,
                span_mode=False, backface_culling=True, use_pallas=True,
                interpret=True, tile_k_cap=2 * gc)


def torch_step_kw(sc, render_cap, device="cpu"):
    w, h, gc = sc[5]
    return dict(color_tables=TP.color_table_tensors(TABLES, device),
                width=w, height=h, tile_h=16, tile_w=128,
                render_cap=render_cap, tile_k_cap=2 * gc)


def engine_records(eng):
    """The port engine's raster input for the frame just rendered (the draw
    list re-expanded from the pool, which already holds the frame's
    inserts)."""
    r = eng.renderer
    up = r.prepare_uploads(eng.pool.quads, eng._last_visible_slots,
                           eng._last_counts_sel, eng._last_positions_sel,
                           dir_mask=eng._last_dir_mask)
    cam = r._cam_dev(eng.camera.view_projection_matrix(),
                     eng.camera.position)
    return TPL._step_camf(*up, cam, debug_return_records=True,
                          **r._bucket_kw(int(up[0].shape[0])))[0].numpy()


def _texel_flip(records, yy, xx, depth, h, w):
    """A record covers pixel (yy, xx) of an h x w frame at ``depth`` with 8u
    or 8v within 8 f32 ulps of an integer (float64 evaluation of the f32
    records)."""
    f = records[:16].view(np.float32).astype(np.float64)
    nx = (2.0 * (xx + 0.5) - w) / w
    ny = 1.0 - 2.0 * (yy + 0.5) / h
    qu = f[0] * nx + f[1] * ny + f[2]
    qv = f[3] * nx + f[4] * ny + f[5]
    qw = f[6] * nx + f[7] * ny + f[8]
    z = f[9] * nx + f[10] * ny + f[11]
    with np.errstate(divide="ignore", invalid="ignore"):
        at = ((qw > 0) & (qu >= f[12] * qw) & (qu <= f[13] * qw)
              & (qv >= f[14] * qw) & (qv <= f[15] * qw)
              & (np.abs(z - depth) <= 4 * np.spacing(np.float32(1.0))))
        edge = np.zeros_like(at)
        for s in (8.0 * qu / qw, 8.0 * qv / qw):
            ulp = np.spacing(np.abs(s).astype(np.float32)).astype(np.float64)
            edge |= np.abs(s - np.round(s)) <= 8 * ulp
    return bool((at & edge).any())


def assert_engine_frame_gates(ref, got, records, depth_ulps=None):
    """The JAX engine's frame ``ref`` against the port engine's ``got``,
    each (color u32, depth, stats, rendered meshes, visible chunks), with
    the port's raster input ``records``: the gates of
    tests/test_torch_engine.py (its docstring gives the reasons).  With
    ``depth_ulps`` (for cameras where the JAX jnp path's depth strays
    further) every finite depth may differ by that many ulps instead of 4,
    and a texel-edge flip may sit at depths that differ within it instead
    of at equal depths."""
    (c1, d1), (c2, d2) = ref[:2], got[:2]
    np.testing.assert_array_equal(np.isfinite(d1), np.isfinite(d2))
    fin = np.isfinite(d1)
    ulp = np.spacing(np.maximum(np.abs(d1), np.float32(1.0)))
    tol = (depth_ulps or 4) * ulp
    assert (np.abs(d1[fin] - d2[fin]) <= tol[fin]).all()
    c2 = c2.copy()
    with np.errstate(invalid="ignore"):   # inf - inf off the terrain
        same_depth = (d1 == d2) if depth_ulps is None else (
            fin & (np.abs(d1 - d2) <= tol))
    flips = np.argwhere((c1 != c2) & same_depth)
    for yy, xx in flips:
        assert _texel_flip(records, yy, xx, d1[yy, xx], *d1.shape), (yy, xx)
        c2[yy, xx] = c1[yy, xx]
    assert len(flips) <= 4
    # same colour and depth within 4 ulps is the gate's own per-pixel
    # rule, applied here before its mismatch-count cap
    parity.assert_kernel_parity_boundary(
        c1, d1, c2, np.where(c1 == c2, d1, d2), records)
    np.testing.assert_array_equal(ref[2], got[2])
    assert ref[3:] == got[3:]
    assert (got[0] != np.uint32(0xFF87CEEB)).sum() > 1000


# where the colours agree, the depth the gates allow between the JAX jnp
# path's frame and the port's at cameras that see far terrain (the
# planar-depth coefficients' cancelling sums, contracted into FMAs by
# XLA:CPU; tests/test_torch_app.py gives the measurement)
JNP_DEPTH_ULPS = 32


def frame_tuple(res):
    """An engine FrameResult (either package) as (color u32, depth, stats,
    rendered meshes, visible chunks), numpy."""
    stats = (res.stats.numpy() if isinstance(res.stats, torch.Tensor)
             else np.asarray(res.stats))
    return (res.color_numpy(), res.depth_numpy(), stats,
            res.rendered_meshes, res.visible_chunks)


def draw_list(eng):
    """An engine's last draw list and camera (either package)."""
    return (eng._last_visible_slots, eng._last_counts_sel,
            eng._last_dir_mask, eng._last_positions_sel,
            eng.camera.view_projection_matrix())


def pool_tables(pool):
    """A pool's slot map, host counts and device rows, as numpy copies
    (either package)."""
    quads = pool.quads
    if isinstance(quads, torch.Tensor):
        quads = quads.numpy().view(np.uint32)
    return (dict(pool.by_pos), pool.counts.copy(), pool.counts6.copy(),
            np.array(quads))


def assert_same_pool_tables(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def resident_state(eng):
    """The resident stream (u32 words, origins) and its bookkeeping, numpy
    and ints (either package)."""
    q, w = eng._res_uploads
    if isinstance(q, torch.Tensor):
        q, w = q.numpy().view(np.uint32), w.numpy()
    return dict(quads=np.array(q), qw=np.array(w), total=eng._res_total,
                cell=eng._res_cell, n=eng._res_n, appends=eng._res_appends,
                fused=eng._res_fused_inserts, dirty=eng._res_dirty,
                pending=None if eng._res_pending is None
                else (np.array(eng._res_pending[0]), *eng._res_pending[1:]))


def resident_records(eng):
    """The port engine's raster input for the resident frame just rendered:
    the stream as it rendered (the next frame's queued batch is already in
    ``_res_total``)."""
    r = eng.renderer
    total = eng._res_total - (eng._res_pending[2] if eng._res_pending
                              else 0)
    q, w = eng._res_uploads
    cam = r._cam_dev(eng.camera.view_projection_matrix(),
                     eng.camera.position)
    return TPL._step_camf(q, w, np.int32(total), cam,
                          debug_return_records=True,
                          **r._bucket_kw(int(q.shape[0])))[0].numpy()


def assert_same_resident_state(a, b):
    """Two ``resident_state`` records equal: streams bit for bit, the
    bookkeeping and the queued batch exact."""
    for k in ("total", "cell", "n", "appends", "fused", "dirty"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["quads"], b["quads"])
    np.testing.assert_array_equal(a["qw"], b["qw"])
    assert (a["pending"] is None) == (b["pending"] is None)
    if a["pending"] is not None:
        np.testing.assert_array_equal(a["pending"][0], b["pending"][0])
        assert a["pending"][1:] == b["pending"][1:]
