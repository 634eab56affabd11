"""Frame parity gates and small scenes, for runs without JAX (the card's
machine: chip_smoke.py, tests/test_torch_cuda.py).

The gates are those of ``differential_projection_voxel_renderer_tpu/
rendering/parity.py``: full-frame equality, or equality up to mismatches
that are proven (in float64) to be coverage-edge or near-depth-tie
ambiguity.  The scenes are the reference fuzz chunk at 128x128 and a 3x3
patch of terrain chunks at 640x128, flattened into a gather stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..meshing.greedy import mesh_chunk
from ..models.camera import Camera
from ..models.chunk import Chunk
from ..ops import projection
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas


def assert_kernel_parity(c1, d1, c2, d2):
    """Full-frame equality of colour and depth."""
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(c1, c2)


def assert_kernel_parity_boundary(c1, d1, c2, d2, records, *,
                                  max_frac=5e-4):
    """Equality up to provable ambiguity: every mismatching pixel must lie
    within 4 f32 ulps of some record's coverage edge, or be a near-z-tie
    between two covering records; at most ``max_frac`` of the frame may
    differ.  ``records`` is the i32[24, cap] raster input.  Returns the
    mismatch count."""
    mism = np.argwhere((d1 != d2) | (c1 != c2))
    if len(mism) == 0:
        return 0
    assert len(mism) <= max(1, int(max_frac * d1.size)), (
        f"{len(mism)} mismatching pixels (> {max_frac:.1e} of frame)")
    f = np.asarray(records)[:16].view(np.float32).astype(np.float64)
    H_, W_ = d1.shape
    for yy, xx in mism:
        if (c1[yy, xx] == c2[yy, xx]
                and np.isfinite(d1[yy, xx]) and np.isfinite(d2[yy, xx])
                and abs(d1[yy, xx] - d2[yy, xx]) <= 4 * np.spacing(
                    np.float32(max(abs(d1[yy, xx]), 1.0)))):
            continue  # z rounding variance, same winner
        nx = (2.0 * (xx + 0.5) - W_) / W_
        ny = 1.0 - 2.0 * (yy + 0.5) / H_
        qu = f[0] * nx + f[1] * ny + f[2]
        qv = f[3] * nx + f[4] * ny + f[5]
        qw = f[6] * nx + f[7] * ny + f[8]
        margins = np.stack([
            np.abs(qu - f[12] * qw), np.abs(qu - f[13] * qw),
            np.abs(qv - f[14] * qw), np.abs(qv - f[15] * qw),
        ])
        term = np.maximum.reduce([
            np.abs(f[0] * nx), np.abs(f[1] * ny), np.abs(f[2]),
            np.abs(f[3] * nx), np.abs(f[4] * ny), np.abs(f[5]),
            np.abs(f[12] * qw), np.abs(f[13] * qw),
            np.abs(f[14] * qw), np.abs(f[15] * qw),
            np.ones_like(qu),
        ])
        ulp = np.spacing(term.astype(np.float32)).astype(np.float64)
        on_edge = (qw > 0) & (margins.min(axis=0) <= 4.0 * ulp)
        slack = 4.0 * ulp
        covers = ((qw > 0)
                  & (qu >= f[12] * qw - slack) & (qu <= f[13] * qw + slack)
                  & (qv >= f[14] * qw - slack) & (qv <= f[15] * qw + slack))
        z = f[9] * nx + f[10] * ny + f[11]
        d1v, d2v = float(d1[yy, xx]), float(d2[yy, xx])
        zt_tie = 4 * np.spacing(np.float32(max(abs(d1v), abs(d2v), 1.0)))
        near_tie = (np.isfinite(d1v) and np.isfinite(d2v)
                    and abs(d1v - d2v) <= zt_tie)
        if near_tie:
            tied = (covers & ((np.abs(z - d1v) <= zt_tie)
                              | (np.abs(z - d2v) <= zt_tie)))
            near_tie = int(tied.sum()) >= 2
        assert on_edge.any() or near_tie, (
            f"pixel ({yy},{xx}) differs but no record is within 4 ulps "
            f"of a coverage edge there and the depths are not a provable "
            f"near-tie between two covering records")
        for dv in (d1v, d2v):
            if np.isfinite(dv):
                zt = 4 * np.spacing(np.float32(max(abs(dv), 1.0)))
                assert (covers & (np.abs(z - dv) <= zt)).any(), (
                    f"pixel ({yy},{xx}): depth {dv} matches no covering "
                    f"record")
    return len(mism)


def frame_parity(c1, d1, c2, d2, records) -> str:
    """'exact', or 'boundary-ok (N px)' when the boundary gate proves
    every mismatch; raises AssertionError otherwise."""
    try:
        assert_kernel_parity(c1, d1, c2, d2)
        return "exact"
    except AssertionError:
        n = assert_kernel_parity_boundary(c1, d1, c2, d2, records)
        return f"boundary-ok ({n} px)"


def fuzz_chunk(seed=42) -> Chunk:
    """The reference fuzz scene: a hilly heightfield of random blocks."""
    rng = np.random.default_rng(seed)
    x = np.arange(32)
    height = ((np.sin(x / 32 * 10) * 2)[None, :]
              + (np.cos(x / 32 * 10) * 2)[:, None] + 8)
    y = np.arange(32)[None, :, None]
    types = rng.integers(1, 4, size=(32, 32, 32)).astype(np.uint8)
    return Chunk.varied((0, 0, 0), np.where(y < height[:, None, :], types,
                                            0).astype(np.uint8))


# name -> (width, height, gather cap, camera position, camera target)
SMALL_SCENES = {
    "fuzz 128x128": (128, 128, 4096, (16.0, 48.0, 16.0), (16.0, 8.0, 16.0)),
    "terrain 640x128": (640, 128, 16384, (0.0, 40.0, 70.0),
                        (0.0, 8.0, 0.0)),
}


def wall_scene(device, gather_cap: int = 16384):
    """The occluder wall of tests/test_macrotile.py at 128x128: a solid
    chunk fills the view and a dense chunk sits fully behind it, each
    meshed alone.  (render_step positional args on ``device``, its keyword
    args)."""
    rng = np.random.default_rng(7)
    hx = np.sin(np.arange(32) / 32 * 12) * 6
    hz = np.cos(np.arange(32) / 32 * 12) * 6
    y = np.arange(32)[None, :, None]
    solid = y < (hx[None, :] + hz[:, None] + 16)[:, None, :]
    types = rng.integers(1, 4, (32, 32, 32)).astype(np.uint8)
    chunks = [Chunk.generate_test_solid((0, 0, 0)),
              Chunk.varied((1, 0, 0), np.where(solid, types, 0)
                           .astype(np.uint8))]
    stream = np.zeros(gather_cap, np.uint32)
    quad_world = np.zeros((3, gather_cap), np.float32)
    total = 0
    for c in chunks:
        q = mesh_chunk(c)
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(c.position, np.float32)[:, None] * 32.0)
        total += len(q)
    cam = Camera(np.array([-20.0, 16.0, 16.0], np.float32), 1.0)
    cam.look_at(np.array([32.0, 16.0, 16.0], np.float32))
    args = (projection.as_quad_words(stream), torch.from_numpy(quad_world),
            torch.tensor(total, dtype=torch.int32),
            torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    kw = dict(color_tables=projection.color_table_tensors(tables, device),
              width=128, height=128, tile_h=16, tile_w=128,
              render_cap=gather_cap, tile_k_cap=2 * gather_cap)
    return tuple(a.to(device) for a in args), kw


def small_scene(name, device):
    """(render_step positional args on ``device``, its keyword args)."""
    w, h, gc, cam_pos, cam_tgt = SMALL_SCENES[name]
    if name.startswith("fuzz"):
        chunks = [fuzz_chunk()]
    else:
        chunks = [Chunk.generate_terrain((x, 0, z)) for x in (-1, 0, 1)
                  for z in (-1, 0, 1)]
    stream = np.zeros(gc, np.uint32)
    quad_world = np.zeros((3, gc), np.float32)
    total = 0
    for c in chunks:
        q = mesh_chunk(c, chunks)
        if q is None:
            continue
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(c.position, np.float32)[:, None] * 32.0)
        total += len(q)
    cam = Camera(np.asarray(cam_pos, np.float32), w / h)
    cam.look_at(np.asarray(cam_tgt, np.float32))
    args = (projection.as_quad_words(stream), torch.from_numpy(quad_world),
            torch.tensor(total, dtype=torch.int32),
            torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    kw = dict(color_tables=projection.color_table_tensors(tables, device),
              width=w, height=h, tile_h=16, tile_w=128, render_cap=gc,
              tile_k_cap=2 * gc)
    return tuple(a.to(device) for a in args), kw
