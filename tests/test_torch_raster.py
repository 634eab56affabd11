"""The port's binning, pixel math and kernel K2's plain twin against the JAX
package, on the CPU.

- ``build_tile_lists`` must match exactly (items, item tiles, starts,
  counts, overflow), including the item-cap, big-quad (512) and huge-quad
  (64) overflow cases.
- K2's twin is fed the JAX package's own records (its
  ``debug_return_records`` hook) and compared with ``rasterize_pallas`` in
  interpret mode on the same records: at 128x128 (the solo kernel) and
  640x128 (the shared-stream kernel, stream group 5).  The gate is
  full-frame equality of colour and depth.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.ops import raster as JR
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch.ops import raster as TR

TILES_Y, TILES_X = 8, 10


def _tileboxes(rng, m, n_big, n_huge):
    """Mostly 1-2 tile quads, plus ``n_big`` spanning 2x3 tiles and
    ``n_huge`` covering the whole grid (more than 64 tiles)."""
    tx0 = rng.integers(0, TILES_X, m)
    ty0 = rng.integers(0, TILES_Y, m)
    tx1 = np.minimum(tx0 + rng.integers(0, 2, m), TILES_X - 1)
    ty1 = np.minimum(ty0 + rng.integers(0, 2, m), TILES_Y - 1)
    big = rng.choice(m, n_big + n_huge, replace=False)
    b, h = big[:n_big], big[n_big:]
    tx0[b] = rng.integers(0, TILES_X - 2, n_big)
    tx1[b] = tx0[b] + 2
    ty0[b] = rng.integers(0, TILES_Y - 1, n_big)
    ty1[b] = ty0[b] + 1
    tx0[h], ty0[h], tx1[h], ty1[h] = 0, 0, TILES_X - 1, TILES_Y - 1
    empty = rng.random(m) < 0.05  # x0 > x1: no tile
    tx0[empty], tx1[empty] = 3, 2
    return (tx0 | (tx1 << 8) | (ty0 << 16) | (ty1 << 24)).astype(np.int32)


# name -> (quads, big, huge, count, item cap, valid mask); the count (or
# the mask, in no-compaction mode) marks the quads in the stream
BIN_CASES = {
    "count": (2048, 40, 8, 1900, 16384, False),
    "valid_mask": (2048, 40, 8, None, 16384, True),
    "item_overflow": (2048, 40, 8, 2048, 2048, False),
    "big_overflow": (4096, 600, 8, 4096, 32768, False),
    "huge_overflow": (2048, 20, 70, 2048, 16384, False),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_build_tile_lists_matches_jax(case):
    m, n_big, n_huge, count, item_cap, masked = BIN_CASES[case]
    rng = np.random.default_rng(sorted(BIN_CASES).index(case))
    tilebox = _tileboxes(rng, m, n_big, n_huge)
    order6 = rng.integers(0, 64, m).astype(np.int32)
    order6_dy1 = order6 & ~3
    valid = (rng.random(m) < 0.8) if masked else None
    kw = dict(tiles_y=TILES_Y, tiles_x=TILES_X, item_cap=item_cap)
    ref = JR.build_tile_lists(
        jnp.asarray(tilebox), count or m, order6=jnp.asarray(order6),
        order6_dy1=jnp.asarray(order6_dy1),
        valid=None if valid is None else jnp.asarray(valid), **kw)
    got = TR.build_tile_lists(
        torch.from_numpy(tilebox), count or m, torch.from_numpy(order6),
        torch.from_numpy(order6_dy1),
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    for name, r, g in zip(("items", "t_of_item", "starts", "counts",
                           "overflow"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=name)
    overflow = int(got[4])
    assert (overflow > 0) == case.endswith("overflow"), overflow


def test_pixel_math_matches_jax():
    """eval_row/blend vs the reference's _eval_one_quad_row and blend rule
    on random coefficients over a 16x128 pixel block."""
    rng = np.random.default_rng(2)
    nx, ny = JR._pixel_ndc(720, 1280, jnp.int32(352), 640, 16, 128)
    tnx, tny = TR.pixel_ndc(720, 1280,
                            torch.arange(352, 368.0)[:, None],
                            torch.arange(640, 768.0)[None, :])
    np.testing.assert_array_equal(np.asarray(nx), tnx.expand(16, 128))
    np.testing.assert_array_equal(np.asarray(ny), tny.expand(16, 128))
    color = np.full((16, 128), JR.SKY_I32, np.int32)
    depth = np.full((16, 128), np.inf, np.float32)
    tcolor, tdepth = torch.from_numpy(color), torch.from_numpy(depth)
    for _ in range(20):
        f = rng.normal(size=16).astype(np.float32)
        f[12:16] = np.sort(rng.uniform(-2, 2, 4)).astype(np.float32)[
            [0, 2, 1, 3]]
        i = rng.integers(-2**31, 2**31, 4).astype(np.int32)
        fro = tuple(jnp.float32(x) for x in f)
        iro = tuple(jnp.int32(x) for x in i)
        cover, z, c = JR._eval_one_quad_row(ny, fro, iro,
                                            JR._eval_bases(nx, fro))
        ok = cover & ((z < depth) | ((z == depth) & (c < color)))
        color = np.asarray(jnp.where(ok, c, color))
        depth = np.asarray(jnp.where(ok, z, depth))
        tfro = tuple(torch.tensor(x) for x in f)
        tiro = tuple(torch.tensor(x) for x in i)
        covered, tz, tc = TR.eval_row(tny, tfro, tiro,
                                      TR.eval_bases(tnx, tfro))
        tcolor, tdepth = TR.blend(covered, tz, tc, tcolor, tdepth)
        np.testing.assert_array_equal(color, tcolor.numpy())
        np.testing.assert_array_equal(depth, tdepth.numpy())
    assert (color != JR.SKY_I32).any()


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_raster_twin_matches_pallas_kernel(name):
    sc = S.scene(name)
    w, h, gc = sc[5]
    records, starts, counts, rows, zmin = JPL._render_step(
        *S.jax_args(sc), debug_return_records=True,
        **S.jax_step_kw(sc, gc))
    out_h = -h % 16 + h
    c1, d1 = JR.rasterize_pallas(
        records, starts, counts, rows, zmin, height=h, width=w, tile_h=16,
        tile_w=128, out_h=out_h, interpret=True, stream_group=5,
        block_q=1024)
    c2, d2 = TR.rasterize_tiles(
        *(torch.from_numpy(np.array(a)) for a in
          (records, starts, counts, rows, zmin)),
        height=h, width=w, tile_h=16, tile_w=128, out_h=out_h)
    c1 = np.asarray(c1).view(np.uint32)
    c2 = c2.numpy().view(np.uint32)
    parity.assert_kernel_parity(c1, np.asarray(d1), c2, d2.numpy())
    assert (c2 != np.uint32(0xFF87CEEB)).sum() > 3000
