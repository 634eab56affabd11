"""Synthetic raster streams for the port's tests: screen-aligned
rectangles with known coverage, binned by hand, for the cases the scenes
do not reach -- a bucket of over a thousand items beside near-empty ones,
ties on signed zeros, and an occlusion break claimed at a chosen octet.
numpy and torch only (tests/test_torch_cuda.py runs without JAX)."""

from __future__ import annotations

import numpy as np
import torch


def _rects(rng, n, x_range, y_range, width, height, zero_ties=0,
           tie_colour=7):
    """Records of n random screen-aligned rectangles inside columns
    ``x_range`` and rows ``y_range`` (inclusive): u = nx, v = ny, w = 1,
    with coverage bounds on the pixel edges, so an item covers exactly the
    pixel centres of its box; random depth planes (constant term in
    [0.1, 0.9), slopes within 0.02) and random colours and masks.  The
    first ``zero_ties`` lie at depth exactly zero, alternating +0 and -0
    planes, in the two colours from ``tie_colour``, so that ties on a
    signed zero meet at pixels.  Returns (rows i32[24, n] with the item's
    bby in row 20, near depth in row 21 and bbx in row 22, near depth
    f32[n]:
    the plane's least value over the box's corner pixel centres, less
    1e-6, a lower bound of every covered depth)."""
    xa = rng.integers(x_range[0], x_range[1] + 1, (n, 2))
    ya = rng.integers(y_range[0], y_range[1] + 1, (n, 2))
    x0, x1 = xa.min(1), xa.max(1)
    y0, y1 = ya.min(1), ya.max(1)
    f = np.zeros((16, n), np.float32)
    f[0] = f[4] = f[8] = 1.0
    f[9] = rng.uniform(-0.02, 0.02, n)
    f[10] = rng.uniform(-0.02, 0.02, n)
    f[11] = rng.uniform(0.1, 0.9, n)
    colours = rng.integers(-2**31, 2**31, (4, n)).astype(np.int32)
    for i in range(zero_ties):
        # a -0 plane evaluates to -0 where nx > 0 and z1 * ny is -0
        f[9:12, i] = ((-0.0, -0.0 if i % 4 == 1 else 0.0, -0.0) if i % 2
                      else 0.0)
        colours[:2, i] = tie_colour + (i // 4) % 2
    w, h = np.float32(width), np.float32(height)
    f[12] = (2.0 * x0.astype(np.float32) - w) / w
    f[13] = (2.0 * (x1 + 1).astype(np.float32) - w) / w
    f[14] = 1.0 - 2.0 * (y1 + 1).astype(np.float32) / h
    f[15] = 1.0 - 2.0 * y0.astype(np.float32) / h
    cx = (2.0 * (np.stack([x0, x1]) + 0.5) - width) / width
    cy = 1.0 - 2.0 * (np.stack([y0, y1]) + 0.5) / height
    z = (f[9].astype(np.float64) * cx[:, None] + f[10] * cy[None]
         + f[11].astype(np.float64))
    near = (z.reshape(4, n).min(0) - 1e-6).astype(np.float32)
    rows = np.zeros((24, n), np.int32)
    rows[:16] = f.view(np.int32)
    rows[16:20] = colours
    rows[20] = y0 | (y1 << 16)
    rows[21] = near.view(np.int32)
    rows[22] = x0 | (x1 << 16)
    return rows, near


def _stream(parts, cap):
    """Segments ``parts`` [(rows, near)] one after another in a stream of
    ``cap`` items: (records i32[24, cap], starts, counts, octet_rows,
    octet_zmin), octet_rows each aligned octet's union of tile-local rows
    (one tile row, 16 high), octet_zmin the suffix-min of near depth from
    the octet's first item to the end of its segment."""
    counts = np.array([p[0].shape[1] for p in parts], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    n = int(counts.sum())
    rec = np.zeros((24, cap), np.int32)
    rec[:, :n] = np.concatenate([p[0] for p in parts], 1)
    near = np.full(cap, np.inf, np.float32)
    near[:n] = np.concatenate([p[1] for p in parts])
    seg = np.concatenate([np.repeat(np.arange(len(parts)), counts),
                          np.full(cap - n, len(parts))])
    ly0 = np.where(np.arange(cap) < n, np.clip(rec[20] & 0xFFFF, 0, 15), 15)
    ly1 = np.clip(rec[20] >> 16, 0, 15)
    orows = ly0.reshape(-1, 8).min(1) | (ly1.reshape(-1, 8).max(1) << 8)
    sfx = near.copy()
    for i in range(cap - 2, -1, -1):
        if seg[i + 1] == seg[i]:
            sfx[i] = min(sfx[i], sfx[i + 1])
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        rec, starts, counts, orows.astype(np.int32), sfx[::8]))


def long_bucket_stream(seed=7):
    """One 16x128 tile of the packed raster: a wide bin of 24 items,
    buckets of 3, 2 and 1 items and a last bucket of 1100 (narrow items,
    each at most two buckets wide), with ties on signed zeros in the wide
    bin and the long bucket (the wide bin's in colours that lose to the
    bucket's, so that the bucket's own order decides the sign).  Returns
    (rasterize_packed's inputs with item_bby and item_bbx, its keyword
    arguments)."""
    rng = np.random.default_rng(seed)
    parts = [_rects(rng, 24, (0, 127), (0, 15), 128, 16, 8, tie_colour=9)]
    for b, n in enumerate((3, 2, 1, 1100)):
        parts.append(_rects(rng, n, (max(32 * b - 8, 0),
                                     min(32 * b + 39, 127)), (0, 15),
                            128, 16, 40 if b == 3 else 0))
    rec = _stream(parts, 2048)
    return ((*rec, rec[0][20].clone(), rec[0][22].clone()),
            dict(height=16, width=128))


def _flat(rows, near, depth, x_ndc=None):
    """Items of ``rows`` made flat at ``depth`` f32[n] (z0 = z1 = 0), and,
    given ``x_ndc`` (lo, hi) f32[n], bounded to those NDC columns."""
    f = rows[:16].view(np.float32)
    f[9:11] = 0.0
    f[11] = depth
    if x_ndc is not None:
        f[12], f[13] = x_ndc
    rows[21] = f[11].view(np.int32)
    near[:] = depth


def octet_break_stream(seed=11):
    """Two 16x128 tiles of K2's input.  Tile 1's segment starts at item 37:
    a full-tile occluder at depth 0.95, then 130 items one pixel wide, each
    nearer than every item before it that shares its column, so each of
    them wins some pixel, then 60 more items.  The octet at item 168 =
    128 + 40 claims a near depth of 0.99 (octet_zmin) while those last 60
    items lie nearer, so the kernel's break fires at item 168, an octet
    base that is not a multiple of 128, and leaves them out, where the
    plain version, which has no break, blends them.  Every octet before
    claims 0.  Returns (rasterize_tiles' inputs, its keyword arguments,
    the break's item index, tile 1's start)."""
    rng = np.random.default_rng(seed)
    width, height = 256, 16
    tile0 = _rects(rng, 37, (0, 127), (0, 15), width, height)
    occl = _rects(rng, 1, (128, 255), (0, 15), width, height)
    _flat(*occl, np.float32([0.95]),
          (np.float32([0.0]), np.float32([1.0])))
    occl[0][:16].view(np.float32)[14:16, 0] = (-1.0, 1.0)
    occl[0][20] = 15 << 16
    mid = _rects(rng, 130, (128, 255), (0, 15), width, height)
    col = (128 + np.arange(130) % 128).astype(np.float32)
    _flat(*mid, np.linspace(0.7, 0.3, 130, dtype=np.float32),
          ((2.0 * col - width) / width, (2.0 * (col + 1) - width) / width))
    tail = _rects(rng, 60, (128, 255), (0, 15), width, height)
    tile1 = tuple(np.concatenate(x, -1) for x in zip(occl, mid, tail))
    rec, starts, counts, orows, ozmin = _stream([tile0, tile1], 2048)
    brk = 168
    ozmin[:brk // 8] = 0.0
    ozmin[brk // 8] = 0.99
    return ((rec, starts, counts, orows, ozmin),
            dict(height=height, width=width, tile_h=16, tile_w=128,
                 out_h=height), brk, int(starts[1]))


def tile_meta_stream(seed, tiles_y, tiles_x, rc, n_items, long_tile=0,
                     n_kept=None):
    """A binned item stream as ``raster.build_tile_lists`` leaves it, built
    by hand for ``raster.tile_metadata``: (all22 i32[22, rc], flat,
    t_of_item i32[n_items], tile_starts, tile_counts i32[T]) and its
    keyword arguments (16-row tiles).  ``n_kept`` kept items (default: n_items
    less 5, so not a multiple of 8) over the row-major tiles, a third of
    the tiles empty and tile ``T // 2`` holding ``long_tile`` of them (if
    any);
    the slots past n_kept hold item 0 in tile 0.  Each quad's rows: random
    words, screen rows (bby) that may start above and end below any tile,
    and near depths that include +-0, +-inf, negative values and NaN."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_y * tiles_x
    n_kept = n_items - 5 if n_kept is None else n_kept
    weights = rng.random(n_tiles) * (rng.random(n_tiles) > 1 / 3)
    if long_tile:
        weights[n_tiles // 2] = 0.0
    weights[0] = max(weights[0], 0.1)
    rest = n_kept - long_tile
    counts = np.floor(weights / weights.sum() * rest).astype(np.int64)
    counts[0] += rest - counts.sum()
    if long_tile:
        counts[n_tiles // 2] = long_tile
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t_of_item = np.zeros(n_items, np.int32)
    t_of_item[:n_kept] = np.repeat(np.arange(n_tiles), counts)
    flat = np.zeros(n_items, np.int32)
    flat[:n_kept] = rng.integers(0, rc, n_kept)
    all22 = rng.integers(-2**31, 2**31, (22, rc), dtype=np.int64).astype(
        np.int32)
    y0 = rng.integers(-8, tiles_y * 16 + 8, rc)
    y1 = y0 + rng.integers(0, 40, rc)
    all22[20] = np.clip(y0, 0, None) | (np.clip(y1, 0, 2**15 - 1) << 16)
    near = rng.uniform(-2.0, 2.0, rc).astype(np.float32)
    special = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40])
    pick = rng.random(rc) < 0.05
    near[pick] = rng.choice(special, int(pick.sum()))
    all22[21] = near.view(np.int32)
    ins = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        all22, flat, t_of_item, starts.astype(np.int32),
        counts.astype(np.int32)))
    return ins, dict(tiles_y=tiles_y, tiles_x=tiles_x, tile_h=16)
