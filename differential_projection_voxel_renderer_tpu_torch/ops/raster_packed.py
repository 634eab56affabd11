"""Packed binning and kernel K4, the packed tile raster
(csrc/raster_packed.cu).

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/
raster_packed.py``:

- ``build_bin_lists`` bins quads into five bins per 16x128 tile, one flat
  sorted item stream: bin 5t holds the tile's "wide" quads (spanning more
  than two 32-pixel buckets), bins 5t+1..5t+4 its four 32-pixel buckets
  (narrow quads, one item per bucket they touch).  The reference's u32
  keys become int64 with explicit 32-bit masks, its manual bisection
  ``torch.searchsorted``; its big quads are binned in the default
  binning's two classes (a deliberate divergence, see ``_big_classes``).
- ``rasterize_packed`` launches K4 for CUDA tensors and runs its plain
  twin ``rasterize_packed_plain`` for CPU tensors.  The per-pixel math and
  the blend are K2's (ops/raster.py), so the frame equals the tile
  raster's on the same quad set.
"""

from __future__ import annotations

import torch

from .. import _build
from . import raster as raster_ops
from .raster import (
    SKY_I32,
    U32_MASK,
    _u32,
    blend,
    eval_bases,
    eval_row,
    kernel_inputs,
    pixel_ndc,
)

BUCKET_W = 32
BINS_PER_TILE = 5  # wide + 4 buckets
# the reference kernel's record window; the record capacity stays a
# multiple of it, so a configuration runs on both packages or on neither
CHAP_Q = 2048

# launches of the CUDA kernel K4 (not of its plain twin), read from
# _build's registry
__getattr__ = _build.module_counts({"launches": "K4"}, __name__)

# The big quads (over more than 2x2 tiles) are binned in the default
# binning's classes (ops/raster.py BIG_CAP, HUGE_CAP, MAX_TILES_BIG), each
# quad over exactly the tiles of its box.  A deliberate divergence: the
# reference bins one class, the first 512 big quads by stream index over
# the whole grid, which drops visible quads on the 1280x720
# view-distance-12 flythrough, so that the packed frames differ from the
# default path's (benches/big_quad_cap.py prints the drops and the pixels
# they change).  The trade: the port keeps up to 2048 quads over at most
# 64 tiles, but only the first 64 over more (the huge class), as the
# default binning always has, where the reference keeps any mix up to 512
# in all; a view with more than 64 huge quads drops some that the
# reference bins.  The keys are the reference's, so each bin holds the
# items of the quads it keeps in the reference's order, and at the step's
# shapes the two classes sort fewer keys than its one.  With
# raster.BIG_CAP 512 and raster.MAX_TILES_BIG at least the grid's tiles
# there is one class, and it bins as the reference does


def _big_classes(n_tiles: int) -> list[tuple[int, int]]:
    """(cap, tiles enumerated a quad) of each class of big quads, by the
    least tile count first; a class takes the quads over more tiles than
    the one before it."""
    big_cap, max_tiles = raster_ops.BIG_CAP, raster_ops.MAX_TILES_BIG
    if max_tiles >= n_tiles:
        return [(big_cap, n_tiles)]
    return [(big_cap, max_tiles), (raster_ops.HUGE_CAP, n_tiles)]


def sort_length(m: int, n_tiles: int, item_cap: int) -> int:
    """Keys ``build_bin_lists`` sorts for ``m`` quads over ``n_tiles``
    tiles: four a quad, a [tiles, cap] block a big class, padded to the
    item cap."""
    return max(4 * m + sum(c * t for c, t in _big_classes(n_tiles)),
               item_cap)


def build_bin_lists(bucketbox, count, order4, order4_dy1, *, tiles_y: int,
                    tiles_x: int, item_cap: int):
    """Bin quads ``q < count`` into per-tile [wide, b0..b3] bins as one
    flat item stream ordered by (bin, order4, quad); ``order4_dy1`` orders
    a quad's second tile row.  ``bucketbox`` is the bucket-granular box
    (bx0 | bx1<<8 | ty0<<16 | ty1<<24), i.e. ``pack_tilebox`` at tile
    width 32.  Returns (flat i32[item_cap], b_of_item i32[item_cap] with
    n_bins - 1 on pad slots, valid_slot bool[item_cap], starts i32[n_bins],
    counts i32[n_bins], overflow i32) as the reference's
    ``build_bin_lists``, but for its big quads, which are binned in two
    classes (see ``_big_classes``): the quads over at most 64 tiles that it
    drops past its 512 are binned, and the quads over more past the first
    64 are dropped."""
    dev = bucketbox.device
    m = bucketbox.shape[0]
    shift = max(1, (m - 1).bit_length())
    shift_t = shift + 4
    n_tiles = tiles_y * tiles_x
    n_bins = n_tiles * BINS_PER_TILE
    assert (n_bins << shift_t) < 2**32, "bin/quad key would overflow u32"
    maxkey = U32_MASK

    q = torch.arange(m, dtype=torch.int32, device=dev)
    in_count = q < count
    bx0 = bucketbox & 0xFF
    bx1 = (bucketbox >> 8) & 0xFF
    ty0 = (bucketbox >> 16) & 0xFF
    ty1 = (bucketbox >> 24) & 0xFF
    nonempty = in_count & (bx0 <= bx1) & (ty0 <= ty1)
    narrow = nonempty & (bx1 - bx0 <= 1) & (ty1 - ty0 <= 1)
    wide = nonempty & ~narrow
    tx0 = bx0 >> 2
    tx1 = bx1 >> 2
    small_wide = wide & (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1)
    big = wide & ~small_wide

    def ukey(binid, ob, qq):
        return ((_u32(binid) << shift_t) | (_u32(ob) << shift)
                | _u32(qq)) & U32_MASK

    # narrow and small-wide quads are disjoint: they share 4 (dy, j) slots
    keys = []
    for dy in (0, 1):
        ty = ty0 + dy
        ob = order4 if dy == 0 else order4_dy1
        for j in (0, 1):
            bx = bx0 + j
            ok_n = narrow & (bx <= bx1) & (ty <= ty1)
            bin_n = (ty * tiles_x + (bx >> 2)) * BINS_PER_TILE + 1 + (bx & 3)
            tx = tx0 + j
            ok_w = small_wide & (tx <= tx1) & (ty <= ty1)
            bin_w = (ty * tiles_x + tx) * BINS_PER_TILE
            binid = torch.where(ok_n, bin_n, bin_w)
            keys.append(torch.where(ok_n | ok_w, ukey(binid, ob, q), maxkey))

    # big quads by class, each over the tiles of its box (the wide bin)
    spanx = tx1 - tx0 + 1
    ntile_of = spanx * (ty1 - ty0 + 1)
    shapes = _big_classes(n_tiles)
    if len(shapes) == 1:
        masks = (big,)
    else:
        huge = big & (ntile_of > shapes[0][1])
        masks = (big & ~huge, huge)
    src, ty, tx, ok, big_dropped, _ = raster_ops.big_quad_tiles(
        [(mask, *shape) for mask, shape in zip(masks, shapes)], tx0, ty0,
        spanx, ntile_of)
    binid = (ty * tiles_x + tx) * BINS_PER_TILE
    keys.append(torch.where(ok, (binid.long() << shift_t)
                            | (order4[src].long() << shift) | src, maxkey))

    raw = torch.cat(keys)
    if raw.shape[0] < item_cap:  # the stream's head is item_cap keys long
        raw = torch.cat([raw, torch.full((item_cap - raw.shape[0],), maxkey,
                                         dtype=torch.int64, device=dev)])
    skeys = torch.sort(raw).values
    prefixes = torch.arange(n_bins + 1, dtype=torch.int64,
                            device=dev) << shift_t
    bounds = torch.searchsorted(skeys, prefixes, side="left")
    total = bounds[-1]
    kept_start = torch.clamp(bounds[:-1], max=item_cap)
    kept_end = torch.clamp(bounds[1:], max=item_cap)
    starts = kept_start.to(torch.int32)
    counts = (kept_end - kept_start).to(torch.int32)
    overflow = (torch.clamp(total - item_cap, min=0)
                + big_dropped).to(torch.int32)

    head = skeys[:item_cap]
    valid_slot = (torch.arange(item_cap, device=dev)
                  < torch.clamp(total, max=item_cap))
    flat = torch.where(valid_slot, head & ((1 << shift) - 1),
                       0).to(torch.int32)
    b_of_item = torch.where(valid_slot, head >> shift_t,
                            n_bins - 1).to(torch.int32)
    return flat, b_of_item, valid_slot, starts, counts, overflow


# ---------------------------------------------------------------- K4


def _check_records(records, starts, counts, octet_rows, octet_zmin, *,
                   out_h, width, tile_h):
    if tile_h != 16:
        raise ValueError("the packed raster takes 16x128 tiles")
    if out_h % tile_h or width % 128:
        raise ValueError(f"frame {out_h}x{width} is not a tile multiple")
    cap = records.shape[1]
    n_bins = (out_h // tile_h) * (width // 128) * BINS_PER_TILE
    if (records.shape[0] != 24 or records.dtype != torch.int32
            or cap % CHAP_Q):
        raise ValueError(f"records must be i32[24, cap] with cap % {CHAP_Q}"
                         f" == 0")
    if starts.shape != (n_bins,) or counts.shape != (n_bins,):
        raise ValueError("starts/counts must be i32[tiles * 5]")
    if octet_rows.shape != (cap // 8,) or octet_zmin.shape != (cap // 8,):
        raise ValueError("octet_rows/octet_zmin must have cap // 8 entries")
    return cap, n_bins // BINS_PER_TILE


def rasterize_packed_plain(records, starts, counts, octet_rows, octet_zmin,
                           *, height: int, width: int, tile_h: int = 16,
                           out_h: int | None = None):
    """Plain PyTorch twin of K4: per tile, the wide bin's items over all
    128 columns, then each bucket's items over its own 32 columns, in
    stream order, looping over the item rank within a bin, vectorised over
    all tiles.  No occlusion break (it only skips items that cannot win)."""
    out_h = out_h or height
    cap, n_tiles = _check_records(
        records, starts, counts, octet_rows, octet_zmin, out_h=out_h,
        width=width, tile_h=tile_h)
    dev = records.device
    tiles_x = width // 128
    nb = 128 // BUCKET_W
    fl = records[:16].contiguous().view(torch.float32)
    il = records[16:20]
    t = torch.arange(n_tiles, device=dev)
    ty = torch.div(t, tiles_x, rounding_mode="floor")
    tx = t % tiles_x
    px = (tx[:, None] * 128 + torch.arange(128, device=dev)).float()
    py = (ty[:, None] * tile_h + torch.arange(tile_h, device=dev)).float()
    nx, ny = pixel_ndc(height, width, py, px)
    # pixels as [tile, row, bucket, column in the bucket]
    nx = nx.view(n_tiles, 1, nb, BUCKET_W)
    ny = ny.view(n_tiles, tile_h, 1, 1)
    ylocal = torch.arange(tile_h, device=dev).view(1, tile_h, 1, 1)
    depth = torch.full((n_tiles, tile_h, nb, BUCKET_W), float("inf"),
                       dtype=torch.float32, device=dev)
    color = torch.full((n_tiles, tile_h, nb, BUCKET_W), SKY_I32,
                       dtype=torch.int32, device=dev)
    st = starts.long().view(n_tiles, BINS_PER_TILE)
    cn = counts.long().view(n_tiles, BINS_PER_TILE)
    # the wide bin (one item over the whole tile), then the four buckets
    # (one item each, over its own columns)
    for s, c in ((st[:, :1], cn[:, :1]), (st[:, 1:], cn[:, 1:])):
        shape = (n_tiles, 1, s.shape[1], 1)
        for r in range(int(c.max()) if n_tiles else 0):
            k = torch.clamp(s + r, max=cap - 1)
            fro = tuple(fl[f, k].view(shape) for f in range(16))
            iro = tuple(il[f, k].view(shape) for f in range(4))
            rows = octet_rows[k >> 3].view(shape)
            in_rows = ((r < c).view(shape) & (ylocal >= (rows & 0xFF))
                       & (ylocal <= (rows >> 8)))
            covered, z, cc = eval_row(ny, fro, iro, eval_bases(nx, fro))
            color, depth = blend(covered & in_rows, z, cc, color, depth)
    tiles_y = out_h // tile_h

    def frame(x):
        return (x.reshape(tiles_y, tiles_x, tile_h, 128)
                .permute(0, 2, 1, 3).reshape(out_h, width))

    return frame(color), frame(depth)


def rasterize_packed(records, starts, counts, octet_rows, octet_zmin,
                     item_bby=None, item_bbx=None, *, height: int,
                     width: int, tile_h: int = 16, out_h: int | None = None):
    """Blend every tile's five bins of the packed item stream.

    ``records`` i32[24, cap] (cap a multiple of CHAP_Q): rows 0-15 the f32
    blend fields (bitcast), 16-19 colour_even/odd and mask_lo/hi, 20-23
    unused; ``starts``/``counts`` i32[tiles * 5] delimit each bin's
    segment (row-major tiles, bins [wide, b0..b3]); ``octet_rows``
    i32[cap/8] the covered tile-local row range (r0 | r1 << 8) of each
    aligned group of 8 items; ``octet_zmin`` f32[cap/8] the suffix-min of
    near depth from each group to the end of the bin of its first item.
    Returns (color i32, depth f32), each [out_h, width]; NDC uses the true
    ``height``.

    ``item_bby`` and ``item_bbx`` i32[cap], each item's screen rows and
    columns (y0 | y1 << 16 and x0 | x1 << 16, the ``bby``/``bbx`` of stage
    A), are inputs of the kernel only: K4 evaluates an item on the pixels
    of its own box, where the plain version evaluates its octet's rows and
    its bin's columns (the same frame, since no item covers a pixel outside
    its own box).  A CUDA call needs them; the plain version ignores
    them."""
    out_h = out_h or height
    if records.device.type != "cuda":
        return rasterize_packed_plain(
            records, starts, counts, octet_rows, octet_zmin, height=height,
            width=width, tile_h=tile_h, out_h=out_h)
    cap, _ = _check_records(
        records, starts, counts, octet_rows, octet_zmin, out_h=out_h,
        width=width, tile_h=tile_h)
    for box in (item_bby, item_bbx):
        if (box is None or box.shape != (cap,) or box.dtype != torch.int32
                or box.device != records.device):
            raise ValueError("rasterize_packed: item_bby and item_bbx must "
                             "be i32[cap] on the records' device")
    if cap >= 2**30:
        raise ValueError("rasterize_packed: cap must be below 2**30")
    dev = records.device
    ins = kernel_inputs("rasterize_packed", records, starts, counts,
                        item_bby, octet_zmin)
    color = torch.empty((out_h, width), dtype=torch.int32, device=dev)
    depth = torch.empty((out_h, width), dtype=torch.float32, device=dev)
    rec, st, cn, bby, zmin = (x.data_ptr() for x in ins)
    bbx = item_bbx.contiguous()
    _build.launch(
        "dpvr_rasterize_packed", dev.index, "rasterize_packed",
        rec, cap, st, cn, bby, bbx.data_ptr(), zmin, out_h // tile_h,
        width // 128, height, width, color.data_ptr(), depth.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.count("K4", dev.index)
    return color, depth
