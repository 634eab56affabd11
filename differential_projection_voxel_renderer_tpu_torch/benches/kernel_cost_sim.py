"""The model of K2's Hopper walk: what the tile raster (``csrc/raster.cu``
+ ``tile_raster.cuh``) does and what its inputs need, tile by tile.

The counterpart of ``benches/kernel_cost_sim.py``, which replays the TPU
octet kernel's walk (DMA blocks, octet groups a loop step, the tiles and
stream groups of a grid step).  Those knobs (``--opi``, ``--tps``,
``--sg``, ``--row-tree``, the fitted per-unit costs) have no meaning for
K2 on Hopper (ROADMAP.md, "not ported, by design"), so this module models
K2's own walk instead: each tile walks its segment of the binned item
stream in order until the occlusion break, the first octet base (a
multiple of 8) strictly inside the segment where the suffix-min of near
depth lies beyond every depth the tile holds so far, and evaluates each
walked item on every column of its tile for each row of its own screen box
(record row 20).  The depth at each octet base comes from K2 on the
segment prefixes (all tiles at once, the m-th base of each tile in the
m-th launch) on the card, or from its plain version on the CPU.  For each
tile it reports the items walked up to the break, the pixels evaluated
against the pixels the items' boxes need inside the tile, the octets the
break skipped, and the longest walk.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.kernel_cost_sim [--pose start|N] [--tiles]

``--pose`` is the reference start pose or key N of
``app/flythrough.default_path(24)`` (benches/scene.py); ``--tiles`` prints
one JSON line a non-empty tile before the summary line.  The module also
holds the work counts that ``chip_smoke.py`` bounds K2 and K4 with
(``k2_work``, ``k4_work``).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import raster, raster_packed
from ..rendering import pipeline
from ..utils.config import RenderConfig
from . import scene as scene_mod
from .common import need_card

# float32 operations the tile raster needs per pixel of an item's box
# (four plane evaluations of a multiply and two adds, four coverage
# products, six compares) and per item and column of its box (the four
# hoisted column products)
K2_OPS_PER_PIXEL = 22
K2_OPS_PER_ITEM_COLUMN = 4
TILE_H, TILE_W = 16, 128


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def item_boxes(step_args, step_kw, rec):
    """Each binned item's screen bbox (x0, x1, y0, y1), inclusive pixels,
    each i32[cap]: ``rendering.pipeline._step_camf`` on the same inputs
    again, with its tile-box packer and its binner (the packed path's with
    ``packed_raster``) observed to map items to quads.  Raises unless that
    call gives ``rec``'s blend fields and the items' bby row."""
    seen = {}
    packed = step_kw.get("packed_raster", False)
    mod, attr = ((pipeline.packed_ops, "build_bin_lists") if packed
                 else (pipeline.raster_ops, "build_tile_lists"))
    pack = pipeline.proj_ops.pack_tilebox
    binner = getattr(mod, attr)

    def pack_spy(*a, **kw):
        seen["box"] = a
        return pack(*a, **kw)

    def bin_spy(*a, **kw):
        out = binner(*a, **kw)
        seen["flat"] = out[0].long()
        return out

    pipeline.proj_ops.pack_tilebox = pack_spy
    setattr(mod, attr, bin_spy)
    try:
        # the packed path's "gather" output: (blend fields, words with bby
        # in row 4, ...); the default path keeps bby in record row 20
        again = pipeline._step_camf(
            *step_args, debug_return_records="gather" if packed else True,
            **step_kw)
    finally:
        pipeline.proj_ops.pack_tilebox = pack
        setattr(mod, attr, binner)
    x0, x1, y0, y1 = (b[seen["flat"]] for b in seen["box"])
    same, bby = ((torch.equal(again[0].view(torch.int32), rec[0][:16]),
                  again[1][4]) if packed
                 else (torch.equal(again[0], rec[0]), again[0][20]))
    if not (same and torch.equal(y0 | (y1 << 16), bby)):
        raise AssertionError("the items' boxes do not match the records")
    return x0, x1, y0, y1


def walk_sums(per_item, st, walked):
    """Per segment, the sum of ``per_item`` over its walk [st, walked)."""
    cum = torch.cat([torch.zeros(1, dtype=torch.long, device=per_item.device),
                     torch.cumsum(per_item, 0)])
    return cum[walked] - cum[st]


def box_in_window(boxes, n, cx0, cx1, ty):
    """(columns, rows) of the first ``n`` items' screen boxes inside
    columns [cx0, cx1] and the 16 rows from ``ty``; no columns where no
    rows."""
    x0, x1, y0, y1 = (b[:n].long() for b in boxes)
    cols = torch.clamp(torch.minimum(x1, cx1) - torch.maximum(x0, cx0) + 1,
                       min=0)
    rows = torch.clamp(torch.minimum(y1, ty + TILE_H - 1)
                       - torch.maximum(y0, ty) + 1, min=0)
    return torch.where(rows > 0, cols, 0), rows


def item_rows(bby, row0):
    """Rows of each item's screen box (bby = y0 | y1 << 16) inside the
    16-row tile that starts at ``row0``, as the kernels clamp them."""
    y0 = torch.clamp((bby & 0xFFFF) - row0, 0, TILE_H - 1)
    y1 = torch.clamp((bby >> 16) - row0, 0, TILE_H - 1)
    return (y1 - y0 + 1).long()


def k2_walk(rec, height, width):
    """(segment starts, segment ends, walk ends) of every tile, int64[T]:
    where K2's occlusion break stops each tile's walk (its segment's end
    when the break never fires)."""
    records, starts, counts, orows, ozmin = rec
    out_h = -height % TILE_H + height
    tiles_y, tiles_x = out_h // TILE_H, width // TILE_W
    kw = dict(height=height, width=width, tile_h=TILE_H, tile_w=TILE_W,
              out_h=out_h)
    st, ends = starts.long(), (starts + counts).long()
    if not torch.equal(st, torch.cumsum(counts.long(), 0) - counts.long()):
        raise AssertionError("the tile segments are not contiguous")
    walked = ends.clone()
    first = torch.div(st, 8, rounding_mode="floor")
    for m in range(1, int(counts.max()) // 8 + 2):
        b = (first + m) * 8
        active = b < walked
        if not bool(active.any()):
            break
        pc = torch.where(active, b - st, 0)
        _, depth = raster.rasterize_tiles(records, starts, pc.int(), orows,
                                          ozmin, **kw)
        dmax = depth.view(tiles_y, TILE_H, tiles_x, TILE_W).amax(dim=(1, 3))
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax.reshape(-1)), b, walked)
    return st, ends, walked


def k2_counts(rec, boxes, height, width) -> dict:
    """Per tile, int64[T]: ``items`` (the segment), ``walked`` (up to the
    break), ``evaluated`` (pixels K2 evaluates: every column of the tile
    for each row of a walked item's own box), ``needed`` (the pixels of
    the walked items' boxes inside the tile), ``ops`` (K2_OPS_PER_PIXEL a
    needed pixel, K2_OPS_PER_ITEM_COLUMN a column of a walked item's box
    in the tile) and ``octets_skipped`` (the octets from the break to the
    segment's end)."""
    records = rec[0]
    tiles_x = width // TILE_W
    st, ends, walked = k2_walk(rec, height, width)
    n_kept = int(ends[-1])
    counts = (ends - st)
    tile = torch.repeat_interleave(
        torch.arange(st.numel(), device=st.device), counts)
    ty, tx = tile // tiles_x * TILE_H, tile % tiles_x * TILE_W
    cols, rows = box_in_window(boxes, n_kept, tx, tx + TILE_W - 1, ty)
    return dict(
        items=counts, walked=walked - st,
        evaluated=walk_sums(item_rows(records[20, :n_kept], ty) * TILE_W,
                            st, walked),
        needed=walk_sums(cols * rows, st, walked),
        ops=walk_sums(cols * (rows * K2_OPS_PER_PIXEL
                              + K2_OPS_PER_ITEM_COLUMN), st, walked),
        octets_skipped=torch.div(ends - walked + 7, 8, rounding_mode="floor"))


def k2_work(rec, boxes, height, width):
    """(bytes, operations, the busiest tile's operations, pixels the
    kernel evaluates, pixels the inputs need, the longest tile walk in
    items) of the tile raster on these records (``k2_counts`` summed)."""
    c = k2_counts(rec, boxes, height, width)
    out_h = -height % TILE_H + height
    n_items = int(c["walked"].sum())
    # an item reads its 21 record words and its octet's suffix-min word;
    # the frame writes colour and depth
    moved = (n_items * (21 * 4) + n_items // 8 * 4 + nbytes(rec[1], rec[2])
             + out_h * width * 8)
    return (moved, int(c["ops"].sum()), int(c["ops"].max()),
            int(c["evaluated"].sum()), int(c["needed"].sum()),
            int(c["walked"].max()))


def k4_work(rec, boxes, height, width):
    """The work of K4 on these packed records, a dict: bytes, ops
    (operations), tile_ops (the busiest tile's), items (walked), kept,
    walk_wide and walk_bucket (the longest walks), slices_bucket (the most
    32-item slices of one bucket's walk), slices_tile and tile (the most
    bucket slices one tile walks, and that tile), and box_w, box_h and
    tile_box_w, tile_box_h (the mean columns and rows of the walked
    bucket items' boxes in their buckets, over all tiles and in that
    tile).  A bin's walk ends at its occlusion break in the
    serial order of the plain version -- the wide bin, then each bucket --
    which walks the fewest items of any order of K4's slices, since it
    tests each octet against the nearest depths possible: the wide bin at
    octet bases strictly inside it, against the max depth of its tile over
    the wide prefix so far; a bucket at octet bases at or past its start,
    against the max depth of its 512 pixels after the tile's wide walk and
    the bucket's own prefix.  The depths come from K4 on those prefixes,
    all bins at once, the m-th octet base of each in the m-th launch.  An
    item of a walk needs the pixels of its screen bbox (``boxes``) inside
    its bin's columns (the tile's 128, or the bucket's 32) and its tile's
    rows, K2_OPS_PER_PIXEL each, plus K2_OPS_PER_ITEM_COLUMN per column of
    that box."""
    BINS_PER_TILE = raster_packed.BINS_PER_TILE
    records, starts, counts, orows, ozmin, item_bby, item_bbx = rec
    out_h = -height % TILE_H + height
    tiles_y, tiles_x = out_h // TILE_H, width // TILE_W
    n_tiles = tiles_y * tiles_x
    kw = dict(height=height, width=width, out_h=out_h)
    st, cn = starts.long(), counts.long()
    ends = st + cn
    if not torch.equal(st, torch.cumsum(cn, 0) - cn):
        raise AssertionError("the bin segments are not contiguous")
    kind = torch.arange(st.numel(), device=st.device) % BINS_PER_TILE
    wide = kind == 0
    walked = ends.clone()

    def depth_of(prefix):
        return raster_packed.rasterize_packed(
            records, starts, prefix.int(), orows, ozmin, item_bby, item_bbx,
            **kw)[1]

    first = torch.div(st, 8, rounding_mode="floor")
    for m in range(1, int(cn[wide].max()) // 8 + 2):
        b = (first + m) * 8
        active = wide & (b < walked)
        if not bool(active.any()):
            break
        dmax = depth_of(torch.where(active, b - st, 0)).view(
            tiles_y, TILE_H, tiles_x, TILE_W).amax(dim=(1, 3))
        dmax = dmax.reshape(-1).repeat_interleave(BINS_PER_TILE)
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax), b, walked)
    first = torch.div(st + 7, 8, rounding_mode="floor")
    for m in range(0, int(cn[~wide].max()) // 8 + 2):
        b = (first + m) * 8
        active = ~wide & (b < walked)
        if not bool(active.any()):
            break
        pc = torch.where(wide, walked - st, torch.where(active, b - st, 0))
        dmax = depth_of(pc).view(tiles_y, TILE_H, tiles_x, 4, 32).amax(
            dim=(1, 4)).reshape(n_tiles, 4)
        dmax = torch.cat([dmax[:, :1], dmax], 1).reshape(-1)
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax), b, walked)

    n_kept = int(ends[-1])
    bins = torch.repeat_interleave(torch.arange(st.numel(),
                                                device=st.device), cn)
    tile, k = bins // BINS_PER_TILE, bins % BINS_PER_TILE
    ty = tile // tiles_x * TILE_H
    cx0 = tile % tiles_x * TILE_W + torch.where(k == 0, 0, 32 * (k - 1))
    cx1 = cx0 + torch.where(k == 0, TILE_W - 1, 31)
    cols, rows = box_in_window(boxes, n_kept, cx0, cx1, ty)
    ops = walk_sums(cols * (rows * K2_OPS_PER_PIXEL
                            + K2_OPS_PER_ITEM_COLUMN), st, walked)
    n_items = int((walked - st).sum())
    # an item reads its 20 record words, its bby and bbx and its octet's
    # suffix-min word; the frame writes colour and depth
    moved = (n_items * (22 * 4) + n_items // 8 * 4 + nbytes(starts, counts)
             + out_h * width * 8)
    tile_ops = ops.view(n_tiles, BINS_PER_TILE).sum(1)
    walk = walked - st
    # the 32-aligned slices of each bucket's walk
    slices = torch.where(~wide & (walk > 0),
                         torch.div(walked - 1, 32, rounding_mode="floor")
                         - torch.div(st, 32, rounding_mode="floor") + 1, 0)
    tile_slices = slices.view(n_tiles, BINS_PER_TILE).sum(1)
    busiest = int(tile_slices.argmax())
    # the walked bucket items' boxes in their buckets
    pos = torch.arange(n_kept, device=st.device)
    in_walk = (k > 0) & (pos < walked[bins])
    in_tile = in_walk & (tile == busiest)
    return dict(
        bytes=moved, ops=int(ops.sum()), tile_ops=int(tile_ops.max()),
        items=n_items, kept=n_kept, walk_wide=int(walk[wide].max()),
        walk_bucket=int(walk[~wide].max()), slices_bucket=int(slices.max()),
        slices_tile=int(tile_slices.max()), tile=busiest,
        box_w=float(cols[in_walk].float().mean()),
        box_h=float(rows[in_walk].float().mean()),
        tile_box_w=float(cols[in_tile].float().mean()),
        tile_box_h=float(rows[in_tile].float().mean()))


def summary(c: dict) -> dict:
    """``k2_counts`` summed over the tiles: the non-empty tiles, the kept
    and walked items, pixels evaluated and needed, octets skipped, the
    longest walk and the busiest tile (by operations)."""
    return dict(
        tiles_nonempty=int((c["items"] > 0).sum()),
        items=int(c["items"].sum()), walked=int(c["walked"].sum()),
        evaluated=int(c["evaluated"].sum()), needed=int(c["needed"].sum()),
        octets_skipped=int(c["octets_skipped"].sum()),
        longest_walk=int(c["walked"].max()),
        busiest_tile=int(c["ops"].argmax()),
        busiest_tile_ops=int(c["ops"].max()), ops=int(c["ops"].sum()))


def scene_records(pose="start", device="cuda"):
    """The benches' scene at ``pose`` (benches/scene.py), stepped as the
    engine steps it (``Renderer._bucket_kw`` of its bucket): (records, the
    items' boxes, frame width, height)."""
    sc = scene_mod.get_scene(pose=pose, device=device)
    quads, qw, total, vp, cam = scene_mod.scene_tensors(sc, device)
    r = pipeline.Renderer(RenderConfig(scene_mod.WIDTH, scene_mod.HEIGHT),
                          device=device)
    cam_f = r._cam_dev(sc[3], sc[4])
    kw = r._bucket_kw(int(quads.shape[0]))
    args = (quads, qw, total, cam_f)
    rec = pipeline._step_camf(*args, debug_return_records=True, **kw)
    return rec, item_boxes(args, kw, rec), scene_mod.WIDTH, scene_mod.HEIGHT


def run(pose="start", device="cuda", tiles: bool = False) -> dict:
    """Print the walk's counts at ``pose`` (one JSON line a non-empty tile
    with ``tiles``, then the summary line) and return the summary."""
    rec, boxes, width, height = scene_records(pose, device)
    c = k2_counts(rec, boxes, height, width)
    if tiles:
        for t in torch.nonzero(c["items"]).flatten().tolist():
            print(json.dumps({"tile": t, **{k: int(v[t])
                                            for k, v in c.items()}}),
                  flush=True)
    out = dict(pose=scene_mod.pose_name(pose), **summary(c))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pose", default="start",
                    help="'start' or a key of default_path(24)")
    ap.add_argument("--tiles", action="store_true",
                    help="one JSON line a non-empty tile")
    a = ap.parse_args(argv)
    need_card()
    run(a.pose if a.pose == "start" else int(a.pose), "cuda", a.tiles)
    return 0


if __name__ == "__main__":
    sys.exit(main())
