"""What the raster kernels' walks rely on, held on the CPU with the plain
twins of K2 and K4.

- Containment: no item covers a pixel outside its own screen box
  (stage A's bbx/bby), exact records and span mode's records alike (a
  span item covers its NDC box, which the box's floor and ceiling hold
  with about half a pixel to spare).  K2 evaluates an item only on the rows of its own
  box and K4's buckets only on its box's pixels, where the twins evaluate
  its 8-item octet's rows over the tile's or bucket's columns; on the test
  scenes, for both the default and the packed binning, every pixel an item
  covers in its tile (or bucket) lies in its box, so the two give the same
  frame.  It also means that the rows past an octet's row range, where the
  reference's kernels keep the colour at depth +inf, are never covered.
- Split and merge: the twins run on sub-segments of each tile or bin (any
  starts/counts), and the partial frames merge, in any order, by the
  lexicographic (depth, colour) minimum, with the sign of a zero depth
  taken from the first partial in stream order that holds the winning
  (zero, colour) -- the merge K4's bucket phase does with its keys -- into
  the full twin's frame, bit for bit, ties and signed zeros included.
"""

import numpy as np
import pytest
import torch

import _torch_scenes as S
import _torch_streams as TS
from differential_projection_voxel_renderer_tpu_torch.ops import raster
from differential_projection_voxel_renderer_tpu_torch.ops import (
    raster_packed as TRP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

PATHS = ("default", "packed")


@pytest.fixture(scope="module")
def scenes():
    return {name: S.scene(name) for name in S.SCENES}


def _binned_items(monkeypatch, sc, packed, span=False):
    """The scene's raster input with each binned item's screen box: records
    i32[24, cap], starts, counts, and x0, x1, y0, y1 i32[cap] (items past
    the last segment hold zeros).  The boxes are observed on their way into
    the step's tile-box packer, and mapped to items by the binner's
    output."""
    w, h, gc = sc[5]
    kw = dict(S.torch_step_kw(sc, gc), packed_raster=packed, span_mode=span)
    seen = {}
    pack = TPL.proj_ops.pack_tilebox
    mod, attr = ((TPL.packed_ops, "build_bin_lists") if packed
                 else (TPL.raster_ops, "build_tile_lists"))
    binner = getattr(mod, attr)

    def pack_spy(*a, **k):
        seen["box"] = a
        return pack(*a, **k)

    def bin_spy(*a, **k):
        out = binner(*a, **k)
        seen["flat"] = out[0].long()
        return out

    monkeypatch.setattr(TPL.proj_ops, "pack_tilebox", pack_spy)
    monkeypatch.setattr(mod, attr, bin_spy)
    rec = TPL.render_step(*S.torch_args(sc), debug_return_records=True,
                          **kw)
    boxes = [b[seen["flat"]] for b in seen["box"]]
    n = int(rec[1][-1] + rec[2][-1])
    for b in boxes:
        b[n:] = 0
    # the binner's items carry the boxes the records were built from
    bby = rec[5] if packed else rec[0][20]
    assert torch.equal((boxes[2] | (boxes[3] << 16))[:n], bby[:n])
    if packed:
        assert torch.equal((boxes[0] | (boxes[1] << 16))[:n], rec[6][:n])
    return rec, boxes


@pytest.mark.parametrize("path", PATHS + ("span",))
@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_items_cover_only_their_own_box(monkeypatch, scenes, name, path):
    """Every pixel a binned item covers in its tile (the default binning,
    exact or span records) or in its bin's columns (the packed binning:
    the whole tile for the wide bin, 32 columns for a bucket) lies in the
    item's own screen box, as the twin's per-pixel coverage evaluates
    it."""
    # span mode culls more (the fuzz scene rasterizes 726 span quads)
    _assert_items_in_boxes(monkeypatch, scenes[name], path,
                           500 if path == "span" else 1000)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("cam", sorted(S.STRADDLE_CAMERAS))
def test_straddling_items_cover_only_their_own_box(monkeypatch, cam, path):
    """The same on views among the terrain's chunks, where quads straddle
    the near plane and stage A bounds their boxes by the visible part
    (``ops/projection.py`` ``STRADDLE_MARGIN``) instead of the reference's
    whole screen."""
    _assert_items_in_boxes(monkeypatch, S.straddle_scene(cam), path, 250)


def _assert_items_in_boxes(monkeypatch, sc, path, least_items):
    w, h, _ = sc[5]
    packed = path == "packed"
    rec, (x0, x1, y0, y1) = _binned_items(monkeypatch, sc, packed,
                                          span=path == "span")
    records, starts, counts = rec[:3]
    n = int(starts[-1] + counts[-1])
    seg = torch.repeat_interleave(torch.arange(counts.numel()),
                                  counts.long())
    bins = TRP.BINS_PER_TILE if packed else 1
    tile, kind = seg // bins, seg % bins
    tiles_x = w // 128
    ty, tx = tile // tiles_x * 16, tile % tiles_x * 128
    cx0 = tx + torch.where(kind == 0, 0, 32 * (kind - 1))
    width_of = torch.where(kind == 0, 128, 32) if packed else 128
    fl = records[:16].contiguous().view(torch.float32)
    il = records[16:20]
    checked = covered_px = 0
    for a in range(0, n, 256):
        k = torch.arange(a, min(a + 256, n))
        cols = cx0[k][:, None] + torch.arange(128)  # [m, 128]
        in_bin = torch.arange(128)[None] < (width_of[k][:, None] if packed
                                            else 128)
        rows = ty[k][:, None] + torch.arange(16)  # [m, 16]
        nx, ny = raster.pixel_ndc(h, w, rows.float(), cols.float())
        fro = tuple(fl[f, k][:, None, None] for f in range(16))
        iro = tuple(il[f, k][:, None, None] for f in range(4))
        cov, _, _ = raster.eval_row(ny[:, :, None], fro, iro,
                                    raster.eval_bases(nx[:, None, :], fro))
        cov = cov & in_bin[:, None, :] & (rows < h)[:, :, None]
        inside = ((cols[:, None, :] >= x0[k][:, None, None])
                  & (cols[:, None, :] <= x1[k][:, None, None])
                  & (rows[:, :, None] >= y0[k][:, None, None])
                  & (rows[:, :, None] <= y1[k][:, None, None]))
        bad = torch.nonzero(cov & ~inside)
        assert bad.numel() == 0, (a + bad[:4, 0]).tolist()
        checked += len(k)
        covered_px += int(cov.sum())
    assert checked > least_items
    assert covered_px > 5000


# ------------------------------------------------------- split and merge


def _merge(parts, seed=0):
    """Partial frames [(colour i32, depth f32)] in stream order -> one
    frame, merged in a random order by the lexicographic (depth, colour)
    minimum (-0 == +0); among partials with the winning (depth, colour)
    the first in stream order gives the depth's bits."""
    perm = np.random.default_rng(seed).permutation(len(parts))
    colour, depth = parts[perm[0]]
    order = torch.full(colour.shape, int(perm[0]))
    for i in perm[1:]:
        c, d = parts[i]
        take = (d < depth) | ((d == depth) & ((c < colour) | (
            (c == colour) & (int(i) < order))))
        colour = torch.where(take, c, colour)
        depth = torch.where(take, d, depth)
        order = torch.where(take, torch.tensor(int(i)), order)
    return colour, depth


def _slices(starts, counts, size):
    """(starts, counts) of each segment's size-aligned slices in the
    stream, one set of segments per slice rank; empty where a segment has
    no such slice."""
    st, en = starts.long(), (starts + counts).long()
    first = torch.div(st, size, rounding_mode="floor")
    n = torch.where(en > st, torch.div(en - 1, size, rounding_mode="floor")
                    - first + 1, 0)
    out = []
    for r in range(int(n.max())):
        lo = torch.maximum(st, (first + r) * size)
        hi = torch.minimum(en, (first + r + 1) * size)
        keep = r < n
        out.append((torch.where(keep, lo, st).int(),
                    torch.where(keep, hi - lo, 0).int()))
    return out


def _same_bits(a, b):
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


def _check_split_merge(twin, rec, size):
    records, starts, counts = rec[:3]
    full = twin(records, starts, counts, *rec[3:5])
    parts = [twin(records, s, c, *rec[3:5])
             for s, c in _slices(starts, counts, size)]
    assert len(parts) > 2
    assert _same_bits(_merge(parts), full)
    return full


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_split_merge_equals_twin_on_scenes(scenes, name, path):
    """The scene's stream cut into 32-item slices (K4's bucket slices; K2's
    tiles likewise), each slice set through the twin, merged: the full
    twin's frame bit for bit, with ties at equal depth in the scene."""
    sc = scenes[name]
    w, h, gc = sc[5]
    kw = dict(S.torch_step_kw(sc, gc), packed_raster=path == "packed")
    rec = TPL.render_step(*S.torch_args(sc), debug_return_records=True,
                          **kw)
    if path == "packed":
        def twin(*a):
            return TRP.rasterize_packed_plain(*a, height=h, width=w,
                                              out_h=-h % 16 + h)
    else:
        def twin(*a):
            return raster.rasterize_tiles_plain(
                *a, height=h, width=w, tile_h=16, tile_w=128,
                out_h=-h % 16 + h)
    _check_split_merge(twin, rec, 32)


@pytest.mark.parametrize("size", [8, 32, 96])
def test_split_merge_equals_twin_with_signed_zero_ties(size):
    """A synthetic packed tile whose long bucket and wide bin hold ties on
    +0 and -0 (equal depth, equal or different colour), cut into slices of
    ``size`` items and merged: the twin's frame bit for bit, both signs of
    zero in it."""
    args, kw = TS.long_bucket_stream(7)

    def twin(*a):
        return TRP.rasterize_packed_plain(*a, **kw)

    full = _check_split_merge(twin, args, size)
    d = full[1]
    assert bool(((d == 0) & (d.view(torch.int32) < 0)).any())
    assert bool(((d == 0) & (d.view(torch.int32) == 0)).any())


def test_merge_order_decides_signed_zero():
    """The zero's sign is the one thing the stream order decides: merging
    the same 8-item slices with their stream order reversed gives the same
    colours and the same depths by value, but some zeros the wrong sign."""
    args, kw = TS.long_bucket_stream(7)

    def twin(*a):
        return TRP.rasterize_packed_plain(*a, **kw)

    full = twin(*args[:5])
    parts = [twin(args[0], s, c, *args[3:5])
             for s, c in _slices(args[1], args[2], 8)]
    naive = _merge(parts[::-1])
    assert torch.equal(naive[0], full[0]) and torch.equal(naive[1], full[1])
    assert not _same_bits(naive, full)
