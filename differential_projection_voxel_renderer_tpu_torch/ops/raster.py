"""Tile binning and kernel K2, the tile raster (csrc/raster.cu).

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/raster.py``:

- ``build_tile_lists`` bins quads to 16x128 tiles as one flat sorted item
  stream (the reference's u32 keys become int64 with explicit 32-bit
  masks; its manual bisection becomes ``torch.searchsorted``);
- ``tile_metadata`` turns the binning into K2's inputs (the record gather,
  the octet row ranges and the suffix-min of near depth) with one kernel,
  csrc/tile_meta.cu, for CUDA tensors, and its plain twin
  ``tile_metadata_plain`` (the reference's XLA ops as torch ops) for CPU
  tensors;
- the pixel math (``pixel_ndc``, ``eval_bases``, ``eval_row``) and the
  commutative blend rule of ``_blend_one_quad``;
- ``rasterize_tiles`` launches K2 for CUDA tensors and runs its plain twin
  ``rasterize_tiles_plain`` for CPU tensors.  The twin loops over the item
  RANK within a tile, batched over all tiles, so it takes about
  ``max(tile_counts)`` steps of [T, 16, 128] tensor ops.  Both take the
  reference's init framebuffer (the two-pass far pass blends onto the near
  pass's frame) and ``y0_px`` (a row band keeps global pixel NDC).  Given
  the next frame's stream (``next_geom``, frames in flight) it launches K3
  instead, the raster and the next frame's stage A in one kernel, whose
  plain version is the twin followed by ``geometry.project_cull_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..utils.config import SKY_COLOR
from . import geometry as geom_ops
from . import projection as proj_ops

F_FIELDS = (
    "a00", "a01", "a02", "a10", "a11", "a12", "a20", "a21", "a22",
    "z0", "z1", "z2", "u0", "u1", "v0", "v1",
)
I_FIELDS = ("color_even", "color_odd", "mask_lo", "mask_hi")
REC_FIELDS = F_FIELDS + I_FIELDS
SKY_I32 = int(np.uint32(SKY_COLOR).astype(np.int32))
U32_MASK = 0xFFFFFFFF

# launches of the CUDA kernels K2, K3 and tile_meta (not of their plain
# versions), read from _build's registry
__getattr__ = _build.module_counts(
    {"launches": "K2", "launches_geom": "K3", "launches_meta": "tile_meta"},
    __name__)


def pick_tile(height: int, width: int) -> tuple[int, int]:
    """16x128 tiles always; heights that are not a tile multiple render
    into a padded buffer and are cropped (rendering/pipeline.py)."""
    if width % 128:
        raise ValueError(f"width {width} must be divisible by 128")
    return 16, 128


# ---------------------------------------------------------------- pixel math


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE quotient ``a / b`` for a frame constant ``b``.  The divisor is
    a tensor because on CUDA torch turns a division by a Python scalar into
    a multiplication by its reciprocal, which rounds differently."""
    return a / torch.tensor(b, dtype=torch.float32, device=a.device)


def pixel_ndc(height: int, width: int, py, px):
    """NDC of pixel centres for float pixel coordinates ``py``/``px``
    (reference ``_pixel_ndc``: nx = (2(px+.5) - W)/W, ny = 1 - 2(py+.5)/H)."""
    nx = _div(2.0 * (px + 0.5) - float(width), float(width))
    ny = 1.0 - _div(2.0 * (py + 0.5), float(height))
    return nx, ny


def eval_bases(nx, fro):
    """Row-invariant column products a00*nx, a10*nx, a20*nx, z0*nx."""
    return (fro[0] * nx, fro[3] * nx, fro[6] * nx, fro[9] * nx)


def eval_row(ny, fro, iro, bases):
    """Coverage, planar depth and texel colour at row NDC ``ny`` given the
    column products (reference ``_eval_one_quad_row``); ``covered``
    already excludes NaN depth."""
    (_a00, a01, a02, _a10, a11, a12, _a20, a21, a22,
     _z0, z1, z2, u0, u1, v0, v1) = fro
    color_even, color_odd, mask_lo, mask_hi = iro
    base_u, base_v, base_w, base_z = bases
    qu = base_u + a01 * ny + a02
    qv = base_v + a11 * ny + a12
    qw = base_w + a21 * ny + a22
    z = base_z + z1 * ny + z2
    covered = ((qw > 0.0) & (qu >= u0 * qw) & (qu <= u1 * qw)
               & (qv >= v0 * qw) & (qv <= v1 * qw) & (z == z))
    inv = torch.reciprocal(qw)
    tu = ((qu * inv) * 8.0).to(torch.int32) & 7
    tv = ((qv * inv) * 8.0).to(torch.int32) & 7
    idx = tv * 8 + tu
    word = torch.where(idx < 32, mask_lo, mask_hi)
    bit = (word >> (idx & 31)) & 1
    return covered, z, torch.where(bit != 0, color_odd, color_even)


def blend(covered, z, c, color, depth):
    """The commutative lexicographic (depth, colour) min
    (reference ``_blend_one_quad``)."""
    ok = covered & ((z < depth) | ((z == depth) & (c < color)))
    return torch.where(ok, c, color), torch.where(ok, z, depth)


# ---------------------------------------------------------------- binning


def _u32(x):
    return x.to(torch.int64) & U32_MASK


# quads over more than 2x2 tiles binned a frame: the first BIG_CAP of
# those over at most MAX_TILES_BIG tiles, the first HUGE_CAP of those over
# more, in stream order; the rest are dropped and count in bin_overflow.  A
# deliberate divergence: the reference's BIG_CAP is 512, which drops
# visible quads on the 1280x720 view-distance-12 flythrough, serial and
# resident, so that their frames differ (benches/big_quad_cap.py prints
# the drops and the pixels they change); at 1024 and 2048 the serial
# flight drops none and the two agree.  At the step's shapes 2048 pads
# the key sort to the same power of two as 1024 does.  HUGE_CAP is the
# reference's: stage A bounds the boxes of quads that straddle the near
# plane (ops/projection.py STRADDLE_MARGIN), which the reference boxes as
# the whole screen, so that the class holds the few quads that do cover
# most of the screen.  The packed binning (ops/raster_packed.py) keeps the
# same classes
BIG_CAP, HUGE_CAP, MAX_TILES_BIG = 2048, 64, 64


@functools.lru_cache(maxsize=None)
def _class_blocks(shapes, m: int, device):
    """For classes of (cap, rows) ``shapes`` over ``m`` quads: the
    compaction's targets 1..C (C the largest cap), i64[classes, C]; each
    class's first index in the classes' masks laid end to end,
    i64[classes, 1]; the caps, i64[classes]; and for the classes' [rows,
    cap] blocks flattened one after another, each element's row (i32) and
    its index into the flattened [classes, C] compaction (i64).  Made once
    a device and shape: a copy from the host inside the step could not be
    captured in a CUDA graph."""
    width = max(cap for cap, _ in shapes)
    rows_of, cols = [], []
    for c, (cap, rows) in enumerate(shapes):
        k = torch.arange(rows * cap, device=device)
        rows_of.append(torch.div(k, cap, rounding_mode="floor").int())
        cols.append(c * width + k % cap)
    n = len(shapes)
    targets = torch.arange(1, width + 1, device=device).repeat(n, 1)
    base = torch.arange(n, device=device)[:, None] * m
    caps = proj_ops.device_constant(
        torch.tensor([cap for cap, _ in shapes]), device)
    return targets, base, caps, torch.cat(rows_of), torch.cat(cols)


def big_quad_tiles(classes, tx0, ty0, spanx, ntile):
    """The big quads a frame bins: for each (mask, cap, rows) of
    ``classes`` the first ``cap`` quads of ``mask`` (bool[m]) by stream
    index, each over the tiles of its box (``tx0``, ``ty0``, ``spanx``
    tiles a row, ``ntile`` in all) enumerated row-major down the rows of a
    [rows, cap] block.  Returns the blocks flattened one after another --
    (src i64, ty and tx i32, ok bool where the element holds one of its
    quad's tiles) --, the quads dropped past the caps, and each class's
    quads, kept or not (i64[classes]).  One scan runs
    over the masks laid end to end (a scan along the rows of [classes, m]
    takes a slow kernel on the card)."""
    m = tx0.shape[0]
    targets, base, caps, j, col = _class_blocks(
        tuple((cap, rows) for _, cap, rows in classes), m, tx0.device)
    csum = torch.cumsum(torch.cat([mask for mask, _, _ in classes]), 0)
    ends = csum[m - 1::m]
    before = torch.cat([ends.new_zeros(1), ends[:-1]])
    n_cls = (ends - before)[:, None]
    pos = torch.searchsorted(csum, targets + before[:, None])
    src = torch.clamp(pos - base, max=m - 1).view(-1)[col]
    valid = (targets <= n_cls).view(-1)[col]
    sx = torch.where(valid, spanx[src], 1)
    ty = ty0[src] + torch.div(j, sx, rounding_mode="floor")
    tx = tx0[src] + j % sx
    ok = valid & (j < torch.where(valid, ntile[src], 0))
    n_cls = n_cls[:, 0]
    return src, ty, tx, ok, torch.clamp(n_cls - caps, min=0).sum(), n_cls


def build_tile_lists(tilebox, count, order6, order6_dy1, *, tiles_y: int,
                     tiles_x: int, item_cap: int, valid=None):
    """Bin quads to tiles as one flat item stream ordered by (tile, order6,
    quad); ``order6_dy1`` orders a quad's second tile row.  The stream is
    ``q < count``, or ``valid`` when given.  Returns (items i32[item_cap],
    t_of_item i32[item_cap], starts i32[T], counts i32[T], overflow i32)
    exactly as the reference's ``build_tile_lists`` (row-major tile ids;
    no ``tile_perm``)."""
    dev = tilebox.device
    m = tilebox.shape[0]
    shift = max(1, (m - 1).bit_length())
    n_tiles = tiles_y * tiles_x
    shift_t = shift + 6
    assert n_tiles << shift_t < 2**32, "tile/quad key would overflow u32"
    maxkey = U32_MASK

    def tid_of(ty, tx):
        return ty * tiles_x + tx

    q = torch.arange(m, dtype=torch.int32, device=dev)
    in_count = (q < count) if valid is None else valid
    tx0 = tilebox & 0xFF
    tx1 = (tilebox >> 8) & 0xFF
    ty0 = (tilebox >> 16) & 0xFF
    ty1 = (tilebox >> 24) & 0xFF
    nonempty = in_count & (tx0 <= tx1) & (ty0 <= ty1)
    small = nonempty & (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1)
    is_big = nonempty & ~small

    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            tx = tx0 + dx
            ty = ty0 + dy
            ok = small & (tx <= tx1) & (ty <= ty1)
            obits = _u32(order6 if dy == 0 else order6_dy1) << shift
            key = (_u32(tid_of(ty, tx)) << shift_t) | obits | _u32(q)
            keys.append(torch.where(ok, key & U32_MASK, maxkey))

    # the big quads by class, each over the tiles of its box (keys of
    # values below 2**32, as the assert above bounds them)
    spanx = tx1 - tx0 + 1
    ntile_of = spanx * (ty1 - ty0 + 1)
    is_huge = is_big & (ntile_of > MAX_TILES_BIG)
    src, ty_b, tx_b, okb, big_dropped, _ = big_quad_tiles(
        ((is_big & ~is_huge, BIG_CAP, MAX_TILES_BIG),
         (is_huge, HUGE_CAP, n_tiles)), tx0, ty0, spanx, ntile_of)
    keyb = ((tid_of(ty_b, tx_b).long() << shift_t)
            | (order6[src].long() << shift) | src)
    keys.append(torch.where(okb, keyb, maxkey))

    raw = torch.cat(keys)
    n_raw = raw.shape[0]
    pow2 = 1 << (n_raw - 1).bit_length()
    if pow2 != n_raw:
        raw = torch.cat([raw, torch.full((pow2 - n_raw,), maxkey,
                                         dtype=torch.int64, device=dev)])
    skeys = torch.sort(raw).values
    prefixes = torch.arange(n_tiles + 1, dtype=torch.int64,
                            device=dev) << shift_t
    bounds = torch.searchsorted(skeys, prefixes, side="left").to(torch.int32)
    starts = bounds[:-1]
    total = bounds[-1]
    kept_end = torch.clamp(bounds[1:], max=item_cap)
    kept_start = torch.clamp(starts, max=item_cap)
    counts = kept_end - kept_start
    overflow = (torch.clamp(total - item_cap, min=0)
                + big_dropped).to(torch.int32)

    mask = (torch.arange(item_cap, device=dev)
            < torch.clamp(total, max=item_cap))
    head = skeys[:item_cap]
    items = torch.where(mask, head & ((1 << shift) - 1), 0).to(torch.int32)
    t_of_item = torch.where(mask, head >> shift_t, 0).to(torch.int32)
    return items, t_of_item, kept_start, counts, overflow


# ---------------------------------------------------------------- metadata


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def tile_metadata_plain(all22, flat, t_of_item, tile_starts, tile_counts, *,
                        tiles_y: int, tiles_x: int, tile_h: int):
    """Plain PyTorch twin of the tile_meta kernel (``tile_metadata``)."""
    dev = all22.device
    i32 = torch.int32
    g22 = all22[:, flat.long()]

    # covered tile-local row range per item -> per-octet bounds
    tpy0 = (t_of_item // tiles_x) * tile_h
    bby_g = g22[20]
    ly0 = torch.clamp((bby_g & 0xFFFF) - tpy0, 0, tile_h - 1)
    ly1 = torch.clamp((bby_g >> 16) - tpy0, 0, tile_h - 1)
    n_items = flat.shape[0]
    n_oct = n_items // 8
    octet_rows = (ly0.view(n_oct, 8).amin(1)
                  | (ly1.view(n_oct, 8).amax(1) << 8))
    # suffix-min of near depth to the end of each tile's segment as one
    # reverse cummin over a packed (tile, order-mapped depth) u32 key; the
    # depth is floor-quantized by the tile bits, a lower bound, so the
    # occlusion break stays conservative
    n_kept = tile_starts[-1] + tile_counts[-1]
    bits_t = max(1, (tiles_y * tiles_x).bit_length())
    dn_u = g22[21].long() & U32_MASK
    omap = dn_u ^ torch.where((dn_u >> 31) != 0, U32_MASK, 1 << 31)
    packed_key = (((t_of_item.long() << (32 - bits_t)) | (omap >> bits_t))
                  & U32_MASK)
    packed_key = torch.where(
        torch.arange(n_items, device=dev) < n_kept, packed_key, U32_MASK)
    sfx = torch.cummin(packed_key.flip(0), 0).values.flip(0)
    zq = (sfx << bits_t) & U32_MASK
    zbits = torch.where((zq >> 31) != 0, zq ^ (1 << 31), ~zq & U32_MASK)
    octet_zmin = u32_as_i32(zbits).view(torch.float32).view(n_oct, 8)[:, 0]
    records = torch.cat([g22, torch.zeros((2, n_items), dtype=i32,
                                          device=dev)])
    return records, octet_rows, octet_zmin


def tile_metadata(all22, flat, t_of_item, tile_starts, tile_counts, *,
                  tiles_y: int, tiles_x: int, tile_h: int):
    """The tile raster's inputs from the default binning (the step's stage
    5): ``all22`` i32[22, rc], the per-quad rows that cross the binning
    (the 16 blend fields' bits, the four colour/mask words, bby, near depth
    bits), gathered by ``build_tile_lists``' items ``flat`` i32[n_items]
    (n_items a multiple of 8) with their tiles ``t_of_item`` and the tiles'
    segments ``tile_starts``/``tile_counts`` i32[tiles_y * tiles_x].

    Returns (records i32[24, n_items]: the gathered rows, then two zero
    rows; octet_rows i32[n_items / 8]: each aligned group of 8 items' least
    first and greatest last covered row, local to each item's own tile
    (r0 | r1 << 8); octet_zmin f32[n_items / 8]: the least near depth from
    each group's first item to the end of its tile's segment, its order-
    mapped bits floor-quantized by the tile id's bit length; past the kept
    items, that quantization of the key U32).

    CUDA tensors go to the tile_meta kernel (csrc/tile_meta.cu, one launch
    counted as ``launches_meta``), which raises on inputs it does not take;
    CPU tensors to ``tile_metadata_plain``.  The two agree bit for bit."""
    if all22.device.type != "cuda":
        return tile_metadata_plain(
            all22, flat, t_of_item, tile_starts, tile_counts,
            tiles_y=tiles_y, tiles_x=tiles_x, tile_h=tile_h)
    dev = all22.device
    n_tiles = tiles_y * tiles_x
    ins = (all22, flat, t_of_item, tile_starts, tile_counts)
    if any(x.dtype != torch.int32 or x.device != dev or not x.is_contiguous()
           for x in ins):
        raise ValueError("tile_metadata: inputs must be contiguous int32 "
                         "tensors on one device")
    n_items = flat.shape[0]
    if (all22.dim() != 2 or all22.shape[0] != 22 or all22.shape[1] < 1
            or flat.dim() != 1 or t_of_item.shape != flat.shape
            or n_items % 8):
        raise ValueError("tile_metadata: all22 must be i32[22, rc] and "
                         "flat/t_of_item i32[n_items], n_items % 8 == 0")
    if (min(tiles_y, tiles_x, tile_h) < 1
            or tile_starts.shape != (n_tiles,)
            or tile_counts.shape != (n_tiles,)):
        raise ValueError("tile_metadata: tile_starts/tile_counts must be "
                         "i32[tiles_y * tiles_x]")
    n_oct = n_items // 8
    # one buffer for the three outputs
    out = torch.empty(24 * n_items + 2 * n_oct, dtype=torch.int32,
                      device=dev)
    records = out[:24 * n_items].view(24, n_items)
    octet_rows = out[24 * n_items:24 * n_items + n_oct]
    octet_zmin = out[24 * n_items + n_oct:].view(torch.float32)
    _build.launch(
        "dpvr_tile_meta", dev.index, "tile_metadata", all22.data_ptr(),
        all22.shape[1], flat.data_ptr(), t_of_item.data_ptr(),
        tile_starts.data_ptr(), tile_counts.data_ptr(), tiles_y, tiles_x,
        tile_h, n_items, records.data_ptr(), octet_rows.data_ptr(),
        octet_zmin.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.count("tile_meta", dev.index)
    return records, octet_rows, octet_zmin


# ---------------------------------------------------------------- K2


def _check_records(records, tile_starts, tile_counts, octet_rows,
                   octet_zmin, *, out_h, width, tile_h, tile_w):
    if tile_h != 16 or tile_w != 128:
        raise ValueError("the tile raster takes 16x128 tiles")
    if out_h % tile_h or width % tile_w:
        raise ValueError(f"frame {out_h}x{width} is not a tile multiple")
    cap = records.shape[1]
    n_tiles = (out_h // tile_h) * (width // tile_w)
    if (records.shape[0] != 24 or records.dtype != torch.int32
            or cap % 8):
        raise ValueError("records must be i32[24, cap] with cap % 8 == 0")
    if tile_starts.shape != (n_tiles,) or tile_counts.shape != (n_tiles,):
        raise ValueError("tile_starts/tile_counts must be i32[T]")
    if octet_rows.shape != (cap // 8,) or octet_zmin.shape != (cap // 8,):
        raise ValueError("octet_rows/octet_zmin must have cap // 8 entries")
    return cap, n_tiles


def kernel_inputs(name, records, starts, counts, rows, octet_zmin):
    """The raster inputs as contiguous tensors of a kernel's types (int32,
    octet_zmin float32) on the records' device; raises otherwise.  ``rows``
    is the int32 row input: octet_rows, or K4's item_bby."""
    ins = [x.contiguous() for x in (records, starts, counts, rows,
                                    octet_zmin)]
    for x, dt in zip(ins, (torch.int32,) * 4 + (torch.float32,)):
        if x.dtype != dt or x.device != records.device:
            raise ValueError(f"{name}: wrong dtype or device")
    return ins


def _check_init(init_color, init_depth, *, out_h, width, device):
    """The init frame: both or neither, i32 and f32 [out_h, width] on the
    records' device.  Returns them contiguous, or (None, None)."""
    if init_color is None and init_depth is None:
        return None, None
    if init_color is None or init_depth is None:
        raise ValueError("init_color and init_depth go together")
    for x, dt in ((init_color, torch.int32), (init_depth, torch.float32)):
        if (x.dtype != dt or x.shape != (out_h, width)
                or x.device != device):
            raise ValueError(f"init frame must be {dt}[{out_h}, {width}] on "
                             f"the records' device")
    return init_color.contiguous(), init_depth.contiguous()


def rasterize_tiles_plain(records, tile_starts, tile_counts, octet_rows,
                          octet_zmin, *, height: int, width: int,
                          tile_h: int, tile_w: int, out_h: int,
                          init_color=None, init_depth=None, y0_px: int = 0):
    """Plain PyTorch twin of K2: the same per-item, per-row blend, looping
    over the item rank within a tile, vectorised over all tiles.  No
    occlusion break (it only skips items that cannot win)."""
    cap, n_tiles = _check_records(
        records, tile_starts, tile_counts, octet_rows, octet_zmin,
        out_h=out_h, width=width, tile_h=tile_h, tile_w=tile_w)
    dev = records.device
    init_color, init_depth = _check_init(init_color, init_depth,
                                         out_h=out_h, width=width, device=dev)
    tiles_x = width // tile_w
    tiles_y = out_h // tile_h
    fl = records[:16].contiguous().view(torch.float32)
    il = records[16:20]
    t = torch.arange(n_tiles, device=dev)
    ty = torch.div(t, tiles_x, rounding_mode="floor")
    tx = t % tiles_x
    px = (tx[:, None] * tile_w + torch.arange(tile_w, device=dev)).float()
    # the global pixel row, in integers before the float conversion
    py = (int(y0_px) + ty[:, None] * tile_h
          + torch.arange(tile_h, device=dev)).float()
    nx, ny = pixel_ndc(height, width, py, px)
    nx = nx[:, None, :]            # [T, 1, W]
    ny = ny[:, :, None]            # [T, H, 1]
    ylocal = torch.arange(tile_h, device=dev)[None, :, None]

    def tiles(x):
        return (x.reshape(tiles_y, tile_h, tiles_x, tile_w)
                .permute(0, 2, 1, 3).reshape(n_tiles, tile_h, tile_w))

    if init_color is None:
        depth = torch.full((n_tiles, tile_h, tile_w), float("inf"),
                           dtype=torch.float32, device=dev)
        color = torch.full((n_tiles, tile_h, tile_w), SKY_I32,
                           dtype=torch.int32, device=dev)
    else:
        depth, color = tiles(init_depth), tiles(init_color)
    starts = tile_starts.long()
    counts = tile_counts.long()
    n_steps = int(counts.max()) if n_tiles else 0
    for r in range(n_steps):
        active = r < counts
        k = torch.clamp(starts + r, max=cap - 1)
        fro = tuple(fl[f, k][:, None, None] for f in range(16))
        iro = tuple(il[f, k][:, None, None] for f in range(4))
        rows = octet_rows[k >> 3]
        r0 = (rows & 0xFF)[:, None, None]
        r1 = (rows >> 8)[:, None, None]
        in_rows = active[:, None, None] & (ylocal >= r0) & (ylocal <= r1)
        covered, z, c = eval_row(ny, fro, iro, eval_bases(nx, fro))
        color, depth = blend(covered & in_rows, z, c, color, depth)

    def frame(x):
        return (x.reshape(tiles_y, tiles_x, tile_h, tile_w)
                .permute(0, 2, 1, 3).reshape(out_h, width))

    return frame(color), frame(depth)


def rasterize_tiles(records, tile_starts, tile_counts, octet_rows,
                    octet_zmin, *, height: int, width: int, tile_h: int,
                    tile_w: int, out_h: int, init_color=None,
                    init_depth=None, y0_px: int = 0, next_geom=None,
                    backface_culling: bool = True):
    """Blend every tile's segment of the binned item stream.

    ``records`` i32[24, cap]: rows 0-15 the f32 blend fields (bitcast),
    16-19 colour_even/odd and mask_lo/hi, 20 the item's screen rows (bby,
    y0 | y1 << 16: K2 evaluates an item on its own rows, the plain version
    on its octet's, the same frame since no item covers a pixel outside its
    own box), 21-23 unused here;
    ``tile_starts``/``tile_counts`` i32[T] (row-major tiles) delimit each
    tile's segment; ``octet_rows`` i32[cap/8] the covered tile-local row
    range (r0 | r1 << 8) of each aligned group of 8 items; ``octet_zmin``
    f32[cap/8] the suffix-min of near depth from each group to the end of
    its tile's segment.  Returns (color i32, depth f32), each
    [out_h, width]; NDC uses the true ``height``.  The rows past the
    frame's (or band's) own are padding that the step crops: K2 evaluates
    each item on its own box, clamped to the frame (or band), and leaves
    them as they started; the twin, like the reference's kernel, evaluates
    an item on its octet's rows, and an octet that straddles the end of a
    tile's segment takes the rows of the next tile's items (or of the
    stream's padding entries), so it may write them.

    ``init_color`` i32 / ``init_depth`` f32 [out_h, width] (both or
    neither): the frame every tile starts from instead of SKY/+inf (the
    reference's init framebuffer).  ``y0_px``: the global pixel row of the
    output's first row (the reference's band offset); pixel NDC uses
    ``y0_px + row`` while the records' rows and the output stay
    buffer-local.

    ``next_geom`` (frames in flight) = (quads2 i32[GQ2], quad_world2
    f32[3, GQ2], n2, view_proj2 f32[4, 4], cam_pos2 f32[3]), the next
    frame's stream and camera: its stage A (at this frame's width and
    height, ``backface_culling``) runs in the same call -- kernel K3 on the
    card -- and a third output is ``geometry.project_cull``'s dict on it."""
    if next_geom is not None and (init_color is not None or y0_px):
        raise ValueError("next_geom runs with neither an init frame nor a "
                         "band offset (frames in flight exclude both)")
    if records.device.type != "cuda":
        color, depth = rasterize_tiles_plain(
            records, tile_starts, tile_counts, octet_rows, octet_zmin,
            height=height, width=width, tile_h=tile_h, tile_w=tile_w,
            out_h=out_h, init_color=init_color, init_depth=init_depth,
            y0_px=y0_px)
        if next_geom is None:
            return color, depth
        return color, depth, geom_ops.project_cull_plain(
            *next_geom, width=width, height=height,
            backface_culling=backface_culling)
    _check_records(records, tile_starts, tile_counts, octet_rows,
                   octet_zmin, out_h=out_h, width=width, tile_h=tile_h,
                   tile_w=tile_w)
    dev = records.device
    ins = kernel_inputs("rasterize_tiles", records, tile_starts, tile_counts,
                        octet_rows, octet_zmin)
    init_color, init_depth = _check_init(init_color, init_depth,
                                         out_h=out_h, width=width, device=dev)
    # fresh outputs: the kernel's pointers are __restrict__, so the init
    # frame is never the output
    color = torch.empty((out_h, width), dtype=torch.int32, device=dev)
    depth = torch.empty((out_h, width), dtype=torch.float32, device=dev)
    # the kernel reads each item's own rows (record row 20, bby) instead of
    # octet_rows, which only the plain version reads
    raster_args = (
        ins[0].data_ptr(), records.shape[1], ins[1].data_ptr(),
        ins[2].data_ptr(), ins[4].data_ptr(), out_h // tile_h,
        width // tile_w, height, width, color.data_ptr(), depth.data_ptr(),
        None if init_color is None else init_color.data_ptr(),
        None if init_depth is None else init_depth.data_ptr(), int(y0_px))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if next_geom is None:
        _build.launch(
            "dpvr_rasterize_tiles", dev.index, "rasterize_tiles",
            *raster_args, *(None,) * 5, 0, int(backface_culling),
            *(None,) * 6, stream)
        _build.count("K2", dev.index)
        return color, depth
    quads2, qw2, n2, vp2, cp2 = next_geom
    if quads2.device != dev:
        raise ValueError("rasterize_tiles: next_geom on another device")
    n2 = geom_ops.device_i32(n2, dev)
    gin = geom_ops.kernel_args(quads2, qw2, n2, vp2, cp2)
    geom = geom_ops.kernel_outputs(quads2.shape[0], dev)
    _build.launch(
        "dpvr_rasterize_tiles", dev.index, "rasterize_tiles (K3)",
        *raster_args, *gin, quads2.shape[0], int(backface_culling),
        *geom_ops.output_ptrs(geom), stream)
    _build.count("K3", dev.index)
    return color, depth, geom
