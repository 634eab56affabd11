"""Tile binning and kernel K2, the tile raster (csrc/raster.cu).

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/raster.py``:

- ``build_tile_lists`` bins quads to 16x128 tiles as one flat sorted item
  stream (the reference's u32 keys become int64 with explicit 32-bit
  masks; its manual bisection becomes ``torch.searchsorted``);
- the pixel math (``pixel_ndc``, ``eval_bases``, ``eval_row``) and the
  commutative blend rule of ``_blend_one_quad``;
- ``rasterize_tiles`` launches K2 for CUDA tensors and runs its plain twin
  ``rasterize_tiles_plain`` for CPU tensors.  The twin loops over the item
  RANK within a tile, batched over all tiles, so it takes about
  ``max(tile_counts)`` steps of [T, 16, 128] tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from differential_projection_voxel_renderer_tpu.utils.config import SKY_COLOR

F_FIELDS = (
    "a00", "a01", "a02", "a10", "a11", "a12", "a20", "a21", "a22",
    "z0", "z1", "z2", "u0", "u1", "v0", "v1",
)
I_FIELDS = ("color_even", "color_odd", "mask_lo", "mask_hi")
REC_FIELDS = F_FIELDS + I_FIELDS
SKY_I32 = int(np.uint32(SKY_COLOR).astype(np.int32))
U32_MASK = 0xFFFFFFFF

# launches of the CUDA kernel (not of the twin)
launches = 0


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
    big_cap, max_tiles_big, huge_cap = 512, 64, 64
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

    spanx = tx1 - tx0 + 1
    spany = ty1 - ty0 + 1
    ntile_of = spanx * spany
    is_huge = is_big & (ntile_of > max_tiles_big)
    is_bigb = is_big & ~is_huge

    def compact_class(mask, cap):
        # indices of the first `cap` set entries via one flat sort
        ck = torch.sort(torch.where(mask, q, 2**30)).values[:cap]
        ok = ck < 2**30
        return (torch.clamp(ck, max=m - 1).long(), ok,
                mask.sum().to(torch.int32))

    src, bvalid, n_bigb = compact_class(is_bigb, big_cap)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ob_src = _u32(torch.where(bvalid, order6[src], zero)) << shift
    j = torch.arange(max_tiles_big, dtype=torch.int32, device=dev)[:, None]
    bsx = torch.clamp(torch.where(bvalid, spanx[src], 1), min=1)[None, :]
    ty_b = torch.where(bvalid, ty0[src], zero)[None, :] + torch.div(
        j, bsx, rounding_mode="floor")
    tx_b = torch.where(bvalid, tx0[src], zero)[None, :] + j % bsx
    okb = bvalid[None, :] & (j < torch.where(bvalid, ntile_of[src],
                                             zero)[None, :])
    keyb = ((_u32(tid_of(ty_b, tx_b)) << shift_t) | ob_src[None, :]
            | _u32(src)[None, :])
    keys.append(torch.where(okb, keyb & U32_MASK, maxkey).reshape(-1))

    hsrc, hvalid, n_huge = compact_class(is_huge, huge_cap)
    t = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tyg = torch.div(t, tiles_x, rounding_mode="floor")[:, None]
    txg = (t % tiles_x)[:, None]
    one = torch.ones((), dtype=torch.int32, device=dev)
    okh = (hvalid[None, :]
           & (txg >= torch.where(hvalid, tx0[hsrc], one)[None, :])
           & (txg <= torch.where(hvalid, tx1[hsrc], zero)[None, :])
           & (tyg >= torch.where(hvalid, ty0[hsrc], one)[None, :])
           & (tyg <= torch.where(hvalid, ty1[hsrc], zero)[None, :]))
    oh = (_u32(torch.where(hvalid, order6[hsrc], zero)) << shift)[None, :]
    tp_h = _u32(tid_of(tyg[:, 0], txg[:, 0]))[:, None]
    keyh = (tp_h << shift_t) | oh | _u32(hsrc)[None, :]
    keys.append(torch.where(okh, keyh & U32_MASK, maxkey).reshape(-1))
    big_dropped = (torch.clamp(n_bigb - big_cap, min=0)
                   + torch.clamp(n_huge - huge_cap, min=0))

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


def rasterize_tiles_plain(records, tile_starts, tile_counts, octet_rows,
                          octet_zmin, *, height: int, width: int,
                          tile_h: int, tile_w: int, out_h: int):
    """Plain PyTorch twin of K2: the same per-item, per-row blend, looping
    over the item rank within a tile, vectorised over all tiles.  No
    occlusion break (it only skips items that cannot win)."""
    cap, n_tiles = _check_records(
        records, tile_starts, tile_counts, octet_rows, octet_zmin,
        out_h=out_h, width=width, tile_h=tile_h, tile_w=tile_w)
    dev = records.device
    tiles_x = width // tile_w
    fl = records[:16].contiguous().view(torch.float32)
    il = records[16:20]
    t = torch.arange(n_tiles, device=dev)
    ty = torch.div(t, tiles_x, rounding_mode="floor")
    tx = t % tiles_x
    px = (tx[:, None] * tile_w + torch.arange(tile_w, device=dev)).float()
    py = (ty[:, None] * tile_h + torch.arange(tile_h, device=dev)).float()
    nx, ny = pixel_ndc(height, width, py, px)
    nx = nx[:, None, :]            # [T, 1, W]
    ny = ny[:, :, None]            # [T, H, 1]
    ylocal = torch.arange(tile_h, device=dev)[None, :, None]
    depth = torch.full((n_tiles, tile_h, tile_w), float("inf"),
                       dtype=torch.float32, device=dev)
    color = torch.full((n_tiles, tile_h, tile_w), SKY_I32,
                       dtype=torch.int32, device=dev)
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
    tiles_y = out_h // tile_h

    def frame(x):
        return (x.reshape(tiles_y, tiles_x, tile_h, tile_w)
                .permute(0, 2, 1, 3).reshape(out_h, width))

    return frame(color), frame(depth)


def rasterize_tiles(records, tile_starts, tile_counts, octet_rows,
                    octet_zmin, *, height: int, width: int, tile_h: int,
                    tile_w: int, out_h: int):
    """Blend every tile's segment of the binned item stream.

    ``records`` i32[24, cap]: rows 0-15 the f32 blend fields (bitcast),
    16-19 colour_even/odd and mask_lo/hi, 20-23 unused here;
    ``tile_starts``/``tile_counts`` i32[T] (row-major tiles) delimit each
    tile's segment; ``octet_rows`` i32[cap/8] the covered tile-local row
    range (r0 | r1 << 8) of each aligned group of 8 items; ``octet_zmin``
    f32[cap/8] the suffix-min of near depth from each group to the end of
    its tile's segment.  Returns (color i32, depth f32), each
    [out_h, width]; NDC uses the true ``height``."""
    if records.device.type != "cuda":
        return rasterize_tiles_plain(
            records, tile_starts, tile_counts, octet_rows, octet_zmin,
            height=height, width=width, tile_h=tile_h, tile_w=tile_w,
            out_h=out_h)
    global launches
    from .. import _build

    _check_records(records, tile_starts, tile_counts, octet_rows,
                   octet_zmin, out_h=out_h, width=width, tile_h=tile_h,
                   tile_w=tile_w)
    dev = records.device
    ins = [x.contiguous() for x in (records, tile_starts, tile_counts,
                                    octet_rows, octet_zmin)]
    for x, dt in zip(ins, (torch.int32,) * 4 + (torch.float32,)):
        if x.dtype != dt or x.device != dev:
            raise ValueError("rasterize_tiles: wrong dtype or device")
    color = torch.empty((out_h, width), dtype=torch.int32, device=dev)
    depth = torch.empty((out_h, width), dtype=torch.float32, device=dev)
    err = _build.lib().dpvr_rasterize_tiles(
        ins[0].data_ptr(), records.shape[1], ins[1].data_ptr(),
        ins[2].data_ptr(), ins[3].data_ptr(), ins[4].data_ptr(),
        out_h // tile_h, width // tile_w, height, width, color.data_ptr(),
        depth.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rasterize_tiles")
    launches += 1
    return color, depth
