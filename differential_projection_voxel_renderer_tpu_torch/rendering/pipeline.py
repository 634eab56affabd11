"""The per-frame device render step and the Renderer, in PyTorch.

Counterpart of the production branch of
``differential_projection_voxel_renderer_tpu/rendering/pipeline.py``:

0. uploads   -- the draw list expands on the device into the quad stream
                (``_expand_uploads_impl``: a repeat plus one flat pool
                gather), cached by the engine while the draw list holds
1. stage A   -- kernel K1 (ops/geometry.project_cull)
2. compact   -- skipped when the stream fits the render cap, else one sort
                of validity-masked indices and a gather
3. coeffs    -- ops/projection.quad_coefficients, stacked with the binning
                metadata into one i32[22, rc] array
4. bin       -- ops/raster.build_tile_lists, order "42" (4 bits of
                log-quantized near depth, 2 bits of covered-row band)
5. metadata  -- per-octet row ranges and the packed-key suffix-min of near
                depth (the occlusion-break key)
6. raster    -- kernel K2 (ops/raster.rasterize_tiles), then the crop

PyTorch runs eagerly, so there is no jit and no trace-time knob: the
capacity buckets only size the tensors.  Capacities are static, so a step
makes no host sync; ``n_quads``, the counts and the totals stay on the
device.  Where JAX's immutable arrays forced a copy, the port updates the
quad pool in place (``apply_insert_payload``).
"""

from __future__ import annotations

import numpy as np
import torch

from differential_projection_voxel_renderer_tpu.ops.shading import (
    build_quad_color_tables,
)
from differential_projection_voxel_renderer_tpu.ops.texture import TextureAtlas
from differential_projection_voxel_renderer_tpu.utils.config import (
    RenderConfig,
)

from ..ops import geometry as geom_ops
from ..ops import projection as proj_ops
from ..ops import raster as raster_ops

U32 = raster_ops.U32_MASK


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def render_step(quads, quad_world, n_quads, view_proj, cam_pos, *,
                color_tables, width: int, height: int, tile_h: int,
                tile_w: int, render_cap: int,
                backface_culling: bool = True, tile_k_cap: int = 8192,
                debug_return_records: bool = False):
    """One frame from the gathered stream: ``quads`` i32[GQ] words,
    ``quad_world`` f32[3, GQ], ``n_quads`` i32 scalar, ``view_proj``
    f32[4, 4], ``cam_pos`` f32[3] (all on one device); ``color_tables``
    from ops/projection.color_table_tensors.  Returns (color i32[H, W],
    depth f32[H, W], stats i32[6] = [gathered, rasterized, overflow,
    bin_overflow, subpixel_culled, 0]).  ``debug_return_records`` returns
    the raster's inputs (records, tile_starts, tile_counts, octet_rows,
    octet_zmin) instead."""
    dev = quads.device
    gq = quads.shape[0]
    i32 = torch.int32
    n_quads = geom_ops.device_i32(n_quads, dev)

    ga = geom_ops.project_cull(quads, quad_world, n_quads, view_proj,
                               cam_pos, width=width, height=height,
                               backface_culling=backface_culling)
    valid_a, bbx_a, bby_a, dn_a = (ga["valid"], ga["bbx"], ga["bby"],
                                   ga["depth_near"])
    subpix_total = ga["subpixel"].sum(dtype=i32)
    count = valid_a.sum(dtype=i32)

    out_h = -height % tile_h + height  # pad to a tile multiple
    tiles_y, tiles_x = out_h // tile_h, width // tile_w
    rc = min(gq, render_cap)
    if gq <= rc:
        # no compaction: the binner takes the raw stream with its mask
        count_c = count
        overflow = torch.zeros((), dtype=i32, device=dev)
        quads_c, wq_c = quads, quad_world
        bbx_c, bby_c, dn_c = bbx_a, bby_a, dn_a
        valid_c = valid_a
    else:
        stream_q = torch.arange(gq, dtype=i32, device=dev)
        idx = torch.sort(torch.where(valid_a, stream_q, 2**30)).values[:rc]
        idx = torch.clamp(idx, max=gq - 1).long()
        quads_c, wq_c = quads[idx], quad_world[:, idx]
        bbx_c, bby_c, dn_c = bbx_a[idx], bby_a[idx], dn_a[idx]
        overflow = torch.clamp(count - rc, min=0)
        count_c = torch.clamp(count, max=rc)
        valid_c = None

    coeffs = proj_ops.quad_coefficients(
        quads_c, (wq_c[0], wq_c[1], wq_c[2]), view_proj, color_tables)
    # every per-item row that crosses the binning, as one i32[22, rc]
    all22 = torch.stack(
        [coeffs[k].view(i32) for k in raster_ops.F_FIELDS]
        + [coeffs[k] for k in raster_ops.I_FIELDS]
        + [bby_c, dn_c.view(i32)])

    tilebox = proj_ops.pack_tilebox(
        bbx_c & 0xFFFF, bbx_c >> 16, bby_c & 0xFFFF, bby_c >> 16,
        tile_h=tile_h, tile_w=tile_w)
    # within-tile order "42": 4 bits of log-quantized near depth (drives
    # the occlusion break), 2 bits of the covered 4-row band
    dq4 = torch.clamp(
        (-torch.log2(torch.clamp(1.0 - dn_c, min=1e-9))).to(i32), 0, 15)
    y0_c = bby_c & 0xFFFF
    ly0_c = torch.clamp(y0_c - (y0_c // tile_h) * tile_h, 0, tile_h - 1)
    band = torch.clamp(ly0_c >> 2, max=3)
    flat, t_of_item, tile_starts, tile_counts, bin_overflow = (
        raster_ops.build_tile_lists(
            tilebox, count_c, (dq4 << 2) | band, dq4 << 2, tiles_y=tiles_y,
            tiles_x=tiles_x, item_cap=tile_k_cap, valid=valid_c))
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
    dn_u = g22[21].long() & U32
    omap = dn_u ^ torch.where((dn_u >> 31) != 0, U32, 1 << 31)
    packed_key = (((t_of_item.long() << (32 - bits_t)) | (omap >> bits_t))
                  & U32)
    packed_key = torch.where(
        torch.arange(n_items, device=dev) < n_kept, packed_key, U32)
    sfx = torch.cummin(packed_key.flip(0), 0).values.flip(0)
    zq = (sfx << bits_t) & U32
    zbits = torch.where((zq >> 31) != 0, zq ^ (1 << 31), ~zq & U32)
    octet_zmin = _to_i32(zbits).view(torch.float32).view(n_oct, 8)[:, 0]
    records = torch.cat([g22, torch.zeros((2, n_items), dtype=i32,
                                          device=dev)])
    if debug_return_records:
        return records, tile_starts, tile_counts, octet_rows, octet_zmin

    color, depth = raster_ops.rasterize_tiles(
        records, tile_starts, tile_counts, octet_rows, octet_zmin,
        height=height, width=width, tile_h=tile_h, tile_w=tile_w,
        out_h=out_h)
    if out_h != height:
        color, depth = color[:height], depth[:height]
    stats = torch.stack([n_quads, count, overflow, bin_overflow,
                         subpix_total, torch.zeros((), dtype=i32,
                                                   device=dev)])
    return color, depth, stats


# ----------------------------------------------------------- draw lists


def _expand_uploads_impl(quad_pool, slots_sel, counts6_sel, mask6_sel,
                         positions_sel, gather_cap: int):
    """Draw list -> the flat quad stream + per-quad world origins.

    Each (chunk, face direction) is one expansion unit of length
    counts * mask.  The reference's ``jnp.repeat(total_repeat_length=)``
    truncates past ``gather_cap`` and pads by repeating the LAST unit;
    ``repeat_interleave(output_size=)`` wants the exact sum, so the units
    are clipped to the cap and one dummy unit (the last index) carries the
    remainder.  Returns (quads i32[cap], quad_world f32[3, cap],
    total i32)."""
    dev = quad_pool.device
    nv = slots_sel.shape[0]
    counts6_sel = counts6_sel.long()
    lens = (counts6_sel * mask6_sel.long()).reshape(nv * 6)
    row_start = (torch.cumsum(counts6_sel, 1) - counts6_sel).reshape(nv * 6)
    starts_flat = torch.cumsum(lens, 0) - lens
    kept = torch.minimum(lens, torch.clamp(gather_cap - starts_flat, min=0))
    units = torch.arange(nv * 6 + 1, device=dev)
    units[-1] = nv * 6 - 1
    reps = torch.cat([kept, (gather_cap - kept.sum()).reshape(1)])
    unit = torch.repeat_interleave(units, reps, output_size=gather_cap)
    ci = unit // 6
    slot_of = slots_sel.long()[ci]
    within = torch.arange(gather_cap, device=dev) - starts_flat[unit]
    row_idx = row_start[unit] + within
    qcap = quad_pool.shape[1]
    quads = quad_pool.reshape(-1)[slot_of * qcap
                                  + torch.clamp(row_idx, 0, qcap - 1)]
    wq = torch.stack([(positions_sel[:, a].float() * 32.0)[ci]
                      for a in range(3)])
    return quads, wq, lens.sum().to(torch.int32)


def _truncate_units(counts6, mask6, cap):
    """Clip masked unit lengths so the stream fits ``cap``; suffix units
    lose quads first.  Returns (counts6_upload, total)."""
    lens = (counts6 * mask6).reshape(-1)
    cum = np.cumsum(lens)
    keep = np.minimum(lens, np.maximum(cap - (cum - lens), 0))
    c6u = counts6.reshape(-1).copy()
    m = mask6.reshape(-1).astype(bool)
    c6u[m] = keep[m]
    return c6u.reshape(counts6.shape), int(keep.sum())


def _c6_of(vals, counts):
    """Per-face-direction histogram i32[k, 6] of packed quad rows."""
    k, mc = vals.shape
    j = torch.arange(mc, device=vals.device)[None, :]
    d = (vals >> 29) & 7
    ok = j < counts[:, None]
    return torch.stack([((d == i) & ok).sum(1) for i in range(6)],
                       dim=1).to(torch.int32)


def apply_insert_payload(pool, c6pool, packed, *, k: int, mc: int):
    """Rebuild [k, mc] rows from the flat payload (slots | starts | counts
    header, then the quad words, all i32 bits) and scatter them into the
    pool and its counts6 mirror IN PLACE.  Padding entries duplicate entry
    0 with identical rows, so the duplicate-index write is harmless.
    Returns (pool, c6pool)."""
    slots = packed[:k].long()
    starts = packed[k:2 * k].long()
    counts = packed[2 * k:3 * k]
    flat = packed[3 * k:]
    j = torch.arange(mc, device=packed.device)[None, :]
    idx = torch.clamp(starts[:, None] + j, 0, flat.shape[0] - 1)
    vals = torch.where(j < counts[:, None], flat[idx], 0)
    full = torch.zeros((k, pool.shape[1]), dtype=pool.dtype,
                       device=pool.device)
    full[:, :mc] = vals
    pool[slots] = full
    c6pool[slots] = _c6_of(vals, counts)
    return pool, c6pool


META_SHORTS = 11   # slots | counts6 | dir-mask bits | positions, per chunk
META5_SHORTS = 5   # slots | dir-mask bits | positions (counts6 from the
                   # pool's device mirror, QuadPool.counts6_dev)


def _pack_cam(view_proj, cam_pos) -> np.ndarray:
    out = np.empty(19, np.float32)
    out[:16] = np.asarray(view_proj, np.float32).ravel()
    out[16:] = np.asarray(cam_pos, np.float32)
    return out


def _unpack_cam(cam_f):
    """f32[19] -> (view_proj [4, 4], cam_pos [3])."""
    return cam_f[:16].reshape(4, 4), cam_f[16:19]


def _pack_mask_bits(mask6, n):
    return (np.asarray(mask6[:n], np.int16)
            << np.arange(6, dtype=np.int16)[None, :]).sum(1)


def _mask6_of_bits(maskb):
    return torch.stack([(maskb >> d) & 1 for d in range(6)], dim=1)


def _pack_meta(vcap, slots, counts6, mask6, positions) -> np.ndarray:
    meta = np.zeros(META_SHORTS * vcap, np.int16)
    n = len(slots)
    meta[:n] = np.asarray(slots, np.int16)
    c6 = np.zeros((vcap, 6), np.int16)
    c6[:n] = counts6[:n]
    meta[vcap:7 * vcap] = c6.ravel()
    meta[7 * vcap:7 * vcap + n] = _pack_mask_bits(mask6, n)
    p = np.zeros((vcap, 3), np.int16)
    p[:n] = np.asarray(positions[:n], np.int16)
    meta[8 * vcap:11 * vcap] = p.ravel()
    return meta


def _unpack_meta(meta_i, vcap: int):
    """int16 meta -> (slots, counts6, mask6, positions), int32."""
    meta_i = meta_i.to(torch.int32)
    return (meta_i[:vcap], meta_i[vcap:7 * vcap].reshape(vcap, 6),
            _mask6_of_bits(meta_i[7 * vcap:8 * vcap]),
            meta_i[8 * vcap:11 * vcap].reshape(vcap, 3))


def _pack_meta5(vcap, slots, mask6, positions) -> np.ndarray:
    meta = np.zeros(META5_SHORTS * vcap, np.int16)
    n = len(slots)
    meta[:n] = np.asarray(slots, np.int16)
    meta[vcap:vcap + n] = _pack_mask_bits(mask6, n)
    p = np.zeros((vcap, 3), np.int16)
    p[:n] = np.asarray(positions[:n], np.int16)
    meta[2 * vcap:5 * vcap] = p.ravel()
    return meta


def _unpack_meta5(meta_i, vcap: int):
    """META5 int16 meta -> (slots, mask6, positions), int32."""
    meta_i = meta_i.to(torch.int32)
    return (meta_i[:vcap], _mask6_of_bits(meta_i[vcap:2 * vcap]),
            meta_i[2 * vcap:5 * vcap].reshape(vcap, 3))


def _split_frame_u(frame_u, vcap: int):
    """One i32 upload [META5 int16 pairs | camera f32 bits | rest]."""
    n_meta = (META5_SHORTS * vcap) // 2
    meta_i = frame_u[:n_meta].view(torch.int16)
    cam_f = frame_u[n_meta:n_meta + 19].view(torch.float32)
    return meta_i, cam_f, frame_u[n_meta + 19:]


def _step_camf(quads, quad_world, n_quads, cam_f, **step_kw):
    view_proj, cam_pos = _unpack_cam(cam_f)
    return render_step(quads, quad_world, n_quads, view_proj, cam_pos,
                       **step_kw)


def _fused_frame(quad_pool, meta_i, cam_f, *, vcap: int, gather_cap: int,
                 **step_kw):
    """11-short draw list: expansion + step; also returns the expanded
    stream so the caller can cache it."""
    slots, counts6, mask6, positions = _unpack_meta(meta_i, vcap)
    quads, quad_world, total = _expand_uploads_impl(
        quad_pool, slots, counts6, mask6, positions, gather_cap)
    color, depth, stats = _step_camf(quads, quad_world, total, cam_f,
                                     **step_kw)
    return color, depth, stats, quads, quad_world, total


def _fused_frame5(quad_pool, counts6_pool, frame_u, *, vcap: int,
                  gather_cap: int, **step_kw):
    """META5 draw list (counts from the pool's device mirror) + camera in
    one upload: expansion + step."""
    meta_i, cam_f, _ = _split_frame_u(frame_u, vcap)
    slots, mask6, positions = _unpack_meta5(meta_i, vcap)
    quads, quad_world, total = _expand_uploads_impl(
        quad_pool, slots, counts6_pool[slots.long()], mask6, positions,
        gather_cap)
    return _step_camf(quads, quad_world, total, cam_f, **step_kw)


def _fused_frame_insert(quad_pool, counts6_pool, frame_u, *, vcap: int,
                        gather_cap: int, kp: int, mc: int, **step_kw):
    """Streaming frame: pool scatter (in place), then the META5 expansion
    that may reference the just-inserted meshes, then the step.  Returns
    (pool, counts6, color, depth, stats)."""
    meta_i, cam_f, ins = _split_frame_u(frame_u, vcap)
    apply_insert_payload(quad_pool, counts6_pool, ins, k=kp, mc=mc)
    slots, mask6, positions = _unpack_meta5(meta_i, vcap)
    quads, quad_world, total = _expand_uploads_impl(
        quad_pool, slots, counts6_pool[slots.long()], mask6, positions,
        gather_cap)
    color, depth, stats = _step_camf(quads, quad_world, total, cam_f,
                                     **step_kw)
    return quad_pool, counts6_pool, color, depth, stats


class Renderer:
    """The render step's configuration, capacity buckets and colour tables
    on one device (reference ``Renderer``, production path only)."""

    INSERT_KP = 16
    INSERT_MC = 512
    INSERT_FP = 8192

    def __init__(self, config: RenderConfig | None = None,
                 atlas: TextureAtlas | None = None, *, device):
        self.config = cfg = config or RenderConfig()
        self.atlas = atlas or TextureAtlas()
        self.device = torch.device(device)
        for flag in ("span_mode", "packed_raster", "two_pass_near_quads",
                     "temporal_hiz"):
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"RenderConfig.{flag} is not ported yet")
        tile_h, tile_w = cfg.tile_h, cfg.tile_w
        if cfg.height % tile_h or cfg.width % tile_w:
            tile_h, tile_w = raster_ops.pick_tile(cfg.height, cfg.width)
        self._tables_np = build_quad_color_tables(
            self.atlas.kernel_tables(), enable_shading=cfg.enable_shading,
            enable_textures=cfg.enable_textures)
        self._base_step_kw = dict(
            color_tables=proj_ops.color_table_tensors(self._tables_np,
                                                      self.device),
            width=cfg.width, height=cfg.height, tile_h=tile_h,
            tile_w=tile_w, backface_culling=cfg.backface_culling)
        # capacity buckets: the mid-stage tensors scale with the gather
        # and render caps, so small scenes take a small bucket; the
        # quads_cap-sized bucket runs without compaction
        cands = {cfg.gather_cap // 4, cfg.gather_cap // 2, cfg.gather_cap,
                 min(cfg.quads_cap, cfg.gather_cap)}
        self.gather_buckets = tuple(
            sorted(c for c in cands if c >= 16384)) or (cfg.gather_cap,)
        self._cam_cache: tuple | None = None

    def _bucket_kw(self, gather_cap: int) -> dict:
        cfg = self.config
        return dict(self._base_step_kw,
                    render_cap=min(cfg.quads_cap, gather_cap),
                    tile_k_cap=min(cfg.tile_k_cap, 2 * gather_cap))

    def bucket_for(self, total_quads: int) -> int:
        for c in self.gather_buckets:
            if total_quads <= c:
                return c
        return self.gather_buckets[-1]

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor.  On CUDA the copy goes through
        pinned memory and does not block the host (a pageable copy would
        wait for every queued kernel)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prep_meta(self, visible_slots, counts_sel, positions_sel,
                   dir_mask):
        """Draw-list normalization shared by every entry point (reference
        ``Renderer._prep_meta``): returns (slots, counts6, mask6,
        positions, cap, truncated)."""
        counts6 = np.asarray(counts_sel, np.int64)
        if counts6.ndim != 2 or counts6.shape[1] != 6:
            raise ValueError("counts_sel must be [vcap, 6] per-direction "
                             "counts")
        mask6 = (np.ones_like(counts6) if dir_mask is None
                 else np.asarray(dir_mask, np.int64))
        # padding rows (all-zero host counts) get a zero mask: META5 reads
        # counts from the device mirror, where slot 0 is a live chunk
        mask6 = mask6 * (counts6.sum(axis=1, keepdims=True) > 0)
        total = int((counts6 * mask6).sum())
        cap = self.bucket_for(total)
        truncated = total > cap
        if truncated:
            counts6, total = _truncate_units(counts6, mask6, cap)
        slots_a = np.asarray(visible_slots, np.int32)
        pos_a = np.asarray(positions_sel, np.int32)
        if slots_a.max(initial=0) > 32767 or np.abs(pos_a).max() > 32767:
            raise ValueError(
                "draw-list meta exceeds int16 range (pool slot > 32767 "
                "or |chunk grid coord| > 32767)")
        return slots_a, counts6, mask6, pos_a, cap, truncated

    def prepare_uploads(self, quad_pool, visible_slots, counts_sel,
                        positions_sel, dir_mask=None):
        """Expand the draw list into the device quad stream; cacheable
        while the draw list (with its dir mask) is unchanged.  Returns
        (quads, quad_world, total)."""
        slots_a, counts6, mask6, pos_a, cap, _ = self._prep_meta(
            visible_slots, counts_sel, positions_sel, dir_mask)
        return _expand_uploads_impl(
            quad_pool, self._upload(slots_a),
            self._upload(counts6.astype(np.int32)),
            self._upload(mask6.astype(np.int32)), self._upload(pos_a), cap)

    def _frame_u(self, vcap, slots_a, mask6, pos_a, view_proj, cam_pos,
                 payload=None) -> torch.Tensor:
        parts = [_pack_meta5(vcap, slots_a, mask6, pos_a).view(np.int32),
                 _pack_cam(view_proj, cam_pos).view(np.int32)]
        if payload is not None:
            parts.append(np.asarray(payload, np.uint32).view(np.int32))
        return self._upload(np.concatenate(parts))

    def render_fused(self, quad_pool, visible_slots, counts_sel,
                     positions_sel, view_proj, cam_pos, dir_mask=None,
                     counts6_dev=None):
        """Draw-list expansion + step (the draw-list-changed frame).
        Returns (color, depth, stats, uploads); ``uploads`` is None on the
        META5 path (``counts6_dev`` given, not truncated), else the
        expanded stream for render_prepared."""
        slots_a, counts6, mask6, pos_a, cap, truncated = self._prep_meta(
            visible_slots, counts_sel, positions_sel, dir_mask)
        vcap = self.config.visible_chunks_cap
        kw = self._bucket_kw(cap)
        if counts6_dev is not None and not truncated:
            color, depth, stats = _fused_frame5(
                quad_pool, counts6_dev,
                self._frame_u(vcap, slots_a, mask6, pos_a, view_proj,
                              cam_pos), vcap=vcap, gather_cap=cap, **kw)
            return color, depth, stats, None
        meta = self._upload(_pack_meta(vcap, slots_a, counts6, mask6, pos_a))
        color, depth, stats, quads, quad_world, total = _fused_frame(
            quad_pool, meta, self._cam_dev(view_proj, cam_pos), vcap=vcap,
            gather_cap=cap, **kw)
        return color, depth, stats, (quads, quad_world, total)

    def _cam_dev(self, view_proj, cam_pos):
        """Device copy of the packed camera, cached while it holds."""
        packed = _pack_cam(view_proj, cam_pos)
        key = packed.tobytes()
        c = self._cam_cache
        if c is not None and c[0] == key:
            return c[1]
        dev = self._upload(packed)
        self._cam_cache = (key, dev)
        return dev

    def render_prepared(self, uploads, view_proj, cam_pos):
        """Step on a cached stream (the static frame)."""
        quads, quad_world, total = uploads
        return _step_camf(quads, quad_world, total,
                          self._cam_dev(view_proj, cam_pos),
                          **self._bucket_kw(int(quads.shape[0])))

    def render_fused_insert(self, quad_pool, counts6_dev, visible_slots,
                            counts_sel, positions_sel, view_proj, cam_pos,
                            insert_payload, dir_mask=None):
        """Streaming frame: mesh insert + expansion + step with one upload
        (QuadPool.prepare_insert_payload gives ``insert_payload``).  Returns
        (pool, counts6, color, depth, stats) -- the pool tensors are
        updated in place -- or None when the frame needs a fallback layout
        (a truncated draw list), in which case nothing ran."""
        if insert_payload.shape != (3 * self.INSERT_KP + self.INSERT_FP,):
            raise ValueError(f"insert payload of shape {insert_payload.shape}")
        slots_a, counts6, mask6, pos_a, cap, truncated = self._prep_meta(
            visible_slots, counts_sel, positions_sel, dir_mask)
        if truncated:
            return None
        vcap = self.config.visible_chunks_cap
        return _fused_frame_insert(
            quad_pool, counts6_dev,
            self._frame_u(vcap, slots_a, mask6, pos_a, view_proj, cam_pos,
                          insert_payload),
            vcap=vcap, gather_cap=cap, kp=self.INSERT_KP, mc=self.INSERT_MC,
            **self._bucket_kw(cap))
