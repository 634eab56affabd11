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
5. metadata  -- the record gather, per-octet row ranges and the suffix-min
                of near depth to the end of each tile's segment (the
                occlusion-break key): one kernel on the card,
                csrc/tile_meta.cu (ops/raster.tile_metadata), whose plain
                twin ``tile_metadata_plain`` runs on the CPU
6. raster    -- kernel K2 (ops/raster.rasterize_tiles), then the crop

Frames in flight (``Renderer.render_*_pipelined``): a step renders frame
N-1 from its carried stage-A result (``pre_geom``) and computes frame N's
stage A in the same raster launch (``next_geom``, kernel K3); the frames
equal the serial step's bit for bit, one frame later.  Between calls the
carried stage A is one i32 tensor (``_pack_pre``) and the carried camera
19 host floats (``_pack_cam``).

Exact occlusion (``RenderConfig.two_pass_near_quads``, ``_two_pass_step``):
stage A once, the nearest ``near_quads`` of the front-to-back stream
rendered, a max-depth pyramid of that frame (ops/hiz.py), and the far
quads that provably lose culled before the far pass, which K2 blends onto
the near frame.  ``RenderConfig.temporal_hiz`` (``_step_camf_hiz``) culls
a static frame against the previous frame's pyramid instead.  Both frames
equal the single pass's bit for bit.  A row band (``band_y0``/``band_h``,
parallel/sharded_render.py) restricts the step to the quads that touch
the band and rasterizes a band-sized buffer at global pixel NDC.

Span mode (``RenderConfig.span_mode``) draws each quad as its screen box
at constant depth: stage A runs K1's span instance, whose NDC box crosses
the compaction into the span records (ops/projection.span_coefficients),
and K2 rasterizes them, also in the two-pass, temporal and band steps.

The packed raster (``RenderConfig.packed_raster``, ``_packed_tail``)
always compacts, keyed by 4 bits of log-quantized near depth so the
stream comes out front to back, then bins into five bins per tile (the
wide quads and four 32-pixel buckets, ops/raster_packed.build_bin_lists),
takes a per-bin suffix-min of near depth, and rasterizes with kernel K4
(ops/raster_packed.rasterize_packed).  Its frame equals the default
path's; it does not run frames in flight.

The resident superset stream (``Engine(resident_stream=True)``): the
engine keeps one stream built from every pooled mesh within view distance
of the camera's chunk cell and renders it with ``render_prepared`` while
the camera stays in the cell.  A streaming frame's batch rides the next
frame's step (``_step_camf_append``: the batch expanded from the pool and
blended into a copy of the stream; ``_step_camf_append_insert`` also
scatters the batch into the pool first).

One dispatch a frame: where the reference jits each serial entry point
once a capacity bucket, the ``Renderer`` serves each (entry point, gather
bucket) from one CUDA graph (rendering/graphs.py), captured at its first
frame or in ``warm_buckets``: a frame is one upload into the graph's
static buffers, one replay and the copies of its outputs.  Capacities are
static, so a step makes no host sync; ``n_quads``, the counts and the
totals stay on the device.  Where JAX's immutable arrays forced a copy,
the port updates the quad pool in place (``apply_insert_payload``), also
inside a graph.  ``prepare_uploads``, which expands a settled draw list
for the static frames, runs from a graph of its own ("expand"), and each
frames-in-flight step from one too ("pipe_seed", "pipe_seed_fused",
"pipe_prepared", "pipe_fused"; a drain replays "prepared"); the resident
append steps run eagerly.

Uploads: each upload of a draw list is written once, by the native
packer (meshing/native_bridge.py ``pack_frame``); on the card it is
written into a slot of the renderer's pinned ring (graphs.PinnedRing), a
camera by ``_pack_cam`` into another, and each is copied onto the card
from there.  ``_pack_frame`` is the packer's numpy twin, which a missing
library and a list past the largest bucket take.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import graphs
from ..meshing import native_bridge
from ..ops import geometry as geom_ops
from ..ops import hiz as hiz_ops
from ..ops import projection as proj_ops
from ..ops import raster as raster_ops
from ..ops import raster_packed as packed_ops
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..utils import profiling as prof
from ..utils.config import RenderConfig

U32 = raster_ops.U32_MASK


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  The port's entry points run on the
    card unless the caller asks for the CPU: a CUDA device that is not
    there raises, nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def _pre_geom_of(ga):
    """K1/K3 output dict -> the pre_geom tuple (valid, bbx, bby,
    depth_near, subpix_total)."""
    return (ga["valid"], ga["bbx"], ga["bby"], ga["depth_near"],
            ga["subpix_total"])


def render_step(quads, quad_world, n_quads, view_proj, cam_pos, *,
                color_tables, width: int, height: int, tile_h: int,
                tile_w: int, render_cap: int, span_mode: bool = False,
                backface_culling: bool = True, tile_k_cap: int = 8192,
                packed_raster: bool = False,
                debug_return_records: bool | str = False, skip_quads=0,
                hiz_level1=None, init_color=None, init_depth=None,
                band_y0: int = 0, band_h: int | None = None, pre_geom=None,
                next_geom=None):
    """One frame from the gathered stream: ``quads`` i32[GQ] words,
    ``quad_world`` f32[3, GQ], ``n_quads`` i32 scalar, ``view_proj``
    f32[4, 4], ``cam_pos`` f32[3] (all on one device); ``color_tables``
    from ops/projection.color_table_tensors.  Returns (color i32[H, W],
    depth f32[H, W], stats i32[6] = [gathered, rasterized, overflow,
    bin_overflow, subpixel_culled, hiz_culled]).  ``debug_return_records``
    returns the raster's inputs (records, tile_starts, tile_counts,
    octet_rows, octet_zmin) instead.

    Exact occlusion (``_two_pass_step``, ``_step_camf_hiz``):
    ``skip_quads`` (int or device scalar) leaves stream[:skip_quads] out;
    ``hiz_level1`` (ops/hiz.build_max_pyramid of a rendered frame) culls
    the quads that provably lose against it, counted in stats[5];
    ``init_color`` i32 / ``init_depth`` f32 [H, W] is the frame the raster
    starts from.  Row band: ``band_h`` rows from ``band_y0`` (ints) -- the
    quads that touch the band, their rows rebased to it, rasterized into a
    [band_h, W] frame at global pixel NDC (K2's ``y0_px``); stacking the
    bands gives the full frame.  A band excludes an init frame, the cull
    and the packed path; the packed path excludes an init frame.

    ``packed_raster``: the packed raster path (``_packed_tail``, kernel
    K4); its ``debug_return_records`` adds K4's item_bby and item_bbx as
    sixth and seventh outputs and may also be "bin" or "gather" (see
    there).

    ``span_mode``: each quad drawn as its screen box at constant depth in
    its block's flat colour (``RenderConfig.span_mode``): stage A runs K1's
    span instance, whose NDC box crosses the compaction into
    ``quad_coefficients``' span records, rasterized by K2.  Span mode
    takes the tile raster even with ``packed_raster`` (as the reference)
    and excludes ``pre_geom`` and ``next_geom``.

    Frames in flight: ``pre_geom`` = (valid, bbx, bby, depth_near,
    subpix_total), this stream's stage A computed earlier, skips stage A
    (``valid`` is masked with the stream range); ``next_geom`` = (quads2,
    quad_world2, n2, view_proj2, cam_pos2) computes the next frame's stage
    A in the raster call (K3) and returns its pre_geom tuple as a fourth
    output."""
    packed_raster = packed_raster and not span_mode
    if next_geom is not None and (debug_return_records or packed_raster
                                  or band_h is not None or span_mode):
        raise ValueError("next_geom runs with the full-frame tile raster "
                         "in exact mode and cannot return the raster's "
                         "inputs")
    if pre_geom is not None and span_mode:
        raise ValueError("a carried stage A has no span fields")
    if band_h is not None and (init_color is not None
                               or hiz_level1 is not None or packed_raster):
        raise ValueError("a row band runs with neither an init frame, the "
                         "Hi-Z cull nor the packed raster")
    if packed_raster and init_color is not None:
        # the packed kernel has no init-framebuffer path: dropping the
        # near pass's frame would render a wrong frame
        raise ValueError(
            "packed_raster cannot run as a two-pass far pass (no init "
            "framebuffer support); disable two_pass_near_quads or "
            "packed_raster")
    dev = quads.device
    gq = quads.shape[0]
    i32 = torch.int32
    n_quads = geom_ops.device_i32(n_quads, dev)

    # stage A's own valid count stands for ``count`` while nothing masks
    # ``valid`` after it (no carried stage A, Hi-Z cull or band)
    valid_count = None
    ndc_a = None  # span mode's NDC box f32[4, GQ]
    if pre_geom is None:
        ga = geom_ops.project_cull(
            quads, quad_world, n_quads, view_proj, cam_pos, width=width,
            height=height, backface_culling=backface_culling,
            skip_quads=skip_quads, span_mode=span_mode)
        valid_a, bbx_a, bby_a, dn_a, subpix_total = _pre_geom_of(ga)
        valid_count = ga["valid_count"]
        ndc_a = ga.get("ndc")
    else:
        # a shared stage A over the whole stream: this pass's quad range
        # folds in as a mask
        valid_a, bbx_a, bby_a, dn_a, subpix_total = pre_geom
        idx = torch.arange(gq, dtype=i32, device=dev)
        valid_a = valid_a & (idx < n_quads)
        if not (isinstance(skip_quads, int) and skip_quads == 0):
            valid_a = valid_a & (idx >= geom_ops.device_i32(skip_quads, dev))
    hiz_culled = torch.zeros((), dtype=i32, device=dev)
    if hiz_level1 is not None:
        # exact occlusion against a rendered frame's max pyramid: a culled
        # quad provably loses every blend, so the frame is unchanged
        occ = hiz_ops.quads_occluded_exact(
            hiz_level1, bbx_a, bby_a,
            _ulps_below(dn_a, HIZ_MARGIN_ULPS), height=height,
            width=width) & valid_a
        valid_a = valid_a & ~occ
        hiz_culled = occ.sum(dtype=i32)
        valid_count = None
    bh = height
    if band_h is not None:
        # the band's quads, their rows rebased to the band (stage A stays
        # global; K2 gets y0_px, so NDC stays global too)
        bh = band_h
        y0q, y1q = bby_a & 0xFFFF, bby_a >> 16
        valid_a = (valid_a & (y1q >= band_y0)
                   & (y0q <= band_y0 + band_h - 1))
        bby_a = (torch.clamp(y0q - band_y0, 0, band_h - 1)
                 | (torch.clamp(y1q - band_y0, 0, band_h - 1) << 16))
        valid_count = None
    count = valid_a.sum(dtype=i32) if valid_count is None else valid_count

    out_h = -bh % tile_h + bh  # pad to a tile multiple
    tiles_y, tiles_x = out_h // tile_h, width // tile_w
    rc = min(gq, render_cap)
    if gq <= rc and not packed_raster:
        # no compaction: the binner takes the raw stream with its mask
        count_c = count
        overflow = torch.zeros((), dtype=i32, device=dev)
        quads_c, wq_c = quads, quad_world
        bbx_c, bby_c, dn_c, ndc_c = bbx_a, bby_a, dn_a, ndc_a
        valid_c = valid_a
    else:
        stream_q = torch.arange(gq, dtype=i32, device=dev)
        if packed_raster:
            # the packed path always compacts, front to back: the key puts
            # 4 bits of log-quantized near depth above the stream index, so
            # the binner needs no finer depth order
            qbits = max(1, (gq - 1).bit_length())
            assert 16 << qbits <= 2**30, "depth class + index overflow"
            key = torch.where(
                valid_a, (_depth_class(dn_a) << qbits) | stream_q, 2**30)
            idx = torch.sort(key).values[:rc] & ((1 << qbits) - 1)
        else:
            idx = torch.sort(torch.where(valid_a, stream_q, 2**30)).values[:rc]
        idx = torch.clamp(idx, max=gq - 1).long()
        quads_c, wq_c = quads[idx], quad_world[:, idx]
        bbx_c, bby_c, dn_c = bbx_a[idx], bby_a[idx], dn_a[idx]
        ndc_c = None if ndc_a is None else ndc_a[:, idx]
        overflow = torch.clamp(count - rc, min=0)
        count_c = torch.clamp(count, max=rc)
        valid_c = None

    coeffs = proj_ops.quad_coefficients(
        quads_c, (wq_c[0], wq_c[1], wq_c[2]), view_proj, color_tables,
        None if ndc_c is None else (ndc_c, dn_c), width=width,
        height=height)

    def stats_of(bin_overflow):
        return torch.stack([n_quads, count, overflow, bin_overflow,
                            subpix_total, hiz_culled])

    if packed_raster:
        f_full = torch.stack([coeffs[k] for k in raster_ops.F_FIELDS])
        i_full = torch.stack([coeffs[k] for k in raster_ops.I_FIELDS]
                             + [bby_c, dn_c.view(i32), bbx_c])
        out = _packed_tail(
            f_full, i_full, bbx_c, bby_c, count_c, height=height,
            width=width, tile_h=tile_h, out_h=out_h, tiles_y=tiles_y,
            tiles_x=tiles_x, tile_k_cap=tile_k_cap,
            debug_return_records=debug_return_records)
        if debug_return_records:
            return out
        color, depth, bin_overflow = out
        return color[:height], depth[:height], stats_of(bin_overflow)
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
    dq4 = _depth_class(dn_c)
    y0_c = bby_c & 0xFFFF
    ly0_c = torch.clamp(y0_c - (y0_c // tile_h) * tile_h, 0, tile_h - 1)
    band = torch.clamp(ly0_c >> 2, max=3)
    flat, t_of_item, tile_starts, tile_counts, bin_overflow = (
        raster_ops.build_tile_lists(
            tilebox, count_c, (dq4 << 2) | band, dq4 << 2, tiles_y=tiles_y,
            tiles_x=tiles_x, item_cap=tile_k_cap, valid=valid_c))
    # the record gather, each octet's row range and the suffix-min of near
    # depth to the end of its tile's segment (the occlusion-break key)
    records, octet_rows, octet_zmin = raster_ops.tile_metadata(
        all22, flat, t_of_item, tile_starts, tile_counts, tiles_y=tiles_y,
        tiles_x=tiles_x, tile_h=tile_h)
    if debug_return_records:
        return records, tile_starts, tile_counts, octet_rows, octet_zmin
    if init_color is not None and out_h != bh:
        # the init frame padded to the tile multiple; the padded rows are
        # cropped again below
        init_color = torch.cat([init_color, torch.full(
            (out_h - bh, width), raster_ops.SKY_I32, dtype=i32, device=dev)])
        init_depth = torch.cat([init_depth, torch.full(
            (out_h - bh, width), float("inf"), dtype=torch.float32,
            device=dev)])

    out = raster_ops.rasterize_tiles(
        records, tile_starts, tile_counts, octet_rows, octet_zmin,
        height=height, width=width, tile_h=tile_h, tile_w=tile_w,
        out_h=out_h, init_color=init_color, init_depth=init_depth,
        y0_px=band_y0, next_geom=next_geom,
        backface_culling=backface_culling)
    color, depth = out[0][:bh], out[1][:bh]
    if next_geom is not None:
        return color, depth, stats_of(bin_overflow), _pre_geom_of(out[2])
    return color, depth, stats_of(bin_overflow)


HIZ_MARGIN_ULPS = 4


def _ulps_below(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` moved ``k`` float32 ulps toward zero where it is positive
    (never below +0); other entries unchanged."""
    low = torch.clamp(x.view(torch.int32) - k, min=0).view(torch.float32)
    return torch.where(x > 0, low, x)


def _depth_class(dn) -> torch.Tensor:
    """4-bit log-quantized near depth: floor(-log2(max(1 - dn, 1e-9))),
    clipped to [0, 15]."""
    return torch.clamp(
        (-torch.log2(torch.clamp(1.0 - dn, min=1e-9))).to(torch.int32), 0, 15)


def _segmented_suffix_min(seg, vals):
    """out[g] = min of ``vals`` over g' >= g with seg[g'] == seg[g], for a
    non-decreasing ``seg`` and ``vals`` without NaN (the reference's
    segmented reverse ``associative_scan``): one reverse cummin over an
    int64 key (segment << 32 | order-mapped float bits), in which later
    segments carry larger keys and so never win."""
    bits = vals.view(torch.int32).long() & U32
    omap = bits ^ torch.where((bits >> 31) != 0, U32, 1 << 31)
    low = torch.cummin(((seg.long() << 32) | omap).flip(0),
                       0).values.flip(0) & U32
    fbits = torch.where((low >> 31) != 0, low ^ (1 << 31), ~low & U32)
    return raster_ops.u32_as_i32(fbits).view(torch.float32)


def _packed_tail(f_full, i_full, bbx_c, bby_c, count_c, *, height: int,
                 width: int, tile_h: int, out_h: int, tiles_y: int,
                 tiles_x: int, tile_k_cap: int, debug_return_records):
    """Binning, metadata and raster of the packed path (the reference's
    ``_packed_tail``) on the compacted, front-to-back stream: ``f_full``
    f32[16, rc] blend fields, ``i_full`` i32[7, rc] (colour/mask words,
    bby, near-depth bits, bbx).  Returns (color, depth, bin_overflow), color and
    depth [out_h, width]; or, with ``debug_return_records`` True, the
    raster's inputs (records, starts, counts, octet_rows, octet_zmin, and
    K4's item_bby and item_bbx; the first five are the reference's);
    "bin" stops after the binning (flat, b_of_item, valid_slot, starts,
    counts), "gather" after the record gather (f_binned, i_binned, starts,
    counts, b_of_item)."""
    i32 = torch.int32
    bucketbox = proj_ops.pack_tilebox(
        bbx_c & 0xFFFF, bbx_c >> 16, bby_c & 0xFFFF, bby_c >> 16,
        tile_h=tile_h, tile_w=packed_ops.BUCKET_W)
    # within-bin order: 2 bits of near depth (early occlusion break), then
    # the 2-bit covered-row band (row coherence); the compaction order
    # refines by 4 bits of depth inside each class
    by0 = bby_c & 0xFFFF
    band2 = torch.clamp(
        torch.clamp(by0 - (by0 // tile_h) * tile_h, 0, tile_h - 1) >> 2,
        max=3)
    dq2 = _depth_class(i_full[5].view(torch.float32)) >> 2
    flat, b_of_item, valid_slot, starts, counts, bin_overflow = (
        packed_ops.build_bin_lists(
            bucketbox, count_c, (dq2 << 2) | band2, dq2 << 2,
            tiles_y=tiles_y, tiles_x=tiles_x, item_cap=tile_k_cap))
    if debug_return_records == "bin":
        return flat, b_of_item, valid_slot, starts, counts
    f_binned = f_full[:, flat.long()]
    ig = i_full[:, flat.long()]
    if debug_return_records == "gather":
        return f_binned, ig, starts, counts, b_of_item
    # covered tile-local row range per item -> per-octet bounds; pad slots
    # are inert (empty row range, +inf depth)
    tpy0 = (b_of_item // packed_ops.BINS_PER_TILE // tiles_x) * tile_h
    ly0 = torch.clamp((ig[4] & 0xFFFF) - tpy0, 0, tile_h - 1)
    ly1 = torch.clamp((ig[4] >> 16) - tpy0, 0, tile_h - 1)
    ly0 = torch.where(valid_slot, ly0, tile_h - 1)
    ly1 = torch.where(valid_slot, ly1, 0)
    n_items = flat.shape[0]
    n_oct = n_items // 8
    octet_rows = (ly0.view(n_oct, 8).amin(1)
                  | (ly1.view(n_oct, 8).amax(1) << 8))
    # the exact occlusion-break key: the suffix-min of near depth to the
    # end of each BIN, over 8-group minima, keyed by each group's first
    # item (the kernel tests it only at groups that start inside a bin);
    # a binned quad's near depth lies in [0, 1] (stage A's frustum test)
    dn_i = torch.where(valid_slot, ig[5].view(torch.float32), float("inf"))
    octet_zmin = _segmented_suffix_min(b_of_item.view(n_oct, 8)[:, 0],
                                       dn_i.view(n_oct, 8).amin(1))
    records = torch.cat([f_binned.view(i32), ig[:4],
                         torch.zeros((4, n_items), dtype=i32,
                                     device=flat.device)])
    # each item's screen box: K4 evaluates an item on its own pixels
    item_bby, item_bbx = ig[4], ig[6]
    if debug_return_records:
        return (records, starts, counts, octet_rows, octet_zmin, item_bby,
                item_bbx)
    color, depth = packed_ops.rasterize_packed(
        records, starts, counts, octet_rows, octet_zmin, item_bby, item_bbx,
        height=height, width=width, tile_h=tile_h, out_h=out_h)
    return color, depth, bin_overflow


# ----------------------------------------------------------- draw lists


def build_gather_indices(counts_sel, slots_sel, positions_sel,
                         gather_cap: int):
    """Host-side ragged flatten (reference ``build_gather_indices``):
    per-visible-chunk quad counts + pool slots + chunk positions ->
    (pool_slot_of i32[GQ], within i32[GQ], quad_world f32[3, GQ], total
    int); a stream past ``gather_cap`` loses its tail."""
    counts_sel = np.asarray(counts_sel, np.int64)
    slots_sel = np.asarray(slots_sel, np.int32)
    positions_sel = np.asarray(positions_sel, np.float32) * 32.0
    total = int(counts_sel.sum())
    if total > gather_cap:
        cum = np.cumsum(counts_sel)
        counts_sel = np.where(cum <= gather_cap, counts_sel,
                              np.maximum(gather_cap - (cum - counts_sel), 0))
        total = int(counts_sel.sum())
    pool_slot_of = np.zeros(gather_cap, np.int32)
    within = np.zeros(gather_cap, np.int32)
    quad_world = np.zeros((3, gather_cap), np.float32)
    if total:
        pool_slot_of[:total] = np.repeat(slots_sel, counts_sel)
        starts = np.repeat(np.cumsum(counts_sel) - counts_sel, counts_sel)
        within[:total] = np.arange(total, dtype=np.int64) - starts
        for a in range(3):
            quad_world[a, :total] = np.repeat(positions_sel[:, a], counts_sel)
    return pool_slot_of, within, quad_world, total


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
    # the last unit again at the end (a clamp: an index write of a Python
    # number would copy it from the host)
    units = torch.clamp(torch.arange(nv * 6 + 1, device=dev), max=nv * 6 - 1)
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


def _normalize_counts6(counts_sel):
    """Legacy [vcap] totals become one dir-0 unit a chunk (the expansion
    then gathers row[0:count]); [vcap, 6] per-direction counts pass."""
    counts_sel = np.asarray(counts_sel, np.int64)
    if counts_sel.ndim == 1:
        c6 = np.zeros((counts_sel.shape[0], 6), np.int64)
        c6[:, 0] = counts_sel
        return c6
    return counts_sel


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


def apply_insert_payload(pool, packed, *, k: int, mc: int):
    """Rebuild [k, mc] rows from the flat payload (slots | starts | counts
    header, then the quad words, all i32 bits) and scatter them into the
    pool IN PLACE.  Padding entries duplicate entry 0 with identical rows,
    so the duplicate-index write is harmless."""
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


META_SHORTS = 11   # slots | counts6 | dir-mask bits | positions, per chunk


def _frame_words(vcap: int, camera: bool = True, payload=None) -> int:
    """The i32 words of a ``_pack_frame`` upload: the meta, padded to whole
    words, the camera's 19 where it has one, and the payload's."""
    return ((META_SHORTS * vcap + 1) // 2 + (19 if camera else 0)
            + (0 if payload is None else len(payload)))


def _pack_cam(view_proj, cam_pos) -> np.ndarray:
    """The camera as f32[19]: ``view_proj`` [4, 4] | ``cam_pos`` [3]."""
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


def _pack_frame(vcap, slots, counts6, mask6, positions, view_proj,
                cam_pos, payload=None) -> np.ndarray:
    """A draw list's one i32 upload: its 11-short meta (``_pack_meta``,
    padded to whole words) | the camera (19 f32 bits), unless
    ``view_proj`` is None | ``payload`` (u32 bits), if any.  The native
    packer's twin (``Renderer._pack_into``)."""
    meta = _pack_meta(vcap, slots, counts6, mask6, positions)
    meta = np.append(meta, np.zeros(meta.size % 2, np.int16))
    parts = [meta.view(np.int32)]
    if view_proj is not None:
        parts.append(_pack_cam(view_proj, cam_pos).view(np.int32))
    if payload is not None:
        parts.append(np.asarray(payload, np.uint32).view(np.int32))
    return np.concatenate(parts)


def _split_frame(frame_u, vcap: int):
    """A ``_pack_frame`` upload on the device -> (meta i16[11 vcap], camera
    f32[19], the rest)."""
    n_meta = _frame_words(vcap, camera=False)
    meta_i = frame_u[:n_meta].view(torch.int16)[:META_SHORTS * vcap]
    cam_f = frame_u[n_meta:n_meta + 19].view(torch.float32)
    return meta_i, cam_f, frame_u[n_meta + 19:]


def _expand_meta(quad_pool, meta_i, *, vcap: int, gather_cap: int):
    """The 11-short draw list ``meta_i`` expanded from the pool: (quads,
    quad_world, total)."""
    slots, counts6, mask6, positions = _unpack_meta(meta_i, vcap)
    return _expand_uploads_impl(quad_pool, slots, counts6, mask6, positions,
                                gather_cap)


def _two_pass_step(quads, quad_world, n_quads, view_proj, cam_pos, *,
                   near_quads: int, **step_kw):
    """Exact two-pass occlusion (the reference's ``_two_pass_step``): stage
    A once over the whole stream, the nearest ``near_quads`` of the
    front-to-back stream rendered, a max-depth pyramid of that frame, then
    the far pass: the rest of the stream with the quads that provably lose
    against the pyramid culled, blended by K2 onto the near frame.  The
    blend is commutative, so the frame equals the single pass's bit for
    bit.  Stats: the far pass's gathered count and Hi-Z cull, the passes'
    sums of rasterized, overflow and bin overflow, and the shared stage
    A's subpixel count once.  In span mode each pass runs its own stage A,
    as the reference's does (its subpixel counts, zero, are summed)."""
    span = step_kw.get("span_mode", False)
    pre_geom = None if span else _geom_stage(
        quads, quad_world, n_quads, view_proj, cam_pos,
        width=step_kw["width"], height=step_kw["height"],
        backface_culling=step_kw.get("backface_culling", True))
    n_quads = geom_ops.device_i32(n_quads, quads.device)
    n1 = torch.clamp(n_quads, max=near_quads)
    color1, depth1, s1 = render_step(quads, quad_world, n1, view_proj,
                                     cam_pos, pre_geom=pre_geom, **step_kw)
    hiz1 = hiz_ops.build_max_pyramid(depth1)
    color, depth, s2 = render_step(
        quads, quad_world, n_quads, view_proj, cam_pos,
        skip_quads=near_quads, hiz_level1=hiz1, init_color=color1,
        init_depth=depth1, pre_geom=pre_geom, **step_kw)
    stats = torch.stack([s2[0], s1[1] + s2[1], s1[2] + s2[2],
                         s1[3] + s2[3], s1[4] + s2[4] if span else s2[4],
                         s2[5]])
    return color, depth, stats


def _step_camf(quads, quad_world, n_quads, cam_f, *, near_quads: int = 0,
               **step_kw):
    view_proj, cam_pos = _unpack_cam(cam_f)
    if near_quads:
        return _two_pass_step(quads, quad_world, n_quads, view_proj,
                              cam_pos, near_quads=near_quads, **step_kw)
    return render_step(quads, quad_world, n_quads, view_proj, cam_pos,
                       **step_kw)


def _step_camf_hiz(quads, quad_world, n_quads, cam_f, hiz1, *,
                   near_quads: int = 0, **step_kw):
    """Temporal occlusion (``RenderConfig.temporal_hiz``): one pass with
    ``hiz1``, the previous frame's max pyramid (or +inf on the first
    static frame), culling the quads that provably lose; returns (color,
    depth, stats, the new pyramid).  Exact while camera, world and draw
    list are those of the pyramid's frame, which the engine ensures."""
    del near_quads  # excluded with temporal_hiz (Renderer.__init__)
    view_proj, cam_pos = _unpack_cam(cam_f)
    color, depth, stats = render_step(quads, quad_world, n_quads, view_proj,
                                      cam_pos, hiz_level1=hiz1, **step_kw)
    return color, depth, stats, hiz_ops.build_max_pyramid(depth)


def _expand_frame(quad_pool, frame_u, *, vcap: int, gather_cap: int):
    """A draw list's stream from its upload's meta (``prepare_uploads``):
    (quads, quad_world, total)."""
    return _expand_meta(quad_pool, _split_frame(frame_u, vcap)[0], vcap=vcap,
                        gather_cap=gather_cap)


def _fused_frame(quad_pool, frame_u, *, vcap: int, gather_cap: int,
                 **step_kw):
    """A changed draw list's frame from its one upload (``_pack_frame``):
    expansion + step.  Returns (color, depth, stats)."""
    meta_i, cam_f, _ = _split_frame(frame_u, vcap)
    quads, quad_world, total = _expand_meta(quad_pool, meta_i, vcap=vcap,
                                            gather_cap=gather_cap)
    return _step_camf(quads, quad_world, total, cam_f, **step_kw)


def _fused_frame_insert(quad_pool, frame_u, *, vcap: int, gather_cap: int,
                        kp: int, mc: int, **step_kw):
    """Streaming frame: the upload's insert payload scattered into the pool
    (in place), then ``_fused_frame``, whose expansion may reference the
    just-inserted meshes.  Returns (color, depth, stats)."""
    apply_insert_payload(quad_pool, _split_frame(frame_u, vcap)[2], k=kp,
                         mc=mc)
    return _fused_frame(quad_pool, frame_u, vcap=vcap, gather_cap=gather_cap,
                        **step_kw)


def views_band_frame(quad_pool, frame_u, *, vcap: int, gather_cap: int,
                     band_y0: int, band_h: int, **step_kw):
    """One view's row band (``Engine.render_views``): the view's upload
    (``Renderer.pack_views``) expanded as ``render_fused`` expands a draw
    list, then the step on the ``band_h`` rows from ``band_y0``.  Returns
    (color, depth [band_h, W], stats i32[6]; stats[1] counts the quads
    that touch the band)."""
    return _fused_frame(quad_pool, frame_u, vcap=vcap, gather_cap=gather_cap,
                        band_y0=band_y0, band_h=band_h, **step_kw)


# resident-stream append batch limits (Engine resident mode): chunks per
# append and quads per append.  A streaming frame inserts <=
# max_chunks_per_frame (16) new chunks plus remeshed neighbours; batches
# beyond these caps force a full stream rebuild.
RESIDENT_APPEND_VCAP = 64
RESIDENT_APPEND_CAP = 16384


def resident_append_cap(stream_len: int) -> int:
    """Append window size for a resident stream of ``stream_len``: the
    fixed cap, shrunk so the window always fits inside the stream (small
    configurations would otherwise never append)."""
    return min(RESIDENT_APPEND_CAP, max(256, stream_len // 8))


def pack_append_meta(slots, counts6, positions) -> np.ndarray:
    """The append rider's batch draw list as one i32 upload: slots |
    counts6 | positions over RESIDENT_APPEND_VCAP rows."""
    vc = RESIDENT_APPEND_VCAP
    nv = len(slots)
    assert nv <= vc
    meta = np.zeros(10 * vc, np.int32)
    meta[:nv] = slots
    c = np.zeros((vc, 6), np.int32)
    c[:nv] = counts6
    meta[vc:7 * vc] = c.reshape(-1)
    p = np.zeros((vc, 3), np.int32)
    p[:nv] = positions
    meta[7 * vc:] = p.reshape(-1)
    return meta


RESIDENT_INSERT_KP = 32    # resident fused-insert payload shape: chunks
RESIDENT_INSERT_MC = 1024  # a call / quads a mesh / flat quad cap
RESIDENT_INSERT_FP = 8192


def _step_camf_append(quads, quad_world, n_quads, cam_f, quad_pool,
                      ameta_i, offset, *, append_cap: int, **step_kw):
    """Resident-stream streaming frame (the reference's
    ``_step_camf_append``): the batch draw list ``ameta_i``
    (``pack_append_meta``) is expanded from the pool, every direction
    kept, and blended into copies of the stream at ``offset`` (int or
    device scalar), and the frame renders from the appended stream, so the
    batch shows exactly one frame late.  The first ``nk`` window entries
    take the batch, ``nk`` its untruncated quad count; the expansion pads
    past ``nk`` with a dummy unit, which the blend never reads.  As
    ``jax.lax.dynamic_slice`` and ``dynamic_update_slice``, the window
    start is clamped to [0, len - append_cap].  ``n_quads`` is the total
    after the append.  The input stream is left as it was.  Returns
    (color, depth, stats, quads2, quad_world2); the caller keeps the new
    stream."""
    vc = RESIDENT_APPEND_VCAP
    dev = quads.device
    counts6 = ameta_i[vc:7 * vc].reshape(vc, 6)
    new_q, new_w, nk = _expand_uploads_impl(
        quad_pool, ameta_i[:vc], counts6, torch.ones_like(counts6),
        ameta_i[7 * vc:10 * vc].reshape(vc, 3), append_cap)
    idx = torch.arange(append_cap, device=dev)
    take = idx < nk
    start = torch.clamp(geom_ops.device_i32(offset, dev).long(), 0,
                        quads.shape[0] - append_cap)
    pos = start + idx
    quads2, qw2 = quads.clone(), quad_world.clone()
    quads2[pos] = torch.where(take, new_q, quads[pos])
    qw2[:, pos] = torch.where(take[None, :], new_w, quad_world[:, pos])
    view_proj, cam_pos = _unpack_cam(cam_f)
    color, depth, stats = render_step(quads2, qw2, n_quads, view_proj,
                                      cam_pos, **step_kw)
    return color, depth, stats, quads2, qw2


def _step_camf_append_insert(quads, quad_world, n_quads, frame_i,
                             quad_pool, *, append_cap: int, kp: int, mc: int,
                             **step_kw):
    """Resident-stream streaming frame with the batch's pool scatter (the
    reference's ``_step_camf_append_insert``): ``frame_i`` i32[10 VC + 20 +
    3 kp + fp] = ameta (``pack_append_meta``) | camera (19 f32 bits) |
    offset | insert payload (``QuadPool.prepare_insert_payload``, u32
    bits).  The payload scatters into the pool in place
    (``apply_insert_payload``), then the batch is appended from the
    scattered pool and the frame renders as ``_step_camf_append``.
    Returns (color, depth, stats, quads2, quad_world2)."""
    na = 10 * RESIDENT_APPEND_VCAP
    apply_insert_payload(quad_pool, frame_i[na + 20:], k=kp, mc=mc)
    return _step_camf_append(
        quads, quad_world, n_quads, frame_i[na:na + 19].view(torch.float32),
        quad_pool, frame_i[:na], frame_i[na + 19], append_cap=append_cap,
        **step_kw)


def _geom_stage(quads, quad_world, n_quads, view_proj, cam_pos, *,
                width: int, height: int, backface_culling: bool):
    """Stage A alone -> the pre_geom tuple; seeds the frames-in-flight
    pipeline (a steady step gets it from K3) and is shared by the two
    passes of ``_two_pass_step``."""
    return _pre_geom_of(geom_ops.project_cull(
        quads, quad_world, n_quads, view_proj, cam_pos, width=width,
        height=height, backface_culling=backface_culling))


def _geom_camf(quads, quad_world, n_quads, cam_f, **geom_kw):
    view_proj, cam_pos = _unpack_cam(cam_f)
    return _geom_stage(quads, quad_world, n_quads, view_proj, cam_pos,
                       **geom_kw)


def _pipe_step_camf(quads_p, qw_p, n_p, cam_p, pre_p, quads_c, qw_c, n_c,
                    cam_c, *, near_quads: int = 0, **step_kw):
    """Frames-in-flight step: render frame N-1 (its stream, camera and
    carried ``pre_p``) and compute frame N's stage A in the same raster
    launch (K3).  Returns (color, depth, stats) of frame N-1 and frame N's
    pre_geom."""
    del near_quads  # refused in flight (Renderer._check_pipelined)
    vp_p, cp_p = _unpack_cam(cam_p)
    vp_c, cp_c = _unpack_cam(cam_c)
    return render_step(quads_p, qw_p, n_p, vp_p, cp_p, pre_geom=pre_p,
                       next_geom=(quads_c, qw_c, n_c, vp_c, cp_c), **step_kw)


def _pipe_fused(quad_pool, meta_i, cam_c, quads_p, qw_p, n_p, cam_p, pre_p,
                *, vcap: int, gather_cap: int, **step_kw):
    """Frames-in-flight step with the CURRENT frame's draw-list expansion:
    expansion(N) + render(N-1) + stage A(N).  Returns (color, depth,
    stats, pre_c, quads_c, qw_c, total_c)."""
    quads_c, qw_c, total_c = _expand_meta(quad_pool, meta_i, vcap=vcap,
                                          gather_cap=gather_cap)
    color, depth, stats, pre_c = _pipe_step_camf(
        quads_p, qw_p, n_p, cam_p, pre_p, quads_c, qw_c, total_c, cam_c,
        **step_kw)
    return color, depth, stats, pre_c, quads_c, qw_c, total_c


def _pack_pre(pre):
    """A stage A (``_pre_geom_of``'s tuple) as the one i32 tensor that the
    frames in flight carry between calls: bbx | bby | depth_near's bits |
    valid's bytes, padded to whole words | subpix_total."""
    valid, bbx, bby, dn, sub = pre
    vb = valid.view(torch.uint8)
    if vb.shape[0] % 4:
        vb = torch.cat([vb, vb.new_zeros(-vb.shape[0] % 4)])
    return torch.cat([bbx, bby, dn.view(torch.int32), vb.view(torch.int32),
                      sub.reshape(1)])


def _unpack_pre(pre_u, gq: int):
    """``_pack_pre``'s tensor of a ``gq``-quad stream -> the pre_geom tuple
    (views of it)."""
    bbx, bby, dn, vw, sub = pre_u.split((gq, gq, gq, (gq + 3) // 4, 1))
    return (vw.view(torch.bool)[:gq], bbx, bby, dn.view(torch.float32),
            sub[0])


def _pipe_seed_step(quads, quad_world, n_quads, cam_f, **geom_kw):
    """The stage A that seeds an empty pipeline with a prepared stream, packed
    (graph "pipe_seed")."""
    return _pack_pre(_geom_camf(quads, quad_world, n_quads, cam_f,
                                **geom_kw))


def _pipe_seed_fused_step(quad_pool, frame_u, *, vcap: int, gather_cap: int,
                          **geom_kw):
    """The draw list's expansion and stage A that seed an empty pipeline
    (graph "pipe_seed_fused"): ``frame_u`` as ``_pipe_fused_step`` takes it,
    its previous camera unread.  Returns (pre packed, quads, qw, total)."""
    meta_i, cam_f, _ = _split_frame(frame_u, vcap)
    quads, qw, total = _expand_meta(quad_pool, meta_i, vcap=vcap,
                                    gather_cap=gather_cap)
    return (_pipe_seed_step(quads, qw, total, cam_f, **geom_kw), quads, qw,
            total)


def _pipe_prepared_step(quads_p, qw_p, n_p, quads_c, qw_c, n_c, cams, pre_p,
                        **step_kw):
    """``_pipe_step_camf`` as graph "pipe_prepared" takes it: ``cams``
    f32[38] the carried frame's camera | this frame's (``_pack_cam``),
    ``pre_p`` the carried stage A packed (``_pack_pre``).  Returns the
    carried frame's (color, depth, stats) and this frame's stage A,
    packed."""
    color, depth, stats, pre_c = _pipe_step_camf(
        quads_p, qw_p, n_p, cams[:19], _unpack_pre(pre_p, quads_p.shape[0]),
        quads_c, qw_c, n_c, cams[19:], **step_kw)
    return color, depth, stats, _pack_pre(pre_c)


def _pipe_fused_step(quad_pool, quads_p, qw_p, n_p, frame_u, pre_p, *,
                     vcap: int, gather_cap: int, **step_kw):
    """``_pipe_fused`` as graph "pipe_fused" takes it: ``frame_u`` the draw
    list's upload (``_pack_frame``) | the carried frame's camera (19 f32
    bits), ``pre_p`` the carried stage A packed.  Returns (color, depth,
    stats, this frame's stage A packed, quads, qw, total)."""
    meta_i, cam_c, cam_p = _split_frame(frame_u, vcap)
    color, depth, stats, pre_c, quads, qw, total = _pipe_fused(
        quad_pool, meta_i, cam_c, quads_p, qw_p, n_p,
        cam_p.view(torch.float32), _unpack_pre(pre_p, quads_p.shape[0]),
        vcap=vcap, gather_cap=gather_cap, **step_kw)
    return color, depth, stats, _pack_pre(pre_c), quads, qw, total


class Renderer:
    """The render step's configuration, capacity buckets and colour tables
    on one device (reference ``Renderer``, production path only).  With
    ``RenderConfig.two_pass_near_quads`` every serial step is the two-pass
    step; with ``RenderConfig.temporal_hiz`` the engine's static frames go
    through ``render_prepared_hiz``.

    The serial entry points (``render_fused``, ``render_prepared``,
    ``render_prepared_hiz``, ``render_fused_insert``),
    ``prepare_uploads``' expansion and the frames-in-flight steps run from
    one ``graphs.CapturedCall`` each a gather bucket, as the reference's
    ``_steps_for`` / ``_hiz_step_for`` / ``_insert_step_for`` /
    ``_pipe_steps_for`` jit one program each.  A graph is captured at its first frame (or in
    ``warm_buckets``), again after ``set_shading`` (the colour tables are
    captured by address) and again when a frame brings other pool tensors
    than it captured.  Their outputs are copies: a frame a caller holds is
    never overwritten by a later one."""

    INSERT_KP = 16
    INSERT_MC = 512
    INSERT_FP = 8192
    # the pinned ring's slots: a serial frame takes one or two (the
    # expansion's meta and the camera), and a caller keeps at most a few
    # frames in flight, so a slot comes round once its copy has run
    RING_SLOTS = 8

    def __init__(self, config: RenderConfig | None = None,
                 atlas: TextureAtlas | None = None, *, device="cuda"):
        self.config = cfg = config or RenderConfig()
        self.atlas = atlas or TextureAtlas()
        self.device = resolve_device(device)
        if cfg.packed_raster and cfg.two_pass_near_quads:
            raise ValueError(
                "packed_raster and two_pass_near_quads are mutually "
                "exclusive: the packed kernel cannot blend onto the near "
                "pass's framebuffer")
        if cfg.temporal_hiz and cfg.two_pass_near_quads:
            raise ValueError(
                "temporal_hiz and two_pass_near_quads are mutually "
                "exclusive (both are forms of the same exact pyramid "
                "cull; the temporal one has no near pass to seed)")
        tile_h, tile_w = cfg.tile_h, cfg.tile_w
        if cfg.height % tile_h or cfg.width % tile_w:
            tile_h, tile_w = raster_ops.pick_tile(cfg.height, cfg.width)
        self._base_step_kw = dict(
            width=cfg.width, height=cfg.height, tile_h=tile_h,
            tile_w=tile_w, span_mode=cfg.span_mode,
            backface_culling=cfg.backface_culling,
            packed_raster=cfg.packed_raster,
            near_quads=cfg.two_pass_near_quads)
        # the resident append steps of each gather cap: plain functions
        # with their keywords bound, dropped when the colour tables change
        self._append_steps: dict[int, object] = {}
        self._append_ins_steps: dict[int, object] = {}
        # the serial entry points' graphs by (entry point, gather cap),
        # also dropped with the colour tables.  One memory pool holds the
        # intermediates of them all: safe only because their replays run
        # one after another on the card's current stream and each replay's
        # outputs are copied out before the next replay can write there
        self._graphs: dict[tuple, graphs.CapturedCall] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._rebuild_tables()
        # capacity buckets: the mid-stage tensors scale with the gather
        # and render caps, so small scenes take a small bucket; the
        # quads_cap-sized bucket runs without compaction
        cands = {cfg.gather_cap // 4, cfg.gather_cap // 2, cfg.gather_cap,
                 min(cfg.quads_cap, cfg.gather_cap)}
        self.gather_buckets = tuple(
            sorted(c for c in cands if c >= 16384)) or (cfg.gather_cap,)
        self._cam_cache: tuple | None = None
        # frames in flight: (cap, uploads, camera f32[19] on the host,
        # stage A packed) of the frame entered last
        self._pipe_carry: tuple | None = None
        # the native packer that writes the draw lists' uploads (None
        # where the library is not built), and on the card the pinned
        # ring they are written into, sized for the largest one-view
        # upload (a fused insert's)
        self._packer = native_bridge.pack_frame
        self._ring = None
        if self.device.type == "cuda":
            self._ring = graphs.PinnedRing(
                self.RING_SLOTS, _frame_words(cfg.visible_chunks_cap)
                + 3 * self.INSERT_KP + self.INSERT_FP)

    def _rebuild_tables(self) -> None:
        """The colour tables of ``config``'s shading and texture flags, on
        the host and as the step's device tables."""
        self._tables_np = build_quad_color_tables(
            self.atlas.kernel_tables(),
            enable_shading=self.config.enable_shading,
            enable_textures=self.config.enable_textures)
        self._base_step_kw["color_tables"] = proj_ops.color_table_tensors(
            self._tables_np, self.device)
        self._append_steps.clear()
        self._append_ins_steps.clear()
        self._graphs.clear()

    def set_shading(self, enable: bool) -> None:
        """Runtime toggle, the reference's F key: sets
        ``config.enable_shading`` (the config object the engine shares)
        and rebuilds the colour tables the step reads, dropping every graph
        (each captured the old tables' address), as the reference re-inits
        its jitted steps.  Everything else stays: the capacity buckets, the
        camera cache, the device buffers.  A frame in flight would be
        rastered with the new tables, so the toggle raises while one is
        (flush the pipeline first)."""
        if self._pipe_carry is not None:
            raise RuntimeError(
                "set_shading with a frame in flight; call pipeline_flush() "
                "first")
        self.config.enable_shading = enable
        self._rebuild_tables()

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

    def warm_buckets(self, quad_pool, pipelined: bool = False) -> None:
        """Capture every capacity bucket's graphs on a one-chunk draw list
        (one quad of pool slot 0, an identity camera), the results
        dropped, as the reference compiles each bucket's jit programs: the
        fused frame, the expansion (``prepare_uploads``), the static step
        and with ``RenderConfig.temporal_hiz`` the temporal step.
        ``pipelined`` also captures the frames-in-flight steps' graphs
        (the seeds, the prepared and the fused step; kernel K3; a drain
        replays the static step's).  On the card the kernels are built
        and loaded first (``_build.lib``).  Nothing is written: the pool,
        the camera cache and the frames-in-flight state are as they were,
        so every later frame is what it would be without the call."""
        if pipelined:
            self._check_pipelined()
        if self.device.type == "cuda":
            from .. import _build

            _build.lib()
        vcap = self.config.visible_chunks_cap
        eye, origin = np.eye(4, dtype=np.float32), np.zeros(3, np.float32)
        cam = _pack_cam(eye, origin)
        one = np.zeros((1, 6), np.int32)
        one[0, 0] = 1
        frame_np = _pack_frame(vcap, np.zeros(1, np.int32), one,
                               np.ones((1, 6), np.int32),
                               np.zeros((1, 3), np.int32), eye, origin)
        meta_np = frame_np[:_frame_words(vcap, camera=False)]
        # the frames-in-flight upload: the draw list's | the carried camera
        pipe_np = np.concatenate([frame_np, cam.view(np.int32)])
        for cap in self.gather_buckets:
            self._fused(quad_pool, frame_np, cap)
            up = self._expand(quad_pool, meta_np, cap)
            self.render_prepared(up, eye, origin)
            if self.config.temporal_hiz:
                self.render_prepared_hiz(up, eye, origin, self.empty_hiz())
            if pipelined:
                pre = self._pipe_seed(cap, up, cam)
                self._pipe_step(cap, up, cam, pre, up, cam)
                self._pipe_seed_fused(quad_pool, pipe_np, cap)
                self._pipe_fused_step(quad_pool, pipe_np, cap, up, pre)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_graph(self, name: str, cap: int, fn, fixed, inputs,
                   keep: int = 0):
        """``fn(*fixed, *inputs)`` from the graph of entry point ``name`` at
        gather bucket ``cap``, captured at its first call and again when
        ``fixed`` is other memory or an input another shape; the first
        ``keep`` inputs are copied in only when they are not the ones
        copied last.  Returns fn's outputs as fresh tensors."""
        g = self._graphs.get((name, cap))
        if g is None or not g.matches(fixed, inputs):
            g = self._graphs[name, cap] = graphs.CapturedCall(
                fn, fixed, inputs, device=self.device, pool=self._graph_pool)
        with prof.LOAD:
            for i, x in enumerate(inputs):
                g.load(i, x, keep=i < keep)
            for x in inputs:
                self.copied(x, (self.device,))
        return g.run()

    def _fused(self, quad_pool, frame, cap: int):
        """The frame of a changed draw list from its one upload ``frame``
        (``_frame_of``) at gather bucket ``cap``, from graph "fused"
        (``_fused_frame``).  Returns (color, depth, stats)."""
        return self._run_graph(
            "fused", cap, functools.partial(
                _fused_frame, vcap=self.config.visible_chunks_cap,
                gather_cap=cap, **self._bucket_kw(cap)),
            (quad_pool,), (frame,))

    def _fused_insert(self, quad_pool, frame, cap: int):
        """``_fused`` with the upload's insert payload scattered into
        ``quad_pool`` first, from graph "insert" (``_fused_frame_insert``).
        Returns (color, depth, stats)."""
        return self._run_graph(
            "insert", cap, functools.partial(
                _fused_frame_insert, vcap=self.config.visible_chunks_cap,
                gather_cap=cap, kp=self.INSERT_KP, mc=self.INSERT_MC,
                **self._bucket_kw(cap)),
            (quad_pool,), (frame,))

    def warm_fused_insert(self, quad_pool, slot: int, counts6, payload,
                          buckets) -> None:
        """Capture the fused insert frame's graph at each gather bucket of
        ``buckets`` on a one-chunk draw list: pool slot ``slot`` with its
        per-direction ``counts6``, all six directions kept, an identity
        camera; ``payload`` (QuadPool.prepare_insert_payload) scatters into
        ``quad_pool`` as a streaming frame's does.  The results are
        dropped."""
        frame_np = _pack_frame(
            self.config.visible_chunks_cap, np.array([slot], np.int32),
            np.asarray(counts6, np.int32).reshape(1, 6),
            np.ones((1, 6), np.int32), np.zeros((1, 3), np.int32),
            np.eye(4, dtype=np.float32), np.zeros(3, np.float32), payload)
        for cap in buckets:
            self._fused_insert(quad_pool, frame_np, cap)

    def _host_words(self, words: int):
        """A host buffer of ``words`` i32 for an upload: (what ``_upload``
        and the graphs take, its numpy view), a slot of the pinned ring on
        the card, a new array on the CPU."""
        if self._ring is None:
            a = np.empty(words, np.int32)
            return a, a
        return self._ring.take(words)

    def _upload(self, x) -> torch.Tensor:
        """An upload (``_host_words``) or a host array of 4-byte words -> a
        new device tensor.  On the card the copy runs from a slot of the
        pinned ring (an array is written into one first) and does not
        block the host (a pageable copy would wait for every queued
        kernel)."""
        if self._ring is None:
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if isinstance(x, np.ndarray):
            arr = np.ascontiguousarray(x)
            up, out = self._ring.take(arr.size)
            out[:] = arr.reshape(-1).view(np.int32)
            x = up.view(torch.from_numpy(arr[:0]).dtype).reshape(arr.shape)
        prof.mark_enqueue()
        t = x.to(self.device, non_blocking=True)
        self.copied(x, (self.device,))
        return t

    def copied(self, up, devices) -> None:
        """The copies of upload ``up`` (``_frame_of``, ``pack_views``) onto
        ``devices`` are enqueued: on the card its slot of the pinned ring
        is written again only once they have run (``PinnedRing.copied``).
        Nothing where ``up`` is no slot."""
        if self._ring is not None:
            self._ring.copied(up, devices)

    def _prep_meta(self, visible_slots, counts_sel, positions_sel,
                   dir_mask):
        """Draw-list normalization shared by every entry point (reference
        ``Renderer._prep_meta``): ``counts_sel`` is [vcap, 6] per-direction
        counts or legacy [vcap] totals, which become one dir-0 unit a
        chunk; a list past the largest bucket loses its suffix units'
        quads.  Returns (slots, counts6, mask6, positions, cap, total)."""
        counts6 = _normalize_counts6(counts_sel)
        mask6 = (np.ones_like(counts6) if dir_mask is None
                 else np.asarray(dir_mask, np.int64))
        total = int((counts6 * mask6).sum())
        cap = self.bucket_for(total)
        if total > cap:
            counts6, total = _truncate_units(counts6, mask6, cap)
        slots_a = np.asarray(visible_slots, np.int32)
        pos_a = np.asarray(positions_sel, np.int32)
        if slots_a.max(initial=0) > 32767 or np.abs(pos_a).max() > 32767:
            raise ValueError(
                "draw-list meta exceeds int16 range (pool slot > 32767 "
                "or |chunk grid coord| > 32767)")
        return slots_a, counts6, mask6, pos_a, cap, total

    def _pack_into(self, out: np.ndarray, visible_slots, counts_sel,
                   positions_sel, dir_mask, view_proj, cam_pos,
                   payload=None):
        """Writes a draw list's upload (``_pack_frame``'s words; the meta
        alone where ``view_proj`` is None) into ``out`` and returns (its
        gather bucket, its quads).  The native packer writes it, without
        the twin's normalization (``_prep_meta``); the twin,
        ``_pack_frame``, where the native library is not built and for a
        list past the largest bucket, whose suffix units lose quads.
        Counts ``pack_native`` or ``pack_numpy``."""
        vcap = self.config.visible_chunks_cap
        if self._packer is not None:
            total = self._packer(out, vcap, visible_slots, counts_sel,
                                 dir_mask, positions_sel, view_proj, cam_pos,
                                 payload)
            cap = self.bucket_for(total)
            if total <= cap:
                prof.PACK_NATIVE.add(1)
                return cap, total
        prof.PACK_NUMPY.add(1)
        slots_a, counts6, mask6, pos_a, cap, total = self._prep_meta(
            visible_slots, counts_sel, positions_sel, dir_mask)
        out[:] = _pack_frame(vcap, slots_a, counts6, mask6, pos_a, view_proj,
                             cam_pos, payload)
        return cap, total

    def _frame_of(self, visible_slots, counts_sel, positions_sel, dir_mask,
                  view_proj, cam_pos, payload=None):
        """A draw list's one upload (``_pack_into``, in ``_host_words``)
        and its gather bucket: (upload, cap, total)."""
        up, out = self._host_words(_frame_words(
            self.config.visible_chunks_cap, payload=payload))
        cap, total = self._pack_into(out, visible_slots, counts_sel,
                                     positions_sel, dir_mask, view_proj,
                                     cam_pos, payload)
        return up, cap, total

    def _cam_upload(self, *cams):
        """Cameras packed by ``_pack_cam`` as one f32 upload (19 floats a
        camera), on the card written into a slot of the pinned ring."""
        if self._ring is None:
            return np.concatenate(cams)
        up, out = self._ring.take(19 * len(cams))
        f = out.view(np.float32)
        for j, cam in enumerate(cams):
            f[19 * j:19 * j + 19] = cam
        return up.view(torch.float32)

    def _expand(self, quad_pool, meta_up, cap: int):
        """The stream of the draw list whose meta upload is ``meta_up``
        (``_pack_into`` without a camera) at gather bucket ``cap``, from
        graph "expand" (``_expand_frame``): (quads, quad_world, total),
        fresh tensors."""
        return self._run_graph(
            "expand", cap, functools.partial(
                _expand_frame, vcap=self.config.visible_chunks_cap,
                gather_cap=cap),
            (quad_pool,), (meta_up,))

    def prepare_uploads(self, quad_pool, visible_slots, counts_sel,
                        positions_sel, dir_mask=None):
        """Expand the draw list into the device quad stream from its
        11-short meta, one upload (the meta of ``render_fused``'s), from
        the graph of its bucket (``_expand``); cacheable while the draw
        list (with its dir mask) is unchanged.  Returns (quads,
        quad_world, total)."""
        vcap = self.config.visible_chunks_cap
        with prof.PREPARE:
            up, out = self._host_words(_frame_words(vcap, camera=False))
            cap, _ = self._pack_into(out, visible_slots, counts_sel,
                                     positions_sel, dir_mask, None, None)
            return self._expand(quad_pool, up, cap)

    def pack_views(self, views):
        """The uploads of a batch of views (``Engine.render_views``):
        ``views`` [(draw list (app/engine.DrawList), view_proj, cam_pos)].
        Each view's row is its ``render_fused`` upload (``_pack_into``),
        all in one ``_host_words`` buffer (on the card, one slot of the
        pinned ring); the batch takes the gather bucket of its largest
        stream.  Returns (i32[B, L], the gather cap, the quads of all the
        views' streams)."""
        n = _frame_words(self.config.visible_chunks_cap)
        up, out = self._host_words(len(views) * n)
        cap, quads = 0, 0
        for j, (dl, view_proj, cam_pos) in enumerate(views):
            c, total = self._pack_into(out[j * n:(j + 1) * n], dl.slots,
                                       dl.counts6, dl.positions, dl.dir_mask,
                                       view_proj, cam_pos)
            cap, quads = max(cap, c), quads + total
        return up.reshape(len(views), n), cap, quads

    def render_fused(self, quad_pool, visible_slots, counts_sel,
                     positions_sel, view_proj, cam_pos, dir_mask=None):
        """Draw-list expansion + step (the draw-list-changed frame) from
        one upload and the graph of its bucket: (color, depth, stats).  The
        expanded stream is not kept (``prepare_uploads`` makes it for the
        static frames)."""
        with prof.PREPARE:
            frame, cap, _ = self._frame_of(visible_slots, counts_sel,
                                           positions_sel, dir_mask,
                                           view_proj, cam_pos)
        return self._fused(quad_pool, frame, cap)

    def _cam_dev(self, view_proj, cam_pos):
        """Device copy of the packed camera (``_cam_upload``), cached while
        it holds."""
        key = (np.asarray(view_proj, np.float32).tobytes(),
               np.asarray(cam_pos, np.float32).tobytes())
        c = self._cam_cache
        if c is not None and c[0] == key:
            return c[1]
        dev = self._upload(self._cam_upload(_pack_cam(view_proj, cam_pos)))
        self._cam_cache = (key, dev)
        return dev

    def render_prepared(self, uploads, view_proj, cam_pos):
        """Step on a cached stream (the static frame): (color, depth,
        stats).  The stream is copied into the graph's buffers only when it
        is not the one copied last."""
        cap = int(uploads[0].shape[0])
        with prof.PREPARE:
            cam = self._cam_upload(_pack_cam(view_proj, cam_pos))
        return self._run_graph(
            "prepared", cap,
            functools.partial(_step_camf, **self._bucket_kw(cap)), (),
            (*uploads, cam), keep=3)

    def empty_hiz(self) -> torch.Tensor:
        """+inf seed pyramid f32[ceil(H/8), ceil(W/8)]: culls nothing (the
        first static frame's input)."""
        h, w = self.config.height, self.config.width
        prof.mark_enqueue()
        return torch.full(((h + 7) // 8, (w + 7) // 8), float("inf"),
                          dtype=torch.float32, device=self.device)

    def render_prepared_hiz(self, uploads, view_proj, cam_pos, hiz1):
        """Static-camera temporal step (``RenderConfig.temporal_hiz``): the
        step on a cached stream with the previous frame's max pyramid
        ``hiz1`` culling quads.  Returns (color, depth, stats, the new
        pyramid).  The caller passes a pyramid rendered from the same
        camera, draw list and world, else ``empty_hiz()``."""
        cap = int(uploads[0].shape[0])
        with prof.PREPARE:
            cam = self._cam_upload(_pack_cam(view_proj, cam_pos))
        return self._run_graph(
            "hiz", cap,
            functools.partial(_step_camf_hiz, **self._bucket_kw(cap)), (),
            (*uploads, cam, hiz1), keep=3)

    def render_fused_insert(self, quad_pool, visible_slots, counts_sel,
                            positions_sel, view_proj, cam_pos,
                            insert_payload, dir_mask=None):
        """Streaming frame: mesh insert + expansion + step with one upload
        (QuadPool.prepare_insert_payload gives ``insert_payload``).  The
        pool is updated in place.  Returns (color, depth, stats)."""
        if insert_payload.shape != (3 * self.INSERT_KP + self.INSERT_FP,):
            raise ValueError(f"insert payload of shape {insert_payload.shape}")
        with prof.PREPARE:
            frame, cap, _ = self._frame_of(
                visible_slots, counts_sel, positions_sel, dir_mask,
                view_proj, cam_pos, insert_payload)
        return self._fused_insert(quad_pool, frame, cap)

    def _resident_kw(self, gather_cap: int) -> dict:
        kw = self._bucket_kw(gather_cap)
        if kw.pop("near_quads", 0):
            raise ValueError(
                "resident mode does not compose with two_pass_near_quads "
                "(the near/far split would need the per-frame draw list)")
        return dict(kw, append_cap=resident_append_cap(gather_cap))

    def _append_step_for(self, gather_cap: int):
        got = self._append_steps.get(gather_cap)
        if got is None:
            got = functools.partial(_step_camf_append,
                                    **self._resident_kw(gather_cap))
            self._append_steps[gather_cap] = got
        return got

    def render_prepared_append(self, uploads, view_proj, cam_pos, quad_pool,
                               ameta: np.ndarray, offset: int):
        """Resident-stream streaming frame: the pending batch (``ameta``
        from pack_append_meta) appended at ``offset`` and the frame
        rendered from the appended stream (``_step_camf_append``).  Returns
        (color, depth, stats, (quads2, quad_world2)); the caller tracks the
        new total (offset + batch)."""
        quads, qw, total = uploads
        step = self._append_step_for(int(quads.shape[0]))
        color, depth, stats, q2, w2 = step(
            quads, qw, total, self._cam_dev(view_proj, cam_pos), quad_pool,
            self._upload(np.asarray(ameta, np.int32)), int(offset))
        return color, depth, stats, (q2, w2)

    def _append_ins_step_for(self, gather_cap: int):
        got = self._append_ins_steps.get(gather_cap)
        if got is None:
            got = functools.partial(
                _step_camf_append_insert, kp=RESIDENT_INSERT_KP,
                mc=RESIDENT_INSERT_MC, **self._resident_kw(gather_cap))
            self._append_ins_steps[gather_cap] = got
        return got

    def render_prepared_append_insert(self, uploads, view_proj, cam_pos,
                                      quad_pool, ameta: np.ndarray,
                                      offset: int, payload: np.ndarray):
        """Resident-stream streaming frame with the batch's pool scatter,
        one upload (``_step_camf_append_insert``); ``payload`` from
        QuadPool.prepare_insert_payload at the resident shape
        (RESIDENT_INSERT_KP/_MC/_FP).  The pool is updated in place.
        Returns (color, depth, stats, (quads2, quad_world2))."""
        quads, qw, total = uploads
        step = self._append_ins_step_for(int(quads.shape[0]))
        frame_i = np.concatenate([
            np.asarray(ameta, np.int32),
            _pack_cam(view_proj, cam_pos).view(np.int32),
            np.asarray([offset], np.int32),
            np.asarray(payload, np.uint32).view(np.int32)])
        color, depth, stats, q2, w2 = step(
            quads, qw, total, self._upload(frame_i), quad_pool)
        return color, depth, stats, (q2, w2)

    def render(self, quad_pool, visible_slots, counts_sel, positions_sel,
               view_proj, cam_pos):
        """Returns (color int32[H, W] as ARGB bits, depth f32[H, W],
        stats): ``prepare_uploads`` then ``render_prepared``.
        ``visible_slots``/``counts_sel``/``positions_sel`` are the host
        per-visible-chunk pool slots, quad counts ([vcap] totals or [vcap,
        6] per direction) and chunk grid positions, front to back and
        zero-padded."""
        uploads = self.prepare_uploads(quad_pool, visible_slots, counts_sel,
                                       positions_sel)
        return self.render_prepared(uploads, view_proj, cam_pos)

    # ------------------------------------------- frames-in-flight pipeline
    def _check_pipelined(self) -> None:
        cfg = self.config
        if (cfg.temporal_hiz or cfg.two_pass_near_quads or cfg.span_mode
                or cfg.packed_raster):
            raise ValueError(
                "pipelined rendering excludes temporal_hiz, two-pass "
                "occlusion, span mode and the packed kernel")

    def _geom_kw(self) -> dict:
        k = self._base_step_kw
        return dict(width=k["width"], height=k["height"],
                    backface_culling=k["backface_culling"])

    def _count_pipe(self) -> None:
        """Counts a frames-in-flight step, seed or drain: ``pipe_graph`` on
        the card, ``pipe_eager`` on the CPU (where a graph runs its
        function)."""
        (prof.PIPE_GRAPH if self.device.type == "cuda"
         else prof.PIPE_EAGER).add(1)

    def _pipe_graph(self, name: str, cap: int, fn, fixed, inputs,
                    keep: int = 0):
        """``_run_graph`` for a frames-in-flight step (``_count_pipe``)."""
        self._count_pipe()
        return self._run_graph(name, cap, fn, fixed, inputs, keep)

    def _pipe_seed(self, cap: int, uploads, cam):
        """The carried stage A (``_pack_pre``) of prepared stream
        ``uploads`` seen by ``cam`` (``_pack_cam``), which seeds an empty
        pipeline, from graph "pipe_seed"."""
        with prof.PREPARE:
            cam_up = self._cam_upload(cam)
        return self._pipe_graph(
            "pipe_seed", cap,
            functools.partial(_pipe_seed_step, **self._geom_kw()), (),
            (*uploads, cam_up), keep=3)

    def _pipe_step(self, cap: int, up_p, cam_p, pre_p, uploads, cam):
        """The carried frame (stream ``up_p``, camera ``cam_p``, stage A
        ``pre_p``) rendered with stage A of prepared stream ``uploads`` seen
        by ``cam`` in its raster launch (K3), from graph "pipe_prepared":
        (color, depth, stats, the new stage A packed).  A stream is copied
        into the graph only when it is not the one copied there last."""
        with prof.PREPARE:
            cams = self._cam_upload(cam_p, cam)
        return self._pipe_graph(
            "pipe_prepared", cap,
            functools.partial(_pipe_prepared_step, **self._bucket_kw(cap)),
            (), (*up_p, *uploads, cams, pre_p), keep=6)

    def _pipe_seed_fused(self, quad_pool, frame, cap: int):
        """A changed draw list's upload ``frame`` (as ``_pipe_fused_step``
        takes it, the carried camera unread) expanded and its stage A, which
        seed an empty pipeline, from graph "pipe_seed_fused": (stage A
        packed, quads, qw, total)."""
        return self._pipe_graph(
            "pipe_seed_fused", cap, functools.partial(
                _pipe_seed_fused_step, vcap=self.config.visible_chunks_cap,
                gather_cap=cap, **self._geom_kw()),
            (quad_pool,), (frame,))

    def _pipe_fused_step(self, quad_pool, frame, cap: int, up_p, pre_p):
        """The carried frame (stream ``up_p``, stage A ``pre_p``, its camera
        in ``frame``) rendered with the changed draw list's expansion and
        stage A in the same step, from graph "pipe_fused": (color, depth,
        stats, the new stage A packed, quads, qw, total)."""
        return self._pipe_graph(
            "pipe_fused", cap, functools.partial(
                _pipe_fused_step, vcap=self.config.visible_chunks_cap,
                gather_cap=cap, **self._bucket_kw(cap)),
            (quad_pool,), (*up_p, frame, pre_p), keep=3)

    def render_prepared_pipelined(self, uploads, view_proj, cam_pos):
        """Frames-in-flight render (one frame of latency): enter frame N
        (its stage A rides in the carried frame's raster launch, K3) and
        return frame N-1's (color, depth, stats), or None when the pipeline
        was empty (drain the tail with pipeline_flush).  Exactly one result
        is emitted per entered frame across render_*_pipelined /
        pipeline_flush calls, in order, each equal to render_prepared's
        frame bit for bit.  Each step replays a graph of its bucket; the
        carry keeps references to frame N-1's stream; nothing writes a
        stream in place."""
        self._check_pipelined()
        cap = int(uploads[0].shape[0])
        cam = _pack_cam(view_proj, cam_pos)
        out, carry = self._pipe_drain_if(cap)
        if carry is None:
            with prof.PIPE_DRAIN if out is not None else prof.NOOP:
                pre = self._pipe_seed(cap, uploads, cam)
        else:
            _, up_p, cam_p, pre_p = carry
            color, depth, stats, pre = self._pipe_step(cap, up_p, cam_p,
                                                       pre_p, uploads, cam)
            out = color, depth, stats
        self._pipe_carry = (cap, uploads, cam, pre)
        return out

    def render_fused_pipelined(self, quad_pool, visible_slots, counts_sel,
                               positions_sel, view_proj, cam_pos,
                               dir_mask=None):
        """Pipelined render with the CURRENT frame's draw-list expansion in
        the same step (the moving/streaming path), from one upload: the
        draw list's (``_pack_into``) with the carried frame's camera after
        it.  Returns (result_or_None, uploads): ``result`` is the OLDEST
        pending frame's (color, depth, stats) and ``uploads`` frame N's
        expanded stream."""
        self._check_pipelined()
        n = _frame_words(self.config.visible_chunks_cap)
        with prof.PREPARE:
            frame, words = self._host_words(n + 19)
            cap, _ = self._pack_into(words[:n], visible_slots, counts_sel,
                                     positions_sel, dir_mask, view_proj,
                                     cam_pos)
            cam = _pack_cam(view_proj, cam_pos)
        out, carry = self._pipe_drain_if(cap)
        if carry is None:
            words[n:] = 0
            with prof.PIPE_DRAIN if out is not None else prof.NOOP:
                pre, *uploads = self._pipe_seed_fused(quad_pool, frame, cap)
        else:
            _, up_p, cam_p, pre_p = carry
            words[n:] = cam_p.view(np.int32)
            color, depth, stats, pre, *uploads = self._pipe_fused_step(
                quad_pool, frame, cap, up_p, pre_p)
            out = color, depth, stats
        uploads = tuple(uploads)
        self._pipe_carry = (cap, uploads, cam, pre)
        return out, uploads

    def _pipe_drain_if(self, cap: int):
        """Drain a carry of another bucket.  Returns (result_or_None,
        carry_or_None): ``carry`` is usable for a pipelined step at
        ``cap``; ``result`` must be emitted first."""
        carry = self._pipe_carry
        if carry is not None and carry[0] != cap:
            return self.pipeline_flush(), None
        return None, carry

    def pipeline_flush(self):
        """Drain the frames-in-flight state: render the carried frame
        serially, from the static step's graph (its stage A runs again:
        the same math, the same frame), in span ``pipe_drain``.  Returns
        (color, depth, stats) or None."""
        carry = self._pipe_carry
        if carry is None:
            return None
        self._pipe_carry = None
        cap, up, cam, _pre = carry
        prof.PIPE_DRAINS.add(1)
        with prof.PIPE_DRAIN:
            self._count_pipe()
            return self.render_prepared(up, *_unpack_cam(cam))


def make_repeated_step(renderer: Renderer, n_frames: int):
    """N full render steps over per-frame cameras, for measuring the
    step's device time with the host out of the way (the reference's
    ``make_repeated_step``, N steps inside one jit).

    Returns ``run(quads, quad_world, n_quads, vps, cams)``: ``quads``
    i32[GQ], ``quad_world`` f32[3, GQ] and ``n_quads`` (an i32 device
    scalar or an int) an expanded stream (``Renderer.prepare_uploads``),
    ``vps`` f32[N, 4, 4] and ``cams`` f32[N, 3] the cameras.  Each step is
    ``render_step`` with the renderer's configuration: its colour tables,
    frame and tile, span mode, backface culling and packed raster, the
    render cap ``quads_cap`` and the item cap ``tile_k_cap`` (the two-pass
    and temporal modes are not applied, as in the reference).  ``run``
    returns the last frame's (color, depth, stats).

    On the card the N steps run eagerly at the first call with a stream of
    GQ quads and are captured into one CUDA graph over static input
    buffers (``graphs.CapturedCall``); each later call copies its inputs
    into those buffers and replays the graph, so K1 and K2 (K4 with
    ``packed_raster``, K1's span instance in span mode) launch N times a
    call from one host call.  The step makes no host sync, so it captures
    whole.  The returned frame is a copy.  On the CPU ``run`` is a plain
    loop over ``render_step`` on the same buffers."""
    if n_frames < 1:
        raise ValueError("make_repeated_step needs at least one frame")
    cfg = renderer.config
    kw = {k: v for k, v in renderer._base_step_kw.items()
          if k != "near_quads"}
    kw.update(render_cap=cfg.quads_cap, tile_k_cap=cfg.tile_k_cap)
    dev = renderer.device
    calls: dict[int, graphs.CapturedCall] = {}

    def steps(quads, quad_world, n_quads, vps, cams):
        out = None
        for i in range(n_frames):
            out = render_step(quads, quad_world, n_quads, vps[i], cams[i],
                              **kw)
        return out

    def run(quads, quad_world, n_quads, vps, cams):
        vps = torch.as_tensor(vps, dtype=torch.float32)
        cams = torch.as_tensor(cams, dtype=torch.float32)
        if vps.shape != (n_frames, 4, 4) or cams.shape != (n_frames, 3):
            raise ValueError(f"vps must be f32[{n_frames}, 4, 4] and cams "
                             f"f32[{n_frames}, 3]")
        inputs = (quads, quad_world, n_quads, vps, cams)
        gq = quads.shape[0]
        call = calls.get(gq)
        if call is None or not call.matches((), inputs):
            call = calls[gq] = graphs.CapturedCall(steps, (), inputs,
                                                   device=dev)
        for i, x in enumerate(inputs):
            call.load(i, x)
        return call.run()

    return run
