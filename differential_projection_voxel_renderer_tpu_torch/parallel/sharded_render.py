"""Row bands and camera batches: the sharded render entry points on one
card.

Counterpart of ``differential_projection_voxel_renderer_tpu/parallel/
sharded_render.py``, which shards a camera batch over the ``dp`` axis and
framebuffer row bands over the ``tp`` axis of a device mesh.  The port
keeps the decomposition and its outputs on one card, without a mesh:

- ``make_mesh`` gives the same (dp, tp) factorization of a device count,
  as two integers;
- a ``tp`` band is one ``render_step`` on its rows (``band_y0``/
  ``band_h``: the quads that touch the band, rasterized by one K2 launch
  into a band-sized frame at global pixel NDC), and the bands stacked
  equal the full frame bit for bit;
- the ``dp`` axis is a loop over the camera batch;
- the reference's one collective, ``psum(count, "tp") // tp`` of the
  bands' rasterized counts, is their sum over the bands, divided by tp.
"""

from __future__ import annotations

import torch

from ..ops import projection as proj_ops
from ..ops.raster import pick_tile
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..rendering.pipeline import render_step, resolve_device


def make_mesh(n_devices: int | None = None) -> tuple[int, int]:
    """The (dp, tp) factorization of ``n_devices`` (by default the CUDA
    device count) that the reference's mesh takes: tp gets the larger
    factor (framebuffer bands are the finer-grained axis)."""
    n = n_devices or max(1, torch.cuda.device_count())
    dp = 1
    for cand in (4, 3, 2):
        if n % cand == 0 and n // cand > 1:
            dp = n // cand if cand >= n // cand else cand
            break
    dp = max(1, min(dp, n))
    while n % dp:
        dp -= 1
    return dp, n // dp


def _color_tables(color_tables, device):
    """Shading tables (numpy, ops/shading.build_quad_color_tables; the
    default atlas when None) as the step's device tables."""
    if color_tables is None:
        color_tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    return proj_ops.color_table_tensors(color_tables, device)


def _render_one_camera(pool, counts_all, positions, visible_slots,
                       n_visible, view_proj, cam_pos, color_tables, *,
                       width: int, height: int, gather_cap: int,
                       render_cap: int, band_y0: int, band_h: int,
                       span_mode: bool = False, tile_k_cap: int = 8192):
    """One camera's gather and render step on one row band: the pool rows
    of the first ``n_visible`` visible slots, ``counts_all`` quads each,
    flattened to a ``gather_cap`` stream with a searchsorted over the
    per-chunk totals.  Returns (color, depth [band_h, W], the band's
    rasterized count)."""
    dev = pool.device
    vcap = visible_slots.shape[0]
    sel = torch.clamp(visible_slots, 0, pool.shape[0] - 1).long()
    counts = torch.where(torch.arange(vcap, device=dev) < n_visible,
                         counts_all[sel], 0).long()
    world = positions[sel].float() * 32.0
    chunk_world = tuple(world[:, a] for a in range(3))
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    i = torch.arange(gather_cap, device=dev)
    chunk_of = torch.clamp(torch.searchsorted(cum, i, right=True), 0,
                           vcap - 1)
    base = torch.where(chunk_of > 0, cum[torch.clamp(chunk_of - 1, min=0)],
                       0)
    within = torch.clamp(i - base, 0, pool.shape[1] - 1)
    quads = pool[sel[chunk_of], within]
    wq = proj_ops.quad_world_from_slots(chunk_world, chunk_of)
    tile_h, tile_w = pick_tile(height, width)
    color, depth, stats = render_step(
        quads, torch.stack(wq), torch.clamp(total, max=gather_cap),
        view_proj, cam_pos, color_tables=color_tables, width=width,
        height=height, tile_h=tile_h, tile_w=tile_w, render_cap=render_cap,
        span_mode=span_mode, backface_culling=True, tile_k_cap=tile_k_cap,
        band_y0=band_y0, band_h=band_h)
    return color, depth, stats[1]


def make_sharded_render(mesh: tuple[int, int], *, width: int, height: int,
                        gather_cap: int = 8192, render_cap: int = 4096,
                        tile_k_cap: int = 8192, color_tables=None,
                        span_mode: bool = False, device="cuda"):
    """The dp x tp render of a camera batch; ``mesh`` = (dp, tp) from
    ``make_mesh``.  Returns ``fn(pool, counts, positions, visible_slots,
    n_visible, view_proj, cam_pos)`` over tensors on ``device``:

    - pool i32[P, QCAP] quad words, counts i32[P], positions i32[P, 3];
    - visible_slots i32[B, VCAP], n_visible i32[B], view_proj
      f32[B, 4, 4], cam_pos f32[B, 3], B a multiple of dp;

    and it returns color i32[B, H, W], depth f32[B, H, W] (each the tp
    bands stacked) and i32[B], the sum of the bands' rasterized counts
    divided by tp (each band counts the quads that touch it).
    ``tile_k_cap`` is the reference's per-camera binning cap (there fixed
    at its default, 8192), here a keyword so that a 720p frame fits.
    ``span_mode`` renders every band in span mode.  ``dp`` changes no
    frame: every camera is rendered in turn, and it is kept, with its
    check that it divides B, for parity with the reference's
    signature."""
    dp, tp = mesh
    if height % (tp * 8):
        raise ValueError("height must split into 8-aligned bands")
    band_h = height // tp
    tables = _color_tables(color_tables, resolve_device(device))

    def fn(pool, counts, positions, visible_slots, n_visible, view_proj,
           cam_pos):
        b = visible_slots.shape[0]
        if b % dp:
            raise ValueError(f"a batch of {b} cameras over dp = {dp}")
        colors, depths, totals = [], [], []
        for i in range(b):
            bands = [_render_one_camera(
                pool, counts, positions, visible_slots[i], n_visible[i],
                view_proj[i], cam_pos[i], tables, width=width,
                height=height, gather_cap=gather_cap, render_cap=render_cap,
                band_y0=t * band_h, band_h=band_h, span_mode=span_mode,
                tile_k_cap=tile_k_cap)
                for t in range(tp)]
            colors.append(torch.cat([c for c, _, _ in bands]))
            depths.append(torch.cat([d for _, d, _ in bands]))
            totals.append(sum(n for _, _, n in bands) // tp)
        return torch.stack(colors), torch.stack(depths), torch.stack(totals)

    return fn


def make_sharded_render_dp(mesh_or_n: int | tuple[int, int] | None = None,
                           *, width: int, height: int,
                           render_cap: int = 4096, tile_k_cap: int = 8192,
                           color_tables=None, device="cuda"):
    """The camera batch, each camera's full frame by the production step
    (the reference's 1-D dp mesh over every device, one camera a chip).
    ``mesh_or_n``: a device count, or a (dp, tp) pair whose product is
    taken (by default the CUDA device count).  Returns (fn, n):
    ``fn(quads i32[B, GQ], quad_world f32[B, 3, GQ], n_quads i32[B],
    view_proj f32[B, 4, 4], cam_pos f32[B, 3])``, B a multiple of n,
    returns color i32[B, H, W], depth f32[B, H, W] and stats i32[B, 6]."""
    if isinstance(mesh_or_n, tuple):
        n = mesh_or_n[0] * mesh_or_n[1]
    else:
        n = mesh_or_n or max(1, torch.cuda.device_count())
    tables = _color_tables(color_tables, resolve_device(device))
    tile_h, tile_w = pick_tile(height, width)

    def fn(quads, quad_world, n_quads, view_proj, cam_pos):
        b = quads.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} cameras over {n} devices")
        outs = [render_step(
            quads[i], quad_world[i], n_quads[i], view_proj[i], cam_pos[i],
            color_tables=tables, width=width, height=height, tile_h=tile_h,
            tile_w=tile_w, render_cap=render_cap, backface_culling=True,
            tile_k_cap=tile_k_cap) for i in range(b)]
        return tuple(torch.stack(x) for x in zip(*outs))

    return fn, n
