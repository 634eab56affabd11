"""Frame parity gates, the self-tests built on them, and small scenes,
for runs without JAX (the card's machine: chip_smoke.py,
tests/test_torch_cuda.py).

The gates are those of ``differential_projection_voxel_renderer_tpu/
rendering/parity.py``: full-frame equality, or equality up to mismatches
that are proven (in float64) to be coverage-edge or near-depth-tie
ambiguity.  ``run_hardware_selftest`` (the fuzz chunk) and
``run_production_parity`` (a real frame's stream) render one frame
through the kernels and through their plain twins on the same device and
apply the gates; ``run_pipelined_selftest`` holds the frames-in-flight
step (kernel K3) to the serial one, ``run_fused_insert_selftest`` and
``run_resident_append_selftest`` the one-call streaming frames to the
separate calls; ``run_selftests`` runs them all.  The scenes are the
reference fuzz chunk at 128x128 and a 3x3 patch of terrain chunks at
640x128, flattened into a gather stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..meshing.greedy import mesh_chunk
from ..models.camera import Camera
from ..models.chunk import Chunk
from ..ops import geometry, projection, raster, raster_packed
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..utils.config import SKY_COLOR, RenderConfig


def assert_kernel_parity(c1, d1, c2, d2):
    """Full-frame equality of colour and depth."""
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(c1, c2)


def assert_kernel_parity_boundary(c1, d1, c2, d2, records, *,
                                  max_frac=5e-4):
    """Equality up to provable ambiguity: every mismatching pixel must lie
    within 4 f32 ulps of some record's coverage edge, or be a near-z-tie
    between two covering records; at most ``max_frac`` of the frame may
    differ.  ``records`` is the i32[24, cap] raster input.  Returns the
    mismatch count."""
    mism = np.argwhere((d1 != d2) | (c1 != c2))
    if len(mism) == 0:
        return 0
    assert len(mism) <= max(1, int(max_frac * d1.size)), (
        f"{len(mism)} mismatching pixels (> {max_frac:.1e} of frame)")
    f = np.asarray(records)[:16].view(np.float32).astype(np.float64)
    H_, W_ = d1.shape
    for yy, xx in mism:
        if (c1[yy, xx] == c2[yy, xx]
                and np.isfinite(d1[yy, xx]) and np.isfinite(d2[yy, xx])
                and abs(d1[yy, xx] - d2[yy, xx]) <= 4 * np.spacing(
                    np.float32(max(abs(d1[yy, xx]), 1.0)))):
            continue  # z rounding variance, same winner
        nx = (2.0 * (xx + 0.5) - W_) / W_
        ny = 1.0 - 2.0 * (yy + 0.5) / H_
        qu = f[0] * nx + f[1] * ny + f[2]
        qv = f[3] * nx + f[4] * ny + f[5]
        qw = f[6] * nx + f[7] * ny + f[8]
        margins = np.stack([
            np.abs(qu - f[12] * qw), np.abs(qu - f[13] * qw),
            np.abs(qv - f[14] * qw), np.abs(qv - f[15] * qw),
        ])
        term = np.maximum.reduce([
            np.abs(f[0] * nx), np.abs(f[1] * ny), np.abs(f[2]),
            np.abs(f[3] * nx), np.abs(f[4] * ny), np.abs(f[5]),
            np.abs(f[12] * qw), np.abs(f[13] * qw),
            np.abs(f[14] * qw), np.abs(f[15] * qw),
            np.ones_like(qu),
        ])
        ulp = np.spacing(term.astype(np.float32)).astype(np.float64)
        on_edge = (qw > 0) & (margins.min(axis=0) <= 4.0 * ulp)
        slack = 4.0 * ulp
        covers = ((qw > 0)
                  & (qu >= f[12] * qw - slack) & (qu <= f[13] * qw + slack)
                  & (qv >= f[14] * qw - slack) & (qv <= f[15] * qw + slack))
        z = f[9] * nx + f[10] * ny + f[11]
        d1v, d2v = float(d1[yy, xx]), float(d2[yy, xx])
        zt_tie = 4 * np.spacing(np.float32(max(abs(d1v), abs(d2v), 1.0)))
        near_tie = (np.isfinite(d1v) and np.isfinite(d2v)
                    and abs(d1v - d2v) <= zt_tie)
        if near_tie:
            tied = (covers & ((np.abs(z - d1v) <= zt_tie)
                              | (np.abs(z - d2v) <= zt_tie)))
            near_tie = int(tied.sum()) >= 2
        assert on_edge.any() or near_tie, (
            f"pixel ({yy},{xx}) differs but no record is within 4 ulps "
            f"of a coverage edge there and the depths are not a provable "
            f"near-tie between two covering records")
        for dv in (d1v, d2v):
            if np.isfinite(dv):
                zt = 4 * np.spacing(np.float32(max(abs(dv), 1.0)))
                assert (covers & (np.abs(z - dv) <= zt)).any(), (
                    f"pixel ({yy},{xx}): depth {dv} matches no covering "
                    f"record")
    return len(mism)


def frame_parity(c1, d1, c2, d2, records) -> str:
    """'exact', or 'boundary-ok (N px)' when the boundary gate proves
    every mismatch; raises AssertionError otherwise."""
    try:
        assert_kernel_parity(c1, d1, c2, d2)
        return "exact"
    except AssertionError:
        n = assert_kernel_parity_boundary(c1, d1, c2, d2, records)
        return f"boundary-ok ({n} px)"


def fuzz_chunk(seed=42) -> Chunk:
    """The reference fuzz scene: a hilly heightfield of random blocks."""
    rng = np.random.default_rng(seed)
    x = np.arange(32)
    height = ((np.sin(x / 32 * 10) * 2)[None, :]
              + (np.cos(x / 32 * 10) * 2)[:, None] + 8)
    y = np.arange(32)[None, :, None]
    types = rng.integers(1, 4, size=(32, 32, 32)).astype(np.uint8)
    return Chunk.varied((0, 0, 0), np.where(y < height[:, None, :], types,
                                            0).astype(np.uint8))


def fuzz_chunk_mono(seed=43) -> Chunk:
    """A single-block-type heightfield in 4-block terraces: greedy merging
    keeps it under the fused-insert payload's per-mesh cap
    (Renderer.INSERT_MC = 512 quads)."""
    rng = np.random.default_rng(seed)
    x = np.arange(32)
    hx = np.sin(x / 32 * 8 + rng.uniform(0, 3)) * 3
    hz = np.cos(np.arange(32) / 32 * 6 + rng.uniform(0, 3)) * 3
    height = ((hx[None, :] + hz[:, None] + 10) // 4) * 4  # [z, x]
    y = np.arange(32)[None, :, None]
    solid = y < height[:, None, :]
    blocks = np.where(solid, np.uint8(1), np.uint8(0)).astype(np.uint8)
    return Chunk.varied((0, 0, 0), blocks)


# name -> (width, height, gather cap, camera position, camera target)
SMALL_SCENES = {
    "fuzz 128x128": (128, 128, 4096, (16.0, 48.0, 16.0), (16.0, 8.0, 16.0)),
    "terrain 640x128": (640, 128, 16384, (0.0, 40.0, 70.0),
                        (0.0, 8.0, 0.0)),
}

# (camera position, target) among the terrain patch's chunks, whose streams
# at the terrain scene's size hold quads that straddle the near plane (the
# reference boxes each as the whole screen, the port by its visible part
# where stage A can bound it)
STRADDLE_CAMERAS = {"low": ((0.0, 14.0, 0.0), (30.0, 8.0, 20.0)),
                    "side": ((10.0, 16.0, -8.0), (-30.0, 6.0, 10.0))}


def wall_scene(device, gather_cap: int = 16384):
    """The occluder wall of tests/test_macrotile.py at 128x128: a solid
    chunk fills the view and a dense chunk sits fully behind it, each
    meshed alone.  (render_step positional args on ``device``, its keyword
    args)."""
    rng = np.random.default_rng(7)
    hx = np.sin(np.arange(32) / 32 * 12) * 6
    hz = np.cos(np.arange(32) / 32 * 12) * 6
    y = np.arange(32)[None, :, None]
    solid = y < (hx[None, :] + hz[:, None] + 16)[:, None, :]
    types = rng.integers(1, 4, (32, 32, 32)).astype(np.uint8)
    chunks = [Chunk.generate_test_solid((0, 0, 0)),
              Chunk.varied((1, 0, 0), np.where(solid, types, 0)
                           .astype(np.uint8))]
    stream = np.zeros(gather_cap, np.uint32)
    quad_world = np.zeros((3, gather_cap), np.float32)
    total = 0
    for c in chunks:
        q = mesh_chunk(c)
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(c.position, np.float32)[:, None] * 32.0)
        total += len(q)
    cam = Camera(np.array([-20.0, 16.0, 16.0], np.float32), 1.0)
    cam.look_at(np.array([32.0, 16.0, 16.0], np.float32))
    args = (projection.as_quad_words(stream), torch.from_numpy(quad_world),
            torch.tensor(total, dtype=torch.int32),
            torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    kw = dict(color_tables=projection.color_table_tensors(tables, device),
              width=128, height=128, tile_h=16, tile_w=128,
              render_cap=gather_cap, tile_k_cap=2 * gather_cap)
    return tuple(a.to(device) for a in args), kw


def small_scene(name, device):
    """(render_step positional args on ``device``, its keyword args)."""
    w, h, gc, cam_pos, cam_tgt = SMALL_SCENES[name]
    if name.startswith("fuzz"):
        chunks = [fuzz_chunk()]
    else:
        chunks = [Chunk.generate_terrain((x, 0, z)) for x in (-1, 0, 1)
                  for z in (-1, 0, 1)]
    stream = np.zeros(gc, np.uint32)
    quad_world = np.zeros((3, gc), np.float32)
    total = 0
    for c in chunks:
        q = mesh_chunk(c, chunks)
        if q is None:
            continue
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(c.position, np.float32)[:, None] * 32.0)
        total += len(q)
    cam = Camera(np.asarray(cam_pos, np.float32), w / h)
    cam.look_at(np.asarray(cam_tgt, np.float32))
    args = (projection.as_quad_words(stream), torch.from_numpy(quad_world),
            torch.tensor(total, dtype=torch.int32),
            torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    kw = dict(color_tables=projection.color_table_tensors(tables, device),
              width=w, height=h, tile_h=16, tile_w=128, render_cap=gc,
              tile_k_cap=2 * gc)
    return tuple(a.to(device) for a in args), kw


# ------------------------------------------------------------- self-tests


def _kernel_and_plain(args, kw):
    """One frame of the step's inputs ``args`` and keywords ``kw`` through
    the kernels (K1 and K2, or K4 with ``packed_raster``) and through their
    plain twins, called by name, on the inputs' own device (on the CPU the
    wrappers run the twins too).  Returns ((color u32, depth, (gathered,
    rasterized)) of the twins, the same of the kernels, the kernels'
    raster records)."""
    from .pipeline import _pre_geom_of, render_step

    h, w, th = kw["height"], kw["width"], kw["tile_h"]
    out_h = -h % th + h
    ga = geometry.project_cull_plain(
        *args, width=w, height=h,
        backface_culling=kw.get("backface_culling", True))
    rec = render_step(*args, pre_geom=_pre_geom_of(ga),
                      debug_return_records=True, **kw)
    if kw.get("packed_raster"):
        c1, d1 = raster_packed.rasterize_packed_plain(
            *rec[:5], height=h, width=w, tile_h=th, out_h=out_h)
    else:
        c1, d1 = raster.rasterize_tiles_plain(
            *rec, height=h, width=w, tile_h=th, tile_w=kw["tile_w"],
            out_h=out_h)
    c2, d2, s2 = render_step(*args, **kw)
    records = render_step(*args, debug_return_records=True, **kw)[0]

    def host(c, d, s):
        return (c[:h].cpu().numpy().view(np.uint32), d[:h].cpu().numpy(),
                tuple(int(x) for x in s))

    return (host(c1, d1, (args[2], ga["valid_count"])),
            host(c2, d2, s2[:2]), records.cpu().numpy())


def run_hardware_selftest(*, device="cuda", size=128, seed=42, width=None):
    """Render the fuzz scene through the kernels and through their plain
    twins on ``device`` and apply the parity gates (the reference's
    ``run_hardware_selftest``, its Mosaic kernel against its jnp twin).
    ``width`` defaults to ``size``.  Returns "exact" when the frames are
    bit-identical, "boundary-ok (N px)" when every mismatch is a proven
    coverage-edge flip; raises AssertionError on a real divergence."""
    width = width or size
    args, kw = _fuzz_step(device, seed, size, width)
    (c1, d1, s1), (c2, d2, s2), records = _kernel_and_plain(args, kw)
    assert s1 == s2, f"stats differ: twins {s1}, kernels {s2}"
    nonsky = int((c1 != np.uint32(SKY_COLOR)).sum())
    assert nonsky > size * size // 4, "fuzz scene rendered (almost) empty"
    return frame_parity(c1, d1, c2, d2, records)


def run_pipelined_selftest(*, device="cuda", seed=42, size=128, width=640):
    """Frames-in-flight gate (the reference's ``run_pipelined_selftest``):
    the fuzz scene rendered with its stage A from K1 handed in as
    ``pre_geom`` and the next frame's stage A computed in the raster call
    (K3) must equal the serial step's frame bit for bit, and K3's stage A
    K1's.  Returns "exact"; raises AssertionError otherwise."""
    from .pipeline import _pre_geom_of, render_step

    args, kw = _fuzz_step(device, seed, size, width)
    c1, d1, s1 = render_step(*args, **kw)
    ga0 = geometry.project_cull(*args, width=width, height=size,
                                backface_culling=kw["backface_culling"])
    c2, d2, s2, pre_next = render_step(*args, pre_geom=_pre_geom_of(ga0),
                                       next_geom=args, **kw)
    assert_kernel_parity(*_host_frame(c1, d1), *_host_frame(c2, d2))
    assert torch.equal(s1[:2], s2[:2]), (s1, s2)
    for got, want in zip(pre_next, _pre_geom_of(ga0)):
        if got.is_floating_point():   # depth_near: its bits, NaNs included
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)
    return "exact"


def _fuzz_step(device, seed, size, width):
    """The fuzz scene's render_step inputs on ``device``: (positional args,
    keyword args)."""
    from .pipeline import Renderer, build_gather_indices

    quads = mesh_chunk(fuzz_chunk(seed))
    cam = Camera(np.array([16.0, 48.0, 16.0], np.float32), width / size)
    cam.look_at(np.array([16.0, 8.0, 16.0], np.float32))
    renderer = Renderer(RenderConfig(width=width, height=size),
                        device=device)
    cfg = renderer.config
    pool = np.zeros((4, 4096), np.uint32)
    pool[0, :len(quads)] = quads
    counts_sel = np.zeros(cfg.visible_chunks_cap, np.int32)
    counts_sel[0] = len(quads)
    visible = np.zeros(cfg.visible_chunks_cap, np.int32)
    positions_sel = np.zeros((cfg.visible_chunks_cap, 3), np.int32)
    slot_of, within, quad_world, total = build_gather_indices(
        counts_sel, visible, positions_sel, cfg.gather_cap)
    args = tuple(a.to(renderer.device) for a in (
        projection.as_quad_words(pool[slot_of, within]),
        torch.from_numpy(quad_world), torch.tensor(total, dtype=torch.int32),
        torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
        torch.from_numpy(cam.position.astype(np.float32))))
    kw = dict(color_tables=renderer._base_step_kw["color_tables"],
              width=width, height=size, tile_h=16, tile_w=128,
              render_cap=cfg.quads_cap,
              backface_culling=cfg.backface_culling,
              tile_k_cap=cfg.quads_cap)
    return args, kw


def _host_frame(color, depth):
    return color.cpu().numpy().view(np.uint32), depth.cpu().numpy()


def _two_chunk_gate(device, seed, size, width):
    """The streaming gates' scene: fuzz chunk A in the pool, the mono fuzz
    chunk B arriving; the separate-call frame (both inserted, expanded,
    rendered).  Returns (renderer, camera, meshes, positions, draw_list,
    (colour, depth, stats) of the separate-call frame, its pool)."""
    from ..app.engine import QuadPool
    from .pipeline import Renderer

    quads_a = mesh_chunk(fuzz_chunk(seed))
    quads_b = mesh_chunk(fuzz_chunk_mono(seed + 1))
    pos_a, pos_b = (0, 0, 0), (1, 0, 0)
    cfg = RenderConfig(width=width, height=size, gather_cap=16384,
                       quads_cap=8192, tile_k_cap=2048)
    renderer = Renderer(cfg, device=device)
    cam = Camera(np.array([32.0, 44.0, 56.0], np.float32), width / size)
    cam.look_at(np.array([32.0, 8.0, 16.0], np.float32))
    vcap = cfg.visible_chunks_cap

    def draw_list(pool, poss):
        slots = np.array([pool.by_pos[p] for p in poss], np.int32)
        visible = np.zeros(vcap, np.int32)
        counts_sel = np.zeros((vcap, 6), np.int32)
        positions_sel = np.zeros((vcap, 3), np.int32)
        visible[:len(slots)] = slots
        counts_sel[:len(slots)] = pool.counts6[slots]
        positions_sel[:len(slots)] = pool.positions[slots]
        return visible, counts_sel, positions_sel

    pool_s = QuadPool(slots=64, qcap=4096, device=device)
    pool_s.insert_many([(pos_a, quads_a), (pos_b, quads_b)])
    uploads = renderer.prepare_uploads(pool_s.quads,
                                       *draw_list(pool_s, (pos_a, pos_b)))
    ref = renderer.render_prepared(uploads, cam.view_projection_matrix(),
                                   cam.position)
    return (renderer, cam, (quads_a, quads_b), (pos_a, pos_b), draw_list,
            ref, pool_s)


def _check_streaming_gate(size, ref, out, pool_s, pool_f, poss):
    """The one-call frame ``out`` and pool ``pool_f`` against the
    separate-call frame ``ref`` and pool ``pool_s``, bit for bit."""
    c1, d1 = _host_frame(*ref[:2])
    c2, d2 = _host_frame(*out[:2])
    assert int((c1 != np.uint32(SKY_COLOR)).sum()) > size * size // 4, (
        "gate scene rendered (almost) empty")
    assert torch.equal(ref[2][:2].cpu(), out[2][:2].cpu()), (ref[2], out[2])
    assert_kernel_parity(c1, d1, c2, d2)
    for pos in poss:
        ss, sf = pool_s.by_pos[pos], pool_f.by_pos[pos]
        assert torch.equal(pool_s.quads[ss], pool_f.quads[sf]), pos
        assert (pool_s.counts6[ss] == pool_f.counts6[sf]).all(), pos


def run_fused_insert_selftest(*, device="cuda", seed=42, size=128,
                              width=640):
    """Streaming fused insert+render gate (the reference's
    ``run_fused_insert_selftest``): a frame whose remesh batch rides the
    render call (``Renderer.render_fused_insert``: pool scatter, draw-list
    expansion, render) must give the frame and device pool state of the
    separate calls (``QuadPool.insert_many``, ``prepare_uploads``,
    ``render_prepared``) bit for bit.  Chunk A is in the pool, the mono
    fuzz chunk B arrives in the payload.  Returns "exact"."""
    from ..app.engine import QuadPool

    renderer, cam, (quads_a, quads_b), (pos_a, pos_b), draw_list, ref, \
        pool_s = _two_chunk_gate(device, seed, size, width)
    assert 0 < len(quads_b) <= renderer.INSERT_MC, len(quads_b)
    pool_f = QuadPool(slots=64, qcap=4096, device=device)
    pool_f.insert_many([(pos_a, quads_a)])
    payload = pool_f.prepare_insert_payload([(pos_b, quads_b)])
    assert payload is not None
    frame = renderer.render_fused_insert(
        pool_f.quads, *draw_list(pool_f, (pos_a, pos_b)),
        cam.view_projection_matrix(), cam.position, payload)
    _check_streaming_gate(size, ref, frame, pool_s, pool_f, (pos_a, pos_b))
    return "exact"


def run_resident_append_selftest(*, device="cuda", seed=42, size=128,
                                 width=640):
    """Resident streaming-frame gate (the reference's
    ``run_resident_append_selftest``): a frame whose batch rides the step
    as pool scatter + stream append
    (``Renderer.render_prepared_append_insert``) must give the frame and
    device pool state of the separate calls bit for bit: the appended
    batch lands at the stream's tail exactly where the full expansion puts
    it (the same draw-list order).  The stream holds chunk A; the mono
    fuzz chunk B scatters, appends and renders in one step.  Returns
    "exact"."""
    from ..app.engine import QuadPool
    from .pipeline import (RESIDENT_INSERT_FP, RESIDENT_INSERT_KP,
                           RESIDENT_INSERT_MC, pack_append_meta)

    renderer, cam, (quads_a, quads_b), (pos_a, pos_b), draw_list, ref, \
        pool_s = _two_chunk_gate(device, seed, size, width)
    assert 0 < len(quads_b) <= RESIDENT_INSERT_MC, len(quads_b)
    pool_f = QuadPool(slots=64, qcap=4096, device=device)
    pool_f.insert_many([(pos_a, quads_a)])
    q_a, w_a, total_a = renderer.prepare_uploads(
        pool_f.quads, *draw_list(pool_f, (pos_a,)))
    payload = pool_f.prepare_insert_payload(
        [(pos_b, quads_b)], kp=RESIDENT_INSERT_KP, mc=RESIDENT_INSERT_MC,
        fp=RESIDENT_INSERT_FP)
    assert payload is not None
    slot_b = pool_f.by_pos[pos_b]
    ameta = pack_append_meta(np.array([slot_b], np.int32),
                             pool_f.counts6[[slot_b]],
                             pool_f.positions[[slot_b]])
    offset = int(total_a)
    *frame, _up = renderer.render_prepared_append_insert(
        (q_a, w_a, np.int32(offset + len(quads_b))),
        cam.view_projection_matrix(), cam.position, pool_f.quads, ameta,
        offset, payload)
    _check_streaming_gate(size, ref, frame, pool_s, pool_f, (pos_a, pos_b))
    return "exact"


def run_selftests(*, device="cuda", seed=42):
    """Every parity gate, each named, as the reference's ``run_selftests``
    on hardware: the fuzz scene at 128x128 (one tile column) and 640x128
    (five), frames in flight, the fused insert and the resident append,
    e.g. "fuzz@128x128: exact | fuzz@640x128: exact | pipelined@640x128:
    exact | fused-insert@640x128: exact | resident-append@640x128:
    exact"."""
    parts = [
        f"fuzz@128x128: {run_hardware_selftest(device=device, seed=seed)}",
        f"fuzz@640x128: "
        f"{run_hardware_selftest(device=device, seed=seed, width=640)}",
        f"pipelined@640x128: "
        f"{run_pipelined_selftest(device=device, seed=seed)}",
        f"fused-insert@640x128: "
        f"{run_fused_insert_selftest(device=device, seed=seed)}",
        f"resident-append@640x128: "
        f"{run_resident_append_selftest(device=device, seed=seed)}"]
    return " | ".join(parts)


def run_production_parity(renderer, uploads, view_proj, cam_pos):
    """Full-production-frame parity: a real scene's prepared stream
    (``uploads`` = (quads, quad_world, total), e.g. a vd12 frame's) at the
    renderer's resolution and bucket through the kernels (K1 and K2, or K4
    with ``packed_raster``) against their plain twins, on the renderer's
    device.  A two-pass configuration is compared as its single pass.
    Returns "exact (...)" or "boundary-ok (N px; ...)"; raises on a real
    divergence.  The twins loop over the items of the frame: seconds at
    720p, so this runs once, after the measurements."""
    quads, quad_world, total = uploads
    kw = renderer._bucket_kw(int(quads.shape[0]))
    kw.pop("near_quads", None)
    dev = quads.device

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    args = (quads, quad_world, total, f32(view_proj), f32(cam_pos))
    (c1, d1, s1), (c2, d2, s2), records = _kernel_and_plain(args, kw)
    assert s1 == s2, f"stats differ: twins {s1}, kernels {s2}"
    h, w = d1.shape
    k = "K4" if kw.get("packed_raster") else "K2"
    tag = (f"{w}x{h}, {s1[1]} quads rasterized, kernels K1+{k} vs plain "
           f"twins on {dev.type}")
    verdict = frame_parity(c1, d1, c2, d2, records)
    if verdict == "exact":
        return f"exact ({tag})"
    return f"{verdict[:-1]}; {tag})"
