"""The port's packed raster path against the JAX package, on the CPU.

``RenderConfig.packed_raster``: depth-keyed compaction, five bins per tile
(``build_bin_lists``), the per-bin suffix-min (``_packed_tail``) and K4's
plain twin (``rasterize_packed_plain``).  The reference is
``_render_step(packed_raster=True)`` on its Pallas path in interpret mode,
as tests/test_render.py runs it.

Tolerances.  Binning, records, octet rows and the suffix-min must be equal
when both steps are fed the same stage A (``pre_geom``: the interpreted
Pallas geometry kernel rounds near depth differently from the port's,
tests/test_torch_pipeline.py).  Stats must be equal.  The frame must equal
the port's own default path bit for bit, which equals the JAX octet
kernel's (tests/test_torch_pipeline.py).  The JAX packed kernel in
interpret mode differs from both in one pixel of the fuzz scene, a
near-depth tie one ulp apart, where the JAX octet kernel and its jnp path
agree with the port (measured), so it is held to the boundary-verified
gate with at most that one pixel.  That pixel differs with the reference
kernel's occlusion break disabled too, so the break drops no winning item
on these scenes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.ops import raster_packed as JRP
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.meshing.greedy import (
    mesh_chunk,
)
from differential_projection_voxel_renderer_tpu_torch.models.camera import (
    Camera,
)
from differential_projection_voxel_renderer_tpu_torch.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    raster_packed as TRP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

SKY = np.uint32(0xFF87CEEB)
TILES_Y, TILES_X = 8, 10

# ---------------------------------------------------------------- binning


def _bucketboxes(rng, m, n_small_wide, n_big, frac_empty):
    """Bucket-granular boxes (bx in 0..4*TILES_X-1): narrow quads (one or
    two buckets and tile rows), ``n_small_wide`` spanning 3-5 buckets
    inside two tiles, ``n_big`` spanning three or more tiles."""
    nbx = 4 * TILES_X
    bx0 = rng.integers(0, nbx, m)
    bx1 = np.minimum(bx0 + rng.integers(0, 2, m), nbx - 1)
    ty0 = rng.integers(0, TILES_Y, m)
    ty1 = np.minimum(ty0 + rng.integers(0, 2, m), TILES_Y - 1)
    pick = rng.choice(m, n_small_wide + n_big, replace=False)
    sw, big = pick[:n_small_wide], pick[n_small_wide:]
    bx0[sw] = rng.integers(0, nbx - 8, n_small_wide)
    bx1[sw] = bx0[sw] + rng.integers(2, 5, n_small_wide)
    bx0[big] = rng.integers(0, nbx - 12, n_big)
    bx1[big] = bx0[big] + rng.integers(9, 12, n_big)
    ty1[big] = np.minimum(ty0[big] + rng.integers(0, 3, n_big), TILES_Y - 1)
    empty = rng.random(m) < frac_empty
    bx0[empty], bx1[empty] = 5, 4
    return (bx0 | (bx1 << 8) | (ty0 << 16) | (ty1 << 24)).astype(np.int32)


# name -> (quads, small-wide, big, share empty, count, item cap)
BIN_CASES = {
    "narrow": (2048, 0, 0, 0.0, 2048, 16384),
    "small_wide": (2048, 300, 0, 0.0, 2000, 16384),
    "big": (2048, 200, 100, 0.0, 2048, 32768),
    "big_overflow": (4096, 100, 600, 0.0, 4096, 32768),
    "item_overflow": (2048, 200, 40, 0.0, 2048, 4096),
    "empty": (2048, 100, 20, 0.5, 1500, 16384),
}


def _bin_both(box, count, item_cap, rng):
    """``box`` binned by the JAX package and by the port, with orders drawn
    from ``rng``: (ref, got)."""
    order4 = rng.integers(0, 16, box.shape[0]).astype(np.int32)
    order4_dy1 = order4 & ~3
    kw = dict(tiles_y=TILES_Y, tiles_x=TILES_X, item_cap=item_cap)
    ref = JRP.build_bin_lists(jnp.asarray(box), count, jnp.asarray(order4),
                              jnp.asarray(order4_dy1), **kw)
    got = TRP.build_bin_lists(torch.from_numpy(box), count,
                              torch.from_numpy(order4),
                              torch.from_numpy(order4_dy1), **kw)
    return ref, got


def _case(case):
    """The case's boxes, count and item cap, and its binnings (ref, got)."""
    m, n_sw, n_big, frac_empty, count, item_cap = BIN_CASES[case]
    rng = np.random.default_rng(sorted(BIN_CASES).index(case))
    box = _bucketboxes(rng, m, n_sw, n_big, frac_empty)
    return box, count, _bin_both(box, count, item_cap, rng)


def _reference_binning(monkeypatch):
    """The reference's big-quad binning: one class of 512 over the whole
    grid (no grid the tests bin has more than 1024 tiles)."""
    monkeypatch.setattr(TPL.raster_ops, "BIG_CAP", 512)
    monkeypatch.setattr(TPL.raster_ops, "MAX_TILES_BIG", 1024)


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_build_bin_lists_matches_jax(monkeypatch, case):
    """At the reference's big-quad binning: one class of 512 over the whole
    grid."""
    _reference_binning(monkeypatch)
    _, m, (ref, got) = _case(case)
    for name, r, g in zip(("flat", "b_of_item", "valid_slot", "starts",
                           "counts", "overflow"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=name)
    assert (int(got[5]) > 0) == case.endswith("overflow"), int(got[5])
    assert int(got[4].sum()) > m // 2


def _big_quads(box, count):
    """Stream indices of the quads over more than 2x2 tiles, and each one's
    tile box (tx0, tx1, ty0, ty1) and tile count, as the binning sees
    them."""
    bx0, bx1 = box & 0xFF, (box >> 8) & 0xFF
    ty0, ty1 = (box >> 16) & 0xFF, (box >> 24) & 0xFF
    tx0, tx1 = bx0 >> 2, bx1 >> 2
    live = (np.arange(box.shape[0]) < count) & (bx0 <= bx1) & (ty0 <= ty1)
    big = np.flatnonzero(live & ((tx1 - tx0 > 1) | (ty1 - ty0 > 1)))
    tiles = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    return big, (tx0, tx1, ty0, ty1), tiles[big]


def _assert_bins_add(ref, got, box, count, added, removed=()):
    """Each bucket bin equals the reference's; each tile's wide bin is the
    reference's in its order, less the big quads ``removed`` and plus the
    big quads ``added`` whose box covers the tile."""
    _, (tx0, tx1, ty0, ty1), _ = _big_quads(box, count)
    added, removed = np.asarray(added, int), np.asarray(removed, int)
    flat_r, flat_g = np.asarray(ref[0]), got[0].numpy()
    st_r, cn_r = np.asarray(ref[3]), np.asarray(ref[4])
    st_g, cn_g = got[3].numpy(), got[4].numpy()
    n_added = 0
    for b in range(TILES_Y * TILES_X * 5):
        r = flat_r[st_r[b]:st_r[b] + cn_r[b]]
        g = flat_g[st_g[b]:st_g[b] + cn_g[b]]
        if b % 5:
            np.testing.assert_array_equal(r, g, err_msg=f"bucket bin {b}")
            continue
        ty, tx = divmod(b // 5, TILES_X)

        def cover(qs):
            return qs[(tx0[qs] <= tx) & (tx <= tx1[qs]) & (ty0[qs] <= ty)
                      & (ty <= ty1[qs])]

        extra, gone = cover(added), cover(removed)
        np.testing.assert_array_equal(g[~np.isin(g, extra)],
                                      r[~np.isin(r, gone)],
                                      err_msg=f"wide bin {b}")
        assert sorted(g[np.isin(g, extra)]) == sorted(extra), b
        assert np.isin(gone, r).all(), b
        n_added += len(extra)
    assert n_added > 0


def test_build_bin_lists_bins_the_big_quads_the_reference_drops():
    """The big-quad case at the port's own binning: no overflow, and each
    wide bin holds the reference's items in their order plus the big quads
    past its 512 (by stream index) that cover the tile."""
    box, count, (ref, got) = _case("big_overflow")
    big, _, _ = _big_quads(box, count)
    assert int(ref[5]) == len(big) - 512 > 0 and int(got[5]) == 0
    _assert_bins_add(ref, got, box, count, big[512:])


def test_build_bin_lists_bins_big_and_huge_quads():
    """More than 512 big quads and more than HUGE_CAP (64) over the whole
    grid (80 tiles): the port keeps every big quad over at most 64 tiles
    and the first 64 huge ones, the reference the first 512 of both by
    stream index; each wide bin holds the reference's items, less its huge
    quads past the port's 64, plus its big quads past 512."""
    rng = np.random.default_rng(7)
    m = 4096
    box = _bucketboxes(rng, m, 100, 600, 0.0)
    one_bucket = (box & 0xFF) == ((box >> 8) & 0xFF)
    huge = rng.choice(np.flatnonzero(one_bucket), 100, replace=False)
    box[huge] = ((4 * TILES_X - 1) << 8) | ((TILES_Y - 1) << 24)
    ref, got = _bin_both(box, m, 32768, rng)
    big, _, tiles = _big_quads(box, m)
    assert (tiles > 64).sum() == 100 and (tiles <= 64).sum() > 512
    kept_ref = big[:512]
    kept = np.concatenate([big[tiles <= 64], big[tiles > 64][:64]])
    assert int(ref[5]) == len(big) - 512
    assert int(got[5]) == 100 - 64
    assert int(got[4].sum()) < 32768
    _assert_bins_add(ref, got, box, m, np.setdiff1d(kept, kept_ref),
                     np.setdiff1d(kept_ref, kept))


def _pillars_scene():
    """Two chunks of 1x1 pillars, 32 blocks tall, every other column, seen
    from the side at 256x128: 1008 quads rasterized, each side face over
    three tile rows or more, so more than 512 big quads."""
    blocks = np.zeros((32, 32, 32), np.uint8)
    blocks[::2, :, ::2] = 1
    chunks = [Chunk.varied((x, 0, 0), blocks) for x in (-1, 0)]
    gc = 8192
    stream = np.zeros(gc, np.uint32)
    quad_world = np.zeros((3, gc), np.float32)
    total = 0
    for c in chunks:
        q = mesh_chunk(c, chunks)
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(c.position, np.float32)[:, None] * 32.0)
        total += len(q)
    w, h = 256, 128
    cam = Camera(np.array([0.0, 16.0, 60.0], np.float32), w / h)
    cam.look_at(np.array([0.0, 16.0, 16.0], np.float32))
    args = (TP.as_quad_words(stream), torch.from_numpy(quad_world),
            torch.tensor(total, dtype=torch.int32),
            torch.from_numpy(cam.view_projection_matrix().astype(np.float32)),
            torch.from_numpy(cam.position.astype(np.float32)))
    kw = dict(color_tables=TP.color_table_tensors(S.TABLES, "cpu"),
              width=w, height=h, tile_h=16, tile_w=128, render_cap=gc,
              tile_k_cap=2 * gc)
    return args, kw


def test_packed_frame_keeps_more_than_512_big_quads(monkeypatch):
    """On a stream with more than 512 big quads the packed frame (K4's
    plain twin) equals the default path's bit for bit, stats included; at
    the reference's binning it drops big quads and differs."""
    args, kw = _pillars_scene()
    default = TPL.render_step(*args, **kw)
    packed = TPL.render_step(*args, packed_raster=True, **kw)
    assert int(default[2][3]) == 0 and int(default[2][1]) > 512
    for a, b in zip(default, packed):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _reference_binning(monkeypatch)
    ref = TPL.render_step(*args, packed_raster=True, **kw)
    assert int(ref[2][3]) > 0
    assert int((ref[0] != default[0]).sum()) > 1000


# ------------------------------------------------------------- the step

# (scene, render cap, item cap): the smaller render caps force compaction
# overflow; their item caps keep the reference's key stream at least one
# item cap long (4 x render cap + 512 per tile)
CASES = [("fuzz", 4096, 8192), ("fuzz", 1024, 4096),
         ("terrain", 16384, 32768), ("terrain", 2048, 8192)]
IDS = [f"{n}-{rc}" for n, rc, _ in CASES]
OVERFLOW = {("fuzz", 1024): 91, ("terrain", 2048): 306}


@pytest.fixture(scope="module")
def scenes():
    return {name: S.scene(name) for name in S.SCENES}


def _kw(sc, render_cap, item_cap):
    jkw = dict(S.jax_step_kw(sc, render_cap), tile_k_cap=item_cap,
               packed_raster=True)
    tkw = dict(S.torch_step_kw(sc, render_cap), tile_k_cap=item_cap,
               packed_raster=True)
    return jkw, tkw


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """(scene, render cap) -> the JAX packed step's (colour u32, depth,
    stats), run once for the module."""
    out = {}
    for name, rc, cap in CASES:
        jkw, _ = _kw(scenes[name], rc, cap)
        c, d, st = JPL._render_step(*S.jax_args(scenes[name]), **jkw)
        out[name, rc] = (np.asarray(c).view(np.uint32), np.asarray(d),
                         np.asarray(st))
    return out


def _shared_stage_a(sc):
    """The port's stage A (K1's twin) on the scene, as the pre_geom of
    both steps: (JAX arrays, torch tensors)."""
    ta = S.torch_args(sc)
    w, h, _ = sc[5]
    pre = TPL._geom_stage(*ta, width=w, height=h, backface_culling=True)
    return tuple(jnp.asarray(x.numpy()) for x in pre), pre


@pytest.mark.parametrize("name,render_cap,item_cap", CASES, ids=IDS)
def test_packed_step_intermediates_match_jax(scenes, name, render_cap,
                                             item_cap):
    """The "bin" and records outputs of the packed step, exactly."""
    sc = scenes[name]
    jkw, tkw = _kw(sc, render_cap, item_cap)
    jpre, tpre = _shared_stage_a(sc)
    ja, ta = S.jax_args(sc), S.torch_args(sc)
    for mode, names in (("bin", ("flat", "b_of_item", "valid_slot",
                                 "starts", "counts")),
                        (True, ("records", "starts", "counts", "octet_rows",
                                "octet_zmin"))):
        ref = JPL._render_step(*ja, pre_geom=jpre, debug_return_records=mode,
                               **jkw)
        got = TPL.render_step(*ta, pre_geom=tpre, debug_return_records=mode,
                              **tkw)
        for n, r, g in zip(names, ref, got):
            np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                          err_msg=f"{mode} {n}")
    counts = got[2].numpy()
    assert counts.sum() > 1000 and counts.reshape(-1, 5)[:, 1:].sum() > 0


@pytest.fixture(scope="module")
def port_frames(scenes):
    """(scene, render cap) -> the port's packed step: (colour, depth,
    stats, records)."""
    out = {}
    for name, rc, cap in CASES:
        _, tkw = _kw(scenes[name], rc, cap)
        ta = S.torch_args(scenes[name])
        out[name, rc] = (*TPL.render_step(*ta, **tkw),
                         TPL.render_step(*ta, debug_return_records=True,
                                         **tkw)[0])
    return out


@pytest.mark.parametrize("name,render_cap,item_cap", CASES, ids=IDS)
def test_packed_frame_matches_jax(jax_frames, port_frames, name, render_cap,
                                  item_cap):
    """Frame and stats against the JAX packed step: stats exact, the frame
    through the boundary gate with at most one pixel."""
    c1, d1, s1 = jax_frames[name, render_cap]
    c2, d2, s2, records = port_frames[name, render_cap]
    c2, d2 = c2.numpy().view(np.uint32), d2.numpy()
    np.testing.assert_array_equal(s1, s2.numpy())
    assert int(s1[2]) == OVERFLOW.get((name, render_cap), 0)
    assert int(s1[3]) == 0
    n = parity.assert_kernel_parity_boundary(c1, d1, c2, d2,
                                             records.numpy())
    assert n <= (1 if name == "fuzz" else 0), n
    assert (c2 != SKY).sum() > 3000


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_packed_frame_matches_default_path(scenes, port_frames, name):
    """Without overflow the packed step renders the default step's frame
    bit for bit (the blend is commutative; both see every quad)."""
    sc = scenes[name]
    gc = sc[5][2]
    _, tkw = _kw(sc, gc, 2 * gc)
    packed = port_frames[name, gc]
    default = TPL.render_step(*S.torch_args(sc),
                              **dict(tkw, packed_raster=False))
    assert torch.equal(packed[0], default[0])
    assert torch.equal(packed[1].view(torch.int32),
                       default[1].view(torch.int32))
    assert torch.equal(packed[2], default[2])


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_packed_twin_matches_pallas_kernel(scenes, jax_frames, name):
    """K4's twin on the JAX package's own packed records against
    ``rasterize_pallas_packed`` in interpret mode, with its occlusion break
    and without it (octet_zmin = -inf): the break drops no winning item,
    including at groups that straddle two bins."""
    sc = scenes[name]
    w, h, gc = sc[5]
    jkw, _ = _kw(sc, gc, 2 * gc)
    rec = JPL._render_step(*S.jax_args(sc), debug_return_records=True,
                           **jkw)
    kw = dict(height=h, width=w, tile_h=16, out_h=-h % 16 + h)
    c1, d1 = JRP.rasterize_pallas_packed(*rec, interpret=True, **kw)
    no_break = list(rec)
    no_break[4] = jnp.full_like(rec[4], -jnp.inf)
    c0, d0 = JRP.rasterize_pallas_packed(*no_break, interpret=True, **kw)
    parity.assert_kernel_parity(np.asarray(c0), np.asarray(d0),
                                np.asarray(c1), np.asarray(d1))
    c2, d2 = TRP.rasterize_packed(
        *(torch.from_numpy(np.array(a)) for a in rec), **kw)
    n = parity.assert_kernel_parity_boundary(
        np.asarray(c1), np.asarray(d1), c2.numpy(), d2.numpy(),
        np.asarray(rec[0]))
    assert n <= (1 if name == "fuzz" else 0), n
    c, d, _ = jax_frames[name, gc]
    np.testing.assert_array_equal(np.asarray(c1).view(np.uint32)[:h], c)


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_octet_zmin_bounds_its_bin(scenes, name):
    """From every 8-group whose first item lies inside its bin, octet_zmin
    is at most the near depth of every item of that bin from the group on
    (the exact occlusion break's key); the group's own first bin decides."""
    sc = scenes[name]
    gc = sc[5][2]
    _, tkw = _kw(sc, gc, 2 * gc)
    ta = S.torch_args(sc)
    _, ig, starts, counts, b_of_item = (
        x.numpy() for x in TPL.render_step(
            *ta, debug_return_records="gather", **tkw))
    zmin = TPL.render_step(*ta, debug_return_records=True, **tkw)[4].numpy()
    dn = ig[5].view(np.float32)
    checked = 0
    for b in np.flatnonzero(counts):
        s, e = starts[b], starts[b] + counts[b]
        assert (b_of_item[s:e] == b).all()
        for g in range(-(-s // 8), -(-e // 8)):
            assert zmin[g] <= dn[8 * g:e].min(), (b, g)
            checked += 1
    assert checked > 100


# ---------------------------------------------------- Renderer and Engine


def _engine_configs(render_config_cls, world_config_cls):
    """tests/test_torch_engine.py's configuration with the packed raster."""
    return dict(
        render_config=render_config_cls(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192,
                                        packed_raster=True),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=4),
        pool_slots=512)


def _primed(eng):
    eng.camera.position = np.array([0.0, 40.0, 60.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, 0.0], np.float32))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    return eng


def test_packed_renderer_refuses_two_pass():
    cfg = TE.RenderConfig(width=256, height=128, packed_raster=True,
                          two_pass_near_quads=16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TPL.Renderer(cfg, device="cpu")


def test_packed_engine_refuses_pipelined():
    eng = TE.Engine(**_engine_configs(TE.RenderConfig, TE.WorldConfig),
                    device="cpu")
    with pytest.raises(ValueError, match="packed"):
        eng.render_frame_pipelined(dt=0.0)


def test_packed_engine_frame_matches_jax():
    """One packed Engine.render_frame against the JAX engine with the same
    configuration (its jnp path on the CPU), through the engine gates of
    tests/test_torch_engine.py; the port's frame went through K4's twin."""
    jeng = _primed(JE.Engine(**_engine_configs(JCFG.RenderConfig,
                                               JW.WorldConfig)))
    teng = _primed(TE.Engine(**_engine_configs(TE.RenderConfig,
                                               TE.WorldConfig),
                             device="cpu"))
    calls = []
    plain = TPL.packed_ops.rasterize_packed

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    TPL.packed_ops.rasterize_packed = spy
    try:
        got = teng.render_frame(dt=0.0)
    finally:
        TPL.packed_ops.rasterize_packed = plain
    ref = jeng.render_frame(dt=0.0)
    assert calls == [1]
    S.assert_engine_frame_gates(
        (ref.color_numpy(), ref.depth_numpy(), np.asarray(ref.stats),
         ref.rendered_meshes, ref.visible_chunks),
        (got.color_numpy(), got.depth_numpy(), got.stats.numpy(),
         got.rendered_meshes, got.visible_chunks),
        S.engine_records(teng))


def test_rasterize_packed_checks_shapes():
    rec = torch.zeros((24, 1024), dtype=torch.int32)
    meta = (torch.zeros(5, dtype=torch.int32),) * 2
    octs = (torch.zeros(128, dtype=torch.int32), torch.zeros(128))
    with pytest.raises(ValueError, match="cap % 2048"):
        TRP.rasterize_packed(rec, *meta, *octs, height=16, width=128)
    rec = torch.zeros((24, 2048), dtype=torch.int32)
    octs = (torch.zeros(256, dtype=torch.int32), torch.zeros(256))
    with pytest.raises(ValueError, match="tiles \\* 5"):
        TRP.rasterize_packed(rec, meta[0][:4], meta[1][:4], *octs,
                             height=16, width=128)
    color, depth = TRP.rasterize_packed(rec, *meta, *octs, height=16,
                                        width=128)
    assert (color == TRP.SKY_I32).all() and torch.isinf(depth).all()
