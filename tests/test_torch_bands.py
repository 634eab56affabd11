"""Row bands, the camera batch and K2's last two inputs, on the CPU, against
the JAX package.

- ``render_step`` with ``band_y0``/``band_h`` against JAX ``_render_step``
  in band mode (Pallas path, interpret mode), for 2 and 4 bands, on the
  scene of tests/test_parallel.py; the port's stacked bands must equal its
  full frame bit for bit.
- ``parallel/sharded_render.py``: ``make_mesh`` factors like JAX's;
  ``make_sharded_render`` and ``make_sharded_render_dp`` against JAX's on
  the 8-device CPU mesh of tests/conftest.py.  There JAX renders with its
  jnp path, whose plane evaluations XLA contracts into FMAs (README "One
  caveat"): colours must be equal and depths within 16 float32 ulps
  (measured: up to 10, on about a tenth of the pixels).  The port's
  batch frames must also equal its own full-frame step bit for bit, and
  that step equals the JAX Pallas step (tests/test_torch_pipeline.py).
  JAX's band count on the CPU is its jnp path's full-frame count; the
  port's is the bands' own (as the reference's Pallas path counts), held to
  the JAX Pallas band steps'.
- K2's plain twin with an init frame and with ``y0_px`` against JAX
  ``rasterize_pallas`` in interpret mode on the same records: bit-equal
  (this is the Pallas kernel itself), on the solo kernel (128x128) and the
  shared-stream kernel (640x128, ``stream_group=5``), over the whole
  buffer, the padded rows of a band included.

Tolerances: band frames and K2 frames bit-equal; stats equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.meshing.greedy import mesh_chunk
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu.ops import raster as JR
from differential_projection_voxel_renderer_tpu.parallel import (
    sharded_render as JS,
)
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch.ops import raster as TR
from differential_projection_voxel_renderer_tpu_torch.parallel import (
    sharded_render as TS,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

W = H = 128
GQ, RCAP, KCAP = 1024, 512, 512
JNP_ULPS = 16
# camera positions looking at the solid chunk's centre
CAMS = [(60.0, 70.0, 90.0), (-50.0, 40.0, 70.0)]


@pytest.fixture(scope="module")
def chunk():
    """tests/test_parallel.py's scene: one solid chunk in an 8-slot pool."""
    quads = mesh_chunk(Chunk.generate_test_solid((0, 0, 0)))
    pool = np.zeros((8, 512), np.uint32)
    pool[0, :len(quads)] = quads
    counts = np.zeros(8, np.int32)
    counts[0] = len(quads)
    return pool, counts, np.zeros((8, 3), np.int32)


def _camera(pos):
    cam = Camera(np.array(pos, np.float32), 1.0)
    cam.look_at(np.array([16.0, 16.0, 16.0]))
    return (cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32))


def _stream(chunk, pos):
    """(numpy step inputs, port tensors) of the chunk's stream seen from
    ``pos``."""
    pool, counts, _ = chunk
    nq = int(counts[0])
    stream = np.zeros(GQ, np.uint32)
    stream[:nq] = pool[0, :nq]
    vp, cp = _camera(pos)
    sc = (stream, np.zeros((3, GQ), np.float32), nq, vp, cp, (W, H, GQ))
    return sc, S.torch_args(sc)


def _tkw():
    return dict(S.torch_step_kw((None,) * 5 + ((W, H, GQ),), RCAP),
                tile_k_cap=KCAP)


def _jkw():
    return dict(S.jax_step_kw((None,) * 5 + ((W, H, GQ),), RCAP),
                tile_k_cap=KCAP)


@pytest.fixture(scope="module")
def jax_bands(chunk):
    """The JAX Pallas step (interpret mode) on each band of 2 and 4, for
    the first camera: {bands: [(color, depth, stats)]}."""
    sc, _ = _stream(chunk, CAMS[0])
    out = {}
    for bands in (2, 4):
        bh = H // bands
        out[bands] = [
            tuple(np.asarray(x) for x in JPL._render_step(
                *S.jax_args(sc), band_y0=b * bh, band_h=bh, **_jkw()))
            for b in range(bands)]
    return out


def _near_jnp(c_ref, d_ref, c_got, d_got):
    """The JAX jnp path's frame against the port's: the same colours and
    undrawn pixels, depths within JNP_ULPS float32 ulps."""
    np.testing.assert_array_equal(np.asarray(c_ref).view(np.uint32),
                                  np.asarray(c_got).view(np.uint32))
    d1, d2 = np.asarray(d_ref), np.asarray(d_got)
    fin = np.isfinite(d1)
    np.testing.assert_array_equal(fin, np.isfinite(d2))
    np.testing.assert_array_equal(d1[~fin], d2[~fin])
    assert (np.abs(d1[fin] - d2[fin])
            <= JNP_ULPS * np.spacing(np.abs(d1[fin]))).all()


@pytest.mark.parametrize("bands", [2, 4])
def test_band_render_step_matches_jax(chunk, jax_bands, bands):
    _, ta = _stream(chunk, CAMS[0])
    tkw = _tkw()
    full_c, full_d, full_s = TPL.render_step(*ta, **tkw)
    bh = H // bands
    cs, ds = [], []
    for b, (jc, jd, js) in enumerate(jax_bands[bands]):
        c, d, s = TPL.render_step(*ta, band_y0=b * bh, band_h=bh, **tkw)
        assert c.shape == (bh, W)
        np.testing.assert_array_equal(jc, c.numpy())
        np.testing.assert_array_equal(jd, d.numpy())
        np.testing.assert_array_equal(js, s.numpy())
        assert int(s[1]) <= int(full_s[1])
        cs.append(c)
        ds.append(d)
    assert torch.equal(torch.cat(cs), full_c)
    assert torch.equal(torch.cat(ds), full_d)
    assert (full_c.numpy() != TR.SKY_I32).sum() > 1000


def test_make_mesh_matches_jax():
    assert len(jax.devices()) == 8
    for n in range(1, 9):
        mesh = JS.make_mesh(n)
        got = TS.make_mesh(n, devices=["cpu"] * 8)
        assert tuple(got) == (mesh.shape["dp"], mesh.shape["tp"])
    assert tuple(TS.make_mesh(devices=["cpu"] * 8)) == (2, 4)


def test_sharded_render_matches_jax(chunk, jax_bands):
    pool, counts, positions = chunk
    mesh = JS.make_mesh(8)
    tmesh = TS.make_mesh(8, devices=["cpu"] * 8)
    dp, tp = tmesh
    assert tp == 4 and dp == len(CAMS)
    visible = np.zeros((dp, 8), np.int32)
    nvis = np.ones(dp, np.int32)
    vps, cps = zip(*(_camera(p) for p in CAMS))
    vps, cps = np.stack(vps), np.stack(cps)
    ref = JS.make_sharded_render(mesh, width=W, height=H, gather_cap=GQ,
                                 render_cap=RCAP)(
        jnp.asarray(pool), jnp.asarray(counts), jnp.asarray(positions),
        jnp.asarray(visible), jnp.asarray(nvis), jnp.asarray(vps),
        jnp.asarray(cps))
    fn = TS.make_sharded_render(tmesh, width=W, height=H, gather_cap=GQ,
                                render_cap=RCAP, tile_k_cap=KCAP)
    color, depth, count = fn(
        torch.from_numpy(pool.view(np.int32)), torch.from_numpy(counts),
        torch.from_numpy(positions), torch.from_numpy(visible),
        torch.from_numpy(nvis), torch.from_numpy(vps),
        torch.from_numpy(cps))
    assert color.shape == (dp, H, W) and depth.shape == (dp, H, W)
    for i, pos in enumerate(CAMS):
        _, ta = _stream(chunk, pos)
        _near_jnp(ref[0][i], ref[1][i], color[i].numpy(), depth[i].numpy())
        full_c, full_d, _ = TPL.render_step(*ta, **_tkw())
        assert torch.equal(color[i], full_c) and torch.equal(depth[i], full_d)
    # the bands' counts, summed and divided by tp as the reference's psum
    want = sum(int(s[1]) for _, _, s in jax_bands[4]) // 4
    assert int(count[0]) == want > 0


def test_sharded_render_dp_matches_jax(chunk):
    pool, counts, _ = chunk
    b = 8
    streams = [_stream(chunk, CAMS[i % 2]) for i in range(b)]
    sc = [s for s, _ in streams]
    ref_fn, _ = JS.make_sharded_render_dp(8, width=W, height=H,
                                          gather_cap=GQ, render_cap=RCAP,
                                          tile_k_cap=KCAP)
    ref = ref_fn(*(jnp.asarray(np.stack([s[k] for s in sc]))
                   for k in range(5)))
    fn, n = TS.make_sharded_render_dp(TS.make_mesh(devices=["cpu"] * 8),
                                      width=W, height=H, render_cap=RCAP,
                                      tile_k_cap=KCAP)
    assert n == 8
    got = fn(*(torch.stack([t[k] for _, t in streams]) for k in range(5)))
    assert got[0].shape == (b, H, W)
    for i in range(b):
        _near_jnp(ref[0][i], ref[1][i], got[0][i].numpy(), got[1][i].numpy())
        full = TPL.render_step(*streams[i][1], **_tkw())
        assert all(torch.equal(x, y[i]) for x, y in zip(full, got))
        np.testing.assert_array_equal(np.asarray(ref[2][i]),
                                      got[2][i].numpy())
    assert not torch.equal(got[0][0], got[0][1])
    with pytest.raises(ValueError):
        fn(*(torch.stack([t[k] for _, t in streams[:3]]) for k in range(5)))


def _init_frame(rng, out_h, width):
    """An init frame: random colours, depths in [0.95, 1) with a fifth of
    the pixels +inf (undrawn)."""
    color = rng.integers(-2**31, 2**31, (out_h, width)).astype(np.int32)
    depth = (0.95 + 0.05 * rng.random((out_h, width))).astype(np.float32)
    depth[rng.random((out_h, width)) < 0.2] = np.inf
    return color, depth


# (scene, with an init frame, band rows (y0, band_h) or None).  A band_h
# that is not a multiple of 16 pads the buffer, and the whole buffer, its
# padded rows included, is compared: the twin, like the Pallas kernel,
# evaluates an item on its octet's rows, and an octet that straddles the
# end of a tile's segment takes rows of the next tile's items (or, at the
# end of the stream, of the padding entries), which reach the padded rows
# (K2 evaluates each item on its own box, clamped to the band, and leaves
# them as they started: tests/test_torch_cuda.py).  There the Pallas
# kernel also leaves a colour over +inf depth at some pixels of its first
# padded row (measured: 1 pixel of fuzz (0, 72) with the init frame),
# so the colours of undrawn padded pixels are not compared.
K2_CASES = [("fuzz", True, None), ("fuzz", False, (32, 64)),
            ("fuzz", True, (48, 80)), ("terrain", True, (16, 96)),
            ("terrain", False, (40, 88)), ("fuzz", False, (16, 88)),
            ("fuzz", True, (0, 72))]


@pytest.mark.parametrize("name,init,band", K2_CASES)
def test_raster_twin_init_and_band_match_pallas_kernel(name, init, band):
    sc = S.scene(name)
    w, h, gc = sc[5]
    y0, bh = band or (0, h)
    records = JPL._render_step(
        *S.jax_args(sc), debug_return_records=True,
        **dict(S.jax_step_kw(sc, gc), **(dict(band_y0=y0, band_h=bh)
                                        if band else {})))
    out_h = -bh % 16 + bh
    ic = idp = None
    if init:
        ic, idp = _init_frame(np.random.default_rng(len(K2_CASES)), out_h,
                              w)
    c1, d1 = JR.rasterize_pallas(
        *records, None if ic is None else jnp.asarray(ic),
        None if idp is None else jnp.asarray(idp), height=h, width=w,
        tile_h=16, tile_w=128, out_h=out_h, interpret=True,
        stream_group=5, block_q=1024, y0_px=y0)
    tkw = dict(height=h, width=w, tile_h=16, tile_w=128, out_h=out_h,
               y0_px=y0)
    if init:
        tkw.update(init_color=torch.from_numpy(ic),
                   init_depth=torch.from_numpy(idp))
    trec = [torch.from_numpy(np.array(a)) for a in records]
    c2, d2 = TR.rasterize_tiles(*trec, **tkw)
    c1, d1 = np.asarray(c1), np.asarray(d1)
    np.testing.assert_array_equal(d1, d2.numpy())
    np.testing.assert_array_equal(c1[:bh], c2.numpy()[:bh])
    drawn = np.isfinite(d1[bh:])
    np.testing.assert_array_equal(c1[bh:][drawn], c2.numpy()[bh:][drawn])
    # the inputs matter: the init frame shows where no item wins, and the
    # band offset moves the rows' NDC
    c0, _ = TR.rasterize_tiles(*trec, **dict(tkw, y0_px=0, init_color=None,
                                             init_depth=None))
    assert not torch.equal(c0, c2)
    if init:
        assert bool((c2 == torch.from_numpy(ic)).any())
    elif out_h > bh:
        # the padded rows, which the step crops, are written here
        assert bool((c2[bh:] != TR.SKY_I32).any())
