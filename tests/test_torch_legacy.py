"""The port's legacy vertex renderer (rendering/legacy.py) and vertex
format (models/vertex.py) against the JAX package's, on the CPU.

The cases of tests/test_legacy_render.py and tests/test_formats.py's two
vertex cases, each with the same numpy inputs through both packages.

Tolerances.  Packing and unpacking are numpy and equal bit for bit.  The
vertex transform is held to rtol 1e-5, atol 1e-4 (tests/test_formats.py's
bound), because XLA:CPU may contract its multiply-adds into FMAs, which
torch never does.  For the same reason the frames are held to a gate.
Where the colours agree the depth may differ by 4 ulps (the contracted
barycentric depth sum; measured: 2 ulps on the first case's quad).  The
colours are equal except at pixels whose centre lies within 4 float32
ulps (of the edge function's terms) of a triangle edge, where two
covering triangles' depths tie within 4 ulps, or where at equal depth
each colour channel differs by at most one (the 8-bit truncation of a
shade the two compilations round to either side of an integer; measured:
one pixel of the terrain chunk, green 0x3f against 0x3e), and at most
0.1% of the frame.  The port's blocked evaluation equals the reference's
one-triangle-at-a-time loop, written out below, exactly: ties at equal
depth, -0.0 against +0.0, NaN depths and the triangle count included.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.models import vertex as JV
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.rendering import legacy as JL
from differential_projection_voxel_renderer_tpu_torch.meshing.greedy import (
    mesh_chunk,
)
from differential_projection_voxel_renderer_tpu_torch.meshing.quad_format import (
    quad_corners_local,
    unpack_quads,
)
from differential_projection_voxel_renderer_tpu_torch.models import vertex as TV
from differential_projection_voxel_renderer_tpu_torch.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    legacy as TL,
)
from differential_projection_voxel_renderer_tpu_torch.utils.config import (
    NEAR_W_EPS,
    SKY_COLOR,
)

torch.set_num_threads(1)

W = H = 128
SKY = np.uint32(SKY_COLOR)


def _quad_packed(z, light=(255, 255, 255, 255), block=3, ao=(0, 0, 0, 0)):
    """tests/test_legacy_render.py's +Z quad at local z, corners
    (4..28)^2, as packed vertices."""
    return TV.pack_vertices([4, 28, 28, 4], [4, 4, 28, 28], [z] * 4,
                            [block] * 4, np.asarray(light, np.float32) / 255.0,
                            [4] * 4, list(ao))


def _cam():
    cam = Camera(np.array([16.0, 16.0, 90.0], np.float32), 1.0)
    cam.look_at(np.array([16.0, 16.0, 0.0], np.float32))
    return cam.view_projection_matrix().astype(np.float32)


def _both(packed, n_quads, off, mvp, init=None, width=W, height=H):
    """The JAX and the port frame of the same packed mesh: ((colour u32,
    depth), (colour u32, depth))."""
    idx = TL.mesh_quads_to_triangles(n_quads)
    n = len(idx)
    unpacked = TV.unpack_vertices(packed)
    jv = {k: jnp.asarray(a) for k, a in unpacked.items()}
    tv = {k: torch.from_numpy(a) for k, a in unpacked.items()}
    jinit = {} if init is None else dict(
        init_color=jnp.asarray(init[0].view(np.int32)),
        init_depth=jnp.asarray(init[1]))
    tinit = {} if init is None else dict(
        init_color=torch.from_numpy(init[0].view(np.int32).copy()),
        init_depth=torch.from_numpy(init[1].copy()))
    jc, jd = JL.render_vertex_mesh(jv, jnp.asarray(idx), jnp.int32(n),
                                   jnp.asarray(off), jnp.asarray(mvp),
                                   width=width, height=height, **jinit)
    tc, td = TL.render_vertex_mesh(tv, torch.from_numpy(idx), n,
                                   torch.from_numpy(off),
                                   torch.from_numpy(mvp), width=width,
                                   height=height, **tinit)
    return ((np.asarray(jc).view(np.uint32), np.asarray(jd)),
            (tc.numpy().view(np.uint32), td.numpy()))


def _edge_or_tie(packed, n_quads, off, mvp, yy, xx, width, height):
    """Pixel (yy, xx) lies within 4 ulps of an edge of a covering
    triangle, or two covering triangles' depths tie within 4 ulps there
    (float64 evaluation of the float32 screen coordinates)."""
    v = TV.unpack_vertices(packed)
    world = np.stack([v["x"] + off[0], v["y"] + off[1], v["z"] + off[2],
                      np.ones(len(v["x"]))], 1).astype(np.float32)
    clip = (world.astype(np.float64) @ mvp.astype(np.float64).T)
    w = clip[:, 3]
    sx = (clip[:, 0] / w + 1.0) * (0.5 * width)
    sy = (1.0 - clip[:, 1] / w) * (0.5 * height)
    sz = clip[:, 2] / w
    px, py = xx + 0.5, yy + 0.5
    zs = []
    for t in TL.mesh_quads_to_triangles(n_quads):
        if (w[t] <= NEAR_W_EPS).any():
            continue
        x, y = sx[t], sy[t]
        edges = [(x[(k + 2) % 3] - x[(k + 1) % 3]) * (py - y[(k + 1) % 3])
                 - (y[(k + 2) % 3] - y[(k + 1) % 3]) * (px - x[(k + 1) % 3])
                 for k in range(3)]
        scale = max(abs(x).max(), abs(y).max(), px, py) ** 2
        slack = 4 * 2.0 ** -23 * 4 * scale
        area = edges[0] + edges[1] + edges[2]
        sgn = 1.0 if area >= 0 else -1.0
        e = [sgn * a for a in edges]
        if min(e) < -slack:
            continue
        if min(abs(a) for a in e) <= slack:
            return True
        b = np.array(e) / abs(area)
        zs.append(float(b @ sz[t]))
    zs.sort()
    return any(b - a <= 4 * np.spacing(np.float32(max(abs(a), 1.0)))
               for a, b in zip(zs, zs[1:]))


def _channel_flip(c1, c2):
    """Two ARGB words whose channels differ by at most one: the 8-bit
    truncation of a shade that the two compilations round to either side
    of an integer."""
    return all(abs(int((c1 >> s) & 0xFF) - int((c2 >> s) & 0xFF)) <= 1
               for s in (0, 8, 16, 24))


def _assert_frames_gate(ref, got, packed, n_quads, off, mvp, width=W,
                        height=H):
    (c1, d1), (c2, d2) = ref, got
    np.testing.assert_array_equal(np.isfinite(d1), np.isfinite(d2))
    # where the colours agree, the depth may differ by the contracted
    # multiply-adds of the barycentric sum (measured: 2 ulps)
    fin = np.isfinite(d1) & (c1 == c2)
    ulp = np.spacing(np.maximum(np.abs(d1[fin]), np.float32(1.0)))
    assert (np.abs(d1[fin] - d2[fin]) <= 4 * ulp).all()
    mism = np.argwhere(c1 != c2)
    assert len(mism) <= 0.001 * width * height, len(mism)
    for yy, xx in mism:
        same_depth = abs(d1[yy, xx] - d2[yy, xx]) <= 4 * np.spacing(
            np.maximum(np.abs(d1[yy, xx]), np.float32(1.0)))
        assert ((same_depth and _channel_flip(c1[yy, xx], c2[yy, xx]))
                or _edge_or_tie(packed, n_quads, off, mvp, yy, xx, width,
                                height)), (yy, xx)


def test_quad_renders_and_depth_tests():
    mvp = _cam()
    off = np.zeros(3, np.float32)
    far, near = _quad_packed(0), _quad_packed(20)
    ref, got = _both(far, 1, off, mvp)
    _assert_frames_gate(ref, got, far, 1, off, mvp)
    c, d = got
    assert (c != SKY).sum() > 500
    # the near quad drawn onto the far frame wins where it covers
    ref2, got2 = _both(near, 1, off, mvp, init=got)
    assert (got2[1] < d - 1e-6).sum() > 400
    _assert_frames_gate(ref2, got2, near, 1, off, mvp)
    # the reverse order gives the same frame: the depth test, not the
    # draw order, decides
    _, gn = _both(near, 1, off, mvp)
    _, gf = _both(far, 1, off, mvp, init=gn)
    np.testing.assert_array_equal(got2[0], gf[0])


def test_vertex_light_interpolates():
    mvp = _cam()
    off = np.zeros(3, np.float32)
    packed = _quad_packed(0, light=(40, 255, 255, 40))
    ref, got = _both(packed, 1, off, mvp)
    _assert_frames_gate(ref, got, packed, 1, off, mvp)
    row = got[0][H // 2]
    drawn = np.nonzero(row != SKY)[0]
    assert len(drawn) > 20
    red = (row[drawn] >> 16) & 0xFF
    assert red[-1] > red[0] + 40


def test_ao_darkens():
    mvp = _cam()
    off = np.zeros(3, np.float32)
    frames = []
    for ao in ((0, 0, 0, 0), (3, 3, 3, 3)):
        packed = _quad_packed(0, ao=ao)
        ref, got = _both(packed, 1, off, mvp)
        _assert_frames_gate(ref, got, packed, 1, off, mvp)
        frames.append(got[0])
    c0, c3 = frames
    m = (c0 != SKY) & (c3 != SKY)
    assert ((c0[m] >> 16) & 0xFF).mean() > ((c3[m] >> 16) & 0xFF).mean() * 2


def test_behind_camera_skipped():
    mvp = _cam()
    packed = _quad_packed(0)
    off = np.asarray([0.0, 0.0, 400.0], np.float32)
    ref, got = _both(packed, 1, off, mvp)
    for c, d in (ref, got):
        assert (c != SKY).sum() == 0 and np.isinf(d).all()


def _chunk_vertices(quads, light_seed=None):
    """A chunk mesh's quads as packed legacy vertices: each quad's four
    corners (quad_corners_local), its block, its face as the normal, light
    1.0 (or random, from the seed) and AO 0."""
    corners = quad_corners_local(quads).reshape(-1, 3).astype(np.int64)
    f = unpack_quads(quads)
    n = len(quads)
    light = (np.ones(4 * n, np.float32) if light_seed is None else
             np.random.default_rng(light_seed).random(4 * n, np.float32))
    return TV.pack_vertices(corners[:, 0], corners[:, 1], corners[:, 2],
                            np.repeat(f["block"], 4), light,
                            np.repeat(f["face"], 4), np.zeros(4 * n))


def _terrain_view(width, height):
    cam = Camera(np.array([0.0, 25.0, 0.0], np.float32), width / height)
    cam.look_at(np.array([16.0, 12.0, 16.0], np.float32))
    return cam.view_projection_matrix().astype(np.float32)


def test_terrain_chunk_frame_matches_jax():
    """A terrain chunk's mesh (hundreds of triangles, shared edges, ties
    along them) through both renderers, under the gate."""
    quads = mesh_chunk(Chunk.generate_terrain((0, 0, 0)))
    packed = _chunk_vertices(quads, light_seed=5)
    mvp = _terrain_view(W, H)
    off = np.zeros(3, np.float32)
    ref, got = _both(packed, len(quads), off, mvp)
    _assert_frames_gate(ref, got, packed, len(quads), off, mvp)
    assert (got[0] != SKY).sum() > 2000


def test_vertex_pack_roundtrip():
    rng = np.random.default_rng(0)
    n = 500
    x, y, z = (rng.integers(0, 33, n) for _ in range(3))
    b = rng.integers(0, 4, n)
    light = rng.random(n).astype(np.float32)
    nd = rng.integers(0, 6, n)
    ao = rng.integers(0, 4, n)
    v = TV.pack_vertices(x, y, z, b, light, nd, ao)
    np.testing.assert_array_equal(v, JV.pack_vertices(x, y, z, b, light,
                                                      nd, ao))
    d = TV.unpack_vertices(v)
    ref = JV.unpack_vertices(v)
    assert d.keys() == ref.keys()
    for k in d:
        np.testing.assert_array_equal(d[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(d["x"], x)
    np.testing.assert_array_equal(d["normal_index"], nd)
    np.testing.assert_array_equal(d["ao_level"], ao)
    np.testing.assert_array_equal(d["light"],
                                  (light * 255 + 0.5).astype(np.int32))


def test_batched_vertex_transform_matches_scalar():
    """tests/test_formats.py's case on the port, against the float32
    matrix product and the JAX transform."""
    rng = np.random.default_rng(1)
    n = 257
    xs, ys, zs = (rng.integers(0, 33, n) for _ in range(3))
    mvp = rng.standard_normal((4, 4)).astype(np.float32)
    off = np.array([64.0, -32.0, 128.0], np.float32)
    got = np.stack([c.numpy() for c in TV.decompress_and_transform_vertices(
        *(torch.from_numpy(a) for a in (xs, ys, zs)), torch.from_numpy(off),
        torch.from_numpy(mvp))], 1)
    ref = np.stack([np.asarray(c) for c in JV.decompress_and_transform_vertices(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs), jnp.asarray(off),
        jnp.asarray(mvp))], 1)
    world = np.stack([xs + 64.0, ys - 32.0, zs + 128.0, np.ones(n)],
                     1).astype(np.float32)
    np.testing.assert_allclose(got, world @ mvp.T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


# ------------------------------------------- blocked form against the loop


def _render_loop(vertices, indices, n_tris, off, mvp, *, width, height,
                 init_color=None, init_depth=None):
    """The reference's ``render_vertex_mesh`` one triangle at a time (its
    ``fori_loop`` body), in torch: the yardstick of the blocked form."""
    from differential_projection_voxel_renderer_tpu_torch.models.block_type import (
        BLOCK_COLORS,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops.shading import (
        AO_FACTORS,
    )

    cx, cy, cz, cw = TV.decompress_and_transform_vertices(
        vertices["x"], vertices["y"], vertices["z"], off, mvp)
    colors = torch.from_numpy(np.asarray(BLOCK_COLORS, np.float32))
    bright = (vertices["light"].float() / 255.0
              * torch.from_numpy(AO_FACTORS)[vertices["ao_level"].long()])
    base = colors[torch.clamp(vertices["block_type"], 0, 3).long()]
    inv_w = 1.0 / torch.where(cw.abs() > 1e-30, cw, 1e-30)
    sx = (cx * inv_w + 1.0) * (0.5 * width)
    sy = (1.0 - cy * inv_w) * (0.5 * height)
    sz = cz * inv_w
    px = torch.arange(width, dtype=torch.float32)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32)[:, None] + 0.5
    color = (torch.full((height, width), TL.SKY_I32, dtype=torch.int32)
             if init_color is None else init_color)
    depth = (torch.full((height, width), float("inf"))
             if init_depth is None else init_depth)
    eps = np.float32(NEAR_W_EPS).item()
    for t in range(indices.shape[0]):
        i0, i1, i2 = (int(i) for i in indices[t])
        ok_w = bool(cw[i0] > eps) and bool(cw[i1] > eps) and bool(
            cw[i2] > eps)
        x0, y0, x1, y1, x2, y2 = sx[i0], sy[i0], sx[i1], sy[i1], sx[i2], sy[i2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        flip = torch.where(area < 0, -1.0, 1.0)
        area_a = area.abs()
        w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * flip
        w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * flip
        w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * flip
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area_a > 0) & ok_w
        den = torch.clamp(area_a, min=1e-30)
        b0, b1, b2 = w0 / den, w1 / den, w2 / den
        z = b0 * sz[i0] + b1 * sz[i1] + b2 * sz[i2]
        lum = b0 * bright[i0] + b1 * bright[i1] + b2 * bright[i2]
        rgb = (b0[..., None] * base[i0] + b1[..., None] * base[i1]
               + b2[..., None] * base[i2]) * lum[..., None]
        rgb_u = torch.clamp(rgb, 0.0, 255.0).to(torch.int32)
        argb = (TL.OPAQUE_I32 | (rgb_u[..., 0] << 16) | (rgb_u[..., 1] << 8)
                | rgb_u[..., 2])
        win = inside & (z < depth) & (t < n_tris)
        color = torch.where(win, argb, color)
        depth = torch.where(win, z, depth)
    return color, depth


def _same_bits(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(
        a[1].view(torch.int32), b[1].view(torch.int32))


def _tensors(packed):
    return {k: torch.from_numpy(a)
            for k, a in TV.unpack_vertices(packed).items()}


def _blocks_of(monkeypatch, n, width, height):
    """Make render_vertex_mesh evaluate ``n`` triangles a block."""
    monkeypatch.setattr(TL, "BLOCK_ELEMENTS", n * width * height)


@pytest.mark.parametrize("block_tris", [None, 1, 3, 64])
def test_blocked_form_equals_triangle_loop_on_terrain(monkeypatch,
                                                      block_tris):
    """A terrain chunk's mesh (its first 300 quads: shared edges, ties
    between coplanar neighbours) in blocks of the default size, 1, 3 and
    64 triangles, and the count cutting the last block."""
    if block_tris is not None:
        _blocks_of(monkeypatch, block_tris, 64, 48)
    quads = mesh_chunk(Chunk.generate_terrain((0, 0, 0)))[:300]
    v = _tensors(_chunk_vertices(quads, light_seed=3))
    idx = torch.from_numpy(TL.mesh_quads_to_triangles(len(quads)))
    mvp = torch.from_numpy(_terrain_view(64, 48))
    off = torch.zeros(3)
    for n in (len(idx), len(idx) - 37):
        got = TL.render_vertex_mesh(v, idx, n, off, mvp, width=64,
                                    height=48)
        ref = _render_loop(v, idx, n, off, mvp, width=64, height=48)
        assert _same_bits(got, ref)
        assert int((got[0] != TL.SKY_I32).sum()) > 400


def test_blocked_form_equals_triangle_loop_on_ties_and_zeros(monkeypatch):
    """The same quad drawn four times in different light (exact depth
    ties: the first drawn wins), under a camera whose depth row is all
    -0.0 (every depth -0.0), onto an init frame at +0.0 and then at -0.0
    (a tie: nothing wins); and a NaN depth row (nothing wins)."""
    packed = np.concatenate([_quad_packed(5, light=(lv,) * 4)
                             for lv in (60, 120, 180, 240)])
    v = _tensors(packed)
    idx = torch.from_numpy(TL.mesh_quads_to_triangles(4))
    mvp = torch.from_numpy(_cam())
    off = torch.zeros(3)
    kw = dict(width=W, height=H)
    plain = TL.render_vertex_mesh(v, idx, 8, off, mvp, **kw)
    assert _same_bits(plain, _render_loop(v, idx, 8, off, mvp, **kw))
    _blocks_of(monkeypatch, 1, W, H)
    assert _same_bits(plain, TL.render_vertex_mesh(v, idx, 8, off, mvp,
                                                   **kw))
    monkeypatch.undo()
    first = TL.render_vertex_mesh(v, idx[:2], 2, off, mvp, **kw)
    assert torch.equal(plain[0], first[0])  # the first drawn quad wins
    neg = mvp.clone()
    neg[2] = -0.0
    out = TL.render_vertex_mesh(v, idx, 8, off, neg, **kw)
    assert _same_bits(out, _render_loop(v, idx, 8, off, neg, **kw))
    drawn = out[0] != TL.SKY_I32
    assert bool(drawn.any())
    assert bool((out[1][drawn].view(torch.int32) == -2**31).all())  # -0.0
    for zero in (0.0, -0.0):
        init = (torch.full((H, W), 7, dtype=torch.int32),
                torch.full((H, W), zero))
        got = TL.render_vertex_mesh(v, idx, 8, off, neg, init_color=init[0],
                                    init_depth=init[1], **kw)
        ref = _render_loop(v, idx, 8, off, neg, init_color=init[0],
                           init_depth=init[1], **kw)
        assert _same_bits(got, ref) and _same_bits(got, init)
    nan = mvp.clone()
    nan[2, 3] = float("nan")
    got = TL.render_vertex_mesh(v, idx, 8, off, nan, **kw)
    assert _same_bits(got, _render_loop(v, idx, 8, off, nan, **kw))
    assert bool((got[0] == TL.SKY_I32).all())


def test_resolve_block_matches_sequential_test():
    """``resolve_block`` on synthetic depths: ties, +-0, NaN, +-inf and
    uncovered triangles, against the strict test applied in order."""
    rng = np.random.default_rng(13)
    vals = np.array([0.5, 0.25, 0.0, -0.0, np.nan, np.inf, -np.inf, 0.75],
                    np.float32)
    z = torch.from_numpy(vals[rng.integers(0, len(vals), (9, 16, 16))])
    inside = torch.from_numpy(rng.random((9, 16, 16)) < 0.7)
    depth = torch.from_numpy(vals[rng.integers(0, len(vals), (16, 16))])
    first, zw, win = TL.resolve_block(z, inside, depth)
    ref_d, ref_i = depth.clone(), torch.full((16, 16), -1)
    for t in range(9):
        w = inside[t] & (z[t] < ref_d)
        ref_d = torch.where(w, z[t], ref_d)
        ref_i = torch.where(w, t, ref_i)
    got_d = torch.where(win, zw, depth)
    assert torch.equal(got_d.view(torch.int32)[~torch.isnan(got_d)],
                       ref_d.view(torch.int32)[~torch.isnan(ref_d)])
    assert torch.equal(torch.isnan(got_d), torch.isnan(ref_d))
    assert torch.equal(torch.where(win, first, -1), ref_i)
