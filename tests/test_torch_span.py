"""Span mode (``RenderConfig.span_mode``) of the port against the JAX
package, on the CPU.

Span mode draws each quad as its screen box at constant depth in its
block's flat colour.  The reference runs its stage A as jnp in span mode;
the port runs K1's span instance, whose plain twin is checked here (the
kernel itself against the twin on the card, tests/test_torch_cuda.py).

Tolerances.  Stage A's span fields, K1's twin and the span coefficients
equal the JAX package's XLA form bit for bit.  The span frame and stats of
``render_step`` equal the reference's ``_render_step(span_mode=True,
use_pallas=True, interpret=True)`` bit for bit (the boundary-verified gate
of rendering/parity.py is the fallback the tests allow where XLA:CPU
contracts a multiply-add; none is needed on these scenes).  Against the
float64 span oracle (``oracle.render_span``) at most 0.1% of the pixels
may differ in colour and depth by under 1e-4, tests/test_fuzz.py's
bounds.  The two-pass, temporal Hi-Z and band span frames equal the single
pass's bit for bit, as in exact mode.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.ops import projection as JP
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.ops import geometry as TG
from differential_projection_voxel_renderer_tpu_torch.ops import hiz as THZ
from differential_projection_voxel_renderer_tpu_torch.ops import projection as TP
from differential_projection_voxel_renderer_tpu_torch.parallel import (
    sharded_render as TSR,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import oracle
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)
from differential_projection_voxel_renderer_tpu_torch.utils.config import (
    SKY_COLOR,
)

SKY = np.uint32(SKY_COLOR)
N = 4096
N_QUADS = 3500  # the stream's length; the tail is out of stream

# (scene, render cap): the scene's gather cap takes the no-compaction
# branch, a smaller cap the compaction (the NDC rows cross it)
CASES = [("fuzz", 4096), ("fuzz", 2048), ("terrain", 16384),
         ("terrain", 8192)]


@pytest.fixture(scope="module")
def scenes():
    return {name: S.scene(name) for name in S.SCENES}


def _fuzz_stream():
    """Fuzzed words over every field (faces 6 and 7 included) with chunk
    origins around the camera, so that quads lie behind it, cross its near
    plane and face both ways."""
    rng = np.random.default_rng(77)
    f = [rng.integers(0, hi, N) for hi in (32, 32, 64, 64, 4, 32, 8)]
    u, v, w, h, blk, sl, face = f
    words = (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22) | (sl << 24)
             | (face << 29)).astype(np.uint32)
    qw = (rng.integers(-2, 2, (3, N)) * 32).astype(np.float32)
    return words, qw


CAMERAS = {"inside": ([5.0, 5.0, 5.0], [40.0, 0.0, 20.0]),
           "far": ([10.0, 60.0, 90.0], [0.0, 0.0, 0.0])}


def _camera(name, w, h):
    from differential_projection_voxel_renderer_tpu_torch.models.camera import (
        Camera,
    )

    pos, tgt = CAMERAS[name]
    cam = Camera(np.asarray(pos, np.float32), w / h)
    cam.look_at(np.asarray(tgt, np.float32))
    return (cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32))


@pytest.mark.parametrize("backface", [True, False])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_stage_a_span_fields_match_jax(cam, backface):
    """The span form of stage A (clip-normal backface test, no sub-pixel
    cull, the NDC box) and K1's plain twin with ``span_mode``, bit for
    bit."""
    words, qw = _fuzz_stream()
    vp, cp = _camera(cam, 256, 128)
    in_stream = np.arange(N) < N_QUADS
    ref = JP.project_and_cull(
        jnp.asarray(words), tuple(jnp.asarray(qw[a]) for a in range(3)),
        jnp.asarray(in_stream),
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), width=256,
        height=128, span_mode=True, backface_culling=backface)
    got = TP.project_and_cull(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(in_stream), torch.from_numpy(vp),
        torch.from_numpy(cp), width=256, height=128, span_mode=True,
        backface_culling=backface)
    assert set(ref) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(),
                                      err_msg=k)
    assert not got["subpixel"].any() and got["valid"].sum() > 50
    twin = TG.project_cull(
        TP.as_quad_words(words), torch.from_numpy(qw), N_QUADS,
        torch.from_numpy(vp), torch.from_numpy(cp), width=256, height=128,
        backface_culling=backface, span_mode=True)
    np.testing.assert_array_equal(twin["valid"].numpy(), np.asarray(
        ref["valid"]))
    np.testing.assert_array_equal(
        twin["bbx"].numpy(),
        np.asarray(ref["bb_x0"] | (ref["bb_x1"] << 16)))
    np.testing.assert_array_equal(twin["depth_near"].numpy(),
                                  np.asarray(ref["depth_near"]))
    for row, k in zip(twin["ndc"].numpy(), TG.NDC_ROWS):
        np.testing.assert_array_equal(row, np.asarray(ref[k]), err_msg=k)
    assert int(twin["subpix_total"]) == 0
    assert int(twin["valid_count"]) == int(np.asarray(ref["valid"]).sum())
    # the span backface test differs from the exact one on this stream
    exact = TP.project_and_cull(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(in_stream), torch.from_numpy(vp),
        torch.from_numpy(cp), width=256, height=128,
        backface_culling=backface)
    if backface:
        assert not torch.equal(exact["valid"] | exact["subpixel"],
                               got["valid"])


def test_kernel_outputs_span_layout():
    """With ``span`` the NDC rows sit between depth_near and valid, 16-byte
    aligned, in the same buffer; without it the layout is unchanged."""
    plain = TG.kernel_outputs(1024, "cpu")
    span = TG.kernel_outputs(1024, "cpu", span=True)
    assert "ndc" not in plain and span["ndc"].shape == (4, 1024)
    base = span["bbx"].data_ptr()
    assert span["ndc"].data_ptr() == base + 4 * 4 * 1024
    assert span["valid"].data_ptr() == base + 8 * 4 * 1024
    assert span["ndc"].data_ptr() % 16 == 0
    assert (plain["valid"].data_ptr() - plain["bbx"].data_ptr()
            == 4 * 4 * 1024)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_span_coefficients_match_jax(cam):
    words, qw = _fuzz_stream()
    vp, cp = _camera(cam, 256, 128)
    in_stream = np.arange(N) < N_QUADS
    tables = S.TABLES
    jproj = JP.project_and_cull(
        jnp.asarray(words), tuple(jnp.asarray(qw[a]) for a in range(3)),
        jnp.asarray(in_stream),
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), width=256,
        height=128, span_mode=True)
    ref = JP.quad_coefficients(
        jnp.asarray(words), tuple(jnp.asarray(qw[a]) for a in range(3)),
        jproj, JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), tables,
        width=256, height=128, span_mode=True)
    twin = TG.project_cull(
        TP.as_quad_words(words), torch.from_numpy(qw), N_QUADS,
        torch.from_numpy(vp), torch.from_numpy(cp), width=256, height=128,
        span_mode=True)
    got = TP.quad_coefficients(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(vp), TP.color_table_tensors(tables, "cpu"),
        (twin["ndc"], twin["depth_near"]), width=256, height=128)
    assert set(ref) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(),
                                      err_msg=k)


def _span_step(sc, render_cap, **kw):
    return TPL.render_step(*S.torch_args(sc), span_mode=True,
                           **dict(S.torch_step_kw(sc, render_cap), **kw))


@pytest.mark.parametrize("name,render_cap", CASES)
def test_render_step_span_matches_jax(scenes, name, render_cap):
    sc = scenes[name]
    jkw = dict(S.jax_step_kw(sc, render_cap), span_mode=True)
    c1, d1, s1 = JPL._render_step(*S.jax_args(sc), **jkw)
    rec1 = JPL._render_step(*S.jax_args(sc), debug_return_records=True,
                            **jkw)
    c2, d2, s2 = _span_step(sc, render_cap)
    rec2 = _span_step(sc, render_cap, debug_return_records=True)
    np.testing.assert_array_equal(np.asarray(s1), s2.numpy())
    assert int(s2[4]) == 0  # no sub-pixel cull in span mode
    c1 = np.asarray(c1).view(np.uint32)
    c2 = c2.numpy().view(np.uint32)
    parity.assert_kernel_parity(c1, np.asarray(d1), c2, d2.numpy())
    assert (c2 != SKY).sum() > 3000
    # the span records themselves, and the binning
    np.testing.assert_array_equal(np.asarray(rec1[0]), rec2[0].numpy())
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(np.asarray(rec1[i]), rec2[i].numpy())


def test_span_frame_against_oracle(scenes):
    """The port's span frame against the float64 span walker
    (tests/test_fuzz.py test_fuzz_span_mode's bounds)."""
    stream, qw, total, vp, cp, (w, h, gc) = scenes["fuzz"]
    color, depth, _ = _span_step(scenes["fuzz"], gc)
    color, depth = color.numpy().view(np.uint32), depth.numpy()
    oc, od = oracle.render_span(stream[:total], np.zeros(3), vp, cp, w, h)
    assert (oc != color).sum() <= w * h * 0.001
    both = np.isfinite(od) & np.isfinite(depth)
    assert np.abs(od[both] - depth[both]).max() < 1e-4
    assert (color != SKY).sum() > 3000


def _equal(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(
        a[1].view(torch.int32), b[1].view(torch.int32))


def _wall_case():
    """tests/test_macrotile.py's wall scene (the scene whose far quads the
    near pass occludes) as port step arguments, with its near pass."""
    import test_macrotile as TM
    from differential_projection_voxel_renderer_tpu.utils.config import (
        RenderConfig as JRenderConfig,
    )

    w = h = 128
    ja = TM._wall_args(JPL.Renderer(JRenderConfig(width=w, height=h,
                                                  use_pallas=False)))
    ta = (TP.as_quad_words(np.asarray(ja[0])),
          torch.from_numpy(np.array(ja[1])),
          torch.tensor(int(ja[2]), dtype=torch.int32),
          torch.from_numpy(np.array(ja[3])), torch.from_numpy(np.array(ja[4])))
    tkw = dict(color_tables=TP.color_table_tensors(S.TABLES, "cpu"),
               width=w, height=h, tile_h=16, tile_w=128, render_cap=4096,
               tile_k_cap=4096)
    return ta, tkw, 16


@pytest.mark.parametrize("name", sorted(S.SCENES) + ["wall"])
def test_span_occlusion_and_bands_equal_single_pass(scenes, name):
    """Two-pass (a stage A in each pass), temporal Hi-Z (the frame's own
    pyramid) and row bands (tp = 2, stacked) in span mode: each frame
    equals the single-pass span frame bit for bit, and the rasterized
    count is the single pass's less the culled quads (the wall scene
    culls; the other two scenes' pyramids hold sky in every cell a far
    quad covers, as in exact mode)."""
    if name == "wall":
        ta, tkw, near = _wall_case()
    else:
        sc = scenes[name]
        ta, tkw, near = S.torch_args(sc), S.torch_step_kw(sc, sc[5][2]), 512
    tkw = dict(tkw, span_mode=True)
    h = tkw["height"]
    single = TPL.render_step(*ta, **tkw)
    two = TPL._two_pass_step(*ta, near_quads=near, **tkw)
    hiz1 = THZ.build_max_pyramid(single[1])
    temporal = TPL.render_step(*ta, hiz_level1=hiz1, **tkw)
    for out in (two, temporal):
        assert _equal(out, single)
        assert int(out[2][1]) + int(out[2][5]) == int(single[2][1])
        assert int(out[2][4]) == 0
        assert (int(out[2][5]) > 0) == (name == "wall")
    bands = [TPL.render_step(*ta, band_y0=y0, band_h=h // 2, **tkw)
             for y0 in (0, h // 2)]
    assert _equal((torch.cat([b[0] for b in bands]),
                   torch.cat([b[1] for b in bands])), single)


def test_sharded_render_span_stacks_to_the_step(scenes):
    """``make_sharded_render(span_mode=True)`` with dp = 1, tp = 2 on the
    terrain patch's pool: the stacked bands equal the span step's frame."""
    from __graft_entry__ import _example_scene

    pool, counts, positions, n, _ = _example_scene()
    w, h, gc = scenes["terrain"][5]
    vp, cp = scenes["terrain"][3:5]
    mesh = TSR.make_mesh(devices=["cpu"] * 2)
    assert tuple(mesh) == (1, 2)
    fn = TSR.make_sharded_render(mesh, width=w, height=h, gather_cap=gc,
                                 render_cap=gc, tile_k_cap=2 * gc,
                                 color_tables=S.TABLES, span_mode=True)
    vis = torch.zeros((1, 64), dtype=torch.int32)
    vis[0, :n] = torch.arange(n)
    color, depth, count = fn(
        torch.from_numpy(pool.view(np.int32)), torch.from_numpy(counts),
        torch.from_numpy(positions), vis, torch.tensor([n]),
        torch.from_numpy(vp)[None], torch.from_numpy(cp)[None])
    single = _span_step(scenes["terrain"], gc)
    assert _equal((color[0], depth[0]), single)
    assert (color[0].numpy().view(np.uint32) != SKY).sum() > 3000


def test_span_renderer_with_packed_raster_renders_k2_frame(scenes):
    """A span Renderer with ``packed_raster`` renders through the tile
    raster (the reference's ``use_packed = packed_raster and not
    span_mode``): its frame is the plain span Renderer's, and its step
    never reaches the packed tail."""
    stream, qw, total, vp, cp, (w, h, gc) = scenes["fuzz"]
    up = (TP.as_quad_words(stream), torch.from_numpy(qw),
          torch.tensor(total, dtype=torch.int32))
    frames = {}
    for packed in (False, True):
        r = TPL.Renderer(TE.RenderConfig(width=w, height=h, span_mode=True,
                                         packed_raster=packed),
                         device="cpu")
        frames[packed] = r.render_prepared(up, vp, cp)
    assert _equal(frames[True], frames[False])
    assert torch.equal(frames[True][2], frames[False][2])
    rec = TPL.render_step(*S.torch_args(scenes["fuzz"]), span_mode=True,
                          packed_raster=True, debug_return_records=True,
                          **S.torch_step_kw(scenes["fuzz"], gc))
    assert len(rec) == 5  # the tile raster's inputs, not the packed seven


def test_dir_keep_mask_all_ones_in_span_mode():
    """The host direction mask is a strict subset of the exact backface
    cull; span mode's clip-normal test differs, so its mask keeps every
    direction (the reference's ``_dir_keep_mask``)."""
    pos = np.array([[0, 0, 0], [3, -1, 2], [-4, 1, -2]], np.int32)
    cam = np.array([40.0, 10.0, 5.0], np.float32)
    masks = {}
    for span in (False, True):
        eng = TE.Engine(TE.RenderConfig(width=128, height=128,
                                        span_mode=span),
                        TE.WorldConfig(view_distance=1), pool_slots=16,
                        device="cpu")
        masks[span] = eng._dir_keep_mask(pos, cam)
    assert (masks[True] == 1).all()
    assert (masks[False] == 0).any()


def test_span_step_refuses_carried_stage_a(scenes):
    """A carried stage A (frames in flight) has no NDC box: the step
    refuses it in span mode, as the reference asserts."""
    sc = scenes["fuzz"]
    ta, tkw = S.torch_args(sc), S.torch_step_kw(sc, 4096)
    pre = TPL._geom_stage(*ta, width=tkw["width"], height=tkw["height"],
                          backface_culling=True)
    with pytest.raises(ValueError):
        TPL.render_step(*ta, span_mode=True, pre_geom=pre, **tkw)
    with pytest.raises(ValueError):
        TPL.render_step(*ta, span_mode=True, next_geom=ta, **tkw)
