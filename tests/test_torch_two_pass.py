"""The port's exact occlusion modes on the CPU: two-pass
(``RenderConfig.two_pass_near_quads``, ``_two_pass_step``) against the JAX
package's ``_two_pass_step`` on its Pallas path in interpret mode, and
both modes against the port's own single pass.

Scene: the occluder wall of tests/test_macrotile.py (a solid chunk fills
the 128x128 view; a dense chunk of ~1k quads sits behind it).

Tolerances.  Frames must be bit-equal to the JAX step's, or pass the
boundary-verified gate (rendering/parity.py) where JAX's interpret
rounding differs; stats[:5] must be equal.  stats[5], the Hi-Z cull, must
be equal, or else every quad on which the two packages disagree must have
its near depth within 1e-4 (relative) of its pyramid cell: the port culls
only quads whose near depth lies more than ``HIZ_MARGIN_ULPS`` float32
ulps beyond the cell, because the reference's strict test culls quads
whose planar depth at a pixel they win rounds below their corner near
depth (PERF.md, section 6).  Frames of either mode must equal the port's single
pass bit for bit.

The temporal mode (``_step_camf_hiz``) runs against JAX's on the wall
stream with two pyramids, as numpy: the near pass's frame's and the
frame's own.  On both the reference's strict test culls the wall itself
and renders sky, while the port's frame stays the single pass's.  The
temporal Engines of both packages run side by side at 256x128, view
distance 3 (tests/test_macrotile.py's scene), every frame held to the
gates of tests/test_torch_engine.py with equal stats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_scenes as S
import test_macrotile as TM
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.ops import hiz as JH
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu.utils.config import (
    RenderConfig as JRenderConfig,
)
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.ops import hiz as TH
from differential_projection_voxel_renderer_tpu_torch.ops import raster as TR
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    parity as rparity,
    pipeline as TPL,
)
from differential_projection_voxel_renderer_tpu_torch.rendering.macrotile import (
    MacrotileRenderConfig,
    macrotile_renderer,
)

W = H = 128
NEAR = 16


def _wall(**caps):
    """The wall scene: (JAX args, JAX step kwargs, port args, port step
    kwargs) at the given gather/render caps."""
    jr = JPL.Renderer(JRenderConfig(width=W, height=H, use_pallas=False,
                                    **caps))
    ja = TM._wall_args(jr)
    ta = (TP.as_quad_words(np.asarray(ja[0])),
          torch.from_numpy(np.array(ja[1])),
          torch.tensor(int(ja[2]), dtype=torch.int32),
          torch.from_numpy(np.array(ja[3])),
          torch.from_numpy(np.array(ja[4])))
    cfg = jr.config
    tkw = dict(color_tables=TP.color_table_tensors(S.TABLES, "cpu"),
               width=W, height=H, tile_h=16, tile_w=128,
               render_cap=cfg.quads_cap, tile_k_cap=cfg.quads_cap)
    return ja, TM._kw(jr, use_pallas=True, interpret=True), ta, tkw


# (name, caps): a render cap below the gather cap compacts the stream
CAPS = {"compaction": {},
        "no compaction": dict(gather_cap=16384, quads_cap=16384)}


@pytest.fixture(scope="module")
def wall():
    return _wall()


def _occluded(h1, ga, far, dn):
    return TH.quads_occluded_exact(h1, ga["bbx"], ga["bby"], dn, height=H,
                                   width=W) & far


def _assert_culls_differ_at_cells(h1, ga, mask, n_ref, n_got):
    """The cull against pyramid ``h1`` of the quads in ``mask``, on stage A
    ``ga``: the port's rule culls ``n_got`` quads, and where the
    reference's count ``n_ref`` differs, the JAX rule (ops/hiz.py of the
    JAX package, on the same numpy inputs) and the port's disagree on
    exactly that many quads, each with its near depth within 1e-4
    (relative) of its pyramid cell: culled with the near depth moved 1e-4
    farther, kept with it moved 1e-4 nearer."""
    dn = ga["depth_near"]
    got = _occluded(h1, ga, mask, TPL._ulps_below(dn, TPL.HIZ_MARGIN_ULPS))
    assert int(got.sum()) == n_got
    ref = torch.from_numpy(np.asarray(JH.quads_occluded_exact(
        h1.numpy(), ga["bbx"].numpy(), ga["bby"].numpy(), dn.numpy(),
        height=H, width=W))) & mask
    assert int(ref.sum()) == n_ref
    diff = torch.nonzero(ref != got).flatten()
    assert len(diff) == abs(n_ref - n_got)
    above = _occluded(h1, ga, mask, dn * (1 + 1e-4))
    below = _occluded(h1, ga, mask, dn * (1 - 1e-4))
    assert bool(above[diff].all()) and not bool(below[diff].any())


def test_card_wall_scene_is_the_test_wall():
    """rendering/parity.wall_scene, the card's copy of this scene, holds
    the same stream and camera as tests/test_macrotile.py's."""
    ja, _, ta, _ = _wall(gather_cap=16384)
    args, kw = rparity.wall_scene("cpu")
    n = int(ta[2])
    assert int(args[2]) == n and kw["width"] == W and kw["height"] == H
    assert torch.equal(args[0][:n], ta[0][:n])
    assert torch.equal(args[1][:, :n], ta[1][:, :n])
    assert torch.equal(args[3], ta[3]) and torch.equal(args[4], ta[4])


def test_two_pass_matches_jax(wall):
    ja, jkw, ta, tkw = wall
    c1, d1, s1 = JPL._two_pass_step(*ja, near_quads=NEAR, **jkw)
    c2, d2, s2 = TPL._two_pass_step(*ta, near_quads=NEAR, **tkw)
    rec = TPL.render_step(*ta, debug_return_records=True, **tkw)
    c1 = np.asarray(c1).view(np.uint32)
    c2n = c2.numpy().view(np.uint32)
    parity.assert_kernel_parity_boundary(
        c1, np.asarray(d1), c2n, d2.numpy(), rec[0].numpy())
    np.testing.assert_array_equal(np.asarray(s1)[:5], s2.numpy()[:5])
    assert int(s2[5]) > 0
    # the far pass's cull, recomputed: the port's rule and the reference's
    # rule on the port's stage A and near frame
    _, d_near, _ = TPL.render_step(*ta[:2], torch.tensor(NEAR), *ta[3:],
                                   **tkw)
    h1 = TH.build_max_pyramid(d_near)
    ga = geometry.project_cull(*ta, width=W, height=H)
    idx = torch.arange(ta[0].shape[0])
    far = ga["valid"] & (idx >= NEAR) & (idx < ta[2])
    _assert_culls_differ_at_cells(h1, ga, far, int(s1[5]), int(s2[5]))


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_two_pass_equals_single_pass(caps):
    _, _, ta, tkw = _wall(**CAPS[caps])
    assert (ta[0].shape[0] > tkw["render_cap"]) == (caps == "compaction")
    c1, d1, s1 = TPL.render_step(*ta, **tkw)
    c2, d2, s2 = TPL._two_pass_step(*ta, near_quads=NEAR, **tkw)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert int(s2[5]) > 0
    assert s2[0] == s1[0] and s2[4] == s1[4]
    assert int(s1[1]) - int(s2[1]) == int(s2[5])


def test_temporal_cull_equals_single_pass(wall):
    """The temporal step on a frame's own pyramid: the wall's far quads
    are culled and the frame is unchanged (the reference's strict test
    would cull the wall itself here: its planar depth rounds one ulp below
    its corner near depth)."""
    _, _, ta, tkw = wall
    c1, d1, s1 = TPL.render_step(*ta, **tkw)
    cam_f = torch.from_numpy(TPL._pack_cam(ta[3].numpy(), ta[4].numpy()))
    c2, d2, s2, h2 = TPL._step_camf_hiz(*ta[:3], cam_f,
                                        TH.build_max_pyramid(d1), **tkw)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert int(s2[5]) > 0
    assert torch.equal(h2, TH.build_max_pyramid(d1))


@pytest.fixture(scope="module")
def wall_pyramids(wall):
    """The JAX single-pass frame of the wall (Pallas path, interpret mode)
    and the pyramids, as numpy, that the temporal step culls against: the
    two-pass near pass's frame's and the single-pass frame's own."""
    ja, jkw, ta, tkw = wall
    single = tuple(np.asarray(x) for x in JPL._render_step(*ja, **jkw))
    _, d_near, _ = TPL.render_step(*ta[:2], torch.tensor(NEAR), *ta[3:],
                                   **tkw)
    return single, {
        "near frame": TH.build_max_pyramid(d_near).numpy(),
        "own frame": np.asarray(JH.build_max_pyramid(jnp.asarray(single[1])))}


@pytest.mark.parametrize("pyramid", ["near frame", "own frame"])
def test_temporal_step_matches_jax(wall, wall_pyramids, pyramid):
    """The temporal step (``_step_camf_hiz``) of both packages on the wall
    stream and one pyramid.  The port's frame is the single pass's and
    its returned pyramid that frame's; stats agree but for the cull's
    split of stats[1] and stats[5], and every quad on which the two culls
    differ lies within 1e-4 of its pyramid cell.  On either pyramid the
    reference's strict test culls every quad, the wall that the pyramid's
    frame shows too (its planar depth at the pixels it wins rounds below
    its corner near depth), and renders sky: the reason for the port's
    margin."""
    ja, jkw, ta, tkw = wall
    (c0, d0, s0), pyr = wall_pyramids
    h1 = pyr[pyramid]
    cam_f = TPL._pack_cam(ta[3].numpy(), ta[4].numpy())
    c1, d1, s1, _ = JPL._step_camf_hiz(*ja[:3], jnp.asarray(cam_f),
                                       jnp.asarray(h1), **jkw)
    c2, d2, s2, h2 = TPL._step_camf_hiz(*ta[:3], torch.from_numpy(cam_f),
                                        torch.from_numpy(h1), **tkw)
    s1, s2n = np.asarray(s1), s2.numpy()
    rec = TPL.render_step(*ta, debug_return_records=True, **tkw)
    parity.assert_kernel_parity_boundary(
        c0.view(np.uint32), d0, c2.numpy().view(np.uint32), d2.numpy(),
        rec[0].numpy())
    assert torch.equal(h2, TH.build_max_pyramid(d2))
    np.testing.assert_array_equal(s1[[0, 2, 3, 4]], s2n[[0, 2, 3, 4]])
    assert s1[1] + s1[5] == s2n[1] + s2n[5] == s0[1]
    assert s2n[5] > 0
    ga = geometry.project_cull(*ta, width=W, height=H)
    valid = ga["valid"] & (torch.arange(ta[0].shape[0]) < ta[2])
    _assert_culls_differ_at_cells(torch.from_numpy(h1), ga, valid,
                                  int(s1[5]), int(s2[5]))
    # the reference's strict test culls every quad, the wall too
    assert s1[1] == 0 and (np.asarray(c1).view(np.int32) == TR.SKY_I32).all()


# the temporal engines' camera: tests/test_macrotile.py's pose, held for
# four frames, then moved
TEMPORAL_FRAMES = 5


@pytest.fixture(scope="module")
def temporal_engines():
    """tests/test_macrotile.py's temporal engine (256x128, view distance
    3, temporal_hiz) in both packages, frame by frame: [(JAX frame, port
    frame, port records)].  On the CPU the JAX Engine takes its jnp
    path."""
    jeng = JE.Engine(render_config=JRenderConfig(width=256, height=128,
                                                 temporal_hiz=True),
                     world_config=JW.WorldConfig(view_distance=3),
                     pool_slots=1024)
    teng = TE.Engine(TE.RenderConfig(width=256, height=128, temporal_hiz=True),
                     TE.WorldConfig(view_distance=3), pool_slots=1024,
                     device="cpu")
    for eng in (jeng, teng):
        eng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
        eng.camera.look_at(np.array([0.0, 0.0, -60.0]))
        while eng.world.update(eng.camera.position):
            pass
        eng.prime()
    frames = []
    for k in range(TEMPORAL_FRAMES):
        out = []
        for eng in (jeng, teng):
            if k == TEMPORAL_FRAMES - 1:
                eng.camera.position += np.array([0.5, 0.0, 0.0], np.float32)
            res = eng.render_frame(dt=0.0)
            out.append((res.color_numpy(), res.depth_numpy(),
                        np.asarray(res.stats) if eng is jeng
                        else res.stats.numpy(),
                        res.rendered_meshes, res.visible_chunks))
        frames.append((*out, S.engine_records(teng)))
    return frames


@pytest.mark.parametrize("frame", range(TEMPORAL_FRAMES))
def test_temporal_engine_matches_jax(temporal_engines, frame):
    """Each frame of the temporal engines: the gates of
    tests/test_torch_engine.py (the JAX jnp path's FMA rounding), stats
    equal, the Hi-Z cull's count included; the culls fire from the third
    static frame and stop once the camera moves."""
    ref, got, records = temporal_engines[frame]
    S.assert_engine_frame_gates(ref, got, records)
    culls = frame in (2, 3)
    assert (int(got[2][5]) > 0) == culls


def test_macrotile_facade(wall):
    """macrotile_renderer(use_hiz=True) renders the plain Renderer's
    frame through the public entry point."""
    _, _, ta, _ = wall
    r1 = TPL.Renderer(TE.RenderConfig(width=W, height=H), device="cpu")
    r2 = macrotile_renderer(
        width=W, height=H,
        config=MacrotileRenderConfig(tile_size=128, use_hiz=True,
                                     near_quads=NEAR), device="cpu")
    assert r2.config.two_pass_near_quads == NEAR
    vp, cp = ta[3].numpy(), ta[4].numpy()
    c1, d1, s1 = r1.render_prepared(ta[:3], vp, cp)
    c2, d2, s2 = r2.render_prepared(ta[:3], vp, cp)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert int(s1[5]) == 0 and int(s2[5]) > 0
    with pytest.raises(ValueError):
        macrotile_renderer(width=W, height=96, device="cpu")


def test_temporal_engine():
    """tests/test_macrotile.py's temporal engine on the port: the first
    frame takes the plain path, the second seeds the pyramid (culls
    nothing), the third culls against it with the same frame; a moved
    camera takes the plain path again."""
    eng = TE.Engine(TE.RenderConfig(width=256, height=128, temporal_hiz=True),
                    TE.WorldConfig(view_distance=3), pool_slots=1024,
                    device="cpu")
    eng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, -60.0]))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    f1, f2, f3 = [eng.render_frame(dt=0.0) for _ in range(3)]
    assert torch.equal(f1.color, f3.color) and torch.equal(f1.depth, f3.depth)
    assert torch.equal(f1.color, f2.color) and torch.equal(f1.depth, f2.depth)
    assert int(f1.stats[5]) == 0 and int(f2.stats[5]) == 0
    assert int(f3.stats[5]) > 0
    # the culled quads leave the rasterized count, nothing else
    assert int(f1.stats[1]) - int(f3.stats[1]) == int(f3.stats[5])
    assert torch.equal(f1.stats[[0, 2, 3, 4]], f3.stats[[0, 2, 3, 4]])
    eng.camera.position += np.array([0.5, 0.0, 0.0], np.float32)
    assert int(eng.render_frame(dt=0.0).stats[5]) == 0


def _renderer(**flags):
    return TPL.Renderer(TE.RenderConfig(width=W, height=H, **flags),
                        device="cpu")


def _pipelined(**flags):
    def run(ta, tkw):
        _renderer(**flags).render_prepared_pipelined(
            ta[:3], ta[3].numpy(), ta[4].numpy())
    return run


def _step(**kw):
    def run(ta, tkw):
        TPL.render_step(*ta, **dict(tkw, **kw))
    return run


# the exclusions the reference keeps: (error, what raises)
EXCLUSIONS = {
    "packed with two-pass": (ValueError, lambda ta, tkw: _renderer(
        packed_raster=True, two_pass_near_quads=NEAR)),
    "temporal with two-pass": (ValueError, lambda ta, tkw: _renderer(
        temporal_hiz=True, two_pass_near_quads=NEAR)),
    "two-pass in flight": (ValueError, _pipelined(two_pass_near_quads=NEAR)),
    "temporal in flight": (ValueError, _pipelined(temporal_hiz=True)),
    "packed step with an init frame": (ValueError, _step(
        packed_raster=True, init_color=torch.zeros((H, W), dtype=torch.int32),
        init_depth=torch.zeros((H, W)))),
    "band with the Hi-Z cull": (ValueError, _step(
        band_y0=0, band_h=64, hiz_level1=torch.zeros((16, 16)))),
    "band with an init frame": (ValueError, _step(
        band_y0=0, band_h=64, init_color=torch.zeros((64, W),
                                                      dtype=torch.int32),
        init_depth=torch.zeros((64, W)))),
    "span mode in flight": (ValueError, _pipelined(span_mode=True)),
}


@pytest.mark.parametrize("case", sorted(EXCLUSIONS))
def test_exclusions_raise(wall, case):
    err, run = EXCLUSIONS[case]
    with pytest.raises(err):
        run(wall[2], wall[3])
