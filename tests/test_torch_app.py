"""The port's application surface on the CPU against the JAX package's:
``prime_all``, the runtime toggles, the shading toggle, the flythrough,
``Renderer.render`` with legacy [vcap] totals, ``QuadPool.slot_of`` and
``device_tables``, and the warm-ups.

The engines run the configuration of tests/test_torch_engine.py (256x128,
view distance 3, gather cap 16384, 512 pool slots, 4 chunks streamed a
frame) from the same pose, primed with ``prime_all``.  The port engine
also runs ``warm_buckets`` and ``warm_streaming`` in the order of the JAX
package's flythrough bench (warm_buckets, one frame, warm_streaming); the
JAX engine runs neither.

Tolerances.  Pools, draw lists, stats and mesh counts are exact.  Frames
go through the gates of tests/test_torch_engine.py
(tests/_torch_scenes.py ``assert_engine_frame_gates``), with one
difference: where the colours agree, depth may differ by 32 ulps, not 4.
The flythrough's first key looks at the terrain from 60 units up and out,
and there the JAX jnp path's frame, whose XLA:CPU program contracts the
planar-depth coefficients' cancelling sums into FMAs (README "One
caveat"), differs from the port's (which equals the JAX Pallas path bit
for bit, tests/test_torch_pipeline.py) by up to 24 ulps at depths near
0.998, with the same colour (measured; the z evaluation's own terms are
below 0.011 there, so it is the coefficients).  Every colour mismatch must
still be proven by the boundary gate.  The warm-ups are held exactly:
each leaves the pool state as it was, and the first streaming frame after
them equals that of a port engine that never warmed, bit for bit.  The
reference's frames-in-flight, fused-insert and resident-append self-tests
return "exact" on the port's plain versions.
"""

import numpy as np
import pytest
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.app import flythrough as JF
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.rendering import (
    parity as JPAR,
)
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.app import (
    flythrough as TF,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    parity as TPAR,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

SKY = np.uint32(JCFG.SKY_COLOR)
POSE0 = ((0.0, 40.0, 60.0), (0.0, 0.0, 0.0))
# the path of tests/test_engine.py test_flythrough_runs
KEYS = [((60.0, 40.0, 60.0), (0.0, 0.0, 0.0)),
        ((40.0, 35.0, 70.0), (10.0, 0.0, 0.0)),
        ((20.0, 30.0, 80.0), (20.0, 0.0, 0.0))]


def _configs(render_config_cls, world_config_cls):
    return dict(
        render_config=render_config_cls(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=4),
        pool_slots=512)


def _jax_engine():
    return JE.Engine(**_configs(JCFG.RenderConfig, JW.WorldConfig))


def _port_engine():
    return TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                     device="cpu")


def _pose(eng, pose):
    eng.camera.position = np.array(pose[0], np.float32)
    eng.camera.look_at(np.array(pose[1], np.float32))


def _primed(eng):
    _pose(eng, POSE0)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    return eng


def pool_state(pool):
    """Everything a later frame or slot choice of a port pool reads."""
    lc = pool._lookup_cache
    return dict(quads=pool.quads.clone(), counts=pool.counts.copy(),
                counts6=pool.counts6.copy(),
                positions=pool.positions.copy(), by_pos=dict(pool.by_pos),
                free=list(pool._free), used=pool._used.copy(),
                drops=pool.overflow_drops,
                lookup=None if lc is None else (lc[0].copy(), lc[1].copy()))


def assert_same_pool_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k == "lookup" and a[k] is not None:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        else:
            assert a[k] == b[k], k


def _legacy_render(eng, records=False):
    """The last frame's draw list with [vcap] totals and no dir mask,
    through ``Renderer.render`` (or, for the port, the raster records of
    the same uploads)."""
    r = eng.renderer
    totals = eng._last_counts_sel.sum(axis=1).astype(np.int32)
    args = (eng.pool.quads, eng._last_visible_slots, totals,
            eng._last_positions_sel)
    vp, cp = eng.camera.view_projection_matrix(), eng.camera.position
    if records:
        up = r.prepare_uploads(*args)
        return TPL._step_camf(*up, r._cam_dev(vp, cp),
                              debug_return_records=True,
                              **r._bucket_kw(int(up[0].shape[0])))[0].numpy()
    c, d, s = r.render(*args, vp, cp)
    if isinstance(c, torch.Tensor):
        c, d, s = c.numpy(), d.numpy(), s.numpy()
    return np.asarray(c).view(np.uint32), np.asarray(d), np.asarray(s)


@pytest.fixture(scope="module")
def app():
    """Both engines primed; the port's warm-ups; frame 0; the shading
    round trip; the flythrough; a legacy-totals render.  Each port frame
    comes with its raster records and draw list, each JAX frame with its
    draw list."""
    jeng, teng = _primed(_jax_engine()), _primed(_port_engine())
    out = dict(jeng=jeng, teng=teng,
               primed=(S.pool_tables(jeng.pool), S.pool_tables(teng.pool)))
    before = pool_state(teng.pool)
    teng.warm_buckets()
    out["warm_buckets"] = (before, pool_state(teng.pool))
    pairs = []   # (jax frame, its draw list, port frame, records, draw list)

    def both():
        jf = S.frame_tuple(jeng.render_frame(dt=0.0))
        tf = S.frame_tuple(teng.render_frame(dt=0.0))
        pairs.append((jf, S.draw_list(jeng), tf, S.engine_records(teng),
                      S.draw_list(teng)))

    both()
    before = pool_state(teng.pool)
    caches = (teng._upload_cache, teng.renderer._cam_cache)
    tables = dict(teng.renderer._base_step_kw["color_tables"])
    teng.warm_streaming()
    out["warm_streaming"] = (before, pool_state(teng.pool), caches,
                             (teng._upload_cache, teng.renderer._cam_cache))
    # the shading round trip
    toggles = [eng.toggle_shading() for eng in (jeng, teng)]
    both()
    toggles += [eng.toggle_shading() for eng in (jeng, teng)]
    out["shading"] = (toggles, tables,
                      dict(teng.renderer._base_step_kw["color_tables"]))
    # the flythrough, key by key (each frame's records right after it)
    for p, t in KEYS:
        jr = JF.run_flythrough(jeng, [JF.CameraKey(np.array(p, np.float32),
                                                   np.array(t, np.float32))])
        tr = TF.run_flythrough(teng, [TF.CameraKey(np.array(p, np.float32),
                                                   np.array(t, np.float32))])
        assert len(jr) == len(tr) == 1
        pairs.append((S.frame_tuple(jr[0]), S.draw_list(jeng),
                      S.frame_tuple(tr[0]), S.engine_records(teng),
                      S.draw_list(teng)))
    out["pools_after"] = (S.pool_tables(jeng.pool), S.pool_tables(teng.pool))
    out["legacy"] = (_legacy_render(jeng), _legacy_render(teng),
                     _legacy_render(teng, records=True))
    # the first streaming frame on a port engine that never warmed
    ueng = _primed(_port_engine())
    _pose(ueng, KEYS[0])
    out["unwarmed"] = S.frame_tuple(ueng.render_frame())
    out["pairs"] = pairs
    return out


def _assert_pair(pair):
    jf, jdl, tf, records, tdl = pair
    for a, b in zip(jdl, tdl):
        np.testing.assert_array_equal(a, b)
    S.assert_engine_frame_gates(jf, tf, records, depth_ulps=S.JNP_DEPTH_ULPS)


def test_prime_all_matches_jax(app):
    """Every loaded chunk meshed into the same slots, rows and counts."""
    ref, got = app["primed"]
    assert len(got[0]) > 50
    S.assert_same_pool_tables(ref, got)


def test_shading_toggle_matches_jax(app):
    """F-key analogue (tests/test_engine.py test_shading_toggle_runtime):
    the unshaded frame matches JAX's unshaded frame, has the shaded
    frame's coverage and differs from it at covered pixels; toggling back
    restores the colour tables exactly (the frame is a function of the
    tables, the stream and the camera: chip_smoke.py phase 14 renders
    it)."""
    toggles, before, after = app["shading"]
    assert toggles == [False, False, True, True]
    assert app["teng"].config.enable_shading
    assert app["teng"].renderer.config is app["teng"].config
    for pair in app["pairs"][:2]:
        _assert_pair(pair)
    base, flat = app["pairs"][0][2][0], app["pairs"][1][2][0]
    np.testing.assert_array_equal(base != SKY, flat != SKY)
    both = base != SKY
    assert (base[both] != flat[both]).any()
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k


def test_flythrough_matches_jax(app):
    """A three-key flythrough (tests/test_engine.py test_flythrough_runs),
    port against JAX frame by frame, and the pools after it."""
    pairs = app["pairs"][2:]
    assert len(pairs) == len(KEYS)
    for pair in pairs:
        _assert_pair(pair)
    assert (pairs[-1][2][0] != SKY).sum() > 100
    S.assert_same_pool_tables(*app["pools_after"])


def test_render_legacy_totals_matches_jax(app):
    """``Renderer.render`` with [vcap] totals (one dir-0 unit a chunk)."""
    ref, got, records = app["legacy"]
    S.assert_engine_frame_gates(ref, got, records, depth_ulps=S.JNP_DEPTH_ULPS)


def test_warm_buckets_changes_nothing(app):
    before, after = app["warm_buckets"]
    assert_same_pool_state(before, after)


def test_warm_streaming_changes_nothing(app):
    """The throwaway entry's slot, its device row and host counts, the
    free list, the used mask and the lookup cache are restored exactly;
    the upload and camera caches are untouched; the first streaming frame
    equals that of an engine that never warmed, bit for bit."""
    before, after, caches, caches_after = app["warm_streaming"]
    assert_same_pool_state(before, after)
    assert all(a is b for a, b in zip(caches, caches_after))
    got, ref = app["pairs"][2][2], app["unwarmed"]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_warm_streaming_takes_the_next_free_slot():
    """The throwaway entry takes the slot the next insert takes, and that
    slot is the next insert's again after the call."""
    pool = TE.QuadPool(slots=8, qcap=1024, device="cpu")
    pool.insert((0, 0, 0), np.arange(3, dtype=np.uint32))
    eng = _port_engine()
    eng.pool = pool
    free = list(pool._free)
    eng.warm_streaming()
    assert pool._free == free
    assert (10**6, 10**6, 10**6) not in pool
    pool.insert((1, 0, 0), None)
    assert pool.slot_of((1, 0, 0)) == free[-1]


def test_runtime_toggles_match_jax():
    """tests/test_engine.py test_runtime_toggles on both engines."""
    got = []
    for eng in (JE.Engine(render_config=JCFG.RenderConfig(
                    width=128, height=128, use_pallas=False, gather_cap=2048,
                    quads_cap=1024, visible_chunks_cap=16),
                    world_config=JW.WorldConfig(view_distance=1,
                                                max_chunks_per_frame=1000),
                    pool_slots=32),
                TE.Engine(render_config=TE.RenderConfig(
                    width=128, height=128, gather_cap=2048, quads_cap=1024,
                    visible_chunks_cap=16),
                    world_config=TE.WorldConfig(view_distance=1,
                                                max_chunks_per_frame=1000),
                    pool_slots=32, device="cpu")):
        got.append([eng.toggle_occlusion_culling(),
                    eng.toggle_occlusion_culling(), eng.toggle_shading(),
                    eng.toggle_shading()])
        eng.set_view_distance(2)
        got[-1].append(eng.world.config.view_distance)
    assert got[0] == got[1] == [True, False, False, True, 2]


def test_set_shading_refuses_a_frame_in_flight():
    eng = TE.Engine(render_config=TE.RenderConfig(width=128, height=128),
                    world_config=TE.WorldConfig(view_distance=1),
                    pool_slots=32, device="cpu")
    _pose(eng, POSE0)
    eng.world.generate_region((-1, 0, -1), (1, 0, 1))
    eng.prime()
    assert eng.render_frame_pipelined(dt=0.0) is None
    with pytest.raises(RuntimeError, match="in flight"):
        eng.toggle_shading()
    assert eng.config.enable_shading
    assert eng.flush_pipeline() is not None
    assert eng.toggle_shading() is False


def test_slot_of_and_device_tables_match_jax():
    """tests/test_engine.py test_pool_slot_reuse_and_overflow_reporting on
    both pools, and the positions table: on the pool's device, the same
    tensor until a mutation, equal to JAX's."""
    jp = JE.QuadPool(slots=4, qcap=16)
    tp = TE.QuadPool(slots=4, qcap=16, device="cpu")
    ops = [("insert", (0, 0, 0), np.arange(10, dtype=np.uint32)),
           ("insert", (1, 0, 0), np.arange(30, dtype=np.uint32)),
           ("remove", (0, 0, 0), None), ("insert", (2, 0, 0), None),
           ("insert", (3, 0, 0), np.arange(4, dtype=np.uint32)),
           ("insert", (4, 0, 0), np.arange(4, dtype=np.uint32))]
    for op, pos, quads in ops:
        t0 = tp.device_tables()
        assert tp.device_tables() is t0
        for pool in (jp, tp):
            if op == "remove":
                pool.remove(pos)
            else:
                pool.insert(pos, quads)
        t1 = tp.device_tables()
        assert t1 is not t0 and t1.device.type == "cpu"
        np.testing.assert_array_equal(t1.numpy(),
                                      np.asarray(jp.device_tables()))
        for p in [(i, 0, 0) for i in range(6)]:
            assert tp.slot_of(p) == jp.slot_of(p), p
            assert (p in tp) == (p in jp)
    assert tp.overflow_drops == jp.overflow_drops == 14
    assert tp.counts[tp.slot_of((1, 0, 0))] == 16
    assert tp.counts[tp.slot_of((2, 0, 0))] == 0
    for pool in (jp, tp):
        with pytest.raises(RuntimeError):
            pool.insert((5, 0, 0), np.arange(4, dtype=np.uint32))


@pytest.mark.parametrize("name", ["pipelined", "fused_insert",
                                  "resident_append"])
def test_streaming_selftests_on_the_cpu(name):
    """The reference's last three parity self-tests on the port's plain
    versions: frames in flight against the serial step, the fused insert
    and the resident append + scatter against the separate calls, each
    frame and pool bit for bit.  The JAX package's resident gate passes on
    its jnp path too (its other two compile Mosaic or interpret Pallas
    kernels here)."""
    assert getattr(TPAR, f"run_{name}_selftest")(device="cpu") == "exact"
    if name == "resident_append":
        assert JPAR.run_resident_append_selftest(use_pallas=False) == "exact"


def test_append_steps_follow_the_shading_toggle():
    """The renderer's cached resident steps bind the colour tables, so
    set_shading drops them: the append step after the toggle renders the
    unshaded tables, as the plain step does."""
    r = TPL.Renderer(TE.RenderConfig(width=128, height=128), device="cpu")
    shaded = r._append_step_for(16384)
    assert r._append_step_for(16384) is shaded
    r.set_shading(False)
    flat = r._append_step_for(16384)
    assert flat is not shaded
    assert (flat.keywords["color_tables"]
            is r._bucket_kw(16384)["color_tables"])
