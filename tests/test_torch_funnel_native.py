"""The host funnel's draw-list stage as one native pass
(``Engine._funnel_native`` over ``native_bridge.funnel_pass``) against its
numpy twin (``Engine._funnel_numpy``), on the CPU:

- the pass and the twin bit for bit: two engines in lockstep, one through
  each, the same poses a frame; each frame's draw list (slots, counts,
  direction masks, positions, ``n``), its visible-mesh count, its
  signature and the visible chunks it found with no mesh must be equal.
  Cases: 200 pan poses; a 130-frame flight into fresh terrain with its
  loads, unloads and remeshes; random poses at fractional positions and
  on chunk boundaries; horizon culling off; backface culling off; span
  mode; a draw-list cap under the list's length; an empty pool and an
  empty world; the occlusion pass on, where the funnel takes the twin
  whole and counts no native funnel;
- the pass's sort keys against numpy's ``(d * d).sum(-1)`` at fractional
  camera positions;
- the same frames from either path through the engine: a 40-frame flight
  of ``render_frame`` and two-view ``render_views`` calls, their frames
  and stats equal, with the counter ``funnel_native`` one a funnel on
  the pass's engine and none on the twin's;
- the counter ``funnel_native`` a no-op under ``DPVR_TRACE=0``, and the
  benchmark's reader ``native_funnel_share`` on the tracer's frames.

Skips where the native library cannot be built (no pass to test)."""

import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from benchmark.metrics import native_funnel_share
from benchmark.trace import Spans
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.meshing import (
    native_bridge,
)
from differential_projection_voxel_renderer_tpu_torch.utils import (
    profiling as P,
)

pytestmark = pytest.mark.skipif(
    native_bridge.funnel_pass is None,
    reason="the native library cannot be built here: no funnel pass")

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
PITCH = -0.12435499454676144
RENDER = dict(width=256, height=128, gather_cap=16384, quads_cap=8192,
              tile_k_cap=16384)
# the frames rendered on the CPU: small, as the CPU raster is slow
SMALL = dict(width=128, height=64, gather_cap=8192, quads_cap=4096,
             tile_k_cap=8192)


def _engine(vd=5, chunks_a_frame=16, prime=True, render=None, attrs=None,
            start=(0.0, 10.0, 20.0), mesh_cards=None):
    eng = TE.Engine(TE.RenderConfig(**dict(RENDER, **(render or {}))),
                    TE.WorldConfig(view_distance=vd, frustum_culling=True,
                                   max_chunks_per_frame=chunks_a_frame),
                    pool_slots=2048, device="cpu", mesh_cards=mesh_cards)
    for k, v in (attrs or {}).items():
        setattr(eng, k, v)
    eng.camera.position = np.array(start, np.float32)
    eng.camera.pitch = PITCH
    if prime:
        while eng.world.update(eng.camera.position):
            pass
        eng.prime_all()
    return eng


def _set(eng, pose):
    position, yaw, pitch = pose
    eng.camera.position = np.array(position, np.float32)
    eng.camera.yaw, eng.camera.pitch = float(yaw), float(pitch)


def _pan(frames, yaw0=0.3):
    return [((0.0, 10.0, 20.0), yaw0 + 0.01 * k, PITCH)
            for k in range(frames)]


def _flight(frames, step=(3.0, 0.0, -3.0)):
    """From (0, 24, 20) by ``step`` and 0.01 rad a frame."""
    return [(tuple(np.array((0.0, 24.0, 20.0)) + np.array(step) * k),
             0.01 * k, PITCH) for k in range(1, frames + 1)]


def _random(frames, seed=7):
    """Fractional positions inside the loaded region, and cameras on
    chunk boundaries (one axis or all three at a multiple of 32)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(frames):
        p = rng.uniform((-40.0, 2.0, -40.0), (40.0, 60.0, 60.0))
        if k % 4 == 0:
            p[k // 4 % 3] = 32.0 * np.round(p[k // 4 % 3] / 32.0)
        if k % 9 == 0:
            p = 32.0 * np.round(p / 32.0)
        out.append((tuple(p), rng.uniform(-math.pi, math.pi),
                    rng.uniform(-1.2, 1.2)))
    return out


def _spy_missing(eng, got):
    """Record the visible chunks found with no mesh (the argument of
    ``_remesh_list_of``), each call that has some (the twin finds none
    without the call)."""
    orig = eng._remesh_list_of

    def spy(missing):
        if len(missing):
            got.append(np.asarray(missing).copy())
        return orig(missing)

    eng._remesh_list_of = spy


def _draw(eng):
    dl = eng.draw_list()
    return dict(slots=dl.slots, counts6=dl.counts6, dir_mask=dl.dir_mask,
                positions=dl.positions, n=dl.n)


def _lockstep(make, poses, hold_world=0):
    """Two engines from ``make``, the first through the pass, the second
    through the twin, a funnel a pose each in a frame of the tracer (the
    world held for the first ``hold_world``); asserts every frame equal.
    Returns (frames, the first engine, the funnel_native count of each
    engine's frames, first then second, and the first's missing
    lists)."""
    nat, twin = make(), make()
    twin._funnel_native = twin._funnel_numpy
    missing = {id(nat): [], id(twin): []}
    for e in (nat, twin):
        _spy_missing(e, missing[id(e)])
    counts = {id(nat): [], id(twin): []}
    for k, pose in enumerate(poses):
        out = {}
        for e in (nat, twin):
            _set(e, pose)
            e._hold_world = k < hold_world
            P.TRACER.reset()
            with P.FRAME(CPU):
                vp, sig, n, n_vis, cam_same = e._funnel(0.016)
            counts[id(e)].append(int(P.TRACER.frames(1).count(
                "funnel_native")[0]))
            e._hold_world = False
            if e._pending_insert is not None:
                e.pool.dispatch_insert_payload(e._pending_insert)
                e._pending_insert = None
            out[id(e)] = (vp, sig, n, n_vis, cam_same, _draw(e))
        a, b = out[id(nat)], out[id(twin)]
        assert np.array_equal(a[0], b[0]) and a[1] == b[1], k
        assert a[2:5] == b[2:5], (k, a[2:5], b[2:5])
        for name in ("slots", "counts6", "dir_mask", "positions"):
            x, y = a[5][name], b[5][name]
            assert x.dtype == y.dtype and x.shape == y.shape, (k, name)
            assert np.array_equal(x, y), (k, name)
        assert a[5]["n"] == b[5]["n"] == a[2]
        ma, mb = missing[id(nat)], missing[id(twin)]
        assert len(ma) == len(mb) and all(
            np.array_equal(x, y) for x, y in zip(ma, mb)), k
    return len(poses), nat, counts[id(nat)], counts[id(twin)], missing[
        id(nat)]


CASES = {
    "pan": dict(make={}, poses=lambda: _pan(200)),
    "stream": dict(make=dict(vd=3, chunks_a_frame=8,
                             start=(0.0, 24.0, 20.0)),
                   poses=lambda: _flight(130)),
    "random": dict(make={}, poses=lambda: _random(60)),
    "horizon_off": dict(make=dict(attrs={"enable_horizon_culling": False}),
                        poses=lambda: _pan(30) + _random(20, seed=3)),
    "backface_off": dict(make=dict(render={"backface_culling": False}),
                         poses=lambda: _random(30, seed=4)),
    "span_mode": dict(make=dict(render={"span_mode": True}),
                      poses=lambda: _random(30, seed=5)),
    "small_cap": dict(make=dict(render={"visible_chunks_cap": 16}),
                      poses=lambda: _pan(20) + _random(20, seed=6)),
    "empty_pool": dict(make=dict(prime=False),
                       poses=lambda: _pan(6) + _flight(20)),
    "occlusion": dict(make=dict(attrs={"enable_occlusion_culling": True}),
                      poses=lambda: _pan(20) + _random(10, seed=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pass_equals_its_numpy_twin(case):
    spec = CASES[case]
    poses = spec["poses"]()
    frames, nat, native, twin, missing = _lockstep(
        lambda: _engine(**spec["make"]), poses)
    assert frames == len(poses) and not any(twin)
    want = 0 if case == "occlusion" else 1
    assert native == [want] * frames
    if case == "stream":
        # the flight streamed, unloaded and meshed
        assert nat.world.unload_version > 0
        assert any(len(m) for m in missing)
    if case == "empty_pool":
        assert len(missing[0]) > 0
    if case == "small_cap":
        assert nat._last_n_visible == 16


def test_pass_on_an_empty_world():
    """No chunk loaded (the world held): an empty draw list from both
    paths, then the world streams in."""
    frames, nat, native, _, _ = _lockstep(
        lambda: _engine(prime=False), _pan(8), hold_world=3)
    assert native == [1] * frames


def test_sort_keys_match_numpy_at_fractional_cameras():
    lib = native_bridge._build_and_load()
    rng = np.random.default_rng(11)
    for n in (1, 2, 5, 64, 700):
        c = (rng.integers(-13, 13, (n, 3)) * 32 + 16).astype(np.float32)
        for cam in (rng.uniform(-200, 200, 3), np.array([32.0, 64.0, -96.0]),
                    np.array([0.5, 10.25, 19.999])):
            cam = cam.astype(np.float32)
            got = np.empty(n, np.float32)
            lib.funnel_sort_keys(c.ctypes.data, n, cam.ctypes.data,
                                 got.ctypes.data)
            d = c - cam[None, :]
            assert np.array_equal(got.view(np.int32),
                                  (d * d).sum(-1).view(np.int32))


def _frames_of(eng, views=False):
    out = []
    for k in range(40):
        pos = (4.0 * k, 24.0, 20.0 - 4.0 * k)
        yaw = 0.4 + 0.02 * k
        if views:
            if k % 10:
                continue
            r = eng.render_views([(pos, yaw, PITCH),
                                  (pos, yaw + math.pi, PITCH)], dt=0.016)
            out.append((r.color.clone(), r.depth.clone(), r.stats.clone(),
                        r.reduced.clone()))
        else:
            _set(eng, (pos, yaw, PITCH))
            r = eng.render_frame(dt=0.016)
            out.append((r.color.clone(), r.depth.clone(), r.stats.clone(),
                        r.rendered_meshes, r.visible_chunks))
    return out


@pytest.mark.parametrize("views", [False, True], ids=["frames", "views"])
def test_engine_frames_equal_from_either_path(views):
    """Two engines through the same 40-frame flight into fresh terrain
    (or two-view calls every tenth frame of it), one through the pass,
    one calling its twin: the frames, stats and counts equal, and
    ``funnel_native`` one a funnel on the first and none on the
    second."""
    cards = 4 if views else None
    got = {}
    for name in ("pass", "twin"):
        eng = _engine(vd=2, chunks_a_frame=4, start=(0.0, 24.0, 20.0),
                      render=SMALL, mesh_cards=cards)
        if name == "twin":
            eng._funnel_native = eng._funnel_numpy
        P.TRACER.reset()
        got[name] = _frames_of(eng, views)
        f = P.TRACER.frames(len(got[name]))
        funnels = f.calls[:, P.SPAN_NAMES.index("funnel")]
        assert (funnels == (2 if views else 1)).all()
        want = funnels if name == "pass" else 0 * funnels
        assert np.array_equal(f.count("funnel_native"), want)
        # the flight streamed chunks in (and, frame by frame, out)
        assert eng.world.version > 0
        assert views or eng.world.unload_version > 0
    for a, b in zip(got["pass"], got["twin"]):
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            else:
                assert x == y


def test_native_funnel_share_reader():
    """The benchmark's reader on the tracer: the native funnels over the
    funnel span's calls of the window's frames."""
    eng = _engine(vd=2, chunks_a_frame=4, render=SMALL)
    P.TRACER.reset()
    for pose in _pan(6):
        _set(eng, pose)
        eng.render_frame(dt=0.016)
    eng.enable_occlusion_culling = True
    for pose in _pan(2, yaw0=1.0):
        _set(eng, pose)
        eng.render_frame(dt=0.016)
    spans = Spans()
    spans.frames = 8
    ctx = dict(profile={"frames": 0}, spans=spans, peaks=None)
    assert native_funnel_share.read(ctx) == 6 / 8
    spans.frames = 2
    assert native_funnel_share.read(ctx) == 0.0
    # a program without the counter reads nothing
    fake = types.SimpleNamespace(COUNTER_NAMES=("chunks_meshed",))
    real = native_funnel_share.importlib.import_module
    try:
        native_funnel_share.importlib.import_module = lambda name: fake
        assert native_funnel_share.read(ctx) is None
    finally:
        native_funnel_share.importlib.import_module = real


def test_counter_is_a_noop_with_tracing_off():
    code = textwrap.dedent("""
        import numpy as np
        from differential_projection_voxel_renderer_tpu_torch.app import (
            engine as TE)
        from differential_projection_voxel_renderer_tpu_torch.utils import (
            profiling as P)
        assert P.FUNNEL_NATIVE is P.NOOP
        eng = TE.Engine(TE.RenderConfig(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
                        TE.WorldConfig(view_distance=2), pool_slots=128,
                        device="cpu")
        while eng.world.update(eng.camera.position):
            pass
        eng.prime_all()
        for k in range(3):
            eng.camera.yaw = 0.1 * k
            eng.render_frame()
        assert eng._last_n_visible > 0
        assert P.TRACER.n == 0 and sum(P.TRACER.counts) == 0
        print("off")
    """)
    env = dict(os.environ, DPVR_TRACE="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "off"
