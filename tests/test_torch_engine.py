"""The port's Engine on the CPU against the JAX package's Engine, and the
port's import boundary.

Both engines run the configuration of tests/test_engine.py (256x128,
view distance 3, gather cap 16384, 512 pool slots) through the same camera
path: prime, a draw-list-changed frame, a static frame, then moving frames
that stream new chunks, so that the port takes all three device entry
points (render_fused, render_prepared, render_fused_insert).  On the CPU
the JAX Engine takes its jnp path, whose frame equals its Pallas kernels'
(tests/test_render.py), and the port takes its kernels' plain twins.
Stats and mesh counts must be equal.  Frames are held to the
boundary-verified gate, because XLA:CPU contracts the jnp path's plane
evaluations into FMAs (README "One caveat"): depth may differ by at most 4
ulps where both frames show the same colour (measured: 1 ulp on about a
third of the covered pixels, against a port that equals the JAX Pallas
path bit for bit in tests/test_torch_pipeline.py), and every colour
mismatch must be proven a coverage-edge or near-depth-tie flip, or a
texel-edge flip: a record covering the pixel at its depth whose texel
coordinate 8u or 8v lies within 8 f32 ulps of an integer, where the
truncation to a texel goes either way (measured: one pixel, 8u =
70.9999961).  The item cap is raised from tests/test_engine.py's 2048 to
the default so that the port's binned path drops no tile (the jnp path
never bins), and chunks stream 4 per frame so that the remesh batches fit
the fused insert.

The resident superset stream flies tests/test_engine.py
test_resident_frames_bit_identical_primed's path (4 moving frames, one
chunk-cell crossing after the first build): the port's resident frames
equal its serial frames bit for bit, and its resident streams, their
bookkeeping and the stats equal the JAX resident engine's, the frames
under the gates above with the jnp path's depth tolerance
(tests/_torch_scenes.py ``JNP_DEPTH_ULPS``).
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

# one intra-op thread, as in tests/_torch_scenes.py: the twins' many small
# ops stall on an oversubscribed pool when several test workers share a host
torch.set_num_threads(1)

REF = "differential_projection_voxel_renderer_tpu"

# camera path: (position, look-at target); frames 0-1 hold the primed pose
POSE0 = ((0.0, 40.0, 60.0), (0.0, 0.0, 0.0))
PATH = [POSE0, POSE0] + [((x, 40.0, 60.0 - x), (x, 0.0, -x))
                         for x in (24.0, 48.0, 72.0, 96.0, 120.0)]


def _configs(render_config_cls, world_config_cls):
    """The engine configuration, built from the given package's classes."""
    return dict(
        render_config=render_config_cls(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=4),
        pool_slots=512)


def _jax_configs():
    return _configs(JCFG.RenderConfig, JW.WorldConfig)


def _port_configs():
    return _configs(TE.RenderConfig, TE.WorldConfig)


def _pose(eng, pose):
    eng.camera.position = np.array(pose[0], np.float32)
    eng.camera.look_at(np.array(pose[1], np.float32))


class _Spy:
    """Counts the port renderer's entry points."""

    def __init__(self, renderer):
        self.calls = {}
        for name in ("render_fused", "render_prepared",
                     "render_fused_insert"):
            fn = getattr(renderer, name)
            setattr(renderer, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if out is not None:
                self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return call


@pytest.fixture(scope="module")
def runs():
    jeng = JE.Engine(**_jax_configs())
    teng = TE.Engine(**_port_configs(), device="cpu")
    spy = _Spy(teng.renderer)
    for eng in (jeng, teng):
        _pose(eng, POSE0)
        while eng.world.update(eng.camera.position):
            pass
        eng.prime()
    frames = []
    for pose in PATH:
        out = []
        for eng in (jeng, teng):
            _pose(eng, pose)
            res = eng.render_frame(dt=0.0)
            out.append((res.color_numpy(), res.depth_numpy(),
                        np.asarray(res.stats) if eng is jeng
                        else res.stats.numpy(),
                        res.rendered_meshes, res.visible_chunks))
        out.append(S.engine_records(teng))
        frames.append(out)
    return jeng, teng, frames, spy.calls


@pytest.mark.parametrize("frame", range(len(PATH)))
def test_engine_frame_matches_jax(runs, frame):
    ref, got, records = runs[2][frame]
    S.assert_engine_frame_gates(ref, got, records)


def test_engine_took_every_entry_point(runs):
    jeng, teng, _, calls = runs
    assert calls.get("render_fused_insert", 0) >= 2, calls
    assert calls.get("render_prepared", 0) >= 1, calls
    assert calls.get("render_fused", 0) >= 1, calls
    assert teng.pool.by_pos == jeng.pool.by_pos
    np.testing.assert_array_equal(teng.pool.counts6, jeng.pool.counts6)


def test_pool_round_trip_from_numpy(runs):
    """The JAX pool's state, carried into QuadPool.from_numpy, holds the
    same rows and host tables and renders the port engine's last frame."""
    jeng, teng, frames, _ = runs
    jp = jeng.pool
    pool = TE.QuadPool.from_numpy(np.asarray(jp.quads),
                                  jp.counts6, jp.positions,
                                  jp.by_pos, device="cpu")
    np.testing.assert_array_equal(pool.quads.numpy().view(np.uint32),
                                  np.asarray(jp.quads))
    used = np.nonzero(jp._used)[0]
    np.testing.assert_array_equal(pool.counts[used], jp.counts[used])
    np.testing.assert_array_equal(pool.counts6[used], jp.counts6[used])
    assert pool.by_pos == jp.by_pos
    probe = np.concatenate([jp.positions[used[:20]], [[99, 99, 99]]])
    for r, g in zip(jp.lookup_slots(probe), pool.lookup_slots(probe)):
        np.testing.assert_array_equal(r, g)
    uploads = teng.renderer.prepare_uploads(
        pool.quads, jeng._last_visible_slots, jeng._last_counts_sel,
        jeng._last_positions_sel, dir_mask=jeng._last_dir_mask)
    color, depth, stats = teng.renderer.render_prepared(
        uploads, jeng.camera.view_projection_matrix(), jeng.camera.position)
    got = frames[-1][1]
    np.testing.assert_array_equal(color.numpy().view(np.uint32), got[0])
    np.testing.assert_array_equal(depth.numpy(), got[1])
    np.testing.assert_array_equal(stats.numpy(), got[2])


def test_truncated_streaming_frame_takes_the_fused_insert(monkeypatch):
    """A streaming frame whose draw list is past the largest gather bucket
    (truncated, gather cap 2048) takes the fused insert from its graph,
    with no standalone scatter, and gives the frame and pool of the
    standalone scatter followed by the expanded stream's step
    (``apply_insert_payload``, ``prepare_uploads``, ``render_prepared``)
    bit for bit."""
    eng = TE.Engine(TE.RenderConfig(width=128, height=64, gather_cap=2048,
                                    quads_cap=2048),
                    TE.WorldConfig(view_distance=3, frustum_culling=True,
                                   max_chunks_per_frame=4),
                    pool_slots=256, device="cpu")
    r, pool = eng.renderer, eng.pool
    assert r.gather_buckets == (2048,)
    _pose(eng, ((0.0, 10.0, 20.0), (0.0, 0.0, -60.0)))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    eng.render_frame(dt=0.0)
    events = []

    def spy(obj, name, fn=None):
        real = getattr(obj, name)

        def call(*a, **k):
            events.append((name, fn(*a) if fn else a[0]))
            return real(*a, **k)
        monkeypatch.setattr(obj, name, call)

    spy(r, "_run_graph")
    spy(pool, "dispatch_insert_payload")
    spy(r, "render_fused_insert", lambda quads, *a: (quads.clone(), a))
    checked = 0
    for x in (16.0, 24.0):
        _pose(eng, ((x, 10.0, 20.0 - x), (x, 0.0, -60.0 - x)))
        events.clear()
        res = eng.render_frame(dt=0.0)
        dl = (eng._last_visible_slots, eng._last_counts_sel,
              eng._last_positions_sel)
        if [e[0] for e in events[:1]] != ["render_fused_insert"]:
            continue
        assert int((dl[1] * eng._last_dir_mask).sum()) > 2048
        # one graph call and no standalone scatter
        assert [e[0] for e in events[1:]] == ["_run_graph"], events
        assert events[1][1] == "insert"
        monkeypatch.undo()
        before, (*_, vp, cp, payload) = events[0][1]
        TPL.apply_insert_payload(before,
                                 torch.from_numpy(payload.view(np.int32)),
                                 k=r.INSERT_KP, mc=r.INSERT_MC)
        assert torch.equal(before, pool.quads)
        want = r.render_prepared(r.prepare_uploads(
            before, *dl, dir_mask=eng._last_dir_mask), vp, cp)
        for a, b in zip(want, (res.color, res.depth, res.stats)):
            assert torch.equal(a, b)
        checked += 1
        spy(r, "_run_graph")
        spy(pool, "dispatch_insert_payload")
        spy(r, "render_fused_insert", lambda quads, *a: (quads.clone(), a))
    assert checked


@pytest.mark.parametrize("flag", ["span_mode", "packed_raster",
                                  "two_pass_near_quads", "temporal_hiz"])
def test_unported_render_modes_raise(flag):
    """Every render mode is ported: its Renderer builds with the mode in
    its step keywords, and only the combinations that the JAX Renderer
    refuses (packed or temporal with two-pass) raise its ValueError; span
    mode with two-pass builds, as the JAX Renderer does."""
    cfg = TE.RenderConfig(width=256, height=128)
    setattr(cfg, flag, 1 if flag == "two_pass_near_quads" else True)
    r = TPL.Renderer(cfg, device="cpu")
    assert r._base_step_kw["span_mode"] == (flag == "span_mode")
    assert r._base_step_kw["packed_raster"] == (flag == "packed_raster")
    assert r._base_step_kw["near_quads"] == cfg.two_pass_near_quads
    if flag == "two_pass_near_quads":
        return
    cfg.two_pass_near_quads = 1
    if flag == "span_mode":
        assert TPL.Renderer(cfg, device="cpu")._base_step_kw["near_quads"]
        return
    with pytest.raises(ValueError, match="mutually exclusive"):
        TPL.Renderer(cfg, device="cpu")


N_PRIMED = 4   # moving frames of the primed resident flight


@pytest.fixture(scope="module")
def primed_resident():
    """tests/test_engine.py test_resident_frames_bit_identical_primed's
    flight (tests/test_engine.py _small_engine with the default item cap,
    prime_all over a region that holds every chunk the flight reaches),
    moving and turning across a chunk-cell boundary, on a port resident,
    a port serial and a JAX resident engine: {name: (engine, [(frame,
    resident state, port raster records)])}."""
    out = {}
    for name, resident in (("port", True), ("serial", False),
                           ("jax", True)):
        port = name != "jax"
        rc, wc = ((TE.RenderConfig, TE.WorldConfig) if port
                  else (JCFG.RenderConfig, JW.WorldConfig))
        kw = dict(render_config=rc(width=256, height=128, gather_cap=16384,
                                   quads_cap=8192),
                  world_config=wc(view_distance=3, frustum_culling=True,
                                  max_chunks_per_frame=64),
                  pool_slots=512, resident_stream=resident)
        eng = TE.Engine(**kw, device="cpu") if port else JE.Engine(**kw)
        _pose(eng, POSE0)
        eng.world.generate_region((-5, -1, -5), (5, 1, 5))
        eng.prime_all()
        base = eng.camera.position.copy()
        frames = []
        for i in range(1, N_PRIMED + 1):
            eng.camera.position = base + np.array([8.0 * i, 0.0, -8.0 * i],
                                                  np.float32)
            eng.camera.yaw += 0.04
            res = S.frame_tuple(eng.render_frame(dt=0.0))
            frames.append((res, S.resident_state(eng) if resident else None,
                           S.resident_records(eng) if name == "port"
                           else None))
        out[name] = (eng, frames)
    return out


def test_resident_engine_renders_the_serial_frames(primed_resident):
    """The resident superset stream builds and renders on the CPU: every
    primed resident frame equals the serial engine's bit for bit (colour
    and depth; the stats count the superset stream, so the resident engine
    gathers and rasterizes at least as many quads), neither overflows, the
    mode never falls back, and the flight crosses a chunk cell after the
    first build (tests/test_torch_resident.py holds the mode to the JAX
    package's)."""
    eng, frames = primed_resident["port"]
    serial = [f[0] for f in primed_resident["serial"][1]]
    frames = [f[0] for f in frames]
    cells = [f[1]["cell"] for f in primed_resident["port"][1]]
    assert eng.resident_stream and eng.config.gather_cap == 2 * 16384
    assert len(set(cells)) >= 2, cells
    for i, (t, s) in enumerate(zip(frames, serial)):
        np.testing.assert_array_equal(t[0], s[0], err_msg=f"frame {i}")
        np.testing.assert_array_equal(t[1], s[1], err_msg=f"frame {i}")
        assert t[2][2] == t[2][3] == s[2][2] == s[2][3] == 0
        assert t[2][1] >= s[2][1] and t[2][0] >= s[2][0]
        assert (t[0] != np.uint32(JCFG.SKY_COLOR)).sum() > 1000


@pytest.mark.parametrize("frame", range(N_PRIMED))
def test_primed_resident_frame_matches_jax(primed_resident, frame):
    """The same flight on the JAX package's resident engine: the resident
    stream bit for bit, its total, cell, chunk count and queued batch
    exact, the stats exact, the frame under the gates of this file (with
    the JAX jnp path's depth tolerance, as tests/test_torch_app.py)."""
    jeng, jf = primed_resident["jax"]
    assert jeng.resident_stream
    ref, got = jf[frame], primed_resident["port"][1][frame]
    S.assert_same_resident_state(ref[1], got[1])
    S.assert_engine_frame_gates(ref[0], got[0], got[2],
                                depth_ulps=S.JNP_DEPTH_ULPS)


def test_device_meshing_still_raises(monkeypatch):
    """Device meshing is ported (tests/test_torch_meshing_device.py holds
    it to the JAX mesher): the engine builds, and a remesh batch of 4
    chunks or more goes through ``_remesh_device``, a smaller one through
    the host mesher, as the reference's ``_mesh_list`` chooses."""
    eng = TE.Engine(TE.RenderConfig(width=128, height=128),
                    TE.WorldConfig(view_distance=1), pool_slots=64,
                    device_meshing=True, device="cpu")
    assert eng.device_meshing
    while eng.world.update(eng.camera.position):
        pass
    calls = []
    real = eng._remesh_device
    monkeypatch.setattr(eng, "_remesh_device",
                        lambda to_mesh: calls.append(len(to_mesh))
                        or real(to_mesh))
    keys = sorted(eng.world.chunks)
    assert eng._mesh_list(keys[:3]) == 3 and calls == []
    rest = len(keys) - 3
    assert rest >= 4
    assert eng._mesh_list(keys[3:]) == rest and calls == [rest]
    assert all(k in eng.pool for k in keys)


@pytest.mark.parametrize("blocked", ["jax", REF])
def test_port_imports_without_jax(blocked):
    """Every module of the port imports with ``blocked`` (jax, or the JAX
    package) unimportable, and meshing a chunk through the port loads the
    port's own native mesher, built under ``build/native/``, not the JAX
    package's."""
    code = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys

        BLOCKED = {blocked!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == BLOCKED or name.startswith(BLOCKED + "."):
                    raise ImportError(BLOCKED + " is blocked")

        sys.meta_path.insert(0, Block())
        import differential_projection_voxel_renderer_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from differential_projection_voxel_renderer_tpu_torch.meshing import (
            greedy, native_bridge)
        from differential_projection_voxel_renderer_tpu_torch.models import (
            chunk)
        mesh = greedy.mesh_chunk(chunk.Chunk.generate_terrain((0, 0, 0)))
        assert mesh is not None
        lib = native_bridge._build_and_load()
        build = os.path.join(os.getcwd(), "build", "native")
        assert lib is not None and os.path.dirname(lib._name) == build
        assert "jax" not in sys.modules
        assert not [m for m in sys.modules
                    if m == {REF!r} or m.startswith({REF!r} + ".")]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of the repo but the port, and no jax."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    port = "differential_projection_voxel_renderer_tpu_torch"
    assert any(n.startswith(port) for n in names)
    for n in names:
        top = n.split(".")[0]
        assert top == port or top in sys.stdlib_module_names | {
            "torch", "numpy"}, n
