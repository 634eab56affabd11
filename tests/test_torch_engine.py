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
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models.world import WorldConfig
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.utils.config import RenderConfig
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

# one intra-op thread, as in tests/_torch_scenes.py: the twins' many small
# ops stall on an oversubscribed pool when several test workers share a host
torch.set_num_threads(1)

# camera path: (position, look-at target); frames 0-1 hold the primed pose
POSE0 = ((0.0, 40.0, 60.0), (0.0, 0.0, 0.0))
PATH = [POSE0, POSE0] + [((x, 40.0, 60.0 - x), (x, 0.0, -x))
                         for x in (24.0, 48.0, 72.0, 96.0, 120.0)]


def _configs():
    return dict(
        render_config=RenderConfig(width=256, height=128, gather_cap=16384,
                                   quads_cap=8192),
        world_config=WorldConfig(view_distance=3, frustum_culling=True,
                                 max_chunks_per_frame=4),
        pool_slots=512)


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


def _records(eng):
    """The port's raster input for the frame just rendered (the draw list
    re-expanded from the pool, which already holds the frame's inserts)."""
    r = eng.renderer
    up = r.prepare_uploads(eng.pool.quads, eng._last_visible_slots,
                           eng._last_counts_sel, eng._last_positions_sel,
                           dir_mask=eng._last_dir_mask)
    cam = r._cam_dev(eng.camera.view_projection_matrix(),
                     eng.camera.position)
    return TPL._step_camf(*up, cam, debug_return_records=True,
                          **r._bucket_kw(int(up[0].shape[0])))[0].numpy()


@pytest.fixture(scope="module")
def runs():
    jeng = JE.Engine(**_configs())
    teng = TE.Engine(**_configs(), device="cpu")
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
        out.append(_records(teng))
        frames.append(out)
    return jeng, teng, frames, spy.calls


def _texel_flip(records, yy, xx, depth):
    """A record covers pixel (yy, xx) at ``depth`` with 8u or 8v within 8
    f32 ulps of an integer (float64 evaluation of the f32 records)."""
    f = records[:16].view(np.float32).astype(np.float64)
    h, w = 128, 256
    nx = (2.0 * (xx + 0.5) - w) / w
    ny = 1.0 - 2.0 * (yy + 0.5) / h
    qu = f[0] * nx + f[1] * ny + f[2]
    qv = f[3] * nx + f[4] * ny + f[5]
    qw = f[6] * nx + f[7] * ny + f[8]
    z = f[9] * nx + f[10] * ny + f[11]
    with np.errstate(divide="ignore", invalid="ignore"):
        at = ((qw > 0) & (qu >= f[12] * qw) & (qu <= f[13] * qw)
              & (qv >= f[14] * qw) & (qv <= f[15] * qw)
              & (np.abs(z - depth) <= 4 * np.spacing(np.float32(1.0))))
        edge = np.zeros_like(at)
        for s in (8.0 * qu / qw, 8.0 * qv / qw):
            ulp = np.spacing(np.abs(s).astype(np.float32)).astype(np.float64)
            edge |= np.abs(s - np.round(s)) <= 8 * ulp
    return bool((at & edge).any())


@pytest.mark.parametrize("frame", range(len(PATH)))
def test_engine_frame_matches_jax(runs, frame):
    ref, got, records = runs[2][frame]
    (c1, d1), (c2, d2) = ref[:2], got[:2]
    np.testing.assert_array_equal(np.isfinite(d1), np.isfinite(d2))
    fin = np.isfinite(d1)
    ulp4 = 4 * np.spacing(np.maximum(np.abs(d1), np.float32(1.0)))
    assert (np.abs(d1[fin] - d2[fin]) <= ulp4[fin]).all()
    c2 = c2.copy()
    flips = np.argwhere((c1 != c2) & (d1 == d2))
    for yy, xx in flips:
        assert _texel_flip(records, yy, xx, d1[yy, xx]), (yy, xx)
        c2[yy, xx] = c1[yy, xx]
    assert len(flips) <= 4
    # same colour and depth within 4 ulps is the gate's own per-pixel
    # rule, applied here before its mismatch-count cap
    parity.assert_kernel_parity_boundary(
        c1, d1, c2, np.where(c1 == c2, d1, d2), records)
    np.testing.assert_array_equal(ref[2], got[2])
    assert ref[3:] == got[3:]
    assert (got[0] != np.uint32(0xFF87CEEB)).sum() > 1000


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
                                  np.asarray(jp.counts6_dev), jp.positions,
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


@pytest.mark.parametrize("flag", ["span_mode", "packed_raster",
                                  "two_pass_near_quads", "temporal_hiz"])
def test_unported_render_modes_raise(flag):
    cfg = RenderConfig(width=256, height=128)
    setattr(cfg, flag, 1 if flag == "two_pass_near_quads" else True)
    with pytest.raises(NotImplementedError):
        TPL.Renderer(cfg, device="cpu")


def test_port_imports_without_jax():
    """The port and every submodule import with jax blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith("jax."):
                    raise ImportError("jax is blocked")

        sys.meta_path.insert(0, Block())
        import differential_projection_voxel_renderer_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in sys.modules
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10


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
