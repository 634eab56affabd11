"""Frames in flight in the port, on the CPU: the step with a carried stage
A (``pre_geom``) and the next frame's stage A in the raster call
(``next_geom``, kernel K3, whose plain version runs here), the Renderer's
pipelined entry points, and ``Engine.render_frame_pipelined``.

References and tolerances:

- the port's pipelined step and engine against the port's serial ones:
  bit for bit (the same arithmetic in another schedule);
- the step against the JAX package's ``_render_step(..., pre_geom=,
  next_geom=)`` with its Pallas kernels in interpret mode: the frame passes
  the boundary gate of the JAX package's ``parity.py``; the next frame's
  valid, bbx, bby and sub-pixel count are exact; its ``depth_near`` equals
  the XLA form of stage A bit for bit and is within 6 ulps of the
  interpreted kernel's, whose XLA:CPU lowering contracts multiply-adds
  into FMAs (the 2-ulp bound of tests/test_render.py holds for its own
  camera only: seen from the moved camera here, 39 quads of the fuzz
  scene and 38 of the terrain scene differ by more than 2 ulps, at most
  4 and 5);
- each frame of the engine's pipelined mode against the JAX package's
  step on its Pallas path (interpret mode) over the same stream and camera:
  bit for bit; and against the JAX engine's pipelined frame (its jnp path
  on the CPU): stats and mesh counts exact, depth within 8 ulps where the
  colours agree, at most 4 pixels of another colour.  The jnp path's
  XLA:CPU program contracts the plane evaluations into FMAs, and on this
  camera path its frames differ from the Pallas path's by up to 6.5 ulps
  in depth (frames 3, 5, 6, 8 and 9) and in one pixel's colour (frame 3,
  a near-depth tie 5.5 ulps apart, beyond the 4 ulps that the gates of
  tests/test_torch_engine.py allow), in serial and pipelined mode alike.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import (
    pipeline as JPL,
)
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.meshing.greedy import (
    mesh_chunk,
)
from differential_projection_voxel_renderer_tpu_torch.models.camera import (
    Camera,
)
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.rendering import graphs
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    parity as TPAR,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

torch.set_num_threads(1)

# the next frame's camera in the step tests: the scene's camera moved
NEXT_SHIFT = np.array([3.0, -2.0, 5.0], np.float32)


@pytest.fixture(scope="module")
def scenes():
    return {name: S.scene(name) for name in S.SCENES}


def _next_stream(name, sc):
    """The scene's stream seen from a moved camera: the next frame."""
    stream, qw, total, _, cp, (w, h, _) = sc
    cam = Camera(cp + NEXT_SHIFT, w / h)
    cam.look_at(np.asarray(S.SCENES[name][4], np.float32))
    return (stream, qw, total,
            cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32), sc[5])


def _same(a, b):
    """Equal dtypes and equal bits."""
    assert a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_pipelined_step_matches_serial(scenes, name):
    """render_step with pre_geom/next_geom renders the serial frame and
    returns the next stream's stage A bit for bit."""
    sc = scenes[name]
    ta, tkw = S.torch_args(sc), S.torch_step_kw(sc, sc[5][2])
    na = S.torch_args(_next_stream(name, sc))
    gkw = dict(width=tkw["width"], height=tkw["height"])
    c1, d1, s1 = TPL.render_step(*ta, **tkw)
    pre = TPL._geom_stage(*ta, backface_culling=True, **gkw)
    c2, d2, s2, pre_next = TPL.render_step(*ta, pre_geom=pre, next_geom=na,
                                           **tkw)
    _same(c1, c2)
    _same(d1, d2)
    _same(s1, s2)
    ref = geometry.project_cull_plain(*na, **gkw)
    for k, got in zip(("valid", "bbx", "bby", "depth_near"), pre_next):
        _same(ref[k], got)
    assert int(ref["subpixel"].sum()) == int(pre_next[4])
    assert int(pre_next[0].sum()) > 100
    # the carried stage A covers the whole bucket; the step masks it with
    # its own stream length
    short = (ta[0], ta[1], ta[2] // 2, ta[3], ta[4])
    c3, d3, s3 = TPL.render_step(*short, **tkw)
    c4, d4, s4, _ = TPL.render_step(*short, pre_geom=pre, next_geom=na,
                                    **tkw)
    _same(c3, c4)
    _same(d3, d4)
    _same(s3[:2], s4[:2])


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_pipelined_step_matches_jax(scenes, name):
    sc = scenes[name]
    nxt = _next_stream(name, sc)
    ja, jkw = S.jax_args(sc), S.jax_step_kw(sc, sc[5][2])
    jn = S.jax_args(nxt)
    gkw = dict(width=jkw["width"], height=jkw["height"],
               backface_culling=True)
    jpre = JPL._geom_stage(*ja, use_pallas=True, interpret=True, **gkw)
    c1, d1, s1, jnext = JPL._render_step(*ja, pre_geom=jpre, next_geom=jn,
                                         **jkw)
    ta, tkw = S.torch_args(sc), S.torch_step_kw(sc, sc[5][2])
    tpre = TPL._geom_stage(*ta, **gkw)
    c2, d2, s2, tnext = TPL.render_step(*ta, pre_geom=tpre,
                                        next_geom=S.torch_args(nxt), **tkw)
    records = TPL.render_step(*ta, debug_return_records=True, **tkw)[0]
    parity.assert_kernel_parity_boundary(
        np.asarray(c1).view(np.uint32), np.asarray(d1),
        c2.numpy().view(np.uint32), d2.numpy(), records.numpy())
    np.testing.assert_array_equal(np.asarray(s1), s2.numpy())
    for i in (0, 1, 2, 4):  # valid, bbx, bby, subpixel count
        np.testing.assert_array_equal(np.asarray(jnext[i]), tnext[i].numpy())
    # depth_near: bit for bit against the XLA form of stage A, within 6
    # ulps of the interpreted kernel (the module docstring gives the reason
    # and the measurement)
    got = tnext[3].numpy()
    xla = JPL._geom_stage(*jn, use_pallas=False, interpret=True, **gkw)
    np.testing.assert_array_equal(np.asarray(xla[3]).view(np.int32),
                                  got.view(np.int32))
    ref = np.asarray(jnext[3])
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ref[~fin], got[~fin])
    ulps = np.abs(got[fin] - ref[fin]) / np.spacing(np.abs(ref[fin]))
    assert ulps.max() <= 6


# ------------------------------------------------------------- the engine


def _small_engine(E, render_config_cls, world_config_cls, **kw):
    """tests/test_engine.py's small engine, the item cap at its default
    (the port's binned path must drop no tile; the jnp path never bins)."""
    eng = E.Engine(
        render_config=render_config_cls(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=64),
        pool_slots=512, **kw)
    eng.camera.position = np.array([0.0, 40.0, 60.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, 0.0]))
    eng.world.generate_region((-3, -1, -3), (3, 1, 3))
    eng.prime()
    return eng


def _port_engine():
    return _small_engine(TE, TE.RenderConfig, TE.WorldConfig, device="cpu")


def _path(eng, n=10):
    """tests/test_engine.py's pipelined camera path."""
    for i in range(n):
        eng.camera.position = (eng.camera.position
                               + np.array([2.0, 0.0, -1.0], np.float32))
        eng.camera.yaw += 0.02
        yield i


def _frame(res, port):
    return (res.color_numpy().copy(), res.depth_numpy().copy(),
            res.stats.numpy().copy() if port else np.asarray(res.stats),
            res.rendered_meshes, res.visible_chunks)


def _run_pipelined(eng, port):
    out = []
    for _ in _path(eng):
        res = eng.render_frame_pipelined(dt=0.0)
        if res is not None:
            out.append(_frame(res, port))
    out.append(_frame(eng.flush_pipeline(), port))
    assert eng.flush_pipeline() is None
    return out


def _pallas_frame(eng):
    """The JAX package's step on its Pallas path (interpret mode) over the
    port engine's stream and camera for the frame just rendered."""
    r = eng.renderer
    up = r.prepare_uploads(eng.pool.quads, eng._last_visible_slots,
                           eng._last_counts_sel, eng._last_positions_sel,
                           dir_mask=eng._last_dir_mask)
    cap = int(up[0].shape[0])
    kw = r._bucket_kw(cap)
    c, d, st = JPL._render_step(
        jnp.asarray(up[0].numpy().view(np.uint32)), jnp.asarray(up[1].numpy()),
        jnp.asarray(int(up[2]), jnp.int32),
        jnp.asarray(eng.camera.view_projection_matrix()),
        jnp.asarray(eng.camera.position), color_tables=S.TABLES, width=256,
        height=128, tile_h=16, tile_w=128, gather_cap=cap,
        render_cap=kw["render_cap"], span_mode=False, backface_culling=True,
        use_pallas=True, interpret=True, tile_k_cap=kw["tile_k_cap"])
    return np.asarray(c).view(np.uint32), np.asarray(d), np.asarray(st)


@pytest.fixture(scope="module")
def engine_runs():
    """(serial port frames with their raster inputs and the JAX Pallas
    step's frames on their streams, pipelined port frames, pipelined JAX
    engine frames, the port's raster calls: True where K3's plain version
    ran)."""
    serial = []
    eng = _port_engine()
    for _ in _path(eng):
        serial.append((_frame(eng.render_frame(dt=0.0), True),
                       S.engine_records(eng), _pallas_frame(eng)))
    eng = _port_engine()
    calls = []
    plain = TPL.raster_ops.rasterize_tiles

    def spy(*a, **kw):
        calls.append(kw.get("next_geom") is not None)
        return plain(*a, **kw)

    TPL.raster_ops.rasterize_tiles = spy
    try:
        piped = _run_pipelined(eng, True)
    finally:
        TPL.raster_ops.rasterize_tiles = plain
    jaxed = _run_pipelined(
        _small_engine(JE, JCFG.RenderConfig, JW.WorldConfig), False)
    return serial, piped, jaxed, calls


def test_engine_pipelined_emits_every_frame_once_in_order(engine_runs):
    serial, piped, jaxed, calls = engine_runs
    assert len(piped) == len(jaxed) == len(serial) == 10
    # every steady step fused the next frame's stage A into its raster
    # call; the flush rendered serially
    assert calls == [True] * 9 + [False]


@pytest.mark.parametrize("frame", range(10))
def test_engine_pipelined_matches_serial(engine_runs, frame):
    (want, _, _), got = engine_runs[0][frame], engine_runs[1][frame]
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert want[3:] == got[3:]


@pytest.mark.parametrize("frame", range(10))
def test_engine_pipelined_matches_jax(engine_runs, frame):
    """Bit for bit against the JAX Pallas step on the frame's stream; and
    against the JAX engine's pipelined frame (jnp path), stats and mesh
    counts exact, depth within 8 ulps where the colours agree, at most 4
    pixels of another colour."""
    (_, _, pallas), got, ref = (engine_runs[0][frame], engine_runs[1][frame],
                                engine_runs[2][frame])
    for a, b in zip(pallas, got[:3]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    (c1, d1), (c2, d2) = ref[:2], got[:2]
    np.testing.assert_array_equal(np.isfinite(d1), np.isfinite(d2))
    same = np.isfinite(d1) & (c1 == c2)
    ulp8 = 8 * np.spacing(np.maximum(np.abs(d1), np.float32(1.0)))
    assert (np.abs(d1[same] - d2[same]) <= ulp8[same]).all()
    assert (c1 != c2).sum() <= 4
    np.testing.assert_array_equal(ref[2], got[2])
    assert ref[3:] == got[3:]
    assert (c2 != np.uint32(0xFF87CEEB)).sum() > 1000


def test_render_frame_rejects_nonempty_pipeline():
    eng = _port_engine()
    assert eng.render_frame_pipelined(dt=0.0) is None
    with pytest.raises(RuntimeError):
        eng.render_frame(dt=0.0)
    assert eng.flush_pipeline() is not None
    assert eng.flush_pipeline() is None
    eng.render_frame(dt=0.0)  # empty pipeline: serial works again


# ------------------------------------------------------------ the Renderer


@pytest.fixture(scope="module")
def fuzz_renderer():
    """A Renderer with three capacity buckets (16384, 32768, 65536), the
    fuzz chunk in pool slot 0, and draw lists of n copies of it."""
    renderer = TPL.Renderer(TE.RenderConfig(width=128, height=128,
                                            gather_cap=65536,
                                            quads_cap=8192), device="cpu")
    quads = mesh_chunk(TPAR.fuzz_chunk())
    pool = np.zeros((4, 4096), np.uint32)
    pool[0, :len(quads)] = quads
    pool_t = torch.from_numpy(pool.view(np.int32))
    vcap = renderer.config.visible_chunks_cap
    cam = Camera(np.array([16.0, 48.0, 16.0], np.float32), 1.0)
    cam.look_at(np.array([16.0, 8.0, 16.0], np.float32))

    def draw_list(n):
        counts = np.zeros((vcap, 6), np.int32)
        positions = np.zeros((vcap, 3), np.int32)
        counts[:n, 0] = len(quads)
        positions[:n] = [(i % 3 - 1, 0, i // 3 - 1) for i in range(n)]
        return np.zeros(vcap, np.int32), counts, positions

    small, big = 1, 16384 // len(quads) + 1
    return renderer, pool_t, draw_list, (small, big), cam


def test_bucket_switch_drains_in_order(fuzz_renderer):
    """render_prepared_pipelined across a capacity-bucket switch: the
    carried frame drains through the serial path; every frame comes out
    once, in order, equal to the serial render (after
    tests/test_render.py's test of the JAX Renderer)."""
    renderer, pool, draw_list, sizes, cam = fuzz_renderer
    vp, cp = cam.view_projection_matrix(), cam.position
    ups = [renderer.prepare_uploads(pool, *draw_list(n)) for n in sizes]
    assert ups[0][0].shape[0] == 16384 and ups[1][0].shape[0] == 32768
    serial = [renderer.render_prepared(up, vp, cp) for up in ups]
    assert renderer.render_prepared_pipelined(ups[0], vp, cp) is None
    out = [renderer.render_prepared_pipelined(ups[1], vp, cp),
           renderer.pipeline_flush()]
    assert renderer.pipeline_flush() is None
    for want, got in zip(serial, out):
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    assert int(serial[1][2][1]) > int(serial[0][2][1]) > 0


def test_serial_fallback_keeps_order(fuzz_renderer, monkeypatch):
    """Draw lists past the largest bucket (truncated) and legacy [vcap]
    totals stay in flight in render_fused_pipelined: the second list of a
    bucket rides the first one's step (``_pipe_fused``), a bucket switch
    drains the carried frame, and every frame comes out once, in order,
    equal to render_fused's bit for bit."""
    renderer, pool, draw_list, sizes, cam = fuzz_renderer
    vp, cp = cam.view_projection_matrix(), cam.position
    per = int(draw_list(1)[1][0, 0])
    n_trunc = renderer.gather_buckets[-1] // per + 1

    def legacy(n):
        slots, counts, positions = draw_list(n)
        return slots, counts.sum(axis=1), positions

    lists = [draw_list(n_trunc), draw_list(n_trunc + 1), legacy(sizes[1]),
             legacy(sizes[1] + 1)]
    serial = [renderer.render_fused(pool, *dl, vp, cp) for dl in lists]
    assert int(serial[1][2][0]) == renderer.gather_buckets[-1]
    riders = []
    real = TPL._pipe_fused
    monkeypatch.setattr(TPL, "_pipe_fused",
                        lambda *a, **k: riders.append(1) or real(*a, **k))
    out = []
    for i, dl in enumerate(lists):
        got, uploads = renderer.render_fused_pipelined(pool, *dl, vp, cp)
        assert (got is None) == (i == 0)
        assert int(uploads[0].shape[0]) == (
            renderer.gather_buckets[-1] if i < 2 else 32768)
        out += [got] if got is not None else []
    out.append(renderer.pipeline_flush())
    assert renderer.pipeline_flush() is None
    assert len(riders) == 2 and len(out) == len(serial)
    for want, got in zip(serial, out):
        for a, b in zip(want, got):
            assert torch.equal(a, b)


PIPE_GRAPHS = ("pipe_seed", "pipe_seed_fused", "pipe_prepared", "pipe_fused")


@pytest.mark.parametrize("moving", [False, True])
def test_pipelined_graphs_equal_their_eager_functions(fuzz_renderer, moving):
    """Every frames-in-flight step through ``Renderer._run_graph`` against
    its function called eagerly on the same inputs (``graphs.EagerTwin``),
    bit for bit: a draw-list change (fused; its seed, then its step),
    steady prepared frames, a bucket switch of each kind (the drain
    replays the static step "prepared", then the seed) and the flush.
    Every emitted frame equals render_fused's for its list and camera,
    one call later, the streams the calls return included.  ``moving``
    turns the camera every call, so each carried frame renders from its
    own camera."""
    renderer, pool, draw_list, sizes, cam = fuzz_renderer
    small, big = sizes

    def camera(i):
        c = Camera(np.array([16.0 + (2.0 * i if moving else 0.0), 48.0,
                             16.0], np.float32), 1.0)
        c.look_at(np.array([16.0, 8.0, 16.0], np.float32))
        return c.view_projection_matrix(), c.position

    # (call, draw list): fused A, A prepared twice, fused B (another
    # bucket: drain), fused B' (its step), B' prepared, A prepared (drain)
    plan = [("fused", small), ("prepared", small), ("prepared", small),
            ("fused", big), ("fused", big + 1), ("prepared", big + 1),
            ("prepared", small)]
    serial = [renderer.render_fused(pool, *draw_list(n), *camera(i))
              for i, (_, n) in enumerate(plan)]
    twin = graphs.EagerTwin(renderer)
    try:
        out, streams = [], {}
        for i, (kind, n) in enumerate(plan):
            if kind == "fused":
                got, streams[n] = renderer.render_fused_pipelined(
                    pool, *draw_list(n), *camera(i))
            else:
                got = renderer.render_prepared_pipelined(streams[n],
                                                         *camera(i))
            assert (got is None) == (i == 0)
            out += [got] if got is not None else []
        out.append(renderer.pipeline_flush())
        assert renderer.pipeline_flush() is None
    finally:
        twin.close()
    names = [c[0] for c in twin.calls]
    assert names == ["pipe_seed_fused", "pipe_prepared", "pipe_prepared",
                     "prepared", "pipe_seed_fused", "pipe_fused",
                     "pipe_prepared", "prepared", "pipe_seed", "prepared"]
    assert {c[1] for c in twin.calls} == {16384, 32768}
    assert all(equal for *_, equal in twin.calls), twin.calls
    assert len(out) == len(serial)
    for want, got in zip(serial, out):
        for a, b in zip(want, got):
            _same(a, b)


@pytest.mark.parametrize("make", ["Engine", "Renderer", "QuadPool"])
def test_entry_points_default_to_the_card(make, monkeypatch):
    """Without ``device`` an entry point runs on CUDA, and raises when
    there is none: nothing falls back to the CPU."""
    cls = {"Engine": TE.Engine, "Renderer": TPL.Renderer,
           "QuadPool": TE.QuadPool}[make]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls() if make != "QuadPool" else cls(slots=8, qcap=16)
    assert cls(device="cpu") if make != "QuadPool" else cls(
        slots=8, qcap=16, device="cpu")
