"""Several views a call over a mesh (``Engine.render_views``) on the CPU,
on a mesh that lists the CPU four times (dp = 2 views, tp = 2 row bands
a view), at 256x128 and view distance 3:

- each view's stacked bands against ``render_frame`` at its pose, bit for
  bit, with its stream length, on a static pair of views and a pair that
  moves across a chunk boundary (new chunks stream in and mesh);
- each view against the benchmark's plain reference (``benchmark/
  reference``: its frame, stream length and ``psum // tp`` of its bands,
  ``reference/bands.py``), at the reference's boxes (``projection.
  STRADDLE_MARGIN = inf``: a quad that straddles the near plane boxes the
  whole screen, as the reference's does): the meshes and stream length
  exact, no quad dropped, at most ``MISMATCH`` of the pixels apart (ties
  at an edge), depth within the benchmark's ``DEPTH_TOL``, and the reduced
  count between the reference's without and with the quads it boxes
  whole-screen (it keeps those wholly behind the near plane too);
- the exchange left out (``benchmark/runners/views.py no_exchange``)
  splits the reduced count of a view whose bands count differently;
- the gather cap follows the renderer's bucket ladder, and ``warm_views``
  captures every bucket's step on every shard, after which a call makes
  none;
- the views spans and counters of ``utils/profiling.py``, and none under
  ``DPVR_TRACE=0``.

Tolerances: the views against ``render_frame`` bit-equal; against the
reference, meshes and stream lengths equal, depths within ``DEPTH_TOL``
(float32 rounding of NDC depth is under 1e-5) and the pixels and the
count as above."""

import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from benchmark import correct, poses
from benchmark.reference import bands
from benchmark.reference.frame import Reference
from benchmark.runners import views as BV
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.ops import projection
from differential_projection_voxel_renderer_tpu_torch.utils import (
    profiling as P,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RENDER = dict(width=256, height=128, gather_cap=16384, quads_cap=8192,
              tile_k_cap=16384)
WORLD = dict(view_distance=3, frustum_culling=True, max_chunks_per_frame=4)
START = (0.0, 10.0, 20.0)
PITCH = -0.12435499454676144
# the benchmark's yaw seeds: view 0's yaw drawn by the seed, view 1 behind
SEEDS = (2 ** 31 + 5, 2 ** 33 + 17)
# a pair that moves across the chunk boundary at z = 0 (chunks of 32)
MOVES = ((0.0, 10.0, 2.0), (0.0, 10.0, -6.0))
MISMATCH = 2e-4


def _engine(mesh_cards=None):
    eng = TE.Engine(TE.RenderConfig(**RENDER), TE.WorldConfig(**WORLD),
                    pool_slots=512, device="cpu", mesh_cards=mesh_cards)
    eng.camera.position = np.array(START, np.float32)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    return eng


def _yaw(seed):
    return poses.Traffic({"start": list(START), "pitch": PITCH,
                          "yaw": "seed"}, seed).yaw0


def _pair(position, yaw):
    return [(position, yaw, PITCH), (position, yaw + math.pi, PITCH)]


@pytest.fixture(scope="module")
def flight():
    """Each call's poses, its ViewsResult and draw lists, on a views
    engine; each view's render_frame on a serial engine over the same
    poses in the same order; the graph calls of each views call."""
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        graphs)

    eng, serial = _engine(4), _engine()
    eng.warm_views()
    calls = [_pair(START, _yaw(s)) for s in SEEDS]
    calls += [_pair(p, _yaw(SEEDS[0]) + 0.5) for p in MOVES]
    out = []
    for views in calls:
        before = graphs.calls.copy()
        res = eng.render_views(views)
        made = graphs.calls - before
        frames = []
        for k, (position, yaw, pitch) in enumerate(views):
            serial.camera.position = np.array(position, np.float32)
            serial.camera.yaw, serial.camera.pitch = yaw, pitch
            # the world updates at a call's first view alone, as there
            serial._hold_world = k > 0
            f = serial.render_frame(dt=0.0)
            frames.append((f.color, f.depth, f.stats))
        serial._hold_world = False
        out.append((views, res, frames, made))
    return eng, out


@pytest.mark.parametrize("call", range(4))
@pytest.mark.parametrize("view", range(2))
def test_views_equal_render_frame(flight, call, view):
    _, out = flight
    _, res, frames, _ = out[call]
    color, depth, stats = frames[view]
    assert torch.equal(res.color[view], color)
    assert torch.equal(res.depth[view].view(torch.int32),
                       depth.view(torch.int32))
    assert int(res.stats[view, 0]) == int(stats[0])
    assert res.stats[view, 2:4].tolist() == [0, 0]
    assert res.reduced[view].tolist() == [int(res.stats[view, 1])] * 2


def test_moving_views_streamed_and_meshed(flight):
    """The moving pair crossed into chunks the first calls had not
    loaded, and the pool took their meshes."""
    eng, out = flight
    assert out[2][0][0][0] != out[3][0][0][0]
    pooled = set(eng.pool.by_pos)
    assert any(p[2] < -1 for p in pooled)


@pytest.fixture(scope="module")
def reference_flight():
    """The views at the reference's boxes: (engine samples in the
    benchmark's form, the reference)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(projection, "STRADDLE_MARGIN", float("inf"))
    try:
        eng = _engine(4)
        got = []
        for seed in SEEDS:
            views = _pair(START, _yaw(seed))
            res = eng.render_views(views)
            got.append(_sample(eng, views, res))
    finally:
        mp.undo()
    config = dict(render=dict(RENDER, enable_shading=True,
                              enable_textures=True, visible_chunks_cap=(
                                  TE.RenderConfig().visible_chunks_cap)),
                  world=WORLD)
    return got, Reference(config, "cpu")


def _sample(eng, views, res):
    """The benchmark runner's sample of a call (runners/views.py)."""
    runner = BV.Runner.__new__(BV.Runner)
    runner.eng, runner.device = eng, torch.device("cpu")
    runner.cfg = dict(render=RENDER, world=WORLD)
    runner.first, runner.samples = 0, []
    runner.poses = lambda i: views
    runner.samples.append(runner._sample(0, res))
    return runner.host_samples()[0]


@pytest.mark.parametrize("seed", range(len(SEEDS)))
@pytest.mark.parametrize("view", range(2))
def test_views_equal_the_reference(reference_flight, seed, view):
    samples, ref = reference_flight
    s = BV._views(samples[seed])[view]
    rf = correct.ref_frame(ref, s, 0, 1)
    nums = correct.compare(s, rf, 0, 1)
    assert nums["mesh_diff"] == 0 and nums["gathered_diff"] == 0
    assert nums["dropped"] == 0
    # every pixel but the few where two quads of one depth meet at an edge
    # that float32 rounding gives to the other (0-2 of the 32768 here)
    assert nums["pixel_mismatch"] <= MISMATCH
    both = np.isfinite(rf.depth) & (s["color"] == rf.color)
    assert (np.isfinite(s["depth"]) == np.isfinite(rf.depth)).all()
    assert np.abs(s["depth"][both] - rf.depth[both]).max() <= (
        correct.DEPTH_TOL)
    # the reduced count against the reference's: the reference keeps every
    # quad with a corner behind the near plane and boxes it whole-screen
    # (in both bands), the port culls the ones wholly behind; so the count
    # lies between the reference's without those quads and with them
    st = bands.stream_of(ref, rf, s["pose"])
    whole = ((st.x0 == 0) & (st.x1 == ref.width - 1) & (st.y0 == 0)
             & (st.y1 == ref.height - 1))
    hi = bands.reduced_count(st, 2)
    st.visible = st.visible & ~whole
    lo = bands.reduced_count(st, 2)
    got = int(s["stats"][1])
    assert lo <= got <= hi, (lo, got, hi)
    assert samples[seed]["reduced"][view].tolist() == [got, got]


def test_no_exchange_splits_the_count():
    """Without the exchange each tp card holds its own band's count: the
    two differ on a view whose bands count differently."""
    eng = _engine(4)
    views = _pair(START, _yaw(SEEDS[0]))
    bands_of = eng._views_render()
    seen = []
    orig = bands_of.reduce

    def spy(shards):
        seen.append([int(shards[0, t][2][0]) for t in range(2)])
        return orig(shards)

    bands_of.reduce = spy
    sound = eng.render_views(views)
    del bands_of.reduce
    undo = BV.no_exchange(types.SimpleNamespace(eng=eng))
    split = eng.render_views(views)
    undo()
    b0, b1 = seen[0]
    assert b0 != b1
    assert sound.reduced[0].tolist() == [(b0 + b1) // 2] * 2
    assert split.reduced[0].tolist() == [b0, b1]
    assert int(split.reduced[0].max() - split.reduced[0].min()) > 0


def test_gather_cap_follows_the_bucket_ladder(flight):
    eng, out = flight
    r = eng.renderer
    assert {k[0] for k in eng._views.shards.graphs} == set(r.gather_buckets)
    for views, res, _, made in out:
        # warm_views captured every bucket: the calls only replay (on the
        # CPU a graph call runs its function; nothing captures)
        assert not made["captures"]
    lists = [eng.draw_list()]
    for n in (1, 8, 40):
        dl = TE.DrawList(lists[0].slots.copy(), lists[0].counts6.copy(),
                         lists[0].dir_mask.copy(),
                         lists[0].positions.copy(), lists[0].n)
        dl.counts6[:] = 0
        dl.counts6[:n, 0] = 400
        eye = np.eye(4, dtype=np.float32)
        frames, cap, quads = r.pack_views(
            [(dl, eye, np.zeros(3, np.float32)), (lists[0], eye,
                                                  np.zeros(3, np.float32))])
        want = max(400 * n, int((lists[0].counts6 * lists[0].dir_mask)[
            :lists[0].n].sum()))
        assert cap == r.bucket_for(want)
        assert frames.shape == (2, (11 * r.config.visible_chunks_cap + 1)
                                // 2 + 19)


def test_views_spans_and_counters():
    eng = _engine(4)
    eng.warm_views()
    P.TRACER.reset()
    views = _pair(START, _yaw(SEEDS[1]))
    res = eng.render_views(views)
    f = P.TRACER.frames(1)
    assert len(f) == 1
    names = {n for j, n in enumerate(P.SPAN_NAMES) if f.calls[0, j]}
    assert names >= {"frame", "funnel", "views_pack", "views_dispatch",
                     "views_load", "views_replay", "views_reduce",
                     "views_gather"}
    assert f.calls[0, P.SPAN_NAMES.index("funnel")] == 2
    assert int(f.count("views")[0]) == 2
    assert int(f.count("view_quads")[0]) == int(res.stats[:, 0].sum())
    dispatch = P.SPAN_NAMES.index("views_dispatch")
    kids = sum(f.span_ns(n)[0] for n in ("views_load", "views_replay",
                                         "views_reduce", "views_gather"))
    assert f.child_ns[0, dispatch] == kids
    for name in ("views_load", "views_replay", "views_reduce",
                 "views_gather"):
        assert P.PARENT[name] == "views_dispatch"


def test_views_trace_off_records_nothing():
    code = textwrap.dedent("""
        import numpy as np
        from differential_projection_voxel_renderer_tpu_torch.app import (
            engine as TE)
        from differential_projection_voxel_renderer_tpu_torch.utils import (
            profiling as P)
        assert not P.ENABLED
        assert P.VIEWS_DISPATCH is P.VIEWS_GATHER is P.VIEWS is P.NOOP
        eng = TE.Engine(TE.RenderConfig(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
                        TE.WorldConfig(view_distance=1), pool_slots=64,
                        device="cpu", mesh_cards=4)
        while eng.world.update(eng.camera.position):
            pass
        eng.prime_all()
        eng.render_views([((0.0, 10.0, 20.0), 0.0, 0.0),
                          ((0.0, 10.0, 20.0), 3.0, 0.0)])
        assert P.TRACER.n == 0 and P.TRACER.log is None
        print("off")
    """)
    env = dict(os.environ, DPVR_TRACE="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "off"


def test_views_need_a_mesh_and_the_single_pass():
    eng = TE.Engine(TE.RenderConfig(**RENDER), TE.WorldConfig(
        view_distance=1), pool_slots=64, device="cpu")
    with pytest.raises(RuntimeError):
        eng.render_views([((0.0, 10.0, 20.0), 0.0, 0.0)] * 2)
    packed = TE.Engine(TE.RenderConfig(**RENDER, packed_raster=True),
                       TE.WorldConfig(view_distance=1), pool_slots=64,
                       device="cpu", mesh_cards=4)
    with pytest.raises(ValueError):
        packed.warm_views()
    with pytest.raises(ValueError):
        TE.Engine(TE.RenderConfig(**RENDER), device="cpu",
                  pool_slots=64, mesh_cards=4).render_views([])


def test_views_follow_the_shading_toggle():
    """``toggle_shading`` gives the renderer other colour tables: the
    views render takes them (its graphs made again), and each view stays
    ``render_frame``'s frame."""
    eng, serial = _engine(4), _engine()
    views = _pair(START, _yaw(SEEDS[1]))
    eng.render_views(views)
    assert eng.toggle_shading() is False and serial.toggle_shading() is False
    res = eng.render_views(views)
    for k, (position, yaw, pitch) in enumerate(views):
        serial.camera.position = np.array(position, np.float32)
        serial.camera.yaw, serial.camera.pitch = yaw, pitch
        serial._hold_world = k > 0
        f = serial.render_frame(dt=0.0)
        assert torch.equal(res.color[k], f.color)
