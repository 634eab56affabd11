"""The Renderer's serial entry points served from graphs
(rendering/graphs.py ``CapturedCall``), on the CPU.

On the CPU a ``CapturedCall`` copies its inputs into its static buffers,
calls its function on them eagerly and copies the outputs out: every step
of a card's frame but the capture and the replay (tests/test_torch_cuda.py
holds the replays on the card).  A temporal Engine (128x64, view distance
3, ``temporal_hiz``, so that one flight takes all four graph-backed entry
points: ``render_fused``, ``render_prepared``, ``render_prepared_hiz`` and
``render_fused_insert``) flies a mixed path beside the JAX package's
Engine: a draw-list-changed frame, a temporal static pair, a shading
toggle and back, a turned camera on the same draw list, moving frames that
stream chunks, and a held pose.  Every FrameResult is kept to the end;
each must equal, bit for bit, the eager function of its entry point
called on the same inputs at its frame, and the JAX engine's frame under
the gates of tests/_torch_scenes.py (``assert_engine_frame_gates`` with
the JAX jnp path's depth tolerance ``JNP_DEPTH_ULPS``, as the resident
flight of tests/test_torch_engine.py: XLA:CPU contracts the jnp path's
plane evaluations into FMAs; every colour mismatch a proven edge or texel
flip, stats and mesh counts equal).
"""

import collections
import threading

import numpy as np
import pytest
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch import _build
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.ops import raster
from differential_projection_voxel_renderer_tpu_torch.rendering import graphs
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

torch.set_num_threads(1)

W, H = 128, 64
P0 = ((0.0, 10.0, 20.0), (0.0, 0.0, -60.0))
# (pose, shading toggles before the frame, settle the world first); the
# turned camera keeps the draw list, the moving poses stream chunks 4 a
# frame, the held pose settles once and then holds for three frames
P1 = ((24.0, 20.0, -4.0), (24.0, 0.0, -50.0))
FLIGHT = ([(P0, 0, False)] * 3 + [(P0, 1, False), (P0, 1, False),
                                  (((0.0, 10.0, 20.0), (0.05, 0.0, -60.0)),
                                   0, False)]
          + [(((x, 10.0, 20.0 - x), (x, 0.0, -60.0 - x)), 0, False)
             for x in (8.0, 16.0, 24.0)]
          + [(P1, 0, True), (P1, 0, False), (P1, 0, False)])


def _configs(render_config_cls, world_config_cls):
    return dict(
        render_config=render_config_cls(width=W, height=H, gather_cap=16384,
                                        quads_cap=8192, temporal_hiz=True),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=4),
        pool_slots=512)


def _pose(eng, pose):
    eng.camera.position = np.array(pose[0], np.float32)
    eng.camera.look_at(np.array(pose[1], np.float32))


@pytest.fixture(scope="module")
def flight():
    """Both engines over FLIGHT: [(JAX frame, port frame, port records,
    the port FrameResult, its call (entry point, cap, eager outputs))]."""
    jeng = JE.Engine(**_configs(JCFG.RenderConfig, JW.WorldConfig))
    teng = TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                     device="cpu")
    twin = graphs.EagerTwin(teng.renderer, keep_eager=True)
    for eng in (jeng, teng):
        _pose(eng, P0)
        while eng.world.update(eng.camera.position):
            pass
        eng.prime()
    frames = []
    for pose, toggles, settle in FLIGHT:
        for _ in range(toggles):
            assert jeng.toggle_shading() == teng.toggle_shading()
        n_calls = len(twin.calls)
        out = []
        for eng in (jeng, teng):
            _pose(eng, pose)
            while settle and eng.world.update(eng.camera.position):
                pass
            out.append(eng.render_frame(dt=0.0))
        # a settled draw list is expanded first, from its own graph
        calls = twin.calls[n_calls:]
        assert [c[0] for c in calls[:-1]] in ([], ["expand"]), calls
        assert all(equal and not replayed  # the CPU has no graph to replay
                   for _, _, replayed, equal in calls)
        name, cap, replayed, equal = twin.calls[-1]
        want = twin.eager[-1]
        frames.append((S.frame_tuple(out[0]), S.frame_tuple(out[1]),
                       S.engine_records(teng), out[1], (name, cap, want)))
    return frames


@pytest.mark.parametrize("frame", range(len(FLIGHT)))
def test_kept_frame_equals_the_eager_function(flight, frame):
    """The kept FrameResult, read after the whole flight, equals its entry
    point's function called eagerly on the same inputs, bit for bit."""
    res, (name, cap, want) = flight[frame][3:]
    got = (res.color, res.depth, res.stats)
    assert cap == 16384
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("frame", range(len(FLIGHT)))
def test_flight_frame_matches_jax(flight, frame):
    """The gates with the JAX jnp path's depth tolerance: measured here up
    to 7 ulps at the turned camera, colours and stats equal."""
    ref, got, records = flight[frame][:3]
    S.assert_engine_frame_gates(ref, got, records,
                                depth_ulps=S.JNP_DEPTH_ULPS)


def test_flight_took_every_graph_entry_point(flight):
    """The flight's frames in order: the draw-list-changed frame, the
    temporal static frames (the pyramid seeded, then culling), the turned
    camera on the same draw list, streaming frames, the held pose."""
    names = [f[4][0] for f in flight]
    assert names[:6] == ["fused", "hiz", "hiz", "hiz", "hiz", "prepared"]
    assert "insert" in names[6:10], names
    assert names[-2:] == ["hiz", "hiz"], names
    culls = [int(f[1][2][5]) > 0 for f in flight]
    assert culls[2] and culls[-1] and not culls[1] and not culls[5]


def _engine_at_p0():
    eng = TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                    device="cpu")
    _pose(eng, P0)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    eng.render_frame(dt=0.0)
    return eng


@pytest.mark.parametrize("pipelined", [False, True])
def test_one_graph_per_entry_point_and_bucket(pipelined):
    """warm_buckets makes one graph per (entry point, gather bucket) --
    the fused frame, the expansion, the static step and the temporal step
    of each of the three buckets; with ``pipelined`` (which excludes the
    temporal step) the frames-in-flight seeds and steps besides -- and a
    second warm_buckets reuses every one of them."""
    r = TPL.Renderer(TE.RenderConfig(width=W, height=H, gather_cap=65536,
                                     quads_cap=8192,
                                     temporal_hiz=not pipelined),
                     device="cpu")
    assert r.gather_buckets == (16384, 32768, 65536)
    pool = torch.zeros((4, 512), dtype=torch.int32)
    r.warm_buckets(pool, pipelined=pipelined)
    names = ("fused", "expand", "prepared") + (
        ("pipe_seed", "pipe_seed_fused", "pipe_prepared", "pipe_fused")
        if pipelined else ("hiz",))
    assert set(r._graphs) == {(n, c) for n in names
                              for c in r.gather_buckets}
    assert r._pipe_carry is None
    made = dict(r._graphs)
    r.warm_buckets(pool, pipelined=pipelined)
    assert all(r._graphs[k] is g for k, g in made.items())
    assert len(r._graphs) == len(made)
    assert r._cam_cache is None


def test_set_shading_drops_every_graph():
    eng = _engine_at_p0()
    r = eng.renderer
    assert r._graphs
    tables = r._bucket_kw(16384)["color_tables"]
    eng.toggle_shading()
    assert r._graphs == {}
    eng.render_frame(dt=0.0)
    # the settled draw list's expansion, then the temporal static step
    assert set(r._graphs) == {("expand", 16384), ("hiz", 16384)}
    g = r._graphs["hiz", 16384]
    assert g.fn.keywords["color_tables"] is not tables


def test_new_pool_tensors_rebuild_the_graph():
    """A frame with other pool tensors than the graph captured gets a new
    graph over them, and renders the same frame; the first pool again
    rebuilds again."""
    eng = _engine_at_p0()
    r, pool = eng.renderer, eng.pool
    args = (eng._last_visible_slots, eng._last_counts_sel,
            eng._last_positions_sel, eng.camera.view_projection_matrix(),
            eng.camera.position)
    first = r.render_fused(pool.quads, *args, dir_mask=eng._last_dir_mask)
    g = r._graphs["fused", 16384]
    assert len(g.fixed) == 1 and g.fixed[0] is pool.quads
    q2 = pool.quads.clone()
    second = r.render_fused(q2, *args, dir_mask=eng._last_dir_mask)
    g2 = r._graphs["fused", 16384]
    assert g2 is not g and g2.fixed[0] is q2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    r.render_fused(pool.quads, *args, dir_mask=eng._last_dir_mask)
    assert r._graphs["fused", 16384].fixed[0] is pool.quads


def _storages(ts):
    return {t.untyped_storage().data_ptr() for t in ts}


def test_outputs_share_no_storage_with_the_graph():
    """A frame's tensors share storage with no static buffer, no fixed
    tensor and no other frame's tensors."""
    eng = _engine_at_p0()
    frames = [eng.render_frame(dt=0.0) for _ in range(3)]
    owned = set()
    for g in eng.renderer._graphs.values():
        owned |= _storages(g.static) | _storages(g.fixed)
    seen = set()
    for f in frames:
        mine = _storages((f.color, f.depth, f.stats))
        assert len(mine) == 3
        assert not mine & owned and not mine & seen
        seen |= mine


def test_static_stream_copied_only_when_it_changes():
    """render_prepared copies its stream into the graph only when it is
    not the stream copied last (that one is kept referenced); the camera
    goes in every frame."""
    eng = _engine_at_p0()
    r = eng.renderer
    uploads = r.prepare_uploads(eng.pool.quads, eng._last_visible_slots,
                                eng._last_counts_sel,
                                eng._last_positions_sel,
                                dir_mask=eng._last_dir_mask)
    vp, cp = eng.camera.view_projection_matrix(), eng.camera.position
    want = r.render_prepared(uploads, vp, cp)
    g = r._graphs["prepared", 16384]
    assert all(k is u for k, u in zip(g._kept[:3], uploads))
    assert int(want[2][0]) > 0
    g.static[2].zero_()   # the stream's length: a copy would restore it
    again = r.render_prepared(uploads, vp, cp)
    assert int(again[2][0]) == 0 and int(g.static[2]) == 0
    other = tuple(x.clone() for x in uploads)
    third = r.render_prepared(other, vp, cp)
    assert torch.equal(g.static[2], uploads[2])
    for a, b in zip(want, third):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["tensor", "array", "int", "keep-same",
                                  "keep-other", "keep-int", "bad-shape",
                                  "bad-dtype"])
def test_captured_call_load(case):
    """``CapturedCall.load``: tensors and arrays are copied into the
    static buffer, integers filled; with ``keep`` the same object (or an
    equal integer) is not copied again, another one is; a shape or dtype
    other than the buffer's raises."""
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    call = graphs.CapturedCall(lambda a, n: a * n, (), (x, 1), device="cpu")
    if case.startswith("bad"):
        bad = (torch.zeros(3, dtype=torch.int32) if case == "bad-shape"
               else x.float())
        with pytest.raises(ValueError):
            call.load(0, bad)
        return
    if case == "tensor":
        call.load(0, x)
    elif case == "array":
        call.load(0, x.numpy())
    elif case == "int":
        call.load(1, 7)
        assert int(call.static[1]) == 7
        return
    elif case == "keep-int":
        call.load(1, np.int32(3), keep=True)
        call.static[1].fill_(0)
        call.load(1, 3, keep=True)
        assert int(call.static[1]) == 0
        call.load(1, 4, keep=True)
        assert int(call.static[1]) == 4
        return
    else:
        call.load(0, x, keep=True)
        call.static[0].zero_()
        call.load(0, x if case == "keep-same" else x.clone(), keep=True)
        if case == "keep-same":
            assert not call.static[0].any() and call._kept[0] is x
            return
    assert torch.equal(call.static[0], x)
    call.load(1, 2)
    out = call.run()
    assert torch.equal(out, 2 * x)
    assert out.untyped_storage().data_ptr() not in _storages(call.static)


def test_captured_call_matches():
    a = torch.zeros(4, dtype=torch.int32)
    call = graphs.CapturedCall(lambda f, x: f + x, (a,), (np.ones(4,
                                                                  np.int32),),
                               device="cpu")
    assert call.matches((a,), (np.zeros(4, np.int32),))
    assert call.matches((a[:],), (torch.zeros(4, dtype=torch.int32),))
    assert not call.matches((a.clone(),), (np.zeros(4, np.int32),))
    assert not call.matches((a,), (np.zeros(5, np.int32),))
    assert not call.matches((a,), (np.zeros(4, np.float32),))


def test_launch_counts_taken_back_and_added():
    """A capturing thread counts into its own tally, not the registry
    (another thread's launches meanwhile still count there); the tally is
    added at each replay, in the modules' counts and by card."""
    tally = (collections.Counter(), collections.Counter())
    with _build.COUNT_LOCK:
        saved = (_build.counts.copy(), _build.card_launches.copy())
    try:
        before = (geometry.launches, raster.launches,
                  _build.card_launches["K1", 0])
        with _build.counting_into(tally):
            _build.count("K1", 0)
            _build.count("K1", 0, "K1 span")
            _build.count("K2", 0)
            other = threading.Thread(target=_build.count, args=("K2", 1))
            other.start()
            other.join()
        assert (geometry.launches, raster.launches) == (before[0],
                                                        before[1] + 1)
        assert tally == (collections.Counter({"K1": 2, "K1 span": 1,
                                              "K2": 1}),
                         collections.Counter({("K1", 0): 2, ("K2", 0): 1}))
        _build.add_counts(tally)
        _build.add_counts(tally)
        assert geometry.launches == before[0] + 4
        assert raster.launches == before[1] + 3
        assert _build.card_launches["K1", 0] == before[2] + 4
        assert geometry.launches_span == saved[0]["K1 span"] + 2
    finally:
        with _build.COUNT_LOCK:
            for live, old in zip((_build.counts, _build.card_launches),
                                 saved):
                live.clear()
                live.update(old)


def test_modules_read_their_counts_from_the_registry():
    """Every wrapper module's count attributes read _build.counts; the
    reset clears them all."""
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        micro,
        raster_packed,
    )

    names = {(geometry, "launches"): "K1", (geometry, "launches_span"):
             "K1 span", (raster, "launches"): "K2", (raster, "launches_geom"):
             "K3", (raster, "launches_meta"): "tile_meta",
             (raster_packed, "launches"): "K4",
             (micro, "launches_fill"): "M1", (micro, "launches_copy"): "M2"}
    with _build.COUNT_LOCK:
        saved = (_build.counts.copy(), _build.card_launches.copy())
    try:
        for k, key in enumerate(names.values()):
            _build.counts[key] = 10 + k
        assert [getattr(m, a) for m, a in names] == [
            10 + k for k in range(len(names))]
        _build.reset_counts()
        assert [getattr(m, a) for m, a in names] == [0] * len(names)
        with pytest.raises(AttributeError):
            raster.launches_nowhere
    finally:
        with _build.COUNT_LOCK:
            for live, old in zip((_build.counts, _build.card_launches),
                                 saved):
                live.clear()
                live.update(old)


def test_captured_call_run_without_copy():
    """``run(copy=False)`` returns the function's own outputs; ``run()``
    copies them out."""
    held = torch.arange(4, dtype=torch.int32)
    call = graphs.CapturedCall(lambda f, x: (f, f + x), (held,),
                               (np.ones(4, np.int32),), device="cpu")
    call.load(0, np.ones(4, np.int32))
    own = call.run(copy=False)
    assert own[0] is held and torch.equal(own[1], held + 1)
    copied = call.run()
    assert copied[0] is not held and torch.equal(copied[0], held)
    assert copied[0].untyped_storage().data_ptr() != held.data_ptr()


def test_eager_twin_records_and_closes():
    """EagerTwin records each graph call with its eager outputs and gives
    the renderer its method back."""
    eng = _engine_at_p0()
    r = eng.renderer
    twin = graphs.EagerTwin(r, keep_eager=True)
    assert "_run_graph" in vars(r)
    eng.render_frame(dt=0.0)
    # the settled draw list's expansion, then its static step
    expand, (name, cap, replayed, equal) = twin.calls
    assert expand == ("expand", 16384, False, True)
    assert (cap, replayed, equal) == (16384, False, True)
    assert name in ("prepared", "hiz") and len(twin.eager) == 2
    assert twin.replays() == {} and not twin.all_replayed_equal()
    twin.close()
    assert "_run_graph" not in vars(r)
