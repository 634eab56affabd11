"""The port's tracer (``utils/profiling.py``): spans and their self time,
the spans each serial entry path records, ``DPVR_TRACE=0``, the frames a
reader takes, the meshing counter against the benchmark's count, and, on
the card (marked ``cuda``), the card's idle time on its own clock and a
frame path that never syncs.  Imports nothing of the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from benchmark.runners.engine import Runner
from benchmark.trace import Spans
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.utils import (
    profiling as P,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
# the serial path of tests/test_torch_engine.py: two frames at the primed
# pose (render_fused, then render_prepared), then frames that stream new
# chunks (render_fused_insert)
POSE0 = ((0.0, 40.0, 60.0), (0.0, 0.0, 0.0))
PATH = [POSE0, POSE0] + [((x, 40.0, 60.0 - x), (x, 0.0, -x))
                         for x in (24.0, 48.0, 72.0)]
ENTRIES = ("render_fused", "render_prepared", "render_fused_insert")


def _engine(device="cpu", prime_all=False):
    eng = TE.Engine(
        render_config=TE.RenderConfig(width=256, height=128,
                                      gather_cap=16384, quads_cap=8192),
        world_config=TE.WorldConfig(view_distance=3, frustum_culling=True,
                                    max_chunks_per_frame=4),
        pool_slots=512, device=device)
    _pose(eng, POSE0)
    while eng.world.update(eng.camera.position):
        pass
    if prime_all:
        eng.prime_all()
    else:
        eng.prime()
    return eng


def _pose(eng, pose):
    eng.camera.position = np.array(pose[0], np.float32)
    eng.camera.look_at(np.array(pose[1], np.float32))


def _names(frames, r):
    return {n for j, n in enumerate(P.SPAN_NAMES) if frames.calls[r, j]}


@pytest.fixture(scope="module")
def flight():
    """The path on the CPU: each frame's entry point, the tracer's frames,
    and the benchmark's own count of the loaded chunks handed to
    ``Engine._mesh_list`` (its traced run's wrapper)."""
    eng = _engine()
    took = []
    for name in ENTRIES:
        fn = getattr(eng.renderer, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            if out is not None:
                took.append(_name)
            return out

        setattr(eng.renderer, name, spy)
    spans = Spans()
    Runner.wrap_spans(types.SimpleNamespace(eng=eng), spans)
    entry = []
    for pose in PATH:
        _pose(eng, pose)
        del took[:]
        eng.render_frame(dt=0.0)
        entry.append(took[-1])
    return entry, P.TRACER.frames(len(PATH)), spans


def test_span_nesting_and_self_time():
    P.TRACER.reset()
    with P.FRAME(CPU):
        with P.FUNNEL:
            time.sleep(0.002)
            with P.WORLD_UPDATE:
                time.sleep(0.003)
            with P.MESHING:
                time.sleep(0.001)
        with P.DISPATCH:
            with P.LOAD:
                pass
            with P.LOAD:
                pass
    f = P.TRACER.frames(1)
    assert list(f.number) == [0]
    ms = {n: f.span_ns(n)[0] / 1e6 for n in P.SPAN_NAMES}
    assert ms["world_update"] >= 3.0 and ms["meshing"] >= 1.0
    assert ms["funnel"] >= 6.0
    funnel = P.SPAN_NAMES.index("funnel")
    assert f.child_ns[0, funnel] == (f.span_ns("world_update")[0]
                                     + f.span_ns("meshing")[0])
    assert 2.0 <= f.span_ns("funnel", self_time=True)[0] / 1e6 < ms["funnel"]
    assert f.calls[0, P.SPAN_NAMES.index("load")] == 2
    frame = P.SPAN_NAMES.index("frame")
    assert f.child_ns[0, frame] == (f.span_ns("funnel")[0]
                                    + f.span_ns("dispatch")[0])
    assert f.start_ns[0, frame] <= f.start_ns[0, funnel]
    assert f.end_ns[0, funnel] <= f.start_ns[0, P.SPAN_NAMES.index(
        "dispatch")] <= f.end_ns[0, frame]
    # spans outside a frame are not a frame's
    with P.FUNNEL:
        pass
    assert len(P.TRACER.frames(5)) == 1
    assert np.isnan(f.idle_ms).all()
    assert P.TRACER.completed == 1


def test_tree_of_the_spans():
    assert set(P.PARENT) == set(P.SPAN_NAMES)
    for name, parent in P.PARENT.items():
        assert parent is None or parent in P.SPAN_NAMES, name


def test_spans_each_serial_entry_path_records(flight):
    entry, frames, _ = flight
    assert set(entry) == set(ENTRIES), entry
    dispatch = {"dispatch", "prepare", "load", "replay", "copy_out"}
    want = {"frame", "funnel", "world_update"} | dispatch
    for r, name in enumerate(entry):
        got = _names(frames, r)
        assert got >= want, (name, got)
        if name == "render_fused_insert":
            assert "meshing" in got
    # every frame's children lie inside it
    frame = P.SPAN_NAMES.index("frame")
    assert (frames.ns[:, 1:] <= frames.ns[:, [frame]]).all()
    assert (frames.child_ns <= frames.ns).all()


def test_spans_and_counters_of_frames_in_flight():
    """The frames-in-flight path on the CPU: each call's renderer call in
    ``dispatch``, with its graph's load, replay and copy_out; every seed,
    step and drain counted in ``pipe_eager`` (the CPU has no graph to
    replay) and none in ``pipe_graph``; the flush a drain, in span
    ``pipe_drain`` and counter ``pipe_drains``."""
    P.TRACER.reset()
    eng = _engine()
    for _ in range(3):
        eng.render_frame_pipelined(dt=0.0)
    eng.flush_pipeline()
    f = P.TRACER.frames(4)
    assert len(f) == 4
    for r in range(4):
        assert _names(f, r) >= {"frame", "dispatch", "load", "replay",
                                "copy_out"}
        assert ("pipe_drain" in _names(f, r)) == (r == 3)
    assert list(f.count("pipe_eager")) == [1, 1, 1, 1]
    assert list(f.count("pipe_graph")) == [0, 0, 0, 0]
    assert list(f.count("pipe_drains")) == [0, 0, 0, 1]
    drain = P.SPAN_NAMES.index("pipe_drain")
    assert f.child_ns[3, drain] > 0  # the drain's graph call nests in it


def test_meshing_counter_is_the_benchmarks_count(flight):
    """The counter ``chunks_meshed`` a frame against the benchmark's
    wrapper of ``Engine._mesh_list`` (the loaded chunks it is handed)."""
    entry, frames, spans = flight
    assert spans.counts["meshing"] > 0
    assert int(frames.count("chunks_meshed").sum()) == spans.counts[
        "meshing"]
    gen = frames.count("chunks_generated")
    assert gen.sum() > 0 and (gen <= 4).all()


def test_frames_leave_out_the_profiled_ones():
    P.TRACER.reset()
    for i in range(6):
        if i in (2, 3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                with P.FRAME(CPU), P.DISPATCH:
                    pass
        else:
            with P.FRAME(CPU), P.DISPATCH:
                pass
    assert list(P.TRACER.frames(6).number) == [0, 1, 4, 5]
    assert list(P.TRACER.frames(3).number) == [4, 5]
    assert list(P.TRACER.frames(100).number) == [0, 1, 4, 5]


def test_trace_off_records_nothing():
    code = textwrap.dedent("""
        from differential_projection_voxel_renderer_tpu_torch.app import (
            engine as TE)
        from differential_projection_voxel_renderer_tpu_torch.utils import (
            profiling as P)
        assert not P.ENABLED and P.FUNNEL is P.FRAME is P.NOOP
        eng = TE.Engine(TE.RenderConfig(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
                        TE.WorldConfig(view_distance=1), pool_slots=64,
                        device="cpu")
        while eng.world.update(eng.camera.position):
            pass
        eng.prime_all()
        eng.render_frame()
        assert P.TRACER.n == 0 and P.TRACER.log is None
        assert len(P.TRACER.frames(10)) == 0
        print("off")
    """)
    env = dict(os.environ, DPVR_TRACE="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "off"


def test_log_fps_counts_completed_frames(capsys):
    """``log_fps``: the slow-frame line from the frame span and the
    frames completed a second."""
    eng = _engine()
    eng.log_fps = True
    eng.slow_frame_ms = 0.0
    eng._fps_t0 -= 1.0
    eng.render_frame(dt=0.0)
    out = capsys.readouterr().out
    assert "slow frame:" in out and "FPS:" in out
    fps = float(out.split("FPS:")[1].split()[0])
    assert fps > 0


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pan(eng, frames, yaw=0.002, sync=False):
    for _ in range(frames):
        eng.camera.yaw += yaw
        eng.render_frame(dt=0.0)
        if sync:
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_idle_in_the_funnel_on_the_cards_clock(cuda_device):
    """A world update that holds the host 2 ms: the card's idle while the
    host is in the funnel rises by about 2 ms a frame; its idle in the
    dispatch before the first enqueue does not.  Each frame waits for the
    card, so that it starts on an idle card either way."""
    eng = _engine("cuda", prime_all=True)
    eng.warm_buckets()
    _pan(eng, 20)
    n = 8 * P.MARK_EVERY

    def idle():
        f = P.TRACER.frames(n)
        got = ~np.isnan(f.idle_ms).any(axis=1)
        assert got.sum() == n // P.MARK_EVERY, got
        assert (f.idle("idle")[got] >= f.idle("idle_funnel")[got]
                + f.idle("idle_dispatch")[got]).all()
        return (f.idle("idle_funnel")[got].mean(),
                f.idle("idle_dispatch")[got].mean())

    _pan(eng, n, sync=True)
    base = idle()
    update = eng.world.update

    def slow_update(pos):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.002:
            pass
        return update(pos)

    eng.world.update = slow_update
    _pan(eng, n, sync=True)
    slow = idle()
    assert 1.8 <= slow[0] - base[0] <= 2.2, (base, slow)
    assert abs(slow[1] - base[1]) < 0.1, (base, slow)


@pytest.mark.cuda
def test_frame_path_never_syncs_with_tracing_on(cuda_device):
    """The serial frames (draw list changed and unchanged) under
    ``torch.cuda.set_sync_debug_mode("error")``, tracing on: neither the
    frame path nor the tracer's markers and their reading sync."""
    assert P.ENABLED
    eng = _engine("cuda", prime_all=True)
    eng.warm_buckets()
    _pan(eng, 4)
    torch.cuda.synchronize()
    n0 = P.TRACER.n
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _pan(eng, 30, yaw=0.05)
        got = P.TRACER.frames(30)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert P.TRACER.n == n0 + 30 and len(got) == 30
