"""The readers of the program's tracer (``benchmark/program.py`` and the
eight metrics on it) on a fake tracer: which frames they read, and what
they make of them."""

import math

import numpy as np
import pytest

from benchmark import program, spec
from benchmark.trace import Spans

NAMES = ("frame", "funnel", "world_update", "world_queue", "world_generate",
         "world_unload", "meshing", "dispatch", "prepare", "load", "replay",
         "copy_out")


class FakeFrames:
    """Four frames as the port's ``profiling.Frames`` gives them."""

    def __init__(self, idle):
        ms = 1_000_000
        self.ns = np.zeros((4, len(NAMES)), np.int64)
        self.child_ns = np.zeros_like(self.ns)
        for name, v in (("frame", 7), ("funnel", 5), ("world_update", 0.5),
                        ("meshing", 1), ("dispatch", 1.5)):
            self.ns[:, NAMES.index(name)] = int(v * ms)
        self.ns[0, NAMES.index("meshing")] = 3 * ms    # 1.5 ms on average
        self.child_ns[:, NAMES.index("funnel")] = (
            self.ns[:, NAMES.index("world_update")]
            + self.ns[:, NAMES.index("meshing")])
        self.meshed = np.array([16, 0, 17, 3])
        self.idle_ms = np.asarray(idle, np.float64)

    def __len__(self):
        return 4

    def span_ns(self, name, self_time=False):
        j = NAMES.index(name)
        return self.ns[:, j] - self.child_ns[:, j] * self_time

    def count(self, name):
        assert name == "chunks_meshed"
        return self.meshed

    def idle(self, name):
        return self.idle_ms[:, ("idle", "idle_funnel",
                                "idle_dispatch").index(name)]


class FakeTracer:
    enabled = True

    def __init__(self, idle):
        self.asked = []
        self.idle = idle

    def frames(self, last):
        self.asked.append(last)
        return FakeFrames(self.idle)


ON_CARD = [[0.3, 0.2, 0.05], [0.5, 0.4, 0.05], [math.nan] * 3,
           [0.1, 0.0, 0.02]]


def ctx(spans_frames=10, profile_frames=4):
    spans = Spans()
    spans.frames = spans_frames
    return dict(profile={"frames": profile_frames}, spans=spans, peaks=None)


@pytest.fixture
def fake(monkeypatch):
    tr = FakeTracer(ON_CARD)
    monkeypatch.setattr(program, "tracer", lambda: tr)
    return tr


@pytest.mark.parametrize("name, want", [
    ("funnel_ms", 5 - 0.5 - 1.5),
    ("dispatch_ms", 1.5), ("world_update_ms", 0.5), ("meshing_ms", 1.5),
    ("meshed_chunks", 9.0), ("idle_ms", 0.3), ("idle_funnel_ms", 0.2),
    ("idle_dispatch_ms", 0.04)])
def test_reader(fake, name, want):
    assert spec.metric_reader(name)(ctx()) == pytest.approx(want)


def test_window_is_the_spans_and_the_profiled_frames(fake):
    program.window(ctx(spans_frames=700, profile_frames=300))
    assert fake.asked == [1000]


@pytest.mark.parametrize("name", ["idle_ms", "idle_funnel_ms",
                                  "idle_dispatch_ms"])
def test_idle_is_none_where_no_frame_resolved(monkeypatch, name):
    """Off a card (or before the card ran them) the frames' idle times
    are NaN: nothing to read, never 0."""
    tr = FakeTracer([[math.nan] * 3] * 4)
    monkeypatch.setattr(program, "tracer", lambda: tr)
    assert spec.metric_reader(name)(ctx()) is None
    assert spec.metric_reader("dispatch_ms")(ctx()) == pytest.approx(1.5)


NEW = ["funnel_ms", "dispatch_ms", "world_update_ms", "meshing_ms",
       "meshed_chunks", "idle_ms", "idle_funnel_ms", "idle_dispatch_ms"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_a_tracer(monkeypatch, name):
    """A program without the tracer (or with tracing off), and a run
    without spans, read as None: the reader does not raise."""
    monkeypatch.setattr(program, "tracer", lambda: None)
    assert spec.metric_reader(name)(ctx()) is None
    monkeypatch.setattr(program, "tracer", lambda: FakeTracer(ON_CARD))
    assert spec.metric_reader(name)(dict(ctx(), spans=None)) is None


def test_tracer_of_a_program_without_one(monkeypatch):
    """The parent's ``utils/profiling`` has no ``TRACER``: None."""
    import types

    monkeypatch.setattr("importlib.import_module",
                        lambda name: types.ModuleType(name))
    assert program.tracer() is None


def test_the_real_tracer_reads_on_the_cpu():
    """The port's tracer as the readers find it after a CPU frame: spans
    read, idle None (no card)."""
    import torch

    from differential_projection_voxel_renderer_tpu_torch.utils import (
        profiling as P)

    with P.FRAME(torch.device("cpu")), P.DISPATCH:
        pass
    c = ctx(spans_frames=1, profile_frames=0)
    assert spec.metric_reader("dispatch_ms")(c) >= 0.0
    assert spec.metric_reader("idle_ms")(c) is None
