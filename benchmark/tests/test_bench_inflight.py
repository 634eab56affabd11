"""The frames-in-flight runner (``runners/inflight.py``), its plain model
(``reference/inflight.py``) and its five readers: the model's order; on a
stub engine, the one-call-late pairing of outputs with poses and the
latencies to the emitting mark; at a tiny size on the CPU, a whole run's
result line, ``correct`` coming out false under the dropped and the
doubled frame (by ``order_diff``) and under the control; each new reader
on a program with and without its span or counter."""

import json
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control, harness, program, spec
from benchmark.control_views import with_views_faults
from benchmark.reference import inflight as model
from benchmark.runners import engine as base
from benchmark.tests.tiny import shrink
from benchmark.trace import Spans

WORKLOAD = "vd12_720p_inflight.pan"
E2E = {"fps", "frame_p99_ms", "setup_s"}
NEW = ("pipe_graph_share", "pipe_drains", "pipe_drain_ms",
       "inflight_dispatch_ms", "k3_ms")


@pytest.fixture(scope="module")
def cell():
    return shrink(spec.cell(WORKLOAD))


# ----------------------------------------------------------------- model

def test_model_emits_each_frame_one_call_late():
    calls, flushed, drained = model.emissions([1, 1, 2, 2, 1], flushes=2)
    assert calls == [None, 0, 1, 2, 3]
    assert flushed == [4, None]
    assert drained == [2, 4]
    assert model.emissions([], flushes=1) == ([], [None], [])


@pytest.mark.parametrize("emitted, flushed, want", [
    ([False, True, True, True], [True, False], 0),
    # the frame call 2 emits is lost: every later frame comes out a place
    # late, and one frame is missing
    ([False, True, False, True], [True, False], 3),
    # the last frame comes out twice
    ([False, True, True, True], [True, True], 1),
    # the last frame never comes out
    ([False, True, True, True], [False, False], 1),
    # a frame comes out of an empty pipeline
    ([True, True, True, True], [True, False], 5),
])
def test_order_diff(emitted, flushed, want):
    assert model.order_diff([7, 7, 9, 9], emitted, flushed) == want


# ------------------------------------------------------ the stub engine

SLEEP = 0.01


def _out(j):
    t = torch.tensor([j], dtype=torch.int32)
    return types.SimpleNamespace(color=t, depth=t.float(), stats=t)


class StubEngine:
    """One frame in flight, as the program promises it: a call enters its
    camera's frame and returns the frame entered before, each call taking
    ``SLEEP`` seconds; a frame's outputs are its index."""

    def __init__(self):
        self.camera = types.SimpleNamespace(position=None, yaw=0.0,
                                            pitch=0.0)
        self.renderer = types.SimpleNamespace(_pipe_carry=None)
        self.yaws = []

    def render_frame_pipelined(self, dt):
        time.sleep(SLEEP)
        self.yaws.append(self.camera.yaw)
        out = self.flush_pipeline()
        self.renderer._pipe_carry = (16384, len(self.yaws) - 1)
        return out

    def flush_pipeline(self):
        carry, self.renderer._pipe_carry = self.renderer._pipe_carry, None
        return None if carry is None else _out(carry[1])


@pytest.fixture(scope="module")
def stub_run(cell):
    r = harness.build(cell, 2 ** 31 + 5, "cpu")
    r.eng, r.first = StubEngine(), 0
    r._state = lambda k: base.Sample(k=k, yaw=r.traffic.pose(k).yaw)
    return r, r.window(0.3, False)


def test_outputs_pair_with_their_own_pose(stub_run):
    r, got = stub_run
    assert len(r.samples) >= 2
    for s in r.samples:
        assert int(s["color"][0]) == s["k"]
        assert r.eng.yaws[s["k"]] == s["yaw"]
    assert r.samples[-1]["k"] == got["frames"] - 1


def test_latency_runs_to_the_emitting_mark(stub_run):
    """A frame completes when the call after it returns, two calls of
    ``SLEEP`` from its issue at least; the last when the flush returns."""
    r, got = stub_run
    lat = got["latencies_ms"]
    assert len(lat) == got["frames"] == len(r.eng.yaws) > 5
    assert min(lat[:-1]) >= 2 * SLEEP * 1e3 * 0.95
    assert SLEEP * 1e3 * 0.95 <= lat[-1] < min(lat[:-1])
    assert r.calls["emitted"] == [False] + [True] * (got["frames"] - 1)
    assert r.calls["flushed"] == [True, False]
    assert model.order_diff(r.calls["buckets"], r.calls["emitted"],
                            r.calls["flushed"]) == 0


# -------------------------------------------------- a run on the CPU

@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(cell, trace):
    r = harness.run_cell(cell, 2 ** 31 + 11, 1.0, bool(trace),
                         time.perf_counter(), device="cpu")
    line = json.loads(json.dumps(r))
    assert line["correct"] is True and line["attempted"] >= 1
    assert line["compared"]["order_diff"] == {"value": 0, "limit": 0}
    if trace:
        # the CPU serves every step eagerly; no K3 without a card
        assert line["metrics"]["pipe_graph_share"]["value"] == 0.0
        assert {"pipe_drains", "pipe_drain_ms",
                "inflight_dispatch_ms"} <= set(line["metrics"])
        assert "k3_ms" not in line["metrics"]
    else:
        assert set(line["metrics"]) == E2E


@pytest.fixture(scope="module")
def got(cell):
    with_views_faults(cell)
    return control.readings(cell, 2 ** 31 + 12, 1.0,
                            ["dropped_frame", "doubled_frame"],
                            device="cpu")


def _fails(nums, limits):
    return [k for k in limits if nums.get(k, 0) > limits[k]]


def test_sound_run_passes(cell, got):
    assert got["sound"]["order_diff"] == 0
    assert _fails(got["sound"], cell.limits["limits"]) == []


@pytest.mark.parametrize("fault", ["dropped_frame", "doubled_frame"])
def test_fault_fails_by_order(cell, got, fault):
    assert "order_diff" in _fails(got[fault], cell.limits["limits"])


def test_control_fails(cell, got):
    assert _fails(got["control"], cell.limits["limits"]) == [
        "pixel_mismatch"]


# ----------------------------------------------------------- readers

class Frames:
    def __init__(self, spans, counts):
        self.spans, self.counts = spans, counts

    def __len__(self):
        return 2

    def span_ns(self, name, self_time=False):
        if name not in self.spans:
            raise ValueError(f"{name!r} is not in list")
        return np.asarray(self.spans[name], np.int64)

    def count(self, name):
        return np.asarray(self.counts[name], np.int64)


def _ctx(monkeypatch, spans, counts, counter_names):
    from differential_projection_voxel_renderer_tpu_torch.utils import (
        profiling as P)

    tracer = types.SimpleNamespace(
        enabled=True, frames=lambda n: Frames(spans, counts))
    monkeypatch.setattr(program, "tracer", lambda: tracer)
    monkeypatch.setattr(P, "COUNTER_NAMES", counter_names)
    s = Spans()
    s.frames = 2
    kernels = {"(anonymous namespace)::raster_kernel(int const*)": 300.0,
               "(anonymous namespace)::raster_packed_kernel(int)": 50.0}
    return dict(profile=dict(frames=3, kernels=kernels), spans=s,
                peaks=None)


def test_readers(monkeypatch):
    c = _ctx(monkeypatch, {"dispatch": [1e6, 3e6], "pipe_drain": [0, 2e6]},
             {"pipe_graph": [3, 1], "pipe_eager": [0, 0],
              "pipe_drains": [0, 1]},
             ("pipe_graph", "pipe_eager", "pipe_drains"))
    want = {"pipe_graph_share": 1.0, "pipe_drains": 0.5,
            "pipe_drain_ms": 1.0, "inflight_dispatch_ms": 2.0,
            "k3_ms": 0.1}
    for name in NEW:
        assert spec.metric_reader(name)(c) == pytest.approx(want[name])


@pytest.mark.parametrize("name", ["pipe_graph_share", "pipe_drains",
                                  "pipe_drain_ms"])
def test_reader_is_none_on_a_program_without_it(monkeypatch, name):
    """The parent's tracer has neither the counters nor the span: the
    reader returns None and does not raise."""
    c = _ctx(monkeypatch, {"dispatch": [1e6, 3e6]}, {},
             ("chunks_meshed", "pack_native", "pack_numpy"))
    assert spec.metric_reader(name)(c) is None
    assert spec.metric_reader("inflight_dispatch_ms")(c) == 2.0
