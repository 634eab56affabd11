"""The views runner (``runners/views.py``) at a tiny size on the CPU: a
whole run's result line, ``correct`` coming out false under each of its
faults of the exchange and under the control; and its five readers on a
synthetic traced run."""

import json
import time

import pytest

from benchmark import control, harness, spec
from benchmark.control_views import with_views_faults
from benchmark.tests.tiny import shrink
from benchmark.trace import Spans

WORKLOAD = "vd12_720p_2x2.views"
E2E = {"fps", "frame_p99_ms", "setup_s"}


@pytest.fixture(scope="module")
def cell():
    return shrink(spec.cell(WORKLOAD))


def test_result_line(cell):
    r = harness.run_cell(cell, 2 ** 31 + 11, 1.0, False, time.perf_counter(),
                         device="cpu")
    line = json.loads(json.dumps(r))
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == E2E
    assert set(line["compared"]) == {"mesh_diff", "gathered_diff",
                                     "dropped", "count_split",
                                     "band_count_diff", "pixel_mismatch"}


@pytest.fixture(scope="module")
def got(cell):
    with_views_faults(cell)
    return control.readings(cell, 2 ** 31 + 12, 1.0,
                            ["no_exchange", "altered_band"], device="cpu")


def _fails(nums, limits):
    return [k for k in limits if nums.get(k, 0) > limits[k]]


def test_sound_run_passes(cell, got):
    assert _fails(got["sound"], cell.limits["limits"]) == []


@pytest.mark.parametrize("fault, number", [("no_exchange", "count_split"),
                                           ("altered_band",
                                            "pixel_mismatch")])
def test_fault_fails(cell, got, fault, number):
    assert number in _fails(got[fault], cell.limits["limits"])


def test_control_fails(cell, got):
    assert "pixel_mismatch" in _fails(got["control"], cell.limits["limits"])


def test_runner_takes_the_views_key(cell):
    r = harness.build(cell, 7, "cpu")
    views = r.poses(3)
    assert len(views) == 2
    assert views[1][1] - views[0][1] == pytest.approx(3.141592653589793)
    assert views[0][0] == views[1][0]


def ctx(union=True):
    spans = Spans()
    spans.frames = 10
    kernels = {
        "ncclDevKernel_AllReduce_Sum_i32_RING_LL(ncclDevKernelArgs)": 80.0,
        "Memcpy PtoP (Device -> Device)": 120.0,
        "(anonymous namespace)::raster_kernel(int const*)": 400.0}
    profile = dict(frames=4, window_us=8000.0, busy_us={0: 6000.0},
                   launches=8, kernels=kernels)
    if union:
        profile["peer_union_us"] = 98.304
    return dict(profile=profile, spans=spans, peaks=None)


@pytest.mark.parametrize("name, want", [
    ("allreduce_ms", 0.02), ("gather_ms", 0.03),
    ("gather_link_share", 100 * 3 * 360 * 1280 * 8 * 4 / 450e9 / 98.304e-6)])
def test_reader(name, want):
    assert spec.metric_reader(name)(ctx()) == pytest.approx(want)


def test_link_share_needs_peer_copies():
    assert spec.metric_reader("gather_link_share")(ctx(union=False)) is None


@pytest.mark.parametrize("name", ["views_funnel_ms", "views_dispatch_ms"])
def test_span_readers_read_the_tracer(name, monkeypatch):
    """The program's spans through ``benchmark/program.py``: on a fake
    tracer, a call's ``funnel`` spans (both views') and its
    ``views_dispatch``."""
    import numpy as np

    from benchmark import program
    from differential_projection_voxel_renderer_tpu_torch.utils import (
        profiling as P)

    class Frames:
        def __len__(self):
            return 2

        def span_ns(self, span, self_time=False):
            assert span in P.SPAN_NAMES and not self_time
            return np.array([2e6, 4e6])

    class Tracer:
        enabled = True

        def frames(self, n):
            return Frames()

    monkeypatch.setattr(program, "tracer", lambda: Tracer())
    assert spec.metric_reader(name)(ctx()) == pytest.approx(3.0)
