"""The per-layer readers on a synthetic traced run."""

import pytest

from benchmark import spec
from benchmark.trace import Spans, _span_at, breakdown


def ctx():
    spans = Spans()
    spans.frames = 10
    spans.ms.update(entry=20.0, world_update=5.0, meshing=15.0)
    spans.calls.update(entry=10, world_update=10, meshing=4)
    spans.counts.update(meshing=30)
    profile = dict(
        frames=4, window_us=8000.0, busy_us={0: 6000.0, 1: 2000.0},
        launches=8, gathered=[50000] * 4,
        kernels={"void project_cull_kernel<1>(...)": 40.0,
                 "(anonymous namespace)::raster_kernel(int const*)": 400.0,
                 "raster_packed_kernel(int const*)": 100.0},
        gaps=[(300.0, "wait"), (200.0, "entry")])
    return dict(profile=profile, spans=spans,
                peaks={"hbm_bytes_per_s": 3.35e12})


@pytest.mark.parametrize("name, want", [
    ("host_ms", 2.0), ("mesh_host_ms", 2.0), ("chunks_meshed", 3.0),
    ("kernel_launches", 2.0), ("device_busy_ms", 1.5),
    ("device_idle_share", 0.25), ("k2_ms", 0.1), ("k4_ms", 0.025),
    ("k1_roofline", 100 * 29 * 200000 / 3.35e12 / 40e-6)])
def test_reader(name, want):
    assert spec.metric_reader(name)(ctx()) == pytest.approx(want)


def test_readers_find_nothing_in_an_empty_run():
    empty = dict(profile={}, spans=None, peaks=None)
    for m in spec.benchmark_json()["per_layer"]:
        assert spec.metric_reader(m["name"])(empty) is None


def test_breakdown_and_gap_spans():
    b = breakdown(ctx()["profile"])
    assert [n for n, _ in b["device_ops"]][0].startswith("(anonymous")
    assert b["idle_gaps"][0] == ["wait", 300.0 / 1e6]
    spans = [(0.0, 10.0, "entry"), (2.0, 4.0, "meshing")]
    assert _span_at(spans, 3.0) == "meshing"
    assert _span_at(spans, 5.0) == "entry"
    assert _span_at(spans, 11.0) == "other"
