"""A whole run on the CPU at a tiny size, with the harness's look for a
card skipped: the result line's keys, and ``correct`` coming out false
under each planted fault and under the control."""

import json

import pytest

from benchmark import harness
from benchmark.control import readings

from benchmark.tests.tiny import tiny_cell

E2E = {"fps", "frame_p99_ms", "setup_s"}


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(cell, trace):
    import time

    r = harness.run_cell(cell, 2 ** 31 + 11, 1.0, bool(trace),
                         time.perf_counter(), device="cpu")
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
        assert not E2E & set(line["metrics"])
    else:
        assert set(line["metrics"]) == E2E
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}


@pytest.fixture(scope="module")
def got(cell):
    return readings(cell, 2 ** 31 + 12, 1.0, ["altered_pixels",
                                               "half_drawlist",
                                               "altered_mesh"],
                    device="cpu")


def _fails(nums, limits):
    return [k for k in limits if nums.get(k, 0) > limits[k]]


def test_sound_run_passes(cell, got):
    assert _fails(got["sound"], cell.limits["limits"]) == []


@pytest.mark.parametrize("fault", ["altered_pixels", "half_drawlist",
                                   "altered_mesh"])
def test_fault_fails(cell, got, fault):
    assert _fails(got[fault], cell.limits["limits"])


def test_control_fails(cell, got):
    assert "pixel_mismatch" in _fails(got["control"], cell.limits["limits"])


def test_configuration_sets_engine_attributes(cell):
    """``engine_attrs`` reach the engine; one it lacks is refused."""
    c = tiny_cell()
    c.config = dict(c.config, engine_attrs={"enable_horizon_culling": False})
    r = harness.build(c, 1, "cpu")
    r.cfg = dict(r.cfg, world=dict(r.cfg["world"], view_distance=1))
    assert r._engine().enable_horizon_culling is False
    c.config = dict(c.config, engine_attrs={"no_such_switch": True})
    with pytest.raises(AttributeError):
        harness.build(c, 1, "cpu")._engine()


@pytest.mark.parametrize("present", [
    (True,) * 6, (False,) * 6, (True, False, True, False, True, False),
    (False, False, False, True, True, True)])
def test_a_mesh_is_its_faces_each_by_one_neighbour(present):
    """The neighbour rule rests on this: the quads that face a direction
    depend only on the neighbour across it, so a mesh against any
    neighbour states is the faces of the all-present and the all-absent
    meshes taken direction by direction."""
    import numpy as np

    from benchmark.reference.frame import Reference, face_of

    ref = Reference(tiny_cell().config, "cpu")
    pos = next(p for p in ((x, 0, z) for x in range(-4, 4)
                           for z in range(-4, 4))
               if len(ref.mesh(p, (True,) * 6)) != len(ref.mesh(p, (False,)
                                                                 * 6)))
    hi, lo = ref.mesh(pos, (True,) * 6), ref.mesh(pos, (False,) * 6)
    mixed = np.concatenate([face_of(hi if here else lo, d)
                            for d, here in enumerate(present)])
    assert np.array_equal(ref.mesh(pos, present), mixed)


def test_neighbour_rule_follows_pooled_and_chooses_by_the_program():
    """A neighbour the program holds meshed is present; of another, the
    program's faces choose between the two sound meshes, and a face that
    matches neither is the reference's own (loaded now or not)."""
    import numpy as np

    from benchmark.reference.frame import Reference, face_of

    ref = Reference(tiny_cell().config, "cpu")
    pos = next(p for p in ((x, 0, z) for x in range(-4, 4)
                           for z in range(-4, 4))
               if len(ref.mesh(p, (True,) * 6)) != len(ref.mesh(p, (False,)
                                                                 * 6)))
    from benchmark.reference.mesher import NEIGHBOR_OFFSETS

    nbs = [(pos[0] + a, pos[1] + b, pos[2] + c)
           for a, b, c in NEIGHBOR_OFFSETS]
    hi, lo = ref.mesh(pos, (True,) * 6), ref.mesh(pos, (False,) * 6)
    assert np.array_equal(ref._mesh_sound(pos, set(nbs), set(), None), hi)
    assert np.array_equal(ref._mesh_sound(pos, set(), set(), None), lo)
    assert np.array_equal(ref._mesh_sound(pos, set(), set(nbs), None), hi)
    assert np.array_equal(ref._mesh_sound(pos, set(), set(),
                                          lambda p: hi), hi)
    bad = hi.copy()
    bad[0] ^= 1 << 28
    d = int((hi[0] >> 29) & 7)
    got = ref._mesh_sound(pos, set(), set(), lambda p: bad)
    assert np.array_equal(face_of(got, d), face_of(lo, d))


@pytest.mark.card
@pytest.mark.parametrize("workload", ["vd12_720p.pan"])
def test_control_fails_at_the_cells_size(card, workload):
    """On the card, at the cell's own size: a sound run passes every
    limit and the control fails the pixel comparison."""
    from benchmark import spec

    c = spec.cell(workload)
    got = readings(c, 2 ** 31 + 21, 1.0, [], device="cuda")
    assert _fails(got["sound"], c.limits["limits"]) == []
    assert "pixel_mismatch" in _fails(got["control"], c.limits["limits"])
