"""The native packer of a frame's upload (``native_bridge.pack_frame``,
``pack_frame`` in native/src/greedy_mesh.cpp) against its numpy twin
(rendering/pipeline.py ``_pack_frame`` after ``Renderer._prep_meta``), on
the CPU:

- the packer's words equal the twin's bit for bit, and its total equals
  ``_prep_meta``'s, written into a buffer that held other words: a draw
  list with and without a direction mask, legacy [vcap] totals, an
  empty list, a full list (``n == vcap``), a list of fewer rows than
  ``vcap`` with an odd meta, a fused insert's payload, the meta alone
  (``prepare_uploads``), inputs of other integer widths;
- a slot or a coordinate past int16 raises the twin's ValueError;
- the renderer's own packing (``Renderer._pack_into``) through the
  packer and through the twin: ``_frame_of``, ``pack_views``' rows, a
  list past the largest bucket (which takes the twin), the counters
  ``pack_native`` and ``pack_numpy``;
- frames from an engine whose renderer takes the packer equal those of
  one that takes the twin, and the benchmark's reader
  ``native_pack_share`` on the tracer's frames.

The renderer takes the packer on every device (on the CPU its buffers
are new arrays, not the pinned ring); these tests take the twin from it
(``Renderer._packer`` None) for the comparison.  Skips where the native
library cannot be built."""

import math
import types

import numpy as np
import pytest
import torch

from benchmark.metrics import native_pack_share
from benchmark.trace import Spans
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.meshing import (
    native_bridge,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)
from differential_projection_voxel_renderer_tpu_torch.utils import (
    profiling as P,
)
from differential_projection_voxel_renderer_tpu_torch.utils.config import (
    RenderConfig,
)

pytestmark = pytest.mark.skipif(
    native_bridge.pack_frame is None,
    reason="the native library cannot be built here: no packer")

CPU = torch.device("cpu")
PITCH = -0.12435499454676144
SMALL = dict(width=128, height=64, gather_cap=16384, quads_cap=8192,
             tile_k_cap=16384)


def _renderer(vcap=64, packer=True):
    r = TPL.Renderer(RenderConfig(**SMALL, visible_chunks_cap=vcap),
                     device="cpu")
    assert r._packer is native_bridge.pack_frame
    if not packer:
        r._packer = None
    return r


def _list(rng, vcap, n, fill=60):
    """A funnel's draw list: ``n`` live rows padded to ``vcap`` (slots 0,
    counts 0, masks 1, positions 0)."""
    slots = np.zeros(vcap, np.int32)
    counts6 = np.zeros((vcap, 6), np.int32)
    mask6 = np.ones((vcap, 6), np.int32)
    positions = np.zeros((vcap, 3), np.int32)
    slots[:n] = rng.integers(0, 32768, n)
    counts6[:n] = rng.integers(0, fill, (n, 6))
    mask6[:n] = rng.integers(0, 2, (n, 6))
    positions[:n] = rng.integers(-32767, 32768, (n, 3))
    return slots, counts6, mask6, positions


def _camera(rng):
    return (rng.normal(size=(4, 4)).astype(np.float32),
            rng.normal(size=3).astype(np.float32))


def _twin(vcap, slots, counts, mask, positions, vp, cp, payload):
    """The twin's upload and total (``_prep_meta`` normalizes, then
    ``_pack_frame`` packs)."""
    r = _renderer(vcap, packer=False)
    slots_a, c6, m6, pos_a, _, total = r._prep_meta(slots, counts,
                                                    positions, mask)
    return TPL._pack_frame(vcap, slots_a, c6, m6, pos_a, vp, cp,
                           payload), total


def _case(name, rng):
    """(vcap, slots, counts, dir_mask, positions, view_proj, cam_pos,
    payload) of each case."""
    vcap = 64
    slots, counts6, mask6, positions = _list(rng, vcap, 40)
    vp, cp = _camera(rng)
    if name == "masked":
        return vcap, slots, counts6, mask6, positions, vp, cp, None
    if name == "no_mask":
        return vcap, slots, counts6, None, positions, vp, cp, None
    if name == "legacy_totals":
        return vcap, slots, counts6.sum(1), None, positions, vp, cp, None
    if name == "legacy_totals_masked":
        return vcap, slots, counts6.sum(1), mask6, positions, vp, cp, None
    if name == "empty":
        s, c, m, p = _list(rng, vcap, 0)
        return vcap, s, c, m, p, vp, cp, None
    if name == "full":
        s, c, m, p = _list(rng, vcap, vcap)
        return vcap, s, c, m, p, vp, cp, None
    if name == "short_rows_odd_meta":
        # rows under vcap, and 11 * 63 shorts: a zero pad short
        return 63, slots[:40], counts6[:40], mask6[:40], positions[:40], \
            vp, cp, None
    if name == "insert_payload":
        ins = rng.integers(0, 2**32, 3 * 16 + 8192, dtype=np.uint64)
        return (vcap, slots, counts6, mask6, positions, vp, cp,
                ins.astype(np.uint32))
    if name == "meta_only":
        return vcap, slots, counts6, mask6, positions, None, None, None
    if name == "int64_inputs":
        return (vcap, slots.astype(np.int64), counts6.astype(np.int64),
                mask6.astype(np.int64), positions.astype(np.int64),
                vp.astype(np.float64), cp.astype(np.float64), None)
    raise KeyError(name)


CASES = ["masked", "no_mask", "legacy_totals", "legacy_totals_masked",
         "empty", "full", "short_rows_odd_meta", "insert_payload",
         "meta_only", "int64_inputs"]


@pytest.mark.parametrize("case", CASES)
def test_packer_equals_its_numpy_twin(case):
    rng = np.random.default_rng(CASES.index(case) + 17)
    vcap, slots, counts, mask, positions, vp, cp, payload = _case(case, rng)
    want, want_total = _twin(vcap, slots, counts, mask, positions, vp, cp,
                             payload)
    assert want.size == TPL._frame_words(vcap, vp is not None, payload)
    # a buffer that held other words, one longer than the upload
    out = rng.integers(-2**31, 2**31, want.size + 1).astype(np.int32)
    tail = out[-1]
    total = native_bridge.pack_frame(out, vcap, slots, counts, mask,
                                     positions, vp, cp, payload)
    assert total == want_total
    assert np.array_equal(out[:-1], want)
    assert out[-1] == tail
    if case == "empty":
        assert total == 0
    if case == "full":
        assert total == int((counts * mask).sum()) > 0


@pytest.mark.parametrize("where,value", [
    ("slot", 32768), ("slot", 2**31 - 1), ("position", 32768),
    ("position", -32768), ("position", -2**31 + 1)])
def test_past_int16_raises_the_twins_error(where, value):
    rng = np.random.default_rng(5)
    slots, counts6, mask6, positions = _list(rng, 16, 9)
    if where == "slot":
        slots[8] = value
    else:
        positions[3, 2] = value
    r = _renderer(16, packer=False)
    with pytest.raises(ValueError) as twin:
        r._prep_meta(slots, counts6, positions, mask6)
    out = np.zeros(TPL._frame_words(16), np.int32)
    with pytest.raises(ValueError) as native:
        native_bridge.pack_frame(out, 16, slots, counts6, mask6, positions,
                                 np.eye(4, dtype=np.float32),
                                 np.zeros(3, np.float32))
    assert str(native.value) == str(twin.value)


def test_packer_refuses_shapes_it_cannot_hold():
    rng = np.random.default_rng(6)
    slots, counts6, mask6, positions = _list(rng, 16, 9)
    out = np.zeros(TPL._frame_words(16), np.int32)
    with pytest.raises(ValueError):  # more rows than vcap
        native_bridge.pack_frame(out, 8, slots, counts6, mask6, positions)
    with pytest.raises(ValueError):  # a mask of other rows
        native_bridge.pack_frame(out, 16, slots, counts6, mask6[:4],
                                 positions)
    with pytest.raises(ValueError):  # an upload longer than the buffer
        native_bridge.pack_frame(out[:-1], 16, slots, counts6, mask6,
                                 positions, np.eye(4, dtype=np.float32),
                                 np.zeros(3, np.float32))


def _counts():
    f = P.TRACER.frames(1)
    return int(f.count("pack_native")[0]), int(f.count("pack_numpy")[0])


@pytest.mark.parametrize("entry", ["frame", "insert", "views", "past_cap"])
def test_renderer_packs_as_its_twin(entry):
    """The renderer's uploads through the packer and through the twin:
    the same words, bucket and total, and one count a view of
    ``pack_native`` (or, past the largest bucket, ``pack_numpy``)."""
    rng = np.random.default_rng(["frame", "insert", "views",
                                 "past_cap"].index(entry))
    vcap = 64
    lists = [_list(rng, vcap, 40) for _ in range(2)]
    cams = [_camera(rng) for _ in range(2)]
    ins = (rng.integers(0, 2**32, 3 * 16 + 8192, dtype=np.uint64).astype(
        np.uint32) if entry == "insert" else None)
    if entry == "past_cap":
        # over the largest bucket: the suffix units lose quads
        lists[0][1][:40] = rng.integers(400, 800, (40, 6))
    got = {}
    for packer in (True, False):
        r = _renderer(vcap, packer=packer)
        assert r.gather_buckets[-1] < 40 * 6 * 400 or entry != "past_cap"
        P.TRACER.reset()
        with P.FRAME(CPU):
            if entry == "views":
                views = [(TE.DrawList(s, c, m, p, 40), vp, cp)
                         for (s, c, m, p), (vp, cp) in zip(lists, cams)]
                up, cap, total = r.pack_views(views)
            else:
                s, c, m, p = lists[0]
                up, cap, total = r._frame_of(s, c, p, m, *cams[0], ins)
        got[packer] = (np.array(up), cap, total, _counts())
    (a, cap_a, tot_a, n_a), (b, cap_b, tot_b, n_b) = got[True], got[False]
    assert np.array_equal(a, b) and cap_a == cap_b and tot_a == tot_b
    views = 2 if entry == "views" else 1
    assert n_b == (0, views)
    assert n_a == ((0, 1) if entry == "past_cap" else (views, 0))
    if entry == "past_cap":
        assert tot_a == cap_a == r.gather_buckets[-1]


def _engine(packer):
    eng = TE.Engine(TE.RenderConfig(**SMALL),
                    TE.WorldConfig(view_distance=2, frustum_culling=True,
                                   max_chunks_per_frame=4),
                    pool_slots=512, device="cpu")
    if not packer:
        eng.renderer._packer = None
    eng.camera.position = np.array((0.0, 24.0, 20.0), np.float32)
    eng.camera.pitch = PITCH
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    return eng


def test_engine_frames_equal_from_either_packer():
    """Two engines through the same flight (fused frames as the list
    changes, the expansion and static frames where it holds, fused
    inserts as chunks stream in), one packing natively, one through the
    twin: the frames and stats equal, and each frame counts its packing
    on its own counter."""
    got = {}
    for packer in (True, False):
        eng = _engine(packer)
        P.TRACER.reset()
        frames = []
        for k in range(24):
            eng.camera.position = np.array(
                (3.0 * (k // 2), 24.0, 20.0 - 3.0 * (k // 2)), np.float32)
            eng.camera.yaw = 0.4 + 0.02 * (k // 3)
            r = eng.render_frame(dt=0.016)
            frames.append((r.color.clone(), r.depth.clone(), r.stats.clone()))
        f = P.TRACER.frames(24)
        nat, twin = f.count("pack_native"), f.count("pack_numpy")
        # a fused frame packs its draw list, a settled list its meta once
        # for the expansion, and a static frame no draw list
        assert (nat + twin).sum() >= 6
        assert not (twin if packer else nat).any()
        got[packer] = frames
    for a, b in zip(got[True], got[False]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_native_pack_share_reader():
    """The benchmark's reader on the tracer: the native uploads over all
    the uploads of the window's frames."""
    eng = _engine(True)
    P.TRACER.reset()
    for k in range(6):
        eng.camera.yaw = 0.3 + 0.01 * k
        eng.render_frame(dt=0.016)
    eng.renderer._packer = None
    for k in range(2):
        eng.camera.yaw = 1.0 + 0.01 * k
        eng.render_frame(dt=0.016)
    f = P.TRACER.frames(8)
    native = float(f.count("pack_native").sum())
    numpy_ = float(f.count("pack_numpy").sum())
    assert native > 0 and numpy_ > 0
    spans = Spans()
    spans.frames = 8
    ctx = dict(profile={"frames": 0}, spans=spans, peaks=None)
    assert math.isclose(native_pack_share.read(ctx),
                        native / (native + numpy_))
    spans.frames = 2
    assert native_pack_share.read(ctx) == 0.0
    # a program without the counters reads nothing
    fake = types.SimpleNamespace(COUNTER_NAMES=("chunks_meshed",
                                                "funnel_native"))
    real = native_pack_share.importlib.import_module
    try:
        native_pack_share.importlib.import_module = lambda name: fake
        assert native_pack_share.read(ctx) is None
    finally:
        native_pack_share.importlib.import_module = real
