"""The port's CUDA kernels against their plain PyTorch twins on the card.

Needs an NVIDIA GPU with nvcc (every test is marked ``cuda`` and skips
without a card) and no JAX, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.)  Kernel and twin run
on the same card, on the same tensors, and must agree bit for bit.  The
tests marked ``multicard`` also need two or more cards (they skip with
fewer; ``-m multicard`` runs them alone): every kernel on every card from
card 0's thread against card 0, K4 on the cards after card 0, the
launch counts under threads that drive several cards, and the sharded
batch on the cards (each card's step from its CUDA graph) against the
same batch on one card, all bit for bit.
The file imports nothing of the JAX package.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import _torch_streams as TS
from differential_projection_voxel_renderer_tpu_torch import _build
from differential_projection_voxel_renderer_tpu_torch import graft_entry
from differential_projection_voxel_renderer_tpu_torch.benches import (
    common as bench_common,
    micro_fixed,
    micro_fixed2,
    micro_fixed3,
    multicard,
)
from differential_projection_voxel_renderer_tpu_torch.models.camera import (
    Camera,
)
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.ops import hiz
from differential_projection_voxel_renderer_tpu_torch.ops import micro
from differential_projection_voxel_renderer_tpu_torch.ops import projection
from differential_projection_voxel_renderer_tpu_torch.ops import raster
from differential_projection_voxel_renderer_tpu_torch.ops import raster_packed
from differential_projection_voxel_renderer_tpu_torch.parallel import (
    sharded_render,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import graphs
from differential_projection_voxel_renderer_tpu_torch.rendering import parity
from differential_projection_voxel_renderer_tpu_torch.rendering import pipeline

CAMERAS = {
    "above": ([16.0, 48.0, 16.0], [16.0, 8.0, 16.0]),
    "inside": ([5.0, 5.0, 5.0], [40.0, 0.0, 20.0]),
    "far": ([10.0, 60.0, 90.0], [0.0, 0.0, 0.0]),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _fuzz_stream(n, seed=1234, max_size=64):
    """Random quad words (sizes 1..max_size) and chunk origins."""
    rng = np.random.default_rng(seed)
    u, v, w, h, blk, sl, face = (rng.integers(0, hi, n) for hi in
                                 (32, 32, max_size, max_size, 4, 32, 6))
    words = (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22) | (sl << 24)
             | (face << 29)).astype(np.uint32)
    qw = (rng.integers(-2, 2, (3, n)) * 32).astype(np.float32)
    return projection.as_quad_words(words), torch.from_numpy(qw)


def _same_geometry(got, want):
    """Stage A's five outputs bit for bit and its two counts."""
    for k in ("valid", "bbx", "bby", "subpixel", "subpix_total",
              "valid_count"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    a, b = got["depth_near"], want["depth_near"]
    assert bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _camera_args(name, device, aspect=2.0):
    pos, tgt = CAMERAS[name]
    c = Camera(np.asarray(pos, np.float32), aspect)
    c.look_at(np.asarray(tgt, np.float32))
    return (torch.from_numpy(c.view_projection_matrix()).to(device),
            torch.from_numpy(c.position.copy()).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_project_cull_kernel_matches_twin(cuda_device, cam):
    words, qw = _fuzz_stream(8192)
    pos, tgt = CAMERAS[cam]
    c = Camera(np.asarray(pos, np.float32), 2.0)
    c.look_at(np.asarray(tgt, np.float32))
    args = (words.to(cuda_device), qw.to(cuda_device),
            torch.tensor(7000, dtype=torch.int32, device=cuda_device),
            torch.from_numpy(c.view_projection_matrix()).to(cuda_device),
            torch.from_numpy(c.position.copy()).to(cuda_device))
    before = geometry.launches
    got = geometry.project_cull(*args, width=256, height=128)
    assert geometry.launches == before + 1
    ref = geometry.project_cull_plain(*args, width=256, height=128)
    _same_geometry(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cam", sorted(parity.STRADDLE_CAMERAS))
def test_project_cull_kernel_bounds_straddling_quads(cuda_device, cam):
    """K1 against its twin on the terrain patch seen from among its chunks,
    where quads straddle the near plane: every output bit for bit, and more
    than three quarters of the visible straddlers get a box smaller than
    the screen (K1's straddle_bounded, the twin's ``bounded``)."""
    args, kw = parity.small_scene("terrain 640x128", cuda_device)
    w, h = kw["width"], kw["height"]
    pos, tgt = parity.STRADDLE_CAMERAS[cam]
    c = Camera(np.asarray(pos, np.float32), w / h)
    c.look_at(np.asarray(tgt, np.float32))
    args = (*args[:3],
            torch.from_numpy(c.view_projection_matrix()).to(cuda_device),
            torch.from_numpy(c.position.copy()).to(cuda_device))
    before = geometry.launches
    got = geometry.project_cull(*args, width=w, height=h)
    assert geometry.launches == before + 1
    _same_geometry(got, geometry.project_cull_plain(*args, width=w,
                                                    height=h))
    in_stream = torch.arange(args[0].shape[0], device=cuda_device) < args[2]
    behind = projection.project_and_cull(args[0], tuple(args[1]), in_stream,
                                         *args[3:], width=w,
                                         height=h)["any_behind"]
    straddles = behind & got["valid"]
    area = (((got["bbx"] >> 16) - (got["bbx"] & 0xFFFF) + 1)
            * ((got["bby"] >> 16) - (got["bby"] & 0xFFFF) + 1))
    n, bounded = int(straddles.sum()), int((straddles & (area < w * h)).sum())
    assert 4 * bounded > 3 * n > 3 * 20


@pytest.mark.cuda
@pytest.mark.parametrize("backface", [True, False])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_project_cull_span_kernel_matches_twin(cuda_device, cam, backface):
    """K1's span instance (flag kSpan): the five outputs, both counts and
    the NDC box bit for bit, on odd lengths and with a skip too."""
    words, qw = _fuzz_stream(8191, seed=99)
    vp, cp = _camera_args(cam, cuda_device)
    kw = dict(width=256, height=128, backface_culling=backface,
              span_mode=True)
    for n, skip in ((8191, 0), (7000, 1500)):
        args = (words[:n].to(cuda_device), qw[:, :n].contiguous().to(
            cuda_device), n - 100, vp, cp)
        before = geometry.launches
        got = geometry.project_cull(*args, skip_quads=skip, **kw)
        assert geometry.launches == before + 1
        ref = geometry.project_cull_plain(*args, skip_quads=skip, **kw)
        _same_geometry(got, ref)
        assert got["ndc"].shape == (4, n)
        assert torch.equal(got["ndc"].view(torch.int32),
                           ref["ndc"].view(torch.int32))
        assert int(got["subpix_total"]) == 0 and int(got["valid_count"]) > 50


@pytest.mark.cuda
def test_project_cull_kernel_skip_matches_twin(cuda_device):
    """The kernel's skip argument, as a Python int and as a device scalar."""
    words, qw = _fuzz_stream(8192)
    c = Camera(np.asarray(CAMERAS["above"][0], np.float32), 2.0)
    c.look_at(np.asarray(CAMERAS["above"][1], np.float32))
    args = (words.to(cuda_device), qw.to(cuda_device), 7000,
            torch.from_numpy(c.view_projection_matrix()).to(cuda_device),
            torch.from_numpy(c.position.copy()).to(cuda_device))
    kw = dict(width=256, height=128)
    full = geometry.project_cull(*args, **kw)["valid"]
    for skip in (3000, torch.tensor(3000, dtype=torch.int32,
                                    device=cuda_device)):
        got = geometry.project_cull(*args, skip_quads=skip, **kw)
        ref = geometry.project_cull_plain(*args, skip_quads=skip, **kw)
        _same_geometry(got, ref)
        assert not bool(got["valid"][:3000].any())
        assert torch.equal(got["valid"][3000:], full[3000:])
    assert bool(full[:3000].any())


@pytest.mark.cuda
def test_project_cull_kernel_without_subpixel_culling(cuda_device):
    """``subpixel_culling=False`` on a stream of 1x1 quads seen from afar:
    the kernel equals its twin, counts included, and keeps as valid the
    quads that the default culls as sub-pixel."""
    words, qw = _fuzz_stream(8192, seed=7, max_size=1)
    args = (words.to(cuda_device), qw.to(cuda_device),
            torch.tensor(7000, dtype=torch.int32, device=cuda_device),
            *_camera_args("far", cuda_device))
    kw = dict(width=256, height=128)
    culled = geometry.project_cull(*args, **kw)
    assert int(culled["subpix_total"]) > 0
    got = geometry.project_cull(*args, subpixel_culling=False, **kw)
    _same_geometry(got, geometry.project_cull_plain(
        *args, subpixel_culling=False, **kw))
    assert int(got["subpix_total"]) == 0
    assert torch.equal(got["valid"],
                       culled["valid"] | (culled["subpixel"] != 0))


@pytest.mark.cuda
@pytest.mark.parametrize("qpt", [1, 2, 4])
@pytest.mark.parametrize("gq,offset", [(8192, 0), (8190, 0), (8193, 0),
                                       (8192, 1)])
def test_project_cull_kernel_any_length(cuda_device, monkeypatch, qpt, gq,
                                        offset):
    """K1 at one, two and four quads a thread, on lengths that are not a
    multiple of a block, nor of 2 or 4 (the kernel's groups), and on a
    stream of words that starts off a 16-byte boundary (the quads then go
    one by one): equal to the twin, counts included; every call returns a
    fresh buffer."""
    monkeypatch.setattr(geometry, "QUADS_PER_THREAD", qpt)
    words, qw = _fuzz_stream(gq + offset, seed=gq)
    quads = words.to(cuda_device)[offset:]
    assert quads.data_ptr() % 16 == 4 * offset
    args = (quads, qw[:, offset:].contiguous().to(cuda_device),
            torch.tensor(gq - 5, dtype=torch.int32, device=cuda_device),
            *_camera_args("above", cuda_device))
    kw = dict(width=256, height=128)
    got = geometry.project_cull(*args, **kw)
    _same_geometry(got, geometry.project_cull_plain(*args, **kw))
    again = geometry.project_cull(*args, **kw)
    assert again["bbx"].data_ptr() != got["bbx"].data_ptr()
    _same_geometry(again, got)


@pytest.mark.cuda
def test_project_cull_kernel_counts_on_two_streams(cuda_device):
    """Launches on two streams at once: each launch's counts are its own
    (each zeroes its own slots and adds to them alone)."""
    kw = dict(width=256, height=128)
    calls = []
    for seed, cam in ((1, "above"), (2, "far")):
        words, qw = _fuzz_stream(65536, seed=seed)
        calls.append((words.to(cuda_device), qw.to(cuda_device),
                      torch.tensor(60000, dtype=torch.int32,
                                   device=cuda_device),
                      *_camera_args(cam, cuda_device)))
    refs = [geometry.project_cull_plain(*a, **kw) for a in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[j].append(geometry.project_cull(*calls[j], **kw))
    torch.cuda.synchronize()
    for j in range(2):
        for got in outs[j]:
            _same_geometry(got, refs[j])


@pytest.mark.cuda
def test_project_cull_kernel_keeps_its_budget(cuda_device):
    """K1 builds without spills at one, two and four quads a thread and in
    its span instance."""
    _, log = _build.build(force=True, verbose=True)
    reps = {name: r for name, r in _build.ptxas_report(log).items()
            if "19project_cull_kernel" in name}
    assert len(reps) == 4, reps
    assert sum("ILi1ELb1E" in name for name in reps) == 1, list(reps)
    reps = list(reps.values())
    for rep in reps:
        assert rep["spill_stores"] == 0 and rep["spill_loads"] == 0, rep


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_raster_kernel_matches_twin(cuda_device, name):
    args, kw = parity.small_scene(name, cuda_device)
    rec = pipeline.render_step(*args, debug_return_records=True, **kw)
    rkw = dict(height=kw["height"], width=kw["width"], tile_h=16,
               tile_w=128, out_h=kw["height"])
    before = raster.launches
    c1, d1 = raster.rasterize_tiles(*rec, **rkw)
    assert raster.launches == before + 1
    c2, d2 = raster.rasterize_tiles_plain(*rec, **rkw)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_render_step_on_card_matches_cpu(cuda_device, name):
    """The whole step on the card (kernels) vs on the CPU (twins)."""
    gargs, gkw = parity.small_scene(name, cuda_device)
    cargs, ckw = parity.small_scene(name, "cpu")
    c1, d1, s1 = pipeline.render_step(*gargs, **gkw)
    c2, d2, s2 = pipeline.render_step(*cargs, **ckw)
    assert torch.equal(s1.cpu(), s2)
    rec = pipeline.render_step(*cargs, debug_return_records=True, **ckw)
    parity.frame_parity(c1.cpu().numpy(), d1.cpu().numpy(), c2.numpy(),
                        d2.numpy(), rec[0].numpy())


def _meta_inputs(args, kw):
    """The inputs render_step hands ``raster.tile_metadata`` (its stage
    5), the step stopped there."""
    return bench_common.meta_inputs(lambda: pipeline.render_step(*args, **kw))


def _meta_case(case, device):
    """tile_metadata's inputs for ``case``: a small scene's step, its span
    step and a row band of it; a fuzz stream of the vd12 caps at 1280x720
    (gather 131072, render cap 65536, items 131072); a hand-built stream
    (tests/_torch_streams.py tile_meta_stream) with a tile of 5000 items,
    empty tiles, octets across tiles and 131067 kept items."""
    if case in parity.SMALL_SCENES:
        return _meta_inputs(*parity.small_scene(case, device))
    if case == "constructed":
        ins, kw = TS.tile_meta_stream(3, 45, 10, 65536, 131072, 5000)
        return tuple(x.to(device) for x in ins), kw
    args, kw = parity.small_scene("terrain 640x128", device)
    if case == "span":
        return _meta_inputs(args, dict(kw, span_mode=True))
    if case == "band":
        return _meta_inputs(args,
                            dict(kw, band_y0=40, band_h=50))
    assert case == "vd12 720p"
    words, qw = _fuzz_stream(131072, seed=19, max_size=8)
    vp, cp = _camera_args("far", device, aspect=16 / 9)
    n = torch.tensor(120000, dtype=torch.int32, device=device)
    return _meta_inputs(
        (words.to(device), qw.to(device), n, vp, cp),
        dict(kw, width=1280, height=720, render_cap=65536,
             tile_k_cap=131072))


META_CASES = sorted(parity.SMALL_SCENES) + ["band", "constructed", "span",
                                            "vd12 720p"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", META_CASES)
def test_tile_meta_kernel_matches_twin(cuda_device, case):
    """The tile_meta kernel against tile_metadata_plain on the same card
    and inputs: records, octet rows and octet_zmin (as int32) bit for bit,
    the unused slots past the kept items included; one launch counted."""
    a, kw = _meta_case(case, cuda_device)
    starts, counts = a[3], a[4]
    n_kept = int(starts[-1] + counts[-1])
    assert 0 < n_kept and int(counts.max()) > 8
    before = raster.launches_meta
    got = raster.tile_metadata(*a, **kw)
    torch.cuda.synchronize()
    assert raster.launches_meta == before + 1
    want = raster.tile_metadata_plain(*a, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))


@pytest.mark.cuda
def test_tile_meta_kernel_refuses_what_it_does_not_take(cuda_device):
    ins, kw = TS.tile_meta_stream(3, 4, 5, 256, 1024)
    ins = [x.to(cuda_device) for x in ins]
    bad = {"odd items": (ins[0], ins[1][:-4], ins[2][:-4], *ins[3:]),
           "int64": (ins[0].long(), *ins[1:]),
           "strided": (ins[0][:, ::2], *ins[1:]),
           "21 rows": (ins[0][:21], *ins[1:]),
           "on the CPU": (ins[0], ins[1].cpu(), *ins[2:]),
           "tiles": (*ins[:3], ins[3][:-1], ins[4][:-1])}
    for name, b in bad.items():
        with pytest.raises(ValueError):
            raster.tile_metadata(*b, **kw)


def _resident_append_frame(device):
    """A resident streaming frame on ``device``: the fuzz chunk's stream,
    the mono fuzz chunk scattered, appended and rendered in one step
    (Renderer.render_prepared_append_insert) at 640x128.  Returns the
    frame, the appended stream and the pool, on the CPU."""
    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        QuadPool,
    )
    from differential_projection_voxel_renderer_tpu_torch.meshing.greedy \
        import mesh_chunk

    r = pipeline.Renderer(pipeline.RenderConfig(
        width=640, height=128, gather_cap=16384, quads_cap=8192,
        tile_k_cap=2048), device=device)
    pool = QuadPool(slots=64, qcap=4096, device=device)
    pool.insert_many([((0, 0, 0), mesh_chunk(parity.fuzz_chunk()))])
    vcap = r.config.visible_chunks_cap
    vs, cs = np.zeros(vcap, np.int32), np.zeros((vcap, 6), np.int32)
    cs[0] = pool.counts6[0]
    stream = r.prepare_uploads(pool.quads, vs, cs,
                               np.zeros((vcap, 3), np.int32))
    quads_b = mesh_chunk(parity.fuzz_chunk_mono(43))
    payload = pool.prepare_insert_payload(
        [((1, 0, 0), quads_b)], kp=pipeline.RESIDENT_INSERT_KP,
        mc=pipeline.RESIDENT_INSERT_MC, fp=pipeline.RESIDENT_INSERT_FP)
    slot = pool.by_pos[(1, 0, 0)]
    ameta = pipeline.pack_append_meta(np.array([slot], np.int32),
                                      pool.counts6[[slot]],
                                      pool.positions[[slot]])
    offset = int(stream[2])
    cam = Camera(np.array([32.0, 44.0, 56.0], np.float32), 5.0)
    cam.look_at(np.array([32.0, 8.0, 16.0], np.float32))
    color, depth, stats, (q2, w2) = r.render_prepared_append_insert(
        (stream[0], stream[1], np.int32(offset + len(quads_b))),
        cam.view_projection_matrix(), cam.position, pool.quads, ameta,
        offset, payload)
    return [t.cpu() for t in (color, depth, stats, q2, w2, pool.quads)]


@pytest.mark.cuda
def test_resident_append_frame_matches_plain(cuda_device):
    """A resident append frame with its fused scatter through K1 and K2 on
    the card against the same step on the CPU (their plain versions): the
    appended stream and the pool bit for bit, stats
    equal, the frame exact; and the resident self-test on the card."""
    before = (geometry.launches, raster.launches)
    got = _resident_append_frame(cuda_device)
    assert (geometry.launches, raster.launches) == (before[0] + 1,
                                                    before[1] + 1)
    ref = _resident_append_frame(torch.device("cpu"))
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(a, b)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))
    assert parity.run_resident_append_selftest(device="cuda") == "exact"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_raster_geom_kernel_matches_plain(cuda_device, name):
    """K3 (the raster with the next frame's stage A) against its plain
    version, K2's twin and K1's twin, and against the K2 and K1 kernels: a
    fuzzed next stream and the scene's own stream, bit for bit."""
    args, kw = parity.small_scene(name, cuda_device)
    h, w = kw["height"], kw["width"]
    rec = pipeline.render_step(*args, debug_return_records=True, **kw)
    rkw = dict(height=h, width=w, tile_h=16, tile_w=128, out_h=h)
    words, qw = _fuzz_stream(8192)
    c = Camera(np.asarray(CAMERAS["far"][0], np.float32), w / h)
    c.look_at(np.asarray(CAMERAS["far"][1], np.float32))
    fuzz = (words.to(cuda_device), qw.to(cuda_device),
            torch.tensor(7000, dtype=torch.int32, device=cuda_device),
            torch.from_numpy(c.view_projection_matrix()).to(cuda_device),
            torch.from_numpy(c.position.copy()).to(cuda_device))
    c2, d2 = raster.rasterize_tiles_plain(*rec, **rkw)
    c3, d3 = raster.rasterize_tiles(*rec, **rkw)
    assert torch.equal(c2, c3) and torch.equal(d2, d3)
    for nxt in (fuzz, args):
        before = (raster.launches_geom, raster.launches, geometry.launches)
        c1, d1, g1 = raster.rasterize_tiles(*rec, next_geom=nxt, **rkw)
        assert (raster.launches_geom, raster.launches,
                geometry.launches) == (before[0] + 1,) + before[1:]
        assert torch.equal(c1, c2) and torch.equal(d1, d2)
        _same_geometry(g1, geometry.project_cull_plain(*nxt, width=w,
                                                       height=h))
        _same_geometry(g1, geometry.project_cull(*nxt, width=w, height=h))
        assert bool(g1["valid"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_packed_kernel_matches_twin(cuda_device, name):
    """K4 against its plain version on the port's packed records."""
    args, kw = parity.small_scene(name, cuda_device)
    rec = pipeline.render_step(*args, packed_raster=True,
                               debug_return_records=True, **kw)
    rkw = dict(height=kw["height"], width=kw["width"])
    before = raster_packed.launches
    c1, d1 = raster_packed.rasterize_packed(*rec, **rkw)
    assert raster_packed.launches == before + 1
    c2, d2 = raster_packed.rasterize_packed_plain(*rec[:5], **rkw)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert int(rec[2].view(-1, 5)[:, 1:].sum()) > 0  # buckets were walked


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_packed_step_on_card_matches_cpu(cuda_device, name):
    """The packed step on the card (K1, K4) vs on the CPU (twins), and
    against the default step on the card."""
    gargs, gkw = parity.small_scene(name, cuda_device)
    cargs, ckw = parity.small_scene(name, "cpu")
    c1, d1, s1 = pipeline.render_step(*gargs, packed_raster=True, **gkw)
    c2, d2, s2 = pipeline.render_step(*cargs, packed_raster=True, **ckw)
    assert torch.equal(s1.cpu(), s2)
    rec = pipeline.render_step(*cargs, packed_raster=True,
                               debug_return_records=True, **ckw)
    parity.frame_parity(c1.cpu().numpy(), d1.cpu().numpy(), c2.numpy(),
                        d2.numpy(), rec[0].numpy())
    c0, d0, _ = pipeline.render_step(*gargs, **gkw)
    assert torch.equal(c1, c0) and torch.equal(d1, d0)



def _same_bits(a, b):
    """(colour, depth) pairs equal bit for bit (depth signs included)."""
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_packed_kernel_long_bucket_matches_twin(cuda_device, seed):
    """K4 on a tile whose last bucket holds 1100 items and whose other
    buckets are near empty (the case its bucket phase spreads over all
    eight warps), with ties on signed zeros, bit for bit."""
    args, kw = TS.long_bucket_stream(seed)
    args = [a.to(cuda_device) for a in args]
    before = raster_packed.launches
    got = raster_packed.rasterize_packed(*args, **kw)
    assert raster_packed.launches == before + 1
    ref = raster_packed.rasterize_packed_plain(*args[:5], **kw)
    assert _same_bits(got, ref)
    zero = ref[1] == 0
    assert bool((zero & (ref[1].view(torch.int32) < 0)).any())
    assert bool((zero & (ref[1].view(torch.int32) == 0)).any())


@pytest.mark.cuda
def test_raster_kernel_breaks_at_octet_base(cuda_device):
    """K2's occlusion break fires at an octet base that is not a multiple
    of 128: on a stream whose octet_zmin claims the break there while the
    items after it would win pixels, the kernel equals its plain version
    on the segment cut at that base, and neither on the full segment nor
    on the segment cut one octet earlier."""
    args, kw, brk, start = TS.octet_break_stream()
    args = [a.to(cuda_device) for a in args]
    assert brk % 128 and brk % 8 == 0

    def twin(end):
        counts = args[2].clone()
        counts[1] = end - start
        return raster.rasterize_tiles_plain(args[0], args[1], counts,
                                            *args[3:], **kw)

    got = raster.rasterize_tiles(*args, **kw)
    assert _same_bits(got, twin(brk))
    assert not _same_bits(got, twin(brk - 8))
    assert not _same_bits(got, twin(start + int(args[2][1])))


def _init_frame(shape, seed, device):
    """Random colours; depths in [0.95, 1) with a fifth +inf."""
    g = torch.Generator().manual_seed(seed)
    color = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                          dtype=torch.int32)
    depth = 0.95 + 0.05 * torch.rand(shape, generator=g)
    depth[torch.rand(shape, generator=g) < 0.2] = float("inf")
    return color.to(device), depth.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wall near pass", "random init",
                                  "band", "band with init"])
def test_raster_kernel_init_and_band_match_twin(cuda_device, case):
    """K2 with an init frame (the two-pass far pass on the wall scene's
    near frame, or a random frame) and with y0_px on a row band (72 rows
    in an 80-row buffer) equals its plain version bit for bit on the rows
    the step keeps."""
    if case == "wall near pass":
        args, kw = parity.wall_scene(cuda_device)
        n_near = 16
        c1, d1, _ = pipeline.render_step(*args[:2], n_near, *args[3:], **kw)
        hiz1 = hiz.build_max_pyramid(d1)
        rec = pipeline.render_step(*args, skip_quads=n_near, hiz_level1=hiz1,
                                   debug_return_records=True, **kw)
        y0, bh, init = 0, 128, (c1, d1)
    else:
        args, kw = parity.small_scene("terrain 640x128", cuda_device)
        band = "band" in case
        y0, bh = (48, 72) if band else (0, 128)
        rec = pipeline.render_step(
            *args, debug_return_records=True,
            **dict(kw, **(dict(band_y0=y0, band_h=bh) if band else {})))
        init = (_init_frame((80 if band else 128, kw["width"]), 5,
                            cuda_device) if "init" in case else (None, None))
    out_h = -bh % 16 + bh
    rkw = dict(height=kw["height"], width=kw["width"], tile_h=16,
               tile_w=128, out_h=out_h, init_color=init[0],
               init_depth=init[1], y0_px=y0)
    before = raster.launches
    got = raster.rasterize_tiles(*rec, **rkw)
    assert raster.launches == before + 1
    want = raster.rasterize_tiles_plain(*rec, **rkw)
    # the rows the step keeps: in the padded rows of a band the twin (like
    # the reference's kernel) evaluates an item on its octet's rows, K2 on
    # its own box clamped to the band, and the step crops them.  K2 leaves
    # the padded rows as they started.
    if out_h > bh:
        start = (init if init[0] is not None else (
            torch.full_like(got[0], raster.SKY_I32),
            torch.full_like(got[1], float("inf"))))
        assert _same_bits(tuple(x[bh:] for x in got),
                          tuple(x[bh:] for x in start))
    got, want = (tuple(x[:bh] for x in f) for f in (got, want))
    assert _same_bits(got, want)
    plain = raster.rasterize_tiles(*rec, **dict(rkw, init_color=None,
                                                init_depth=None, y0_px=0))
    assert not _same_bits(got, tuple(x[:bh] for x in plain))
    if case == "wall near pass":
        full = pipeline.render_step(*args, **kw)
        assert _same_bits(got, full[:2])


@pytest.mark.cuda
def test_raster_kernel_keeps_its_budget(cuda_device):
    """After the init frame and y0_px: K2/K3 still builds without spills
    in at most 64 registers, four resident blocks an SM."""
    _, log = _build.build(force=True, verbose=True)
    reps = [r for name, r in _build.ptxas_report(log).items()
            if "13raster_kernel" in name]
    assert len(reps) == 1, reps
    rep = reps[0]
    assert rep["spill_stores"] == 0 and rep["spill_loads"] == 0, rep
    assert rep["registers"] <= 64, rep
    assert _build.lib().dpvr_rasterize_tiles_blocks_per_sm() >= 4


@pytest.mark.cuda
def test_ptx_has_no_multiply_adds(cuda_device):
    """The rounding contract: no floating-point multiply-add in the PTX of
    any kernel source."""
    counts = _build.ptx_fma_counts()
    assert set(counts) == set(_build.SOURCES)
    assert not any(counts.values()), counts


@pytest.mark.cuda
def test_raster_kernels_fit_four_blocks_an_sm(cuda_device):
    """K2/K3 and K4 hold four resident 256-thread blocks an SM (all 450
    tiles of a 1280x720 frame at once on 132 SMs)."""
    lib = _build.lib()
    assert lib.dpvr_rasterize_tiles_blocks_per_sm() >= 4
    assert lib.dpvr_rasterize_packed_blocks_per_sm() >= 4


PROBE_MODULES = {"micro_fixed": (micro_fixed, micro_fixed.LEVELS),
                 "micro_fixed2": (micro_fixed2,
                                  micro_fixed2.LABELS + micro_fixed2.SWEEP),
                 "micro_fixed3": (micro_fixed3, micro_fixed3.LABELS)}


def _launches():
    return {"M1": micro.launches_fill, "M2": micro.launches_copy,
            "K2": raster.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("module", sorted(PROBE_MODULES))
def test_probe_kernels_match_plain(cuda_device, module):
    """Every cost-probe variant: its kernel (M1, M2, or K2 on an empty
    stream) launched as often as the variant calls it, and its outputs
    equal to the plain versions' bit for bit where the kernel writes."""
    mod, labels = PROBE_MODULES[module]
    args = (7,) if module == "micro_fixed2" else ()
    for label in labels:
        v = mod.variant(label)
        before = _launches()
        got = mod.run_variant(label, *args)
        torch.cuda.synchronize()
        grew = {k: n - before[k] for k, n in _launches().items()}
        assert grew == {k: v.calls if k == v.kernel else 0 for k in grew}, (
            label, grew)
        ref = mod.run_variant(label, *args, plain=True)
        assert bench_common.same_bits(v.written(got), v.written(ref)), label


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["micro_fixed", "micro_fixed3"])
def test_probe_record_stage_matches_plain(cuda_device, module):
    """Levels 1-2 on random tile counts, where blocks stage their first
    record block in shared memory, and on the original's zeros."""
    mod = PROBE_MODULES[module][0]
    for seed in (None, 11):
        inputs = mod.build_inputs(seed=seed)
        for level in ("1", "2"):
            v = mod.variant(level)
            got = mod.run_variant(level, inputs)
            ref = mod.run_variant(level, inputs, plain=True)
            assert bench_common.same_bits(got, ref), (seed, level)
            assert bench_common.same_bits(v.written(got), got)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["X_FROM_META", "X_PLUS_REC", "MAP_ORDER",
                                  "X_PLUS_SCRATCH"])
def test_fill_kernel_reads_its_operands(cuda_device, flag):
    """M1 against its plain version on random operands."""
    rng = np.random.default_rng(3)
    lay = bench_common.frame_layout(
        flags=micro.DEPTH | micro.DEPTH_ADD_X | getattr(micro, flag))
    ops = dict(x=rng.integers(-2**31, 2**31, 1),
               order=rng.permutation(lay.steps),
               starts=rng.integers(-2**31, 2**31, 460),
               counts=rng.integers(-2**31, 2**31, 460),
               recs=rng.integers(-2**31, 2**31, (24, 98304)),
               bidx=rng.integers(0, 384, lay.steps))
    ops = {k: torch.from_numpy(a.astype(np.int32)).to(cuda_device)
           for k, a in ops.items()}
    before = micro.launches_fill
    got = micro.fill_tiles(lay, **ops)
    assert micro.launches_fill == before + 1
    assert bench_common.same_bits(got, micro.fill_tiles_plain(lay, **ops))


@pytest.mark.cuda
def test_copy_kernel_matches_plain(cuda_device):
    """M2 on random int32 with eight inputs and eight outputs (sums wrap),
    and in place."""
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.integers(-2**31, 2**31, (256, 128))
                            .astype(np.int32)).to(cuda_device)
           for _ in range(8)]
    x = torch.tensor([2**31 - 3], dtype=torch.int32, device=cuda_device)
    pairs = tuple((1 + k % 2, k, k % 3 == 0) for k in range(8))
    before = micro.launches_copy
    got = micro.blocked_copy(ins, x, pairs)
    assert micro.launches_copy == before + 1
    ref = micro.blocked_copy_plain(ins, x, pairs)
    assert bench_common.same_bits(got, ref)
    buf = ins[0].clone()
    out = micro.blocked_copy([buf], x, pairs[:2], out=(buf, None))
    assert out[0] is buf and bench_common.same_bits(out, ref[:2])


def _fill_ops(lay, device, seed):
    """Random operands of every kind a fill reads, for ``lay``."""
    rng = np.random.default_rng(seed)
    n_meta = lay.steps * lay.tps
    ops = dict(x=rng.integers(-2**31, 2**31, 1),
               order=rng.permutation(lay.steps),
               starts=rng.integers(-2**31, 2**31, n_meta),
               counts=rng.integers(-2**31, 2**31, n_meta),
               recs=rng.integers(-2**31, 2**31, (24, 4096)),
               bidx=rng.integers(0, 16, lay.steps))
    return {k: torch.from_numpy(a.astype(np.int32)).to(device)
            for k, a in ops.items()}


FILL_FLAGS = ("MAP_ORDER", "MAP_CONST", "X_FROM_META", "X_PLUS_SCRATCH",
              "X_PLUS_REC", "STAGE_TILE")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["736x1280 16x256", "48x64 3x4",
                                   "64x64 1x8"])
def test_fill_kernel_under_every_flag(cuda_device, shape):
    """M1 against its plain version on random operands under each flag
    alone, all value flags together, and MAP_CONST with each (its tile
    keeps the last step's value), with and without depth: bit for bit
    where it writes, one launch a call, at tiles wider and narrower than
    a block."""
    frame, tile = (tuple(map(int, p.split("x"))) for p in shape.split())
    tps = max(1, tile[1] // 128)
    steps = frame[0] // tile[0] * (frame[1] // tile[1])
    combos = [(f,) for f in FILL_FLAGS] + [
        ("MAP_ORDER", "X_FROM_META", "X_PLUS_SCRATCH", "X_PLUS_REC",
         "STAGE_TILE"),
        ("MAP_CONST", "X_PLUS_SCRATCH", "STAGE_TILE"),
        ("MAP_CONST", "X_FROM_META"), ("MAP_CONST", "X_PLUS_REC")]
    for combo, depth in ((c, d) for c in combos for d in (True, False)):
        flags = sum(getattr(micro, f) for f in combo)
        flags |= (micro.DEPTH | micro.DEPTH_ADD_X) if depth else 0
        lay = micro.FillLayout(frame, *tile, (1, steps), flags=flags,
                               tps=tps)
        ops = _fill_ops(lay, cuda_device, seed=len(combo) + flags)
        before = micro.launches_fill
        got = micro.fill_tiles(lay, **ops)
        assert micro.launches_fill == before + 1
        assert len(got) == 1 + depth
        if flags & micro.MAP_CONST:
            # the plain version's duplicate stores leave any step's value
            last = lay.steps - 1
            xt = int(ops["x"][0])
            if flags & micro.X_FROM_META:
                xt = int(ops["counts"][last * tps]) + int(
                    ops["starts"][last * tps])
            if flags & micro.X_PLUS_REC:
                xt += int(ops["recs"][0, int(ops["bidx"][last]) * 256])
            want = (raster.SKY_I32 + xt + 2**31) % 2**32 - 2**31
            tile0 = got[0].reshape(lay.view)[:tile[0], :tile[1]]
            assert bool((tile0 == want).all()), combo
            if depth:
                assert bool(torch.isinf(got[1].reshape(lay.view)
                                        [:tile[0], :tile[1]]).all())
            continue
        ref = micro.fill_tiles_plain(lay, **ops)
        rows = lay.rows_written
        assert bench_common.same_bits(
            [o.reshape(lay.view)[:rows] for o in got],
            [o.reshape(lay.view)[:rows] for o in ref]), combo


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 1024, 3 * 64])
def test_copy_kernel_grid_matches_plain(cuda_device, rows):
    """M2 at its grid (one 16-byte vector a thread, 128 threads a block)
    against its plain version: eight inputs and eight outputs, one output,
    block_rows 64 or all the rows, and in place with out0 = in0."""
    rng = np.random.default_rng(rows)
    ins = [torch.from_numpy(rng.integers(-2**31, 2**31, (rows, 128))
                            .astype(np.int32)).to(cuda_device)
           for _ in range(8)]
    x = torch.tensor([-2**31 + 9], dtype=torch.int32, device=cuda_device)
    pairs = tuple((3 - k % 3, 11 * k - 40, k % 2 == 1) for k in range(8))
    for br, n_in, n_out in ((64, 8, 8), (rows, 1, 1), (64, 2, 5)):
        got = micro.blocked_copy(ins[:n_in], x, pairs[:n_out],
                                 block_rows=br)
        ref = micro.blocked_copy_plain(ins[:n_in], x, pairs[:n_out])
        assert bench_common.same_bits(got, ref), (br, n_in, n_out)
        ptrs = sorted(o.data_ptr() for o in got)
        assert all(b - a >= rows * 512 for a, b in zip(ptrs, ptrs[1:]))
    buf = ins[0].clone()
    out = micro.blocked_copy([buf, ins[1]], x, pairs[:3],
                             out=(buf, None, ins[2]))
    ref = micro.blocked_copy_plain(ins[:1], x, pairs[:3])
    assert out[0] is buf and out[2] is ins[2]
    assert bench_common.same_bits(out, ref)


@pytest.mark.cuda
def test_copy_chain_in_a_cuda_graph(cuda_device):
    """Two M2 calls, the second fed the first one's outputs (views of one
    buffer), captured in one CUDA graph: each replay recomputes both from
    the input's current values, equal to the plain chain bit for bit."""
    rng = np.random.default_rng(13)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (1024, 128))
                         .astype(np.int32)).to(cuda_device)
    x = torch.tensor([12345], dtype=torch.int32, device=cuda_device)
    p1, p2 = ((1, 0, True), (2, 1, False)), ((1, 1, True), (5, -7, True))

    def chain(copy):
        o = copy([a], x, p1)
        return copy([o[0], o[1]], x, p2) + (o[1],)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(micro.blocked_copy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = micro.launches_copy
    with torch.cuda.graph(graph):
        out = chain(micro.blocked_copy)
    assert micro.launches_copy == before + 2
    for seed in (1, 2):
        a.copy_(torch.from_numpy(np.random.default_rng(seed).integers(
            -2**31, 2**31, (1024, 128)).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        assert bench_common.same_bits(out, chain(micro.blocked_copy_plain))
    assert micro.launches_copy == before + 2


@pytest.mark.cuda
def test_hardware_selftest_is_exact(cuda_device):
    """The fuzz scene through K1 and K2 against their plain twins on the
    card, at one and five tile columns: bit for bit, and the kernels
    launched."""
    k1, k2 = geometry.launches, raster.launches
    assert parity.run_hardware_selftest(device="cuda") == "exact"
    assert parity.run_hardware_selftest(device="cuda", width=640) == "exact"
    assert geometry.launches > k1 and raster.launches > k2


def _path_cameras(device, shift=(0.0, 0.0, 0.0), n=4):
    """n cameras of the terrain scene stepping (2, 0, -2) a frame from its
    pose moved by ``shift``, all looking at its target: (vps f32[n, 4, 4],
    cams f32[n, 3]) on ``device``."""
    w, h, _, pos, tgt = parity.SMALL_SCENES["terrain 640x128"]
    vps, cams = [], []
    for i in range(n):
        c = Camera(np.asarray(pos, np.float32) + np.float32(shift)
                   + np.float32([2.0 * i, 0.0, -2.0 * i]), w / h)
        c.look_at(np.asarray(tgt, np.float32))
        vps.append(c.view_projection_matrix())
        cams.append(c.position.copy())
    return (torch.from_numpy(np.stack(vps).astype(np.float32)).to(device),
            torch.from_numpy(np.stack(cams).astype(np.float32)).to(device))


def _repeated_setup(device, mode, n=4):
    """The terrain scene at 640x128 with a renderer of ``mode`` (serial,
    packed or span), ``make_repeated_step(r, n)``, the step's keywords as
    make_repeated_step sets them, and n cameras along a short path (vps,
    cams on the card)."""
    gargs, gkw = parity.small_scene("terrain 640x128", device)
    gc = gkw["render_cap"]
    cfg = pipeline.RenderConfig(
        width=gkw["width"], height=gkw["height"], gather_cap=gc,
        quads_cap=gc // 2, tile_k_cap=2 * gc,
        packed_raster=mode == "packed", span_mode=mode == "span")
    r = pipeline.Renderer(cfg, device=device)
    kw = {k: v for k, v in r._base_step_kw.items() if k != "near_quads"}
    kw.update(render_cap=cfg.quads_cap, tile_k_cap=cfg.tile_k_cap)
    return (gargs, kw, pipeline.make_repeated_step(r, n),
            *_path_cameras(device, n=n))


def _same(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


def _k1_k2(mode):
    k1 = geometry.launches_span if mode == "span" else geometry.launches
    return k1, (raster_packed if mode == "packed" else raster).launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["serial", "packed", "span"])
def test_repeated_step_graph_matches_eager(cuda_device, mode):
    """make_repeated_step's CUDA graph of 4 steps: its last frame equals an
    eager render_step on the 4th camera bit for bit; the first call runs
    the 4 steps eagerly and captures them, a replay calls no wrapper, and
    each call counts K1 and K2 (or K4, or K1's span instance and K2) 4
    times: a capture counts into its own tally, added at each replay."""
    gargs, kw, run, vps, cams = _repeated_setup(cuda_device, mode)
    before = _k1_k2(mode)
    calls = graphs.calls.copy()
    out = run(*gargs[:3], vps, cams)
    assert _k1_k2(mode) == (before[0] + 4, before[1] + 4)
    assert graphs.calls - calls == {"captures": 1}
    ref = pipeline.render_step(*gargs[:3], vps[3], cams[3], **kw)
    assert _same(out, ref)
    before = _k1_k2(mode)
    calls = graphs.calls.copy()
    with _wrappers_raise():
        again = run(*gargs[:3], vps, cams)
    assert _k1_k2(mode) == (before[0] + 4, before[1] + 4)
    assert graphs.calls - calls == {"replays": 1}
    assert _same(again, ref) and _same(out, ref)
    assert int((ref[0] != raster.SKY_I32).sum()) > 1000
    first = pipeline.render_step(*gargs[:3], vps[0], cams[0], **kw)
    assert not torch.equal(first[0], ref[0])


@pytest.mark.cuda
def test_repeated_step_takes_new_cameras(cuda_device):
    """A second call with other cameras gives the frame of its own last
    camera (the inputs are copied into the graph's buffers each call, not
    captured by value), and a third with the first cameras the first
    frame again."""
    gargs, kw, run, vps, cams = _repeated_setup(cuda_device, "serial")
    first = [t.clone() for t in run(*gargs[:3], vps, cams)]
    vps2, cams2 = _path_cameras(cuda_device, shift=(6.0, -4.0, 9.0))
    second = [t.clone() for t in run(*gargs[:3], vps2, cams2)]
    ref2 = pipeline.render_step(*gargs[:3], vps2[3], cams2[3], **kw)
    assert _same(second, ref2) and not torch.equal(second[0], first[0])
    assert _same(run(*gargs[:3], vps, cams), first)


@contextlib.contextmanager
def _wrappers_raise():
    """Every kernel wrapper a frame reaches raises inside the block: a
    replay runs none of the step's Python."""
    saved = (geometry.project_cull, raster.rasterize_tiles,
             raster.tile_metadata, raster_packed.rasterize_packed)

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper ran at a replay")

    geometry.project_cull = raster.rasterize_tiles = refuse
    raster.tile_metadata = raster_packed.rasterize_packed = refuse
    try:
        yield
    finally:
        (geometry.project_cull, raster.rasterize_tiles, raster.tile_metadata,
         raster_packed.rasterize_packed) = saved


# the frame-graph tests' engines: 256x128, view distance 3, three gather
# buckets (16384, 32768, 65536), chunks streamed 4 a frame
GRAPH_MODES = {"serial": {}, "packed": dict(packed_raster=True),
               "two-pass": dict(two_pass_near_quads=1024),
               "temporal": dict(temporal_hiz=True),
               "span": dict(span_mode=True)}
GRAPH_POSES = [((0.0, 10.0, 20.0), (0.0, 0.0, -60.0))] * 3 + [
    ((x, 10.0, 20.0 - x), (x, 0.0, -60.0 - x)) for x in (8.0, 16.0, 24.0)]


def _graph_engine(device, mode="serial"):
    from differential_projection_voxel_renderer_tpu_torch.app import (
        engine as TE,
    )

    eng = TE.Engine(TE.RenderConfig(width=256, height=128, gather_cap=65536,
                                    quads_cap=32768, **GRAPH_MODES[mode]),
                    TE.WorldConfig(view_distance=3, frustum_culling=True,
                                   max_chunks_per_frame=4),
                    pool_slots=512, device=device)
    assert eng.renderer.gather_buckets == (16384, 32768, 65536)
    pos, tgt = GRAPH_POSES[0]
    eng.camera.position = np.array(pos, np.float32)
    eng.camera.look_at(np.array(tgt, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    return eng


def _fly(eng, poses):
    out = []
    for pos, tgt in poses:
        eng.camera.position = np.array(pos, np.float32)
        eng.camera.look_at(np.array(tgt, np.float32))
        out.append(eng.render_frame(dt=0.0))
    return out


def _frame_bits(out):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in out]


def _fly_pipelined(eng, poses):
    """``_fly`` in frames-in-flight mode: the frames that come out, the
    last one by the flush."""
    out = []
    for pos, tgt in poses:
        eng.camera.position = np.array(pos, np.float32)
        eng.camera.look_at(np.array(tgt, np.float32))
        out.append(eng.render_frame_pipelined(dt=0.0))
    return [r for r in out if r is not None] + [eng.flush_pipeline()]


PIPE_GRAPHS = ["pipe_seed", "pipe_seed_fused", "pipe_prepared", "pipe_fused"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(GRAPH_MODES) + ["pipelined"])
def test_graph_frame_equals_eager_frame(cuda_device, mode):
    """Every entry point's graph at every gather bucket (warm_buckets and
    warm_streaming twice: captures, then replays) and the engine's frames
    (static, moving, streaming) replayed: each replay's outputs equal its
    function called eagerly on the same inputs, bit for bit.  "pipelined":
    the serial engine warmed with ``warm_buckets(pipelined=True)``, its
    frames in flight."""
    pipelined = mode == "pipelined"
    eng = _graph_engine(cuda_device, "serial" if pipelined else mode)
    twin = graphs.EagerTwin(eng.renderer)
    for _ in range(2):
        eng.warm_buckets(pipelined=pipelined)
        eng.warm_streaming()
    (_fly_pipelined if pipelined else _fly)(eng, GRAPH_POSES)
    torch.cuda.synchronize()
    twin.close()
    names = ["fused", "expand", "prepared", "insert"] + (
        ["hiz"] if mode == "temporal" else []) + (
        PIPE_GRAPHS if pipelined else [])
    want = {(n, c) for n in names for c in eng.renderer.gather_buckets}
    assert set(twin.replays()) == want == set(eng.renderer._graphs)
    assert all(equal for *_, equal in twin.calls), twin.calls


@pytest.mark.cuda
def test_held_frames_unchanged_after_more_frames(cuda_device):
    eng = _graph_engine(cuda_device)
    held = _fly(eng, GRAPH_POSES[:4])
    copies = [(r.color.clone(), r.depth.clone(), r.stats.clone())
              for r in held]
    _fly(eng, GRAPH_POSES[1:4] + GRAPH_POSES[4:][::-1])
    torch.cuda.synchronize()
    for r, c in zip(held, copies):
        assert all(torch.equal(a, b) for a, b in zip(
            _frame_bits((r.color, r.depth, r.stats)), _frame_bits(c)))


@pytest.mark.cuda
def test_graphs_recapture_after_set_shading_and_a_new_pool(cuda_device):
    """set_shading drops every graph and the next frame captures anew with
    the new tables; a frame with other pool tensors captures a graph over
    them, and renders the frame the first pool renders."""
    eng = _graph_engine(cuda_device)
    r = eng.renderer
    base = _fly(eng, GRAPH_POSES[:2])
    assert r._graphs
    eng.toggle_shading()
    assert r._graphs == {}
    flat = _fly(eng, GRAPH_POSES[:1])[0]
    eng.toggle_shading()
    back = _fly(eng, GRAPH_POSES[:1])[0]
    assert not torch.equal(flat.color, base[1].color)
    assert torch.equal(back.color, base[1].color)
    args = (eng._last_visible_slots, eng._last_counts_sel,
            eng._last_positions_sel, eng.camera.view_projection_matrix(),
            eng.camera.position)
    pool = eng.pool
    first = [r.render_fused(pool.quads, *args, dir_mask=eng._last_dir_mask)
             for _ in range(2)][1]
    g = r._graphs["fused", 16384]
    q2 = pool.quads.clone()
    second = r.render_fused(q2, *args, dir_mask=eng._last_dir_mask)
    g2 = r._graphs["fused", 16384]
    assert g2 is not g and g2.fixed[0] is q2
    assert all(torch.equal(a, b) for a, b in zip(_frame_bits(first),
                                                 _frame_bits(second)))


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_replay_runs_no_wrapper_and_counts_exactly(cuda_device, pipelined):
    """After the warm-ups, static, moving and streaming frames replay
    (one replay a frame, and one more for the settled draw list's
    expansion; no capture) with every kernel wrapper made to raise, and
    K1, tile_meta and K2 still count exactly one launch a frame.
    ``pipelined``: steady frames in flight at the held pose replay their
    graphs the same way -- the seed (K1), three steps (K3 and tile_meta
    each), the flush's static step (K1, tile_meta, K2) -- each counting the
    launches of one eager call."""
    eng = _graph_engine(cuda_device)
    eng.warm_buckets(pipelined=pipelined)
    eng.warm_streaming()
    _fly(eng, GRAPH_POSES[:1])
    torch.cuda.synchronize()
    counts = (lambda: (geometry.launches, raster.launches_meta,
                       raster.launches, raster.launches_geom))
    before = counts()
    calls = graphs.calls.copy()
    if pipelined:
        with _wrappers_raise():
            frames = _fly_pipelined(eng, GRAPH_POSES[:1] * 4)
        assert len(frames) == 4 and all(r is not None for r in frames)
        assert tuple(b - a for a, b in zip(before, counts())) == (2, 4, 1, 3)
        assert graphs.calls - calls == {"replays": 5}
        return
    with _wrappers_raise():
        frames = _fly(eng, GRAPH_POSES)
    assert counts() == (
        before[0] + len(frames), before[1] + len(frames),
        before[2] + len(frames), before[3])
    # the first frame holds the draw list of the frame before it: its
    # expansion (prepare_uploads) replays, then its static step
    assert graphs.calls - calls == {"replays": len(frames) + 1}


@pytest.mark.cuda
def test_warmed_frame_makes_no_host_sync(cuda_device):
    eng = _graph_engine(cuda_device)
    eng.warm_buckets()
    eng.warm_streaming()
    _fly(eng, GRAPH_POSES)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _fly(eng, GRAPH_POSES[:1] * 2 + GRAPH_POSES[4:5])
    finally:
        torch.cuda.set_sync_debug_mode(mode)



@pytest.mark.cuda
def test_graphs_survive_profiler_windows(cuda_device):
    """Graph frames under torch.profiler, in a process of their own
    (tests/_torch_graph_profile.py): a window after an earlier one, an
    engine with captured graphs freed by the cyclic collector inside a
    window, captures inside a window, and moving frames in a last window.
    Every window must see device activity and the process must end with
    exit code 0 (a crash ends it with a signal).  With CUPTI torn down
    after each window (``TEARDOWN_CUPTI=1``) the later windows see no
    device activity."""
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_graph_profile.py")
    done = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, (done.returncode, done.stdout,
                                  done.stderr[-3000:])
    assert done.stdout.split()[-1] == "ok"


@pytest.mark.cuda
def test_pinned_ring_reuse_waits_for_its_copies(cuda_device, monkeypatch):
    """The renderer's uploads come round its pinned ring while the card is
    still busy: behind a long kernel, fused frames and static frames
    (their draw lists and cameras packed natively into the ring's slots)
    alternate for three times the ring's slots.  A slot is written again
    only once its copies have run (``take`` waits on its events), so each
    graph call's input holds its own words: every frame equals its
    function called eagerly on the words packed for it, and the frames
    of the same calls packed by the twin, ``_pack_frame``, bit for bit."""
    eng = _graph_engine(cuda_device)
    eng.warm_buckets()
    r, pool = eng.renderer, eng.pool
    assert r._packer is not None
    _fly(eng, GRAPH_POSES[:1])
    args = (eng._last_visible_slots, eng._last_counts_sel,
            eng._last_positions_sel)
    mask = eng._last_dir_mask
    uploads = r.prepare_uploads(pool.quads, *args, dir_mask=mask)
    cams = []
    for k in range(3 * r.RING_SLOTS):
        eng.camera.yaw = 0.05 * k
        cams.append((eng.camera.view_projection_matrix().copy(),
                     eng.camera.position.copy()))

    def calls(record=None):
        out = []
        for k, (vp, cp) in enumerate(cams):
            if k % 2:
                out.append(r.render_prepared(uploads, vp, cp))
            else:
                out.append(r.render_fused(pool.quads, *args, vp, cp,
                                          dir_mask=mask))
        return out

    # the words of each graph call's upload, read on the host as packed
    seen = []
    run_graph = r._run_graph

    def spy(name, cap, fn, fixed, inputs, keep=0):
        seen.append((fn, fixed, [x.clone() if isinstance(x, torch.Tensor)
                                 and x.device.type == "cpu" else x
                                 for x in inputs]))
        return run_graph(name, cap, fn, fixed, inputs, keep)

    waits = []
    real_sync = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda e: (waits.append(1), real_sync(e))[1])
    monkeypatch.setattr(r, "_run_graph", spy)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card
    native = calls()
    torch.cuda.synchronize()
    assert waits, "no slot came round while its copy was pending"
    monkeypatch.undo()
    assert len(seen) == len(cams)
    for got, (fn, fixed, inputs) in zip(native, seen):
        want = fn(*fixed, *(x.to(cuda_device) if isinstance(x, torch.Tensor)
                            else x for x in inputs))
        assert all(torch.equal(a, b) for a, b in zip(_frame_bits(got),
                                                     _frame_bits(want)))
    r._packer = None
    twin = calls()
    for a, b in zip(native, twin):
        assert all(torch.equal(x, y) for x, y in zip(_frame_bits(a),
                                                     _frame_bits(b)))
    assert not all(torch.equal(native[0][0], f[0]) for f in native[2::2])


@pytest.mark.cuda
def test_pinned_ring_records_on_the_slot_copied(cuda_device):
    """``PinnedRing.copied`` records its events on the slot that holds the
    tensor copied, found from any view of it, even where another slot
    was taken since; a tensor of no slot records nothing.  ``take`` then
    waits for that slot's copy, behind a long kernel, when it comes
    round."""
    ring = graphs.PinnedRing(2, 64)
    a, a_np = ring.take(16)
    b, _ = ring.take(32)
    dst = torch.empty(16, dtype=torch.int32, device=cuda_device)
    ring.copied(torch.zeros(4, dtype=torch.int32), (cuda_device,))
    ring.copied(torch.zeros(4, dtype=torch.int32, device=cuda_device),
                (cuda_device,))
    assert not any(ring._events)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card
    a_np[:] = np.arange(16, dtype=np.int32)
    dst.copy_(a, non_blocking=True)
    ring.copied(a[2:].view(torch.float32), (cuda_device,))
    assert ring._events[0] and not ring._events[1]
    assert not ring._events[0][cuda_device.index or 0].query()
    again, again_np = ring.take(16)  # slot 0: waits for the copy
    assert again.data_ptr() == a.data_ptr()
    assert ring._events[0][cuda_device.index or 0].query()
    again_np[:] = -1
    assert torch.equal(dst.cpu(), torch.arange(16, dtype=torch.int32))
    assert b.data_ptr() != a.data_ptr()


@pytest.mark.cuda
def test_captured_call_keeps_its_graph(cuda_device):
    """A CapturedCall keeps the graph it captured beside the executable
    graph (``keep_graph``), whose handles CUPTI may read at a launch under
    a later profiler window; replays still serve new inputs."""
    call = graphs.CapturedCall(lambda x: (x * 2.0,), (),
                               (torch.ones(8, device=cuda_device),),
                               device=cuda_device)
    for v in (1.0, 3.0):
        call.load(0, torch.full((8,), v, device=cuda_device))
        (out,) = call.run()
        assert torch.equal(out, torch.full((8,), 2.0 * v,
                                           device=cuda_device))
    assert call.graph.raw_cuda_graph() != 0


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.multicard
@pytest.mark.parametrize("name", sorted(parity.SMALL_SCENES))
def test_kernels_on_every_card_match_card_0(cards, name):
    """K1, K2 with y0_px, K3, K4, M1 and M2 launched from this thread
    (current device card 0) on every card: each once on its card, each
    equal to card 0's outputs bit for bit, and the kernel library's own
    runtime on each card inside torch.cuda.device."""
    args, kw = parity.small_scene(name, "cuda:0")
    got = multicard.kernel_checks(args, kw, cards, band=(48, 72))
    assert got["current_device"] == [0, *range(cards)]


@pytest.mark.cuda
@pytest.mark.multicard
def test_packed_kernel_on_the_other_cards(cards):
    """K4 (56 KB of dynamic shared memory a block, over the default 48 KB)
    on every card after card 0, each against its plain version on that
    card: the shared-memory opt-in is made once a card, not once a
    process."""
    args, kw = parity.small_scene("terrain 640x128", "cuda:0")
    rec = pipeline.render_step(*args, packed_raster=True,
                               debug_return_records=True, **kw)
    rkw = dict(height=kw["height"], width=kw["width"])
    raster_packed.rasterize_packed(*rec, **rkw)
    for k in range(1, cards):
        on_k = [x.to(k) for x in rec]
        c1, d1 = raster_packed.rasterize_packed(*on_k, **rkw)
        c2, d2 = raster_packed.rasterize_packed_plain(*on_k[:5], **rkw)
        assert c1.device.index == k
        assert torch.equal(c1, c2) and torch.equal(d1, d2), k


@pytest.mark.cuda
@pytest.mark.multicard
def test_launch_counts_exact_under_threads(cards):
    """A thread a card, each launching K1 on its card 200 times with the
    interpreter switching threads every microsecond: no launch is lost
    from the module's count or the count by card."""
    import sys
    import threading

    words, qw = _fuzz_stream(4096)
    vp, cp = _camera_args("far", "cpu")
    n = 200
    inputs = [tuple(x.to(k) for x in (
        words, qw, torch.tensor(4000, dtype=torch.int32), vp, cp))
        for k in range(cards)]
    with _build.COUNT_LOCK:
        before = geometry.launches
        _build.card_launches.clear()

    def drive(k):
        torch.cuda.set_device(k)
        for _ in range(n):
            geometry.project_cull(*inputs[k], width=256, height=128)
        torch.cuda.synchronize(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive, args=(k,))
                   for k in range(cards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert geometry.launches - before == n * cards
    assert dict(_build.card_launches) == {("K1", k): n
                                          for k in range(cards)}


@pytest.mark.cuda
@pytest.mark.multicard
def test_sharded_batch_on_cards_matches_one_card(cards):
    """make_sharded_render on 2 x 2 cards (1 x 2 with two or three cards)
    at 1280x720 on the graft entry's terrain patch: a camera a dp row, its
    bands on distinct cards, the pool replicated on each card once and kept
    across calls.  The first call runs each card's step eagerly and
    captures its graph; the second replays those graphs (no capture, the
    same graph objects) with every kernel wrapper made to raise.  Each
    counts K1, tile_meta and K2 once on each card (a capture counts into
    its own tally, added at each replay); the frames and counts of both
    equal the same batch's on card 0 alone bit for bit."""
    pool, counts, positions, n_slots, cam = graft_entry._example_scene()
    other = Camera(np.array([-30.0, 50.0, 80.0], np.float32), 16.0 / 9.0)
    other.look_at(np.array([0.0, 0.0, 0.0], np.float32))
    size = 4 if cards >= 4 else 2
    mesh = sharded_render.make_mesh(size)
    one = sharded_render.make_mesh(size, devices=["cuda:0"] * size)
    dp, tp = mesh
    assert len(set(mesh.flat)) == size
    visible = np.zeros((dp, 64), np.int32)
    visible[:, :n_slots] = np.arange(n_slots)
    cams = [cam, other][:dp]
    args = [torch.from_numpy(x).to("cuda:0") for x in (
        pool.view(np.int32), counts, positions, visible,
        np.full(dp, n_slots, np.int32),
        np.stack([c.view_projection_matrix() for c in cams]).astype(
            np.float32),
        np.stack([c.position for c in cams]).astype(np.float32))]
    kw = dict(width=1280, height=720, gather_cap=16384, render_cap=8192,
              tile_k_cap=8192)
    rep = [sharded_render.replicate(mesh, x) for x in args[:3]]
    ptrs = {d: t.data_ptr() for d, t in rep[0].copies.items()}
    assert sorted(d.index for d in ptrs) == list(range(size))
    fn = sharded_render.make_sharded_render(mesh, **kw)
    runs, calls = [], []
    for replay in (False, True):
        multicard.sync_all()
        _build.reset_counts()
        before = graphs.calls.copy()
        with _wrappers_raise() if replay else contextlib.nullcontext():
            runs.append([x.clone() for x in fn(*rep, *args[3:])])
        multicard.sync_all()
        runs.append(dict(_build.card_launches))
        calls.append(graphs.calls - before)
        if not replay:
            made = {k: (g, g.graph) for k, g in fn.shards.graphs.items()}
    assert runs[1] == {(k, c): 1 for k in ("K1", "tile_meta", "K2")
                       for c in range(size)}
    assert runs[3] == runs[1]
    assert calls == [{"captures": size}, {"replays": size}]
    assert {k: (g, g.graph) for k, g in fn.shards.graphs.items()} == made
    assert {d: t.data_ptr() for d, t in rep[0].copies.items()} == ptrs
    want = sharded_render.make_sharded_render(one, **kw)(*args)
    for got in (runs[0], runs[2]):
        assert got[0].device.index == 0
        assert _same_bits(got[:2], want[:2]) and torch.equal(got[2], want[2])
    assert int((want[0] != raster.SKY_I32).sum()) > 1000


def _views_engine(mesh_cards=None):
    from differential_projection_voxel_renderer_tpu_torch.app import (
        engine as TE)

    eng = TE.Engine(TE.RenderConfig(width=1280, height=720, gather_cap=65536,
                                    quads_cap=32768, tile_k_cap=65536),
                    TE.WorldConfig(view_distance=4, frustum_culling=True,
                                   max_chunks_per_frame=8),
                    pool_slots=2048, device="cuda", mesh_cards=mesh_cards)
    eng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    return eng


@pytest.mark.cuda
@pytest.mark.multicard
def test_views_on_cards_equal_render_frame(cards):
    """``Engine.render_views`` on ``make_mesh(4)`` (2 x 2; on two or three
    cards ``make_mesh(2)``, 1 x 2) at 1280x720: two views a call back to
    back, at the start pose and then creeping across the chunk boundary at
    z = 0 (chunks stream in and mesh between calls).  Every view's stacked
    bands equal ``render_frame``'s frame of its pose on a serial engine
    bit for bit, with its stream length; no call after ``warm_views``
    captures a graph; and each card's replica of the pool equals the pool
    after the moving calls."""
    n = 4 if cards >= 4 else 2
    ev, es = _views_engine(n), _views_engine()
    ev.warm_views(2)
    captures = 0
    for i, z in enumerate((20.0, 12.0, 4.0, -4.0, -12.0)):
        views = [((0.0, 10.0, z), 0.2 + 0.01 * i, -0.12),
                 ((0.0, 10.0, z), 0.2 + 0.01 * i + np.pi, -0.12)]
        before = graphs.calls["captures"]
        got = ev.render_views(views)
        captures += graphs.calls["captures"] - before
        for k, (p, y, pt) in enumerate(views):
            es.camera.position = np.array(p, np.float32)
            es.camera.yaw, es.camera.pitch = y, pt
            es._hold_world = k > 0
            f = es.render_frame(dt=0.0)
            es._hold_world = False
            assert got.color.device.index == 0
            assert _same_bits((got.color[k], got.depth[k]),
                              (f.color, f.depth)), (i, k)
            assert int(got.stats[k, 0]) == int(f.stats[0])
            assert got.stats[k, 2:4].tolist() == [0, 0]
            assert len(set(got.reduced[k].tolist())) == 1
    assert captures == 0
    assert any(p[2] < 0 for p in ev.pool.by_pos)
    multicard.sync_all()
    render = ev._views_render()
    assert sorted(d.index for d in render._replicas) == list(range(1, n))
    for d, rep in render._replicas.items():
        assert torch.equal(rep, ev.pool.quads.to(d)), d
