"""The port's CUDA kernels against their plain PyTorch twins on the card.

Needs an NVIDIA GPU with nvcc (every test is marked ``cuda`` and skips
without a card) and no JAX, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.)  Kernel and twin run
on the same card, on the same tensors, and must agree bit for bit.  The
file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

import _torch_streams as TS
from differential_projection_voxel_renderer_tpu_torch import _build
from differential_projection_voxel_renderer_tpu_torch.benches import (
    common as bench_common,
    micro_fixed,
    micro_fixed2,
    micro_fixed3,
)
from differential_projection_voxel_renderer_tpu_torch.models.camera import (
    Camera,
)
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.ops import micro
from differential_projection_voxel_renderer_tpu_torch.ops import projection
from differential_projection_voxel_renderer_tpu_torch.ops import raster
from differential_projection_voxel_renderer_tpu_torch.ops import raster_packed
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


def _fuzz_stream(n, seed=1234):
    rng = np.random.default_rng(seed)
    u, v, w, h, blk, sl, face = (rng.integers(0, hi, n) for hi in
                                 (32, 32, 64, 64, 4, 32, 6))
    words = (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22) | (sl << 24)
             | (face << 29)).astype(np.uint32)
    qw = (rng.integers(-2, 2, (3, n)) * 32).astype(np.float32)
    return projection.as_quad_words(words), torch.from_numpy(qw)


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
    for k in ("valid", "bbx", "bby", "subpixel"):
        assert torch.equal(got[k], ref[k]), k
    a, b = got["depth_near"], ref["depth_near"]
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    assert bool(same.all())


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
        for k in ("valid", "bbx", "bby", "subpixel"):
            assert torch.equal(got[k], ref[k]), k
        a, b = got["depth_near"], ref["depth_near"]
        assert bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
        assert not bool(got["valid"][:3000].any())
        assert torch.equal(got["valid"][3000:], full[3000:])
    assert bool(full[:3000].any())


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


def _same_geometry(got, want):
    for k in ("valid", "bbx", "bby", "subpixel"):
        assert torch.equal(got[k], want[k]), k
    a, b = got["depth_near"], want["depth_near"]
    assert bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


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
        flags=micro.DEPTH | micro.DEPTH_ADD_X | getattr(micro, flag),
        smem_bytes=4 * 460, smem_a=460)
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
