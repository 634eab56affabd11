"""The port's CUDA kernels against their plain PyTorch twins on the card.

Needs an NVIDIA GPU with nvcc (every test is marked ``cuda`` and skips
without a card) and no JAX, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.)  Kernel and twin run
on the same card, on the same tensors, and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
from differential_projection_voxel_renderer_tpu_torch.ops import projection
from differential_projection_voxel_renderer_tpu_torch.ops import raster
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
