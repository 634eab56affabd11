"""The port's Hi-Z module (ops/hiz.py) against the JAX package's, on the
CPU.

The same inputs, made from a numpy seed, go through both packages.
Tolerance: none; pyramids, cull sets, query results, buffer levels and
Morton codes must be equal, NaN where the reference has NaN (its min and
max propagate NaN, and so must the port's).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.ops import hiz as JH
from differential_projection_voxel_renderer_tpu_torch.ops import hiz as TH

SHAPES = [(40, 72), (90, 160), (128, 128), (17, 9)]


def _depth(shape, seed):
    """Random depths in [0, 1) with +inf (undrawn) and NaN entries."""
    rng = np.random.default_rng(seed)
    d = rng.random(shape).astype(np.float32)
    d[rng.random(shape) > 0.85] = np.inf
    d[rng.random(shape) > 0.995] = np.nan
    return d


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_pyramids_match_jax(shape):
    d = _depth(shape, sum(shape))
    assert np.isnan(d).any() and np.isinf(d).any()
    ref1, ref2 = JH.build_pyramid(jnp.asarray(d))
    got1, got2 = TH.build_pyramid(torch.from_numpy(d))
    _equal(ref1, got1)
    _equal(ref2, got2)
    ref = JH.build_max_pyramid(jnp.asarray(d))
    got = TH.build_max_pyramid(torch.from_numpy(d))
    _equal(ref, got)
    assert np.isnan(got.numpy()).any() and np.isinf(got.numpy()).any()


def _boxes(rng, n, height, width):
    """Packed inclusive pixel boxes whose sides span 1 to ~200 pixels, so
    that they fit 1, 2 or more blocks per axis at both levels."""
    side = rng.choice([1, 4, 9, 16, 30, 70, 130, 200], size=(n, 2))
    x0 = rng.integers(-8, width, n)
    y0 = rng.integers(-8, height, n)
    x1 = np.clip(x0 + side[:, 0], 0, width + 20)
    y1 = np.clip(y0 + side[:, 1], 0, height + 20)
    x0, y0 = np.clip(x0, 0, None), np.clip(y0, 0, None)
    bbx = (x0 | (x1 << 16)).astype(np.int32)
    bby = (y0 | (y1 << 16)).astype(np.int32)
    return bbx, bby


@pytest.mark.parametrize("height,width", [(720, 1280), (128, 128),
                                          (128, 640)])
def test_quads_occluded_exact_matches_jax(height, width):
    rng = np.random.default_rng(height + width)
    # a max pyramid with a few undrawn (+inf) and NaN blocks
    level1 = (0.5 * rng.random(((height + 7) // 8, (width + 7) // 8))
              ).astype(np.float32)
    level1[rng.random(level1.shape) > 0.97] = np.inf
    level1[rng.random(level1.shape) > 0.995] = np.nan
    n = 4096
    bbx, bby = _boxes(rng, n, height, width)
    dn = (1.2 * rng.random(n)).astype(np.float32)
    dn[::97] = np.nan
    ref = np.asarray(JH.quads_occluded_exact(
        jnp.asarray(level1), jnp.asarray(bbx), jnp.asarray(bby),
        jnp.asarray(dn), height=height, width=width))
    got = TH.quads_occluded_exact(
        torch.from_numpy(level1), torch.from_numpy(bbx),
        torch.from_numpy(bby), torch.from_numpy(dn), height=height,
        width=width).numpy()
    np.testing.assert_array_equal(ref, got)
    assert 0 < got.sum() < n


def test_quads_occluded_exact_edge_blocks():
    """tests/test_macrotile.py's edge-block case: at 720p (level 1 is
    90x160, 90 % 8 != 0) a bottom-edge quad over undrawn rows must not be
    culled, and the same quad in the interior must be; both packages
    agree."""
    l1 = np.full((90, 160), 5.0, np.float32)
    l1[88:, :] = np.inf
    bbx = np.asarray([0 | (16 << 16)] * 2, np.int32)
    bby = np.asarray([688 | (719 << 16), 320 | (351 << 16)], np.int32)
    dn = np.asarray([10.0, 10.0], np.float32)
    ref = np.asarray(JH.quads_occluded_exact(
        jnp.asarray(l1), jnp.asarray(bbx), jnp.asarray(bby),
        jnp.asarray(dn), height=720, width=1280))
    got = TH.quads_occluded_exact(
        torch.from_numpy(l1), torch.from_numpy(bbx), torch.from_numpy(bby),
        torch.from_numpy(dn), height=720, width=1280).numpy()
    np.testing.assert_array_equal(ref, got)
    assert got.tolist() == [False, True]


def test_is_occluded_batch_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 128, 640
    level1, _ = TH.build_pyramid(torch.from_numpy(_depth((h, w), 9)))
    n = 2048
    x0 = rng.integers(-10, w, n)
    y0 = rng.integers(-10, h, n)
    side = rng.choice([0, 3, 20, 100, 150], size=(n, 2))
    rects = np.stack([x0, y0, x0 + side[:, 0], y0 + side[:, 1]],
                     1).astype(np.int32)
    near = rng.random(n).astype(np.float32)
    ref = np.asarray(JH.is_occluded_batch(
        jnp.asarray(level1.numpy()), jnp.asarray(rects), jnp.asarray(near),
        height=h, width=w))
    got = TH.is_occluded_batch(level1, torch.from_numpy(rects),
                               torch.from_numpy(near), height=h,
                               width=w).numpy()
    np.testing.assert_array_equal(ref, got)
    assert 0 < got.sum() < n


def test_hiz_buffer_matches_jax():
    """from_depth, update_region, is_occluded, clear and resize, in the
    same order on both packages' buffers."""
    rng = np.random.default_rng(4)
    ref, got = JH.HiZBuffer(200, 120), TH.HiZBuffer(200, 120)
    for buf in (ref, got):
        buf.from_depth(_depth((120, 200), 3))

    def same():
        np.testing.assert_array_equal(ref.level1, got.level1)
        np.testing.assert_array_equal(ref.level2, got.level2)

    same()
    for _ in range(300):
        x0, y0 = rng.integers(-20, 220), rng.integers(-20, 140)
        x1, y1 = x0 + rng.integers(-5, 90), y0 + rng.integers(-5, 90)
        z = np.float32(rng.random())
        if rng.random() < 0.5:
            ref.update_region(x0, y0, x1, y1, z)
            got.update_region(x0, y0, x1, y1, z)
        else:
            assert (ref.is_occluded(x0, y0, x1, y1, z)
                    == got.is_occluded(x0, y0, x1, y1, z))
    same()
    got.from_depth(torch.from_numpy(_depth((120, 200), 8)))
    ref.from_depth(_depth((120, 200), 8))
    same()
    ref.clear()
    got.clear()
    same()
    ref.resize(64, 40)
    got.resize(64, 40)
    same()


def test_morton_round_trip_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 2**16, 5000).astype(np.uint32)
    y = rng.integers(0, 2**16, 5000).astype(np.uint32)
    m = TH.morton_encode(x, y)
    np.testing.assert_array_equal(JH.morton_encode(x, y), m)
    gx, gy = TH.morton_decode(m)
    rx, ry = JH.morton_decode(m)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_array_equal(gy, ry)
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)
