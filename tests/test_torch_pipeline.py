"""The port's render step and draw-list device code against the JAX
package, on the CPU.

``render_step`` runs K1's and K2's plain twins here; the reference is
``_render_step`` on its production branch with both Pallas kernels in
interpret mode.  Both capacity branches are covered: no compaction
(render cap = gather cap) and compaction (render cap below it).

Tolerances.  Frames (colour and depth) and stats must be equal.  The binning intermediates (tile starts/counts, the
record rows 0-20, octet rows) must be equal.  The near-depth record row
and the octet suffix-min come from the Pallas geometry kernel, whose
interpret-mode lowering contracts multiply-adds differently from its XLA
form (see tests/test_torch_projection.py), so they are held to 1e-4
relative.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

# (scene, render cap): a render cap equal to the scene's gather cap takes
# the no-compaction branch
CASES = [("fuzz", 4096), ("fuzz", 2048), ("terrain", 16384),
         ("terrain", 8192)]


@pytest.fixture(scope="module")
def scenes():
    return {name: S.scene(name) for name in S.SCENES}


def _allclose_nan(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=0)


@pytest.mark.parametrize("name,render_cap", CASES)
def test_render_step_matches_jax(scenes, name, render_cap):
    sc = scenes[name]
    ja, jkw = S.jax_args(sc), S.jax_step_kw(sc, render_cap)
    c1, d1, s1 = JPL._render_step(*ja, **jkw)
    rec1 = JPL._render_step(*ja, debug_return_records=True, **jkw)
    ta, tkw = S.torch_args(sc), S.torch_step_kw(sc, render_cap)
    c2, d2, s2 = TPL.render_step(*ta, **tkw)
    rec2 = TPL.render_step(*ta, debug_return_records=True, **tkw)

    np.testing.assert_array_equal(np.asarray(s1), s2.numpy())
    c1 = np.asarray(c1).view(np.uint32)
    c2 = c2.numpy().view(np.uint32)
    parity.assert_kernel_parity(c1, np.asarray(d1), c2, d2.numpy())
    assert (c2 != np.uint32(0xFF87CEEB)).sum() > 3000

    records1, records2 = np.asarray(rec1[0]), rec2[0].numpy()
    for i in (1, 2, 3):  # tile starts, tile counts, octet rows
        np.testing.assert_array_equal(np.asarray(rec1[i]), rec2[i].numpy())
    np.testing.assert_array_equal(records1[:21], records2[:21])
    np.testing.assert_array_equal(records1[22:], records2[22:])
    _allclose_nan(records1[21].view(np.float32),
                  records2[21].view(np.float32), 1e-4)
    _allclose_nan(rec1[4], rec2[4].numpy(), 1e-4)


def _draw_list(rng, n_slots, qcap, nv, fill):
    pool = rng.integers(0, 2**32, (n_slots, qcap), dtype=np.uint64).astype(
        np.uint32)
    slots = rng.integers(0, n_slots, nv).astype(np.int32)
    counts6 = rng.integers(0, fill, (nv, 6)).astype(np.int32)
    mask6 = rng.integers(0, 2, (nv, 6)).astype(np.int32)
    positions = rng.integers(-20, 20, (nv, 3)).astype(np.int32)
    return pool, slots, counts6, mask6, positions


@pytest.mark.parametrize("gather_cap", [4096, 256])  # padded, truncated
def test_expand_uploads_matches_jax(gather_cap):
    rng = np.random.default_rng(7)
    args = _draw_list(rng, 24, 512, 16, 60)
    total = int((args[2] * args[3]).sum())
    assert (total < gather_cap) == (gather_cap == 4096)
    ref = JPL._expand_uploads_impl(*(jnp.asarray(a) for a in args),
                                   gather_cap)
    pool = torch.from_numpy(args[0].view(np.int32))
    got = TPL._expand_uploads_impl(
        pool, *(torch.from_numpy(a) for a in args[1:]), gather_cap)
    np.testing.assert_array_equal(np.asarray(ref[0]).view(np.int32),
                                  got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    assert int(ref[2]) == int(got[2]) == total


def test_apply_insert_payload_matches_jax():
    """Flat-payload scatter into the pool and its counts6 mirror, padding
    entries duplicating entry 0 (QuadPool.prepare_insert_payload)."""
    rng = np.random.default_rng(3)
    k, mc, fp, qcap = 16, 512, 2048, 1024
    pool = rng.integers(0, 2**32, (32, qcap), dtype=np.uint64).astype(
        np.uint32)
    c6 = rng.integers(0, 50, (32, 6)).astype(np.int32)
    n = 9
    slots = np.zeros(k, np.int32)
    slots[:n] = rng.choice(32, n, replace=False)
    counts = np.zeros(k, np.int32)
    counts[:n] = rng.integers(0, 200, n)
    starts = np.zeros(k, np.int64)
    starts[:n] = np.cumsum(counts[:n]) - counts[:n]
    slots[n:], counts[n:], starts[n:] = slots[0], counts[0], starts[0]
    packed = np.zeros(3 * k + fp, np.uint32)
    packed[:k], packed[k:2 * k], packed[2 * k:3 * k] = slots, starts, counts
    total = int(counts[:n].sum())
    packed[3 * k:3 * k + total] = rng.integers(0, 2**32, total,
                                               dtype=np.uint64)
    ref_pool, ref_c6 = JPL.apply_insert_payload(
        jnp.asarray(pool), jnp.asarray(c6), jnp.asarray(packed), k=k, mc=mc)
    t_pool = torch.from_numpy(pool.view(np.int32).copy())
    t_c6 = torch.from_numpy(c6.copy())
    TPL.apply_insert_payload(t_pool, t_c6,
                             torch.from_numpy(packed.view(np.int32)),
                             k=k, mc=mc)
    np.testing.assert_array_equal(np.asarray(ref_pool).view(np.int32),
                                  t_pool.numpy())
    np.testing.assert_array_equal(np.asarray(ref_c6), t_c6.numpy())


def test_draw_list_uploads_unpack_like_jax():
    """META5 (+ camera) and the 11-short meta decode to the JAX values."""
    rng = np.random.default_rng(11)
    vcap, n = 64, 40
    _, slots, counts6, mask6, positions = _draw_list(rng, 100, 8, n, 9)
    vp = rng.normal(size=(4, 4)).astype(np.float32)
    cp = rng.normal(size=3).astype(np.float32)
    frame_u = np.concatenate([
        JPL._pack_meta5(vcap, slots, mask6, positions).view(np.uint32),
        JPL._pack_cam(vp, cp).view(np.uint32)])
    np.testing.assert_array_equal(
        frame_u.view(np.int32),
        np.concatenate([TPL._pack_meta5(vcap, slots, mask6, positions)
                        .view(np.int32), TPL._pack_cam(vp, cp)
                        .view(np.int32)]))
    meta_t, cam_t, _ = TPL._split_frame_u(
        torch.from_numpy(frame_u.view(np.int32)), vcap)
    n_meta = (JPL.META5_SHORTS * vcap) // 2
    ref5 = JPL._unpack_meta5(
        jnp.asarray(frame_u[:n_meta]).view(jnp.int16).reshape(-1), vcap)
    for r, g in zip(ref5, TPL._unpack_meta5(meta_t, vcap)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    np.testing.assert_array_equal(cam_t.numpy()[:16], vp.ravel())
    meta11 = JPL._pack_meta(vcap, slots, counts6, mask6, positions)
    np.testing.assert_array_equal(
        meta11, TPL._pack_meta(vcap, slots, counts6, mask6, positions))
    for r, g in zip(JPL._unpack_meta(jnp.asarray(meta11), vcap),
                    TPL._unpack_meta(torch.from_numpy(meta11), vcap)):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
