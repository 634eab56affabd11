"""The port's device mesher (ops/meshing_device.py) against the JAX
package's (ops/meshing_jax.py) and the host mesher, on the CPU.

The cases of tests/test_meshing_device.py, each held to the JAX function
on the same numpy inputs and to the host mesher, byte for byte: masks,
quads, counts, overflow and the per-direction histogram must be equal (the
meshers are integer code; no tolerance).  Then the engine: a port
``Engine(device_meshing=True)`` fills its pool as a host-meshed port
engine does (tests/test_engine.py test_device_meshing_pool_matches_host),
and renders the same frame; and in the resident mode a device-meshed
batch lands in the pool at once with no append queued, as the
reference's ``_mesh_list_resident`` does.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.meshing.greedy import (
    greedy_mesh_slice,
    mesh_chunk,
    slice_masks_for_chunk,
)
from differential_projection_voxel_renderer_tpu.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu.ops import meshing_jax as MJ
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.ops import (
    meshing_device as MD,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t):
    """A port tensor of u32 values (int64) or bits (int32) as uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _sparse_blocks(rng, p):
    return np.where(rng.random((32, 32, 32)) < p,
                    rng.integers(1, 4, (32, 32, 32)), 0).astype(np.uint8)


def test_greedy_merge_matches_host_on_random_slices():
    rng = np.random.default_rng(7)
    planes = rng.integers(0, 2**32, size=(64, 32), dtype=np.uint64).astype(
        np.uint32)
    quads, valid, overflow = MD.greedy_merge(_t(planes.astype(np.int64)),
                                             max_steps=512)
    rq, rv, ro = MJ.greedy_merge(jnp.asarray(planes), max_steps=512)
    np.testing.assert_array_equal(_u32(quads), np.asarray(rq))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(ro))
    assert not overflow.any()
    quads, valid = quads.numpy(), valid.numpy()
    for s in range(64):
        got = [(q & 0x1F, (q >> 5) & 0x1F, ((q >> 10) & 0x3F) + 1,
                ((q >> 16) & 0x3F) + 1)
               for q, v in zip(quads[s].tolist(), valid[s]) if v]
        assert got == greedy_mesh_slice(planes[s]), f"slice {s}"


def test_greedy_merge_overflow_reported():
    """A full checkerboard has 512 quads a plane: 8 steps overflow, and
    the 8 emitted are the first 8 in order."""
    checker = np.zeros((1, 32), np.uint32)
    checker[0, ::2] = 0x55555555
    checker[0, 1::2] = 0xAAAAAAAA
    quads, valid, overflow = MD.greedy_merge(
        _t(checker.astype(np.int64)), max_steps=8)
    rq, _, ro = MJ.greedy_merge(jnp.asarray(checker), max_steps=8)
    assert bool(overflow[0]) and bool(np.asarray(ro)[0])
    assert valid.all()
    np.testing.assert_array_equal(_u32(quads), np.asarray(rq))


def test_face_masks_match_host():
    rng = np.random.default_rng(3)
    chunks = [Chunk.generate_terrain((0, 0, 0)),
              Chunk.varied((1, 0, 0), rng.integers(0, 4, (32, 32, 32))
                           .astype(np.uint8))]
    chunks = [c for c in chunks if not c.is_uniform]
    blocks_by_pos = {tuple(c.position): c.dense() for c in chunks}
    positions = [c.position for c in chunks]
    planes = MD.neighbor_planes_from_batch(blocks_by_pos, positions)
    np.testing.assert_array_equal(
        planes, MJ.neighbor_planes_from_batch(blocks_by_pos, positions))
    blocks = np.stack([c.dense() for c in chunks])
    dev = _u32(MD.face_masks(_t(blocks), _t(planes)))
    np.testing.assert_array_equal(
        dev, np.asarray(MJ.face_masks(jnp.asarray(blocks),
                                      jnp.asarray(planes))))
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(dev[i], slice_masks_for_chunk(c, chunks),
                                      err_msg=f"chunk {i}")


def _three_chunks(seed):
    rng = np.random.default_rng(seed)
    chunks = [Chunk.generate_terrain((0, 0, 0)),
              Chunk.varied((1, 0, 0), _sparse_blocks(rng, 0.08)),
              Chunk.generate_test_solid((0, 0, 1))]
    blocks_by_pos = {tuple(c.position): c.dense() for c in chunks}
    positions = [c.position for c in chunks]
    planes = MD.neighbor_planes_from_batch(blocks_by_pos, positions)
    return chunks, np.stack([c.dense() for c in chunks]), planes


def test_mesh_chunks_device_matches_host():
    """Device quads == host quads == the JAX device mesher's, byte for
    byte, emission order included."""
    chunks, batch, planes = _three_chunks(9)
    dq, dc, dovf = MD.mesh_chunks_device(_t(batch), _t(planes),
                                         max_steps=512, qcap=16384)
    rq, rc, ro = MJ.mesh_chunks_device(jnp.asarray(batch),
                                       jnp.asarray(planes), max_steps=512,
                                       qcap=16384)
    np.testing.assert_array_equal(_u32(dq), np.asarray(rq))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(dovf.numpy(), np.asarray(ro))
    assert not dovf.any()
    dq, dc = _u32(dq), dc.numpy()
    for i, c in enumerate(chunks):
        host = mesh_chunk(c, chunks)
        host = host if host is not None else np.zeros(0, np.uint32)
        assert dc[i] == len(host), f"chunk {i} count"
        np.testing.assert_array_equal(dq[i, :dc[i]], host,
                                      err_msg=f"chunk {i}")


def test_mesh_chunks_device_overflow_truncates_in_order():
    """Past qcap a chunk keeps its first qcap quads in host order and
    counts the rest; past max_steps a plane keeps its first quads in order
    and counts itself, as the reference's."""
    rng = np.random.default_rng(9)
    blocks = _sparse_blocks(rng, 0.4)
    c = Chunk.varied((0, 0, 0), blocks)
    planes = MD.neighbor_planes_from_batch({(0, 0, 0): blocks}, [c.position])
    host = mesh_chunk(c, [c])
    dq, dc, dovf = MD.mesh_chunks_device(_t(blocks[None]), _t(planes),
                                         max_steps=512, qcap=4096)
    assert int(dovf[0]) == len(host) - 4096 and int(dc[0]) == 4096
    np.testing.assert_array_equal(_u32(dq)[0], host[:4096])
    # the engine's 64 steps: planes past them truncate in order
    dq, dc, dovf = MD.mesh_chunks_device(_t(blocks[None]), _t(planes),
                                         max_steps=16, qcap=8192)
    rq, rc, ro = MJ.mesh_chunks_device(jnp.asarray(blocks[None]),
                                       jnp.asarray(planes), max_steps=16,
                                       qcap=8192)
    assert int(dovf[0]) == int(np.asarray(ro)[0]) > 0
    assert int(dc[0]) == int(np.asarray(rc)[0]) < len(host)
    np.testing.assert_array_equal(_u32(dq), np.asarray(rq))


def test_mesh_chunks_device_bucketed_pads_and_histograms():
    """A batch of 3 chunks pads to bucket 4 by repeating chunk 0 (its row
    is chunk 0's, byte for byte), returns the host metadata sliced back to
    3, and its per-direction histogram is the host mesher's."""
    chunks, batch, planes = _three_chunks(11)
    quads, counts, overflow, c6, bucket = MD.mesh_chunks_device_bucketed(
        batch, planes, max_steps=512, qcap=16384, device="cpu")
    ref = MJ.mesh_chunks_device_bucketed(batch, planes, max_steps=512,
                                         qcap=16384)
    assert bucket == ref[4] == 4 and quads.shape == (4, 16384)
    np.testing.assert_array_equal(_u32(quads), np.asarray(ref[0]))
    for got, want in zip((counts, overflow, c6), ref[1:4]):
        np.testing.assert_array_equal(got, want)
    assert counts.shape == (3,) and c6.shape == (3, 6)
    assert not overflow.any()
    q = _u32(quads)
    np.testing.assert_array_equal(q[3], q[0])
    for i, c in enumerate(chunks):
        host = mesh_chunk(c, chunks)
        host = host if host is not None else np.zeros(0, np.uint32)
        assert counts[i] == len(host), f"chunk {i} count"
        np.testing.assert_array_equal(q[i, :counts[i]], host)
        dirs = (host.astype(np.uint64) >> 29) & 7
        np.testing.assert_array_equal(
            c6[i], np.bincount(dirs.astype(np.int64), minlength=6)[:6])


def test_mesh_bucket_for_ladder():
    sizes = (1, 2, 3, 5, 16, 17, 512, 600)
    assert [MD.mesh_bucket_for(b) for b in sizes] == [
        MJ.mesh_bucket_for(b) for b in sizes] == [1, 2, 4, 8, 16, 32, 512,
                                                  512]
    assert MD.MESH_BUCKETS == MJ.MESH_BUCKETS


def _engine(**kw):
    eng = TE.Engine(TE.RenderConfig(width=128, height=128, gather_cap=8192,
                                    quads_cap=4096, visible_chunks_cap=64),
                    TE.WorldConfig(view_distance=2,
                                   max_chunks_per_frame=1000),
                    pool_slots=128, device="cpu", **kw)
    eng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, -60.0], np.float32))
    while eng.world.update(eng.camera.position):
        pass
    return eng


def _same_pools(a, b):
    assert a.by_pos.keys() == b.by_pos.keys()
    qa, qb = a.quads.numpy(), b.quads.numpy()
    for pos, sa in a.by_pos.items():
        sb = b.by_pos[pos]
        ca = a.counts[sa]
        assert ca == b.counts[sb]
        np.testing.assert_array_equal(a.counts6[sa], b.counts6[sb])
        np.testing.assert_array_equal(qa[sa, :ca], qb[sb, :ca])
        # the host counts6 is the face-direction histogram of the rows
        dirs = (qb[sb, :ca].view(np.uint32) >> 29) & 7
        np.testing.assert_array_equal(
            np.bincount(dirs, minlength=6)[:6], b.counts6[sb])


@pytest.fixture(scope="module")
def primed():
    host, dev = _engine(), _engine(device_meshing=True)
    for eng in (host, dev):
        eng.prime_all()
    return host, dev


def test_device_meshing_pool_matches_host(primed):
    """tests/test_engine.py's pool equality on the port: a device-meshed
    ``prime_all`` fills the pool as the host mesher does, rows and
    counts, each counts6 the face-direction histogram of its rows, with no
    overflow; the frame is the same."""
    host, dev = primed
    assert dev.device_meshing and len(dev.pool.by_pos) > 20
    _same_pools(host.pool, dev.pool)
    assert dev.pool.overflow_drops == host.pool.overflow_drops == 0
    fh, fd = host.render_frame(dt=0.0), dev.render_frame(dt=0.0)
    assert torch.equal(fh.color, fd.color) and torch.equal(fh.depth,
                                                           fd.depth)
    assert torch.equal(fh.stats, fd.stats) and int(fh.stats[1]) > 500


def test_device_meshing_pool_matches_jax_engine(primed):
    """The JAX Engine(device_meshing=True) of the same configuration
    primes the same pool."""
    from differential_projection_voxel_renderer_tpu.app import engine as JE
    from differential_projection_voxel_renderer_tpu.models import world as JW
    from differential_projection_voxel_renderer_tpu.utils import (
        config as JCFG,
    )

    jeng = JE.Engine(
        render_config=JCFG.RenderConfig(width=128, height=128,
                                        use_pallas=False, gather_cap=8192,
                                        quads_cap=4096,
                                        visible_chunks_cap=64),
        world_config=JW.WorldConfig(view_distance=2,
                                    max_chunks_per_frame=1000),
        pool_slots=128, device_meshing=True)
    jeng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
    jeng.camera.look_at(np.array([0.0, 0.0, -60.0], np.float32))
    while jeng.world.update(jeng.camera.position):
        pass
    jeng.prime_all()
    dev = primed[1].pool
    assert jeng.pool.by_pos == dev.by_pos
    np.testing.assert_array_equal(np.asarray(jeng.pool.quads),
                                  dev.quads.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jeng.pool.counts6_dev),
                                  dev.counts6)
    np.testing.assert_array_equal(jeng.pool.counts, dev.counts)
    np.testing.assert_array_equal(jeng.pool.counts6, dev.counts6)


def test_device_meshing_resident_batch_lands_in_pool():
    """Resident mode: a device-meshed batch (4 chunks or more) scatters
    into the pool at once and queues no append payload, as the
    reference's ``_mesh_list_resident``; a smaller batch takes the host
    mesher and the queued payload."""
    eng = _engine(device_meshing=True, resident_stream=True)
    ref = _engine()
    batch = sorted(eng.world.chunks)[:6]
    eng._mesh_list_resident(batch)
    assert eng._res_insert is None
    ref._mesh_list(batch)
    _same_pools(ref.pool, eng.pool)
    eng._mesh_list_resident(sorted(eng.world.chunks)[6:8])
    assert eng._res_insert is not None
