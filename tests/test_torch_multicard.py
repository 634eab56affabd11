"""The sharded render over a mesh of devices, on the CPU, against the JAX
package (``parallel/sharded_render.py`` of both).

- ``make_mesh``: device k of the port's mesh sits where JAX's ``make_mesh``
  puts device k of the 8-device virtual CPU mesh of tests/conftest.py, for
  n = 1..8; without ``devices=`` it takes distinct CUDA cards only, and
  raises when there are fewer than asked for;
- ``make_sharded_render`` on a mesh that lists the CPU eight times (its
  shards run in turn, eagerly): the (camera, row range) each shard holds is the
  one JAX's output sharding (``devices_indices_map``) gives the device at
  the same mesh position; colours equal JAX's and depths within 16 float32
  ulps of them (JAX renders with its jnp path on the CPU, whose plane
  evaluations XLA contracts into FMAs, as in tests/test_torch_bands.py);
  each camera's stacked bands equal the port's full-frame step bit for
  bit; the count equals JAX's ``psum(count, "tp") // tp`` of its Pallas
  band steps (interpret mode) on every tp shard;
- the tp all-reduce's CPU form, the replicated scene kept across calls, a
  shard's exception, and ``dryrun_multichip`` on CPU meshes.

Tolerances: colours and counts equal; depths against JAX within 16 ulps;
the port's bands against its own full frame bit-equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.meshing.greedy import mesh_chunk
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu.parallel import (
    sharded_render as JS,
)
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch import graft_entry as TG
from differential_projection_voxel_renderer_tpu_torch.parallel import (
    sharded_render as TS,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

W = H = 128
GQ, RCAP, KCAP = 1024, 512, 512
JNP_ULPS = 16
CAMS = [(60.0, 70.0, 90.0), (-50.0, 40.0, 70.0)]
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def scene():
    """tests/test_parallel.py's scene (one solid chunk in an 8-slot pool)
    and the batch of the two cameras as numpy inputs of the sharded
    render."""
    quads = mesh_chunk(Chunk.generate_test_solid((0, 0, 0)))
    pool = np.zeros((8, 512), np.uint32)
    pool[0, :len(quads)] = quads
    counts = np.zeros(8, np.int32)
    counts[0] = len(quads)
    cams = [_camera(p) for p in CAMS]
    return (pool, counts, np.zeros((8, 3), np.int32),
            np.zeros((2, 8), np.int32), np.ones(2, np.int32),
            np.stack([c[0] for c in cams]), np.stack([c[1] for c in cams]))


def _camera(pos):
    cam = Camera(np.array(pos, np.float32), 1.0)
    cam.look_at(np.array([16.0, 16.0, 16.0]))
    return (cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32))


def _torch(scene):
    return tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                  else x) for x in scene)


def _stream(scene, i):
    """The numpy step inputs of camera i's stream."""
    pool, counts = scene[:2]
    nq = int(counts[0])
    stream = np.zeros(GQ, np.uint32)
    stream[:nq] = pool[0, :nq]
    return (stream, np.zeros((3, GQ), np.float32), nq, scene[5][i],
            scene[6][i], (W, H, GQ))


def _fn(mesh):
    return TS.make_sharded_render(mesh, width=W, height=H, gather_cap=GQ,
                                  render_cap=RCAP, tile_k_cap=KCAP)


@pytest.fixture(scope="module")
def jax_ref(scene):
    """JAX's 8-device sharded render of the batch (jnp path), and each
    camera's band counts by its Pallas step in interpret mode, 4 bands."""
    jmesh = JS.make_mesh(8)
    out = JS.make_sharded_render(jmesh, width=W, height=H, gather_cap=GQ,
                                 render_cap=RCAP)(
        *(jnp.asarray(x) for x in scene))
    kw = dict(S.jax_step_kw((None,) * 5 + ((W, H, GQ),), RCAP),
              tile_k_cap=KCAP)
    bh = H // 4
    bands = [[int(np.asarray(JPL._render_step(
        *S.jax_args(_stream(scene, i)), band_y0=t * bh, band_h=bh,
        **kw)[2][1])) for t in range(4)] for i in range(2)]
    return jmesh, out, bands


def test_make_mesh_lays_devices_out_as_jax():
    assert len(jax.devices()) == 8
    listed = [torch.device("cpu", k) for k in range(8)]
    for n in range(1, 9):
        jmesh = JS.make_mesh(n)
        mesh = TS.make_mesh(n, devices=listed)
        assert mesh.devices.shape == jmesh.devices.shape
        got = np.vectorize(lambda d: d.index, otypes=[int])(mesh.devices)
        want = np.vectorize(lambda d: d.id, otypes=[int])(jmesh.devices)
        np.testing.assert_array_equal(got, want)
        assert mesh.flat == listed[:n]


def test_shards_hold_jax_output_slices(scene, jax_ref):
    """Each shard's bands are the (camera, row) block that JAX's output
    sharding gives the device at the shard's mesh position."""
    jmesh, out, _ = jax_ref
    index = out[0].sharding.devices_indices_map(out[0].shape)
    fn = _fn(TS.make_mesh(8, devices=CPU8))
    shards = fn.bands(*_torch(scene))
    fn.reduce(shards)
    color, depth, _ = fn.gather(shards)
    for jdev, idx in index.items():
        i, t = np.argwhere(jmesh.devices == jdev)[0]
        cs, ds, _ = shards[i, t]
        assert torch.equal(torch.stack(cs), color[idx])
        assert torch.equal(torch.stack(ds), depth[idx])
        assert torch.equal(color[idx], torch.from_numpy(
            np.array(out[0])[idx]))


def test_sharded_render_on_a_cpu_mesh_matches_jax(scene, jax_ref):
    _, out, bands = jax_ref
    fn = _fn(TS.make_mesh(8, devices=CPU8))
    shards = fn.bands(*_torch(scene))
    fn.reduce(shards)
    color, depth, count = fn.gather(shards)
    d_ref, d_got = np.asarray(out[1]), depth.numpy()
    np.testing.assert_array_equal(np.asarray(out[0]), color.numpy())
    fin = np.isfinite(d_ref)
    np.testing.assert_array_equal(fin, np.isfinite(d_got))
    assert (np.abs(d_ref[fin] - d_got[fin])
            <= JNP_ULPS * np.spacing(np.abs(d_ref[fin]))).all()
    kw = dict(S.torch_step_kw((None,) * 5 + ((W, H, GQ),), RCAP),
              tile_k_cap=KCAP)
    for i in range(2):
        full = TPL.render_step(*S.torch_args(_stream(scene, i)), **kw)
        assert torch.equal(color[i], full[0])
        assert torch.equal(depth[i], full[1])
        want = sum(bands[i]) // 4
        assert want > 0 and int(count[i]) == want
        assert [int(shards[i, t][2][0]) for t in range(4)] == [want] * 4


def test_all_reduce_sum_on_the_cpu():
    counts = [torch.tensor([k, 10 * k], dtype=torch.int32) for k in (1, 2, 4)]
    got = TS.all_reduce_sum(counts)
    assert len(got) == 3
    for g in got:
        assert g.dtype == torch.int32 and g.tolist() == [7, 70]
    one = [torch.tensor([5], dtype=torch.int32)]
    assert TS.all_reduce_sum(one)[0] is one[0]


def test_replicated_scene_is_not_copied_again(scene, monkeypatch):
    pools = []
    render = TS._render_one_camera

    def record(pool, *a, **kw):
        pools.append(pool.data_ptr())
        return render(pool, *a, **kw)

    monkeypatch.setattr(TS, "_render_one_camera", record)
    mesh = TS.make_mesh(4, devices=["cpu"] * 4)
    args = _torch(scene)
    rep = [TS.replicate(mesh, x) for x in args[:3]]
    assert TS.replicate(mesh, rep[0]) is rep[0]
    fn = _fn(mesh)
    first = fn(*rep, *args[3:])
    second = fn(*rep, *args[3:])
    assert pools == [rep[0].on(torch.device("cpu")).data_ptr()] * 8
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_shard_exception_reaches_the_caller(scene, monkeypatch):
    done = []
    render = TS._render_one_camera

    def fail_band_one(*a, band_y0, **kw):
        if band_y0 == H // 2:
            raise RuntimeError("band 1 failed")
        done.append(band_y0)
        return render(*a, band_y0=band_y0, **kw)

    monkeypatch.setattr(TS, "_render_one_camera", fail_band_one)
    mesh = TS.make_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="band 1 failed"):
        _fn(mesh)(*_torch(scene))
    assert done == [0]  # shard (0, 0) ran; (0, 1) raised
    calls = []
    step = TS.render_step

    def fail_third(*a, **kw):
        calls.append(len(calls))
        if len(calls) == 3:
            raise RuntimeError("camera 2 failed")
        return step(*a, **kw)

    monkeypatch.setattr(TS, "render_step", fail_third)
    fn, _ = TS.make_sharded_render_dp(mesh, width=W, height=H,
                                      render_cap=RCAP, tile_k_cap=KCAP)
    streams = [S.torch_args(_stream(scene, i % 2)) for i in range(4)]
    with pytest.raises(RuntimeError, match="camera 2 failed"):
        fn(*(torch.stack([s[k] for s in streams]) for k in range(5)))
    assert calls == [0, 1, 2]
    with pytest.raises(ValueError, match="over 4 devices"):
        fn(*(torch.stack([s[k] for s in streams[:3]]) for k in range(5)))


@pytest.mark.parametrize("available,count", [(False, 0), (True, 2)])
def test_make_mesh_needs_as_many_cards(monkeypatch, available, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    with pytest.raises(RuntimeError, match=f"{count} are available"):
        TS.make_mesh(4)
    with pytest.raises(RuntimeError, match=f"{count} are available"):
        TS.make_sharded_render_dp(4, width=W, height=H)
    with pytest.raises(ValueError, match="from 2 listed"):
        TS.make_mesh(4, devices=["cpu"] * 2)


@pytest.mark.parametrize("n,shape", [(4, (2, 2)), (8, (2, 4))])
def test_dryrun_multichip_on_a_cpu_mesh(capfd, n, shape):
    mesh = TG.dryrun_multichip(n, device="cpu")
    assert tuple(mesh) == shape
    assert mesh.flat == [torch.device("cpu")] * n
    assert f"dryrun_multichip({n}): (dp, tp) = {shape}" in capfd.readouterr().err
