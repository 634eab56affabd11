"""The port's resident superset stream (``Engine(resident_stream=True)``,
``DPVR_RESIDENT=1``) against the JAX package's, on the CPU.

- The host helpers (``resident_append_cap``, ``pack_append_meta``) equal
  the JAX ones; the resident steps refuse ``two_pass_near_quads`` with the
  reference's ValueError.
- The append steps (``_step_camf_append``, ``_step_camf_append_insert``)
  against the JAX steps at 256x128, at a mid-stream offset, at an offset
  whose window runs past the stream's end (the window start clamps as
  ``jax.lax.dynamic_slice`` clamps it) and with an empty batch: the
  returned streams and the pool equal bit for bit, the reference's counts
  mirror equal to the port's host counts, and the stats too.  The JAX
  steps run their jnp path (its Pallas kernels in interpret mode would
  cost this file half a minute of tracing), whose XLA:CPU program
  contracts multiply-adds, so frames go through the gates below (with
  depth within 4 ulps where the colours agree).
- A JAX and a port resident engine fly the streaming path of
  tests/test_engine.py's resident cases (8 of its moving frames), then
  settle (the camera held until the stash drains, a frame, then
  ``invalidate_resident()`` and the rebuilt frame), on ``_small_engine``'s
  configuration (256x128, view distance 3, gather cap 16384, 512 pool
  slots; the default item cap, since the port bins and the JAX jnp path
  does not): the resident
  streams (``_res_uploads``) equal bit for bit, ``_res_total``,
  ``_res_cell``, ``_res_appends``, ``_res_fused_inserts``, the late
  batches and the stats equal frame for frame.  Frames go through the
  gates of tests/test_torch_app.py (tests/_torch_scenes.py
  ``assert_engine_frame_gates`` with ``JNP_DEPTH_ULPS``: the JAX engine
  runs its jnp path, whose XLA:CPU program contracts multiply-adds; every
  colour mismatch proven by the boundary gate) against the port's raster
  records of the resident stream.  In both packages the frame on the
  appended stream equals the rebuilt one bit for bit.
  (tests/test_torch_engine.py holds the port's resident frames to its
  serial frames bit for bit on the primed flight, and
  tests/test_torch_app.py runs the resident-append self-test.)
- ``warm_resident`` leaves the pool and every later frame as an unwarmed
  resident engine's, bit for bit.
- Quads that straddle the near plane, which the resident stream carries
  by the hundred (chunks behind the camera are in it): the reference
  boxes each as the whole screen, and its binning keeps the first 64 of
  those over more than 64 tiles (``HUGE_CAP``) by stream index, so that
  at 640x256 (80 tiles) its Pallas step drops a visible floor behind 100
  copies of a wall beside the view; the port's stage A bounds their
  boxes by their visible part (``ops/projection.py``
  ``STRADDLE_MARGIN``), drops none and renders the frame the reference's
  boxes give with a huge cap that drops nothing, default and packed.  On
  views among the terrain's chunks the port's boxes and the reference's
  give the same frame bit for bit, with fewer items.
- The deliberate divergence from the reference: ``DPVR_RES_BUDGET``
  is clamped to at least 1 and falls back to RESIDENT_INSERT_KP when it is
  not an integer.  The port keeps no device counts mirror, so an unload
  that meets a queued payload leaves the pools of both packages equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.rendering import (
    pipeline as JPL,
)
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE
from differential_projection_voxel_renderer_tpu_torch.meshing.greedy import (
    mesh_chunk,
)
from differential_projection_voxel_renderer_tpu_torch.models.camera import (
    Camera,
)
from differential_projection_voxel_renderer_tpu_torch.models.chunk import Chunk
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)

W, H, GC = 256, 128, 16384
N_CHUNKS = 8   # the meshed chunks of the step tests' terrain patch
APPEND_CAP = TPL.resident_append_cap(GC)


# ------------------------------------------------------------ host helpers


@pytest.mark.parametrize("stream_len", [0, 1000, 2048, 2049, 16384, 131072,
                                        262144, 10**6])
def test_resident_append_cap_matches_jax(stream_len):
    assert (TPL.resident_append_cap(stream_len)
            == JPL.resident_append_cap(stream_len))


def test_resident_constants_match_jax():
    for name in ("RESIDENT_APPEND_VCAP", "RESIDENT_APPEND_CAP",
                 "RESIDENT_INSERT_KP", "RESIDENT_INSERT_MC",
                 "RESIDENT_INSERT_FP"):
        assert getattr(TPL, name) == getattr(JPL, name), name


@pytest.mark.parametrize("nv", [0, 1, 17, 64])
def test_pack_append_meta_matches_jax(nv):
    rng = np.random.default_rng(nv)
    slots = rng.integers(0, 4096, nv).astype(np.int32)
    c6 = rng.integers(0, 500, (nv, 6)).astype(np.int32)
    pos = rng.integers(-40, 40, (nv, 3)).astype(np.int32)
    got = TPL.pack_append_meta(slots, c6, pos)
    np.testing.assert_array_equal(got, JPL.pack_append_meta(slots, c6, pos))
    assert got.dtype == np.int32


# ------------------------------------------------------------ append steps


@pytest.fixture(scope="module")
def step_scene():
    """The eight meshed chunks of a 3x3 terrain patch in a pool, a batch of
    two of them (the third and fourth smallest) and the stream of the other
    six: (pool u32[S, Q], counts6, positions, stream u32[GC], quad_world,
    stream total, batch slots, camera)."""
    chunks = [Chunk.generate_terrain((x, 0, z)) for x in (-1, 0, 1)
              for z in (-1, 0, 1)]
    meshes = [(c, q) for c in chunks
              if (q := mesh_chunk(c, chunks)) is not None]
    assert len(meshes) == N_CHUNKS
    pool = np.zeros((16, 4096), np.uint32)
    counts6 = np.zeros((16, 6), np.int32)
    positions = np.zeros((16, 3), np.int32)
    for s, (c, q) in enumerate(meshes):
        pool[s, :len(q)] = q
        counts6[s] = TE._dir_counts(q)
        positions[s] = c.position
    order = np.argsort(counts6.sum(1)[:N_CHUNKS], kind="stable")
    batch = np.sort(order[2:4]).astype(np.int32)
    rest = np.array([s for s in range(N_CHUNKS) if s not in batch],
                    np.int32)
    quads, qw, total = TPL._expand_uploads_impl(
        torch.from_numpy(pool.view(np.int32)), torch.from_numpy(rest),
        torch.from_numpy(counts6[rest]), torch.ones((6, 6), dtype=torch.int32),
        torch.from_numpy(positions[rest]), GC)
    assert int(counts6[batch].sum()) < APPEND_CAP
    cam = Camera(np.array([0.0, 40.0, 70.0], np.float32), W / H)
    cam.look_at(np.array([0.0, 8.0, 0.0], np.float32))
    # past the stream's total, quads behind the camera (the clamped case
    # renders the whole stream; these cost the raster nothing)
    quads, qw = quads.numpy().view(np.uint32), qw.numpy()
    quads[int(total):] = 0
    qw[:, int(total):] = np.array([[0.0], [0.0], [1e4]], np.float32)
    return (pool, counts6, positions, quads, qw, int(total), batch, cam)


def _jax_kw():
    return dict(color_tables=S.TABLES, width=W, height=H, tile_h=16,
                tile_w=128, gather_cap=GC, render_cap=8192, span_mode=False,
                backface_culling=True, use_pallas=False, interpret=False,
                tile_k_cap=2 * GC, append_cap=APPEND_CAP)


def _torch_kw():
    return dict(color_tables=TP.color_table_tensors(S.TABLES, "cpu"),
                width=W, height=H, tile_h=16, tile_w=128, render_cap=8192,
                tile_k_cap=2 * GC, append_cap=APPEND_CAP)


# case -> (window offset, whether the batch holds its chunks); the total
# rendered is the offset plus the batch, at most the stream's length
STEP_CASES = {"mid-stream": (None, True),
              "clamped": (GC - APPEND_CAP // 2, True),
              "empty batch": (None, False)}


def _case(step_scene, case):
    pool, counts6, positions, _, _, total, batch, _ = step_scene
    offset, full = STEP_CASES[case]
    offset = total if offset is None else offset
    slots = batch if full else batch[:0]
    ameta = TPL.pack_append_meta(slots, counts6[slots], positions[slots])
    nk = int(counts6[slots].sum())
    assert (offset + APPEND_CAP > GC) == (case == "clamped")
    return ameta, offset, min(offset + nk, GC), nk


def _assert_same_frames(jout, tout, n, cam_f):
    """The JAX step's frame and stats against the port's, through the
    gates, with the port's raster records of the appended stream."""
    kw = _torch_kw()
    del kw["append_cap"]
    records = TPL._step_camf(tout[3], tout[4], n, torch.from_numpy(cam_f),
                             debug_return_records=True, **kw)[0].numpy()
    ref = tuple(np.asarray(x) for x in jout[:3])
    got = tuple(x.numpy() for x in tout[:3])
    S.assert_engine_frame_gates(
        (ref[0].view(np.uint32), ref[1], ref[2]),
        (got[0].view(np.uint32), got[1], got[2]), records)


def _assert_appended(step_scene, case, quads2, qw2, quads_in):
    """The window took the batch's expansion where it should (the clamped
    start), and the stream passed in is unchanged."""
    _, _, _, stream, qw, _, _, _ = step_scene
    ameta, offset, _, nk = _case(step_scene, case)
    start = min(offset, GC - APPEND_CAP)
    q2 = quads2.view(np.uint32)
    np.testing.assert_array_equal(q2[:start], stream[:start])
    np.testing.assert_array_equal(q2[start + nk:], stream[start + nk:])
    np.testing.assert_array_equal(qw2[:, start + nk:], qw[:, start + nk:])
    if nk:
        assert not np.array_equal(q2[start:start + nk],
                                  stream[start:start + nk])
    np.testing.assert_array_equal(quads_in.numpy().view(np.uint32), stream)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_camf_append_matches_jax(step_scene, case):
    pool, _, _, stream, qw, _, _, cam = step_scene
    ameta, offset, n, _ = _case(step_scene, case)
    cam_f = TPL._pack_cam(cam.view_projection_matrix(), cam.position)
    jout = JPL._step_camf_append(
        jnp.asarray(stream), jnp.asarray(qw), jnp.int32(n),
        jnp.asarray(cam_f), jnp.asarray(pool), jnp.asarray(ameta),
        jnp.int32(offset), **_jax_kw())
    quads_in = torch.from_numpy(stream.view(np.int32).copy())
    tout = TPL._step_camf_append(
        quads_in, torch.from_numpy(qw.copy()), n, torch.from_numpy(cam_f),
        torch.from_numpy(pool.view(np.int32)), torch.from_numpy(ameta),
        offset, **_torch_kw())
    np.testing.assert_array_equal(np.asarray(jout[3]),
                                  tout[3].numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jout[4]), tout[4].numpy())
    _assert_same_frames(jout, tout, n, cam_f)
    _assert_appended(step_scene, case, tout[3].numpy(), tout[4].numpy(),
                     quads_in)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_camf_append_insert_matches_jax(step_scene, case):
    """The batch's chunks arrive in the payload: the pool starts without
    them, the step scatters them and appends them from the scattered
    pool."""
    pool, counts6, positions, stream, qw, _, batch, cam = step_scene
    ameta, offset, n, _ = _case(step_scene, case)
    tpool = TE.QuadPool(16, 4096, device="cpu")
    keep = [s for s in range(N_CHUNKS) if s not in batch]
    tpool.insert_many([(tuple(positions[s]), pool[s, :counts6[s].sum()])
                       for s in keep])
    if STEP_CASES[case][1]:
        payload = tpool.prepare_insert_payload(
            [(tuple(positions[s]), pool[s, :counts6[s].sum()])
             for s in batch], kp=TPL.RESIDENT_INSERT_KP,
            mc=TPL.RESIDENT_INSERT_MC, fp=TPL.RESIDENT_INSERT_FP)
        slots = np.array([tpool.by_pos[tuple(positions[s])] for s in batch],
                         np.int32)
        ameta = TPL.pack_append_meta(slots, tpool.counts6[slots],
                                     tpool.positions[slots])
    else:
        # an empty batch still scatters: a payload of one empty mesh
        payload = tpool.prepare_insert_payload(
            [((50, 0, 50), np.zeros(0, np.uint32))],
            kp=TPL.RESIDENT_INSERT_KP, mc=TPL.RESIDENT_INSERT_MC,
            fp=TPL.RESIDENT_INSERT_FP)
    pool0 = tpool.quads.numpy().view(np.uint32).copy()
    c60 = tpool.counts6.copy()
    frame_i = np.concatenate([
        ameta, TPL._pack_cam(cam.view_projection_matrix(),
                             cam.position).view(np.int32),
        np.asarray([offset], np.int32), payload.view(np.int32)])
    jkw = dict(_jax_kw(), kp=TPL.RESIDENT_INSERT_KP,
               mc=TPL.RESIDENT_INSERT_MC)
    jout = JPL._step_camf_append_insert(
        jnp.asarray(stream), jnp.asarray(qw), jnp.int32(n),
        jnp.asarray(frame_i), jnp.asarray(pool0), jnp.asarray(c60), **jkw)
    quads_in = torch.from_numpy(stream.view(np.int32).copy())
    tout = TPL._step_camf_append_insert(
        quads_in, torch.from_numpy(qw.copy()), n, torch.from_numpy(frame_i),
        tpool.quads, kp=TPL.RESIDENT_INSERT_KP, mc=TPL.RESIDENT_INSERT_MC,
        **_torch_kw())
    assert len(tout) == 5
    np.testing.assert_array_equal(np.asarray(jout[3]),
                                  tout[3].numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jout[4]), tout[4].numpy())
    # the pool updated in place; the reference's counts mirror after its
    # scatter is the port's host counts
    np.testing.assert_array_equal(np.asarray(jout[5]),
                                  tpool.quads.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jout[6]), tpool.counts6)
    _assert_same_frames(jout, tout, n, frame_i[640:659].view(np.float32))
    _assert_appended(step_scene, case, tout[3].numpy(), tout[4].numpy(),
                     quads_in)


# ------------------------------------------------------------ engines

N_STREAMING = 8   # moving frames of the streaming flight


def _configs(render_config_cls, world_config_cls):
    # tests/test_engine.py _small_engine, with the default item cap
    return dict(
        render_config=render_config_cls(width=W, height=H, gather_cap=GC,
                                        quads_cap=8192),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=64),
        pool_slots=512)


def _engine(port, resident=True):
    if port:
        eng = TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                        resident_stream=resident, device="cpu")
    else:
        eng = JE.Engine(**_configs(JCFG.RenderConfig, JW.WorldConfig),
                        resident_stream=resident)
    eng.camera.position = np.array([0.0, 40.0, 60.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, 0.0]))
    return eng


def _fly(eng, poses, port):
    """Render ``poses`` ((position offset, yaw step) a frame, None to hold
    the camera) and record each frame: (frame tuple, late batch, resident
    state, port raster records, whether an unload met a queued payload,
    the pool by chunk: ``_pool_by_chunk``)."""
    calls = []
    for name in ("_mesh_list", "_mesh_list_resident"):
        orig = getattr(eng, name)

        def spy(to_mesh, *a, orig=orig, **k):
            calls.append(list(to_mesh))
            return orig(to_mesh, *a, **k)
        setattr(eng, name, spy)
    base = eng.camera.position.copy()
    out = []
    for pose in poses:
        if pose is not None:
            eng.camera.position = base + np.asarray(pose[0], np.float32)
            eng.camera.yaw += pose[1]
        k0 = len(calls)
        unload = eng.world.unload_version
        queued = eng._res_insert is not None
        res = eng.render_frame(dt=0.0)
        out.append((S.frame_tuple(res),
                    sorted({tuple(p) for c in calls[k0:] for p in c}),
                    S.resident_state(eng),
                    S.resident_records(eng) if port else None,
                    queued and eng.world.unload_version != unload,
                    _pool_by_chunk(eng.pool)))
    return out


def _pool_by_chunk(pool):
    """{chunk position: (host counts6, device row up to its count as
    bytes)} of a pool (either package)."""
    quads = pool.quads
    quads = (quads.numpy().view(np.uint32) if isinstance(quads, torch.Tensor)
             else np.asarray(quads))
    return {pos: (pool.counts6[s].tolist(),
                  quads[s, :pool.counts[s]].tobytes())
            for pos, s in pool.by_pos.items()}


def _streaming_poses():
    moving = [((18.0 * i, 0.0, -9.0 * i), 0.015)
              for i in range(1, N_STREAMING + 1)]
    return moving


@pytest.fixture(scope="module")
def streaming():
    """tests/test_engine.py's resident streaming flight (prime() only, so
    visible chunks stream in), JAX and port, then the settle: the camera
    held until the stash drains and one more frame, then
    invalidate_resident() and the rebuilt frame."""
    out = {}
    for name in ("jax", "port"):
        eng = _engine(name == "port")
        eng.world.generate_region((-3, -1, -3), (3, 1, 3))
        eng.prime()
        frames = _fly(eng, _streaming_poses(), name == "port")
        settle = 0
        while eng._stale_stash:
            frames += _fly(eng, [None], name == "port")
            settle += 1
        frames += _fly(eng, [None], name == "port")
        appended = eng._res_total
        eng.invalidate_resident()
        frames += _fly(eng, [None], name == "port")
        out[name] = dict(frames=frames, settle=settle, appended=appended,
                         pool=S.pool_tables(eng.pool), eng=eng)
    return out


@pytest.mark.parametrize("frame", range(N_STREAMING))
def test_streaming_frame_matches_jax(streaming, frame):
    """Moving frame ``frame``: the late batch, the resident stream and its
    bookkeeping exact, stats exact, the frame under the gates."""
    jf, tf = streaming["jax"]["frames"], streaming["port"]["frames"]
    assert jf[frame][1] == tf[frame][1]
    S.assert_same_resident_state(jf[frame][2], tf[frame][2])
    S.assert_engine_frame_gates(jf[frame][0], tf[frame][0], tf[frame][3],
                                depth_ulps=S.JNP_DEPTH_ULPS)


def test_streaming_flight_appends_and_settles(streaming):
    """The streaming contract (tests/test_engine.py
    test_resident_streaming_stale_bounded_and_settles and
    test_resident_append_matches_rebuild): appends and fused inserts ran;
    the settle frames match JAX's; the frame on the appended stream equals
    the rebuilt stream's bit for bit, in both packages; the pools end
    equal on every chunk."""
    jax_, port = streaming["jax"], streaming["port"]
    assert port["settle"] == jax_["settle"]
    jf, tf = jax_["frames"], port["frames"]
    assert len(jf) == len(tf) == N_STREAMING + port["settle"] + 2
    for a, b in zip(jf[N_STREAMING:], tf[N_STREAMING:]):
        assert a[1] == b[1]
        S.assert_same_resident_state(a[2], b[2])
        S.assert_engine_frame_gates(a[0], b[0], b[3],
                                    depth_ulps=S.JNP_DEPTH_ULPS)
    eng = port["eng"]
    assert eng.resident_stream and eng._res_appends > 0
    assert eng._res_fused_inserts > 0
    assert not eng._stale_stash and port["appended"] == jax_["appended"]
    for frames in (jf, tf):
        appended, rebuilt = frames[-2][0], frames[-1][0]
        np.testing.assert_array_equal(appended[0], rebuilt[0])
        np.testing.assert_array_equal(appended[1], rebuilt[1])
    assert tf[-1][2]["total"] <= port["appended"]
    a, b = jax_["pool"], port["pool"]
    assert a[0] == b[0]
    live = np.array(sorted(a[0].values()))
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x[live], y[live])


def test_unload_with_a_queued_payload_keeps_the_mirror(streaming):
    """Unloads that met a queued payload, on the same frames in both
    packages: after every frame of the flight each pooled chunk's host
    counts and device row (up to its count) are the reference's.  The port
    keeps no device counts mirror (the host counts are the one source of
    counts), so the order of the payload's scatter and the slots' release
    is the reference's and nothing needs mending after it."""
    jf, tf = streaming["jax"]["frames"], streaming["port"]["frames"]
    hits = [i for i, f in enumerate(tf) if f[4]]
    assert hits and hits == [i for i, f in enumerate(jf) if f[4]]
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert a[5] == b[5]


@pytest.mark.parametrize("value,port,jax_", [
    ("0", 1, 0), ("-3", 1, -3), ("x", TPL.RESIDENT_INSERT_KP, ValueError),
    ("", TPL.RESIDENT_INSERT_KP, ValueError),
    ("5", 5, 5), (None, TPL.RESIDENT_INSERT_KP, TPL.RESIDENT_INSERT_KP)])
def test_resident_budget_is_clamped(monkeypatch, value, port, jax_):
    """Deliberate divergence (ADVICE.md, engine.py:517): DPVR_RES_BUDGET is
    at least 1 and falls back to RESIDENT_INSERT_KP when it is not an
    integer.  The reference takes int() of it as given: 0 or less never
    drains the stash, a non-integer raises at construction."""
    if value is None:
        monkeypatch.delenv("DPVR_RES_BUDGET", raising=False)
    else:
        monkeypatch.setenv("DPVR_RES_BUDGET", value)
    kw = dict(world_config=None, pool_slots=16)
    assert TE.Engine(TE.RenderConfig(width=128, height=128), **kw,
                     device="cpu").resident_mesh_budget == port
    if jax_ is ValueError:
        with pytest.raises(ValueError):
            JE.Engine(JCFG.RenderConfig(width=128, height=128), **kw)
    else:
        assert JE.Engine(JCFG.RenderConfig(width=128, height=128),
                         **kw).resident_mesh_budget == jax_


@pytest.mark.parametrize("value,want", [("1", True), ("0", False),
                                        ("", False)])
def test_resident_mode_reads_its_environment_switch(monkeypatch, value,
                                                   want):
    """DPVR_RESIDENT turns the mode on (and with it the stale pool and the
    widened configuration), as in the reference; resident_stream= wins."""
    monkeypatch.setenv("DPVR_RESIDENT", value)
    cfg = dict(width=128, height=128, gather_cap=16384, tile_k_cap=2048,
               visible_chunks_cap=512)
    eng = TE.Engine(TE.RenderConfig(**cfg), pool_slots=16, device="cpu")
    ref = JE.Engine(JCFG.RenderConfig(**cfg), pool_slots=16)
    assert eng.resident_stream is want is ref.resident_stream
    assert eng.stale_streaming is want and eng.world.track_added is want
    for f in ("gather_cap", "tile_k_cap", "visible_chunks_cap"):
        assert getattr(eng.config, f) == getattr(ref.config, f), f
    assert TE.Engine(TE.RenderConfig(**cfg), pool_slots=16, device="cpu",
                     resident_stream=not want).resident_stream is not want


def test_warm_resident_changes_nothing_later(streaming):
    """warm_resident runs every resident device call once and leaves the
    pool (rows, host tables, free list, lookup cache) as it
    was, with the stream as built; the flight's first frames after it (a
    rebuild, an append with its fused scatter) equal the unwarmed port
    engine's of the streaming flight bit for bit, streams included."""
    eng = _engine(True)
    eng.world.generate_region((-3, -1, -3), (3, 1, 3))
    eng.prime()
    before = S.pool_tables(eng.pool)
    free, cache = list(eng.pool._free), eng.pool._lookup_cache
    eng.warm_resident()
    S.assert_same_pool_tables(before, S.pool_tables(eng.pool))
    assert eng.pool._free == free and eng.pool._lookup_cache is cache
    assert eng._res_uploads is not None and not eng._res_dirty
    got = _fly(eng, _streaming_poses()[:3], True)
    assert got[-1][2]["appends"] == got[-1][2]["fused"] == 1
    for x, y in zip(got, streaming["port"]["frames"]):
        for u, v in zip(x[0], y[0]):
            np.testing.assert_array_equal(u, v)
        assert x[1] == y[1]
        S.assert_same_resident_state(x[2], y[2])
    with pytest.raises(RuntimeError, match="resident_stream"):
        _engine(True, resident=False).warm_resident()


def test_resident_steps_refuse_two_pass():
    """The resident steps refuse a two-pass configuration with the
    reference's ValueError: the near/far split needs the frame's draw
    list."""
    cfg = dict(width=128, height=128, two_pass_near_quads=8)
    renderers = (TPL.Renderer(TE.RenderConfig(**cfg), device="cpu"),
                 JPL.Renderer(JCFG.RenderConfig(**cfg)))
    for r in renderers:
        for step_for in (r._append_step_for, r._append_ins_step_for):
            with pytest.raises(ValueError, match="two_pass_near_quads"):
                step_for(16384)


# ----------------------------------------------------- straddling quads


def _straddle_stream():
    """A 640x256 scene (tests/_torch_scenes.py ``scene``'s tuple) whose
    stream is ordered as a resident stream may be: 100 copies of the mesh
    of a wall beside the view, 20 blocks to the left of the camera and
    crossing its near plane, before a floor under the camera that crosses
    it in view."""
    wall = np.zeros((32, 32, 32), np.uint8)   # [z, y, x]
    wall[10:, :, 28] = 1
    floor = np.zeros((32, 32, 32), np.uint8)
    floor[:, :4, :] = 1
    chunks = [Chunk.varied((-1, 0, 0), wall), Chunk.varied((0, 0, 0), floor)]
    meshes = [(mesh_chunk(c, chunks), c.position) for c in chunks]
    gc = 4096
    stream = np.zeros(gc, np.uint32)
    quad_world = np.zeros((3, gc), np.float32)
    total = 0
    for q, pos in [meshes[0]] * 100 + [meshes[1]]:
        stream[total:total + len(q)] = q
        quad_world[:, total:total + len(q)] = (
            np.asarray(pos, np.float32)[:, None] * 32.0)
        total += len(q)
    w, h = 640, 256
    cam = Camera(np.array([16.0, 10.0, 16.0], np.float32), w / h)
    cam.look_at(np.array([16.0, 4.0, -10.0], np.float32))
    return (stream, quad_world, total,
            cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32), (w, h, gc))


def test_straddling_quads_past_the_huge_cap(monkeypatch):
    """The reference's Pallas step drops the straddling quads past its 64
    by stream index, the floor among them (a sky frame); the port drops
    none and renders the floor as the reference's boxes do with a huge cap
    that drops nothing, default and packed, stats included."""
    sc = _straddle_stream()
    ref = JPL._render_step(*S.jax_args(sc), **S.jax_step_kw(sc, sc[5][2]))
    ref_color, ref_stats = np.asarray(ref[0]), np.asarray(ref[2])
    assert int(ref_stats[1]) == 101 and int(ref_stats[3]) == 37
    assert (ref_color == ref_color[0, 0]).all()
    args, kw = S.torch_args(sc), S.torch_step_kw(sc, sc[5][2])
    got = {p: TPL.render_step(*args, packed_raster=p, **kw)
           for p in (False, True)}
    monkeypatch.setattr(TP, "STRADDLE_MARGIN", float("inf"))
    monkeypatch.setattr(TPL.raster_ops, "HUGE_CAP", 512)
    for p, frame in got.items():
        want = TPL.render_step(*args, packed_raster=p, **kw)
        for a, b in zip(frame, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), p
        np.testing.assert_array_equal(frame[2].numpy(), ref_stats
                                      - np.array([0, 0, 0, 37, 0, 0]))
        assert int((frame[0] != frame[0][0, 0]).sum()) > 50000


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cam", sorted(S.STRADDLE_CAMERAS))
def test_straddling_boxes_keep_the_frame(monkeypatch, cam, packed):
    """Among the terrain's chunks the port's straddling boxes give the
    frame of the reference's whole-screen boxes bit for bit, stats
    included, from fewer binned items."""
    sc = S.straddle_scene(cam)
    args, kw = S.torch_args(sc), dict(S.torch_step_kw(sc, sc[5][2]),
                                      packed_raster=packed)
    got = TPL.render_step(*args, **kw)
    items = int(TPL.render_step(*args, debug_return_records=True,
                                **kw)[2].sum())
    monkeypatch.setattr(TP, "STRADDLE_MARGIN", float("inf"))
    want = TPL.render_step(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref_items = int(TPL.render_step(*args, debug_return_records=True,
                                    **kw)[2].sum())
    assert items < ref_items * 0.8, (items, ref_items)
    assert int((got[0] != got[0][0, 0]).sum()) > 10000
