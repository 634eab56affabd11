"""The port's one-frame-stale pool mode (``Engine.stale_streaming``,
``DPVR_STALE_POOL=1``) against the JAX package's, on the CPU: the
contract of tests/test_engine.py
test_stale_pool_streaming_differs_only_in_late_chunks, engine against
engine.

Both stale engines fly the same camera path, which crosses a chunk
boundary every two frames or so.  Each frame's late batch (the union of
the ``_mesh_list`` calls made during the frame, which stale mode makes
after the render call) must be equal, frame for frame, and so must the
draw lists, stats and mesh counts.  Frames go through the gates of
tests/test_torch_app.py (depth within 32 ulps where the colours agree:
the JAX jnp path's planar-depth coefficients; every colour mismatch
proven), against the port's raster records taken before the frame's late
batch lands.  A settle frame with the camera held drains the stash in
both, and the pools end identical: slots, rows and counts.
"""

import numpy as np
import pytest

import _torch_scenes as S
from differential_projection_voxel_renderer_tpu.app import engine as JE
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.app import engine as TE

N_FRAMES = 6


def _configs(render_config_cls, world_config_cls):
    # tests/test_engine.py _small_engine, with the default item cap (the
    # port bins, the jnp path does not: no tile may drop)
    return dict(
        render_config=render_config_cls(width=256, height=128,
                                        gather_cap=16384, quads_cap=8192),
        world_config=world_config_cls(view_distance=3, frustum_culling=True,
                                      max_chunks_per_frame=64),
        pool_slots=512)


def _flight(eng, port):
    """(frames, per-frame late batches, draw lists, port records)."""
    frames, batches, draws, records = [], [], [], []
    calls: list = []
    orig = eng._mesh_list

    def spy(to_mesh, defer=False):
        calls.append(list(to_mesh))
        return orig(to_mesh, defer=defer)

    eng._mesh_list = spy
    if port:
        apply = eng._apply_stale_stash

        def apply_after_records():
            # the records of the frame just issued, from the pool before
            # its late batch lands
            records.append(S.engine_records(eng))
            apply()

        eng._apply_stale_stash = apply_after_records
    base = eng.camera.position.copy()
    for i in range(1, N_FRAMES + 2):
        if i <= N_FRAMES:
            eng.camera.position = base + np.array(
                [18.0 * i, 0.0, -9.0 * i], np.float32)
            eng.camera.yaw += 0.015
        k0 = len(calls)
        frames.append(S.frame_tuple(eng.render_frame(dt=0.0)))
        batches.append(sorted({tuple(p) for c in calls[k0:] for p in c}))
        draws.append(S.draw_list(eng))
    assert not eng._stale_stash
    return frames, batches, draws, records


@pytest.fixture(scope="module")
def flights(monkeypatch_module):
    monkeypatch_module.setenv("DPVR_STALE_POOL", "1")
    out = {}
    for name, eng in (
            ("jax", JE.Engine(**_configs(JCFG.RenderConfig, JW.WorldConfig))),
            ("port", TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                               device="cpu"))):
        assert eng.stale_streaming
        eng.camera.position = np.array([0.0, 40.0, 60.0], np.float32)
        eng.camera.look_at(np.array([0.0, 0.0, 0.0]))
        eng.world.generate_region((-3, -1, -3), (3, 1, 3))
        eng.prime()
        out[name] = _flight(eng, name == "port") + (S.pool_tables(eng.pool),)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_stale_mode_reads_its_environment_switch(monkeypatch):
    for value, want in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("DPVR_STALE_POOL", value)
        eng = TE.Engine(render_config=TE.RenderConfig(width=128, height=128),
                        world_config=TE.WorldConfig(view_distance=1),
                        pool_slots=16, device="cpu")
        assert eng.stale_streaming is want


def test_late_batches_match_jax(flights):
    ref, got = flights["jax"][1], flights["port"][1]
    assert got == ref
    assert sum(1 for b in got[:N_FRAMES] if b) >= 2, got
    assert not got[-1], "the settle frame meshed something"


@pytest.mark.parametrize("frame", range(N_FRAMES + 1))
def test_stale_frame_matches_jax(flights, frame):
    """Frame ``frame`` (the last is the settle frame): draw list, stats and
    mesh counts exact, the frame under the gates."""
    jf, _, jdl, _, _ = flights["jax"]
    tf, _, tdl, records, _ = flights["port"]
    for a, b in zip(jdl[frame], tdl[frame]):
        np.testing.assert_array_equal(a, b)
    S.assert_engine_frame_gates(jf[frame], tf[frame], records[frame],
                                depth_ulps=S.JNP_DEPTH_ULPS)


def test_stale_pools_end_identical(flights):
    S.assert_same_pool_tables(flights["jax"][4], flights["port"][4])


def test_stale_batch_lands_after_the_render_call():
    """The frame renders first; its batch then takes the standalone
    scatter (``insert_many``), never the fused insert of its own frame."""
    eng = TE.Engine(**_configs(TE.RenderConfig, TE.WorldConfig),
                    device="cpu")
    eng.stale_streaming = True
    eng.camera.position = np.array([0.0, 40.0, 60.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, 0.0]))
    eng.world.generate_region((-1, 0, -1), (1, 0, 1))
    eng.prime()
    events = []

    def spy(obj, name):
        fn = getattr(obj, name)

        def call(*a, **k):
            events.append(name)
            return fn(*a, **k)
        setattr(obj, name, call)

    for name in ("render_fused", "render_prepared", "render_fused_insert"):
        spy(eng.renderer, name)
    spy(eng.pool, "insert_many")
    eng.camera.position = np.array([40.0, 40.0, 40.0], np.float32)
    eng.render_frame(dt=0.0)
    # insert_many calls itself once a batch holds meshes over 512 quads
    assert events[0] == "render_fused" and len(events) > 1, events
    assert set(events[1:]) == {"insert_many"}, events
    assert not eng._stale_stash and eng._pending_insert is None
