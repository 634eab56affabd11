"""The port's copies of the host layers against the JAX package's, on the
CPU: meshing, terrain generation, the camera, the culling passes, the
colour tables and the configuration defaults.  The port keeps its own
copies (it imports nothing of the JAX package), so each copy is held to
its original on the same inputs, made from numpy seeds.  All comparisons
are exact.
"""

import dataclasses

import numpy as np
import pytest

from differential_projection_voxel_renderer_tpu.meshing import greedy as JG
from differential_projection_voxel_renderer_tpu.models import camera as JC
from differential_projection_voxel_renderer_tpu.models import chunk as JK
from differential_projection_voxel_renderer_tpu.models import world as JW
from differential_projection_voxel_renderer_tpu.ops import culling as JCU
from differential_projection_voxel_renderer_tpu.ops import occlusion as JO
from differential_projection_voxel_renderer_tpu.ops import shading as JS
from differential_projection_voxel_renderer_tpu.ops import texture as JT
from differential_projection_voxel_renderer_tpu.rendering import (
    parity as JPAR,
)
from differential_projection_voxel_renderer_tpu.utils import config as JCFG
from differential_projection_voxel_renderer_tpu_torch.meshing import (
    greedy as TG,
)
from differential_projection_voxel_renderer_tpu_torch.models import (
    camera as TC,
)
from differential_projection_voxel_renderer_tpu_torch.models import (
    chunk as TK,
)
from differential_projection_voxel_renderer_tpu_torch.models import (
    world as TW,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    culling as TCU,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    occlusion as TO,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    shading as TS,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    texture as TT,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    parity as TPAR,
)
from differential_projection_voxel_renderer_tpu_torch.utils import (
    config as TCFG,
)


def _same_mesh(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", [42, 7, 1234])
def test_mesh_fuzz_chunk_matches_jax(seed):
    ref, got = JPAR.fuzz_chunk(seed), TPAR.fuzz_chunk(seed)
    np.testing.assert_array_equal(ref.dense(), got.dense())
    mesh = TG.mesh_chunk(got)
    assert mesh is not None and len(mesh) > 1000
    _same_mesh(JG.mesh_chunk(ref), mesh)


@pytest.mark.parametrize("center", [(0, 0, 0), (5, 0, -3), (-7, -1, 2)])
def test_mesh_terrain_with_neighbours_matches_jax(center):
    """The centre chunk meshed against its 26 generated neighbours."""
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    worlds = []
    for K in (JK, TK):
        worlds.append({
            p: K.Chunk.generate_terrain(p)
            for p in (tuple(c + o for c, o in zip(center, off))
                      for off in offs)})
    ref, got = worlds
    for p in ref:
        np.testing.assert_array_equal(ref[p].dense(), got[p].dense())
    _same_mesh(JG.mesh_chunk(ref[center], ref),
               TG.mesh_chunk(got[center], got))


@pytest.mark.parametrize("pos", [(0, 0, 0), (3, -1, 9), (-12, 0, 4),
                                 (40, 1, -25)])
def test_terrain_voxels_match_jax(pos):
    ref, got = JK.Chunk.generate_terrain(pos), TK.Chunk.generate_terrain(pos)
    assert ref.is_uniform == got.is_uniform
    np.testing.assert_array_equal(ref.dense(), got.dense())
    np.testing.assert_array_equal(
        JK.sample_terrain_height(np.arange(-50, 50), np.arange(100, 0, -1)),
        TK.sample_terrain_height(np.arange(-50, 50), np.arange(100, 0, -1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-200, 200, 3).astype(np.float32)
    tgt = pos + rng.normal(size=3).astype(np.float32) * 50
    aspect = float(rng.uniform(0.5, 3.0))
    dx, dy = rng.normal(size=2)
    ref, got = JC.Camera(pos, aspect), TC.Camera(pos, aspect)
    for cam in (ref, got):
        cam.look_at(tgt)
        cam.rotate(float(dx), float(dy))
    np.testing.assert_array_equal(ref.view_projection_matrix(),
                                  got.view_projection_matrix())
    fr, fg = ref.extract_frustum(), got.extract_frustum()
    np.testing.assert_array_equal(fr.planes, fg.planes)
    mins = rng.integers(-10, 10, (200, 3)).astype(np.float32) * 32
    np.testing.assert_array_equal(fr.inside_mins(mins, 32.0),
                                  fg.inside_mins(mins, 32.0))


def _chunk_centers(rng, n):
    return (rng.integers(-12, 13, (n, 3)) * 32 + 16).astype(np.float32)


@pytest.mark.parametrize("use_native", [True, False])
def test_culling_passes_match_jax(use_native):
    rng = np.random.default_rng(5)
    centers = _chunk_centers(rng, 600)
    cam_pos = np.array([3.0, 40.0, -7.0], np.float32)
    order = TCU.sort_front_to_back(centers, cam_pos)
    np.testing.assert_array_equal(
        JCU.sort_front_to_back(centers, cam_pos), order)
    centers = centers[order]
    keep = TCU.horizon_cull_mask(centers, cam_pos, use_native=use_native)
    np.testing.assert_array_equal(
        JCU.horizon_cull_mask(centers, cam_pos, use_native=use_native), keep)
    assert 0 < keep.sum() < len(keep)

    cam = TC.Camera(cam_pos, 16 / 9)
    cam.look_at(np.array([0.0, 0.0, -200.0], np.float32))
    vp = cam.view_projection_matrix()
    got = TO.project_chunk_rects(centers, vp, 1280, 720)
    for r, g in zip(JO.project_chunk_rects(centers, vp, 1280, 720), got):
        np.testing.assert_array_equal(r, g)
    rects, near, _ = got
    use_occ = rng.integers(0, 2, len(rects)).astype(bool)
    for eps in (0.005, 1e-4):
        np.testing.assert_array_equal(
            JO.occlusion_pass(rects, near, use_occ, 1280, 720, epsilon=eps,
                              use_native=use_native),
            TO.occlusion_pass(rects, near, use_occ, 1280, 720, epsilon=eps,
                              use_native=use_native))


@pytest.mark.parametrize("shading,textures", [(True, True), (True, False),
                                              (False, True)])
def test_color_tables_match_jax(shading, textures):
    ref_atlas, got_atlas = JT.TextureAtlas(), TT.TextureAtlas()
    ref_t, got_t = ref_atlas.kernel_tables(), got_atlas.kernel_tables()
    assert ref_t.keys() == got_t.keys()
    for k in ref_t:
        np.testing.assert_array_equal(ref_t[k], got_t[k])
    ref = JS.build_quad_color_tables(ref_t, enable_shading=shading,
                                     enable_textures=textures)
    got = TS.build_quad_color_tables(got_t, enable_shading=shading,
                                     enable_textures=textures)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])


def test_config_defaults_match_jax():
    assert (dataclasses.asdict(JCFG.RenderConfig())
            == dataclasses.asdict(TCFG.RenderConfig()))
    assert (dataclasses.asdict(JW.WorldConfig())
            == dataclasses.asdict(TW.WorldConfig()))
    for name in ("CHUNK_SIZE", "NEAR_W_EPS", "MIN_TRIANGLE_AREA",
                 "SKY_COLOR", "GATHER_QUADS_CAP", "RENDER_QUADS_CAP",
                 "QUADS_PER_CHUNK_CAP", "VISIBLE_CHUNKS_CAP",
                 "TERRAIN_SEED"):
        assert getattr(JCFG, name) == getattr(TCFG, name), name


def test_native_build_is_atomic(tmp_path):
    """Processes that build the port's native mesher at once all load a
    whole library: it is compiled into a temporary file and renamed into
    place."""
    import os
    import shutil
    import subprocess
    import sys

    from differential_projection_voxel_renderer_tpu_torch.meshing import (
        native_bridge,
    )

    pkg = tmp_path / "pkg"
    (pkg / "meshing").mkdir(parents=True)
    (pkg / "native" / "src").mkdir(parents=True)
    shutil.copy(native_bridge.__file__, pkg / "meshing")
    shutil.copy(native_bridge.SRC, pkg / "native" / "src")
    bridge = str(pkg / "meshing" / "native_bridge.py")
    code = ("import importlib.util as u; "
            f"s = u.spec_from_file_location('nb', {bridge!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "print(m.mesh_chunk_full is not None)")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert outs == ["True"] * 4
    assert os.listdir(tmp_path / "build" / "native") == [
        os.path.basename(native_bridge.LIB_PATH)]


# ------------------------------------------- chunk_mesh, face_packets,
# ------------------------------------------- framebuffer, oracle


def _fuzz_mesh(seed=42):
    return JG.mesh_chunk(JPAR.fuzz_chunk(seed))


def test_chunk_mesh_matches_jax():
    from differential_projection_voxel_renderer_tpu.meshing import (
        chunk_mesh as JM,
    )
    from differential_projection_voxel_renderer_tpu_torch.meshing import (
        chunk_mesh as TM,
    )

    quads = _fuzz_mesh()
    ref, got = (M.ChunkMesh.from_quads((2, -1, 3), quads) for M in (JM, TM))
    assert got.quad_count() == ref.quad_count() == len(quads)
    np.testing.assert_array_equal(ref.packed(), got.packed())
    for face in (None, *range(6)):
        for r, g in zip(ref.local_aabb(face), got.local_aabb(face)):
            np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(ref.corners_world(face),
                                      got.corners_world(face))
    for f in range(6):
        for r, g in zip(ref.faces[f].slices, got.faces[f].slices):
            np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(JM.corner_winding(f),
                                      TM.corner_winding(f))
        corners = got.corners_world(f)[:3]
        for c in corners:
            np.testing.assert_array_equal(JM.winding_normal(c, f),
                                          TM.winding_normal(c, f))
    for m in (ref, got):
        m.add_quad(3, 1, 2, 3, 4, 2, 17)
        m.add_quad(2, 0, 0, 1, 1, 1, 32)
    np.testing.assert_array_equal(ref.packed(), got.packed())
    assert TM.ChunkMesh.from_quads((0, 0, 0), None).is_empty()


def test_face_packets_match_jax():
    from differential_projection_voxel_renderer_tpu.meshing import (
        face_packets as JFP,
    )
    from differential_projection_voxel_renderer_tpu_torch.meshing import (
        face_packets as TFP,
    )

    quads = _fuzz_mesh(7)
    ref = JFP.ChunkFacePackets.from_packed_quads(quads)
    got = TFP.ChunkFacePackets.from_packed_quads(quads)
    assert got.packet_count() == ref.packet_count() > 6
    assert got.quad_count() == ref.quad_count() == len(quads)
    for rf, gf in zip(ref.faces, got.faces):
        for r, g in zip(rf, gf):
            assert dataclasses.asdict(r).keys() == dataclasses.asdict(g).keys()
            for k, v in dataclasses.asdict(r).items():
                np.testing.assert_array_equal(v, dataclasses.asdict(g)[k])
            assert (r.is_empty, r.is_full) == (g.is_empty, g.is_full)
            np.testing.assert_array_equal(r.slice_idx_uniform(),
                                          g.slice_idx_uniform())


def test_framebuffer_matches_jax(tmp_path):
    """set_pixel, the stripe and tile views, to_rgb8 and the PPM bytes; and
    from_device on torch tensors (the only change of the copy)."""
    import torch

    from differential_projection_voxel_renderer_tpu.rendering import (
        framebuffer as JFB,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        framebuffer as TFB,
    )

    rng = np.random.default_rng(3)
    w, h = 200, 90
    writes = [(int(x), int(y), int(c), float(d)) for x, y, c, d in zip(
        rng.integers(-5, w + 5, 400), rng.integers(-5, h + 5, 400),
        rng.integers(0, 2**32, 400), rng.uniform(0, 1, 400))]
    fbs = []
    for FB in (JFB, TFB):
        fb = FB.Framebuffer(w, h)
        oks = [fb.set_pixel(*wr) for wr in writes]
        stripes = fb.split_into_stripes(7)
        tiles = fb.split_into_tiles(64)
        for i, wr in enumerate(writes):
            oks.append(stripes[i % len(stripes)].test_depth_and_write(*wr))
            oks.append(tiles[i % len(tiles)].test_depth_and_write(*wr))
        ct = FB.CountingTarget(fb)
        oks += [ct.test_depth_and_write(x, y, c, d / 2) for x, y, c, d
                in writes[:50]]
        path = tmp_path / f"{FB.__name__}.ppm"
        fb.save_ppm(str(path))
        fbs.append((oks, [s.rect() for s in stripes],
                    [t.rect() for t in tiles], (ct.attempts, ct.writes),
                    fb.to_rgb8(), fb.color_buffer_slice(), fb.depth,
                    path.read_bytes(), FB.rgb_to_u32(300, 20, 7),
                    [FB.apply_ao([200, 64, 9], ao) for ao in range(5)]))
    for r, g in zip(*fbs):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(r, g)
        else:
            assert r == g
    color = rng.integers(-2**31, 2**31, (h, w)).astype(np.int32)
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    ref = JFB.Framebuffer.from_device(color, depth)
    for c, d in ((color, depth), (torch.from_numpy(color),
                                  torch.from_numpy(depth))):
        got = TFB.Framebuffer.from_device(c, d)
        np.testing.assert_array_equal(ref.color, got.color)
        np.testing.assert_array_equal(ref.depth, got.depth)
        assert got.color.dtype == np.uint32


def test_oracle_matches_jax():
    """render_exact (textured and flat), render_triangles, render_span and
    pixel_candidates on the fuzz chunk at 64x64, bit for bit."""
    from differential_projection_voxel_renderer_tpu.rendering import (
        oracle as JOR,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        oracle as TOR,
    )

    w, h = 64, 64
    quads = _fuzz_mesh()
    cam = JC.Camera(np.array([16.0, 48.0, 16.0], np.float32), w / h)
    cam.look_at(np.array([16.0, 8.0, 16.0], np.float32))
    vp, cp = cam.view_projection_matrix(), cam.position
    origin = np.zeros(3)
    tables = JS.build_quad_color_tables(JT.TextureAtlas().kernel_tables())
    outs = []
    for OR in (JOR, TOR):
        ex = OR.render_exact(quads, origin, vp, cp, w, h,
                             color_tables=tables)
        flat = OR.render_exact(quads, origin, vp, cp, w, h, subpixel=False)
        tri = OR.render_triangles(quads, origin, vp, w, h, cam_pos=cp)
        span = OR.render_span(quads, origin, vp, cp, w, h)
        cands = OR.pixel_candidates(quads, origin, vp, cp, w, h,
                                    [(h // 2, w // 2), (3, 5), (h - 1, 0)],
                                    color_tables=tables)
        outs.append((ex, flat, tri, span, cands))
    (ex, flat, tri, span, cands), got = outs
    assert (ex[0] != np.uint32(JCFG.SKY_COLOR)).sum() > w * h // 4
    for r, g in zip((ex, flat, tri, span), got[:4]):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(a, b)
    assert cands == got[4]


def test_trace_writes_a_chrome_trace(tmp_path):
    """``utils/profiling.trace``, the port's ``torch.profiler`` form of the
    reference's ``jax.profiler`` scope: the same signature, one
    Chrome-format trace in the directory, holding the ops it saw."""
    import inspect
    import json

    import torch

    from differential_projection_voxel_renderer_tpu.utils import (
        profiling as JPR,
    )
    from differential_projection_voxel_renderer_tpu_torch.utils import (
        profiling as TPR,
    )

    assert (list(inspect.signature(JPR.trace).parameters)
            == list(inspect.signature(TPR.trace).parameters) == ["log_dir"])
    with TPR.trace(str(tmp_path)) as d:
        assert d == str(tmp_path)
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# ------------------------------------------- the last ported modules


@pytest.mark.parametrize("module", ["ops/meshing_device.py",
                                    "models/vertex.py",
                                    "rendering/legacy.py"])
def test_last_ported_modules_import_no_jax(module):
    """The counterparts of ops/meshing_jax.py, models/vertex.py and
    rendering/legacy.py (the three JAX modules that import jax) name
    neither jax nor the JAX package, and import in a process where both
    are blocked."""
    import ast
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    port = "differential_projection_voxel_renderer_tpu_torch"
    with open(os.path.join(root, port, module)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib",
                               "differential_projection_voxel_renderer_tpu"), n
    name = port + "." + module[:-3].replace("/", ".")
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, n, path=None, target=None):\n"
        "        if n.split('.')[0] in ('jax', "
        "'differential_projection_voxel_renderer_tpu'):\n"
        "            raise ImportError(n + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
