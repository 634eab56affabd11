"""The port's measuring side on the CPU: ``rendering/pipeline.
make_repeated_step`` and ``ops/projection.chunk_clip_origins`` against
the JAX package's, and the port's ``benches/`` modules against the JAX
bench scripts they port (``benches/*.py``, loaded by path with nothing run
at import, as tests/test_torch_micro.py loads them).

The JAX side runs its jnp path on the CPU, whose frames may differ from
the Pallas path's by FMA contraction (ROADMAP.md), so frames are held to
it with the gates of tests/_torch_scenes.py; the port's own repeated step
must equal its ``render_step`` bit for bit.
"""

import ast
import importlib.util
import os
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
import _torch_streams as TS
from differential_projection_voxel_renderer_tpu.ops import (
    projection as JP,
)
from differential_projection_voxel_renderer_tpu.rendering import (
    pipeline as JPL,
)
from differential_projection_voxel_renderer_tpu.utils.config import (
    RenderConfig as JRenderConfig,
)
from differential_projection_voxel_renderer_tpu_torch.benches import (
    bench as TB,
    kernel_cost_sim as KCS,
    micro_sort as MS,
    profile_stages as PS,
    scene as SC,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    pipeline as TPL,
)
from differential_projection_voxel_renderer_tpu_torch.utils.config import (
    RenderConfig,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_BENCHES = os.path.join(
    ROOT, "differential_projection_voxel_renderer_tpu_torch", "benches")
N_FRAMES = 3


def _load_jax_bench(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(ROOT, "benches", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(S.SCENES))
def test_make_repeated_step_matches_render_step_and_jax(name):
    """N = 3 steps over jittered cameras: the last frame equals the port's
    render_step on the last camera bit for bit, and JAX's
    make_repeated_step under the gates of tests/_torch_scenes.py (depth
    within 4 ulps, texel-edge flips proven, the boundary gate, stats
    exact)."""
    sc = S.scene(name)
    w, h, gc = sc[5]
    cfg = dict(width=w, height=h, gather_cap=gc, quads_cap=gc // 2,
               tile_k_cap=2 * gc)
    vps, cams = SC.jittered_cameras(sc[3], sc[4], N_FRAMES, seed=3)
    r = TPL.Renderer(RenderConfig(**cfg), device="cpu")
    args = S.torch_args(sc)
    c, d, s = TPL.make_repeated_step(r, N_FRAMES)(*args[:3], vps, cams)
    kw = dict(S.torch_step_kw(sc, gc // 2), tile_k_cap=2 * gc)
    c2, d2, s2 = TPL.render_step(*args[:3], torch.from_numpy(vps[-1]),
                                 torch.from_numpy(cams[-1]), **kw)
    assert torch.equal(c, c2) and torch.equal(s, s2)
    assert torch.equal(d.view(torch.int32), d2.view(torch.int32))

    jr = JPL.Renderer(JRenderConfig(**cfg))
    jc, jd, js = JPL.make_repeated_step(jr, N_FRAMES)(
        *S.jax_args(sc)[:3], jnp.asarray(vps), jnp.asarray(cams))
    rec = TPL.render_step(*args[:3], torch.from_numpy(vps[-1]),
                          torch.from_numpy(cams[-1]),
                          debug_return_records=True, **kw)[0].numpy()
    S.assert_engine_frame_gates(
        (np.asarray(jc).view(np.uint32), np.asarray(jd), np.asarray(js)),
        (c.numpy().view(np.uint32), d.numpy(), s.numpy()), rec)


def test_make_repeated_step_checks_camera_shapes():
    sc = S.scene("fuzz")
    w, h, gc = sc[5]
    r = TPL.Renderer(RenderConfig(width=w, height=h, gather_cap=gc),
                     device="cpu")
    run = TPL.make_repeated_step(r, 2)
    vps, cams = SC.jittered_cameras(sc[3], sc[4], 3)
    with pytest.raises(ValueError, match="vps must be"):
        run(*S.torch_args(sc)[:3], vps, cams)
    with pytest.raises(ValueError, match="at least one frame"):
        TPL.make_repeated_step(r, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_clip_origins_matches_jax(seed):
    """vp @ [pos * 32, 1] for random chunk slots, within 2 ulps of JAX's
    (whose matmul sums in another order and may contract multiply-adds).
    The sums cancel, so an ulp is taken at the scale of the sum: of the
    sum of the four products' magnitudes."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-300, 300, (257, 3)).astype(np.int32)
    _, _, _, vp, _, _ = S.scene("terrain")
    vp = vp + rng.normal(0, 0.1, (4, 4)).astype(np.float32)
    want = JP.chunk_clip_origins(jnp.asarray(vp), jnp.asarray(pos))
    got = TP.chunk_clip_origins(torch.from_numpy(vp), torch.from_numpy(pos))
    hom = np.concatenate([pos * 32.0, np.ones((257, 1))], 1)
    assert len(got) == len(want) == 4
    for r, (g, w_) in enumerate(zip(got, want)):
        g, w_ = g.numpy(), np.asarray(w_)
        assert g.dtype == np.float32 and g.shape == (257,)
        scale = np.abs(hom * vp[r].astype(np.float64)).sum(1)
        assert (np.abs(g - w_) <= 2 * np.spacing(scale.astype(np.float32))
                ).all()


def test_scene_cache_round_trip(tmp_path, monkeypatch):
    """A small scene built on the CPU, cached and read back unchanged; a
    second get_scene reads the file and builds nothing; the cache's name
    is the port's own."""
    path = str(tmp_path / "scene.npz")
    kw = dict(width=256, height=128, device="cpu")
    built = SC.get_scene(2, path=path, **kw)
    assert os.path.exists(path)
    quads, qw, total, vp, cam = built
    assert quads.dtype == np.uint32 and qw.shape == (3, quads.shape[0])
    assert 0 < total <= quads.shape[0]
    monkeypatch.setattr(SC, "build_scene",
                        lambda *a, **k: pytest.fail("rebuilt"))
    again = SC.get_scene(2, path=path, **kw)
    for a, b in zip(built, again):
        np.testing.assert_array_equal(a, b)
    assert os.path.basename(SC.cache_path()) != "dpvr_scene_vd12.npz"
    assert "torch" in os.path.basename(SC.cache_path(12, 23))


def _jax_stage_names():
    """The original profile_stages' default stage list and every stage
    name its loop compares against."""
    with open(os.path.join(ROOT, "benches", "profile_stages.py")) as f:
        tree = ast.parse(f.read())
    default, names = None, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.BoolOp)
                and isinstance(node.values[-1], ast.List)):
            default = [e.value for e in node.values[-1].elts]
        if (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name) and node.left.id == "st"):
            for c in node.comparators:
                if isinstance(c, ast.Constant):
                    names.add(c.value)
                elif isinstance(c, ast.Tuple):
                    names.update(e.value for e in c.elts)
    return default, names


def test_profile_stages_list_matches_the_original():
    """The port's default stages are the original's, in order, and it
    takes every stage name the original compares against; the original's
    TPU knob suffixes and settings raise, naming ROADMAP's list."""
    default, names = _jax_stage_names()
    assert tuple(default) == PS.STAGES
    assert names <= set(PS.STAGES + PS.PACKED_STAGES)
    for st in PS.STAGES + PS.PACKED_STAGES:
        assert PS.check_stage(st) == st
    for st in ("raster_tps2", "raster_opi4", "raster_sg1", "raster0_bq512",
               "raster_rt", "raster_pr"):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            PS.check_stage(st)
    with pytest.raises(ValueError, match="unknown stage"):
        PS.check_stage("rastr")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        PS.check_env({"PROF_TH": "32"})
    PS.check_env({"PROF_K": "3", "PROF_GQ": "0"})


def test_profile_stage_bodies_run_on_cpu():
    """Every stage body runs on the CPU on the fuzz scene: ``full`` gives
    render_step's frame, ``raster`` K2's (plain) frame of the records."""
    sc = S.scene("fuzz")
    w, h, gc = sc[5]
    q, qw, n, vp, cp = S.torch_args(sc)
    tables = TP.color_table_tensors(S.TABLES, "cpu")
    bodies, rec, recp = PS.make_stages(q, qw, n, width=w, height=h,
                                       tables=tables, rc=gc, tk=2 * gc,
                                       vp0=vp, cam0=cp)
    assert set(bodies) == set(PS.STAGES + PS.PACKED_STAGES)
    for name, body in bodies.items():
        assert isinstance(body(vp, cp), torch.Tensor), name
    c, _, s = TPL.render_step(q, qw, n, vp, cp, **S.torch_step_kw(sc, gc))
    assert int(bodies["full"](vp, cp)) == int(c[0, 0] + s[1])
    assert int(rec[2].sum()) > 0 and int(recp[2].sum()) > 0


def _numpy_walk(rec, height, width, boxes):
    """K2's walk counted directly: each tile's items in order, the depth of
    its 16x128 pixels blended item by item from the records' planes
    (float32 numpy), the walk stopped at the first octet base strictly
    inside the segment whose suffix-min lies beyond the tile's deepest
    pixel.  Per tile (items walked, pixels evaluated, pixels needed,
    octets skipped)."""
    records, starts, counts, _, ozmin = (x.numpy() for x in rec)
    f = records[:16].view(np.float32)
    x0, x1, y0, y1 = boxes
    tiles_x = width // 128
    out = []
    for t in range(len(starts)):
        st, n = int(starts[t]), int(counts[t])
        ty, tx = t // tiles_x * 16, t % tiles_x * 128
        px = tx + np.arange(128, dtype=np.float32)
        py = ty + np.arange(16, dtype=np.float32)
        nx = ((2.0 * (px + 0.5) - width) / width)[None, :]
        ny = (1.0 - 2.0 * (py + 0.5) / height)[:, None]
        acc = np.full((16, 128), np.inf, np.float32)
        end = walked = st + n
        evaluated = needed = 0
        for i in range(st, end):
            if i > st and i % 8 == 0 and ozmin[i // 8] > acc.max():
                walked = i
                break
            qu = f[0, i] * nx + f[1, i] * ny + f[2, i]
            qv = f[3, i] * nx + f[4, i] * ny + f[5, i]
            qw = f[6, i] * nx + f[7, i] * ny + f[8, i]
            z = f[9, i] * nx + f[10, i] * ny + f[11, i]
            cover = ((qw > 0) & (qu >= f[12, i] * qw) & (qu <= f[13, i] * qw)
                     & (qv >= f[14, i] * qw) & (qv <= f[15, i] * qw))
            acc = np.where(cover, np.minimum(acc, z), acc)
            r0, r1 = max(y0[i], ty), min(y1[i], ty + 15)
            c0, c1 = max(x0[i], tx), min(x1[i], tx + 127)
            evaluated += (r1 - r0 + 1) * 128 if r1 >= r0 else 0
            if r1 >= r0 and c1 >= c0:
                needed += (r1 - r0 + 1) * (c1 - c0 + 1)
        out.append((walked - st, evaluated, needed, (end - walked + 7) // 8))
    return out


def test_kernel_cost_sim_counts_octet_break_stream():
    """kernel_cost_sim's per-tile counts on the octet-break stream (tile
    1's walk ends at item 168) equal a direct numpy count of the same
    walk."""
    rec, kw, brk, t1 = TS.octet_break_stream()
    records = rec[0]
    boxes = (records[22] & 0xFFFF, records[22] >> 16, records[20] & 0xFFFF,
             records[20] >> 16)
    c = KCS.k2_counts(rec, boxes, kw["height"], kw["width"])
    want = _numpy_walk(rec, kw["height"], kw["width"],
                       tuple(b.numpy() for b in boxes))
    got = list(zip(*(c[k].tolist() for k in ("walked", "evaluated",
                                             "needed", "octets_skipped"))))
    assert got == want
    assert c["walked"][1] == brk - t1 and c["octets_skipped"][1] > 0
    sm = KCS.summary(c)
    assert sm["longest_walk"] == brk - t1
    assert sm["walked"] == sum(w[0] for w in want)
    moved, ops, tile_ops, evaluated, needed, walk = KCS.k2_work(
        rec, boxes, kw["height"], kw["width"])
    assert (evaluated, needed, walk) == (sm["evaluated"], sm["needed"],
                                         sm["longest_walk"])
    assert ops == sm["ops"] and tile_ops == sm["busiest_tile_ops"]


def _frame(color):
    return types.SimpleNamespace(color=torch.as_tensor(color))


def test_bench_frame_check_raises():
    """The bench's frame comparison raises on unequal frames (the original
    logged a WARNING and zeroed the FPS) and passes equal ones."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    TB.check_same(_frame(a), _frame(a.copy()), "same")
    b = a.copy()
    b[1, 2] += 1
    with pytest.raises(AssertionError, match="1 pixels differ"):
        TB.check_same(_frame(b), _frame(a), "pipelined")


def test_bench_flythrough_failure_raises(monkeypatch):
    """A failed flythrough process raises with its error output (the
    original logged it and went on)."""
    def failed(*a, **k):
        return subprocess.CompletedProcess(a, 1, "", "Traceback: boom")

    monkeypatch.setattr(TB.subprocess, "run", failed)
    with pytest.raises(RuntimeError, match="boom"):
        TB.fly(4, {})

    def silent(*a, **k):
        return subprocess.CompletedProcess(a, 0, "no line\n", "")

    monkeypatch.setattr(TB.subprocess, "run", silent)
    with pytest.raises(RuntimeError, match="FLYTHROUGH|failed"):
        TB.fly(4, {})


def test_micro_sort_merge_matches_numpy():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 2**32 - 1, 4096, dtype=np.uint32)
    for b in MS.BATCHES:
        rows = torch.sort(torch.from_numpy(base.astype(np.int64)).reshape(
            b, -1), 1).values
        np.testing.assert_array_equal(MS.merge_sorted_rows(rows).numpy(),
                                      np.sort(base))


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(PORT_BENCHES) if f.endswith(".py")))
def test_port_bench_imports_no_jax(name):
    """Every module of the port's benches/ parses and imports neither jax
    nor the JAX package, by its syntax tree."""
    with open(os.path.join(PORT_BENCHES, name)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "benches"), m
            assert top != "differential_projection_voxel_renderer_tpu", m


def test_jax_benches_load_without_running():
    """The JAX bench scripts the port's benches port load by path with
    nothing run at import (their entry points are ``main``)."""
    for name in ("flythrough_bench", "fly_profile", "flythrough_diag",
                 "micro_hiz", "micro_sort", "run_benches"):
        mod = _load_jax_bench(name)
        assert callable(getattr(mod, "main", None)) or name == "run_benches"
