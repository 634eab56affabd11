"""The benches' scene: the headline draw list expanded into a quad stream,
with its camera, cached to a file of its own.

The counterpart of ``benches/profile_stages.py``'s ``build_scene`` and
``get_scene``: an Engine at 1280x720, view distance 12 (frustum culling,
16 chunks generated a frame, an 8192-slot pool), its world settled and
primed at a pose, one frame rendered, and that frame's draw list expanded
(``Renderer.prepare_uploads``).  The pose is the reference start pose
``(0, 10, 20) -> (0, 0, -60)`` or a key of
``app/flythrough.default_path(PATH_KEYS)``.  The scene is cached to
``dpvr_torch_scene_vd<vd>_<pose>.npz`` in the temporary directory
(``tempfile.gettempdir()``), never the JAX bench's file, so the two
packages never read each other's cache.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..app.engine import Engine
from ..app.flythrough import default_path
from ..models.world import WorldConfig
from ..ops.projection import as_quad_words
from ..utils.config import RenderConfig

WIDTH, HEIGHT, VIEW_DISTANCE = 1280, 720, 12
START_POS, START_TARGET = (0.0, 10.0, 20.0), (0.0, 0.0, -60.0)
POOL_SLOTS = 8192
# the flythrough whose keys are the other poses (chip_smoke.py phase 14)
PATH_KEYS = 24


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pose_of(pose) -> tuple:
    """("start" or a key of default_path(PATH_KEYS)) -> (position,
    target)."""
    if pose == "start":
        return START_POS, START_TARGET
    key = default_path(PATH_KEYS)[int(pose)]
    return tuple(key.position.tolist()), tuple(key.target.tolist())


def pose_name(pose) -> str:
    return "start" if pose == "start" else f"key{int(pose)}"


def cache_path(vd: int = VIEW_DISTANCE, pose="start") -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"dpvr_torch_scene_vd{vd}_{pose_name(pose)}.npz")


def new_engine(vd: int = VIEW_DISTANCE, *, width: int = WIDTH,
               height: int = HEIGHT, pose="start", device="cuda",
               pool_slots: int = POOL_SLOTS, **config_kw) -> Engine:
    """An engine of the benches' configuration (``config_kw`` to its
    RenderConfig), the camera at ``pose`` and the world settled there
    (nothing meshed)."""
    pos, target = pose_of(pose)
    eng = Engine(
        render_config=RenderConfig(width=width, height=height, **config_kw),
        world_config=WorldConfig(view_distance=vd, frustum_culling=True,
                                 max_chunks_per_frame=16),
        pool_slots=pool_slots, device=device)
    eng.camera.position = np.array(pos, np.float32)
    eng.camera.look_at(np.array(target, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    return eng


def build_scene(vd: int = VIEW_DISTANCE, *, width: int = WIDTH,
                height: int = HEIGHT, pose="start", device="cuda"):
    """(quads u32[GQ], quad_world f32[3, GQ], total, view_proj f32[4, 4],
    cam_pos f32[3]) of the frame at ``pose``: the world settled,
    ``prime()``, one frame, its draw list expanded."""
    eng = new_engine(vd, width=width, height=height, pose=pose,
                     device=device)
    eng.prime()
    eng.render_frame(dt=0.0)
    quads, quad_world, total = eng.renderer.prepare_uploads(
        eng.pool.quads, eng._last_visible_slots, eng._last_counts_sel,
        eng._last_positions_sel, dir_mask=eng._last_dir_mask)
    return (quads.cpu().numpy().view(np.uint32), quad_world.cpu().numpy(),
            int(total), eng.camera.view_projection_matrix().astype(np.float32),
            np.asarray(eng.camera.position, np.float32))


def save_scene(path: str, scene) -> None:
    """Write ``scene`` to ``path`` atomically (a reader never sees half a
    file)."""
    quads, quad_world, total, vp, cam = scene
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, quads=quads, quad_world=quad_world, total=total, vp=vp,
             cam=cam)
    os.replace(tmp, path)


def load_scene(path: str):
    z = np.load(path)
    return (z["quads"], z["quad_world"], int(z["total"]), z["vp"], z["cam"])


def get_scene(vd: int = VIEW_DISTANCE, *, pose="start", device="cuda",
              path: str | None = None, **build_kw):
    """The cached scene at ``pose``, built (on ``device``) and cached at
    the first call."""
    path = path or cache_path(vd, pose)
    if os.path.exists(path):
        return load_scene(path)
    t0 = time.time()
    scene = build_scene(vd, pose=pose, device=device, **build_kw)
    save_scene(path, scene)
    log(f"scene built in {time.time() - t0:.1f}s (cached to {path})")
    return scene


def scene_tensors(scene, device="cuda", gq: int = 0):
    """The scene's stream as the step takes it, on ``device``: (quads
    i32[GQ], quad_world f32[3, GQ], n_quads i32 scalar, view_proj, cam_pos);
    ``gq`` > 0 keeps the stream's first ``gq`` entries (``PROF_GQ``)."""
    quads, quad_world, total, vp, cam = scene
    if gq:
        quads, quad_world, total = quads[:gq], quad_world[:, :gq], min(
            total, gq)
    dev = torch.device(device)
    return (as_quad_words(quads).to(dev),
            torch.from_numpy(np.ascontiguousarray(quad_world)).to(dev),
            torch.tensor(total, dtype=torch.int32).to(dev),
            torch.from_numpy(np.asarray(vp, np.float32)).to(dev),
            torch.from_numpy(np.asarray(cam, np.float32)).to(dev))


def jittered_cameras(vp, cam, k: int, seed: int = 0):
    """``k`` cameras about (vp, cam), as the originals jitter them so that
    no iteration repeats another: positions + N(0, 0.01), the matrix's
    last row + N(0, 1e-6).  (vps f32[k, 4, 4], cams f32[k, 3]), numpy."""
    rng = np.random.default_rng(seed)
    cams = np.repeat(np.asarray(cam, np.float32)[None], k, 0)
    cams += rng.normal(0, 0.01, cams.shape).astype(np.float32)
    vps = np.repeat(np.asarray(vp, np.float32)[None], k, 0)
    vps[:, 3, :] += rng.normal(0, 1e-6, (k, 4)).astype(np.float32)
    return vps, cams
