# Frozen copies, at commit 1521963, of the host funnel of
# differential_projection_voxel_renderer_tpu_torch: World.get_visible_positions
# (models/world.py), sort_front_to_back and the numpy path of
# horizon_cull_mask (ops/culling.py), Engine._dir_keep_mask and the draw-list
# steps of Engine._funnel (app/engine.py).
"""The draw list of a frame: the loaded chunks inside the view sphere and
the frustum, those with a non-empty mesh, front to back, less those behind
the horizon, at most ``vcap`` of them; and each one's face-direction keep
mask."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .camera import Camera, Frustum
from .constants import CHUNK_SIZE


@dataclass
class HorizonCullingConfig:
    """src/rendering/culling.rs:27-35."""

    bins: int = 128
    base_margin: float = 0.1
    margin_dist_factor: float = 0.05
    min_dist_chunks: float = 2.0


def camera_of(position, yaw: float, pitch: float, width: int,
              height: int) -> Camera:
    cam = Camera(np.asarray(position, np.float32), width / height)
    cam.yaw, cam.pitch = float(yaw), float(pitch)
    return cam


def chunk_of(position) -> np.ndarray:
    p = np.asarray(position, dtype=np.float32)
    return np.floor(p / CHUNK_SIZE).astype(np.int64)


def visible_positions(keys: np.ndarray, cam_pos, frustum: Frustum,
                      view_distance: int) -> np.ndarray:
    """int64[V, 3]: the loaded chunk positions ``keys`` (in the world's
    table order) inside the view sphere and the frustum, in table order."""
    cam = chunk_of(cam_pos)
    if not len(keys):
        return np.zeros((0, 3), np.int64)
    mins = keys.astype(np.float32) * CHUNK_SIZE
    d = mins * np.float32(1.0 / CHUNK_SIZE) - cam.astype(np.float32)
    dist_sq = np.einsum("ij,ij->i", d, d)
    keep = dist_sq <= np.float32(view_distance ** 2)
    keep &= frustum.inside_mins(mins, float(CHUNK_SIZE))
    return keys[keep]


def sort_front_to_back(centers: np.ndarray, cam_pos) -> np.ndarray:
    d = (np.asarray(centers, np.float32)
         - np.asarray(cam_pos, np.float32)[None, :])
    return np.argsort((d * d).sum(-1), kind="stable")


def horizon_cull_mask(centers: np.ndarray, cam_pos,
                      config: HorizonCullingConfig | None = None
                      ) -> np.ndarray:
    """keep bool[n] over front-to-back-sorted mesh centres."""
    config = config or HorizonCullingConfig()
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    cam = np.asarray(cam_pos, dtype=np.float32)
    n = centers.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    d = centers - cam[None, :]
    dist_xz = np.hypot(d[:, 0], d[:, 2])
    dist_chunks = dist_xz / CHUNK_SIZE
    angle = np.arctan2(d[:, 2], d[:, 0])
    bin_f = (angle + np.pi) / (2 * np.pi) * config.bins
    bins = np.floor(bin_f).astype(np.int64)
    bins = np.where(bins < 0, bins + config.bins, bins) % config.bins
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.where(dist_xz > 0, d[:, 1] / dist_xz, 0.0)
        top_slope = np.where(
            dist_xz > 0, (d[:, 1] + CHUNK_SIZE * 0.5) / dist_xz, 0.0)
    margin = config.base_margin * (1.0 + dist_chunks
                                   * config.margin_dist_factor)
    horizon = np.full(config.bins, -np.inf, dtype=np.float32)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if dist_xz[i] < 1e-3 or dist_chunks[i] < config.min_dist_chunks:
            continue
        b = bins[i]
        if slope[i] >= 0.0 and (slope[i] + margin[i]) < horizon[b]:
            keep[i] = False
        elif top_slope[i] > horizon[b]:
            horizon[b] = top_slope[i]
    return keep


def dir_keep_mask(positions: np.ndarray, cam_pos) -> np.ndarray:
    """int32[n, 6]: 0 where every quad of the face direction is provably
    backfacing from ``cam_pos``."""
    m = positions.astype(np.float32) * np.float32(CHUNK_SIZE)
    cam = np.asarray(cam_pos, np.float32)
    keep = np.empty((len(positions), 6), np.int32)
    for axis in range(3):
        keep[:, 2 * axis] = cam[axis] > m[:, axis] + np.float32(1.0)
        keep[:, 2 * axis + 1] = cam[axis] < m[:, axis] + np.float32(31.0)
    return keep


def draw_list(keys: np.ndarray, cam: Camera, has_quads, *,
              view_distance: int, vcap: int):
    """(positions int64[n, 3], dir masks int32[n, 6]) of the frame seen by
    ``cam`` over the loaded chunks ``keys``; ``has_quads(positions)`` says
    which chunks' meshes are non-empty."""
    vis = visible_positions(keys, cam.position, cam.extract_frustum(),
                            view_distance)
    vis = vis[has_quads(vis)] if len(vis) else vis
    if not len(vis):
        return vis, np.zeros((0, 6), np.int32)
    centers = vis.astype(np.float32) * CHUNK_SIZE + 16.0
    order = sort_front_to_back(centers, cam.position)
    vis, centers = vis[order], centers[order]
    vis = vis[horizon_cull_mask(centers, cam.position)][:vcap]
    return vis, dir_keep_mask(vis, cam.position)
