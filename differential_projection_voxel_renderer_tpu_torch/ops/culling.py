"""Chunk-level culling funnel: horizon culling + front-to-back ordering.

Horizon culling (reference src/rendering/culling.rs:40-119): sweep visible
chunk meshes front-to-back; a chunk is culled when its center slope sits
clearly below the angular horizon built by nearer kept chunks; kept chunks
raise their bin's horizon with their top slope.  The sweep is inherently
sequential (kept chunks alter later decisions — a culled chunk must NOT
raise the horizon or holes appear), so it runs on the host over the few
hundred visible meshes (~0.3 ms in the reference, README.md:35), with a C++
fast path (native/src/greedy_mesh.cpp::horizon_cull) and a numpy/Python
fallback.  The vectorizable preamble (distances, bins, slopes) is numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..meshing import native_bridge
from ..utils.config import CHUNK_SIZE


@dataclass
class HorizonCullingConfig:
    """culling.rs:27-35."""

    bins: int = 128
    base_margin: float = 0.1
    margin_dist_factor: float = 0.05
    min_dist_chunks: float = 2.0


def horizon_cull_mask(
    centers: np.ndarray,  # f32[n, 3] mesh centers, PRE-SORTED front-to-back
    cam_pos: np.ndarray,
    config: HorizonCullingConfig | None = None,
    *,
    use_native: bool = True,
) -> np.ndarray:
    """Returns keep mask bool[n] over front-to-back-sorted mesh centers."""
    config = config or HorizonCullingConfig()
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    cam = np.asarray(cam_pos, dtype=np.float32)
    n = centers.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)

    if use_native:
        keep = native_bridge.horizon_cull_native(
            centers, cam, config.bins, config.base_margin,
            config.margin_dist_factor, config.min_dist_chunks,
            float(CHUNK_SIZE),
        )
        if keep is not None:
            return keep.astype(bool)

    # numpy preamble + python sweep fallback
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
            dist_xz > 0, (d[:, 1] + CHUNK_SIZE * 0.5) / dist_xz, 0.0
        )
    margin = config.base_margin * (1.0 + dist_chunks * config.margin_dist_factor)

    horizon = np.full(config.bins, -np.inf, dtype=np.float32)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if dist_xz[i] < 1e-3 or dist_chunks[i] < config.min_dist_chunks:
            continue  # always kept; does not build or respect horizon
        b = bins[i]
        cull = slope[i] >= 0.0 and (slope[i] + margin[i]) < horizon[b]
        if cull:
            keep[i] = False
        else:
            if top_slope[i] > horizon[b]:
                horizon[b] = top_slope[i]
    return keep


def sort_front_to_back(centers: np.ndarray, cam_pos: np.ndarray) -> np.ndarray:
    """Stable front-to-back order by squared distance (main.rs:366-377).
    Returns the permutation indices."""
    d = np.asarray(centers, np.float32) - np.asarray(cam_pos, np.float32)[None, :]
    dist_sq = (d * d).sum(-1)
    return np.argsort(dist_sq, kind="stable")
