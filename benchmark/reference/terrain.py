# Frozen copy of the numpy path of Chunk.generate_terrain and
# sample_terrain_height, differential_projection_voxel_renderer_tpu_torch/
# models/chunk.py at commit 1521963 (the port's native fast path is left
# out: it gives the same bits).
"""Perlin terrain of one chunk (reference src/voxel/chunk.rs:114-177):
``None`` for a chunk above every column (air), ``3`` for one far below
(stone), else the dense ``uint8[z, y, x]`` blocks."""

from __future__ import annotations

import functools

import numpy as np

from .constants import (CHUNK_SIZE, TERRAIN_AMPLITUDE, TERRAIN_DIRT_DEPTH,
                        TERRAIN_SCALE, TERRAIN_SEED, TERRAIN_SOLID_MARGIN)
from .perlin import Perlin

AIR, GRASS, DIRT, STONE = 0, 1, 2, 3


@functools.lru_cache(maxsize=2)
def _noise(seed: int) -> Perlin:
    return Perlin(seed)


class Terrain:
    """Chunks of the seed's terrain, with the column heights cached."""

    def __init__(self, seed: int = TERRAIN_SEED):
        self.seed = seed
        self._heights: dict[tuple[int, int], np.ndarray] = {}

    def heights(self, px: int, pz: int) -> np.ndarray:
        """int32[z, x] column heights of chunk column (px, pz):
        ``trunc(perlin(x * 0.01, z * 0.01) * 20)``."""
        h = self._heights.get((px, pz))
        if h is None:
            xs = np.arange(CHUNK_SIZE, dtype=np.int64) + px * CHUNK_SIZE
            zs = np.arange(CHUNK_SIZE, dtype=np.int64) + pz * CHUNK_SIZE
            zz, xx = np.meshgrid(zs, xs, indexing="ij")
            v = _noise(self.seed).get(
                np.asarray(xx, np.float64) * TERRAIN_SCALE,
                np.asarray(zz, np.float64) * TERRAIN_SCALE)
            h = np.trunc(v * TERRAIN_AMPLITUDE).astype(np.int32)
            self._heights[px, pz] = h
        return h

    def chunk(self, pos):
        """AIR (0) or STONE (3) for a uniform chunk, else uint8[z, y, x]."""
        px, py, pz = (int(c) for c in pos)
        heights = self.heights(px, pz)
        wy0 = py * CHUNK_SIZE
        if wy0 > int(heights.max()):
            return AIR
        if wy0 + CHUNK_SIZE < int(heights.min()) - TERRAIN_SOLID_MARGIN:
            return STONE
        wy = (np.arange(CHUNK_SIZE, dtype=np.int32) + wy0)[None, :, None]
        h = heights[:, None, :]
        return np.where(
            wy > h, np.uint8(AIR),
            np.where(wy == h, np.uint8(GRASS),
                     np.where(wy > h - TERRAIN_DIRT_DEPTH, np.uint8(DIRT),
                              np.uint8(STONE)))).astype(np.uint8)
