"""Chunk: a 32^3 voxel container.

TPU-first design: voxel data is a dense ``uint8[32, 32, 32]`` numpy array
indexed ``[z, y, x]`` — exactly the linear layout of the reference
(``index = z*1024 + y*32 + x``, src/voxel/chunk.rs:52) — so it uploads to the
device and feeds the vectorized meshing ops without any reshuffling.
Uniform chunks (all air / all stone) are stored as a single scalar, mirroring
the reference's ``ChunkData::Uniform`` memory optimization
(src/voxel/chunk.rs:14-20).

Terrain generation mirrors src/voxel/chunk.rs:114-177 (Perlin seed 12345,
scale 0.01, amplitude 20, grass/dirt(3)/stone layering, all-air / all-solid
early-outs) but is fully vectorized: one noise call per 32x32 column grid
instead of per-voxel sampling.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..utils.config import (
    CHUNK_SIZE,
    CHUNK_VOLUME,
    TERRAIN_AMPLITUDE,
    TERRAIN_DIRT_DEPTH,
    TERRAIN_SCALE,
    TERRAIN_SEED,
    TERRAIN_SOLID_MARGIN,
)
from .block_type import BLOCK_IS_SOLID, BlockType
from .perlin import Perlin


@functools.lru_cache(maxsize=8)
def _terrain_noise(seed: int) -> Perlin:
    return Perlin(seed)


# Per-column height-grid cache: terrain height depends only on (x, z), so
# every chunk in a vertical stack shares one 32x32 height grid, and the
# streaming sphere re-requests the same columns as it moves (generation
# was ~0.8 ms/chunk, dominated by the noise evaluation; a hit costs ~1 us).
_HEIGHT_CACHE: dict[tuple[int, int, int], np.ndarray] = {}
_HEIGHT_CACHE_MAX = 8192


def _native_lib():
    """The C++ runtime library, or None (lazy; meshing/native_bridge)."""
    from ..meshing import native_bridge

    return native_bridge._build_and_load()


def _column_heights(px: int, pz: int, seed: int) -> np.ndarray:
    key = (px, pz, seed)
    h = _HEIGHT_CACHE.get(key)
    if h is None:
        lib = _native_lib()
        if lib is not None:
            # native fast path: same bits as the numpy sampler (the noise
            # goes through the parity-tested perlin_grid_twin; fresh-column
            # generation measured 0.32 ms numpy -> ~0.01 ms native)
            import ctypes

            h = np.empty((CHUNK_SIZE, CHUNK_SIZE), np.int32)
            lib.terrain_heights(ctypes.c_uint32(seed & 0xFFFFFFFF),
                                ctypes.c_int64(px), ctypes.c_int64(pz),
                                h.ctypes.data_as(ctypes.c_void_p))
        else:
            xs = np.arange(CHUNK_SIZE, dtype=np.int64) + px * CHUNK_SIZE
            zs = np.arange(CHUNK_SIZE, dtype=np.int64) + pz * CHUNK_SIZE
            zz, xx = np.meshgrid(zs, xs, indexing="ij")
            h = sample_terrain_height(xx, zz, seed=seed)
        if len(_HEIGHT_CACHE) >= _HEIGHT_CACHE_MAX:
            _HEIGHT_CACHE.clear()
        _HEIGHT_CACHE[key] = h
    return h


def sample_terrain_height(x, z, *, seed: int = TERRAIN_SEED) -> np.ndarray:
    """Terrain height at world (x, z) — vectorized.

    Matches src/voxel/chunk.rs:172-177: ``(perlin(x*0.01, z*0.01) * 20) as i32``
    (Rust ``as i32`` truncates toward zero).
    """
    noise = _terrain_noise(seed)
    x = np.asarray(x, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    v = noise.get(x * TERRAIN_SCALE, z * TERRAIN_SCALE)
    return np.trunc(v * TERRAIN_AMPLITUDE).astype(np.int32)


@dataclass
class Chunk:
    """A 32^3 block of voxels at a chunk-grid position.

    ``data`` is either a scalar ``uint8`` block code (uniform chunk) or a
    dense ``uint8[32,32,32]`` array indexed ``[z, y, x]``.
    """

    position: tuple[int, int, int]
    data: np.ndarray | int

    # ---------------------------------------------------------------- ctor
    @staticmethod
    def uniform(position, block_type: int) -> "Chunk":
        return Chunk(tuple(int(c) for c in position), int(block_type))

    @staticmethod
    def varied(position, blocks: np.ndarray) -> "Chunk":
        blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        assert blocks.shape == (CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE)
        return Chunk(tuple(int(c) for c in position), blocks)

    # ------------------------------------------------------------- queries
    @property
    def is_uniform(self) -> bool:
        return np.isscalar(self.data) or np.ndim(self.data) == 0

    def uniform_block_type(self):
        return int(self.data) if self.is_uniform else None

    def get_block(self, x: int, y: int, z: int) -> int:
        if self.is_uniform:
            return int(self.data)
        return int(self.data[z, y, x])

    def get_block_index(self, index: int) -> int:
        """Linear-index access, ZYX order (src/voxel/chunk.rs:59-67)."""
        x, y, z = index_to_coords(index)
        return self.get_block(x, y, z)

    def set_block(self, x: int, y: int, z: int, block: int) -> None:
        """Converts uniform chunks to varied on first write
        (src/voxel/chunk.rs:97-111)."""
        if self.is_uniform:
            self.data = np.full(
                (CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE), int(self.data), dtype=np.uint8
            )
        self.data[z, y, x] = np.uint8(block)
        self._solid_cache = None

    @property
    def position_key(self) -> tuple[int, int, int]:
        """Hashable grid position (cached — the hot membership key in the
        per-frame remesh scan)."""
        k = getattr(self, "_poskey", None)
        if k is None:
            k = tuple(int(c) for c in self.position)
            self._poskey = k
        return k

    def dense(self) -> np.ndarray:
        """Dense uint8[z, y, x] view (materializes uniform chunks)."""
        if self.is_uniform:
            return np.full(
                (CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE), int(self.data), dtype=np.uint8
            )
        return self.data

    def solid(self) -> np.ndarray:
        """bool[z, y, x] solidity mask (cached; a meshed chunk's mask is
        reread by up to 6 neighbor remeshes — invalidated by set_block)."""
        cached = getattr(self, "_solid_cache", None)
        if cached is None:
            cached = BLOCK_IS_SOLID[np.minimum(self.dense(), 3)]
            self._solid_cache = cached
        return cached

    # -------------------------------------------------------- constructors
    @staticmethod
    def generate_terrain(position, *, seed: int = TERRAIN_SEED) -> "Chunk":
        """Perlin terrain, vectorized (reference: src/voxel/chunk.rs:114-170)."""
        px, py, pz = (int(c) for c in position)
        wy0 = py * CHUNK_SIZE

        # heights[z, x] — one sample per column, cached per (px, pz)
        heights = _column_heights(px, pz, seed)

        min_h = int(heights.min())
        max_h = int(heights.max())
        chunk_min_y = wy0
        chunk_max_y = wy0 + CHUNK_SIZE

        # Early-outs (chunk.rs:127-134)
        if chunk_min_y > max_h:
            return Chunk.uniform(position, BlockType.AIR)
        if chunk_max_y < min_h - TERRAIN_SOLID_MARGIN:
            return Chunk.uniform(position, BlockType.STONE)

        lib = _native_lib()
        if lib is not None:
            import ctypes

            heights_i32 = np.ascontiguousarray(heights, np.int32)
            blocks = np.empty((CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE),
                              np.uint8)
            lib.terrain_fill(
                heights_i32.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int32(wy0),
                blocks.ctypes.data_as(ctypes.c_void_p))
            return Chunk(tuple(int(c) for c in position), blocks)

        # world_y[y] broadcast against heights[z, x]
        wy = (np.arange(CHUNK_SIZE, dtype=np.int32) + wy0)[None, :, None]
        h = heights[:, None, :]  # [z, 1, x]
        blocks = np.where(
            wy > h,
            np.uint8(BlockType.AIR),
            np.where(
                wy == h,
                np.uint8(BlockType.GRASS),
                np.where(
                    wy > h - TERRAIN_DIRT_DEPTH,
                    np.uint8(BlockType.DIRT),
                    np.uint8(BlockType.STONE),
                ),
            ),
        ).astype(np.uint8)
        return Chunk.varied(position, blocks)

    @staticmethod
    def generate_test_solid(position) -> "Chunk":
        """Fully-solid stone chunk stored as varied data, for tests
        (reference: src/voxel/chunk.rs:180-189)."""
        return Chunk.varied(
            position,
            np.full((CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE), int(BlockType.STONE), np.uint8),
        )


def coords_to_index(x: int, y: int, z: int) -> int:
    """(x,y,z) -> linear ZYX index (src/voxel/chunk.rs:212-214)."""
    return z * CHUNK_SIZE * CHUNK_SIZE + y * CHUNK_SIZE + x


def index_to_coords(index: int) -> tuple[int, int, int]:
    """linear ZYX index -> (x,y,z) (src/voxel/chunk.rs:218-224)."""
    z = index // (CHUNK_SIZE * CHUNK_SIZE)
    rem = index % (CHUNK_SIZE * CHUNK_SIZE)
    y = rem // CHUNK_SIZE
    x = rem % CHUNK_SIZE
    return x, y, z
