# Frozen copy of differential_projection_voxel_renderer_tpu_torch/models/block_type.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Block types and their lookup tables.

TPU-first representation: block types are plain ``uint8`` codes everywhere;
properties are tiny constant arrays indexed by code so every query is a
branch-free vectorized lookup — the same design intent as the reference's
LUTs (src/voxel/block_type.rs:16-28), but over whole tensors.
"""

from __future__ import annotations

import enum

import numpy as np


class BlockType(enum.IntEnum):
    """4-type block enum (reference: src/voxel/block_type.rs:6-11)."""

    AIR = 0
    GRASS = 1
    DIRT = 2
    STONE = 3


BLOCK_TYPE_COUNT = 4

# Solidity LUT (reference: src/voxel/block_type.rs:16-21)
BLOCK_IS_SOLID = np.array([False, True, True, True], dtype=bool)

# Base colors, RGB u8 (reference: src/voxel/block_type.rs:23-28)
BLOCK_COLORS = np.array(
    [
        [0, 0, 0],        # Air
        [34, 139, 34],    # Grass
        [139, 69, 19],    # Dirt
        [128, 128, 128],  # Stone
    ],
    dtype=np.uint8,
)

# Packed ARGB32 versions of the flat block colors (0xFF alpha), used by the
# oracle rasterizer and the flat-color span path
# (reference: tests/span_walker_fuzz_tests.rs:145-146).
BLOCK_COLORS_ARGB = np.array(
    [
        0xFF000000
        | (int(c[0]) << 16)
        | (int(c[1]) << 8)
        | int(c[2])
        for c in BLOCK_COLORS
    ],
    dtype=np.uint32,
)


def is_solid(block: np.ndarray | int) -> np.ndarray | bool:
    """Vectorized solidity query. Out-of-range values are treated as air,
    mirroring BlockType::from_u8's clamp-to-Air (block_type.rs:70-78)."""
    b = np.asarray(block)
    return BLOCK_IS_SOLID[np.where(b < BLOCK_TYPE_COUNT, b, 0)]


def texture_id(block: np.ndarray | int) -> np.ndarray | int:
    """Texture atlas index — identity mapping (block_type.rs:58-65)."""
    return np.asarray(block)


def from_u8(value: int) -> BlockType:
    """BlockType::from_u8 — invalid values decode to Air (block_type.rs:70-78)."""
    v = int(value)
    if 0 <= v < BLOCK_TYPE_COUNT:
        return BlockType(v)
    return BlockType.AIR
