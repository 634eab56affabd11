# Frozen copy of the Python path of differential_projection_voxel_renderer_
# tpu_torch/meshing/greedy.py (greedy_mesh_slice, mesh_from_masks) at commit
# 1521963; the port meshes with its C++ mesher, which gives the same words.
"""Binary greedy meshing of one chunk against its neighbours (reference
src/meshing/binary_greedy.rs:683-807): packed uint32 quads, grouped by
face direction (+X, -X, +Y, -Y, +Z, -Z), or an empty array."""

from __future__ import annotations

import numpy as np

from .block_type import BLOCK_IS_SOLID, BLOCK_TYPE_COUNT
from .constants import CHUNK_SIZE
from .face_masks import exposed_faces, neighbor_solid_planes, pack_slice_masks
from .quad_format import pack_quads

NEIGHBOR_OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                    (0, 0, 1), (0, 0, -1))
_EMPTY = np.zeros(0, np.uint32)


def greedy_mesh_slice(mask_rows: np.ndarray) -> list[tuple[int, int, int, int]]:
    """Greedy-merge one 32x32 bit slice into (row, col, width, height)
    rectangles, consuming bits as it merges."""
    data = [int(v) for v in mask_rows]
    quads: list[tuple[int, int, int, int]] = []
    for row in range(CHUNK_SIZE):
        if data[row] == 0:
            continue
        col = 0
        while col < CHUNK_SIZE:
            rest = data[row] >> col
            if rest == 0:
                break
            tz = (rest & -rest).bit_length() - 1
            col += tz
            rest >>= tz
            height = 0
            while (rest >> height) & 1:
                height += 1
            height_mask = (1 << height) - 1 if height < 32 else 0xFFFFFFFF
            mask = height_mask << col
            width = 1
            while row + width < CHUNK_SIZE:
                if ((data[row + width] >> col) & height_mask) != height_mask:
                    break
                data[row + width] &= ~mask
                width += 1
            quads.append((row, col, width, height))
            data[row] &= ~mask
            col += height
    return quads


def mesh_from_masks(masks: np.ndarray) -> np.ndarray:
    out = ([], [], [], [], [], [], [])
    for face in range(6):
        for slice_idx in range(CHUNK_SIZE):
            for btype in range(BLOCK_TYPE_COUNT):
                rows = masks[face, btype, slice_idx]
                if not rows.any():
                    continue
                for (row, col, width, height) in greedy_mesh_slice(rows):
                    for lst, val in zip(out, (row, col, width, height, btype,
                                              slice_idx, face)):
                        lst.append(val)
    if not out[0]:
        return _EMPTY
    return pack_quads(*out)


def _solid(blocks) -> np.ndarray | None:
    """bool[z, y, x] solidity of a chunk as ``Terrain.chunk`` gives it."""
    if isinstance(blocks, np.ndarray):
        return BLOCK_IS_SOLID[np.minimum(blocks, 3)]
    if BLOCK_IS_SOLID[int(blocks)]:
        return np.ones((CHUNK_SIZE,) * 3, bool)
    return None


def mesh_chunk(blocks, neighbors) -> np.ndarray:
    """Quads of a chunk (``Terrain.chunk``'s value) whose six neighbours
    (in NEIGHBOR_OFFSETS order) are given the same way, or ``None`` where
    the neighbour was not loaded (its faces count as air).  A uniform chunk
    meshes to nothing (binary_greedy.rs:87-89)."""
    if not isinstance(blocks, np.ndarray):
        return _EMPTY
    planes = neighbor_solid_planes(
        {f: (None if nb is None else _solid(nb))
         for f, nb in enumerate(neighbors)})
    masks = pack_slice_masks(exposed_faces(_solid(blocks), planes), blocks)
    return mesh_from_masks(masks)
