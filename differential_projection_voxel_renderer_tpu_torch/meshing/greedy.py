"""Binary greedy meshing — reference-exact host implementation.

This mirrors ``BinaryGreedyMesher::greedy_mesh_slice_into``
(src/meshing/binary_greedy.rs:683-807) bit for bit: row-major scan, runs
found with trailing_zeros / trailing_ones, greedy horizontal expansion that
consumes bits as it merges.  The merge is inherently sequential per slice,
so it runs on the host (numpy/Python here, with an optional C++ fast path in
``native/``); the *mask construction* and everything downstream is
vectorized/TPU-resident.  Rendering output is invariant to the quad
decomposition, but we keep the exact decomposition so quad-count tests and
packet layouts match the reference.

``mesh_chunk`` emits packed quads (see quad_format.py) in the reference's
deterministic order: face dirs +X,-X,+Y,-Y,+Z,-Z (binary_greedy.rs:105-112),
slices 0..32, block types Air..Stone (binary_greedy.rs:239), scan order
within a slice.
"""

from __future__ import annotations

import numpy as np

from ..models.block_type import BLOCK_TYPE_COUNT
from ..models.chunk import Chunk
from ..utils.config import CHUNK_SIZE
from . import native_bridge
from .face_masks import exposed_faces, neighbor_solid_planes, pack_slice_masks
from .quad_format import pack_quads


def greedy_mesh_slice(mask_rows: np.ndarray) -> list[tuple[int, int, int, int]]:
    """Greedy-merge one 32x32 bit slice into maximal rectangles.

    ``mask_rows``: uint32[32], bit ``col`` of ``mask_rows[row]`` set = cell
    present.  Returns ``(row, col, width, height)`` tuples where ``width``
    spans rows and ``height`` spans cols — the reference's Quad field naming
    (binary_greedy.rs:793-799: x=row, y=col).
    """
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
            # trailing_zeros: skip to next set bit
            tz = (rest & -rest).bit_length() - 1
            col += tz
            rest >>= tz
            # trailing_ones: run length
            height = 0
            while (rest >> height) & 1:
                height += 1
            height_mask = (1 << height) - 1 if height < 32 else 0xFFFFFFFF
            mask = height_mask << col
            # greedy horizontal (across-rows) expansion, consuming bits
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


def _neighbor_solid_grids(chunk: Chunk, all_chunks) -> dict[int, np.ndarray | None]:
    """Resolve the 6 direct neighbors (binary_greedy.rs:181-209).

    ``all_chunks`` is either a mapping ``pos tuple -> Chunk`` (the engine's
    world dict — O(1) per lookup) or an iterable of chunks (test
    convenience; builds a throwaway table)."""
    pos = chunk.position_key
    offsets = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    if isinstance(all_chunks, dict):
        table = all_chunks
    else:
        table = {c.position_key: c for c in all_chunks}
    out: dict[int, np.ndarray | None] = {}
    for f, off in enumerate(offsets):
        key = (pos[0] + off[0], pos[1] + off[1], pos[2] + off[2])
        nb = table.get(key)
        out[f] = nb.solid() if nb is not None else None
    return out


def slice_masks_for_chunk(chunk: Chunk, all_chunks=None) -> np.ndarray:
    """uint32[6, 4, 32 slices, 32 rows] per-type exposed-face bitmasks."""
    all_chunks = all_chunks if all_chunks is not None else [chunk]
    solid = chunk.solid()
    planes = neighbor_solid_planes(_neighbor_solid_grids(chunk, all_chunks))
    exposed = exposed_faces(solid, planes)
    return pack_slice_masks(exposed, chunk.dense())


def mesh_chunk(chunk: Chunk, all_chunks=None) -> np.ndarray | None:
    """Mesh one chunk against its world; returns packed uint32 quads or None
    for uniform chunks (the reference's uniform fast path,
    binary_greedy.rs:87-89) and for empty meshes (:116-120).
    """
    if chunk.is_uniform:
        return None
    native_full = native_bridge.mesh_chunk_full
    if native_full is not None:
        # fused native path: mask construction + merge in ONE call (the
        # numpy mask packing alone costs ~0.6 ms/chunk of small-array
        # overhead; the native fuse runs the whole chunk in ~50 us)
        all_chunks = all_chunks if all_chunks is not None else [chunk]
        planes = neighbor_solid_planes(
            _neighbor_solid_grids(chunk, all_chunks))
        quads = native_full(chunk.dense(), planes.astype(np.uint8))
        return quads if quads.size else None
    masks = slice_masks_for_chunk(chunk, all_chunks)
    quads = mesh_from_masks(masks)
    return quads if quads.size else None


def mesh_from_masks(masks: np.ndarray) -> np.ndarray:
    """Greedy-merge per-type slice masks -> packed uint32 quads.

    Emission order matches the reference mesher exactly (see module doc).
    Dispatches to the native C++ mesher when available
    (native/src/greedy_mesh.cpp), else the Python reference implementation.
    """
    native = native_bridge.greedy_mesh_masks
    if native is not None:
        return native(masks)
    out_u, out_v, out_w, out_h, out_b, out_s, out_f = [], [], [], [], [], [], []
    for face in range(6):
        for slice_idx in range(CHUNK_SIZE):
            for btype in range(BLOCK_TYPE_COUNT):
                rows = masks[face, btype, slice_idx]
                if not rows.any():
                    continue
                for (row, col, width, height) in greedy_mesh_slice(rows):
                    # add_quad maps Quad{x=row, y=col} -> TinyQuad(u=row, v=col)
                    # (mesh.rs:499-510)
                    out_u.append(row)
                    out_v.append(col)
                    out_w.append(width)
                    out_h.append(height)
                    out_b.append(btype)
                    out_s.append(slice_idx)
                    out_f.append(face)
    if not out_u:
        return np.zeros((0,), dtype=np.uint32)
    return pack_quads(out_u, out_v, out_w, out_h, out_b, out_s, out_f)
