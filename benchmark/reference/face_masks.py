# Frozen copy of differential_projection_voxel_renderer_tpu_torch/meshing/face_masks.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Exposed-face mask extraction — vectorized bitplane construction.

This is the tensorized form of the reference's ``generate_binary_masks``
(src/meshing/binary_greedy.rs:286-440): for each of the 6 face directions,
a voxel face is exposed iff the voxel is solid and its neighbor along the
face normal is not (crossing into adjacent chunks at borders; a missing
neighbor counts as air).

Instead of a 6 x 32 x 1024 scalar loop, the whole test is six shifted
boolean compares over the dense ``[z, y, x]`` grid, then a bit-pack matmul
into ``uint32[6, 32 slices, 32 rows]`` masks per block type, matching the
reference's ``SliceMask = [u32; 32]`` layout (binary_greedy.rs:14) with the
same (slice, row, col-bit) coordinate conventions
(binary_greedy.rs:446-458):

=====  =======  =====  =====
axis   slice    row    col
=====  =======  =====  =====
X      x        y      z
Y      y        x      z
Z      z        x      y
=====  =======  =====  =====
"""

from __future__ import annotations

import numpy as np

from .block_type import BLOCK_TYPE_COUNT
from .constants import CHUNK_SIZE

_BITS = (np.uint32(1) << np.arange(CHUNK_SIZE, dtype=np.uint32)).astype(np.uint32)


def neighbor_solid_planes(neighbors: dict[int, np.ndarray | None]) -> np.ndarray:
    """Extract the 6 boundary solidity planes from neighbor chunks.

    ``neighbors`` maps face index (0..5, FaceDir order) to the neighbor's
    dense solidity grid ``bool[z, y, x]`` (or None = treat as air).  Returns
    ``bool[6, 32, 32]`` where plane ``f`` is the neighbor layer adjacent to
    this chunk across face ``f`` (binary_greedy.rs:463-570 boundary cases):

    - +X: neighbor's x = 0 plane, indexed [z, y]
    - -X: neighbor's x = 31 plane, indexed [z, y]
    - +Y: neighbor's y = 0 plane, indexed [z, x]
    - -Y: neighbor's y = 31 plane, indexed [z, x]
    - +Z: neighbor's z = 0 plane, indexed [y, x]
    - -Z: neighbor's z = 31 plane, indexed [y, x]
    """
    planes = np.zeros((6, CHUNK_SIZE, CHUNK_SIZE), dtype=bool)
    sel = [
        (0, lambda s: s[:, :, 0]),
        (1, lambda s: s[:, :, CHUNK_SIZE - 1]),
        (2, lambda s: s[:, 0, :]),
        (3, lambda s: s[:, CHUNK_SIZE - 1, :]),
        (4, lambda s: s[0, :, :]),
        (5, lambda s: s[CHUNK_SIZE - 1, :, :]),
    ]
    for f, take in sel:
        nb = neighbors.get(f)
        if nb is not None:
            planes[f] = take(nb)
    return planes


def exposed_faces(solid: np.ndarray, nb_planes: np.ndarray) -> np.ndarray:
    """bool[6, z, y, x]: voxel face exposed per direction.

    ``solid`` is bool[z, y, x]; ``nb_planes`` is bool[6, 32, 32] from
    :func:`neighbor_solid_planes`.
    """
    out = np.zeros((6,) + solid.shape, dtype=bool)
    # +X neighbor occupancy at (z, y, x) is solid(z, y, x+1), border from plane
    occ = np.concatenate([solid[:, :, 1:], nb_planes[0][:, :, None]], axis=2)
    out[0] = solid & ~occ
    occ = np.concatenate([nb_planes[1][:, :, None], solid[:, :, :-1]], axis=2)
    out[1] = solid & ~occ
    occ = np.concatenate([solid[:, 1:, :], nb_planes[2][:, None, :]], axis=1)
    out[2] = solid & ~occ
    occ = np.concatenate([nb_planes[3][:, None, :], solid[:, :-1, :]], axis=1)
    out[3] = solid & ~occ
    occ = np.concatenate([solid[1:, :, :], nb_planes[4][None, :, :]], axis=0)
    out[4] = solid & ~occ
    occ = np.concatenate([nb_planes[5][None, :, :], solid[:-1, :, :]], axis=0)
    out[5] = solid & ~occ
    return out


def pack_slice_masks(exposed: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Pack exposed faces into per-type bitmasks.

    Returns ``uint32[6, BLOCK_TYPE_COUNT, 32 slices, 32 rows]`` with col bits
    packed into the u32, matching ``generate_binary_masks``'s output layout
    (binary_greedy.rs:294, 358, 404).
    """
    masks = np.zeros((6, BLOCK_TYPE_COUNT, CHUNK_SIZE, CHUNK_SIZE), dtype=np.uint32)
    for t in range(1, BLOCK_TYPE_COUNT):  # air (0) never emits faces
        is_t = blocks == t
        for f in range(6):
            ex = exposed[f] & is_t  # [z, y, x]
            axis = f // 2
            if axis == 0:
                # slice=x, row=y, col=z: bits over z
                m = (ex.astype(np.uint32) * _BITS[:, None, None]).sum(
                    axis=0, dtype=np.uint32
                )  # [y, x]
                masks[f, t] = m.T  # [slice=x, row=y]
            elif axis == 1:
                # slice=y, row=x, col=z
                m = (ex.astype(np.uint32) * _BITS[:, None, None]).sum(
                    axis=0, dtype=np.uint32
                )  # [y, x]
                masks[f, t] = m  # [slice=y, row=x]
            else:
                # slice=z, row=x, col=y
                m = (ex.astype(np.uint32) * _BITS[None, :, None]).sum(
                    axis=1, dtype=np.uint32
                )  # [z, x]
                masks[f, t] = m  # [slice=z, row=x]
    return masks
