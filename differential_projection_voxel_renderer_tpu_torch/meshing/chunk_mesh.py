"""Per-chunk mesh container: the reference's ``ChunkMesh`` / ``FaceList``
data model (src/meshing/mesh.rs:347-436) over the packed 32-bit quad word.

The reference buckets ``TinyQuad``s into ``[Vec<TinyQuad>; 32]`` per-slice
lists per face direction, tracks a running local AABB per face list
(mesh.rs:389-405), and decompresses quads to 4 world-space corners with
per-face winding tables (``tiny_quad_to_vertices``, mesh.rs:610-686).
This module provides the same views over the flat packed-quad stream the
TPU pipeline actually renders from — the buckets are *derived* (numpy
group-by), not the storage format, because the device consumes one flat
stream per chunk (see rendering/pipeline.py).

Winding note: corner order follows FACE_TANGENTS/FACE_BITANGENTS
(quad_format.py), which are NOT mirrored for negative faces — the
documented deviation from the reference's flipped bitangents
(mesh.rs:136-240); ``corner_winding`` applies the reference's
counter-clockwise order on top so triangle-facing tests can use either
convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .quad_format import (
    FACE_IS_POSITIVE,
    pack_quads,
    quad_corners_local,
    unpack_quads,
)

N_FACES = 6
N_SLICES = 32


@dataclass
class FaceList:
    """One face direction's quads, bucketed per slice, with the running
    local-space AABB of every quad added (mesh.rs:347-417)."""

    face: int
    slices: list[np.ndarray] = field(
        default_factory=lambda: [np.empty(0, np.uint32) for _ in range(N_SLICES)]
    )
    aabb_min: np.ndarray = field(
        default_factory=lambda: np.full(3, np.inf, np.float32))
    aabb_max: np.ndarray = field(
        default_factory=lambda: np.full(3, -np.inf, np.float32))

    def __len__(self) -> int:
        return int(sum(len(s) for s in self.slices))

    def is_empty(self) -> bool:
        return len(self) == 0

    def extend(self, quads: np.ndarray) -> None:
        """Bucket packed quads (already of this face) by stored slice and
        grow the AABB from their local corners."""
        if len(quads) == 0:
            return
        dec = unpack_quads(quads)
        for sl in np.unique(dec["slice_idx"]):
            sel = quads[dec["slice_idx"] == sl]
            self.slices[int(sl)] = np.concatenate(
                [self.slices[int(sl)], sel])
        corners = quad_corners_local(quads).reshape(-1, 3)
        self.aabb_min = np.minimum(self.aabb_min, corners.min(0))
        self.aabb_max = np.maximum(self.aabb_max, corners.max(0))

    def packed(self) -> np.ndarray:
        """Flat packed stream in slice order (the device-facing view)."""
        return (np.concatenate(self.slices) if len(self) else
                np.empty(0, np.uint32))


class ChunkMesh:
    """Six FaceLists + chunk position (mesh.rs:422-436).

    ``add_quad`` mirrors mesh.rs:489-523: a greedy rectangle plus its face
    direction and *axis position* (the voxel-grid plane, 0..32) becomes a
    packed quad whose stored slice index follows the reference convention
    (positive faces store ``axis_pos - 1``; quad_format.axis_pos inverts).
    """

    def __init__(self, position) -> None:
        self.position = np.asarray(position, np.int32)
        self.faces = [FaceList(f) for f in range(N_FACES)]

    # -- construction -----------------------------------------------------
    @classmethod
    def from_quads(cls, position, quads: np.ndarray) -> "ChunkMesh":
        m = cls(position)
        if quads is None or len(quads) == 0:
            return m
        dec = unpack_quads(np.asarray(quads, np.uint32))
        for f in range(N_FACES):
            m.faces[f].extend(np.asarray(quads)[dec["face"] == f])
        return m

    def add_quad(self, face: int, u: int, v: int, w: int, h: int,
                 block: int, axis_position: int) -> None:
        """mesh.rs:489-523 — positive faces store axis_pos-1 so that
        ``axis_pos(face, slice)`` reconstitutes the plane."""
        stored = axis_position - 1 if FACE_IS_POSITIVE[face] else axis_position
        q = pack_quads([u], [v], [w], [h], [block], [stored], [face])
        self.faces[face].extend(q)

    # -- views ------------------------------------------------------------
    def quad_count(self) -> int:
        return sum(len(f) for f in self.faces)

    def is_empty(self) -> bool:
        return self.quad_count() == 0

    def packed(self) -> np.ndarray:
        """All quads, face-major then slice order — the per-chunk stream
        uploaded to the device pool (app/engine.py)."""
        parts = [f.packed() for f in self.faces if len(f)]
        return (np.concatenate(parts) if parts else np.empty(0, np.uint32))

    def local_aabb(self, face: int | None = None):
        """Local AABB of one face list (or the whole mesh) — what the
        reference projects for the per-face-dir early reject
        (rasterizer.rs:812-881)."""
        lists = self.faces if face is None else [self.faces[face]]
        lists = [f for f in lists if len(f)]
        if not lists:
            return None
        lo = np.min([f.aabb_min for f in lists], 0)
        hi = np.max([f.aabb_max for f in lists], 0)
        return lo, hi

    def corners_world(self, face: int | None = None) -> np.ndarray:
        """Quads -> [N, 4, 3] world-space corners (tiny_quad_to_vertices,
        mesh.rs:610-686), tangent/bitangent corner order."""
        q = self.packed() if face is None else self.faces[face].packed()
        if len(q) == 0:
            return np.empty((0, 4, 3), np.float32)
        return (quad_corners_local(q)
                + (self.position * 32).astype(np.float32)[None, None, :])


# mesh.rs:136-240 — per-face counter-clockwise corner order (indices into
# the tangent/bitangent corner parameterization: 0=(0,0) 1=(u,0) 2=(u,v)
# 3=(0,v)); negative faces reverse so the CCW normal matches FACE_NORMALS.
CORNER_WINDING = np.array([
    [0, 1, 2, 3],   # +X
    [0, 3, 2, 1],   # -X
    [0, 3, 2, 1],   # +Y
    [0, 1, 2, 3],   # -Y
    [0, 1, 2, 3],   # +Z
    [0, 3, 2, 1],   # -Z
], dtype=np.int32)


def corner_winding(face: int) -> np.ndarray:
    return CORNER_WINDING[face]


def winding_normal(corners4: np.ndarray, face: int) -> np.ndarray:
    """Geometric normal of one quad's CCW winding (unit axis vector) —
    lets tests assert winding-vs-normal agreement (meshing_tests.rs)."""
    w = corners4[CORNER_WINDING[face]]
    n = np.cross(w[1] - w[0], w[3] - w[0]).astype(np.float64)
    ln = np.linalg.norm(n)
    return (n / ln if ln else n).astype(np.float32)
