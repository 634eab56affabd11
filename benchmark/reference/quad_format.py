# Frozen copy of differential_projection_voxel_renderer_tpu_torch/meshing/quad_format.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Packed 32-bit quad format — the TPU analogue of the reference's TinyQuad.

The reference compresses a merged face rectangle to 3 bytes (TinyQuad,
src/meshing/mesh.rs:271-342) and stores quads in per-(face, slice) buckets
(FaceList, mesh.rs:347-417).  On TPU we want one flat, static-shape,
vectorized-decodable stream per chunk, so we widen to exactly 32 bits and
fold the bucket coordinates (face, slice) into the word:

==========  ====  ==========================================================
bits        size  field
==========  ====  ==========================================================
0..4        5     u      (0..31) first tangent coordinate
5..9        5     v      (0..31) second tangent coordinate
10..15      6     w - 1  (1..32) extent along u
16..21      6     h - 1  (1..32) extent along v
22..23      2     block type (1..3; 0 = air never emitted)
24..28      5     slice index (positive faces store axis_pos - 1, negative
                  faces store axis_pos — the FaceList convention,
                  mesh.rs:489-523)
29..31      3     face direction (FaceDir order: +X -X +Y -Y +Z -Z,
                  mesh.rs:136-143)
==========  ====  ==========================================================

Geometry decode (u, v) -> (x, y, z) matches tiny_quad_to_vertices
(mesh.rs:610-686): X faces map (u, v) -> (y, z); Y faces -> (x, z);
Z faces -> (x, y); the remaining coordinate is ``axis_pos``
(slice + 1 for positive faces, slice for negative faces).
"""

from __future__ import annotations

import numpy as np

# Face direction indices (FaceDir as u8, mesh.rs:136-143)
POS_X, NEG_X, POS_Y, NEG_Y, POS_Z, NEG_Z = range(6)

FACE_NORMALS = np.array(
    [
        [1, 0, 0],
        [-1, 0, 0],
        [0, 1, 0],
        [0, -1, 0],
        [0, 0, 1],
        [0, 0, -1],
    ],
    dtype=np.int32,
)

# World-space (tangent, bitangent) per face: the directions along which the
# quad's (u, v) extents grow.  NOTE: unlike the reference's FaceBasis
# (differential_projection.rs:249-288), negative faces do NOT flip an axis:
# `origin + u*tangent + v*bitangent` must land on the true voxel corner for
# every face so the projected geometry is position-exact.  (The reference
# flipped bitangents for right-handedness, which displaces negative-face
# packets; its production Pipeline A never consumes FaceBasis so the quirk is
# invisible there.  We fix it deliberately and cover it with tests.)
FACE_TANGENTS = np.array(
    [
        [0, 1, 0],  # +X: u -> Y
        [0, 1, 0],  # -X: u -> Y
        [1, 0, 0],  # +Y: u -> X
        [1, 0, 0],  # -Y: u -> X
        [1, 0, 0],  # +Z: u -> X
        [1, 0, 0],  # -Z: u -> X
    ],
    dtype=np.int32,
)
FACE_BITANGENTS = np.array(
    [
        [0, 0, 1],  # +X: v -> Z
        [0, 0, 1],  # -X: v -> Z
        [0, 0, 1],  # +Y: v -> Z
        [0, 0, 1],  # -Y: v -> Z
        [0, 1, 0],  # +Z: v -> Y
        [0, 1, 0],  # -Z: v -> Y
    ],
    dtype=np.int32,
)

FACE_IS_POSITIVE = np.array([True, False, True, False, True, False])
FACE_AXIS = np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)


def pack_quads(u, v, w, h, block, slice_idx, face) -> np.ndarray:
    """Vectorized quad packing -> uint32."""
    u = np.asarray(u, np.uint32)
    v = np.asarray(v, np.uint32)
    w = np.asarray(w, np.uint32)
    h = np.asarray(h, np.uint32)
    block = np.asarray(block, np.uint32)
    slice_idx = np.asarray(slice_idx, np.uint32)
    face = np.asarray(face, np.uint32)
    return (
        (u & 0x1F)
        | ((v & 0x1F) << 5)
        | (((w - 1) & 0x3F) << 10)
        | (((h - 1) & 0x3F) << 16)
        | ((block & 0x3) << 22)
        | ((slice_idx & 0x1F) << 24)
        | ((face & 0x7) << 29)
    ).astype(np.uint32)


def unpack_quads(q) -> dict[str, np.ndarray]:
    """Vectorized decode of packed quads (numpy).  Returns int32 fields."""
    q = np.asarray(q, np.uint32)
    u = (q & 0x1F).astype(np.int32)
    v = ((q >> 5) & 0x1F).astype(np.int32)
    w = (((q >> 10) & 0x3F) + 1).astype(np.int32)
    h = (((q >> 16) & 0x3F) + 1).astype(np.int32)
    block = ((q >> 22) & 0x3).astype(np.int32)
    slice_idx = ((q >> 24) & 0x1F).astype(np.int32)
    face = ((q >> 29) & 0x7).astype(np.int32)
    return dict(u=u, v=v, w=w, h=h, block=block, slice_idx=slice_idx, face=face)


def axis_pos(face, slice_idx) -> np.ndarray:
    """Reconstruct the face-plane coordinate from the stored slice index
    (mesh.rs:896-900: positive faces add 1 back)."""
    face = np.asarray(face)
    slice_idx = np.asarray(slice_idx, np.int32)
    return np.where(FACE_IS_POSITIVE[face], slice_idx + 1, slice_idx).astype(np.int32)


def quad_corners_local(q) -> np.ndarray:
    """Decode packed quads to 4 chunk-local corner positions, f32[N, 4, 3].

    Corner order is (u0,v0), (u1,v0), (u1,v1), (u0,v1) around the quad —
    a fixed parallelogram parameterization ``P(u, v) = origin + u*T + v*B``.
    (The reference winds corners per face for rasterizer orientation,
    mesh.rs:624-661; our rasterizer is orientation-free so one order
    suffices.)
    """
    f = unpack_quads(q)
    face = f["face"]
    ap = axis_pos(face, f["slice_idx"]).astype(np.float32)
    n = np.abs(FACE_NORMALS[face]).astype(np.float32)  # axis unit
    t = FACE_TANGENTS[face].astype(np.float32)
    b = FACE_BITANGENTS[face].astype(np.float32)
    origin = n * ap[..., None]
    u0 = f["u"].astype(np.float32)[..., None]
    v0 = f["v"].astype(np.float32)[..., None]
    u1 = (f["u"] + f["w"]).astype(np.float32)[..., None]
    v1 = (f["v"] + f["h"]).astype(np.float32)[..., None]
    c00 = origin + t * u0 + b * v0
    c10 = origin + t * u1 + b * v0
    c11 = origin + t * u1 + b * v1
    c01 = origin + t * u0 + b * v1
    return np.stack([c00, c10, c11, c01], axis=-2)
