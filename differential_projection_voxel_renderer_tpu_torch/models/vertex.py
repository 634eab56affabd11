"""Legacy packed vertex format and the batched vertex transform.

Counterpart of ``differential_projection_voxel_renderer_tpu/models/
vertex.py``: the 8-byte compressed vertex of the reference's deprecated
meshes (u8 local coordinates, block type, quantized light, packed normal
and ambient occlusion) and its MVP transform, batched over the whole
vertex array.  Packing and unpacking are numpy, as in the reference; the
transform is torch ops on the vertices' device.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_vertices(x, y, z, block_type, light, normal_dir, ao_level) -> np.ndarray:
    """Pack vertex fields into the reference's 8-byte layout (mesh.rs:46-86)
    as a uint64 array: x|y|z|block|light|packed|pad16."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    z = np.asarray(z, np.uint64)
    b = np.asarray(block_type, np.uint64)
    light_u8 = np.clip(np.asarray(light, np.float32), 0, 1) * 255.0 + 0.5
    l = light_u8.astype(np.uint64)
    packed = (np.asarray(normal_dir, np.uint64) & 0x7) | (
        (np.asarray(ao_level, np.uint64) & 0x3) << np.uint64(3)
    )
    return (
        x | (y << np.uint64(8)) | (z << np.uint64(16)) | (b << np.uint64(24))
        | (l << np.uint64(32)) | (packed << np.uint64(40))
    )


def unpack_vertices(v: np.ndarray) -> dict[str, np.ndarray]:
    v = np.asarray(v, np.uint64)
    return dict(
        x=(v & np.uint64(0xFF)).astype(np.int32),
        y=((v >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int32),
        z=((v >> np.uint64(16)) & np.uint64(0xFF)).astype(np.int32),
        block_type=((v >> np.uint64(24)) & np.uint64(0xFF)).astype(np.int32),
        light=((v >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32),
        normal_index=((v >> np.uint64(40)) & np.uint64(0x7)).astype(np.int32),
        ao_level=((v >> np.uint64(43)) & np.uint64(0x3)).astype(np.int32),
    )


def decompress_and_transform_vertices(xs, ys, zs, chunk_offset, mvp):
    """Batched vertex decompress + MVP transform (simd_vertex.rs:62-205):
    local coordinates ``xs``/``ys``/``zs`` (integer or float tensors) plus
    ``chunk_offset`` f32[3] through ``mvp`` f32[4, 4], every vertex at
    once.  Returns the clip-space (cx, cy, cz, cw), f32 tensors, each row
    summed in the reference's order."""
    x = xs.to(torch.float32) + chunk_offset[0]
    y = ys.to(torch.float32) + chunk_offset[1]
    z = zs.to(torch.float32) + chunk_offset[2]
    return tuple(mvp[r, 0] * x + mvp[r, 1] * y + mvp[r, 2] * z + mvp[r, 3]
                 for r in range(4))
