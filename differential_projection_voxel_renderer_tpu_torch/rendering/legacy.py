"""Legacy vertex/index-mesh renderer: the reference's deprecated
pretransformed path, in torch ops.

Counterpart of ``differential_projection_voxel_renderer_tpu/rendering/
legacy.py`` (``render_triangle_pretransformed``, rasterizer.rs:2110-2542):
the compressed vertex stream through the MVP (models/vertex.py), the
perspective divide, and barycentric rasterization with per-vertex light
interpolated across each triangle.  It is a parity path, not a production
one, and the JAX package has no Pallas kernel on it, so neither has the
port.

The reference walks the triangles one at a time (a ``fori_loop``), each
winning a pixel where it covers it strictly nearer than the running depth.
Here blocks of triangles are evaluated at once (as many as keep a
temporary under BLOCK_ELEMENTS elements); at each pixel the
lowest-index triangle of least depth in the block (NaN depths never win;
``-0.0`` ties with ``+0.0``) is compared strictly with the running depth.
That is the one-at-a-time result: within a block a later triangle of
equal depth loses to the earlier one, as its strict test would.
Triangles with any vertex at w <= NEAR_W_EPS are skipped (no near
clipping), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.block_type import BLOCK_COLORS
from ..models.vertex import decompress_and_transform_vertices
from ..ops.shading import AO_FACTORS
from ..utils.config import NEAR_W_EPS, SKY_COLOR

SKY_I32 = int(np.uint32(SKY_COLOR).view(np.int32))
OPAQUE_I32 = int(np.uint32(0xFF000000).view(np.int32))  # alpha 0xFF

# pixels x triangles a block evaluates at once (float32 temporaries of
# this many elements)
BLOCK_ELEMENTS = 1 << 22


def resolve_block(z, inside, depth):
    """The one-at-a-time depth test of a block of triangles, at once: ``z``
    f32[B, H, W] their depths, ``inside`` bool[B, H, W] their coverage,
    ``depth`` f32[H, W] the running depth.  Returns (first i64[H, W], the
    lowest index of least depth among the covering triangles; its depth
    f32[H, W]; win bool[H, W], where it is strictly nearer than
    ``depth``)."""
    zc = torch.where(inside & ~torch.isnan(z), z, float("inf"))
    zmin = zc.amin(0)
    first = torch.argmax((zc == zmin[None]).to(torch.uint8), 0)
    zw = torch.gather(zc, 0, first[None])[0]
    return first, zw, zw < depth


def render_vertex_mesh(vertices, indices, n_tris, chunk_offset, mvp, *,
                       width: int, height: int, init_color=None,
                       init_depth=None):
    """Rasterize an indexed triangle mesh of packed legacy vertices.

    ``vertices``: ``unpack_vertices``' dict as tensors on one device (x, y,
    z local coordinates, block_type, light 0..255, ao_level 0..3);
    ``indices`` i32[T, 3]; ``n_tris`` the live triangle count (an int or
    a device scalar; triangles from it on are skipped); ``chunk_offset``
    f32[3]; ``mvp`` f32[4, 4]; ``init_color`` i32 / ``init_depth`` f32
    [H, W], optional, the frame to draw onto (sky at +inf depth by
    default).  Returns (color i32[H, W] ARGB, depth f32[H, W] NDC).

    Colours follow the reference's vertex-lit shading: the block colour
    times the interpolated ``light / 255 * AO_FACTORS[ao]``."""
    dev = indices.device
    f32 = torch.float32
    cx, cy, cz, cw = decompress_and_transform_vertices(
        vertices["x"], vertices["y"], vertices["z"], chunk_offset, mvp)
    colors_tbl = torch.from_numpy(np.asarray(BLOCK_COLORS,
                                             np.float32)).to(dev)
    ao_tbl = torch.from_numpy(np.asarray(AO_FACTORS, np.float32)).to(dev)
    bright = (vertices["light"].to(f32) / 255.0
              * ao_tbl[vertices["ao_level"].long()])
    base_rgb = colors_tbl[torch.clamp(vertices["block_type"], 0,
                                      colors_tbl.shape[0] - 1).long()]

    eps = np.float32(NEAR_W_EPS).item()
    inv_w = 1.0 / torch.where(cw.abs() > 1e-30, cw, 1e-30)
    sx = (cx * inv_w + 1.0) * (0.5 * width)
    sy = (1.0 - cy * inv_w) * (0.5 * height)
    sz = cz * inv_w
    ok_v = cw > eps

    px = torch.arange(width, dtype=f32, device=dev)[None, None, :] + 0.5
    py = torch.arange(height, dtype=f32, device=dev)[None, :, None] + 0.5
    color = (torch.full((height, width), SKY_I32, dtype=torch.int32,
                        device=dev)
             if init_color is None else init_color.clone())
    depth = (torch.full((height, width), float("inf"), dtype=f32,
                        device=dev)
             if init_depth is None else init_depth.clone())
    n_tris = (n_tris.to(dev) if isinstance(n_tris, torch.Tensor)
              else torch.tensor(int(n_tris), device=dev))
    block_tris = max(1, BLOCK_ELEMENTS // (width * height))
    idx = indices.long()
    for t0 in range(0, idx.shape[0], block_tris):
        tri = idx[t0:t0 + block_tris]
        i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
        live = ((torch.arange(t0, t0 + tri.shape[0], device=dev) < n_tris)
                & ok_v[i0] & ok_v[i1] & ok_v[i2])
        x0, y0 = sx[i0][:, None, None], sy[i0][:, None, None]
        x1, y1 = sx[i1][:, None, None], sy[i1][:, None, None]
        x2, y2 = sx[i2][:, None, None], sy[i2][:, None, None]
        # signed doubled area; the winding flipped so that every edge
        # function is positive inside (rasterizer.rs:2553-2558)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        flip = torch.where(area < 0, -1.0, 1.0)
        area_a = area.abs()
        w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * flip
        w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * flip
        w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * flip
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area_a > 0)
                  & live[:, None, None])
        den = torch.clamp(area_a, min=1e-30)
        b0, b1, b2 = w0 / den, w1 / den, w2 / den
        z = (b0 * sz[i0][:, None, None] + b1 * sz[i1][:, None, None]
             + b2 * sz[i2][:, None, None])
        first, zw, win = resolve_block(z, inside, depth)
        # the winner's shading, with its own barycentrics at each pixel
        b0, b1, b2 = (torch.gather(b, 0, first[None])[0]
                      for b in (b0, b1, b2))
        v0, v1, v2 = i0[first], i1[first], i2[first]
        lum = b0 * bright[v0] + b1 * bright[v1] + b2 * bright[v2]
        rgb = (b0[..., None] * base_rgb[v0] + b1[..., None] * base_rgb[v1]
               + b2[..., None] * base_rgb[v2]) * lum[..., None]
        rgb_u = torch.clamp(rgb, 0.0, 255.0).to(torch.int32)
        argb = (OPAQUE_I32 | (rgb_u[..., 0] << 16) | (rgb_u[..., 1] << 8)
                | rgb_u[..., 2])
        color = torch.where(win, argb, color)
        depth = torch.where(win, zw, depth)
    return color, depth


def mesh_quads_to_triangles(n_quads: int) -> np.ndarray:
    """Index pattern of the reference's quad -> two-triangle fan split
    (rasterizer.rs:1056-1068: (0,1,2), (0,2,3) per 4-vertex quad)."""
    q = np.arange(n_quads)[:, None] * 4
    tri = np.concatenate([
        q + np.array([[0, 1, 2]]),
        q + np.array([[0, 2, 3]]),
    ], axis=1).reshape(-1, 3)
    return tri.astype(np.int32)
