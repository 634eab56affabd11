"""Differential projection, culling and rasterizer coefficients in PyTorch.

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/projection.py``
(exact mode only).  Every expression keeps the reference's operation order,
because the parity contract is full-frame equality and a reordered sum
rounds differently.  torch never fuses a multiply and an add across
separate operators, so ``(o + u * t) + v * b`` rounds each product and
each sum, on the CPU and on the card alike; reciprocals go through
``torch.reciprocal``, an IEEE quotient on both.

Quad words travel as int32 (``torch.uint32`` lacks shifts on CUDA);
``decode_quads`` masks every field after its shift, so the sign fill of the
arithmetic shift is harmless.
"""

from __future__ import annotations

import numpy as np
import torch

from differential_projection_voxel_renderer_tpu.utils.config import (
    MIN_TRIANGLE_AREA,
    NEAR_W_EPS,
)

# Per-face chunk-local axes (ops/projection.py of the reference package):
# faces 0..5 are +X,-X,+Y,-Y,+Z,-Z; the 3-bit face field can hold 6 and 7,
# which the reference's select chains map to face 5's entry.
FACE_T_AXIS = (1, 1, 0, 0, 0, 0)
FACE_B_AXIS = (2, 2, 2, 2, 1, 1)
FACE_N_AXIS = (0, 0, 1, 1, 2, 2)


def _axis_table(table, device) -> torch.Tensor:
    return torch.tensor(list(table) + [table[5], table[5]], dtype=torch.int32,
                        device=device)


def as_quad_words(quads) -> torch.Tensor:
    """uint32 numpy words (or an int32 tensor) -> int32 tensor, bits kept."""
    if isinstance(quads, torch.Tensor):
        if quads.dtype != torch.int32:
            raise ValueError(f"quad words must be int32, not {quads.dtype}")
        return quads
    return torch.from_numpy(np.ascontiguousarray(quads).view(np.int32))


def decode_quads(q: torch.Tensor) -> dict[str, torch.Tensor]:
    """Unpack int32 quad words (see meshing/quad_format.py)."""
    u = (q & 0x1F).float()
    v = ((q >> 5) & 0x1F).float()
    w = (((q >> 10) & 0x3F) + 1).float()
    h = (((q >> 16) & 0x3F) + 1).float()
    block = (q >> 22) & 0x3
    slice_idx = (q >> 24) & 0x1F
    face = (q >> 29) & 0x7
    is_pos = (face & 1) == 0
    axis_pos = torch.where(is_pos, slice_idx + 1, slice_idx).float()
    return dict(u0=u, v0=v, u1=u + w, v1=v + h, block=block, face=face,
                slice_idx=slice_idx, axis_pos=axis_pos, is_pos=is_pos)


def _select3(idx, v0, v1, v2):
    return torch.where(idx == 0, v0, torch.where(idx == 1, v1, v2))


class _Basis:
    """Per-quad clip-space basis: origin/tangent/bitangent, 4 rows each."""

    __slots__ = ("o", "t", "b")

    def __init__(self, dec, quad_world, vp: torch.Tensor):
        face = dec["face"].long()
        dev = face.device
        t_axis = _axis_table(FACE_T_AXIS, dev)[face]
        b_axis = _axis_table(FACE_B_AXIS, dev)[face]
        n_axis = _axis_table(FACE_N_AXIS, dev)[face]
        col = [[vp[r, a] for a in range(3)] for r in range(4)]
        self.t = tuple(_select3(t_axis, *col[r]) for r in range(4))
        self.b = tuple(_select3(b_axis, *col[r]) for r in range(4))
        n = tuple(_select3(n_axis, *col[r]) for r in range(4))
        ap = dec["axis_pos"]
        wx, wy, wz = quad_world
        self.o = tuple(
            vp[r, 0] * wx + vp[r, 1] * wy + vp[r, 2] * wz + vp[r, 3]
            + ap * n[r]
            for r in range(4)
        )

    def corner(self, u, v, r):
        return self.o[r] + u * self.t[r] + v * self.b[r]


def stage_a_fields(dec, quad_world, in_stream, vp, cam, *, width: int,
                   height: int, backface_culling: bool = True):
    """Stage A on decoded quads: project the 4 corners, backface + frustum +
    sub-pixel cull, integer screen bbox.  The plain twin of kernel K1
    (csrc/geometry.cu); see the reference's ``stage_a_fields``."""
    face = dec["face"]
    dev = face.device
    vp = vp.to(torch.float32)
    basis = _Basis(dec, quad_world, vp)
    u0, u1, v0, v1 = dec["u0"], dec["u1"], dec["v0"], dec["v1"]

    eps = NEAR_W_EPS
    big = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    corners_uv = ((u0, v0), (u1, v0), (u0, v1), (u1, v1))
    ws = [basis.corner(u, v, 3) for (u, v) in corners_uv]
    any_behind = (ws[0] <= eps) | (ws[1] <= eps) | (ws[2] <= eps) | (ws[3] <= eps)
    all_behind = (ws[0] <= eps) & (ws[1] <= eps) & (ws[2] <= eps) & (ws[3] <= eps)
    invs = [torch.reciprocal(torch.where(w.abs() > 1e-30, w, 1e-30))
            for w in ws]
    oks = [w > eps for w in ws]

    def corner_ndc(r):
        return [basis.corner(u, v, r) * inv
                for (u, v), inv in zip(corners_uv, invs)]

    def minmax(ns):
        lo, hi = big, -big
        for n, ok in zip(ns, oks):
            lo = torch.minimum(lo, torch.where(ok, n, big))
            hi = torch.maximum(hi, torch.where(ok, n, -big))
        return lo, hi

    nxs = corner_ndc(0)
    nys = corner_ndc(1)
    nx_min, nx_max = minmax(nxs)
    ny_min, ny_max = minmax(nys)
    nz_min, _ = minmax(corner_ndc(2))
    depth_near = torch.where(any_behind, 0.0, nz_min)

    in_frustum = ((nx_max >= -1.0) & (nx_min <= 1.0)
                  & (ny_max >= -1.0) & (ny_min <= 1.0)
                  & (depth_near >= 0.0) & (depth_near <= 1.0))
    in_frustum = (in_frustum | any_behind) & ~all_behind

    if backface_culling:
        n_axis = _axis_table(FACE_N_AXIS, dev)[face.long()]
        plane = _select3(n_axis, *quad_world) + dec["axis_pos"]
        d = _select3(n_axis, cam[0], cam[1], cam[2]) - plane
        is_pos = dec["is_pos"]
        front = (is_pos & (d > 0.0)) | (~is_pos & (d < 0.0))
    else:
        front = torch.ones_like(any_behind)

    valid = in_stream & front & in_frustum
    wf, hf = float(width), float(height)

    # sub-pixel cull: fan split (0,1,3),(0,3,2) of the corner order
    # c00, c10, c01, c11; both doubled areas below MIN_TRIANGLE_AREA
    sxs = [(n + 1.0) * 0.5 * wf for n in nxs]
    sys_ = [(1.0 - n) * 0.5 * hf for n in nys]

    def area2(i, j, k):
        return ((sxs[k] - sxs[i]) * (sys_[j] - sys_[i])
                - (sys_[k] - sys_[i]) * (sxs[j] - sxs[i]))

    thr = np.float32(MIN_TRIANGLE_AREA).item()
    tiny = ((area2(0, 1, 3).abs() < thr) & (area2(0, 3, 2).abs() < thr)
            & ~any_behind)
    subpixel = valid & tiny
    valid = valid & ~tiny

    sx0 = (nx_min + 1.0) * 0.5 * wf
    sx1 = (nx_max + 1.0) * 0.5 * wf
    sy0 = (1.0 - ny_max) * 0.5 * hf
    sy1 = (1.0 - ny_min) * 0.5 * hf

    def bound(x, hi_px, behind_value):
        px = torch.clamp(x, 0, hi_px).to(torch.int32)
        return torch.where(any_behind, behind_value, px)

    return dict(
        valid=valid, subpixel=subpixel, depth_near=depth_near,
        any_behind=any_behind,
        bb_x0=bound(torch.floor(sx0), width - 1, 0),
        bb_x1=bound(torch.ceil(sx1), width - 1, width - 1),
        bb_y0=bound(torch.floor(sy0), height - 1, 0),
        bb_y1=bound(torch.ceil(sy1), height - 1, height - 1),
    )


def project_and_cull(quads, quad_world, in_stream, view_proj, cam_pos, *,
                     width: int, height: int, backface_culling: bool = True):
    """Stage A on raw int32 quad words (reference ``project_and_cull``)."""
    return stage_a_fields(decode_quads(quads), quad_world, in_stream,
                          view_proj, cam_pos, width=width, height=height,
                          backface_culling=backface_culling)


def color_table_tensors(color_tables: dict, device) -> dict[str, torch.Tensor]:
    """Shading tables (ops/shading.build_quad_color_tables) as device
    lookup tables indexed by ``face * 4 + block`` (colors) and ``block``
    (masks).  Block 0 and faces 6/7 map to 0, as the reference's select
    chains leave them."""
    ce = np.zeros((8, 4), np.int32)
    co = np.zeros((8, 4), np.int32)
    ce[:6, 1:] = np.asarray(color_tables["color_even"]).view(np.int32)[:, 1:4]
    co[:6, 1:] = np.asarray(color_tables["color_odd"]).view(np.int32)[:, 1:4]
    ml = np.zeros(4, np.int32)
    mh = np.zeros(4, np.int32)
    ml[1:] = np.asarray(color_tables["mask_lo"]).view(np.int32)[1:4]
    mh[1:] = np.asarray(color_tables["mask_hi"]).view(np.int32)[1:4]
    return {k: torch.from_numpy(v.reshape(-1)).to(device)
            for k, v in (("color_even", ce), ("color_odd", co),
                         ("mask_lo", ml), ("mask_hi", mh))}


def quad_coefficients(quads, quad_world, view_proj, color_tables):
    """Stage B (exact mode): sign-fixed adjugate rows a00..a22, planar depth
    z0..z2, coverage bounds u0/u1/v0/v1 and the two-tone texel colours.
    ``color_tables`` comes from :func:`color_table_tensors`."""
    dec = decode_quads(quads)
    vp = view_proj.to(torch.float32)
    basis = _Basis(dec, quad_world, vp)
    m00, m01, m02 = basis.t[0], basis.b[0], basis.o[0]
    m10, m11, m12 = basis.t[1], basis.b[1], basis.o[1]
    m20, m21, m22 = basis.t[3], basis.b[3], basis.o[3]
    a00 = m11 * m22 - m12 * m21
    a01 = -(m01 * m22 - m02 * m21)
    a02 = m01 * m12 - m02 * m11
    a10 = -(m10 * m22 - m12 * m20)
    a11 = m00 * m22 - m02 * m20
    a12 = -(m00 * m12 - m02 * m10)
    a20 = m10 * m21 - m11 * m20
    a21 = -(m00 * m21 - m01 * m20)
    a22 = m00 * m11 - m01 * m10
    det = m00 * a00 + m01 * a10 + m02 * a20
    sigma = torch.where(det > 0, 1.0, torch.where(det < 0, -1.0, 0.0))
    inv_det = torch.where(det != 0.0, torch.reciprocal(det), 0.0)
    tz, bz, oz = basis.t[2], basis.b[2], basis.o[2]
    z0 = (tz * a00 + bz * a10 + oz * a20) * inv_det
    z1 = (tz * a01 + bz * a11 + oz * a21) * inv_det
    z2 = (tz * a02 + bz * a12 + oz * a22) * inv_det
    fb = dec["face"].long() * 4 + dec["block"].long()
    block = dec["block"].long()
    return dict(
        a00=a00 * sigma, a01=a01 * sigma, a02=a02 * sigma,
        a10=a10 * sigma, a11=a11 * sigma, a12=a12 * sigma,
        a20=a20 * sigma, a21=a21 * sigma, a22=a22 * sigma,
        z0=z0, z1=z1, z2=z2,
        u0=dec["u0"], u1=dec["u1"], v0=dec["v0"], v1=dec["v1"],
        color_even=color_tables["color_even"][fb],
        color_odd=color_tables["color_odd"][fb],
        mask_lo=color_tables["mask_lo"][block],
        mask_hi=color_tables["mask_hi"][block],
    )


def pack_tilebox(bb_x0, bb_x1, bb_y0, bb_y1, *, tile_h: int, tile_w: int):
    """Screen bbox -> packed inclusive tile range
    (tx0 | tx1<<8 | ty0<<16 | ty1<<24) for the binner."""
    return ((bb_x0 // tile_w) | ((bb_x1 // tile_w) << 8)
            | ((bb_y0 // tile_h) << 16) | ((bb_y1 // tile_h) << 24))
