"""Stage A and the raster of a quad stream, in plain PyTorch, with no
binning, no capacities and no tiles.

The rule is that of the port's frozen oracle ``render_exact``
(rendering/oracle.py at commit 1521963), evaluated for every pair of a
visible quad and a pixel of its box at once instead of quad by quad:

- stage A: a quad is drawn when it faces the camera (plane side), its NDC
  box meets the frustum (a corner at w <= NEAR_W_EPS keeps it, with the
  whole screen as its box), and it is not sub-pixel (both fan triangles'
  doubled screen areas, in float32, under MIN_TRIANGLE_AREA);
- coverage: with M the 3x3 map from (u, v, 1) on the quad's plane to clip
  (x, y, w) and A its adjugate, q = sign(det M) * A @ (nx, ny, 1) at the
  pixel centre; covered where q_w > 0 and u0 <= q_u / q_w <= u1, v0 <=
  q_v / q_w <= v1 (as products, not quotients);
- depth: NDC z, planar in (nx, ny); colour: the two-tone texel of
  (q_u / q_w, q_v / q_w) at 8 texels a block, face-shaded;
- the winner of a pixel is the lexicographic least (depth, colour as a
  signed 32-bit word), which makes the frame independent of stream order.

``dtype`` is the precision of every step after the quads' integer
fields: float64 for the reference, bfloat16 for the control.  Only the
rows ``rows`` of the frame are evaluated (a sample of rows drawn from the
seed)."""

from __future__ import annotations

import torch

from .constants import MIN_TRIANGLE_AREA, NEAR_W_EPS, SKY_COLOR

# the pairs of one block of quads: bounds the memory of the evaluation
PAIRS_PER_BLOCK = 1 << 23
_T_AX = (1, 1, 0, 0, 0, 0)   # axis of the tangent (u) per face
_B_AX = (2, 2, 2, 2, 1, 1)   # axis of the bitangent (v)
_N_AX = (0, 0, 1, 1, 2, 2)   # axis of the normal
_POSITIVE = (1, 0, 1, 0, 1, 0)


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def decode(words: torch.Tensor) -> dict[str, torch.Tensor]:
    """Fields of packed uint32 quads held in int64."""
    q = words.long() & 0xFFFFFFFF
    return dict(u=q & 0x1F, v=(q >> 5) & 0x1F, w=((q >> 10) & 0x3F) + 1,
                h=((q >> 16) & 0x3F) + 1, block=(q >> 22) & 0x3,
                slice=(q >> 24) & 0x1F, face=(q >> 29) & 0x7)


class Stream:
    """Stage A of a stream: quads (uint32 words in int64 [N]) of chunks at
    world origins ``origin`` float64 [N, 3]."""

    def __init__(self, words, origin, vp, cam_pos, width: int, height: int,
                 dtype=torch.float64):
        dev = words.device
        self.width, self.height, self.dtype = width, height, dtype
        f = decode(words)
        face = f["face"]
        tab = lambda t: torch.tensor(t, device=dev)[face]  # noqa: E731
        t_ax, b_ax, n_ax, pos = tab(_T_AX), tab(_B_AX), tab(_N_AX), tab(
            _POSITIVE)
        ap = f["slice"] + pos
        vp = torch.as_tensor(vp, device=dev).to(dtype)
        org = origin.to(dtype)
        ar = torch.arange(len(words), device=dev)
        # the corners (u0,v0) (u1,v0) (u1,v1) (u0,v1) in world space
        o = org.clone()
        o[ar, n_ax] += ap.to(dtype)
        u0, v0 = f["u"].to(dtype), f["v"].to(dtype)
        u1, v1 = (f["u"] + f["w"]).to(dtype), (f["v"] + f["h"]).to(dtype)
        eye = torch.eye(3, device=dev, dtype=dtype)
        tv, bv = eye[t_ax], eye[b_ax]
        corners = torch.stack([
            o + tv * uu[:, None] + bv * vv[:, None]
            for uu, vv in ((u0, v0), (u1, v0), (u1, v1), (u0, v1))], 1)
        hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
        clip = hom @ vp.T                                   # [N, 4, 4]
        w = clip[..., 3]
        any_behind = (w <= NEAR_W_EPS).any(1)
        safe_w = torch.where(w.abs() > 1e-300, w, torch.full_like(w, 1e-300))
        ndc = clip[..., :3] / safe_w[..., None]
        ok = (w > NEAR_W_EPS)[..., None]
        inf = torch.tensor(float("inf"), device=dev, dtype=dtype)
        nmin = torch.where(ok, ndc, inf).amin(1)
        nmax = torch.where(ok, ndc, -inf).amax(1)
        depth_near = torch.where(any_behind, torch.zeros_like(nmin[:, 2]),
                                 nmin[:, 2])
        in_frustum = ((nmax[:, 0] >= -1) & (nmin[:, 0] <= 1)
                      & (nmax[:, 1] >= -1) & (nmin[:, 1] <= 1)
                      & (depth_near >= 0) & (depth_near <= 1)) | any_behind
        plane = org[ar, n_ax] + ap.to(dtype)
        d = torch.as_tensor(cam_pos, device=dev).to(dtype)[n_ax] - plane
        front = torch.where(pos.bool(), d > 0, d < 0)
        # the sub-pixel cull, its screen corners in float32 (below it in
        # the control's precision)
        sdt = torch.float32 if dtype == torch.float64 else dtype
        sx = ((ndc[..., 0] + 1.0) * 0.5 * width).to(sdt)
        sy = ((1.0 - ndc[..., 1]) * 0.5 * height).to(sdt)

        def area2(i, j, k):
            return ((sx[:, k] - sx[:, i]) * (sy[:, j] - sy[:, i])
                    - (sy[:, k] - sy[:, i]) * (sx[:, j] - sx[:, i]))

        thr = torch.tensor(MIN_TRIANGLE_AREA, dtype=sdt, device=dev)
        tiny = ((area2(0, 1, 2).abs() < thr) & (area2(0, 2, 3).abs() < thr)
                & ~any_behind)
        self.visible = front & in_frustum & ~tiny
        # the pixel box, the whole screen for a quad behind the near plane
        big = float(4 * max(width, height))
        sx0 = ((nmin[:, 0] + 1) * 0.5 * width).clamp(-big, big)
        sx1 = ((nmax[:, 0] + 1) * 0.5 * width).clamp(-big, big)
        sy0 = ((1 - nmax[:, 1]) * 0.5 * height).clamp(-big, big)
        sy1 = ((1 - nmin[:, 1]) * 0.5 * height).clamp(-big, big)
        x0 = torch.floor(sx0).long().clamp(min=0)
        x1 = torch.ceil(sx1).long().clamp(max=width - 1)
        y0 = torch.floor(sy0).long().clamp(min=0)
        y1 = torch.ceil(sy1).long().clamp(max=height - 1)
        zero, wm, hm = torch.zeros_like(x0), width - 1, height - 1
        self.x0 = torch.where(any_behind, zero, x0)
        self.x1 = torch.where(any_behind, zero + wm, x1)
        self.y0 = torch.where(any_behind, zero, y0)
        self.y1 = torch.where(any_behind, zero + hm, y1)
        # M: (u, v, 1) -> clip (x, y, w); its adjugate and determinant
        t_col = vp[:, t_ax].T                                # [N, 4]
        b_col = vp[:, b_ax].T
        o_col = torch.cat([o, torch.ones_like(o[:, :1])], 1) @ vp.T
        m = torch.stack([torch.stack([t_col[:, r], b_col[:, r], o_col[:, r]],
                                     1) for r in (0, 1, 3)], 1)  # [N, 3, 3]
        a = _adjugate(m)
        det = (m[:, 0, :] * a[:, :, 0]).sum(1)
        sigma = torch.sign(det)
        self.visible &= det != 0
        self.q_rows = a * sigma[:, None, None]               # [N, 3, 3]
        zc = torch.stack([t_col[:, 2], b_col[:, 2], o_col[:, 2]], 1)
        safe_det = torch.where(det != 0, det, torch.ones_like(det))
        self.z_row = (zc[:, :, None] * a).sum(1) / safe_det[:, None]
        self.bounds = torch.stack([u0, u1, v0, v1], 1)
        self.face, self.block = face, f["block"]

    @property
    def n_visible(self) -> int:
        return int(self.visible.sum())


def _adjugate(m: torch.Tensor) -> torch.Tensor:
    """adj(M) of [N, 3, 3] matrices, adj(M) @ M = det(M) I."""
    c = lambda i, j: m[:, i, j]  # noqa: E731
    rows = [
        [c(1, 1) * c(2, 2) - c(1, 2) * c(2, 1),
         c(0, 2) * c(2, 1) - c(0, 1) * c(2, 2),
         c(0, 1) * c(1, 2) - c(0, 2) * c(1, 1)],
        [c(1, 2) * c(2, 0) - c(1, 0) * c(2, 2),
         c(0, 0) * c(2, 2) - c(0, 2) * c(2, 0),
         c(0, 2) * c(1, 0) - c(0, 0) * c(1, 2)],
        [c(1, 0) * c(2, 1) - c(1, 1) * c(2, 0),
         c(0, 1) * c(2, 0) - c(0, 0) * c(2, 1),
         c(0, 0) * c(1, 1) - c(0, 1) * c(1, 0)],
    ]
    return torch.stack([torch.stack(r, 1) for r in rows], 1)


def rasterize(s: Stream, tables: dict, rows_first: int, rows_step: int):
    """(colour int32 [R, W], depth float64 [R, W]) of the rows
    ``rows_first + k * rows_step`` of the frame: SKY_COLOR and +inf where
    no quad covers a pixel."""
    dev = s.x0.device
    width, height = s.width, s.height
    n_rows = len(range(rows_first, height, rows_step))
    idx = torch.nonzero(s.visible).flatten()
    # the sampled rows inside each quad's box
    r0 = torch.div(s.y0[idx] - rows_first + rows_step - 1, rows_step,
                   rounding_mode="floor").clamp(min=0)
    r1 = torch.div(s.y1[idx] - rows_first, rows_step, rounding_mode="floor")
    nr = (r1 - r0 + 1).clamp(min=0)
    nc = (s.x1[idx] - s.x0[idx] + 1).clamp(min=0)
    npairs = nr * nc
    keep = npairs > 0
    idx, r0, nc, npairs = idx[keep], r0[keep], nc[keep], npairs[keep]
    even = torch.as_tensor(tables["color_even"].astype("int64"), device=dev)
    odd = torch.as_tensor(tables["color_odd"].astype("int64"), device=dev)
    bits = (torch.as_tensor(tables["mask_lo"].astype("int64"), device=dev)
            | (torch.as_tensor(tables["mask_hi"].astype("int64"),
                               device=dev) << 32))
    even = torch.where(even >= 1 << 31, even - (1 << 32), even)
    odd = torch.where(odd >= 1 << 31, odd - (1 << 32), odd)
    pix_all, z_all, c_all = [], [], []
    ends = torch.cumsum(npairs, 0).tolist()
    start, lo = 0, 0
    while lo < len(idx):
        hi = lo
        while hi < len(idx) and ends[hi] - start <= PAIRS_PER_BLOCK:
            hi += 1
        hi = max(hi, lo + 1)
        got = _block(s, idx[lo:hi], r0[lo:hi], nc[lo:hi], npairs[lo:hi],
                     rows_first, rows_step, even, odd, bits)
        if got is not None:
            pix_all.append(got[0])
            z_all.append(got[1])
            c_all.append(got[2])
        start, lo = ends[hi - 1], hi
    n_pix = n_rows * width
    depth = torch.full((n_pix,), float("inf"), dtype=torch.float64,
                       device=dev)
    color = torch.full((n_pix,), 1 << 40, dtype=torch.int64, device=dev)
    if pix_all:
        pix, z, c = torch.cat(pix_all), torch.cat(z_all), torch.cat(c_all)
        depth.scatter_reduce_(0, pix, z, "amin")
        win = z == depth[pix]
        color.scatter_reduce_(0, pix[win], c[win], "amin")
    color = torch.where(color == 1 << 40,
                        torch.full_like(color, _i32(SKY_COLOR)), color)
    return (color.to(torch.int32).view(n_rows, width),
            depth.view(n_rows, width))


def _block(s: Stream, idx, r0, nc, npairs, rows_first, rows_step, even, odd,
           bits):
    """(pixel, depth, colour) of the covered pairs of the quads ``idx``."""
    dev, dt = idx.device, s.dtype
    width, height = s.width, s.height
    total = int(npairs.sum())
    if total == 0:
        return None
    quad = torch.repeat_interleave(torch.arange(len(idx), device=dev),
                                   npairs)
    first = torch.cumsum(npairs, 0) - npairs
    k = torch.arange(total, device=dev) - first[quad]
    row = r0[quad] + torch.div(k, nc[quad], rounding_mode="floor")
    x = s.x0[idx][quad] + k % nc[quad]
    y = rows_first + row * rows_step
    g = idx[quad]
    nx = ((2.0 * (x.to(torch.float64) + 0.5) - width) / width).to(dt)
    ny = (1.0 - 2.0 * (y.to(torch.float64) + 0.5) / height).to(dt)
    qr = s.q_rows[g]
    qu = qr[:, 0, 0] * nx + qr[:, 0, 1] * ny + qr[:, 0, 2]
    qv = qr[:, 1, 0] * nx + qr[:, 1, 1] * ny + qr[:, 1, 2]
    qw = qr[:, 2, 0] * nx + qr[:, 2, 1] * ny + qr[:, 2, 2]
    b = s.bounds[g]
    cover = ((qw > 0) & (qu >= b[:, 0] * qw) & (qu <= b[:, 1] * qw)
             & (qv >= b[:, 2] * qw) & (qv <= b[:, 3] * qw))
    sel = torch.nonzero(cover).flatten()
    if not len(sel):
        return None
    g, qu, qv, qw = g[sel], qu[sel], qv[sel], qw[sel]
    nx, ny, x, row = nx[sel], ny[sel], x[sel], row[sel]
    zr = s.z_row[g]
    z = (zr[:, 0] * nx + zr[:, 1] * ny + zr[:, 2]).to(torch.float64)
    tu = torch.trunc((qu / qw).to(torch.float64) * 8.0).long() & 7
    tv = torch.trunc((qv / qw).to(torch.float64) * 8.0).long() & 7
    face, block = s.face[g], s.block[g]
    bit = (bits[block] >> (tv * 8 + tu)) & 1
    col = torch.where(bit != 0, odd[face, block], even[face, block])
    return row * width + x, z, col
