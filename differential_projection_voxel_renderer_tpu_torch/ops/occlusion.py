"""Coarse chunk-level occlusion culling.

Reference: src/rendering/occlusion.rs (128x72-cell min-depth grid) driven by
main.rs render_frame pass 2 (:500-526): iterate projected chunk rects
front-to-back; a chunk is culled iff EVERY overlapped cell already holds a
strictly nearer depth (epsilon 0.005); survivors paint their rect's near
depth into the grid.

The pass is order-dependent (painted rects occlude later chunks), so it
runs on the host over the ~250 visible chunks, with a C++ fast path
(native occlusion_pass) and this numpy/Python implementation as both the
fallback and the unit-testable reference.  Off by default, exactly like the
reference's 'O' toggle (main.rs:112).
"""

from __future__ import annotations

import numpy as np

from ..meshing import native_bridge
from ..utils.config import OCCLUSION_EPSILON, OCCLUSION_GRID_H, OCCLUSION_GRID_W


class OcclusionBuffer:
    """API-parity port of occlusion.rs:6-155."""

    def __init__(self, screen_width: int, screen_height: int,
                 grid_width: int = OCCLUSION_GRID_W,
                 grid_height: int = OCCLUSION_GRID_H):
        self.screen_width = int(screen_width)
        self.screen_height = int(screen_height)
        self.grid_width = int(grid_width)
        self.grid_height = int(grid_height)
        self.cells = np.full((self.grid_height, self.grid_width), np.inf,
                             np.float32)
        self.epsilon = OCCLUSION_EPSILON

    def resize(self, screen_width: int, screen_height: int) -> None:
        self.screen_width = int(screen_width)
        self.screen_height = int(screen_height)
        self.clear()

    def clear(self) -> None:
        self.cells.fill(np.inf)

    def _cell_range(self, min_x, min_y, max_x, max_y):
        """Clamp a pixel rect and return the inclusive cell rect, or None
        (occlusion.rs:72-88)."""
        sw, sh = self.screen_width, self.screen_height
        if sw == 0 or sh == 0:
            return None
        if max_x < 0 or max_y < 0 or min_x >= sw or min_y >= sh:
            return None
        min_x = max(min_x, 0)
        min_y = max(min_y, 0)
        max_x = min(max_x, sw - 1)
        max_y = min(max_y, sh - 1)
        if min_x > max_x or min_y > max_y:
            return None
        cx0 = min_x * self.grid_width // sw
        cx1 = max_x * self.grid_width // sw
        cy0 = min_y * self.grid_height // sh
        cy1 = max_y * self.grid_height // sh
        return cx0, cy0, cx1, cy1

    def update(self, x: int, y: int, depth: float) -> None:
        """Min-depth paint of one pixel (occlusion.rs:42-55)."""
        if x >= self.screen_width or y >= self.screen_height:
            return
        cx = x * self.grid_width // self.screen_width
        cy = y * self.grid_height // self.screen_height
        if depth < self.cells[cy, cx]:
            self.cells[cy, cx] = depth

    def mark_rect(self, min_x, min_y, max_x, max_y, depth) -> None:
        """occlusion.rs:60-99 — min-depth paint of a rect."""
        r = self._cell_range(min_x, min_y, max_x, max_y)
        if r is None:
            return
        cx0, cy0, cx1, cy1 = r
        region = self.cells[cy0 : cy1 + 1, cx0 : cx1 + 1]
        np.minimum(region, np.float32(depth), out=region)

    def is_occluded(self, min_x, min_y, max_x, max_y, near_depth) -> bool:
        """occlusion.rs:105-154 — every overlapped cell must be strictly
        nearer by epsilon."""
        r = self._cell_range(min_x, min_y, max_x, max_y)
        if r is None:
            return False
        cx0, cy0, cx1, cy1 = r
        region = self.cells[cy0 : cy1 + 1, cx0 : cx1 + 1]
        return bool((region < near_depth - self.epsilon).all())


def occlusion_pass(
    rects: np.ndarray,    # i32[n, 4] inclusive pixel rects, front-to-back
    depths: np.ndarray,   # f32[n] near depth per rect
    use_occ: np.ndarray,  # bool[n] — participates in the occlusion query
                          # (main.rs:474-478: only beyond 2 chunks distance)
    screen_w: int,
    screen_h: int,
    *,
    grid_w: int = OCCLUSION_GRID_W,
    grid_h: int = OCCLUSION_GRID_H,
    epsilon: float = OCCLUSION_EPSILON,
    use_native: bool = True,
) -> np.ndarray:
    """The reference's render_frame pass 2 (main.rs:500-526) as a function.
    Returns keep mask bool[n].

    NOTE (faithful-semantics finding): with the reference's epsilon of 0.005
    in NDC depth (occlusion.rs:138) and the near=0.1/far=1000 projection,
    depth differences beyond ~20 world units are < 0.002, so the pass culls
    essentially nothing past its own 2-chunk minimum distance — consistent
    with the toggle defaulting OFF (main.rs:112).  ``epsilon`` is exposed so
    a deployment can pick a working threshold (e.g. 1e-4).
    """
    n = len(rects)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if use_native:
        keep = native_bridge.occlusion_pass_native(
            rects, depths, np.asarray(use_occ, np.uint8), screen_w, screen_h,
            grid_w, grid_h, epsilon,
        )
        if keep is not None:
            return keep.astype(bool)

    buf = OcclusionBuffer(screen_w, screen_h, grid_w, grid_h)
    buf.epsilon = epsilon
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        x0, y0, x1, y1 = (int(v) for v in rects[i])
        d = float(depths[i])
        if use_occ[i] and buf.is_occluded(x0, y0, x1, y1, d):
            keep[i] = False
            continue
        buf.mark_rect(x0, y0, x1, y1, d)
    return keep


def project_chunk_rects(centers: np.ndarray, view_proj: np.ndarray,
                        width: int, height: int):
    """Vectorized chunk AABB -> conservative screen rect + near depth
    (the reference's projection pass, main.rs:404-490).

    Returns (rects i32[n, 4], near_depth f32[n], offscreen bool[n]).
    Chunks with any corner behind the near plane get the full screen and
    depth 0 (main.rs:453-458)."""
    centers = np.asarray(centers, np.float32)
    n = centers.shape[0]
    half = np.float32(16.0)
    offs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    ) * half  # [8, 3]
    corners = centers[:, None, :] + offs[None, :, :]  # [n, 8, 3]
    hom = np.concatenate([corners, np.ones((n, 8, 1), np.float32)], axis=-1)
    clip = hom @ np.asarray(view_proj, np.float32).T  # [n, 8, 4]
    w = clip[..., 3]
    behind = (w <= 0.001).any(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc = clip[..., :3] / np.where(np.abs(w[..., None]) > 1e-30,
                                       w[..., None], 1e-30)
    ok = w > 0.001
    sx = (ndc[..., 0] + 1) * 0.5 * width
    sy = (1 - ndc[..., 1]) * 0.5 * height
    big = np.float32(1e30)
    x0 = np.floor(np.where(ok, sx, big).min(axis=1))
    x1 = np.ceil(np.where(ok, sx, -big).max(axis=1))
    y0 = np.floor(np.where(ok, sy, big).min(axis=1))
    y1 = np.ceil(np.where(ok, sy, -big).max(axis=1))
    near = np.where(ok, ndc[..., 2], big).min(axis=1)

    offscreen = (~behind) & (
        np.isinf(near) | (near > 1.0)
        | (np.maximum(x0, 0) > np.minimum(x1, width - 1))
        | (np.maximum(y0, 0) > np.minimum(y1, height - 1))
    )
    rects = np.stack(
        [
            np.where(behind, 0, np.clip(x0, 0, width - 1)),
            np.where(behind, 0, np.clip(y0, 0, height - 1)),
            np.where(behind, width - 1, np.clip(x1, 0, width - 1)),
            np.where(behind, height - 1, np.clip(y1, 0, height - 1)),
        ],
        axis=1,
    ).astype(np.int32)
    near_depth = np.where(behind, 0.0, near).astype(np.float32)
    return rects, near_depth, offscreen
