"""Hierarchical Z: min- and max-depth pyramids, the exact per-quad cull
and the reference's HiZBuffer, in PyTorch.

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/hiz.py``
(reference: src/rendering/hiz_buffer.rs).  A pyramid level is one
reshape-reduce over non-overlapping 8x8 blocks, padded with +inf to a
block multiple.  Every min and max here propagates NaN as ``jnp.min``,
``jnp.max`` and ``jnp.maximum`` do (``torch.amin``, ``torch.amax`` and
``torch.maximum``; never ``torch.fmax``), so a NaN depth reaches the same
cells in both packages.  Morton codes are the same numpy bit spreads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import HIZ_BLOCK_SIZE


def _pad_to_blocks(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x`` [h, w] padded at the bottom and right to a multiple of the
    block size with ``value``."""
    b = HIZ_BLOCK_SIZE
    h, w = x.shape
    ph, pw = (-h) % b, (-w) % b
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=value)
    return x


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[h, w] (block multiples) -> [h/b, b, w/b, b]."""
    b = HIZ_BLOCK_SIZE
    hh, ww = x.shape
    return x.reshape(hh // b, b, ww // b, b)


def build_pyramid(depth: torch.Tensor):
    """depth f32[H, W] -> (level1 f32[ceil(H/8), ceil(W/8)], level2, the
    same pool of level 1): per-8x8-block minimum, +inf padding
    (conservative; hiz_buffer.rs level sizing :44-60)."""
    level1 = _blocks(_pad_to_blocks(depth, float("inf"))).amin(dim=(1, 3))
    level2 = _blocks(_pad_to_blocks(level1, float("inf"))).amin(dim=(1, 3))
    return level1, level2


def build_max_pyramid(depth: torch.Tensor) -> torch.Tensor:
    """depth f32[H, W] -> per-8x8-block MAX depth f32[ceil(H/8),
    ceil(W/8)], +inf padding: the exact cull's pyramid.  A quad whose near
    depth exceeds the farthest rendered pixel of every block under its
    rect can never win a blend (undrawn pixels hold +inf and forbid the
    cull)."""
    return _blocks(_pad_to_blocks(depth, float("inf"))).amax(dim=(1, 3))


def _dilate2(level: torch.Tensor) -> torch.Tensor:
    """dil[y, x] = max over blocks [y..y+1, x..x+1], -inf past the edges."""
    ninf = float("-inf")
    right = F.pad(level[:, 1:], (0, 1, 0, 0), value=ninf)
    down = F.pad(level[1:, :], (0, 0, 0, 1), value=ninf)
    dr = F.pad(level[1:, 1:], (0, 1, 0, 1), value=ninf)
    return torch.maximum(torch.maximum(level, right),
                         torch.maximum(down, dr))


def quads_occluded_exact(level1_max: torch.Tensor, bbx: torch.Tensor,
                         bby: torch.Tensor, depth_near: torch.Tensor, *,
                         height: int, width: int) -> torch.Tensor:
    """Exact-conservative per-quad occlusion against a rendered-depth max
    pyramid (``build_max_pyramid``): True only where a quad PROVABLY cannot
    affect the frame.  ``bbx``/``bby`` are stage A's packed inclusive
    pixel boxes (x0 | x1 << 16, y0 | y1 << 16), ``depth_near`` its nearest
    NDC depth; returns bool[N].

    As the reference does: a quad whose block range fits 2x2 at level 1
    (8-pixel blocks) or at level 2 (the max pool of level 1 padded with
    -inf, 64-pixel blocks) is tested against the dilated cell at its first
    block, one lookup in one flat table of both levels; larger quads are
    never culled."""
    b = HIZ_BLOCK_SIZE
    px0 = torch.clamp(bbx & 0xFFFF, 0, width - 1)
    px1 = torch.clamp(bbx >> 16, 0, width - 1)
    py0 = torch.clamp(bby & 0xFFFF, 0, height - 1)
    py1 = torch.clamp(bby >> 16, 0, height - 1)
    # -inf padding before the level-2 pool: the trailing level-1 blocks
    # stay covered (a VALID pool would drop them: an unsound cull) and the
    # padded entries never raise a max
    level2_max = _blocks(_pad_to_blocks(level1_max, float("-inf"))).amax(
        dim=(1, 3))

    def block_range(bs, shape):
        h1, w1 = shape
        x0 = torch.clamp(px0 // bs, 0, w1 - 1)
        x1 = torch.clamp(px1 // bs, 0, w1 - 1)
        y0 = torch.clamp(py0 // bs, 0, h1 - 1)
        y1 = torch.clamp(py1 // bs, 0, h1 - 1)
        fits = ((x1 - x0) <= 1) & ((y1 - y0) <= 1)
        return fits, y0 * w1 + x0

    h1, w1 = level1_max.shape
    fits1, i1 = block_range(b, (h1, w1))
    fits2, i2 = block_range(b * b, level2_max.shape)
    table = torch.cat([_dilate2(level1_max).reshape(-1),
                       _dilate2(level2_max).reshape(-1)])
    idx = torch.where(fits1, i1, h1 * w1 + i2)
    m = table[idx.long()]
    return (fits1 | fits2) & (depth_near > m)


def is_occluded_batch(level1: torch.Tensor, rects: torch.Tensor,
                      near_depth: torch.Tensor, *, height: int, width: int):
    """Conservative occlusion of N screen rects against the level-1
    min pyramid (hiz_buffer.rs:90-138): occluded iff the rect's near depth
    is beyond the minimum over its block range, taken over a fixed 16x16
    block window; larger rects are never occluded.  ``rects`` i32[N, 4]
    inclusive (x0, y0, x1, y1); returns bool[N]."""
    b = HIZ_BLOCK_SIZE
    bx0 = torch.clamp(rects[:, 0], 0, width - 1) // b
    by0 = torch.clamp(rects[:, 1], 0, height - 1) // b
    bx1 = torch.clamp(rects[:, 2], 0, width - 1) // b
    by1 = torch.clamp(rects[:, 3], 0, height - 1) // b
    max_span = 16
    too_big = ((bx1 - bx0) >= max_span) | ((by1 - by0) >= max_span)
    h1, w1 = level1.shape
    span = torch.arange(max_span, device=rects.device)
    yy = torch.clamp(torch.minimum(by0[:, None] + span[None, :],
                                   by1[:, None]), 0, h1 - 1).long()
    xx = torch.clamp(torch.minimum(bx0[:, None] + span[None, :],
                                   bx1[:, None]), 0, w1 - 1).long()
    vals = level1[yy[:, :, None], xx[:, None, :]]  # [N, S, S]
    return (near_depth > vals.amin(dim=(1, 2))) & ~too_big


class HiZBuffer:
    """The reference's stateful HiZBuffer (hiz_buffer.rs:25-204) over the
    pyramid ops; levels are numpy arrays for host-side callers."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        b = HIZ_BLOCK_SIZE
        self.blocks_x = (self.width + b - 1) // b
        self.blocks_y = (self.height + b - 1) // b
        self.level1 = np.full((self.blocks_y, self.blocks_x), np.inf,
                              np.float32)
        l2y = (self.blocks_y + 7) // 8
        l2x = (self.blocks_x + 7) // 8
        self.level2 = np.full((l2y, l2x), np.inf, np.float32)

    def clear(self) -> None:
        self.level1.fill(np.inf)
        self.level2.fill(np.inf)

    def resize(self, width: int, height: int) -> None:
        self.__init__(width, height)

    def from_depth(self, depth) -> None:
        """Rebuild both levels from a rendered depth buffer (a numpy array
        or a tensor on any device) with ``build_pyramid``."""
        l1, l2 = build_pyramid(torch.as_tensor(depth, dtype=torch.float32))
        self.level1 = l1.cpu().numpy().copy()
        self.level2 = l2.cpu().numpy().copy()

    def update_region(self, x0, y0, x1, y1, near_depth) -> None:
        """hiz_buffer.rs:143-183."""
        b = HIZ_BLOCK_SIZE
        x0 = max(int(x0), 0)
        y0 = max(int(y0), 0)
        x1 = min(int(x1), self.width - 1)
        y1 = min(int(y1), self.height - 1)
        if x0 > x1 or y0 > y1:
            return
        bx0, bx1 = x0 // b, min(x1 // b, self.blocks_x - 1)
        by0, by1 = y0 // b, min(y1 // b, self.blocks_y - 1)
        r1 = self.level1[by0: by1 + 1, bx0: bx1 + 1]
        np.minimum(r1, np.float32(near_depth), out=r1)
        r2 = self.level2[by0 // 8: by1 // 8 + 1, bx0 // 8: bx1 // 8 + 1]
        np.minimum(r2, np.float32(near_depth), out=r2)

    def is_occluded(self, x0, y0, x1, y1, near_depth) -> bool:
        """hiz_buffer.rs:90-138: quick level-2 reject then level-1 scan."""
        x0c = max(int(x0), 0)
        y0c = max(int(y0), 0)
        x1c = min(int(x1), self.width - 1)
        y1c = min(int(y1), self.height - 1)
        if x0c > x1c or y0c > y1c:
            return True  # off-screen
        b = HIZ_BLOCK_SIZE
        bx0, bx1 = x0c // b, min(x1c // b, self.blocks_x - 1)
        by0, by1 = y0c // b, min(y1c // b, self.blocks_y - 1)
        if near_depth > self.level2[by0 // 8, bx0 // 8]:
            return True
        region = self.level1[by0: by1 + 1, bx0: bx1 + 1]
        return bool(near_depth > region.min())


# ---------------------------------------------------------------- Morton


def morton_encode(x, y):
    """Interleave bits: morton = ...y1 x1 y0 x0 (hiz_buffer.rs:239-252),
    vectorized over uint32 inputs < 2^16."""
    x = np.asarray(x, np.uint32)
    y = np.asarray(y, np.uint32)

    def spread(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return spread(x) | (spread(y) << np.uint32(1))


def morton_decode(morton):
    """hiz_buffer.rs:283-298, vectorized: (x, y)."""
    m = np.asarray(morton, np.uint32)

    def compact(v):
        v = v & np.uint32(0x55555555)
        v = (v | (v >> 1)) & np.uint32(0x33333333)
        v = (v | (v >> 2)) & np.uint32(0x0F0F0F0F)
        v = (v | (v >> 4)) & np.uint32(0x00FF00FF)
        v = (v | (v >> 8)) & np.uint32(0x0000FFFF)
        return v

    return compact(m), compact(m >> np.uint32(1))
