# Frozen copy of differential_projection_voxel_renderer_tpu_torch/ops/texture.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Micro-textures and the procedural atlas.

Replicates the reference's 8x8, 4bpp paletted micro-textures and procedural
atlas bit-for-bit (src/rendering/texture.rs):

- RGB565 -> ARGB32 palette expansion with bit replication (texture.rs:42-53)
- checkerboard + LCG-noise texture synthesis (texture.rs:81-123,
  LCG: seed = seed * 1103515245 + 12345, index byte = seed >> 16)
- nibble-packed indices: high nibble = even x, low nibble = odd x
  (texture.rs:10-12, sample at :19-38)

TPU-first twist: the default atlas's palettes alternate between exactly two
colors (``palette[i] = base if i % 2 == 0 else dark``, texture.rs:103-110),
so a texel's color is decided by the *parity bit* of its 4-bit palette
index.  We precompute a 64-bit parity mask per texture; per-pixel sampling
in the rasterizer kernel is then two vector shifts and a select instead of a
gather — the VPU equivalent of the reference's "zero-cost sampling" claim.
A general gather-based ``sample()`` is kept for API parity and custom
palettes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def rgb565_to_argb32(c: int) -> int:
    """texture.rs:42-53."""
    r = (c >> 11) & 0x1F
    g = (c >> 5) & 0x3F
    b = c & 0x1F
    r8 = (r << 3) | (r >> 2)
    g8 = (g << 2) | (g >> 4)
    b8 = (b << 3) | (b >> 2)
    return 0xFF000000 | (r8 << 16) | (g8 << 8) | b8


@dataclass
class MicroTexture:
    """8x8 4bpp paletted texture (texture.rs:3-13)."""

    palette: np.ndarray  # uint32[16]
    indices: np.ndarray  # uint8[32], 2 pixels/byte: high nibble = even x

    def palette_index(self, u: int, v: int) -> int:
        x = u & 7
        y = v & 7
        pixel_idx = (y << 3) | x
        byte = int(self.indices[pixel_idx >> 1])
        return (byte >> 4) & 0xF if (pixel_idx & 1) == 0 else byte & 0xF

    def sample(self, u: int, v: int) -> int:
        """texture.rs:19-38 — wraps to 0..7 and samples the palette."""
        return int(self.palette[self.palette_index(u, v)])

    def index_grid(self) -> np.ndarray:
        """uint8[8, 8] palette indices (y, x)."""
        out = np.zeros((8, 8), dtype=np.uint8)
        for y in range(8):
            for x in range(8):
                out[y, x] = self.palette_index(x, y)
        return out

    def parity_mask(self) -> tuple[int, int]:
        """(lo, hi) 32-bit halves of the 64-bit index-parity mask; bit
        ``y*8 + x`` is the palette index's low bit at (x, y)."""
        grid = self.index_grid() & 1
        bits = 0
        for y in range(8):
            for x in range(8):
                bits |= int(grid[y, x]) << (y * 8 + x)
        return bits & 0xFFFFFFFF, (bits >> 32) & 0xFFFFFFFF

    def two_tone(self) -> tuple[int, int] | None:
        """(even_color, odd_color) if the palette alternates two colors over
        the indices actually used; None for general palettes."""
        grid = self.index_grid()
        used = np.unique(grid)
        even = {int(self.palette[i]) for i in used if i % 2 == 0}
        odd = {int(self.palette[i]) for i in used if i % 2 == 1}
        if len(even) <= 1 and len(odd) <= 1:
            e = next(iter(even)) if even else 0
            o = next(iter(odd)) if odd else e
            return e, o
        return None


def create_checkerboard(c1: int, c2: int) -> MicroTexture:
    """texture.rs:81-101."""
    palette = np.zeros(16, dtype=np.uint32)
    palette[0] = rgb565_to_argb32(c1)
    palette[1] = rgb565_to_argb32(c2)
    indices = np.zeros(32, dtype=np.uint8)
    for i in range(64):
        x, y = i % 8, i // 8
        color_idx = (x + y) % 2
        if i % 2 == 0:
            indices[i // 2] |= color_idx << 4
        else:
            indices[i // 2] |= color_idx
    return MicroTexture(palette, indices)


def create_noise(base: int, dark: int) -> MicroTexture:
    """texture.rs:103-123 — LCG-noise indices, two-tone palette."""
    palette = np.zeros(16, dtype=np.uint32)
    for i in range(16):
        palette[i] = rgb565_to_argb32(base if i % 2 == 0 else dark)
    indices = np.zeros(32, dtype=np.uint8)
    seed = 12345
    for i in range(32):
        seed = (seed * 1103515245 + 12345) & 0xFFFFFFFF
        indices[i] = (seed >> 16) & 0xFF
    return MicroTexture(palette, indices)


class TextureAtlas:
    """Default procedural atlas (texture.rs:60-79): magenta debug
    checkerboard + grass/dirt/stone noise."""

    def __init__(self, textures: list[MicroTexture] | None = None):
        if textures is None:
            textures = [
                create_checkerboard(0xF81F, 0x0000),
                create_noise(0x03E0, 0x02E0),
                create_noise(0x8A22, 0x71C2),
                create_noise(0x8410, 0x73AE),
            ]
        self.textures = textures

    def kernel_tables(self) -> dict[str, np.ndarray]:
        """Per-block constants for the rasterizer kernel:

        - ``mask_lo/mask_hi``: int32[n] 64-bit parity masks
        - ``color_even/color_odd``: uint32[n] two-tone colors

        Non-two-tone palettes fall back to their two most common colors —
        the default atlas is always exactly two-tone so this is lossless
        there; general palettes get the dedicated gather sampler instead.
        """
        n = len(self.textures)
        mask_lo = np.zeros(n, dtype=np.uint32)
        mask_hi = np.zeros(n, dtype=np.uint32)
        ce = np.zeros(n, dtype=np.uint32)
        co = np.zeros(n, dtype=np.uint32)
        for i, t in enumerate(self.textures):
            lo, hi = t.parity_mask()
            mask_lo[i], mask_hi[i] = lo, hi
            tt = t.two_tone()
            if tt is None:
                # best-effort two-tone projection
                grid = t.index_grid()
                evens = [int(t.palette[g]) for g in grid.flatten() if g % 2 == 0]
                odds = [int(t.palette[g]) for g in grid.flatten() if g % 2 == 1]
                tt = (
                    max(set(evens), key=evens.count) if evens else 0,
                    max(set(odds), key=odds.count) if odds else 0,
                )
            ce[i], co[i] = tt
        return dict(mask_lo=mask_lo, mask_hi=mask_hi, color_even=ce, color_odd=co)
