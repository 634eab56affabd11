"""Framebuffer: device-resident ARGB color + f32 depth.

Reference: src/rendering/framebuffer.rs — ARGB u32 color + f32 depth (init
infinity) with SIMD clears and depth-tested writes.  On TPU the buffers are
jnp arrays produced by the render step; "clear" is fused into the raster
kernel (ops/raster.py initializes tiles to sky/inf in VMEM — the AVX clear
loop, framebuffer.rs:224-313, has no standalone existence here because XLA
would fuse it anyway).  This class is the host-facing container: fetch,
inspect, save, and the stripe/tile views used by tests.

The reference's FrameSlice/FrameTile disjoint mutable views
(framebuffer.rs:16-195) exist to prove data-race freedom to the borrow
checker; a pure-functional pipeline has no aliasing to prove, so the
equivalents here are just row-band slices for assertions and the sharded
renderer's band partitioning (parallel/sharded_render.py).
"""

from __future__ import annotations

import numpy as np

from ..utils.config import SKY_COLOR


def rgb_to_u32(r: int, g: int, b: int) -> int:
    """framebuffer.rs:475 — pack RGB into ARGB32 with full alpha."""
    return 0xFF000000 | (int(r) << 16) | (int(g) << 8) | int(b)


def apply_ao(color, ao: int) -> int:
    """framebuffer.rs:481-496 — scale an [r, g, b] color by the AO level's
    factor (this function's convention: 0 = darkest 0.4 .. 3 = unoccluded
    1.0 — the OPPOSITE of shading.rs's vertex AO levels; both preserved).
    Never called by the reference's render paths (like here, the TinyQuad
    pipeline bakes light at mesh time); kept for API parity."""
    factor = (0.4, 0.6, 0.8, 1.0)[ao] if ao < 3 else 1.0
    r = int(int(color[0]) * factor)
    g = int(int(color[1]) * factor)
    b = int(int(color[2]) * factor)
    return 0xFF000000 | (min(r, 255) << 16) | (min(g, 255) << 8) | min(b, 255)


class Framebuffer:
    """Host-side framebuffer container with reference API parity."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.color = np.full((self.height, self.width), np.uint32(SKY_COLOR),
                             np.uint32)
        self.depth = np.full((self.height, self.width), np.inf, np.float32)

    @staticmethod
    def from_device(color, depth) -> "Framebuffer":
        """Wrap a rendered (color int32 bits, depth f32) pair: numpy
        arrays or torch tensors, on the card or the CPU."""
        c = np.asarray(color.cpu() if hasattr(color, "cpu") else color)
        fb = Framebuffer(c.shape[1], c.shape[0])
        fb.color = c.view(np.uint32) if c.dtype == np.int32 else c.astype(np.uint32)
        fb.depth = np.asarray(depth.cpu() if hasattr(depth, "cpu") else depth)
        return fb

    def clear(self, color: int = SKY_COLOR) -> None:
        """framebuffer.rs clear: color fill + depth to infinity."""
        self.color.fill(np.uint32(color))
        self.depth.fill(np.inf)

    def resize(self, width: int, height: int) -> None:
        self.__init__(width, height)

    def set_pixel(self, x: int, y: int, color: int, depth: float) -> bool:
        """Depth-tested write, strict less (framebuffer.rs:317-353)."""
        if not (0 <= x < self.width and 0 <= y < self.height):
            return False
        if depth < self.depth[y, x]:
            self.depth[y, x] = depth
            self.color[y, x] = np.uint32(color)
            return True
        return False

    def split_into_stripes(self, count: int):
        """Disjoint horizontal band views (framebuffer.rs:392-431); numpy
        slices are views, so writes land in the parent buffers."""
        stripe_h = (self.height + count - 1) // count
        out = []
        for i in range(count):
            y0 = i * stripe_h
            y1 = min(y0 + stripe_h, self.height)
            if y0 >= y1:
                break
            out.append(FrameView(self, 0, y0, self.width, y1 - y0))
        return out

    def split_into_tiles(self, tile: int = 128):
        """Disjoint rectangular tile views (framebuffer.rs:123-195,
        436-470 — the raw-pointer FrameTile, safe here because numpy views
        alias the parent without unsafe)."""
        out = []
        for y0 in range(0, self.height, tile):
            for x0 in range(0, self.width, tile):
                out.append(FrameView(
                    self, x0, y0,
                    min(tile, self.width - x0),
                    min(tile, self.height - y0)))
        return out

    def color_buffer_slice(self) -> np.ndarray:
        """Flat u32 view, the blit source (framebuffer.rs color_buffer_slice
        / main.rs:321)."""
        return self.color.reshape(-1)

    # ------------------------------------------------------------- output
    def to_rgb8(self) -> np.ndarray:
        """uint8[H, W, 3] RGB image."""
        c = self.color
        return np.stack(
            [(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], axis=-1
        ).astype(np.uint8)

    def save_ppm(self, path: str) -> None:
        """Write a binary PPM (no image libs needed) — the headless
        replacement for the softbuffer blit."""
        img = self.to_rgb8()
        with open(path, "wb") as f:
            f.write(f"P6\n{self.width} {self.height}\n255\n".encode())
            f.write(img.tobytes())


class FrameView:
    """A disjoint rectangular view implementing the reference's
    ``PixelTarget`` protocol (rasterizer.rs:53-68): width / full_height /
    rect / depth-tested write.  Backs both the stripe split (FrameSlice,
    rasterizer.rs:70-100) and the tile split (FrameTile)."""

    def __init__(self, fb: Framebuffer, x0: int, y0: int, w: int, h: int):
        self.parent = fb
        self.x0, self.y0, self.w, self.h = x0, y0, w, h
        self.color = fb.color[y0:y0 + h, x0:x0 + w]
        self.depth = fb.depth[y0:y0 + h, x0:x0 + w]

    @property
    def width(self) -> int:
        return self.parent.width

    @property
    def full_height(self) -> int:
        return self.parent.height

    def rect(self):
        """(x0, y0, x1, y1) EXCLUSIVE spatial limits — the stripe-gap fix
        convention (rasterizer.rs:1258-1262)."""
        return self.x0, self.y0, self.x0 + self.w, self.y0 + self.h

    def test_depth_and_write(self, x: int, y: int, color: int,
                             depth: float) -> bool:
        """Depth-tested write in FULL-FRAME coordinates, strict less
        (framebuffer.rs:317-353)."""
        lx, ly = x - self.x0, y - self.y0
        if not (0 <= lx < self.w and 0 <= ly < self.h):
            return False
        if depth < self.depth[ly, lx]:
            self.depth[ly, lx] = depth
            self.color[ly, lx] = np.uint32(color)
            return True
        return False


class CountingTarget(FrameView):
    """The reference's TestTarget stub (rasterizer.rs:107-163): a
    PixelTarget that counts depth-test attempts and passing writes."""

    def __init__(self, fb: Framebuffer):
        super().__init__(fb, 0, 0, fb.width, fb.height)
        self.attempts = 0
        self.writes = 0

    def test_depth_and_write(self, x, y, color, depth):
        self.attempts += 1
        ok = super().test_depth_and_write(x, y, color, depth)
        self.writes += int(ok)
        return ok
