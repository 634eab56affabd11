"""The macrotile renderer facade, in PyTorch.

Counterpart of ``differential_projection_voxel_renderer_tpu/rendering/
macrotile.py`` (reference: macrotile_renderer.rs).  The reference's
128x128 macrotile maps to a block of the port's 16x128 tiles, and its
Hi-Z consult (plumbed but never wired, macrotile_renderer.rs:68-70) is
``use_hiz=True``: the exact two-pass occlusion mode
(rendering/pipeline.py ``_two_pass_step``), whose frame equals the single
pass's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.raster import pick_tile
from ..utils.config import MACROTILE_SIZE, RenderConfig
from .pipeline import Renderer


@dataclass
class MacrotileRenderConfig:
    """macrotile_renderer.rs:26-40."""

    tile_size: int = MACROTILE_SIZE
    # exact two-pass Hi-Z occlusion; near_quads = the front-to-back prefix
    # of the first pass
    use_hiz: bool = False
    near_quads: int = 8192
    parallel: bool = True  # tiles are independent thread blocks


def macrotile_renderer(width: int = 1280, height: int = 768,
                       config: MacrotileRenderConfig | None = None, *,
                       device="cuda", **render_kwargs) -> Renderer:
    """A Renderer on ``device`` for a frame whose sides are multiples of
    the macrotile size, with the two-pass mode when ``config.use_hiz``;
    ``render_kwargs`` go to RenderConfig."""
    cfg = config or MacrotileRenderConfig()
    ts = cfg.tile_size
    if width % ts or height % ts:
        raise ValueError(f"framebuffer {width}x{height} must be a multiple "
                         f"of the macrotile size {ts}")
    th, tw = pick_tile(height, width)
    rc = RenderConfig(
        width=width, height=height, tile_h=th, tile_w=tw,
        two_pass_near_quads=(cfg.near_quads if cfg.use_hiz else 0),
        **render_kwargs)
    return Renderer(rc, device=device)
