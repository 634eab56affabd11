"""Headless demo: generate a terrain world, render one frame, save a PPM.

The port's counterpart of ``examples/render_demo.py``, with the same
arguments and ``--device`` (the card unless ``cpu`` is asked for).
``--span`` renders in span mode (``RenderConfig.span_mode``).

Usage:
    python -m differential_projection_voxel_renderer_tpu_torch.examples.render_demo \\
        [out.ppm] [--vd N] [--width W] [--height H] [--span] [--device D]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..app.engine import Engine
from ..models.world import WorldConfig
from ..rendering.framebuffer import Framebuffer
from ..utils.config import SKY_COLOR, RenderConfig


def main(argv=None) -> Framebuffer:
    """Render the reference start pose into ``out`` and return its
    Framebuffer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="frame.ppm")
    ap.add_argument("--vd", type=int, default=6)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--span", action="store_true",
                    help="span mode (flat colors, Hyper-Pipeline semantics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    eng = Engine(
        render_config=RenderConfig(width=args.width, height=args.height,
                                   span_mode=args.span),
        world_config=WorldConfig(view_distance=args.vd,
                                 max_chunks_per_frame=10**9),
        device=args.device)
    print(f"device: {eng.device}"
          + (f" ({torch.cuda.get_device_name(eng.device)})"
             if eng.device.type == "cuda" else ""))
    # reference start pose (main.rs:51)
    eng.camera.position = np.array([0.0, 10.0, 20.0], np.float32)
    eng.camera.look_at(np.array([0.0, 0.0, -60.0], np.float32))

    t0 = time.time()
    while eng.world.update(eng.camera.position):
        pass
    print(f"world: {eng.world.chunk_count()} chunks ({time.time()-t0:.1f}s)")
    t0 = time.time()
    eng.prime()
    print(f"meshed: {len(eng.pool.by_pos)} chunks ({time.time()-t0:.1f}s)")

    res = eng.render_frame(dt=0.0)
    fb = Framebuffer.from_device(res.color, res.depth)
    fb.save_ppm(args.out)
    nonsky = (fb.color != np.uint32(SKY_COLOR)).sum()
    print(f"wrote {args.out} ({args.width}x{args.height}, "
          f"{nonsky} non-sky pixels, stats={res.stats.cpu().numpy()})")
    return fb


if __name__ == "__main__":
    main()
