"""Animated flythrough: camera path replay with per-frame streaming +
remeshing (BASELINE.json benchmark config 5).

The port's counterpart of ``differential_projection_voxel_renderer_tpu/
app/flythrough.py``: the same path and replay; ``block_every`` waits for
the card instead of ``jax.block_until_ready``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .engine import Engine


@dataclass
class CameraKey:
    position: np.ndarray
    target: np.ndarray


def default_path(n_frames: int = 120, radius: float = 160.0,
                 height: float = 48.0) -> list[CameraKey]:
    """Orbit + drift path over the terrain around the origin."""
    keys = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        ang = t * 2.0 * np.pi * 0.75
        pos = np.array(
            [np.cos(ang) * radius * (1.0 - 0.4 * t),
             height - 20.0 * t,
             np.sin(ang) * radius * (1.0 - 0.4 * t)],
            np.float32,
        )
        target = np.array([40.0 * t, 0.0, -30.0 * t], np.float32)
        keys.append(CameraKey(pos, target))
    return keys


def run_flythrough(engine: Engine, path: list[CameraKey] | None = None,
                   block_every: int = 0):
    """Replays the path; returns the list of FrameResults (device tensors:
    nothing is copied to the host unless the caller asks).  With
    ``block_every`` = k the host waits for the card after every k-th
    frame."""
    path = path or default_path()
    results = []
    for key in path:
        engine.camera.position = np.asarray(key.position, np.float32)
        engine.camera.look_at(key.target)
        res = engine.render_frame()
        results.append(res)
        if (block_every and len(results) % block_every == 0
                and res.color.device.type == "cuda"):
            torch.cuda.synchronize(res.color.device)
    return results
