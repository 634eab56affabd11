"""The reference's count of a view split into row bands, the number that
the reference's one collective makes: ``psum(count, "tp") // tp``, where
each band counts the quads that pass stage A and touch its rows (a quad
that touches two bands counts in both).

Plain float64 torch on the reference's own stream (``frame.py``'s draw
list, meshes and stage A); nothing of the port."""

from __future__ import annotations

import numpy as np
import torch

from . import funnel, raster
from .constants import CHUNK_SIZE


def stream_of(ref, rf, pose) -> raster.Stream:
    """Stage A of the stream of ``rf`` (``Reference.frame``'s frame of
    ``pose``), in ``ref``'s precision: its draw list's meshes, each
    chunk's face directions as its masks keep them."""
    words, origins = [], []
    for p, m, q in zip(rf.positions, rf.masks, rf.meshes):
        keep = m[(q >> 29) & 7].astype(bool)
        words.append(q[keep])
        origins.append(np.repeat(p[None].astype(np.float64) * CHUNK_SIZE,
                                 int(keep.sum()), 0))
    words = np.concatenate(words) if words else np.zeros(0, np.uint32)
    origins = (np.concatenate(origins) if origins
               else np.zeros((0, 3), np.float64))
    cam = funnel.camera_of(pose.position, pose.yaw, pose.pitch, ref.width,
                           ref.height)
    dev = ref.device
    return raster.Stream(
        torch.from_numpy(words.astype(np.int64)).to(dev),
        torch.from_numpy(origins).to(dev),
        cam.view_projection_matrix().astype(np.float64),
        np.asarray(cam.position, np.float64), ref.width, ref.height,
        ref.dtype)


def band_counts(s: raster.Stream, tp: int) -> list[int]:
    """The quads of ``s`` that pass stage A and whose pixel box meets each
    of ``tp`` equal row bands, top band first."""
    bh = s.height // tp
    return [int((s.visible & (s.y1 >= t * bh)
                 & (s.y0 <= t * bh + bh - 1)).sum()) for t in range(tp)]


def reduced_count(s: raster.Stream, tp: int) -> int:
    """``psum`` of the bands' counts ``// tp``."""
    return sum(band_counts(s, tp)) // tp
