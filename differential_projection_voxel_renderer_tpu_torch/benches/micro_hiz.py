"""The temporal-occlusion pieces alone on the card.

The counterpart of ``benches/micro_hiz.py``: a) ``ops/hiz.
build_max_pyramid`` on a 720p depth frame, b) ``quads_occluded_exact`` on
a gather-cap stream of 131072 random boxes, c) both chained, as the
temporal step runs them.  Each case runs K iterations (``--k``, default
50; each adds i * 1e-9 to its input, as the original does) captured in one
CUDA graph: the median over 5 replays of the graph's CUDA-event time,
over K.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_hiz [--k K]

One JSON line a case to stdout, ``{"case": ..., "ms": ...}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import hiz
from .common import graph_ms, need_card
from .scene import log

H, W, N = 720, 1280, 131072


def inputs(seed: int = 0, h: int = H, w: int = W, n: int = N):
    """(depth f32[h, w], bbx, bby i32[n], near depth f32[n]), numpy: the
    original's random frame and boxes."""
    rng = np.random.default_rng(seed)
    depth = rng.random((h, w)).astype(np.float32)
    x0 = rng.integers(0, w - 1, n)
    wdt = rng.integers(1, 16, n)
    y0 = rng.integers(0, h - 1, n)
    hgt = rng.integers(1, 8, n)
    bbx = (x0 | (np.minimum(x0 + wdt, w - 1) << 16)).astype(np.int32)
    bby = (y0 | (np.minimum(y0 + hgt, h - 1) << 16)).astype(np.int32)
    dn = rng.random(n).astype(np.float32)
    return depth, bbx, bby, dn


def cases(depth, bbx, bby, dn, k: int):
    """{case: fn()} on device tensors, each running the K iterations."""
    h, w = depth.shape
    l1 = hiz.build_max_pyramid(depth)

    def pyr():
        for i in range(k):
            hiz.build_max_pyramid(depth + i * 1e-9)

    def occ():
        for i in range(k):
            hiz.quads_occluded_exact(l1 + i * 1e-9, bbx, bby, dn, height=h,
                                     width=w).sum()

    def chain():
        for i in range(k):
            l1v = hiz.build_max_pyramid(depth + i * 1e-9)
            hiz.quads_occluded_exact(l1v, bbx, bby, dn, height=h,
                                     width=w).sum()

    return {"build_max_pyramid": pyr, "quads_occluded_exact": occ,
            "chained": chain}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=50)
    a = ap.parse_args(argv)
    need_card()
    ts = [torch.from_numpy(x).cuda() for x in inputs()]
    for label, fn in cases(*ts, a.k).items():
        ms = graph_ms(fn, calls=1, reps=5) / a.k
        log(f"{label:>22}: {ms:.4f} ms")
        print(json.dumps({"case": label, "ms": round(ms, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
