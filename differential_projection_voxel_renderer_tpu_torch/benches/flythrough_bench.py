"""Flythrough frames a second on the card: streaming, remeshing and a
moving camera, in a fresh process.

The counterpart of ``benches/flythrough_bench.py``.  An Engine of the
benches' configuration (1280x720, ``WorldConfig(view_distance=vd,
frustum_culling=True, max_chunks_per_frame=16)``, an 8192-slot pool) at
the reference start pose, its world settled and every loaded chunk meshed
(``prime_all``); then the warm-ups (``warm_resident`` in the resident
mode; else ``warm_buckets``, one frame and ``warm_streaming``) and 8
static frames, and the card synchronised.  Then passes of ``--frames``
moving frames (default 2 passes of 40): each frame the camera moves
(0.4, 0, -0.4) and yaws 0.01 rad, and ``render_frame(dt=0.016)`` renders
it (``render_frame_pipelined`` with ``DPVR_FLY_PIPELINED=1``, flushed at
the pass's end).  A pass ends with ``torch.cuda.synchronize()``.  Pass 1
crosses mostly primed terrain; pass 2 streams fresh chunks.

``DPVR_STALE_POOL=1`` and ``DPVR_RESIDENT=1`` select the engine's
one-frame-stale pool and resident superset stream modes (Engine reads
them).

    python -m differential_projection_voxel_renderer_tpu_torch.benches.flythrough_bench [vd] [--frames N] [--passes P]

Prints one line, ``FLYTHROUGH <pass 1 fps> <pass 2 fps>`` (one value a
pass), and the mode to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import scene as scene_mod
from .common import need_card

STEP = np.array([0.4, 0.0, -0.4], np.float32)
YAW_STEP = 0.01


def flight(eng, n: int, pipelined: bool, dt: float = 0.016):
    """``n`` moving frames: (seconds, the last FrameResult); the card is
    synchronised at the end."""
    res = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.camera.position += STEP
        eng.camera.yaw += YAW_STEP
        if pipelined:
            res = eng.render_frame_pipelined(dt=dt) or res
        else:
            res = eng.render_frame(dt=dt)
    if pipelined:
        res = eng.flush_pipeline() or res
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def warmed_engine(vd: int, pipelined: bool):
    """The flight's engine, primed with prime_all and warmed as the
    original warms it."""
    eng = scene_mod.new_engine(vd)
    eng.prime_all()
    if eng.resident_stream:
        eng.warm_resident()
    else:
        eng.warm_buckets(pipelined=pipelined)
    eng.render_frame(dt=0.0)
    if not eng.resident_stream:
        eng.warm_streaming()
    for _ in range(8):
        eng.render_frame(dt=0.0)
    torch.cuda.synchronize()
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("vd", nargs="?", type=int, default=12)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--passes", type=int, default=2)
    a = ap.parse_args(argv)
    need_card()
    pipelined = bool(int(os.environ.get("DPVR_FLY_PIPELINED", "0") or "0"))
    eng = warmed_engine(a.vd, pipelined)
    fps = []
    for _ in range(a.passes):
        secs, _ = flight(eng, a.frames, pipelined)
        fps.append(a.frames / secs)
    mode = "pipelined (1-frame latency)" if pipelined else "serial"
    if eng.resident_stream:
        mode += ", resident stream"
    elif eng.stale_streaming:
        mode += ", stale pool"
    print(f"flythrough mode: {mode}", file=sys.stderr, flush=True)
    print("FLYTHROUGH " + " ".join(f"{f:.1f}" for f in fps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
