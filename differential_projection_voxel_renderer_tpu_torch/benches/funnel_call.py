"""The host funnel's draw-list stage: the native pass against its numpy
twin, in ms a funnel, on the host alone (the engine on the CPU; no card).

The scene is the benchmark's ``vd12_720p``: 1280x720, view distance 12
(frustum culling, 16 chunks generated a frame), a 16384-slot pool, a
512-chunk draw list, horizon culling; the world settled and every loaded
chunk meshed at the first pose.  Two pose sequences:

- ``pan``: the reference start (0, 10, 20), pitch -0.1244, the yaw
  turning 0.01 rad a frame, so the visibility cache never hits.  One
  engine; each frame runs ``Engine._funnel_native`` and
  ``Engine._funnel_numpy`` on the same pose (in alternating order), and
  its parts are timed apart: the camera and world update, the camera's
  matrices (``view_projection_matrix`` and ``extract_frustum``), the
  draw-list stage, and the signature's ``tobytes``.
- ``stream``: from (0, 24, 20), (0.4, 0, -0.4) and 0.01 rad a frame into
  fresh terrain.  Two engines fly the same frames, one through the pass,
  one through the twin (each frame's whole ``_funnel``, its world update
  and meshing included; the remesh batch's payload is applied to the
  pool after the timed call).

Every frame's draw lists from the two paths are compared bit for bit.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.funnel_call [--vd 12] [--frames 500] [--stream-frames 200]

One JSON line a sequence to stdout (medians and means in ms, the draw
lists' lengths and the frames whose draw lists differed), the host's
CPU model and Python/numpy versions on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

from ..app.engine import Engine
from ..meshing import native_bridge
from ..models.world import WorldConfig
from ..utils.config import RenderConfig

PITCH = -0.12435499454676144
PAN_START, STREAM_START = (0.0, 10.0, 20.0), (0.0, 24.0, 20.0)
STREAM_MOVE = np.array([0.4, 0.0, -0.4], np.float32)
YAW_STEP = 0.01


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def engine(vd: int, position, yaw: float, pool_slots: int) -> Engine:
    """The ``vd12_720p`` engine on the CPU, its world settled and every
    loaded chunk meshed at the pose."""
    eng = Engine(
        render_config=RenderConfig(width=1280, height=720,
                                   visible_chunks_cap=512),
        world_config=WorldConfig(view_distance=vd, frustum_culling=True,
                                 max_chunks_per_frame=16),
        pool_slots=pool_slots, device="cpu")
    eng.enable_horizon_culling = True
    set_pose(eng, position, yaw)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    return eng


def set_pose(eng, position, yaw: float) -> None:
    eng.camera.position = np.asarray(position, np.float32)
    eng.camera.yaw, eng.camera.pitch = float(yaw), PITCH


def draw_list_of(eng):
    dl = eng.draw_list()
    return (dl.n, dl.slots.tobytes(), dl.counts6.tobytes(),
            dl.dir_mask.tobytes(), dl.positions.tobytes())


def stats(ms) -> dict:
    return {"median": statistics.median(ms), "mean": statistics.fmean(ms)}


def pan(vd: int, frames: int, pool_slots: int) -> dict:
    eng = engine(vd, PAN_START, 0.0, pool_slots)
    cam = eng.camera
    parts = {name: {k: [] for k in ("update", "matrices", "stage", "sig")}
             for name in ("native", "numpy")}
    differ, n = 0, []
    for k in range(frames):
        got = {}
        for name in (("native", "numpy") if k % 2 else ("numpy", "native")):
            # a turn the caches have not seen, then back to the frame's
            # yaw: each path pays the camera's matrices and the full query
            set_pose(eng, PAN_START, YAW_STEP * k + 1.0)
            cam.view_projection_matrix()
            set_pose(eng, PAN_START, YAW_STEP * k)
            eng._seen_vp = None
            t0 = time.perf_counter()
            eng.controller.update_camera(cam, 0.016)
            eng.world.update(cam.position)
            t1 = time.perf_counter()
            cam.view_projection_matrix()
            cam.extract_frustum()
            t2 = time.perf_counter()
            getattr(eng, f"_funnel_{name}")()
            t3 = time.perf_counter()
            m = eng._last_n_visible
            _sig = (eng.world.version, eng._last_visible_slots[:m].tobytes(),
                    eng._last_counts_sel[:m].tobytes(),
                    eng._last_dir_mask[:m].tobytes())
            t4 = time.perf_counter()
            p = parts[name]
            for key, dt in (("update", t1 - t0), ("matrices", t2 - t1),
                            ("stage", t3 - t2), ("sig", t4 - t3)):
                p[key].append(dt * 1e3)
            got[name] = draw_list_of(eng)
        differ += got["native"] != got["numpy"]
        n.append(got["native"][0])
    out = {"sequence": "pan", "frames": frames, "differ": differ,
           "draw_list": stats(n)}
    for name, p in parts.items():
        out[name] = {key: stats(v) for key, v in p.items()}
        out[name]["funnel"] = stats([sum(t) for t in zip(*p.values())])
    return out


def stream(vd: int, frames: int, pool_slots: int) -> dict:
    engines = {name: engine(vd, STREAM_START, 0.0, pool_slots)
               for name in ("native", "numpy")}
    engines["numpy"]._funnel_native = engines["numpy"]._funnel_numpy
    ms = {name: [] for name in engines}
    differ, n = 0, []
    for k in range(1, frames + 1):
        got = {}
        for name, eng in engines.items():
            set_pose(eng, STREAM_START + STREAM_MOVE * k, YAW_STEP * k)
            t = time.perf_counter()
            eng._funnel(0.016)
            ms[name].append((time.perf_counter() - t) * 1e3)
            if eng._pending_insert is not None:
                eng.pool.dispatch_insert_payload(eng._pending_insert)
                eng._pending_insert = None
            got[name] = draw_list_of(eng)
        differ += got["native"] != got["numpy"]
        n.append(got["native"][0])
    return {"sequence": "stream", "frames": frames, "differ": differ,
            "draw_list": stats(n),
            **{name: {"funnel": stats(v)} for name, v in ms.items()}}


def cpu_model() -> str:
    """The host's CPU model where /proc/cpuinfo names one, its
    architecture and its cores."""
    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return (f"{name or 'unnamed CPU'} ({platform.machine()}, "
            f"{os.cpu_count()} cores)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vd", type=int, default=12)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--stream-frames", type=int, default=200)
    ap.add_argument("--pool-slots", type=int, default=16384)
    a = ap.parse_args(argv)
    if native_bridge.funnel_pass is None:
        raise RuntimeError("the native library is not built: no pass to "
                           "time")
    log(f"host: {cpu_model()}; python {platform.python_version()}, numpy "
        f"{np.__version__}")
    for seq in (pan(a.vd, a.frames, a.pool_slots),
                stream(a.vd, a.stream_frames, a.pool_slots)):
        print(json.dumps(seq), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
