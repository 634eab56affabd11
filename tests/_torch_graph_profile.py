"""Engines with CUDA-graph frames inside torch.profiler windows, in a
process of their own (tests/test_torch_cuda.py runs it and reads its exit
code, so that a crash fails that test and not the test session).

    python tests/_torch_graph_profile.py [STEP ...]

Steps, in this order, all by default:

- ``early``: a profiler window over plain torch work before any graph is
  captured;
- ``session``: a window over warmed graph frames of engine A, so that
  later graphs are captured after a window has ended;
- ``drop``: engine B, warmed, flown, then left in a reference cycle; a
  second window frees it with ``gc.collect()`` between A's frames, so that
  B's graphs are destroyed inside the window;
- ``capture``: engine C's first frames inside that window (its captures);
- ``moving``: a last window over A's moving frames, the camera alternating
  between two poses.

Each window counts the device activities the profiler saw.  Prints
``ok`` and exits 0 when every step ran and every window saw device
activity (with CUPTI torn down after each window, as torch.profiler does
by default, later windows over graph frames see none, and the process
can crash: rendering/graphs.py keeps CUPTI set up once it captures).
With each captured graph destroyed at its instantiation, the ``moving``
window's first replays of engine A's "fused" graphs could segfault
inside the driver, from CUPTI's launch callback: rendering/graphs.py
keeps the captured graphs.
"""

import gc
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from differential_projection_voxel_renderer_tpu_torch.app import (  # noqa: E402,E501
    engine as TE,
)

STEPS = ("early", "session", "drop", "capture", "moving")
POSES = [((0.0, 10.0, 20.0), (0.0, 0.0, -60.0)),
         ((8.0, 10.0, 12.0), (8.0, 0.0, -68.0))]


def engine():
    eng = TE.Engine(TE.RenderConfig(width=256, height=128, gather_cap=65536,
                                    quads_cap=32768),
                    TE.WorldConfig(view_distance=3, frustum_culling=True,
                                   max_chunks_per_frame=4),
                    pool_slots=512, device="cuda")
    pose(eng, 0)
    while eng.world.update(eng.camera.position):
        pass
    eng.prime()
    return eng


def pose(eng, i):
    eng.camera.position = np.array(POSES[i][0], np.float32)
    eng.camera.look_at(np.array(POSES[i][1], np.float32))


def warmed():
    eng = engine()
    eng.warm_buckets()
    eng.warm_streaming()
    for i in (0, 1, 0, 1, 0):
        pose(eng, i)
        eng.render_frame(dt=0.0)
    torch.cuda.synchronize()
    return eng


def device_activities(body) -> int:
    """``body()`` inside a torch.profiler window; the device activities
    the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def main(steps) -> int:
    seen = {}

    def window(name, body):
        seen[name] = device_activities(body)
        print(name, seen[name], flush=True)

    if "early" in steps:
        x = torch.ones(1 << 20, device="cuda")
        window("early", lambda: [x.mul_(1.0) for _ in range(10)])
    a = warmed()

    def frames(n=5, moving=False):
        for k in range(n):
            pose(a, k % 2 if moving else 0)
            a.render_frame(dt=0.0)

    if "session" in steps:
        window("session", frames)
    if "drop" in steps or "capture" in steps:
        if "drop" in steps:
            b = warmed()
            b.cycle = b  # freed only by the cyclic collector
            del b
        holder = []

        def second():
            frames()
            if "drop" in steps:
                gc.collect()
            frames()
            if "capture" in steps:
                holder.append(engine())
                holder[0].render_frame(dt=0.0)
                pose(holder[0], 1)
                holder[0].render_frame(dt=0.0)
            frames()

        window("drop/capture", second)
    if "moving" in steps:
        window("moving", lambda: frames(10, moving=True))
    if not all(seen.values()):
        print(f"a window saw no device activity: {seen}", flush=True)
        return 1
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if any(s not in STEPS for s in args):
        sys.exit(f"steps: {' '.join(STEPS)}")
    sys.exit(main(args or STEPS))
