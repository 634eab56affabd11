"""cudaLaunchKernel calls a frame in the profiled frames: 0 on a frame
replayed from its CUDA graph, so it shows work that falls off the
graphs.  (0 is a reading here, not a missing one.)"""


def read(ctx):
    p = ctx["profile"]
    if not p.get("frames") or not p.get("busy_us"):
        return None
    return p["launches"] / p["frames"]
