"""Device ms a frame in which an operation ran (the union of the device
activities' intervals) over the profiled frames, on the busiest card."""


def read(ctx):
    p = ctx["profile"]
    busy = p.get("busy_us")
    if not busy or not p.get("frames"):
        return None
    return max(busy.values()) / p["frames"] / 1e3
