"""The share of the profiled window in which the busiest card ran
nothing: 1 - busy / window."""


def read(ctx):
    p = ctx["profile"]
    busy = p.get("busy_us")
    if not busy or not p.get("window_us"):
        return None
    return 1.0 - max(busy.values()) / p["window_us"]
