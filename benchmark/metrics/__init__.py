"""Per-layer metrics, one module each, found by the metric's name in
BENCHMARK.json.  Each has ``read(ctx) -> float | None``: ``ctx`` holds the
traced run's ``profile`` (trace.Profile.read's dict, with ``frames`` and
``gathered``, the stream length of each profiled frame as its
``stats[0]`` reads), ``spans`` (trace.Spans over the
calls outside the profile) and ``peaks`` (the card's row of peaks.json,
or None).  A reader that finds nothing to read returns None and the
metric is left out."""


def kernel_us(ctx, *names, exclude=()) -> float:
    """Device us in the profile of the operations whose name holds one of
    ``names`` and none of ``exclude``."""
    return sum(us for n, us in ctx["profile"].get("kernels", {}).items()
               if any(s in n for s in names)
               and not any(s in n for s in exclude))


def per_frame(ctx, us: float) -> float | None:
    frames = ctx["profile"].get("frames")
    return us / frames / 1e3 if frames and us > 0 else None
