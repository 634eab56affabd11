"""The program's own tracer, read for the traced window: the port's
``utils/profiling.TRACER``, which holds each frame's host spans, counters
and card idle times.  The window's frames are the last ``spans.frames +
profile["frames"]`` frames the tracer holds (the harness's span sums and
the profiled frames, give or take one warm-up frame), less those recorded
under the profiler, which the tracer flags.  Where the program has no
tracer, or tracing is off, every reading is None."""

from __future__ import annotations

import math

PORT = "differential_projection_voxel_renderer_tpu_torch"


def tracer():
    """The port's tracer, or None where the program has none."""
    import importlib

    try:
        mod = importlib.import_module(PORT + ".utils.profiling")
    except ImportError:
        return None
    tr = getattr(mod, "TRACER", None)
    return tr if getattr(tr, "enabled", False) else None


def window(ctx):
    """The traced window's unprofiled frames, or None."""
    spans, prof = ctx.get("spans"), ctx.get("profile") or {}
    tr = tracer()
    if not spans or not spans.frames or tr is None:
        return None
    got = tr.frames(spans.frames + int(prof.get("frames", 0)))
    return got if len(got) else None


def span_ms(ctx, name: str, self_time: bool = False):
    """Host ms a frame in span ``name`` (its self time: less its
    children's), mean over the window's frames."""
    w = window(ctx)
    if w is None:
        return None
    return float(w.span_ns(name, self_time).mean()) / 1e6


def count(ctx, name: str):
    """Counter ``name`` a frame, mean over the window's frames."""
    w = window(ctx)
    return None if w is None else float(w.count(name).mean())


def idle_ms(ctx, name: str):
    """Card idle ms a frame (``idle``, ``idle_funnel`` or
    ``idle_dispatch``), mean over the window's resolved frames; None where
    none resolved (off a card)."""
    w = window(ctx)
    if w is None:
        return None
    v = [x for x in w.idle(name).tolist() if not math.isnan(x)]
    return sum(v) / len(v) if v else None
