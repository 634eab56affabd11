"""The share of the traced window's funnels whose draw list came from the
program's native pass: the program's counter ``funnel_native`` over the
calls of its ``funnel`` span, both summed over the window's unprofiled
frames (a views call runs the funnel once a view).  None where the
program counts no such thing (a program without the native pass)."""

import importlib

from ..program import PORT, window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    names = importlib.import_module(PORT + ".utils.profiling")
    if "funnel_native" not in getattr(names, "COUNTER_NAMES", ()):
        return None
    calls = int(w.calls[:, names.SPAN_NAMES.index("funnel")].sum())
    if not calls:
        return None
    return float(w.count("funnel_native").sum()) / calls
