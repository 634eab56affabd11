"""The share of the traced window's frames-in-flight steps, seeds and
drains that the program served from a CUDA graph: its counter
``pipe_graph`` over ``pipe_graph`` and ``pipe_eager`` (those it ran
eagerly), both summed over the window's unprofiled frames.  None where
the program counts no such thing (a program whose frames in flight run
eagerly, uncounted), or served none in the window."""

import importlib

from ..program import PORT, window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    names = importlib.import_module(PORT + ".utils.profiling")
    if not {"pipe_graph", "pipe_eager"} <= set(
            getattr(names, "COUNTER_NAMES", ())):
        return None
    graph = float(w.count("pipe_graph").sum())
    served = graph + float(w.count("pipe_eager").sum())
    return graph / served if served else None
