"""Carried frames drained a frame (the program's counter ``pipe_drains``:
a change of gather bucket, or the flush), mean over the traced window's
unprofiled frames.  None where the program counts no drains."""

import importlib

from ..program import PORT, count


def read(ctx):
    names = importlib.import_module(PORT + ".utils.profiling")
    if "pipe_drains" not in getattr(names, "COUNTER_NAMES", ()):
        return None
    return count(ctx, "pipe_drains")
