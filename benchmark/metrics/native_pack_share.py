"""The share of the traced window's uploads of a draw list that the
program's native packer wrote: its counter ``pack_native`` over
``pack_native`` and ``pack_numpy`` (those its numpy twin wrote), both
summed over the window's unprofiled frames.  None where the program
counts no such thing (a program without the native packer), or packed
nothing in the window."""

import importlib

from ..program import PORT, window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    names = importlib.import_module(PORT + ".utils.profiling")
    if not {"pack_native", "pack_numpy"} <= set(
            getattr(names, "COUNTER_NAMES", ())):
        return None
    native = float(w.count("pack_native").sum())
    packed = native + float(w.count("pack_numpy").sum())
    return native / packed if packed else None
